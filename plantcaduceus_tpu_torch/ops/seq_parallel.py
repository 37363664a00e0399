"""Context-parallel (sequence-sharded) selective scan, forward and
gradient.

Counterpart of ``plantcaduceus_tpu.ops.seq_parallel``. The time axis is
sharded over the ``seq`` mesh axis; a linear recurrence splits across ranks
with one ``[rows, D, N]`` state exchange per shard boundary. Per direction:

  pass 1: each rank scans its chunk from zero (K1 with ``emit_hfin``),
          keeping its final state F; the chunk's decay product P =
          ``exp(A · Σ_t softplus(dt_t))`` is computed outside the kernel;
  stitch: all_gather the (P, F) pairs over ``seq`` and run the exclusive
          recurrence h0_i = P_{i-1} h0_{i-1} + F_{i-1} in shard order
          (reversed for the reverse direction);
  pass 2: each rank scans its chunk again from its h0 (K1 with ``h0``).

Gradients: the seeded scan emitting (y, hfin) is :class:`SpScanFn`, whose
backward is K3 with ``g0`` (the cotangent of hfin) and ``emit_dh0`` (the
gradient of h0); the decay product, the stitch and the all_gather are
differentiated by autograd (``parallel/collectives.py``), so no
cross-shard adjoint is written by hand. On CPU tensors the kernels' plain
versions run.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from plantcaduceus_tpu_torch.ops.cuda_scan import scan_bwd, scan_fwd
from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK, softplus
from plantcaduceus_tpu_torch.parallel.collectives import all_gather


def _decay_product(dt, A, dt_bias, dt_proj_w):
    """P[r, d, n] = prod_t exp(softplus(dt)[r, t, d] · A[d, n]) over the
    local chunk, as the exp of the summed rates. The same for both
    directions. dt: ``[rows, L, R]`` with ``dt_proj_w [R, D]``, else ``[rows,
    L, D]``."""
    dtr = dt.float()
    if dt_proj_w is not None:
        dtr = dtr @ dt_proj_w.float()
    s = softplus(dtr + dt_bias.float()).sum(1)                  # [rows, D]
    return torch.exp(s[..., None] * A.float())                  # [rows, D, N]


class SpScanFn(torch.autograd.Function):
    """One direction's scan seeded with ``h0``, returning ``(y, hfin)`` (JAX
    ``_sp_scan_op``): K1 with ``h0`` and ``emit_hfin``, with ``hb`` when a
    gradient is needed; the backward is K3 with ``g0 = d hfin`` and
    ``emit_dh0``. Arguments as :func:`cuda_scan.scan_fwd`; gradients come
    back in each input's dtype (A, Dskip, dt_bias, dt_proj_w and h0:
    float32)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, h0, reverse):
        x, dt, Bm, Cm = (t.contiguous() for t in (x, dt, Bm, Cm))
        h0 = h0.float().contiguous()
        if not any(ctx.needs_input_grad):
            return scan_fwd(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse, h0=h0,
                            emit_hfin=True)
        y, hb, hfin = scan_fwd(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse,
                               hb_chunk=HB_CHUNK, h0=h0, emit_hfin=True)
        ctx.save_for_backward(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, hb)
        ctx.reverse = reverse
        return y, hfin

    @staticmethod
    def backward(ctx, gy, ghfin):
        x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, hb = ctx.saved_tensors
        dx, ddt, dB, dC, dA, ddtb, dD, dW, dh0 = scan_bwd(
            x, gy.to(x.dtype).contiguous(), dt, A, Bm, Cm, Dskip, dt_bias, hb, dt_proj_w,
            ctx.reverse, HB_CHUNK, g0=ghfin.float().contiguous(), emit_dh0=True)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bm.dtype), dC.to(Cm.dtype), dD,
                ddtb, dW, dh0, None)


def _stitch_h0(aprod, hfin, sp, reverse: bool):
    """This rank's entry state from every shard's (decay product, final
    state), [rows, D, N] each: the exclusive recurrence in shard order,
    written as JAX writes it (every shard's carry formed, this rank's
    selected), so the all_gather takes part in every rank's backward."""
    pf = all_gather(torch.stack([aprod, hfin]), sp)              # [S, 2, rows, D, N]
    order = range(sp.size - 1, -1, -1) if reverse else range(sp.size)
    mine = carry = torch.zeros_like(hfin)
    for k in order:
        mine = torch.where(carry.new_full((), k == sp.index, dtype=torch.bool), carry, mine)
        carry = pf[k, 0] * carry + pf[k, 1]
    return mine


def scan_seq_sharded(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, sp,
                     reverse: bool = False) -> torch.Tensor:
    """One direction over a chunk of the sequence sharded over ``sp`` (a
    ``parallel.mesh.Axis``): the arguments hold this rank's chunk, as
    :func:`cuda_scan.scan_fwd` takes them (``x [rows, Lloc, D]``, dt_lr
    with ``dt_proj_w``, else dt at full width). Returns this rank's y
    chunk; differentiable."""
    aprod = _decay_product(dt, A, dt_bias, dt_proj_w)
    zero = torch.zeros_like(aprod)
    _, hfin = SpScanFn.apply(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, zero, reverse)
    h0 = _stitch_h0(aprod, hfin, sp, reverse)
    y, _ = SpScanFn.apply(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, h0, reverse)
    return y


def selective_scan_seq_sharded(x, dt, A, Bm, Cm, Dskip, dt_bias,
                               dt_proj_w: Optional[torch.Tensor], sp,
                               directions: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """JAX ``selective_scan_seq_sharded``'s group layout: ``x [G, B, Lloc,
    D]``, ``dt [G, B, Lloc, R|D]``, ``A [G, D, N]``, ``Bm, Cm [G, B, Lloc,
    N]``, ``Dskip, dt_bias [G, D]``, ``dt_proj_w [G, R, D]`` or None;
    ``directions[g]`` reverses group g. Returns ``y [G, B, Lloc, D]``."""
    ys = []
    for g in range(x.shape[0]):
        rev = bool(directions[g]) if directions is not None else False
        ys.append(scan_seq_sharded(x[g], dt[g], A[g], Bm[g], Cm[g], Dskip[g], dt_bias[g],
                                   dt_proj_w[g] if dt_proj_w is not None else None, sp,
                                   reverse=rev))
    return torch.stack(ys)
