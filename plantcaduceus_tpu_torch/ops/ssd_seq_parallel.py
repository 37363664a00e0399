"""Context-parallel (sequence-sharded) SSD, forward and gradient.

Counterpart of ``plantcaduceus_tpu.ops.ssd_seq_parallel``: the Mamba-2
recurrence with its time axis sharded over the ``seq`` mesh axis. One
local pass and a closed-form correction per direction:

  local:   each rank runs the chunked SSD on its chunk from a zero state
           (K4 forward, K6 plain-mode backward, ``cuda_ssd.SsdDirFn``; the
           plain versions on CPU tensors), giving y_zero;
  summary: the SSD decay is a scalar per head, so the shard's decay product
           prod[b, h] = exp(Σ_t la[t]) and final state F[b, h, n, p] =
           Σ_t w[t]·B[t]⊗x[t] are closed-form (one product per head);
  stitch:  all_gather the (prod, F) pairs over ``seq`` and run the exclusive
           recurrence S0_i = prod_{i-1}·S0_{i-1} + F_{i-1} in shard order
           (reversed for the anticausal direction);
  correct: y[t] = y_zero[t] + (C[t] @ S0)·exp(into[t]).

Everything around the local pass is differentiated by autograd. Every
exponent is ≤ 0 (la = softplus(dt)·A with A < 0). On the card the K4/K6
shape rules hold for the local chunk: its length must be a multiple of
128, and the kernels refuse it otherwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops.cuda_ssd import ssd_dir, ssd_dir_train
from plantcaduceus_tpu_torch.parallel.collectives import all_gather


def _stitch_state(prod, fin, sp, reverse: bool):
    """This rank's boundary state from every shard's summary: ``prod [B,
    NG, hg]``, ``fin [B, NG, hg, N, P]``; every shard's carry is formed and
    this rank's selected, as JAX writes it."""
    gp = all_gather(prod, sp)                                   # [S, B, NG, hg]
    gf = all_gather(fin, sp)                                    # [S, B, NG, hg, N, P]
    order = range(sp.size - 1, -1, -1) if reverse else range(sp.size)
    mine = carry = torch.zeros_like(fin)
    for k in order:
        mine = torch.where(carry.new_full((), k == sp.index, dtype=torch.bool), carry, mine)
        carry = gp[k][..., None, None] * carry + gf[k]
    return mine


def ssd_dir_seq_sharded(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk: int, reverse: bool,
                        sp) -> torch.Tensor:
    """One direction over this rank's chunk of a sequence sharded over
    ``sp`` (a ``parallel.mesh.Axis``), on the flat contract of
    ``cuda_ssd.ssd_dir``: ``x [B, Lloc, H*P]``, ``dt [B, Lloc, H]`` raw,
    ``Bm, Cm [B, Lloc, NG, N]``, ``A, Dskip, dt_bias [H]``. Returns this
    rank's y chunk; differentiable."""
    B, L, HP = x.shape
    H = dt.shape[-1]
    P = HP // H
    NG, N = Bm.shape[-2:]
    hg = H // NG
    f32 = torch.float32
    args = (x, dt, A, Bm, Cm, Dskip, dt_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y = ssd_dir_train(*args, chunk, reverse)
    else:
        y = ssd_dir(*(t.contiguous() for t in args), chunk, reverse)

    dtp = F.softplus(dt.to(f32) + dt_bias.to(f32))              # [B, L, H]
    la = (dtp * A.to(f32)).reshape(B, L, NG, hg)                # ≤ 0
    dtg = dtp.reshape(B, L, NG, hg)
    cum = torch.cumsum(la, dim=1)
    total = cum[:, -1]                                          # [B, NG, hg]
    if not reverse:
        # w[t] decays t's contribution to the shard's end; S0 enters t with
        # exp(cum[t]) (the boundary state passes through t's own decay)
        w = dtg * torch.exp(total[:, None] - cum)
        into = cum
    else:
        # anticausal: e is the exclusive left cumsum; t's contribution to the
        # shard-start state decays by exp(e[t]); the shard-end state enters t
        # with exp(Σ_{r>=t} la[r])
        e = cum - la
        w = dtg * torch.exp(e)
        into = total[:, None] - e
    xg = x.to(f32).reshape(B, L, NG, hg, P)
    fin = torch.einsum("blgn,blghp->bghnp", Bm.to(f32), w[..., None] * xg)
    s0 = _stitch_state(torch.exp(total), fin, sp, reverse)
    corr = torch.einsum("blgn,bghnp->blghp", Cm.to(f32), s0) * torch.exp(into)[..., None]
    return y + corr.reshape(B, L, HP).to(y.dtype)
