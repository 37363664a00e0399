"""Selective-scan (Mamba S6) recurrence — plain PyTorch versions.

Counterpart of ``plantcaduceus_tpu.ops.selective_scan``. These are the CPU
oracle for the CUDA kernels in :mod:`.cuda_scan` and :mod:`.cuda_mixer`.

Recurrence (per batch row, channel d, state n), with ``delta_softplus``:

    dt'    = softplus(dt + dt_bias)
    a[t]   = exp(dt'[t,d] * A[d,n])              (A real, negative)
    h[t]   = a[t] * h[t-1] + dt'[t,d] * B[t,n] * x[t,d]
    y[t,d] = sum_n C[t,n] * h[t,d,n] + D[d] * x[t,d]

Shapes carry a leading group axis G (the two directions of a bidirectional
block), exactly as in the JAX package:

    x, dt : [G, B, L, D]    A : [G, D, N]    Bm, Cm : [G, B, L, N]
    Dskip, dt_bias : [G, D]                  y : [G, B, L, D]

The carry is float32 whatever the input dtype; outputs take ``x.dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

LOG2E = 1.4426950408889634


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``x > 20 ? x : log1p(exp(x))``: the form the CUDA kernels use; within
    float32 rounding of ``jax.nn.softplus``."""
    return F.softplus(x, beta=1.0, threshold=20.0)


def _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus):
    x, dt, A, Bm, Cm, Dskip = (t.float() for t in (x, dt, A, Bm, Cm, Dskip))
    if dt_bias is not None:
        dt = dt + dt_bias.float()[:, None, None, :]
    if dt_softplus:
        dt = softplus(dt)
    return x, dt, A, Bm, Cm, Dskip


def selective_scan_sequential(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    Dskip: torch.Tensor,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
) -> torch.Tensor:
    """Ground-truth scan: a Python loop over time."""
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    G, B, L, D = x.shape
    h = x.new_zeros((G, B, D, A.shape[-1]))
    ys = []
    for t in range(L):
        dt_t = dt[:, :, t]                                  # [G, B, D]
        a = torch.exp(dt_t[..., None] * A[:, None])         # [G, B, D, N]
        b = (dt_t * x[:, :, t])[..., None] * Bm[:, :, t, None, :]
        h = a * h + b
        ys.append(torch.einsum("gbdn,gbn->gbd", h, Cm[:, :, t]))
    y = torch.stack(ys, dim=2) + Dskip[:, None, None, :] * x
    return y.to(out_dtype)


def selective_scan_associative(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    Dskip: torch.Tensor,
    dt_bias: Optional[torch.Tensor] = None,
    dt_softplus: bool = True,
) -> torch.Tensor:
    """Parallel prefix scan over the linear recurrence (Hillis-Steele
    doubling, log2(L) steps). Combines ``(a1, b1), (a2, b2)`` into
    ``(a2*a1, a2*b1 + b2)``. Materialises ``[G, B, L, D, N]`` states: for
    small shapes only."""
    out_dtype = x.dtype
    x, dt, A, Bm, Cm, Dskip = _prep(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_softplus)
    a = torch.exp(dt[..., None] * A[:, None, None])         # [G, B, L, D, N]
    b = (dt * x)[..., None] * Bm[:, :, :, None, :]
    L = x.shape[2]
    for s in (1 << k for k in range(math.ceil(math.log2(max(L, 1))))):
        b = torch.cat([b[:, :, :s], a[:, :, s:] * b[:, :, :-s] + b[:, :, s:]], dim=2)
        a = torch.cat([a[:, :, :s], a[:, :, s:] * a[:, :, :-s]], dim=2)
    y = torch.einsum("gbldn,gbln->gbld", b, Cm) + Dskip[:, None, None, :] * x
    return y.to(out_dtype)


# Time steps between the chunk-entry states ``hb`` that the training forward
# emits and the backward recomputes from. One constant for both sides: the
# forward's emission and the backward's chunking must agree. A tiling choice
# only; gradients do not depend on it beyond rounding.
HB_CHUNK = 16


def _processing_order(L: int, reverse: bool):
    return range(L - 1, -1, -1) if reverse else range(L)


def scan_direction(x, dt, A, Bm, Cm, Dskip, dt_bias, reverse: bool,
                   hb_chunk: Optional[int] = None, h0: Optional[torch.Tensor] = None,
                   emit_hfin: bool = False):
    """One direction of the scan over rows, in the order of the CUDA kernels'
    arithmetic: ``x [R, L, D]``, full-width ``dt [R, L, D]`` (pre-bias),
    ``A [D, N]``, ``Bm, Cm [R, L, N]``, ``Dskip, dt_bias [D]``. Decay is
    ``exp2(dt' * log2e * A)``. ``reverse`` walks from L-1 down to 0. ``h0
    [R, D, N]`` seeds the states before the first processed step (zeros
    when None). Returns fp32 ``y [R, L, D]``, then with ``hb_chunk`` the fp32
    state at the entry of every ``hb_chunk``-step chunk, ``hb [R,
    ceil(L/hb_chunk), D, N]``, in processing order (chunk c starts at
    processing step c * hb_chunk), then with ``emit_hfin`` the fp32 state
    after the last processed step, ``hfin [R, D, N]``; a tuple when more
    than y is asked for (JAX ``_pallas_scan_group``'s outputs)."""
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    dtp = softplus(dt + dt_bias.float())
    dtl = dtp * LOG2E
    dtx = dtp * x
    R, L, D = x.shape
    h = (h0.float().clone() if h0 is not None else x.new_zeros((R, D, A.shape[-1])))
    hb = (x.new_empty((R, -(-L // hb_chunk), D, A.shape[-1]))
          if hb_chunk else None)
    ys = [None] * L
    for p, t in enumerate(_processing_order(L, reverse)):
        if hb is not None and p % hb_chunk == 0:
            hb[:, p // hb_chunk] = h
        a = torch.exp2(dtl[:, t, :, None] * A)              # [R, D, N]
        h = a * h + Bm[:, t, None, :] * dtx[:, t, :, None]
        ys[t] = torch.einsum("rdn,rn->rd", h, Cm[:, t])
    y = torch.stack(ys, dim=1) + x * Dskip.float()
    out = (y,) + ((hb,) if hb is not None else ()) + ((h,) if emit_hfin else ())
    return out if len(out) > 1 else y


def scan_direction_bwd(x, gy, dt, A, Bm, Cm, Dskip, dt_bias, hb=None,
                       dt_proj_w=None, reverse: bool = False,
                       hb_chunk: int = HB_CHUNK, g0: Optional[torch.Tensor] = None,
                       emit_dh0: bool = False):
    """Adjoint of :func:`scan_direction` (the plain version of kernel K3,
    ``csrc/scan_bwd.cu``), with its arithmetic: per ``hb_chunk`` chunk, in
    reverse processing order, the states are recomputed from the entry state
    ``hb`` and the cotangent runs backwards through them.

    x, gy: ``[R, L, D]``; dt: ``[R, L, D]``, or the low-rank ``dt_lr [R, L,
    Rk]`` when ``dt_proj_w [Rk, D]`` is given; Bm, Cm: ``[R, L, N]``; A:
    ``[D, N]``; Dskip, dt_bias: ``[D]``; hb: the forward's chunk-entry states
    (recomputed when None). ``g0 [R, D, N]`` seeds the cotangent state (the
    adjoint of an emitted final state; zeros when None). Returns float32 ``(dx, ddt, dB, dC, dA, ddt_bias, dD,
    dW)``: ddt is ``d dt_lr [R, L, Rk]`` when fused, else ``d dt [R, L,
    D]``; dW is ``d dt_proj_w [Rk, D]``, or None when not fused; with
    ``emit_dh0`` also ``dh0 [R, D, N]``, the cotangent left after the
    earliest-processed step: the gradient with respect to the
    processing-order initial state (JAX ``_pallas_bwd_group``'s options)."""
    x, gy, Bm, Cm, A = (t.float() for t in (x, gy, Bm, Cm, A))
    dt_in = dt.float()
    dt_raw = dt_in @ dt_proj_w.float() if dt_proj_w is not None else dt_in
    pre = dt_raw + dt_bias.float()
    dtp = softplus(pre)
    sig = torch.sigmoid(pre)
    dtl = dtp * LOG2E
    dtx = dtp * x
    R, L, D = x.shape
    if hb is None:
        _, hb = scan_direction(x, dt_raw, A, Bm, Cm, Dskip, dt_bias, reverse, hb_chunk)
    hb = hb.float()
    order = list(_processing_order(L, reverse))
    dx = torch.empty_like(x)
    ddt = torch.empty_like(x)
    dB = torch.empty_like(Bm)
    dC = torch.empty_like(Cm)
    dA = torch.zeros_like(A)
    g = g0.float().clone() if g0 is not None else x.new_zeros((R, D, A.shape[-1]))
    for c in reversed(range(hb.shape[1])):
        ts = order[c * hb_chunk:(c + 1) * hb_chunk]
        hs, h = [], hb[:, c]
        for t in ts:                                         # recompute the chunk
            h = torch.exp2(dtl[:, t, :, None] * A) * h + Bm[:, t, None, :] * dtx[:, t, :, None]
            hs.append(h)
        for k in reversed(range(len(ts))):                   # adjoint, backwards
            t = ts[k]
            h_prev = hs[k - 1] if k else hb[:, c]
            g_t = Cm[:, t, None, :] * gy[:, t, :, None] + g  # dL/dh[t]
            gB = (g_t * Bm[:, t, None, :]).sum(-1)           # [R, D]
            dB[:, t] = (g_t * dtx[:, t, :, None]).sum(1)
            dC[:, t] = (gy[:, t, :, None] * hs[k]).sum(1)
            g = torch.exp2(dtl[:, t, :, None] * A) * g_t     # carried to step t-1
            das = g * h_prev
            dA += (das * dtp[:, t, :, None]).sum(0)
            ddt[:, t] = ((das * A).sum(-1) + gB * x[:, t]) * sig[:, t]
            dx[:, t] = gB * dtp[:, t] + gy[:, t] * Dskip.float()
    ddt_bias = ddt.sum((0, 1))
    dD = (gy * x).sum((0, 1))
    if dt_proj_w is None:
        out = (dx, ddt, dB, dC, dA, ddt_bias, dD, None)
    else:
        dW = torch.einsum("rlk,rld->kd", dt_in, ddt)
        out = (dx, ddt @ dt_proj_w.float().T, dB, dC, dA, ddt_bias, dD, dW)
    return out + (g,) if emit_dh0 else out
