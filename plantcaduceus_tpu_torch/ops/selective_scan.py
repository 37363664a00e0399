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


def scan_direction(x, dt, A, Bm, Cm, Dskip, dt_bias, reverse: bool):
    """One direction of the scan over rows, in the order of the CUDA kernels'
    arithmetic: ``x [R, L, D]``, full-width ``dt [R, L, D]`` (pre-bias),
    ``A [D, N]``, ``Bm, Cm [R, L, N]``, ``Dskip, dt_bias [D]``. Decay is
    ``exp2(dt' * log2e * A)``. ``reverse`` walks from L-1 down to 0. Returns
    fp32 ``[R, L, D]``."""
    x, dt, A, Bm, Cm = (t.float() for t in (x, dt, A, Bm, Cm))
    dtp = softplus(dt + dt_bias.float())
    dtl = dtp * LOG2E
    dtx = dtp * x
    R, L, D = x.shape
    h = x.new_zeros((R, D, A.shape[-1]))
    ys = [None] * L
    for t in (range(L - 1, -1, -1) if reverse else range(L)):
        a = torch.exp2(dtl[:, t, :, None] * A)              # [R, D, N]
        h = a * h + Bm[:, t, None, :] * dtx[:, t, :, None]
        ys[t] = torch.einsum("rdn,rn->rd", h, Cm[:, t])
    return torch.stack(ys, dim=1) + x * Dskip.float()
