"""Short causal depthwise convolution — the Mamba conv prologue.

Counterpart of ``plantcaduceus_tpu.ops.conv.causal_conv1d``. Written as K
shifted multiply-adds rather than ``F.conv1d``: cuDNN runs fp32
convolutions in TF32 by default, which would keep only about three decimal
digits.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.parallel.collectives import ppermute


def causal_conv1d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    activation: Optional[str] = "silu",
    anticausal: bool = False,
) -> torch.Tensor:
    """Depthwise causal 1-D convolution along the second-to-last axis.

    x: [..., L, D]; w: [..., D, K] (tap K-1 multiplies the current step);
    b: [..., D] or None. Leading axes of ``w``/``b`` broadcast against the
    leading axes of ``x``.

    ``anticausal=True`` computes ``flip_L(causal_conv(flip_L(x), w, b))``
    without the flips: the output at t reads x[t .. t+K-1] through reversed
    taps.
    """
    K = w.shape[-1]
    L = x.shape[-2]
    pad = (0, 0, 0, K - 1) if anticausal else (0, 0, K - 1, 0)
    xp = F.pad(x, pad)

    def _bcast(v):  # [*P, D] -> [*P, 1, ..., 1, D] matching x's rank
        return v.reshape(v.shape[:-1] + (1,) * (x.dim() - v.dim()) + v.shape[-1:])

    y = None
    for k in range(K):
        tap_w = w[..., K - 1 - k] if anticausal else w[..., k]
        tap = xp[..., k:k + L, :] * _bcast(tap_w)
        y = tap if y is None else y + tap
    if b is not None:
        y = y + _bcast(b)
    if activation == "silu":
        y = F.silu(y)
    elif activation is not None:
        raise ValueError(f"unsupported activation {activation!r}")
    return y


def causal_conv1d_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                      anticausal: bool = False):
    """Transpose of :func:`causal_conv1d` without activation, for ``x [B, L,
    D]`` and ``w [D, K]``: returns ``(dx, dw, db)`` for the cotangent ``dy``
    of its output (the conv is linear, so its VJP is its transpose), in
    ``dy``'s dtype."""
    K = w.shape[-1]
    L = x.shape[-2]
    pad = (0, 0, 0, K - 1) if anticausal else (0, 0, K - 1, 0)
    xp = F.pad(x, pad)
    dxp = torch.zeros_like(xp, dtype=dy.dtype)
    dw = torch.empty(w.shape, dtype=dy.dtype, device=dy.device)
    for k in range(K):
        tap = K - 1 - k if anticausal else k
        dxp[..., k:k + L, :] += dy * w[..., tap].to(dy.dtype)
        dw[..., tap] = (dy * xp[..., k:k + L, :]).sum((0, 1))
    dx = dxp[..., :L, :] if anticausal else dxp[..., K - 1:, :]
    return dx, dw, dy.sum((0, 1))


def halo_depthwise_conv_silu(inp: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                             anticausal: bool, sp) -> torch.Tensor:
    """Context-parallel depthwise conv + SiLU over a sequence-sharded ``inp
    [B, Llocal, D]`` (JAX ``ops/conv.halo_depthwise_conv_silu``): the K-1
    boundary rows come from the neighbouring shard of the ``sp`` axis
    (``parallel.mesh.Axis``) — the next shard for the anticausal direction,
    the previous one for the causal — and the sequence's edge shards get
    zeros, the conv's own padding. Differentiable: the exchange's adjoint is
    the reverse exchange."""
    K = w.shape[-1]
    S, L = sp.size, inp.shape[1]
    if anticausal:  # halo = the next shard's first K-1 rows
        halo = ppermute(inp[:, :K - 1], sp, [(i, i - 1) for i in range(1, S)])
        ext = torch.cat([inp, halo], dim=1)
        return causal_conv1d(ext, w, b, activation="silu", anticausal=True)[:, :L]
    halo = ppermute(inp[:, L - (K - 1):], sp, [(i, i + 1) for i in range(S - 1)])
    ext = torch.cat([halo, inp], dim=1)
    return causal_conv1d(ext, w, b, activation="silu")[:, K - 1:]
