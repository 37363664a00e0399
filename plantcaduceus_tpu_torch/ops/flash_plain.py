"""Plain versions of K7 and K8: flash attention with a structured bias,
forward and backward, as dense PyTorch over the [B*H, L, L] scores.

The functions the CUDA kernels (``csrc/attn_fwd.cu``, ``csrc/attn_bwd.cu``)
compute, written as the TPU kernels of
``plantcaduceus_tpu.ops.pallas_attention`` define them: the inputs cast to
float32 first (``_fwd_kernel`` :74-75), the bias built from indices as
``_block_bias`` (:43-60) builds it, masked entries at the finite sentinel
``-1e30`` (``_NEG``), ``lse`` the float32 row logsumexp and ``delta =
rowsum(do * o)`` in float32 (``_bwd`` :231-233). Tensors are ``[B, L, H,
hd]``; ``lse`` is ``[B*H, L]`` (the TPU's ``[BH, L, 128]`` broadcast is a
layout). The tests and the CPU path use these; the card's main path does
not.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG = -1e30  # pallas_attention._NEG


def block_bias(L: int, slopes: Optional[torch.Tensor], causal: bool = False,
               window: Optional[int] = None, symmetric: bool = True,
               device=None) -> torch.Tensor:
    """The additive bias ``[H or 1, L, L]`` float32 of ``_block_bias`` for a
    whole row: ``-slope * |i - j|`` (``(i - j)`` when not ``symmetric``),
    then ``NEG`` where ``|i - j| > window`` or, with ``causal``, ``j > i``."""
    pos = torch.arange(L, device=device)
    delta = pos[:, None] - pos[None, :]
    bias = torch.zeros((1, L, L), dtype=torch.float32, device=device)
    if slopes is not None:
        dist = (delta.abs() if symmetric else delta).float()
        bias = -slopes.float().to(device)[:, None, None] * dist[None]
    if window is not None:
        bias = torch.where(delta.abs() <= window, bias, NEG)
    if causal:
        bias = torch.where(delta >= 0, bias, NEG)
    return bias


def _heads_first(*ts):
    """[B, L, H, hd] -> float32 [B, H, L, hd]."""
    return [t.float().permute(0, 2, 1, 3) for t in ts]


def _scores(qf, kf, slopes, causal, window, symmetric, scale):
    L = qf.shape[2]
    bias = block_bias(L, slopes, causal, window, symmetric, qf.device)
    return qf @ kf.transpose(-1, -2) * scale + bias


def default_scale(hd: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(hd) if scale is None else float(scale)


def flash_fwd_plain(q, k, v, slopes=None, causal: bool = False,
                    window: Optional[int] = None, symmetric: bool = True,
                    scale: Optional[float] = None):
    """Plain K7: ``(o [B, L, H, hd] in q's dtype, lse [B*H, L] float32)``."""
    B, L, H, hd = q.shape
    qf, kf, vf = _heads_first(q, k, v)
    s = _scores(qf, kf, slopes, causal, window, symmetric, default_scale(hd, scale))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (p @ vf) / l
    lse = (m + torch.log(l)).reshape(B * H, L)
    return o.permute(0, 2, 1, 3).to(q.dtype).contiguous(), lse


def flash_bwd_plain(q, k, v, o, do, lse, slopes=None, causal: bool = False,
                    window: Optional[int] = None, symmetric: bool = True,
                    scale: Optional[float] = None):
    """Plain K8: ``(dq, dk, dv)`` ``[B, L, H, hd]`` in the dtypes of q, k and
    v, from the forward's ``o`` and ``lse`` and the cotangent ``do``."""
    B, L, H, hd = q.shape
    sc = default_scale(hd, scale)
    qf, kf, vf, of, gf = _heads_first(q, k, v, o, do)
    s = _scores(qf, kf, slopes, causal, window, symmetric, sc)
    p = torch.exp(s - lse.float().reshape(B, H, L, 1))
    delta = (gf * of).sum(-1, keepdim=True)
    dv = p.transpose(-1, -2) @ gf
    ds = p * (gf @ vf.transpose(-1, -2) - delta)
    dq = sc * (ds @ kf)
    dk = sc * (ds.transpose(-1, -2) @ qf)
    return tuple(g.permute(0, 2, 1, 3).to(t.dtype).contiguous()
                 for g, t in ((dq, q), (dk, k), (dv, v)))
