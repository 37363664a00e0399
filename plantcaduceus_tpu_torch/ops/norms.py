"""Normalisation layers (fp32 internals, weight-only RMSNorm as in Mamba).

Counterpart of ``plantcaduceus_tpu.ops.norms``: both compute in fp32 and
return the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis. Computes in fp32, returns x.dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def layer_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last axis. Computes in fp32, returns x.dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)
