"""Rotary position embeddings with context-extension scaling.

Counterpart of ``plantcaduceus_tpu.ops.rotary``: (cos, sin) tables for
vanilla RoPE, Position Interpolation, NTK-aware scaling and YaRN, and the
helper that applies them. Tables are float32 and computed in float32, in
the JAX package's order of operations.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def rope_frequencies(head_dim: int, base: float = 10000.0, device=None) -> torch.Tensor:
    """Standard RoPE inverse frequencies ``[head_dim/2]``."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (torch.tensor(base, dtype=torch.float32, device=device) ** exps)


def rope_tables(seq_len: int, head_dim: int, base: float = 10000.0,
                scaling: str = "none", scale: float = 1.0,
                original_max_len: int = 2048,
                yarn_beta_fast: float = 32.0, yarn_beta_slow: float = 1.0,
                yarn_attn_factor: float = 1.0, device=None,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables ``[seq_len, head_dim/2]``.

    scaling:
      none        — vanilla RoPE
      interpolate — Position Interpolation: positions divided by ``scale``
      ntk         — NTK-aware: base multiplied by scale^(dim/(dim-2))
      yarn        — YaRN: per-frequency interpolation ramp between PI-scaled
                    and unscaled frequencies + attention temperature factor
    """
    positions = torch.arange(seq_len, dtype=torch.float32, device=device)
    inv = rope_frequencies(head_dim, base, device)
    mscale = 1.0

    if scaling == "none" or scale == 1.0:
        pass
    elif scaling == "interpolate":
        positions = positions / scale
    elif scaling == "ntk":
        base = base * scale ** (head_dim / (head_dim - 2))
        inv = rope_frequencies(head_dim, base, device)
    elif scaling == "yarn":
        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        # the ramp's ends, in bands: 0 (keep) where the wavelength is short
        # against the context, 1 (interpolate) where it is long
        low = head_dim / 2 * torch.log(f32(original_max_len / (yarn_beta_fast * 2 * math.pi))) \
            / torch.log(f32(base))
        high = head_dim / 2 * torch.log(f32(original_max_len / (yarn_beta_slow * 2 * math.pi))) \
            / torch.log(f32(base))
        idx = torch.arange(head_dim // 2, dtype=torch.float32, device=device)
        ramp = torch.clip((idx - low) / torch.clamp(high - low, min=1e-3), 0, 1)
        inv_interp = inv / scale
        inv = inv * (1 - ramp) + inv_interp * ramp
        # attention temperature (YaRN eq. 22): sqrt(1/t) ~ 0.1 ln(s) + 1
        mscale = (0.1 * math.log(scale) + 1.0) * yarn_attn_factor
    else:
        raise ValueError(f"unknown rope scaling {scaling!r}")

    angles = positions[:, None] * inv[None, :]
    return torch.cos(angles) * mscale, torch.sin(angles) * mscale


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs of channels. x: ``[..., L, H, head_dim]``; tables
    ``[L, head_dim/2]``. The result takes the promoted dtype of x and the
    tables, as in JAX."""
    x1, x2 = x.chunk(2, dim=-1)
    c = cos[:, None, :]
    s = sin[:, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
