"""int8 matmul primitives (counterpart of ``plantcaduceus_tpu.ops.quant``),
wired into no model, as in the JAX package.

The JAX module's docstring records a rejected experiment on the TPU: its
int8 × int8 → int32 products ran faster than bf16 at the mixer projection
shapes on that chip's matrix unit, yet the whole scoring path with int8
projections (dynamic per-tensor activation scales, then static per-layer
scales calibrated on a first batch) stayed at or below bf16 end to end,
because the selective scan, not the projections, bounds the mixer there.
Its engine and CLI path were removed and these primitives kept for other
hardware. Those are TPU measurements; nothing here states a figure for
this port or the H100.

The functions compute what JAX's do, with the same rounding (round half to
even, then a clip to ±127) and the same order of the rescale's products:
weight quantisation per output channel, dynamic and static activation
quantisation per tensor, and the int8 product with its float32 rescale.
The integer product is ``torch._int_mm`` on the card (int8 inputs, int32
accumulation; it takes more than 16 rows and inner and outer sizes that
are multiples of 8, and raises otherwise) and an exact int32 product on the
CPU. Neither is a hand-written kernel: JAX computes it with
``lax.dot_general``, not a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_weight(w: torch.Tensor, reduce_axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8. ``reduce_axis`` is the contraction
    axis; the scale broadcasts over the remaining axes.

    Returns (w8 int8, scale float32 with reduce_axis collapsed to size 1)."""
    w = w.float()
    amax = w.abs().amax(dim=reduce_axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w8, scale


def quantize_activation(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-tensor symmetric int8: one amax over the whole tensor."""
    xf = x.float()
    amax = xf.abs().amax()
    scale = torch.clamp(amax, min=1e-12) / 127.0
    x8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x8, scale


def quantize_activation_static(x: torch.Tensor, a_scale: torch.Tensor) -> torch.Tensor:
    """Quantize with a pre-calibrated scale (no amax reduction). Values
    beyond the calibration range saturate at ±127."""
    xf = x.float()
    return torch.clamp(torch.round(xf * (1.0 / a_scale)), -127, 127).to(torch.int8)


def _int8_product(x8: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 @ [K, N] int8 -> [M, N] int32, exact."""
    if x8.dtype != torch.int8 or w8.dtype != torch.int8:
        raise ValueError(f"int8 product of {x8.dtype} and {w8.dtype}; both must be int8")
    if x8.device.type == "cuda":
        return torch._int_mm(x8.contiguous(), w8.contiguous())
    return x8.to(torch.int32) @ w8.to(torch.int32)


def int8_matmul(x8: torch.Tensor, w8: torch.Tensor, scale: torch.Tensor,
                out_dtype=torch.float32) -> torch.Tensor:
    """[..., d_in] int8 @ [d_in, d_out] int8 -> int32 accumulation, rescaled
    by ``scale`` (= a_scale * w_scale, broadcastable over the output)."""
    lead = x8.shape[:-1]
    y32 = _int8_product(x8.reshape(-1, x8.shape[-1]), w8)
    y = y32.float() * scale
    return y.reshape(*lead, w8.shape[-1]).to(out_dtype)


def int8_dense(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
               out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w8) with a dynamic activation scale.

    x: [..., d_in]; w8: [d_in, d_out] int8; w_scale: [1, d_out] float32."""
    x8, sx = quantize_activation(x)
    return int8_matmul(x8, w8, sx * w_scale, out_dtype)


def int8_dense_static(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
                      a_scale: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ dequant(w8) with a pre-calibrated activation scale ``a_scale``
    (a scalar: this layer's calibrated amax/127)."""
    return int8_matmul(quantize_activation_static(x, a_scale), w8, a_scale * w_scale,
                       out_dtype)
