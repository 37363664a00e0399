"""Attention ops for the baseline (BERT-family) models.

Counterpart of ``plantcaduceus_tpu.ops.attention``:

* ``alibi_slopes`` — the ALiBi head slopes (power-of-two schedule, extended
  for other head counts);
* ``alibi_bias`` — MosaicBERT's symmetric ALiBi bias ``[H, L, L]``;
* ``local_window_mask`` — banded additive mask ``[L, L]``;
* ``multi_head_attention`` — attention on ``[B, L, H, hd]``.

Dispatch of ``multi_head_attention`` (``impl="auto"``): a structured bias
(``alibi``, ``local_window`` or ``causal``) given with no bias or mask array
goes to ``ops.cuda_attention.flash_attention`` — kernel K7 on CUDA tensors
(and K8 under autograd), its plain versions on CPU tensors. Everything else
takes the einsum path, which the JAX package also runs outside any Pallas
kernel. The JAX package sends structured forms to its kernel only on a TPU
and only at lengths the TPU tiles (``L <= 128`` or ``L % 128 == 0``); the
card's kernel takes any length, so every structured call on the card
reaches K7.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops.cuda_attention import flash_attention


def alibi_slopes(n_heads: int, device=None) -> torch.Tensor:
    """ALiBi head slopes ``[n_heads]`` float32 (power-of-two geometric
    schedule, extended for non-power-of-two head counts). Made once per
    ``(n_heads, device)`` and shared by every later call, so a model's
    forward copies no host list to the card per layer; do not modify the
    result in place."""
    return _alibi_slopes(n_heads, torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=None)
def _alibi_slopes(n_heads: int, device: torch.device) -> torch.Tensor:
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(n_heads).is_integer():
        s = pow2_slopes(n_heads)
    else:
        closest = 2 ** math.floor(math.log2(n_heads))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][: n_heads - closest]
    with torch.inference_mode(False):  # a normal tensor, usable under autograd later
        return torch.tensor(s, dtype=torch.float32, device=device)


def alibi_bias(n_heads: int, seq_len: int, device=None) -> torch.Tensor:
    """Symmetric (bidirectional-encoder) ALiBi bias ``[n_heads, L, L]``:
    ``-slope * |i - j|``."""
    pos = torch.arange(seq_len, device=device)
    dist = (pos[None, :] - pos[:, None]).abs().float()
    return -alibi_slopes(n_heads, device)[:, None, None] * dist[None]


def local_window_mask(seq_len: int, window: int, device=None) -> torch.Tensor:
    """``[L, L]`` additive mask: 0 within ``+-window``, ``-inf`` outside."""
    pos = torch.arange(seq_len, device=device)
    dist = (pos[None, :] - pos[:, None]).abs()
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(dist <= window, zero, -math.inf)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    alibi: bool = False,
    local_window: Optional[int] = None,
    impl: str = "auto",
) -> torch.Tensor:
    """q, k, v: ``[B, L, H, hd]``. ``bias`` and ``mask``: additive,
    broadcastable to ``[B, H, L, L]``. Returns ``[B, L, H, hd]``; softmax in
    float32. ``impl``: auto | flash | xla (the einsum path, named as in the
    JAX package); ``flash`` takes structured forms only."""
    if alibi and bias is not None:
        raise ValueError("pass either alibi=True or an explicit bias")
    if impl == "auto":
        structured = alibi or local_window is not None or causal
        impl = "flash" if (structured and bias is None and mask is None) else "xla"
    if impl == "flash":
        if bias is not None or mask is not None:
            raise ValueError("flash impl takes structured bias forms only "
                             "(alibi/local_window/causal), not arrays")
        return flash_attention(
            q, k, v, alibi_slopes=alibi_slopes(q.shape[2], q.device) if alibi else None,
            causal=causal, local_window=local_window)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}: auto | flash | xla")
    L, dev = q.shape[1], q.device
    if alibi:
        bias = alibi_bias(q.shape[2], L, dev)
    if local_window is not None:
        lw = local_window_mask(L, local_window, dev)
        mask = lw if mask is None else mask + lw
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("blhd,bmhd->bhlm", q, k).float() * scale
    if bias is not None:
        logits = logits + bias
    if mask is not None:
        logits = logits + mask
    if causal:
        pos = torch.arange(L, device=dev)
        logits = logits + torch.where(pos[None, :] <= pos[:, None], 0.0, -math.inf)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhd->blhd", probs, v)
