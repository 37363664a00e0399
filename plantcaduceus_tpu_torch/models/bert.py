"""MosaicBERT-style baseline: ALiBi encoder with a gated-linear-unit FFN.

Counterpart of ``plantcaduceus_tpu.models.bert``, the reference's attention
baseline (ALiBi bias instead of position embeddings, GLU FFN, post-norm
blocks, tied MLM head; optional RoPE with PI/NTK/YaRN context extension and
optional local-window attention). Not used by the Caduceus path.

Attention goes through ``ops.attention.multi_head_attention``: ALiBi, a
local window or causal masking pass as structured forms, which run kernel
K7 on the card (K8 in the backward) and the kernels' plain versions on the
CPU; ``use_kernels=False`` takes the einsum path instead. The dtype flow is
the JAX package's: weights are float32 master copies cast to the compute
``dtype`` where they are used, matmuls and the residual sum run in
``dtype``, layer norms compute in float32 and return ``dtype``, and GELU is
JAX's default tanh form.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from plantcaduceus_tpu_torch.models.caduceus import CaduceusLayer, _param
from plantcaduceus_tpu_torch.ops import attention as attn_ops
from plantcaduceus_tpu_torch.ops import rotary as rope_ops
from plantcaduceus_tpu_torch.ops.norms import layer_norm
from plantcaduceus_tpu_torch.utils.device import resolve_device

LAYER_KEYS = ("qkv_w", "qkv_b", "attn_out_w", "attn_out_b", "ln1_w", "ln1_b", "ffn_in_w",
              "ffn_in_b", "ffn_out_w", "ffn_out_b", "ln2_w", "ln2_b")
TOP_KEYS = ("embedding", "emb_ln_w", "emb_ln_b", "head_dense_w", "head_dense_b",
            "head_ln_w", "head_ln_b", "head_bias")


@dataclasses.dataclass
class BertConfig:
    vocab_size: int = 16
    d_model: int = 256
    n_layer: int = 4
    n_heads: int = 8
    ffn_mult: int = 4
    glu: bool = True                 # MosaicBERT GatedLinearUnit FFN
    position: str = "alibi"          # alibi | rope | none
    rope_scaling: str = "none"       # none | interpolate | ntk | yarn
    rope_scale: float = 1.0
    rope_base: float = 10000.0
    original_max_len: int = 2048     # for rope scaling schemes
    local_window: Optional[int] = None
    norm_epsilon: float = 1e-12
    pad_token_id: int = 4

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def d_ffn(self) -> int:
        return self.ffn_mult * self.d_model


def init_params(cfg: BertConfig, generator: Optional[torch.Generator] = None,
                seed: int = 0) -> dict:
    """Parameter dict in the JAX package's layout (block leaves stacked on a
    leading n_layer axis), float32 on the CPU: matrices N(0, 0.02), biases
    0, layer-norm weights 1, as JAX ``init_params``; drawn from
    ``generator`` (default: a new one seeded with ``seed``), so the numbers
    differ from JAX's for the same seed."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    d, f, nl = cfg.d_model, cfg.d_ffn, cfg.n_layer
    cols = 2 * f if cfg.glu else f

    def lin(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    zeros, ones = torch.zeros, torch.ones
    return {
        "embedding": lin(cfg.vocab_size, d),
        "blocks": {
            "qkv_w": lin(nl, d, 3 * d), "qkv_b": zeros(nl, 3 * d),
            "attn_out_w": lin(nl, d, d), "attn_out_b": zeros(nl, d),
            "ln1_w": ones(nl, d), "ln1_b": zeros(nl, d),
            "ffn_in_w": lin(nl, d, cols), "ffn_in_b": zeros(nl, cols),
            "ffn_out_w": lin(nl, f, d), "ffn_out_b": zeros(nl, d),
            "ln2_w": ones(nl, d), "ln2_b": zeros(nl, d),
        },
        "emb_ln_w": ones(d), "emb_ln_b": zeros(d),
        "head_dense_w": lin(d, d), "head_dense_b": zeros(d),
        "head_ln_w": ones(d), "head_ln_b": zeros(d),
        "head_bias": zeros(cfg.vocab_size),
    }


class Bert(nn.Module):
    """The encoder with its MLM head. Weights are float32 and built frozen;
    ``requires_grad_()`` makes them train."""

    def __init__(self, cfg: BertConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for k in TOP_KEYS:
            setattr(self, k, _param(params[k]))
        blocks = params["blocks"]
        self.layers = nn.ModuleList(CaduceusLayer({k: blocks[k][i] for k in LAYER_KEYS},
                                                  LAYER_KEYS) for i in range(cfg.n_layer))

    def forward(self, input_ids: torch.Tensor, dtype=torch.bfloat16,
                use_kernels: bool = True) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids, dtype=dtype, use_kernels=use_kernels)


def build(cfg: BertConfig, params: Optional[dict] = None, seed: int = 0,
          device="cuda") -> Bert:
    """The model on ``device`` (the card unless the caller asks for the CPU;
    raises when the card is asked for and absent), from ``params`` or from
    :func:`init_params` with ``seed``."""
    dev = resolve_device(device)
    return Bert(cfg, params if params is not None else init_params(cfg, seed=seed)).to(dev)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _dense(x, w, b, dtype):
    return x @ w.to(dtype) + b.to(dtype)


def forward(model: Bert, input_ids: torch.Tensor, dtype=torch.bfloat16,
            use_kernels: bool = True) -> Dict[str, torch.Tensor]:
    """``{"logits": [B, L, vocab], "hidden_states": [B, L, d_model]}`` (JAX
    ``bert.forward``). ``use_kernels=False`` runs attention on the einsum
    path (the plain path the kernels are held to on the card)."""
    cfg = model.cfg
    B, L = input_ids.shape
    H, hd, eps = cfg.n_heads, cfg.head_dim, cfg.norm_epsilon
    x = model.embedding.to(dtype)[input_ids]
    x = layer_norm(x, model.emb_ln_w, model.emb_ln_b, eps)
    alibi = cfg.position == "alibi"
    cos = sin = None
    if cfg.position == "rope":
        cos, sin = rope_ops.rope_tables(
            L, hd, base=cfg.rope_base, scaling=cfg.rope_scaling, scale=cfg.rope_scale,
            original_max_len=cfg.original_max_len, device=input_ids.device)
    impl = "auto" if use_kernels else "xla"
    for lp in model.layers:
        qkv = _dense(x, lp.qkv_w, lp.qkv_b, dtype)
        q, k, v = qkv.reshape(B, L, 3 * H, hd).split(H, dim=2)
        if cos is not None:
            q = rope_ops.apply_rotary(q, cos, sin)
            k = rope_ops.apply_rotary(k, cos, sin)
        a = attn_ops.multi_head_attention(q, k, v, alibi=alibi, local_window=cfg.local_window,
                                          impl=impl)
        a = _dense(a.reshape(B, L, cfg.d_model), lp.attn_out_w, lp.attn_out_b, dtype)
        x = layer_norm(x + a, lp.ln1_w, lp.ln1_b, eps)  # post-norm residual
        h = _dense(x, lp.ffn_in_w, lp.ffn_in_b, dtype)
        if cfg.glu:
            gate, up = h.chunk(2, dim=-1)
            h = gelu(gate) * up
        else:
            h = gelu(h)
        h = _dense(h, lp.ffn_out_w, lp.ffn_out_b, dtype)
        x = layer_norm(x + h, lp.ln2_w, lp.ln2_b, eps)

    # MLM head: dense + gelu + layer norm, then the tied decoder
    h = gelu(_dense(x, model.head_dense_w, model.head_dense_b, dtype))
    h = layer_norm(h, model.head_ln_w, model.head_ln_b, eps)
    logits = h @ model.embedding.to(dtype).T + model.head_bias.to(dtype)
    return {"logits": logits, "hidden_states": x}
