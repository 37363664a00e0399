"""GPN dilated-convolution baseline masked LM.

Counterpart of ``plantcaduceus_tpu.models.gpn``, the reference's ConvNet
genomic LM: an embedding, a stack of dilated convolutions (dilation cycling
powers of two up to a cap), each followed by a residual layer norm and a
pointwise FFN with a residual layer norm, and a linear head. The weighted
masked CE is ``models.caduceus.mlm_loss`` on its logits, as in JAX.

The dilated convolution is ``F.conv1d`` with SAME padding and
``dilation``: JAX computes it with ``lax.conv_general_dilated``, outside any
Pallas kernel, so a library call is its counterpart. The dtype flow is
JAX's: float32 master weights cast to the compute ``dtype`` where used,
layer norms in float32 returning ``dtype``, tanh GELU. No CLI or trainer,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from plantcaduceus_tpu_torch.models.caduceus import CaduceusLayer, _param
from plantcaduceus_tpu_torch.ops.norms import layer_norm
from plantcaduceus_tpu_torch.utils.device import resolve_device

LAYER_KEYS = ("conv_w", "conv_b", "ln1_w", "ln1_b", "ffn_in_w", "ffn_in_b",
              "ffn_out_w", "ffn_out_b", "ln2_w", "ln2_b")
TOP_KEYS = ("embedding", "head_w", "head_b")


@dataclasses.dataclass
class GpnConfig:
    vocab_size: int = 16
    d_model: int = 256
    n_layer: int = 8
    kernel_size: int = 9
    dilation_max: int = 32
    dilation_double_every: int = 1
    dilation_cycle: int = 6
    ffn_mult: int = 4
    norm_epsilon: float = 1e-12

    def dilation_schedule(self) -> List[int]:
        """The reference's get_dilation_schedule: dilation doubles every
        ``dilation_double_every`` layers, capped at ``dilation_max``, cycling
        with period ``dilation_cycle``."""
        return [min(self.dilation_max,
                    2 ** ((i % self.dilation_cycle) // self.dilation_double_every))
                for i in range(self.n_layer)]


def init_params(cfg: GpnConfig, generator: Optional[torch.Generator] = None,
                seed: int = 0) -> dict:
    """Parameters in the JAX package's layout (``layers`` a list of dicts;
    ``conv_w`` [kernel, in, out]), float32 on the CPU: matrices N(0, 0.02),
    biases 0, layer-norm weights 1, as JAX ``init_params``; drawn from
    ``generator`` (default: a new one seeded with ``seed``), so the numbers
    differ from JAX's for the same seed."""
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    d, f, K = cfg.d_model, cfg.ffn_mult * cfg.d_model, cfg.kernel_size

    def lin(*shape):
        return 0.02 * torch.randn(shape, generator=gen)

    layers = [{"conv_w": lin(K, d, d), "conv_b": torch.zeros(d),
               "ln1_w": torch.ones(d), "ln1_b": torch.zeros(d),
               "ffn_in_w": lin(d, f), "ffn_in_b": torch.zeros(f),
               "ffn_out_w": lin(f, d), "ffn_out_b": torch.zeros(d),
               "ln2_w": torch.ones(d), "ln2_b": torch.zeros(d)}
              for _ in range(cfg.n_layer)]
    return {"embedding": lin(cfg.vocab_size, d), "layers": layers,
            "head_w": lin(d, cfg.vocab_size), "head_b": torch.zeros(cfg.vocab_size)}


class Gpn(nn.Module):
    """The dilated-conv LM. Weights are float32 and built frozen;
    ``requires_grad_()`` makes them train."""

    def __init__(self, cfg: GpnConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        for k in TOP_KEYS:
            setattr(self, k, _param(torch.as_tensor(params[k])))
        self.layers = nn.ModuleList(
            CaduceusLayer({k: torch.as_tensor(lp[k]) for k in LAYER_KEYS}, LAYER_KEYS)
            for lp in params["layers"])

    def forward(self, input_ids: torch.Tensor, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
        return forward(self, input_ids, dtype=dtype)


def build(cfg: GpnConfig, params: Optional[dict] = None, seed: int = 0,
          device="cuda") -> Gpn:
    """The model on ``device`` (the card unless the caller asks for the CPU;
    raises when the card is asked for and absent)."""
    dev = resolve_device(device)
    return Gpn(cfg, params if params is not None else init_params(cfg, seed=seed)).to(dev)


def dilated_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 dilation: int) -> torch.Tensor:
    """SAME-padded dilated convolution along L. x: [B, L, d]; w: [K, in, out]."""
    K = w.shape[0]
    total = (K - 1) * dilation            # SAME: the output keeps L
    y = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(y, w.to(x.dtype).permute(2, 1, 0), dilation=dilation)
    return y.transpose(1, 2) + b.to(x.dtype)


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def forward(model: Gpn, input_ids: torch.Tensor, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """``{"logits": [B, L, vocab], "hidden_states": [B, L, d_model]}`` (JAX
    ``gpn.forward``)."""
    cfg = model.cfg
    eps = cfg.norm_epsilon
    x = model.embedding.to(dtype)[input_ids]
    for lp, dil in zip(model.layers, cfg.dilation_schedule()):
        h = _gelu(dilated_conv(x, lp.conv_w, lp.conv_b, dil))
        x = layer_norm(x + h, lp.ln1_w, lp.ln1_b, eps)
        h = _gelu(x @ lp.ffn_in_w.to(dtype) + lp.ffn_in_b.to(dtype))
        h = h @ lp.ffn_out_w.to(dtype) + lp.ffn_out_b.to(dtype)
        x = layer_norm(x + h, lp.ln2_w, lp.ln2_b, eps)
    logits = x @ model.head_w.to(dtype) + model.head_b.to(dtype)
    return {"logits": logits, "hidden_states": x}
