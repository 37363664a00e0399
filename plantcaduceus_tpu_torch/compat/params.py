"""Carry weights across from the JAX package's parameter pytree.

The pytree, given as numpy arrays, is
``{"embedding", "blocks": {leaf: [n_layer, ...]}, "norm_f_weight"[, "lm_head"]}``
— the layout of ``plantcaduceus_tpu.models.caduceus.init_params`` and of
``plantcaduceus_tpu.compat.hf_import.import_params``.
"""

from __future__ import annotations

import numpy as np
import torch

from plantcaduceus_tpu_torch.models.caduceus import LAYER_KEYS, Caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def from_jax_params(params_np: dict, cfg: CaduceusConfig) -> Caduceus:
    """Build the port's model (on the CPU, float32) from the JAX pytree's
    numpy arrays. Raises on a missing leaf."""
    missing = [k for k in LAYER_KEYS if k not in params_np["blocks"]]
    if missing:
        raise KeyError(f"parameter pytree lacks block leaves {missing}")

    def conv(v):
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))

    params = {k: conv(v) for k, v in params_np.items() if k != "blocks"}
    params["blocks"] = {k: conv(params_np["blocks"][k]) for k in LAYER_KEYS}
    return Caduceus(cfg, params)


def to_jax_params(model: Caduceus) -> dict:
    """The inverse of :func:`from_jax_params`: the model's weights as the JAX
    pytree of float32 numpy arrays (block leaves stacked on n_layer)."""
    def conv(t):
        return t.detach().float().cpu().numpy().copy()

    params = {"embedding": conv(model.embedding),
              "blocks": {k: np.stack([conv(getattr(layer, k)) for layer in model.layers])
                         for k in LAYER_KEYS},
              "norm_f_weight": conv(model.norm_f_weight)}
    if model.lm_head is not None:
        params["lm_head"] = conv(model.lm_head)
    return params
