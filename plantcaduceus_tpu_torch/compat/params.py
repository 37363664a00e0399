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
