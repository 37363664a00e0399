"""Carry weights across from the JAX package's parameter pytrees.

The Caduceus pytree, given as numpy arrays, is
``{"embedding", "blocks": {leaf: [n_layer, ...]}, "norm_f_weight"[, "lm_head"]}``
— the layout of ``plantcaduceus_tpu.models.caduceus.init_params`` and of
``plantcaduceus_tpu.compat.hf_import.import_params``. The BERT baseline's
is that of ``plantcaduceus_tpu.models.bert.init_params`` (the JAX package
has no HF export for it, so the pytree is the crossing), and the AR Mamba
LM's that of ``plantcaduceus_tpu.models.mamba_lm.init_params``, and the GPN
baseline's that of ``plantcaduceus_tpu.models.gpn.init_params`` (``layers``
a list of per-layer dicts).
"""

from __future__ import annotations

import numpy as np
import torch

from plantcaduceus_tpu_torch.models import bert, gpn, mamba_lm
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, layer_keys
from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def from_jax_params(params_np: dict, cfg: CaduceusConfig) -> Caduceus:
    """Build the port's model (on the CPU, float32) from the JAX pytree's
    numpy arrays, for either SSM variant. Raises on a missing leaf."""
    keys = layer_keys(cfg)
    return Caduceus(cfg, _torch_pytree(params_np, keys))


def _torch_pytree(params_np: dict, keys) -> dict:
    """The pytree's arrays as float32 tensors; raises on a missing block leaf."""
    missing = [k for k in keys if k not in params_np["blocks"]]
    if missing:
        raise KeyError(f"parameter pytree lacks block leaves {missing}")

    def conv(v):
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))

    params = {k: conv(v) for k, v in params_np.items() if k != "blocks"}
    params["blocks"] = {k: conv(params_np["blocks"][k]) for k in keys}
    return params


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def to_jax_params(model) -> dict:
    """The inverse of :func:`from_jax_params` (and of
    :func:`mamba_lm_from_jax_params`): the model's weights as the JAX pytree
    of float32 numpy arrays (block leaves stacked on n_layer)."""
    params = {"embedding": _numpy(model.embedding),
              "blocks": {k: np.stack([_numpy(getattr(layer, k)) for layer in model.layers])
                         for k in layer_keys(model.cfg)},
              "norm_f_weight": _numpy(model.norm_f_weight)}
    if model.lm_head is not None:
        params["lm_head"] = _numpy(model.lm_head)
    return params


def bert_from_jax_params(params_np: dict, cfg: bert.BertConfig) -> bert.Bert:
    """The port's BERT baseline (on the CPU, float32) from the JAX
    ``bert.init_params`` pytree's numpy arrays. Raises on a missing leaf."""
    missing = [k for k in bert.TOP_KEYS if k not in params_np]
    if missing:
        raise KeyError(f"parameter pytree lacks leaves {missing}")
    return bert.Bert(cfg, _torch_pytree(params_np, bert.LAYER_KEYS))


def bert_to_jax_params(model: bert.Bert) -> dict:
    """The inverse of :func:`bert_from_jax_params`: the JAX pytree of float32
    numpy arrays (block leaves stacked on n_layer)."""
    params = {k: _numpy(getattr(model, k)) for k in bert.TOP_KEYS}
    params["blocks"] = {k: np.stack([_numpy(getattr(layer, k)) for layer in model.layers])
                        for k in bert.LAYER_KEYS}
    return params


def mamba_lm_from_jax_params(params_np: dict, cfg: mamba_lm.MambaLmConfig) -> mamba_lm.MambaLm:
    """The port's AR Mamba LM (on the CPU, float32) from the JAX
    ``mamba_lm`` pytree's numpy arrays (blocks stacked on n_layer, the
    optional ``lm_head``), for either SSM variant. Raises on a missing leaf."""
    top = ("embedding", "norm_f_weight") + (() if cfg.tie_word_embeddings else ("lm_head",))
    missing = [k for k in top if k not in params_np]
    if missing:
        raise KeyError(f"parameter pytree lacks leaves {missing}")
    return mamba_lm.MambaLm(cfg, _torch_pytree(params_np, layer_keys(cfg)))



def gpn_from_jax_params(params_np: dict, cfg: gpn.GpnConfig) -> gpn.Gpn:
    """The port's GPN baseline (on the CPU, float32) from the JAX
    ``gpn.init_params`` pytree's numpy arrays. Raises on a missing leaf."""
    missing = [k for k in gpn.TOP_KEYS if k not in params_np]
    missing += [f"layers/{i}/{k}" for i, lp in enumerate(params_np.get("layers", []))
                for k in gpn.LAYER_KEYS if k not in lp]
    if missing or len(params_np.get("layers", [])) != cfg.n_layer:
        raise KeyError(f"parameter pytree lacks leaves {missing or ['layers']}")

    def conv(v):
        return torch.from_numpy(np.array(v, dtype=np.float32, copy=True))

    return gpn.Gpn(cfg, {**{k: conv(params_np[k]) for k in gpn.TOP_KEYS},
                         "layers": [{k: conv(lp[k]) for k in gpn.LAYER_KEYS}
                                    for lp in params_np["layers"]]})


def gpn_to_jax_params(model: gpn.Gpn) -> dict:
    """The inverse of :func:`gpn_from_jax_params`: the JAX pytree of float32
    numpy arrays."""
    return {**{k: _numpy(getattr(model, k)) for k in gpn.TOP_KEYS},
            "layers": [{k: _numpy(getattr(layer, k)) for k in gpn.LAYER_KEYS}
                       for layer in model.layers]}
