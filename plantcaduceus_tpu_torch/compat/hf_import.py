"""Strict HF Caduceus checkpoint loader: ``pytorch_model*.bin`` -> model.

Counterpart of ``plantcaduceus_tpu.compat.hf_import`` for Mamba-1
checkpoints, with the same contract: every state-dict tensor is consumed
exactly once (known torch buffers aside), every mapped leaf must have the
shape the config implies, and a lookup that matches several keys is an
error. A checkpoint therefore maps correctly or fails naming the key.

Mapping: torch Linear ``[out, in]`` -> ``[in, out]``; depthwise conv
``[di, 1, K]`` -> ``[di, K]``; BiMamba fwd/rev weights stacked on the
direction axis (tied in/out projections collapse to one); packed in_proj
rows ``[x | z]`` and x_proj rows ``[dt | B | C]`` split.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from plantcaduceus_tpu_torch.compat.params import from_jax_params
from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def load_state_dict(model_dir) -> Dict[str, np.ndarray]:
    """All tensors of ``pytorch_model*.bin`` (shards included), as float32
    numpy arrays, read with ``torch.load(weights_only=True)``."""
    p = Path(model_dir)
    bin_files = sorted(p.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(
            f"no pytorch_model*.bin under {p} (safetensors checkpoints are "
            "not read by the PyTorch port)")
    tensors: Dict[str, np.ndarray] = {}
    for f in bin_files:
        sd = torch.load(str(f), map_location="cpu", weights_only=True)
        for k, v in sd.items():
            tensors[k] = v.float().numpy()
    return tensors


def load_hf_config(model_dir) -> CaduceusConfig:
    """Translate the HF config.json into a CaduceusConfig."""
    data = json.loads((Path(model_dir) / "config.json").read_text())
    ssm = data.get("ssm_cfg") or {}
    if data.get("ssm_variant") == "mamba2" or ssm.get("layer") == "Mamba2":
        raise NotImplementedError("the PyTorch port covers Mamba-1 checkpoints only")
    cmap = data.get("complement_map")
    if isinstance(cmap, dict):
        cmap = tuple(cmap[str(i)] if str(i) in cmap else cmap[i]
                     for i in range(len(cmap)))
    return CaduceusConfig(
        d_model=data["d_model"],
        n_layer=data["n_layer"],
        vocab_size=data.get("vocab_size", 16),
        d_state=ssm.get("d_state", 16),
        d_conv=ssm.get("d_conv", 4),
        expand=ssm.get("expand", 2),
        bidirectional=data.get("bidirectional", True),
        bidirectional_strategy=data.get("bidirectional_strategy", "add"),
        bidirectional_weight_tie=data.get("bidirectional_weight_tie", True),
        rcps=data.get("rcps", True),
        complement_map=cmap,
        rms_norm=data.get("rms_norm", True),
        norm_epsilon=data.get("norm_epsilon", 1e-5),
        residual_in_fp32=data.get("residual_in_fp32", True),
        tie_word_embeddings=data.get("tie_word_embeddings", True),
        pad_token_id=data.get("pad_token_id", 4),
    )


class AmbiguousKeyError(KeyError):
    """More than one state-dict key matches a lookup pattern."""


class _Resolver:
    """State-dict key lookup that allows extra wrapper segments
    (submodule/module/model) anywhere in the path, and records every key it
    hands out so the import can prove nothing was left over."""

    def __init__(self, sd: Dict[str, np.ndarray]):
        self.sd = sd
        self._keys = list(sd.keys())
        self.consumed: Dict[str, int] = {}

    def find(self, *fragments: str) -> Optional[str]:
        pat = ".*".join(re.escape(f) for f in fragments)
        rx = re.compile(rf"(^|\.){pat}$")
        hits = [k for k in self._keys if rx.search(k)]
        if len(hits) > 1:
            raise AmbiguousKeyError(
                f"state-dict pattern {fragments} matches {len(hits)} keys — "
                f"refusing to guess: {sorted(hits)}")
        if hits:
            self.consumed[hits[0]] = self.consumed.get(hits[0], 0) + 1
            return hits[0]
        return None

    def get(self, *fragments: str) -> np.ndarray:
        k = self.find(*fragments)
        if k is None:
            raise KeyError(f"no state-dict key matching {fragments}; "
                           f"sample keys: {self._keys[:8]}")
        return np.asarray(self.sd[k], np.float32)

    def maybe(self, *fragments: str) -> Optional[np.ndarray]:
        k = self.find(*fragments)
        return None if k is None else np.asarray(self.sd[k], np.float32)

    def unconsumed(self):
        return [k for k in self._keys if k not in self.consumed]


# Non-parameter torch buffers that may ride along in a state dict.
_IGNORABLE = re.compile(
    r"(^|\.)(position_ids|inv_freq|num_batches_tracked|rotary_emb\.[^.]+)$")


def _expected_shapes(cfg: CaduceusConfig, gio: int, has_lm_head: bool):
    d, di, N, K = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.d_conv
    L, V, G, R = cfg.n_layer, cfg.vocab_size, cfg.n_directions, cfg.dt_rank
    want = {
        "embedding": (V, d),
        "norm_f_weight": (d,),
        "blocks": {
            "norm_weight": (L, d),
            "in_proj_x": (L, gio, d, di),
            "in_proj_z": (L, gio, d, di),
            "out_proj": (L, gio, di, d),
            "conv_w": (L, G, di, K),
            "conv_b": (L, G, di),
            "x_proj_dt": (L, G, di, R),
            "x_proj_B": (L, G, di, N),
            "x_proj_C": (L, G, di, N),
            "dt_proj_w": (L, G, R, di),
            "dt_proj_b": (L, G, di),
            "A_log": (L, G, di, N),
            "D": (L, G, di),
        },
    }
    if has_lm_head:
        want["lm_head"] = (V, d)
    return want


def _build_pytree(r: _Resolver, sd: Dict[str, np.ndarray], cfg: CaduceusConfig):
    G = cfg.n_directions
    R, N = cfg.dt_rank, cfg.d_state

    def layer(i: int):
        base = f"layers.{i}."

        def dir_name(g: int) -> str:
            return "mamba_fwd" if g == 0 else "mamba_rev"

        in_w = [r.maybe(base, dir_name(g), "in_proj.weight") for g in range(G)]
        if in_w[0] is None:  # unidirectional naming without wrapper
            in_w = [r.get(base, "in_proj.weight")]
        tied = len(in_w) == 1 or in_w[1] is None or np.array_equal(in_w[0], in_w[1])
        # torch in_proj.weight is [2*di, d], rows [:di] = x, [di:] = z
        in_kept = [w.T for w in in_w[:(1 if tied else G)]]
        di = in_kept[0].shape[1] // 2
        out_w = [r.maybe(base, dir_name(g), "out_proj.weight") for g in range(G)]
        if out_w[0] is None:
            out_w = [r.get(base, "out_proj.weight")]

        def per_dir(*frag, transform=lambda x: x):
            vals = []
            for g in range(G):
                v = r.maybe(base, dir_name(g), *frag)
                if v is None:
                    v = r.get(base, *frag)
                vals.append(transform(v))
            if len({v.shape for v in vals}) > 1:
                raise ValueError(
                    f"strict import: mapped tensor shapes disagree between "
                    f"directions for layer {i} {'.'.join(frag)}: "
                    f"{[v.shape for v in vals]} (transposed weights?)")
            return np.stack(vals)

        x_proj = per_dir("x_proj.weight", transform=lambda w: w.T)  # [G, di, R+2N]
        return {
            "norm_weight": r.get(base, "norm", "weight"),
            "in_proj_x": np.stack([w[:, :di] for w in in_kept]),
            "in_proj_z": np.stack([w[:, di:] for w in in_kept]),
            "out_proj": np.stack([w.T for w in out_w[:(1 if tied else G)]]),
            "conv_w": per_dir("conv1d.weight", transform=lambda w: w[:, 0, :]),
            "conv_b": per_dir("conv1d.bias"),
            "x_proj_dt": x_proj[..., :R],
            "x_proj_B": x_proj[..., R:R + N],
            "x_proj_C": x_proj[..., R + N:],
            "dt_proj_w": per_dir("dt_proj.weight", transform=lambda w: w.T),
            "dt_proj_b": per_dir("dt_proj.bias"),
            "A_log": per_dir("A_log"),
            "D": per_dir("D"),
        }

    layers = [layer(i) for i in range(cfg.n_layer)]
    emb_key = r.find("embeddings", "weight") or r.find("word_embeddings", "weight")
    if emb_key is None:
        raise KeyError("embedding weights not found")
    params = {
        "embedding": np.asarray(sd[emb_key], np.float32),
        "blocks": {k: np.stack([l[k] for l in layers]) for k in layers[0]},
        "norm_f_weight": r.get("norm_f", "weight"),
    }
    lm = r.maybe("lm_head", "weight")
    if lm is not None and not np.array_equal(lm, params["embedding"]):
        params["lm_head"] = lm
    return params


def import_params(model_dir, cfg: Optional[CaduceusConfig] = None):
    """(numpy parameter pytree in the JAX layout, config) from an HF
    checkpoint dir, with the strict bijection and shape checks."""
    if cfg is None:
        cfg = load_hf_config(model_dir)
    sd = load_state_dict(model_dir)
    r = _Resolver(sd)
    params = _build_pytree(r, sd, cfg)
    stray = [k for k in r.unconsumed() if not _IGNORABLE.search(k)]
    if stray:
        raise ValueError(
            f"strict import: {len(stray)} state-dict tensor(s) were never "
            f"consumed by the mapping: {sorted(stray)[:20]}")
    gio = int(params["blocks"]["in_proj_x"].shape[1])
    if gio not in (1, cfg.n_directions):
        raise ValueError(f"strict import: in/out projection direction axis is "
                         f"{gio}, expected 1 (tied) or {cfg.n_directions}")
    want = _expected_shapes(cfg, gio, "lm_head" in params)
    errs = [f"{name}: got {tuple(leaf.shape)}, want {expect}"
            for name, leaf, expect in (
                [(k, params[k], want[k]) for k in want if k != "blocks"]
                + [(f"blocks.{k}", params["blocks"][k], want["blocks"][k])
                   for k in want["blocks"]])
            if tuple(leaf.shape) != expect]
    if errs:
        raise ValueError("strict import: mapped tensor shapes disagree with the "
                         "config (transposed/misplaced weights?):\n  " + "\n  ".join(errs))
    return params, cfg


def import_model(model_dir, cfg: Optional[CaduceusConfig] = None):
    """(Caduceus on the CPU, config) from an HF checkpoint dir."""
    params, cfg = import_params(model_dir, cfg)
    return from_jax_params(params, cfg), cfg
