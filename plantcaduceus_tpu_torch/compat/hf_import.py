"""Strict HF Caduceus checkpoint loader: ``*.safetensors`` or ``pytorch_model*.bin`` -> model.

Counterpart of ``plantcaduceus_tpu.compat.hf_import``, with the same
contract: every state-dict tensor is consumed exactly once (known torch
buffers aside), every mapped leaf must have the shape the config implies,
and a lookup that matches several keys is an error. A checkpoint therefore
maps correctly or fails naming the key.

Mapping: torch Linear ``[out, in]`` -> ``[in, out]``; depthwise conv
``[C, 1, K]`` -> ``[C, K]``; BiMamba fwd/rev weights stacked on the
direction axis (tied in/out projections collapse to one). Mamba-1: packed
in_proj rows ``[x | z]`` and x_proj rows ``[dt | B | C]`` split. Mamba-2
(mamba_ssm ``Mamba2`` packing): in_proj rows ``[z | x | B | C | dt]``, the
conv over the packed ``[x | B | C]`` stream, per-head dt_bias/A_log/D and
the gated-RMSNorm weight beside out_proj.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from plantcaduceus_tpu_torch.compat.params import from_jax_params
from plantcaduceus_tpu_torch.io import safetensors
from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def load_state_dict(model_dir) -> Dict[str, np.ndarray]:
    """All tensors of a checkpoint dir as float32 numpy arrays, in the JAX
    package's order: every ``*.safetensors`` file (sorted and merged, shards
    included, read by the port's ``io.safetensors``), else every
    ``pytorch_model*.bin`` (``torch.load(weights_only=True)``)."""
    p = Path(model_dir)
    if any(p.glob("*.safetensors")):
        return {k: np.asarray(v, np.float32) for k, v in safetensors.load_dir(p).items()}
    bin_files = sorted(p.glob("pytorch_model*.bin"))
    if not bin_files:
        raise FileNotFoundError(f"no *.safetensors or pytorch_model*.bin under {p}")
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
    # Mamba-2 checkpoints: exports write ssm_variant; mamba_ssm-convention
    # configs mark ssm_cfg.layer == "Mamba2".
    is_m2 = data.get("ssm_variant") == "mamba2" or ssm.get("layer") == "Mamba2"
    extra = {}
    if is_m2:
        extra = {"ssm_variant": "mamba2", "head_dim": ssm.get("headdim", 128),
                 "n_groups": ssm.get("ngroups", 1), "chunk_size": ssm.get("chunk_size", 128)}
    cmap = data.get("complement_map")
    if isinstance(cmap, dict):
        cmap = tuple(cmap[str(i)] if str(i) in cmap else cmap[i]
                     for i in range(len(cmap)))
    return CaduceusConfig(
        d_model=data["d_model"],
        n_layer=data["n_layer"],
        vocab_size=data.get("vocab_size", 16),
        d_state=ssm.get("d_state", 128 if is_m2 else 16),
        d_conv=ssm.get("d_conv", 4),
        expand=ssm.get("expand", 2),
        **extra,
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
    if cfg.ssm_variant == "mamba2":
        H, NGN = cfg.n_heads, cfg.n_groups * cfg.d_state
        blocks = {
            "norm_weight": (L, d),
            "in_proj_x": (L, gio, d, di),
            "in_proj_z": (L, gio, d, di),
            "in_proj_B": (L, G, d, NGN),
            "in_proj_C": (L, G, d, NGN),
            "in_proj_dt": (L, G, d, H),
            "conv_x_w": (L, G, di, K),
            "conv_x_b": (L, G, di),
            "conv_B_w": (L, G, NGN, K),
            "conv_B_b": (L, G, NGN),
            "conv_C_w": (L, G, NGN, K),
            "conv_C_b": (L, G, NGN),
            "mixer_norm_weight": (L, gio, di),
            "out_proj": (L, gio, di, d),
            "dt_bias": (L, G, H),
            "A_log": (L, G, H),
            "D": (L, G, H),
        }
    else:
        blocks = {
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
        }
    want = {"embedding": (V, d), "norm_f_weight": (d,), "blocks": blocks}
    if has_lm_head:
        want["lm_head"] = (V, d)
    return want


def _dir_name(g: int) -> str:
    return "mamba_fwd" if g == 0 else "mamba_rev"


def _per_dir(r: _Resolver, i: int, G: int, *frag, transform=lambda x: x) -> np.ndarray:
    """Layer i's tensor ``frag`` of each direction (the unwrapped name when a
    model has one direction), stacked; raises if their shapes disagree."""
    base = f"layers.{i}."
    vals = []
    for g in range(G):
        v = r.maybe(base, _dir_name(g), *frag)
        if v is None:
            v = r.get(base, *frag)
        vals.append(transform(v))
    if len({v.shape for v in vals}) > 1:
        raise ValueError(
            f"strict import: mapped tensor shapes disagree between directions for "
            f"layer {i} {'.'.join(frag)}: {[v.shape for v in vals]} (transposed weights?)")
    return np.stack(vals)


def _per_dir_weights(r: _Resolver, i: int, G: int, name: str):
    """``name`` (e.g. ``in_proj.weight``) of each direction, or the one
    unwrapped tensor of a unidirectional model."""
    base = f"layers.{i}."
    ws = [r.maybe(base, _dir_name(g), name) for g in range(G)]
    if ws[0] is None:  # unidirectional naming without wrapper
        ws = [r.get(base, name)]
    return ws


def _layer_mamba1(r: _Resolver, i: int, cfg: CaduceusConfig):
    G = cfg.n_directions
    R, N = cfg.dt_rank, cfg.d_state
    in_w = _per_dir_weights(r, i, G, "in_proj.weight")
    tied = len(in_w) == 1 or in_w[1] is None or np.array_equal(in_w[0], in_w[1])
    # torch in_proj.weight is [2*di, d], rows [:di] = x, [di:] = z
    in_kept = [w.T for w in in_w[:(1 if tied else G)]]
    di = in_kept[0].shape[1] // 2
    out_w = _per_dir_weights(r, i, G, "out_proj.weight")
    x_proj = _per_dir(r, i, G, "x_proj.weight", transform=lambda w: w.T)  # [G, di, R+2N]
    return {
        "norm_weight": r.get(f"layers.{i}.", "norm", "weight"),
        "in_proj_x": np.stack([w[:, :di] for w in in_kept]),
        "in_proj_z": np.stack([w[:, di:] for w in in_kept]),
        "out_proj": np.stack([w.T for w in out_w[:(1 if tied else G)]]),
        "conv_w": _per_dir(r, i, G, "conv1d.weight", transform=lambda w: w[:, 0, :]),
        "conv_b": _per_dir(r, i, G, "conv1d.bias"),
        "x_proj_dt": x_proj[..., :R],
        "x_proj_B": x_proj[..., R:R + N],
        "x_proj_C": x_proj[..., R + N:],
        "dt_proj_w": _per_dir(r, i, G, "dt_proj.weight", transform=lambda w: w.T),
        "dt_proj_b": _per_dir(r, i, G, "dt_proj.bias"),
        "A_log": _per_dir(r, i, G, "A_log"),
        "D": _per_dir(r, i, G, "D"),
    }


def _layer_mamba2(r: _Resolver, i: int, cfg: CaduceusConfig):
    """One Mamba-2 block. Direction tying is read from the z|x rows of
    in_proj; when they are tied, the reverse direction's gated-norm weight
    and out_proj must equal the forward's (else the checkpoint is not one
    this layout holds, and the import raises)."""
    G = cfg.n_directions
    di, NGN = cfg.d_inner, cfg.n_groups * cfg.d_state
    base = f"layers.{i}."
    in_w = [w for w in _per_dir_weights(r, i, G, "in_proj.weight") if w is not None]
    tied = len(in_w) == 1 or np.array_equal(in_w[0][:2 * di], in_w[1][:2 * di])
    keep = 1 if tied else G
    # rows: [z (di) | x (di) | B (NGN) | C (NGN) | dt (H)]
    per_dir_in = [in_w[min(g, len(in_w) - 1)] for g in range(G)]
    norm_w = []
    for g in range(G):
        v = r.maybe(base, _dir_name(g), "norm.weight")
        if v is None:  # anchored on "mixer": the block's own norm is layers.{i}.norm
            v = r.get(base, "mixer", "norm.weight")
        norm_w.append(v)
    out_w = [w for w in _per_dir_weights(r, i, G, "out_proj.weight") if w is not None]
    if tied and not (np.array_equal(norm_w[0], norm_w[-1])
                     and np.array_equal(out_w[0], out_w[-1])):
        raise ValueError(f"strict import: layer {i} ties in_proj across directions but "
                         "not its gated-norm weight or out_proj")
    bn = r.maybe(f"layers.{i}.norm.weight")
    if bn is None:
        bn = r.maybe(f"layers.{i}.norm.submodule.weight")
    if bn is None:
        raise KeyError(f"block norm weight not found for layer {i}")
    cw = _per_dir(r, i, G, "conv1d.weight", transform=lambda w: w[:, 0, :])
    cb = _per_dir(r, i, G, "conv1d.bias")
    return {
        "norm_weight": bn,
        "in_proj_x": np.stack([w[di:2 * di].T for w in in_w[:keep]]),
        "in_proj_z": np.stack([w[:di].T for w in in_w[:keep]]),
        "in_proj_B": np.stack([w[2 * di:2 * di + NGN].T for w in per_dir_in]),
        "in_proj_C": np.stack([w[2 * di + NGN:2 * di + 2 * NGN].T for w in per_dir_in]),
        "in_proj_dt": np.stack([w[2 * di + 2 * NGN:].T for w in per_dir_in]),
        "conv_x_w": cw[:, :di],
        "conv_x_b": cb[:, :di],
        "conv_B_w": cw[:, di:di + NGN],
        "conv_B_b": cb[:, di:di + NGN],
        "conv_C_w": cw[:, di + NGN:],
        "conv_C_b": cb[:, di + NGN:],
        "mixer_norm_weight": np.stack(norm_w[:keep]),
        "out_proj": np.stack([w.T for w in out_w[:keep]]),
        "dt_bias": _per_dir(r, i, G, "dt_bias"),
        "A_log": _per_dir(r, i, G, "A_log"),
        "D": _per_dir(r, i, G, "D"),
    }


def _build_pytree(r: _Resolver, sd: Dict[str, np.ndarray], cfg: CaduceusConfig):
    layer = _layer_mamba2 if cfg.ssm_variant == "mamba2" else _layer_mamba1
    layers = [layer(r, i, cfg) for i in range(cfg.n_layer)]
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
