"""Export the port's parameters as an HF-style checkpoint directory.

Counterpart of ``plantcaduceus_tpu.compat.hf_export``, and the inverse of
``compat.hf_import``: config.json and pytorch_model.bin with the Caduceus
remote-code naming and packing (RCPS wrappers, BiMamba fwd/rev; Mamba-1:
packed in_proj ``[2di, d]`` and x_proj ``[R+2N, di]``; Mamba-2: mamba_ssm
``Mamba2``'s in_proj rows ``[z | x | B | C | dt]``, conv1d over ``[x | B |
C]``, per-direction gated norm, out_proj, dt_bias, A_log and D), so weights
trained by the port load in the port's and the JAX package's importers and,
structurally, in the reference's torch stack.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def export_state_dict(params, cfg: CaduceusConfig) -> Dict[str, np.ndarray]:
    """JAX-layout parameter pytree (numpy, as ``compat.params.to_jax_params``
    gives) -> torch-convention state dict of float32 numpy arrays."""
    blocks = {k: np.asarray(v, np.float32) for k, v in params["blocks"].items()}
    sd: Dict[str, np.ndarray] = {}
    emb_key = ("caduceus.backbone.embeddings.word_embeddings.embedding.weight"
               if cfg.rcps else
               "caduceus.backbone.embeddings.word_embeddings.weight")
    sd[emb_key] = np.asarray(params["embedding"], np.float32)
    mixer = _mixer_mamba2 if cfg.ssm_variant == "mamba2" else _mixer_mamba1
    for i in range(cfg.n_layer):
        base = f"caduceus.backbone.layers.{i}"
        norm_key = (f"{base}.norm.submodule.weight" if cfg.rcps
                    else f"{base}.norm.weight")
        sd[norm_key] = blocks["norm_weight"][i]
        for g in range(cfg.n_directions):
            prefix = f"{base}.mixer.submodule" if cfg.rcps else f"{base}.mixer"
            m = (f"{prefix}.{'mamba_fwd' if g == 0 else 'mamba_rev'}"
                 if cfg.bidirectional else prefix)
            mixer(sd, m, blocks, i, g)
    normf_key = ("caduceus.backbone.norm_f.submodule.weight" if cfg.rcps
                 else "caduceus.backbone.norm_f.weight")
    sd[normf_key] = np.asarray(params["norm_f_weight"], np.float32)
    if "lm_head" in params:
        sd["lm_head.lm_head.weight"] = np.asarray(params["lm_head"], np.float32)
    return sd


def _tied(blocks, key, i, g):
    """Layer i's leaf for direction g: per direction, or shared when tied."""
    return blocks[key][i, min(g, blocks[key].shape[1] - 1)]


def _mixer_mamba1(sd, m, blocks, i, g) -> None:
    # packed in_proj rows: [x | z], torch [2di, d]
    sd[f"{m}.in_proj.weight"] = np.concatenate(
        [_tied(blocks, "in_proj_x", i, g).T, _tied(blocks, "in_proj_z", i, g).T], axis=0)
    sd[f"{m}.out_proj.weight"] = _tied(blocks, "out_proj", i, g).T
    sd[f"{m}.conv1d.weight"] = blocks["conv_w"][i, g][:, None, :]
    sd[f"{m}.conv1d.bias"] = blocks["conv_b"][i, g]
    # packed x_proj rows: [dt | B | C], torch [R+2N, di]
    sd[f"{m}.x_proj.weight"] = np.concatenate(
        [blocks["x_proj_dt"][i, g].T, blocks["x_proj_B"][i, g].T,
         blocks["x_proj_C"][i, g].T], axis=0)
    sd[f"{m}.dt_proj.weight"] = blocks["dt_proj_w"][i, g].T
    sd[f"{m}.dt_proj.bias"] = blocks["dt_proj_b"][i, g]
    sd[f"{m}.A_log"] = blocks["A_log"][i, g]
    sd[f"{m}.D"] = blocks["D"][i, g]


def _mixer_mamba2(sd, m, blocks, i, g) -> None:
    # mamba_ssm Mamba2 in_proj rows: [z | x | B | C | dt]
    sd[f"{m}.in_proj.weight"] = np.concatenate(
        [_tied(blocks, "in_proj_z", i, g).T, _tied(blocks, "in_proj_x", i, g).T,
         blocks["in_proj_B"][i, g].T, blocks["in_proj_C"][i, g].T,
         blocks["in_proj_dt"][i, g].T], axis=0)
    # conv over the packed [x | B | C] stream
    sd[f"{m}.conv1d.weight"] = np.concatenate(
        [blocks["conv_x_w"][i, g], blocks["conv_B_w"][i, g],
         blocks["conv_C_w"][i, g]], axis=0)[:, None, :]
    sd[f"{m}.conv1d.bias"] = np.concatenate(
        [blocks["conv_x_b"][i, g], blocks["conv_B_b"][i, g], blocks["conv_C_b"][i, g]],
        axis=0)
    sd[f"{m}.norm.weight"] = _tied(blocks, "mixer_norm_weight", i, g)
    sd[f"{m}.out_proj.weight"] = _tied(blocks, "out_proj", i, g).T
    sd[f"{m}.dt_bias"] = blocks["dt_bias"][i, g]
    sd[f"{m}.A_log"] = blocks["A_log"][i, g]
    sd[f"{m}.D"] = blocks["D"][i, g]


def export_hf_dir(directory, params, cfg: CaduceusConfig) -> None:
    """Write config.json + pytorch_model.bin, loadable by ``compat.hf_import``
    (the port's and the JAX package's)."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    ssm_cfg = {"d_state": cfg.d_state, "d_conv": cfg.d_conv, "expand": cfg.expand}
    if cfg.ssm_variant == "mamba2":
        # mamba_ssm Mamba2 config naming for the SSD-specific dims
        ssm_cfg.update({"layer": "Mamba2", "headdim": cfg.head_dim,
                        "ngroups": cfg.n_groups, "chunk_size": cfg.chunk_size})
    (directory / "config.json").write_text(json.dumps({
        "model_type": "caduceus",
        "d_model": cfg.d_model,
        "n_layer": cfg.n_layer,
        "vocab_size": cfg.vocab_size,
        "ssm_variant": cfg.ssm_variant,
        "ssm_cfg": ssm_cfg,
        "rcps": cfg.rcps,
        "bidirectional": cfg.bidirectional,
        "bidirectional_strategy": cfg.bidirectional_strategy,
        "bidirectional_weight_tie": cfg.bidirectional_weight_tie,
        "complement_map": {str(i): int(c) for i, c in enumerate(cfg.complement_map)},
        "rms_norm": cfg.rms_norm,
        "norm_epsilon": cfg.norm_epsilon,
        "residual_in_fp32": cfg.residual_in_fp32,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "pad_token_id": cfg.pad_token_id,
    }, indent=2))
    sd = export_state_dict(params, cfg)
    torch.save({k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
                for k, v in sd.items()}, directory / "pytorch_model.bin")
