"""PEFT LoRA adapter import/export (the released-adapter interchange format).

Counterpart of ``plantcaduceus_tpu.compat.peft_adapter``. The reference
ecosystem ships LoRA fine-tunes as PEFT adapter directories
(adapter_config.json + adapter_model.safetensors; 21 released adapters,
resolved through PeftConfig.base_model_name_or_path). This module maps that
format onto the port's stacked adapter tree (``train/lora.py``, numpy
arrays here) and back, exactly as the JAX package does, so a PEFT dir is
the route for adapters between the two packages:

* torch Linear LoRA (y += B @ A @ x, A [r, in], B [out, r]) -> our
  input-side layout a = A.T [in, r], b = B.T [r, out] (delta = a@b,
  scaled alpha/r identically),
* the fused torch ``in_proj`` [2*d_inner, d] splits into in_proj_x /
  in_proj_z halves (lora_B rows [:di] / [di:], same split as
  compat/hf_import.py),
* torch ``x_proj`` [R+2N, d_inner] splits into x_proj_dt / x_proj_B /
  x_proj_C (lora_B row blocks dt / B / C),
* BiMamba direction naming (mamba_fwd/mamba_rev, or a single tied module)
  stacks onto the G axis; per-layer tensors stack onto the n_layer axis,
* ``modules_to_save`` classification heads map onto models/heads.py
  {"w", "b"} when the feature width matches,
* strict ledger: every adapter tensor must be consumed, mirroring
  hf_import's bijection proof.

Tensor files: ``adapter_model.safetensors`` through the port's
``io.safetensors`` (the export always writes it, as the JAX package does
where its ``safetensors`` package is installed), else ``adapter_model.bin``
through ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from plantcaduceus_tpu_torch.compat.hf_import import _Resolver
from plantcaduceus_tpu_torch.io import safetensors
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train.lora import LoraConfig

# the torch modules PEFT adapts, whose lora_B rows split onto our targets
_TORCH_TARGETS = ("in_proj", "x_proj", "out_proj")

_TASK_FROM_PEFT = {"SEQ_CLS": "classification"}


def _load_adapter_tensors(adapter_dir: Path) -> Dict[str, np.ndarray]:
    st = adapter_dir / "adapter_model.safetensors"
    if st.exists():
        return safetensors.load_file(st)
    bn = adapter_dir / "adapter_model.bin"
    if bn.exists():
        import torch

        sd = torch.load(str(bn), map_location="cpu", weights_only=True)
        return {k: v.float().numpy() for k, v in sd.items()}
    raise FileNotFoundError(f"no adapter_model.{{safetensors,bin}} under "
                            f"{adapter_dir}")


def _np(t) -> np.ndarray:
    """A tensor (any device) or array as a float32 numpy array."""
    if hasattr(t, "detach"):
        t = t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def is_peft_adapter_dir(path) -> bool:
    """A PEFT dir carries peft_type/target_modules in adapter_config.json;
    the packages' own adapter dirs carry 'targets' and their tensor files."""
    p = Path(path)
    cfgf = p / "adapter_config.json"
    if not cfgf.exists():
        return False
    try:
        meta = json.loads(cfgf.read_text())
    except ValueError:
        return False
    return "target_modules" in meta or "peft_type" in meta


def import_peft_adapter(
    adapter_dir,
    cfg: CaduceusConfig,
    strict: bool = True,
) -> Tuple[Dict, Optional[Dict], LoraConfig, str, str]:
    """-> (adapters, head|None, LoraConfig, task_type, base_model_name).

    ``adapters`` (numpy float32) matches train.lora.init_lora's layout, so
    as tensors it drops into lora_ctx / apply_lora / the evaluate/predict
    CLIs unchanged."""
    adapter_dir = Path(adapter_dir)
    meta = json.loads((adapter_dir / "adapter_config.json").read_text())
    r_rank = int(meta["r"])
    cfg_l = LoraConfig(
        r=r_rank,
        alpha=float(meta.get("lora_alpha", meta.get("alpha", r_rank))),
        dropout=float(meta.get("lora_dropout", meta.get("dropout", 0.0))),
    )
    task_type = _TASK_FROM_PEFT.get(meta.get("task_type", ""),
                                    meta.get("task_type") or "classification")
    base_model = str(meta.get("base_model_name_or_path", ""))
    targets = set(meta.get("target_modules") or _TORCH_TARGETS)

    sd = _load_adapter_tensors(adapter_dir)
    r = _Resolver(sd)
    G = cfg.n_directions
    di, d = cfg.d_inner, cfg.d_model
    R, N = cfg.dt_rank, cfg.d_state

    def dir_name(g: int) -> str:
        return "mamba_fwd" if g == 0 else "mamba_rev"

    def pair(base: str, torch_name: str, g: Optional[int]):
        """(A, B) for one adapted Linear, or None when absent."""
        frags = ((base, dir_name(g), torch_name) if g is not None
                 else (base, torch_name))
        A = r.maybe(*frags, "lora_A", "weight")
        if A is None:
            return None
        B = r.maybe(*frags, "lora_B", "weight")
        if B is None:
            raise KeyError(f"{torch_name} layer pattern {frags} has lora_A "
                           f"but no lora_B")
        return np.asarray(A, np.float32), np.asarray(B, np.float32)

    def per_layer(torch_name: str):
        """[(A, B) per direction] per layer; directions collapse to the
        tied single module when per-direction names are absent."""
        out = []
        for i in range(cfg.n_layer):
            base = f"layers.{i}."
            per_dir = [pair(base, torch_name, g) for g in range(G)]
            if per_dir[0] is None:
                tied = pair(base, torch_name, None)
                if tied is None:
                    raise KeyError(
                        f"adapter names {torch_name} in target_modules but "
                        f"layer {i} has no matching lora_A tensor")
                per_dir = [tied]
            elif any(p is None for p in per_dir[1:]):
                raise KeyError(f"layer {i} {torch_name}: partial "
                               f"per-direction adapter tensors")
            out.append(per_dir)
        n_dir = {len(l) for l in out}
        if len(n_dir) != 1:
            raise ValueError(f"{torch_name}: inconsistent direction counts "
                             f"across layers: {n_dir}")
        return out

    adapters: Dict[str, Dict[str, np.ndarray]] = {}

    def put(name: str, a_stack, b_stack):
        adapters[name] = {"a": np.asarray(a_stack, np.float32),
                          "b": np.asarray(b_stack, np.float32)}

    def stack(layers, fa, fb):
        # layers: [n_layer][n_dir](A, B) -> a [L, n_dir, in, r], b [L, n_dir, r, out]
        a = np.stack([np.stack([fa(A) for A, _ in l]) for l in layers])
        b = np.stack([np.stack([fb(B) for _, B in l]) for l in layers])
        return a, b

    if "in_proj" in targets:
        layers = per_layer("in_proj")
        A0, B0 = layers[0][0]
        if A0.shape != (r_rank, d) or B0.shape != (2 * di, r_rank):
            raise ValueError(
                f"in_proj adapter shapes A{A0.shape} B{B0.shape} disagree "
                f"with config (want A ({r_rank}, {d}), B ({2 * di}, {r_rank}))")
        at = lambda A: A.T                      # [d, r]
        put("in_proj_x", *stack(layers, at, lambda B: B[:di].T))
        put("in_proj_z", *stack(layers, at, lambda B: B[di:].T))

    if "x_proj" in targets:
        layers = per_layer("x_proj")
        A0, B0 = layers[0][0]
        if A0.shape != (r_rank, di) or B0.shape != (R + 2 * N, r_rank):
            raise ValueError(
                f"x_proj adapter shapes A{A0.shape} B{B0.shape} disagree "
                f"with config (want A ({r_rank}, {di}), "
                f"B ({R + 2 * N}, {r_rank}))")
        if len(layers[0]) != G:  # tied module: replicate onto the G axis
            layers = [l * G for l in layers]
        at = lambda A: A.T                      # [di, r]
        put("x_proj_dt", *stack(layers, at, lambda B: B[:R].T))
        put("x_proj_B", *stack(layers, at, lambda B: B[R:R + N].T))
        put("x_proj_C", *stack(layers, at, lambda B: B[R + N:].T))

    if "out_proj" in targets:
        layers = per_layer("out_proj")
        A0, B0 = layers[0][0]
        if A0.shape != (r_rank, di) or B0.shape != (d, r_rank):
            raise ValueError(
                f"out_proj adapter shapes A{A0.shape} B{B0.shape} disagree "
                f"with config (want A ({r_rank}, {di}), B ({d}, {r_rank}))")
        put("out_proj", *stack(layers, lambda A: A.T, lambda B: B.T))

    # modules_to_save classification/regression head (PEFT saves the full
    # fine-tuned Linear, e.g. base_model.model.score.modules_to_save.weight).
    head = None
    hw = r.maybe("score", "weight")
    if hw is None:
        hw = r.maybe("classifier", "weight")
    if hw is not None:
        hw = np.asarray(hw, np.float32)
        if hw.shape[1] != d:
            raise ValueError(
                f"adapter head in_features={hw.shape[1]} does not match this "
                f"framework's RC-averaged feature width d_model={d} — "
                f"retrain the head with lora_fine_tune train, or evaluate "
                f"with the reference pooling")
        hb = r.maybe("score", "bias")
        if hb is None:
            hb = r.maybe("classifier", "bias")
        head = {"w": hw.T,
                "b": (np.asarray(hb, np.float32) if hb is not None
                      else np.zeros((hw.shape[0],), np.float32))}

    if strict:
        stray = r.unconsumed()
        if stray:
            raise ValueError(
                f"strict adapter import: {len(stray)} tensor(s) were never "
                f"consumed — unknown adapter layout: {sorted(stray)[:20]}")
    if not adapters:
        raise ValueError(f"no supported target_modules in {sorted(targets)}")
    return adapters, head, cfg_l, task_type, base_model


def export_peft_adapter(directory, adapters: Dict, head: Optional[Dict],
                        cfg: CaduceusConfig, cfg_l: LoraConfig,
                        task_type: str, base_model: str = "") -> None:
    """Write a PEFT-format adapter dir (the inverse mapping; round-trip
    tested). Only the torch-target-compatible adapter set exports: the
    in_proj halves and x_proj splits must all be present and share lora_A
    (always true for adapters imported from PEFT; adapters trained here
    have independent A per split, and per-split deltas are not expressible
    in PEFT's fused-Linear format — those raise). Tensors may be numpy
    arrays or torch tensors."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    adapters = {n: {k: _np(v) for k, v in ab.items()} for n, ab in adapters.items()}
    head = None if head is None else {k: _np(v) for k, v in head.items()}
    sd: Dict[str, np.ndarray] = {}

    def dirs_of(name):
        return adapters[name]["a"].shape[1]

    def key(i, g, n_dir, torch_name, ab):
        mid = "" if n_dir == 1 else f".{'mamba_fwd' if g == 0 else 'mamba_rev'}"
        return (f"base_model.model.backbone.layers.{i}.mixer{mid}."
                f"{torch_name}.{ab}.weight")

    def export_fused(torch_name, parts, axis_concat):
        names = [p for p in parts if p in adapters]
        if not names:
            return
        if len(names) != len(parts):
            raise ValueError(f"{torch_name}: partial splits {names} cannot "
                             f"export to PEFT's fused Linear")
        n_dir = dirs_of(names[0])
        for i in range(cfg.n_layer):
            for g in range(n_dir):
                a0 = adapters[names[0]]["a"][i, g]
                for p in names[1:]:
                    if not np.allclose(adapters[p]["a"][i, g], a0,
                                       atol=0, rtol=0):
                        raise ValueError(
                            f"{torch_name} splits have independent lora_A "
                            f"at layer {i} — not expressible in PEFT")
                B = np.concatenate(
                    [adapters[p]["b"][i, g].T for p in names], axis=0)
                sd[key(i, g, n_dir, torch_name, "lora_A")] = a0.T
                sd[key(i, g, n_dir, torch_name, "lora_B")] = B

    export_fused("in_proj", ["in_proj_x", "in_proj_z"], 0)
    export_fused("x_proj", ["x_proj_dt", "x_proj_B", "x_proj_C"], 0)
    if "out_proj" in adapters:
        n_dir = dirs_of("out_proj")
        for i in range(cfg.n_layer):
            for g in range(n_dir):
                sd[key(i, g, n_dir, "out_proj", "lora_A")] = \
                    adapters["out_proj"]["a"][i, g].T
                sd[key(i, g, n_dir, "out_proj", "lora_B")] = \
                    adapters["out_proj"]["b"][i, g].T
    if head is not None:
        sd["base_model.model.score.modules_to_save.weight"] = \
            np.asarray(head["w"], np.float32).T
        sd["base_model.model.score.modules_to_save.bias"] = \
            np.asarray(head["b"], np.float32)

    safetensors.save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
                          directory / "adapter_model.safetensors")

    peft_task = {v: k for k, v in _TASK_FROM_PEFT.items()}.get(task_type,
                                                               task_type)
    (directory / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA",
        "task_type": peft_task,
        "r": cfg_l.r,
        "lora_alpha": cfg_l.alpha,
        "lora_dropout": cfg_l.dropout,
        "target_modules": [t for t, parts in
                           (("in_proj", ("in_proj_x",)),
                            ("x_proj", ("x_proj_dt",)),
                            ("out_proj", ("out_proj",)))
                           if parts[0] in adapters],
        "base_model_name_or_path": base_model,
    }, indent=2))
