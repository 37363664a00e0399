"""Model + tokenizer resolution for the port's CLIs.

Accepts an HF checkpoint directory (config.json and ``*.safetensors``, sharded
or not, or ``pytorch_model*.bin``, read by the strict loader of
``compat.hf_import``) or a preset spec
``<preset>[:random]`` that builds a model of the published size with
weights drawn from a seeded ``torch.Generator``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Tuple

from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import PRESETS, CaduceusConfig

log = logging.getLogger(__name__)


def load_model_and_tokenizer(spec: str, seed: int = 0) -> Tuple[Caduceus, CaduceusConfig, DnaTokenizer]:
    """Resolve ``spec`` to (model on the CPU, config, tokenizer)."""
    path = Path(spec)
    if path.is_dir():
        try:
            tokenizer = DnaTokenizer.from_hf_dir(path)
        except FileNotFoundError:
            tokenizer = DnaTokenizer()
        if (path / "params").is_dir():
            raise NotImplementedError(
                f"{path} is a JAX framework checkpoint (Orbax); the PyTorch port "
                "reads HF checkpoints only — export one with "
                "plantcaduceus_tpu.compat.hf_export.export_hf_dir")
        from plantcaduceus_tpu_torch.compat.hf_import import import_model

        log.info("Importing HF checkpoint from %s", path)
        model, cfg = import_model(path)
        return model, cfg, tokenizer

    name = spec.split(":")[0]
    if name not in PRESETS:
        raise FileNotFoundError(
            f"model spec {spec!r} is neither a checkpoint dir nor a preset "
            f"({sorted(PRESETS)})")
    log.info("Building randomly initialised preset %s (seed %d)", name, seed)
    cfg = CaduceusConfig.preset(name)
    return Caduceus(cfg, init_params(cfg, seed=seed)), cfg, DnaTokenizer()


def load_tokenizer_only(spec: str) -> DnaTokenizer:
    """The tokenizer of an HF checkpoint dir (its vocab files), else the
    default DNA tokenizer (a preset name, or a dir without vocab files)."""
    path = Path(spec)
    if path.is_dir():
        try:
            return DnaTokenizer.from_hf_dir(path)
        except FileNotFoundError:
            pass
    return DnaTokenizer()
