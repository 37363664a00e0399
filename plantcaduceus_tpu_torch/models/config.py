"""Model configuration (kept in step with plantcaduceus_tpu.models.config).

Mirrors the capability surface of the HF ``CaduceusConfig`` that the reference
loads as remote code (see SURVEY.md §2.2: config keys d_model/n_layer, injected
complement_map, vocab padded to a multiple of 8 —
the reference repository's pretrain/llmlib/architectures/models/mamba/caduceus.py:100-125),
expressed as a plain dataclass for the unified config system.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, Optional, Tuple


# Released model sizes (reference README.md:56-63 and docs/PlantCAD2-overview.md:17-21).
PRESETS: Dict[str, dict] = {
    "l20": dict(d_model=384, n_layer=20),   # PlantCaduceus_l20, 20M, 512 bp
    "l24": dict(d_model=512, n_layer=24),   # PlantCaduceus_l24, 40M, 512 bp
    "l28": dict(d_model=768, n_layer=28),   # PlantCaduceus_l28, 128M, 512 bp
    "l32": dict(d_model=1024, n_layer=32),  # PlantCaduceus_l32, 225M, 512 bp
    "pc2-small": dict(d_model=768, n_layer=24),    # PlantCAD2-Small,  8192 bp
    "pc2-medium": dict(d_model=1024, n_layer=48),  # PlantCAD2-Medium, 8192 bp
    "pc2-large": dict(d_model=1536, n_layer=48),   # PlantCAD2-Large,  8192 bp
}

# SSD (Mamba-2) variants of every size — beyond the reference (which is
# Mamba-1 only): scalar-per-head decay turns the recurrence into chunked
# matmuls on the MXU instead of a VPU-bound scan (docs/DESIGN.md §5, ops/ssd.py).
# d_state rises to 128 (the Mamba-2 default) because extra state is nearly
# free in the matmul formulation.
PRESETS.update({
    f"{name}-ssd": dict(kw, ssm_variant="mamba2", d_state=128)
    for name, kw in list(PRESETS.items())
})


@dataclasses.dataclass
class CaduceusConfig:
    """Architecture hyper-parameters of the Caduceus model."""

    d_model: int = 384
    n_layer: int = 20
    vocab_size: int = 16          # char vocab padded to a multiple of 8
    d_state: int = 16             # SSM state size N
    d_conv: int = 4               # causal-conv kernel width
    expand: int = 2               # d_inner = expand * d_model
    dt_rank: Optional[int] = None  # default ceil(d_model / 16)
    # Caduceus-specific:
    bidirectional: bool = True
    bidirectional_strategy: str = "add"     # add | ew_multiply
    bidirectional_weight_tie: bool = True   # tie in_proj/out_proj across directions
    rcps: bool = True                       # reverse-complement parameter sharing
    complement_map: Optional[Tuple[int, ...]] = None  # token id -> complement id
    # Norm / numerics:
    rms_norm: bool = True
    norm_epsilon: float = 1e-5
    residual_in_fp32: bool = True
    tie_word_embeddings: bool = True
    # Head behaviour: how fwd/rc logits combine in the RCPS LM head.
    lm_head_strategy: str = "sum"  # sum | mean
    # Sequence classification head:
    pooling: str = "mean"          # mean | last | first
    # Token ids (defaults follow the CharacterTokenizer layout, SURVEY.md §2.5/B19):
    pad_token_id: int = 4
    mask_token_id: int = 3
    # Kernel selection for the selective scan:
    # auto (pallas on TPU, associative elsewhere) | associative | sequential | pallas.
    # Kept for config round-trips with the JAX package; the PyTorch port picks
    # its scan by device (CUDA kernel on the card, plain version on the CPU).
    scan_impl: str = "auto"
    # SSM variant: "mamba1" (selective scan — the released-model architecture)
    # or "mamba2" (SSD, scalar-per-head decay, MXU chunked-matmul recurrence).
    ssm_variant: str = "mamba1"
    # mamba2 head size P (d_inner = n_heads * head_dim). 128 (vs mamba_ssm's
    # default 64) so every per-head SSD dot is a full 128-lane MXU tile —
    # the Pallas kernel requires P % 128 == 0 (ops/pallas_ssd.py).
    head_dim: int = 128
    n_groups: int = 1      # mamba2: B/C groups shared across heads
    chunk_size: int = 128  # mamba2: SSD chunk length (L % chunk_size == 0)

    def __post_init__(self):
        if self.dt_rank is None:
            self.dt_rank = math.ceil(self.d_model / 16)
        if self.ssm_variant not in ("mamba1", "mamba2"):
            raise ValueError(f"bad ssm_variant {self.ssm_variant!r}")
        if self.ssm_variant == "mamba2":
            if self.d_inner % self.head_dim:
                raise ValueError(
                    f"d_inner={self.d_inner} not divisible by head_dim={self.head_dim}")
            if self.n_heads % self.n_groups:
                raise ValueError(
                    f"n_heads={self.n_heads} not divisible by n_groups={self.n_groups}")
        if self.vocab_size % 8 != 0:
            # Reference pads vocab to a multiple of 8 (caduceus.py:124-125).
            self.vocab_size += 8 - (self.vocab_size % 8)
        if self.complement_map is None:
            # Default char-tokenizer layout: a=7<->t=10, c=8<->g=9, rest self.
            cmap = list(range(self.vocab_size))
            if self.vocab_size >= 11:
                cmap[7], cmap[10] = 10, 7
                cmap[8], cmap[9] = 9, 8
            self.complement_map = tuple(cmap)
        else:
            cmap = list(self.complement_map)
            if len(cmap) < self.vocab_size:  # pad ids complement to themselves
                cmap += list(range(len(cmap), self.vocab_size))
            self.complement_map = tuple(cmap)
        if self.bidirectional_strategy not in ("add", "ew_multiply"):
            raise ValueError(f"bad bidirectional_strategy {self.bidirectional_strategy!r}")
        if self.lm_head_strategy not in ("sum", "mean"):
            raise ValueError(f"bad lm_head_strategy {self.lm_head_strategy!r}")

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        """mamba2 only: number of SSD heads."""
        return self.d_inner // self.head_dim

    @property
    def hidden_size(self) -> int:
        """Width of the residual stream / output hidden states."""
        return 2 * self.d_model if self.rcps else self.d_model

    @property
    def n_directions(self) -> int:
        return 2 if self.bidirectional else 1

    @classmethod
    def preset(cls, name: str, **overrides) -> "CaduceusConfig":
        if name not in PRESETS:
            raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
        kw = dict(PRESETS[name])
        kw.update(overrides)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "CaduceusConfig":
        data = json.loads(text)
        if "complement_map" in data and data["complement_map"] is not None:
            data["complement_map"] = tuple(data["complement_map"])
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def save(self, path) -> None:
        Path(path).write_text(self.to_json())

    @classmethod
    def load(cls, path) -> "CaduceusConfig":
        return cls.from_json(Path(path).read_text())
