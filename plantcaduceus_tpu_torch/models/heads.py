"""Task heads over the Caduceus backbone.

Counterpart of ``plantcaduceus_tpu.models.heads``: sequence classification,
regression and multi-label heads (the reference's
``AutoModelForSequenceClassification`` surface: num_labels 2, 1 or N). The
features are the RC-averaged channels pooled over the sequence, cast to
float32 before the head.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig


def rc_average(hidden: torch.Tensor, cfg: CaduceusConfig) -> torch.Tensor:
    """[B, L, hidden_size] -> [B, L, d_model] strand-symmetric features."""
    if not cfg.rcps:
        return hidden
    d = hidden.shape[-1] // 2
    return (hidden[..., :d] + hidden[..., d:].flip(-1)) * 0.5


def pool(features: torch.Tensor, cfg: CaduceusConfig) -> torch.Tensor:
    """[B, L, d] -> [B, d] per ``cfg.pooling``."""
    if cfg.pooling == "mean":
        return features.mean(dim=1)
    if cfg.pooling == "last":
        return features[:, -1]
    if cfg.pooling == "first":
        return features[:, 0]
    raise ValueError(f"unknown pooling {cfg.pooling!r}")


def init_head(generator: torch.Generator, cfg: CaduceusConfig, num_labels: int,
              dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """w ~ N(0, 0.02²) [d_model, num_labels] drawn from ``generator``, b = 0
    (the JAX distribution; other numbers for the same seed)."""
    return {"w": (torch.randn((cfg.d_model, num_labels), generator=generator) * 0.02).to(dtype),
            "b": torch.zeros((num_labels,), dtype=dtype)}


def sequence_logits(model, head: Dict[str, torch.Tensor], input_ids: torch.Tensor,
                    cfg: CaduceusConfig, dtype=torch.bfloat16, remat: bool = False,
                    lora: Optional[dict] = None, use_kernels: bool = True) -> torch.Tensor:
    """[B, num_labels] float32 logits (or regression values). ``lora`` (see
    ``caduceus.backbone``) applies adapters on the activation path with
    PEFT's dropout semantics."""
    h_work = caduceus.backbone(model, input_ids, dtype, use_kernels=use_kernels, remat=remat,
                               lora=lora)
    hidden = caduceus.readout_hidden(h_work, cfg)
    feats = pool(rc_average(hidden, cfg), cfg).float()
    return feats @ head["w"].float() + head["b"].float()


def task_loss(logits: torch.Tensor, labels: torch.Tensor, task_type: str) -> torch.Tensor:
    """Per-task loss, HF's problem_type dispatch: classification NLL,
    regression MSE on column 0, multi-label BCE with logits (the stable
    form)."""
    if task_type == "classification":
        logp = F.log_softmax(logits, dim=-1)
        return -torch.gather(logp, -1, labels[:, None].long())[:, 0].mean()
    if task_type == "regression":
        return ((logits[..., 0] - labels.float()) ** 2).mean()
    if task_type == "multi_label":
        y, z = labels.float(), logits
        return (z.clamp(min=0) - z * y + torch.log1p(torch.exp(-z.abs()))).mean()
    raise ValueError(f"unknown task_type {task_type!r}")
