"""Masked-LM training step on one device.

Counterpart of ``plantcaduceus_tpu.train.step`` without the mesh: the
gradient of the globally normalised weighted MLM loss through the model's
forward (K2's residual variant and K3 under autograd; remat per block),
gradient accumulation over microbatches, and the optimizer update. The
data-, fsdp-, tensor-, sequence- and pipeline-parallel layouts are not
ported yet (the CLI refuses them).

The loss normaliser (the weight sum) is computed over ALL microbatches
before any gradient, so an accum-N step computes the one-big-batch gradient.
Metrics: ``loss``, ``accuracy`` (masked tokens), ``grad_norm`` (global,
before clipping).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train.optimizer import AdamW
from plantcaduceus_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class TrainState:
    model: caduceus.Caduceus   # trained in place
    opt_state: dict
    step: int


def _loss_sums(logits, labels, loss_weights, ignore_index=-100):
    """(weighted NLL sum, weight sum)."""
    valid = labels != ignore_index
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels_safe[..., None])[..., 0]
    w = valid.float()
    if loss_weights is not None:
        w = w * loss_weights.float()
    return (nll * w).sum(), w.sum()


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device``: ids and labels as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = (t.long() if k in ("input_ids", "labels") else t.float()).to(device)
    return out


def make_train_step(
    cfg: CaduceusConfig,
    optimizer: AdamW,
    model: caduceus.Caduceus,
    dtype=torch.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
    device="cuda",
) -> Tuple[Callable, Callable, Callable]:
    """Build ``(init_state, train_step, eval_step)``; ``model`` moves to
    ``device`` (the card unless the CPU is asked for; raises when CUDA is
    absent). ``grad_accum=N`` expects train batches with N times the
    microbatch rows and runs them as N sequential microbatches with one
    optimizer update. Batches are numpy dicts (``PretrainDataset``) or
    tensors on the device."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    device = resolve_device(device)
    model.to(device)
    params = dict(model.named_parameters())

    def init_state() -> TrainState:
        model.requires_grad_(True)
        return TrainState(model, optimizer.init(params), 0)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = to_device(batch, device) if isinstance(batch["labels"], np.ndarray) else batch
        rows = batch["labels"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch rows {rows} must divide by grad_accum={grad_accum}")
        valid = batch["labels"] != -100
        w = valid.float()
        if "loss_weights" in batch:
            w = w * batch["loss_weights"].float()
        W = torch.clamp(w.sum(), min=1e-8)   # global normaliser, outside the graph
        for p in params.values():
            p.grad = None
        loss = torch.zeros((), device=device)
        correct = torch.zeros((), dtype=torch.long, device=device)
        mb = rows // grad_accum
        for i in range(grad_accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            logits = caduceus.forward(state.model, part["input_ids"], dtype=dtype,
                                      remat=remat)["logits"]
            nll, _ = _loss_sums(logits, part["labels"], part.get("loss_weights"))
            obj = nll / W
            obj.backward()
            loss += obj.detach()
            correct += ((logits.argmax(-1) == part["labels"]) & (part["labels"] != -100)).sum()
        grads = {n: p.grad for n, p in params.items()}
        grad_norm = optimizer.update(grads, state.opt_state, params)
        for p in params.values():
            p.grad = None
        state.step += 1
        acc = correct.float() / torch.clamp(valid.sum(), min=1)
        return state, {"loss": loss, "accuracy": acc, "grad_norm": grad_norm}

    @torch.inference_mode()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Forward only, on the inference kernels."""
        batch = to_device(batch, device) if isinstance(batch["labels"], np.ndarray) else batch
        logits = caduceus.forward(state.model, batch["input_ids"], dtype=dtype)["logits"]
        nll, w = _loss_sums(logits, batch["labels"], batch.get("loss_weights"))
        valid = batch["labels"] != -100
        correct = ((logits.argmax(-1) == batch["labels"]) & valid).sum()
        return {"loss": nll / torch.clamp(w, min=1e-8),
                "accuracy": correct.float() / torch.clamp(valid.sum(), min=1)}

    return init_state, train_step, eval_step
