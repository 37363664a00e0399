"""Masked-LM training step, on one device or over a data × seq mesh.

Counterpart of ``plantcaduceus_tpu.train.step``: the gradient of the
globally normalised weighted MLM loss through the model's forward (Mamba-1:
K2's residual variant and K3 under autograd; Mamba-2: K5's residual variant
and K6; remat per block), gradient accumulation over microbatches, and the
optimizer update. The fsdp, tensor and pipeline layouts are not ported yet
(``parallel.mesh.NOT_PORTED``).

The loss normaliser (the weight sum) is computed over ALL microbatches
before any gradient, so an accum-N step computes the one-big-batch gradient.
Metrics: ``loss``, ``accuracy`` (masked tokens), ``grad_norm`` (global,
before clipping).

Over a mesh (``parallel.mesh``) every rank holds the same global batch and
takes its part (``shard_batch``: rows over ``data``, L over ``seq``, the
sequence-sharded forward of ``models.caduceus`` with ``sp``). Each rank's
objective is its weighted NLL sum over the GLOBAL weight sum W, which is
summed over ``data × seq`` outside the differentiated graph; the replicated
weights' gradients are summed over ``data × seq`` once per optimizer step,
after the last microbatch; loss and accuracy sum over the same ranks. Every
rank applies the same update to the same weights (one seed, one init).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.parallel import collectives
from plantcaduceus_tpu_torch.parallel.mesh import Mesh, shard_batch
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


def sync_grads(grads, axis) -> None:
    """Sum the gradients over ``axis`` in place, as one flat buffer (one
    collective a step; JAX ``_sync_grads`` for replicated leaves)."""
    if axis.size == 1:
        return
    flat = collectives.psum(_flatten_dense_tensors(grads), axis)
    for g, s in zip(grads, _unflatten_dense_tensors(flat, grads)):
        g.copy_(s)


def make_grad_fn(
    cfg: CaduceusConfig,
    model: caduceus.Caduceus,
    dtype=torch.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Callable:
    """``grad_fn(batch) -> (loss, accuracy, grads)``: the gradient of the
    globally normalised loss with respect to ``model``'s parameters (a dict
    by name; summed over ``data × seq`` over a mesh), the loss and the
    masked-token accuracy (JAX ``make_grad_fn``). ``model`` moves to
    ``device``; ``grad_accum=N`` runs the (per-rank) rows as N sequential
    microbatches against the normaliser of them all. Batches are numpy dicts
    (``PretrainDataset``) or tensors on the device; over a ``mesh`` they are
    the global batch, which each rank slices."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    device = resolve_device(device)
    model.to(device)
    params = dict(model.named_parameters())
    sp, loss_axis, psum = _mesh_axes(mesh)
    multi = loss_axis is not None

    def grad_fn(batch):
        batch = _place(batch, mesh, device)
        rows = batch["labels"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"{'per-shard ' if multi else ''}batch rows {rows} must divide "
                             f"by grad_accum={grad_accum}")
        valid = batch["labels"] != -100
        w = valid.float()
        if "loss_weights" in batch:
            w = w * batch["loss_weights"].float()
        with torch.no_grad():   # the global normaliser, outside the graph
            W = torch.clamp(psum(w.sum()), min=1e-8)
        for p in params.values():
            p.grad = None
        loss = torch.zeros((), device=device)
        correct = torch.zeros((), dtype=torch.long, device=device)
        mb = rows // grad_accum
        for i in range(grad_accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            logits = caduceus.forward(model, part["input_ids"], dtype=dtype,
                                      remat=remat, sp=sp)["logits"]
            nll, _ = _loss_sums(logits, part["labels"], part.get("loss_weights"))
            obj = nll / W
            obj.backward()
            loss += obj.detach()
            correct += ((logits.argmax(-1) == part["labels"]) & (part["labels"] != -100)).sum()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if multi:
            sync_grads(list(grads.values()), loss_axis)
        acc = psum(correct).float() / torch.clamp(psum(valid.sum()), min=1)
        return psum(loss), acc, grads

    return grad_fn


def _mesh_axes(mesh: Optional[Mesh]):
    """(the seq axis, the ``data × seq`` axis the loss reduces over, the sum
    over it); the axes None in a single process."""
    if mesh is None or mesh.world_size == 1:
        return None, None, lambda v: v
    sp = mesh.axis("seq") if mesh.shape["seq"] > 1 else None
    loss_axis = mesh.axis("data", "seq")
    return sp, loss_axis, lambda v: collectives.psum(v, loss_axis)


def _place(batch, mesh, device):
    """This rank's part of a global batch, on the device."""
    if mesh is not None and mesh.world_size > 1:
        batch = shard_batch(batch, mesh)
    return to_device(batch, device) if isinstance(batch["labels"], np.ndarray) else batch


def make_train_step(
    cfg: CaduceusConfig,
    optimizer: AdamW,
    model: caduceus.Caduceus,
    dtype=torch.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable, Callable]:
    """Build ``(init_state, train_step, eval_step)``: :func:`make_grad_fn`'s
    gradient, then one optimizer update. ``model`` moves to ``device`` (the
    card unless the CPU is asked for; raises when CUDA is absent)."""
    grad_fn = make_grad_fn(cfg, model, dtype, remat, grad_accum, device, mesh)
    device = resolve_device(device)
    params = dict(model.named_parameters())
    sp, _, psum = _mesh_axes(mesh)

    def init_state() -> TrainState:
        model.requires_grad_(True)
        return TrainState(model, optimizer.init(params), 0)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, acc, grads = grad_fn(batch)
        grad_norm = optimizer.update(grads, state.opt_state, params)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc, "grad_norm": grad_norm}

    @torch.inference_mode()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Forward only, on the inference kernels."""
        batch = _place(batch, mesh, device)
        logits = caduceus.forward(state.model, batch["input_ids"], dtype=dtype,
                                  sp=sp)["logits"]
        nll, w = _loss_sums(logits, batch["labels"], batch.get("loss_weights"))
        valid = batch["labels"] != -100
        correct = ((logits.argmax(-1) == batch["labels"]) & valid).sum()
        return {"loss": psum(nll) / torch.clamp(psum(w), min=1e-8),
                "accuracy": psum(correct).float() / torch.clamp(psum(valid.sum()), min=1)}

    return init_state, train_step, eval_step
