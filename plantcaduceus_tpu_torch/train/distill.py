"""Knowledge distillation between Caduceus models (teacher → student), on
one device or over a data × fsdp mesh.

Counterpart of ``plantcaduceus_tpu.train.distill``: the path that moves a
pretrained Mamba-1 teacher onto an SSD (``-ssd``) student, or any
teacher/student pair sharing a vocabulary. At the MLM-masked positions,

    loss = alpha * T^2 * KL(softmax(t/T) || softmax(s/T)) + (1-alpha) * CE

with the pre-training step's soft-mask weights and normalisation (both
terms weighted per position and divided by the weight sum), computed in
float32. The teacher runs forward only, under ``torch.no_grad`` with frozen
weights, so it takes the scoring kernels (K2 for Mamba-1, K5 for Mamba-2);
the student trains through the training kernels (K2-res/K3 or K5-res/K6).

Over a mesh (JAX's sharding, ``train/step.py``'s): the batch's rows split
over ``data × fsdp``, the normaliser and the metrics sum over them, and
with ``fsdp`` above 1 the student's weights and optimizer state are sharded
(``step.FsdpParams``: gathered once a step, gradients reduce-scattered);
the teacher stays replicated and runs forward only. ``seq``, ``tensor``
and ``pipe`` are refused with JAX's message.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.parallel import collectives
from plantcaduceus_tpu_torch.parallel.mesh import Mesh
from plantcaduceus_tpu_torch.train.optimizer import AdamW
from plantcaduceus_tpu_torch.train.step import (TrainState, _loss_sums, _place, make_fsdp,
                                                sync_grads, update)
from plantcaduceus_tpu_torch.utils.device import resolve_device


def distill_objective(teacher_model: caduceus.Caduceus, student_model: caduceus.Caduceus,
                      batch: Dict[str, torch.Tensor], dtype=torch.bfloat16,
                      temperature: float = 2.0, alpha: float = 0.5, remat: bool = False,
                      use_kernels: bool = True, psum: Callable = lambda v: v):
    """The objective on a batch of tensors: ``(objective, aux)`` with aux
    ``(student logits, teacher logits, KL sum, CE sum, weight sum)``, all
    float32 and the sums local. The teacher runs under ``torch.no_grad``;
    the objective carries the student's graph. ``use_kernels=False`` runs
    both forwards on the plain path (what the kernels are held to on the
    card). ``psum`` sums the normaliser over the ranks (this rank's rows'
    share of the global objective)."""
    labels, weights = batch["labels"], batch.get("loss_weights")
    valid = labels != -100
    w = valid.float() if weights is None else valid.float() * weights.float()
    with torch.no_grad():   # the global normaliser, outside the graph
        W = torch.clamp(psum(w.sum()), min=1e-8)
    T = float(temperature)
    with torch.no_grad():
        t_logits = caduceus.forward(teacher_model, batch["input_ids"], dtype=dtype,
                                    use_kernels=use_kernels)["logits"].float()
        logp_t = torch.log_softmax(t_logits / T, dim=-1)
        p_t = logp_t.exp()
    s_logits = caduceus.forward(student_model, batch["input_ids"], dtype=dtype, remat=remat,
                                use_kernels=use_kernels)["logits"].float()
    logq = torch.log_softmax(s_logits / T, dim=-1)
    kl = (p_t * (logp_t - logq)).sum(-1)                          # [B, L]
    kl_sum = (kl * w).sum() * (T * T)
    hard_sum, _ = _loss_sums(s_logits, labels, weights)
    obj = (alpha * kl_sum + (1.0 - alpha) * hard_sum) / W
    return obj, (s_logits, t_logits, kl_sum, hard_sum, W)


def make_distill_step(
    teacher_cfg: CaduceusConfig,
    student_cfg: CaduceusConfig,
    optimizer: AdamW,
    student_model: caduceus.Caduceus,
    dtype=torch.bfloat16,
    temperature: float = 2.0,
    alpha: float = 0.5,
    remat: bool = True,
    device="cuda",
    mesh: Optional[Mesh] = None,
) -> Tuple[Callable, Callable]:
    """Build ``(init_state, distill_step)``; the student moves to ``device``
    (the card unless the CPU is asked for; raises when CUDA is absent).

    ``distill_step(state, teacher_model, batch) -> (state, metrics)`` with
    metrics {loss, accuracy, kl, hard, agree, grad_norm}; ``agree`` is the
    masked-position argmax agreement between student and teacher. The
    teacher must sit on ``device``; it is an argument, so one step serves
    several teachers. Over a ``mesh`` every rank passes the global batch."""
    if mesh is not None and any(mesh.shape[a] > 1 for a in ("seq", "tensor", "pipe")):
        raise ValueError("distillation supports data/fsdp meshes only")
    if teacher_cfg.vocab_size != student_cfg.vocab_size:
        raise ValueError(f"teacher vocab {teacher_cfg.vocab_size} != student "
                         f"{student_cfg.vocab_size}")
    fsdp = make_fsdp(student_model, mesh, device)
    device = resolve_device(device)
    student_model.to(device)
    params = dict(student_model.named_parameters())
    axis = mesh.axis("data", "fsdp") if mesh is not None and mesh.world_size > 1 else None
    psum = (lambda v: collectives.psum(v, axis)) if axis is not None else (lambda v: v)

    def init_state() -> TrainState:
        student_model.requires_grad_(True)
        return TrainState(student_model,
                          optimizer.init(fsdp.masters() if fsdp is not None else params), 0, fsdp)

    def distill_step(state: TrainState, teacher_model: caduceus.Caduceus,
                     batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = _place(batch, mesh, device)
        if fsdp is not None:
            fsdp.gather()
        for p in params.values():
            p.grad = None
        obj, (s_logits, t_logits, kl_sum, hard_sum, W) = distill_objective(
            teacher_model, state.model, batch, dtype, temperature, alpha, remat, psum=psum)
        obj.backward()
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if fsdp is not None:
            fsdp.release()
            grads = fsdp.sync(grads, axis, mesh.axis("data"))
        elif axis is not None:
            sync_grads(list(grads.values()), axis)
        grad_norm = update(optimizer, state, grads)
        state.step += 1

        labels = batch["labels"]
        valid = labels != -100
        pred = s_logits.detach().argmax(-1)
        n_valid = torch.clamp(psum(valid.sum()), min=1).float()
        count = lambda hit: psum((hit & valid).sum()) / n_valid
        metrics = {"loss": psum(obj.detach()), "accuracy": count(pred == labels),
                   "kl": psum(kl_sum.detach()) / W, "hard": psum(hard_sum.detach()) / W,
                   "agree": count(pred == t_logits.argmax(-1)), "grad_norm": grad_norm}
        return state, metrics

    return init_state, distill_step
