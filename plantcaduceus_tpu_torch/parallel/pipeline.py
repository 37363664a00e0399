"""GPipe-style pipeline parallelism over the Caduceus layer stack
(counterpart of ``plantcaduceus_tpu.parallel.pipeline``).

* Each of the ``pipe`` axis's ``n_stages`` ranks holds ``n_layer /
  n_stages`` contiguous layers (``parallel.mesh.param_specs(pipeline=
  True)``: the block leaves' n_layer axis over ``pipe``); the embedding,
  final norm and head are replicated across stages.
* The forward runs JAX's SPMD schedule: ``n_micro + n_stages - 1`` steps,
  and at every step every stage runs its layers on its microbatch in flight
  and hands the activation to the next stage with one ``ppermute``. Stages
  that are filling or draining compute on masked zeros (stage 0 reads
  zeros once the microbatches are spent, the others receive them before
  the first one arrives), which is how a bubble looks without data-
  dependent control flow.
* The schedule is differentiable: the adjoint of each ``ppermute`` is the
  reverse ``ppermute`` (``parallel.collectives``), and autograd runs the
  backward pipeline with the bubbles mirrored. Every stage's graph has the
  same shape (the masks are tensors, so each stage's inputs, hand-offs and
  outputs stay in its graph, their gradients zero where masked), so every
  rank runs the same collectives in the same order in the backward too.
* Stage 0 alone reads the embedding. Every stage applies the final norm
  and the head to its outputs, which hold zeros except on the last stage,
  and the train step gates the loss on the last stage: the head's and the
  embedding's gradients are per-stage partials that the step sums over
  ``pipe``; the block weights' gradients are each stage's own.

``pipe`` combines with ``data`` and ``fsdp`` (the batch splits over them
and is replicated across stages; fsdp shards a stage's own layers); not
with ``tensor`` or ``seq`` (``parallel.mesh.check_axes``), as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.parallel.collectives import ppermute

AXIS = "pipe"


def stage_layers(n_layer: int, axis) -> range:
    """The indices of the layers that the stage at ``axis.index`` holds."""
    per = n_layer // axis.size
    return range(axis.index * per, (axis.index + 1) * per)


def pipeline_stages(blocks_local: Sequence[dict], emb_mb: torch.Tensor,
                    block_fn: Callable, axis, n_micro: int) -> torch.Tensor:
    """Run the GPipe schedule over ``axis`` (the ``pipe`` axis), with
    ``blocks_local`` this stage's layers' weights in order and ``emb_mb``
    the ``[n_micro, mb, L, d]`` embedded microbatches (only stage 0 reads
    them). Returns ``[n_micro, mb, L, d]`` final residual-stream states,
    real on the last stage only (zeros elsewhere)."""
    n_stages, stage = axis.size, axis.index
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    dev = emb_mb.device
    first = torch.tensor(stage == 0, device=dev)
    last = torch.tensor(stage == n_stages - 1, device=dev)
    zeros = torch.zeros_like(emb_mb[0])
    recv, outputs = zeros, [zeros] * n_micro
    n_steps = n_micro + n_stages - 1
    for t in range(n_steps):
        x = torch.where(first, emb_mb[t] if t < n_micro else zeros, recv)
        y = x
        for p in blocks_local:
            y = block_fn(y, p)
        oi = t - (n_stages - 1)   # the last stage finishes microbatch oi at step t
        if oi >= 0:
            outputs[oi] = torch.where(last, y, zeros)
        if t < n_steps - 1:
            recv = ppermute(y, axis, perm)
    return torch.stack(outputs)


def pipeline_forward(model: caduceus.Caduceus, input_ids: torch.Tensor, axis,
                     n_micro: Optional[int] = None, dtype=torch.bfloat16, remat: bool = True,
                     use_kernels: bool = True):
    """The masked-LM forward under pipeline parallelism over ``axis`` (the
    ``pipe`` axis of ``n_stages`` ranks): ``model``'s layers of this stage
    hold its weights (``stage_layers``). ``n_micro`` microbatches (default:
    the stage count) split the folded ``[S*B, L, d]`` rows. Returns
    ``(logits, is_last)``: the logits are real only where ``is_last`` (the
    last stage); gate the loss and metrics on it and sum them over
    ``axis``."""
    cfg = model.cfg
    n_stages = axis.size
    n_micro = n_micro or n_stages
    if axis.index == 0:
        residual = caduceus.embed_residual(model, input_ids, dtype)
    else:   # only stage 0 reads the embedding
        rows = input_ids.shape[0] * (2 if cfg.rcps else 1)
        residual = torch.zeros((rows, input_ids.shape[1], cfg.d_model),
                               dtype=torch.float32 if cfg.residual_in_fp32 else dtype,
                               device=input_ids.device)
    SB, L, d = residual.shape
    if SB % n_micro:
        raise ValueError(f"pipeline microbatching needs batch rows ({SB}, streams folded) "
                         f"divisible by n_micro={n_micro}")
    emb_mb = residual.reshape(n_micro, SB // n_micro, L, d)
    block_fn = caduceus.make_block_fn(cfg, dtype, use_kernels, remat)
    blocks = [model.layers[i].params() for i in stage_layers(cfg.n_layer, axis)]
    h_res = pipeline_stages(blocks, emb_mb, block_fn, axis, n_micro).reshape(SB, L, d)
    h_work = caduceus._norm(h_res.to(dtype), model.norm_f_weight, cfg)
    return caduceus.lm_logits(model, h_work), axis.index == n_stages - 1
