"""Masked-LM training step, on one device or over a data × fsdp × seq ×
tensor × pipe mesh.

Counterpart of ``plantcaduceus_tpu.train.step``: the gradient of the
globally normalised weighted MLM loss through the model's forward (Mamba-1:
K2's residual variant and K3 under autograd; Mamba-2: K5's residual variant
and K6; remat per block), gradient accumulation over microbatches, and the
optimizer update.

The loss normaliser (the weight sum) is computed over ALL microbatches
before any gradient, so an accum-N step computes the one-big-batch gradient.
Metrics: ``loss``, ``accuracy`` (masked tokens), ``grad_norm`` (global,
before clipping).

Over a mesh (``parallel.mesh``) every rank holds the same global batch and
takes its part (``shard_batch``: rows over ``data × fsdp``, L over
``seq``, the sequence-sharded forward of ``models.caduceus`` with ``sp``).
Each rank's objective is its weighted NLL sum over the GLOBAL weight sum W,
which is summed over ``data × fsdp × seq`` outside the differentiated
graph; loss and accuracy sum over the same ranks. Gradients are synced once
per optimizer step, after the last microbatch (JAX ``_sync_grads``):
replicated leaves summed over ``data × fsdp × seq``; with ``fsdp`` above 1
(:class:`FsdpParams`) the sharded leaves summed over ``data × seq`` and then
reduce-scattered over ``fsdp`` onto each rank's block, where the optimizer
updates them (its moments are blocks too). Every rank applies the same
update to the same weights (one seed, one init).

With ``tensor`` or ``pipe`` above 1 (:class:`ModelShards`) each rank keeps
its slice of the mixers' d_inner leaves (tensor) and its stage's layers
(pipe), fsdp sharding those further. Under ``tensor`` the forward is the
mixers' tensor-parallel path (``tp=``); the gradients of
``TENSOR_PARTIAL_LEAVES`` are summed over ``tensor`` as well (JAX
``_sync_grads(tp=True)``), and ``validate_tp_grad_coverage`` runs when the
step is built. Under ``pipe`` the forward is the GPipe schedule
(``parallel.pipeline``; ``pp_microbatches`` microbatches, default the stage
count), the loss and accuracy are the last stage's, summed over ``pipe``,
and the leaves replicated across stages (embedding, final norm, head) have
their gradients summed over ``pipe``. The gradient norm counts every leaf
once however it is split. Checkpoints stay one-process files of full
tensors, so a run resumes under any layout.
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
from plantcaduceus_tpu_torch.parallel.mesh import (AXES, TENSOR_PARTIAL_LEAVES, Mesh,
                                                   check_axes, check_stages, fsdp_dims,
                                                   param_spec_tree, shard_batch, tensor_dims,
                                                   validate_tp_grad_coverage)
from plantcaduceus_tpu_torch.parallel.pipeline import pipeline_forward, stage_layers
from plantcaduceus_tpu_torch.train.optimizer import AdamW
from plantcaduceus_tpu_torch.utils.device import resolve_device


class FsdpParams:
    """A model's master weights sharded over the mesh's ``fsdp`` axis (ZeRO;
    JAX ``make_train_step(fsdp=True)``). Each rank keeps, in float32, its
    block of every leaf that ``param_specs(replicated=False)`` shards
    (``shards``, what the optimizer updates); a leaf that the rule leaves
    replicated stays the module's own parameter. The module's sharded
    parameters hold the full weights only from :meth:`gather` (once per
    optimizer step, before its microbatches, as ``_gather_fsdp``) to
    :meth:`release` (after the backward): between steps a rank holds its
    blocks alone."""

    def __init__(self, model: torch.nn.Module, mesh: Mesh, names=None):
        self.axis = mesh.axis("fsdp")
        self.params = {n: p for n, p in model.named_parameters() if names is None or n in names}
        self.shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self.dims = fsdp_dims(self.shapes, self.axis.size)
        self.sharded = [n for n, d in self.dims.items() if d is not None]
        self.shards = {n: self.block(self.params[n].detach(), n).clone() for n in self.sharded}
        self.release()

    def block(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's block of the full tensor ``t`` of leaf ``name``."""
        d = self.dims[name]
        per = t.shape[d] // self.axis.size
        return t.narrow(d, self.axis.index * per, per)

    def masters(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer updates, in the model's order: each
        sharded leaf's block, each replicated leaf's parameter."""
        return {n: self.shards.get(n, p) for n, p in self.params.items()}

    def full(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A dict shaped as :meth:`masters` (blocks of the sharded leaves)
        with every block replaced by its full tensor: one tiled all_gather
        of all the blocks, flattened."""
        if not self.sharded:
            return dict(tree)
        F = self.axis.size
        flat = torch.cat([tree[n].reshape(-1) for n in self.sharded])
        gathered = collectives.all_gather_tiled(flat, self.axis).view(F, -1)
        out, off = dict(tree), 0
        for n in self.sharded:
            blk = tree[n]
            pieces = gathered[:, off:off + blk.numel()].reshape(F, *blk.shape)
            out[n] = pieces.movedim(0, self.dims[n]).reshape(self.shapes[n]).contiguous()
            off += blk.numel()
        return out

    @torch.no_grad()
    def gather(self) -> None:
        """The full weights into the module's parameters."""
        for n, t in self.full(self.masters()).items():
            self.params[n].data = t

    def release(self) -> None:
        """Free the module's copies of the sharded leaves."""
        for n in self.sharded:
            self.params[n].data = self.params[n].data.new_empty(0)

    def scatter(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's block of the sum over ``fsdp`` of each sharded leaf's
        full gradient: one tiled ``psum_scatter`` of all of them, each cut
        into its blocks and flattened block by block."""
        F = self.axis.size
        parts = []
        for n in self.sharded:
            g, d = grads[n], self.dims[n]
            shape = self.shapes[n]
            parts.append(g.reshape(shape[:d] + (F, shape[d] // F) + shape[d + 1:])
                         .movedim(d, 0).reshape(F, -1))
        mine = collectives.psum_scatter(torch.cat(parts, dim=1).reshape(-1), self.axis)
        out, off = {}, 0
        for n in self.sharded:
            blk = self.shards[n]
            out[n] = mine[off:off + blk.numel()].view(blk.shape)
            off += blk.numel()
        return out

    def sync(self, grads: Dict[str, torch.Tensor], batch_axis, rows_axis) -> Dict[str, torch.Tensor]:
        """The synced gradients, shaped as :meth:`masters` (JAX
        ``_sync_grads``): the sharded leaves summed over ``rows_axis``
        (``data × seq``) and then reduce-scattered over ``fsdp``; the
        replicated leaves summed over ``batch_axis`` (``data × fsdp ×
        seq``)."""
        rep = [g for n, g in grads.items() if n not in self.shards]
        if rep:
            sync_grads(rep, batch_axis)
        sharded = [grads[n] for n in self.sharded]
        if sharded:
            sync_grads(sharded, rows_axis)
        blocks = self.scatter(grads) if sharded else {}
        return {n: blocks.get(n, g) for n, g in grads.items()}

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from the synced blocks: each
        rank's squares of its blocks summed over ``fsdp``, each replicated
        leaf counted once."""
        sq = lambda ts: torch.stack(torch._foreach_norm(ts)).square().sum()
        parts = [collectives.psum(sq([grads[n] for n in self.sharded]), self.axis)]
        rep = [g for n, g in grads.items() if n not in self.shards]
        if rep:
            parts.append(sq(rep))
        return sum(parts).sqrt()

    def full_state(self, opt_state: dict) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(the full master weights by parameter name, the optimizer state
        with full moments): what a one-process checkpoint holds. A
        collective: every rank calls it."""
        return self.full(self.masters()), {"count": opt_state["count"],
                                           "mu": self.full(opt_state["mu"]),
                                           "nu": self.full(opt_state["nu"])}

    @torch.no_grad()
    def load_state(self, weights: Dict[str, torch.Tensor], opt_state: dict) -> dict:
        """Take this rank's blocks of full weights and moments (a
        one-process checkpoint); returns the optimizer state of blocks."""
        for n, p in self.params.items():
            if n in self.shards:
                self.shards[n] = self.block(weights[n], n).clone()
            else:
                p.copy_(weights[n])
        blocks = lambda tree: {n: self.block(t, n).clone() if n in self.shards else t
                               for n, t in tree.items()}
        return {"count": opt_state["count"], "mu": blocks(opt_state["mu"]),
                "nu": blocks(opt_state["nu"])}


def _gather_split(tensors, axis):
    """Every rank's tensors of ``axis``, each rank holding tensors of the
    same shapes: one all_gather of them flattened; a list by coordinate of
    lists in ``tensors``' order."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    gathered = collectives.all_gather(flat, axis)
    out = []
    for row in gathered:
        parts, off = [], 0
        for t in tensors:
            parts.append(row[off:off + t.numel()].view(t.shape))
            off += t.numel()
        out.append(parts)
    return out


def _layer_of(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "layers" else None


class ModelShards:
    """A model's master weights over the mesh's ``tensor`` and ``pipe``
    axes (JAX ``param_specs`` with the tensor rule, and ``pipeline=True``):
    each rank keeps, as the module's parameters, its slice along ``tensor``
    of each mixer leaf that the tensor rule shards (``tensor_dims``), and
    only its stage's layers along ``pipe`` (the others' parameters are
    emptied); the embedding, norms and head stay whole. With ``fsdp`` above
    1 an :class:`FsdpParams` shards what the rank keeps further
    (``self.fsdp``). ``owned`` names the leaves this rank trains."""

    def __init__(self, model: caduceus.Caduceus, mesh: Mesh):
        self.tensor, self.pipe = mesh.axis("tensor"), mesh.axis("pipe")
        self.world = mesh.axis(*AXES)
        self.params = dict(model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self.tdims = (tensor_dims(self.shapes, self.tensor.size) if self.tensor.size > 1
                      else dict.fromkeys(self.shapes))
        self.n_layer = model.cfg.n_layer
        mine = set(stage_layers(self.n_layer, self.pipe)) if self.pipe.size > 1 else None
        self.staged = {n for n in self.params if mine is not None and _layer_of(n) is not None}
        self.owned = [n for n in self.params if n not in self.staged or _layer_of(n) in mine]
        with torch.no_grad():
            for n, p in self.params.items():
                if n not in self.owned:
                    p.data = p.data.new_empty(0)
                elif self.tdims[n] is not None:
                    p.data = self.local(p.data, n).clone()
        self.local_shapes = {n: tuple(self.params[n].shape) for n in self.owned}
        self.fsdp = FsdpParams(model, mesh, self.owned) if mesh.shape["fsdp"] > 1 else None

    def local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """This rank's slice of the full tensor ``t`` of leaf ``name``."""
        d = self.tdims[name]
        if d is None:
            return t
        per = t.shape[d] // self.tensor.size
        return t.narrow(d, self.tensor.index * per, per)

    def masters(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer updates: each owned leaf's slice (its
        fsdp block under fsdp)."""
        if self.fsdp is not None:
            return self.fsdp.masters()
        return {n: self.params[n] for n in self.owned}

    def gather(self) -> None:
        """Before a step's microbatches: the fsdp blocks into the module."""
        if self.fsdp is not None:
            self.fsdp.gather()

    def release(self) -> None:
        if self.fsdp is not None:
            self.fsdp.release()

    def sync(self, grads: Dict[str, torch.Tensor], batch_axis, rows_axis) -> Dict[str, torch.Tensor]:
        """The synced gradients of the owned leaves, shaped as
        :meth:`masters` (JAX ``_sync_grads``): ``TENSOR_PARTIAL_LEAVES``
        summed over ``tensor`` and the leaves replicated across stages over
        ``pipe``, then everything over the batch axes as without them (the
        fsdp blocks reduce-scattered)."""
        dev = next(g for g in grads.values() if g is not None).device
        grads = {n: grads[n] if grads[n] is not None   # a leaf this stage did not use
                 else torch.zeros(self.local_shapes[n], device=dev) for n in self.owned}
        if self.tensor.size > 1:
            partial = [g for n, g in grads.items() if n.split(".")[-1] in TENSOR_PARTIAL_LEAVES]
            if partial:
                sync_grads(partial, self.tensor)
        if self.pipe.size > 1:
            sync_grads([g for n, g in grads.items() if n not in self.staged], self.pipe)
        if self.fsdp is not None:
            return self.fsdp.sync(grads, batch_axis, rows_axis)
        sync_grads(list(grads.values()), batch_axis)
        return grads

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient from the synced, split gradients:
        each rank's squares of each leaf over the number of ranks holding
        the same piece of it, summed over every rank (each piece counted
        once)."""
        n_ranks = self.world.size
        shards = self.fsdp.shards if self.fsdp is not None else {}
        total = 0.0
        for n, g in grads.items():
            split = ((self.fsdp.axis.size if n in shards else 1)
                     * (self.tensor.size if self.tdims[n] is not None else 1)
                     * (self.pipe.size if n in self.staged else 1))
            total = total + g.float().square().sum() / (n_ranks // split)
        return collectives.psum(torch.as_tensor(total, device=next(iter(grads.values())).device),
                                self.world).sqrt()

    def full(self, tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A dict shaped as :meth:`masters` as full tensors of every leaf of
        the model: the fsdp blocks gathered, then the tensor slices, then
        the other stages' layers (one all_gather each). A collective."""
        tree = dict(self.fsdp.full(tree) if self.fsdp is not None else tree)
        if self.tensor.size > 1:
            names = [n for n in self.owned if self.tdims[n] is not None]
            got = _gather_split([tree[n] for n in names], self.tensor)
            for j, n in enumerate(names):
                tree[n] = torch.cat([r[j] for r in got], self.tdims[n]).contiguous()
        if self.pipe.size > 1:
            names = [n for n in self.owned if n in self.staged]
            got = _gather_split([tree[n] for n in names], self.pipe)
            per = self.n_layer // self.pipe.size
            for s, r in enumerate(got):
                for j, n in enumerate(names):
                    parts = n.split(".")
                    k = _layer_of(n) + (s - self.pipe.index) * per
                    tree[".".join([parts[0], str(k)] + parts[2:])] = r[j]
        return tree

    def full_state(self, opt_state: dict) -> Tuple[Dict[str, torch.Tensor], dict]:
        """(the full master weights by parameter name, the optimizer state
        with full moments): a one-process checkpoint. A collective."""
        return self.full(self.masters()), {"count": opt_state["count"],
                                           "mu": self.full(opt_state["mu"]),
                                           "nu": self.full(opt_state["nu"])}

    @torch.no_grad()
    def load_state(self, weights: Dict[str, torch.Tensor], opt_state: dict) -> dict:
        """Take this rank's part of full weights and moments (a one-process
        checkpoint); returns the optimizer state shaped as :meth:`masters`."""
        local = lambda tree: {n: self.local(tree[n], n).clone() for n in self.owned}
        w, mu, nu = local(weights), local(opt_state["mu"]), local(opt_state["nu"])
        opt = {"count": opt_state["count"], "mu": mu, "nu": nu}
        if self.fsdp is not None:
            return self.fsdp.load_state(w, opt)
        for n in self.owned:
            self.params[n].copy_(w[n])
        return opt

    @torch.no_grad()
    def full_model(self) -> None:
        """Every parameter of the module set to its full tensor (for the
        final export; the layout is given up). A collective."""
        for n, t in self.full(self.masters()).items():
            self.params[n].data = t


@dataclasses.dataclass
class TrainState:
    model: caduceus.Caduceus   # trained in place (under fsdp: the gathered working copy)
    opt_state: dict
    step: int
    fsdp: Optional[FsdpParams] = None   # the master weights' blocks, under fsdp alone
    shards: Optional[ModelShards] = None   # the weights' layout, under tensor or pipe

    @property
    def layout(self):
        """How the master weights are split over ranks (None: whole)."""
        return self.shards if self.shards is not None else self.fsdp


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
    fsdp=None,
    pp_microbatches: Optional[int] = None,
) -> Callable:
    """``grad_fn(batch) -> (loss, accuracy, grads)``: the gradient of the
    globally normalised loss with respect to ``model``'s parameters (a dict
    by name, synced over the mesh), the loss and the masked-token accuracy
    (JAX ``make_grad_fn``). ``model`` moves to ``device``;
    ``grad_accum=N`` runs the (per-rank) rows as N sequential microbatches
    against the normaliser of them all. Batches are numpy dicts
    (``PretrainDataset``) or tensors on the device; over a ``mesh`` they are
    the global batch, which each rank slices. ``fsdp`` is the weights'
    layout over the mesh (:class:`FsdpParams` or :class:`ModelShards`):
    its blocks are gathered into ``model`` before the first microbatch and
    released after the last, and the gradients come back shaped as its
    ``masters()``. Under ``tensor`` the forward is the tensor-parallel one;
    under ``pipe`` the GPipe schedule over ``pp_microbatches``
    microbatches, the loss the last stage's."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
    device = resolve_device(device)
    model.to(device)
    params = dict(model.named_parameters())
    sp, loss_axis, psum = _mesh_axes(mesh)
    tp, pp, gated_psum = _model_axes(mesh, psum)
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
        if fsdp is not None:
            fsdp.gather()
        for p in params.values():
            p.grad = None
        loss = torch.zeros((), device=device)
        correct = torch.zeros((), dtype=torch.long, device=device)
        mb = rows // grad_accum
        for i in range(grad_accum):
            part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
            logits, last = _logits(model, part["input_ids"], dtype, remat, sp, tp, pp,
                                   pp_microbatches)
            nll, _ = _loss_sums(logits, part["labels"], part.get("loss_weights"))
            obj = torch.where(last, nll, 0.0) / W   # under pipe the last stage's
            obj.backward()
            loss += obj.detach()
            hits = ((logits.argmax(-1) == part["labels"]) & (part["labels"] != -100)).sum()
            correct += torch.where(last, hits, 0)
        grads = {n: p.grad for n, p in params.items()}
        for p in params.values():
            p.grad = None
        if fsdp is not None:
            fsdp.release()
            grads = fsdp.sync(grads, loss_axis, mesh.axis("data", "seq"))
        elif multi:
            sync_grads(list(grads.values()), loss_axis)
        acc = gated_psum(correct).float() / torch.clamp(psum(valid.sum()), min=1)
        return gated_psum(loss), acc, grads

    return grad_fn


def _logits(model, ids, dtype, remat, sp, tp, pp, n_micro, use_kernels=True):
    """(the logits, a tensor: whether they count): the forward over the
    seq and tensor axes, or the pipeline's (whose logits count on its last
    stage alone)."""
    if pp is not None:
        logits, last = pipeline_forward(model, ids, pp, n_micro, dtype=dtype, remat=remat,
                                        use_kernels=use_kernels)
        return logits, torch.tensor(last, device=logits.device)
    logits = caduceus.forward(model, ids, dtype=dtype, remat=remat, sp=sp, tp=tp,
                              use_kernels=use_kernels)["logits"]
    return logits, torch.tensor(True, device=logits.device)


def _mesh_axes(mesh: Optional[Mesh]):
    """(the seq axis, the ``data × fsdp × seq`` axis the loss reduces over,
    the sum over it); the axes None in a single process."""
    if mesh is None or mesh.world_size == 1:
        return None, None, lambda v: v
    sp = mesh.axis("seq") if mesh.shape["seq"] > 1 else None
    loss_axis = mesh.axis("data", "fsdp", "seq")
    return sp, loss_axis, lambda v: collectives.psum(v, loss_axis)


def _model_axes(mesh: Optional[Mesh], psum):
    """(the tensor axis, the pipe axis, the sum of the last stage's gated
    loss and hits over the batch axes and ``pipe``: JAX's ``gated_axes``);
    the axes None where they have size 1."""
    if mesh is None or mesh.world_size == 1:
        return None, None, psum
    tp = mesh.axis("tensor") if mesh.shape["tensor"] > 1 else None
    if mesh.shape["pipe"] == 1:
        return tp, None, psum
    gated = mesh.axis("data", "fsdp", "pipe")
    return tp, mesh.axis("pipe"), lambda v: collectives.psum(v, gated)


def _place(batch, mesh, device):
    """This rank's part of a global batch, on the device."""
    if mesh is not None and mesh.world_size > 1:
        batch = shard_batch(batch, mesh)
    return to_device(batch, device) if isinstance(batch["labels"], np.ndarray) else batch


def make_fsdp(model: caduceus.Caduceus, mesh: Optional[Mesh], device) -> Optional[FsdpParams]:
    """The model's weights sharded over ``mesh``'s fsdp axis (moved to
    ``device`` first), or None when the mesh has none above 1."""
    if mesh is None or mesh.shape["fsdp"] == 1:
        return None
    return FsdpParams(model.to(resolve_device(device)), mesh)


def jax_shape_tree(model: caduceus.Caduceus) -> dict:
    """The shapes of ``model``'s parameters in the JAX layout (block leaves
    stacked on n_layer, under ``blocks``), for ``param_spec_tree``."""
    tree = {"blocks": {}}
    for n, p in model.named_parameters():
        parts = n.split(".")
        if parts[0] == "layers":
            tree["blocks"][parts[-1]] = (model.cfg.n_layer,) + tuple(p.shape)
        else:
            tree[n] = tuple(p.shape)
    return tree


def make_layout(cfg: CaduceusConfig, model: caduceus.Caduceus, mesh: Optional[Mesh], device):
    """(``FsdpParams`` or None, ``ModelShards`` or None): the weights'
    layout over ``mesh`` (moved to ``device`` first), after JAX's checks of
    the axes, the stage count and, under tensor, the tensor gradient rules'
    coverage of every block leaf."""
    if mesh is None or mesh.world_size == 1:
        return None, None
    check_axes(mesh.shape)
    check_stages(cfg.n_layer, mesh.shape["pipe"])
    if mesh.shape["tensor"] == 1 and mesh.shape["pipe"] == 1:
        return make_fsdp(model, mesh, device), None
    if mesh.shape["tensor"] > 1:
        validate_tp_grad_coverage(param_spec_tree(jax_shape_tree(model), replicated=False))
    return None, ModelShards(model.to(resolve_device(device)), mesh)


def update(optimizer: AdamW, state: TrainState, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """One optimizer update of the state's weights (under a layout its
    part of them, clipped by the whole gradient's norm); returns that norm."""
    layout = state.layout
    if layout is None:
        return optimizer.update(grads, state.opt_state, dict(state.model.named_parameters()))
    return optimizer.update(grads, state.opt_state, layout.masters(),
                            g_norm=layout.global_norm(grads))


def make_train_step(
    cfg: CaduceusConfig,
    optimizer: AdamW,
    model: caduceus.Caduceus,
    dtype=torch.bfloat16,
    remat: bool = True,
    grad_accum: int = 1,
    device="cuda",
    mesh: Optional[Mesh] = None,
    pp_microbatches: Optional[int] = None,
) -> Tuple[Callable, Callable, Callable]:
    """Build ``(init_state, train_step, eval_step)``: :func:`make_grad_fn`'s
    gradient, then one optimizer update. ``model`` moves to ``device`` (the
    card unless the CPU is asked for; raises when CUDA is absent). A mesh
    with an fsdp axis above 1 shards the weights and the optimizer state
    over it (:class:`FsdpParams`), one with tensor or pipe above 1 lays
    them out over those too (:class:`ModelShards`), from ``model``'s
    weights now. ``pp_microbatches``: the GPipe microbatch count under pipe
    (default: the stage count; JAX's)."""
    fsdp, shards = make_layout(cfg, model, mesh, device)
    layout = shards if shards is not None else fsdp
    grad_fn = make_grad_fn(cfg, model, dtype, remat, grad_accum, device, mesh, layout,
                           pp_microbatches)
    device = resolve_device(device)
    sp, _, psum = _mesh_axes(mesh)
    tp, pp, gated_psum = _model_axes(mesh, psum)

    def init_state() -> TrainState:
        model.requires_grad_(True)
        masters = layout.masters() if layout is not None else dict(model.named_parameters())
        return TrainState(model, optimizer.init(masters), 0, fsdp, shards)

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, acc, grads = grad_fn(batch)
        grad_norm = update(optimizer, state, grads)
        state.step += 1
        return state, {"loss": loss, "accuracy": acc, "grad_norm": grad_norm}

    @torch.inference_mode()
    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        """Forward only, on the inference kernels (under fsdp on the
        gathered weights, released after)."""
        batch = _place(batch, mesh, device)
        if layout is not None:
            layout.gather()
        logits, last = _logits(state.model, batch["input_ids"], dtype, False, sp, tp, pp,
                               pp_microbatches)
        if layout is not None:
            layout.release()
        nll, w = _loss_sums(logits, batch["labels"], batch.get("loss_weights"))
        valid = batch["labels"] != -100
        correct = ((logits.argmax(-1) == batch["labels"]) & valid).sum()
        gate = lambda v: torch.where(last, v, torch.zeros_like(v))
        return {"loss": gated_psum(gate(nll)) / torch.clamp(psum(w), min=1e-8),
                "accuracy": gated_psum(gate(correct)).float()
                / torch.clamp(psum(valid.sum()), min=1)}

    return init_state, train_step, eval_step
