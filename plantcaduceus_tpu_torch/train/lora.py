"""LoRA and full fine-tuning, on one device or over the batch axes.

Counterpart of ``plantcaduceus_tpu.train.lora``: the reference recipe's
low-rank adapters (rank 8, alpha 32, dropout 0.1) over the Mamba-block
projections in_proj / x_proj / out_proj, in the split naming of the
stacked weights (in_proj_x/in_proj_z, x_proj_dt/B/C, out_proj; Mamba-2:
in_proj_B/C/dt too), plus a task head. Training applies the adapters on the
activation path (``models.caduceus`` ``lora=``, PEFT's dropout); inference
merges them into the weights (``apply_lora``), so evaluation runs the
scoring kernels (K2, K5) and training the decomposed route (K1-hb and K3;
K5-res and K6 for Mamba-2).

The optimizer is ``train.optimizer.AdamW``. Adapters, head and optimizer
state are ``torch.save`` files (``adapter.pt``, ``train_state.pt``) beside
the JAX package's ``adapter_config.json``.

Over a mesh (JAX's ``make_mesh()``: every rank on ``data``) each rank takes
its rows of the global batch (``data × fsdp``); each microbatch's mean loss
is weighted by its rows' share of the GLOBAL rows (JAX's ``n_global``), and
gradients and loss are summed over the batch axes once a step. The base
weights and the trainable tensors are replicated. Dropout masks come from
the same seed on every rank, drawn over the rank's own rows, as JAX draws
with its one replicated key under ``shard_map``: a data-parallel step with
dropout is not one process's step over all rows. Inference splits each
batch's rows and gathers the logits back, so every rank gets them all.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from plantcaduceus_tpu_torch.models import heads
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, fold_in
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.parallel import collectives
from plantcaduceus_tpu_torch.parallel.mesh import Mesh, shard_batch
from plantcaduceus_tpu_torch.train.optimizer import AdamW
from plantcaduceus_tpu_torch.train.step import sync_grads
from plantcaduceus_tpu_torch.utils.device import resolve_device

# The reference's target_modules = [x_proj, in_proj, out_proj] in the split
# naming. Names absent from the model are skipped at init, so one default
# covers both SSM variants.
DEFAULT_TARGETS = ("in_proj_x", "in_proj_z", "out_proj",
                   "x_proj_dt", "x_proj_B", "x_proj_C",
                   "in_proj_B", "in_proj_C", "in_proj_dt")

ADAPTER_FILE = "adapter.pt"
TRAIN_STATE_FILE = "train_state.pt"

Adapters = Dict[str, Dict[str, torch.Tensor]]


class LoraConfig(NamedTuple):
    r: int = 8
    alpha: float = 32.0
    dropout: float = 0.1
    targets: Tuple[str, ...] = DEFAULT_TARGETS


def _stacked_shape(model, name: str):
    """The JAX leaf shape of a block weight: [n_layer, G?, in, out]."""
    return (len(model.layers),) + tuple(getattr(model.layers[0], name).shape)


def init_lora(generator: torch.Generator, model, cfg_l: LoraConfig,
              dtype=torch.float32) -> Adapters:
    """a ~ N(0, 1/r²) [n_layer, G?, in, r] on the input side, b = 0 (PEFT's
    convention: the delta starts at zero), on the CPU. Raises when no
    target is in the model."""
    present = set(model.layers[0].keys) if len(model.layers) else set()
    targets = [n for n in cfg_l.targets if n in present]
    if not targets:
        raise ValueError(f"no LoRA targets {cfg_l.targets} found in model")
    adapters = {}
    for name in targets:
        *lead, fan_in, fan_out = _stacked_shape(model, name)
        a = torch.randn((*lead, fan_in, cfg_l.r), generator=generator) * (1.0 / cfg_l.r)
        adapters[name] = {"a": a.to(dtype), "b": torch.zeros((*lead, cfg_l.r, fan_out), dtype=dtype)}
    return adapters


class _Layer:
    """One block's weights as ``caduceus.backbone`` and ``to_jax_params``
    read them."""

    def __init__(self, p: Dict[str, torch.Tensor]):
        self._p = p
        self.keys = tuple(p)

    def params(self) -> Dict[str, torch.Tensor]:
        return self._p

    def __getattr__(self, name):
        try:
            return self.__dict__["_p"][name]
        except KeyError:
            raise AttributeError(name) from None


class MergedModel:
    """A Caduceus model with its adapted block weights replaced: the
    attributes ``caduceus.backbone`` reads (``cfg``, ``embedding``,
    ``cmap``, ``norm_f_weight``, ``lm_head``, ``layers``). The other
    weights are the base model's own tensors."""

    def __init__(self, model, layers):
        self.cfg, self.cmap = model.cfg, model.cmap
        self.embedding, self.norm_f_weight = model.embedding, model.norm_f_weight
        self.lm_head = model.lm_head
        self.layers = layers


@torch.no_grad()
def apply_lora(model, adapters: Adapters, cfg_l: LoraConfig) -> MergedModel:
    """Effective weights W + (alpha/r) * a @ b, on the base's device.

    Dropout-free application (inference, evaluation, export), equal to the
    activation path by linearity. Training with dropout must use
    :func:`lora_ctx`: PEFT drops the adapted projection's input
    activations, which no weight perturbation expresses."""
    scale = cfg_l.alpha / cfg_l.r
    layers = []
    for i, layer in enumerate(model.layers):
        p = dict(layer.params())
        for name, ab in adapters.items():
            delta = torch.einsum("...ir,...ro->...io", ab["a"][i], ab["b"][i]) * scale
            p[name] = p[name] + delta.to(p[name].dtype)
        layers.append(_Layer(p))
    return MergedModel(model, layers)


merge_lora = apply_lora  # fold the adapters into the base weights (export)


def lora_ctx(adapters: Adapters, cfg_l: LoraConfig, dropout_seed: Optional[int] = None) -> dict:
    """The activation-path context ``caduceus.backbone`` reads (PEFT
    semantics: y = Wx + scale * B A dropout(x))."""
    return {"adapters": adapters, "scale": cfg_l.alpha / cfg_l.r,
            "dropout": cfg_l.dropout,
            "seed": dropout_seed if cfg_l.dropout > 0 else None}


@dataclasses.dataclass
class LoraTrainState:
    """``adapters``: the LoRA tree, or under full fine-tuning the model's
    named parameters (the JAX state's params slot); ``head``: {"w", "b"}."""
    adapters: Dict
    head: Dict[str, torch.Tensor]
    opt_state: dict
    step: int


def trainable(state: LoraTrainState, full: bool = False) -> Dict[str, torch.Tensor]:
    """The optimizer's named tensors: the adapters (or the model's
    parameters) and the head."""
    out = {}
    if full:
        out.update({f"params.{n}": t for n, t in state.adapters.items()})
    else:
        for n, ab in state.adapters.items():
            out.update({f"adapters.{n}.{k}": t for k, t in ab.items()})
    out.update({f"head.{k}": t for k, t in state.head.items()})
    return out


def _to_device(batch: Dict[str, np.ndarray], device, task_type: str):
    ids = torch.as_tensor(np.asarray(batch["input_ids"])).long().to(device)
    out = {"input_ids": ids}
    if batch.get("labels") is not None:
        labels = torch.as_tensor(np.asarray(batch["labels"]))
        out["labels"] = (labels.long() if task_type == "classification"
                         else labels.float()).to(device)
    return out


class _BatchAxes:
    """A step's view of the mesh: this rank's rows of a global host batch,
    and the sum over the batch axes (``data × fsdp``); the identity in one
    process."""

    def __init__(self, mesh: Optional[Mesh]):
        multi = mesh is not None and mesh.world_size > 1
        self.mesh = mesh if multi else None
        self.axis = mesh.axis("data", "fsdp") if multi else None
        self.size = self.axis.size if multi else 1

    def rows(self, batch: dict) -> dict:
        return shard_batch(batch, self.mesh) if self.mesh is not None else batch

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.psum(t, self.axis) if self.axis is not None else t

    def sync(self, grads: Dict[str, torch.Tensor]) -> None:
        if self.axis is not None:
            sync_grads(list(grads.values()), self.axis)

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        return collectives.all_gather_tiled(t, self.axis) if self.axis is not None else t


def _accumulated_step(loss_fn: Callable, tensors: Dict[str, torch.Tensor], batch: dict,
                      grad_accum: int, n_global: int) -> Tuple[torch.Tensor,
                                                               Dict[str, torch.Tensor]]:
    """``grad_accum`` sequential microbatches, each mean weighted by its
    share of the ``n_global`` rows of the step (over every rank); one
    gradient sum. Returns (this rank's share of the loss, grads)."""
    rows = batch["labels"].shape[0]
    if rows % grad_accum:
        raise ValueError(f"per-shard batch rows {rows} must divide by grad_accum={grad_accum}")
    mb = rows // grad_accum
    for t in tensors.values():
        t.grad = None
    loss = torch.zeros((), device=batch["labels"].device)
    for i in range(grad_accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        obj = loss_fn(part, i) * mb / n_global
        obj.backward()
        loss += obj.detach()
    # a weight off the head's path (an untied lm_head) gets zeros, as jax.grad gives
    grads = {n: t.grad if t.grad is not None else torch.zeros_like(t)
             for n, t in tensors.items()}
    for t in tensors.values():
        t.grad = None
    return loss, grads


def _check_accum(grad_accum: int) -> None:
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")


def make_lora_train_step(cfg: CaduceusConfig, cfg_l: LoraConfig, optimizer: AdamW,
                         model: Caduceus, task_type: str = "classification",
                         dtype=torch.bfloat16, remat: bool = True, grad_accum: int = 1,
                         device="cuda", mesh: Optional[Mesh] = None):
    """Build ``(train_step, infer_fn)``. The base model moves to ``device``
    (the card unless the CPU is asked for) and stays frozen; only adapters
    and head train.

    ``train_step(state, base, batch, seed)``: ``grad_accum=N`` runs the
    rows as N sequential microbatches, weighted by their share of the rows,
    with one optimizer update (raises when the rows do not divide); each
    microbatch's dropout seed is ``fold_in(seed, i)``. ``infer_fn(state,
    base, batch)`` runs the merged weights under ``no_grad``: float32 logits
    [rows, num_labels]. Over a ``mesh`` every rank passes the global batch
    and the same seed (module docstring)."""
    _check_accum(grad_accum)
    device = resolve_device(device)
    model.to(device).requires_grad_(False)
    ax = _BatchAxes(mesh)

    def train_step(state: LoraTrainState, base, batch, seed: Optional[int] = None):
        n_global = len(batch["labels"])
        batch = _to_device(ax.rows(batch), device, task_type)
        tensors = trainable(state)

        def loss_fn(mb, i):
            sub = seed if (seed is None or grad_accum == 1) else fold_in(seed, i)
            ctx = lora_ctx(state.adapters, cfg_l, dropout_seed=sub)
            logits = heads.sequence_logits(base, state.head, mb["input_ids"], cfg, dtype=dtype,
                                           remat=remat, lora=ctx)
            return heads.task_loss(logits, mb["labels"], task_type)

        loss, grads = _accumulated_step(loss_fn, tensors, batch, grad_accum, n_global)
        ax.sync(grads)
        optimizer.update(grads, state.opt_state, tensors)
        state.step += 1
        return state, {"loss": ax.psum(loss)}

    @torch.no_grad()
    def infer_fn(state: LoraTrainState, base, batch) -> torch.Tensor:
        eff = apply_lora(base, state.adapters, cfg_l)
        ids = _to_device(ax.rows(batch), device, task_type)["input_ids"]
        return ax.gather_rows(heads.sequence_logits(eff, state.head, ids, cfg, dtype=dtype))

    return train_step, infer_fn


def trainable_copy(tree, device):
    """A float32 copy of a tree of tensors (or numpy arrays) on ``device``,
    each leaf requiring grad."""
    if isinstance(tree, dict):
        return {k: trainable_copy(v, device) for k, v in tree.items()}
    t = torch.as_tensor(tree).detach()
    return t.to(device=device, dtype=torch.float32).clone().requires_grad_(True)


def init_lora_state(seed: int, model, cfg: CaduceusConfig, cfg_l: LoraConfig,
                    num_labels: int, optimizer: AdamW, device=None) -> LoraTrainState:
    """Adapters, then the head, drawn from one generator seeded with
    ``seed``, on ``device`` (the model's by default), with a fresh
    optimizer state."""
    device = device if device is not None else model.embedding.device
    gen = torch.Generator().manual_seed(seed)
    adapters = trainable_copy(init_lora(gen, model, cfg_l), device)
    head = trainable_copy(heads.init_head(gen, cfg, num_labels), device)
    state = LoraTrainState(adapters, head, None, 0)
    state.opt_state = optimizer.init(trainable(state))
    return state


def make_full_finetune_step(cfg: CaduceusConfig, optimizer: AdamW, model: Caduceus,
                            task_type: str = "classification", dtype=torch.bfloat16,
                            remat: bool = True, grad_accum: int = 1, device="cuda",
                            mesh: Optional[Mesh] = None):
    """Full fine-tuning (the reference's FineTuningStrategy.FULL): every
    backbone weight trains with the head. The model moves to ``device`` and
    trains in place: the state's ``adapters`` are its named parameters
    (:func:`init_full_state`). Same ``(train_step, infer_fn)`` contract as
    :func:`make_lora_train_step`; the base and seed arguments are unused."""
    _check_accum(grad_accum)
    device = resolve_device(device)
    model.to(device).requires_grad_(True)
    ax = _BatchAxes(mesh)

    def train_step(state: LoraTrainState, base_unused=None, batch=None, seed_unused=None):
        n_global = len(batch["labels"])
        batch = _to_device(ax.rows(batch), device, task_type)
        tensors = trainable(state, full=True)

        def loss_fn(mb, i):
            logits = heads.sequence_logits(model, state.head, mb["input_ids"], cfg, dtype=dtype,
                                           remat=remat)
            return heads.task_loss(logits, mb["labels"], task_type)

        loss, grads = _accumulated_step(loss_fn, tensors, batch, grad_accum, n_global)
        ax.sync(grads)
        optimizer.update(grads, state.opt_state, tensors)
        state.step += 1
        return state, {"loss": ax.psum(loss)}

    @torch.no_grad()
    def infer_fn(state: LoraTrainState, base_unused, batch) -> torch.Tensor:
        ids = _to_device(ax.rows(batch), device, task_type)["input_ids"]
        return ax.gather_rows(heads.sequence_logits(model, state.head, ids, cfg, dtype=dtype))

    return train_step, infer_fn


def init_full_state(model: Caduceus, head: Dict[str, torch.Tensor], optimizer: AdamW,
                    params: Optional[Dict[str, torch.Tensor]] = None, step: int = 0,
                    opt_state: Optional[dict] = None) -> LoraTrainState:
    """A full fine-tuning state over ``model``'s own parameters; ``params``
    (a saved state's) are copied into the model first."""
    device = model.embedding.device
    if params is not None:
        with torch.no_grad():
            model.load_state_dict({k: v.to(device) for k, v in params.items()})
    state = LoraTrainState(dict(model.named_parameters()), trainable_copy(head, device), opt_state, step)
    if opt_state is None:
        state.opt_state = optimizer.init(trainable(state, full=True))
    return state


# ---------------------------------------------------------------------------
# Adapter persistence (the PEFT-adapter-dir analogue)
# ---------------------------------------------------------------------------


def _cpu(tree):
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().float().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def save_adapter(directory, state: LoraTrainState, cfg_l: LoraConfig, task_type: str,
                 base_model: str) -> None:
    """``adapter_config.json`` (JAX's keys) and ``adapter.pt`` (adapters
    and head, float32 on the CPU)."""
    directory = Path(directory).absolute()
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "adapter_config.json").write_text(json.dumps({
        "r": cfg_l.r, "alpha": cfg_l.alpha, "dropout": cfg_l.dropout,
        "targets": list(cfg_l.targets), "task_type": task_type,
        "base_model_name_or_path": str(base_model),
    }, indent=2))
    torch.save({"adapters": _cpu(state.adapters), "head": _cpu(state.head)},
               directory / ADAPTER_FILE)


def load_adapter(directory):
    """-> (adapters, head, LoraConfig, task_type, base_model_name), tensors
    on the CPU."""
    directory = Path(directory).absolute()
    meta = json.loads((directory / "adapter_config.json").read_text())
    tree = torch.load(directory / ADAPTER_FILE, map_location="cpu", weights_only=True)
    cfg_l = LoraConfig(r=meta["r"], alpha=meta["alpha"], dropout=meta["dropout"],
                       targets=tuple(meta["targets"]))
    return tree["adapters"], tree["head"], cfg_l, meta["task_type"], meta["base_model_name_or_path"]


def save_train_state(directory, state: LoraTrainState, cfg_l: LoraConfig, task_type: str,
                     base_model: str) -> None:
    """Adapter dir plus optimizer state and step (``train_state.pt``): a
    checkpoint-N a later run resumes from exactly. The adapter part stays
    loadable by evaluate/predict like any exported adapter."""
    save_adapter(directory, state, cfg_l, task_type, base_model)
    opt = state.opt_state
    torch.save({"opt_state": {"count": int(opt["count"]), "mu": _cpu(opt["mu"]),
                              "nu": _cpu(opt["nu"])},
                "step": int(state.step)}, Path(directory).absolute() / TRAIN_STATE_FILE)


def load_train_state(directory, device="cpu") -> Tuple[LoraTrainState, LoraConfig, str, str]:
    """Restore adapters, head, optimizer state and step from a
    :func:`save_train_state` directory, on ``device``. Under full
    fine-tuning the ``adapters`` are the saved parameters; pass them to
    :func:`init_full_state`. -> (state, LoraConfig, task_type, base)."""
    directory = Path(directory).absolute()
    adapters, head, cfg_l, task_type, base = load_adapter(directory)
    path = directory / TRAIN_STATE_FILE
    if not path.exists():
        raise FileNotFoundError(
            f"{directory} has no {TRAIN_STATE_FILE} — it is an adapter export, "
            "not a resumable training checkpoint")
    saved = torch.load(path, map_location="cpu", weights_only=True)
    opt = saved["opt_state"]
    opt_state = {"count": int(opt["count"]),
                 "mu": {k: v.to(device) for k, v in opt["mu"].items()},
                 "nu": {k: v.to(device) for k, v in opt["nu"].items()}}
    state = LoraTrainState(trainable_copy(adapters, device), trainable_copy(head, device), opt_state,
                           int(saved["step"]))
    return state, cfg_l, task_type, base
