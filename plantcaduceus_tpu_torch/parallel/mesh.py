"""Device mesh over ``torch.distributed`` ranks, process groups and batch
slicing.

Counterpart of ``plantcaduceus_tpu.parallel.mesh``. One rank drives one
device. The ranks form a ``(data, fsdp, seq, tensor, pipe)`` grid in JAX's
device order (``pipe`` innermost), so rank = ``(((d·F + f)·S + s)·T + t)·P
+ p``, and each axis gets the process groups of its lines:

    data   — batch parallel: rows split over it, gradients summed over it
    fsdp   — parameter and optimizer-state sharding (ZeRO): each rank keeps
             its shard of every leaf (``param_specs(replicated=False)``),
             all-gathered before use; rows split over it too, inside
             ``data`` (JAX ``batch_spec()``: ``P(("data", "fsdp"))``)
    seq    — context parallel over the L axis (halo exchanges and the
             two-pass sharded scan; models/caduceus.py)
    tensor — tensor parallel over the mixers' d_inner axis (Mamba-2: the
             heads); each rank keeps its slice of those leaves
             (``param_specs(replicated=False)``, ``tensor_dims``) and the
             mixers sum the contractions over d_inner (models/caduceus.py)
    pipe   — pipeline parallel over the layer stack (GPipe schedule;
             parallel/pipeline.py); each rank keeps its stage's layers
             (``param_specs(pipeline=True)``)

As in JAX, ``seq`` does not combine with ``tensor``, and ``pipe`` combines
with ``data`` and ``fsdp`` only; the layers must divide over ``pipe``.

The backend is chosen once, from the configuration (:func:`choose_backend`):
NCCL where every rank has a card of its own, gloo where the ranks run on
the CPU or share one card. Under gloo every collective stages its tensors
through host memory (``parallel/collectives.py``).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

AXES = ("data", "fsdp", "seq", "tensor", "pipe")
# The axis sets that get process groups: each axis, the batch axes (the
# gradient sums of LoRA and distillation), the data and seq axes (the
# sharded leaves' gradient sum before the fsdp reduce-scatter), all three
# (the loss normaliser and the replicated leaves' gradient sum), the batch
# axes with pipe (the last stage's gated loss and accuracy), and every axis
# (the gradient norm of leaves split over tensor, pipe and fsdp).
GROUP_AXES = tuple((a,) for a in AXES) + (("data", "fsdp"), ("data", "seq"),
                                          ("data", "fsdp", "seq"), ("data", "fsdp", "pipe"), AXES)
SEQ_TENSOR_MSG = ("sequence and tensor parallelism cannot be combined "
                  "(the context-parallel mixer needs unsharded d_inner)")
PIPE_MSG = ("pipeline parallelism combines with data/fsdp only "
            "(parallel/pipeline.py module docstring)")
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1      # -1: all remaining ranks
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int, int, int, int]:
        fixed = self.fsdp * self.seq * self.tensor * self.pipe
        data = self.data
        if data == -1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by "
                    f"fsdp*seq*tensor*pipe={fixed}")
            data = n_devices // fixed
        if data * fixed != n_devices:
            raise ValueError(
                f"mesh {data}x{self.fsdp}x{self.seq}x{self.tensor}"
                f"x{self.pipe} != {n_devices} devices")
        return data, self.fsdp, self.seq, self.tensor, self.pipe


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its size, this rank's coordinate
    on it, the global ranks of this rank's line in coordinate order, and the
    line's process group (None when the axis has size 1)."""

    name: str
    size: int
    index: int
    ranks: Tuple[int, ...]
    group: Optional[object]
    staged: bool  # collectives copy their tensors to the host first (gloo)


@dataclasses.dataclass
class Mesh:
    """This rank's view of the grid: ``shape`` by axis name, its
    coordinates, and a process group for each axis set of ``GROUP_AXES``."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    rank: int
    world_size: int
    backend: Optional[str]
    _groups: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], Optional[object]]]

    def axis(self, *names: str) -> Axis:
        """The line through this rank along ``names`` (one axis, or several
        taken together, such as ``("data", "seq")``)."""
        ranks, group = self._groups[names]
        index = ranks.index(self.rank)
        return Axis("+".join(names), len(ranks), index, ranks, group,
                    staged=self.backend == "gloo")


def choose_backend(device: torch.device, local_world_size: int) -> str:
    """NCCL when the ranks run on cards and each has its own, gloo when
    they run on the CPU or share cards. Decided by the configuration alone
    and logged; never a fallback after a failure."""
    if device.type == "cuda" and torch.cuda.device_count() >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device: str, local_rank: int, local_world_size: int) -> torch.device:
    """The device of this rank: its own card when every rank has one, card
    ``local_rank % cards`` when ranks share them, the CPU when asked."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {local_rank}: device {device!r} requested but CUDA is not "
                           "available; pass the CPU device to run on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) outside a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize_distributed(device: str = "cuda", store=None, rank: Optional[int] = None,
                           world_size: Optional[int] = None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group and return this rank's device. The ranks come
    from ``torch.distributed.run``'s environment (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``)
    or from ``store``/``rank``/``world_size``; a single process (no
    ``WORLD_SIZE`` above 1) joins nothing. The counterpart of JAX's
    ``jax.distributed.initialize()`` behind ``JAX_COORDINATOR_ADDRESS``."""
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if rank is None:
        rank = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = rank_device(device, local_rank, local_world)
    if world_size == 1 or dist.is_initialized():
        return dev
    backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = dict(store=store) if store is not None else dict(init_method="env://")
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    log.info("rank %d of %d on %s over %s (%s)", rank, world_size, dev, backend,
             "one card a rank" if backend == "nccl" else
             "ranks on the CPU or sharing a card; collectives staged through the host")
    return dev


def rank_grid(shape: Dict[str, int]) -> torch.Tensor:
    """The ranks laid out on the ``AXES`` grid, ``pipe`` innermost (JAX
    ``make_mesh``'s reshape of its device list)."""
    dims = [shape[a] for a in AXES]
    return torch.arange(int(torch.tensor(dims).prod())).reshape(dims)


def make_mesh(config: Optional[MeshConfig] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """The grid over every rank of the process group (one rank, and no
    group, in a single process). Every rank must call it with the same
    config: the groups of every line are created on every rank, in one
    order. Refuses JAX's axis combinations (:func:`check_axes`) first."""
    config = config or MeshConfig()
    rank, n = world()
    shape = dict(zip(AXES, config.resolve(n)))
    check_axes(shape)
    grid = rank_grid(shape)
    dims = list(grid.shape)
    coords = dict(zip(AXES, (int(i) for i in (grid == rank).nonzero()[0])))
    backend = dist.get_backend() if n > 1 else None
    timeout = datetime.timedelta(seconds=timeout_s)
    groups, made = {}, {}
    for names in GROUP_AXES:
        axes = [AXES.index(a) for a in names]
        rest = [i for i in range(len(AXES)) if i not in axes]
        lines = grid.permute(rest + axes).reshape(-1, int(torch.tensor(
            [dims[i] for i in axes]).prod()))
        mine = None
        for line in map(tuple, lines.tolist()):
            # every rank creates every group, in the same order; a line that
            # another axis set already spans (an axis of size 1 added) reuses
            # its group
            if line not in made:
                made[line] = dist.new_group(list(line), timeout=timeout) if len(line) > 1 \
                    else None
            if rank in line:
                mine = (line, made[line])
        groups[names] = mine
    return Mesh(shape, coords, rank, n, backend, groups)


def check_axes(shape: Dict[str, int]) -> None:
    """JAX's refusals of axis combinations (``make_grad_fn``,
    ``make_train_step``): seq with tensor; pipe with tensor or seq."""
    if shape.get("pipe", 1) > 1 and (shape.get("tensor", 1) > 1 or shape.get("seq", 1) > 1):
        raise ValueError(PIPE_MSG)
    if shape.get("seq", 1) > 1 and shape.get("tensor", 1) > 1:
        raise ValueError(SEQ_TENSOR_MSG)


def check_stages(n_layer: int, pipe: int) -> None:
    """JAX ``make_train_step``'s refusal of a layer count that does not
    divide over the pipeline stages."""
    if pipe > 1 and n_layer % pipe:
        raise ValueError(f"n_layer={n_layer} must divide evenly over pipe={pipe} stages")


SEQ_SHARDED_KEYS = frozenset({"input_ids", "labels", "loss_weights"})


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n_rows``: contiguous blocks
    over ``data × fsdp``, ``data`` outer and ``fsdp`` inner, as JAX shards
    the leading axis over ``P(("data", "fsdp"))``."""
    d = mesh.shape["data"] * mesh.shape["fsdp"]
    if n_rows % d:
        raise ValueError(f"batch rows {n_rows} must divide over the {d}-way batch axes "
                         "(data x fsdp)")
    per = n_rows // d
    k = mesh.coords["data"] * mesh.shape["fsdp"] + mesh.coords["fsdp"]
    return slice(k * per, (k + 1) * per)


def shard_length(L: int, mesh: Mesh) -> slice:
    """This rank's positions of a length-``L`` axis sharded over ``seq``."""
    s = mesh.shape["seq"]
    if L % s:
        raise ValueError(f"length {L} must divide over the {s}-way seq axis")
    per = L // s
    return slice(mesh.coords["seq"] * per, (mesh.coords["seq"] + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's part of a global host batch: rows over ``data × fsdp``; with a
    seq axis above 1, the L axis of the [B, L] token arrays (``input_ids``,
    ``labels``, ``loss_weights``) over ``seq`` too (JAX ``shard_batch``, as
    per-rank slicing: every rank holds the same global batch)."""
    out = {}
    sp = mesh.shape["seq"] > 1
    for k, a in batch.items():
        a = a[shard_rows(a.shape[0], mesh)]
        if sp and k in SEQ_SHARDED_KEYS and a.ndim == 2:
            a = a[:, shard_length(a.shape[1], mesh)]
        out[k] = a
    return out


# Mamba-2 (SSD) leaves that stay replicated over 'tensor' although the
# head-sharded mixer consumes them on every tensor rank: each rank's gradient
# is a partial that the train step sums over 'tensor' as well (JAX
# ``TENSOR_PARTIAL_LEAVES``). Kept beside the tensor rule of ``param_specs``;
# ``validate_tp_grad_coverage`` checks that every block leaf is covered by one
# of the two.
TENSOR_PARTIAL_LEAVES = ("in_proj_B", "in_proj_C", "conv_B_w", "conv_B_b",
                         "conv_C_w", "conv_C_b")

# Block leaves outside the tensor-sharded mixer interior (the residual RMS
# norm): replicated over 'tensor', and their gradients are already whole on
# every rank (``_tp_boundary``'s adjoint sums the cotangent entering the
# mixer), so they need neither a 'tensor' axis nor a sum.
_TP_FULL_GRAD_BLOCK_LEAVES = ("norm_weight",)

# The tensor rule: the d_inner (Mamba-2: heads) axis of each mixer leaf, in
# the JAX layout (stacked on n_layer; [L, G or Gio, ...]).
TP_AXES = {
    "in_proj_x": 3,   # [L, Gio, d, di]
    "in_proj_z": 3,
    "out_proj": 2,    # [L, Gio, di, d] -> di (contracted; summed)
    "conv_w": 2, "conv_b": 2,
    "x_proj_dt": 2,   # [L, G, di, R]
    "x_proj_B": 2, "x_proj_C": 2,
    "dt_proj_w": 3,   # [L, G, R, di]
    "dt_proj_b": 2, "A_log": 2, "D": 2,
    "in_proj_dt": 3,  # [L, G, d, H]
    "conv_x_w": 2, "conv_x_b": 2,        # [L, G, di, K] / [L, G, di]
    "mixer_norm_weight": 2,              # [L, Gio, di]
    "dt_bias": 2,                        # [L, G, H]
}


def param_specs(replicated: bool = True, pipeline: bool = False):
    """Partition rule ``rule(path, shape) -> spec`` for the parameters in the
    JAX layout (``path`` like ``"blocks/in_proj_x"``, block leaves stacked on
    n_layer), JAX ``param_specs``'s rule: a spec is a tuple of one axis name
    or None per dimension, ``()`` replicated.

    ``replicated=True``: every leaf replicated. ``replicated=False``: the
    tensor rule (``TP_AXES``: each mixer leaf's d_inner axis over
    ``"tensor"``), then FSDP: the largest remaining axis of size above 1
    (the first of equals) over ``"fsdp"``. ``pipeline=True``: every block
    leaf's n_layer axis over ``"pipe"`` (stages hold disjoint layers, even
    when replicated), and without ``replicated`` the largest other axis over
    fsdp; the embedding, final norm and head stay replicated across stages.
    The port's FSDP applies the largest-axis rule to its own per-layer
    leaves (``fsdp_dims``), and its tensor layout takes the tensor axis of
    this rule (``tensor_dims``): the layouts are internal, and checkpoints
    hold full tensors."""

    def rule(path: str, shape: Tuple[int, ...]) -> tuple:
        if pipeline and "blocks" in path.split("/"):
            axes: list = [None] * len(shape)
            axes[0] = "pipe"
            if not replicated:
                free = [i for i, a in enumerate(axes) if a is None and shape[i] > 1]
                if free:
                    axes[max(free, key=lambda i: shape[i])] = "fsdp"
            return tuple(axes)
        if replicated:
            return ()
        leaf = path.split("/")[-1]
        axes = [None] * len(shape)
        if leaf in TP_AXES and len(shape) > TP_AXES[leaf]:
            axes[TP_AXES[leaf]] = "tensor"
        free = [i for i, a in enumerate(axes) if a is None and shape[i] > 1]
        if free:
            axes[max(free, key=lambda i: shape[i])] = "fsdp"
        return tuple(axes)

    return rule


def param_spec_tree(params, replicated: bool = True, pipeline: bool = False):
    """The spec of every leaf of a nested dict in the JAX layout (arrays,
    or their shapes as tuples; JAX ``param_pspec_tree``)."""
    rule = param_specs(replicated, pipeline=pipeline)

    def walk(tree, prefix):
        return {k: walk(v, prefix + (k,)) if isinstance(v, dict)
                else rule("/".join(prefix + (k,)), tuple(getattr(v, "shape", v)))
                for k, v in tree.items()}

    return walk(params, ())


def validate_tp_grad_coverage(spec_tree) -> None:
    """Raise unless every block leaf of ``spec_tree`` (from
    :func:`param_spec_tree`) is covered by the tensor gradient rules:
    tensor-sharded (its gradient local), in ``TENSOR_PARTIAL_LEAVES``
    (replicated, its gradient summed over 'tensor'), or a residual-norm leaf
    whose gradient is whole (JAX ``validate_tp_grad_coverage``): a new mixer
    leaf that is none of these would train with wrong gradients under
    tensor parallelism."""
    bad = []

    def check(tree, names):
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, names + (k,))
            elif "blocks" in names + (k,) and not (
                    k in TENSOR_PARTIAL_LEAVES or k in _TP_FULL_GRAD_BLOCK_LEAVES
                    or "tensor" in v):
                bad.append(k)

    check(spec_tree, ())
    if bad:
        raise ValueError(
            "tensor-parallel gradient rules don't cover mixer leaves "
            f"{sorted(set(bad))}: shard them over 'tensor' in "
            "parallel.mesh.param_specs, or add them to "
            "TENSOR_PARTIAL_LEAVES / _TP_FULL_GRAD_BLOCK_LEAVES with the "
            "matching _sync_grads semantics")


def tensor_dims(shapes: Dict[str, Tuple[int, ...]], n_shards: int) -> Dict[str, Optional[int]]:
    """The axis of each of the port's parameters (per-layer block leaves
    ``layers.<i>.<key>``) that the tensor rule shards over ``tensor``, or
    None. Raises a ``ValueError`` naming the leaf when that axis does not
    divide over ``n_shards``."""
    rule = param_specs(replicated=False)
    dims = {}
    for name, shape in shapes.items():
        parts = name.split(".")
        d = None
        if parts[0] == "layers":
            spec = rule(f"blocks/{parts[-1]}", (1,) + tuple(shape))
            d = spec.index("tensor") - 1 if "tensor" in spec else None
        if d is not None and shape[d] % n_shards:
            raise ValueError(f"tensor: leaf {name!r} axis {d} of size {shape[d]} does not "
                             f"divide over the {n_shards}-way tensor axis")
        dims[name] = d
    return dims


def fsdp_dims(shapes: Dict[str, Tuple[int, ...]], n_shards: int) -> Dict[str, Optional[int]]:
    """The axis of each leaf that ``param_specs(replicated=False)`` shards
    over ``fsdp`` (None: replicated). Raises a ``ValueError`` that names the
    leaf and the axis when its size does not divide over ``n_shards`` (no
    padding: JAX's ``shard_map`` refuses it too)."""
    rule = param_specs(replicated=False)
    dims = {}
    for name, shape in shapes.items():
        spec = rule(name, tuple(shape))   # a port name: the largest-axis rule alone
        d = spec.index("fsdp") if "fsdp" in spec else None
        if d is not None and shape[d] % n_shards:
            raise ValueError(f"fsdp: leaf {name!r} axis {d} of size {shape[d]} does not "
                             f"divide over the {n_shards}-way fsdp axis")
        dims[name] = d
    return dims


def cli_mesh(seq: int = 1, flag: str = "--seq", fsdp: int = 1, tensor: int = 1,
             pipe: int = 1) -> Optional[Mesh]:
    """The mesh of an entry point: data × fsdp × seq × tensor × pipe over
    the process group's ranks (``data`` the ranks left over, as JAX's
    ``make_mesh``), or None in a single process with every axis 1. Exits
    when the ranks do not divide over the axes (``flag`` names the seq
    option); ``make_mesh`` refuses JAX's axis combinations."""
    n = world()[1]
    for size, name in ((seq, flag), (fsdp, "--fsdp"), (tensor, "--tensor"), (pipe, "--pipe")):
        if size < 1 or n % size:
            raise SystemExit(
                f"{name} {size}: {n} rank(s) do not divide over it; start a multiple of {size} "
                "ranks, e.g. python -m torch.distributed.run --nproc-per-node "
                f"{max(size, 1)} -m <entry point> ... {name} {size}")
    fixed = seq * fsdp * tensor * pipe
    if n % fixed:
        named = " ".join(f"{k} {v}" for k, v in (("--fsdp", fsdp), (flag, seq),
                                                 ("--tensor", tensor), ("--pipe", pipe))
                         if v > 1)
        raise SystemExit(f"{named}: {n} rank(s) do not divide over {fixed}")
    if n == 1:
        return None
    mesh = make_mesh(MeshConfig(fsdp=fsdp, seq=seq, tensor=tensor, pipe=pipe))
    log.info("mesh: %s", mesh.shape)
    return mesh


def barrier() -> None:
    """Wait for every rank (nothing in a single process): after rank 0
    writes what the others read next."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def refuse_multi_rank(what: str) -> None:
    """Exit when this process is one of several ranks: ``what`` runs on one
    device, as the JAX package's counterpart does (it builds no mesh), and
    several copies of it would each write the same files."""
    n = max(int(os.environ.get("WORLD_SIZE", "1")), world()[1])
    if n > 1:
        raise SystemExit(f"{what}: started as one of {n} ranks; it runs on one device, as "
                         "the JAX package's CLI does (it builds no mesh)")
