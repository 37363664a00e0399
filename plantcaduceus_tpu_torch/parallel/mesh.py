"""Device mesh over ``torch.distributed`` ranks, process groups and batch
slicing.

Counterpart of ``plantcaduceus_tpu.parallel.mesh``. One rank drives one
device. The ranks form a ``(data, fsdp, seq, tensor, pipe)`` grid in JAX's
device order (``pipe`` innermost), so rank = ``(((d·F + f)·S + s)·T + t)·P
+ p``, and each axis gets the process groups of its lines:

    data   — batch parallel: rows split over it, gradients summed over it
    seq    — context parallel over the L axis (halo exchanges and the
             two-pass sharded scan; models/caduceus.py)
    fsdp, tensor, pipe — not ported yet (``NOT_PORTED``)

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
NOT_PORTED = ("not ported to the PyTorch port yet (ROADMAP.md, Queue 1 item 9b: FSDP, "
              "tensor and pipeline parallelism, multi-rank LoRA, distillation and serving)")
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
    coordinates, and a process group for each axis and for the axis pair
    the train step reduces over."""

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
    order."""
    config = config or MeshConfig()
    rank, n = world()
    shape = dict(zip(AXES, config.resolve(n)))
    if shape["seq"] > 1 and shape["tensor"] > 1:
        raise ValueError("sequence and tensor parallelism cannot be combined "
                         "(the context-parallel mixer needs unsharded d_inner)")
    unported = {k: v for k, v in shape.items() if k in ("fsdp", "tensor", "pipe") and v > 1}
    if unported:
        raise NotImplementedError(f"mesh axes {unported}: {NOT_PORTED}")
    grid = rank_grid(shape)
    dims = list(grid.shape)
    coords = dict(zip(AXES, (int(i) for i in (grid == rank).nonzero()[0])))
    backend = dist.get_backend() if n > 1 else None
    timeout = datetime.timedelta(seconds=timeout_s)
    groups = {}
    for names in [(a,) for a in AXES] + [("data", "seq")]:
        axes = [AXES.index(a) for a in names]
        rest = [i for i in range(len(AXES)) if i not in axes]
        lines = grid.permute(rest + axes).reshape(-1, int(torch.tensor(
            [dims[i] for i in axes]).prod()))
        mine = None
        for line in lines.tolist():
            # every rank creates every group, in the same order
            group = dist.new_group(line, timeout=timeout) if len(line) > 1 else None
            if rank in line:
                mine = (tuple(line), group)
        groups[names] = mine
    return Mesh(shape, coords, rank, n, backend, groups)


SEQ_SHARDED_KEYS = frozenset({"input_ids", "labels", "loss_weights"})


def shard_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n_rows``: contiguous blocks in
    ``data`` coordinate order, as JAX shards the leading axis."""
    d = mesh.shape["data"]
    if n_rows % d:
        raise ValueError(f"batch rows {n_rows} must divide over the {d}-way data axis")
    per = n_rows // d
    return slice(mesh.coords["data"] * per, (mesh.coords["data"] + 1) * per)


def shard_length(L: int, mesh: Mesh) -> slice:
    """This rank's positions of a length-``L`` axis sharded over ``seq``."""
    s = mesh.shape["seq"]
    if L % s:
        raise ValueError(f"length {L} must divide over the {s}-way seq axis")
    per = L // s
    return slice(mesh.coords["seq"] * per, (mesh.coords["seq"] + 1) * per)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's part of a global host batch: rows over ``data``; with a
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


def param_specs(replicated: bool = True, pipeline: bool = False):
    """Partition rule for the parameters: every leaf replicated (an empty
    spec). Sharded layouts (``replicated=False``: FSDP and tensor
    parallelism; ``pipeline=True``) are refused."""
    if not replicated or pipeline:
        raise NotImplementedError(
            f"sharded parameter layouts (replicated={replicated}, pipeline={pipeline}) are "
            f"{NOT_PORTED}")
    return lambda path, shape: ()


def cli_mesh(seq: int, flag: str = "--seq") -> Optional[Mesh]:
    """The mesh of an entry point that takes ``seq`` (``flag``): data × seq
    over the process group's ranks, or None in a single process with
    ``seq`` 1. Exits when the ranks do not divide over ``seq``."""
    n = world()[1]
    if seq < 1 or n % seq:
        raise SystemExit(
            f"{flag} {seq}: {n} rank(s) do not divide over it; start a multiple of {seq} "
            "ranks, e.g. python -m torch.distributed.run --nproc-per-node "
            f"{max(seq, 1)} -m <entry point> ... {flag} {seq}")
    if n == 1:
        return None
    mesh = make_mesh(MeshConfig(seq=seq))
    log.info("mesh: %s", mesh.shape)
    return mesh


def refuse_multi_rank(what: str) -> None:
    """Exit when this process is one of several ranks: ``what`` runs on one
    device, and several copies of it would each write the same files."""
    n = max(int(os.environ.get("WORLD_SIZE", "1")), world()[1])
    if n > 1:
        raise SystemExit(f"{what}: started as one of {n} ranks; multi-rank runs of it are "
                         f"{NOT_PORTED}")
