"""Ranks for the port's multi-rank CPU tests: gloo over a ``FileStore``.

:class:`Ranks` starts ``world`` Python processes (``python -m
tests.torch_parallel_ranks``), each joining one process group through a
``FileStore`` under the test's directory (never a fixed TCP port: several
test workers run at once), with a 60 s timeout on every group and one
PyTorch thread a rank, and runs one function named ``module:function``.
The parent waits with a deadline and kills every rank still alive, so a
rank that hangs or dies fails the test instead of hanging the suite. This
module imports neither JAX nor the JAX package: the ranks run the port
alone, and the tests compare what they write with JAX in the parent.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

GROUP_TIMEOUT_S = 60.0
DEADLINE_S = 180.0
REPO = Path(__file__).resolve().parents[1]


def _entry(target: str, rank: int, world: int, workdir: Path) -> None:
    import torch
    import torch.distributed as dist

    from plantcaduceus_tpu_torch.parallel import mesh as meshlib

    torch.set_num_threads(1)
    store = dist.FileStore(str(workdir / "store"), world)
    meshlib.initialize_distributed("cpu", store=store, rank=rank, world_size=world,
                                   timeout_s=GROUP_TIMEOUT_S)
    module, fn = target.rsplit(":", 1)
    getattr(importlib.import_module(module), fn)(rank, world, workdir)
    dist.barrier()
    dist.destroy_process_group()


class Ranks:
    """``world`` rank processes running ``target``; :meth:`wait` joins them."""

    def __init__(self, world: int, target: str, workdir: Path):
        workdir.mkdir(parents=True, exist_ok=True)
        self.target, self.workdir = target, workdir
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([str(REPO), *sys.path]))
        self.logs = [open(workdir / f"rank{r}.log", "w+b") for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_ranks", target, str(r), str(world),
             str(workdir)], cwd=REPO, env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        self.end = time.monotonic() + DEADLINE_S

    def wait(self) -> Path:
        """Join the ranks; raise with their output if one failed or the
        deadline passed (every rank still alive is killed first)."""
        if self.procs is None:
            return self.workdir
        procs, self.procs = self.procs, None
        try:
            while any(p.poll() is None for p in procs):
                if time.monotonic() > self.end or any(p.poll() not in (None, 0) for p in procs):
                    break  # past the deadline, or a rank died: do not wait for its siblings
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        codes = [p.returncode for p in procs]
        out = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            out.append(f"--- rank {r} (exit {codes[r]}):\n" + f.read().decode()[-4000:])
            f.close()
        if any(codes):
            raise RuntimeError(f"{self.target} failed on {len(procs)} ranks (deadline "
                               f"{DEADLINE_S} s)\n" + "\n".join(out))
        return self.workdir


def randn32(rng, *shape, sc=1.0, shift=0.0):
    import numpy as np

    return (rng.standard_normal(shape) * sc + shift).astype(np.float32)


def scan_inputs(L=64):
    """Inputs of both sharded scans, from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(7)
    G, B, D, N, R = 2, 1, 16, 4, 3
    inp = {}
    for pre, R_ in (("m1f_", R), ("m1u_", D)):
        inp.update({pre + "x": randn32(rng, G, B, L, D), pre + "dt": randn32(rng, G, B, L, R_, sc=0.5,
                                                                       shift=-0.5),
                    pre + "A": -np.exp(randn32(rng, G, D, N, sc=0.5)),
                    pre + "Bm": randn32(rng, G, B, L, N), pre + "Cm": randn32(rng, G, B, L, N),
                    pre + "Ds": randn32(rng, G, D), pre + "dtb": randn32(rng, G, D, sc=0.3),
                    pre + "cot": randn32(rng, G, B, L, D)})
    inp["m1f_W"] = randn32(rng, G, R, D, sc=0.3)
    Bs, H, Pd, NG, Ns = 2, 4, 8, 2, 4
    inp.update({"ssd_x": randn32(rng, Bs, L, H * Pd), "ssd_dt": randn32(rng, Bs, L, H, sc=0.5,
                                                                  shift=-1.0),
                "ssd_A": -np.exp(randn32(rng, H, sc=0.5)), "ssd_Bm": randn32(rng, Bs, L, NG, Ns),
                "ssd_Cm": randn32(rng, Bs, L, NG, Ns), "ssd_Ds": randn32(rng, H),
                "ssd_dtb": randn32(rng, H, sc=0.3), "ssd_cot": randn32(rng, Bs, L, H * Pd),
                "ssd_chunk": np.int64(16)})
    return inp


# -- what the ranks run ---------------------------------------------------------
#
# Every function reads ``inputs.npz`` (written by the test from a numpy seed)
# from the work directory, runs the port over its mesh and has rank 0 write
# the assembled results (outputs gathered along L, gradients summed over the
# ranks) to ``<name>.npz`` there.

TINY = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)
TINY2 = dict(d_model=16, n_layer=2, vocab_size=16, ssm_variant="mamba2", d_state=4,
             head_dim=8, n_groups=2, chunk_size=16)
MODELS = {"mamba1": TINY, "mamba2": TINY2}


def _inputs(workdir):
    import numpy as np

    return dict(np.load(workdir / "inputs.npz"))


def _save(rank, workdir, name, out):
    import numpy as np

    if rank == 0:
        np.savez(workdir / f"{name}.npz",
                 **{k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
                    for k, v in out.items()})


def _sharded_grads(sp, fn, full, cot, dim, device="cpu"):
    """Run ``fn`` on this rank's slice (along ``dim``) of every ``full``
    tensor marked in it, against the matching slice of ``cot``; return the
    output gathered along ``dim`` and every leaf's gradient summed over
    ``sp``."""
    import torch

    from plantcaduceus_tpu_torch.parallel.collectives import all_gather, psum

    leaves = {k: torch.from_numpy(v).to(device).requires_grad_(True) for k, v in full.items()}
    L = cot.shape[dim]
    per = L // sp.size
    sl = [slice(None)] * cot.ndim
    sl[dim] = slice(sp.index * per, (sp.index + 1) * per)
    y = fn(leaves, tuple(sl))
    (y * torch.from_numpy(cot).to(device)[tuple(sl)]).sum().backward()
    out = {"y": torch.cat(list(all_gather(y.detach(), sp)), dim=dim)}
    for k, t in leaves.items():
        out["d_" + k] = psum(t.grad, sp)
    return out


def scans_on_card(rank, world, workdir):
    """:func:`scans` with every rank's tensors on ``cuda:0`` (the kernels;
    gloo stages the collectives through the host)."""
    scans(rank, world, workdir, device="cuda", ssd=False)


def scans(rank, world, workdir, device="cpu", ssd=True):
    """Both sharded scans (the Mamba-1 one alone without ``ssd``) over
    ``world`` seq shards: forward and the gradient of sum(y * cot)."""
    from plantcaduceus_tpu_torch.ops.seq_parallel import selective_scan_seq_sharded
    from plantcaduceus_tpu_torch.ops.ssd_seq_parallel import ssd_dir_seq_sharded
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    inp = _inputs(workdir)
    sp = make_mesh(MeshConfig(seq=world)).axis("seq")
    seq_keys = ("x", "dt", "Bm", "Cm")

    for fused in (True, False):
        pre = "m1f_" if fused else "m1u_"
        full = {k: inp[pre + k] for k in seq_keys + ("A", "Ds", "dtb")}
        if fused:
            full["W"] = inp[pre + "W"]

        def m1(t, sl, fused=fused):
            loc = {k: t[k][sl] if k in seq_keys else t[k] for k in t}
            return selective_scan_seq_sharded(
                loc["x"], loc["dt"], loc["A"], loc["Bm"], loc["Cm"], loc["Ds"], loc["dtb"],
                loc["W"] if fused else None, sp, directions=(False, True))

        _save(rank, workdir, pre + "scan",
              _sharded_grads(sp, m1, full, inp[pre + "cot"], dim=2, device=device))

    full = {k: inp["ssd_" + k] for k in seq_keys + ("A", "Ds", "dtb")}
    for reverse in (False, True) if ssd else ():
        def ssd(t, sl, reverse=reverse):
            loc = {k: t[k][sl] if k in seq_keys else t[k] for k in t}
            return ssd_dir_seq_sharded(loc["x"], loc["dt"], loc["A"], loc["Bm"], loc["Cm"],
                                       loc["Ds"], loc["dtb"], int(inp["ssd_chunk"]), reverse, sp)

        _save(rank, workdir, f"ssd{int(reverse)}_scan",
              _sharded_grads(sp, ssd, full, inp["ssd_cot"], dim=1, device=device))



def _grads_by_name(model):
    return {"g_" + n: p.grad for n, p in model.named_parameters()}


def models_seq(rank, world, workdir):
    """The tiny Mamba-1 and Mamba-2 models with L over ``world`` seq shards
    (fp32, remat): logits gathered along L, and the weights' gradients of
    sum(logits * cot) summed over the shards."""
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, forward, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.collectives import all_gather, psum
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh, shard_length

    inp = _inputs(workdir)
    mesh = make_mesh(MeshConfig(seq=world))
    sp = mesh.axis("seq")
    ids, cot = torch.from_numpy(inp["ids"]), torch.from_numpy(inp["cot"])
    sl = shard_length(ids.shape[1], mesh)
    for name, kw in MODELS.items():
        model = Caduceus(CaduceusConfig(**kw), init_params(CaduceusConfig(**kw), seed=5))
        model.requires_grad_(True)
        logits = forward(model, ids[:, sl], dtype=torch.float32, remat=True, sp=sp)["logits"]
        (logits * cot[:, sl]).sum().backward()
        out = {"logits": torch.cat(list(all_gather(logits.detach(), sp)), dim=1)}
        out.update({k: psum(g, sp) for k, g in _grads_by_name(model).items()})
        _save(rank, workdir, f"model_{name}", out)


def train_steps(rank, world, workdir, config, grad_accum):
    """2 fp32 train steps of the tiny Mamba-1 model over ``config``'s mesh:
    each step's metrics and the weights after them."""
    import torch

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.mesh import make_mesh
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg = CaduceusConfig(**TINY)
    model = Caduceus(cfg, init_params(cfg, seed=2))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                         params=dict(model.named_parameters()))
    init, step, eval_step = step_lib.make_train_step(
        cfg, opt, model, dtype=torch.float32, remat=True, grad_accum=grad_accum,
        device="cpu", mesh=make_mesh(config))
    seqs = data_lib.sequence_source("synthetic", window=64, synthetic_n=64, seed=3)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=3)
    state, out = init(), {}
    for s in range(2):
        state, m = step(state, ds.batch_at(s))
        out.update({f"{k}{s}": torch.tensor(float(v)) for k, v in m.items()})
    ev = eval_step(state, ds.batch_at(0))
    out.update({"eval_" + k: torch.tensor(float(v)) for k, v in ev.items()})
    out.update({"p_" + n: p.detach() for n, p in model.named_parameters()})
    return out


def row_split_scores(rank, world, workdir):
    """``nucleotide_probs`` with each batch's rows split over a
    ``world``-way data axis."""
    import torch

    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    cfg = CaduceusConfig(**TINY)
    runner = InferenceRunner(Caduceus(cfg, init_params(cfg, seed=5)), cfg,
                             dtype=torch.float32, batch_size=2, device="cpu",
                             mesh=make_mesh(MeshConfig(data=world)))
    seqs = [str(s) for s in _inputs(workdir)["windows"]]
    probs = zero_shot.nucleotide_probs(runner, DnaTokenizer(), seqs, 32, progress=False)
    _save(rank, workdir, "row_split", {"probs": probs})


def halo_conv(rank, world, workdir):
    """``halo_depthwise_conv_silu`` over ``world`` seq shards, both
    directions: output and gradients of sum(out * cot)."""
    from plantcaduceus_tpu_torch.ops.conv import halo_depthwise_conv_silu
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    inp = _inputs(workdir)
    sp = make_mesh(MeshConfig(seq=world)).axis("seq")
    for anti in (False, True):
        def conv(t, sl, anti=anti):
            return halo_depthwise_conv_silu(t["x"][sl], t["w"], t["b"], anti, sp)

        _save(rank, workdir, f"halo{int(anti)}",
              _sharded_grads(sp, conv, {k: inp["halo_" + k] for k in ("x", "w", "b")},
                             inp["halo_cot"], dim=1))


def collective_adjoints(rank, world, workdir):
    """``all_gather``, ``ppermute`` (coordinate i to i + 1) and ``psum`` of
    rank r's ``coll_x[r]`` over ``world`` ranks, against the cotangents
    ``coll_g[r]``, ``coll_p[r]``, ``coll_s[r]``: every rank's forward
    outputs and the gradient of its input."""
    import torch

    from plantcaduceus_tpu_torch.parallel.collectives import all_gather, ppermute, psum
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    inp = _inputs(workdir)
    ax = make_mesh(MeshConfig(seq=world)).axis("seq")
    x = torch.from_numpy(inp["coll_x"][rank]).requires_grad_(True)
    g, p, s = (torch.from_numpy(inp[k][rank]) for k in ("coll_g", "coll_p", "coll_s"))
    ys = (all_gather(x, ax), ppermute(x, ax, [(i, i + 1) for i in range(world - 1)]),
          psum(x, ax))
    sum((y * c).sum() for y, c in zip(ys, (g, p, s))).backward()
    out = {k: all_gather(v.detach(), ax) for k, v in zip(("gather", "permute", "sum"), ys)}
    out["grad"] = all_gather(x.grad, ax)
    _save(rank, workdir, "collectives", out)


def world2(rank, world, workdir):
    """Every 2-rank check of ``tests/test_torch_parallel.py`` but the CLI's."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    halo_conv(rank, world, workdir)
    scans(rank, world, workdir)
    models_seq(rank, world, workdir)
    row_split_scores(rank, world, workdir)
    for name, config in (("train_data2", MeshConfig(data=2)), ("train_seq2", MeshConfig(seq=2))):
        _save(rank, workdir, name, train_steps(rank, world, workdir, config, grad_accum=2))


def world4(rank, world, workdir):
    """Every 4-rank check of ``tests/test_torch_parallel.py``: the
    collectives' adjoints, both scans at 4 shards, and the refusal of seq
    with tensor."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    collective_adjoints(rank, world, workdir)
    scans(rank, world, workdir)
    try:
        make_mesh(MeshConfig(seq=2, tensor=2))
        msg = ""
    except ValueError as e:
        msg = str(e)
    _save(rank, workdir, "seq_tensor", {"msg": msg})


if __name__ == "__main__":
    _entry(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
