"""What the ranks of ``tests/test_torch_tensor.py`` and
``tests/test_torch_pipeline.py`` run, and the one-process runs beside them
(the same functions with no mesh).

The ranks are started by ``tests/torch_parallel_ranks.Ranks`` (gloo over a
``FileStore``, one PyTorch thread a rank); rank 0 writes each result to
``<name>.npz`` in the work directory (the CLI writes its own run dirs
there). This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from tests.torch_multirank_jobs import ROWS, WINDOW, _mesh, _mlm_batches
from tests.torch_parallel_ranks import TINY, _save

TINY4 = dict(TINY, n_layer=4)     # 4 layers: 2 a stage at pipe 2
TINY_SSD = dict(d_model=16, n_layer=2, vocab_size=16, ssm_variant="mamba2", d_state=4,
                head_dim=8, n_groups=1, chunk_size=16)   # 4 heads: 2 a rank at tensor 2
MODELS = {"mamba1": TINY4, "mamba2": TINY_SSD}


class _KeepGrads:
    """The optimizer, keeping a copy of each update's (synced) gradients."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        self.grads.append({n: g.detach().clone() for n, g in grads.items()})
        return self.opt.update(grads, state, params, **kw)


def _full(state, tree):
    """A dict shaped as the layout's ``masters()`` as full tensors of every
    leaf (a collective under a layout)."""
    return state.layout.full(tree) if state.layout is not None else tree


def steps_run(config=None, model="mamba1", pp_microbatches=None) -> dict:
    """2 fp32 train steps (8 rows, grad-accum 2, remat) of a tiny model
    over ``config``'s mesh: each step's metrics and full gradients, an eval
    step's metrics, the full weights after."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg = CaduceusConfig(**MODELS[model])
    net = Caduceus(cfg, init_params(cfg, seed=2))
    opt = _KeepGrads(make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                                    params=dict(net.named_parameters())))
    init, step, eval_step = step_lib.make_train_step(
        cfg, opt, net, dtype=torch.float32, remat=True, grad_accum=2, device="cpu",
        mesh=_mesh(config), pp_microbatches=pp_microbatches)
    ds = _mlm_batches()
    state, out = init(), {}
    for s in range(2):
        state, m = step(state, ds.batch_at(s))
        out.update({f"{k}{s}": torch.tensor(float(v)) for k, v in m.items()})
    ev = eval_step(state, ds.batch_at(0))
    out.update({"eval_" + k: torch.tensor(float(v)) for k, v in ev.items()})
    for s, g in enumerate(opt.grads):
        out.update({f"g{s}_{n}": t for n, t in _full(state, g).items()})
    masters = state.layout.masters() if state.layout is not None else dict(
        net.named_parameters())
    out.update({"p_" + n: p.detach().clone() for n, p in _full(state, masters).items()})
    return out


def pretrain_args(workdir: Path, config: str = "tiny4.json") -> list:
    """``cli.pretrain`` flags of a tiny model, fp32 steps of 8 rows, a
    checkpoint every step."""
    return ["--dataset", "synthetic", "--config", str(workdir / config), "--window",
            str(WINDOW), "--batch-size", str(ROWS), "--save-steps", "1", "--log-steps", "1",
            "--warmup-steps", "1", "--lr", "1e-3", "--dtype", "float32", "--device", "cpu"]


def write_configs(workdir: Path) -> None:
    for name, kw in (("tiny4.json", TINY4), ("tiny_ssd.json", TINY_SSD)):
        (workdir / name).write_text(json.dumps(kw))


def tensor2(rank, world, workdir):
    """2 ranks: the train steps at tensor 2 (Mamba-1 and Mamba-2), and
    ``cli.pretrain --tensor 2``: 2 steps, and 1 step then a resume to 2."""
    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    for model in MODELS:
        _save(rank, workdir, f"tensor2_{model}", steps_run(MeshConfig(tensor=2), model))
    args = pretrain_args(workdir) + ["--tensor", "2"]
    pretrain.main(args + ["--max-steps", "2", "--output-dir", str(workdir / "full")])
    pretrain.main(args + ["--max-steps", "1", "--output-dir", str(workdir / "resumed")])
    pretrain.main(args + ["--max-steps", "2", "--output-dir", str(workdir / "resumed")])


def tensor4(rank, world, workdir):
    """4 ranks: the train steps at data 2 x tensor 2 (Mamba-1 and Mamba-2)."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    for model in MODELS:
        _save(rank, workdir, f"data2_tensor2_{model}",
              steps_run(MeshConfig(data=2, tensor=2), model))


def pipe2(rank, world, workdir):
    """2 ranks: the train steps at pipe 2 with 2 and 4 microbatches, and
    ``cli.pretrain --pipe 2 --pipe-microbatches 4``: 2 steps, and 1 step
    then a resume to 2."""
    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    for m in (2, 4):
        _save(rank, workdir, f"pipe2_m{m}", steps_run(MeshConfig(pipe=2), pp_microbatches=m))
    args = pretrain_args(workdir) + ["--pipe", "2", "--pipe-microbatches", "4"]
    pretrain.main(args + ["--max-steps", "2", "--output-dir", str(workdir / "full")])
    pretrain.main(args + ["--max-steps", "1", "--output-dir", str(workdir / "resumed")])
    pretrain.main(args + ["--max-steps", "2", "--output-dir", str(workdir / "resumed")])


def pipe4(rank, world, workdir):
    """4 ranks: the train steps at fsdp 2 x pipe 2 (the default 2
    microbatches) and at data 2 x pipe 2."""
    from plantcaduceus_tpu_torch.parallel.mesh import MeshConfig

    _save(rank, workdir, "fsdp2_pipe2", steps_run(MeshConfig(fsdp=2, pipe=2)))
    _save(rank, workdir, "data2_pipe2", steps_run(MeshConfig(data=2, pipe=2)))
