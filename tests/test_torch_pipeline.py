"""The port's pipe axis (``parallel/pipeline.py``, GPipe) on gloo ranks of
this CPU, held to the JAX package.

One group of 2 ranks and one of 4 (``tests/torch_tp_pp_jobs.py``:
``pipe2``, ``pipe4``, started once for the module) run the multi-rank
checks while this process computes JAX's reference, on the tiny Mamba-1
model at 4 layers (2 a stage):

* 2 train steps (grad-accum 2, 8 rows, remat) at pipe 2 with 2 and 4
  microbatches, at fsdp 2 × pipe 2 and at data 2 × pipe 2: the loss and
  every gradient of both steps within 1e-5 (of each leaf's max |value|) of
  JAX's ``make_grad_fn`` on one device from the same weights and batches,
  the gradient norm within 1e-5 relative, the weights after within 1e-4;
* ``cli.pretrain --pipe 2 --pipe-microbatches 4``: 2 steps against one
  process, and 1 step then a resume under the same flags equal to the 2
  steps bit for bit, and the same checkpoint resumed in one process;
* JAX's refusals, message for message: pipe with tensor or seq, a layer
  count the stages do not divide, microbatches that do not divide the
  folded rows.

Float32 throughout.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_steps import as_jax_paths, assert_close, jax_two_steps
from tests.torch_parallel_ranks import Ranks
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tp_pp_jobs import TINY4, pretrain_args, write_configs

GRAD_TOL, PARAM_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = {}
    for world, job in ((2, "pipe2"), (4, "pipe4")):
        d = tmp_path_factory.mktemp(job)
        write_configs(d)
        runs[world] = Ranks(world, f"tests.torch_tp_pp_jobs:{job}", d)
    yield runs
    for r in runs.values():
        r.wait()


@pytest.fixture(scope="module")
def jax_ref(ranks):
    return jax_two_steps(TINY4)


@pytest.mark.parametrize("run,world", [("pipe2_m2", 2), ("pipe2_m4", 2), ("fsdp2_pipe2", 4),
                                       ("data2_pipe2", 4)])
def test_pipe_steps_match_jax_one_device(jax_ref, ranks, run, world):
    steps, want_params, net = jax_ref
    got = dict(np.load(ranks[world].wait() / f"{run}.npz"))
    for s, m in enumerate(steps):
        assert float(got[f"loss{s}"]) == pytest.approx(m["loss"], rel=METRIC_TOL), s
        assert float(got[f"grad_norm{s}"]) == pytest.approx(m["grad_norm"], rel=METRIC_TOL), s
        grads = as_jax_paths(net, {k[len(f"g{s}_"):]: v for k, v in got.items()
                                   if k.startswith(f"g{s}_")})
        for k, v in m["grads"].items():
            assert_close(grads[k], v, GRAD_TOL, f"step {s} gradient {k}")
    assert np.isfinite(float(got["eval_loss"])) and 0 <= float(got["eval_accuracy"]) <= 1
    params = as_jax_paths(net, {k[2:]: v for k, v in got.items() if k.startswith("p_")})
    for k, v in want_params.items():
        assert_close(params[k], v, PARAM_TOL, f"weights {k}")


# -- the pretrain CLI and its checkpoints ---------------------------------------------


def _final(d):
    return torch.load(d / "final" / "pytorch_model.bin", weights_only=True)


def test_pretrain_cli_pipe2_matches_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    pretrain.main(pretrain_args(d) + ["--max-steps", "2", "--output-dir", str(tmp_path / "one")])
    want, got = _final(tmp_path / "one"), _final(d / "full")
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


def test_pipe2_checkpoint_resumes_under_pipe2_bit_for_bit(ranks):
    """The step-1 checkpoint holds every layer's full tensors (the
    one-process format); resumed under ``--pipe 2`` it reaches the 2
    uninterrupted steps' weights bit for bit."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    d = ranks[2].wait()
    want, got = _final(d / "full"), _final(d / "resumed")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    saved = torch.load(d / "resumed" / "1" / "state.pt", weights_only=True)
    assert saved["step"] == 1 and saved["opt_state"]["count"] == 1
    cfg = CaduceusConfig(**TINY4)
    shapes = {n: p.shape for n, p in Caduceus(cfg, init_params(cfg)).named_parameters()}
    assert set(saved["model"]) == set(shapes)
    for k, v in saved["model"].items():
        opt = saved["opt_state"]
        assert v.shape == opt["mu"][k].shape == opt["nu"][k].shape == shapes[k], k


def test_pipe2_checkpoint_resumes_in_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    shutil.copytree(d / "resumed" / "1", tmp_path / "run" / "1")
    pretrain.main(pretrain_args(d) + ["--max-steps", "2", "--output-dir", str(tmp_path / "run")])
    want, got = _final(d / "full"), _final(tmp_path / "run")
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


# -- JAX's refusals, message for message ----------------------------------------------


class _Mesh:
    """A mesh stand-in for the refusals, which come before any collective."""

    def __init__(self, **shape):
        self.shape = dict(dict(data=1, fsdp=1, seq=1, tensor=1, pipe=1), **shape)
        self.world_size = int(np.prod(list(self.shape.values())))


def _refusal(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("axes,n_layer", [(dict(pipe=2, tensor=2), 4), (dict(pipe=2, seq=2), 4),
                                          (dict(pipe=2), 3), (dict(seq=2, tensor=2), 4)],
                         ids=["pipe_tensor", "pipe_seq", "layers", "seq_tensor"])
def test_mesh_refusals_match_jax(axes, n_layer):
    """JAX ``make_train_step`` (and ``make_grad_fn``) against the port's
    ``make_train_step`` over the same axes."""
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu.parallel import mesh as jax_mesh
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    kw = dict(TINY4, n_layer=n_layer)
    cfg = CaduceusConfig(**kw)
    model = Caduceus(cfg, init_params(cfg, seed=0))
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    n = int(np.prod(list(axes.values())))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=1, **axes), devices=jax.devices()[:n])
    want = _refusal(lambda: jax_step.make_train_step(JaxConfig(**kw), jax_opt(params=params),
                                                     mesh, params))
    got = _refusal(lambda: step_lib.make_train_step(cfg, make_optimizer(), model, device="cpu",
                                                    mesh=_Mesh(**axes)))
    assert got == want


def test_microbatch_refusal_matches_jax():
    """Microbatches that do not divide the folded rows (2 windows + their
    RC stream = 4 rows, 3 microbatches)."""
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu.parallel.pipeline import pipeline_forward as jax_pipeline_forward
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.mesh import Axis
    from plantcaduceus_tpu_torch.parallel.pipeline import pipeline_forward

    cfg = CaduceusConfig(**TINY4)
    model = Caduceus(cfg, init_params(cfg, seed=0))
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    ids = np.zeros((2, 16), np.int64)
    want = _refusal(lambda: jax_pipeline_forward(params, jnp.asarray(ids), JaxConfig(**TINY4),
                                                 n_stages=2, n_micro=3))
    axis = Axis("pipe", 2, 0, (0, 1), None, staged=True)
    got = _refusal(lambda: pipeline_forward(model, torch.from_numpy(ids), axis, n_micro=3,
                                            dtype=torch.float32))
    assert got == want


def test_pretrain_takes_the_pipe_flags(tmp_path):
    """``--pipe`` and ``--pipe-microbatches`` are live with JAX's defaults
    (1 stage; microbatches: the stage count)."""
    from plantcaduceus_tpu_torch.cli import pretrain

    base = ["--dataset", "synthetic", "--output-dir", str(tmp_path), "--device", "cpu"]
    args = pretrain.parse_args(base)
    assert (args.pipe, args.pipe_microbatches) == (1, None)
    args = pretrain.parse_args(base + ["--pipe", "2", "--pipe-microbatches", "4"])
    assert (args.pipe, args.pipe_microbatches) == (2, 4)
