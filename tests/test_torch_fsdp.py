"""The port's fsdp axis on gloo ranks of this CPU: FSDP training,
checkpoints across layouts and distillation.

One group of 2 ranks and one of 4 (``tests/torch_multirank_jobs.py``:
``fsdp2``, ``fsdp4``, started once for the module) run every multi-rank
check and write their results, while this process computes the references:

* 2 train steps at fsdp 2 and at data 2 × fsdp 2 (grad-accum 2, 8 rows)
  against JAX's ``make_train_step`` on one device (JAX on one device equals
  JAX over ``fsdp``), with ``test_torch_parallel.py``'s tolerances, the
  gradient norm included; what each rank holds between steps; those steps
  and fsdp 2 × seq 2's against the port in one process;
* ``cli.pretrain --fsdp 2``: 4 steps against one process; 2 steps and a
  resume under ``--fsdp 2`` equal to the 4 steps bit for bit, and the
  same checkpoint resumed in one process;
* 2 distillation steps at fsdp 2 and at data 2 × fsdp 2 against the port's
  one-process distillation (itself held to JAX by
  ``tests/test_torch_distill.py``);
* ``psum_scatter`` and the tiled ``all_gather`` (and their adjoints) at 2
  and 4 ranks against their definitions, and ``broadcast``.

Without ranks: the rule's divisibility refusal, each rank's blocks of every
leaf, and distillation's refusal of the seq axis with JAX's message.

Float32 throughout. The ranks sum gradients in other orders than one
process: weights within 1e-4 of each leaf's max |value| and metrics within
1e-5 relative, against the port's own one-process runs.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_multirank_jobs import distill_run, pretrain_args, train_run
from tests.torch_parallel_ranks import TINY, Ranks, randn32
from tests.torch_threads import one_torch_thread  # noqa: F401

PARAM_TOL, METRIC_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both groups of ranks, started before any test, and their inputs."""
    rng = np.random.default_rng(31)
    runs = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"fsdp{world}")
        np.savez(d / "inputs.npz", ps_x=randn32(rng, world, 2 * world, 3),
                 ps_c=randn32(rng, world, 2, 3), ag_x=randn32(rng, world, 2, 3),
                 ag_c=randn32(rng, world, 2, 3 * world))
        (d / "tiny.json").write_text(json.dumps(TINY))
        runs[world] = Ranks(world, f"tests.torch_multirank_jobs:fsdp{world}", d)
    yield runs
    for r in runs.values():
        r.wait()


def _result(ranks, world, name):
    return dict(np.load(ranks[world].wait() / f"{name}.npz"))


def _params(res):
    return {k[2:]: v for k, v in res.items() if k.startswith("p_")}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-6)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"


# -- without ranks -----------------------------------------------------------------


class _OneAxisMesh:
    """A mesh stand-in: the fsdp axis at coordinate ``index`` of ``size``."""

    def __init__(self, index, size):
        from plantcaduceus_tpu_torch.parallel.mesh import Axis

        self.shape = {"data": 1, "fsdp": size, "seq": 1, "tensor": 1, "pipe": 1}
        self._axis = Axis("fsdp", size, index, tuple(range(size)), None, staged=True)

    def axis(self, *names):
        return self._axis


def test_fsdp_rule_refuses_an_axis_that_does_not_divide():
    from plantcaduceus_tpu_torch.parallel.mesh import fsdp_dims

    assert fsdp_dims({"a": (6, 4), "b": (1,), "c": (2, 8, 8)}, 2) == {"a": 0, "b": None, "c": 1}
    with pytest.raises(ValueError, match="leaf 'a' axis 0 of size 6 does not divide over the "
                                         "4-way fsdp axis"):
        fsdp_dims({"a": (6, 4)}, 4)


@pytest.mark.parametrize("size", [2, 4])
def test_each_rank_keeps_its_block_of_every_leaf(size):
    """The blocks of the ranks put back together along each leaf's axis are
    the leaf; the module keeps no copy of a sharded leaf."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train.step import FsdpParams

    cfg = CaduceusConfig(**TINY)
    full = {n: p.detach().clone()
            for n, p in Caduceus(cfg, init_params(cfg, seed=2)).named_parameters()}
    ranks = []
    for i in range(size):
        model = Caduceus(cfg, init_params(cfg, seed=2))
        ranks.append(FsdpParams(model, _OneAxisMesh(i, size)))
        assert all(p.numel() == 0 for n, p in model.named_parameters() if n in ranks[i].shards)
    assert set(ranks[0].sharded) == set(full)   # every tiny leaf has an axis to shard
    for n, t in full.items():
        d = ranks[0].dims[n]
        assert torch.equal(torch.cat([r.shards[n] for r in ranks], d), t), n


def test_distillation_refuses_seq_with_jax_message():
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train.distill import make_distill_step
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg = CaduceusConfig(**TINY)
    mesh = _OneAxisMesh(0, 1)
    mesh.shape["seq"] = 2
    model = Caduceus(cfg, init_params(cfg, seed=2))
    with pytest.raises(ValueError, match="^distillation supports data/fsdp meshes only$"):
        make_distill_step(cfg, cfg, make_optimizer(), model, device="cpu", mesh=mesh)


# -- the train steps against JAX (its reference computes while the ranks run) -------


@pytest.fixture(scope="module")
def jax_train(ranks):
    """2 steps of JAX ``make_train_step`` on one device (grad-accum 2, the
    ranks' 8-row batches): each step's metrics and the weights after."""
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu.parallel import mesh as jax_mesh
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from tests.torch_multirank_jobs import _mlm_batches

    cfg = CaduceusConfig(**TINY)
    model = Caduceus(cfg, init_params(cfg, seed=2))
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=1), devices=jax.devices()[:1])
    tx = jax_opt(learning_rate=1e-3, warmup_steps=1, total_steps=3, params=params)
    init, step, _ = jax_step.make_train_step(JaxConfig(**TINY, scan_impl="sequential"), tx, mesh,
                                             params, dtype=jnp.float32, remat=False,
                                             grad_accum=2)
    ds = _mlm_batches()
    state, metrics = init(params), []
    for s in range(2):
        state, m = step(state, {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.params), model


def _as_jax_leaves(model, by_name):
    from plantcaduceus_tpu_torch.compat.params import to_jax_params

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(by_name[n]))
    tree = to_jax_params(model)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("run", ["train_fsdp2", "train_data2_fsdp2"],
                         ids=["fsdp2", "data2_fsdp2"])
def test_train_steps_match_jax_one_device(jax_train, ranks, run):
    """As ``test_torch_parallel.py``'s: loss 1e-5 relative, accuracy 1e-6,
    the gradient norm 1e-4 relative, weights 1e-4 / 1e-5."""
    metrics, want_tree, model = jax_train
    got = _result(ranks, 2 if run == "train_fsdp2" else 4, run)
    for s, m in enumerate(metrics):
        assert float(got[f"loss{s}"]) == pytest.approx(m["loss"], rel=1e-5), s
        assert float(got[f"accuracy{s}"]) == pytest.approx(m["accuracy"], abs=1e-6), s
        assert float(got[f"grad_norm{s}"]) == pytest.approx(m["grad_norm"], rel=1e-4), s
    assert np.isfinite(float(got["eval_loss"])) and 0 <= float(got["eval_accuracy"]) <= 1
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(want_tree)[0]}
    got_p = _as_jax_leaves(model, _params(got))
    for k, v in want.items():
        np.testing.assert_allclose(got_p[k], v, rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("run,world", [("train_fsdp2", 2), ("train_data2_fsdp2", 4)],
                         ids=["fsdp2", "data2_fsdp2"])
def test_each_rank_holds_only_its_blocks_between_steps(ranks, run, world):
    """Between steps a rank holds 1/fsdp of the weights and of each Adam
    moment, and no full copy of a leaf (every tiny leaf is sharded)."""
    got = _result(ranks, world, run)
    full = int(got["full"])
    assert int(got["held_module"]) == 0
    assert int(got["held_blocks"]) == int(got["held_mu"]) == int(got["held_nu"]) == full // 2


@pytest.mark.parametrize("run,world", [("train_fsdp2", 2), ("train_data2_fsdp2", 4),
                                      ("train_fsdp2_seq2", 4)],
                         ids=["fsdp2", "data2_fsdp2", "fsdp2_seq2"])
def test_train_steps_match_one_process(ranks, run, world):
    """The same steps against the port in one process: the sharded path
    computes what the unsharded one does (JAX aside)."""
    want = train_run()
    got = _result(ranks, world, run)
    for k in [k for k in want if not k.startswith("p_")]:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=METRIC_TOL), k
    for n, v in _params(want).items():
        _close(got["p_" + n], v, PARAM_TOL, n)


# -- the pretrain CLI and its checkpoints ---------------------------------------------


def _final(d):
    return torch.load(d / "final" / "pytorch_model.bin", weights_only=True)


def test_pretrain_cli_fsdp2_matches_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    pretrain.main(pretrain_args(d) + ["--max-steps", "4", "--output-dir", str(tmp_path / "one")])
    want, got = _final(tmp_path / "one"), _final(d / "full")
    assert set(got) == set(want)
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


def test_fsdp2_checkpoint_resumes_under_fsdp2_bit_for_bit(ranks):
    """2 steps, then a resume from the step-2 checkpoint to step 4, under
    ``--fsdp 2``: the final weights equal the 4 uninterrupted steps'."""
    d = ranks[2].wait()
    want, got = _final(d / "full"), _final(d / "resumed")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    saved = torch.load(d / "resumed" / "2" / "state.pt", weights_only=True)
    assert saved["step"] == 2 and saved["opt_state"]["count"] == 2
    cfg = CaduceusConfig(**TINY)
    shapes = {n: p.shape for n, p in Caduceus(cfg, init_params(cfg)).named_parameters()}
    assert set(saved["model"]) == set(shapes)
    for k, v in saved["model"].items():   # full tensors: the one-process format
        opt = saved["opt_state"]
        assert v.shape == opt["mu"][k].shape == opt["nu"][k].shape == shapes[k], k


def test_fsdp2_checkpoint_resumes_in_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    shutil.copytree(d / "resumed" / "2", tmp_path / "run" / "2")
    pretrain.main(pretrain_args(d) + ["--max-steps", "4", "--output-dir", str(tmp_path / "run")])
    want, got = _final(d / "full"), _final(tmp_path / "run")
    for k, v in want.items():
        _close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


# -- distillation ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def distill_one():
    return distill_run()


@pytest.mark.parametrize("run,world", [("distill_fsdp2", 2), ("distill_data2_fsdp2", 4)],
                         ids=["fsdp2", "data2_fsdp2"])
def test_distillation_matches_one_process(ranks, distill_one, run, world):
    got = _result(ranks, world, run)
    for k in [k for k in distill_one if not k.startswith("p_")]:
        assert float(got[k]) == pytest.approx(float(distill_one[k]), rel=METRIC_TOL), k
    for n, v in _params(distill_one).items():
        _close(got["p_" + n], v, PARAM_TOL, n)


# -- collectives ------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_psum_scatter_and_tiled_all_gather(ranks, world):
    """``psum_scatter`` (tiled, dim 0): rank r keeps block r of the sum;
    its adjoint is the tiled all_gather of the cotangents. ``all_gather_
    tiled`` (dim 1) concatenates; its adjoint is ``psum_scatter``.
    ``broadcast`` gives every rank coordinate 1's tensor."""
    inp = dict(np.load(ranks[world].workdir / "inputs.npz"))
    got = _result(ranks, world, f"collectives{world}")
    x, c, t, ct = inp["ps_x"], inp["ps_c"], inp["ag_x"], inp["ag_c"]
    total = x.sum(0)
    for r in range(world):
        np.testing.assert_allclose(got["ps"][r], total[2 * r:2 * r + 2], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got["d_ps"][r], np.concatenate(list(c), 0))
        np.testing.assert_array_equal(got["ag"][r], np.concatenate(list(t), 1))
        np.testing.assert_allclose(got["d_ag"][r], ct.sum(0)[:, 3 * r:3 * r + 3], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["bc"][r], t[1])
