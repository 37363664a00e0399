"""The port's tensor axis on gloo ranks of this CPU, held to the JAX package.

One group of 2 ranks and one of 4 (``tests/torch_tp_pp_jobs.py``:
``tensor2``, ``tensor4``, started once for the module) run the multi-rank
checks while this process computes JAX's references:

* the tensor rule: ``param_spec_tree``, ``TENSOR_PARTIAL_LEAVES`` and
  ``validate_tp_grad_coverage`` against JAX's ``param_pspec_tree`` and its
  lists on the tiny Mamba-1 and Mamba-2 parameters, as data;
* 2 train steps at tensor 2 and at data 2 × tensor 2 (grad-accum 2, 8 rows,
  remat), Mamba-1 (K1-hb/K3's plain versions on the decomposed path) and
  Mamba-2 (heads sharded; SsdDirFn's plain versions): the loss and every
  gradient of both steps within 1e-5 (of each leaf's max |value|) of JAX's
  ``make_grad_fn`` on one device from the same weights and batches, the
  gradient norm within 1e-5 relative, the weights after within 1e-4;
* ``cli.pretrain --tensor 2``: 2 steps against one process, and 1 step
  then a resume under ``--tensor 2`` equal to the 2 steps bit for bit,
  and the same checkpoint resumed in one process;
* the mixers' refusals with JAX's messages (activation-path LoRA with a
  tensor axis, Mamba-2 with ``n_groups`` above 1, Mamba-2 with tensor and
  seq).

Float32 throughout.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_jax_steps import as_jax_paths, assert_close, jax_two_steps
from tests.torch_parallel_ranks import Ranks
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_tp_pp_jobs import MODELS, TINY_SSD, pretrain_args, write_configs

GRAD_TOL, PARAM_TOL, METRIC_TOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = {}
    for world, job in ((2, "tensor2"), (4, "tensor4")):
        d = tmp_path_factory.mktemp(job)
        write_configs(d)
        runs[world] = Ranks(world, f"tests.torch_tp_pp_jobs:{job}", d)
    yield runs
    for r in runs.values():
        r.wait()


def _result(ranks, world, name):
    return dict(np.load(ranks[world].wait() / f"{name}.npz"))


def _jax_params(model_kw):
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(**model_kw)
    return jax.tree.map(jnp.asarray, to_jax_params(Caduceus(cfg, init_params(cfg, seed=2))))


# -- the rules, as data (no ranks) ---------------------------------------------------


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("replicated,pipeline", [(False, False), (True, True), (False, True)])
def test_param_spec_tree_matches_jax(model, replicated, pipeline):
    from plantcaduceus_tpu.parallel.mesh import param_pspec_tree
    from plantcaduceus_tpu_torch.parallel.mesh import param_spec_tree

    params = _jax_params(MODELS[model])
    want = param_pspec_tree(params, replicated=replicated, pipeline=pipeline)
    got = param_spec_tree(params, replicated=replicated, pipeline=pipeline)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(v) for path, v in
            jax.tree_util.tree_flatten_with_path(
                want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    assert {"/".join(p): v for p, v in _flatten(got)} == flat


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_grad_coverage_matches_jax(model):
    """The lists are JAX's; every tiny block leaf is covered; a leaf the
    rules miss is refused with JAX's message."""
    from plantcaduceus_tpu.parallel import mesh as jax_mesh
    from plantcaduceus_tpu_torch.parallel import mesh

    assert mesh.TENSOR_PARTIAL_LEAVES == jax_mesh.TENSOR_PARTIAL_LEAVES
    assert mesh._TP_FULL_GRAD_BLOCK_LEAVES == jax_mesh._TP_FULL_GRAD_BLOCK_LEAVES
    params = _jax_params(MODELS[model])
    mesh.validate_tp_grad_coverage(mesh.param_spec_tree(params, replicated=False))
    params["blocks"]["extra_w"] = jnp.zeros((2, 1, 7))
    with pytest.raises(ValueError) as want:
        jax_mesh.validate_tp_grad_coverage(jax_mesh.param_pspec_tree(params, replicated=False))
    with pytest.raises(ValueError) as got:
        mesh.validate_tp_grad_coverage(mesh.param_spec_tree(params, replicated=False))
    assert str(got.value) == str(want.value)


def test_tensor_dims_take_the_rule_on_the_port_leaves():
    """Each per-layer leaf's tensor axis is the rule's, less the n_layer
    axis; an axis that does not divide is refused with the leaf named."""
    from plantcaduceus_tpu_torch.parallel.mesh import TP_AXES, tensor_dims

    shapes = {"layers.0.in_proj_x": (1, 16, 32), "layers.1.out_proj": (1, 32, 16),
              "layers.0.norm_weight": (16,), "layers.0.in_proj_B": (2, 16, 4),
              "embedding": (16, 16)}
    assert tensor_dims(shapes, 2) == {"layers.0.in_proj_x": TP_AXES["in_proj_x"] - 1,
                                      "layers.1.out_proj": 1, "layers.0.norm_weight": None,
                                      "layers.0.in_proj_B": None, "embedding": None}
    with pytest.raises(ValueError, match="leaf 'layers.0.in_proj_x' axis 2 of size 32 does "
                                         "not divide over the 3-way tensor axis"):
        tensor_dims(shapes, 3)


# -- the train steps against JAX (its references compute while the ranks run) -------


@pytest.fixture(scope="module")
def jax_refs(ranks):
    return {m: jax_two_steps(kw) for m, kw in MODELS.items()}


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("run,world", [("tensor2", 2), ("data2_tensor2", 4)])
def test_tensor_steps_match_jax_one_device(jax_refs, ranks, model, run, world):
    steps, want_params, net = jax_refs[model]
    got = _result(ranks, world, f"{run}_{model}")
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


def test_pretrain_cli_tensor2_matches_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    pretrain.main(pretrain_args(d) + ["--max-steps", "2", "--output-dir", str(tmp_path / "one")])
    want, got = _final(tmp_path / "one"), _final(d / "full")
    assert set(got) == set(want)
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


def test_tensor2_checkpoint_resumes_under_tensor2_bit_for_bit(ranks):
    """The step-1 checkpoint holds full tensors (the one-process format),
    and resumed under ``--tensor 2`` reaches the 2 uninterrupted steps'
    weights bit for bit."""
    d = ranks[2].wait()
    want, got = _final(d / "full"), _final(d / "resumed")
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    saved = torch.load(d / "resumed" / "1" / "state.pt", weights_only=True)
    assert saved["step"] == 1 and saved["opt_state"]["count"] == 1
    cfg = CaduceusConfig(**MODELS["mamba1"])
    shapes = {n: p.shape for n, p in Caduceus(cfg, init_params(cfg)).named_parameters()}
    assert set(saved["model"]) == set(shapes)
    for k, v in saved["model"].items():
        opt = saved["opt_state"]
        assert v.shape == opt["mu"][k].shape == opt["nu"][k].shape == shapes[k], k


def test_tensor2_checkpoint_resumes_in_one_process(ranks, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = ranks[2].wait()
    shutil.copytree(d / "resumed" / "1", tmp_path / "run" / "1")
    pretrain.main(pretrain_args(d) + ["--max-steps", "2", "--output-dir", str(tmp_path / "run")])
    want, got = _final(d / "full"), _final(tmp_path / "run")
    for k, v in want.items():
        assert_close(got[k].numpy(), v.numpy(), PARAM_TOL, k)


# -- refusals, with JAX's messages ----------------------------------------------------


def _refusal(fn):
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return type(e), str(e)
    raise AssertionError("no refusal")


@pytest.mark.parametrize("case", ["lora_mamba1", "lora_mamba2", "groups", "seq_and_tensor"])
def test_tensor_mixer_refusals_match_jax(case):
    from plantcaduceus_tpu.models import caduceus as jax_caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu_torch.models import caduceus
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.parallel.mesh import Axis

    kw = dict(MODELS["mamba1"] if case == "lora_mamba1" else TINY_SSD)
    if case == "groups":
        kw["n_groups"] = 2
    cfg, jcfg = CaduceusConfig(**kw), JaxConfig(**kw)
    model = caduceus.Caduceus(cfg, caduceus.init_params(cfg, seed=0))
    p = model.layers[0].params()
    jp = jax.tree.map(lambda a: jnp.asarray(a)[0], _jax_params(kw)["blocks"])
    tp = Axis("tensor", 2, 0, (0, 1), None, staged=True)
    sp = Axis("seq", 2, 0, (0, 1), None, staged=True)
    mixer = caduceus.mamba2_mixer if kw.get("ssm_variant") == "mamba2" else caduceus.mamba_mixer
    jmixer = (jax_caduceus.mamba2_mixer if kw.get("ssm_variant") == "mamba2"
              else jax_caduceus.mamba_mixer)
    lora = {"adapters": {}, "scale": 1.0} if case.startswith("lora") else None
    x = torch.zeros(1, 16, cfg.d_model)
    got = _refusal(lambda: mixer(p, x, cfg, lora=lora, tp=tp,
                                 sp=sp if case == "seq_and_tensor" else None))
    want = _refusal(lambda: jmixer(jp, jnp.zeros((1, 16, cfg.d_model)), jcfg, tp_axis="tensor",
                                   sp_axis="seq" if case == "seq_and_tensor" else None,
                                   lora=lora))
    assert got == want


def test_pretrain_takes_the_tensor_flag(tmp_path):
    """``--tensor`` is live with JAX's default (1); a count of ranks it does
    not divide is refused before any work."""
    from plantcaduceus_tpu_torch.cli import pretrain

    base = ["--dataset", "synthetic", "--output-dir", str(tmp_path), "--device", "cpu"]
    assert pretrain.parse_args(base).tensor == 1
    assert pretrain.parse_args(base + ["--tensor", "2"]).tensor == 2
    (tmp_path / "tiny.json").write_text(json.dumps(MODELS["mamba1"]))
    with pytest.raises(SystemExit, match="--tensor 2: 1 rank"):
        pretrain.main(base + ["--config", str(tmp_path / "tiny.json"), "--tensor", "2"])
