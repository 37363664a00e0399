"""The port's distillation, planted-structure harness and GPN baseline
against the JAX package, on the CPU.

* ``train/distill``: three float32 distillation steps of tests/test_distill.py's
  tiny Mamba-1 teacher and Mamba-2 student, the weights carried across by
  ``compat/params``, the same batches and optimizer (warmup, clipping, the
  decay mask), against JAX ``make_distill_step`` on a one-device mesh:
  every metric, and every updated parameter within 1e-5 of its leaf's max
  |value|. ``alpha = 0`` gives the pre-training step's loss, as in JAX.
* ``cli/distill``: the preset-teacher and student refusals, ``--fsdp 2`` in
  one process refused (it needs 2 ranks); a
  tiny run resumed from its checkpoint to the same bits, whose ``final/``
  both packages' importers read.
* ``train/convergence``: ``planted_corpus`` equals JAX's string for string;
  ``evaluate_structure`` on carried-across weights within 1e-5 of JAX's; a
  two-step ``train_planted`` (the learning claim is the card's, at JAX's
  150 and 200 steps).
* ``models/gpn``: the forward and the weighted masked CE against JAX's, in
  float32, within 1e-5 of max |logit|; the weights crossing both ways.

JAX's compiles are kept short: its sequential reference scan and XLA's
optimisation passes off for this module.
"""

import dataclasses
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.models import caduceus as jcaduceus
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu_torch.compat import params as cparams
from plantcaduceus_tpu_torch.models import caduceus
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train import distill
from plantcaduceus_tpu_torch.train.masking import MlmCollator
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

T_CFG = dict(d_model=32, n_layer=2, vocab_size=16, d_state=8)
S_CFG = dict(d_model=32, n_layer=2, vocab_size=16, ssm_variant="mamba2", d_state=8,
             head_dim=16, chunk_size=32)
TOL = 1e-5
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3, weight_decay=0.01, grad_clip=1.0)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for this module's tiny JAX programs."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale else 1.0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _leaves(x, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def _batches(n, rows=8, L=64):
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        ids = rng.integers(7, 11, size=(rows, L)).astype(np.int32)
        w = np.where(rng.random((rows, L)) < 0.3, 0.1, 1.0).astype(np.float32)
        out.append(MlmCollator(DnaTokenizer(), seed=i)(ids, loss_weights=w))
    return out


def _weights():
    """Teacher and student weights from the port's initialisers, as numpy
    pytrees both packages take (JAX configs on the sequential scan)."""
    tcfg, scfg = CaduceusConfig(**T_CFG), CaduceusConfig(**S_CFG)
    teacher = cparams.to_jax_params(caduceus.Caduceus(tcfg, caduceus.init_params(tcfg, seed=0)))
    student = cparams.to_jax_params(caduceus.Caduceus(scfg, caduceus.init_params(scfg, seed=1)))
    return (tcfg, scfg, JaxConfig(**T_CFG, scan_impl="sequential"), JaxConfig(**S_CFG),
            teacher, student)


def _jax_steps(jtcfg, jscfg, teacher, student, batches, alpha=0.5):
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import distill as jdistill
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt

    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=1), devices=jax.devices()[:1])
    tx = jax_opt(params=student, **OPT)
    init, step = jdistill.make_distill_step(jtcfg, jscfg, tx, mesh, student, dtype=jnp.float32,
                                            alpha=alpha, remat=False)
    state, metrics = init(student), []
    for b in batches:
        state, m = step(state, teacher, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state.params), metrics


def _port_steps(tcfg, scfg, teacher, student, batches, alpha=0.5, remat=True):
    t_model = cparams.from_jax_params(teacher, tcfg)
    s_model = cparams.from_jax_params(student, scfg)
    opt = make_optimizer(params=dict(s_model.named_parameters()), **OPT)
    init, step = distill.make_distill_step(tcfg, scfg, opt, s_model, dtype=torch.float32,
                                           alpha=alpha, remat=remat, device="cpu")
    state, metrics = init(), []
    for b in batches:
        state, m = step(state, t_model, b)
        metrics.append({k: float(v) for k, v in m.items()})
    assert not any(p.requires_grad for p in t_model.parameters())
    return cparams.to_jax_params(s_model), metrics


def test_three_distill_steps_match_jax():
    tcfg, scfg, jtcfg, jscfg, teacher, student = _weights()
    batches = _batches(3)
    want_p, want_m = _jax_steps(jtcfg, jscfg, teacher, student, batches)
    got_p, got_m = _port_steps(tcfg, scfg, teacher, student, batches)
    for s, (g, w) in enumerate(zip(got_m, want_m)):
        assert g.keys() == w.keys() == {"loss", "accuracy", "kl", "hard", "agree", "grad_norm"}
        for k in w:
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (s, k, g[k], w[k])
    got, want = _leaves(got_p), _leaves(want_p)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(got[k], want[k]) <= TOL, (k, _rel(got[k], want[k]))


def test_alpha0_equals_pretrain_loss():
    """With alpha = 0 the objective is the pre-training MLM loss (same
    weights and normaliser): the KL term is inert, as in JAX."""
    from plantcaduceus_tpu_torch.train import step as step_lib

    tcfg, scfg, _, _, teacher, student = _weights()
    batch = _batches(1)
    _, dm = _port_steps(tcfg, scfg, teacher, student, batch, alpha=0.0, remat=False)
    model = cparams.from_jax_params(student, scfg)
    opt = make_optimizer(params=dict(model.named_parameters()), **OPT)
    init, step, _ = step_lib.make_train_step(scfg, opt, model, dtype=torch.float32,
                                             remat=False, device="cpu")
    _, tm = step(init(), batch[0])
    assert dm[0]["loss"] == pytest.approx(float(tm["loss"]), rel=1e-6)
    assert dm[0]["hard"] == pytest.approx(float(tm["loss"]), rel=1e-6)
    assert dm[0]["grad_norm"] == pytest.approx(float(tm["grad_norm"]), rel=1e-5)
    with pytest.raises(ValueError, match="vocab"):
        distill.make_distill_step(tcfg, dataclasses.replace(scfg, vocab_size=32), opt, model,
                                  device="cpu")


def test_distill_cli_refuses_and_resumes(tmp_path):
    from plantcaduceus_tpu.compat.hf_import import import_params
    from plantcaduceus_tpu_torch.cli import distill as cli
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.compat.hf_import import import_model

    base = ["--student-preset", "l20-ssd", "--dataset", "synthetic",
            "--output-dir", str(tmp_path / "never")]
    with pytest.raises(SystemExit, match="randomly initialised"):
        cli.main(["--teacher", "l20"] + base)
    with pytest.raises(SystemExit, match="student"):
        cli.main(["--teacher", "l20", "--allow-random-teacher", "--dataset", "synthetic",
                  "--output-dir", str(tmp_path / "never")])
    # --fsdp 2 is taken; one process does not divide over it
    assert cli.parse_args(["--teacher", "l20", "--fsdp", "2"] + base).fsdp == 2
    with pytest.raises(SystemExit, match="--fsdp 2: 1 rank"):
        cli.main(["--teacher", "l20", "--allow-random-teacher", "--fsdp", "2",
                  "--device", "cpu"] + base)
    assert not (tmp_path / "never").exists()

    tcfg, scfg, _, _, teacher, _ = _weights()
    export_hf_dir(tmp_path / "teacher", teacher, tcfg)
    (tmp_path / "student.json").write_text(json.dumps(S_CFG))
    args = ["--teacher", str(tmp_path / "teacher"), "--student-config",
            str(tmp_path / "student.json"), "--dataset", "synthetic", "--window", "64",
            "--batch-size", "4", "--dtype", "float32", "--save-steps", "2", "--log-steps", "1",
            "--warmup-steps", "1", "--lr", "1e-3", "--device", "cpu"]
    cli.main(args + ["--max-steps", "4", "--output-dir", str(tmp_path / "full")])
    cli.main(args + ["--max-steps", "2", "--output-dir", str(tmp_path / "resumed")])
    cli.main(args + ["--max-steps", "4", "--output-dir", str(tmp_path / "resumed")])
    want, got = (torch.load(tmp_path / r / "final" / "pytorch_model.bin", weights_only=True)
                 for r in ("full", "resumed"))
    assert want.keys() == got.keys() and all(torch.equal(got[k], want[k]) for k in want)
    model, cfg = import_model(tmp_path / "full" / "final")
    assert cfg.ssm_variant == "mamba2"
    jparams, jcfg = import_params(tmp_path / "full" / "final")
    got, want = _leaves(cparams.to_jax_params(model)), _leaves(jax.device_get(jparams))
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# the planted-structure harness
# ---------------------------------------------------------------------------

CONV = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)


def test_planted_corpus_equals_jax():
    from plantcaduceus_tpu.train import convergence as jconv
    from plantcaduceus_tpu_torch.train import convergence as conv

    for n, window, seed in ((32, 128, 5), (8, 160, 123)):
        assert conv.planted_corpus(n, window, seed=seed) == jconv.planted_corpus(n, window,
                                                                                seed=seed)
    s = conv.planted_corpus(4, 128, seed=0)[0]
    assert conv.motif_starts(s) == jconv.motif_starts(s) and len(conv.motif_starts(s)) >= 2
    with pytest.raises(ValueError, match="repeat tract"):
        conv.planted_corpus(1, 100)


def test_evaluate_structure_matches_jax_and_trains():
    """Two steps of ``train_planted`` on the CPU, then the probes on those
    weights through both packages."""
    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer as JaxTokenizer
    from plantcaduceus_tpu.train import convergence as jconv
    from plantcaduceus_tpu_torch.train import convergence as conv

    cfg = CaduceusConfig(**CONV)
    run = conv.train_planted(cfg, steps=2, batch=4, n_corpus=16, loss_every=1, device="cpu")
    assert [s for s, _ in run["losses"]] == [1, 2] and np.isfinite(run["final_loss"])
    assert run["state"].step == 2 and len(run["corpus"]) == 16
    got = conv.evaluate_structure(run, n_eval=24)
    jrun = dict(run, cfg=JaxConfig(**CONV, scan_impl="sequential"), tokenizer=JaxTokenizer(),
                dtype=jnp.float32, state=types.SimpleNamespace(
                    params=cparams.to_jax_params(run["state"].model)))
    want = jconv.evaluate_structure(jrun, n_eval=24)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL * max(1.0, abs(want[k])), (k, got[k], want[k])
    assert conv.evaluate_structure(run, n_eval=8, held_out=False).keys() == want.keys()


# ---------------------------------------------------------------------------
# GPN
# ---------------------------------------------------------------------------


def test_gpn_forward_and_loss_match_jax():
    from plantcaduceus_tpu.models import gpn as jgpn
    from plantcaduceus_tpu_torch.models import gpn

    cfg = gpn.GpnConfig(d_model=32, n_layer=4, kernel_size=5, dilation_max=2, dilation_cycle=3)
    jcfg = jgpn.GpnConfig(**dataclasses.asdict(cfg))
    assert cfg.dilation_schedule() == jcfg.dilation_schedule() == [1, 2, 2, 1]  # cap, cycle
    assert gpn.GpnConfig(n_layer=8).dilation_schedule() == \
        jgpn.GpnConfig(n_layer=8).dilation_schedule() == [1, 2, 4, 8, 16, 32, 1, 2]
    # the port's weights in JAX's layout (shapes from JAX's init_params,
    # traced, not run), then across and back
    params = cparams.gpn_to_jax_params(gpn.Gpn(cfg, gpn.init_params(cfg, seed=0)))
    shapes = jax.eval_shape(lambda k: jgpn.init_params(k, jcfg), jax.random.PRNGKey(0))
    want_shapes = {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
                   leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert {k: v.shape for k, v in _leaves(params).items()} == want_shapes
    model = cparams.gpn_from_jax_params(params, cfg)
    got_p, want_p = _leaves(cparams.gpn_to_jax_params(model)), _leaves(params)
    assert got_p.keys() == want_p.keys()
    assert all(np.array_equal(got_p[k], want_p[k]) for k in want_p)
    rng = np.random.default_rng(0)
    ids = rng.integers(7, 11, (3, 48)).astype(np.int32)
    want = jax.jit(lambda p, i: jgpn.forward(p, i, jcfg, dtype=jnp.float32))(params, ids)
    got = gpn.forward(model, torch.from_numpy(ids).long(), dtype=torch.float32)
    for k in ("logits", "hidden_states"):
        assert got[k].shape == want[k].shape
        assert _rel(got[k].numpy(), want[k]) <= TOL, k
    labels = np.where(rng.random(ids.shape) < 0.2, ids, -100)
    w = rng.random(ids.shape).astype(np.float32)
    lw = jcaduceus.mlm_loss(want["logits"], jnp.asarray(labels), jnp.asarray(w))
    lp = caduceus.mlm_loss(got["logits"], torch.from_numpy(labels).long(), torch.from_numpy(w))
    assert float(lp) == pytest.approx(float(lw), rel=TOL)
    own = gpn.Gpn(gpn.GpnConfig(n_layer=2), gpn.init_params(gpn.GpnConfig(n_layer=2), seed=1))
    assert own.layers[0].conv_w.shape == (9, 256, 256)
    with pytest.raises(KeyError, match="lacks"):
        cparams.gpn_from_jax_params({"embedding": params["embedding"]}, cfg)
