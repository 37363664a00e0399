"""The port's training stack against the JAX package, on the CPU.

* Batches: ``PretrainDataset.batch_at`` is byte-identical to JAX's.
* Optimizer: 3 AdamW steps (warmup, clipping, decay mask) against optax.
* Train step: 3 full steps from the same weights (``from_jax_params``)
  against JAX ``make_train_step`` on a one-device mesh, for the tied+add
  (K2) and an untied (K1, fused dt) config; grad accumulation and remat.
* Checkpoints and CLI: exact autoresume, the final HF export scored by
  ``cli.zero_shot_score``, and read back by the JAX importer.
* Guards: CUDA asked for and absent, and the refused options.

Float32 throughout. Tolerances: losses 1e-5 relative and gradient norms 1e-4
(the same float32 math, summed in other orders; JAX runs its associative
scan on the CPU, the port its sequential plain versions); parameters after
Adam steps 1e-4 relative + 1e-5 absolute (Adam's m/sqrt(v) turns tiny
gradient differences into update differences of up to ~lr on near-zero
entries; lr is 1e-3 here).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.models import caduceus as jax_caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu_torch.compat.params import from_jax_params, to_jax_params
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train import data as data_lib
from plantcaduceus_tpu_torch.train import step as step_lib
from plantcaduceus_tpu_torch.train.optimizer import decay_mask, jax_leaf, make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(d_model=32, n_layer=2, vocab_size=16, d_state=4)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _leaves(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _assert_params_match(model, jax_params, **tol):
    got, want = _leaves(to_jax_params(model)), _leaves(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _batches(n, rows=4, window=64, seed=3):
    tok = DnaTokenizer()
    seqs = data_lib.sequence_source("synthetic", window=window, synthetic_n=64, seed=seed)
    ds = data_lib.PretrainDataset(seqs, tok, rows, seed=seed)
    return [ds.batch_at(s) for s in range(n)]


# -- data ---------------------------------------------------------------------


def test_batches_byte_identical_to_jax(tmp_path):
    from plantcaduceus_tpu.io.tokenizer import DnaTokenizer as JaxTok
    from plantcaduceus_tpu.train import data as jax_data

    rng = np.random.default_rng(9)
    tsv = tmp_path / "seqs.tsv"
    with open(tsv, "w") as fh:
        fh.write("name\tseq\n")
        for i in range(40):
            fh.write(f"r{i}\t{''.join(rng.choice(list('ACGTacgtN'), 48))}\n")
    for spec, kw in (("synthetic", dict(window=48, synthetic_n=40)), (str(tsv), {})):
        jseqs = jax_data.sequence_source(spec, seed=4, **kw)
        pseqs = data_lib.sequence_source(spec, seed=4, **kw)
        assert pseqs == jseqs
        jd = jax_data.PretrainDataset(jseqs, JaxTok(), 8, seed=4)
        pd = data_lib.PretrainDataset(pseqs, DnaTokenizer(), 8, seed=4)
        for step in (0, 3, 7, 11):  # crosses epoch boundaries (5 batches/epoch)
            want, got = jd.batch_at(step), pd.batch_at(step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                assert got[k].tobytes() == want[k].tobytes(), (spec, step, k)


def test_unsupported_sources_raise(tmp_path):
    """``hf:`` stays refused (network, ``datasets``); a parquet table and a
    ``shards:`` directory load."""
    from plantcaduceus_tpu_torch.io.parquet import write_parquet
    from plantcaduceus_tpu_torch.train.streaming import StreamingPretrainDataset

    with pytest.raises(NotImplementedError, match="HF dataset"):
        data_lib.sequence_source("hf:some/dataset")
    seqs = data_lib.sequence_source("synthetic", window=16, synthetic_n=8, seed=1)
    write_parquet(tmp_path / "x.parquet", {"seq": seqs})
    assert data_lib.sequence_source(str(tmp_path / "x.parquet")) == seqs
    with pytest.raises(ValueError, match="streams"):
        data_lib.sequence_source(f"shards:{tmp_path}")
    batch = next(iter(StreamingPretrainDataset(tmp_path, DnaTokenizer(), 4, window=16)))
    assert batch["input_ids"].shape == (4, 16)


# -- optimizer ------------------------------------------------------------------


def test_optimizer_matches_optax():
    """3 updates with warmup (first lr 0), clipping (global norm > 1 on two
    steps, < 1 on one) and the decay mask, against the JAX optimizer."""
    import optax

    from plantcaduceus_tpu.train.optimizer import _decay_mask, make_optimizer as jax_opt

    cfg = JaxConfig(**TINY)
    params = jax_caduceus.init_params(jax.random.PRNGKey(0), cfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), CaduceusConfig(**TINY))
    named = dict(model.named_parameters())
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0)
    tx = jax_opt(params=params, **kw)
    opt = make_optimizer(params=named, **kw)

    jmask = _leaves(_decay_mask(params))
    pmask = {jax_leaf(n, p.dim())[0]: m for n, p in named.items() for m in [decay_mask(named)[n]]}
    assert pmask == {k: bool(v) for k, v in jmask.items()}
    assert pmask["blocks/conv_w"] and not pmask["blocks/D"] and not pmask["norm_f_weight"]

    opt_state, state = tx.init(params), opt.init(named)

    @jax.jit
    def jax_update(g, opt_state, params):
        upd, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state

    rng = np.random.default_rng(1)
    for scale in (0.05, 0.002, 0.05):
        g_np = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale).astype(np.float32),
                            params)
        params, opt_state = jax_update(jax.tree.map(jnp.asarray, g_np), opt_state, params)
        grads = {}
        for n in named:
            leaf, _ = jax_leaf(n, 0)
            arr = g_np["blocks"][leaf.split("/")[1]][int(n.split(".")[1])] \
                if leaf.startswith("blocks/") else g_np[leaf]
            grads[n] = torch.from_numpy(np.array(arr))
        g_norm = opt.update(grads, state, named)
        np.testing.assert_allclose(float(g_norm), float(optax.global_norm(g_np)), rtol=1e-5)
        _assert_params_match(model, params, rtol=1e-5, atol=1e-7)


# -- train step -----------------------------------------------------------------


def _train_step_fns(model, cfg, **kw):
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                         params=dict(model.named_parameters()))
    return step_lib.make_train_step(cfg, opt, model, dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("overrides", [{}, dict(bidirectional_weight_tie=False)],
                         ids=["tied_add", "untied"])
def test_three_train_steps_match_jax(overrides):
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt

    jcfg = JaxConfig(**TINY, **overrides)
    params = jax_caduceus.init_params(jax.random.PRNGKey(2), jcfg)
    cfg = CaduceusConfig(**TINY, **overrides)
    model = from_jax_params(jax.tree.map(np.asarray, params), cfg)
    batches = _batches(3)

    mesh = meshlib.make_mesh(meshlib.MeshConfig(data=1), devices=jax.devices()[:1])
    tx = jax_opt(learning_rate=1e-3, warmup_steps=1, total_steps=3, params=params)
    init, step, _ = jax_step.make_train_step(jcfg, tx, mesh, params, dtype=jnp.float32,
                                             remat=True)
    jstate, jm = init(params), []
    for b in batches:
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})

    init_p, step_p, eval_p = _train_step_fns(model, cfg, remat=True)
    state, pm = init_p(), []
    for b in batches:
        state, m = step_p(state, b)
        pm.append({k: float(v) for k, v in m.items()})
    for s, (got, want) in enumerate(zip(pm, jm)):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), s
        assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6), s
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4), s
    _assert_params_match(model, jax.device_get(jstate.params), **PARAM_TOL)
    ev = eval_p(state, batches[0])
    assert np.isfinite(float(ev["loss"])) and 0 <= float(ev["accuracy"]) <= 1


def test_grad_accum_equals_big_batch():
    """Unidirectional config (K1 with full-width dt): accum 2 over 8 rows
    == one step on the 8 rows."""
    cfg = CaduceusConfig(**TINY, bidirectional=False, rcps=False)
    params = init_params(cfg, seed=5)
    batch = _batches(1, rows=8)[0]
    out = {}
    for ga in (1, 2):
        model = Caduceus(cfg, params)
        init, step, _ = _train_step_fns(model, cfg, remat=False, grad_accum=ga)
        state, m = step(init(), batch)
        state, m = step(state, batch)   # a second step: the first has lr 0
        out[ga] = (to_jax_params(model), {k: float(v) for k, v in m.items()})
    assert out[1][1]["loss"] == pytest.approx(out[2][1]["loss"], rel=1e-6)
    assert out[1][1]["accuracy"] == out[2][1]["accuracy"]
    assert out[1][1]["grad_norm"] == pytest.approx(out[2][1]["grad_norm"], rel=1e-5)
    for k, v in _leaves(out[1][0]).items():
        np.testing.assert_allclose(_leaves(out[2][0])[k], v, err_msg=k, **PARAM_TOL)


def test_remat_equals_no_remat():
    """Recomputing each block in the backward changes nothing but memory."""
    cfg = CaduceusConfig(**TINY)
    params = init_params(cfg, seed=6)
    batch = _batches(1)[0]
    out = {}
    for remat in (True, False):
        model = Caduceus(cfg, params)
        init, step, _ = _train_step_fns(model, cfg, remat=remat)
        state, _ = step(init(), batch)
        state, m = step(state, batch)
        out[remat] = (to_jax_params(model), {k: float(v) for k, v in m.items()})
    assert out[True][1] == out[False][1]
    for k, v in _leaves(out[True][0]).items():
        np.testing.assert_array_equal(_leaves(out[False][0])[k], v, err_msg=k)


@pytest.mark.parametrize("overrides", [{}, dict(bidirectional_weight_tie=False)],
                         ids=["tied_add", "untied"])
def test_frozen_layer_passes_gradient_through(monkeypatch, overrides):
    """Layer 0 frozen, the rest trained: its mixer still takes the autograd
    route (its input needs a gradient), and the embedding's gradient equals
    the plain path's."""
    from plantcaduceus_tpu_torch.models import caduceus

    cfg = CaduceusConfig(**TINY, **overrides)
    params = init_params(cfg, seed=7)
    ids = torch.from_numpy(_batches(1)[0]["input_ids"]).long()
    routed = []
    for name in ("bimamba_mixer", "selective_scan"):
        fn = getattr(caduceus, name)
        monkeypatch.setattr(caduceus, name,
                            lambda *a, fn=fn, name=name, **k: routed.append(name) or fn(*a, **k))
    grads = {}
    for use_kernels in (True, False):
        model = Caduceus(cfg, params).requires_grad_()
        model.layers[0].requires_grad_(False)
        routed.clear()
        caduceus.forward(model, ids, dtype=torch.float32,
                         use_kernels=use_kernels)["logits"].square().mean().backward()
        want = ["bimamba_mixer"] * 2 if not overrides else ["selective_scan"] * 4
        assert routed == (want if use_kernels else [])
        grads[use_kernels] = model.embedding.grad
    assert grads[True].abs().max() > 0
    np.testing.assert_allclose(grads[True].numpy(), grads[False].numpy(), rtol=1e-5, atol=1e-7)


# -- checkpoints and CLI ---------------------------------------------------------

CLI = ["--dataset", "synthetic", "--window", "32", "--batch-size", "8", "--dtype", "float32",
       "--log-steps", "1", "--eval-steps", "3", "--save-steps", "3", "--warmup-steps", "2",
       "--lr", "1e-2", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = tmp_path_factory.mktemp("pretrain")
    (d / "cfg.json").write_text(json.dumps(dict(d_model=16, n_layer=2, vocab_size=16,
                                                d_state=4)))
    pretrain.main(CLI + ["--config", str(d / "cfg.json"), "--max-steps", "6",
                         "--output-dir", str(d / "full")])
    return d


def _state_dict(path):
    return torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)


def test_cli_autoresume_is_exact(cli_run):
    """A run stopped after its step-3 checkpoint and resumed to step 6
    exports the same bits as the uninterrupted 6-step run."""
    from plantcaduceus_tpu_torch.cli import pretrain

    cfg = ["--config", str(cli_run / "cfg.json"), "--output-dir", str(cli_run / "resumed")]
    pretrain.main(CLI + cfg + ["--max-steps", "3"])
    pretrain.main(CLI + cfg + ["--max-steps", "6"])
    want, got = _state_dict(cli_run / "full" / "final"), _state_dict(cli_run / "resumed" / "final")
    assert want.keys() == got.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert sorted(p.name for p in (cli_run / "full").iterdir()) == \
        ["3", "6", "config.json", "final"]


def test_cli_final_export_scores_and_loads_in_jax(cli_run, tmp_path):
    """zero_shot_score on the exported final/ (CPU), and the JAX importer
    reading the same directory back as the trained parameters."""
    from plantcaduceus_tpu.compat.hf_import import import_params
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score
    from plantcaduceus_tpu_torch.compat.hf_import import import_model

    final = cli_run / "full" / "final"
    rng = np.random.default_rng(3)
    tsv, out = tmp_path / "snps.tsv", tmp_path / "scores.tsv"
    with open(tsv, "w") as fh:
        fh.write("chr\tpos\tref\talt\tsequences\n")
        for i in range(5):
            s = "".join(rng.choice(list("ACGT"), 32))
            fh.write(f"chr1\t{i}\t{s[15]}\t{'A' if s[15] != 'A' else 'C'}\t{s}\n")
    score(["-input-table", str(tsv), "-model", str(final), "-output", str(out),
           "-tokenIdx", "15", "-batchSize", "4", "-dtype", "float32", "-device", "cpu",
           "-no-progress"])
    rows = out.read_text().splitlines()[1:]
    assert len(rows) == 5 and all(np.isfinite(float(r.split("\t")[-1])) for r in rows)

    model, cfg = import_model(final)
    jparams, _ = import_params(final)
    _assert_params_match(model, jparams, rtol=0, atol=0)


# -- guards -----------------------------------------------------------------------


def test_cuda_absent_raises_in_trainer_and_cli(monkeypatch, tmp_path):
    from plantcaduceus_tpu_torch.cli import pretrain

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the card is the default without PCAD_PLATFORM (tests/conftest.py sets it
    # to cpu for the JAX CLIs; the port's CLIs honour it too)
    monkeypatch.delenv("PCAD_PLATFORM", raising=False)
    cfg = CaduceusConfig(**TINY)
    model = Caduceus(cfg, init_params(cfg))
    opt = make_optimizer(params=dict(model.named_parameters()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        step_lib.make_train_step(cfg, opt, model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain.main(["--dataset", "synthetic", "--preset", "l20",
                       "--output-dir", str(tmp_path / "never")])
    assert not (tmp_path / "never").exists()
    # --seq, --fsdp, --tensor and --pipe are taken (context parallelism,
    # FSDP, tensor and pipeline parallelism over torch.distributed ranks)
    for flag in ("--tensor", "--pipe"):
        args = pretrain.parse_args(["--dataset", "synthetic", "--output-dir", "x", flag, "2"])
        assert getattr(args, flag[2:]) == 2
    assert pretrain.parse_args(["--dataset", "synthetic", "--output-dir", "x",
                                "--seq", "2"]).seq == 2
    assert pretrain.parse_args(["--dataset", "synthetic", "--output-dir", "x",
                                "--fsdp", "2"]).fsdp == 2
    # --profile-dir and --eval-shards are taken, as in JAX
    args = pretrain.parse_args(["--dataset", "shards:d", "--output-dir", "x", "--eval-shards",
                                "1", "--profile-dir", str(tmp_path)])
    assert (args.profile_dir, args.eval_shards) == (str(tmp_path), 1)
    # --push-to-hub is taken, as in JAX: the export's push_to_hub raises offline
    assert pretrain.parse_args(["--dataset", "synthetic", "--output-dir", "x",
                                "--push-to-hub", "me/model"]).push_to_hub == "me/model"
