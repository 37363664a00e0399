"""The port's Mamba-2 (SSD) training path against the JAX package, on the CPU.

* Train step: 3 full steps of a tiny ``*-ssd``-shaped config (d_state 4,
  head_dim 8, n_groups 2, chunk 16; tests/test_torch_model2.py's) from the
  same weights (``from_jax_params``) and byte-identical batches, against
  JAX ``make_train_step`` on a one-device mesh with optax, remat on. The
  port's mixers take ``Mamba2InteriorFn`` (K5-res, K6 pre_silu; their plain
  versions on CPU tensors), JAX its XLA path under autodiff.
* Export: ``export_state_dict`` equal to JAX's key for key and bit for bit;
  the HF dir read back by both packages' ``hf_import``.
* CLI: pre-training with an exact autoresume, and the final export scored
  by the port's ``zero_shot_score``.

Float32 throughout; tolerances as tests/test_torch_train.py: losses 1e-5
relative, gradient norms 1e-4, parameters after Adam steps 1e-4 relative +
1e-5 absolute.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.compat import hf_export as jexport
from plantcaduceus_tpu.compat import hf_import as jimport
from plantcaduceus_tpu.models import caduceus as jax_caduceus
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu_torch.compat import hf_export, hf_import
from plantcaduceus_tpu_torch.compat.params import from_jax_params, to_jax_params
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train import data as data_lib
from plantcaduceus_tpu_torch.train import step as step_lib
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY2 = dict(d_model=16, n_layer=2, vocab_size=16, ssm_variant="mamba2", d_state=4,
             head_dim=8, n_groups=2, chunk_size=16)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {"tied_add": {}, "untied": dict(bidirectional_weight_tie=False)}


def _leaves(params):
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}


def _assert_params_match(got_params, jax_params, **tol):
    got, want = _leaves(got_params), _leaves(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _batches(n, rows=4, window=64, seed=3):
    seqs = data_lib.sequence_source("synthetic", window=window, synthetic_n=64, seed=seed)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), rows, seed=seed)
    return [ds.batch_at(s) for s in range(n)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_train_steps_match_jax(monkeypatch, name):
    from plantcaduceus_tpu.parallel import mesh as meshlib
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt
    from plantcaduceus_tpu_torch.models import caduceus

    jcfg = JaxConfig(**TINY2, **CONFIGS[name])
    params = jax_caduceus.init_params(jax.random.PRNGKey(2), jcfg)
    cfg = CaduceusConfig(**TINY2, **CONFIGS[name])
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

    routed = []
    fn = caduceus.mamba2_mixer_interior_train
    monkeypatch.setattr(caduceus, "mamba2_mixer_interior_train",
                        lambda *a, **k: routed.append(1) or fn(*a, **k))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=3,
                         params=dict(model.named_parameters()))
    init_p, step_p, eval_p = step_lib.make_train_step(cfg, opt, model, dtype=torch.float32,
                                                      remat=True, device="cpu")
    state, pm = init_p(), []
    for b in batches:
        state, m = step_p(state, b)
        pm.append({k: float(v) for k, v in m.items()})
    # forward and remat recompute: 2 directions x 2 layers x 2 per step
    assert len(routed) == 3 * 2 * cfg.n_layer * 2
    for s, (got, want) in enumerate(zip(pm, jm)):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5), s
        assert got["accuracy"] == pytest.approx(want["accuracy"], abs=1e-6), s
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4), s
    _assert_params_match(to_jax_params(model), jax.device_get(jstate.params), **PARAM_TOL)
    ev = eval_p(state, batches[0])
    assert np.isfinite(float(ev["loss"])) and 0 <= float(ev["accuracy"]) <= 1


@pytest.mark.parametrize("name", list(CONFIGS))
def test_export_state_dict_matches_jax(name):
    """The port's Mamba-2 export (mamba_ssm ``Mamba2`` packing) equals the
    JAX package's, key for key and bit for bit."""
    jcfg = JaxConfig(**TINY2, **CONFIGS[name])
    params = jax_caduceus.init_params(jax.random.PRNGKey(4), jcfg)
    want = jexport.export_state_dict(params, jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            CaduceusConfig(**TINY2, **CONFIGS[name]))
    got = hf_export.export_state_dict(to_jax_params(model), model.cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_hf_dir_reads_back_in_both_importers(tmp_path, name):
    """An HF dir written by the port: both packages' importers give the
    exported parameters and the SSD dims back. The JAX importer refuses an
    untied Mamba-2 dir, its own exports too (it expects one gated-norm
    weight per direction where its init keeps one), so the untied dir is
    read by the port's importer only."""
    cfg = CaduceusConfig(**TINY2, **CONFIGS[name])
    jcfg = JaxConfig(**TINY2, **CONFIGS[name])
    params = jax.tree.map(np.asarray,
                          jax_caduceus.init_params(jax.random.PRNGKey(5), jcfg))
    hf_export.export_hf_dir(tmp_path / "m", params, cfg)
    ssm = json.loads((tmp_path / "m" / "config.json").read_text())["ssm_cfg"]
    assert (ssm["layer"], ssm["headdim"], ssm["ngroups"], ssm["chunk_size"]) == \
        ("Mamba2", 8, 2, 16)
    for importer in (jimport, hf_import) if name == "tied_add" else (hf_import,):
        back, bcfg = importer.import_params(tmp_path / "m")
        assert bcfg.ssm_variant == "mamba2"
        assert (bcfg.head_dim, bcfg.n_groups, bcfg.chunk_size, bcfg.d_state) == (8, 2, 16, 4)
        _assert_params_match(back, params, rtol=0, atol=0)


CLI = ["--dataset", "synthetic", "--window", "32", "--batch-size", "8", "--dtype", "float32",
       "--log-steps", "1", "--eval-steps", "3", "--save-steps", "3", "--warmup-steps", "2",
       "--lr", "1e-2", "--device", "cpu"]


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    from plantcaduceus_tpu_torch.cli import pretrain

    d = tmp_path_factory.mktemp("pretrain2")
    (d / "cfg.json").write_text(json.dumps(TINY2))
    pretrain.main(CLI + ["--config", str(d / "cfg.json"), "--max-steps", "6",
                         "--output-dir", str(d / "full")])
    return d


def _state_dict(path):
    return torch.load(path / "pytorch_model.bin", map_location="cpu", weights_only=True)


def test_cli_autoresume_is_exact(cli_run):
    """A Mamba-2 run stopped after its step-3 checkpoint and resumed to step
    6 exports the same bits as the uninterrupted 6-step run."""
    from plantcaduceus_tpu_torch.cli import pretrain

    cfg = ["--config", str(cli_run / "cfg.json"), "--output-dir", str(cli_run / "resumed")]
    pretrain.main(CLI + cfg + ["--max-steps", "3"])
    pretrain.main(CLI + cfg + ["--max-steps", "6"])
    want, got = _state_dict(cli_run / "full" / "final"), _state_dict(cli_run / "resumed" / "final")
    assert want.keys() == got.keys()
    assert any(".in_proj.weight" in k for k in want) and any(".dt_bias" in k for k in want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_cli_final_export_scores(cli_run, tmp_path):
    """zero_shot_score (CPU) on the exported Mamba-2 final/; the JAX
    importer reads the same directory back as the trained parameters."""
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score

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
    model, _ = hf_import.import_model(final)
    jparams, _ = jimport.import_params(final)
    _assert_params_match(to_jax_params(model), jparams, rtol=0, atol=0)
