"""The port's PlantCAD2 zero-shot evaluation (``engine/eval_tasks.py``,
``cli/zero_shot_eval.py``) against the JAX package's, on the CPU.

* The numpy ROC AUC and average precision against ``sklearn.metrics``
  within 1e-12: random scores, heavy ties, and one class left out (nan ROC
  AUC, average precision 0 or 1, as sklearn gives).
* The four subcommands of both CLIs on the same seeded TSVs (written with
  pandas, as the JAX CLI's tests do) and the same tiny checkpoint exported
  from JAX. Both runners are pinned to float32 (the CLIs compute in bf16):
  probabilities, scores and metrics agree within 1e-5 (forwards that agree
  to ~1e-6). One bf16 run per package, unpinned: probabilities within 2**-6
  (both round each product to 8 mantissa bits, in different places).
* The ``--save-logits`` / ``--logits-path`` round trip within each package
  and across them: the same metrics, exactly, from the same file.
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
from tests.torch_threads import one_torch_thread  # noqa: F401

L, CENTER, N_ROWS = 64, 32, 16
MOTIF = f"{CENTER - 1},{CENTER},{CENTER + 1}"
F32_TOL = 1e-5
BF16_TOL = 2 ** -6


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _metric_cases():
    rng = np.random.default_rng(5)
    cases = {"random": (rng.integers(0, 2, 40), rng.random(40)),
             "ties": (rng.integers(0, 2, 60), rng.integers(0, 4, 60) / 3),
             "all_tied": (np.array([0, 1, 1, 0, 1]), np.full(5, 0.5)),
             "no_negatives": (np.ones(7, int), rng.random(7)),
             "no_positives": (np.zeros(7, int), rng.integers(0, 3, 7) / 2)}
    return cases


@pytest.mark.parametrize("case", list(_metric_cases()))
def test_metrics_match_sklearn(case):
    from sklearn.metrics import auc, average_precision_score, roc_curve

    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    y, s = _metric_cases()[case]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn warns on a missing class
        fpr, tpr, _ = roc_curve(y, s)
        want = {"auroc": auc(fpr, tpr), "auprc": average_precision_score(y, s)}
    got = T.auroc_auprc(y, s)
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_scoring_functions_are_the_jax_ones():
    """The copied task functions give the JAX package's values."""
    from plantcaduceus_tpu.engine import eval_tasks as JT
    from plantcaduceus_tpu_torch.engine import eval_tasks as T

    rng = np.random.default_rng(2)
    seqs = ["".join(rng.choice(list("ACGTN"), 12)) for _ in range(9)]
    probs = rng.dirichlet(np.ones(4), 9 * 3)
    toks = T.true_tokens_from_seq(seqs, [3, 4, 5])
    np.testing.assert_array_equal(toks, JT.true_tokens_from_seq(seqs, [3, 4, 5]))
    np.testing.assert_array_equal(T.refprob_scores(seqs, probs[:9], 4),
                                  JT.refprob_scores(seqs, probs[:9], 4))
    assert T.token_accuracy(probs, toks) == JT.token_accuracy(probs, toks)
    assert T.motif_accuracy(probs, toks, 3) == JT.motif_accuracy(probs, toks, 3)
    np.testing.assert_array_equal(T.avg_trueprob_scores(probs, toks, 3),
                                  JT.avg_trueprob_scores(probs, toks, 3))
    rows = [{"left": 10, "right": 20, "MutSeq": s * 3} for s in seqs]
    ref, mut = rng.dirichlet(np.ones(4), (9, 36)), rng.dirichlet(np.ones(4), (9, 36))
    np.testing.assert_array_equal(T.sv_llr_boundary(rows, ref, mut, 3),
                                  JT.sv_llr_boundary(rows, ref, mut, 3))


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import jax

    from plantcaduceus_tpu.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4)
    d = tmp_path_factory.mktemp("ckpt") / "tiny"
    export_hf_dir(d, caduceus.init_params(jax.random.PRNGKey(0), cfg), cfg)
    return str(d)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    rng = np.random.default_rng(7)
    d = tmp_path_factory.mktemp("frames")

    def seqs():
        return ["".join(rng.choice(list("ACGT"), L)) for _ in range(N_ROWS)]

    labels = np.array([0, 1] * (N_ROWS // 2))
    motif = seqs()
    motif[3] = motif[3][:CENTER] + "N" + motif[3][CENTER + 1:]  # an invalid motif row
    tables = {
        "evo": pd.DataFrame({"sequence": seqs(), "label": labels}),
        "motif": pd.DataFrame({"sequence": motif, "label": labels}),
        "core": pd.DataFrame({"sequence": seqs(), "is_core": labels}),
        "sv": pd.DataFrame({"RefSeq": seqs(), "MutSeq": seqs(),
                            "left": rng.integers(10, 20, N_ROWS),
                            "right": rng.integers(44, 54, N_ROWS), "label": labels,
                            "Left5_Positions": ["x"] * N_ROWS,
                            "Right5_Positions": ["y"] * N_ROWS}),
    }
    paths = {}
    for k, df in tables.items():
        paths[k] = d / f"{k}.tsv"
        df.to_csv(paths[k], sep="\t", index=False)
    return paths


@pytest.fixture
def fp32(monkeypatch):
    """Pin both packages' runners to float32 for the duration of a test."""
    import jax.numpy as jnp
    import torch

    import plantcaduceus_tpu.engine.runner as jr
    import plantcaduceus_tpu_torch.engine.runner as tr

    def pinned(base, dtype):
        class Runner(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **dict(kw, dtype=dtype))
        return Runner

    monkeypatch.setattr(jr, "InferenceRunner", pinned(jr.InferenceRunner, jnp.float32))
    monkeypatch.setattr(tr, "InferenceRunner", pinned(tr.InferenceRunner, torch.float32))


SUBCOMMANDS = {
    "evo_cons": ("evo", ["--token-idx", str(CENTER)]),
    "motif_acc": ("motif", ["--mask-idx", MOTIF, "--motif-len", "3"]),
    "core_noncore": ("core", ["--mask-idx", MOTIF, "--motif-len", "3",
                              "--label-column", "is_core"]),
    "sv_effect": ("sv", ["--flanking", "3"]),
}


def _run(pkg, cmd, frames, ckpt, tmp_path, extra=()):
    """One CLI run of ``pkg`` ("jax" or "torch"); returns its metrics JSON."""
    if pkg == "jax":
        from plantcaduceus_tpu.cli.zero_shot_eval import main
    else:
        from plantcaduceus_tpu_torch.cli.zero_shot_eval import main
        extra = [*extra, "--device", "cpu"]
    frame, flags = SUBCOMMANDS[cmd]
    mj = tmp_path / f"{pkg}_{cmd}.json"
    main([cmd, "--repo-id", str(frames[frame]), "--model", ckpt, "--batch-size", "8",
          "--metrics-json", str(mj), "--no-progress", *flags, *extra])
    return json.loads(mj.read_text())


def _assert_metrics_close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("cmd", ["evo_cons", "motif_acc", "core_noncore"])
def test_masked_subcommands_match_jax(fp32, tiny_ckpt, frames, tmp_path, cmd):
    outs = {}
    for pkg in ("jax", "torch"):
        logits = tmp_path / f"{pkg}_logits.tsv"
        outs[pkg] = (_run(pkg, cmd, frames, tiny_ckpt, tmp_path,
                          ["--save-logits", str(logits)]), pd.read_csv(logits, sep="\t"))
    (jm, jl), (tm, tl) = outs["jax"], outs["torch"]
    _assert_metrics_close(tm, jm, F32_TOL)
    assert list(tl.columns) == list(jl.columns) == list("ACGT")
    assert tl.shape == jl.shape == (N_ROWS * (1 if cmd == "evo_cons" else 3), 4)
    np.testing.assert_allclose(tl.values, jl.values, atol=F32_TOL, rtol=0)
    if cmd == "evo_cons":
        assert tm["token_idx"] == CENTER


def test_sv_effect_matches_jax(fp32, tiny_ckpt, frames, tmp_path):
    tables = {}
    for pkg in ("jax", "torch"):
        out = tmp_path / f"{pkg}_sv.tsv"
        m = _run(pkg, "sv_effect", frames, tiny_ckpt, tmp_path, ["--output", str(out)])
        tables[pkg] = (m, out.read_text().splitlines())
    (jm, jt), (tm, tt) = tables["jax"], tables["torch"]
    _assert_metrics_close(tm, jm, F32_TOL)
    assert tt[0] == jt[0] == "RefSeq\tMutSeq\tleft\tright\tlabel\tscore"
    assert len(tt) == len(jt) == N_ROWS + 1
    for a, b in zip(tt[1:], jt[1:]):
        a, b = a.split("\t"), b.split("\t")
        assert a[:-1] == b[:-1]
        assert abs(float(a[-1]) - float(b[-1])) <= F32_TOL


@pytest.mark.parametrize("cmd", ["evo_cons", "sv_effect"])
def test_parquet_tables_match_tsv_and_jax(fp32, tiny_ckpt, frames, tmp_path, cmd):
    """The table as parquet (pandas' default snappy, as the PlantCAD2 tables
    come) gives the TSV's metrics exactly through the port, and JAX's
    metrics on the same parquet file."""
    frame = SUBCOMMANDS[cmd][0]
    pq_frames = dict(frames)
    pq_frames[frame] = tmp_path / f"{frame}.parquet"
    pd.read_csv(frames[frame], sep="\t").to_parquet(pq_frames[frame])
    from_tsv = _run("torch", cmd, frames, tiny_ckpt, tmp_path)
    from_pq = _run("torch", cmd, pq_frames, tiny_ckpt, tmp_path)
    assert from_pq == from_tsv
    _assert_metrics_close(from_pq, _run("jax", cmd, pq_frames, tiny_ckpt, tmp_path), F32_TOL)


def test_logits_round_trip_within_and_across(tiny_ckpt, frames, tmp_path):
    """Each package's cached logits replayed by itself and by the other
    package (no model: the spec names none) give the same metrics exactly."""
    cached, direct = {}, {}
    for pkg in ("jax", "torch"):
        cached[pkg] = tmp_path / f"{pkg}.tsv"
        direct[pkg] = _run(pkg, "evo_cons", frames, tiny_ckpt, tmp_path,
                           ["--save-logits", str(cached[pkg])])
    for src in ("jax", "torch"):
        for pkg in ("jax", "torch"):
            replay = _run(pkg, "evo_cons", frames, "no-such-model", tmp_path,
                          ["--logits-path", str(cached[src])])
            assert replay == direct[src], (src, pkg)


def test_bf16_probabilities_within_bound(tiny_ckpt, frames, tmp_path):
    probs = {}
    for pkg in ("jax", "torch"):
        logits = tmp_path / f"{pkg}.tsv"
        _run(pkg, "motif_acc", frames, tiny_ckpt, tmp_path, ["--save-logits", str(logits)])
        probs[pkg] = pd.read_csv(logits, sep="\t").values
    assert np.abs(probs["torch"] - probs["jax"]).max() <= BF16_TOL


def test_row_mismatch_asserts(tiny_ckpt, frames, tmp_path):
    from plantcaduceus_tpu_torch.cli.zero_shot_eval import main

    bad = tmp_path / "bad.tsv"
    pd.DataFrame(np.full((5, 4), 0.25), columns=list("ACGT")).to_csv(bad, sep="\t",
                                                                      index=False)
    with pytest.raises(AssertionError, match="Row mismatch"):
        main(["evo_cons", "--repo-id", str(frames["evo"]), "--model", tiny_ckpt,
              "--logits-path", str(bad), "--no-progress", "--device", "cpu"])


@pytest.mark.parametrize("route", ["zstd", "hub", "seq"])
def test_refused_routes(tiny_ckpt, frames, tmp_path, route, capsys):
    """A hub dataset id and ``--seq > 1`` are refused. A zstd parquet table
    is no longer refused (the port carries a zstd decoder): its metrics
    equal the TSV's."""
    import pandas as pd

    from plantcaduceus_tpu_torch.cli.zero_shot_eval import main

    if route == "zstd":
        pd.read_csv(frames["evo"], sep="\t").to_parquet(tmp_path / "x.parquet",
                                                        compression="zstd")
        metrics = {}
        for name, table in (("zstd", tmp_path / "x.parquet"), ("tsv", frames["evo"])):
            metrics[name] = tmp_path / f"{name}.json"
            main(["evo_cons", "--repo-id", str(table), "--model", tiny_ckpt, "--device", "cpu",
                  "--token-idx", str(CENTER), "--no-progress", "--metrics-json",
                  str(metrics[name])])
        assert json.loads(metrics["zstd"].read_text()) == json.loads(metrics["tsv"].read_text())
        return
    repo = {"hub": "kuleshov-group/cross-species", "seq": str(frames["evo"])}[route]
    with pytest.raises(SystemExit) as exc:
        main(["evo_cons", "--repo-id", repo, "--model", tiny_ckpt, "--device", "cpu",
              *(["--seq", "2"] if route == "seq" else [])])
    text = str(exc.value) + capsys.readouterr().err
    assert {"hub": "local TSV", "seq": "--seq"}[route] in text


def test_load_tokenizer_only(tiny_ckpt):
    from plantcaduceus_tpu.utils.model_loading import load_tokenizer_only as jload
    from plantcaduceus_tpu_torch.utils.model_loading import load_tokenizer_only

    for spec in (tiny_ckpt, "pc2-small"):
        got, want = load_tokenizer_only(spec), jload(spec)
        assert got.get_vocab() == want.get_vocab()
        assert got.mask_token_id == want.mask_token_id


def test_new_modules_import_nothing_the_gpu_hosts_lack():
    """The AR LM, evaluation, XGBoost, serving, input-tool, fine-tuning,
    streaming, profiling, distillation, convergence and GPN modules, the
    table opener, the parquet reader, the mesh and its collectives, the
    sequence-sharded scans, the runner, the zero-shot engine, the train step
    and the scoring CLI import neither jax nor the JAX
    package, nor sklearn, pandas, pyarrow, zstandard, xgboost, matplotlib,
    datasets, optax, orbax, peft, safetensors, huggingface_hub or scipy.stats
    (absent or unused on the GPU hosts), in a fresh interpreter."""
    code = """
import importlib, sys
for m in ("models.mamba_lm", "cli.ar_lm", "engine.eval_tasks", "cli.zero_shot_eval",
          "compat.params", "utils.model_loading", "io.tables", "downstream.xgb_json",
          "downstream.metrics", "downstream.gbm", "cli.predict_xgboost",
          "cli.train_xgboost", "engine.server", "engine.client", "cli.serve",
          "pipelines.mutagenesis", "cli.mutagenesis", "cli.format_vcf",
          "models.heads", "models.caduceus", "train.lora", "compat.peft_adapter",
          "cli.lora_fine_tune", "cli.finetune_suite", "compat.model_card", "cli.pretrain",
          "io.parquet", "train.data", "train.streaming", "utils.profiling", "train.loop",
          "train.distill", "cli.distill", "train.convergence", "models.gpn",
          "io.safetensors", "io.zstd", "compat.hf_import", "parallel.mesh",
          "parallel.collectives", "ops.seq_parallel", "ops.ssd_seq_parallel", "ops.conv",
          "engine.runner", "engine.zero_shot", "train.step", "cli.zero_shot_score"):
    importlib.import_module("plantcaduceus_tpu_torch." + m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "plantcaduceus_tpu", "sklearn", "pandas",
                                    "pyarrow", "zstandard", "xgboost", "matplotlib",
                                    "datasets", "optax", "orbax", "peft", "safetensors",
                                    "huggingface_hub")
             or m.startswith("scipy.stats"))
assert not bad, bad
print("clean")
"""
    repo = Path(__file__).resolve().parents[1]
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH")
           if k in os.environ}
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True,
                         timeout=120, env=dict(env, PYTHONPATH=str(repo)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("clean")
