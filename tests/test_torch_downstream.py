"""The port's XGBoost workload (``downstream/*``, ``cli/predict_xgboost.py``,
``cli/train_xgboost.py``) against the JAX package's, on the CPU.

* ``XgbJsonPredictor`` on ``tests/test_xgb_json.py``'s hand-built documents:
  the same margins, probabilities and classes, bit for bit (one numpy
  code), and the same refusals.
* Every metric function against JAX's (sklearn/scipy underneath): scalars
  and every curve array (same length) within 1e-12, tied scores, one class
  absent (nan and a warning where sklearn gives them), and labels sklearn
  refuses (``ValueError`` in both).
* ``GbmClassifier``'s sklearn fit on the same data and seed: equal
  probabilities; each package loads the other's saved file.
* Both CLIs run on one tiny checkpoint (written by the port's
  ``export_hf_dir``) with both runners pinned to float32 (the CLIs hard-code
  bf16): ``predict_xgboost`` with a classifier whose every threshold lies
  midway between neighbouring embedding values (a 1e-6 gap cannot flip a
  split): equal labels, predictions within 1e-6, through compressed tables;
  ``train_xgboost`` fitting on JAX's cached embeddings: equal validation
  predictions, ``metrics.txt`` equal byte for byte, each package's
  ``-test_only`` on the other's model, ``-save_memory`` equal to the plain
  run, and a rerun served from the caches.
"""

import gzip
import json
import shutil
import warnings
import zipfile

import numpy as np
import pytest
import torch

from tests.test_torch_eval import fp32  # noqa: F401  (pins both runners to float32)
from tests.test_torch_tables import tiny_ckpt  # noqa: F401
from tests.test_xgb_json import TREE_A, TREE_B, _learner, _tree
from tests.torch_threads import one_torch_thread  # noqa: F401

WINDOW, IDX = 48, 23
PRED_TOL = 1e-6
EMB_TOL = 1e-5


# ---------------------------------------------------------------------------
# XgbJsonPredictor
# ---------------------------------------------------------------------------

X3 = np.array([[0.0, 1.0, 0.0], [0.0, 3.0, 2.0], [1.0, 0.0, 0.0], [np.nan, 3.0, 0.0],
               [0.0, np.nan, 5.0], [np.nan, np.nan, np.nan], [0.5, 2.0, 1.0]])
DOCS = {
    "binary": _learner([TREE_A, TREE_B], [0, 0]),
    "base_score": _learner([TREE_B], [0], base_score="0.2"),
    "multiclass": _learner([TREE_B, TREE_B, TREE_A], [0, 1, 2], objective="multi:softprob",
                           base_score="0.5", num_class="3"),
    "regression": _learner([TREE_B], [0], objective="reg:squarederror", base_score="1.5"),
    "count": _learner([TREE_A], [0], objective="count:poisson", base_score="0.7"),
}


@pytest.mark.parametrize("name", list(DOCS))
def test_xgb_json_matches_jax(name, tmp_path):
    from plantcaduceus_tpu.downstream.xgb_json import XgbJsonPredictor as J
    from plantcaduceus_tpu_torch.downstream.xgb_json import XgbJsonPredictor as T

    path = tmp_path / "m.json"
    path.write_text(json.dumps(DOCS[name]))
    j, t = J.load(path), T.load(path)
    np.testing.assert_array_equal(t.margin(X3), j.margin(X3))
    np.testing.assert_array_equal(t.predict(X3), j.predict(X3))
    if name in ("regression", "count"):
        with pytest.raises(NotImplementedError):
            t.predict_proba(X3)
    else:
        np.testing.assert_array_equal(t.predict_proba(X3), j.predict_proba(X3))


def _broken(kind):
    doc = _learner([TREE_A, TREE_B], [0, 0])
    if kind == "gblinear":
        doc["learner"]["gradient_booster"]["name"] = "gblinear"
    elif kind == "categorical":
        doc["learner"]["gradient_booster"]["model"]["trees"][1] = dict(
            TREE_B, split_type=[1, 0, 0], categories=[1])
    elif kind == "tree_info":
        doc["learner"]["gradient_booster"]["model"]["tree_info"] = [0]
    return json.dumps(doc).encode()


@pytest.mark.parametrize("kind, raw, err", [
    ("gblinear", None, NotImplementedError), ("categorical", None, NotImplementedError),
    ("tree_info", None, ValueError), ("not_model", b'{"hello": 1}', ValueError),
    ("ubjson", b"\x00\x01binary", ValueError)])
def test_xgb_json_refusals_match_jax(kind, raw, err, tmp_path):
    from plantcaduceus_tpu.downstream.xgb_json import XgbJsonPredictor as J
    from plantcaduceus_tpu_torch.downstream.xgb_json import XgbJsonPredictor as T

    path = tmp_path / "m.json"
    path.write_bytes(raw or _broken(kind))
    messages = []
    for cls in (J, T):
        with pytest.raises(err) as exc:
            cls.load(path)
        messages.append(str(exc.value).replace(str(path), ""))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _metric_cases():
    rng = np.random.default_rng(3)
    n = 30
    return {
        "random": rng.integers(0, 2, n),
        "ties": rng.integers(0, 2, n),
        "no_positives": np.zeros(n, int),
        "no_negatives": np.ones(n, int),
        "multiclass": rng.integers(0, 3, n),
    }, {
        "random": rng.standard_normal((n, 2)),
        "ties": np.round(rng.standard_normal((n, 2)) * 2) / 2,   # tied scores
    }


def _outcome(fn, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            return fn(*args)
        except ValueError:
            return ValueError


def _assert_same(got, want):
    if want is ValueError:
        assert got is ValueError
        return
    assert isinstance(got, dict) and set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k], np.float64), np.asarray(want[k], np.float64)
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12, equal_nan=True, err_msg=k)


@pytest.mark.parametrize("case", list(_metric_cases()[0]))
def test_metrics_match_jax(case):
    from plantcaduceus_tpu.downstream import metrics as J
    from plantcaduceus_tpu_torch.downstream import metrics as T

    labels_by_case, logits_by_case = _metric_cases()
    y = labels_by_case[case]
    logits = logits_by_case.get(case, logits_by_case["ties"])
    scores = J.softmax(logits, axis=1)[:, 1]
    multi_y = np.stack([y, np.roll(y, 1), np.roll(y, 2)], axis=1)
    multi_logits = np.concatenate([logits, logits[:, :1] - 0.5], axis=1)
    for name, args in (("classification_metrics", (logits, y)),
                       ("multilabel_metrics", (multi_logits, multi_y)),
                       ("regression_metrics", (scores.astype(np.float32), y)),
                       ("binary_curve_metrics", (scores, y))):
        _assert_same(_outcome(getattr(T, name), *args), _outcome(getattr(J, name), *args))


def test_metric_warnings_and_ranks():
    from scipy.stats import rankdata

    from plantcaduceus_tpu_torch.downstream import metrics as T

    with pytest.warns(T.UndefinedMetricWarning):
        assert np.isnan(T.roc_auc_score(np.zeros(4, int), np.arange(4.0)))
    with pytest.warns(T.ConstantInputWarning):
        assert np.isnan(T.spearman_r(np.ones(4), np.arange(4.0)))
    a = np.array([3.0, 1.0, 3.0, 2.0, 1.0, 3.0, 0.5])
    np.testing.assert_array_equal(T.rank_average(a), rankdata(a))


# ---------------------------------------------------------------------------
# GbmClassifier
# ---------------------------------------------------------------------------


def test_gbm_sklearn_fit_matches_jax_and_files_cross(tmp_path):
    from plantcaduceus_tpu.downstream.gbm import GbmClassifier as J
    from plantcaduceus_tpu_torch.downstream.gbm import HAVE_XGBOOST, GbmClassifier as T

    rng = np.random.default_rng(0)
    X = rng.standard_normal((80, 8)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 3] + 0.3 * rng.standard_normal(80) > 0).astype(int)
    j = J(n_estimators=40, random_state=3, backend="sklearn").fit(X, y)
    t = T(n_estimators=40, random_state=3, backend="sklearn").fit(X, y)
    np.testing.assert_array_equal(t.predict_proba(X), j.predict_proba(X))
    j.save(tmp_path / "j.json")
    t.save(tmp_path / "t.json")
    for cls, other, want in ((T, "j.json", j), (J, "t.json", t)):
        loaded = cls.load(tmp_path / other)
        assert loaded.backend == "sklearn"
        np.testing.assert_array_equal(loaded.predict_proba(X), want.predict_proba(X))

    if not HAVE_XGBOOST:  # a JSON artifact: the numpy evaluator, inference only
        path = tmp_path / "model.json"
        path.write_text(json.dumps(DOCS["binary"]))
        clf = T.load(path)
        assert clf.backend == "xgb_json"
        np.testing.assert_array_equal(clf.predict_proba(X3), J.load(path).predict_proba(X3))
        with pytest.raises(RuntimeError, match="inference-only"):
            clf.fit(X3, np.zeros(len(X3)))
        with pytest.raises(RuntimeError, match="read-only"):
            clf.save(tmp_path / "out.json")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def _write_tsv(path, seqs, labels=None):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as fh:
        fh.write("sequences" + ("\tlabel" if labels is not None else "") + "\n")
        for i, s in enumerate(seqs):
            fh.write(s + (f"\t{labels[i]}" if labels is not None else "") + "\n")


def _seqs(rng, n):
    return ["".join(rng.choice(list("ACGT"), WINDOW)) for _ in range(n)]


def _port_embeddings(ckpt, seqs):
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    model, cfg, tok = load_model_and_tokenizer(ckpt)
    runner = InferenceRunner(model, cfg, dtype=torch.float32, batch_size=8, device="cpu")
    return runner.center_embeddings(tok.encode_batch(seqs), IDX, progress=False)


def _classifier(emb):
    """binary:logistic over ``emb``'s width, depth-2 trees; every threshold
    midway across the widest gap between neighbouring values in the middle
    half of its feature's sorted values."""
    def threshold(f):
        v = np.unique(emb[:, f].astype(np.float64))
        lo, hi = len(v) // 4, 3 * len(v) // 4
        k = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
        return float((v[k] + v[k + 1]) / 2)

    d = emb.shape[1]
    trees = []
    for t, (fa, fb, fc) in enumerate([(0, 3, 5), (d - 1, 2, 1), (4, 6, 7)]):
        trees.append(_tree(left=[1, 3, 5, -1, -1, -1, -1], right=[2, 4, 6, -1, -1, -1, -1],
                           feat=[fa, fb, fc, 0, 0, 0, 0],
                           cond=[threshold(fa), threshold(fb), threshold(fc),
                                 -0.6 + 0.1 * t, 0.3, -0.2, 0.7 - 0.2 * t],
                           default_left=[1, 0, 1, 0, 0, 0, 0]))
    return _learner(trees, [0, 0, 0], num_feature=str(d))


def test_predict_xgboost_matches_jax(fp32, tiny_ckpt, tmp_path):
    from plantcaduceus_tpu.cli.predict_xgboost import main as jax_main
    from plantcaduceus_tpu_torch.cli.predict_xgboost import main as torch_main

    rng = np.random.default_rng(8)
    seqs = _seqs(rng, 20)
    clf = tmp_path / "clf.json"
    clf.write_text(json.dumps(_classifier(_port_embeddings(tiny_ckpt, seqs))))
    inputs = {"labelled.tsv.gz": [int(v) for v in rng.integers(0, 2, 20)],
              "unlabelled.tsv": None}
    for name, labels in inputs.items():
        _write_tsv(tmp_path / name, seqs, labels)
        outs = {}
        for pkg, fn, extra in (("jax", jax_main, []), ("torch", torch_main, ["-device", "cpu"])):
            (tmp_path / pkg).mkdir(exist_ok=True)
            outs[pkg] = tmp_path / pkg / "pred.tsv.zip"
            fn(["-input", str(tmp_path / name), "-model", tiny_ckpt, "-classifier", str(clf),
                "-output", str(outs[pkg]), "-batchSize", "8", "-tokenIdx", str(IDX),
                "-no-progress", *extra])
        got = {}
        for pkg, path in outs.items():
            with zipfile.ZipFile(path) as zf:
                assert zf.namelist() == ["pred.tsv"]
                got[pkg] = [ln.split("\t") for ln in zf.read("pred.tsv").decode().splitlines()]
        assert got["torch"][0] == got["jax"][0] == ["label", "prediction"]
        assert [r[0] for r in got["torch"]] == [r[0] for r in got["jax"]]
        assert [r[0] for r in got["torch"][1:]] == [str(v) for v in labels or [0] * 20]
        p_t = np.array([float(r[1]) for r in got["torch"][1:]])
        p_j = np.array([float(r[1]) for r in got["jax"][1:]])
        np.testing.assert_allclose(p_t, p_j, rtol=0, atol=PRED_TOL)
        assert len(np.unique(p_t)) > 2  # the trees split the windows
        assert [r[1] for r in got["torch"][1:]] == [repr(float(v)) for v in p_t]


def test_train_xgboost_matches_jax(fp32, tiny_ckpt, tmp_path):
    from plantcaduceus_tpu.cli.train_xgboost import main as jax_main
    from plantcaduceus_tpu_torch.cli.train_xgboost import main as torch_main

    rng = np.random.default_rng(9)
    for name, n in (("train", 48), ("valid", 20), ("test", 17)):
        _write_tsv(tmp_path / f"{name}.tsv", _seqs(rng, n), [int(v) for v in rng.integers(0, 2, n)])
    d = {k: tmp_path / k for k in ("jax", "torch", "jax_only", "torch_only")}
    common = ["-model", tiny_ckpt, "-batchSize", "8", "-tokenIdx", str(IDX), "-no-progress"]
    fit = ["-train", str(tmp_path / "train.tsv"), "-valid", str(tmp_path / "valid.tsv"),
           "-test", str(tmp_path / "test.tsv")]
    only = ["-test", str(tmp_path / "test.tsv"), "-test_only"]

    def run(pkg, out, flags):
        main, extra = (jax_main, []) if pkg.startswith("jax") else (torch_main, ["-device", "cpu"])
        main([*flags, "-output", str(out), *common, *extra])

    def preds(out, prefix):
        return np.load(out / f"seed_42_{prefix}_predictions.npz")["predictions"]

    run("jax", d["jax"], fit)
    d["torch"].mkdir()
    shutil.copy(d["jax"] / "train_valid_embeddings.npz", d["torch"])
    run("torch", d["torch"], fit)
    np.testing.assert_array_equal(preds(d["torch"], "valid"), preds(d["jax"], "valid"))
    for prefix in ("valid", "test"):
        txt = f"seed_42_{prefix}_metrics.txt"
        assert (d["torch"] / txt).read_bytes() == (d["jax"] / txt).read_bytes()
        assert (d["torch"] / f"seed_42_{prefix}_metrics.png").is_file()
    np.testing.assert_allclose(np.load(d["torch"] / "test_embeddings.npz")["test"],
                               np.load(d["jax"] / "test_embeddings.npz")["test"],
                               rtol=0, atol=EMB_TOL)
    np.testing.assert_allclose(preds(d["torch"], "test"), preds(d["jax"], "test"),
                               rtol=0, atol=PRED_TOL)

    # each package's -test_only on the other's model; the port's in 7-row chunks
    for pkg, src in (("torch_only", "jax"), ("jax_only", "torch")):
        d[pkg].mkdir()
        shutil.copy(d[src] / "seed_42_XGBoost.json", d[pkg])
        run(pkg, d[pkg], only + (["-save_memory", "-chunk_size", "7"]
                                 if pkg == "torch_only" else []))
        np.testing.assert_allclose(preds(d[pkg], "test"), preds(d[src], "test"),
                                   rtol=0, atol=PRED_TOL)
    assert sorted(p.name for p in d["torch_only"].glob("test_chunk_*")) == [
        f"test_chunk_{i}_embeddings.npz" for i in (0, 14, 7)]
    np.testing.assert_array_equal(preds(d["torch_only"], "test"), preds(d["torch"], "test"))

    # a rerun is served from the caches and the saved model: the same bits
    before = preds(d["torch"], "test")
    (d["torch"] / "seed_42_test_predictions.npz").unlink()
    run("torch", d["torch"], fit)
    np.testing.assert_array_equal(preds(d["torch"], "test"), before)


def test_train_xgboost_refuses_non_integer_labels(tmp_path):
    from plantcaduceus_tpu_torch.cli.train_xgboost import load_data

    path = tmp_path / "t.tsv.gz"
    _write_tsv(path, ["ACGT", "ACGA", "ACGG"], [1, " 0", -2])
    assert load_data(path) == (["ACGT", "ACGA", "ACGG"], [1, 0, -2])
    for bad in ("1.0", "pos", ""):
        _write_tsv(path, ["ACGT", "ACGA"], [0, bad])
        with pytest.raises(ValueError, match="not an integer"):
            load_data(path)


@pytest.mark.parametrize("cli", ["predict_xgboost", "train_xgboost", "serve"])
def test_new_entry_points_refuse_missing_cuda(monkeypatch, tiny_ckpt, tmp_path, cli):
    import importlib

    main = importlib.import_module(f"plantcaduceus_tpu_torch.cli.{cli}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("PCAD_PLATFORM", raising=False)   # the card is the default without it
    args = {"predict_xgboost": ["-input", "x.tsv", "-classifier", "c.json", "-output", "o"],
            "train_xgboost": ["-test", "x.tsv", "-test_only", "-output", str(tmp_path)],
            "serve": ["-port", "0"]}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-model", tiny_ckpt, *args])
