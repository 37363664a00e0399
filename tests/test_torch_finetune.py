"""The port's fine-tuning workload (PEFT adapter dirs, ``cli/lora_fine_tune.py``,
``cli/finetune_suite.py``, the model card) against the JAX package's, on the
CPU.

* PEFT import and export against JAX's on ``tests/test_peft_adapter.py``'s
  hand-built dirs, in ``adapter_model.safetensors`` and, with safetensors
  hidden, ``adapter_model.bin``: the same adapter tree, head, config and
  task, the same tensors written (the port always as
  ``adapter_model.safetensors``), and the same strict refusals.
* ``evaluate`` and ``predict`` of the port on a PEFT dir the JAX package
  exported, equal to the JAX CLI's within 1e-5 (both in float32 with
  ``--no-bf16``), and the JAX CLI's ``predict`` on the port's export equal
  to the port's.
* ``tokenize`` to ``.npz`` and ``.parquet`` (from a ``.tsv.gz`` too) equal
  to the JAX CLI's parquet ids and labels, for a classification and a
  multi-label table; ``display``'s inventory in JAX's layout.
* The CLI's resume: a run resumed from ``checkpoint-2`` (dropout 0.1,
  ``--grad-accum 2``) equals the uninterrupted run bit for bit, LoRA and
  full fine-tuning; mismatched resumes are refused.
* The suite on two tiny jobs (LoRA classification, full fine-tune
  regression) and its re-aggregation.
* The model card: JAX's text with the lines that name the framework mapped;
  ``push_to_hub``'s offline error; the port's ``pretrain`` writing the card.

Both packages read one tiny checkpoint written by the port's
``export_hf_dir``.
"""

import csv
import gzip
import json
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from plantcaduceus_tpu.compat import peft_adapter as jpeft
from plantcaduceus_tpu_torch.compat import peft_adapter as tpeft
from tests.test_peft_adapter import CFG, RANK, _synthetic_sd
from tests.torch_threads import one_torch_thread  # noqa: F401

L = 32
PRED_TOL = 1e-5
TINY = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for the JAX CLIs' tiny programs."""
    import jax

    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _cfgs():
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    return CFG, CaduceusConfig(**TINY)


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory):
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.models.caduceus import init_params

    _, cfg = _cfgs()
    d = tmp_path_factory.mktemp("base") / "tiny"
    export_hf_dir(d, init_params(cfg, seed=0), cfg)
    return d


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 16-row classification table, tokenized by the JAX CLI to parquet."""
    from plantcaduceus_tpu.cli.lora_fine_tune import main as jmain

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(16)]
    pd.DataFrame({"sequence": seqs, "label": rng.integers(0, 2, 16)}).to_csv(
        d / "cls.tsv", sep="\t", index=False)
    jmain(["tokenize", "--data-dir", str(d / "cls.tsv"), "--output-path",
           str(d / "cls.parquet"), "--sequence-length", str(L)])
    return d


def _write_dir(path, sd, fmt, meta=None):
    """A PEFT dir with ``sd`` as ``adapter_model`` + ``fmt``."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "adapter_config.json").write_text(json.dumps(meta or {
        "peft_type": "LORA", "task_type": "SEQ_CLS", "r": RANK, "lora_alpha": 16.0,
        "lora_dropout": 0.05, "target_modules": ["in_proj", "x_proj", "out_proj"],
        "base_model_name_or_path": "kuleshov-group/PlantCaduceus_l20"}))
    if fmt == ".safetensors":
        from safetensors.numpy import save_file

        save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
                  str(path / "adapter_model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                    for k, v in sd.items()}, str(path / "adapter_model.bin"))
    return path


@pytest.fixture(params=[".safetensors", ".bin"])
def fmt(request, monkeypatch):
    """The tensor file format; for ``.bin`` safetensors is hidden from both
    packages, as on a host without it."""
    if request.param == ".bin":
        monkeypatch.setitem(sys.modules, "safetensors", None)
        monkeypatch.setitem(sys.modules, "safetensors.numpy", None)
    return request.param


def _assert_imports_equal(got, want):
    (ga, gh, gc, gt, gb), (wa, wh, wc, wt, wb) = got, want
    assert (tuple(gc), gt, gb) == (tuple(wc), wt, wb)
    assert sorted(ga) == sorted(wa)
    for n in wa:
        for k in ("a", "b"):
            assert ga[n][k].dtype == wa[n][k].dtype
            np.testing.assert_array_equal(ga[n][k], wa[n][k], err_msg=f"{n}.{k}")
    assert (gh is None) == (wh is None)
    if wh is not None:
        for k in ("w", "b"):
            np.testing.assert_array_equal(gh[k], wh[k])


# ---------------------------------------------------------------------------
# PEFT dirs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_direction, with_head", [(False, True), (True, False)])
def test_peft_import_and_export_match_jax(tmp_path, fmt, per_direction, with_head):
    jcfg, cfg = _cfgs()
    sd = _synthetic_sd(np.random.default_rng(0), per_direction_xproj=per_direction,
                       with_head=with_head)
    d = _write_dir(tmp_path / "in", sd, fmt)
    assert tpeft.is_peft_adapter_dir(d) and jpeft.is_peft_adapter_dir(d)
    got, want = tpeft.import_peft_adapter(d, cfg), jpeft.import_peft_adapter(d, jcfg)
    _assert_imports_equal(got, want)

    adapters, head, cfg_l, task, base = got
    tpeft.export_peft_adapter(tmp_path / "t", adapters, head, cfg, cfg_l, task, base)
    jpeft.export_peft_adapter(tmp_path / "j", *want[:2], jcfg, want[2], task, base)
    # the port always writes safetensors (its own writer); JAX writes .bin
    # where its safetensors package is hidden
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == [
        "adapter_config.json", "adapter_model.safetensors"]
    assert sorted(p.name for p in (tmp_path / "j").iterdir()) == [
        "adapter_config.json", "adapter_model" + fmt]
    assert ((tmp_path / "t" / "adapter_config.json").read_text()
            == (tmp_path / "j" / "adapter_config.json").read_text())
    t_sd, j_sd = (tpeft._load_adapter_tensors(tmp_path / k) for k in ("t", "j"))
    assert t_sd.keys() == j_sd.keys()
    for k in j_sd:
        np.testing.assert_array_equal(t_sd[k], j_sd[k], err_msg=k)
    # torch tensors export as numpy arrays do
    tpeft.export_peft_adapter(
        tmp_path / "t2", {n: {k: torch.from_numpy(v) for k, v in ab.items()}
                          for n, ab in adapters.items()}, head, cfg, cfg_l, task, base)
    _assert_imports_equal(tpeft.import_peft_adapter(tmp_path / "t2", cfg), got)


def _stray(sd):
    sd["base_model.model.mystery.lora_A.weight"] = np.zeros((4, 16), np.float32)


def _transposed(sd):
    k = "base_model.model.backbone.layers.0.mixer.in_proj.lora_B.weight"
    sd[k] = sd[k].T.copy()


def _wide_head(sd):
    sd["base_model.model.score.modules_to_save.weight"] = np.zeros((2, 32), np.float32)


def _partial_dirs(sd):
    k = "base_model.model.backbone.layers.1.mixer.mamba_rev.x_proj.lora_A.weight"
    del sd[k]


@pytest.mark.parametrize("breakage", [_stray, _transposed, _wide_head, _partial_dirs])
def test_peft_strict_refusals_match_jax(tmp_path, fmt, breakage):
    jcfg, cfg = _cfgs()
    sd = _synthetic_sd(np.random.default_rng(1), with_head=False,
                       per_direction_xproj=breakage is _partial_dirs)
    breakage(sd)
    d = _write_dir(tmp_path / "in", sd, fmt)
    errors = []
    for mod, c in ((jpeft, jcfg), (tpeft, cfg)):
        with pytest.raises((KeyError, ValueError)) as exc:
            mod.import_peft_adapter(d, c)
        errors.append((type(exc.value), str(exc.value)))
    assert errors[0] == errors[1]


def test_peft_export_refuses_independent_lora_a(tmp_path):
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.train import lora

    jcfg, cfg = _cfgs()
    adapters = lora.init_lora(torch.Generator().manual_seed(1),
                              Caduceus(cfg, init_params(cfg)), lora.LoraConfig(r=4))
    errors = []
    for mod, c, ad in ((jpeft, jcfg, {n: {k: v.numpy() for k, v in ab.items()}
                                      for n, ab in adapters.items()}),
                       (tpeft, cfg, adapters)):
        with pytest.raises(ValueError, match="independent lora_A") as exc:
            mod.export_peft_adapter(tmp_path / mod.__name__, ad, None, c,
                                    lora.LoraConfig(r=4), "classification")
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def _cli(pkg, args):
    if pkg == "jax":
        from plantcaduceus_tpu.cli.lora_fine_tune import main
    else:
        from plantcaduceus_tpu_torch.cli.lora_fine_tune import main
        args = args + (["--device", "cpu"] if args[0] != "tokenize" else [])
    main(args)


def _predictions(path):
    with open(path) as f:
        rows = list(csv.reader(f))
    return rows[0], np.array([[float(v) for v in r] for r in rows[1:]])


def test_evaluate_and_predict_cross_peft_dirs(tmp_path, base_dir, data):
    """The port on JAX's PEFT export and the JAX CLI on the port's: the same
    metrics and probabilities (float32 both), predictions in pandas' CSV
    layout."""
    jcfg, cfg = _cfgs()
    sd = _synthetic_sd(np.random.default_rng(2), n_labels=2)
    src = _write_dir(tmp_path / "src", sd, ".bin")
    imported = jpeft.import_peft_adapter(src, jcfg)
    jpeft.export_peft_adapter(tmp_path / "jax_export", *imported[:2], jcfg, *imported[2:])
    got = tpeft.import_peft_adapter(src, cfg)
    tpeft.export_peft_adapter(tmp_path / "port_export", *got[:2], cfg, *got[2:])

    common = ["--data-dir", str(data / "cls.parquet"), "--model-name", str(base_dir),
              "--batch-size", "8", "--no-bf16"]
    out = {}
    for pkg, ckpt, cmd in (("jax", "jax_export", "evaluate"), ("torch", "jax_export", "evaluate"),
                           ("torch", "jax_export", "predict"), ("jax", "port_export", "predict"),
                           ("torch", "port_export", "predict")):
        res = tmp_path / f"{pkg}_{ckpt}_{cmd}"
        flag = (["--metrics-json", str(res)] if cmd == "evaluate"
                else ["--output-file", str(res)])
        _cli(pkg, [cmd, "--checkpoint-dir", str(tmp_path / ckpt)] + common + flag)
        out[pkg, ckpt, cmd] = res
    want = json.loads(out["jax", "jax_export", "evaluate"].read_text())
    metrics = json.loads(out["torch", "jax_export", "evaluate"].read_text())
    assert metrics.keys() == want.keys()
    for k in want:
        assert abs(metrics[k] - want[k]) <= PRED_TOL, k
    jh, jp = _predictions(out["jax", "port_export", "predict"])
    for key in (("torch", "jax_export", "predict"), ("torch", "port_export", "predict")):
        th, tp = _predictions(out[key])
        assert th == jh == ["probability_positive"] and tp.shape == jp.shape == (16, 1)
        np.testing.assert_allclose(tp, jp, atol=PRED_TOL, rtol=0)


def test_evaluate_needs_model_name_for_a_peft_dir(tmp_path, data):
    src = _write_dir(tmp_path / "src", _synthetic_sd(np.random.default_rng(3), n_labels=2), ".bin")
    with pytest.raises(SystemExit, match="--model-name is required"):
        _cli("torch", ["evaluate", "--checkpoint-dir", str(src), "--data-dir",
                       str(data / "cls.parquet")])


# ---------------------------------------------------------------------------
# tokenize, display
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("task", ["classification", "multi_label"])
def test_tokenize_matches_jax(tmp_path, base_dir, task):
    from plantcaduceus_tpu_torch.cli.lora_fine_tune import _load_data

    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGTN"), L)) for _ in range(12)]
    labels = (rng.integers(0, 3, 12) if task == "classification"
              else ["1" + "".join(rng.choice(list("01"), 3)) for _ in range(12)])
    tsv = tmp_path / "t.tsv"
    pd.DataFrame({"Sequence": seqs, "Label": labels}).to_csv(tsv, sep="\t", index=False)
    (tmp_path / "t.tsv.gz").write_bytes(gzip.compress(tsv.read_bytes()))
    flags = ["--model-name", str(base_dir), "--sequence-length", str(L), "--task-type", task]
    _cli("jax", ["tokenize", "--data-dir", str(tsv)] + flags)  # default: t.parquet
    want = pd.read_parquet(tmp_path / "t.parquet")
    for src, out in (("t.tsv", "p.npz"), ("t.tsv.gz", "g.npz"), ("t.tsv", "p.parquet")):
        from plantcaduceus_tpu_torch.cli.lora_fine_tune import main

        main(["tokenize", "--data-dir", str(tmp_path / src), "--output-path",
              str(tmp_path / out)] + flags)
        ids, lab = _load_data(tmp_path / out)
        np.testing.assert_array_equal(ids, np.stack(want["input_ids"].to_numpy()))
        col = "labels" if task == "multi_label" else "label"
        wl = np.stack(want[col].to_numpy())
        np.testing.assert_array_equal(lab, wl.astype(lab.dtype))
        if out.endswith(".parquet"):
            got = pd.read_parquet(tmp_path / out)
            assert list(got.columns) == list(want.columns)
            assert got[col].dtype == want[col].dtype
    bad = tmp_path / "bad.tsv"
    pd.DataFrame({"sequence": ["ACGT", "ACG"], "label": [0, 1]}).to_csv(bad, sep="\t", index=False)
    errors = []
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError) as exc:
            _cli(pkg, ["tokenize", "--data-dir", str(bad), "--sequence-length", "4",
                       "--output-path", str(tmp_path / "bad.npz")])
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_hub_dataset_and_parquet_without_pandas_are_refused(tmp_path, monkeypatch):
    """A hub dataset is refused; a ``.parquet`` without pandas is no longer
    refused: it is written and read by the port's ``io.parquet``."""
    from plantcaduceus_tpu_torch.cli.lora_fine_tune import _load_data, _save_data, main

    with pytest.raises(SystemExit, match="--hf-dataset"):
        main(["tokenize", "--hf-dataset", "org/data"])
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    ids = np.arange(12, dtype=np.int32).reshape(3, 4)
    _save_data(tmp_path / "x.parquet", {"input_ids": ids, "label": np.array([0, 1, 0])})
    got_ids, got_labels = _load_data(tmp_path / "x.parquet")
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_labels, [0, 1, 0])


def test_display_lists_jax_leaves(base_dir, capsys):
    """The inventory in JAX's layout and order (its keystr paths, stacked
    shapes), the adapters trainable and nothing else."""
    _cli("torch", ["display", "--model-name", str(base_dir), "--lora-r", "4"])
    lines = capsys.readouterr().out.splitlines()
    rows = [ln.split() for ln in lines[1:] if ln.startswith(("[", "lora["))]
    assert rows[0][:2] == ["['blocks']['A_log']", "False"]
    assert [r[0] for r in rows if r[1] == "True"] == [
        f"lora['{n}']['{k}']" for n in ("in_proj_x", "in_proj_z", "out_proj", "x_proj_B",
                                        "x_proj_C", "x_proj_dt") for k in "ab"]
    shapes = {r[0]: " ".join(r[2:-1]) for r in rows}
    assert shapes["lora['x_proj_dt']['a']"] == "(2, 2, 32, 4)"
    assert shapes["['blocks']['in_proj_x']"] == "(2, 1, 16, 32)"
    trainable = sum(int(r[-1]) for r in rows if r[1] == "True")
    assert lines[-1].startswith(f"trainable params: {trainable} | all params: "
                                f"{sum(int(r[-1]) for r in rows)}")


# ---------------------------------------------------------------------------
# train: resume, suite
# ---------------------------------------------------------------------------


def _train(tmp_path, base_dir, data, out, extra=()):
    from plantcaduceus_tpu_torch.cli.lora_fine_tune import main

    main(["train", "--train-dir", str(data / "cls.parquet"), "--valid-dir",
          str(data / "cls.parquet"), "--model-name", str(base_dir), "--output-dir",
          str(tmp_path / out), "--max-steps", "4", "--save-steps", "2", "--eval-steps", "2",
          "--train-batch-size", "4", "--grad-accum", "2", "--warmup-steps", "1",
          "--lora-r", "4", "--no-bf16", "--device", "cpu", *extra])


def _tensors(path):
    tree = torch.load(path, weights_only=True)
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(t, torch.Tensor):
            flat[prefix] = t
    walk(tree, "")
    return flat


@pytest.mark.parametrize("full", [False, True])
def test_resume_is_exact(tmp_path, base_dir, data, full):
    mode = ["--full-finetune"] if full else ["--lora-dropout", "0.1"]
    _train(tmp_path, base_dir, data, "a", mode)
    _train(tmp_path, base_dir, data, "b",
           mode + ["--resume-from", str(tmp_path / "a" / "checkpoint-2")])
    for f in ("final/adapter.pt", "checkpoint-4/adapter.pt", "checkpoint-4/train_state.pt"):
        a, b = _tensors(tmp_path / "a" / f), _tensors(tmp_path / "b" / f)
        assert a.keys() == b.keys() and a
        assert all(torch.equal(a[k], b[k]) for k in a), f
    meta = json.loads((tmp_path / "a" / "final" / "adapter_config.json").read_text())
    assert meta.get("full_finetune", False) == full
    # the other mode, or other LoRA hyperparameters, are refused
    other = ([] if full else ["--full-finetune"])
    with pytest.raises(SystemExit, match="full_finetune"):
        _train(tmp_path, base_dir, data, "c",
               other + ["--resume-from", str(tmp_path / "a" / "checkpoint-2")])
    if not full:
        with pytest.raises(SystemExit, match="does not match"):
            _train(tmp_path, base_dir, data, "d", ["--lora-dropout", "0.2", "--resume-from",
                                                   str(tmp_path / "a" / "checkpoint-2")])
        with pytest.raises(FileNotFoundError, match="not a resumable"):
            _train(tmp_path, base_dir, data, "e",
                   mode + ["--resume-from", str(tmp_path / "a" / "final")])


def test_suite_runs_jobs_and_aggregates(tmp_path, base_dir):
    from plantcaduceus_tpu_torch.cli import finetune_suite

    rng = np.random.default_rng(5)
    for name, task in (("clsA", "classification"), ("regrB", "regression")):
        for split, n in (("train", 16), ("valid", 8)):
            label = (rng.integers(0, 2, n) if task == "classification"
                     else rng.standard_normal(n).astype(np.float32))
            np.savez(tmp_path / f"{name}_{split}.npz",
                     input_ids=rng.integers(7, 11, (n, L)).astype(np.int32), label=label)
    manifest = {
        "defaults": {"model-name": str(base_dir), "max-steps": 4, "train-batch-size": 8,
                     "grad-accum": 1, "eval-batch-size": 8, "eval-steps": 4,
                     "save-steps": 4, "warmup-steps": 1, "no-bf16": True, "device": "cpu"},
        "jobs": [
            {"name": "clsA", "train_dir": str(tmp_path / "clsA_train.npz"),
             "valid_dir": str(tmp_path / "clsA_valid.npz"), "task_type": "classification"},
            {"name": "regrB", "train_dir": str(tmp_path / "regrB_train.npz"),
             "valid_dir": str(tmp_path / "regrB_valid.npz"), "task_type": "regression",
             "overrides": {"full-finetune": True}},
        ],
    }
    out = tmp_path / "suite"
    results = finetune_suite.run_suite(manifest, out)
    saved = json.loads((out / "suite_metrics.json").read_text())
    assert set(saved) == {"clsA", "regrB"} and results == saved
    assert "accuracy" in saved["clsA"] and "rmse" in saved["regrB"]
    assert (out / "clsA" / "final" / "adapter_config.json").exists()
    again = finetune_suite.run_suite(manifest, out, only={"clsA"}, skip_train=True)
    assert again == {"clsA": saved["clsA"]}


# ---------------------------------------------------------------------------
# model card
# ---------------------------------------------------------------------------

# The lines of JAX's card that name its framework, and the port's.
CARD_MAP = {"library_name: plantcaduceus_tpu": "library_name: plantcaduceus_tpu_torch",
            "- tpu": "- cuda", "- jax": "- pytorch",
            "- name: plantcaduceus-tpu": "- name: plantcaduceus-tpu-torch",
            "# PlantCaduceus (TPU-native)": "# PlantCaduceus (PyTorch/CUDA)",
            "Masked-language genomic model trained with the plantcaduceus_tpu framework "
            "(JAX/Pallas on TPU).": "Masked-language genomic model trained with the "
            "plantcaduceus_tpu_torch framework (PyTorch/CUDA on GPU).",
            "python -m plantcaduceus_tpu.cli.zero_shot_score \\":
            "python -m plantcaduceus_tpu_torch.cli.zero_shot_score \\"}


@pytest.mark.parametrize("kw", [
    {}, dict(finetuned_from="base-l20", dataset="synthetic", n_params=12345,
             metrics={"loss": 1.25, "perplexity": 3.49}, extra={"Notes": "seeded"})])
def test_model_card_matches_jax(tmp_path, kw):
    from plantcaduceus_tpu.compat import model_card as jcard
    from plantcaduceus_tpu_torch.compat import model_card as tcard

    jcfg, cfg = _cfgs()
    want = jcard.write_model_card(tmp_path / "j" / "final", jcfg, **kw).read_text()
    got = tcard.write_model_card(tmp_path / "t" / "final", cfg, **kw).read_text()
    mapped = [CARD_MAP.get(line, line) for line in want.split("\n")]
    assert got.split("\n") == mapped
    for m in ({"loss": 1.5, "accuracy": "0.25", "junk": object()}, None, {"x": object()}):
        assert tcard._final_metrics_from_log(m) == jcard._final_metrics_from_log(m)


def test_push_to_hub_offline_error(tmp_path, monkeypatch):
    """Without huggingface_hub (as on the card's host): one clear error
    naming the offline upload command, JAX's message."""
    from plantcaduceus_tpu.compat import model_card as jcard
    from plantcaduceus_tpu_torch.compat import model_card as tcard

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    messages = []
    for mod in (jcard, tcard):
        with pytest.raises(RuntimeError, match="huggingface-cli upload") as exc:
            mod.push_to_hub(tmp_path, "org/repo")
        messages.append(str(exc.value))
        with pytest.raises(FileNotFoundError):
            mod.push_to_hub(tmp_path / "missing", "org/repo")
    assert messages[0] == messages[1]


def test_pretrain_writes_the_model_card(tmp_path, monkeypatch):
    """The port's final export carries README.md with the final eval
    metrics; ``--push-to-hub`` then calls ``push_to_hub`` (offline here)."""
    from plantcaduceus_tpu_torch.cli import pretrain

    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(TINY))
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    with pytest.raises(RuntimeError, match="huggingface-cli upload"):
        pretrain.main(["--dataset", "synthetic", "--config", str(cfg_path), "--window", "32",
                       "--batch-size", "8", "--dtype", "float32", "--log-steps", "1",
                       "--eval-steps", "2", "--save-steps", "3", "--max-steps", "3",
                       "--device", "cpu", "--output-dir", str(tmp_path / "run"),
                       "--push-to-hub", "org/repo"])
    text = (tmp_path / "run" / "final" / "README.md").read_text()
    assert "pipeline_tag: fill-mask" in text and "- synthetic" in text
    assert "perplexity" in text and "library_name: plantcaduceus_tpu_torch" in text
