"""The port's zero-shot CLI against the JAX CLI, on the CPU.

Both CLIs score the same synthetic inputs with one tiny config exported by
``hf_export.export_hf_dir``, in float32. Scores agree within 1e-4 absolute
(log-ratios of probabilities from forwards that agree to ~1e-6); the rows
kept, the BED intervals and the VCF text around the scores agree exactly.
Also here: the port imports neither jax nor the JAX package, and its entry
points refuse to run when CUDA is asked for and absent.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WINDOW, IDX = 48, 23
SCORE_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    import jax

    from plantcaduceus_tpu.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu.models import caduceus
    from plantcaduceus_tpu.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4)
    params = caduceus.init_params(jax.random.PRNGKey(0), cfg)
    d = tmp_path_factory.mktemp("ckpt") / "tiny"
    export_hf_dir(d, params, cfg)
    return str(d)


def _run_both(args, tmp_path, suffix):
    from plantcaduceus_tpu.cli.zero_shot_score import main as jax_main
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as torch_main

    outs = {}
    for name, fn, extra in (("jax", jax_main, []), ("torch", torch_main, ["-device", "cpu"])):
        outs[name] = tmp_path / f"{name}{suffix}"
        fn(args + ["-output", str(outs[name]), "-batchSize", "8", "-dtype", "float32",
                   "-no-progress"] + extra)
    return outs


def _read_tsv(path, header=True):
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))
    return (rows[0], rows[1:]) if header else (None, rows)


@pytest.fixture
def snp_table(tmp_path):
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), WINDOW)) for _ in range(7)]
    seqs.append(seqs[2])  # a repeated window: scored once, reported twice
    refs = [s[IDX] for s in seqs]
    alts = [next(b for b in "ACGT" if b != r) for r in refs]
    refs[4], alts[5] = "N", "-"  # non-ACGT alleles: filtered out
    path = tmp_path / "snps.tsv"
    with open(path, "w") as fh:
        fh.write("chr\tpos\tref\talt\tsequences\n")
        for i, (s, r, a) in enumerate(zip(seqs, refs, alts)):
            fh.write(f"chr{i % 2 + 1}\t{100 + 7 * i}\t{r}\t{a}\t{s}\n")
    return path


def test_tsv_scores_match_jax_cli(tiny_ckpt, snp_table, tmp_path):
    outs = _run_both(["-input-table", str(snp_table), "-model", tiny_ckpt,
                      "-tokenIdx", str(IDX)], tmp_path, ".tsv")
    (jh, jrows), (th, trows) = _read_tsv(outs["jax"]), _read_tsv(outs["torch"])
    assert th == jh == ["chr", "pos", "ref", "alt", "sequences", "zeroShotScore"]
    assert len(trows) == len(jrows) == 6
    assert [r[:5] for r in trows] == [r[:5] for r in jrows]
    np.testing.assert_allclose([float(r[5]) for r in trows],
                               [float(r[5]) for r in jrows], **SCORE_TOL)
    assert trows[2][4] == trows[5][4] and trows[2][5] == trows[5][5]  # deduplicated window


def test_bed_output_matches_jax_cli(tiny_ckpt, snp_table, tmp_path):
    outs = _run_both(["-input-table", str(snp_table), "-model", tiny_ckpt,
                      "-tokenIdx", str(IDX), "-outBED"], tmp_path, ".bed")
    _, jrows = _read_tsv(outs["jax"], header=False)
    _, trows = _read_tsv(outs["torch"], header=False)
    assert [r[:5] for r in trows] == [r[:5] for r in jrows]
    assert all(int(r[2]) - int(r[1]) == 1 for r in trows)
    np.testing.assert_allclose([float(r[5]) for r in trows],
                               [float(r[5]) for r in jrows], **SCORE_TOL)


def test_vcf_mode_matches_jax_cli(tiny_ckpt, tmp_path):
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGT"), 300))
    fa = tmp_path / "g.fa"
    fa.write_text(">chr1\n" + "\n".join(seq[i:i + 60] for i in range(0, 300, 60)) + "\n")

    def other(base, k=1):
        return [c for c in "ACGT" if c != base][:k]

    a150 = other(seq[149], 2)
    vcf = tmp_path / "in.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        f"chr1\t5\t.\t{seq[4]}\t{other(seq[4])[0]}\t.\t.\tDP=1\n"        # left edge
        f"chr1\t150\t.\t{seq[149]}\t{a150[0]},TTG,{a150[1]}\t.\t.\t.\n"  # multi-allelic
        "chr1\t200\t.\tA\tATT\t.\t.\t.\n"                                # indel only
        f"chr1\t296\t.\t{seq[295]}\t{other(seq[295])[0]}\t.\t.\t.\n")    # right edge
    outs = _run_both(["-input-vcf", str(vcf), "-input-fasta", str(fa),
                      "-model", tiny_ckpt, "-window", str(WINDOW),
                      "-tokenIdx", str(IDX)], tmp_path, ".vcf")
    jl, tl = (p.read_text().splitlines() for p in (outs["jax"], outs["torch"]))
    assert [l for l in tl if l.startswith("#")] == [l for l in jl if l.startswith("#")]
    jrec = [l.split("\t") for l in jl if not l.startswith("#")]
    trec = [l.split("\t") for l in tl if not l.startswith("#")]
    assert len(trec) == len(jrec) == 3
    for j, t in zip(jrec, trec):
        assert t[:7] == j[:7]
        jinfo, jval = j[7].rsplit("plantCAD_zero_shot=", 1)
        tinfo, tval = t[7].rsplit("plantCAD_zero_shot=", 1)
        assert tinfo == jinfo
        jv, tv = jval.split(","), tval.split(",")
        assert [v == "." for v in tv] == [v == "." for v in jv]
        np.testing.assert_allclose([float(v) for v in tv if v != "."],
                                   [float(v) for v in jv if v != "."], **SCORE_TOL)
    assert trec[1][7].endswith(",.," + trec[1][7].rsplit(",", 1)[1])


def test_runner_extractors_match_jax(tiny_ckpt):
    """masked/multi-masked/positionwise probs and centre embeddings of the
    port's runner (10 windows: one full batch of 8 and a padded tail) against
    the JAX runner, float32. Probabilities and embeddings agree to 1e-5."""
    import jax.numpy as jnp

    from plantcaduceus_tpu.engine.runner import InferenceRunner as JaxRunner
    from plantcaduceus_tpu.utils.model_loading import load_model_and_tokenizer as jax_load
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    params, jcfg, _ = jax_load(tiny_ckpt)
    model, cfg, tok = load_model_and_tokenizer(tiny_ckpt)
    jr = JaxRunner(params, jcfg, dtype=jnp.float32, batch_size=8)
    tr = InferenceRunner(model, cfg, dtype=torch.float32, batch_size=8, device="cpu")
    ids = np.random.default_rng(5).integers(7, 11, size=(10, 32)).astype(np.int32)
    ids[:, 15] = tok.mask_token_id
    nuc = nucleotide_ids(tok)
    for name, args in (("masked_probs", (nuc, 15)), ("multi_masked_probs", (nuc, (3, 15))),
                       ("positionwise_probs", (nuc,)), ("center_embeddings", (15,))):
        want = getattr(jr, name)(ids, *args, progress=False)
        got = getattr(tr, name)(ids, *args, progress=False)
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=name)


def test_port_imports_no_jax():
    """Import every module of the port (the training stack, the HF export and
    the pre-training CLI included) and chip_smoke.py, run a CPU forward and
    a CPU training step, and check that neither jax nor any
    plantcaduceus_tpu module was loaded."""
    code = r"""
import importlib, importlib.util, pkgutil, sys
import numpy as np
import torch
import plantcaduceus_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
for m in ("train.masking", "train.data", "train.optimizer", "train.step", "train.loop",
          "train.checkpoint", "compat.hf_export", "cli.pretrain"):
    assert "plantcaduceus_tpu_torch." + m in sys.modules, m
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from plantcaduceus_tpu_torch.train.step import make_train_step
cfg = CaduceusConfig(d_model=16, n_layer=2, d_state=4)
model = Caduceus(cfg, init_params(cfg))
with torch.inference_mode():
    out = model(torch.randint(7, 11, (2, 16)))
assert out["logits"].shape == (2, 16, 16)
init, step, _ = make_train_step(cfg, make_optimizer(params=dict(model.named_parameters())),
                                model, dtype=torch.float32, device="cpu")
ids = np.random.default_rng(0).integers(7, 11, (2, 16))
_, m = step(init(), {"input_ids": ids, "labels": ids})
assert np.isfinite(float(m["loss"]))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "plantcaduceus_tpu"))
assert not bad, bad
print("clean")
"""
    # A fresh environment: only the repository on the path, so nothing the
    # parent process or its site setup imported can leak into the check.
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LD_LIBRARY_PATH")
           if k in os.environ}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=dict(env, PYTHONPATH=str(REPO)))
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("clean")


def test_entry_points_refuse_missing_cuda(monkeypatch, tiny_ckpt, snp_table, tmp_path):
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.tsv"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["-input-table", str(snp_table), "-model", tiny_ckpt,
              "-output", str(out), "-no-progress"])
    assert not out.exists()
    model, cfg, _ = load_model_and_tokenizer(tiny_ckpt)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceRunner(model, cfg)
    with pytest.raises(SystemExit):
        main(["-input-table", str(snp_table), "-model", tiny_ckpt,
              "-output", str(out), "-seq", "2", "-device", "cpu"])
