"""Compressed tables (``io/tables.py``) in the port's CLIs against the JAX CLIs.

The JAX CLIs read and write their TSVs with pandas, which picks the
compression from the suffix. The port's ``zero_shot_score`` (TSV output,
and BED output as gzip), ``predict_xgboost`` and ``zero_shot_eval`` (``--repo-id``,
``--save-logits``, ``--logits-path``) must read the same ``.gz``, ``.bz2``,
``.xz`` and ``.zip`` inputs and write files whose decompressed text is the
JAX CLI's: every cell equal, scores within 1e-4 and probabilities within
1e-5 (float32 forwards that agree to ~1e-6), the zip member named alike.
A gzip header holds an mtime, so files are compared decompressed.
``.zst`` and tar archives are refused with a message naming the suffix.
Both packages read one tiny checkpoint written by the port's
``export_hf_dir``.
"""

import bz2
import gzip
import json
import lzma
import zipfile

import numpy as np
import pandas as pd
import pytest

from tests.test_torch_eval import fp32  # noqa: F401  (pins both runners to float32)
from tests.torch_threads import one_torch_thread  # noqa: F401

WINDOW, IDX = 48, 23
SCORE_TOL = 1e-4
PROB_TOL = 1e-5
SUFFIXES = [".gz", ".bz2", ".xz", ".zip"]


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=16, n_layer=2, vocab_size=16, d_state=4)
    d = tmp_path_factory.mktemp("ckpt") / "tiny"
    export_hf_dir(d, init_params(cfg, seed=0), cfg)
    return str(d)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(11)
    seqs = ["".join(rng.choice(list("ACGT"), WINDOW)) for _ in range(10)]
    refs = [s[IDX] for s in seqs]
    alts = [next(b for b in "ACGT" if b != r) for r in refs]
    refs[4] = "N"  # a non-ACGT allele: filtered out
    snps = pd.DataFrame({"chr": [f"chr{i % 2 + 1}" for i in range(10)],
                         "pos": [100 + 7 * i for i in range(10)],
                         "ref": refs, "alt": alts, "sequences": seqs})
    evo = pd.DataFrame({"sequence": seqs, "label": [i % 2 for i in range(10)]})
    return snps, evo


def decompressed(path):
    """(zip member names or None, the file's text)."""
    path = str(path)
    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            return names, zf.read(names[0]).decode()
    opener = {".gz": gzip.open, ".bz2": bz2.open, ".xz": lzma.open}[path[path.rindex("."):]]
    with opener(path, "rt") as fh:
        return None, fh.read()


def assert_same_table(got, want, tol, float_cols):
    """Decompressed texts: the same lines and cells, ``float_cols`` within tol."""
    (gnames, gtext), (wnames, wtext) = decompressed(got), decompressed(want)
    assert gnames == wnames
    glines, wlines = gtext.splitlines(), wtext.splitlines()
    assert len(glines) == len(wlines) > 1
    for g, w in zip(glines, wlines):
        g, w = g.split("\t"), w.split("\t")
        assert len(g) == len(w)
        for i, (a, b) in enumerate(zip(g, w)):
            if i in float_cols and a != b:
                assert abs(float(a) - float(b)) <= tol, (a, b)
            else:
                assert a == b


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_scoring_cli_reads_and_writes_compressed(tiny_ckpt, frames, tmp_path, suffix):
    from plantcaduceus_tpu.cli.zero_shot_score import main as jax_main
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as torch_main

    snps, _ = frames
    table = tmp_path / f"snps.tsv{suffix}"
    snps.to_csv(table, sep="\t", index=False)  # pandas writes the compressed input
    for bed in (False, True) if suffix == ".gz" else (False,):
        name = f"scores.{'bed' if bed else 'tsv'}{suffix}"
        outs = {}
        for pkg, fn, extra in (("jax", jax_main, []),
                               ("torch", torch_main, ["-device", "cpu"])):
            (tmp_path / pkg).mkdir(exist_ok=True)
            outs[pkg] = tmp_path / pkg / name
            fn(["-input-table", str(table), "-model", tiny_ckpt, "-tokenIdx", str(IDX),
                "-output", str(outs[pkg]), "-batchSize", "8", "-dtype", "float32",
                "-no-progress", *(["-outBED"] if bed else []), *extra])
        assert_same_table(outs["torch"], outs["jax"], SCORE_TOL, {5})
        if bed:  # pos - 1 and pos, printed as pandas prints an integer column
            _, text = decompressed(outs["torch"])
            rows = [ln.split("\t") for ln in text.splitlines()]
            assert [(r[1], r[2]) for r in rows] == [
                (str(p - 1), str(p)) for p, r in zip(snps["pos"], snps["ref"]) if r != "N"]


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_eval_cli_reads_and_writes_compressed(fp32, tiny_ckpt, frames, tmp_path, suffix):
    from plantcaduceus_tpu.cli.zero_shot_eval import main as jax_main
    from plantcaduceus_tpu_torch.cli.zero_shot_eval import main as torch_main

    _, evo = frames
    table = tmp_path / f"evo.tsv{suffix}"
    evo.to_csv(table, sep="\t", index=False)
    mains = {"jax": (jax_main, []), "torch": (torch_main, ["--device", "cpu"])}

    def run(pkg, tag, *flags):
        fn, extra = mains[pkg]
        mj = tmp_path / f"{pkg}_{tag}.json"
        fn(["evo_cons", "--repo-id", str(table), "--model", tiny_ckpt, "--batch-size", "8",
            "--token-idx", str(IDX), "--metrics-json", str(mj), "--no-progress",
            *flags, *extra])
        return json.loads(mj.read_text())

    logits = {pkg: tmp_path / pkg / f"logits.tsv{suffix}" for pkg in mains}
    for p in logits.values():
        p.parent.mkdir()
    got = {pkg: run(pkg, "save", "--save-logits", str(logits[pkg])) for pkg in mains}
    for k in ("auroc", "auprc"):
        assert abs(got["torch"][k] - got["jax"][k]) <= PROB_TOL
    assert_same_table(logits["torch"], logits["jax"], PROB_TOL, {0, 1, 2, 3})
    # each package replays the JAX package's compressed logits: the same metrics
    replays = [run(pkg, "replay", "--logits-path", str(logits["jax"])) for pkg in mains]
    assert replays[0] == replays[1]


def test_refused_and_malformed_archives(tiny_ckpt, tmp_path):
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main
    from plantcaduceus_tpu_torch.io.tables import open_table, suffix_of, zip_member_name

    for suffix in (".zst", ".tar", ".tar.gz", ".tar.bz2", ".tar.xz", ".TSV.ZST"):
        path = tmp_path / f"snps.tsv{suffix}"
        path.write_bytes(b"not read")
        with pytest.raises(ValueError, match=suffix.lower().replace(".tsv", "")):
            main(["-input-table", str(path), "-model", tiny_ckpt, "-output",
                  str(tmp_path / "out.tsv"), "-device", "cpu", "-no-progress"])
        with pytest.raises(ValueError, match="PyTorch port"):
            with open_table(tmp_path / f"out{suffix}", "w"):
                pass
    assert suffix_of("a.TSV.GZ") == ".gz" and suffix_of("a.tsv") is None
    assert zip_member_name("x/s.tsv.zip") == "s.tsv" and zip_member_name("s.ZIP") == "s.ZIP"

    two = tmp_path / "two.tsv.zip"
    with zipfile.ZipFile(two, "w") as zf:
        zf.writestr("a.tsv", "x\n1\n")
        zf.writestr("b.tsv", "x\n2\n")
    with pytest.raises(ValueError, match="Only one file per ZIP") as ours:
        with open_table(two):
            pass
    with pytest.raises(ValueError) as theirs:
        pd.read_csv(two, sep="\t")
    assert str(ours.value) == str(theirs.value)
