"""The port's input tools (``pipelines/mutagenesis.py``, ``cli/mutagenesis.py``,
``cli/format_vcf.py``) against the JAX package's, on the CPU.

On ``tests/test_pipelines.py``'s genome (two chromosomes, a description on
the first header line): ``mutagenesis simulate`` (with and without the
header, a gene overhanging the chromosome, a gene on another chromosome),
``mutagenesis downsample`` (classes over their caps, so both sample with
``random.Random(seed)``) and ``format_vcf`` (edge windows N-padded, a
multi-allelic record, an indel-only record, a change of chromosome) write
the JAX CLIs' files byte for byte. Then ``format_vcf``'s table scored by
the port's ``zero_shot_score -input-table`` gives the VCF mode's scores of
the same records within 1e-4 (one float32 forward, printed two ways).
"""

import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_torch_tables import tiny_ckpt  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WINDOW, IDX = 48, 23


@pytest.fixture
def genome(tmp_path, rng):
    seq = "".join(rng.choice(list("ACGT"), 3000))
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        f.write(">chr1 some description\n")
        for i in range(0, len(seq), 70):
            f.write(seq[i: i + 70] + "\n")
        f.write(">chr2\n" + seq[:500] + "\n")
    return fa, seq


def _both(tmp_path, name, args_for):
    """Run both packages' CLI ``name``; each writes into its own directory."""
    from importlib import import_module

    outs = {}
    for pkg in ("plantcaduceus_tpu", "plantcaduceus_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir(exist_ok=True)
        import_module(f"{pkg}.cli.{name}").main(args_for(d))
        outs[pkg] = d
    return outs["plantcaduceus_tpu_torch"], outs["plantcaduceus_tpu"]


@pytest.mark.parametrize("header", [True, False])
def test_mutagenesis_simulate_matches_jax(tmp_path, genome, header):
    fa, _ = genome
    gff = tmp_path / "ann.gff"
    gff.write_text(
        "##gff-version 3\n"
        "chr1\tsrc\tgene\t1200\t1400\t.\t+\t.\tID=gene1\n"
        "chr1\tsrc\texon\t1200\t1300\t.\t+\t.\tID=exon1\n"
        "chr1\tsrc\tgene\t10\t50\t.\t-\t.\tID=gene2\n"
        "chr1\tsrc\tgene\t1350\t1361\t.\t-\t.\tID=gene3\n"     # overlaps gene1's region
        "chr2\tsrc\tgene\t100\t200\t.\t+\t.\tID=gene4\n")
    ours, theirs = _both(tmp_path, "mutagenesis", lambda d: [
        "simulate", "-g", str(gff), "-f", str(fa), "-o", str(d / "sim.vcf"), "-c", "chr1",
        "-k", "100", *([] if header else ["--no-header"])])
    got = (ours / "sim.vcf").read_bytes()
    assert got == (theirs / "sim.vcf").read_bytes()
    assert got.count(b"\n") == 401 * 3 + (2 if header else 0)

    from plantcaduceus_tpu_torch.pipelines.mutagenesis import simulate_snps
    with pytest.raises(KeyError, match="chrX"):
        list(simulate_snps(fa, gff, "chrX"))


@pytest.mark.parametrize("seed", [42, 7])
def test_mutagenesis_downsample_matches_jax(tmp_path, seed):
    lines = ["##x\n", "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"]
    for i in range(30):
        lines.append(f"chr1\t{i + 1}\t.\tA\tG\t.\t.\tCSQ=G|intergenic_variant|x\n")
    for i in range(20):
        lines.append(f"chr1\t{100 + i}\t.\tA\tG\t.\t.\tConsequence=missense_variant\n")
    for i in range(5):
        lines.append(f"chr1\t{200 + i}\t.\tA\tC\t.\t.\tCSQ=C|synonymous_variant|y,C|x|z\n")
    lines.append("chr1\t500\t.\tA\tG\t.\t.\tCSQ=G|splice_donor&intron|x\n")  # '&'
    lines.append("chr1\t501\t.\tA\tG\t.\t.\tDP=3\n")  # no consequence
    lines.append("chr1\t502\t.\tA\n")  # too few columns
    src = tmp_path / "vep.vcf"
    src.write_text("".join(lines))
    ours, theirs = _both(tmp_path, "mutagenesis", lambda d: [
        "downsample", str(src), str(d / "ds.vcf"), "--intergenic-cap", "10",
        "--class-cap", "15", "--seed", str(seed)])
    got = (ours / "ds.vcf").read_text()
    assert got == (theirs / "ds.vcf").read_text()
    assert len([ln for ln in got.splitlines() if not ln.startswith("#")]) == 10 + 15 + 5


def _vcf(tmp_path, seq):
    def other(base, k=1):
        return [c for c in "ACGT" if c != base][:k]

    a = other(seq[1000], 2)
    vcf = tmp_path / "in.vcf"
    vcf.write_text(
        "##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
        f"chr1\t3\t.\t{seq[2]}\t{other(seq[2])[0]}\t.\t.\tDP=1\n"          # left edge
        f"chr1\t1001\t.\t{seq[1000]}\t{a[0]},TT,{a[1]}\t.\t.\t.\n"         # multi-allelic
        f"chr1\t1100\t.\t{seq[1099]}\tTTG\t.\t.\t.\n"                      # indel only
        f"chr1\t2995\t.\t{seq[2994].lower()}\t{other(seq[2994])[0].lower()}\t.\t.\t.\n"
        f"chr2\t480\t.\t{seq[479]}\t{other(seq[479])[0]}\t.\t.\t.\n")      # right edge
    return vcf


@pytest.mark.parametrize("window", [[], ["-window", str(WINDOW), "-tokenIdx", str(IDX)]])
def test_format_vcf_matches_jax(tmp_path, genome, window):
    fa, seq = genome
    vcf = _vcf(tmp_path, seq)
    ours, theirs = _both(tmp_path, "format_vcf", lambda d: [
        "-input-vcf", str(vcf), "-input-fasta", str(fa), "-output", str(d / "out.tsv"),
        *window])
    got = (ours / "out.tsv").read_bytes()
    assert got == (theirs / "out.tsv").read_bytes()
    assert got.count(b"\n") == 1 + 1 + 2 + 1 + 1


def test_format_vcf_table_scores_equal_vcf_mode(tmp_path, genome, tiny_ckpt):
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score

    fa, seq = genome
    vcf = _vcf(tmp_path, seq)
    flags = ["-model", tiny_ckpt, "-tokenIdx", str(IDX), "-batchSize", "4",
             "-dtype", "float32", "-device", "cpu", "-no-progress"]
    # format_vcf through python -m, as a user runs it
    res = subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.format_vcf",
                          "-input-vcf", str(vcf), "-input-fasta", str(fa), "-output",
                          str(tmp_path / "t.tsv"), "-window", str(WINDOW), "-tokenIdx",
                          str(IDX)], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    score(["-input-table", str(tmp_path / "t.tsv"), "-output", str(tmp_path / "t_scores.tsv"),
           *flags])
    score(["-input-vcf", str(vcf), "-input-fasta", str(fa), "-window", str(WINDOW),
           "-output", str(tmp_path / "scored.vcf"), *flags])
    rows = [ln.split("\t") for ln in (tmp_path / "t_scores.tsv").read_text().splitlines()]
    assert rows[0] == ["chr", "start", "end", "pos", "ref", "alt", "sequences",
                       "zeroShotScore"]
    table = [float(r[7]) for r in rows[1:]]
    vcf_scores = [float(v) for ln in (tmp_path / "scored.vcf").read_text().splitlines()
                  if not ln.startswith("#")
                  for v in ln.split("\t")[7].split("plantCAD_zero_shot=")[1].split(",")
                  if v != "."]
    assert len(table) == len(vcf_scores) == 5
    assert max(abs(a - b) for a, b in zip(table, vcf_scores)) <= 1e-4
