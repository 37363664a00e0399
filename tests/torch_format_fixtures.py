"""Writes the committed zstd parquet fixtures in ``tests/format_fixtures/``
through the JAX package's own writers, from a seed.

    JAX_PLATFORMS=cpu python tests/torch_format_fixtures.py

* ``shards/shard_0000{0,1}.parquet``: 256 windows of 512 bp from a seeded
  genome-like sequence (AT-rich, soft-masked repeat copies, a few N runs),
  two shards of 128 written by ``plantcaduceus_tpu.train.streaming
  .convert_to_shards`` (pandas, zstd);
* ``lora_cls.parquet`` and ``lora_multi.parquet``: 64 windows of 512 bp
  tokenized by the JAX CLI's ``lora_fine_tune tokenize`` (pandas, zstd):
  ``input_ids`` a ``list<int32>`` column, with a scalar ``label`` (1 where
  the window's GC share passes 0.36) or a multi-label ``labels``
  (``list<int64>``, 4 classes; pandas reads the TSV's label strings as
  integers, so each string starts with a 1 to keep its width).

The port reads these files on hosts without pandas, pyarrow or zstandard
(``tests/test_torch_formats.py``; ``chip_smoke.py`` phase 16).
:func:`shard_sequences` and :func:`lora_rows` give what the files hold, so
a test can tell when the committed files go stale. Not a test module: it
imports JAX only when :func:`write` runs.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

SEED = 1414
L = 512
SHARDS, SHARD_WINDOWS = 2, 128
LORA_ROWS = 64
FIXTURES = Path(__file__).resolve().parent / "format_fixtures"


def _genome(rng, n: int) -> str:
    """An AT-rich sequence of ``n`` bp with soft-masked (lowercase) copies
    of three repeat elements, each copy 2% mutated, and a few N runs."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    seq = rng.choice(bases, n, p=[0.32, 0.18, 0.18, 0.32])
    elements = [rng.choice(bases, k) for k in (300, 800, 1500)]
    for _ in range(n // 4000):
        e = elements[rng.integers(len(elements))].copy()
        flip = rng.random(len(e)) < 0.02
        e[flip] = rng.choice(bases, int(flip.sum()))
        at = int(rng.integers(0, n - len(e)))
        seq[at:at + len(e)] = e + 32  # lowercase
    for _ in range(n // 40000):
        at = int(rng.integers(0, n - 50))
        seq[at:at + int(rng.integers(5, 50))] = ord("N")
    return seq.tobytes().decode()


def shard_sequences() -> list:
    """The 512-bp windows of the shards, in order."""
    g = _genome(np.random.default_rng([SEED, 0]), SHARDS * SHARD_WINDOWS * L)
    return [g[i:i + L] for i in range(0, len(g), L)]


def lora_rows(task: str) -> tuple:
    """(windows, labels as the TSV holds them) of a tokenized table."""
    g = _genome(np.random.default_rng([SEED, 1]), LORA_ROWS * L)
    seqs = [g[i:i + L] for i in range(0, len(g), L)]
    upper = [s.upper() for s in seqs]
    gc = [(s.count("G") + s.count("C")) / L for s in upper]
    if task == "classification":
        return seqs, [int(f > 0.36) for f in gc]
    return seqs, ["1" + "".join(str(int(c)) for c in (f > 0.36, s != u, "N" in u))
                  for f, s, u in zip(gc, seqs, upper)]


def write(out_dir: Path = FIXTURES) -> None:
    from plantcaduceus_tpu.cli.lora_fine_tune import main as jax_ft
    from plantcaduceus_tpu.train.streaming import convert_to_shards

    out_dir = Path(out_dir)
    for old in out_dir.glob("**/*.parquet"):
        old.unlink()
    convert_to_shards(shard_sequences(), out_dir / "shards", shard_size=SHARD_WINDOWS)
    with tempfile.TemporaryDirectory() as tmp:
        for task, name in (("classification", "lora_cls"), ("multi_label", "lora_multi")):
            seqs, labels = lora_rows(task)
            tsv = Path(tmp) / f"{name}.tsv"
            tsv.write_text("sequence\tlabel\n" + "".join(
                f"{s}\t{y}\n" for s, y in zip(seqs, labels)))
            jax_ft(["tokenize", "--data-dir", str(tsv), "--output-path",
                    str(out_dir / f"{name}.parquet"), "--sequence-length", str(L),
                    "--task-type", task])


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    write()
    for f in sorted(FIXTURES.glob("**/*.parquet")):
        print(f.relative_to(FIXTURES), f.stat().st_size)
