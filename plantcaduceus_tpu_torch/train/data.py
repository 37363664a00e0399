"""Pre-training data pipeline (numpy, host side).

Counterpart of ``plantcaduceus_tpu.train.data``: fixed-length genome windows
with soft-mask loss weights for the masked-LM trainer, reproducing
src/HF_pre_train.py's tokenize/map path.

* ``sequence_source`` resolves where raw sequences come from: a synthetic
  stream, a TSV/CSV with a ``seq`` column (read with the ``csv`` module), or
  a FASTA tiled into windows. Parquet, ``hf:`` datasets and ``shards:``
  streaming are not ported yet (the machine with the card has neither
  pandas nor ``datasets``); they raise.
* ``PretrainDataset`` tokenises, computes the lowercase soft-mask weights
  and applies the MLM collator. ``batch_at(step)`` is a pure function of
  (seed, step) and gives the JAX package's batches byte for byte.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Iterator, List, Optional

import numpy as np

from plantcaduceus_tpu_torch.io.fasta import iter_fasta
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.train.masking import MlmCollator, soft_mask_weights

# In-memory source cap: ~2M 512-bp windows ≈ 1 GB of Python strings.
DEFAULT_MAX_SEQUENCES = 2_000_000

_LATER = ("is not supported by the PyTorch port yet: streaming and HF/parquet "
          "sources come with a later slice of the port; use synthetic, a "
          "TSV/CSV or a FASTA")


def _capped(it, max_sequences: int, spec: str) -> List[str]:
    out: List[str] = []
    for s in it:
        out.append(s)
        if len(out) > max_sequences:
            raise ValueError(
                f"dataset {spec!r} exceeds the in-memory cap of {max_sequences} "
                "sequences; raise max_sequences explicitly")
    return out


def sequence_source(spec: str, split: str = "train",
                    seq_column: str = "seq",
                    window: int = 512, stride: Optional[int] = None,
                    synthetic_n: int = 4096,
                    seed: int = 0,
                    max_sequences: int = DEFAULT_MAX_SEQUENCES) -> List[str]:
    """Resolve a dataset spec to a list of raw sequences.

    spec forms:
      ``synthetic``                     — random ACGTacgt windows (smoke/bench)
      ``path.tsv`` / ``.txt`` / ``.csv``  — tab-separated table with a seq
                                          column (else a ``sequences`` column)
      ``path.fa[.gz]``                  — FASTA tiled into windows
    ``path.parquet``, ``hf:<name>`` and ``shards:<dir>`` raise
    ``NotImplementedError``.
    """
    if spec == "synthetic":
        rng = np.random.default_rng(seed)
        bases = np.array(list("ACGTacgt"))
        return ["".join(rng.choice(bases, window)) for _ in range(synthetic_n)]
    if spec.startswith(("hf:", "shards:")) or spec.endswith(".parquet"):
        raise NotImplementedError(f"dataset {spec!r} {_LATER}")

    p = Path(spec)
    if p.suffix in (".tsv", ".txt", ".csv"):
        with open(p, newline="") as fh:
            reader = csv.DictReader(fh, delimiter="\t")
            col = seq_column if seq_column in (reader.fieldnames or ()) else "sequences"
            return _capped((str(row[col]) for row in reader), max_sequences, spec)
    if p.name.endswith((".fa", ".fasta", ".fa.gz", ".fasta.gz")):
        stride = stride or window

        def windows():
            for _, seq in iter_fasta(p):
                for i in range(0, max(1, len(seq) - window + 1), stride):
                    w = seq[i : i + window]
                    if len(w) == window:
                        yield w

        return _capped(windows(), max_sequences, spec)
    raise ValueError(f"unrecognised dataset spec {spec!r}")


class PretrainDataset:
    """Shuffled, collated batch stream (one process: the JAX package's
    per-host record striding waits for the multi-GPU slice)."""

    def __init__(
        self,
        sequences: List[str],
        tokenizer: DnaTokenizer,
        batch_size: int,
        soft_masked_weight: float = 0.1,
        mlm_probability: float = 0.15,
        seed: int = 0,
    ):
        self.sequences = sequences
        if not self.sequences:
            raise ValueError("no sequences to train on")
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.soft_masked_weight = soft_masked_weight
        self.collator = MlmCollator(tokenizer, mlm_probability, seed=seed + 1)
        self.seed = seed
        self.n_batches_per_epoch = max(1, len(self.sequences) // batch_size)
        self._order_cache = (-1, None)

    def batch_at(self, step: int) -> dict:
        """The batch for a global step, as a PURE function of (seed, step):
        the epoch's shuffle order and the step's MLM mask both come from
        counter-keyed generators, so autoresume reproduces an uninterrupted
        run exactly."""
        epoch, k = divmod(step, self.n_batches_per_epoch)
        if self._order_cache[0] != epoch:  # one permutation per epoch
            self._order_cache = (epoch, np.random.default_rng(
                [self.seed, epoch]).permutation(len(self.sequences)))
        order = self._order_cache[1]
        idx = order[k * self.batch_size : (k + 1) * self.batch_size]
        seqs = [self.sequences[j] for j in idx]
        ids = self.tokenizer.encode_batch(seqs)
        w = soft_mask_weights(seqs, self.soft_masked_weight)
        return self.collator(
            ids, loss_weights=w,
            rng=np.random.default_rng([self.seed + 1, step]))

    def iter_from(self, start_step: int) -> Iterator[dict]:
        step = start_step
        while True:  # steps-based training; epochs loop forever
            yield self.batch_at(step)
            step += 1

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def eval_batches(self, n: Optional[int] = None) -> Iterator[dict]:
        """Deterministic pass (no shuffle) over up to n batches."""
        count = 0
        for i in range(0, len(self.sequences) - self.batch_size + 1, self.batch_size):
            if n is not None and count >= n:
                return
            seqs = self.sequences[i : i + self.batch_size]
            ids = self.tokenizer.encode_batch(seqs)
            w = soft_mask_weights(seqs, self.soft_masked_weight)
            yield self.collator(ids, loss_weights=w)
            count += 1
