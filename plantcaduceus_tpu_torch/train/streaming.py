"""Sharded streaming dataset for pre-training corpora too large for memory.

Counterpart of ``plantcaduceus_tpu.train.streaming``, on the port's own
readers (no pandas):

* a corpus is a directory of shard files (parquet / tsv / txt / jsonl /
  fasta), or one shard file such as a multi-GB genome FASTA;
* shards are assigned round-robin to processes from an order shuffled per
  epoch with a seeded numpy generator;
* within a shard, records are block-shuffled through a bounded buffer, so
  memory stays O(buffer), not O(corpus);
* records flow through the same tokenise → soft-mask weights → MLM collate
  path as the in-memory ``PretrainDataset``.

The numpy generators are drawn in the JAX package's order, so both packages
yield the same batches byte for byte from the same shards, from step 0, from
a resume step and in ``eval_batches``. Parquet shards go through
``io/parquet`` (zstd, gzip, snappy or uncompressed: the JAX package's zstd
shards too), TSV shards through ``io/tables`` (the first column
stands in for a missing ``seq_column``, as in JAX), FASTA shards one
chromosome at a time through ``io/fasta``.

``convert_to_shards`` is the offline converter: it splits any iterable of
sequences into fixed-size gzip parquet shards (JAX writes zstd, through
pandas; both packages read both packages' shards).
"""

from __future__ import annotations

import csv
import itertools
import json
import logging
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from plantcaduceus_tpu_torch.io.fasta import iter_fasta
from plantcaduceus_tpu_torch.io.parquet import read_parquet, write_parquet
from plantcaduceus_tpu_torch.io.tables import open_table
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.train.masking import MlmCollator, soft_mask_weights

log = logging.getLogger(__name__)

SHARD_SUFFIXES = (".parquet", ".tsv", ".txt", ".jsonl", ".fa", ".fasta")
FASTA_SUFFIXES = (".fa", ".fasta", ".fa.gz", ".fasta.gz")


def _read_shard(path: Path, seq_column: str, window: int,
                stride: Optional[int]) -> Iterator[str]:
    """Lazily yield the records of one shard. FASTA shards stream one
    chromosome at a time (O(chromosome) memory); table shards are loaded
    whole — the shard size is the memory granularity there."""
    if path.suffix == ".parquet":
        yield from (str(s) for s in read_parquet(path, [seq_column])[seq_column])
        return
    if path.suffix in (".tsv", ".txt"):
        with open_table(path) as fh:
            reader = csv.reader(fh, delimiter="\t")
            header = next(reader, [])
            col = header.index(seq_column) if seq_column in header else 0
            yield from (row[col] for row in reader if row)
        return
    if path.suffix == ".jsonl":
        with open(path) as fh:
            for line in fh:
                if line.strip():
                    yield json.loads(line)[seq_column]
        return
    if path.name.endswith(FASTA_SUFFIXES):
        stride = stride or window
        for _, seq in iter_fasta(path):
            for i in range(0, max(1, len(seq) - window + 1), stride):
                w = seq[i:i + window]
                if len(w) == window:
                    yield w
        return
    raise ValueError(f"unsupported shard type {path.suffix}")


class StreamingPretrainDataset:
    """Infinite batch stream over a shard directory."""

    def __init__(
        self,
        shard_dir,
        tokenizer: DnaTokenizer,
        batch_size: int,
        seq_column: str = "seq",
        window: int = 512,
        stride: Optional[int] = None,
        soft_masked_weight: float = 0.1,
        mlm_probability: float = 0.15,
        shuffle_buffer: int = 8192,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        eval_shards: int = 0,
        split: str = "train",
    ):
        """``eval_shards=K`` holds out the LAST K shards (sorted order) as the
        eval split; ``split`` selects which side this instance serves.
        ``shard_dir`` may also be a single shard file."""
        root = Path(shard_dir)
        if root.is_file():
            shards = [root]
        else:
            shards = sorted(p for p in root.iterdir()
                            if p.suffix in SHARD_SUFFIXES or p.name.endswith(FASTA_SUFFIXES))
        if not shards:
            raise FileNotFoundError(f"no shard files under {shard_dir}")
        if eval_shards:
            if eval_shards >= len(shards):
                raise ValueError(f"eval_shards={eval_shards} would leave no training "
                                 f"shards (corpus has {len(shards)})")
            shards = shards[:-eval_shards] if split == "train" else shards[-eval_shards:]
        elif split != "train":
            raise ValueError("split='eval' requires eval_shards > 0")
        self.shards = shards
        self.tokenizer = tokenizer
        self.batch_size = batch_size
        self.seq_column = seq_column
        self.window = window
        self.stride = stride
        self.soft_masked_weight = soft_masked_weight
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.collator = MlmCollator(tokenizer, mlm_probability, seed=seed + 1)

    def _host_shards(self, epoch: int) -> List[Path]:
        """The epoch's shard order (one seeded permutation every process
        computes alike), striped across processes."""
        rng = np.random.default_rng(self.seed * 1000003 + epoch)
        order = rng.permutation(len(self.shards))
        mine = order[self.process_index::self.process_count]
        if len(mine) == 0:  # fewer shards than processes: share round-robin
            mine = [order[self.process_index % len(order)]]
        return [self.shards[i] for i in mine]

    def _records(self, epoch: int) -> Iterator[str]:
        rng = np.random.default_rng(self.seed * 7 + epoch * 13 + self.process_index)
        buf: List[str] = []
        for shard in self._host_shards(epoch):
            for seq in _read_shard(shard, self.seq_column, self.window, self.stride):
                if len(seq) != self.window:
                    continue
                buf.append(seq)
                if len(buf) >= self.shuffle_buffer:
                    idx = rng.integers(len(buf))
                    buf[idx], buf[-1] = buf[-1], buf[idx]
                    yield buf.pop()
        rest = np.array(buf, dtype=object)
        rng.shuffle(rest)
        yield from rest.tolist()

    def _batch(self, seqs: List[str], rng: np.random.Generator) -> dict:
        ids = self.tokenizer.encode_batch(seqs)
        w = soft_mask_weights(seqs, self.soft_masked_weight)
        return self.collator(ids, loss_weights=w, rng=rng)

    def iter_from(self, start_step: int) -> Iterator[dict]:
        """Batch stream from a global step. Batches before ``start_step`` are
        skipped without tokenising, but their shards are still read: that
        replay is what makes a resumed stream equal an uninterrupted one. The
        MLM mask is keyed by the global batch index."""
        epoch = step = 0
        pending: List[str] = []
        while True:
            for seq in self._records(epoch):
                pending.append(seq)
                if len(pending) == self.batch_size:
                    if step >= start_step:
                        yield self._batch(pending, np.random.default_rng([self.seed + 1, step]))
                    step += 1
                    pending = []
            epoch += 1

    def __iter__(self) -> Iterator[dict]:
        return self.iter_from(0)

    def eval_batches(self, n: Optional[int] = None) -> Iterator[dict]:
        """Deterministic pass over this split: shards in sorted order, no
        shuffle, collator generator keyed by batch index; every process reads
        the same records."""
        pending: List[str] = []
        count = 0
        for shard in self.shards:
            for seq in _read_shard(shard, self.seq_column, self.window, self.stride):
                if len(seq) != self.window:
                    continue
                pending.append(seq)
                if len(pending) == self.batch_size:
                    if n is not None and count >= n:
                        return
                    yield self._batch(pending, np.random.default_rng([self.seed + 2, count]))
                    count += 1
                    pending = []


def concat_chunks(sequences, window: int, tokenizer: DnaTokenizer,
                  sep_token: str = "[SEP]") -> Iterator[np.ndarray]:
    """Concat-mode chunking: join token streams with a separator id and emit
    fixed-length id windows, so no sequence material is dropped at record
    boundaries."""
    sep = tokenizer.get_vocab().get(sep_token, tokenizer.pad_token_id)
    buf = np.zeros(0, np.int32)
    for seq in sequences:
        ids = tokenizer.encode(seq)
        buf = (np.concatenate([buf, ids, [sep]]) if buf.size
               else np.concatenate([ids, [sep]]).astype(np.int32))
        while buf.size >= window:
            yield buf[:window].astype(np.int32)
            buf = buf[window:]


def convert_to_shards(source: Sequence[str], out_dir, shard_size: int = 65536,
                      seq_column: str = "seq") -> int:
    """Offline converter: iterable of sequences -> gzip parquet shards
    ``shard_00000.parquet``, ... of ``shard_size`` records. Returns the
    number of shards."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    records = iter(source)
    n_shards = 0
    while chunk := list(itertools.islice(records, shard_size)):
        write_parquet(out_dir / f"shard_{n_shards:05d}.parquet", {seq_column: chunk})
        n_shards += 1
    log.info("wrote %d shards to %s", n_shards, out_dir)
    return n_shards
