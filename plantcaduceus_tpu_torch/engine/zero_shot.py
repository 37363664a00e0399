"""Zero-shot variant-effect scoring — the north-star workload.

Counterpart of ``plantcaduceus_tpu.engine.zero_shot``: mask
the window centre, masked-LM forward, softmax over the four nucleotide
logits, score ``log(P_alt) - log(P_ref)``. Two input modes (TSV with
ref/alt/sequences columns; VCF+FASTA), three outputs (TSV with
``zeroShotScore``, BED, VCF with ``INFO plantCAD_zero_shot``). Tables are
read and written with the ``csv`` module, compressed as their suffix says
(``io.tables``); every input column is kept as its text.

Over a mesh every rank holds every record, and the runner splits each
batch's rows over the ranks and gathers them back
(``engine.runner.InferenceRunner.run``), so every rank holds every
record's probabilities, equal to one process's; the caller writes on rank
0.
"""

from __future__ import annotations

import csv
import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
from plantcaduceus_tpu_torch.io.tables import open_table
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer, nucleotide_ids
from plantcaduceus_tpu_torch.io.vcf import ZERO_SHOT_INFO_HEADER, VcfReader, VcfWriter

log = logging.getLogger(__name__)

NUCLEOTIDES = ("A", "C", "G", "T")


@dataclasses.dataclass
class Table:
    """A tab-separated table: column names and rows of cell values."""

    columns: List[str]
    rows: List[Dict[str, object]]


def read_table(path) -> Table:
    with open_table(path) as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        rows = list(reader)
        return Table(list(reader.fieldnames or []), rows)


def mask_and_encode(sequences: Sequence[str], tokenizer: DnaTokenizer,
                    token_idx: int) -> np.ndarray:
    """Encode windows and set the scored index to [MASK]."""
    ids = tokenizer.encode_batch(sequences)
    ids[:, token_idx] = tokenizer.mask_token_id
    return ids


def _dedup(sequences: Sequence[str]):
    """(unique_sequences, inverse) with unique[inverse[i]] == sequences[i],
    in first-occurrence order; (sequences, None) when all are distinct. The
    masked forward depends only on the window, so records sharing one are
    scored once."""
    index_of: dict = {}
    inverse = np.empty(len(sequences), np.int64)
    unique: List[str] = []
    for i, s in enumerate(sequences):
        j = index_of.setdefault(s, len(unique))
        if j == len(unique):
            unique.append(s)
        inverse[i] = j
    if len(unique) == len(sequences):
        return sequences, None
    return unique, inverse


def nucleotide_probs(runner: InferenceRunner, tokenizer: DnaTokenizer,
                     sequences: Sequence[str], token_idx: int,
                     progress: bool = True) -> np.ndarray:
    """[N, 4] softmax probs over a,c,g,t at the masked centre."""
    nuc_ids = nucleotide_ids(tokenizer)
    sequences, inverse = _dedup(sequences)
    if inverse is not None:
        log.info("Scoring %d unique windows for %d records",
                 len(sequences), len(inverse))
    if len(sequences) == 0:
        return np.zeros((0, 4), np.float32)
    start = time.perf_counter()
    ids = mask_and_encode(sequences, tokenizer, token_idx)
    probs = runner.masked_probs(ids, nuc_ids, token_idx, progress=progress)
    secs = time.perf_counter() - start
    log.info("Scored %d windows in %.3f s (%.1f windows/s)",
             len(sequences), secs, len(sequences) / secs)
    return probs if inverse is None else probs[inverse]


def log_ratio_scores(probs: np.ndarray, refs: Sequence[str],
                     alts: Sequence[str]) -> np.ndarray:
    """log(P_alt / P_ref) per row."""
    ref_idx = np.asarray([NUCLEOTIDES.index(r) for r in refs])
    alt_idx = np.asarray([NUCLEOTIDES.index(a) for a in alts])
    rows = np.arange(len(probs))
    return np.log(probs[rows, alt_idx] / probs[rows, ref_idx])


# ---------------------------------------------------------------------------
# TSV mode
# ---------------------------------------------------------------------------


def score_table(runner: InferenceRunner, tokenizer: DnaTokenizer, table: Table,
                token_idx: int = 255, progress: bool = True) -> Table:
    """Score a table with ref/alt/sequences columns. Rows whose ref or alt
    is not one of A,C,G,T are dropped. Returns the kept rows with a
    ``zeroShotScore`` column."""
    kept = [r for r in table.rows
            if r["ref"] in NUCLEOTIDES and r["alt"] in NUCLEOTIDES]
    if len(kept) < len(table.rows):
        log.info("Filtered out %d invalid SNPs", len(table.rows) - len(kept))
    probs = nucleotide_probs(runner, tokenizer, [r["sequences"] for r in kept],
                             token_idx, progress=progress)
    scores = log_ratio_scores(probs, [r["ref"] for r in kept],
                              [r["alt"] for r in kept])
    rows = [dict(r, zeroShotScore=s) for r, s in zip(kept, scores)]
    return Table(table.columns + ["zeroShotScore"], rows)


def write_table(table: Table, output: str, as_bed: bool = False) -> None:
    with open_table(output, "w") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        if as_bed:
            for r in table.rows:
                pos = int(r["pos"])
                w.writerow([r["chr"], pos - 1, pos, r["ref"], r["alt"],
                            r["zeroShotScore"]])
        else:
            w.writerow(table.columns)
            for r in table.rows:
                w.writerow([r[c] for c in table.columns])


# ---------------------------------------------------------------------------
# VCF mode
# ---------------------------------------------------------------------------


def windows_from_vcf(vcf_path, fasta_path, window: int = 512,
                     token_idx: int = 255) -> Tuple[List[str], List[int]]:
    """Scoring windows for every record with at least one SNV alt, and the
    indices of those records; N-padded at chromosome edges."""
    from plantcaduceus_tpu_torch.io.native import open_fasta

    fasta = open_fasta(fasta_path)
    sequences: List[str] = []
    record_indices: List[int] = []
    prev_chrom: Optional[str] = None
    for idx, rec in enumerate(VcfReader(vcf_path)):
        if not rec.has_snv:
            continue
        sequences.append(fasta.window(rec.chrom, rec.pos0, window, token_idx))
        record_indices.append(idx)
        if prev_chrom is not None and prev_chrom != rec.chrom:
            fasta.evict(prev_chrom)
        prev_chrom = rec.chrom
    return sequences, record_indices


def annotate_vcf(vcf_path, output: str, record_indices: Sequence[int],
                 probs: np.ndarray) -> None:
    """Re-read the VCF and write scores into INFO plantCAD_zero_shot;
    non-SNV alt alleles get '.'; records without an SNV alt are dropped."""
    reader = VcfReader(vcf_path)
    by_record = {int(r): i for i, r in enumerate(record_indices)}
    with VcfWriter(output, reader.header_lines,
                   extra_info=[ZERO_SHOT_INFO_HEADER]) as writer:
        for idx, rec in enumerate(reader):
            row = by_record.get(idx)
            if row is None:
                continue
            p = probs[row]
            ref_p = p[NUCLEOTIDES.index(rec.ref.upper())]
            scores = []
            for alt in rec.alts:
                if rec.alt_is_snv(alt):
                    scores.append(str(np.log(p[NUCLEOTIDES.index(alt.upper())] / ref_p)))
                else:
                    scores.append(".")
            writer.write(rec.with_info("plantCAD_zero_shot", ",".join(scores)))


def score_vcf(runner: InferenceRunner, tokenizer: DnaTokenizer, vcf_path,
              fasta_path, output: str, token_idx: int = 255, window: int = 512,
              progress: bool = True) -> int:
    """Full VCF pipeline. Returns the number of scored records. Over a mesh
    every rank scores and rank 0 writes."""
    sequences, record_indices = windows_from_vcf(vcf_path, fasta_path, window,
                                                 token_idx)
    log.info("Scoring %d SNV records", len(sequences))
    probs = nucleotide_probs(runner, tokenizer, sequences, token_idx,
                             progress=progress)
    if runner.mesh is None or runner.mesh.rank == 0:
        annotate_vcf(vcf_path, output, record_indices, probs)
    return len(sequences)
