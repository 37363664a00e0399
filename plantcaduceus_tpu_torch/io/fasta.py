"""FASTA reading and fixed-width window extraction.

Replaces the reference's Biopython ``SeqIO.to_dict`` loading
(src/zero_shot_score.py:176-180) and the samtools/bedtools pipeline of
src/format_VCF.sh with framework-native code. A C++ fast path
(native/libpcio, loaded via ctypes in :mod:`plantcaduceus_tpu_torch.io.native`)
accelerates bulk window extraction; this module is the reference Python
implementation and the fallback.

Window semantics match the reference exactly
(src/zero_shot_score.py:187-198): for a 0-based variant position ``pos`` and
window length ``L`` with mask index ``idx``, the window is
``[pos - idx, pos + (L - idx))``; windows overhanging the chromosome start
are right-justified ('N'-padded on the left, rjust) and windows overhanging
the end are left-justified ('N'-padded on the right, ljust). Output is
upper-cased.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, Iterator, Tuple


def _open_text(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")
    return open(p, "r")


def iter_fasta(path) -> Iterator[Tuple[str, str]]:
    """Yield (name, sequence) pairs. Name is the first whitespace token."""
    name = None
    chunks = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    yield name, "".join(chunks)
                name = line[1:].split()[0] if len(line) > 1 else ""
                chunks = []
            elif line:
                chunks.append(line)
    if name is not None:
        yield name, "".join(chunks)


def read_fasta(path) -> Dict[str, str]:
    """Load the whole FASTA into a dict (chromosome name -> sequence)."""
    return dict(iter_fasta(path))


class FastaIndex:
    """Lazy per-chromosome FASTA access with optional eviction.

    Mirrors the reference's RAM-saving chromosome eviction
    (src/zero_shot_score.py:203-207) without requiring sorted input: each
    chromosome is materialised on first use and can be dropped explicitly.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._seqs: Dict[str, str] = {}
        self._loaded_all = False

    def _ensure(self, chrom: str) -> str:
        if chrom not in self._seqs:
            if self._loaded_all:
                # evicted earlier: re-stream just this chromosome
                for name, seq in iter_fasta(self.path):
                    if name == chrom:
                        self._seqs[name] = seq
                        break
            else:
                # stream everything, caching all sequences on the way
                for name, seq in iter_fasta(self.path):
                    if name not in self._seqs:
                        self._seqs[name] = seq
                self._loaded_all = True
            if chrom not in self._seqs:
                raise KeyError(chrom)
        return self._seqs[chrom]

    def __contains__(self, chrom: str) -> bool:
        try:
            self._ensure(chrom)
            return True
        except KeyError:
            return False

    def chrom_len(self, chrom: str) -> int:
        return len(self._ensure(chrom))

    def evict(self, chrom: str) -> None:
        self._seqs.pop(chrom, None)

    def window(self, chrom: str, pos0: int, length: int = 512,
               center_idx: int = 255) -> str:
        """Extract the reference-semantics window around 0-based ``pos0``."""
        return extract_window(self._ensure(chrom), pos0, length, center_idx)


def extract_window(seq: str, pos0: int, length: int = 512,
                   center_idx: int = 255) -> str:
    """Window ``[pos0-center_idx, pos0+(length-center_idx))`` over ``seq``,
    N-padded at chromosome edges per the reference rjust/ljust rules."""
    add = length - center_idx
    if pos0 - center_idx < 0:
        return seq[0 : pos0 + add].upper().rjust(length, "N")
    return seq[pos0 - center_idx : pos0 + add].upper().ljust(length, "N")
