"""Minimal VCF reader/writer — replaces PyVCF3 in the scoring pipeline.

Covers exactly what the reference uses (src/zero_shot_score.py:137-214):
iterate records, classify alt alleles as SNV or not, and re-emit records with
an added ``INFO plantCAD_zero_shot`` annotation. Gzip input supported.
"""

from __future__ import annotations

import dataclasses
import gzip
from pathlib import Path
from typing import Iterator, List, Optional

_SNV_BASES = frozenset("ACGT")


@dataclasses.dataclass
class VcfRecord:
    chrom: str
    pos: int          # 1-based, as in the file
    id: str
    ref: str
    alts: List[str]
    qual: str
    filter: str
    info: str
    rest: List[str]   # FORMAT + sample columns, verbatim

    @property
    def pos0(self) -> int:
        return self.pos - 1

    def alt_is_snv(self, alt: str) -> bool:
        """Single-nucleotide substitution: 1-base ref, 1-base ACGT alt."""
        return (
            len(self.ref) == 1
            and len(alt) == 1
            and alt.upper() in _SNV_BASES
            and self.ref.upper() in _SNV_BASES
        )

    @property
    def has_snv(self) -> bool:
        return any(self.alt_is_snv(a) for a in self.alts)

    def with_info(self, key: str, value: str) -> "VcfRecord":
        info = self.info
        if info in (".", ""):
            info = f"{key}={value}"
        else:
            info = f"{info};{key}={value}"
        return dataclasses.replace(self, info=info)

    def to_line(self) -> str:
        fields = [
            self.chrom, str(self.pos), self.id, self.ref,
            ",".join(self.alts) if self.alts else ".",
            self.qual, self.filter, self.info,
        ] + self.rest
        return "\t".join(fields)


def _open_text(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rt")
    return open(p, "r")


class VcfReader:
    """Streaming VCF reader retaining the raw header for re-emission."""

    def __init__(self, path):
        self.path = Path(path)
        self.header_lines: List[str] = []
        self._read_header()

    def _read_header(self):
        with _open_text(self.path) as fh:
            for line in fh:
                if line.startswith("#"):
                    self.header_lines.append(line.rstrip("\n"))
                else:
                    break

    def __iter__(self) -> Iterator[VcfRecord]:
        with _open_text(self.path) as fh:
            for line in fh:
                if line.startswith("#") or not line.strip():
                    continue
                yield parse_vcf_line(line)


def parse_vcf_line(line: str) -> VcfRecord:
    f = line.rstrip("\n").split("\t")
    if len(f) < 8:
        f = f + ["."] * (8 - len(f))
    alts = [] if f[4] in (".", "") else f[4].split(",")
    return VcfRecord(
        chrom=f[0], pos=int(f[1]), id=f[2], ref=f[3], alts=alts,
        qual=f[5], filter=f[6], info=f[7], rest=f[8:],
    )


class VcfWriter:
    """Writes records under the source header, declaring added INFO keys."""

    def __init__(self, path, header_lines: List[str],
                 extra_info: Optional[List[str]] = None):
        self._fh = open(path, "w")
        lines = list(header_lines)
        if extra_info:
            # Insert new ##INFO declarations before the #CHROM line.
            body = [ln for ln in lines if not ln.startswith("#CHROM")]
            chrom = [ln for ln in lines if ln.startswith("#CHROM")]
            lines = body + extra_info + chrom
        for ln in lines:
            self._fh.write(ln + "\n")

    def write(self, record: VcfRecord) -> None:
        self._fh.write(record.to_line() + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


ZERO_SHOT_INFO_HEADER = (
    '##INFO=<ID=plantCAD_zero_shot,Number=A,Type=String,'
    'Description="PlantCAD zero-shot log(P_alt/P_ref) score per alt allele">'
)
