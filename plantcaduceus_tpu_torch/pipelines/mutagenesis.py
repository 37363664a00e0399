"""In-silico saturation mutagenesis pipeline (pipelines/in-silico-mutagenesis).

Counterpart of ``plantcaduceus_tpu.pipelines.mutagenesis``, copied over the
port's ``io.fasta.FastaIndex``; the same seed keeps the same lines.
Framework-native (pure Python over the io layer — no R/GenomicRanges, no
samtools/bedtools) reimplementation of:

* step 1 — SNP simulation (reference 1_simulation.R): take gene records from
  a GFF for one chromosome, extend each region by ``flank`` on both sides
  around its centre, drop regions overhanging the chromosome, enumerate all
  3 alternative alleles for every ACGT reference base, emit VCF-style rows
  sorted by position.
* step 2 — VEP consequence-balanced downsampling (reference
  2_down_sampling.py): parse CSQ=/Consequence= INFO, skip missing or
  multi-consequence ('&') records, cap intergenic_variant at 200k and every
  other class at 100k with seed 42.

Step 3 (scoring) is cli.zero_shot_score on the simulated VCF.
"""

from __future__ import annotations

import random
from collections import defaultdict
from typing import Iterator, List, Optional, Tuple

from plantcaduceus_tpu_torch.io.fasta import FastaIndex


def parse_gff_genes(gff_path, chrom: str) -> List[Tuple[int, int]]:
    """1-based inclusive (start, end) of ``type == gene`` records on chrom."""
    regions = []
    with open(gff_path) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.rstrip("\n").split("\t")
            if len(f) < 5 or f[0] != chrom:
                continue
            if f[2] == "gene":
                regions.append((int(f[3]), int(f[4])))
    return regions


def extend_regions(regions, flank: int, chrom_len: int) -> List[Tuple[int, int]]:
    """Resize around centre by +2*flank; drop regions leaving [1, chrom_len]
    (the reference's start>0 / end<=len filter, 1_simulation.R:70-77)."""
    out = []
    for start, end in regions:
        width = end - start + 1
        new_width = width + 2 * flank
        # GenomicRanges resize(fix="center"): start' = start - floor((new-old)/2)
        new_start = start - (new_width - width) // 2
        new_end = new_start + new_width - 1
        if new_start > 0 and new_end <= chrom_len:
            out.append((new_start, new_end))
    return out


def simulate_snps(fasta_path, gff_path, chrom: str,
                  flank: int = 2000) -> Iterator[Tuple[int, str, str]]:
    """Yield (pos_1based, ref, alt) for every possible SNP in the extended
    gene regions, position-sorted, 3 alts per ACGT reference base."""
    fasta = FastaIndex(fasta_path)
    seq = None
    try:
        chrom_len = fasta.chrom_len(chrom)
    except KeyError:
        raise KeyError(f"Chromosome {chrom!r} not found in the FASTA file")
    regions = extend_regions(parse_gff_genes(gff_path, chrom), flank, chrom_len)

    positions = {}
    for start, end in regions:
        window = fasta.window(chrom, start - 1, end - start + 1, 0)
        for off, base in enumerate(window):
            if base in "ACGT":
                positions[start + off] = base
    for pos in sorted(positions):
        ref = positions[pos]
        for alt in "ACGT":
            if alt != ref:
                yield pos, ref, alt


def write_snp_vcf(path, chrom: str, snps, header: bool = True) -> int:
    """Write simulated SNPs as headerless VCF rows (reference emits 7
    columns, no header — 1_simulation.R:108-127; ``header=True`` adds a
    minimal valid header so downstream tools accept the file)."""
    n = 0
    with open(path, "w") as fh:
        if header:
            fh.write("##fileformat=VCFv4.2\n")
            fh.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for pos, ref, alt in snps:
            fh.write(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t.\n")
            n += 1
    return n


def parse_consequence(info: str) -> Optional[str]:
    """First consequence of the first transcript from CSQ=/Consequence=."""
    for field in info.split(";"):
        if field.startswith("CSQ="):
            return field[4:].split(",")[0].split("|")[1]
        if field.startswith("Consequence="):
            return field.split("=", 1)[1]
    return None


def downsample_vep_vcf(input_vcf, output_vcf,
                       intergenic_cap: int = 200_000,
                       class_cap: int = 100_000,
                       seed: int = 42) -> dict:
    """Class-balanced downsampling of a VEP-annotated VCF. Returns per-class
    kept counts."""
    rng = random.Random(seed)
    header: List[str] = []
    by_class = defaultdict(list)
    with open(input_vcf) as fh:
        for line in fh:
            if line.startswith("#"):
                header.append(line)
                continue
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 8:
                continue
            cons = parse_consequence(fields[7])
            if not cons or "&" in cons:
                continue
            by_class[cons].append(line)

    kept = {}
    out_lines: List[str] = []
    inter = by_class.get("intergenic_variant", [])
    sampled = rng.sample(inter, min(len(inter), intergenic_cap))
    out_lines.extend(sampled)
    kept["intergenic_variant"] = len(sampled)
    for cons, lines in by_class.items():
        if cons == "intergenic_variant":
            continue
        if len(lines) > class_cap:
            lines = rng.sample(lines, class_cap)
        out_lines.extend(lines)
        kept[cons] = len(lines)

    with open(output_vcf, "w") as out:
        out.writelines(header)
        out.writelines(out_lines)
    return kept
