"""CLI: VCF + FASTA -> scoring TSV (the reference's src/format_VCF.sh).

Replaces the samtools/bedtools pipeline (faidx | grep | awk | bedtools slop
-l 255 -r 256 | getfasta) with framework-native windowing: for each VCF
record, a ``window``-bp sequence with the variant at 1-based position
``tokenIdx+1`` (0-based tokenIdx, default 255), written as
``chr  start  end  pos  ref  alt  sequences`` — the exact input format of
cli.zero_shot_score -input-table (reference header comment,
src/format_VCF.sh:35).

Counterpart of ``plantcaduceus_tpu.cli.format_vcf``, with its flags and
columns, over the port's ``FastaIndex`` and ``VcfReader``; host work only,
a plain-text TSV out, as the JAX package writes.

Unlike bedtools, windows overhanging chromosome edges are kept and N-padded
(matching src/zero_shot_score.py:187-198 VCF-mode semantics) instead of
being silently truncated.
"""

from __future__ import annotations

import argparse
import logging

from plantcaduceus_tpu_torch.io.fasta import FastaIndex
from plantcaduceus_tpu_torch.io.vcf import VcfReader
from plantcaduceus_tpu_torch.parallel.mesh import refuse_multi_rank

log = logging.getLogger(__name__)


def main(argv=None):
    refuse_multi_rank("cli.format_vcf")
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-input-vcf", dest="vcf", required=True)
    p.add_argument("-input-fasta", dest="fasta", required=True)
    p.add_argument("-output", dest="output", required=True)
    p.add_argument("-window", dest="window", type=int, default=512)
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=255)
    args = p.parse_args(argv)

    fasta = FastaIndex(args.fasta)
    n = 0
    prev_chrom = None
    with open(args.output, "w") as out:
        out.write("chr\tstart\tend\tpos\tref\talt\tsequences\n")
        for rec in VcfReader(args.vcf):
            if not rec.has_snv:
                continue
            seq = fasta.window(rec.chrom, rec.pos0, args.window,
                               args.token_idx)
            start = rec.pos0 - args.token_idx
            end = start + args.window
            for alt in rec.alts:
                if not rec.alt_is_snv(alt):
                    continue
                out.write(f"{rec.chrom}\t{max(start, 0)}\t{end}\t{rec.pos0}"
                          f"\t{rec.ref.upper()}\t{alt.upper()}\t{seq}\n")
                n += 1
            if prev_chrom is not None and prev_chrom != rec.chrom:
                fasta.evict(prev_chrom)
            prev_chrom = rec.chrom
    log.info("Wrote %d rows to %s", n, args.output)


if __name__ == "__main__":
    main()
