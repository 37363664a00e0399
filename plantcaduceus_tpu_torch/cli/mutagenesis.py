"""CLI: in-silico mutagenesis pipeline steps
(reference pipelines/in-silico-mutagenesis/{1_simulation.R,2_down_sampling.py}).

  simulate    — GFF + FASTA -> VCF of every possible SNP in extended gene
                regions of one chromosome
  downsample  — class-balanced downsampling of a VEP-annotated VCF

Counterpart of ``plantcaduceus_tpu.cli.mutagenesis``, with its subcommands
and flags; host work only, plain-text VCFs out, as the JAX package writes.
Then score the VCF with cli.zero_shot_score (step 4 of the reference
workflow; VEP itself is an external annotation tool, step 2).
"""

from __future__ import annotations

import argparse
import logging

from plantcaduceus_tpu_torch.parallel.mesh import refuse_multi_rank
from plantcaduceus_tpu_torch.pipelines import mutagenesis

log = logging.getLogger(__name__)


def main(argv=None):
    refuse_multi_rank("cli.mutagenesis")
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    sim = sub.add_parser("simulate")
    sim.add_argument("-g", "--gff", required=True)
    sim.add_argument("-f", "--fasta", required=True)
    sim.add_argument("-o", "--output", required=True)
    sim.add_argument("-c", "--chr", required=True, dest="chrom")
    sim.add_argument("-k", "--flank", type=int, default=2000)
    sim.add_argument("--no-header", action="store_true")

    ds = sub.add_parser("downsample")
    ds.add_argument("input_vcf")
    ds.add_argument("output_vcf")
    ds.add_argument("--intergenic-cap", type=int, default=200_000)
    ds.add_argument("--class-cap", type=int, default=100_000)
    ds.add_argument("--seed", type=int, default=42)

    args = p.parse_args(argv)
    if args.cmd == "simulate":
        snps = mutagenesis.simulate_snps(args.fasta, args.gff, args.chrom,
                                         args.flank)
        n = mutagenesis.write_snp_vcf(args.output, args.chrom, snps,
                                      header=not args.no_header)
        log.info("Wrote %d candidate SNPs to %s", n, args.output)
    else:
        kept = mutagenesis.downsample_vep_vcf(
            args.input_vcf, args.output_vcf,
            intergenic_cap=args.intergenic_cap, class_cap=args.class_cap,
            seed=args.seed)
        log.info("Saved: %s (%s)", args.output_vcf, kept)


if __name__ == "__main__":
    main()
