"""CLI: zero-shot SNP scoring on the GPU (the flags of the JAX CLI).

Usage:
    python -m plantcaduceus_tpu_torch.cli.zero_shot_score \
        -input-table snps.tsv -model <ckpt-or-preset> \
        -output scores.tsv [-outBED] [-batchSize 128] [-tokenIdx 255]

    python -m plantcaduceus_tpu_torch.cli.zero_shot_score \
        -input-vcf in.vcf -input-fasta genome.fa -model <ckpt> -output out.vcf

``-model`` takes an HF checkpoint directory or a preset name like ``l20``
or ``l20-ssd`` (random weights from a seeded generator). Runs on CUDA unless ``-device
cpu`` is given, and fails when CUDA is asked for and absent.

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.zero_shot_score ...``) score over a data × seq
mesh: ``-seq S`` shards each window's length over S ranks (context
parallelism), and the other ranks split each batch's rows over ``data``
(``engine.runner``). Rank 0 alone writes the output.
"""

from __future__ import annotations

import argparse
import logging
import sys

import torch

from plantcaduceus_tpu_torch.engine import zero_shot
from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.utils.device import resolve_device
from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    grp = p.add_mutually_exclusive_group(required=True)
    grp.add_argument("-input-table", dest="input_table", default=None,
                     help="TSV with columns ref, alt, sequences")
    grp.add_argument("-input-vcf", dest="input_vcf", default=None)
    p.add_argument("-input-fasta", dest="input_fasta", default=None,
                   help="FASTA (required with -input-vcf)")
    p.add_argument("-output", dest="output", required=True)
    p.add_argument("-outBED", action="store_true", dest="out_bed")
    p.add_argument("-model", dest="model", required=True,
                   help="HF checkpoint dir or preset (l20/l24/l28/l32, pc2-*, "
                        "and their Mamba-2 variants *-ssd)")
    p.add_argument("-batchSize", dest="batch_size", type=int, default=128)
    p.add_argument("-tokenIdx", dest="token_idx", type=int, default=255)
    p.add_argument("-window", dest="window", type=int, default=512)
    p.add_argument("-seq", dest="seq", type=int, default=1,
                   help="context-parallel mesh shards over the window "
                        "length (ranks of torch.distributed.run)")
    p.add_argument("-dtype", dest="dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("-device", dest="device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    p.add_argument("-no-progress", action="store_true", dest="no_progress")
    args = p.parse_args(argv)
    if args.input_vcf and not args.input_fasta:
        p.error("-input-fasta is required with -input-vcf")
    return args


def main(argv=None):
    maybe_force_platform()
    logging.basicConfig(
        force=True,
        level=logging.INFO,
        format="%(asctime)s - %(levelname)s - %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )
    args = parse_args(argv)
    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh(args.seq, "-seq")
    rank = meshlib.world()[0]

    model, cfg, tokenizer = load_model_and_tokenizer(args.model)
    runner = InferenceRunner(
        model, cfg,
        dtype=torch.float32 if args.dtype == "float32" else torch.bfloat16,
        batch_size=args.batch_size, device=device, mesh=mesh)
    progress = not args.no_progress

    if args.input_table:
        logging.info("Reading input data from %s", args.input_table)
        table = zero_shot.read_table(args.input_table)
        table = zero_shot.score_table(runner, tokenizer, table,
                                      token_idx=args.token_idx, progress=progress)
        if rank == 0:
            zero_shot.write_table(table, args.output, as_bed=args.out_bed)
    else:
        n = zero_shot.score_vcf(runner, tokenizer, args.input_vcf,
                                args.input_fasta, args.output,
                                token_idx=args.token_idx, window=args.window,
                                progress=progress)
        logging.info("Scored %d records", n)
    logging.info("Zero-shot scores saved to %s", args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
