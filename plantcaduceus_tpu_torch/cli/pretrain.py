"""CLI: masked-LM pre-training on the GPU (the flags of the JAX CLI).

Usage (smoke run):
    python -m plantcaduceus_tpu_torch.cli.pretrain --dataset synthetic \
        --preset l20 --max-steps 20 --batch-size 8 --output-dir /tmp/run

Reproduces the reference recipe surface: 15% dynamic masking, soft-masked
(lowercase) loss down-weighting (0.1 train / 0.0 eval), AdamW
constant-with-warmup lr 2e-4 / 1k warmup, checkpoints every N steps with
autoresume from ``--output-dir``, eval + perplexity. The final weights go
to ``<output-dir>/final`` as an HF checkpoint directory that
``cli.zero_shot_score -model`` loads, with a model card (README.md: config,
dataset, final eval metrics); ``--push-to-hub`` then uploads it, and raises
one clear error where ``huggingface_hub`` or the network is missing. Runs
on CUDA unless ``--device cpu`` is given (or ``PCAD_PLATFORM=cpu`` with no
``--device``), and fails when CUDA is asked for and absent.

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.pretrain ...``) train over a data × fsdp × seq
× tensor × pipe mesh (JAX's ``MeshConfig``): ``--seq S`` shards each
window's length over S ranks (context parallelism); ``--fsdp F`` shards
the weights and both Adam moments over F ranks, each keeping its block
(ZeRO; ``train.step.FsdpParams``); ``--tensor T`` shards the mixers'
d_inner (Mamba-2: heads) over T ranks; ``--pipe P`` splits the layers into
P stages run as a GPipe schedule over ``--pipe-microbatches`` microbatches
(default P; ``train.step.ModelShards``, ``parallel.pipeline``). As in
JAX, seq does not combine with tensor, pipe combines with data and fsdp
only, and the layers must divide over pipe. The global batch
(``--batch-size`` × ``--grad-accum`` rows a step) splits over ``data ×
fsdp``. Every rank builds the same weights and batches from the seed; rank
0 alone writes checkpoints (one-process files, full tensors: a run resumes
under any layout), logs and ``final/``.

``--dataset shards:<dir-or-file>`` streams a shard directory (or one large
file) at O(buffer) memory (``train/streaming``); ``--eval-shards N`` holds
out its last N shards for evaluation. A FASTA over 256 MiB takes that path
by itself. ``--profile-dir`` writes a trace of steps 10-12 (counted from
the run's first step) there (``utils/profiling``).
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import torch

from plantcaduceus_tpu_torch.compat import model_card as card_lib
from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import PRESETS, CaduceusConfig
from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib
from plantcaduceus_tpu_torch.train import data as data_lib
from plantcaduceus_tpu_torch.train import loop as loop_lib
from plantcaduceus_tpu_torch.train import step as step_lib
from plantcaduceus_tpu_torch.train import streaming
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from plantcaduceus_tpu_torch.utils.device import resolve_device
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform

STREAM_FASTA_BYTES = 256 * 2**20  # a larger FASTA streams (the JAX CLI's threshold)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True,
                   help="synthetic | file.tsv/.csv/.parquet | genome.fa | "
                        "shards:<dir-or-file> (streaming; hf: is refused)")
    p.add_argument("--eval-dataset", default=None)
    p.add_argument("--eval-shards", type=int, default=0,
                   help="with a shards: dataset, hold out the last N shards as the "
                        "eval split (evaluated every --eval-steps)")
    p.add_argument("--seq-column", default="seq")
    p.add_argument("--preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--config", default=None, help="CaduceusConfig json path")
    p.add_argument("--resume-from", default=None,
                   help="checkpoint dir (defaults to --output-dir autoresume)")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-device microbatch (reference: 32/device)")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="gradient-accumulation microbatches per optimizer step "
                        "(reference pre-train recipe: 4 — README per-device "
                        "batch 32 x accum 4)")
    p.add_argument("--max-steps", type=int, default=120000)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup-steps", type=int, default=1000)
    p.add_argument("--schedule", default="constant_with_warmup")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--mlm-probability", type=float, default=0.15)
    p.add_argument("--soft-masked-weight-train", type=float, default=0.1)
    p.add_argument("--soft-masked-weight-eval", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=32)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--save-total-limit", type=int, default=20)
    p.add_argument("--eval-steps", type=int, default=1000)
    p.add_argument("--log-steps", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp mesh axis size: weights and optimizer state sharded over "
                        "that many ranks of torch.distributed.run")
    p.add_argument("--seq", type=int, default=1,
                   help="sequence(context)-parallel mesh axis size (ranks of "
                        "torch.distributed.run)")
    p.add_argument("--tensor", type=int, default=1,
                   help="tensor mesh axis size (the mixers' d_inner over that many ranks)")
    p.add_argument("--pipe", type=int, default=1,
                   help="pipeline-parallel mesh axis size (GPipe stages over the layer "
                        "stack; n_layer must divide by it)")
    p.add_argument("--pipe-microbatches", type=int, default=None,
                   help="GPipe microbatch count (default: --pipe; raise to shrink the "
                        "pipeline bubble, efficiency M/(M+stages-1); must divide the "
                        "folded batch rows)")
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace dir (traces steps 10-12 of the run)")
    p.add_argument("--wandb-project", default=None)
    p.add_argument("--wandb-run-name", default=None)
    p.add_argument("--push-to-hub", default=None, metavar="REPO_ID")
    p.add_argument("--device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    maybe_force_platform()
    args = parse_args(argv)
    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh(args.seq, fsdp=args.fsdp, tensor=args.tensor, pipe=args.pipe)
    rank = meshlib.world()[0]

    if args.config:
        cfg = CaduceusConfig.load(args.config)
    elif args.preset:
        cfg = CaduceusConfig.preset(args.preset)
    else:
        sys.exit("one of --preset / --config is required")

    tokenizer = DnaTokenizer()
    model = Caduceus(cfg, init_params(cfg, seed=args.seed))
    optimizer = make_optimizer(
        learning_rate=args.lr, schedule=args.schedule,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        params=dict(model.named_parameters()))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    init_state, train_step, eval_step = step_lib.make_train_step(
        cfg, optimizer, model, dtype=dtype, remat=not args.no_remat,
        grad_accum=args.grad_accum, device=device, mesh=mesh,
        pp_microbatches=args.pipe_microbatches)
    state = init_state()
    # One optimizer step consumes batch_size * grad_accum rows (over a mesh:
    # the global batch, split over the data axis).
    step_rows = args.batch_size * args.grad_accum

    ckpt = ckpt_lib.CheckpointManager(args.output_dir,
                                      save_interval_steps=args.save_steps,
                                      max_to_keep=args.save_total_limit)
    if rank == 0:
        ckpt_lib.save_config(args.output_dir, cfg)
    resume_dir = args.resume_from or args.output_dir
    resume = ckpt_lib.CheckpointManager(resume_dir) if resume_dir != args.output_dir else ckpt
    if resume.latest_step() is not None:
        state = resume.restore(state)
        logging.info("Resumed from step %d", state.step)

    dataset = args.dataset
    # A corpus-scale FASTA streams at O(chromosome) memory: the in-memory
    # source would hit its cap.
    if dataset.endswith(streaming.FASTA_SUFFIXES) and Path(dataset).is_file() \
            and Path(dataset).stat().st_size > STREAM_FASTA_BYTES:
        logging.info("large FASTA (>256MB): streaming at O(chromosome) memory (shards: path)")
        dataset = "shards:" + dataset
    eval_data = seqs = None
    if dataset.startswith("shards:"):
        shards = dataset[len("shards:"):]
        common = dict(seq_column=args.seq_column, window=args.window,
                      mlm_probability=args.mlm_probability, seed=args.seed,
                      eval_shards=args.eval_shards)
        train_data = streaming.StreamingPretrainDataset(
            shards, tokenizer, step_rows,
            soft_masked_weight=args.soft_masked_weight_train, split="train", **common)
        if args.eval_shards:
            eval_data = streaming.StreamingPretrainDataset(
                shards, tokenizer, args.batch_size,
                soft_masked_weight=args.soft_masked_weight_eval, split="eval", **common)
    else:
        seqs = data_lib.sequence_source(dataset, seq_column=args.seq_column,
                                        window=args.window, seed=args.seed)
        train_data = data_lib.PretrainDataset(
            seqs, tokenizer, step_rows,
            soft_masked_weight=args.soft_masked_weight_train,
            mlm_probability=args.mlm_probability, seed=args.seed)
    # streaming evaluates on the --eval-shards holdout, unless --eval-dataset
    eval_seqs = seqs[: max(args.batch_size, len(seqs) // 20)] if seqs is not None else None
    if args.eval_dataset:
        eval_seqs = data_lib.sequence_source(
            args.eval_dataset, split="validation", seq_column=args.seq_column,
            window=args.window, seed=args.seed + 1)
    if eval_seqs is not None:
        eval_data = data_lib.PretrainDataset(
            eval_seqs, tokenizer, args.batch_size,
            soft_masked_weight=args.soft_masked_weight_eval,
            mlm_probability=args.mlm_probability, seed=args.seed + 2)

    wandb_run = None
    if args.wandb_project:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project,
                                   name=args.wandb_run_name, resume="allow")
        except Exception as e:  # offline env: log and continue
            logging.warning("wandb unavailable: %s", e)

    # Resume data determinism: restart the stream at the restored step, so the
    # resumed run sees exactly the batches an uninterrupted run would.
    train_iter = train_data.iter_from(state.step)
    state = loop_lib.run_training(
        state, train_step, eval_step, train_iter,
        eval_data.eval_batches if eval_data is not None else None,
        args.max_steps, log_every=args.log_steps, eval_every=args.eval_steps,
        ckpt=ckpt, wandb_run=wandb_run, tokens_per_step=step_rows * args.window,
        profile_dir=args.profile_dir)

    final_metrics = None
    if eval_data is not None and args.eval_steps:
        # every rank: the eval step's collectives need them all
        final_metrics = loop_lib.evaluate(state, eval_step, eval_data.eval_batches(),
                                          max_batches=20)
        logging.info("final eval: %s", final_metrics)
    final_dir = Path(args.output_dir) / "final"
    if not ckpt_lib.export_final(final_dir, state, cfg):
        return 0
    card_lib.write_model_card(
        final_dir, cfg, tasks="fill-mask", dataset=args.dataset,
        metrics=card_lib._final_metrics_from_log(final_metrics),
        n_params=sum(p.numel() for p in state.model.parameters()))
    logging.info("Exported final params + model card to %s", final_dir)
    if args.push_to_hub:
        card_lib.push_to_hub(final_dir, args.push_to_hub)
    if device.type == "cuda":
        logging.info("peak device memory allocated: %d bytes",
                     torch.cuda.max_memory_allocated(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
