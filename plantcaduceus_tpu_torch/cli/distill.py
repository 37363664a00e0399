"""CLI: distill a Caduceus teacher into a (typically faster) student, on the GPU.

Counterpart of ``plantcaduceus_tpu.cli.distill`` with its flags, plus
``--device``. The intended use is moving a pretrained Mamba-1 checkpoint
onto the SSD (``-ssd``) family, or compressing it to a smaller config:

    python -m plantcaduceus_tpu_torch.cli.distill \\
        --teacher /path/to/hf_dir \\
        --student-preset l20-ssd \\
        --dataset genome.fa --window 512 \\
        --batch-size 32 --max-steps 20000 --output-dir runs/l20_to_ssd

The objective is masked-LM distillation (``train/distill.py``): soft-target
KL at ``--temperature`` mixed with the hard MLM loss by ``--alpha``, with
``cli.pretrain``'s masking and soft-mask weights. Checkpoints go to
``--output-dir`` every ``--save-steps`` and a rerun resumes from the latest;
the student's ``final/`` is an HF checkpoint dir that the inference CLIs of
both packages load (``-model <output>/final``). A preset name as
``--teacher`` means random weights and is refused unless
``--allow-random-teacher``. Runs on CUDA unless ``--device cpu`` is given,
and fails when CUDA is asked for and absent.

Several ranks (``python -m torch.distributed.run --nproc-per-node N -m
plantcaduceus_tpu_torch.cli.distill ...``) distil over a data × fsdp mesh,
as JAX's ``MeshConfig(fsdp=--fsdp)``: the global batch (``--batch-size``
rows) splits over the ranks, ``--fsdp F`` shards the student's weights and
optimizer state over F of them, and the teacher is replicated. Rank 0
alone writes checkpoints and ``final/``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

import torch

from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
from plantcaduceus_tpu_torch.models.config import PRESETS, CaduceusConfig
from plantcaduceus_tpu_torch.parallel import mesh as meshlib
from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib
from plantcaduceus_tpu_torch.train import data as data_lib
from plantcaduceus_tpu_torch.train import distill as distill_lib
from plantcaduceus_tpu_torch.train import loop as loop_lib
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from plantcaduceus_tpu_torch.utils.device import resolve_device
from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer
from plantcaduceus_tpu_torch.utils.platform import default_device, maybe_force_platform


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--teacher", required=True,
                   help="teacher model: HF checkpoint dir (a bare preset name is "
                        "rejected unless --allow-random-teacher: it means random weights)")
    p.add_argument("--student-preset", default=None, choices=sorted(PRESETS))
    p.add_argument("--student-config", default=None,
                   help="CaduceusConfig json path (alternative to preset)")
    p.add_argument("--dataset", required=True,
                   help="synthetic | file.tsv/.csv/.parquet | genome.fa (hf: is refused)")
    p.add_argument("--seq-column", default="seq")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--window", type=int, default=512)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--max-steps", type=int, default=20000)
    p.add_argument("--temperature", type=float, default=2.0)
    p.add_argument("--alpha", type=float, default=0.5,
                   help="soft-target weight (1.0 = pure KL, 0.0 = pure MLM)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--warmup-steps", type=int, default=500)
    p.add_argument("--schedule", default="constant_with_warmup")
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--mlm-probability", type=float, default=0.15)
    p.add_argument("--soft-masked-weight", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=32)
    p.add_argument("--save-steps", type=int, default=1000)
    p.add_argument("--log-steps", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--no-remat", action="store_true")
    p.add_argument("--allow-random-teacher", action="store_true",
                   help="permit a preset (randomly initialised) teacher — for smoke "
                        "tests only")
    p.add_argument("--fsdp", type=int, default=1,
                   help="fsdp mesh axis size: the student's weights and optimizer state "
                        "sharded over that many ranks of torch.distributed.run")
    p.add_argument("--device", default=default_device(),
                   help="cuda (default; PCAD_PLATFORM=cpu makes it cpu) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    maybe_force_platform()
    logging.basicConfig(force=True, level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s",
                        datefmt="%Y-%m-%d %H:%M:%S")
    args = parse_args(argv)
    # A preset teacher resolves to random weights: distilling from noise is
    # never what a user wants.
    if not Path(args.teacher).is_dir() and not args.allow_random_teacher:
        raise SystemExit(
            f"--teacher {args.teacher!r} is a preset name, which resolves to randomly "
            "initialised weights — a distillation teacher must be a checkpoint dir "
            "(HF). Pass --allow-random-teacher to override (smoke tests only).")
    if args.student_config:
        student_cfg = CaduceusConfig.load(args.student_config)
    elif args.student_preset:
        student_cfg = CaduceusConfig.preset(args.student_preset)
    else:
        raise SystemExit("one of --student-preset / --student-config required")
    resolve_device(args.device)  # before any work: no silent CPU run
    device = meshlib.initialize_distributed(args.device)  # this rank's device
    mesh = meshlib.cli_mesh(fsdp=args.fsdp)

    teacher, teacher_cfg, tokenizer = load_model_and_tokenizer(args.teacher, seed=args.seed)
    teacher.to(device)
    student = Caduceus(student_cfg, init_params(student_cfg, seed=args.seed))
    logging.info("teacher %s -> student %s on %s", args.teacher,
                 args.student_preset or args.student_config, device)

    optimizer = make_optimizer(
        learning_rate=args.lr, schedule=args.schedule,
        warmup_steps=args.warmup_steps, total_steps=args.max_steps,
        weight_decay=args.weight_decay, grad_clip=args.grad_clip,
        params=dict(student.named_parameters()))
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    init_state, distill_step = distill_lib.make_distill_step(
        teacher_cfg, student_cfg, optimizer, student, dtype=dtype,
        temperature=args.temperature, alpha=args.alpha, remat=not args.no_remat,
        device=device, mesh=mesh)
    state = init_state()

    ckpt = ckpt_lib.CheckpointManager(args.output_dir, save_interval_steps=args.save_steps)
    if meshlib.world()[0] == 0:
        ckpt_lib.save_config(args.output_dir, student_cfg)
    if ckpt.latest_step() is not None:
        state = ckpt.restore(state)
        logging.info("Resumed from step %d", state.step)

    seqs = data_lib.sequence_source(args.dataset, seq_column=args.seq_column,
                                    window=args.window, seed=args.seed)
    train_data = data_lib.PretrainDataset(
        seqs, tokenizer, args.batch_size, soft_masked_weight=args.soft_masked_weight,
        mlm_probability=args.mlm_probability, seed=args.seed)

    state = loop_lib.run_training(
        state, lambda s, b: distill_step(s, teacher, b), None,
        train_data.iter_from(state.step), None, args.max_steps,
        log_every=args.log_steps, eval_every=0, ckpt=ckpt,
        tokens_per_step=args.batch_size * args.window)

    final_dir = Path(args.output_dir) / "final"
    if not ckpt_lib.export_final(final_dir, state, student_cfg):
        return 0
    logging.info("Exported distilled student to %s", final_dir)
    if device.type == "cuda":
        logging.info("peak device memory allocated: %d bytes",
                     torch.cuda.max_memory_allocated(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
