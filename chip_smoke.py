#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plantcaduceus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``plantcaduceus_tpu_torch/csrc`` and drives the
port's paths on the card, zero-shot scoring and masked-LM pre-training with
the l20 model and with its Mamba-2 (SSD) variant l20-ssd, and the forward
and training of the ALiBi attention baseline:

1. the card: name, power limit, count;
2. build the kernels (one nvcc per source, in parallel);
3. each kernel against its plain PyTorch version at the main paths' shapes,
   both directions, fp32 and bf16, with its time on the card, the plain
   version's time and its bound: K1 (fused dt and dt given), K2 with xi
   given, K2's fuse_in variant (x [256, 512, 384] and in_proj's x half,
   and at the fine-tuning window, 8 x 600; two launches equal bit for bit;
   one call's allocations beside an xi's size; timed beside the decomposed
   route, torch.matmul for xi then K2 with xi given) and K1's combine
   epilogue at the scoring shape (l20: 256 rows x 512 x 768, N=16, R=24),
   and K1's h0/hfin options (two half-length calls chained give one call's
   bits); then (3b) K1's hb variant, K2's residual variant and K3 (fused
   and full-width dt) at the training shape (64 rows); the outputs of K2
   with xi given, K2-res, K1 and K1c at these inputs must have the SHA-256
   of the kernels before K2 fuse_in's Hopper redesign (PARENT_SHA256);
4. the full l20 forward (batch 128 windows of 512 bp, seeded weights) with
   the kernels against the plain path in fp32; K2 fuse_in launches = 2 *
   n_layer (l20's d_inner 768 takes in_proj into K2, as JAX does at d_inner
   <= 768; every l20 inference path below counts fuse_in launches, and
   xi-given K2 launches only where d_inner is wider: pc2-small);
5. a small untied and a unidirectional config through the general mixer
   path, which launches K1 (dt projected in the kernel, and outside);
5b. the PCAD_GATED_KERNEL=1 route, switched on in-process: the l20 fp32
   forward at 16 x 512 against the plain path, the bf16 forward within 2x
   the plain path's own gap, one fp32 step's gradients at l20 width, 2
   layers, 4 x 512 (K1, K1 combine; K1-hb, K3), exact launches;
6. the CLI on a seeded synthetic TSV (in-process, counted and timed, then
   ``-outBED`` through ``python -m``) and on a seeded FASTA + VCF
   (``python -m``); row counts and finite scores; windows/s;
7. device time by kernel over one l20 scoring batch (torch.profiler), K2's
   share, and the batch's peak memory with fuse_in and with xi written
   first;
8. one fp32 training step's gradients with the kernels against the plain
   path (autograd through the plain versions), l20 width, 2 layers, for the
   tied+add config (K2-res, K3), an untied one (K1-hb, K3 fused dt) and a
   unidirectional one (K1-hb, K3 full-width dt);
9. the pre-training CLI: l20 at full width and depth, batch 32 x 512 bp,
   bf16, remat, 16 steps (in-process, counted and timed); a second run
   through ``python -m`` resumes from the step-8 checkpoint and must reach
   the same step-16 weights bit for bit; the exported ``final/`` scores
   phase 6's TSV through ``python -m ...zero_shot_score``;
10. device time by kernel over one l20 training step (torch.profiler);

and the Mamba-2 (SSD) scoring path with the l20-ssd model (d_model 384, 20
layers, H 6 heads of P 128, N 128, chunk 128):

3c. K4 (``ssd_dir``) and K5 (``mamba2_mixer_interior``) against their plain
    versions at the l20-ssd scoring shape (256 rows x 512 x 768), both
    directions, fp32 and bf16, with time, plain time and bound; one timing
    row at the pc2-small-ssd width (16 rows x 8192 x 1536, H 12); and K4's
    own entry point driven once per direction at the scoring shape;
4b. the full l20-ssd forward with the kernels against the plain path in
    fp32; K5 launches = 2 * n_layer;
6b. the CLI with ``-model l20-ssd`` on phase 6's TSV (counted and timed)
    and the steady-state scoring rate;
7b. device time by kernel over one l20-ssd scoring batch (torch.profiler);

and the Mamba-2 pre-training path with l20-ssd:

3d. K4-fentry (``ssd_dir(emit_fentry=True)``), K5-res
    (``mamba2_mixer_interior(emit_residuals=True)``) and K6
    (``ssd_dir_bwd``, plain and ``pre_silu`` modes) against their plain
    versions at the l20-ssd training shape (64 rows x 512 x 768), both
    directions, fp32 and bf16, with time, plain time and bound;
8b. one fp32 training step's gradients at l20-ssd width, 2 layers, kernels
    (K5-res, K6 pre_silu) against the plain path; ``SsdDirFn``'s gradients
    (K4-fentry, K6 plain mode) against autograd through K4's plain version;
9b. phase 9 with ``--preset l20-ssd``: 16 steps, launch counts, the exact
    resume from step 8, the export scored;
10b. device time by kernel over one l20-ssd training step;

and the attention baseline, BERT at MosaicBERT-Base width and depth
(d_model 768, 12 layers, 12 heads of 64, GLU FFN 3072, ALiBi, post-norm,
tied MLM head; vocab 16, 512-bp windows, seeded weights):

3e. K7 (``flash_fwd``) and K8 (``flash_bwd``) against their plain versions
    in four bias cases (symmetric ALiBi, causal, window 128, ALiBi + window
    128), fp32 and bf16: K7 at the forward shape (128 windows x 512, H 12,
    hd 64) and both at the training shape (32 windows); the ALiBi case
    timed beside the plain version and ``scaled_dot_product_attention``
    with the ALiBi bias materialised (the library yardstick, never on the
    path), K8's time split between its dq and dk/dv kernels; then hd 16 and
    48 through ``flash_attention`` (zero-padded to 32 and 64) and hd 128
    through both wrappers, fp32 and bf16, against the plain versions; hd
    256 through both wrappers and 160 through ``flash_attention`` (padded
    to 256: the wide kernels, in 128-wide slices) at 4 x 512, H 4, timed
    beside SDPA at hd 256, and a 2-layer BERT with heads of 256 forward and
    backward (the wide kernels' path, counted); one bf16 timing row at L
    8192 (one window);
4c. the BERT-Base forward at batch 128, fp32, K7 against the einsum path;
    K7 launches = 12;
6c. the steady bf16 forward rate at batch 128, model resident;
8c. one fp32 ``mlm_loss`` gradient at BERT-Base width, 2 layers, batch 8,
    K7/K8 against autograd through the einsum path;
9c. 30 bf16 training steps at full depth, batch 32, fp32 master weights,
    the port's AdamW: the loss falls; ms per step, tokens/s, peak memory;
    K7 and K8 12 launches per step;
10c. device time by kernel over one bf16 forward batch and one training
    step, with the host-to-device copies and host synchronisations in each.

and the AR Mamba LM (``models/mamba_lm.py``, ``cli/ar_lm.py``) at the l20
widths (d_model 384, 20 layers, vocab 256, batch 32 x 512 tokens), then the
PlantCAD2 zero-shot evaluation (``cli/zero_shot_eval.py``):

11. Mamba-1 (d_state 16): the fp32 forward with K1 (dt given at full
    width) against the plain path, one fp32 ``nll_loss`` gradient (2
    layers, 4 rows) with K1-hb and K3 against autograd through the plain
    versions, ``ar_lm train`` on SURVEY.md's bytes for 20 bf16 steps
    (in-process, counted and timed: bits/dim falls), a profiled training
    step, ``python -m ... sample`` from its checkpoint (greedy, equal to the
    in-process decode), the decode rate at batch 1 and a profiled decode
    step;
11b. the same for Mamba-2 at the SSD kernels' shapes (head_dim = d_state =
    chunk = 128, 6 heads): K4 in the forward, K4-fentry and K6 in plain
    mode under grad;
12. the four ``zero_shot_eval`` subcommands with pc2-small (24 layers,
    d_model 768, random seeded weights) on seeded 8192-bp TSVs of 16 rows,
    batch 16 (in-process, counted and timed), the ``--save-logits`` /
    ``--logits-path`` round trip and a second core_noncore run through
    ``python -m`` (the same metrics exactly), the steady rate, a profiled
    batch, K2 at that shape (32 rows x 8192 x 1536) against its plain
    version with time and bound, and evo_cons with pc2-small-ssd (K5);

and the XGBoost workload, the scoring server and the input tools, with l20
(K2 on every path):

13a. seeded train/valid/test TSVs (256/128/256 windows of 512 bp): fp32
    ``center_embeddings`` with the kernels against the plain path (K2 2 x
    n_layer a batch); a hand-built binary:logistic XGBoost JSON over their
    width; ``predict_xgboost`` in-process in bf16 (counted and timed), equal
    to ``XgbJsonPredictor`` on the same runner's embeddings, then through
    ``python -m`` (the same file); ``train_xgboost -test_only`` with that
    JSON as the seed-42 model, plain and ``-save_memory -chunk_size 100``
    (equal predictions), a rerun from the caches (no launch); the fit caches
    the embeddings and then fits where sklearn or xgboost imports, and
    otherwise raises sklearn's ImportError, as the JAX package does; the
    steady embedding rate at batch 128;
13b. ``ScoringServer`` in-process on port 0: 8 client threads send 48 of
    phase 6's windows each at once, in fp32 (every reply 200, scores within
    1e-4 of ``score_table``, the forwards the batcher ran) and in bf16
    (windows/s and requests/s beside phase 6's in-process rate); then
    ``python -m ...cli.serve -model l20 -warmup`` as a subprocess: /healthz,
    one /score, /masked_probs and /embed, all 200 and finite;
13c. ``format_vcf`` on phase 6's FASTA and VCF, scored with ``-input-table``
    in fp32, equal to the VCF mode's fp32 scores within 1e-4;
    ``mutagenesis simulate`` on a seeded GFF (flank 50) scored with
    ``-input-vcf``: 3 x the ACGT bases of the extended regions, all finite.

and LoRA and full fine-tuning (``train/lora.py``, ``cli/lora_fine_tune.py``):

14a. one fp32 LoRA gradient (adapters and head; dropout 0.1, the same
    seeded masks both ways; remat) with the kernels against the plain path,
    l20 width (K1-hb and K3, dt fused) and l20-ssd width (K5-res and K6
    pre_silu), 2 layers, batch 4 x 512 bp; then ``lora_fine_tune`` with l20
    at full width and depth (a seeded random base written as an HF dir):
    ``tokenize`` to ``.npz``, ``train`` (batch 8 x grad-accum 4, bf16,
    dropout 0.1, remat, 6 steps, checkpoints at 3 and 6; in-process,
    counted and timed), ``python -m ... train --resume-from checkpoint-3``
    equal bit for bit, ``evaluate``, ``predict``, ``display`` (merged
    weights: K2), and the PEFT export (the full set refused as JAX refuses
    it; out_proj + head exported, re-imported, predicted byte-equal);
14b. K1-hb and K3 at the PlantCAD2 LoRA shape (16 rows x 600 x 1536, R 48)
    against their plain versions, timed; 3 bf16 LoRA steps of pc2-small x
    600 bp, batch 8: ms a step, windows/s, peak memory;
14c. ``train --full-finetune`` with l20, 3 steps (K2-res, K3);
14d. 3 bf16 LoRA steps of l20-ssd and an evaluation batch (K5-res, K6
    pre_silu, K5); then one profiled microbatch of an l20 LoRA step.

and the rest of training (15: sharded streaming pre-training, distillation
l20 -> l20-ssd, the planted-structure harness, a parquet evaluation table
and the GPN baseline; see ``phase_rest_of_training``), then the files
users have, read on the card's host by the port's own readers (no
safetensors, zstandard, pandas or pyarrow there):

16a. one seeded l20 state dict as ``export_hf_dir``'s pytorch_model.bin, as
    one F32 model.safetensors, as two safetensors shards with
    model.safetensors.index.json and as one BF16 model.safetensors, each
    scored in-process on phase 6's windows (the shards also through
    ``python -m``): scores equal to the .bin's byte for byte (the BF16
    file's to those of a .bin rounded to bf16), K2 2 x n_layer a batch,
    each load's seconds;
16b. l20 streaming pre-training (batch 32 x 512, bf16, remat, 3 steps)
    over the committed zstd shards JAX's ``convert_to_shards`` wrote
    (``tests/format_fixtures``) and over the same sequences re-written by
    the port's gzip writer: losses and final weights equal bit for bit,
    K2-res 80 and K3 40 a step; the zstd decoder's MB/s on the host;
16c. ``lora_fine_tune train`` with l20 (3 steps, batch 8) on the committed
    JAX-tokenized zstd tables (a scalar label; multi-label lists) and on
    the same rows as .npz: losses and adapters equal bit for bit;
    ``tokenize`` to .parquet reads back equal to .npz; an adapter exported
    as PEFT adapter_model.safetensors and run through ``evaluate`` gives
    the in-memory adapter's metrics.

and last context and data parallelism (17; ``phase_parallel``): K3 with
``g0``/``emit_dh0`` against its plain version at the seq path's local shape
(pc2-small, 8 rows x 2048 x 1536, both directions, bf16 and fp32), chained
over two halves against one call, K1-hb's first entry state equal to its
h0; then ranks of ``torch.distributed.run`` (``chip_smoke.py
--phase17-rank``) sharing ``cuda:0`` over gloo: pc2-small and
pc2-small-ssd at 4 of their 24 layers (full widths) and 8192 bp scored at
seq 4 (fp32 and bf16 logits) and
trained 3 steps at data 2 x seq 2 (fp32 and bf16; the first step's
gradients, the weights after), l20 scored with each batch's rows split
over data 2 (against one process at the rows of a rank's forward) and
trained 2 steps; each against one process on the card;
exact launches on every rank, each rank's peak memory, the seconds spent
in the collectives.

Then FSDP and the data axis on the entry points (18; ``phase_fsdp_entry``),
l20 at 512 bp on 2 ranks of ``torch.distributed.run`` (``chip_smoke.py
--phase18-rank``) sharing ``cuda:0`` over gloo, each against one process
on the card with the same weights and inputs, exact launches equal on
every rank:

18a. pre-training at ``fsdp`` 2 (8 rows, remat): 3 fp32 steps, each step's
    gradients (gathered from the blocks) and the weights after within 1e-3
    of each leaf's max, grad_norm within 1e-5 relative; a checkpoint at
    step 2 resumed under fsdp 2 gives step 3's weights bit for bit, and in
    one process within the fp32 gate; what a rank holds between steps; 1
    bf16 step timed; peak memory a rank (K2-res, K3);
18b. distillation l20 -> l20-ssd at fsdp 2, 2 fp32 steps gated the same way
    (K2, K5-res, K6 pre_silu);
18c. ``lora_fine_tune train`` on 2 data ranks (8 rows, fp32, dropout 0, 2
    steps): the adapters within 1e-3; ``predict`` byte-equal (K1-hb, K3,
    K2);
18d. ``predict_xgboost`` on 2 data ranks at batch 16: the embeddings and
    the output equal bit for bit to one process at batch 8, the rows of a
    rank's forward (K2);
18e. ``python -m torch.distributed.run ... cli.serve -model l20 -seq 2`` on
    a free port: /score and /embed within 1e-5 of the in-process one-rank
    service; SIGTERM to the leader, and every rank exits 0.

Then tensor and pipeline parallelism for pre-training (19;
``phase_tensor_pipe``), l20 and l20-ssd at full width and depth, batch 8 x
512 bp, on 2 ranks of ``torch.distributed.run`` (``chip_smoke.py
--phase19-rank``) sharing ``cuda:0`` over gloo, each against one process
on the card with the same weights and batches: K1-hb, K3, K4-fentry and K6
(plain mode) against their plain versions at a tensor rank's shapes (d_inner
384; 3 heads of 128); 19a ``tensor`` 2 for l20 (K1-hb, K3 on the decomposed
mixer) and l20-ssd (K4-fentry, K6 plain), 19b ``pipe`` 2 with 4
microbatches for l20 (K2-res, K3 on a stage's 10 layers): 3 fp32 steps,
each step's gradients within 1e-5 of each leaf's max, grad_norm within
1e-5 relative, the weights after within 1e-3, the step-2 checkpoint
resumed in one process within 1e-4 after step 3; 2 bf16 steps, the second
timed; exact launches on every rank.

Inputs and outputs of phases 6, 9, 9b, 11, 11b, 12, 13, 14, 15, 16, 17,
18 and 19 go to ``build/chip_smoke/`` in the checkout.

Every phase logs its seconds (``phase N ok in X s``). The script keeps its
own clock: a deadline ``DEADLINE_S`` (1100 s) after it starts, checked
before every phase; each multi-rank job waits at most the smaller of its
cap and the time left, and its ranks' process groups time out after
``RANK_TIMEOUT_S`` (90 s), so a rank stuck in a collective raises inside
its job and the script fails with the phase named. Every failure exits
non-zero; no phase's failure is caught. Without CUDA it exits 1 and prints
no result. The last two lines of standard output are the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM 3.35 TB/s, fp32 67 TFLOP/s outside
# the tensor cores. Special-function unit (exp2/exp/log) rate: 16 results per
# clock per SM on compute capability 9.0 (CUDA C++ Programming Guide,
# arithmetic instruction throughput) x 132 SMs x 1.98 GHz boost clock.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OPS_S = 16 * 132 * 1.98e9
BF16_TC_FLOP_S = 989e12  # dense bf16 tensor-core products

# Kernel vs plain version. float32: only the order of sums differs (the
# x_proj reduction over D=768, the dt projection, the C readout over N, 512
# steps); 1e-3 of the output's scale. bfloat16: both round the fp32 result
# to 8 mantissa bits, so one bf16 step of the output's scale (2**-7).
TOL = {"float32": 1e-3, "bfloat16": 2 ** -7}
FORWARD_TOL = 1e-3  # l20 logits, fp32, 20 layers: relative to max |logit|
# Float32 outputs computed from the same inputs by kernel and plain version
# (K3's gradients, the hb states, K2's dt_lr/B/C), whatever the input dtype:
# only the order of sums differs (over 768 channels, 512 steps, 64 rows).
F32_TOL = 1e-3
# One fp32 training step, kernels vs plain path (phase 8): every parameter's
# gradient within this fraction of its max |gradient|.
GRAD_TOL = 1e-3
TRAIN_ROWS = 64  # l20 training batch: 32 windows plus their RC stream
FT_WINDOW = (8, 600)  # fine-tuning's microbatch rows and window (phase 14)

# SHA-256 (first 16 hex digits) of the outputs of K2 with xi given, K2-res,
# K1 and K1c at phases 3 and 3b's seeded inputs, as the kernels gave them
# before K2 fuse_in's Hopper redesign (that tree's kernels under this
# script's record_digest, on an NVIDIA H100 80GB HBM3 with torch 2.11.0+cu128,
# whose seeded randn makes the inputs): the redesign leaves these kernels'
# code paths, and so their bits, as they were.
PARENT_SHA256 = {
    "K1 bfloat16 fuse=0 fwd": "ffc239117c3d5f53",
    "K1 bfloat16 fuse=0 rev": "4cd18206532fa9b5",
    "K1 bfloat16 fuse=1 fwd": "1685ab6e9f22a51b",
    "K1 bfloat16 fuse=1 rev": "f85f0ecd90814442",
    "K1 float32 fuse=0 fwd": "e5b78278ebd4ba8d",
    "K1 float32 fuse=0 rev": "755570c6d87499b6",
    "K1 float32 fuse=1 fwd": "890539cb13462471",
    "K1 float32 fuse=1 rev": "b1dadb8bf2b5d4af",
    "K1c bfloat16 fwd": "e50de71ac1b822ab",
    "K1c bfloat16 rev": "e5d7331e80ac3dd0",
    "K1c float32 fwd": "4953125d3d66fe2f",
    "K1c float32 rev": "2c363cd9234402ad",
    "K2 bfloat16 fwd": "17e454efe8acef26",
    "K2 bfloat16 rev": "f10981be48982165",
    "K2 float32 fwd": "cd4df3e6742ca1bd",
    "K2 float32 rev": "4d37886018d29725",
    "K2-res bfloat16 fwd": "bc83edb8b1937d76",
    "K2-res bfloat16 rev": "f473b6e8e489ac81",
    "K2-res float32 fwd": "ba4b89d052a11987",
    "K2-res float32 rev": "49d907fe019eda5a",
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


# The script's own clock: a deadline DEADLINE_S after main() starts, checked
# before every phase; the multi-rank jobs' waits are clipped to it, and their
# process groups time out after RANK_TIMEOUT_S, so a stuck collective fails
# the script with its phase named before an outer time limit stops it.
DEADLINE_S = 1100.0
RANK_TIMEOUT_S = 90.0
_clock = {"deadline": None}


def time_left() -> float:
    """Seconds before the script's deadline (inf before main() sets it)."""
    at = _clock["deadline"]
    return math.inf if at is None else at - time.perf_counter()


def check_clock(phase: str) -> None:
    if time_left() <= 0:
        fail(f"the script's deadline of {DEADLINE_S:.0f} s passed before phase {phase}")


def run_phase(phase: str, fn, *args, **kw):
    """``fn(*args, **kw)`` as phase ``phase``: the clock checked before it,
    its seconds logged after it."""
    check_clock(phase)
    t = time.perf_counter()
    out = fn(*args, **kw)
    log(f"phase {phase} ok in {time.perf_counter() - t:.1f} s")
    return out


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, want, dtype_name, tol=None):
    """Max abs and max relative (to max |want|) error; fail past tolerance."""
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = d / scale if scale else d
    tol = TOL[dtype_name] if tol is None else tol
    log(f"  {name:<34} max_abs_err={d:.3e} max_rel_err={rel:.3e} (tol {tol:.1e} rel)")
    if not (math.isfinite(d) and rel <= tol):
        fail(f"{name}: kernel disagrees with its plain version (rel {rel:.3e} > {tol:.1e})")
    return d


def time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes, flops, sfu_ops, tc_flops=0.0):
    """The least time for the work: the largest of bytes over the memory
    rate, fp32 flops over the fp32 rate, special-function ops over their
    rate and bf16 product flops (``tc_flops``) over the tensor cores' rate."""
    t = {"bytes": nbytes / HBM_BYTES_S, "flops": flops / FP32_FLOP_S,
         "sfu": sfu_ops / SFU_OPS_S, "tc": tc_flops / BF16_TC_FLOP_S}
    kind = max(t, key=t.get)
    return t[kind] * 1e3, ("bytes" if kind == "bytes" else "operations"), t


_digests = {}


def record_digest(name, out):
    """Keep the SHA-256 (first 16 hex digits) of the bytes of every tensor
    of ``out`` under ``name``, for the parent-bits check."""
    import torch

    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy())
    _digests[name] = h.hexdigest()[:16]


def check_parent_digests():
    """K2 (xi given), K2-res, K1 and K1c at phases 3 and 3b's inputs give
    the parent tree's bits."""
    got = _digests
    differ = sorted(k for k in PARENT_SHA256 if got.get(k) != PARENT_SHA256[k])
    missing = sorted(set(got) ^ set(PARENT_SHA256))
    log(f"  parent bits: {len(got)} outputs of K2 (xi given), K2-res, K1 and K1c hashed; "
        f"{len(got) - len(differ)} equal the parent's SHA-256")
    if differ or missing or not got:
        fail(f"outputs differ from the parent's bits: {differ or missing or 'none hashed'} "
             f"(got {got})")


def layer_weights(cfg, seed, dev):
    """One layer's weights from the model's own initialiser, on the card."""
    import dataclasses

    from plantcaduceus_tpu_torch.models.caduceus import init_params

    blocks = init_params(dataclasses.replace(cfg, n_layer=1), seed=seed)["blocks"]
    return {k: v[0].to(dev) for k, v in blocks.items()}


# ---------------------------------------------------------------------------


def phase_card():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()
    log("phase 1: card")
    log(smi[0])
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi[0]


def phase_build():
    from plantcaduceus_tpu_torch.ops import cuda_build

    log("phase 2: build kernels")
    t = time.perf_counter()
    paths = cuda_build.build_all()
    log(f"  built {sorted(p.name for p in paths.values())} in {time.perf_counter() - t:.1f} s "
        f"(each nvcc: {', '.join(f'{n} {v:.1f}' for n, v in cuda_build.build_seconds.items())} s)")
    for name, rep in cuda_build.ptxas_reports.items():
        regs = sorted({ln.split("Used ")[1].split(" registers")[0]
                       for ln in rep.splitlines() if "registers" in ln})
        spills = sorted({ln.strip() for ln in rep.splitlines()
                         if "spill" in ln and not ln.strip().startswith("0 bytes stack")})
        log(f"  {name}: registers per thread {regs}; spills {spills or 'none'}")


def phase_kernels(cfg, dev):
    """Each kernel against its plain version at the l20 shapes; timings."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    log("phase 3: kernels vs plain versions (l20 shapes)")
    rows, L = 256, 512
    D, N, R, K = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    w = layer_weights(cfg, 1, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"mixer_fwd": {"err": 0.0}, "scan_fwd": {"err": 0.0}}

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        xi = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        for g in (0, 1):
            args = (xi, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g],
                    w["x_proj_B"][g], w["x_proj_C"][g], w["dt_proj_w"][g],
                    w["dt_proj_b"][g], A[g], w["D"][g])
            got = cuda_mixer.mixer_fwd(*args, reverse=g == 1)
            want = cuda_mixer.mixer_fwd_plain(*args, reverse=g == 1)
            torch.cuda.synchronize()
            res["mixer_fwd"]["err"] = max(res["mixer_fwd"]["err"], compare(
                f"K2 mixer_fwd {dn} {'rev' if g else 'fwd'}", got, want, dn))
            record_digest(f"K2 {dn} {'rev' if g else 'fwd'}", got)
            del got, want
            if dtype == torch.bfloat16 and g == 1:
                res["mixer_fwd"]["ms"] = time_ms(
                    lambda: cuda_mixer.mixer_fwd(*args, reverse=True), 10)
                res["mixer_fwd"]["plain_ms"] = time_ms(
                    lambda: cuda_mixer.mixer_fwd_plain(*args, reverse=True), 2, warmup=1)
                res["mixer_fwd"]["bound"] = bound_ms(*mixer_fwd_work(rows, L, D, N, R, K,
                                                                    xi.element_size()))

        kernel_options_fuse_in(cfg, w, A, rows, L, dtype, dev, gen, res)

        x = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        Bm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
        Cm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
        kernel_options_combine(x, Bm, Cm, A, w, rows, L, R, dtype, dev, gen, res)
        for fuse in (True, False):
            dt = (torch.randn((rows, L, R if fuse else D), generator=gen, device=dev)
                  * 0.5).to(dtype)
            wdt = w["dt_proj_w"][0] if fuse else None
            for rev in (False, True):
                args = (x, dt, A[0], Bm, Cm, w["D"][0], w["dt_proj_b"][0], wdt)
                got = cuda_scan.scan_fwd(*args, reverse=rev)
                want = cuda_scan.scan_fwd_plain(*args, reverse=rev)
                torch.cuda.synchronize()
                res["scan_fwd"]["err"] = max(res["scan_fwd"]["err"], compare(
                    f"K1 scan_fwd {dn} fuse={int(fuse)} {'rev' if rev else 'fwd'}",
                    got, want, dn))
                record_digest(f"K1 {dn} fuse={int(fuse)} {'rev' if rev else 'fwd'}", got)
                del got, want
                if dtype == torch.bfloat16 and rev:
                    # fused dt in the contract's keys, dt given beside it
                    r = res["scan_fwd"] if fuse else res["scan_fwd"].setdefault("dt_given", {})
                    r["ms"] = time_ms(lambda: cuda_scan.scan_fwd(*args, reverse=True), 10)
                    r["plain_ms"] = time_ms(
                        lambda: cuda_scan.scan_fwd_plain(*args, reverse=True), 2, warmup=1)
                    r["bound"] = bound_ms(*scan_fwd_work(rows, L, D, N, R if fuse else 0,
                                                         x.element_size()))
                if dtype == torch.bfloat16 and fuse:
                    scan_chain_check(args, rev, L // 2)
    for name, r in [*res.items(), ("scan_fwd dt given", res["scan_fwd"]["dt_given"])]:
        b, by, parts = r["bound"]
        log(f"  {name} (bf16, one direction): {r['ms']:.3f} ms; plain {r['plain_ms']:.1f} ms; "
            f"bound {b:.3f} ms by {by} (bytes {parts['bytes'] * 1e3:.3f}, fp32 flops "
            f"{parts['flops'] * 1e3:.3f}, sfu {parts['sfu'] * 1e3:.3f}, bf16 tensor cores "
            f"{parts['tc'] * 1e3:.3f} ms)")
        if "float32" in r:
            f = r["float32"]
            log(f"    {name} fp32: {f['ms']:.3f} ms; plain {f['plain_ms']:.1f} ms; bound "
                f"{f['bound'][0]:.3f} ms by {f['bound'][1]}"
                + (f"; decomposed {f['decomposed_ms']:.3f} ms" if "decomposed_ms" in f else ""))
    return res


def kernel_options_fuse_in(cfg, w, A, rows, L, dtype, dev, gen, res):
    """K2's fuse_in variant at the l20 scoring shape (x [rows, L, d_model],
    in_proj's x half [d_model, d_inner]) and at the fine-tuning window (8 x
    600, its own generator), both directions, against its plain version,
    two launches equal bit for bit; in bf16 (and fp32 beside it) its time
    beside the decomposed route's (torch.matmul for xi in x's dtype, then K2
    with xi given), the plain version's and the bound; the call's
    allocations beside one [rows, L, d_inner] xi."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_mixer

    dn = str(dtype).split(".")[1]
    D, N, R, K, Dm = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv, cfg.d_model
    w_in = w["in_proj_x"][0]
    r = res.setdefault("mixer_fwd_x", {"err": 0.0})

    def check(x, tag):
        for g in (0, 1):
            args = (x, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                    w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g])
            got = cuda_mixer.mixer_fwd(*args, reverse=g == 1, w_in=w_in)
            again = cuda_mixer.mixer_fwd(*args, reverse=g == 1, w_in=w_in)
            want = cuda_mixer.mixer_fwd_plain(*args, reverse=g == 1, w_in=w_in)
            torch.cuda.synchronize()
            name = f"K2 fuse_in {dn} {tag}{'rev' if g else 'fwd'}"
            r["err"] = max(r["err"], compare(name, got, want, dn))
            if not torch.equal(got, again):
                fail(f"{name}: two launches differ")
            del got, again, want
        return args

    ft = torch.Generator(device=dev).manual_seed(20)
    check(torch.randn(FT_WINDOW + (Dm,), generator=ft, device=dev).to(dtype),
          f"{FT_WINDOW[0]}x{FT_WINDOW[1]} ")
    x = torch.randn((rows, L, Dm), generator=gen, device=dev).to(dtype)
    args = check(x, "")
    t = r if dtype == torch.bfloat16 else r.setdefault("float32", {})
    t["ms"] = time_ms(lambda: cuda_mixer.mixer_fwd(*args, reverse=True, w_in=w_in), 5)
    w_x = w_in.to(dtype)
    t["decomposed_ms"] = time_ms(
        lambda: cuda_mixer.mixer_fwd(torch.matmul(x, w_x), *args[1:], reverse=True), 5)
    t["plain_ms"] = time_ms(lambda: cuda_mixer.mixer_fwd_plain(*args, reverse=True, w_in=w_in),
                            1, warmup=1)
    work = mixer_fwd_x_work(rows, L, Dm, D, N, R, K, x.element_size())
    t["bound"] = (bound_ms(*work) if dtype == torch.bfloat16
                  else bound_ms(work[0], work[1] + work[3], work[2]))
    log(f"  K2 fuse_in {dn}: {t['ms']:.3f} ms; decomposed route (torch.matmul for xi, then K2 "
        f"with xi given) {t['decomposed_ms']:.3f} ms in the same call")
    # what one call allocates: y, the x_proj rows, the weights' copies; no xi
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    y = cuda_mixer.mixer_fwd(*args, reverse=True, w_in=w_in)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated(dev) - base
    xi_bytes = rows * L * D * x.element_size()
    allowed = (y.numel() * y.element_size() + rows * L * (R + 2 * N) * 4
               + D * (128 * 4 + Dm * x.element_size()) + 2 ** 20)
    log(f"  K2 fuse_in {dn}: one call allocates {extra} bytes (y {y.numel() * y.element_size()}, "
        f"x_proj rows {rows * L * (R + 2 * N) * 4}); an xi would be {xi_bytes}")
    if extra > allowed:
        fail(f"K2 fuse_in allocated {extra} bytes, more than y, its scratch and the weights "
             f"({allowed}): an xi-sized buffer?")
    del x, y


def kernel_options_combine(x, Bm, Cm, A, w, rows, L, R, dtype, dev, gen, res):
    """K1 with the combine epilogue (y_prev, z) at the l20 scoring shape,
    fused dt, both directions, against its plain version; its bf16 time
    (fp32 beside), the plain version's and the bound."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_scan

    dn = str(dtype).split(".")[1]
    D, N = x.shape[-1], Bm.shape[-1]
    r = res.setdefault("scan_fwd_combine", {"err": 0.0})
    dt = (torch.randn((rows, L, R), generator=gen, device=dev) * 0.5).to(dtype)
    y_prev, z = (torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
                 for _ in range(2))
    args = (x, dt, A[1], Bm, Cm, w["D"][1], w["dt_proj_b"][1], w["dt_proj_w"][1])
    for rev in (False, True):
        got = cuda_scan.scan_fwd(*args, reverse=rev, y_prev=y_prev, z=z)
        want = cuda_scan.scan_fwd_plain(*args, reverse=rev, y_prev=y_prev, z=z)
        torch.cuda.synchronize()
        r["err"] = max(r["err"], compare(f"K1 combine {dn} {'rev' if rev else 'fwd'}", got,
                                         want, dn))
        record_digest(f"K1c {dn} {'rev' if rev else 'fwd'}", got)
        del got, want
    t = r if dtype == torch.bfloat16 else r.setdefault("float32", {})
    t["ms"] = time_ms(lambda: cuda_scan.scan_fwd(*args, reverse=True, y_prev=y_prev, z=z), 5)
    t["plain_ms"] = time_ms(
        lambda: cuda_scan.scan_fwd_plain(*args, reverse=True, y_prev=y_prev, z=z), 1, warmup=1)
    nbytes, flops, sfu = scan_fwd_work(rows, L, D, N, R, x.element_size())
    # + y_prev and z read; the sum, the gate's product and sigmoid
    t["bound"] = bound_ms(nbytes + 2 * rows * L * D * x.element_size(),
                          flops + 5 * rows * L * D, sfu + rows * L * D)


def scan_chain_check(args, rev, split):
    """K1's carry options at the scan's own shapes: the sequence in two
    calls chained hfin -> h0 (the later part first for ``rev``) gives the
    one-call y and final state bit for bit."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_scan

    x, dt, A, Bm, Cm, Dskip, dt_bias, wdt = args
    L = x.shape[1]
    full_y, full_h = cuda_scan.scan_fwd(*args, reverse=rev, emit_hfin=True)
    spans = [(split, L), (0, split)] if rev else [(0, split), (split, L)]
    h, ys = None, {}
    for a, b in spans:
        part = [t[:, a:b].contiguous() for t in (x, dt, Bm, Cm)]
        ys[a], h = cuda_scan.scan_fwd(part[0], part[1], A, part[2], part[3], Dskip, dt_bias, wdt,
                                      reverse=rev, h0=h, emit_hfin=True)
    same = torch.equal(torch.cat([ys[0], ys[split]], 1), full_y) and torch.equal(h, full_h)
    log(f"  K1 h0/hfin {'rev' if rev else 'fwd'}: {split} + {L - split} steps chained "
        f"{'equal' if same else 'DIFFER from'} one call bit for bit")
    if not same:
        fail("K1's chained halves differ from the one-call scan")


def phase_train_kernels(cfg, dev):
    """The training kernels against their plain versions at the l20
    training shape (batch 32 + RC = 64 rows x 512 x 768, N=16, R=24): K1's
    hb variant, K2's residual variant, K3 with fused (mixer path) and
    full-width dt; both directions, fp32 and bf16; timings."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    log(f"phase 3b: training kernels vs plain versions ({TRAIN_ROWS} rows x 512 x "
        f"{cfg.d_inner}, hb chunk {HB_CHUNK})")
    rows, L = TRAIN_ROWS, 512
    D, N, R, K = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    J = R + 2 * N
    nhb = -(-L // HB_CHUNK)
    pts = rows * L * D
    hb_bytes = 4 * rows * nhb * D * N
    w = layer_weights(cfg, 5, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(7)
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}}
           for k in ("scan_fwd_hb", "mixer_fwd_res", "scan_bwd")}
    for k in ("mixer_fwd_res", "scan_bwd"):
        res[k]["split_ms"] = {}

    def cmp(kernel, name, got, want, tol):
        res[kernel]["err"] = max(res[kernel]["err"], compare(name, got, want, None, tol))

    def timed(kernel, dn, fn, plain, nbytes, flops, sfu):
        res[kernel]["ms"][dn] = time_ms(fn, 10)
        res[kernel]["plain_ms"][dn] = time_ms(plain, 1, warmup=1)
        res[kernel]["bound"][dn] = bound_ms(nbytes, flops, sfu)
        if "split_ms" in res[kernel]:
            res[kernel]["split_ms"][dn] = device_ms_by_kernel(fn)

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.empty((), dtype=dtype).element_size()
        x = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        gy = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)

        # K1 hb: y in x's dtype, hb float32.
        Bm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
        Cm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
        for fuse in (True, False):
            dt = (torch.randn((rows, L, R if fuse else D), generator=gen, device=dev)
                  * 0.5).to(dtype)
            wdt = w["dt_proj_w"][0] if fuse else None
            for rev in (False, True):
                args = (x, dt, A[0], Bm, Cm, w["D"][0], w["dt_proj_b"][0], wdt, rev)
                y, hb = cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK)
                y_p, hb_p = cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK)
                torch.cuda.synchronize()
                tag = f"fuse={int(fuse)} {'rev' if rev else 'fwd'}"
                cmp("scan_fwd_hb", f"K1-hb y {dn} {tag}", y, y_p, TOL[dn])
                cmp("scan_fwd_hb", f"K1-hb hb {dn} {tag}", hb, hb_p, F32_TOL)
                if not fuse:  # K3, full-width dt (the general path's G=1 mode)
                    got = cuda_scan.scan_bwd(x, gy, *args[1:7], hb, None, rev)
                    want = cuda_scan.scan_bwd_plain(x, gy, *args[1:7], hb, None, rev)
                    torch.cuda.synchronize()
                    for n, g_, w_ in zip(("dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD"),
                                         got, want):
                        cmp("scan_bwd", f"K3 {n} {dn} full-width dt {tag}", g_, w_, F32_TOL)
                if fuse and rev:
                    timed("scan_fwd_hb", dn,
                          lambda: cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK),
                          lambda: cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK),
                          *scan_fwd_work(rows, L, D, N, R, s, HB_CHUNK))

        # K2-res: y and acc in xi's dtype; dt_lr | B | C and hb float32.
        for g in (0, 1):
            margs = (x, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                     w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g],
                     g == 1)
            got = cuda_mixer.mixer_fwd(*margs, emit_res=True)
            want = cuda_mixer.mixer_fwd_plain(*margs, emit_res=True)
            torch.cuda.synchronize()
            d = "rev" if g else "fwd"
            for n, g_, w_ in zip(("y", "acc", "dt_lr", "B", "C", "hb"), got, want):
                cmp("mixer_fwd_res", f"K2-res {n} {dn} {d}", g_, w_,
                    TOL[dn] if n in ("y", "acc") else F32_TOL)
            record_digest(f"K2-res {dn} {d}", got)
            if g == 1:
                timed("mixer_fwd_res", dn,
                      lambda: cuda_mixer.mixer_fwd(*margs, emit_res=True),
                      lambda: cuda_mixer.mixer_fwd_plain(*margs, emit_res=True),
                      3 * s * pts + 4 * rows * L * J + hb_bytes
                      + 4 * (D * (K + 1 + J + N + 2) + R * D),
                      pts * (2 * K + 2 * J + 2 * R + 6 * N + 10), pts * (N + 3))

            # K3 on the mixer's residuals (fused dt; dt_lr/B/C float32 views
            # of one buffer), as BimambaMixerFn calls it.
            xg, dt_lr, Bm_r, Cm_r, hb = x, got[2], got[3], got[4], got[5]
            kargs = (xg, gy, dt_lr, A[g], Bm_r, Cm_r, w["D"][g], w["dt_proj_b"][g], hb,
                     w["dt_proj_w"][g], g == 1)
            kgot = cuda_scan.scan_bwd(*kargs)
            kwant = cuda_scan.scan_bwd_plain(*kargs)
            torch.cuda.synchronize()
            for n, g_, w_ in zip(("dx", "ddt_lr", "dB", "dC", "dA", "ddt_bias", "dD", "dW"),
                                 kgot, kwant):
                cmp("scan_bwd", f"K3 {n} {dn} fused dt {d}", g_, w_, F32_TOL)
            if g == 1:
                timed("scan_bwd", dn, lambda: cuda_scan.scan_bwd(*kargs),
                      lambda: cuda_scan.scan_bwd_plain(*kargs),
                      *scan_bwd_work(rows, L, D, N, R, s))

    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, one direction): {r['ms'][dn]:.3f} ms; plain "
                f"{r['plain_ms'][dn]:.1f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, "
                f"sfu {parts['sfu'] * 1e3:.3f} ms){split_note(r, dn)}")
    return res


def split_note(r, dn):
    """The per-kernel split of a timed call, for its log line."""
    split = r.get("split_ms", {}).get(dn)
    if not split:
        return ""
    return "; by kernel " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()) + " ms"


def mixer_fwd_work(rows, L, D, N, R, K, s):
    """K2's inference variant: (bytes, fp32 flops, SFU ops) for xi in, y out
    (``s`` bytes each) and the float32 weights read once."""
    J = R + 2 * N
    nbytes = 2 * rows * L * D * s + 4 * (D * (K + 1 + J + N + 2) + R * D)
    pts = rows * L * D
    flops = pts * (2 * K + 2 * J + 2 * R + 6 * N + 10)
    sfu = pts * (N + 3)  # exp2 per state; silu exp; softplus exp+log1p
    return nbytes, flops, sfu


def mixer_fwd_x_work(rows, L, Dm, D, N, R, K, s):
    """K2's fuse_in variant: (bytes, fp32 flops, SFU ops, in_proj product
    flops) for x [rows, L, Dm] in, y out (``s`` bytes each), w_in in ``s``
    bytes and the float32 weights read once; the in_proj x w_in once."""
    nbytes, flops, sfu = mixer_fwd_work(rows, L, D, N, R, K, s)
    nbytes += rows * L * (Dm - D) * s + D * Dm * s
    return nbytes, flops, sfu, 2 * rows * L * Dm * D


def scan_fwd_work(rows, L, D, N, R, s, hbc=None):
    """What one direction of K1 must do, counted from the shapes: bytes
    (x, dt, B, C read once in ``s`` bytes, y written once; A, Dskip,
    dt_bias and W_dt float32; with ``hbc`` the float32 states every
    ``hbc`` steps), fp32 flops and special-function ops (per state its
    exp2; per (step, channel) softplus's exp and log1p). ``R`` is the dt
    rank when dt is fused, 0 when dt is given at full width."""
    pts = rows * L * D
    nbytes = s * rows * L * (2 * D + (R or D) + 2 * N) + 4 * (D * (N + 2) + R * D)
    if hbc:
        nbytes += 4 * rows * -(-L // hbc) * D * N
    return nbytes, pts * (2 * R + 6 * N + 10), pts * (N + 2)


def scan_bwd_work(rows, L, D, N, R, s, hbc=16):
    """What one direction of K3 with fused dt must do, counted from the
    shapes: bytes (each input read once, each output written once; x and
    gy in ``s`` bytes, the residuals and outputs float32), fp32 flops and
    special-function ops. Per state the one exp2 of its decay and ~18 fp32
    flops (recompute 3, adjoint 13, the dB/dC sums over channels 2); per
    (step, channel) softplus + sigmoid (3 SFU) and the dt projection, its
    transpose and dW (6R flops)."""
    pts, J = rows * L * D, R + 2 * N
    hb_bytes = 4 * rows * -(-L // hbc) * D * N
    nbytes = 2 * s * pts + 4 * pts + 8 * rows * L * J + hb_bytes + 8 * (D * N + 2 * D + R * D)
    return nbytes, pts * (18 * N + 6 * R + 12), pts * (N + 3)


def ssd_work(R, L, H, NG, s, K=4, mixer=False):
    """What one direction of K4 (or, with ``mixer``, K5) must do, counted
    from the shapes (P = N = chunk = 128): bytes (each input read once, each
    output written once, ``s`` bytes an activation), fp32 elementwise flops,
    special-function ops, and the flops of the four products (C @ B^T once
    per group, the other three per head)."""
    P = N = T = 128
    di, NGN = H * P, NG * N
    rows, nc = R * L, L // T
    head_chunks = R * nc * H
    prod = R * nc * (NG * 2 * T * T * N + H * 3 * 2 * T * T * P)
    # per score: the masked difference and the product (exp2 on the SFU);
    # per (step, head): softplus and three exp2 decays
    scores_ew, scores_sfu = 3 * head_chunks * T * T, head_chunks * T * T
    if mixer:  # + conv of x|B|C (2K flops) and SiLU; gate and norm over di
        nbytes = (s * rows * (3 * di + 2 * NGN + H)
                  + 4 * (di * (K + 2) + 2 * NGN * (K + 1) + 3 * H))
        ew = rows * (2 * K * (di + 2 * NGN) + 12 * di + 10 * H) + scores_ew
        sfu = rows * (2 * di + 2 * NGN + 5 * H) + scores_sfu
    else:
        nbytes = s * rows * (2 * di + 2 * NGN + H) + 4 * 3 * H
        ew = rows * (6 * di + 10 * H) + scores_ew
        sfu = rows * 5 * H + scores_sfu
    return nbytes, ew, sfu, prod


def work_bound(work, dtype_name):
    """The bound of ``(bytes, fp32 elementwise flops, SFU ops, product
    flops)``: in bf16 the products run on the tensor cores, in fp32 on the
    fp32 cores."""
    nbytes, ew, sfu, prod = work
    if dtype_name == "bfloat16":
        return bound_ms(nbytes, ew, sfu, tc_flops=prod)
    return bound_ms(nbytes, ew + prod, sfu)


def ssd_inputs(cfg, R, L, dtype, dev, gen, seed):
    """Seeded activations at one layer's shapes and that layer's weights
    from the model's initialiser: K5's 15 arguments and K4's 7."""
    import torch

    H, di, NGN = cfg.n_heads, cfg.d_inner, cfg.n_groups * cfg.d_state
    w = layer_weights(cfg, seed, dev)
    A = -torch.exp(w["A_log"])

    def r(*shape, sc=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * sc).to(dtype)

    xi, z, Braw, Craw, dt = r(R, L, di), r(R, L, di), r(R, L, NGN), r(R, L, NGN), r(R, L, H)
    Bm = r(R, L, cfg.n_groups, cfg.d_state, sc=0.5)
    Cm = r(R, L, cfg.n_groups, cfg.d_state, sc=0.5)

    def mixer(g):
        return (xi, z, Braw, Craw, dt, w["conv_x_w"][g], w["conv_x_b"][g], w["conv_B_w"][g],
                w["conv_B_b"][g], w["conv_C_w"][g], w["conv_C_b"][g],
                w["mixer_norm_weight"][0], A[g], w["D"][g], w["dt_bias"][g])

    def ssd(g):
        return xi, dt, A[g], Bm, Cm, w["D"][g], w["dt_bias"][g]

    return mixer, ssd


def phase_ssd_kernels(dev):
    """K4 and K5 against their plain versions at the l20-ssd scoring shape
    (both directions, fp32 and bf16) with timings; a bf16 timing row at the
    pc2-small-ssd width; K4's own entry point driven once per direction."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    cfg = CaduceusConfig.preset("l20-ssd")
    rows, L = 256, 512
    log(f"phase 3c: SSD kernels vs plain versions (l20-ssd: {rows} rows x {L} x "
        f"{cfg.d_inner}, H {cfg.n_heads}, P = N = chunk = 128)")
    gen = torch.Generator(device=dev).manual_seed(13)
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}, "split_ms": {}}
           for k in ("ssd_fwd", "mixer2_fwd")}
    kw = dict(d_state=cfg.d_state, eps=cfg.norm_epsilon, chunk=cfg.chunk_size)

    def k5(args, rev):
        return cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=rev)

    def k5_plain(args, rev):
        return cuda_mixer2.mamba2_mixer_interior_plain(*args, **kw, reverse=rev)

    def k4(args, rev):
        return cuda_ssd.ssd_dir(*args, cfg.chunk_size, rev)

    def k4_plain(args, rev):
        return cuda_ssd.ssd_dir_plain(*args, cfg.chunk_size, rev)

    fns = {"mixer2_fwd": (k5, k5_plain, True), "ssd_fwd": (k4, k4_plain, False)}
    bf16_inputs = None
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        inp = ssd_inputs(cfg, rows, L, dtype, dev, gen, 21)
        if dtype == torch.bfloat16:
            bf16_inputs = inp
        for name, (kern, plain, mixer) in fns.items():
            make = inp[0] if mixer else inp[1]
            for g in (0, 1):
                got = kern(make(g), g == 1)
                want = plain(make(g), g == 1)
                torch.cuda.synchronize()
                res[name]["err"] = max(res[name]["err"], compare(
                    f"{'K5' if mixer else 'K4'} {name} {dn} {'rev' if g else 'fwd'}",
                    got, want, dn))
                del got, want
            args = make(1)
            res[name]["ms"][dn] = time_ms(lambda: kern(args, True), 10)
            res[name]["split_ms"][dn] = device_ms_by_kernel(lambda: kern(args, True))
            res[name]["plain_ms"][dn] = time_ms(lambda: plain(args, True), 2, warmup=1)
            res[name]["bound"][dn] = work_bound(
                ssd_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize, mixer=mixer), dn)
    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, one direction): {r['ms'][dn]:.3f} ms; plain "
                f"{r['plain_ms'][dn]:.1f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, sfu "
                f"{parts['sfu'] * 1e3:.3f}, bf16 tensor cores {parts['tc'] * 1e3:.3f} ms)"
                f"{split_note(r, dn)}")

    # K4's own entry point, one launch per direction, counted (no model path
    # of the port launches K4: its core runs inside every K5 launch).
    reset_counts()
    for g in (0, 1):
        k4(bf16_inputs[1](g), g == 1)
    torch.cuda.synchronize()
    c = counts()
    if c != only(ssd_fwd=2):
        fail(f"K4's entry point launched {c}")
    k4_launches = c["ssd_fwd"]
    del bf16_inputs

    # pc2-small-ssd width: 16 rows (8 windows + RC) x 8192 bp, d_inner 1536, H 12.
    pcfg = CaduceusConfig.preset("pc2-small-ssd")
    prow, pL = 16, 8192
    inp = ssd_inputs(pcfg, prow, pL, torch.bfloat16, dev, gen, 22)
    for name, (kern, plain, mixer) in fns.items():
        args = (inp[0] if mixer else inp[1])(1)
        got, want = kern(args, True), plain(args, True)
        torch.cuda.synchronize()
        compare(f"{name} bfloat16 rev at pc2-small-ssd width", got, want, "bfloat16")
        del got, want
        b, by, parts = work_bound(ssd_work(prow, pL, pcfg.n_heads, pcfg.n_groups, 2,
                                          mixer=mixer), "bfloat16")
        res[name]["pc2_small_ssd"] = dict(
            ms=time_ms(lambda: kern(args, True), 5),
            plain_ms=time_ms(lambda: plain(args, True), 1, warmup=1), bound_ms=b, bound_by=by)
        r = res[name]["pc2_small_ssd"]
        log(f"  {name} (bfloat16, one direction, {prow} x {pL} x {pcfg.d_inner}, H "
            f"{pcfg.n_heads}): {r['ms']:.3f} ms; plain {r['plain_ms']:.1f} ms; bound "
            f"{b:.3f} ms by {by}")
    return res, k4_launches


def ssd_train_work(R, L, H, NG, s, kernel):
    """What one direction of ``kernel`` (``ssd_fwd_fentry``,
    ``mixer2_fwd_res``, ``ssd_bwd`` or ``ssd_bwd_pre_silu``) must do,
    counted from the shapes as :func:`ssd_work`. The training variants add their residual outputs: the
    float32 entry states [R, L/T, N, H*P] and, for K5-res, the accumulators
    and y in the activation dtype. K6 reads x, g, B, C, dt and the entry
    states and writes dx, dB, dC, ddt_raw and dmass in float32 (pre_silu:
    also gx and dtp); its products are eight per (row, chunk, head) and C @
    B^T once per group; per score, the masked exp2 and ~6 flops."""
    P = N = T = 128
    di, NGN = H * P, NG * N
    rows, nc = R * L, L // T
    fentry = 4 * R * nc * N * di
    if kernel in ("ssd_fwd_fentry", "mixer2_fwd_res"):
        res = kernel == "mixer2_fwd_res"
        nbytes, ew, sfu, prod = ssd_work(R, L, H, NG, s, mixer=res)
        return nbytes + fentry + (s * rows * (2 * di + 2 * NGN) if res else 0), ew, sfu, prod
    pre = kernel == "ssd_bwd_pre_silu"
    head_chunks = R * nc * H
    nbytes = (s * rows * (2 * di + 2 * NGN + H) + fentry
              + 4 * rows * (di + 2 * NGN + (4 if pre else 2) * H) + 4 * 3 * H)
    prod = R * nc * (NG * 2 * T * T * N + H * 8 * 2 * T * T * P)
    ew = 6 * head_chunks * T * T + rows * (10 * di + 4 * NGN + 20 * H)
    sfu = head_chunks * T * T + rows * (6 * H + (2 * (di + 2 * NGN) if pre else 0))
    return nbytes, ew, sfu, prod


def phase_ssd_train_kernels(dev):
    """The Mamba-2 training kernels against their plain versions at the
    l20-ssd training shape (64 rows x 512 x 768, H 6): K4-fentry, K5-res and
    K6 in both modes (K6 pre_silu on K5-res's plain residuals, as the
    trainer calls it), both directions, fp32 and bf16; timings."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    cfg = CaduceusConfig.preset("l20-ssd")
    rows, L, H, NG, N = TRAIN_ROWS, 512, cfg.n_heads, cfg.n_groups, cfg.d_state
    log(f"phase 3d: Mamba-2 training kernels vs plain versions (l20-ssd: {rows} rows x {L} "
        f"x {cfg.d_inner}, H {H}, P = N = chunk = 128)")
    gen = torch.Generator(device=dev).manual_seed(17)
    names = ("ssd_fwd_fentry", "mixer2_fwd_res", "ssd_bwd", "ssd_bwd_pre_silu")
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}} for k in names}
    for k in ("ssd_fwd_fentry", "mixer2_fwd_res", "ssd_bwd", "ssd_bwd_pre_silu"):
        res[k]["split_ms"] = {}
    kw = dict(d_state=N, eps=cfg.norm_epsilon, chunk=cfg.chunk_size)
    T = cfg.chunk_size

    def check(kernel, label, got, want, dn):
        # TOL[dn] for every output, the float32 ones too (entry states and
        # gradients computed from bf16-rounded product operands; a value
        # near a rounding boundary can round the other way)
        for n, g_, w_ in zip(label, got, want):
            res[kernel]["err"] = max(res[kernel]["err"], compare(
                f"{kernel} {n} {dn}", g_, w_, dn))

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = dtype.itemsize
        mixer, ssd = ssd_inputs(cfg, rows, L, dtype, dev, gen, 23)
        g = torch.randn((rows, L, cfg.d_inner), generator=gen, device=dev).to(dtype)
        for d in (0, 1):
            rev = d == 1
            tag = "rev" if rev else "fwd"
            k4 = (lambda a=ssd(d), r=rev: cuda_ssd.ssd_dir(*a, T, r, emit_fentry=True),
                  lambda a=ssd(d), r=rev: cuda_ssd.ssd_dir_plain(*a, T, r, emit_fentry=True))
            k5 = (lambda a=mixer(d), r=rev: cuda_mixer2.mamba2_mixer_interior(
                      *a, **kw, reverse=r, emit_residuals=True),
                  lambda a=mixer(d), r=rev: cuda_mixer2.mamba2_mixer_interior_plain(
                      *a, **kw, reverse=r, emit_residuals=True))
            y_p, fe_p = k4[1]()
            check("ssd_fwd_fentry", (f"y {tag}", f"fentry {tag}"), k4[0](), (y_p, fe_p), dn)
            want5 = k5[1]()
            check("mixer2_fwd_res",
                  [f"{n} {tag}" for n in ("u", "accx", "accB", "accC", "fentry", "y")],
                  k5[0](), want5, dn)
            # K6, plain mode on K4's arguments; pre_silu on K5-res's residuals
            bargs = (*ssd(d), fe_p, g)
            _, accx, accB, accC, fe5, _ = want5
            a5 = mixer(d)
            pargs = (accx, a5[4], a5[12], accB.reshape(rows, L, NG, N),
                     accC.reshape(rows, L, NG, N), a5[13], a5[14], fe5, g)
            k6 = (lambda a=bargs, r=rev: cuda_ssd.ssd_dir_bwd(*a, T, r),
                  lambda a=bargs, r=rev: cuda_ssd.ssd_dir_bwd_plain(*a, T, r))
            k6p = (lambda a=pargs, r=rev: cuda_ssd.ssd_dir_bwd(*a, T, r, pre_silu=True),
                   lambda a=pargs, r=rev: cuda_ssd.ssd_dir_bwd_plain(*a, T, r, pre_silu=True))
            bnames = ("dx", "dB", "dC", "ddt_raw", "dmass", "gx", "dtp")
            check("ssd_bwd", [f"{n} {tag}" for n in bnames[:5]], k6[0](), k6[1](), dn)
            check("ssd_bwd_pre_silu", [f"{n} {tag}" for n in bnames], k6p[0](), k6p[1](), dn)
            torch.cuda.synchronize()
            calls = {"ssd_fwd_fentry": k4, "mixer2_fwd_res": k5, "ssd_bwd": k6,
                     "ssd_bwd_pre_silu": k6p}  # the reverse direction's are timed
            del y_p, fe_p, want5, bargs, pargs
        for name, (kern, plain) in calls.items():
            res[name]["ms"][dn] = time_ms(kern, 10)
            res[name]["plain_ms"][dn] = time_ms(plain, 2, warmup=1)
            res[name]["bound"][dn] = work_bound(ssd_train_work(rows, L, H, NG, s, name), dn)
            if "split_ms" in res[name]:
                res[name]["split_ms"][dn] = device_ms_by_kernel(kern)
        del calls, mixer, ssd, g
        torch.cuda.empty_cache()
    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, one direction): {r['ms'][dn]:.3f} ms; plain "
                f"{r['plain_ms'][dn]:.1f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, sfu "
                f"{parts['sfu'] * 1e3:.3f}, bf16 tensor cores {parts['tc'] * 1e3:.3f} ms)"
                f"{split_note(r, dn)}")
    return res


def _counters():
    """Each kernel's name in the kernels line -> (wrapper, counter attribute)."""
    from plantcaduceus_tpu_torch.ops import (cuda_attention, cuda_mixer, cuda_mixer2, cuda_scan,
                                             cuda_ssd)

    return {"mixer_fwd": (cuda_mixer.mixer_fwd, "launches"),
            "mixer_fwd_res": (cuda_mixer.mixer_fwd, "res_launches"),
            "mixer_fwd_x": (cuda_mixer.mixer_fwd, "x_launches"),
            "scan_fwd": (cuda_scan.scan_fwd, "launches"),
            "scan_fwd_hb": (cuda_scan.scan_fwd, "hb_launches"),
            "scan_fwd_combine": (cuda_scan.scan_fwd, "combine_launches"),
            "scan_bwd": (cuda_scan.scan_bwd, "launches"),
            "scan_bwd_g0": (cuda_scan.scan_bwd, "g0_launches"),
            "ssd_fwd": (cuda_ssd.ssd_dir, "launches"),
            "ssd_fwd_fentry": (cuda_ssd.ssd_dir, "fentry_launches"),
            "mixer2_fwd": (cuda_mixer2.mamba2_mixer_interior, "launches"),
            "mixer2_fwd_res": (cuda_mixer2.mamba2_mixer_interior, "res_launches"),
            "ssd_bwd": (cuda_ssd.ssd_dir_bwd, "launches"),
            "ssd_bwd_pre_silu": (cuda_ssd.ssd_dir_bwd, "pre_silu_launches"),
            "attn_fwd": (cuda_attention.flash_fwd, "launches"),
            "attn_bwd": (cuda_attention.flash_bwd, "launches"),
            "attn_fwd_wide": (cuda_attention.flash_fwd, "wide_launches"),
            "attn_bwd_wide": (cuda_attention.flash_bwd, "wide_launches")}


def reset_counts():
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def counts():
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def only(**nonzero):
    """The counts dict with these entries and every other one 0."""
    return {k: nonzero.get(k, 0) for k in _counters()}


def phase_forward(cfg, dev):
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params

    log("phase 4: full l20 forward, kernels vs plain path (fp32, batch 128 x 512 bp)")
    model = Caduceus(cfg, init_params(cfg, seed=0)).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(7, 11, (128, 512), generator=gen, device=dev)
    with torch.inference_mode():
        reset_counts()
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        c = counts()
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
        lo = model(ids)["logits"]  # default bf16 compute
        torch.cuda.synchronize()
    if c != only(mixer_fwd_x=2 * cfg.n_layer):
        fail(f"l20 forward launched {c}; expected mixer_fwd_x={2 * cfg.n_layer}, scan_fwd=0")
    d = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  logits {tuple(got.shape)}: max_abs_err={d:.3e} (max |logit| {scale:.3e}, "
        f"tol {FORWARD_TOL:.0e} rel); launches {c}")
    if not (torch.isfinite(got).all() and d <= FORWARD_TOL * scale):
        fail("l20 forward with kernels disagrees with the plain path")
    if not torch.isfinite(lo).all():
        fail("bf16 l20 forward produced non-finite logits")
    del model


def phase_forward2(dev):
    """The full l20-ssd forward, kernels against the plain path in fp32."""
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig.preset("l20-ssd")
    log("phase 4b: full l20-ssd forward, kernels vs plain path (fp32, batch 128 x 512 bp)")
    model = Caduceus(cfg, init_params(cfg, seed=0)).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(7, 11, (128, 512), generator=gen, device=dev)
    with torch.inference_mode():
        reset_counts()
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        c = counts()
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
        lo = model(ids)["logits"]  # default bf16 compute
        torch.cuda.synchronize()
    if c != only(mixer2_fwd=2 * cfg.n_layer):
        fail(f"l20-ssd forward launched {c}; expected mixer2_fwd={2 * cfg.n_layer} only")
    d = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  logits {tuple(got.shape)}: max_abs_err={d:.3e} (max |logit| {scale:.3e}, "
        f"tol {FORWARD_TOL:.0e} rel); launches {c}")
    if not (torch.isfinite(got).all() and d <= FORWARD_TOL * scale):
        fail("l20-ssd forward with kernels disagrees with the plain path")
    if not torch.isfinite(lo).all():
        fail("bf16 l20-ssd forward produced non-finite logits")
    del model


def phase_general(dev):
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    log("phase 5: general mixer path (K1): untied G=2 and unidirectional G=1")
    total = 0
    for kw, per_layer in ((dict(bidirectional_weight_tie=False), 2),
                          (dict(bidirectional=False, rcps=False), 1)):
        cfg = CaduceusConfig(d_model=128, n_layer=2, **kw)
        model = Caduceus(cfg, init_params(cfg, seed=2)).to(dev).eval()
        ids = torch.randint(7, 11, (16, 256), generator=torch.Generator(device=dev)
                            .manual_seed(3), device=dev)
        with torch.inference_mode():
            reset_counts()
            got = model(ids, dtype=torch.float32)["logits"]
            torch.cuda.synchronize()
            c = counts()
            want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
        d = (got - want).abs().max().item()
        scale = want.abs().max().item()
        log(f"  {kw}: max_abs_err={d:.3e} (max |logit| {scale:.3e}); launches {c}")
        if c != only(scan_fwd=per_layer * cfg.n_layer):
            fail(f"general path launched {c}")
        if not d <= FORWARD_TOL * scale:
            fail(f"general path {kw} disagrees with its plain path")
        total += c["scan_fwd"]
    return total


def phase_gated(cfg, dev):
    """5b: the ``PCAD_GATED_KERNEL=1`` route (in_proj, conv, x_proj in plain
    PyTorch, then ``bimamba_scan_gated``: K1 forward and K1 reverse with
    the combine epilogue; K1-hb and K3 under training), switched on in this
    process: the l20 fp32 forward at 16 x 512 against the plain path (1e-3
    of max |logit|), the bf16 forward within 2 x the plain path's own gap
    from fp32, one fp32 training step's gradients at l20 width, 2 layers,
    4 x 512 bp (1e-3 of each leaf's max); exact launches. Returns the
    launches by kernel."""
    import dataclasses

    import torch

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models import caduceus
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.step import to_device

    log("phase 5b: the PCAD_GATED_KERNEL route (K1 + K1 combine; K1-hb, K3 under grad), l20")
    nl = cfg.n_layer
    total = dict.fromkeys(_counters(), 0)
    caduceus._USE_GATED_KERNEL = True
    try:
        model = caduceus.Caduceus(cfg, caduceus.init_params(cfg, seed=51)).to(dev).eval()
        ids = torch.randint(7, 11, (16, 512), generator=torch.Generator(device=dev)
                            .manual_seed(52), device=dev)
        logits = {}
        with torch.inference_mode():
            for dtype in (torch.float32, torch.bfloat16):
                reset_counts()
                logits[dtype, True] = model(ids, dtype=dtype)["logits"].float()
                torch.cuda.synchronize()
                c = counts()
                if c != only(scan_fwd=nl, scan_fwd_combine=nl):
                    fail(f"phase 5b {dtype} forward launched {c}; expected scan_fwd={nl}, "
                         f"scan_fwd_combine={nl}")
                total = {k: total[k] + v for k, v in c.items()}
                logits[dtype, False] = model(ids, dtype=dtype, use_kernels=False)["logits"].float()
        del model
        want = logits[torch.float32, False]
        scale = want.abs().max().item()
        d32 = (logits[torch.float32, True] - want).abs().max().item()
        d16 = (logits[torch.bfloat16, True] - want).abs().max().item()
        gap = (logits[torch.bfloat16, False] - want).abs().max().item()
        log(f"  fp32 logits (16 x 512): max_abs_err={d32:.3e} (max |logit| {scale:.3e}, tol "
            f"{FORWARD_TOL:.0e} rel); bf16: {d16:.3e} from plain fp32, the plain bf16 path's "
            f"own gap {gap:.3e} (tol 2x)")
        if not (math.isfinite(d32) and d32 <= FORWARD_TOL * scale):
            fail("phase 5b: the gated route's fp32 logits disagree with the plain path")
        if not (math.isfinite(d16) and d16 <= 2 * gap):
            fail(f"phase 5b: the gated route's bf16 logits {d16:.3e} from fp32, past 2 x the "
                 f"plain path's {gap:.3e}")
        small = dataclasses.replace(cfg, n_layer=2)
        seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=8, seed=53)
        batch = to_device(data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=53)
                          .batch_at(0), dev)
        params = caduceus.init_params(small, seed=54)
        grads = {}
        for use_kernels in (True, False):
            model = caduceus.Caduceus(small, params).requires_grad_().to(dev)
            reset_counts()
            out = caduceus.forward(model, batch["input_ids"], dtype=torch.float32,
                                   use_kernels=use_kernels)["logits"]
            caduceus.mlm_loss(out, batch["labels"], batch["loss_weights"]).backward()
            torch.cuda.synchronize()
            c = counts()
            expect = only(scan_fwd_hb=4, scan_bwd=4) if use_kernels else only()
            if c != expect:
                fail(f"phase 5b step (kernels={use_kernels}) launched {c}; expected {expect}")
            total = {k: total[k] + v for k, v in c.items()}
            grads[use_kernels] = {n: q.grad for n, q in model.named_parameters()}
            del model
        worst, worst_name = grads_agree("phase 5b", grads[True], grads[False])
        log(f"  one fp32 step (2 layers, 4 x 512): {len(grads[False])} gradients, worst "
            f"{worst_name} at {worst:.3e} of its max |grad| (tol {GRAD_TOL:.0e}); launches "
            f"per forward K1 {nl}, K1 combine {nl}; per step K1-hb 4, K3 4")
    finally:
        caduceus._USE_GATED_KERNEL = False
    return total


def write_inputs(tmp: Path):
    """Seeded synthetic TSV (390 rows, 6 with non-ACGT alleles) and a
    FASTA (2 x 4000 bp) + VCF (120 records: SNVs, multi-allelic, indels)."""
    import numpy as np

    rng = np.random.default_rng(2024)
    bases = np.array(list("ACGT"))
    tsv = tmp / "snps.tsv"
    with open(tsv, "w") as fh:
        fh.write("chr\tpos\tref\talt\tsequences\n")
        for i in range(390):
            seq = "".join(rng.choice(bases, 512))
            ref = seq[255]
            alt = rng.choice([b for b in "ACGT" if b != ref])
            if i % 65 == 7:
                ref = "N"
            fh.write(f"chr{1 + i % 3}\t{1000 + 10 * i}\t{ref}\t{alt}\t{seq}\n")
    chroms = {f"chr{c}": "".join(rng.choice(bases, 4000)) for c in (1, 2)}
    fa = tmp / "genome.fa"
    with open(fa, "w") as fh:
        for name, s in chroms.items():
            fh.write(f">{name}\n" + "\n".join(s[i:i + 80] for i in range(0, len(s), 80)) + "\n")
    vcf = tmp / "in.vcf"
    n_snv = 0
    with open(vcf, "w") as fh:
        fh.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")
        for name, s in chroms.items():
            for pos in sorted(rng.choice(np.arange(1, len(s) + 1), 60, replace=False)):
                ref = s[pos - 1]
                others = [b for b in "ACGT" if b != ref]
                kind = rng.integers(0, 6)
                alt = (f"{ref}TT" if kind == 0 else
                       f"{others[0]},{ref}G,{others[1]}" if kind == 1 else others[kind % 3])
                n_snv += kind != 0
                fh.write(f"{name}\t{pos}\t.\t{ref}\t{alt}\t.\t.\t.\n")
    return tsv, fa, vcf, n_snv


def start_module(module, args):
    """``python -m plantcaduceus_tpu_torch.<module> args`` from the checkout,
    started now (its output in a file beside the phases' inputs), to be
    finished by :func:`finish_module`: checks that share nothing run side by
    side, so their processes' starts overlap."""
    out = REPO / "build" / "chip_smoke" / f"python_m_{module}_{time.monotonic_ns()}.log"
    out.parent.mkdir(parents=True, exist_ok=True)
    fh = open(out, "w+")
    proc = subprocess.Popen([sys.executable, "-m", f"plantcaduceus_tpu_torch.{module}", *args],
                            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=fh, stderr=subprocess.STDOUT, text=True)
    return proc, fh, module, args


def finish_module(job, timeout=600):
    """Wait for a :func:`start_module` run; fail if it did not exit 0 within
    ``timeout`` (it is stopped)."""
    proc, fh, module, args = job
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = f"a timeout after {timeout} s"
    fh.seek(0)
    out = fh.read()
    fh.close()
    if rc != 0:
        fail(f"python -m {module} {args} exited {rc}:\n{out[-4000:]}")


def run_module(module, args, timeout=600):
    """``python -m plantcaduceus_tpu_torch.<module> args`` from the checkout."""
    finish_module(start_module(module, args), timeout)


def phase_cli(cfg, dev):
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as cli_main
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    log("phase 6: zero-shot CLI, l20 preset (random seeded weights), bf16")
    tmp = REPO / "build" / "chip_smoke"  # inside the checkout; .gitignore lists build/
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    tsv, fa, vcf, n_snv = write_inputs(tmp)
    table = zero_shot.read_table(tsv)
    n_valid = sum(r["ref"] in zero_shot.NUCLEOTIDES and r["alt"] in zero_shot.NUCLEOTIDES
                  for r in table.rows)

    out = tmp / "scores.tsv"
    reset_counts()
    t = time.perf_counter()
    cli_main(["-input-table", str(tsv), "-model", "l20", "-output", str(out),
              "-no-progress"])
    secs = time.perf_counter() - t
    c = counts()
    n_batches = math.ceil(n_valid / 128)
    got = zero_shot.read_table(out)
    scores = np.array([float(r["zeroShotScore"]) for r in got.rows])
    log(f"  TSV: {len(table.rows)} rows in, {len(got.rows)} scored, {secs:.2f} s end to end "
        f"({n_valid / secs:.1f} windows/s incl. model build and file I/O); launches {c}")
    if len(got.rows) != n_valid or not np.isfinite(scores).all():
        fail("TSV scoring: wrong row count or non-finite scores")
    if c != only(mixer_fwd_x=2 * cfg.n_layer * n_batches):
        fail(f"TSV scoring launched {c}; expected mixer_fwd_x={2 * cfg.n_layer * n_batches}")

    # Steady-state scoring rate of the engine at batch 128 (model resident).
    model, _, tok = load_model_and_tokenizer("l20")
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=128, device=dev)
    seqs = [r["sequences"] for r in table.rows][:384]
    ids = zero_shot.mask_and_encode(seqs * 4, tok, 255)  # 1536 windows, 12 batches
    runner.masked_probs(ids[:256], nucleotide_ids(tok), 255, progress=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = runner.masked_probs(ids, nucleotide_ids(tok), 255, progress=False)
    wps = len(ids) / (time.perf_counter() - t)
    if probs.shape != (len(ids), 4) or not np.isfinite(probs).all():
        fail("steady-state scoring produced bad probabilities")
    log(f"  steady state: {wps:.1f} windows/s (l20, 512 bp, batch 128, bf16; "
        f"{len(ids)} windows, model resident)")
    del runner, model

    bed, out_vcf = tmp / "scores.bed", tmp / "out.vcf"
    bed_job = start_module("cli.zero_shot_score", ["-input-table", str(tsv), "-model", "l20",
                                                   "-output", str(bed), "-outBED", "-no-progress"])
    vcf_job = start_module("cli.zero_shot_score", ["-input-vcf", str(vcf), "-input-fasta",
                                                   str(fa), "-model", "l20", "-output",
                                                   str(out_vcf), "-no-progress"])
    finish_module(bed_job)
    finish_module(vcf_job)
    bed_rows = [ln.split("\t") for ln in bed.read_text().splitlines()]
    if len(bed_rows) != n_valid or any(int(r[2]) - int(r[1]) != 1 for r in bed_rows):
        fail("BED output: wrong rows or intervals")
    log(f"  python -m ... -outBED: {len(bed_rows)} BED rows")
    recs = [ln.split("\t") for ln in out_vcf.read_text().splitlines()
            if not ln.startswith("#")]
    vals = [v for r in recs for v in r[7].split("plantCAD_zero_shot=")[1].split(",")]
    finite = all(math.isfinite(float(v)) for v in vals if v != ".")
    log(f"  python -m ... -input-vcf: {len(recs)} records annotated ({n_snv} with an SNV "
        f"alt), {sum(v == '.' for v in vals)} non-SNV alts as '.'")
    if len(recs) != n_snv or not finite:
        fail("VCF scoring: wrong record count or non-finite scores")
    return c["mixer_fwd_x"], wps, n_valid / secs, tsv, n_valid


def phase_profile(cfg, dev):
    """Device time by kernel over one l20 scoring batch (bf16, 128 x 512 bp),
    and the device's busy share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params

    from plantcaduceus_tpu_torch.models import caduceus

    log("phase 7: profile one l20 bf16 batch (torch.profiler)")
    model = Caduceus(cfg, init_params(cfg, seed=0)).to(dev).eval()
    ids = torch.randint(7, 11, (128, 512), device=dev)
    peak = {}
    with torch.inference_mode():
        model(ids)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model(ids)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        # the batch's peak memory with K2 fuse_in, and with xi written first
        # (the same call with the fuse_in threshold set to 0)
        threshold = caduceus.FUSE_IN_MAX_D_INNER
        for name, limit in (("fuse_in", threshold), ("xi first", 0)):
            caduceus.FUSE_IN_MAX_D_INNER = limit
            try:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                model(ids)
                torch.cuda.synchronize()
                peak[name] = torch.cuda.max_memory_allocated(dev) - base
            finally:
                caduceus.FUSE_IN_MAX_D_INNER = threshold
    report_profile(prof, wall, 10)
    k2 = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and ("conv_xproj" in e.key or "MixConvSrc" in e.key)) / 1e3
    log(f"  K2 (fuse_in, both kernels) {k2:.2f} ms of the batch (on an NVIDIA H100 80GB HBM3 "
        f"at 700 W, fuse_in's first design: busy 246.50 ms, K2 180.32 ms; xi given: busy 158.35 "
        f"ms, K2 79.6 ms); the batch's peak memory above the model: fuse_in "
        f"{peak['fuse_in']} bytes ({peak['fuse_in'] / 2**30:.2f} GiB), xi written first "
        f"{peak['xi first']} bytes ({peak['xi first'] / 2**30:.2f} GiB)")


def report_profile(prof, wall, top):
    """Device time by kernel, the device's busy share of ``wall`` ms, and
    the host-to-device copies and host synchronisations in the window."""
    import torch

    # Kernel-level entries only: operator entries also carry their kernels'
    # device time, and summing both would count it twice.
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if not kernels:
        log("  the profiler recorded no device time (not measured)")
        return
    ev = prof.key_averages()
    htod = sum(e.count for e in ev if e.key.startswith("Memcpy HtoD"))
    syncs = sum(e.count for e in ev if e.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                                 "cudaEventSynchronize"))
    log(f"  wall {wall:.2f} ms; device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of wall); "
        f"host-to-device copies {htod}, host synchronisations {syncs}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


def phase_cli2(dev, tsv, n_valid):
    """The zero-shot CLI with the l20-ssd preset on phase 6's TSV, and the
    engine's steady-state rate at batch 128."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as cli_main
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    log("phase 6b: zero-shot CLI, l20-ssd preset (random seeded weights), bf16")
    out = tsv.parent / "scores_ssd.tsv"
    reset_counts()
    t = time.perf_counter()
    cli_main(["-input-table", str(tsv), "-model", "l20-ssd", "-output", str(out),
              "-no-progress"])
    secs = time.perf_counter() - t
    c = counts()
    model, cfg, tok = load_model_and_tokenizer("l20-ssd")
    n_batches = math.ceil(n_valid / 128)
    got = zero_shot.read_table(out)
    scores = np.array([float(r["zeroShotScore"]) for r in got.rows])
    log(f"  TSV: {len(got.rows)} scored, {secs:.2f} s end to end ({n_valid / secs:.1f} "
        f"windows/s incl. model build and file I/O); launches {c}")
    if len(got.rows) != n_valid or not np.isfinite(scores).all():
        fail("l20-ssd TSV scoring: wrong row count or non-finite scores")
    if c != only(mixer2_fwd=2 * cfg.n_layer * n_batches):
        fail(f"l20-ssd TSV scoring launched {c}; expected "
             f"mixer2_fwd={2 * cfg.n_layer * n_batches} only")

    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=128, device=dev)
    seqs = [r["sequences"] for r in got.rows][:384]
    ids = zero_shot.mask_and_encode(seqs * 4, tok, 255)  # 1536 windows, 12 batches
    runner.masked_probs(ids[:256], nucleotide_ids(tok), 255, progress=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = runner.masked_probs(ids, nucleotide_ids(tok), 255, progress=False)
    wps = len(ids) / (time.perf_counter() - t)
    if probs.shape != (len(ids), 4) or not np.isfinite(probs).all():
        fail("l20-ssd steady-state scoring produced bad probabilities")
    log(f"  steady state: {wps:.1f} windows/s (l20-ssd, 512 bp, batch 128, bf16; "
        f"{len(ids)} windows, model resident)")
    return c["mixer2_fwd"], wps, n_valid / secs


def phase_profile2(dev):
    """Device time by kernel over one l20-ssd scoring batch (bf16, 128 x 512 bp)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    log("phase 7b: profile one l20-ssd bf16 batch (torch.profiler)")
    cfg = CaduceusConfig.preset("l20-ssd")
    model = Caduceus(cfg, init_params(cfg, seed=0)).to(dev).eval()
    ids = torch.randint(7, 11, (128, 512), device=dev)
    with torch.inference_mode():
        model(ids)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            model(ids)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall, 10)


def phase_grads(dev):
    """One fp32 training step's gradients, kernels against the plain path
    (autograd through the plain versions), l20 width, 2 layers, 4 x 512 bp.
    Returns K1-hb's launches."""
    import torch

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import (Caduceus, forward, init_params,
                                                         mlm_loss)
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.step import to_device

    log("phase 8: one fp32 training step's gradients, kernels vs plain path "
        "(d_model 384, 2 layers, batch 4 x 512 bp)")
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=16, seed=8)
    batch = to_device(data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=8).batch_at(0),
                      dev)
    hb_launches = 0
    for name, kw, expect in (
            ("tied+add", {}, lambda nl: only(mixer_fwd_res=2 * nl, scan_bwd=2 * nl)),
            ("untied G=2 (dt fused)", dict(bidirectional_weight_tie=False),
             lambda nl: only(scan_fwd_hb=2 * nl, scan_bwd=2 * nl)),
            ("unidirectional G=1 (full-width dt)", dict(bidirectional=False, rcps=False),
             lambda nl: only(scan_fwd_hb=nl, scan_bwd=nl))):
        cfg = CaduceusConfig(d_model=384, n_layer=2, **kw)
        params = init_params(cfg, seed=9)
        grads = {}
        for use_kernels in (True, False):
            model = Caduceus(cfg, params).requires_grad_().to(dev)
            reset_counts()
            logits = forward(model, batch["input_ids"], dtype=torch.float32,
                             use_kernels=use_kernels)["logits"]
            mlm_loss(logits, batch["labels"], batch["loss_weights"]).backward()
            torch.cuda.synchronize()
            c = counts()
            want = expect(cfg.n_layer) if use_kernels else only()
            if c != want:
                fail(f"phase 8 {name} (kernels={use_kernels}) launched {c}; expected {want}")
            if use_kernels:
                hb_launches += c["scan_fwd_hb"]
                launched = {k: v for k, v in c.items() if v}
            grads[use_kernels] = {n: p.grad for n, p in model.named_parameters()}
        worst, worst_name = grads_agree(f"phase 8 {name}", grads[True], grads[False])
        log(f"  {name}: {len(grads[False])} parameter gradients, worst {worst_name} at "
            f"{worst:.3e} of its max |grad| (tol {GRAD_TOL:.0e}); launches {launched}")
    return hb_launches


def rel_gap(got, want):
    """max |got - want| over max |want|."""
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    return err / scale if scale else err


def grads_agree(what, got, want, tol=GRAD_TOL):
    """Every parameter's gradient through the kernels within ``tol`` of its
    max |gradient| through the plain path; returns (worst, its name)."""
    worst, worst_name = 0.0, ""
    for n, gp in want.items():
        rel = rel_gap(got[n], gp)
        if not (math.isfinite(rel) and rel <= tol):
            fail(f"{what}: gradient of {n} off by {rel:.3e} of its max (tol {tol:.1e})")
        if rel >= worst:
            worst, worst_name = rel, n
    return worst, worst_name


def phase_grads2(dev):
    """One fp32 training step of an l20-ssd-width model (2 layers, 4 x 512
    bp), kernels (K5-res, K6 pre_silu) against the plain path; then
    SsdDirFn's gradients (K4-fentry, K6 plain mode) against autograd
    through K4's plain version at 4 rows x 512 x 768. Returns the launches
    of K4-fentry and K6 plain mode."""
    import torch

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import (Caduceus, forward, init_params,
                                                         mlm_loss)
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_ssd
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.step import to_device

    log("phase 8b: one fp32 training step's gradients, kernels vs plain path "
        "(l20-ssd width, 2 layers, batch 4 x 512 bp); SsdDirFn's gradients")
    cfg = CaduceusConfig.preset("l20-ssd", n_layer=2)
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=16, seed=8)
    batch = to_device(data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=8).batch_at(0),
                      dev)
    params = init_params(cfg, seed=9)
    grads = {}
    for use_kernels in (True, False):
        model = Caduceus(cfg, params).requires_grad_().to(dev)
        reset_counts()
        logits = forward(model, batch["input_ids"], dtype=torch.float32,
                         use_kernels=use_kernels)["logits"]
        mlm_loss(logits, batch["labels"], batch["loss_weights"]).backward()
        torch.cuda.synchronize()
        c = counts()
        nl2 = 2 * cfg.n_layer
        want = only(mixer2_fwd_res=nl2, ssd_bwd_pre_silu=nl2) if use_kernels else only()
        if c != want:
            fail(f"phase 8b (kernels={use_kernels}) launched {c}; expected {want}")
        grads[use_kernels] = {n: p.grad for n, p in model.named_parameters()}
        del model
    worst, worst_name = grads_agree("phase 8b", grads[True], grads[False])
    log(f"  tied+add: {len(grads[False])} parameter gradients, worst {worst_name} at "
        f"{worst:.3e} of its max |grad| (tol {GRAD_TOL:.0e}); launches per direction and "
        f"layer: K5-res 1, K6 pre_silu 1")

    gen = torch.Generator(device=dev).manual_seed(29)
    _, ssd = ssd_inputs(cfg, 4, 512, torch.float32, dev, gen, 31)
    reset_counts()
    worst, worst_name = 0.0, ""
    for d in (0, 1):
        ins = [t.detach().clone().requires_grad_() for t in ssd(d)]
        gw = torch.randn(tuple(ins[0].shape), generator=gen, device=dev)
        got = torch.autograd.grad(
            (cuda_ssd.ssd_dir_train(*ins, cfg.chunk_size, d == 1) * gw).sum(), ins)
        torch.cuda.synchronize()
        c = counts()
        want = torch.autograd.grad(
            (cuda_ssd.ssd_dir_plain(*ins, cfg.chunk_size, d == 1) * gw).sum(), ins)
        names = [f"{n} {'rev' if d else 'fwd'}"
                 for n in ("x", "dt", "A", "Bm", "Cm", "Dskip", "dt_bias")]
        w, wn = grads_agree("phase 8b SsdDirFn", dict(zip(names, got)), dict(zip(names, want)))
        if w >= worst:
            worst, worst_name = w, wn
    if c != only(ssd_fwd_fentry=2, ssd_bwd=2):
        fail(f"phase 8b SsdDirFn launched {c}")
    log(f"  SsdDirFn, both directions: 14 input gradients, worst {worst_name} at {worst:.3e} "
        f"of its max |grad|; launches {dict((k, v) for k, v in c.items() if v)}")
    return c["ssd_fwd_fentry"], c["ssd_bwd"]


class StepLog:
    """Collects ``(step, loss, host time)`` from the training loop's log
    lines while in a ``with`` block."""

    def __init__(self, logger="plantcaduceus_tpu_torch.train.loop"):
        import logging

        self.steps = []
        self.logger = logging.getLogger(logger)
        steps = self.steps

        class Handler(logging.Handler):
            def emit(self, record):
                if isinstance(record.msg, str) and record.msg.startswith("step "):
                    steps.append((record.args[0], float(record.args[2]), time.perf_counter()))

        self.handler = Handler()

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.steps

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def steady_ms(steps, first, last, skip=()):
    """Mean host interval between logged steps ``first``..``last`` without
    the intervals ending at ``skip`` (checkpoint writes, evaluations)."""
    t = {s[0]: s[2] for s in steps}
    d = [t[k] - t[k - 1] for k in range(first + 1, last + 1) if k not in skip]
    return 1e3 * sum(d) / len(d)


def resume_equal(module, args, run_a, run_b, step, what):
    """Run ``python -m`` ``module`` into ``run_b`` seeded with ``run_a``'s
    step-``step`` checkpoint; its ``final/`` must equal ``run_a``'s bit for bit."""
    import torch

    shutil.rmtree(run_b, ignore_errors=True)
    run_b.mkdir(parents=True)
    shutil.copytree(run_a / str(step), run_b / str(step))
    shutil.copy(run_a / "config.json", run_b / "config.json")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", f"plantcaduceus_tpu_torch.{module}", *args,
                          "--output-dir", str(run_b)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        fail(f"{what}: resumed run exited {res.returncode}:\n{res.stderr[-4000:]}")
    if f"Resumed from step {step}" not in res.stderr:
        fail(f"{what}: the second run did not resume from step {step}:\n{res.stderr[-4000:]}")
    a = torch.load(run_a / "final" / "pytorch_model.bin", weights_only=True)
    b = torch.load(run_b / "final" / "pytorch_model.bin", weights_only=True)
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        fail(f"{what}: the run resumed at step {step} reached other final weights")
    return len(a)


TRAIN_STEPS, TRAIN_SAVE = 16, 8   # the run's steps and its checkpoint (the resume) at the midpoint
TRAIN_ARGS = ["--dataset", "synthetic", "--batch-size", "32", "--window", "512",
              "--dtype", "bfloat16", "--max-steps", str(TRAIN_STEPS), "--warmup-steps", "5",
              "--lr", "1e-3", "--save-steps", str(TRAIN_SAVE), "--log-steps", "1"]
# Per preset: the phase, and the kernels a training run launches: the
# inference variant (the final eval), the residual variant (forward and
# remat recompute) and the adjoint.
TRAIN_KERNELS = {"l20": ("9", "mixer_fwd_x", "mixer_fwd_res", "scan_bwd"),
                 "l20-ssd": ("9b", "mixer2_fwd", "mixer2_fwd_res", "ssd_bwd_pre_silu")}


def phase_pretrain(preset, dev, tsv, n_valid):
    """The pre-training CLI on the card (``preset`` at full width and depth,
    batch 32 x 512 bp, bf16, remat): loss, launches, throughput, memory; an
    exact resume from the midpoint through ``python -m``; scoring with the
    export."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig.preset(preset)
    phase, k_inf, k_res, k_bwd = TRAIN_KERNELS[preset]
    args = TRAIN_ARGS + ["--preset", preset]
    log(f"phase {phase}: pre-training CLI, {preset} ({cfg.n_layer} layers, d_model "
        f"{cfg.d_model}), batch 32 x 512 bp, bf16, remat, {TRAIN_STEPS} steps")
    tmp = REPO / "build" / "chip_smoke"
    run_a, run_b = tmp / f"pretrain_{preset}", tmp / f"pretrain_{preset}_resumed"
    shutil.rmtree(run_a, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    with StepLog() as steps:
        pretrain.main(args + ["--output-dir", str(run_a)])
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)

    nl, bs, L = cfg.n_layer, 32, 512
    losses = [s[1] for s in steps]
    log(f"  {len(steps)} steps in {wall:.1f} s (kernel build, model init, final eval and "
        f"export included); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if [s[0] for s in steps] != list(range(1, TRAIN_STEPS + 1)) or not all(
            map(math.isfinite, losses)):
        fail(f"phase {phase}: bad step log {steps}")
    if not losses[-1] < losses[0]:
        fail(f"phase {phase}: loss did not fall ({losses[0]} -> {losses[-1]})")
    # Per step: the residual variant twice per direction and layer (the
    # forward, and the recompute of every block in the backward under
    # remat), the adjoint once per direction and layer. The final eval runs
    # the inference variant.
    want = only(**{k_inf: c[k_inf], k_res: TRAIN_STEPS * 2 * 2 * nl,
                    k_bwd: TRAIN_STEPS * 2 * nl})
    if c != want or not (c[k_inf] > 0 and c[k_inf] % (2 * nl) == 0):
        fail(f"phase {phase} launched {c}; expected {want} with {k_inf} a positive "
             f"multiple of {2 * nl}")
    log(f"  launches {dict((k, v) for k, v in c.items() if v)}: per step {k_res} {4 * nl} (2 "
        f"directions x {nl} layers x forward + remat recompute), {k_bwd} {2 * nl}; {k_inf} = "
        f"final eval, inference kernel")
    times = {s[0]: s[2] for s in steps}
    # From step 4 on, without TRAIN_SAVE + 1: its interval holds the checkpoint write.
    deltas = [times[k] - times[k - 1] for k in range(4, TRAIN_STEPS + 1) if k != TRAIN_SAVE + 1]
    step_s = sum(deltas) / len(deltas)
    with_save = (times[TRAIN_STEPS] - times[3]) / (TRAIN_STEPS - 3)
    tps = bs * L / step_s
    log(f"  steady (steps 3-{TRAIN_STEPS} without the checkpoint step): {step_s * 1e3:.2f} ms "
        f"per step, {tps:.1f} tokens/s ({bs / step_s:.2f} windows/s); with the checkpoint write: "
        f"{with_save * 1e3:.2f} ms per step; peak memory allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")

    # the export scored through python -m beside the resumed run
    out = tmp / f"scores_trained_{preset}.tsv"
    score_job = start_module("cli.zero_shot_score", ["-input-table", str(tsv), "-model",
                                                     str(run_a / "final"), "-output", str(out),
                                                     "-no-progress"])
    try:
        n_t = resume_equal("cli.pretrain", args, run_a, run_b, TRAIN_SAVE, f"phase {phase}")
    finally:   # on a failure too
        finish_module(score_job)
    log(f"  python -m ... resumed at step {TRAIN_SAVE}: step-{TRAIN_STEPS} weights equal bit for "
        f"bit ({n_t} tensors)")
    scores = np.array([float(r["zeroShotScore"]) for r in zero_shot.read_table(out).rows])
    if len(scores) != n_valid or not np.isfinite(scores).all():
        fail("scoring with the trained export: wrong row count or non-finite scores")
    log(f"  python -m ...zero_shot_score -model {run_a.name}/final: {len(scores)} rows scored")
    return c, tps, step_s, peak


def phase_train_profile(preset, dev):
    """Device time by kernel over one training step of ``preset`` (bf16,
    batch 32 x 512 bp, remat), and the device's busy share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
    from plantcaduceus_tpu_torch.train.step import make_train_step, to_device

    cfg = CaduceusConfig.preset(preset)
    phase = "10" if preset == "l20" else "10b"
    log(f"phase {phase}: profile one {preset} training step (bf16, batch 32 x 512 bp, remat)")
    model = Caduceus(cfg, init_params(cfg, seed=32))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=5, total_steps=30,
                         params=dict(model.named_parameters()))
    init, step, _ = make_train_step(cfg, opt, model, dtype=torch.bfloat16, remat=True,
                                    device=dev)
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=64, seed=32)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), 32, seed=32)
    state = init()
    state, m = step(state, ds.batch_at(0))
    float(m["loss"])
    batch = to_device(ds.batch_at(1), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall, 14)


# ---------------------------------------------------------------------------
# The attention baseline: BERT-Base width (mosaicml/mosaic-bert-base: hidden
# 768, 12 layers, 12 heads of 64, intermediate 3072 with a GLU, ALiBi,
# post-norm, tied MLM head), vocab 16, 512-bp windows.

BERT_BASE = dict(vocab_size=16, d_model=768, n_layer=12, n_heads=12, ffn_mult=4, glu=True,
                 position="alibi")
# K7/K8 cases: symmetric ALiBi (the model's), causal, window 128, ALiBi +
# window 128.
ATTN_CASES = {"alibi": dict(alibi=True), "causal": dict(causal=True),
              "window128": dict(window=128), "alibi_window128": dict(alibi=True, window=128)}
ATTN_TILE = 64  # the kernels' query and key tiles (kAttnTile in csrc/attn_core.cuh)
BERT_L = 512                    # the windows' length
BERT_BATCH = (128, 32, 8)       # windows per batch: forward, training, fp32 gradient (8c)
BERT_STEPS = 30                 # training steps of phase 9c
LONG_L = 8192                   # PlantCAD2's context: phase 3e's timing row


def attn_pairs(L, causal=False, window=None):
    """(query, key) pairs in the 64 x 64 tiles K7 and K8 compute for one
    (batch row, head): each query tile's key tiles within its span."""
    n = 0
    for q0 in range(0, L, ATTN_TILE):
        q1 = min(q0 + ATTN_TILE, L) - 1
        lo, hi = 0, L - 1
        if window is not None:
            lo, hi = max(0, q0 - window), min(hi, q1 + window)
        if causal:
            hi = min(hi, q1)
        n += (q1 - q0 + 1) * (min((hi // ATTN_TILE + 1) * ATTN_TILE, L)
                              - lo // ATTN_TILE * ATTN_TILE)
    return n


def attn_work(B, L, H, hd, s, kernel, causal=False, window=None):
    """What K7 (``attn_fwd``) or K8 (``attn_bwd``) must do, counted from the
    shapes over the tiles it computes: bytes (q, k, v read and o written;
    K8: q, k, v, o, do read and dq, dk, dv written; lse in float32), fp32
    elementwise flops (~8 per score: scale, bias, max, the exp's argument,
    the sum; K8 ~10), one exp per score on the SFU, and the products' flops
    (K7: q k^T and p v; K8: s, dp, dv, dk and dq, five products)."""
    pairs = B * H * attn_pairs(L, causal, window)
    rows = B * L * H
    if kernel == "attn_fwd":
        return 4 * rows * hd * s + 4 * rows, 8 * pairs, pairs, 2 * 2 * pairs * hd
    return 8 * rows * hd * s + 4 * rows, 10 * pairs, pairs, 5 * 2 * pairs * hd


def attn_inputs(B, L, H, hd, dtype, dev, gen):
    import torch

    return [torch.randn((B, L, H, hd), generator=gen, device=dev).to(dtype) for _ in range(4)]


def sdpa_fn(q, k, v, bias, grad):
    """The library yardstick: one ``scaled_dot_product_attention`` call on
    the same inputs with the ALiBi bias materialised as an ``attn_mask`` [H,
    L, L] in the input dtype; with ``grad``, a closure timing its autograd
    backward."""
    import torch
    import torch.nn.functional as F

    qh, kh, vh = (t.detach().transpose(1, 2).requires_grad_(grad) for t in (q, k, v))
    if not grad:
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias)
    g = torch.randn_like(out)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), g, retain_graph=True)


def device_ms_by_kernel(fn, iters=10):
    """Device ms per launch by kernel name over ``iters`` calls of ``fn``
    after one warm call (torch.profiler): each kernel's total over the
    launches the profiler recorded, so a dropped record skews nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("(")[0].split()[-1].split("::")[-1]:
            e.self_device_time_total / 1e3 / e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


# Head dims beside the model's 64: 16 and 48 reach K7/K8 through
# flash_attention zero-padded to 32 and 64; 128 is the widest instantiation.
ATTN_PAD_HDS = (16, 48)
ATTN_WIDE_HD = 128


def attn_other_head_dims(dev, slopes, gen):
    """K7 and K8 at the other head dims, fp32 and bf16, ALiBi, 8 x 512, H
    12, against their plain versions: flash_attention (forward and
    autograd) at hd 16 and 48, and both wrappers at hd 128. Every kernel
    instantiation (hd 32, 64, 128) is then held on the card."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_attention as ca
    from plantcaduceus_tpu_torch.ops import flash_plain as fp

    H, B, L = BERT_BASE["n_heads"], 8, BERT_L
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hd in ATTN_PAD_HDS:
            q, k, v, do = attn_inputs(B, L, H, hd, dtype, dev, gen)
            ins = [t.clone().requires_grad_() for t in (q, k, v)]
            o = ca.flash_attention(*ins, alibi_slopes=slopes)
            grads = torch.autograd.grad(o, ins, do)
            o_w, lse_w = fp.flash_fwd_plain(q, k, v, slopes)
            want = fp.flash_bwd_plain(q, k, v, o_w, do, lse_w, slopes)
            torch.cuda.synchronize()
            if o.shape != q.shape or any(g.shape != q.shape for g in grads):
                fail(f"flash_attention at hd {hd} returned {tuple(o.shape)}")
            for n, g_, w_ in zip(("o", "dq", "dk", "dv"), (o, *grads), (o_w, *want)):
                compare(f"flash_attention hd {hd} {dn} {n}", g_, w_, dn)
        hd = ATTN_WIDE_HD
        q, k, v, do = attn_inputs(B, L, H, hd, dtype, dev, gen)
        o, lse = ca.flash_fwd(q, k, v, slopes)
        o_w, lse_w = fp.flash_fwd_plain(q, k, v, slopes)
        got = ca.flash_bwd(q, k, v, o, do, lse, slopes)
        want = fp.flash_bwd_plain(q, k, v, o, do, lse, slopes)
        torch.cuda.synchronize()
        compare(f"K7 alibi hd {hd} {dn} o", o, o_w, dn)
        compare(f"K7 alibi hd {hd} {dn} lse", lse, lse_w, dn, tol=F32_TOL)
        for n, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            compare(f"K8 alibi hd {hd} {dn} {n}", g_, w_, dn)
        del q, k, v, do, o, lse, o_w, lse_w, got, want
        torch.cuda.empty_cache()


# Above hd 128 the kernels take multiples of 128 in 128-wide slices; 160
# reaches them through flash_attention zero-padded to 256. A small shape.
ATTN_WIDE_HDS = (256, 160)
ATTN_WIDE_SHAPE = (4, 512, 4)  # B, L, H


def attn_wide_head_dims(dev, gen):
    """K7 and K8 above hd 128, fp32 and bf16, ALiBi, 4 x 512, H 4, against
    their plain versions, forward and backward: both wrappers at hd 256,
    flash_attention (forward and autograd) at hd 160; at hd 256 each
    kernel's time beside the plain version's, SDPA's (the ALiBi bias
    materialised) and the bound. Then the path: a 2-layer BERT with 3 heads
    of 256 (d_model 768), one bf16 forward and mlm_loss backward through
    the model, counted (the wide K7 and K8 once a layer). Returns (the
    results by kernel, the path's launches)."""
    import torch

    from plantcaduceus_tpu_torch.models import bert
    from plantcaduceus_tpu_torch.models.caduceus import mlm_loss
    from plantcaduceus_tpu_torch.ops import cuda_attention as ca
    from plantcaduceus_tpu_torch.ops import flash_plain as fp
    from plantcaduceus_tpu_torch.ops.attention import alibi_bias, alibi_slopes
    from plantcaduceus_tpu_torch.train.step import to_device

    B, L, H = ATTN_WIDE_SHAPE
    slopes = alibi_slopes(H, dev)
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "library_ms": {}, "bound": {}}
           for k in ("attn_fwd_hd256", "attn_bwd_hd256")}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for hd in ATTN_WIDE_HDS:
            q, k, v, do = attn_inputs(B, L, H, hd, dtype, dev, gen)
            o_w, lse_w = fp.flash_fwd_plain(q, k, v, slopes)
            want = fp.flash_bwd_plain(q, k, v, o_w, do, lse_w, slopes)
            if hd % 128 == 0:
                o, lse = ca.flash_fwd(q, k, v, slopes)
                got = ca.flash_bwd(q, k, v, o, do, lse, slopes)
                torch.cuda.synchronize()
                compare(f"K7 wide hd {hd} {dn} lse", lse, lse_w, dn, tol=F32_TOL)
            else:
                ins = [t.clone().requires_grad_() for t in (q, k, v)]
                o = ca.flash_attention(*ins, alibi_slopes=slopes)
                got = torch.autograd.grad(o, ins, do)
                torch.cuda.synchronize()
            res["attn_fwd_hd256"]["err"] = max(res["attn_fwd_hd256"]["err"], compare(
                f"K7 wide hd {hd} {dn} o", o, o_w, dn))
            for n, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                res["attn_bwd_hd256"]["err"] = max(res["attn_bwd_hd256"]["err"], compare(
                    f"K8 wide hd {hd} {dn} {n}", g_, w_, dn))
            if hd % 128 == 0:
                bias = alibi_bias(H, L, dev).to(dtype)
                for name, kern, fn, plain, lib in (
                        ("attn_fwd_hd256", "attn_fwd", lambda: ca.flash_fwd(q, k, v, slopes),
                         lambda: fp.flash_fwd_plain(q, k, v, slopes),
                         sdpa_fn(q, k, v, bias, False)),
                        ("attn_bwd_hd256", "attn_bwd",
                         lambda: ca.flash_bwd(q, k, v, o, do, lse, slopes),
                         lambda: fp.flash_bwd_plain(q, k, v, o, do, lse, slopes),
                         sdpa_fn(q, k, v, bias, True))):
                    r = res[name]
                    r["ms"][dn] = time_ms(fn, 5)
                    r["plain_ms"][dn] = time_ms(plain, 1, warmup=1)
                    r["library_ms"][dn] = time_ms(lib, 5)
                    r["bound"][dn] = work_bound(attn_work(B, L, H, hd, dtype.itemsize, kern), dn)
                    b, by, _ = r["bound"][dn]
                    log(f"  {name} ({dn}, ALiBi, {B} x {L}, H {H}): {r['ms'][dn]:.3f} ms; plain "
                        f"{r['plain_ms'][dn]:.2f} ms; SDPA {r['library_ms'][dn]:.3f} ms; bound "
                        f"{b:.3f} ms by {by}")
                del bias
            del q, k, v, do, o, o_w, lse_w, got, want
            torch.cuda.empty_cache()
    # the path: BERT with heads of 256, a bf16 forward and backward
    cfg = bert.BertConfig(**dict(BERT_BASE, n_layer=2, n_heads=3))
    model = bert.build(cfg, seed=47, device=dev).requires_grad_()
    batch = to_device(mlm_batches(B, 1, 48)[0], dev)
    reset_counts()
    logits = model(batch["input_ids"], dtype=torch.bfloat16)["logits"]
    loss = mlm_loss(logits, batch["labels"], batch["loss_weights"])
    loss.backward()
    torch.cuda.synchronize()
    c = counts()
    if c != only(attn_fwd_wide=cfg.n_layer, attn_bwd_wide=cfg.n_layer) or \
            not math.isfinite(loss.item()):
        fail(f"phase 3e: BERT at hd {cfg.head_dim} launched {c} (expected the wide K7 and "
             f"K8 {cfg.n_layer} each), loss {loss.item()}")
    log(f"  BERT, {cfg.n_layer} layers of {cfg.n_heads} heads of {cfg.head_dim}, bf16, batch "
        f"{B} x {L}: loss {loss.item():.4f}; launches wide K7 {c['attn_fwd_wide']}, wide K8 "
        f"{c['attn_bwd_wide']}")
    del model
    return res, c


def phase_attn_kernels(dev):
    """K7 and K8 against their plain versions in four bias cases, fp32 and
    bf16: K7 at the forward shape (128 x 512, H 12, hd 64) and both at the
    training shape (32 x 512); the ALiBi case timed beside the plain version
    and SDPA; one bf16 timing row at L 8192 (B 1)."""
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_attention as ca
    from plantcaduceus_tpu_torch.ops import flash_plain as fp
    from plantcaduceus_tpu_torch.ops.attention import alibi_bias, alibi_slopes

    H, hd, L = BERT_BASE["n_heads"], BERT_BASE["d_model"] // BERT_BASE["n_heads"], BERT_L
    fwd_b, train_b = BERT_BATCH[:2]
    log(f"phase 3e: attention kernels vs plain versions (H {H}, hd {hd}, L {L}; forward "
        f"{fwd_b} windows, training {train_b})")
    gen = torch.Generator(device=dev).manual_seed(41)
    slopes = alibi_slopes(H, dev)
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "library_ms": {}, "bound": {}}
           for k in ("attn_fwd", "attn_fwd_train", "attn_bwd")}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, kern in ((fwd_b, "attn_fwd"), (train_b, "attn_fwd_train")):
            q, k, v, do = attn_inputs(B, L, H, hd, dtype, dev, gen)
            for case, kw in ATTN_CASES.items():
                kw = dict(kw)
                sl = slopes if kw.pop("alibi", False) else None
                o, lse = ca.flash_fwd(q, k, v, sl, **kw)
                o_w, lse_w = fp.flash_fwd_plain(q, k, v, sl, **kw)
                torch.cuda.synchronize()
                err = compare(f"K7 {case} {dn} B {B} o", o, o_w, dn)
                compare(f"K7 {case} {dn} B {B} lse", lse, lse_w, dn, tol=F32_TOL)
                res[kern]["err"] = max(res[kern]["err"], err)
                if kern == "attn_fwd_train":
                    got = ca.flash_bwd(q, k, v, o, do, lse, sl, **kw)
                    want = fp.flash_bwd_plain(q, k, v, o, do, lse, sl, **kw)
                    torch.cuda.synchronize()
                    for n, g_, w_ in zip(("dq", "dk", "dv"), got, want):
                        res["attn_bwd"]["err"] = max(res["attn_bwd"]["err"], compare(
                            f"K8 {case} {dn} B {B} {n}", g_, w_, dn))
                    del got, want
                del o_w, lse_w
            # timings, ALiBi (the model's case)
            o, lse = ca.flash_fwd(q, k, v, slopes)
            bias = alibi_bias(H, L, dev).to(dtype)
            r = res[kern]
            r["ms"][dn] = time_ms(lambda: ca.flash_fwd(q, k, v, slopes), 10)
            r["plain_ms"][dn] = time_ms(lambda: fp.flash_fwd_plain(q, k, v, slopes), 2,
                                        warmup=1)
            r["library_ms"][dn] = time_ms(sdpa_fn(q, k, v, bias, False), 10)
            r["bound"][dn] = work_bound(attn_work(B, L, H, hd, dtype.itemsize, "attn_fwd"), dn)
            if kern == "attn_fwd_train":
                r = res["attn_bwd"]
                r["ms"][dn] = time_ms(lambda: ca.flash_bwd(q, k, v, o, do, lse, slopes), 10)
                r["plain_ms"][dn] = time_ms(
                    lambda: fp.flash_bwd_plain(q, k, v, o, do, lse, slopes), 2, warmup=1)
                r["library_ms"][dn] = time_ms(sdpa_fn(q, k, v, bias, True), 10)
                r["bound"][dn] = work_bound(attn_work(B, L, H, hd, dtype.itemsize, "attn_bwd"),
                                            dn)
                r.setdefault("split_ms", {})[dn] = device_ms_by_kernel(
                    lambda: ca.flash_bwd(q, k, v, o, do, lse, slopes))
                log(f"  K8 {dn} B {B} by kernel: " + ", ".join(
                    f"{n} {t:.3f} ms" for n, t in r["split_ms"][dn].items()))
            # the other cases' K7 times (forward shape), for the log
            if kern == "attn_fwd":
                for case in ("causal", "window128"):
                    kw = ATTN_CASES[case]
                    t_ = time_ms(lambda: ca.flash_fwd(q, k, v, None, **kw), 10)
                    b_ = work_bound(attn_work(B, L, H, hd, dtype.itemsize, "attn_fwd",
                                              kw.get("causal", False), kw.get("window")), dn)
                    log(f"  K7 {case} {dn} B {B}: {t_:.3f} ms; bound {b_[0]:.3f} ms by {b_[1]}")
            del q, k, v, do, o, lse, bias
            torch.cuda.empty_cache()
    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, ALiBi): {r['ms'][dn]:.3f} ms; plain {r['plain_ms'][dn]:.2f} "
                f"ms; SDPA {r['library_ms'][dn]:.3f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, sfu "
                f"{parts['sfu'] * 1e3:.3f}, bf16 tensor cores {parts['tc'] * 1e3:.3f} ms)")

    attn_other_head_dims(dev, slopes, gen)
    res["wide"] = attn_wide_head_dims(dev, gen)

    # PlantCAD2's context: L 8192, one window, ALiBi, bf16
    B8, L8 = 1, LONG_L
    q, k, v, _ = attn_inputs(B8, L8, H, hd, torch.bfloat16, dev, gen)
    o, _ = ca.flash_fwd(q, k, v, slopes)
    o_w, _ = fp.flash_fwd_plain(q, k, v, slopes)
    torch.cuda.synchronize()
    compare(f"K7 alibi bfloat16 L {L8} o", o, o_w, "bfloat16")
    del o_w
    bias = alibi_bias(H, L8, dev).to(torch.bfloat16)
    b, by, _ = work_bound(attn_work(B8, L8, H, hd, 2, "attn_fwd"), "bfloat16")
    res["attn_fwd"]["l8192"] = dict(
        ms=time_ms(lambda: ca.flash_fwd(q, k, v, slopes), 5),
        plain_ms=time_ms(lambda: fp.flash_fwd_plain(q, k, v, slopes), 1, warmup=1),
        library_ms=time_ms(sdpa_fn(q, k, v, bias, False), 5), bound_ms=b, bound_by=by)
    r = res["attn_fwd"]["l8192"]
    log(f"  attn_fwd (bfloat16, ALiBi, {B8} x {L8}, H {H}): {r['ms']:.3f} ms; plain "
        f"{r['plain_ms']:.1f} ms; SDPA with a {bias.numel() * 2 / 1e9:.2f} GB bias "
        f"{r['library_ms']:.3f} ms; bound {b:.3f} ms by {by}")
    del q, k, v, o, bias
    torch.cuda.empty_cache()
    return res


def bert_base(dev, n_layer=None, seed=0):
    from plantcaduceus_tpu_torch.models import bert

    cfg = bert.BertConfig(**dict(BERT_BASE, **({"n_layer": n_layer} if n_layer else {})))
    return cfg, bert.build(cfg, seed=seed, device=dev)


def phase_bert_forward(dev):
    """The BERT-Base forward at batch 128 x 512, fp32, K7 against the
    einsum path (4c); the steady bf16 forward rate, model resident (6c)."""
    import torch

    bs = BERT_BATCH[0]
    log(f"phase 4c: BERT-Base forward, kernels vs plain path (fp32, batch {bs} x {BERT_L} bp)")
    cfg, model = bert_base(dev)
    model.eval()
    gen = torch.Generator(device=dev).manual_seed(43)
    ids = torch.randint(7, 11, (bs, BERT_L), generator=gen, device=dev)
    with torch.inference_mode():
        reset_counts()
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        c = counts()
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
        torch.cuda.synchronize()
    if c != only(attn_fwd=cfg.n_layer):
        fail(f"BERT forward launched {c}; expected attn_fwd={cfg.n_layer} only")
    d = (got - want).abs().max().item()
    scale = want.abs().max().item()
    log(f"  logits {tuple(got.shape)}: max_abs_err={d:.3e} (max |logit| {scale:.3e}, "
        f"tol {FORWARD_TOL:.0e} rel); launches {dict((k, v) for k, v in c.items() if v)}")
    if not (torch.isfinite(got).all() and d <= FORWARD_TOL * scale):
        fail("BERT forward with kernels disagrees with the plain path")
    del got, want

    log(f"phase 6c: BERT-Base steady-state forward rate (bf16, batch {bs} x {BERT_L} bp)")
    batches = [torch.randint(7, 11, (bs, BERT_L), generator=gen, device=dev) for _ in range(12)]
    with torch.inference_mode():
        model(batches[0])
        torch.cuda.synchronize()
        reset_counts()
        t = time.perf_counter()
        outs = [model(b)["logits"] for b in batches]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        c = counts()
    if c != only(attn_fwd=cfg.n_layer * len(batches)):
        fail(f"BERT steady forward launched {c}")
    if not all(torch.isfinite(o).all() for o in outs):
        fail("bf16 BERT forward produced non-finite logits")
    wps = bs * len(batches) / secs
    log(f"  {wps:.1f} windows/s ({len(batches)} batches of {bs}, {secs * 1e3 / len(batches):.2f} "
        f"ms per batch, bf16, model resident); K7 launches {c['attn_fwd']}")
    return wps, c["attn_fwd"]


def mlm_batches(bs, n, seed):
    """``n`` seeded masked-LM batches of ``bs`` synthetic 512-bp windows (15%
    of positions masked, the port's collator)."""
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    seqs = data_lib.sequence_source("synthetic", window=BERT_L, synthetic_n=max(bs * n, 16),
                                    seed=seed)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), bs, seed=seed)
    return [ds.batch_at(i) for i in range(n)]


def phase_bert_grads(dev):
    """One fp32 mlm_loss gradient through BERT-Base width at 2 layers, batch
    8 x 512: K7/K8 against autograd through the einsum path (8c)."""
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import mlm_loss
    from plantcaduceus_tpu_torch.train.step import to_device

    bs = BERT_BATCH[2]
    log(f"phase 8c: one fp32 mlm_loss gradient, BERT-Base width, 2 layers, batch {bs} x "
        f"{BERT_L} bp, kernels vs plain path")
    batch = to_device(mlm_batches(bs, 1, 45)[0], dev)
    grads = {}
    for use_kernels in (True, False):
        cfg, model = bert_base(dev, n_layer=2, seed=46)
        model.requires_grad_()
        reset_counts()
        logits = model(batch["input_ids"], dtype=torch.float32, use_kernels=use_kernels)
        mlm_loss(logits["logits"], batch["labels"], batch["loss_weights"]).backward()
        torch.cuda.synchronize()
        c = counts()
        want = only(attn_fwd=2, attn_bwd=2) if use_kernels else only()
        if c != want:
            fail(f"phase 8c (kernels={use_kernels}) launched {c}; expected {want}")
        grads[use_kernels] = {n: p.grad for n, p in model.named_parameters()}
        del model
    worst, worst_name = grads_agree("phase 8c", grads[True], grads[False])
    log(f"  {len(grads[False])} parameter gradients, worst {worst_name} at {worst:.3e} of its "
        f"max |grad| (tol {GRAD_TOL:.0e}); launches K7 2, K8 2")


def bert_trainer(dev, seed):
    """BERT-Base at full depth, trainable, with the port's AdamW (lr 5e-4,
    warmup 5): ``(cfg, model, step)``, where ``step(batch)`` runs one bf16
    step with fp32 master weights and returns the loss on the host."""
    import torch

    from plantcaduceus_tpu_torch.models.caduceus import mlm_loss
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg, model = bert_base(dev, seed=seed)
    model.requires_grad_()
    params = dict(model.named_parameters())
    opt = make_optimizer(learning_rate=5e-4, warmup_steps=5, total_steps=BERT_STEPS,
                         params=params)
    state = opt.init(params)

    def step(b):
        for p in params.values():
            p.grad = None
        loss = mlm_loss(model(b["input_ids"], dtype=torch.bfloat16)["logits"], b["labels"],
                        b["loss_weights"])
        loss.backward()
        opt.update({n: p.grad for n, p in params.items()}, state, params)
        return float(loss.detach())

    return cfg, model, step


def phase_bert_train(dev):
    """30 bf16 training steps of BERT-Base (full depth, batch 32 x 512, fp32
    master weights, the port's AdamW), built from the port's pieces (9c)."""
    import torch

    from plantcaduceus_tpu_torch.train.step import to_device

    steps, bs, L = BERT_STEPS, BERT_BATCH[1], BERT_L
    log(f"phase 9c: BERT-Base pre-training steps (bf16, fp32 master weights, AdamW, batch "
        f"{bs} x {L} bp, {steps} steps)")
    cfg, _, step = bert_trainer(dev, 47)
    batches = [to_device(b, dev) for b in mlm_batches(bs, steps, 48)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    losses, times = [], [time.perf_counter()]
    for b in batches:
        losses.append(step(b))
        times.append(time.perf_counter())
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = only(attn_fwd=steps * cfg.n_layer, attn_bwd=steps * cfg.n_layer)
    if c != want:
        fail(f"phase 9c launched {c}; expected {want}")
    if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
        fail(f"phase 9c: loss did not fall ({losses})")
    step_s = (times[-1] - times[10]) / (steps - 10)
    tps = bs * L / step_s
    log(f"  loss {losses[0]:.4f} -> {losses[-1]:.4f}; steady (steps 11-{steps}) "
        f"{step_s * 1e3:.2f} ms per step, {tps:.1f} tokens/s; peak memory allocated {peak} "
        f"bytes ({peak / 2**30:.2f} GiB); launches per step K7 {cfg.n_layer}, K8 {cfg.n_layer}")
    return c, tps, step_s, peak


def phase_bert_profile(dev):
    """Device time by kernel over one bf16 forward batch (128 x 512) and one
    training step (32 x 512) of BERT-Base (10c)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.train.step import to_device

    log(f"phase 10c: profile one BERT-Base bf16 forward batch ({BERT_BATCH[0]} x {BERT_L}) "
        f"and one training step ({BERT_BATCH[1]} x {BERT_L}) (torch.profiler)")
    _, model, step = bert_trainer(dev, 49)
    ids = torch.randint(7, 11, (BERT_BATCH[0], BERT_L), device=dev)
    batches = [to_device(b, dev) for b in mlm_batches(BERT_BATCH[1], 2, 50)]
    for label, warm, run, top in (
            ("forward batch", lambda: model(ids), lambda: model(ids), 8),
            ("training step", lambda: step(batches[0]), lambda: step(batches[1]), 12)):
        with torch.inference_mode(label == "forward batch"):
            warm()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        log(f"  {label}:")
        report_profile(prof, wall, top)


# ---------------------------------------------------------------------------
# The AR Mamba LM (models/mamba_lm.py, cli/ar_lm.py) at the l20 widths:
# d_model 384, 20 layers, batch 32 x 512 tokens, byte-level (vocab 256).
AR_WIDTHS = dict(d_model=384, n_layer=20, vocab_size=256)
AR_BATCH, AR_L, AR_STEPS = 32, 512, 20
AR_PROMPT, AR_NEW = 32, 96  # decode: prompt and new tokens at batch 1 (the rate's sample)
# Per variant: the phase, its config, the CLI's flags, and the kernels its
# forward (no grad) and its training step launch, once per layer each.
AR_VARIANTS = {
    "mamba1": ("11", dict(d_state=16), ["--d-state", "16"], ("scan_fwd",),
               ("scan_fwd_hb", "scan_bwd")),
    "mamba2": ("11b", dict(ssm_variant="mamba2", d_state=128, head_dim=128, chunk_size=128),
               ["--ssm-variant", "mamba2", "--d-state", "128", "--head-dim", "128",
                "--chunk-size", "128"], ("ssd_fwd",), ("ssd_fwd_fentry", "ssd_bwd")),
}


def phase_ar_lm(variant, dev):
    """The AR Mamba LM: the fp32 forward at full depth and ``nll_loss``
    gradients at the trainer's batch (2 layers; fp32, and bf16 for Mamba-2)
    with the kernels against the plain path; the ``ar_lm train`` CLI (in-process, counted and timed), a
    profiled training step, ``python -m ... sample`` from its checkpoint
    and the decode rate at batch 1. Returns (launches by kernel, figures)."""
    import dataclasses
    import logging

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import ar_lm
    from plantcaduceus_tpu_torch.compat.params import mamba_lm_from_jax_params
    from plantcaduceus_tpu_torch.models import mamba_lm

    phase, kw, flags, k_fwd, k_train = AR_VARIANTS[variant]
    cfg = mamba_lm.MambaLmConfig(**AR_WIDTHS, **kw)
    log(f"phase {phase}: AR Mamba LM, {variant} ({cfg.n_layer} layers, d_model {cfg.d_model}, "
        f"{kw}), batch {AR_BATCH} x {AR_L} tokens")
    launches = dict.fromkeys(k_fwd + k_train, 0)
    ids = torch.randint(0, 256, (AR_BATCH, AR_L), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(11))
    model = mamba_lm.MambaLm(cfg, mamba_lm.init_params(cfg, seed=11)).to(dev)
    with torch.inference_mode():
        reset_counts()
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        c = counts()
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
    if c != only(**{k: cfg.n_layer for k in k_fwd}):
        fail(f"phase {phase} forward launched {c}; expected {k_fwd} {cfg.n_layer} each")
    launches.update({k: launches[k] + c[k] for k in k_fwd})
    d, scale = (got - want).abs().max().item(), want.abs().max().item()
    log(f"  fp32 logits {tuple(got.shape)}: max_abs_err={d:.3e} (max |logit| {scale:.3e}, "
        f"tol {FORWARD_TOL:.0e} rel); launches {c[k_fwd[0]]} {k_fwd[0]}")
    if not (torch.isfinite(got).all() and d <= FORWARD_TOL * scale):
        fail(f"phase {phase}: the forward with kernels disagrees with the plain path")
    del model, got, want

    # nll_loss gradients at the trainer's batch (AR_BATCH x AR_L), 2 layers,
    # kernels against the plain path: fp32 within GRAD_TOL, and for Mamba-2
    # bf16 too (the trainer's dtype; the Mamba-1 mixer casts the scan's
    # inputs to fp32, so K1-hb and K3 run in fp32 whatever the compute
    # dtype). A bf16 gradient through two layers carries bf16's rounding of
    # every product, not one output's: the plain path's own bf16 gradient
    # is ~3e-2 of a leaf's max from its fp32 one. So the bf16 tolerance is
    # measured in the run: with `gap` that worst leaf, a kernel path no
    # further than `gap` from the fp32 gradient lies within 2 * gap of the
    # plain path (triangle inequality); both distances are logged.
    gcfg = dataclasses.replace(cfg, n_layer=2)
    params = mamba_lm.init_params(gcfg, seed=13)
    dtypes = (torch.float32, torch.bfloat16) if variant == "mamba2" else (torch.float32,)
    grads = {}
    for dtype in dtypes:
        for use_kernels in (True, False):
            m = mamba_lm.MambaLm(gcfg, params).to(dev).requires_grad_()
            names, ps = zip(*m.named_parameters())
            reset_counts()
            loss = mamba_lm.nll_loss(m, ids, dtype=dtype, use_kernels=use_kernels)
            grads[dtype, use_kernels] = dict(zip(names, torch.autograd.grad(loss, ps)))
            torch.cuda.synchronize()
            c = counts()
            want = only(**{k: gcfg.n_layer for k in k_train}) if use_kernels else only()
            if c != want:
                fail(f"phase {phase} {dtype} gradient (kernels={use_kernels}) launched {c}; "
                     f"expected {want}")
            if use_kernels:
                launches.update({k: launches[k] + c[k] for k in k_train})
        dn = str(dtype).split(".")[-1]
        tol, note = GRAD_TOL, ""
        if dtype != torch.float32:
            ref = grads[torch.float32, False]
            gaps = {n: (rel_gap(grads[dtype, True][n], g), rel_gap(grads[dtype, False][n], g))
                    for n, g in ref.items()}
            # every leaf's gap from the fp32 gradient, kernels beside plain,
            # with its size: where the kernels' excess over plain sits
            log(f"  {dn} gradient against the fp32 one, every leaf (kernels / plain, of its "
                "max |grad|; elements): " + ", ".join(
                    f"{n} {k:.2e} / {p:.2e} ({ref[n].numel()})" for n, (k, p) in gaps.items()))
            excess = {n: k - p for n, (k, p) in gaps.items()}
            top = sorted(excess, key=excess.get, reverse=True)[:4]
            gap = max(p for _, p in gaps.values())
            k_gap = max(k for k, _ in gaps.values())
            tol = 2 * gap
            note = (f"; against the fp32 gradient: plain path {gap:.3e}, kernels {k_gap:.3e} "
                    f"(worst leaf); largest excess of kernels over plain: " + ", ".join(
                        f"{n} {excess[n]:+.2e} ({ref[n].numel()} elements)" for n in top))
        worst, worst_name = grads_agree(f"phase {phase} {dn}", grads[dtype, True],
                                        grads[dtype, False], tol)
        log(f"  {dn} nll_loss gradient (2 layers, {AR_BATCH} rows x {AR_L}): "
            f"{len(grads[dtype, False])} parameters, worst {worst_name} at {worst:.3e} of its "
            f"max |grad| (tol {tol:.3e}){note}; launches "
            f"{', '.join(f'{k} {gcfg.n_layer}' for k in k_train)}")
    del grads

    tmp = REPO / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    ckpt = tmp / f"ar_lm_{variant}.npz"
    args = ["train", "--data", str(REPO / "SURVEY.md"), "--seq-len", str(AR_L), "--batch",
            str(AR_BATCH), "--steps", str(AR_STEPS), "--d-model", str(cfg.d_model),
            "--n-layer", str(cfg.n_layer), "--log-every", "1", "--output", str(ckpt), *flags]
    steps = []  # (step, bits/dim, host time once the step's loss reached the host)

    class StepLog(logging.Handler):
        def emit(self, record):
            if isinstance(record.msg, str) and record.msg.startswith("step "):
                steps.append((record.args[0], record.args[1], time.perf_counter()))

    handler = StepLog()
    cli_log = logging.getLogger("plantcaduceus_tpu_torch.cli.ar_lm")
    cli_log.addHandler(handler)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    ar_lm.main(args)
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    cli_log.removeHandler(handler)
    bpd = [s[1] for s in steps]
    if [s[0] for s in steps] != list(range(1, AR_STEPS + 1)) or not all(map(math.isfinite, bpd)):
        fail(f"phase {phase}: bad step log {steps}")
    if not bpd[-1] < bpd[0]:
        fail(f"phase {phase}: bits/dim did not fall ({bpd[0]} -> {bpd[-1]})")
    want = only(**{k: AR_STEPS * cfg.n_layer for k in k_train})
    if c != want:
        fail(f"phase {phase} ar_lm train launched {c}; expected {want}")
    launches.update({k: launches[k] + c[k] for k in k_train})
    times = {s[0]: s[2] for s in steps}
    step_s = (times[AR_STEPS] - times[10]) / (AR_STEPS - 10)
    tps = AR_BATCH * AR_L / step_s
    log(f"  ar_lm train (bf16, SURVEY.md bytes, {AR_STEPS} steps): {wall:.1f} s in all; bits/dim "
        f"{bpd[0]:.4f} -> {bpd[-1]:.4f}; steps 11-{AR_STEPS}: {step_s * 1e3:.2f} ms per step, "
        f"{tps:.1f} tokens/s; peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"launches {', '.join(f'{k} {c[k]}' for k in k_train)}")
    ar_step_profile(cfg, dev, ids)

    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.ar_lm", "sample",
                          str(ckpt), "--prompt-len", str(AR_PROMPT), "--n-new", "64"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"ar_lm sample exited {res.returncode}:\n{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    if len(out["prompt"]) != AR_PROMPT or len(out["generated"]) != 64 or \
            not all(0 <= t < 256 for t in out["generated"]):
        fail(f"ar_lm sample printed {out}")

    targs, tree = ar_lm._load_ckpt(ckpt)
    model = mamba_lm_from_jax_params(tree, ar_lm._config(targs)).to(dev)
    prompt = torch.tensor(out["prompt"], device=dev)[None]
    toks = mamba_lm.generate(model, prompt, 64)  # the CLI's greedy decode, bf16
    if toks[0].tolist() != out["generated"]:
        fail("greedy decode in-process differs from python -m ... sample")
    mamba_lm.generate(model, prompt, 8)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    mamba_lm.generate(model, prompt, AR_NEW)
    torch.cuda.synchronize()
    dec = time.perf_counter() - t
    n_steps = AR_PROMPT + AR_NEW - 1  # prefill steps, then one per new token but the last
    log(f"  python -m ... sample: greedy, 64 tokens after a {AR_PROMPT}-token prompt, equal "
        f"to the in-process decode; decode at batch 1: {n_steps} steps in {dec:.3f} s, "
        f"{dec / n_steps * 1e3:.2f} ms per step, {n_steps / dec:.1f} tokens/s")
    decode_step_profile(model, prompt)
    return launches, dict(tps=tps, step_ms=step_s * 1e3, peak=peak,
                          decode_tps=n_steps / dec, bpd=(bpd[0], bpd[-1]))


def decode_step_profile(model, prompt):
    """Device time by kernel over one decode step at batch 1 (bf16), and
    the host's share: the device is idle while Python issues the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models import mamba_lm

    with torch.inference_mode():
        cache = mamba_lm.init_cache(model.cfg, 1, device=prompt.device)
        logits, cache = mamba_lm.step(model, cache, prompt[:, 0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            mamba_lm.step(model, cache, prompt[:, 1])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0)
    log(f"  profile of one decode step (batch 1, bf16): {n} kernel launches")
    report_profile(prof, wall, 5)


def ar_step_profile(cfg, dev, ids):
    """Device time by kernel over one bf16 training step of the AR LM (the
    CLI's loop body: nll_loss, its gradient, AdamW)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models import mamba_lm
    from plantcaduceus_tpu_torch.train.optimizer import AdamW, make_schedule

    model = mamba_lm.MambaLm(cfg, mamba_lm.init_params(cfg, seed=14)).to(dev).requires_grad_()
    params = dict(model.named_parameters())
    opt = AdamW(make_schedule("constant_with_warmup", 3e-3), weight_decay=1e-4)
    state = opt.init(params)

    def train_step():
        loss = mamba_lm.nll_loss(model, ids)
        opt.update(dict(zip(params, torch.autograd.grad(loss, list(params.values())))),
                   state, params)
        return loss.item()

    train_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        train_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    log("  profile of one training step (bf16):")
    report_profile(prof, wall, 10)


# ---------------------------------------------------------------------------
# PlantCAD2 zero-shot evaluation (cli/zero_shot_eval.py) with pc2-small
# (d_model 768, 24 layers, d_inner 1536, N 16, R 48; random seeded weights)
# at 8192 bp on seeded synthetic TSVs.
EVAL_L, EVAL_ROWS, EVAL_BATCH = 8192, 16, 16
EVAL_CENTER = EVAL_L // 2 - 1
EVAL_MOTIF = f"{EVAL_CENTER - 1},{EVAL_CENTER},{EVAL_CENTER + 1}"


def write_eval_inputs(tmp: Path):
    """The four subcommands' TSVs: 16 rows of 8192 bp each, labels 0/1
    alternating; one motif row with an N inside the motif."""
    import numpy as np

    rng = np.random.default_rng(12)
    bases = np.array(list("ACGT"))

    def seqs():
        return ["".join(rng.choice(bases, EVAL_L)) for _ in range(EVAL_ROWS)]

    labels = [i % 2 for i in range(EVAL_ROWS)]
    motif = seqs()
    motif[3] = motif[3][:EVAL_CENTER] + "N" + motif[3][EVAL_CENTER + 1:]
    tables = {
        "evo": (["sequence", "label"], list(zip(seqs(), labels))),
        "motif": (["sequence", "label"], list(zip(motif, labels))),
        "core": (["sequence", "is_core"], list(zip(seqs(), labels))),
        "sv": (["RefSeq", "MutSeq", "left", "right", "label"],
               list(zip(seqs(), seqs(),  # breakpoints within an eighth of the centre
                        rng.integers(EVAL_L // 2 - EVAL_L // 8, EVAL_L // 2 - EVAL_L // 16,
                                     EVAL_ROWS),
                        rng.integers(EVAL_L // 2 + EVAL_L // 16, EVAL_L // 2 + EVAL_L // 8,
                                     EVAL_ROWS), labels))),
    }
    paths = {}
    for name, (cols, rows) in tables.items():
        paths[name] = tmp / f"eval_{name}.tsv"
        paths[name].write_text("\t".join(cols) + "\n" + "".join(
            "\t".join(map(str, r)) + "\n" for r in rows))
    return paths


EVAL_CMDS = {  # subcommand -> (table, flags, forward passes over the rows)
    "evo_cons": ("evo", ["--token-idx", str(EVAL_CENTER)], 1),
    "motif_acc": ("motif", ["--mask-idx", EVAL_MOTIF, "--motif-len", "3"], 1),
    "core_noncore": ("core", ["--mask-idx", EVAL_MOTIF, "--motif-len", "3",
                              "--label-column", "is_core"], 1),
    "sv_effect": ("sv", ["--flanking", "5"], 2),
}


def phase_eval(dev):
    """The four zero_shot_eval subcommands with pc2-small at 8192 bp
    (in-process, counted and timed), the logits round trip and one full
    subcommand through ``python -m``, the steady rate, K2 at this shape
    against its plain version, a profiled batch, and evo_cons with
    pc2-small-ssd. Returns (K2 launches, K5 launches, figures)."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import zero_shot_eval as zse
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    cfg = CaduceusConfig.preset("pc2-small")
    log(f"phase 12: zero_shot_eval, pc2-small ({cfg.n_layer} layers, d_model {cfg.d_model}, "
        f"random seeded weights), {EVAL_ROWS} rows x {EVAL_L} bp, batch {EVAL_BATCH}, bf16")
    tmp = REPO / "build" / "chip_smoke"
    tmp.mkdir(parents=True, exist_ok=True)
    paths = write_eval_inputs(tmp)
    per_pass = 2 * cfg.n_layer * math.ceil(EVAL_ROWS / EVAL_BATCH)
    k2, metrics, walls = 0, {}, {}
    torch.cuda.reset_peak_memory_stats(dev)
    for cmd, (table, flags, passes) in EVAL_CMDS.items():
        mj = tmp / f"eval_{cmd}.json"
        extra = ["--save-logits", str(tmp / "eval_logits.tsv")] if cmd == "evo_cons" else []
        reset_counts()
        t = time.perf_counter()
        zse.main([cmd, "--repo-id", str(paths[table]), "--model", "pc2-small", "--batch-size",
                  str(EVAL_BATCH), "--metrics-json", str(mj), "--no-progress", *flags, *extra])
        walls[cmd] = time.perf_counter() - t
        c = counts()
        if c != only(mixer_fwd=per_pass * passes):
            fail(f"phase 12 {cmd} launched {c}; expected mixer_fwd={per_pass * passes}")
        k2 += c["mixer_fwd"]
        metrics[cmd] = json.loads(mj.read_text())
        vals = [v for k, v in metrics[cmd].items() if k != "token_idx"]
        if not all(math.isfinite(v) and 0 <= v <= 1 for v in vals):
            fail(f"phase 12 {cmd}: metrics {metrics[cmd]}")
        log(f"  {cmd}: {metrics[cmd]}; {walls[cmd]:.2f} s end to end "
            f"({passes * EVAL_ROWS / walls[cmd]:.2f} windows/s incl. model build); "
            f"mixer_fwd {c['mixer_fwd']}")
    peak = torch.cuda.max_memory_allocated(dev)

    replay = tmp / "eval_evo_cons_replay.json"
    again = tmp / "eval_core_noncore_again.json"
    table, flags, _ = EVAL_CMDS["core_noncore"]
    jobs = [start_module("cli.zero_shot_eval", ["evo_cons", "--repo-id", str(paths["evo"]),
                                                "--token-idx", str(EVAL_CENTER), "--logits-path",
                                                str(tmp / "eval_logits.tsv"), "--metrics-json",
                                                str(replay), "--no-progress"]),
            start_module("cli.zero_shot_eval", ["core_noncore", "--repo-id", str(paths[table]),
                                                "--model", "pc2-small", "--batch-size",
                                                str(EVAL_BATCH), "--metrics-json", str(again),
                                                *flags, "--no-progress"])]
    for job in jobs:
        finish_module(job, timeout=900)
    if json.loads(replay.read_text()) != metrics["evo_cons"]:
        fail("phase 12: --logits-path replay gave other metrics than the run that saved them")
    if json.loads(again.read_text()) != metrics["core_noncore"]:
        fail("phase 12: python -m ... core_noncore gave other metrics than in-process")
    log("  python -m ...: the evo_cons --logits-path replay and a second core_noncore run "
        "give the same metrics exactly")

    model, _, tok = load_model_and_tokenizer("pc2-small")
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=EVAL_BATCH,
                             device=dev)
    seqs = [ln.split("\t")[0] for ln in paths["evo"].read_text().splitlines()[1:]]
    ids = tok.encode_batch(seqs * 2)  # 64 windows, 4 batches
    ids[:, EVAL_CENTER] = tok.mask_token_id
    nuc = nucleotide_ids(tok)
    runner.masked_probs(ids[:EVAL_BATCH], nuc, EVAL_CENTER, progress=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = runner.masked_probs(ids, nuc, EVAL_CENTER, progress=False)
    wps = len(ids) / (time.perf_counter() - t)
    if probs.shape != (len(ids), 4) or not np.isfinite(probs).all():
        fail("phase 12: steady-state probabilities")
    log(f"  steady state: {wps:.2f} windows/s (pc2-small, {EVAL_L} bp, batch {EVAL_BATCH}, "
        f"bf16, model resident); peak memory allocated over the subcommands {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")

    from torch.profiler import ProfilerActivity, profile

    batch = torch.from_numpy(ids[:EVAL_BATCH].astype(np.int64)).to(dev)
    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            runner.model(batch)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
    log(f"  profile of one pc2-small batch ({EVAL_BATCH} x {EVAL_L} bp, bf16):")
    report_profile(prof, wall, 10)
    del runner, model

    # K2 at this path's shape: 2 x 16 rows (the RC stream), one direction each way.
    rows, D, N, R, K = 2 * EVAL_BATCH, cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    w = layer_weights(cfg, 1, dev)
    A = -torch.exp(w["A_log"])
    xi = torch.randn((rows, EVAL_L, D), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(5)).to(torch.bfloat16)
    k2res = {"err": 0.0}
    for g in (0, 1):
        args = (xi, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g])
        got = cuda_mixer.mixer_fwd(*args, reverse=g == 1)
        want = cuda_mixer.mixer_fwd_plain(*args, reverse=g == 1)
        torch.cuda.synchronize()
        k2res["err"] = max(k2res["err"], compare(
            f"K2 mixer_fwd pc2-small bf16 {'rev' if g else 'fwd'}", got, want, "bfloat16"))
        del got, want
    k2res["ms"] = time_ms(lambda: cuda_mixer.mixer_fwd(*args, reverse=True), 10)
    k2res["plain_ms"] = time_ms(lambda: cuda_mixer.mixer_fwd_plain(*args, reverse=True), 1,
                                warmup=0)
    b, by, parts = bound_ms(*mixer_fwd_work(rows, EVAL_L, D, N, R, K, xi.element_size()))
    k2res.update(bound_ms=b, bound_by=by)
    log(f"  K2 at {rows} rows x {EVAL_L} x {D} (bf16, one direction): {k2res['ms']:.3f} ms; "
        f"plain {k2res['plain_ms']:.1f} ms; bound {b:.3f} ms by {by} (bytes "
        f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, sfu "
        f"{parts['sfu'] * 1e3:.3f} ms)")
    del xi

    ssd_cfg = CaduceusConfig.preset("pc2-small-ssd")
    mj = tmp / "eval_evo_cons_ssd.json"
    reset_counts()
    t = time.perf_counter()
    zse.main(["evo_cons", "--repo-id", str(paths["evo"]), "--model", "pc2-small-ssd",
              "--batch-size", str(EVAL_BATCH), "--metrics-json", str(mj), "--no-progress",
              "--token-idx", str(EVAL_CENTER)])
    wall = time.perf_counter() - t
    c = counts()
    k5 = 2 * ssd_cfg.n_layer * math.ceil(EVAL_ROWS / EVAL_BATCH)
    if c != only(mixer2_fwd=k5):
        fail(f"phase 12 evo_cons pc2-small-ssd launched {c}; expected mixer2_fwd={k5}")
    m = json.loads(mj.read_text())
    if not all(math.isfinite(m[k]) for k in ("auroc", "auprc")):
        fail(f"phase 12 pc2-small-ssd metrics {m}")
    log(f"  evo_cons -model pc2-small-ssd: {m}; {wall:.2f} s end to end; mixer2_fwd {k5}")
    return k2, k5, dict(k2=k2res, wps=wps, walls=walls, peak=peak, metrics=metrics,
                        paths=paths)


# ---------------------------------------------------------------------------
# Phase 13: the XGBoost workload (cli/predict_xgboost.py, cli/train_xgboost.py),
# the scoring server (engine/server.py, cli/serve.py) and the input tools
# (cli/format_vcf.py, cli/mutagenesis.py), all with l20 (random seeded
# weights) on 512-bp windows: K2 on every path.
XGB_ROWS = {"train": 256, "valid": 128, "test": 256}
SERVE_CLIENTS, SERVE_WINDOWS, SERVE_ROUNDS = 8, 48, 4


def write_xgb_inputs(tmp: Path):
    """Seeded train/valid/test TSVs of 512-bp windows with 0/1 labels."""
    import numpy as np

    rng = np.random.default_rng(13)
    bases = np.array(list("ACGT"))
    paths = {}
    for name, n in XGB_ROWS.items():
        paths[name] = tmp / f"xgb_{name}.tsv"
        with open(paths[name], "w") as fh:
            fh.write("sequences\tlabel\n")
            for _ in range(n):
                fh.write("".join(rng.choice(bases, 512)) + f"\t{rng.integers(0, 2)}\n")
    return paths


def xgb_classifier(emb):
    """A binary:logistic XGBoost JSON document over ``emb``'s width (the
    schema of tests/test_xgb_json.py): four depth-2 trees, each threshold
    midway across the widest gap in the middle half of its feature's
    sorted values."""
    import numpy as np

    def threshold(f):
        v = np.unique(emb[:, f].astype(np.float64))
        lo, hi = len(v) // 4, 3 * len(v) // 4
        k = lo + int(np.argmax(np.diff(v[lo:hi + 1])))
        return float((v[k] + v[k + 1]) / 2)

    d = emb.shape[1]
    trees = []
    for t, feats in enumerate([(0, 7, 11), (d - 1, 2, 30), (d // 2, 5, 9), (100, 3, d - 2)]):
        n = 7
        trees.append({
            "tree_param": {"num_nodes": str(n), "num_feature": str(d), "size_leaf_vector": "1"},
            "left_children": [1, 3, 5, -1, -1, -1, -1],
            "right_children": [2, 4, 6, -1, -1, -1, -1],
            "parents": [2147483647] * n, "split_indices": list(feats) + [0] * 4,
            "split_conditions": [threshold(f) for f in feats] + [-0.6 + 0.1 * t, 0.3, -0.2,
                                                                0.7 - 0.2 * t],
            "default_left": [1, 0, 1, 0, 0, 0, 0], "base_weights": [0.0] * n,
            "loss_changes": [0.0] * n, "sum_hessian": [1.0] * n, "split_type": [0] * n,
            "categories": [], "categories_nodes": [], "categories_segments": [],
            "categories_sizes": []})
    return {"learner": {
        "attributes": {}, "feature_names": [], "feature_types": [],
        "gradient_booster": {"model": {
            "gbtree_model_param": {"num_trees": str(len(trees)), "num_parallel_tree": "1"},
            "iteration_indptr": list(range(len(trees) + 1)),
            "tree_info": [0] * len(trees), "trees": trees}, "name": "gbtree"},
        "learner_model_param": {"base_score": "5E-1", "num_class": "0",
                                "num_feature": str(d), "num_target": "1"},
        "objective": {"name": "binary:logistic", "reg_loss_param": {"scale_pos_weight": "1"}},
    }, "version": [2, 0, 3]}


def read_predictions(path):
    rows = [ln.split("\t") for ln in Path(path).read_text().splitlines()]
    if rows[0] != ["label", "prediction"]:
        fail(f"{path}: header {rows[0]}")
    return rows[1:]


def phase_xgboost(cfg, dev):
    """13a: the XGBoost workload with l20. Returns (K2 launches, figures)."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import predict_xgboost, train_xgboost
    from plantcaduceus_tpu_torch.downstream.xgb_json import XgbJsonPredictor
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.zero_shot import read_table
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    log(f"phase 13a: XGBoost workload, l20 preset (random seeded weights), train/valid/test "
        f"{'/'.join(str(n) for n in XGB_ROWS.values())} windows of 512 bp")
    tmp = REPO / "build" / "chip_smoke" / "xgb"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    paths = write_xgb_inputs(tmp)
    per_batch = 2 * cfg.n_layer
    k2 = 0
    model, _, tok = load_model_and_tokenizer("l20")
    test_seqs = [r["sequences"] for r in read_table(paths["test"]).rows]
    ids = tok.encode_batch(test_seqs)
    n_test_batches = math.ceil(len(ids) / 128)

    # fp32 centre embeddings, kernels against the plain path
    runner32 = InferenceRunner(model, cfg, dtype=torch.float32, batch_size=128, device=dev)
    reset_counts()
    emb32 = runner32.center_embeddings(ids, 255, progress=False)
    c = counts()
    if c != only(mixer_fwd_x=per_batch * n_test_batches):
        fail(f"phase 13a fp32 embeddings launched {c}; expected "
             f"mixer_fwd_x={per_batch * n_test_batches}")
    k2 += c["mixer_fwd_x"]
    plain = []
    with torch.inference_mode():
        for i in range(0, len(ids), 128):
            batch = torch.from_numpy(ids[i:i + 128].astype(np.int64)).to(dev)
            h = model(batch, dtype=torch.float32, output_hidden_states=True,
                      use_kernels=False)["hidden_states"].float()[:, 255, :]
            d = h.shape[-1] // 2
            plain.append(((h[:, :d] + h[:, d:].flip(-1)) * 0.5).cpu().numpy())
    plain = np.concatenate(plain)
    err = float(np.abs(emb32 - plain).max())
    scale = float(np.abs(plain).max())
    log(f"  fp32 center_embeddings {emb32.shape}: max_abs_err={err:.3e} (max |embedding| "
        f"{scale:.3e}, tol {FORWARD_TOL:.0e} rel); mixer_fwd_x {c['mixer_fwd_x']}")
    if not (np.isfinite(emb32).all() and err <= FORWARD_TOL * scale):
        fail("phase 13a: fp32 embeddings with the kernels disagree with the plain path")
    clf = tmp / "classifier.json"
    clf.write_text(json.dumps(xgb_classifier(emb32)))

    # predict_xgboost in-process (bf16), against the evaluator on the same
    # runner's embeddings, then through python -m
    out = tmp / "pred.tsv"
    args = ["-input", str(paths["test"]), "-model", "l20", "-classifier", str(clf),
            "-no-progress"]
    reset_counts()
    t = time.perf_counter()
    predict_xgboost.main([*args, "-output", str(out)])
    pred_s = time.perf_counter() - t
    c = counts()
    if c != only(mixer_fwd_x=per_batch * n_test_batches):
        fail(f"phase 13a predict_xgboost launched {c}")
    k2 += c["mixer_fwd_x"]
    rows = read_predictions(out)
    runner16 = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=128, device=dev)
    emb16 = runner16.center_embeddings(ids, 255, progress=False)
    want = [repr(float(p)) for p in XgbJsonPredictor.load(clf).predict_proba(emb16)[:, 1]]
    labels = [r["label"] for r in read_table(paths["test"]).rows]
    if [r[1] for r in rows] != want or [r[0] for r in rows] != labels:
        fail("phase 13a: predict_xgboost's predictions differ from XgbJsonPredictor over the "
             "same runner's embeddings")
    spread = len(set(want))
    log(f"  predict_xgboost (in-process, bf16): {len(rows)} predictions ({spread} distinct) "
        f"in {pred_s:.2f} s end to end, equal to XgbJsonPredictor on the runner's bf16 "
        f"embeddings; mixer_fwd_x {c['mixer_fwd_x']}")
    if spread < 3:
        fail("phase 13a: the classifier's trees do not split the windows")
    out2 = tmp / "pred_module.tsv"
    run_module("cli.predict_xgboost", [*args, "-output", str(out2)])
    if out2.read_bytes() != out.read_bytes():
        fail("phase 13a: python -m predict_xgboost wrote another file than in-process")
    log("  python -m ... predict_xgboost: the same file, byte for byte")

    # train_xgboost -test_only with the JSON as the seed-42 model, plain and chunked
    only_flags = ["-test", str(paths["test"]), "-test_only", "-model", "l20", "-no-progress"]
    preds, walls = {}, {}
    for name, extra in (("plain", []), ("chunked", ["-save_memory", "-chunk_size", "100"])):
        d = tmp / f"test_only_{name}"
        d.mkdir()
        shutil.copy(clf, d / "seed_42_XGBoost.json")
        reset_counts()
        t = time.perf_counter()
        train_xgboost.main([*only_flags, "-output", str(d), *extra])
        walls[name] = time.perf_counter() - t
        c = counts()
        want_k2 = per_batch * (n_test_batches if name == "plain"
                               else sum(math.ceil(min(100, len(ids) - i) / 128)
                                        for i in range(0, len(ids), 100)))
        if c != only(mixer_fwd_x=want_k2):
            fail(f"phase 13a -test_only {name} launched {c}; expected mixer_fwd_x={want_k2}")
        k2 += c["mixer_fwd_x"]
        preds[name] = np.load(d / "seed_42_xgb_test_predictions.npz")["predictions"]
        if not (d / "seed_42_xgb_test_metrics.txt").is_file():
            fail(f"phase 13a -test_only {name}: no metrics file")
    gap = float(np.abs(preds["plain"] - preds["chunked"]).max())
    if gap != 0.0:
        fail(f"phase 13a: -save_memory predictions differ from the plain run by {gap:.3e}")
    reset_counts()
    train_xgboost.main([*only_flags, "-output", str(tmp / "test_only_plain")])
    c = counts()
    again = np.load(tmp / "test_only_plain" / "seed_42_xgb_test_predictions.npz")["predictions"]
    if c != only() or not np.array_equal(again, preds["plain"]):
        fail(f"phase 13a: the rerun launched {c} or gave other predictions")
    log(f"  train_xgboost -test_only: plain {walls['plain']:.2f} s, -save_memory -chunk_size "
        f"100 {walls['chunked']:.2f} s, equal predictions; the rerun reads the caches, "
        f"mixer_fwd_x 0")

    # the fit: embeddings cached first, then sklearn/xgboost or JAX's ImportError
    fit = tmp / "fit"
    fit_flags = ["-train", str(paths["train"]), "-valid", str(paths["valid"]), "-model", "l20",
                 "-output", str(fit), "-no-progress"]
    have = []
    for pkg in ("xgboost", "sklearn"):
        try:
            __import__(pkg)
            have.append(pkg)
        except ImportError:
            pass
    reset_counts()
    raised = None
    try:
        train_xgboost.main(fit_flags)
    except ImportError as e:  # the JAX package's behaviour without either backend
        raised = e
    c = counts()
    want_k2 = per_batch * sum(math.ceil(XGB_ROWS[k] / 128) for k in ("train", "valid"))
    if c != only(mixer_fwd_x=want_k2) or not (fit / "train_valid_embeddings.npz").is_file():
        fail(f"phase 13a fit: launched {c} (expected mixer_fwd_x={want_k2}) or no cached "
             "embeddings")
    k2 += c["mixer_fwd_x"]
    if have:
        if raised is not None or not (fit / "seed_42_xgb_valid_metrics.txt").is_file():
            fail(f"phase 13a fit with {have}: {raised!r} or no valid metrics")
        log(f"  train_xgboost fit ({have[0]}): embeddings cached, valid metrics "
            f"{(fit / 'seed_42_xgb_valid_metrics.txt').read_text().split()}")
    else:
        if raised is None or "sklearn" not in str(raised):
            fail(f"phase 13a fit without xgboost or sklearn: expected sklearn's ImportError, "
                 f"got {raised!r}")
        log(f"  train_xgboost fit: embeddings cached ({want_k2} mixer_fwd_x), then {raised!r} "
            "as the JAX package raises without xgboost or sklearn")

    # steady embedding rate at batch 128, bf16
    many = np.concatenate([ids] * 4)  # 1024 windows, 8 batches
    runner16.center_embeddings(ids[:128], 255, progress=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    emb = runner16.center_embeddings(many, 255, progress=False)
    ewps = len(many) / (time.perf_counter() - t)
    if not np.isfinite(emb).all():
        fail("phase 13a: steady embeddings not finite")
    log(f"  steady center_embeddings: {ewps:.1f} windows/s (l20, 512 bp, batch 128, bf16; "
        f"{len(many)} windows, model resident)")
    del runner16, runner32, model
    return k2, dict(ewps=ewps, err=err, predict_s=pred_s)


def serve_round(port, items_by_client):
    """Each client thread posts its /score items at once; the replies."""
    import threading
    import urllib.error
    import urllib.request

    replies = [None] * len(items_by_client)

    def one(i):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                     data=json.dumps({"items": items_by_client[i]}).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                replies[i] = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            replies[i] = (e.code, e.read().decode()[-500:])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(items_by_client))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for code, body in replies:
        if code != 200:
            fail(f"phase 13b: the server replied {code}: {body}")
    return [body["scores"] for _, body in replies]


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_serve(cfg, dev, tsv, wps_inproc):
    """13b: the scoring server with l20: fp32 parity with in-process
    scoring, the bf16 rate through it, and ``python -m ...serve``.
    Returns (K2 launches, figures)."""
    import urllib.request

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.server import ScoringServer, ScoringService
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    n = SERVE_CLIENTS * SERVE_WINDOWS
    log(f"phase 13b: scoring server, l20 preset, {SERVE_CLIENTS} client threads x "
        f"{SERVE_WINDOWS} windows of phase 6's TSV")
    table = zero_shot.read_table(tsv)
    rows = [r for r in table.rows
            if r["ref"] in zero_shot.NUCLEOTIDES and r["alt"] in zero_shot.NUCLEOTIDES][:n]
    items = [{"sequence": r["sequences"], "ref": r["ref"], "alt": r["alt"]} for r in rows]
    by_client = [items[i::SERVE_CLIENTS] for i in range(SERVE_CLIENTS)]
    model, _, tok = load_model_and_tokenizer("l20")
    per_forward = 2 * cfg.n_layer
    k2 = 0
    figures = {}
    for dtype in (torch.float32, torch.bfloat16):
        runner = InferenceRunner(model, cfg, dtype=dtype, batch_size=128, device=dev)
        server = ScoringServer(ScoringService(runner, tok), port=0, model_name="l20")
        server.start_background()
        try:
            if dtype == torch.float32:
                reset_counts()
                got = serve_round(server.port, by_client)
                c = counts()
                groups = server.batcher.groups
                want = zero_shot.score_table(runner, tok, zero_shot.Table(table.columns, rows),
                                             progress=False)
                want = np.array([r["zeroShotScore"] for r in want.rows])
                got_flat = np.empty(n)
                for i, scores in enumerate(got):
                    got_flat[i::SERVE_CLIENTS] = scores
                d = float(np.abs(got_flat - want).max())
                fwd = c["mixer_fwd_x"] // per_forward
                log(f"  fp32: {n} windows in {SERVE_CLIENTS} concurrent requests, all 200; "
                    f"max |server - score_table| {d:.3e} (tol 1e-4); the batcher ran {groups} "
                    f"coalesced groups, {fwd} forwards of 128 rows (mixer_fwd_x "
                    f"{c['mixer_fwd_x']})")
                if not (np.isfinite(got_flat).all() and d <= 1e-4):
                    fail("phase 13b: the server's fp32 scores differ from in-process scoring")
                if c["mixer_fwd_x"] % per_forward or c != only(mixer_fwd_x=c["mixer_fwd_x"]):
                    fail(f"phase 13b launched {c}")
                k2 += c["mixer_fwd_x"]
                figures.update(groups=groups, forwards=fwd, err=d)
            else:
                serve_round(server.port, by_client)  # warm
                reset_counts()
                t = time.perf_counter()
                for _ in range(SERVE_ROUNDS):
                    serve_round(server.port, by_client)
                secs = time.perf_counter() - t
                c = counts()
                k2 += c["mixer_fwd_x"]
                figures.update(wps=SERVE_ROUNDS * n / secs,
                               rps=SERVE_ROUNDS * SERVE_CLIENTS / secs,
                               bf16_forwards=c["mixer_fwd_x"] // per_forward)
                log(f"  bf16: {figures['wps']:.1f} windows/s, {figures['rps']:.2f} requests/s "
                    f"through the server ({SERVE_ROUNDS} rounds of {SERVE_CLIENTS} x "
                    f"{SERVE_WINDOWS}; {figures['bf16_forwards']} forwards); in-process steady "
                    f"state {wps_inproc:.1f} windows/s (phase 6)")
        finally:
            server.shutdown()
        del runner
    del model

    port = free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    log_path = REPO / "build" / "chip_smoke" / "serve.log"
    log_fh = open(log_path, "w")
    proc = subprocess.Popen([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.serve",
                             "-model", "l20", "-warmup", "-port", str(port)], cwd=REPO, env=env,
                            stdout=log_fh, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}"
    try:
        t = time.perf_counter()
        while True:
            if proc.poll() is not None:
                fail(f"python -m ...serve exited {proc.returncode}:\n"
                     f"{log_path.read_text()[-4000:]}")
            try:
                with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                if time.perf_counter() - t > 300:
                    fail("python -m ...serve did not answer /healthz within 300 s")
                time.sleep(1)
        ready = time.perf_counter() - t
        seqs = [it["sequence"] for it in items[:4]]
        replies = {}
        for path, body in (("/score", {"items": items[:4]}),
                           ("/masked_probs", {"sequences": seqs}),
                           ("/embed", {"sequences": seqs})):
            req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:  # a 4xx/5xx raises
                replies[path] = json.loads(r.read())
        vals = [np.asarray(replies[path][key]) for path, key in (
            ("/score", "scores"), ("/masked_probs", "probs"), ("/embed", "embeddings"))]
        if not all(np.isfinite(v).all() for v in vals) or vals[1].shape != (4, 4):
            fail(f"python -m ...serve: bad replies {[v.shape for v in vals]}")
        log(f"  python -m ...serve -warmup: {health} after {ready:.1f} s; /score, "
            f"/masked_probs {vals[1].shape}, /embed {vals[2].shape}: 200, finite")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        log_fh.close()
    return k2, figures


def phase_tools(cfg, dev, fa, vcf):
    """13c: format_vcf and mutagenesis simulate on phase 6's FASTA, scored
    on the card. Returns K2 launches."""
    import numpy as np

    from plantcaduceus_tpu_torch.cli import format_vcf, mutagenesis
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score
    from plantcaduceus_tpu_torch.io.fasta import read_fasta

    log("phase 13c: input tools (format_vcf, mutagenesis simulate) scored with l20 on the card")
    tmp = REPO / "build" / "chip_smoke" / "tools"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    fp32 = ["-model", "l20", "-dtype", "float32", "-no-progress"]
    k2 = 0

    reset_counts()
    format_vcf.main(["-input-vcf", str(vcf), "-input-fasta", str(fa),
                     "-output", str(tmp / "fmt.tsv")])
    score(["-input-table", str(tmp / "fmt.tsv"), "-output", str(tmp / "fmt_scores.tsv"), *fp32])
    score(["-input-vcf", str(vcf), "-input-fasta", str(fa), "-output",
           str(tmp / "scored.vcf"), *fp32])
    c = counts()
    if c != only(mixer_fwd_x=c["mixer_fwd_x"]) or not c["mixer_fwd_x"]:
        fail(f"phase 13c: the two fp32 scoring runs launched {c}")
    k2 += c["mixer_fwd_x"]
    table = [float(ln.split("\t")[7])
             for ln in (tmp / "fmt_scores.tsv").read_text().splitlines()[1:]]
    from_vcf = [float(v) for ln in (tmp / "scored.vcf").read_text().splitlines()
                if not ln.startswith("#")
                for v in ln.split("\t")[7].split("plantCAD_zero_shot=")[1].split(",")
                if v != "."]
    d = max(abs(a - b) for a, b in zip(table, from_vcf)) if table else math.inf
    log(f"  format_vcf -> zero_shot_score -input-table (fp32): {len(table)} rows; VCF mode "
        f"{len(from_vcf)} SNV alts; max |difference| {d:.3e} (tol 1e-4); mixer_fwd_x "
        f"{c['mixer_fwd_x']}")
    if len(table) != len(from_vcf) or not d <= 1e-4:
        fail("phase 13c: format_vcf's table scores differ from the VCF mode's")

    chroms = read_fasta(fa)
    gff = tmp / "genes.gff"
    genes = [(1000, 1100), (2500, 2560), (10, 60)]  # the last overhangs with the flank
    gff.write_text("##gff-version 3\n" + "".join(
        f"chr1\tsrc\tgene\t{s}\t{e}\t.\t+\t.\tID=g{i}\n" for i, (s, e) in enumerate(genes)))
    flank = 50
    region = set()
    for s, e in genes:
        if s - flank > 0 and e + flank <= len(chroms["chr1"]):
            region.update(range(s - flank, e + flank + 1))
    n_snps = 3 * sum(chroms["chr1"][p - 1].upper() in "ACGT" for p in region)
    mutagenesis.main(["simulate", "-g", str(gff), "-f", str(fa), "-o", str(tmp / "sim.vcf"),
                      "-c", "chr1", "-k", str(flank)])
    reset_counts()
    t = time.perf_counter()
    score(["-input-vcf", str(tmp / "sim.vcf"), "-input-fasta", str(fa), "-output",
           str(tmp / "sim_scored.vcf"), "-model", "l20", "-no-progress"])
    secs = time.perf_counter() - t
    c = counts()
    k2 += c["mixer_fwd_x"]
    recs = [ln.split("\t") for ln in (tmp / "sim_scored.vcf").read_text().splitlines()
            if not ln.startswith("#")]
    vals = np.array([float(r[7].split("plantCAD_zero_shot=")[1]) for r in recs])
    windows = len(region)
    want_k2 = 2 * cfg.n_layer * math.ceil(windows / 128)
    log(f"  mutagenesis simulate (flank {flank}) -> zero_shot_score -input-vcf (bf16): "
        f"{len(recs)} SNPs scored (3 x {n_snps // 3} ACGT bases), {windows} windows in "
        f"{secs:.2f} s end to end; mixer_fwd_x {c['mixer_fwd_x']}")
    if len(recs) != n_snps or not np.isfinite(vals).all() or c != only(mixer_fwd_x=want_k2):
        fail(f"phase 13c: mutagenesis scoring gave {len(recs)} records (expected {n_snps}), "
             f"finite {np.isfinite(vals).all()}, launches {c} (expected mixer_fwd_x={want_k2})")
    return k2


# ---------------------------------------------------------------------------
# Phase 14: LoRA and full fine-tuning (train/lora.py, cli/lora_fine_tune.py)

FT_ROWS = {"train": 256, "valid": 64}
FT_STEPS, FT_SAVE, FT_BATCH, FT_ACCUM = 6, 3, 8, 4
FT_EVAL_BATCH = 16
FT_ARGS = ["--train-batch-size", str(FT_BATCH), "--grad-accum", str(FT_ACCUM),
           "--lora-dropout", "0.1", "--learning-rate", "1e-3", "--warmup-steps", "2",
           "--save-steps", str(FT_SAVE), "--eval-steps", str(FT_SAVE), "--logging-steps", "1",
           "--eval-batch-size", str(FT_EVAL_BATCH)]
PC2_L, PC2_BATCH, PC2_STEPS = 600, 8, 3  # the PlantCAD2 LoRA recipe (docs/PLANTCAD2.md)


def write_ft_inputs(tmp: Path):
    """Seeded train/valid TSVs of 512-bp windows, labelled 1 where the
    window's GC share exceeds one half."""
    import numpy as np

    rng = np.random.default_rng(14)
    bases = np.array(list("ACGT"))
    paths = {}
    for name, n in FT_ROWS.items():
        paths[name] = tmp / f"ft_{name}.tsv"
        with open(paths[name], "w") as fh:
            fh.write("sequence\tlabel\n")
            for _ in range(n):
                seq = "".join(rng.choice(bases, 512, p=rng.dirichlet([4, 4, 4, 4])))
                fh.write(f"{seq}\t{int(sum(b in 'GC' for b in seq) > 256)}\n")
    return paths


def lora_case(cfg, dev, seed, rows, L, num_labels=2):
    """A seeded base model on the card, adapters with b drawn (so every
    adapter leaf has a gradient), a head, ids and labels."""
    import torch

    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.train import lora

    model = Caduceus(cfg, init_params(cfg, seed=seed)).to(dev)
    gen = torch.Generator().manual_seed(seed)
    adapters = lora.init_lora(gen, model, lora.LoraConfig())
    for ab in adapters.values():
        ab["b"].normal_(0.0, 0.02, generator=gen)
    head = heads.init_head(gen, cfg, num_labels)
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(7, 11, (rows, L), generator=g, device=dev)
    labels = torch.randint(0, num_labels, (rows,), generator=g, device=dev)
    return model, adapters, head, ids, labels


def phase_lora_grads(dev):
    """14a: one fp32 LoRA gradient (adapters and head) with the kernels
    against the plain path, dropout 0.1 (the same seeded masks both ways),
    remat, at l20 and l20-ssd width, 2 layers, batch 4 x 512 bp."""
    import torch

    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora

    log("phase 14a: LoRA gradients, kernels vs plain path (fp32, dropout 0.1, remat, "
        "2 layers, batch 4 x 512 bp)")
    cfg_l = lora.LoraConfig(dropout=0.1)
    for name, cfg, expect in (
            ("l20 tied+add", CaduceusConfig.preset("l20", n_layer=2),
             lambda nl: only(scan_fwd_hb=4 * nl, scan_bwd=2 * nl)),
            ("l20-ssd", CaduceusConfig.preset("l20-ssd", n_layer=2),
             lambda nl: only(mixer2_fwd_res=4 * nl, ssd_bwd_pre_silu=2 * nl))):
        model, adapters, head, ids, labels = lora_case(cfg, dev, 15, 4, 512)
        grads = {}
        for use_kernels in (True, False):
            ad, hd = lora.trainable_copy(adapters, dev), lora.trainable_copy(head, dev)
            reset_counts()
            logits = heads.sequence_logits(model, hd, ids, cfg, dtype=torch.float32, remat=True,
                                           lora=lora.lora_ctx(ad, cfg_l, dropout_seed=17),
                                           use_kernels=use_kernels)
            heads.task_loss(logits, labels, "classification").backward()
            torch.cuda.synchronize()
            c = counts()
            want = expect(cfg.n_layer) if use_kernels else only()
            if c != want:
                fail(f"phase 14a {name} (kernels={use_kernels}) launched {c}; expected {want}")
            grads[use_kernels] = {f"{n}.{k}": t.grad for n, ab in ad.items()
                                  for k, t in ab.items()}
            grads[use_kernels].update({f"head.{k}": t.grad for k, t in hd.items()})
        worst, worst_name = grads_agree(f"phase 14a {name}", grads[True], grads[False])
        log(f"  {name}: {len(grads[False])} adapter and head gradients, worst {worst_name} at "
            f"{worst:.3e} of its max |grad| (tol {GRAD_TOL:.0e}); launches "
            f"{dict((k, v) for k, v in expect(cfg.n_layer).items() if v)}")
        del model


def phase_scan_600(dev):
    """14b's kernels at the PlantCAD2 LoRA shape: K1-hb and K3 (dt fused,
    R 48) at 16 rows (batch 8 + RC) x 600 x 1536, both directions, bf16 and
    fp32, against their plain versions; the bf16 reverse direction timed."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_scan
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    cfg = CaduceusConfig.preset("pc2-small")
    rows, L = 2 * PC2_BATCH, PC2_L
    D, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
    log(f"phase 14b: K1-hb and K3 vs plain at pc2-small x {L} bp ({rows} rows x {L} x {D}, "
        f"N {N}, R {R}; {L // HB_CHUNK} hb chunks and a tail of {L % HB_CHUNK})")
    w = layer_weights(cfg, 18, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(19)
    res = {k: {"err": 0.0} for k in ("scan_fwd_hb", "scan_bwd")}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        s = torch.empty((), dtype=dtype).element_size()
        x, gy = (torch.randn((rows, L, D), generator=gen, device=dev).to(dtype) for _ in "ab")
        Bm, Cm = (torch.randn((rows, L, N), generator=gen, device=dev).to(dtype) for _ in "ab")
        dt = (torch.randn((rows, L, R), generator=gen, device=dev) * 0.5).to(dtype)
        for g in (0, 1):
            args = (x, dt, A[g], Bm, Cm, w["D"][g], w["dt_proj_b"][g], w["dt_proj_w"][g], g == 1)
            y, hb = cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK)
            y_p, hb_p = cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK)
            kargs = (x, gy, *args[1:7], hb, w["dt_proj_w"][g], g == 1)
            got, want = cuda_scan.scan_bwd(*kargs), cuda_scan.scan_bwd_plain(*kargs)
            torch.cuda.synchronize()
            d = "rev" if g else "fwd"
            res["scan_fwd_hb"]["err"] = max(
                res["scan_fwd_hb"]["err"], compare(f"K1-hb y {dn} {d}", y, y_p, dn),
                compare(f"K1-hb hb {dn} {d}", hb, hb_p, None, F32_TOL))
            for n, a, b in zip(("dx", "ddt_lr", "dB", "dC", "dA", "ddt_bias", "dD", "dW"),
                               got, want):
                res["scan_bwd"]["err"] = max(res["scan_bwd"]["err"],
                                             compare(f"K3 {n} {dn} {d}", a, b, None, F32_TOL))
            if g == 1 and dtype == torch.bfloat16:
                for k, fn, plain, work in (
                        ("scan_fwd_hb", lambda: cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK),
                         lambda: cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK),
                         scan_fwd_work(rows, L, D, N, R, s, HB_CHUNK)),
                        ("scan_bwd", lambda: cuda_scan.scan_bwd(*kargs),
                         lambda: cuda_scan.scan_bwd_plain(*kargs),
                         scan_bwd_work(rows, L, D, N, R, s))):
                    b, by, _ = bound_ms(*work)
                    res[k].update(ms=time_ms(fn, 10), plain_ms=time_ms(plain, 1, warmup=1),
                                  bound_ms=b, bound_by=by, rows=rows, L=L, D=D, R=R)
    for k, r in res.items():
        log(f"  {k} (bf16, reverse): {r['ms']:.3f} ms; plain {r['plain_ms']:.1f} ms; bound "
            f"{r['bound_ms']:.3f} ms by {r['bound_by']}")
    return res


def ft_step_log():
    """A handler collecting the fine-tuning CLI's (step, loss, host time)."""
    import logging

    steps = []

    class StepLog(logging.Handler):
        def emit(self, record):
            if isinstance(record.msg, str) and record.msg.startswith("step "):
                steps.append((record.args[0], float(record.args[2]), time.perf_counter()))

    handler = StepLog()
    logging.getLogger("plantcaduceus_tpu_torch.cli.lora_fine_tune").addHandler(handler)
    return steps, handler


def _adapter_tensors(path):
    import torch

    tree = torch.load(path, weights_only=True)
    flat = {}

    def walk(t, prefix):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{prefix}/{k}")
        elif isinstance(t, torch.Tensor):
            flat[prefix] = t
    walk(tree, "")
    return flat


def phase_finetune_cli(dev, tmp):
    """14a: the fine-tuning CLI with l20 at full width and depth (a seeded
    random base written as an HF dir): tokenize to .npz, train (batch 8 x
    grad-accum 4, bf16, dropout 0.1, remat, 6 steps, checkpoints at 3 and
    6), a ``python -m`` run resumed at step 3 equal bit for bit, evaluate,
    predict, display; a PEFT export of what PEFT can express, re-imported
    and predicted alike. Returns (launches of the in-process runs, figures)."""
    import contextlib
    import io
    import logging

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import lora_fine_tune as ft
    from plantcaduceus_tpu_torch.compat import peft_adapter
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora

    cfg = CaduceusConfig.preset("l20")
    nl = cfg.n_layer
    log(f"phase 14a: lora_fine_tune with l20 ({nl} layers, d_model {cfg.d_model}), batch "
        f"{FT_BATCH} x grad-accum {FT_ACCUM} x 512 bp, bf16, dropout 0.1, {FT_STEPS} steps")
    base = tmp / "l20"
    export_hf_dir(base, init_params(cfg, seed=14), cfg)
    tsv = write_ft_inputs(tmp)
    npz = {k: tmp / f"ft_{k}.npz" for k in tsv}
    for k in tsv:
        ft.main(["tokenize", "--data-dir", str(tsv[k]), "--output-path", str(npz[k]),
                 "--model-name", str(base), "--sequence-length", "512"])
    common = ["--train-dir", str(npz["train"]), "--valid-dir", str(npz["valid"]),
              "--model-name", str(base)]
    run_a, run_b = tmp / "run", tmp / "run_resumed"
    steps, handler = ft_step_log()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    ft.main(["train"] + common + FT_ARGS + ["--max-steps", str(FT_STEPS), "--output-dir",
                                            str(run_a)])
    wall = time.perf_counter() - t
    c_train = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    logging.getLogger("plantcaduceus_tpu_torch.cli.lora_fine_tune").removeHandler(handler)
    losses = [s[1] for s in steps]
    if [s[0] for s in steps] != list(range(1, FT_STEPS + 1)) or not all(map(math.isfinite, losses)):
        fail(f"phase 14a: bad step log {steps}")
    mb = FT_ACCUM * 2 * nl  # per step: microbatches x directions x layers
    n_eval = FT_STEPS // FT_SAVE * -(-FT_ROWS["valid"] // FT_EVAL_BATCH) * 2 * nl
    want = only(scan_fwd_hb=FT_STEPS * 2 * mb, scan_bwd=FT_STEPS * mb, mixer_fwd_x=n_eval)
    if c_train != want:
        fail(f"phase 14a train launched {c_train}; expected {want}")
    times = {s[0]: s[2] for s in steps}
    # steps 3..FT_STEPS without FT_SAVE + 1: its interval holds the eval and checkpoint
    deltas = [times[k] - times[k - 1] for k in range(3, FT_STEPS + 1) if k != FT_SAVE + 1]
    step_s = sum(deltas) / len(deltas)
    wps = FT_BATCH * FT_ACCUM / step_s
    log(f"  {FT_STEPS} steps in {wall:.1f} s (model load, 2 evals and 2 checkpoints included); "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; steady {step_s * 1e3:.2f} ms per step, "
        f"{wps:.2f} windows/s; peak memory allocated {peak} bytes ({peak / 2**30:.2f} GiB); "
        f"launches {dict((k, v) for k, v in c_train.items() if v)}: per step K1-hb {2 * mb} "
        f"({FT_ACCUM} microbatches x 2 directions x {nl} layers x forward + remat), K3 {mb}; "
        f"K2 {n_eval} in the evals (merged weights)")

    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.lora_fine_tune",
                          "train", *common, *FT_ARGS, "--max-steps", str(FT_STEPS),
                          "--output-dir", str(run_b), "--resume-from",
                          str(run_a / f"checkpoint-{FT_SAVE}")],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        fail(f"resumed fine-tuning exited {res.returncode}:\n{res.stderr[-4000:]}")
    if f"at step {FT_SAVE}" not in res.stderr:
        fail(f"the second run did not resume from step {FT_SAVE}:\n{res.stderr[-4000:]}")
    for f in ("final/adapter.pt", f"checkpoint-{FT_STEPS}/train_state.pt"):
        a, b = _adapter_tensors(run_a / f), _adapter_tensors(run_b / f)
        if not a or a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"phase 14a: the run resumed at step {FT_SAVE} reached another {f}")
    log(f"  python -m ... --resume-from checkpoint-{FT_SAVE}: step-{FT_STEPS} adapters, head "
        f"and optimizer state equal bit for bit ({len(a)} tensors in the train state)")

    reset_counts()
    metrics_json, pred = tmp / "metrics.json", tmp / "pred.csv"
    ft.main(["evaluate", "--checkpoint-dir", str(run_a / "final"), "--data-dir",
             str(npz["valid"]), "--batch-size", str(FT_EVAL_BATCH), "--metrics-json",
             str(metrics_json)])
    ft.main(["predict", "--checkpoint-dir", str(run_a / "final"), "--data-dir",
             str(npz["valid"]), "--batch-size", str(FT_EVAL_BATCH), "--output-file", str(pred)])
    with contextlib.redirect_stdout(io.StringIO()) as shown:
        ft.main(["display", "--model-name", str(base)])
    c_eval = counts()
    metrics = json.loads(metrics_json.read_text())
    probs = np.loadtxt(pred, skiprows=1, delimiter=",")
    if not (all(map(math.isfinite, metrics.values())) and probs.shape == (FT_ROWS["valid"],)
            and np.isfinite(probs).all() and (0 <= probs).all() and (probs <= 1).all()):
        fail(f"phase 14a evaluate/predict: {metrics}, {probs.shape}")
    per_pass = -(-FT_ROWS["valid"] // FT_EVAL_BATCH) * 2 * nl
    if c_eval != only(mixer_fwd_x=2 * per_pass):
        fail(f"phase 14a evaluate + predict launched {c_eval}")
    log(f"  evaluate: {', '.join(f'{k} {v:.4f}' for k, v in metrics.items())}; predict: "
        f"{len(probs)} probabilities in [0, 1]; display: {shown.getvalue().splitlines()[-1]}")

    # PEFT: JAX's exporter refuses adapters trained with an A per split (PEFT
    # fuses in_proj and x_proj into one Linear); out_proj and the head export.
    adapters, head, cfg_l, task, _ = lora.load_adapter(run_a / "final")
    try:
        peft_adapter.export_peft_adapter(tmp / "peft_all", adapters, head, cfg, cfg_l, task)
        fail("export_peft_adapter took adapters with an lora_A per split")
    except ValueError as e:
        if "independent lora_A" not in str(e):
            raise
    sub = {"out_proj": adapters["out_proj"]}
    peft_adapter.export_peft_adapter(tmp / "peft", sub, head, cfg, cfg_l, task, str(base))
    lora.save_adapter(tmp / "native_out_proj", lora.LoraTrainState(sub, head, None, 0), cfg_l,
                      task, str(base))
    preds = {}
    reset_counts()
    for name in ("peft", "native_out_proj"):
        out = tmp / f"pred_{name}.csv"
        ft.main(["predict", "--checkpoint-dir", str(tmp / name), "--data-dir", str(npz["valid"]),
                 "--model-name", str(base), "--batch-size", str(FT_EVAL_BATCH),
                 "--output-file", str(out)])
        preds[name] = out.read_text()
    c_eval2 = counts()
    if preds["peft"] != preds["native_out_proj"]:
        fail("phase 14a: the PEFT export's predictions differ from the adapter dir's")
    log(f"  PEFT: the full adapter set refused ({len(adapters)} splits with their own lora_A, "
        f"as JAX refuses); out_proj + head exported, re-imported: predictions equal to the "
        f"adapter dir's byte for byte ({len(probs)} rows)")
    c = {k: c_train[k] + c_eval[k] + c_eval2[k] for k in c_train}
    return c, dict(step_ms=step_s * 1e3, wps=wps, peak=peak, metrics=metrics)


def lora_trainer(cfg, dev, seed, rows, L, cfg_l=None, full=False):
    """A bf16 LoRA (or full) trainer on a seeded random base, remat on: the
    step, the infer function, the state, a batch."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.train import lora
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    model = Caduceus(cfg, init_params(cfg, seed=seed))
    opt = make_optimizer(learning_rate=1e-3, schedule="linear", warmup_steps=1, total_steps=10,
                         weight_decay=0.01, grad_clip=1.0)
    cfg_l = cfg_l or lora.LoraConfig()
    if full:
        step, infer = lora.make_full_finetune_step(cfg, opt, model, dtype=torch.bfloat16,
                                                   device=dev)
        state = lora.init_full_state(model, heads.init_head(
            torch.Generator().manual_seed(seed), cfg, 2), opt)
    else:
        step, infer = lora.make_lora_train_step(cfg, cfg_l, opt, model, dtype=torch.bfloat16,
                                                device=dev)
        state = lora.init_lora_state(seed, model, cfg, cfg_l, 2, opt, device=dev)
    rng = np.random.default_rng(seed)
    batch = {"input_ids": rng.integers(7, 11, (rows, L)).astype(np.int32),
             "labels": rng.integers(0, 2, rows)}
    return model, step, infer, state, batch


def timed_steps(model, step, state, batch, n, seed):
    """``n`` steps, the host synchronised on each loss; (losses, ms of the
    steps after the first)."""
    losses, times = [], []
    for i in range(n):
        t = time.perf_counter()
        state, m = step(state, model, batch, seed + i)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t)
    if not all(map(math.isfinite, losses)):
        fail(f"non-finite fine-tuning loss {losses}")
    return losses, 1e3 * sum(times[1:]) / max(1, len(times) - 1)


def phase_finetune_more(dev, tmp):
    """14b: the PlantCAD2 recipe, pc2-small x 600 bp, batch 8, 3 LoRA
    steps, bf16; 14c: ``--full-finetune`` at l20, 3 steps; 14d: l20-ssd
    LoRA, 3 steps and an evaluation batch. Returns (launches, figures)."""
    import torch

    from plantcaduceus_tpu_torch.cli import lora_fine_tune as ft
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    figs, c = {}, only()

    def add(d):
        for k, v in d.items():
            c[k] += v

    cfg = CaduceusConfig.preset("pc2-small")
    log(f"phase 14b: LoRA, pc2-small ({cfg.n_layer} layers, d_model {cfg.d_model}, d_inner "
        f"{cfg.d_inner}) x {PC2_L} bp, batch {PC2_BATCH}, bf16, remat, {PC2_STEPS} steps")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, step, _, state, batch = lora_trainer(cfg, dev, 20, PC2_BATCH, PC2_L)
    reset_counts()
    losses, ms = timed_steps(model, step, state, batch, PC2_STEPS, 21)
    cb = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    nl2 = 2 * cfg.n_layer
    if cb != only(scan_fwd_hb=PC2_STEPS * 2 * nl2, scan_bwd=PC2_STEPS * nl2):
        fail(f"phase 14b launched {cb}")
    add(cb)
    figs["pc2"] = dict(step_ms=ms, wps=PC2_BATCH / (ms / 1e3), peak=peak)
    log(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; {ms:.2f} ms per step (steps 2-"
        f"{PC2_STEPS}), {figs['pc2']['wps']:.2f} windows/s; peak memory allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches per step K1-hb {2 * nl2}, K3 {nl2}")
    del model, step, state
    torch.cuda.empty_cache()

    log("phase 14c: lora_fine_tune --full-finetune with l20, 3 steps (batch 8 x grad-accum 4)")
    nl2 = 2 * CaduceusConfig.preset("l20").n_layer
    reset_counts()
    ft.main(["train", "--train-dir", str(tmp / "ft_train.npz"), "--valid-dir",
             str(tmp / "ft_valid.npz"), "--model-name", str(tmp / "l20"), "--output-dir",
             str(tmp / "full"), "--full-finetune", "--train-batch-size", str(FT_BATCH),
             "--grad-accum", str(FT_ACCUM), "--learning-rate", "1e-4", "--warmup-steps", "1",
             "--max-steps", "3", "--save-steps", "3", "--eval-steps", "3", "--logging-steps",
             "1", "--eval-batch-size", str(FT_EVAL_BATCH)])
    cc = counts()
    n_eval = -(-FT_ROWS["valid"] // FT_EVAL_BATCH) * nl2
    if cc != only(mixer_fwd_res=3 * FT_ACCUM * 2 * nl2, scan_bwd=3 * FT_ACCUM * nl2,
                  mixer_fwd_x=n_eval):
        fail(f"phase 14c launched {cc}")
    add(cc)
    meta = json.loads((tmp / "full" / "final" / "adapter_config.json").read_text())
    if not meta.get("full_finetune"):
        fail("phase 14c: the export is not marked full_finetune")
    log(f"  launches {dict((k, v) for k, v in cc.items() if v)}: per step K2-res "
        f"{FT_ACCUM * 2 * nl2} (forward + remat), K3 {FT_ACCUM * nl2}; K2 {n_eval} in the eval")

    cfg = CaduceusConfig.preset("l20-ssd")
    log("phase 14d: LoRA, l20-ssd, batch 8 x 512 bp, bf16, remat, 3 steps and an eval batch")
    model, step, infer, state, batch = lora_trainer(cfg, dev, 22, FT_BATCH, 512)
    reset_counts()
    losses, ms = timed_steps(model, step, state, batch, 3, 23)
    logits = infer(state, model, batch)
    torch.cuda.synchronize()
    cd = counts()
    nl2 = 2 * cfg.n_layer
    if cd != only(mixer2_fwd_res=3 * 2 * nl2, ssd_bwd_pre_silu=3 * nl2, mixer2_fwd=nl2):
        fail(f"phase 14d launched {cd}")
    if not torch.isfinite(logits).all():
        fail("phase 14d: non-finite logits")
    add(cd)
    figs["ssd"] = dict(step_ms=ms)
    log(f"  losses {', '.join(f'{v:.4f}' for v in losses)}; {ms:.2f} ms per step; launches "
        f"{dict((k, v) for k, v in cd.items() if v)}")
    return c, figs


def phase_finetune_profile(dev):
    """Device time by kernel over one microbatch of an l20 LoRA step (bf16,
    8 x 512 bp, dropout 0.1, remat, the optimizer update included; a 14a
    step is four such microbatches), and the busy share."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    log(f"phase 14 profile: one microbatch of an l20 LoRA step (bf16, {FT_BATCH} x 512 bp, "
        "dropout 0.1, remat, with the update)")
    cfg, cfg_l = CaduceusConfig.preset("l20"), lora.LoraConfig()
    model = Caduceus(cfg, init_params(cfg, seed=24))
    opt = make_optimizer(learning_rate=1e-3, schedule="linear", warmup_steps=1, total_steps=10)
    step, _ = lora.make_lora_train_step(cfg, cfg_l, opt, model, dtype=torch.bfloat16, device=dev)
    state = lora.init_lora_state(24, model, cfg, cfg_l, 2, opt, device=dev)
    rng = np.random.default_rng(24)
    batch = {"input_ids": rng.integers(7, 11, (FT_BATCH, 512)).astype(np.int32),
             "labels": rng.integers(0, 2, FT_BATCH)}
    state, m = step(state, model, batch, 1)
    float(m["loss"])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, model, batch, 2)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall, 12)


def phase_finetune(dev):
    """Phase 14 (LoRA and full fine-tuning). The kernel checks (14a's
    gradients, 14b's K1-hb/K3 at 600 x 1536) run before the launch counts
    are zeroed; the counts of the main paths (the CLI runs in-process, the
    pc2-small and l20-ssd steps) are read after them."""
    t = time.perf_counter()
    tmp = REPO / "build" / "chip_smoke" / "finetune"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    marks = [time.perf_counter()]
    phase_lora_grads(dev)
    marks.append(time.perf_counter())
    k600 = phase_scan_600(dev)
    marks.append(time.perf_counter())
    ca, figs = phase_finetune_cli(dev, tmp)
    marks.append(time.perf_counter())
    cb, more = phase_finetune_more(dev, tmp)
    marks.append(time.perf_counter())
    figs.update(more)
    c = {k: ca[k] + cb[k] for k in ca}
    phase_finetune_profile(dev)
    marks.append(time.perf_counter())
    log("phase 14 seconds: " + ", ".join(
        f"{n} {b - a:.1f}" for n, a, b in zip(("gradients", "K1-hb/K3 at 600", "CLI", "14b-d",
                                               "profile"), marks, marks[1:])))
    log(f"phase 14 ok in {time.perf_counter() - t:.1f} s: LoRA l20 {figs['step_ms']:.2f} ms per "
        f"step ({figs['wps']:.2f} windows/s, batch {FT_BATCH} x {FT_ACCUM}); pc2-small x "
        f"{PC2_L} bp {figs['pc2']['step_ms']:.2f} ms per step ({figs['pc2']['wps']:.2f} "
        f"windows/s, batch {PC2_BATCH}, peak {figs['pc2']['peak']} bytes); l20-ssd "
        f"{figs['ssd']['step_ms']:.2f} ms per step (batch {FT_BATCH}); launches "
        f"{dict((k, v) for k, v in c.items() if v)}")
    return c, k600, figs

# ---------------------------------------------------------------------------
# Phase 15: the rest of training. Sharded streaming pre-training with a
# profile window (train/streaming.py, io/parquet.py, utils/profiling.py),
# teacher -> student distillation l20 -> l20-ssd (train/distill.py,
# cli/distill.py), the planted-structure convergence harness
# (train/convergence.py) at the JAX package's configuration, a parquet table
# through zero_shot_eval, and the GPN baseline (models/gpn.py).
# 40 shards of 256 windows: the 39 training shards hold 9,984 windows, more
# than StreamingPretrainDataset's shuffle buffer of 8,192, so the run swaps
# out of a bounded buffer and opens shards while it trains.
STREAM_SHARDS, STREAM_SHARD_WINDOWS, STREAM_STEPS, STREAM_SAVE = 40, 256, 14, 7
STREAM_BATCHES = 24  # batches drawn from the stream alone, to time its host cost
DISTILL_STEPS, DISTILL_SAVE = 6, 3
CONVERGENCE_CFG = dict(d_model=64, n_layer=2, vocab_size=16, d_state=8)  # d_inner 128, R 4
CONVERGENCE_RUNS = (("float32", 150, 1.0), ("float32", 150, 0.1), ("bfloat16", 200, 0.1))
GPN_ROWS, GPN_L = 128, 512


def trace_kernels(prof_dir):
    """The device kernels named in the one Chrome trace under ``prof_dir``."""
    traces = list(Path(prof_dir).glob("*.pt.trace.json"))
    if len(traces) != 1:
        fail(f"expected one trace under {prof_dir}, found {traces}")
    events = json.loads(traces[0].read_text())["traceEvents"]
    return traces[0], [e["name"] for e in events if e.get("cat") == "kernel"]


def stream_draws(shard_dir, n_batches, eval_shards=0):
    """The stream's own host cost, as the trainer draws it (the loop reads a
    batch before each step, with no prefetch): the ms of each of the first
    ``n_batches`` batches (32 x 512 bp) of ``StreamingPretrainDataset`` over
    ``shard_dir``, and which of them opened a shard (its parquet read
    counted as it happens). The first batch fills the shuffle buffer."""
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import streaming

    ds = streaming.StreamingPretrainDataset(shard_dir, DnaTokenizer(), 32, window=512,
                                            eval_shards=eval_shards)
    read, draw, opened, ms = streaming.read_parquet, [0], [], []

    def counted(*args, **kwargs):
        opened.append(draw[0])
        return read(*args, **kwargs)

    streaming.read_parquet = counted
    try:
        it = ds.iter_from(0)
        for draw[0] in range(n_batches):
            t = time.perf_counter()
            next(it)
            ms.append((time.perf_counter() - t) * 1e3)
    finally:
        streaming.read_parquet = read
    opens = sorted(set(opened) - {0})
    rest = [v for i, v in enumerate(ms[1:], 1) if i not in opens]
    if not opens or not rest:
        fail(f"{shard_dir}: no batch after the buffer's fill opened a shard ({opened})")
    r = dict(fill_ms=ms[0], batch_ms=sum(rest) / len(rest),
             open_ms=sum(ms[i] for i in opens) / len(opens), opens=opens)
    r["note"] = (f"first batch (fills the {ds.shuffle_buffer}-window buffer from "
                 f"{opened.count(0)} shards) {r['fill_ms']:.2f} ms; then {r['batch_ms']:.3f} ms a "
                 f"batch, {r['open_ms']:.3f} ms for a batch that opens a shard (batches {opens}); "
                 f"all {[round(v, 3) for v in ms]}")
    return r


def phase_streaming(dev, tsv, n_valid):
    """15a: the port's convert_to_shards writes a seeded 512-bp corpus as
    gzip parquet shards; ``cli.pretrain --dataset shards:`` with l20 at full
    width and depth (bf16, remat, one eval shard, a profile window) runs
    in-process, counted and timed; ``python -m`` resumed at step 7 must end
    equal bit for bit; the trace must name K2-res's and K3's kernels. The
    stream alone is timed first: the buffer's fill, a batch, a shard open."""
    import re

    import torch

    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train import streaming

    cfg = CaduceusConfig.preset("l20")
    tmp = REPO / "build" / "chip_smoke" / "streaming"
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 15a: streaming pre-training, l20 over {STREAM_SHARDS} gzip parquet shards of "
        f"{STREAM_SHARD_WINDOWS} windows (one held out), batch 32 x 512 bp, bf16, remat, "
        f"{STREAM_STEPS} steps, profile window")
    t = time.perf_counter()
    corpus = data_lib.sequence_source("synthetic", window=512, synthetic_n=STREAM_SHARDS
                                      * STREAM_SHARD_WINDOWS, seed=15)
    n = streaming.convert_to_shards(corpus, tmp / "shards", shard_size=STREAM_SHARD_WINDOWS)
    size = sum(p.stat().st_size for p in (tmp / "shards").iterdir())
    log(f"  convert_to_shards: {n} shards, {size} bytes, {time.perf_counter() - t:.2f} s")
    if n != STREAM_SHARDS:
        fail(f"phase 15a: {n} shards")
    r = stream_draws(tmp / "shards", STREAM_BATCHES, eval_shards=1)
    stream = {k: r[k] for k in ("fill_ms", "batch_ms", "open_ms")}
    log(f"  the stream alone, batch 32 x 512: {r['note']}")
    args = ["--preset", "l20", "--dataset", f"shards:{tmp / 'shards'}", "--eval-shards", "1",
            "--batch-size", "32", "--window", "512", "--dtype", "bfloat16", "--max-steps",
            str(STREAM_STEPS), "--eval-steps", str(STREAM_SAVE), "--save-steps",
            str(STREAM_SAVE), "--log-steps", "1", "--warmup-steps", "5", "--lr", "1e-3"]
    run_a, prof = tmp / "run", tmp / "profile"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    with StepLog() as steps:
        pretrain.main(args + ["--output-dir", str(run_a), "--profile-dir", str(prof)])
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    nl = cfg.n_layer
    losses = [s[1] for s in steps]
    if [s[0] for s in steps] != list(range(1, STREAM_STEPS + 1)) or \
            not all(map(math.isfinite, losses)):
        fail(f"phase 15a: bad step log {steps}")
    # training: K2-res twice per direction and layer (forward, remat), K3
    # once; the evaluations (every --eval-steps and the final one) run K2
    # once per direction and layer on each full batch of the eval shard (at
    # most 20 batches an evaluation).
    n_eval = (STREAM_STEPS // STREAM_SAVE + 1) * min(STREAM_SHARD_WINDOWS // 32, 20)
    want = only(mixer_fwd_x=n_eval * 2 * nl, mixer_fwd_res=STREAM_STEPS * 4 * nl,
                scan_bwd=STREAM_STEPS * 2 * nl)
    if c != want:
        fail(f"phase 15a launched {c}; expected exactly {want} ({n_eval} eval batches)")
    # steps 3-7: after the buffer's fill, before the first checkpoint,
    # evaluation and profile window
    step_ms = steady_ms(steps, 2, STREAM_SAVE)
    prof_ms = steady_ms(steps, 10, 12)  # traced steps 11-12 (step 13's interval writes the trace)
    tps = 32 * 512 / step_ms * 1e3
    log(f"  {STREAM_STEPS} steps in {wall:.1f} s (model init, evaluations, checkpoints, "
        f"export included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; steps 3-7: "
        f"{step_ms:.2f} ms per step, {tps:.1f} tokens/s; traced steps 11-12: "
        f"{prof_ms:.2f} ms per step; peak memory allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB); launches {dict((k, v) for k, v in c.items() if v)}")
    path, names = trace_kernels(prof)
    k2res = [k for k in names
             if re.search(r"scan_fwd_kernel<[^,]+, \d+, true, false, pc::MixConvSrc", k)]
    xproj = [k for k in names if re.search(r"conv_xproj_kernel<[^,]+, true,", k)]
    k3 = [k for k in names if "scan_bwd_kernel<" in k]
    if not (k2res and xproj and k3):
        fail(f"phase 15a: the trace {path.name} lacks K2-res or K3 ({len(names)} kernels)")
    log(f"  trace {path.name} ({path.stat().st_size} bytes): {len(names)} kernel events; "
        f"K2-res scan {len(k2res)}, K2-res conv + x_proj {len(xproj)}, K3 {len(k3)} (3 traced "
        f"steps launch {3 * 4 * nl} K2-res and {3 * 2 * nl} K3)")
    n_t = resume_equal("cli.pretrain", args, run_a, tmp / "resumed", STREAM_SAVE, "phase 15a")
    log(f"  python -m ... resumed at step {STREAM_SAVE}: step-{STREAM_STEPS} weights equal "
        f"bit for bit ({n_t} tensors)")
    return c, dict(step_ms=step_ms, tps=tps, peak=peak, prof_ms=prof_ms, **stream)


def phase_distill(dev, tsv, n_valid):
    """15b: the fp32 distillation gradient (l20 teacher, l20-ssd student, 2
    layers, 4 rows x 512) with the kernels against the plain path, every
    leaf logged; then ``cli.distill`` l20 -> l20-ssd (exported random
    teacher, batch 32 x 512, bf16, remat, 6 steps; in-process, counted and
    timed), resumed at step 3 through ``python -m``, a profiled step, and
    the student's final/ scored."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.cli import distill as distill_cli
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score_main
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train import distill
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
    from plantcaduceus_tpu_torch.train.step import to_device
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    tmp = REPO / "build" / "chip_smoke" / "distill"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    log("phase 15b: distillation l20 -> l20-ssd; the fp32 gradient (2 layers, 4 x 512 bp), "
        "kernels vs plain path")
    tcfg = CaduceusConfig.preset("l20", n_layer=2)
    scfg = CaduceusConfig.preset("l20-ssd", n_layer=2)
    teacher = Caduceus(tcfg, init_params(tcfg, seed=151)).to(dev)
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=16, seed=152)
    batch = to_device(data_lib.PretrainDataset(seqs, DnaTokenizer(), 4, seed=152).batch_at(0),
                      dev)
    sp = init_params(scfg, seed=153)
    grads = {}
    for use_kernels in (True, False):
        student = Caduceus(scfg, sp).requires_grad_().to(dev)
        reset_counts()
        obj, aux = distill.distill_objective(teacher, student, batch, torch.float32,
                                             remat=True, use_kernels=use_kernels)
        if aux[1].requires_grad:
            fail("phase 15b: the teacher's logits carry a graph")
        obj.backward()
        torch.cuda.synchronize()
        c = counts()
        nl2 = 2 * scfg.n_layer
        want = only(mixer_fwd_x=2 * tcfg.n_layer, mixer2_fwd_res=2 * nl2,
                    ssd_bwd_pre_silu=nl2) if use_kernels else only()
        if c != want:
            fail(f"phase 15b gradient (kernels={use_kernels}) launched {c}; expected {want}")
        grads[use_kernels] = {n: p.grad for n, p in student.named_parameters()}
        del student
    gaps = {n: rel_gap(grads[True][n], g) for n, g in grads[False].items()}
    log("  every leaf's gap (kernels vs plain, of its max |grad|): " + ", ".join(
        f"{n} {v:.2e}" for n, v in gaps.items()))
    worst, worst_name = grads_agree("phase 15b", grads[True], grads[False])
    log(f"  {len(gaps)} student gradients, worst {worst_name} at {worst:.3e} (tol "
        f"{GRAD_TOL:.0e}); teacher K2 {2 * tcfg.n_layer}, student K5-res {4 * scfg.n_layer}, "
        f"K6 pre_silu {2 * scfg.n_layer}; the teacher recorded no graph")
    del teacher, grads

    tcfg = CaduceusConfig.preset("l20")
    scfg = CaduceusConfig.preset("l20-ssd")
    teacher_dir = tmp / "teacher_l20"
    ckpt_lib.export_params(teacher_dir, Caduceus(tcfg, init_params(tcfg, seed=154)), tcfg)
    args = ["--teacher", str(teacher_dir), "--student-preset", "l20-ssd", "--dataset",
            "synthetic", "--batch-size", "32", "--window", "512", "--dtype", "bfloat16",
            "--max-steps", str(DISTILL_STEPS), "--save-steps", str(DISTILL_SAVE),
            "--log-steps", "1", "--warmup-steps", "2", "--lr", "1e-3"]
    log(f"  cli.distill: l20 teacher (exported, random) -> l20-ssd student, batch 32 x 512 bp, "
        f"bf16, remat, {DISTILL_STEPS} steps")
    run_a = tmp / "run"
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    with StepLog() as steps:
        distill_cli.main(args + ["--output-dir", str(run_a)])
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    nt, ns = tcfg.n_layer, scfg.n_layer
    want = only(mixer_fwd_x=DISTILL_STEPS * 2 * nt, mixer2_fwd_res=DISTILL_STEPS * 4 * ns,
                ssd_bwd_pre_silu=DISTILL_STEPS * 2 * ns)
    if c != want:
        fail(f"phase 15b cli.distill launched {c}; expected exactly {want}")
    losses = [s[1] for s in steps]
    if [s[0] for s in steps] != list(range(1, DISTILL_STEPS + 1)) or \
            not all(map(math.isfinite, losses)):
        fail(f"phase 15b: bad step log {steps}")
    step_ms = steady_ms(steps, 2, DISTILL_STEPS, skip=(DISTILL_SAVE + 1,))
    log(f"  {DISTILL_STEPS} steps in {wall:.1f} s (teacher load, student init, checkpoints, "
        f"export included); loss {losses[0]:.4f} -> {losses[-1]:.4f}; steps 3-{DISTILL_STEPS} "
        f"without the "
        f"checkpoint step: {step_ms:.2f} ms per step, {32e3 / step_ms:.2f} windows/s; peak "
        f"memory allocated {peak} bytes ({peak / 2**30:.2f} GiB); launches per step: K2 "
        f"{2 * nt} (teacher), K5-res {4 * ns}, K6 pre_silu {2 * ns} (student)")
    n_t = resume_equal("cli.distill", args, run_a, tmp / "resumed", DISTILL_SAVE, "phase 15b")
    log(f"  python -m ... resumed at step {DISTILL_SAVE}: the student's step-{DISTILL_STEPS} "
        f"weights equal bit for bit ({n_t} tensors)")

    teacher_m, _, tok = load_model_and_tokenizer(str(teacher_dir))
    teacher_m.to(dev)
    student = Caduceus(scfg, init_params(scfg, seed=155))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                         params=dict(student.named_parameters()))
    init, dstep = distill.make_distill_step(tcfg, scfg, opt, student, dtype=torch.bfloat16,
                                            remat=True, device=dev)
    ds = data_lib.PretrainDataset(data_lib.sequence_source("synthetic", window=512,
                                                           synthetic_n=64, seed=156), tok, 32,
                                  seed=156)
    state = init()
    state, m = dstep(state, teacher_m, ds.batch_at(0))
    float(m["loss"])
    b1 = to_device(ds.batch_at(1), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_:
        t = time.perf_counter()
        state, m = dstep(state, teacher_m, b1)
        float(m["loss"])
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t) * 1e3
    log("  profile of one distillation step (bf16, batch 32 x 512 bp):")
    report_profile(prof_, pwall, 10)
    del teacher_m, student, state

    out = tmp / "scores_student.tsv"
    score_main(["-input-table", str(tsv), "-model", str(run_a / "final"), "-output", str(out),
                "-no-progress"])
    scores = np.array([float(r["zeroShotScore"]) for r in zero_shot.read_table(out).rows])
    if len(scores) != n_valid or not np.isfinite(scores).all():
        fail("phase 15b: scoring with the student's export: row count or non-finite scores")
    log(f"  zero_shot_score -model {run_a.name}/final: {len(scores)} rows scored")
    return c, dict(step_ms=step_ms, wps=32e3 / step_ms, peak=peak, worst=worst)


def phase_convergence(dev):
    """15c: ``train_planted`` at the JAX package's configuration (d_model
    64, 2 layers, d_state 8, 128 bp, batch 16) on the card, held to JAX's
    bars: fp32 150 steps at soft-mask weights 1.0 and 0.1
    (tests/test_pretrain_learns.py), bf16 200 steps at 0.1 (bench.py's
    convergence lane). Before the runs, at this shape: one training step's
    loss and gradients through K2-res and K3 against the plain path, in fp32
    and bf16, and the probe forward through K2."""
    import torch

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import (Caduceus, forward, init_params,
                                                         mlm_loss)
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import convergence as conv
    from plantcaduceus_tpu_torch.train.data import PretrainDataset
    from plantcaduceus_tpu_torch.train.step import to_device

    cfg = CaduceusConfig(**CONVERGENCE_CFG)
    log(f"phase 15c: planted-structure convergence (d_model 64, 2 layers, d_inner "
        f"{cfg.d_inner}, N {cfg.d_state}, R {cfg.dt_rank}, 128 bp, batch 16)")
    # The kernels against the plain path at this shape: fp32 within GRAD_TOL;
    # bf16 within 2 x the plain path's own worst gap from its fp32 gradient
    # (the bound phase 11b measures; every leaf's gaps are logged).
    batch = to_device(PretrainDataset(conv.planted_corpus(64, 128, seed=3), DnaTokenizer(), 16,
                                      seed=3).batch_at(0), dev)
    params = init_params(cfg, seed=4)
    grads, loss = {}, {}
    nl2 = 2 * cfg.n_layer
    for dtype in (torch.float32, torch.bfloat16):
        for use_kernels in (True, False):
            model = Caduceus(cfg, params).requires_grad_().to(dev)
            reset_counts()
            logits = forward(model, batch["input_ids"], dtype=dtype,
                             use_kernels=use_kernels)["logits"]
            obj = mlm_loss(logits, batch["labels"], batch["loss_weights"])
            obj.backward()
            torch.cuda.synchronize()
            c = counts()
            want = only(mixer_fwd_res=nl2, scan_bwd=nl2) if use_kernels else only()
            if c != want:
                fail(f"phase 15c {dtype} gradient (kernels={use_kernels}) launched {c}; "
                     f"expected {want}")
            loss[dtype, use_kernels] = obj.item()
            grads[dtype, use_kernels] = {n: p.grad for n, p in model.named_parameters()}
        dn = str(dtype).split(".")[-1]
        tol, note = GRAD_TOL, ""
        if dtype != torch.float32:
            ref = grads[torch.float32, False]
            gaps = {n: (rel_gap(grads[dtype, True][n], g), rel_gap(grads[dtype, False][n], g))
                    for n, g in ref.items()}
            log(f"  {dn} gradient against the fp32 one, every leaf (kernels / plain, of its "
                "max |grad|): " + ", ".join(f"{n} {k:.2e} / {p:.2e}"
                                            for n, (k, p) in gaps.items()))
            tol = 2 * max(p for _, p in gaps.values())
            note = " (2 x the plain path's worst gap from fp32)"
        dl = abs(loss[dtype, True] - loss[dtype, False])
        if not (math.isfinite(dl) and dl <= tol * abs(loss[dtype, False])):
            fail(f"phase 15c {dn}: loss {loss[dtype, True]} with kernels, "
                 f"{loss[dtype, False]} plain (tol {tol:.1e} rel)")
        worst, worst_name = grads_agree(f"phase 15c {dn}", grads[dtype, True],
                                        grads[dtype, False], tol)
        log(f"  {dn} one step, kernels vs plain: loss {loss[dtype, True]:.6f} / "
            f"{loss[dtype, False]:.6f}; {len(grads[dtype, False])} gradients, worst "
            f"{worst_name} at {worst:.3e} of its max |grad| (tol {tol:.3e}{note}); launches "
            f"K2-res {nl2}, K3 {nl2}")
    with torch.inference_mode():
        reset_counts()
        got = forward(model, batch["input_ids"], dtype=torch.float32)["logits"]
        c = counts()
        want = forward(model, batch["input_ids"], dtype=torch.float32,
                       use_kernels=False)["logits"]
    d, scale = (got - want).abs().max().item(), want.abs().max().item()
    if c != only(mixer_fwd_x=nl2) or not (torch.isfinite(got).all()
                                        and d <= FORWARD_TOL * scale):
        fail(f"phase 15c probe forward: launched {c}; max_abs_err {d:.3e} of max |logit| "
             f"{scale:.3e} (tol {FORWARD_TOL:.0e} rel)")
    log(f"  fp32 probe forward, kernels vs plain: max_abs_err={d:.3e} (max |logit| "
        f"{scale:.3e}, tol {FORWARD_TOL:.0e} rel); launches K2 {nl2}")
    del model, grads, got, want
    res = {}
    reset_counts()
    for dn, steps, w in CONVERGENCE_RUNS:
        t = time.perf_counter()
        run = conv.train_planted(cfg, steps=steps, batch=16, n_corpus=512,
                                 soft_masked_weight=w, dtype=getattr(torch, dn), device=dev)
        m = conv.evaluate_structure(run)
        wall = time.perf_counter() - t
        res[dn, w] = (run, m)
        log(f"  {dn} weight {w}, {steps} steps in {wall:.2f} s: losses "
            f"{[(s, round(v, 4)) for s, v in run['losses']]}; held-out motif "
            f"{m['motif_accuracy']:.4f}, background {m['background_accuracy']:.4f}, repeat "
            f"loss {m['repeat_loss']:.4f}")
    c = counts()
    total = sum(s for _, s, _ in CONVERGENCE_RUNS)
    want = only(mixer_fwd_x=len(CONVERGENCE_RUNS) * nl2, mixer_fwd_res=total * nl2,
                scan_bwd=total * nl2)
    if c != want:
        fail(f"phase 15c launched {c}; expected {want}")
    for w in (1.0, 0.1):
        run, m = res["float32", w]
        if not (m["motif_accuracy"] > 0.8 and m["background_accuracy"] < 0.45
                and run["final_loss"] < 1.3):
            fail(f"phase 15c fp32 weight {w}: {m}, final loss {run['final_loss']}")
    full, soft = res["float32", 1.0][1], res["float32", 0.1][1]
    if not soft["repeat_loss"] > 2.0 * full["repeat_loss"]:
        fail(f"phase 15c: repeat loss at 0.1 {soft['repeat_loss']} not > 2 x at 1.0 "
             f"{full['repeat_loss']}")
    m = res["bfloat16", 0.1][1]
    if not (m["motif_accuracy"] >= 0.8 and m["background_accuracy"] <= 0.45):
        fail(f"phase 15c bf16: {m}")
    log(f"  JAX's bars hold: fp32 motif > 0.8, background < 0.45, final loss < 1.3 at both "
        f"weights, repeat loss {soft['repeat_loss']:.4f} > 2 x {full['repeat_loss']:.4f}; "
        f"bf16 motif {m['motif_accuracy']:.4f} >= 0.8, background "
        f"{m['background_accuracy']:.4f} <= 0.45; launches "
        f"{dict((k, v) for k, v in c.items() if v)}")
    return c, {f"{dn}_{w}": dict(final_loss=run["final_loss"], **m)
               for (dn, w), (run, m) in res.items()}


def phase_parquet_gpn(dev, ev):
    """15d: evo_cons with pc2-small over phase 12's table written as parquet
    by the port (metrics equal to phase 12's TSV run); the GPN forward at
    its defaults on the card against the CPU forward in fp32."""
    import torch

    from plantcaduceus_tpu_torch.cli import zero_shot_eval as zse
    from plantcaduceus_tpu_torch.io.parquet import write_parquet
    from plantcaduceus_tpu_torch.models import gpn
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    log("phase 15d: zero_shot_eval evo_cons over a parquet table (pc2-small, "
        f"{EVAL_ROWS} x {EVAL_L} bp, batch {EVAL_BATCH}); the GPN forward")
    tmp = REPO / "build" / "chip_smoke"
    frame = zse.read_tsv(ev["paths"]["evo"])
    table = tmp / "eval_evo.parquet"
    write_parquet(table, {"sequence": frame.col("sequence"),
                          "label": [int(v) for v in frame.col("label")]})
    mj = tmp / "eval_evo_cons_parquet.json"
    reset_counts()
    t = time.perf_counter()
    zse.main(["evo_cons", "--repo-id", str(table), "--model", "pc2-small", "--batch-size",
              str(EVAL_BATCH), "--metrics-json", str(mj), "--no-progress", "--token-idx",
              str(EVAL_CENTER)])
    wall = time.perf_counter() - t
    c = counts()
    cfg = CaduceusConfig.preset("pc2-small")
    k2 = 2 * cfg.n_layer * math.ceil(EVAL_ROWS / EVAL_BATCH)
    if c != only(mixer_fwd=k2):
        fail(f"phase 15d evo_cons launched {c}; expected mixer_fwd={k2}")
    got = json.loads(mj.read_text())
    if got != ev["metrics"]["evo_cons"]:
        fail(f"phase 15d: parquet metrics {got} != the TSV's {ev['metrics']['evo_cons']}")
    log(f"  parquet ({table.stat().st_size} bytes, gzip): {got}, equal to phase 12's TSV run; "
        f"{wall:.2f} s end to end; mixer_fwd {k2}")

    gcfg = gpn.GpnConfig()
    params = gpn.init_params(gcfg, seed=16)
    ids = torch.randint(7, 11, (GPN_ROWS, GPN_L), generator=torch.Generator().manual_seed(16))
    with torch.inference_mode():
        want = gpn.forward(gpn.Gpn(gcfg, params), ids, dtype=torch.float32)["logits"]
        model, ids_d = gpn.build(gcfg, params, device=dev), ids.to(dev)
        got = gpn.forward(model, ids_d, dtype=torch.float32)["logits"]
        ms = time_ms(lambda: gpn.forward(model, ids_d, dtype=torch.bfloat16), 5)
    d, scale = (got.cpu() - want).abs().max().item(), want.abs().max().item()
    log(f"  GPN (d_model {gcfg.d_model}, {gcfg.n_layer} layers, dilations "
        f"{gcfg.dilation_schedule()}), {GPN_ROWS} x {GPN_L}: fp32 logits on the card vs the "
        f"CPU max_abs_err={d:.3e} (max |logit| {scale:.3e}, tol {FORWARD_TOL:.0e} rel); bf16 "
        f"forward {ms:.3f} ms ({GPN_ROWS / ms * 1e3:.1f} windows/s)")
    if not (torch.isfinite(got).all() and d <= FORWARD_TOL * scale):
        fail("phase 15d: the GPN forward on the card disagrees with the CPU forward")
    return c, dict(gpn_ms=ms, gpn_err=d / scale)


def phase_rest_of_training(dev, tsv, n_valid, ev):
    """Phase 15. The kernel checks (15b's and 15c's gradients, 15c's probe
    forward) run before the launch counts are zeroed; each main path's counts
    are read just after it."""
    t = time.perf_counter()
    marks = [t]
    ca, fa = phase_streaming(dev, tsv, n_valid)
    marks.append(time.perf_counter())
    cb, fb = phase_distill(dev, tsv, n_valid)
    marks.append(time.perf_counter())
    cc, fc = phase_convergence(dev)
    marks.append(time.perf_counter())
    cd, fd = phase_parquet_gpn(dev, ev)
    marks.append(time.perf_counter())
    c = {k: ca[k] + cb[k] + cc[k] + cd[k] for k in ca}
    log("phase 15 seconds: " + ", ".join(f"{n} {b - a:.1f}" for n, a, b in zip(
        ("15a streaming", "15b distillation", "15c convergence", "15d parquet+GPN"), marks,
        marks[1:])))
    log(f"phase 15 ok in {time.perf_counter() - t:.1f} s: streaming l20 {fa['step_ms']:.2f} "
        f"ms per step ({fa['tps']:.1f} tokens/s, peak {fa['peak']} bytes); distillation "
        f"l20 -> l20-ssd {fb['step_ms']:.2f} ms per step ({fb['wps']:.2f} windows/s, peak "
        f"{fb['peak']} bytes); launches {dict((k, v) for k, v in c.items() if v)}")
    return c, dict(streaming=fa, distill=fb, convergence=fc, gpn=fd)


# ---------------------------------------------------------------------------
# Phase 16: the files users have, read on the card's host by the port's own
# readers (io/safetensors.py, io/zstd.py, io/parquet.py's list columns). One
# l20 state dict as pytorch_model.bin, one F32 safetensors file, two shards
# with an index and a BF16 file, scored through the CLI; JAX's zstd parquet
# shards (committed, written by its convert_to_shards) streamed into l20
# pre-training beside the same sequences in the port's gzip shards;
# JAX-tokenized zstd tables (list columns) fine-tuned beside .npz, and a
# PEFT adapter saved as safetensors and evaluated.
FIXTURES = REPO / "tests" / "format_fixtures"
# 80 copies of the 2 committed 128-window shards: 10,240 windows, more than
# the 8,192-window shuffle buffer, so after the fill every 4th batch opens
# (and decodes) a shard; steps 2-9 draw batches 1-8, two of which open one
FORMAT_STREAM_COPIES, FORMAT_STREAM_STEPS, FORMAT_STREAM_BATCHES = 80, 9, 12
FORMAT_FT_STEPS, FORMAT_FT_BATCH, FORMAT_FT_EVAL = 3, 8, 16
FORMAT_FT_TABLES = (("classification", "lora_cls"), ("multi_label", "lora_multi"))


def phase_format_checkpoints(dev, tsv, n_valid):
    """16a: one seeded l20 state dict written four ways (export_hf_dir's
    pytorch_model.bin; one F32 model.safetensors; two safetensors shards
    with model.safetensors.index.json; one BF16 model.safetensors) and a
    .bin of the weights rounded to bf16; each scored in-process on phase 6's
    windows (counted; its load timed), the shards once more through
    ``python -m``. The safetensors files' scores equal the .bin's byte for
    byte, the BF16 file's those of the rounded .bin."""
    import torch

    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as score
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.io import safetensors
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    cfg = CaduceusConfig.preset("l20")
    nl = cfg.n_layer
    tmp = REPO / "build" / "chip_smoke" / "formats"
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 16a: safetensors checkpoints, l20 ({nl} layers, d_model {cfg.d_model}), scored "
        f"on phase 6's {n_valid} windows, bf16, batch 128")
    dirs = {k: tmp / f"ckpt_{k}" for k in ("bin", "st", "sharded", "bf16", "bin_bf16")}
    export_hf_dir(dirs["bin"], init_params(cfg, seed=16), cfg)
    sd = torch.load(dirs["bin"] / "pytorch_model.bin", weights_only=True)
    for k in ("st", "sharded", "bf16", "bin_bf16"):
        dirs[k].mkdir(parents=True)
        shutil.copy(dirs["bin"] / "config.json", dirs[k] / "config.json")
    safetensors.save_file(sd, dirs["st"] / "model.safetensors")
    safetensors.save_sharded(sd, dirs["sharded"], 2)
    safetensors.save_file({k: v.to(torch.bfloat16) for k, v in sd.items()},
                          dirs["bf16"] / "model.safetensors")
    torch.save({k: v.to(torch.bfloat16).float() for k, v in sd.items()},
               dirs["bin_bf16"] / "pytorch_model.bin")
    n_batches = math.ceil(n_valid / 128)
    load_s, out, c = {}, {}, only()
    for name, d in dirs.items():
        t = time.perf_counter()
        load_model_and_tokenizer(str(d))
        load_s[name] = time.perf_counter() - t
        out[name] = tmp / f"scores_{name}.tsv"
        reset_counts()
        score(["-input-table", str(tsv), "-model", str(d), "-output", str(out[name]),
               "-no-progress"])
        got = counts()
        if got != only(mixer_fwd_x=2 * nl * n_batches):
            fail(f"phase 16a scoring {name} launched {got}; expected mixer_fwd_x="
                 f"{2 * nl * n_batches}")
        c = {k: c[k] + got[k] for k in c}
    sizes = {k: sum(f.stat().st_size for f in d.iterdir()) for k, d in dirs.items()}
    for a, b in (("st", "bin"), ("sharded", "bin"), ("bf16", "bin_bf16")):
        if out[a].read_bytes() != out[b].read_bytes():
            fail(f"phase 16a: the {a} dir's scores differ from the {b} dir's")
    if out["bf16"].read_bytes() == out["bin"].read_bytes():
        fail("phase 16a: the BF16 file scored as the float32 weights")
    by_m = tmp / "scores_sharded_m.tsv"
    run_module("cli.zero_shot_score", ["-input-table", str(tsv), "-model", str(dirs["sharded"]),
                                       "-output", str(by_m), "-no-progress"])
    if by_m.read_bytes() != out["bin"].read_bytes():
        fail("phase 16a: python -m over the shards scored otherwise than the .bin dir")
    log("  load seconds (import from the dir, model on the host): " + ", ".join(
        f"{k} {load_s[k]:.3f} s ({sizes[k]} bytes)" for k in dirs))
    log(f"  scores: model.safetensors and the 2 shards equal the .bin's byte for byte "
        f"({n_valid} rows; also through python -m), BF16 equal to the bf16-rounded .bin's; "
        f"K2 {2 * nl} a batch, {n_batches} batches a run")
    return c, dict(load_s=load_s, sizes=sizes), dirs["bin"]


def phase_format_streaming(dev):
    """16b: l20 streaming pre-training (batch 32 x 512, bf16, remat) over
    copies of JAX's committed zstd shards, enough that the timed steps open
    shards after the buffer's fill, then over the same sequences written by
    the port's gzip convert_to_shards: the step log and the final weights
    equal bit for bit; K2-res 4 x n_layer and K3 2 x n_layer a step. The
    zstd decoder's output rate on the host, over the shards' pages, and the
    stream alone over both copies: the fill, a batch, a shard-opening batch."""
    import torch

    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.io import parquet, zstd
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import streaming

    nl = CaduceusConfig.preset("l20").n_layer
    tmp = REPO / "build" / "chip_smoke" / "formats"
    shards = sorted((FIXTURES / "shards").glob("*.parquet"))
    per = [list(parquet.read_parquet(f, ["seq"])["seq"]) for f in shards]
    zdir, gdir = tmp / "zstd_shards", tmp / "gzip_shards"
    zdir.mkdir(parents=True)
    for i in range(FORMAT_STREAM_COPIES):
        shutil.copy(shards[i % len(shards)], zdir / f"shard_{i:05d}.parquet")
    seqs = [s for i in range(FORMAT_STREAM_COPIES) for s in per[i % len(shards)]]
    streaming.convert_to_shards(seqs, gdir, shard_size=len(per[0]))
    log(f"phase 16b: streaming l20 pre-training over {FORMAT_STREAM_COPIES} copies of JAX's "
        f"{len(shards)} zstd shards ({len(seqs)} windows, {len(per[0])} a shard, "
        f"{sum(f.stat().st_size for f in shards)} bytes the pair) and the port's gzip copy, "
        f"batch 32 x 512 bp, bf16, remat, {FORMAT_STREAM_STEPS} steps each")
    # the decoder alone: every zstd page of the shards, timed inside read_parquet
    spent, produced, decode = [0.0], [0], zstd.decompress

    def timed(data, max_output=None):
        t = time.perf_counter()
        out = decode(data, max_output)
        spent[0] += time.perf_counter() - t
        produced[0] += len(out)
        return out

    zstd.decompress = timed
    try:
        t = time.perf_counter()
        for _ in range(3):
            for f in shards:
                parquet.read_parquet(f)
        read_s = (time.perf_counter() - t) / 3
    finally:
        zstd.decompress = decode
    mbs = produced[0] / spent[0] / 1e6
    log(f"  zstd on the host: {produced[0] // 3} bytes of pages a pass, {mbs:.2f} MB/s of "
        f"output; the {len(shards)} shards read in {read_s * 1e3:.1f} ms a pass")
    stream = {name: stream_draws(d, FORMAT_STREAM_BATCHES) for name, d in (("zstd", zdir),
                                                                           ("gzip", gdir))}
    if stream["zstd"]["opens"] != stream["gzip"]["opens"]:
        fail(f"phase 16b: the zstd and gzip streams opened shards at other batches "
             f"({stream['zstd']['opens']}, {stream['gzip']['opens']})")
    for name, r in stream.items():
        log(f"  the {name} stream alone, batch 32 x 512: {r['note']}")
    runs, c = {}, only()
    for name, src in (("zstd", zdir), ("gzip", gdir)):
        args = ["--preset", "l20", "--dataset", f"shards:{src}", "--batch-size", "32",
                "--window", "512", "--dtype", "bfloat16", "--max-steps",
                str(FORMAT_STREAM_STEPS), "--save-steps", str(FORMAT_STREAM_STEPS),
                "--log-steps", "1", "--warmup-steps", "1", "--lr", "1e-3",
                "--output-dir", str(tmp / f"run_{name}")]
        reset_counts()
        t = time.perf_counter()
        with StepLog() as steps:
            pretrain.main(args)
        wall = time.perf_counter() - t
        got = counts()
        want = only(mixer_fwd_res=FORMAT_STREAM_STEPS * 4 * nl,
                    scan_bwd=FORMAT_STREAM_STEPS * 2 * nl)
        if got != want:
            fail(f"phase 16b over the {name} shards launched {got}; expected {want}")
        c = {k: c[k] + got[k] for k in c}
        losses = [s[1] for s in steps]
        if [s[0] for s in steps] != list(range(1, FORMAT_STREAM_STEPS + 1)) or \
                not all(map(math.isfinite, losses)):
            fail(f"phase 16b: bad step log {steps}")
        t_at = {s[0]: s[2] for s in steps}
        runs[name] = dict(losses=losses, wall=wall,
                          step_ms=steady_ms(steps, 1, FORMAT_STREAM_STEPS),
                          each=[round(1e3 * (t_at[k] - t_at[k - 1]), 2)
                                for k in range(2, FORMAT_STREAM_STEPS + 1)])
    if runs["zstd"]["losses"] != runs["gzip"]["losses"]:
        fail(f"phase 16b: losses over zstd {runs['zstd']['losses']} != over gzip "
             f"{runs['gzip']['losses']}")
    a = torch.load(tmp / "run_zstd" / "final" / "pytorch_model.bin", weights_only=True)
    b = torch.load(tmp / "run_gzip" / "final" / "pytorch_model.bin", weights_only=True)
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        fail("phase 16b: the zstd and gzip runs reached other final weights")
    opening = [i + 1 for i in stream["zstd"]["opens"] if i < FORMAT_STREAM_STEPS]
    log(f"  losses {runs['zstd']['losses']} over both, final weights equal bit for bit; "
        f"steps 2-{FORMAT_STREAM_STEPS} (steps {opening} draw a shard-opening batch): "
        f"{runs['zstd']['step_ms']:.2f} ms a step over zstd {runs['zstd']['each']}, "
        f"{runs['gzip']['step_ms']:.2f} over gzip {runs['gzip']['each']}; "
        f"{runs['zstd']['wall']:.1f} / {runs['gzip']['wall']:.1f} s a run; K2-res {4 * nl}, "
        f"K3 {2 * nl} a step")
    return c, dict(zstd_mbs=mbs, read_ms=read_s * 1e3, zstd_step_ms=runs["zstd"]["step_ms"],
                   gzip_step_ms=runs["gzip"]["step_ms"],
                   **{f"{name}_{k}": r[k] for name, r in stream.items()
                      for k in ("fill_ms", "batch_ms", "open_ms")})


def phase_format_finetune(dev, base):
    """16c: ``lora_fine_tune train`` with l20 (``base``), batch 8, bf16,
    dropout 0.1, remat, 3 steps, on JAX's two committed zstd tables (scalar
    label; multi-label lists) and on the same rows as .npz: step losses and
    final adapters equal bit for bit. ``tokenize`` to .parquet reads back
    equal to its .npz. An out_proj + head adapter exported as PEFT
    (adapter_model.safetensors) and run through ``evaluate`` gives the
    in-memory adapter's metrics."""
    import argparse
    import logging

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import lora_fine_tune as ft
    from plantcaduceus_tpu_torch.compat import peft_adapter
    from plantcaduceus_tpu_torch.downstream import metrics as M
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora

    cfg = CaduceusConfig.preset("l20")
    nl = cfg.n_layer
    tmp = REPO / "build" / "chip_smoke" / "formats"
    log(f"phase 16c: lora_fine_tune train with l20 on JAX's zstd tables and as .npz, batch "
        f"{FORMAT_FT_BATCH}, bf16, dropout 0.1, {FORMAT_FT_STEPS} steps")
    args = ["--model-name", str(base), "--max-steps", str(FORMAT_FT_STEPS), "--train-batch-size",
            str(FORMAT_FT_BATCH), "--grad-accum", "1", "--lora-dropout", "0.1",
            "--learning-rate", "1e-3", "--warmup-steps", "1", "--save-steps",
            str(FORMAT_FT_STEPS), "--eval-steps", str(FORMAT_FT_STEPS), "--logging-steps", "1",
            "--eval-batch-size", str(FORMAT_FT_EVAL)]
    c, figs = only(), {}
    for task, name in FORMAT_FT_TABLES:
        table = FIXTURES / f"{name}.parquet"
        ids, labels = ft._load_data(table)
        npz = tmp / f"{name}.npz"
        ft._save_data(npz, {"input_ids": ids,
                            ("labels" if task == "multi_label" else "label"): labels})
        runs = {}
        for fmt, path in (("parquet", table), ("npz", npz)):
            steps, handler = ft_step_log()
            reset_counts()
            t = time.perf_counter()
            try:
                ft.main(["train", "--train-dir", str(path), "--valid-dir", str(path),
                         "--task-type", task, "--output-dir", str(tmp / f"ft_{name}_{fmt}"),
                         *args])
            finally:
                logging.getLogger("plantcaduceus_tpu_torch.cli.lora_fine_tune") \
                    .removeHandler(handler)
            wall = time.perf_counter() - t
            got = counts()
            mb = 2 * nl  # a microbatch: both directions of every layer
            n_eval = -(-len(ids) // FORMAT_FT_EVAL) * 2 * nl
            want = only(scan_fwd_hb=FORMAT_FT_STEPS * 2 * mb, scan_bwd=FORMAT_FT_STEPS * mb,
                        mixer_fwd_x=n_eval)
            if got != want:
                fail(f"phase 16c {name} from {fmt} launched {got}; expected {want}")
            c = {k: c[k] + got[k] for k in c}
            times = {s[0]: s[2] for s in steps}
            runs[fmt] = dict(losses=[s[1] for s in steps], wall=wall,
                             each=[1e3 * (times[k] - times[k - 1])
                                   for k in range(2, FORMAT_FT_STEPS + 1)])
        if runs["parquet"]["losses"] != runs["npz"]["losses"]:
            fail(f"phase 16c {name}: losses from parquet {runs['parquet']['losses']} != from "
                 f".npz {runs['npz']['losses']}")
        a = _adapter_tensors(tmp / f"ft_{name}_parquet" / "final" / "adapter.pt")
        b = _adapter_tensors(tmp / f"ft_{name}_npz" / "final" / "adapter.pt")
        if not a or a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
            fail(f"phase 16c {name}: the parquet and .npz runs reached other adapters")
        each = runs["parquet"]["each"] + runs["npz"]["each"]
        figs[name] = float(np.median(each))
        log(f"  {name} ({task}, {len(ids)} rows, labels {np.asarray(labels).shape}): losses "
            f"{runs['parquet']['losses']} from parquet and .npz, final adapters equal bit for "
            f"bit; {figs[name]:.2f} ms a step, the median of steps 2-{FORMAT_FT_STEPS} of both "
            f"runs {[round(v, 2) for v in each]} (parquet, then .npz); "
            f"{runs['parquet']['wall']:.1f} / {runs['npz']['wall']:.1f} s a run")

    # tokenize on the card's host: .parquet (gzip, list columns) equal to .npz
    rng = np.random.default_rng(16)
    tsv = tmp / "tok.tsv"
    tsv.write_text("sequence\tlabel\n" + "".join(
        f"{''.join(rng.choice(list('ACGTN'), 512))}\t1{rng.integers(0, 2)}{rng.integers(0, 2)}\n"
        for _ in range(32)))
    for task in ("classification", "multi_label"):
        got = {}
        for suffix in ("parquet", "npz"):
            out = tmp / f"tok_{task}.{suffix}"
            ft.main(["tokenize", "--data-dir", str(tsv), "--output-path", str(out),
                     "--model-name", str(base), "--sequence-length", "512", "--task-type", task])
            got[suffix] = ft._load_data(out)
        if not all(np.array_equal(x, y) for x, y in zip(got["parquet"], got["npz"])):
            fail(f"phase 16c: tokenize {task} to .parquet reads back unlike its .npz")
    log("  tokenize to .parquet (gzip, list columns) reads back equal to .npz: classification "
        "and multi-label, 32 rows")

    # the adapter as PEFT safetensors, through evaluate, vs in memory
    table = FIXTURES / "lora_cls.parquet"
    adapters, head, cfg_l, task, _ = lora.load_adapter(tmp / "ft_lora_cls_parquet" / "final")
    sub = {"out_proj": adapters["out_proj"]}
    peft_dir = tmp / "peft"
    shutil.rmtree(peft_dir, ignore_errors=True)
    peft_adapter.export_peft_adapter(peft_dir, sub, head, cfg, cfg_l, task, str(base))
    if sorted(p.name for p in peft_dir.iterdir()) != ["adapter_config.json",
                                                      "adapter_model.safetensors"]:
        fail(f"phase 16c: the PEFT export wrote {sorted(p.name for p in peft_dir.iterdir())}")
    mj = tmp / "peft_metrics.json"
    reset_counts()
    ft.main(["evaluate", "--checkpoint-dir", str(peft_dir), "--data-dir", str(table),
             "--model-name", str(base), "--batch-size", str(FORMAT_FT_EVAL), "--metrics-json",
             str(mj)])
    got_c = counts()
    ids, labels = ft._load_data(table)
    n_eval = -(-len(ids) // FORMAT_FT_EVAL) * 2 * nl
    if got_c != only(mixer_fwd_x=n_eval):
        fail(f"phase 16c evaluate launched {got_c}; expected mixer_fwd_x={n_eval}")
    c = {k: c[k] + got_c[k] for k in c}
    ns = argparse.Namespace(model_name=str(base), lora_r=cfg_l.r, lora_alpha=cfg_l.alpha,
                            lora_dropout=cfg_l.dropout, learning_rate=1e-3, warmup_steps=50,
                            max_steps=500, weight_decay=0.01, bf16=True, device="cuda",
                            full_finetune=False, grad_accum=1)
    model, _, _, _, _, _, infer_fn, _, device = ft._build(ns, task, head["b"].shape[0])
    state = lora.LoraTrainState(lora.trainable_copy(sub, device),
                                lora.trainable_copy(head, device), None, 0)
    logits = ft._predict_all(infer_fn, state, model, ids, FORMAT_FT_EVAL)
    want = {k: float(v) for k, v in ft._task_metrics(task, logits, labels, M).items()}
    metrics = json.loads(mj.read_text())
    if metrics != want:
        fail(f"phase 16c: evaluate on the safetensors adapter gave {metrics}; in memory {want}")
    log(f"  PEFT adapter_model.safetensors (out_proj + head) through evaluate: "
        f"{', '.join(f'{k} {v:.4f}' for k, v in metrics.items())}, equal to the in-memory "
        f"adapter's")
    return c, figs


def phase_formats(dev, tsv, n_valid):
    """Phase 16. Each main path's counts are zeroed just before it and read
    just after."""
    t = time.perf_counter()
    marks = [t]
    ca, fa, base = phase_format_checkpoints(dev, tsv, n_valid)
    marks.append(time.perf_counter())
    cb, fb = phase_format_streaming(dev)
    marks.append(time.perf_counter())
    cc, fc = phase_format_finetune(dev, base)
    marks.append(time.perf_counter())
    c = {k: ca[k] + cb[k] + cc[k] for k in ca}
    log("phase 16 seconds: " + ", ".join(f"{n} {b - a:.1f}" for n, a, b in zip(
        ("16a checkpoints", "16b streaming", "16c fine-tuning"), marks, marks[1:])))
    log(f"phase 16 ok in {time.perf_counter() - t:.1f} s: zstd {fb['zstd_mbs']:.2f} MB/s on "
        f"the host; a shard-opening batch {fb['zstd_open_ms']:.2f} ms over zstd, "
        f"{fb['gzip_open_ms']:.2f} over gzip; streaming l20 {fb['zstd_step_ms']:.2f} ms a step "
        f"over zstd shards, {fb['gzip_step_ms']:.2f} over gzip; LoRA l20 median "
        f"{', '.join(f'{k} {v:.2f}' for k, v in fc.items())} ms a step; launches "
        f"{dict((k, v) for k, v in c.items() if v)}")
    return c, dict(checkpoints=fa, streaming=fb, finetune=fc)


# ---------------------------------------------------------------------------
# Phase 17: context and data parallelism (parallel/mesh.py,
# parallel/collectives.py, ops/seq_parallel.py, ops/ssd_seq_parallel.py,
# ops/conv.halo_depthwise_conv_silu, the data x seq runner and train
# step) on ranks of ``torch.distributed.run`` that share the one card over
# gloo: every rank runs its kernels on the card, and gloo stages the
# collectives through the host, so the times below are the card's for ranks
# sharing it, not a scaling result. First K3's g0 / emit_dh0 at the seq
# path's local shape (pc2-small, 4 windows + their RC stream = 8 rows x 2048
# x 1536, R 48) against the plain version, and chained over two halves
# against one call; then pc2-small and pc2-small-ssd at 4 of their 24
# layers (full widths; the depth cut to fit the script's time) at 8192 bp
# (scoring at seq 4; pre-training at data 2 x seq 2, global batch 4, remat:
# 3 fp32 steps, every step's gradients and the weights after them gated, and
# 2 bf16 steps, the first's gradients gated and the second timed) and l20 at
# 512 bp (scoring with each batch's rows split over data 2, K2;
# data-parallel training, K2-res and K3), each against one process on the
# same card with the same weights and inputs.
PAR_L, PAR_WINDOWS, PAR_STEPS, PAR_BF16_STEPS = 8192, 4, 3, 2
PAR_MODELS = ("pc2-small", "pc2-small-ssd")
PAR_LAYERS = 4   # of pc2-small's 24: full widths and L, the depth cut to fit the time limit
DP_L, DP_WINDOWS, DP_BATCH, DP_ROWS = 512, 64, 16, 8
PAR_SEED = 17
PAR_TIMEOUT_S = 150   # the 2- and 4-rank jobs' cap, clipped to the deadline


def par_inputs(workdir: Path) -> dict:
    """The phase's inputs from a seed, written where the ranks read them:
    per pc2 model 4 windows of 8192 ids and 4 training batches of 4 rows;
    for l20 64 windows (row-split scoring) and one training batch of 8 rows."""
    import numpy as np

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    tok = DnaTokenizer()
    rng = np.random.default_rng(PAR_SEED)
    inp = {"ids": tok.encode_batch(["".join(rng.choice(list("ACGT"), PAR_L))
                                    for _ in range(PAR_WINDOWS)])}
    seqs = data_lib.sequence_source("synthetic", window=PAR_L, synthetic_n=64, seed=PAR_SEED)
    ds = data_lib.PretrainDataset(seqs, tok, PAR_WINDOWS, seed=PAR_SEED)
    for s in range(1, 1 + PAR_STEPS):
        inp.update({f"b{s}_{k}": v for k, v in ds.batch_at(s).items()})
    windows = ["".join(rng.choice(list("ACGT"), DP_L)) for _ in range(DP_WINDOWS)]
    inp["dp_windows"] = np.array(windows)
    inp["dp_alt"] = np.array(["ACGT"[("ACGT".index(w[DP_L // 2 - 1]) + 1) % 4] for w in windows])
    dseqs = data_lib.sequence_source("synthetic", window=DP_L, synthetic_n=64, seed=PAR_SEED)
    dds = data_lib.PretrainDataset(dseqs, tok, DP_ROWS, seed=PAR_SEED)
    for s in range(2):
        inp.update({f"dpb{s}_{k}": v for k, v in dds.batch_at(s).items()})
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inp)
    return inp


def batch_of(inp, prefix):
    return {k[len(prefix):]: inp[k] for k in inp if k.startswith(prefix)}


def par_model(preset, dev):
    """``preset`` from the phase's seed, on ``dev``: the pc2 models at
    ``PAR_LAYERS`` layers, the others at full depth."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig.preset(preset, **({"n_layer": PAR_LAYERS} if preset in PAR_MODELS
                                           else {}))
    return cfg, Caduceus(cfg, init_params(cfg, seed=PAR_SEED)).to(dev)


class KeptGrads:
    """The optimizer with the gradients of each update kept on the host:
    the train step's own gradients, checked without computing them twice."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params, **kw):
        self.grads.append({n: g.detach().to("cpu", copy=True) for n, g in grads.items()})
        return self.opt.update(grads, state, params, **kw)


def par_run(preset, dev, inp, scoring_mesh, train_mesh, sync=None):
    """One model's phase-17 work, in one process or on one rank (the meshes
    None in one process): fp32 and bf16 logits of the 4 windows (the bf16
    run timed), then training from the seeded weights: 3 fp32 steps (every
    step's gradients, the weights after the third) and 2 bf16 steps (the
    recipe's dtype: the first step's gradients, the second step timed); the
    counts and seconds of each part."""
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    sync = sync or torch.cuda.synchronize
    t0 = time.perf_counter()
    cfg, model = par_model(preset, dev)
    seeded = {k: v.clone() for k, v in model.state_dict().items()}
    out, cnt, secs = {}, {}, {"init": time.perf_counter() - t0}
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        runner = InferenceRunner(model, cfg, dtype=dtype, batch_size=PAR_WINDOWS, device=dev,
                                 mesh=scoring_mesh)
        sync()
        t = time.perf_counter()
        out[f"logits_{dtype}"] = torch.from_numpy(
            runner.run(inp["ids"], lambda o: o["logits"], progress=False))
        sync()
        out["score_s"] = time.perf_counter() - t
    cnt["scoring"] = counts()
    secs["scoring"] = time.perf_counter() - t0 - secs["init"]
    reset_counts()
    for dtype, n_steps in ((torch.float32, PAR_STEPS), (torch.bfloat16, PAR_BF16_STEPS)):
        t1 = time.perf_counter()
        model.load_state_dict(seeded)
        # the pre-training recipe's learning rate, without its 1000-step warmup
        opt = KeptGrads(make_optimizer(learning_rate=2e-4, warmup_steps=1,
                                       total_steps=PAR_STEPS,
                                       params=dict(model.named_parameters())))
        init, step, _ = step_lib.make_train_step(cfg, opt, model, dtype=dtype, remat=True,
                                                 device=dev, mesh=train_mesh)
        state, times = init(), []
        for s in range(1, n_steps + 1):
            sync()
            t = time.perf_counter()
            state, m = step(state, batch_of(inp, f"b{s}_"))
            out[f"step_loss{s}_{dtype}"] = float(m["loss"])
            times.append(time.perf_counter() - t)
        out[f"step_ms_{dtype}"] = 1e3 * sum(times[1:]) / len(times[1:])
        out[f"grads_{dtype}"] = opt.grads
        if dtype == torch.float32:
            out["weights"] = {n: p.detach().to("cpu", copy=True)
                              for n, p in model.named_parameters()}
        secs[f"steps_{dtype}"] = time.perf_counter() - t1
    cnt["steps"] = counts()
    out["counts"], out["secs"] = cnt, secs
    return out


def dp_run(dev, inp, mesh, sync=None):
    """l20 at 512 bp in one process or on one rank of a data-2 mesh: fp32
    scores of the 64 windows (each batch of 16 rows split over data, one
    process at the 8 rows of a rank's forward), their windows/s, and two
    fp32 training steps (the second timed; the weights after)."""
    import torch

    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    sync = sync or torch.cuda.synchronize
    cfg, model = par_model("l20", dev)
    runner = InferenceRunner(model, cfg, dtype=torch.float32,
                             batch_size=DP_BATCH if mesh is not None else DP_BATCH // 2,
                             device=dev, mesh=mesh)
    seqs = [str(w) for w in inp["dp_windows"]]
    out, cnt = {}, {}
    reset_counts()
    probs = zero_shot.nucleotide_probs(runner, DnaTokenizer(), seqs, DP_L // 2 - 1,
                                       progress=False)
    cnt["scoring"] = counts()
    sync()
    t = time.perf_counter()
    zero_shot.nucleotide_probs(runner, DnaTokenizer(), seqs, DP_L // 2 - 1, progress=False)
    sync()
    out["score_s"] = time.perf_counter() - t
    out["scores"] = torch.from_numpy(zero_shot.log_ratio_scores(
        probs, [w[DP_L // 2 - 1] for w in seqs], [str(a) for a in inp["dp_alt"]]))
    reset_counts()
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=1, total_steps=1,
                         params=dict(model.named_parameters()))
    init, step, _ = step_lib.make_train_step(cfg, opt, model, dtype=torch.float32, remat=True,
                                             device=dev, mesh=mesh)
    state = init()
    for s in range(2):
        sync()
        t = time.perf_counter()
        state, m = step(state, batch_of(inp, f"dpb{s}_"))
        out[f"step_loss{s}"] = float(m["loss"])
    out["step_ms"] = 1e3 * (time.perf_counter() - t)  # the second step's
    cnt["step"] = counts()
    out["weights"] = {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()}
    out["counts"] = cnt
    return out


def time_collectives() -> dict:
    """Wrap the collectives' host-side bodies and the train step's gradient
    sum so that each adds its wall seconds (the device synchronised at its
    start: the staging copy waits for the card) to the returned dict."""
    from plantcaduceus_tpu_torch.parallel import collectives
    from plantcaduceus_tpu_torch.train import step as step_lib

    spent = {}

    def timed(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] = spent.get(key, 0.0) + time.perf_counter() - t

        setattr(mod, name, wrapper)

    for name in ("_all_reduce", "_all_gather", "_reduce_scatter", "_ppermute"):
        timed(collectives, name, name.lstrip("_"))
    timed(step_lib, "sync_grads", "gradient_sum")
    return spent


def phase17_rank(job: str, workdir: Path) -> None:
    """One rank of phase 17 (started by ``torch.distributed.run``): ``job``
    "pc2" (4 ranks: seq 4 scoring, data 2 x seq 2 training) or "l20" (2
    ranks, data 2). Rank 0 writes the results; every rank its counts and
    peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from plantcaduceus_tpu_torch.parallel import mesh as meshlib

    if not torch.cuda.is_available():
        fail("phase 17 rank: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank_log("imported")
    dev = meshlib.initialize_distributed("cuda", timeout_s=RANK_TIMEOUT_S)
    rank = meshlib.world()[0]
    rank_log("joined the process group")
    configs = ([meshlib.MeshConfig(seq=4), meshlib.MeshConfig(data=2, seq=2)] if job == "pc2"
               else [meshlib.MeshConfig(data=2)])
    meshes = [meshlib.make_mesh(c, RANK_TIMEOUT_S) for c in configs]
    rank_go()
    inp = dict(np.load(workdir / "inputs.npz"))
    torch.cuda.reset_peak_memory_stats(dev)
    comm = time_collectives()

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    if job == "pc2":
        res = {p: par_run(p, dev, inp, *meshes, sync) for p in PAR_MODELS}
    else:
        res = {"l20": dp_run(dev, inp, meshes[0], sync)}
    mine = {"counts": {p: r.pop("counts") for p, r in res.items()},
            "secs": {p: r.pop("secs", None) for p, r in res.items()}, "comm_s": comm,
            "peak": torch.cuda.max_memory_allocated(dev), "device": str(dev),
            "backend": dist.get_backend()}
    (workdir / f"{job}_rank{rank}.json").write_text(json.dumps(mine))
    rank_log("work done")
    if rank == 0:
        torch.save(res, workdir / f"{job}.pt")
    dist.barrier()
    dist.destroy_process_group()
    rank_log("results written")


def rank_log(what: str) -> None:
    """On a rank: ``what`` with the seconds since its job was started, in
    the job's log."""
    t0 = float(os.environ.get("SMOKE_JOB_T0", time.time()))
    log(f"rank {os.environ.get('RANK', '?')}: +{time.time() - t0:.1f} s {what}")


def stop_ranks(proc, grace_s: float = 60) -> None:
    """End a ``torch.distributed.run`` still running: SIGTERM to it stops its
    ranks (they run in sessions of their own, out of reach of a kill of its
    group); SIGKILL to its group after ``grace_s``."""
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()


class RankJob:
    """``python -m torch.distributed.run --standalone --nproc-per-node n
    chip_smoke.py *rank_args``, started now with its output in
    ``workdir/name.log``. Its ranks import, join their process group and
    make their meshes, then wait for :meth:`wait` to let them work (a file
    ``workdir/name.go``), so their start overlaps what the script does
    meanwhile (the one-process references, earlier phases) without sharing
    the card with it; a rank given no go before the script's deadline
    fails. ``timeout_s`` caps the job from its go. Stop it with :meth:`stop`
    on any way out."""

    def __init__(self, n: int, rank_args: list, workdir: Path, name: str, timeout_s: float):
        self.n, self.name, self.timeout_s = n, name, timeout_s
        self.logf, self.go = workdir / f"{name}.log", workdir / f"{name}.go"
        self.go.unlink(missing_ok=True)
        self.fh = open(self.logf, "wb")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(n), str(REPO / "chip_smoke.py"), *rank_args],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                               SMOKE_JOB_T0=repr(time.time()), SMOKE_GO=str(self.go),
                               SMOKE_GO_WAIT=repr(min(DEADLINE_S, time_left()))),
            stdout=self.fh, stderr=subprocess.STDOUT, start_new_session=True)

    def wait(self, phase: str) -> float:
        """Let the ranks work; fail ``phase`` if a rank fails
        (torch.distributed.run then stops its siblings) or the job outlasts
        its cap or the script's deadline, whichever comes first (the ranks
        are stopped). Returns the seconds from the go to its end."""
        check_clock(phase)
        timeout_s = min(self.timeout_s, time_left())
        t = time.perf_counter()
        self.go.touch()
        try:
            rc = self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.stop()
            rc = f"a timeout after {timeout_s:.0f} s"
        self.fh.close()
        if rc != 0:
            tail = self.logf.read_text(errors="replace")[-6000:]
            fail(f"{phase}: {self.n} ranks of {self.name} ended with {rc}:\n{tail}")
        return time.perf_counter() - t

    def stop(self) -> None:
        stop_ranks(self.proc)


def rank_go() -> None:
    """On a rank of a :class:`RankJob`: wait for its go (nothing outside
    one)."""
    go = os.environ.get("SMOKE_GO")
    if not go:
        return
    end = time.time() + float(os.environ["SMOKE_GO_WAIT"])
    rank_log("waiting for the go")
    while not os.path.exists(go):
        if time.time() > end:
            fail(f"rank {os.environ.get('RANK')}: no go within {os.environ['SMOKE_GO_WAIT']} s")
        time.sleep(0.05)
    rank_log("go")


def k3_options_check(dev):
    """K3 with g0 and emit_dh0 at the seq path's local shape against its
    plain version (both directions, bf16 and fp32, fused dt), K1-hb's first
    entry state against the h0 it was given (K3 recomputes from it), and two
    calls over the halves chained through dh0 -> g0 against one call."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_scan
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rows, L, D, N, R = 2 * PAR_WINDOWS, PAR_L // 4, 1536, 16, 48
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    r = lambda *shape, sc=1.0: torch.randn(*shape, generator=gen, device=dev) * sc
    res, err = {}, 0.0
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        x, gy = r(rows, L, D).to(dtype), r(rows, L, D).to(dtype)
        dt = r(rows, L, R, sc=0.5).to(dtype)
        Bm, Cm = r(rows, L, N).to(dtype), r(rows, L, N).to(dtype)
        A = -torch.exp(r(D, N, sc=0.5))
        Ds, dtb, w = r(D), r(D, sc=0.3), r(R, D, sc=0.3)
        h0, g0 = r(rows, D, N), r(rows, D, N)
        kres = {}
        for reverse in (False, True):
            _, hb = cuda_scan.scan_fwd(x, dt, A, Bm, Cm, Ds, dtb, w, reverse, HB_CHUNK, h0=h0)
            if not torch.equal(hb[:, 0], h0):
                fail("phase 17: K1-hb's first chunk-entry state is not the h0 it was given")
            args = (x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse, HB_CHUNK)
            got = cuda_scan.scan_bwd(*args, g0=g0, emit_dh0=True)
            torch.cuda.synchronize()
            t = time.perf_counter()   # the plain version's one call, timed
            want = cuda_scan.scan_bwd_plain(*args, g0=g0, emit_dh0=True)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.perf_counter() - t)
            for n, g, wnt in zip(("dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD", "dW", "dh0"),
                                 got, want):
                err = max(err, compare(f"K3-g0/dh0 {dn} {'rev' if reverse else 'fwd'} {n}", g,
                                       wnt, dn, F32_TOL))
            nl = L // 2 // HB_CHUNK
            spans = [((0, L // 2), hb[:, :nl]), ((L // 2, L), hb[:, nl:])]
            if reverse:
                spans = [((L // 2, L), hb[:, :nl]), ((0, L // 2), hb[:, nl:])]
            part = lambda t, a, b: t[:, a:b].contiguous()
            g, outs = g0, {}
            for (a, b), hbp in reversed(spans):
                outs[a] = cuda_scan.scan_bwd(part(x, a, b), part(gy, a, b), part(dt, a, b), A,
                                             part(Bm, a, b), part(Cm, a, b), Ds, dtb,
                                             hbp.contiguous(), w, reverse, HB_CHUNK, g0=g,
                                             emit_dh0=True)
                g = outs[a][-1]
            for i, n in enumerate(("dx", "ddt", "dB", "dC")):
                if not torch.equal(torch.cat([outs[0][i], outs[L // 2][i]], 1), got[i]):
                    fail(f"phase 17: K3 chained over two halves: {n} differs from one call")
            if not torch.equal(g, got[-1]):
                fail("phase 17: K3 chained over two halves: dh0 differs from one call")
            for i, n in zip(range(4, 8), ("dA", "ddt_bias", "dD", "dW")):
                rel = rel_gap(outs[0][i] + outs[L // 2][i], got[i])
                if rel > 1e-5:
                    fail(f"phase 17: K3 chained over two halves: {n} off by {rel:.3e}")
            kres[reverse] = dict(
                ms=time_ms(lambda: cuda_scan.scan_bwd(*args, g0=g0, emit_dh0=True), 10),
                plain_ms=plain_ms,
                no_options_ms=time_ms(lambda: cuda_scan.scan_bwd(*args), 10))
        nbytes, flops, sfu = scan_bwd_work(rows, L, D, N, R, x.element_size())
        b, by, _ = bound_ms(nbytes + 8 * rows * D * N, flops, sfu)
        res[dn] = dict(ms=max(k["ms"] for k in kres.values()),
                       plain_ms=max(k["plain_ms"] for k in kres.values()),
                       no_options_ms=max(k["no_options_ms"] for k in kres.values()),
                       bound_ms=b, bound_by=by)
        log(f"  K3-g0/dh0 {dn} at {rows} x {L} x {D} (N {N}, R {R}): "
            + "; ".join(f"{'rev' if rv else 'fwd'} {k['ms']:.3f} ms (without the options "
                        f"{k['no_options_ms']:.3f}, plain {k['plain_ms']:.1f})"
                        for rv, k in kres.items())
            + f"; bound {b:.3f} ms ({by}); chained halves equal bit for bit")
    return res, err


def worst_weight(name, sh, one) -> dict:
    """Where the fp32 weights after the steps differ most in leaf ``name``:
    the element, |w| there and the leaf's max |w|, the gap, and each step's
    gradient there on the ranks and in one process, beside the leaf's max
    |gradient| (a sign that differs on a gradient near zero becomes, under
    Adam's normalised update, a weight gap of up to 2 x the learning rate)."""
    import numpy as np

    got, want = sh["weights"][name], one["weights"][name]
    diff = (got - want).abs()
    i = int(diff.argmax())
    at = lambda t: float(t.flatten()[i])
    return dict(
        element=[int(j) for j in np.unravel_index(i, tuple(got.shape))],
        gap=float(diff.flatten()[i]), w=at(want), leaf_max_w=float(want.abs().max()),
        grads_ranks=[at(g[name]) for g in sh["grads_torch.float32"]],
        grads_one=[at(g[name]) for g in one["grads_torch.float32"]],
        leaf_max_grad=[float(g[name].abs().max()) for g in one["grads_torch.float32"]])


# Expected launches of each part, on every rank (pc2: PAR_LAYERS layers x 2
# directions; the sharded scan's two passes, remat's recompute; l20: 20 x 2).
def par_expected(preset, n_layer, sharded):
    per = 2 * n_layer
    if preset == "pc2-small-ssd":
        scoring = only(ssd_fwd=2 * per) if sharded else only(mixer2_fwd=2 * per)
        step = (only(ssd_fwd_fentry=2 * per, ssd_bwd=per) if sharded
                else only(mixer2_fwd_res=2 * per, ssd_bwd_pre_silu=per))
    else:
        scoring = only(scan_fwd=2 * 2 * per) if sharded else only(mixer_fwd=2 * per)
        step = (only(scan_fwd_hb=2 * 2 * per, scan_bwd_g0=2 * per) if sharded
                else only(mixer_fwd_res=2 * per, scan_bwd=per))
    # scoring in fp32 and bf16; 3 steps in fp32 and 2 in bf16, a step the
    # forward and remat's recompute (the sharded scan: two passes each) and
    # the adjoint (the sharded scan's: one a pass)
    return {"scoring": scoring,
            "steps": {k: v * (PAR_STEPS + PAR_BF16_STEPS) for k, v in step.items()}}


def phase_parallel(dev, card, start_later=None):
    """Phase 17 (see above). ``start_later``, if given, is called once
    phase 17's own rank jobs are started, to start the later phases' too
    (their ranks' start then overlaps phase 17). Returns (the launches of
    the ranks' main paths by kernel, summed over ranks; K3-g0/dh0's row;
    the figures)."""
    t0 = time.perf_counter()
    log("phase 17: context and data parallelism, ranks of torch.distributed.run sharing "
        f"{card} over gloo")
    k3, k3_err = k3_options_check(dev)
    workdir = REPO / "build" / "chip_smoke" / "phase17"
    inp = par_inputs(workdir)
    # both jobs' ranks start now and wait for their go: their start overlaps
    # the one-process references, their work runs alone on the card
    jobs = {job: RankJob(n, ["--phase17-rank", job, str(workdir)], workdir, job, PAR_TIMEOUT_S)
            for job, n in (("pc2", 4), ("l20", 2))}
    if start_later is not None:
        start_later()
    try:
        return par_checks(dev, inp, workdir, jobs, k3, k3_err, t0)
    finally:   # on a failure too
        for job in jobs.values():
            job.stop()


def par_checks(dev, inp, workdir, jobs, k3, k3_err, t0):
    """Phase 17's one-process references, its rank jobs (``jobs``, started)
    and its gates."""
    import torch

    single = {}
    for preset in PAR_MODELS:   # one process, the same card, weights and inputs
        single[preset] = par_run(preset, dev, inp, None, None)
        torch.cuda.empty_cache()
    single["l20"] = dp_run(dev, inp, None)
    torch.cuda.empty_cache()
    l20_want = {"scoring": only(mixer_fwd_x=2 * 20 * DP_WINDOWS // (DP_BATCH // 2)),
                "step": only(mixer_fwd_res=2 * 80, scan_bwd=2 * 40)}
    for preset, want in (*((p, par_expected(p, PAR_LAYERS, False)) for p in PAR_MODELS),
                         ("l20", l20_want)):
        if single[preset]["counts"] != want:
            fail(f"phase 17 one-process {preset} launched {single[preset]['counts']}; "
                 f"expected {want}")
    secs = {name: job.wait("phase 17") for name, job in jobs.items()}
    sharded = {**torch.load(workdir / "pc2.pt", weights_only=False),
               **torch.load(workdir / "l20.pt", weights_only=False)}
    ranks = {job: [json.loads((workdir / f"{job}_rank{r}.json").read_text()) for r in range(n)]
             for job, n in (("pc2", 4), ("l20", 2))}
    total = {k: 0 for k in _counters()}
    total["scan_bwd_g0"] = 0
    for job, rs in ranks.items():
        for r, rr in enumerate(rs):
            if rr["device"] != "cuda:0" or rr["backend"] != "gloo":
                fail(f"phase 17 {job} rank {r} ran on {rr['device']} over {rr['backend']}")
            for preset, parts in rr["counts"].items():
                want = (par_expected(preset, PAR_LAYERS, True) if job == "pc2" else
                        {"scoring": only(mixer_fwd_x=2 * 20 * DP_WINDOWS // DP_BATCH),
                         "step": only(mixer_fwd_res=2 * 80, scan_bwd=2 * 40)})
                if parts != want:
                    fail(f"phase 17 {job} rank {r} {preset} launched {parts}; expected {want}")
                for c in parts.values():
                    for k, v in c.items():
                        total[k] += v
    figs = {}
    for preset in PAR_MODELS:
        one, sh = single[preset], sharded[preset]
        f32, b16 = "logits_torch.float32", "logits_torch.bfloat16"
        lg = rel_gap(sh[f32], one[f32])
        if not (math.isfinite(lg) and lg <= FORWARD_TOL):
            fail(f"phase 17 {preset}: seq-4 fp32 logits off by {lg:.3e} of max |logit|")
        gap, bg = rel_gap(one[b16], one[f32]), rel_gap(sh[b16], one[f32])
        if not (math.isfinite(bg) and bg <= 2 * gap):
            fail(f"phase 17 {preset}: seq-4 bf16 logits {bg:.3e} from fp32, beyond 2 x the "
                 f"one-process gap {gap:.3e}")
        # every fp32 step's gradients, then step 1's bf16 gradients within
        # 2 x the one process's bf16 gap from its fp32 gradients
        wf, wfn = 0.0, ""
        for s, (got, want) in enumerate(zip(sh["grads_torch.float32"],
                                            one["grads_torch.float32"]), 1):
            w, n = grads_agree(f"phase 17 {preset} fp32 step {s}", got, want)
            if w >= wf:
                wf, wfn = w, f"step {s} {n}"
        ref = one["grads_torch.float32"][0]
        ggap = max(rel_gap(one["grads_torch.bfloat16"][0][n], g) for n, g in ref.items())
        wb, wbn = grads_agree(f"phase 17 {preset} bf16 step 1", sh["grads_torch.bfloat16"][0],
                              one["grads_torch.bfloat16"][0], 2 * ggap)
        ww, wwn = grads_agree(f"phase 17 {preset} fp32 weights after {PAR_STEPS} steps",
                              sh["weights"], one["weights"])
        figs[preset] = dict(
            logits_fp32=lg, logits_bf16=bg, logits_bf16_gap=gap, grads_fp32=(wf, wfn),
            grads_bf16=(wb, wbn), grads_bf16_gap=ggap, weights_fp32=(ww, wwn),
            worst_weight=worst_weight(wwn, sh, one),
            wps=PAR_WINDOWS / sh["score_s"], wps_single=PAR_WINDOWS / one["score_s"],
            step_ms=sh["step_ms_torch.bfloat16"], step_ms_single=one["step_ms_torch.bfloat16"],
            step_ms_fp32=sh["step_ms_torch.float32"],
            step_ms_fp32_single=one["step_ms_torch.float32"],
            losses=[sh[f"step_loss{s}_torch.float32"] for s in range(1, PAR_STEPS + 1)],
            losses_single=[one[f"step_loss{s}_torch.float32"]
                           for s in range(1, PAR_STEPS + 1)])
        f = figs[preset]
        f["secs"], f["secs_single"] = ranks["pc2"][0]["secs"][preset], one["secs"]
        log(f"  {preset} seconds (rank 0 / one process): " + ", ".join(
            f"{k} {v:.1f} / {f['secs_single'][k]:.1f}" for k, v in f["secs"].items()))
        log(f"  {preset} x {PAR_L} bp: seq-4 logits fp32 {lg:.3e} of max (tol "
            f"{FORWARD_TOL:.0e}), bf16 {bg:.3e} from fp32 (one process {gap:.3e}); data 2 x "
            f"seq 2 gradients of {PAR_STEPS} fp32 steps worst {wfn} {wf:.3e} (tol "
            f"{GRAD_TOL:.0e}), bf16 step 1 worst {wbn} {wb:.3e} (tol 2 x {ggap:.3e}); weights "
            f"after {PAR_STEPS} fp32 steps worst {wwn} {ww:.3e} (tol {GRAD_TOL:.0e}); scoring "
            f"{f['wps']:.2f} windows/s on 4 ranks, {f['wps_single']:.2f} in one process; bf16 "
            f"step {f['step_ms']:.1f} ms on 4 ranks, {f['step_ms_single']:.1f} in one process "
            f"(fp32 {f['step_ms_fp32']:.1f} / {f['step_ms_fp32_single']:.1f}); fp32 losses "
            f"{f['losses']} / {f['losses_single']}")
        log(f"  {preset} the weights gap's worst element: {f['worst_weight']}")
    log("  seconds in the collectives on each pc2 rank (both models; the gradient "
        "sum's all_reduce within all_reduce): " + "; ".join(
            ", ".join(f"{k} {v:.1f}" for k, v in rr["comm_s"].items()) for rr in ranks["pc2"]))
    one, sh = single["l20"], sharded["l20"]
    sg = rel_gap(sh["scores"], one["scores"])
    if not torch.equal(sh["scores"], one["scores"]):
        fail(f"phase 17 l20: data-parallel scores differ from one process's ({sg:.3e} of max "
             "|score|)")
    ww, wwn = grads_agree("phase 17 l20 weights after two data-parallel steps", sh["weights"],
                          one["weights"])
    figs["l20"] = dict(scores=sg, weights=(ww, wwn), wps=DP_WINDOWS / sh["score_s"],
                       wps_single=DP_WINDOWS / one["score_s"], step_ms=sh["step_ms"],
                       step_ms_single=one["step_ms"])
    log(f"  l20 x {DP_L} bp, data 2: scores through the row split equal bit for bit; "
        f"weights after two fp32 steps worst {wwn} {ww:.3e}; scoring "
        f"{figs['l20']['wps']:.1f} windows/s on 2 ranks, {figs['l20']['wps_single']:.1f} in "
        f"one process; second step {sh['step_ms']:.1f} ms on 2 ranks, {one['step_ms']:.1f} in "
        "one")
    figs["peak"] = {job: [rr["peak"] for rr in rs] for job, rs in ranks.items()}
    figs["rank_s"] = secs
    figs["seconds"] = time.perf_counter() - t0
    log(f"phase 17 ok in {figs['seconds']:.1f} s (ranks: pc2 {secs['pc2']:.1f} s, l20 "
        f"{secs['l20']:.1f} s); peak bytes by rank {figs['peak']}; launches on the ranks "
        f"{dict((k, v) for k, v in total.items() if v)}")
    k3_row = dict(err=k3_err, **k3)
    return total, k3_row, figs


# ---------------------------------------------------------------------------
# Phase 18: FSDP for pre-training and distillation, and the data axis on
# fine-tuning, embeddings and serving, on ranks sharing the card over gloo.

P18_RANKS, P18_L, P18_ROWS, P18_STEPS = 2, 512, 8, 3
P18_FT_ROWS, P18_EMB_ROWS, P18_EMB_BATCH, P18_SERVE = 16, 64, 16, 4
P18_TIMEOUT_S = 150
P18_SEED = 18


def p18_inputs(workdir: Path) -> dict:
    """The phase's inputs from a seed: l20 pre-training batches of 8 x 512
    (steps 1-3 fp32, 4 bf16), 2 distillation batches, a tokenized
    fine-tuning file of 16 rows, 64 windows to embed with their TSV and a
    classifier over their one-process embeddings (written later), and 4
    windows to serve."""
    import numpy as np

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    tok = DnaTokenizer()
    rng = np.random.default_rng(P18_SEED)
    seqs = data_lib.sequence_source("synthetic", window=P18_L, synthetic_n=64, seed=P18_SEED)
    ds = data_lib.PretrainDataset(seqs, tok, P18_ROWS, seed=P18_SEED)
    inp = {}
    for s in range(1, P18_STEPS + 2):
        inp.update({f"b{s}_{k}": v for k, v in ds.batch_at(s).items()})
    for s in range(2):
        inp.update({f"d{s}_{k}": v for k, v in ds.batch_at(10 + s).items()})
    windows = ["".join(rng.choice(list("ACGT"), P18_L)) for _ in range(P18_EMB_ROWS)]
    inp["windows"] = np.array(windows)
    workdir.mkdir(parents=True, exist_ok=True)
    ids = tok.encode_batch(windows[:P18_FT_ROWS])
    np.savez(workdir / "ft.npz", input_ids=ids.astype(np.int32),
             label=np.array([int(w.count("G") + w.count("C") > P18_L // 2)
                             for w in windows[:P18_FT_ROWS]]))
    with open(workdir / "emb.tsv", "w") as fh:
        fh.write("sequences\tlabel\n")
        fh.writelines(f"{w}\t{i % 2}\n" for i, w in enumerate(windows))
    np.savez(workdir / "inputs.npz", **inp)
    return inp


def p18_ft_args(workdir: Path, out: Path) -> list:
    """``lora_fine_tune train``: l20 from its HF dir, 2 steps of 8 rows,
    fp32, dropout 0, an evaluation of 16 rows at the end."""
    return ["train", "--train-dir", str(workdir / "ft.npz"), "--valid-dir",
            str(workdir / "ft.npz"), "--model-name", str(workdir / "l20"), "--output-dir",
            str(out), "--max-steps", "2", "--save-steps", "2", "--eval-steps", "2",
            "--train-batch-size", "8", "--grad-accum", "1", "--eval-batch-size", "16",
            "--lora-dropout", "0", "--learning-rate", "1e-3", "--warmup-steps", "1",
            "--no-bf16", "--device", "cuda"]


def p18_predict_args(workdir: Path, adapter: Path, out: Path) -> list:
    return ["predict", "--checkpoint-dir", str(adapter), "--data-dir", str(workdir / "ft.npz"),
            "--batch-size", "8", "--output-file", str(out), "--no-bf16", "--device", "cuda"]


def p18_xgb_args(workdir: Path, out: Path, batch: int) -> list:
    return ["-input", str(workdir / "emb.tsv"), "-model", str(workdir / "l20"), "-classifier",
            str(workdir / "clf.json"), "-output", str(out), "-batchSize", str(batch),
            "-device", "cuda", "-no-progress"]


def p18_emb_batch(mesh) -> int:
    """The runner's global batch: 16 over the ranks, and in one process the
    8 rows of a rank's forward."""
    return P18_EMB_BATCH if mesh is not None else P18_EMB_BATCH // P18_RANKS


def p18_trainer(dev, mesh, dtype):
    """l20 from the seeded weights, its optimizer (keeping each update's
    gradients) and train step, over ``mesh`` or in one process."""
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg, model = par_model("l20", dev)
    opt = KeptGrads(make_optimizer(learning_rate=2e-4, warmup_steps=1, total_steps=P18_STEPS,
                                   params=dict(model.named_parameters())))
    init, step, _ = step_lib.make_train_step(cfg, opt, model, dtype=dtype, remat=True,
                                             device=dev, mesh=mesh)
    return model, opt, step, init()


def p18_weights(model, state):
    """The full fp32 weights on the host (under fsdp gathered: every rank
    calls it)."""
    f = state.fsdp
    weights = f.full(f.masters()) if f else dict(model.named_parameters())
    return {n: w.detach().to("cpu", copy=True) for n, w in weights.items()}


def p18_resume(dev, inp, mesh, ckpt_dir):
    """A new trainer restored from ``ckpt_dir``'s step 2, then step 3: the
    weights after."""
    import torch

    from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib

    model, _, step, state = p18_trainer(dev, mesh, torch.float32)
    state = ckpt_lib.CheckpointManager(ckpt_dir).restore(state, step=2)
    state, _ = step(state, batch_of(inp, f"b{P18_STEPS}_"))
    return p18_weights(model, state)


def p18_train(dev, inp, mesh, ckpt_dir, sync):
    """18a: l20 pre-training from the seeded weights, in one process or
    over ``mesh`` (fsdp 2): 3 fp32 steps (each step's gradients, under
    fsdp gathered from the blocks; grad_norm; the weights after) with a
    checkpoint at step 2, resumed into a new trainer under the same layout
    for step 3; then 1 bf16 step from the seeded weights, timed; what a
    rank holds between steps."""
    import torch

    from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib

    model, opt, step, state = p18_trainer(dev, mesh, torch.float32)
    f, out = state.fsdp, {}
    ckpt = ckpt_lib.CheckpointManager(ckpt_dir, save_interval_steps=2)
    for s in range(1, P18_STEPS + 1):
        state, m = step(state, batch_of(inp, f"b{s}_"))
        out[f"loss{s}"], out[f"grad_norm{s}"] = float(m["loss"]), float(m["grad_norm"])
        ckpt.save(s, state)
    out["grads"] = [{n: g.cpu() for n, g in (f.full({k: v.to(dev) for k, v in gs.items()})
                                             if f else gs).items()} for gs in opt.grads]
    out["weights"] = p18_weights(model, state)
    if f:
        count = lambda tree: sum(t.numel() for t in tree.values())
        out["held"] = dict(module=count(dict(model.named_parameters())),
                           blocks=count(f.shards), mu=count(state.opt_state["mu"]),
                           nu=count(state.opt_state["nu"]),
                           full=sum(math.prod(s) for s in f.shapes.values()))
    del model, opt, state
    out["resumed"] = p18_resume(dev, inp, mesh, ckpt_dir)
    model, _, step, state = p18_trainer(dev, mesh, torch.bfloat16)
    sync()
    t = time.perf_counter()
    state, m = step(state, batch_of(inp, f"b{P18_STEPS + 1}_"))
    sync()
    out["bf16_ms"], out["bf16_loss"] = 1e3 * (time.perf_counter() - t), float(m["loss"])
    return out


def p18_distill(dev, inp, mesh):
    """18b: distillation l20 -> l20-ssd, 2 fp32 steps from seeded weights:
    each step's gradients (under fsdp gathered), the metrics, the student's
    weights after."""
    import torch

    from plantcaduceus_tpu_torch.train.distill import make_distill_step
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    tcfg, teacher = par_model("l20", dev)
    scfg, student = par_model("l20-ssd", dev)
    opt = KeptGrads(make_optimizer(learning_rate=2e-4, warmup_steps=1, total_steps=2,
                                   params=dict(student.named_parameters())))
    init, step = make_distill_step(tcfg, scfg, opt, student, dtype=torch.float32, remat=True,
                                   device=dev, mesh=mesh)
    state, out = init(), {}
    for s in range(2):
        state, m = step(state, teacher, batch_of(inp, f"d{s}_"))
        out.update({f"{k}{s}": float(v) for k, v in m.items()})
    f = state.fsdp
    out["grads"] = [{n: g.cpu() for n, g in (f.full({k: v.to(dev) for k, v in gs.items()})
                                             if f else gs).items()} for gs in opt.grads]
    weights = f.full(f.masters()) if f else dict(student.named_parameters())
    out["weights"] = {n: w.detach().to("cpu", copy=True) for n, w in weights.items()}
    return out


def p18_embed(dev, inp, mesh):
    """18d's library half: the bf16 RC-averaged centre embeddings of the 64
    windows through the runner (rows split over ``mesh``)."""
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer

    cfg, model = par_model("l20", dev)
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=p18_emb_batch(mesh),
                             device=dev, mesh=mesh)
    ids = DnaTokenizer().encode_batch([str(w) for w in inp["windows"]])
    return torch.from_numpy(runner.center_embeddings(ids, P18_L // 2 - 1, progress=False))


def p18_work(dev, inp, workdir, meshes, tag, sync):
    """Phase 18a-d in one process (``meshes`` all None, ``tag`` "one") or on
    one rank: each part's result, launches and seconds."""
    import torch

    from plantcaduceus_tpu_torch.cli import lora_fine_tune, predict_xgboost

    res, cnt, secs = {}, {}, {}
    for part, fn in (
            ("train", lambda: p18_train(dev, inp, meshes["fsdp"], workdir / f"ckpt_{tag}", sync)),
            ("distill", lambda: p18_distill(dev, inp, meshes["fsdp"])),
            ("lora", lambda: (lora_fine_tune.main(p18_ft_args(workdir, workdir / f"ft_{tag}")),
                              lora_fine_tune.main(p18_predict_args(
                                  workdir, workdir / "ft_one" / "final",
                                  workdir / f"pred_{tag}.csv")))),
            ("embed", lambda: (p18_embed(dev, inp, meshes["data"]),
                               predict_xgboost.main(p18_xgb_args(
                                   workdir, workdir / f"xgb_{tag}.tsv",
                                   p18_emb_batch(meshes["data"])))))):
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        reset_counts()
        t = time.perf_counter()
        res[part] = fn()
        sync()
        secs[part] = time.perf_counter() - t
        cnt[part] = counts()
        res[part + "_peak"] = torch.cuda.max_memory_allocated(dev) - base
    res["embed"] = res["embed"][0]
    del res["lora"]
    return res, cnt, secs


def phase18_rank(workdir: Path) -> None:
    """One rank of phase 18 (started by ``torch.distributed.run``): 18a-d
    over fsdp 2 and data 2. Rank 0 writes the results; every rank its
    counts, seconds and peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from plantcaduceus_tpu_torch.parallel import mesh as meshlib

    if not torch.cuda.is_available():
        fail("phase 18 rank: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank_log("imported")
    dev = meshlib.initialize_distributed("cuda", timeout_s=RANK_TIMEOUT_S)
    rank = meshlib.world()[0]
    rank_log("joined the process group")
    meshes = {"fsdp": meshlib.make_mesh(meshlib.MeshConfig(fsdp=P18_RANKS), RANK_TIMEOUT_S),
              "data": meshlib.make_mesh(meshlib.MeshConfig(data=P18_RANKS), RANK_TIMEOUT_S)}
    rank_go()
    inp = dict(np.load(workdir / "inputs.npz"))
    comm = time_collectives()

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    res, cnt, secs = p18_work(dev, inp, workdir, meshes, "ranks", sync)
    rank_log("work done")
    (workdir / f"rank{rank}.json").write_text(json.dumps(
        {"counts": cnt, "secs": secs, "comm_s": comm, "device": str(dev),
         "backend": dist.get_backend(),
         "peak": {k: v for k, v in res.items() if k.endswith("_peak")}}))
    if rank == 0:
        torch.save(res, workdir / "ranks.pt")
    dist.barrier()
    dist.destroy_process_group()


def p18_serve_start(workdir: Path):
    """18e: ``cli.serve -model l20 -seq 2`` (fp32) on 2 ranks of
    ``torch.distributed.run``, on a free port; (process, port, log)."""
    port = free_port()
    logf = open(workdir / "serve.log", "w+b")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(P18_RANKS), "-m", "plantcaduceus_tpu_torch.cli.serve", "-model", "l20", "-seq",
         str(P18_RANKS), "-batchSize", str(P18_SERVE), "-dtype", "float32", "-port", str(port),
         "-device", "cuda"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        stdout=logf, stderr=subprocess.STDOUT, start_new_session=True)
    return proc, port, logf


def p18_serve_check(dev, inp, proc, port, logf):
    """18e: /score and /embed of 4 windows from the 2 ranks against the
    in-process one-rank service (1e-5 of max |value|); SIGTERM to the
    leader, and every rank exits 0 within the timeout. Returns figures."""
    import signal
    import urllib.request

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.server import ScoringService
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    def text():
        logf.seek(0)
        return logf.read().decode(errors="replace")

    seqs = [str(w) for w in inp["windows"][:P18_SERVE]]
    refs = [s[P18_L // 2 - 1] for s in seqs]
    alts = ["ACGT"[("ACGT".index(r) + 1) % 4] for r in refs]
    items = [{"sequence": s, "ref": r, "alt": a} for s, r, a in zip(seqs, refs, alts)]
    base, t = f"http://127.0.0.1:{port}", time.perf_counter()
    while True:
        if proc.poll() is not None:
            fail(f"phase 18e: cli.serve -seq 2 exited {proc.returncode}:\n{text()[-4000:]}")
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5):
                break
        except OSError:
            if time.perf_counter() - t > min(P18_TIMEOUT_S, time_left()):
                fail("phase 18e: cli.serve -seq 2 did not answer /healthz")
            time.sleep(0.5)
    replies = {}
    t = time.perf_counter()
    for path, body, key in (("/score", {"items": items}, "scores"),
                            ("/embed", {"sequences": seqs}, "embeddings")):
        req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            replies[key] = torch.tensor(json.loads(r.read())[key], dtype=torch.float64)
    req_s = time.perf_counter() - t
    model, cfg, tok = load_model_and_tokenizer("l20")
    service = ScoringService(InferenceRunner(model, cfg, dtype=torch.float32,
                                             batch_size=P18_SERVE, device=dev), DnaTokenizer())
    want = {"scores": torch.from_numpy(np.asarray(service.score(seqs, refs, alts), np.float64)),
            "embeddings": torch.from_numpy(np.asarray(service.embed(seqs), np.float64))}
    gaps = {k: rel_gap(replies[k], want[k]) for k in want}
    for k, g in gaps.items():
        if not (math.isfinite(g) and g <= 1e-5):
            fail(f"phase 18e: /{k} of the 2 ranks off by {g:.3e} of max |value| (tol 1e-5)")
    import re

    m = re.search(r"leader of 2 ranks .*pid (\d+)", text())
    if m is None:
        fail(f"phase 18e: no leader pid in the log:\n{text()[-4000:]}")
    t = time.perf_counter()
    os.kill(int(m.group(1)), signal.SIGTERM)
    try:
        rc = proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        stop_ranks(proc)
        rc = "timeout"
    stop_s = time.perf_counter() - t
    if rc != 0 or "released by the leader" not in text():
        fail(f"phase 18e: cli.serve -seq 2 did not stop cleanly ({rc}):\n{text()[-4000:]}")
    return dict(gaps=gaps, request_s=req_s, stop_s=stop_s)


P18_DIR = REPO / "build" / "chip_smoke" / "phase18"


def p18_job() -> "RankJob":
    """18a-d's ranks, started in a fresh ``P18_DIR``; they wait for their
    go (after the one-process runs)."""
    shutil.rmtree(P18_DIR, ignore_errors=True)
    P18_DIR.mkdir(parents=True)
    return RankJob(P18_RANKS, ["--phase18-rank", str(P18_DIR)], P18_DIR, "ranks", P18_TIMEOUT_S)


def phase_fsdp_entry(dev, card, ranks_job=None):
    """Phase 18 (see the module docstring), with 18a-d's ranks
    ``ranks_job`` (:func:`p18_job`; started here if None). Returns (the
    launches of the ranks' main paths by kernel, summed over ranks; the
    figures)."""
    t0 = time.perf_counter()
    log(f"phase 18: FSDP and the data axis on the entry points, {P18_RANKS} ranks of "
        f"torch.distributed.run sharing {card} over gloo, l20 at {P18_L} bp")
    ranks_job = ranks_job or p18_job()
    workdir = P18_DIR
    serve = p18_serve_start(workdir)
    try:
        return p18_checks(dev, workdir, serve, ranks_job, t0)
    finally:   # on a failure too
        ranks_job.stop()
        stop_ranks(serve[0])
        serve[2].close()


def p18_checks(dev, workdir, serve, ranks_job, t0):
    """Phase 18's runs and gates, with 18e's ranks started (``serve``)."""
    import torch

    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    inp = p18_inputs(workdir)
    cfg = CaduceusConfig.preset("l20")
    export_hf_dir(workdir / "l20", init_params(cfg, seed=PAR_SEED), cfg)
    emb = p18_embed(dev, inp, None)
    (workdir / "clf.json").write_text(json.dumps(xgb_classifier(emb.numpy())))
    none = {"fsdp": None, "data": None}
    one, one_cnt, one_secs = p18_work(dev, inp, workdir, none, "one", torch.cuda.synchronize)
    rank_s = ranks_job.wait("phase 18")
    sh = torch.load(workdir / "ranks.pt", weights_only=False)
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(P18_RANKS)]
    total = {k: 0 for k in _counters()}
    # every rank runs one process's forwards and steps, but half the
    # runner's batches (each a batch of one process's shape)
    want = dict(one_cnt, embed={k: v // P18_RANKS for k, v in one_cnt["embed"].items()})
    for r, rr in enumerate(ranks):
        if rr["device"] != "cuda:0" or rr["backend"] != "gloo":
            fail(f"phase 18 rank {r} ran on {rr['device']} over {rr['backend']}")
        if rr["counts"] != want:
            fail(f"phase 18 rank {r} launched {rr['counts']}; expected {want}")
        for c in rr["counts"].values():
            for k, v in c.items():
                total[k] += v
    path = {"train": ("mixer_fwd_res", "scan_bwd"),
            "distill": ("mixer_fwd_x", "mixer2_fwd_res", "ssd_bwd_pre_silu"),
            "lora": ("scan_fwd_hb", "scan_bwd", "mixer_fwd_x"), "embed": ("mixer_fwd_x",)}
    for part, names in path.items():
        if not all(one_cnt[part][k] for k in names):
            fail(f"phase 18 {part}: a kernel of its path did not launch: {one_cnt[part]}")
    figs = {}
    # 18a
    a, b = sh["train"], one["train"]
    wg, wgn = 0.0, ""
    for s, (got, want) in enumerate(zip(a["grads"], b["grads"]), 1):
        w, n = grads_agree(f"phase 18a fsdp 2 fp32 step {s}", got, want)
        if w >= wg:
            wg, wgn = w, f"step {s} {n}"
    gn = max(abs(a[f"grad_norm{s}"] / b[f"grad_norm{s}"] - 1) for s in range(1, P18_STEPS + 1))
    if not gn <= 1e-5:
        fail(f"phase 18a: grad_norm off by {gn:.3e} relative (tol 1e-5)")
    ww, wwn = grads_agree("phase 18a fsdp 2 fp32 weights after 3 steps", a["weights"],
                          b["weights"])
    for run, what in ((a, "under fsdp 2"), (b, "in one process from its own")):
        if not all(torch.equal(run["resumed"][n], run["weights"][n]) for n in run["weights"]):
            fail(f"phase 18a: the step-2 checkpoint resumed {what} did not give step 3's "
                 "weights bit for bit")
    wr, wrn = grads_agree("phase 18a the fsdp-2 checkpoint resumed in one process",
                          p18_resume(dev, inp, None, workdir / "ckpt_ranks"), a["weights"])
    held = a["held"]
    if not (held["module"] == 0 and 2 * held["blocks"] == 2 * held["mu"] == 2 * held["nu"]
            == held["full"]):
        fail(f"phase 18a: a rank holds {held} between steps")
    figs["train"] = dict(grads=(wg, wgn), grad_norm=gn, weights=(ww, wwn), resumed_one=(wr, wrn),
                         bf16_ms=a["bf16_ms"], bf16_ms_one=b["bf16_ms"],
                         losses=[a[f"loss{s}"] for s in range(1, 4)],
                         losses_one=[b[f"loss{s}"] for s in range(1, 4)], held=held,
                         peak=[rr["peak"]["train_peak"] for rr in ranks],
                         peak_one=one["train_peak"])
    f = figs["train"]
    log(f"  18a pretrain --fsdp 2, l20 8 x {P18_L}: fp32 gradients of 3 steps worst {wgn} "
        f"{wg:.3e}, grad_norm {gn:.3e} relative, weights after 3 steps worst {wwn} {ww:.3e} "
        f"(tol {GRAD_TOL:.0e}); the step-2 checkpoint resumed under fsdp 2: step 3 equal bit "
        f"for bit; in one process worst {wrn} {wr:.3e}; a rank holds {held}; bf16 step "
        f"{f['bf16_ms']:.1f} ms on 2 ranks, {f['bf16_ms_one']:.1f} in one process; peak "
        f"bytes above the start a rank {f['peak']}, one process {f['peak_one']}")
    # 18b
    a, b = sh["distill"], one["distill"]
    wg, wgn = 0.0, ""
    for s, (got, want) in enumerate(zip(a["grads"], b["grads"]), 1):
        w, n = grads_agree(f"phase 18b distill fsdp 2 fp32 step {s}", got, want)
        if w >= wg:
            wg, wgn = w, f"step {s} {n}"
    ww, wwn = grads_agree("phase 18b distill fsdp 2 weights after 2 steps", a["weights"],
                          b["weights"])
    lg = max(abs(a[f"loss{s}"] / b[f"loss{s}"] - 1) for s in range(2))
    if not lg <= 1e-5:
        fail(f"phase 18b: losses off by {lg:.3e} relative")
    figs["distill"] = dict(grads=(wg, wgn), weights=(ww, wwn), loss=lg,
                           secs=ranks[0]["secs"]["distill"], secs_one=one_secs["distill"])
    log(f"  18b distill l20 -> l20-ssd --fsdp 2: fp32 gradients of 2 steps worst {wgn} "
        f"{wg:.3e}, weights worst {wwn} {ww:.3e}, losses {lg:.3e} relative; K5-res "
        f"{ranks[0]['counts']['distill']['mixer2_fwd_res']}, K6 "
        f"{ranks[0]['counts']['distill']['ssd_bwd_pre_silu']} a rank")
    # 18c
    load = lambda d: torch.load(d / "final" / "adapter.pt", weights_only=True)
    flat = lambda tree: {f"head.{k}": v for k, v in tree["head"].items()} | {
        f"{n}.{k}": v for n, ab in tree["adapters"].items() for k, v in ab.items()}
    wa, wan = grads_agree("phase 18c lora_fine_tune on 2 data ranks, adapters after 2 steps",
                          flat(load(workdir / "ft_ranks")), flat(load(workdir / "ft_one")))
    if (workdir / "pred_ranks.csv").read_bytes() != (workdir / "pred_one.csv").read_bytes():
        fail("phase 18c: predict on 2 data ranks differs from one process")
    figs["lora"] = dict(adapters=(wa, wan), secs=ranks[0]["secs"]["lora"],
                        secs_one=one_secs["lora"])
    log(f"  18c lora_fine_tune on 2 data ranks (8 x {P18_L}, fp32, dropout 0, 2 steps): "
        f"adapters worst {wan} {wa:.3e} (tol {GRAD_TOL:.0e}); predict byte-equal to one "
        f"process")
    # 18d
    if not torch.equal(sh["embed"], one["embed"]):
        fail("phase 18d: the embeddings on 2 data ranks differ from one process's")
    if (workdir / "xgb_ranks.tsv").read_bytes() != (workdir / "xgb_one.tsv").read_bytes():
        fail("phase 18d: predict_xgboost on 2 data ranks differs from one process")
    figs["embed"] = dict(secs=ranks[0]["secs"]["embed"], secs_one=one_secs["embed"])
    log(f"  18d predict_xgboost on 2 data ranks ({P18_EMB_ROWS} windows, batch "
        f"{P18_EMB_BATCH} over the ranks, {P18_EMB_BATCH // P18_RANKS} in one process, bf16): "
        "embeddings and predictions equal bit for bit")
    # 18e
    t = time.perf_counter()
    figs["serve"] = p18_serve_check(dev, inp, *serve)
    s = figs["serve"]
    log(f"  18e serve -seq 2: /score {s['gaps']['scores']:.3e}, /embed "
        f"{s['gaps']['embeddings']:.3e} of max |value| from the one-rank service (tol 1e-5); "
        f"both requests {s['request_s']:.2f} s; SIGTERM to the leader: every rank exited 0 in "
        f"{s['stop_s']:.1f} s")
    figs["secs"] = dict(one=one_secs, ranks=ranks[0]["secs"], rank_run=rank_s,
                        serve=time.perf_counter() - t)
    figs["comm_s"] = [rr["comm_s"] for rr in ranks]
    figs["seconds"] = time.perf_counter() - t0
    log(f"phase 18 ok in {figs['seconds']:.1f} s (one process {sum(one_secs.values()):.1f} s, "
        f"the ranks {rank_s:.1f} s: {ranks[0]['secs']}); seconds in the collectives a rank "
        f"{figs['comm_s']}; launches on the ranks {dict((k, v) for k, v in total.items() if v)}")
    return total, figs


# ---------------------------------------------------------------------------
# Phase 19: tensor and pipeline parallelism for pre-training
# (parallel/mesh.py's tensor and pipe axes, parallel/collectives.py's
# tensor-parallel sums, the mixers' tp paths, parallel/pipeline.py and
# train/step.ModelShards), l20 and l20-ssd at full width and depth on 2
# ranks of torch.distributed.run sharing cuda:0 over gloo, each against
# one process on the card with the same weights and batches: first K1-hb,
# K3, K4-fentry and K6 (plain mode) against their plain versions at the
# tensor-parallel shapes (a rank's d_inner 384; l20-ssd's 3 heads a rank),
# then 19a tensor 2 for l20 (K1-hb, K3) and l20-ssd (K4-fentry, K6 plain)
# and 19b pipe 2 with 4 microbatches for l20 (K2-res, K3 on a stage's 10
# layers): 3 fp32 steps (each step's gradients and grad_norm, the weights
# after; a checkpoint at step 2 resumed in one process for step 3) and 2
# bf16 steps (the second timed).
P19_RANKS, P19_L, P19_ROWS, P19_STEPS, P19_BF16_STEPS, P19_MICRO = 2, 512, 8, 3, 2, 4
P19_JOBS = {"tensor_l20": ("l20", dict(tensor=2)), "tensor_l20-ssd": ("l20-ssd", dict(tensor=2)),
            "pipe_l20": ("l20", dict(pipe=2))}
P19_TIMEOUT_S = 150
P19_SEED = 19
# Each fp32 step's gradients against one process, of each leaf's max: 1e-5
# for l20; for l20-ssd 1e-4, since float32's reassociation through 20
# layers of the Mamba-2 backward alone moves dt_bias's and A_log's
# gradients (sums over every position, with cancellation) by 1.5-2.1e-5 of
# their max (sharded against unsharded with the same decomposed mixer, the
# plain versions in one process on the CPU: 1.7e-5; the two one-process
# paths against each other: 2.6e-6).
P19_GRAD_TOL = {"l20": 1e-5, "l20-ssd": 1e-4}
P19_RESUME_TOL = 1e-4


def p19_inputs(workdir: Path) -> dict:
    """l20 pre-training batches of 8 x 512 from a seed: steps 1-3 fp32,
    4-5 bf16."""
    import numpy as np

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.train import data as data_lib

    seqs = data_lib.sequence_source("synthetic", window=P19_L, synthetic_n=64, seed=P19_SEED)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), P19_ROWS, seed=P19_SEED)
    inp = {}
    for s in range(1, P19_STEPS + P19_BF16_STEPS + 1):
        inp.update({f"b{s}_{k}": v for k, v in ds.batch_at(s).items()})
    workdir.mkdir(parents=True, exist_ok=True)
    np.savez(workdir / "inputs.npz", **inp)
    return inp


def p19_trainer(preset, dev, mesh, dtype, micro=None):
    """``preset`` from the phase's seed, its optimizer (keeping each
    update's gradients) and train step, over ``mesh`` or in one process."""
    from plantcaduceus_tpu_torch.train import step as step_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg, model = par_model(preset, dev)
    opt = KeptGrads(make_optimizer(learning_rate=2e-4, warmup_steps=1, total_steps=P19_STEPS,
                                   params=dict(model.named_parameters())))
    init, step, _ = step_lib.make_train_step(cfg, opt, model, dtype=dtype, remat=True,
                                             device=dev, mesh=mesh, pp_microbatches=micro)
    return model, opt, step, init()


def p19_full(model, state, tree=None):
    """``tree`` (default: the weights the optimizer updates) as full tensors
    on the host (under a layout gathered: every rank calls it)."""
    lay = state.layout
    if tree is None:
        tree = lay.masters() if lay is not None else dict(model.named_parameters())
    tree = lay.full(tree) if lay is not None else tree
    return {n: t.detach().to("cpu", copy=True) for n, t in tree.items()}


def p19_train(preset, dev, inp, mesh, ckpt_dir, sync, micro=None):
    """3 fp32 steps from the seeded weights (each step's loss, grad_norm
    and full gradients; a checkpoint at step 2; the full weights after),
    then 2 bf16 steps from the seeded weights (the second timed), with the
    launches of each dtype's steps."""
    import torch

    from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib

    out, cnt = {}, {}
    reset_counts()
    model, opt, step, state = p19_trainer(preset, dev, mesh, torch.float32, micro)
    ckpt = ckpt_lib.CheckpointManager(ckpt_dir, save_interval_steps=2)
    for s in range(1, P19_STEPS + 1):
        state, m = step(state, batch_of(inp, f"b{s}_"))
        out[f"loss{s}"], out[f"grad_norm{s}"] = float(m["loss"]), float(m["grad_norm"])
        ckpt.save(s, state)
    cnt["float32"] = counts()
    out["grads"] = [p19_full(model, state, g) for g in opt.grads]
    out["weights"] = p19_full(model, state)
    del model, opt, state
    reset_counts()
    model, _, step, state = p19_trainer(preset, dev, mesh, torch.bfloat16, micro)
    for s in range(P19_STEPS + 1, P19_STEPS + P19_BF16_STEPS + 1):
        sync()
        t = time.perf_counter()
        state, m = step(state, batch_of(inp, f"b{s}_"))
        sync()
        out["bf16_ms"], out[f"bf16_loss{s}"] = 1e3 * (time.perf_counter() - t), float(m["loss"])
    cnt["bfloat16"] = counts()
    out["counts"] = cnt
    return out


def p19_resume(preset, dev, inp, ckpt_dir):
    """One process restored from ``ckpt_dir``'s step 2 (written under any
    layout), then step 3: the weights after."""
    import torch

    from plantcaduceus_tpu_torch.train import checkpoint as ckpt_lib

    model, _, step, state = p19_trainer(preset, dev, None, torch.float32)
    state = ckpt_lib.CheckpointManager(ckpt_dir).restore(state, step=2)
    state, _ = step(state, batch_of(inp, f"b{P19_STEPS}_"))
    return p19_full(model, state)


def phase19_rank(workdir: Path) -> None:
    """One rank of phase 19 (started by ``torch.distributed.run``): the
    three jobs. Rank 0 writes the results; every rank its counts, seconds
    and peak memory."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from plantcaduceus_tpu_torch.parallel import mesh as meshlib

    if not torch.cuda.is_available():
        fail("phase 19 rank: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank_log("imported")
    dev = meshlib.initialize_distributed("cuda", timeout_s=RANK_TIMEOUT_S)
    rank = meshlib.world()[0]
    rank_log("joined the process group")
    meshes = {job: meshlib.make_mesh(meshlib.MeshConfig(**axes), RANK_TIMEOUT_S)
              for job, (_, axes) in P19_JOBS.items()}
    rank_go()
    inp = dict(np.load(workdir / "inputs.npz"))
    comm = time_collectives()

    def sync():
        torch.cuda.synchronize(dev)
        dist.barrier()

    res, secs, peak = {}, {}, {}
    for job, (preset, axes) in P19_JOBS.items():
        mesh = meshes[job]
        sync()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t = time.perf_counter()
        res[job] = p19_train(preset, dev, inp, mesh, workdir / f"ckpt_{job}", sync,
                             P19_MICRO if "pipe" in axes else None)
        secs[job], peak[job] = time.perf_counter() - t, torch.cuda.max_memory_allocated(dev)
        rank_log(f"{job} done")
    (workdir / f"rank{rank}.json").write_text(json.dumps(
        {"counts": {j: r.pop("counts") for j, r in res.items()}, "secs": secs, "peak": peak,
         "comm_s": comm, "device": str(dev), "backend": dist.get_backend()}))
    if rank == 0:
        torch.save(res, workdir / "ranks.pt")
    dist.barrier()
    dist.destroy_process_group()


def p19_expected(job):
    """The launches of each dtype's steps on every rank: tensor 2 runs the
    decomposed mixers on a rank's d_inner (K1-hb twice a layer and
    direction, the forward and remat's recompute, K3 once; Mamba-2 K4-fentry
    and K6 plain alike); pipe 2 runs K2-res and K3 on a stage's 10 layers at
    every one of the schedule's n_micro + 1 steps (the bubble on masked
    zeros)."""
    steps = {"float32": P19_STEPS, "bfloat16": P19_BF16_STEPS}
    per = {"tensor_l20": dict(scan_fwd_hb=2 * 2 * 20, scan_bwd=2 * 20),
           "tensor_l20-ssd": dict(ssd_fwd_fentry=2 * 2 * 20, ssd_bwd=2 * 20),
           "pipe_l20": dict(mixer_fwd_res=(P19_MICRO + 1) * 2 * 2 * 10,
                            scan_bwd=(P19_MICRO + 1) * 2 * 10)}[job]
    return {dn: only(**{k: v * n for k, v in per.items()}) for dn, n in steps.items()}


def p19_kernel_check(dev):
    """K1-hb and K3 (fused dt, both directions) at a tensor rank's l20
    shape (16 rows x 512 x 384, R 24), and K4-fentry and K6 in plain mode
    at a tensor rank's l20-ssd heads (16 rows x 512, 3 heads of 128),
    against their plain versions, fp32 and bf16. Returns the worst error by
    kernel."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_scan, cuda_ssd
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    cfg = CaduceusConfig.preset("l20")
    rows, L, D, N, R = 2 * P19_ROWS, P19_L, cfg.d_inner // 2, cfg.d_state, cfg.dt_rank
    w = layer_weights(cfg, P19_SEED, dev)
    A = -torch.exp(w["A_log"])[:, :D].contiguous()
    loc = lambda t: t[:, :D].contiguous()
    Ds, dtb, W = loc(w["D"]), loc(w["dt_proj_b"]), w["dt_proj_w"][:, :, :D].contiguous()
    gen = torch.Generator(device=dev).manual_seed(P19_SEED)
    r = lambda *shape, sc=1.0: torch.randn(*shape, generator=gen, device=dev) * sc
    err = dict.fromkeys(("scan_fwd_hb", "scan_bwd", "ssd_fwd_fentry", "ssd_bwd"), 0.0)
    scfg = CaduceusConfig.preset("l20-ssd")
    H, P = scfg.n_heads // 2, scfg.head_dim
    sw = layer_weights(scfg, P19_SEED, dev)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        x, gy = r(rows, L, D).to(dtype), r(rows, L, D).to(dtype)
        dt = r(rows, L, R, sc=0.5).to(dtype)
        Bm, Cm = r(rows, L, N).to(dtype), r(rows, L, N).to(dtype)
        for g in (0, 1):
            args = (x, dt, A[g], Bm, Cm, Ds[g], dtb[g], W[g], g == 1)
            tag = f"{dn} {'rev' if g else 'fwd'}"
            y, hb = cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK)
            y_p, hb_p = cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK)
            err["scan_fwd_hb"] = max(err["scan_fwd_hb"],
                                     compare(f"K1-hb y at D {D} {tag}", y, y_p, dn),
                                     compare(f"K1-hb hb at D {D} {tag}", hb, hb_p, dn, F32_TOL))
            kargs = (x, gy, dt, A[g], Bm, Cm, Ds[g], dtb[g], hb, W[g], g == 1)
            for n, got, want in zip(("dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD", "dW"),
                                    cuda_scan.scan_bwd(*kargs), cuda_scan.scan_bwd_plain(*kargs)):
                err["scan_bwd"] = max(err["scan_bwd"],
                                      compare(f"K3 {n} at D {D} {tag}", got, want, dn, F32_TOL))
            xs, sdt = r(rows, L, H * P).to(dtype), r(rows, L, H, sc=0.5).to(dtype)
            SB, SC = (r(rows, L, 1, scfg.d_state, sc=0.5).to(dtype) for _ in range(2))
            sargs = (xs, sdt, -torch.exp(sw["A_log"][g, :H]).contiguous(), SB, SC,
                     sw["D"][g, :H].contiguous(), sw["dt_bias"][g, :H].contiguous())
            T = scfg.chunk_size
            yk, fe = cuda_ssd.ssd_dir(*sargs, T, g == 1, emit_fentry=True)
            yp, fep = cuda_ssd.ssd_dir_plain(*sargs, T, g == 1, emit_fentry=True)
            # phase 3d's tolerance for the SSD kernels: TOL[dn] for every
            # output, the float32 ones too (bf16-rounded product operands)
            err["ssd_fwd_fentry"] = max(err["ssd_fwd_fentry"],
                                        compare(f"K4-fentry y at H {H} {tag}", yk, yp, dn),
                                        compare(f"K4-fentry fentry at H {H} {tag}", fe, fep, dn))
            gs = r(rows, L, H * P).to(dtype)
            for n, got, want in zip(("dx", "dB", "dC", "ddt", "dmass"),
                                    cuda_ssd.ssd_dir_bwd(*sargs, fe, gs, T, g == 1),
                                    cuda_ssd.ssd_dir_bwd_plain(*sargs, fe, gs, T, g == 1)):
                err["ssd_bwd"] = max(err["ssd_bwd"],
                                     compare(f"K6 {n} at H {H} {tag}", got, want, dn))
    return err


P19_DIR = REPO / "build" / "chip_smoke" / "phase19"


def p19_job() -> "RankJob":
    """Phase 19's ranks, started in a fresh ``P19_DIR``; they wait for their
    go (after the one-process runs)."""
    shutil.rmtree(P19_DIR, ignore_errors=True)
    P19_DIR.mkdir(parents=True)
    return RankJob(P19_RANKS, ["--phase19-rank", str(P19_DIR)], P19_DIR, "ranks", P19_TIMEOUT_S)


def phase_tensor_pipe(dev, card, ranks_job=None):
    """Phase 19 (see above), with its ranks ``ranks_job`` (:func:`p19_job`;
    started here if None). Returns (the launches of the ranks' main paths
    by kernel, summed over ranks; the figures)."""
    t0 = time.perf_counter()
    log(f"phase 19: tensor and pipeline parallelism, {P19_RANKS} ranks of torch.distributed.run "
        f"sharing {card} over gloo, l20 and l20-ssd at full width and depth, "
        f"{P19_ROWS} x {P19_L} bp")
    ranks_job = ranks_job or p19_job()
    try:
        return p19_checks(dev, P19_DIR, ranks_job, t0)
    finally:   # on a failure too
        ranks_job.stop()


def p19_checks(dev, workdir, ranks_job, t0):
    """Phase 19's kernel checks, one-process runs, rank job (``ranks_job``,
    started) and gates."""
    import torch

    kerr = p19_kernel_check(dev)
    t_k = time.perf_counter() - t0
    inp = p19_inputs(workdir)
    one, one_secs = {}, {}
    for preset in ("l20", "l20-ssd"):   # one process, the same card, weights and batches
        t = time.perf_counter()
        one[preset] = p19_train(preset, dev, inp, None, workdir / f"ckpt_one_{preset}",
                                torch.cuda.synchronize)
        one_secs[preset] = time.perf_counter() - t
        torch.cuda.empty_cache()
    rank_s = ranks_job.wait("phase 19")
    sh = torch.load(workdir / "ranks.pt", weights_only=False)
    ranks = [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(P19_RANKS)]
    total = {k: 0 for k in _counters()}
    for r, rr in enumerate(ranks):
        if rr["device"] != "cuda:0" or rr["backend"] != "gloo":
            fail(f"phase 19 rank {r} ran on {rr['device']} over {rr['backend']}")
        for job, c in rr["counts"].items():
            if c != p19_expected(job):
                fail(f"phase 19 {job} rank {r} launched {c}; expected {p19_expected(job)}")
            for part in c.values():
                for k, v in part.items():
                    total[k] += v
    figs = {"kernels_err": kerr, "kernels_s": t_k}
    for job, (preset, axes) in P19_JOBS.items():
        a, b = sh[job], one[preset]
        wg, wgn = 0.0, ""
        for s, (got, want) in enumerate(zip(a["grads"], b["grads"]), 1):
            w, n = grads_agree(f"phase 19 {job} fp32 step {s}", got, want, P19_GRAD_TOL[preset])
            if w >= wg:
                wg, wgn = w, f"step {s} {n}"
        gn = max(abs(a[f"grad_norm{s}"] / b[f"grad_norm{s}"] - 1) for s in range(1, P19_STEPS + 1))
        if not gn <= 1e-5:
            fail(f"phase 19 {job}: grad_norm off by {gn:.3e} relative (tol 1e-5)")
        ww, wwn = grads_agree(f"phase 19 {job} fp32 weights after {P19_STEPS} steps",
                              a["weights"], b["weights"])
        wr, wrn = grads_agree(f"phase 19 {job}: its step-2 checkpoint resumed in one process",
                              p19_resume(preset, dev, inp, workdir / f"ckpt_{job}"),
                              a["weights"], P19_RESUME_TOL)
        f = figs[job] = dict(grads=(wg, wgn), grad_norm=gn, weights=(ww, wwn), resumed=(wr, wrn),
                             bf16_ms=a["bf16_ms"], bf16_ms_one=b["bf16_ms"],
                             losses=[a[f"loss{s}"] for s in range(1, P19_STEPS + 1)],
                             losses_one=[b[f"loss{s}"] for s in range(1, P19_STEPS + 1)],
                             secs=ranks[0]["secs"][job], peak=[rr["peak"][job] for rr in ranks])
        log(f"  19{'a' if 'tensor' in job else 'b'} {job} ({axes}): fp32 gradients of "
            f"{P19_STEPS} steps worst {wgn} {wg:.3e} (tol {P19_GRAD_TOL[preset]:.0e}), grad_norm "
            f"{gn:.3e} relative, weights after {P19_STEPS} steps worst {wwn} {ww:.3e} (tol "
            f"{GRAD_TOL:.0e}); the step-2 checkpoint resumed in one process worst {wrn} "
            f"{wr:.3e} (tol {P19_RESUME_TOL:.0e}); bf16 step {f['bf16_ms']:.1f} ms on 2 ranks, "
            f"{f['bf16_ms_one']:.1f} in one process; fp32 losses {f['losses']} / "
            f"{f['losses_one']}; {f['secs']:.1f} s on the ranks; peak bytes a rank {f['peak']}")
    figs["secs"] = dict(kernels=t_k, one=one_secs, ranks=rank_s)
    figs["comm_s"] = [rr["comm_s"] for rr in ranks]
    figs["seconds"] = time.perf_counter() - t0
    log(f"phase 19 ok in {figs['seconds']:.1f} s (kernel checks {t_k:.1f} s, one process "
        f"{sum(one_secs.values()):.1f} s, the ranks {rank_s:.1f} s); seconds in the "
        f"collectives a rank {figs['comm_s']}; launches on the ranks "
        f"{dict((k, v) for k, v in total.items() if v)}")
    return total, figs


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (REPO / "plantcaduceus_tpu_torch" / "csrc").is_dir():
        fail(f"plantcaduceus_tpu_torch not found beside {Path(__file__).name}: "
             "run from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    if sys.argv[1:2] == ["--phase17-rank"]:  # one rank of phase 17, not a run of the script
        phase17_rank(sys.argv[2], Path(sys.argv[3]))
        return
    if sys.argv[1:2] == ["--phase18-rank"]:  # one rank of phase 18
        phase18_rank(Path(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--phase19-rank"]:  # one rank of phase 19
        phase19_rank(Path(sys.argv[2]))
        return
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _clock["deadline"] = t0 + DEADLINE_S
    card = phase_card()
    run_phase("2", phase_build)
    dev = torch.device("cuda")
    cfg = CaduceusConfig.preset("l20")
    kres = run_phase("3", phase_kernels, cfg, dev)
    tres = run_phase("3b", phase_train_kernels, cfg, dev)
    check_parent_digests()
    sres, k4_launches = run_phase("3c", phase_ssd_kernels, dev)
    s2res = run_phase("3d", phase_ssd_train_kernels, dev)
    run_phase("4", phase_forward, cfg, dev)
    run_phase("4b", phase_forward2, dev)
    k1_launches = run_phase("5", phase_general, dev)
    gc5 = run_phase("5b", phase_gated, cfg, dev)
    k2_launches, wps, wps_e2e, tsv, n_valid = run_phase("6", phase_cli, cfg, dev)
    k5_launches, wps2, wps2_e2e = run_phase("6b", phase_cli2, dev, tsv, n_valid)
    run_phase("7", phase_profile, cfg, dev)
    run_phase("7b", phase_profile2, dev)
    hb_launches = run_phase("8", phase_grads, dev)
    fentry_launches, k6_launches = run_phase("8b", phase_grads2, dev)
    tc, tps, step_s, peak = run_phase("9", phase_pretrain, "l20", dev, tsv, n_valid)
    tc2, tps2, step_s2, peak2 = run_phase("9b", phase_pretrain, "l20-ssd", dev, tsv, n_valid)
    run_phase("10", phase_train_profile, "l20", dev)
    run_phase("10b", phase_train_profile, "l20-ssd", dev)
    # the attention baseline last, so the earlier phases run as before it
    torch.cuda.empty_cache()
    ares = run_phase("3e", phase_attn_kernels, dev)
    bwps, k7_fwd_launches = run_phase("4c", phase_bert_forward, dev)
    run_phase("8c", phase_bert_grads, dev)
    btc, btps, bstep_s, bpeak = run_phase("9c", phase_bert_train, dev)
    run_phase("10c", phase_bert_profile, dev)
    # the AR Mamba LM and the PlantCAD2 evaluation after every earlier phase
    torch.cuda.empty_cache()
    ar1, ar1_fig = run_phase("11", phase_ar_lm, "mamba1", dev)
    ar2, ar2_fig = run_phase("11b", phase_ar_lm, "mamba2", dev)
    torch.cuda.empty_cache()
    ek2, ek5, ev = run_phase("12", phase_eval, dev)
    # phase 13: the XGBoost workload, the server and the input tools, with l20
    torch.cuda.empty_cache()
    check_clock("13")
    t13 = time.perf_counter()
    xk2, xg = phase_xgboost(cfg, dev)
    sk2, sv = phase_serve(cfg, dev, tsv, wps)
    tk2 = phase_tools(cfg, dev, tsv.parent / "genome.fa", tsv.parent / "in.vcf")
    log(f"phase 13 ok in {time.perf_counter() - t13:.1f} s: embeddings {xg['ewps']:.1f} "
        f"windows/s; server {sv['wps']:.1f} windows/s, {sv['rps']:.2f} requests/s (in-process "
        f"{wps:.1f}); {sv['forwards']} forwards for {SERVE_CLIENTS} concurrent requests of "
        f"{SERVE_WINDOWS} windows")
    # phases 14 to 18 log their own seconds
    # phase 14: LoRA and full fine-tuning, after every earlier phase
    torch.cuda.empty_cache()
    check_clock("14")
    fc, k600, ff = phase_finetune(dev)
    # phase 15: the rest of training, after every earlier phase
    torch.cuda.empty_cache()
    check_clock("15")
    rc, rf = phase_rest_of_training(dev, tsv, n_valid, ev)
    # phase 16: the formats users have, after every earlier phase
    torch.cuda.empty_cache()
    check_clock("16")
    gc16, gf = phase_formats(dev, tsv, n_valid)
    # phases 17-19: several ranks, after every earlier phase; phases 18 and
    # 19's ranks start during phase 17 and wait there for their go
    later = {}
    try:
        torch.cuda.empty_cache()
        check_clock("17")
        pc17, k3g, pf = phase_parallel(dev, card, lambda: later.update(p18=p18_job(),
                                                                       p19=p19_job()))
        # phase 18: FSDP and the data axis on the entry points
        torch.cuda.empty_cache()
        check_clock("18")
        pc18, qf = phase_fsdp_entry(dev, card, later["p18"])
        # phase 19: tensor and pipeline parallelism
        torch.cuda.empty_cache()
        check_clock("19")
        pc19, tf = phase_tensor_pipe(dev, card, later["p19"])
    finally:   # on a failure too
        for job in later.values():
            job.stop()
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s on {card}; scoring l20 "
        f"{wps:.1f} windows/s steady state, {wps_e2e:.1f} windows/s end to end; l20-ssd "
        f"{wps2:.1f} / {wps2_e2e:.1f} windows/s; training l20 {tps:.1f} tokens/s, "
        f"{step_s * 1e3:.2f} ms per step, peak {peak} bytes; l20-ssd {tps2:.1f} tokens/s, "
        f"{step_s2 * 1e3:.2f} ms per step, peak {peak2} bytes; BERT-Base forward {bwps:.1f} "
        f"windows/s, training {btps:.1f} tokens/s, {bstep_s * 1e3:.2f} ms per step, peak "
        f"{bpeak} bytes; AR LM mamba1 {ar1_fig['tps']:.1f} / mamba2 {ar2_fig['tps']:.1f} "
        f"training tokens/s, decode {ar1_fig['decode_tps']:.1f} / {ar2_fig['decode_tps']:.1f} "
        f"tokens/s at batch 1; zero_shot_eval pc2-small {ev['wps']:.2f} windows/s at "
        f"{EVAL_L} bp; LoRA l20 {ff['step_ms']:.2f} ms per step ({ff['wps']:.2f} windows/s), "
        f"pc2-small x {PC2_L} bp {ff['pc2']['step_ms']:.2f} ms per step "
        f"({ff['pc2']['wps']:.2f} windows/s); streaming l20 {rf['streaming']['step_ms']:.2f} "
        f"ms per step; distillation l20 -> l20-ssd {rf['distill']['step_ms']:.2f} ms per step; "
        f"zstd on the host {gf['streaming']['zstd_mbs']:.2f} MB/s; phase 17 (ranks sharing "
        f"the card) pc2-small seq 4 {pf['pc2-small']['wps']:.2f} windows/s, data 2 x seq 2 "
        f"step {pf['pc2-small']['step_ms']:.1f} ms; phase 18 l20 --fsdp 2 bf16 step "
        f"{qf['train']['bf16_ms']:.1f} ms (one process {qf['train']['bf16_ms_one']:.1f}); "
        f"phase 19 bf16 step l20 --tensor 2 {tf['tensor_l20']['bf16_ms']:.1f} ms, l20-ssd "
        f"--tensor 2 {tf['tensor_l20-ssd']['bf16_ms']:.1f} ms, l20 --pipe 2 "
        f"{tf['pipe_l20']['bf16_ms']:.1f} ms (one process {tf['pipe_l20']['bf16_ms_one']:.1f})")

    src = "plantcaduceus_tpu_torch/csrc/"
    meta = {
        "mixer_fwd": dict(source=src + "mixer_fwd.cu",
                          replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                          launches=ek2 + fc["mixer_fwd"] + rc["mixer_fwd"] + gc16["mixer_fwd"]
                          + pc17["mixer_fwd"] + pc18["mixer_fwd"]),
        "mixer_fwd_x": dict(source=src + "mixer_fwd.cu",
                            replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                            launches=k2_launches + xk2 + sk2 + tk2 + fc["mixer_fwd_x"]
                            + rc["mixer_fwd_x"] + gc16["mixer_fwd_x"] + pc17["mixer_fwd_x"]
                            + pc18["mixer_fwd_x"]),
        "scan_fwd_combine": dict(source=src + "scan_fwd.cu",
                                 replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                                 launches=gc5["scan_fwd_combine"]),
        "mixer_fwd_res": dict(source=src + "mixer_fwd.cu",
                              replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                              launches=tc["mixer_fwd_res"] + fc["mixer_fwd_res"]
                              + rc["mixer_fwd_res"] + gc16["mixer_fwd_res"]
                              + pc17["mixer_fwd_res"] + pc18["mixer_fwd_res"]
                              + pc19["mixer_fwd_res"]),
        "scan_fwd": dict(source=src + "scan_fwd.cu",
                         replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                         launches=k1_launches + gc5["scan_fwd"] + ar1["scan_fwd"]
                         + pc17["scan_fwd"]),
        "scan_fwd_hb": dict(source=src + "scan_fwd.cu",
                            replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                            launches=hb_launches + gc5["scan_fwd_hb"] + ar1["scan_fwd_hb"]
                            + fc["scan_fwd_hb"]
                            + gc16["scan_fwd_hb"] + pc17["scan_fwd_hb"]
                            + pc18["scan_fwd_hb"] + pc19["scan_fwd_hb"]),
        "scan_bwd": dict(source=src + "scan_bwd.cu",
                         replaces="plantcaduceus_tpu/ops/pallas_scan.py:310",
                         launches=tc["scan_bwd"] + gc5["scan_bwd"] + ar1["scan_bwd"]
                         + fc["scan_bwd"]
                         + rc["scan_bwd"] + gc16["scan_bwd"] + pc17["scan_bwd"]
                         + pc18["scan_bwd"] + pc19["scan_bwd"]),
        "ssd_fwd": dict(source=src + "ssd_fwd.cu",
                        replaces="plantcaduceus_tpu/ops/pallas_ssd.py:164",
                        launches=k4_launches + ar2["ssd_fwd"] + pc17["ssd_fwd"]),
        "mixer2_fwd": dict(source=src + "mixer2_fwd.cu",
                           replaces="plantcaduceus_tpu/ops/pallas_mixer2.py:72",
                           launches=k5_launches + ek5 + fc["mixer2_fwd"]),
        "ssd_fwd_fentry": dict(source=src + "ssd_fwd.cu",
                               replaces="plantcaduceus_tpu/ops/pallas_ssd.py:164",
                               launches=fentry_launches + ar2["ssd_fwd_fentry"]
                               + pc17["ssd_fwd_fentry"] + pc19["ssd_fwd_fentry"]),
        "mixer2_fwd_res": dict(source=src + "mixer2_fwd.cu",
                               replaces="plantcaduceus_tpu/ops/pallas_mixer2.py:72",
                               launches=tc2["mixer2_fwd_res"] + fc["mixer2_fwd_res"]
                               + rc["mixer2_fwd_res"] + pc18["mixer2_fwd_res"]),
        "ssd_bwd": dict(source=src + "ssd_bwd.cu",
                        replaces="plantcaduceus_tpu/ops/pallas_ssd.py:290",
                        launches=k6_launches + ar2["ssd_bwd"] + pc17["ssd_bwd"]
                        + pc19["ssd_bwd"]),
        "ssd_bwd_pre_silu": dict(source=src + "ssd_bwd.cu",
                                 replaces="plantcaduceus_tpu/ops/pallas_ssd.py:290",
                                 launches=tc2["ssd_bwd_pre_silu"] + fc["ssd_bwd_pre_silu"]
                                 + rc["ssd_bwd_pre_silu"] + pc18["ssd_bwd_pre_silu"]),
    }
    kernels = []
    for name in ("mixer_fwd", "mixer_fwd_x", "scan_fwd", "scan_fwd_combine"):
        r = kres[name]
        b, by, _ = r["bound"]
        extra = {}
        if "float32" in r:  # the new variants' fp32 times beside their bf16 ones
            f = r["float32"]
            extra["float32"] = dict(ms=f["ms"], plain_ms=f["plain_ms"], bound_ms=f["bound"][0],
                                    bound_by=f["bound"][1])
        if "decomposed_ms" in r:  # K2 fuse_in's yardstick: matmul, then K2 with xi given
            extra["decomposed_ms"] = r["decomposed_ms"]
            extra["float32"]["decomposed_ms"] = r["float32"]["decomposed_ms"]
        if "dt_given" in r:  # K1 with dt given at full width, beside the fused mode
            g = r["dt_given"]
            extra["dt_given"] = dict(ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound"][0],
                                     bound_by=g["bound"][1])
        err = r["err"]
        if name == "mixer_fwd":  # K2 at pc2-small's 8192-bp shape, beside l20's
            extra["pc2_small"] = dict(ev["k2"], rows=2 * EVAL_BATCH, L=EVAL_L)
            err = max(err, ev["k2"]["err"])
        kernels.append(dict(name=name, route="cuda", **meta[name], max_abs_err=err,
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
                            library_ms=None, **extra))
    # The training variants and K3: the bf16 numbers (the trainer's dtype)
    # in the contract's keys, the fp32 ones beside them.
    for name, r in [(n, tres[n]) for n in ("mixer_fwd_res", "scan_fwd_hb", "scan_bwd")] + \
            [(n, sres[n]) for n in ("mixer2_fwd", "ssd_fwd")] + list(s2res.items()):
        b, by, _ = r["bound"]["bfloat16"]
        b32, by32, _ = r["bound"]["float32"]
        kernels.append(dict(name=name, route="cuda", **meta[name], max_abs_err=r["err"],
                            ms=r["ms"]["bfloat16"], plain_ms=r["plain_ms"]["bfloat16"],
                            bound_ms=b, bound_by=by, library_ms=None,
                            float32=dict(ms=r["ms"]["float32"],
                                         plain_ms=r["plain_ms"]["float32"],
                                         bound_ms=b32, bound_by=by32),
                            **({"split_ms": r["split_ms"]} if "split_ms" in r else {}),
                            **({"pc2_small_ssd": r["pc2_small_ssd"]}
                               if "pc2_small_ssd" in r else {})))
    # K7 and K8: bf16 ALiBi in the contract's keys (K7 at the forward shape,
    # 128 x 512; K8 at the training shape, 32 x 512), fp32 beside; launches
    # from phase 9c's 30 training steps.
    for name, replaces, also in (("attn_fwd", ":63", {}), ("attn_bwd", ":103",
                                                         {"also_replaces": ":135"})):
        r = ares[name]
        b, by, _ = r["bound"]["bfloat16"]
        b32, by32, _ = r["bound"]["float32"]
        extra = {}
        if name == "attn_fwd":
            t = ares["attn_fwd_train"]
            extra = dict(forward_launches=k7_fwd_launches, l8192=r["l8192"], training_shape={
                dn: dict(ms=t["ms"][dn], plain_ms=t["plain_ms"][dn],
                         library_ms=t["library_ms"][dn], bound_ms=t["bound"][dn][0])
                for dn in t["ms"]})
        kernels.append(dict(
            name=name, route="cuda", source=src + f"{name}.cu",
            replaces="plantcaduceus_tpu/ops/pallas_attention.py" + replaces,
            launches=btc[name], ms=r["ms"]["bfloat16"],
            max_abs_err=max(r["err"], ares["attn_fwd_train"]["err"] if name == "attn_fwd" else 0),
            plain_ms=r["plain_ms"]["bfloat16"], bound_ms=b, bound_by=by,
            library_ms=r["library_ms"]["bfloat16"],
            float32=dict(ms=r["ms"]["float32"], plain_ms=r["plain_ms"]["float32"],
                         library_ms=r["library_ms"]["float32"], bound_ms=b32, bound_by=by32),
            **({"split_ms": r["split_ms"]} if "split_ms" in r else {}),
            **{k: "plantcaduceus_tpu/ops/pallas_attention.py" + v for k, v in also.items()},
            **extra))
    # K7 and K8 above hd 128 (128-wide slices): bf16 at hd 256, 4 x 512, H 4
    # in the contract's keys, fp32 beside; launches from phase 3e's BERT at
    # heads of 256.
    wide, wide_c = ares["wide"]
    for name, replaces, counter in (("attn_fwd_hd256", ":63", "attn_fwd_wide"),
                                    ("attn_bwd_hd256", ":103", "attn_bwd_wide")):
        r = wide[name]
        b, by, _ = r["bound"]["bfloat16"]
        b32, by32, _ = r["bound"]["float32"]
        kernels.append(dict(
            name=name, route="cuda", source=src + name[:8] + ".cu",
            replaces="plantcaduceus_tpu/ops/pallas_attention.py" + replaces,
            launches=wide_c[counter], max_abs_err=r["err"], ms=r["ms"]["bfloat16"],
            plain_ms=r["plain_ms"]["bfloat16"], bound_ms=b, bound_by=by,
            library_ms=r["library_ms"]["bfloat16"],
            float32=dict(ms=r["ms"]["float32"], plain_ms=r["plain_ms"]["float32"],
                         library_ms=r["library_ms"]["float32"], bound_ms=b32, bound_by=by32),
            shape=dict(zip(("B", "L", "H"), ATTN_WIDE_SHAPE), hd=256)))
    # K3 with g0 / emit_dh0 (the context-parallel backward): bf16 at the seq
    # path's local shape in the contract's keys, fp32 beside; launches from
    # phase 17's ranks.
    kernels.append(dict(
        name="scan_bwd_g0", route="cuda", source=src + "scan_bwd.cu",
        replaces="plantcaduceus_tpu/ops/pallas_scan.py:310", launches=pc17["scan_bwd_g0"],
        max_abs_err=k3g["err"], ms=k3g["bfloat16"]["ms"], plain_ms=k3g["bfloat16"]["plain_ms"],
        bound_ms=k3g["bfloat16"]["bound_ms"], bound_by=k3g["bfloat16"]["bound_by"],
        library_ms=None, without_options_ms=k3g["bfloat16"]["no_options_ms"],
        rows=2 * PAR_WINDOWS, L=PAR_L // 4, D=1536, R=48,
        float32={k: k3g["float32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                  "no_options_ms")}))
    # Phases 14 to 19: their launches beside each total; K1-hb and
    # K3 at pc2-small x 600 bp; phase 19's kernel checks at the tensor
    # ranks' shapes.
    for k in kernels:
        if fc.get(k["name"]):
            k["phase14_launches"] = fc[k["name"]]
        if rc.get(k["name"]):
            k["phase15_launches"] = rc[k["name"]]
        if gc16.get(k["name"]):
            k["phase16_launches"] = gc16[k["name"]]
        if pc17.get(k["name"]):
            k["phase17_launches"] = pc17[k["name"]]
        if pc18.get(k["name"]):
            k["phase18_launches"] = pc18[k["name"]]
        if pc19.get(k["name"]):
            k["phase19_launches"] = pc19[k["name"]]
        if k["name"] in tf["kernels_err"]:
            k["max_abs_err"] = max(k["max_abs_err"], tf["kernels_err"][k["name"]])
        if k["name"] in k600:
            r = k600[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], r["err"])
            k["pc2_small_600"] = {n: r[n] for n in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "rows", "L", "D", "R")}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
