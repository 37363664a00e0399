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
   version's time and its bound: K1 and K2 at the scoring shape (l20: 256
   rows x 512 x 768, N=16, R=24); then (3b) K1's hb variant, K2's residual
   variant and K3 (fused and full-width dt) at the training shape (64 rows);
4. the full l20 forward (batch 128 windows of 512 bp, seeded weights) with
   the kernels against the plain path in fp32; K2 launches = 2 * n_layer;
5. a small untied and a unidirectional config through the general mixer
   path, which launches K1 (dt projected in the kernel, and outside);
6. the CLI on a seeded synthetic TSV (in-process, counted and timed, then
   ``-outBED`` through ``python -m``) and on a seeded FASTA + VCF
   (``python -m``); row counts and finite scores; windows/s;
7. device time by kernel over one l20 scoring batch (torch.profiler);
8. one fp32 training step's gradients with the kernels against the plain
   path (autograd through the plain versions), l20 width, 2 layers, for the
   tied+add config (K2-res, K3), an untied one (K1-hb, K3 fused dt) and a
   unidirectional one (K1-hb, K3 full-width dt);
9. the pre-training CLI: l20 at full width and depth, batch 32 x 512 bp,
   bf16, remat, 30 steps (in-process, counted and timed); a second run
   through ``python -m`` resumes from the step-15 checkpoint and must reach
   the same step-30 weights bit for bit; the exported ``final/`` scores
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
9b. phase 9 with ``--preset l20-ssd``: 30 steps, launch counts, the exact
    resume from step 15, the export scored;
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
    through both wrappers, fp32 and bf16, against the plain versions; one
    bf16 timing row at L 8192 (one window);
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

Inputs and outputs of phases 6, 9 and 9b go to ``build/chip_smoke/`` in the
checkout.

Every failure exits non-zero; no phase's failure is caught. Without CUDA it
exits 1 and prints no result. The last two lines of standard output are the
``{"kernels": [...]}`` record and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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
    log(f"  built {sorted(p.name for p in paths.values())} in {time.perf_counter() - t:.1f} s")
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
    J = R + 2 * N
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
            if dtype == torch.bfloat16 and g == 1:
                res["mixer_fwd"]["ms"] = time_ms(
                    lambda: cuda_mixer.mixer_fwd(*args, reverse=True), 10)
                res["mixer_fwd"]["plain_ms"] = time_ms(
                    lambda: cuda_mixer.mixer_fwd_plain(*args, reverse=True), 2, warmup=1)
                s = xi.element_size()
                nbytes = 2 * rows * L * D * s + 4 * (D * (K + 1 + J + N + 2) + R * D)
                pts = rows * L * D
                flops = pts * (2 * K + 2 * J + 2 * R + 6 * N + 10)
                sfu = pts * (N + 3)  # exp2 per state; silu exp; softplus exp+log1p
                res["mixer_fwd"]["bound"] = bound_ms(nbytes, flops, sfu)

        x = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        Bm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
        Cm = torch.randn((rows, L, N), generator=gen, device=dev).to(dtype)
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
                if dtype == torch.bfloat16 and fuse and rev:
                    res["scan_fwd"]["ms"] = time_ms(
                        lambda: cuda_scan.scan_fwd(*args, reverse=True), 10)
                    res["scan_fwd"]["plain_ms"] = time_ms(
                        lambda: cuda_scan.scan_fwd_plain(*args, reverse=True), 2, warmup=1)
                    s = x.element_size()
                    nbytes = s * rows * L * (2 * D + R + 2 * N) + 4 * (D * (N + 2) + R * D)
                    pts = rows * L * D
                    res["scan_fwd"]["bound"] = bound_ms(
                        nbytes, pts * (2 * R + 6 * N + 10), pts * (N + 2))
    for name, r in res.items():
        b, by, parts = r["bound"]
        log(f"  {name} (bf16, one direction): {r['ms']:.3f} ms; plain {r['plain_ms']:.1f} ms; "
            f"bound {b:.3f} ms by {by} (bytes {parts['bytes'] * 1e3:.3f}, fp32 flops "
            f"{parts['flops'] * 1e3:.3f}, sfu {parts['sfu'] * 1e3:.3f} ms)")
    return res


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
    res["scan_bwd"]["split_ms"] = {}

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
                          s * rows * L * (2 * D + R + 2 * N) + hb_bytes
                          + 4 * (D * (N + 2) + R * D),
                          pts * (2 * R + 6 * N + 10), pts * (N + 2))

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
    res = {k: {"err": 0.0, "ms": {}, "plain_ms": {}, "bound": {}}
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
            res[name]["plain_ms"][dn] = time_ms(lambda: plain(args, True), 2, warmup=1)
            res[name]["bound"][dn] = work_bound(
                ssd_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize, mixer=mixer), dn)
    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, one direction): {r['ms'][dn]:.3f} ms; plain "
                f"{r['plain_ms'][dn]:.1f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, sfu "
                f"{parts['sfu'] * 1e3:.3f}, bf16 tensor cores {parts['tc'] * 1e3:.3f} ms)")

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
    for k in ("ssd_bwd", "ssd_bwd_pre_silu"):
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
            "scan_fwd": (cuda_scan.scan_fwd, "launches"),
            "scan_fwd_hb": (cuda_scan.scan_fwd, "hb_launches"),
            "scan_bwd": (cuda_scan.scan_bwd, "launches"),
            "ssd_fwd": (cuda_ssd.ssd_dir, "launches"),
            "ssd_fwd_fentry": (cuda_ssd.ssd_dir, "fentry_launches"),
            "mixer2_fwd": (cuda_mixer2.mamba2_mixer_interior, "launches"),
            "mixer2_fwd_res": (cuda_mixer2.mamba2_mixer_interior, "res_launches"),
            "ssd_bwd": (cuda_ssd.ssd_dir_bwd, "launches"),
            "ssd_bwd_pre_silu": (cuda_ssd.ssd_dir_bwd, "pre_silu_launches"),
            "attn_fwd": (cuda_attention.flash_fwd, "launches"),
            "attn_bwd": (cuda_attention.flash_bwd, "launches")}


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
    if c != only(mixer_fwd=2 * cfg.n_layer):
        fail(f"l20 forward launched {c}; expected mixer_fwd={2 * cfg.n_layer}, scan_fwd=0")
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


def run_cli(args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.zero_shot_score",
                          *args, "-no-progress"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    if res.returncode != 0:
        fail(f"CLI {args} exited {res.returncode}:\n{res.stderr[-4000:]}")
    return res.stderr


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
    if c != only(mixer_fwd=2 * cfg.n_layer * n_batches):
        fail(f"TSV scoring launched {c}; expected mixer_fwd={2 * cfg.n_layer * n_batches}")

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

    bed = tmp / "scores.bed"
    run_cli(["-input-table", str(tsv), "-model", "l20", "-output", str(bed), "-outBED"])
    bed_rows = [ln.split("\t") for ln in bed.read_text().splitlines()]
    if len(bed_rows) != n_valid or any(int(r[2]) - int(r[1]) != 1 for r in bed_rows):
        fail("BED output: wrong rows or intervals")
    log(f"  python -m ... -outBED: {len(bed_rows)} BED rows")

    out_vcf = tmp / "out.vcf"
    run_cli(["-input-vcf", str(vcf), "-input-fasta", str(fa), "-model", "l20",
             "-output", str(out_vcf)])
    recs = [ln.split("\t") for ln in out_vcf.read_text().splitlines()
            if not ln.startswith("#")]
    vals = [v for r in recs for v in r[7].split("plantCAD_zero_shot=")[1].split(",")]
    finite = all(math.isfinite(float(v)) for v in vals if v != ".")
    log(f"  python -m ... -input-vcf: {len(recs)} records annotated ({n_snv} with an SNV "
        f"alt), {sum(v == '.' for v in vals)} non-SNV alts as '.'")
    if len(recs) != n_snv or not finite:
        fail("VCF scoring: wrong record count or non-finite scores")
    return c["mixer_fwd"], wps, n_valid / secs, tsv, n_valid


def phase_profile(cfg, dev):
    """Device time by kernel over one l20 scoring batch (bf16, 128 x 512 bp),
    and the device's busy share of that window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params

    log("phase 7: profile one l20 bf16 batch (torch.profiler)")
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


def grads_agree(what, got, want):
    """Every parameter's gradient through the kernels within GRAD_TOL of its
    max |gradient| through the plain path; returns (worst, its name)."""
    worst, worst_name = 0.0, ""
    for n, gp in want.items():
        scale = gp.abs().max().item()
        err = (got[n] - gp).abs().max().item()
        rel = err / scale if scale else err
        if not (math.isfinite(err) and rel <= GRAD_TOL):
            fail(f"{what}: gradient of {n} off by {rel:.3e} of its max (tol {GRAD_TOL:.0e})")
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


TRAIN_ARGS = ["--dataset", "synthetic", "--batch-size", "32", "--window", "512",
              "--dtype", "bfloat16", "--max-steps", "30", "--warmup-steps", "5", "--lr", "1e-3",
              "--save-steps", "15", "--log-steps", "1"]
# Per preset: the phase, and the kernels a training run launches: the
# inference variant (the final eval), the residual variant (forward and
# remat recompute) and the adjoint.
TRAIN_KERNELS = {"l20": ("9", "mixer_fwd", "mixer_fwd_res", "scan_bwd"),
                 "l20-ssd": ("9b", "mixer2_fwd", "mixer2_fwd_res", "ssd_bwd_pre_silu")}


def phase_pretrain(preset, dev, tsv, n_valid):
    """The pre-training CLI on the card (``preset`` at full width and depth,
    batch 32 x 512 bp, bf16, remat): loss, launches, throughput, memory; an
    exact resume from step 15 through ``python -m``; scoring with the
    export."""
    import logging

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig.preset(preset)
    phase, k_inf, k_res, k_bwd = TRAIN_KERNELS[preset]
    args = TRAIN_ARGS + ["--preset", preset]
    log(f"phase {phase}: pre-training CLI, {preset} ({cfg.n_layer} layers, d_model "
        f"{cfg.d_model}), batch 32 x 512 bp, bf16, remat, 30 steps")
    tmp = REPO / "build" / "chip_smoke"
    run_a, run_b = tmp / f"pretrain_{preset}", tmp / f"pretrain_{preset}_resumed"
    for d in (run_a, run_b):
        shutil.rmtree(d, ignore_errors=True)
    steps = []  # (step, loss, host time once the step's metrics reached the host)

    class StepLog(logging.Handler):
        def emit(self, record):
            if isinstance(record.msg, str) and record.msg.startswith("step "):
                steps.append((record.args[0], float(record.args[2]), time.perf_counter()))

    handler = StepLog()
    loop_log = logging.getLogger("plantcaduceus_tpu_torch.train.loop")
    loop_log.addHandler(handler)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    t = time.perf_counter()
    pretrain.main(args + ["--output-dir", str(run_a)])
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    loop_log.removeHandler(handler)

    nl, bs, L = cfg.n_layer, 32, 512
    losses = [s[1] for s in steps]
    log(f"  {len(steps)} steps in {wall:.1f} s (kernel build, model init, final eval and "
        f"export included); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if [s[0] for s in steps] != list(range(1, 31)) or not all(map(math.isfinite, losses)):
        fail(f"phase {phase}: bad step log {steps}")
    if not losses[-1] < losses[0]:
        fail(f"phase {phase}: loss did not fall ({losses[0]} -> {losses[-1]})")
    # Per step: the residual variant twice per direction and layer (the
    # forward, and the recompute of every block in the backward under
    # remat), the adjoint once per direction and layer. The final eval runs
    # the inference variant.
    want = only(**{k_inf: c[k_inf], k_res: 30 * 2 * 2 * nl, k_bwd: 30 * 2 * nl})
    if c != want or not (c[k_inf] > 0 and c[k_inf] % (2 * nl) == 0):
        fail(f"phase {phase} launched {c}; expected {want} with {k_inf} a positive "
             f"multiple of {2 * nl}")
    log(f"  launches {dict((k, v) for k, v in c.items() if v)}: per step {k_res} {4 * nl} (2 "
        f"directions x {nl} layers x forward + remat recompute), {k_bwd} {2 * nl}; {k_inf} = "
        f"final eval, inference kernel")
    times = {s[0]: s[2] for s in steps}
    # Steps 11..30, without step 16: its interval holds the step-15 checkpoint write.
    deltas = [times[k] - times[k - 1] for k in range(11, 31) if k != 16]
    step_s = sum(deltas) / len(deltas)
    with_save = (times[30] - times[10]) / 20
    tps = bs * L / step_s
    log(f"  steady (steps 10-30 without the checkpoint step): {step_s * 1e3:.2f} ms per step, "
        f"{tps:.1f} tokens/s ({bs / step_s:.2f} windows/s); with the checkpoint write: "
        f"{with_save * 1e3:.2f} ms per step; peak memory allocated {peak} bytes "
        f"({peak / 2**30:.2f} GiB)")

    run_b.mkdir(parents=True)
    shutil.copytree(run_a / "15", run_b / "15")
    shutil.copy(run_a / "config.json", run_b / "config.json")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-m", "plantcaduceus_tpu_torch.cli.pretrain",
                          *args, "--output-dir", str(run_b)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        fail(f"resumed pre-training exited {res.returncode}:\n{res.stderr[-4000:]}")
    if "Resumed from step 15" not in res.stderr:
        fail(f"the second run did not resume from step 15:\n{res.stderr[-4000:]}")
    a = torch.load(run_a / "final" / "pytorch_model.bin", weights_only=True)
    b = torch.load(run_b / "final" / "pytorch_model.bin", weights_only=True)
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        fail("the run resumed at step 15 reached other step-30 weights")
    log(f"  python -m ... resumed at step 15: step-30 weights equal bit for bit "
        f"({len(a)} tensors)")

    out = tmp / f"scores_trained_{preset}.tsv"
    run_cli(["-input-table", str(tsv), "-model", str(run_a / "final"), "-output", str(out)])
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (REPO / "plantcaduceus_tpu_torch" / "csrc").is_dir():
        fail(f"plantcaduceus_tpu_torch not found beside {Path(__file__).name}: "
             "run from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = phase_card()
    phase_build()
    dev = torch.device("cuda")
    cfg = CaduceusConfig.preset("l20")
    kres = phase_kernels(cfg, dev)
    tres = phase_train_kernels(cfg, dev)
    sres, k4_launches = phase_ssd_kernels(dev)
    s2res = phase_ssd_train_kernels(dev)
    phase_forward(cfg, dev)
    phase_forward2(dev)
    k1_launches = phase_general(dev)
    k2_launches, wps, wps_e2e, tsv, n_valid = phase_cli(cfg, dev)
    k5_launches, wps2, wps2_e2e = phase_cli2(dev, tsv, n_valid)
    phase_profile(cfg, dev)
    phase_profile2(dev)
    hb_launches = phase_grads(dev)
    fentry_launches, k6_launches = phase_grads2(dev)
    tc, tps, step_s, peak = phase_pretrain("l20", dev, tsv, n_valid)
    tc2, tps2, step_s2, peak2 = phase_pretrain("l20-ssd", dev, tsv, n_valid)
    phase_train_profile("l20", dev)
    phase_train_profile("l20-ssd", dev)
    # the attention baseline last, so the earlier phases run as before it
    torch.cuda.empty_cache()
    ares = phase_attn_kernels(dev)
    bwps, k7_fwd_launches = phase_bert_forward(dev)
    phase_bert_grads(dev)
    btc, btps, bstep_s, bpeak = phase_bert_train(dev)
    phase_bert_profile(dev)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s on {card}; scoring l20 "
        f"{wps:.1f} windows/s steady state, {wps_e2e:.1f} windows/s end to end; l20-ssd "
        f"{wps2:.1f} / {wps2_e2e:.1f} windows/s; training l20 {tps:.1f} tokens/s, "
        f"{step_s * 1e3:.2f} ms per step, peak {peak} bytes; l20-ssd {tps2:.1f} tokens/s, "
        f"{step_s2 * 1e3:.2f} ms per step, peak {peak2} bytes; BERT-Base forward {bwps:.1f} "
        f"windows/s, training {btps:.1f} tokens/s, {bstep_s * 1e3:.2f} ms per step, peak "
        f"{bpeak} bytes")

    src = "plantcaduceus_tpu_torch/csrc/"
    meta = {
        "mixer_fwd": dict(source=src + "mixer_fwd.cu",
                          replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                          launches=k2_launches),
        "mixer_fwd_res": dict(source=src + "mixer_fwd.cu",
                              replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                              launches=tc["mixer_fwd_res"]),
        "scan_fwd": dict(source=src + "scan_fwd.cu",
                         replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                         launches=k1_launches),
        "scan_fwd_hb": dict(source=src + "scan_fwd.cu",
                            replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                            launches=hb_launches),
        "scan_bwd": dict(source=src + "scan_bwd.cu",
                         replaces="plantcaduceus_tpu/ops/pallas_scan.py:310",
                         launches=tc["scan_bwd"]),
        "ssd_fwd": dict(source=src + "ssd_fwd.cu",
                        replaces="plantcaduceus_tpu/ops/pallas_ssd.py:164",
                        launches=k4_launches),
        "mixer2_fwd": dict(source=src + "mixer2_fwd.cu",
                           replaces="plantcaduceus_tpu/ops/pallas_mixer2.py:72",
                           launches=k5_launches),
        "ssd_fwd_fentry": dict(source=src + "ssd_fwd.cu",
                               replaces="plantcaduceus_tpu/ops/pallas_ssd.py:164",
                               launches=fentry_launches),
        "mixer2_fwd_res": dict(source=src + "mixer2_fwd.cu",
                               replaces="plantcaduceus_tpu/ops/pallas_mixer2.py:72",
                               launches=tc2["mixer2_fwd_res"]),
        "ssd_bwd": dict(source=src + "ssd_bwd.cu",
                        replaces="plantcaduceus_tpu/ops/pallas_ssd.py:290",
                        launches=k6_launches),
        "ssd_bwd_pre_silu": dict(source=src + "ssd_bwd.cu",
                                 replaces="plantcaduceus_tpu/ops/pallas_ssd.py:290",
                                 launches=tc2["ssd_bwd_pre_silu"]),
    }
    kernels = []
    for name in ("mixer_fwd", "scan_fwd"):
        r = kres[name]
        b, by, _ = r["bound"]
        kernels.append(dict(name=name, route="cuda", **meta[name], max_abs_err=r["err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
                            library_ms=None))
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
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
