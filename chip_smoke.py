#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plantcaduceus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``plantcaduceus_tpu_torch/csrc`` and drives the
port's two paths on the card, zero-shot scoring and masked-LM pre-training
with the l20 model:

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
10. device time by kernel over one l20 training step (torch.profiler).

Inputs and outputs of phases 6 and 9 go to ``build/chip_smoke/`` in the
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


def bound_ms(nbytes, flops, sfu_ops):
    t = {"bytes": nbytes / HBM_BYTES_S, "flops": flops / FP32_FLOP_S,
         "sfu": sfu_ops / SFU_OPS_S}
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

    def cmp(kernel, name, got, want, tol):
        res[kernel]["err"] = max(res[kernel]["err"], compare(name, got, want, None, tol))

    def timed(kernel, dn, fn, plain, nbytes, flops, sfu):
        res[kernel]["ms"][dn] = time_ms(fn, 10)
        res[kernel]["plain_ms"][dn] = time_ms(plain, 1, warmup=1)
        res[kernel]["bound"][dn] = bound_ms(nbytes, flops, sfu)

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
                # Each input read once, each output written once; per state
                # the one exp2 of its decay and ~18 fp32 flops (recompute
                # 3, adjoint 13, the dB/dC sums over channels 2); per
                # (step, channel) softplus + sigmoid (3 SFU) and the dt
                # projection, its transpose and dW (6R flops).
                timed("scan_bwd", dn, lambda: cuda_scan.scan_bwd(*kargs),
                      lambda: cuda_scan.scan_bwd_plain(*kargs),
                      2 * s * pts + 4 * pts + 8 * rows * L * J + hb_bytes
                      + 8 * (D * N + 2 * D + R * D),
                      pts * (18 * N + 6 * R + 12), pts * (N + 3))

    for name, r in res.items():
        for dn in r["ms"]:
            b, by, parts = r["bound"][dn]
            log(f"  {name} ({dn}, one direction): {r['ms'][dn]:.3f} ms; plain "
                f"{r['plain_ms'][dn]:.1f} ms; bound {b:.3f} ms by {by} (bytes "
                f"{parts['bytes'] * 1e3:.3f}, fp32 flops {parts['flops'] * 1e3:.3f}, "
                f"sfu {parts['sfu'] * 1e3:.3f} ms)")
    return res


def reset_counts():
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    cuda_mixer.mixer_fwd.launches = 0
    cuda_mixer.mixer_fwd.res_launches = 0
    cuda_scan.scan_fwd.launches = 0
    cuda_scan.scan_fwd.hb_launches = 0
    cuda_scan.scan_bwd.launches = 0


def counts():
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    return {"mixer_fwd": cuda_mixer.mixer_fwd.launches,
            "mixer_fwd_res": cuda_mixer.mixer_fwd.res_launches,
            "scan_fwd": cuda_scan.scan_fwd.launches,
            "scan_fwd_hb": cuda_scan.scan_fwd.hb_launches,
            "scan_bwd": cuda_scan.scan_bwd.launches}


def only(**nonzero):
    """The counts dict with these entries and every other one 0."""
    return {k: nonzero.get(k, 0) for k in ("mixer_fwd", "mixer_fwd_res", "scan_fwd",
                                            "scan_fwd_hb", "scan_bwd")}


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
    """Device time by kernel and the device's busy share of ``wall`` ms."""
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
    log(f"  wall {wall:.2f} ms; device busy {busy:.2f} ms ({100 * busy / wall:.1f}% of wall)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


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
        worst, worst_name = 0.0, ""
        for n, gp in grads[False].items():
            gk = grads[True][n]
            scale = gp.abs().max().item()
            err = (gk - gp).abs().max().item()
            rel = err / scale if scale else err
            if not (math.isfinite(err) and rel <= GRAD_TOL):
                fail(f"phase 8 {name}: gradient of {n} off by {rel:.3e} of its max "
                     f"(tol {GRAD_TOL:.0e})")
            if rel >= worst:
                worst, worst_name = rel, n
        log(f"  {name}: {len(grads[False])} parameter gradients, worst {worst_name} at "
            f"{worst:.3e} of its max |grad| (tol {GRAD_TOL:.0e}); launches {launched}")
    return hb_launches


TRAIN_ARGS = ["--dataset", "synthetic", "--preset", "l20", "--batch-size", "32",
              "--window", "512", "--dtype", "bfloat16", "--max-steps", "30",
              "--warmup-steps", "5", "--lr", "1e-3", "--save-steps", "15", "--log-steps", "1"]


def phase_pretrain(cfg, dev, tsv, n_valid):
    """The pre-training CLI on the card (l20, full width and depth, batch 32
    x 512 bp, bf16, remat): loss, launches, throughput, memory; an exact
    resume from step 15 through ``python -m``; scoring with the export."""
    import logging

    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.cli import pretrain
    from plantcaduceus_tpu_torch.engine import zero_shot

    log("phase 9: pre-training CLI, l20 (20 layers, d_model 384), batch 32 x 512 bp, "
        "bf16, remat, 30 steps")
    tmp = REPO / "build" / "chip_smoke"
    run_a, run_b = tmp / "pretrain", tmp / "pretrain_resumed"
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
    pretrain.main(TRAIN_ARGS + ["--output-dir", str(run_a)])
    wall = time.perf_counter() - t
    c = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    loop_log.removeHandler(handler)

    nl, bs, L = cfg.n_layer, 32, 512
    losses = [s[1] for s in steps]
    log(f"  {len(steps)} steps in {wall:.1f} s (kernel build, model init, final eval and "
        f"export included); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if [s[0] for s in steps] != list(range(1, 31)) or not all(map(math.isfinite, losses)):
        fail(f"phase 9: bad step log {steps}")
    if not losses[-1] < losses[0]:
        fail(f"phase 9: loss did not fall ({losses[0]} -> {losses[-1]})")
    # Per step: K2-res twice per direction and layer (the forward, and the
    # recompute of every block in the backward under remat), K3 once per
    # direction and layer. The final eval runs the inference K2.
    want = only(mixer_fwd=c["mixer_fwd"], mixer_fwd_res=30 * 2 * 2 * nl, scan_bwd=30 * 2 * nl)
    if c != want or not (c["mixer_fwd"] > 0 and c["mixer_fwd"] % (2 * nl) == 0):
        fail(f"phase 9 launched {c}; expected {want} with mixer_fwd a positive "
             f"multiple of {2 * nl}")
    log(f"  launches {c}: per step K2-res {4 * nl} (2 directions x {nl} layers x forward + "
        f"remat recompute), K3 {2 * nl}; mixer_fwd = final eval, inference kernel")
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
                          *TRAIN_ARGS, "--output-dir", str(run_b)], cwd=REPO, env=env,
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

    out = tmp / "scores_trained.tsv"
    run_cli(["-input-table", str(tsv), "-model", str(run_a / "final"), "-output", str(out)])
    scores = np.array([float(r["zeroShotScore"]) for r in zero_shot.read_table(out).rows])
    if len(scores) != n_valid or not np.isfinite(scores).all():
        fail("scoring with the trained export: wrong row count or non-finite scores")
    log(f"  python -m ...zero_shot_score -model {run_a.name}/final: {len(scores)} rows scored")
    return c, tps, step_s, peak


def phase_train_profile(cfg, dev):
    """Device time by kernel over one l20 training step (bf16, batch 32 x
    512 bp, remat), and the device's busy share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
    from plantcaduceus_tpu_torch.train.step import make_train_step, to_device

    log("phase 10: profile one l20 training step (bf16, batch 32 x 512 bp, remat)")
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
    phase_forward(cfg, dev)
    k1_launches = phase_general(dev)
    k2_launches, wps, wps_e2e, tsv, n_valid = phase_cli(cfg, dev)
    phase_profile(cfg, dev)
    hb_launches = phase_grads(dev)
    tc, tps, step_s, peak = phase_pretrain(cfg, dev, tsv, n_valid)
    phase_train_profile(cfg, dev)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s on {card}; scoring "
        f"{wps:.1f} windows/s steady state, {wps_e2e:.1f} windows/s end to end; training "
        f"{tps:.1f} tokens/s, {step_s * 1e3:.2f} ms per step, peak {peak} bytes")

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
    for name in ("mixer_fwd_res", "scan_fwd_hb", "scan_bwd"):
        r = tres[name]
        b, by, _ = r["bound"]["bfloat16"]
        b32, by32, _ = r["bound"]["float32"]
        kernels.append(dict(name=name, route="cuda", **meta[name], max_abs_err=r["err"],
                            ms=r["ms"]["bfloat16"], plain_ms=r["plain_ms"]["bfloat16"],
                            bound_ms=b, bound_by=by, library_ms=None,
                            float32=dict(ms=r["ms"]["float32"],
                                         plain_ms=r["plain_ms"]["float32"],
                                         bound_ms=b32, bound_by=by32)))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
