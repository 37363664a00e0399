#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (plantcaduceus_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``plantcaduceus_tpu_torch/csrc`` and drives the
port's main path, zero-shot scoring with the l20 model, on the card:

1. the card: name, power limit, count;
2. build the kernels (one nvcc per source, in parallel);
3. each kernel against its plain PyTorch version at the main path's shapes
   (l20: 256 rows x 512 x 768, N=16, R=24), both directions, fp32 and bf16,
   with its time on the card, the plain version's time and its bound;
4. the full l20 forward (batch 128 windows of 512 bp, seeded weights) with
   the kernels against the plain path in fp32; K2 launches = 2 * n_layer;
5. a small untied and a unidirectional config through the general mixer
   path, which launches K1 (dt projected in the kernel, and outside);
6. the CLI on a seeded synthetic TSV (in-process, counted and timed, then
   ``-outBED`` through ``python -m``) and on a seeded FASTA + VCF
   (``python -m``); row counts and finite scores; windows/s;
7. device time by kernel over one l20 scoring batch (torch.profiler).

Inputs and outputs of phase 6 go to ``build/chip_smoke/`` in the checkout.

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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, got, want, dtype_name):
    """Max abs and max relative (to max |want|) error; fail past tolerance."""
    d = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rel = d / scale if scale else d
    tol = TOL[dtype_name]
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


def reset_counts():
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    cuda_mixer.mixer_fwd.launches = 0
    cuda_scan.scan_fwd.launches = 0


def counts():
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    return {"mixer_fwd": cuda_mixer.mixer_fwd.launches,
            "scan_fwd": cuda_scan.scan_fwd.launches}


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
    if c["mixer_fwd"] != 2 * cfg.n_layer or c["scan_fwd"] != 0:
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
        if c != {"mixer_fwd": 0, "scan_fwd": per_layer * cfg.n_layer}:
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
    if c != {"mixer_fwd": 2 * cfg.n_layer * n_batches, "scan_fwd": 0}:
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
    return c["mixer_fwd"], wps, n_valid / secs


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
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4} {e.key[:90]}")


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
    phase_forward(cfg, dev)
    k1_launches = phase_general(dev)
    k2_launches, wps, wps_e2e = phase_cli(cfg, dev)
    phase_profile(cfg, dev)
    log(f"all phases ok in {time.perf_counter() - t0:.1f} s on {card}; "
        f"{wps:.1f} windows/s steady state, {wps_e2e:.1f} windows/s end to end")

    meta = {
        "mixer_fwd": dict(route="cuda", source="plantcaduceus_tpu_torch/csrc/mixer_fwd.cu",
                          replaces="plantcaduceus_tpu/ops/pallas_mixer.py:49",
                          launches=k2_launches),
        "scan_fwd": dict(route="cuda", source="plantcaduceus_tpu_torch/csrc/scan_fwd.cu",
                         replaces="plantcaduceus_tpu/ops/pallas_scan.py:76",
                         launches=k1_launches),
    }
    kernels = []
    for name in ("mixer_fwd", "scan_fwd"):
        r = kres[name]
        b, by, _ = r["bound"]
        kernels.append(dict(name=name, **meta[name], max_abs_err=r["err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=b, bound_by=by,
                            library_ms=None))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
