#!/usr/bin/env python3
"""K6 and K3 on the card, split by kernel, and the two Mamba training steps'
profiles, for one checkout.

    python3 tools/scan_bench.py [--repo DIR] [--label NAME] [--skip-steps]

Imports ``plantcaduceus_tpu_torch`` from DIR (default: the checkout this
script sits in), builds its ``ssd_bwd`` and ``scan_bwd`` sources and
measures, on one CUDA card (CUDA events over 10 launches after 2 warm-up;
the split by kernel from torch.profiler over 10 calls):

* K6 (``ssd_dir_bwd``), plain and ``pre_silu`` mode, both directions, bf16
  and fp32, at ``chip_smoke.py`` phase 3d's shape (64 rows x 512, H 6,
  P = N = chunk = 128, NG 1), each beside its bound (``ssd_train_work``);
* K3 (``scan_bwd``), fused dt, both directions, bf16 and fp32, at phase
  3b's shape (64 rows x 512 x 768, N 16, R 24, hb chunk 16) on K2-res's
  residuals, beside its bound (``scan_bwd_work``);
* the l20 and l20-ssd training steps (bf16, batch 32 x 512, remat, as
  phases 9/10 and 9b/10b): the mean step over 8 steps after 3 warm ones,
  and one profiled step's wall, device busy time, busy share and its five
  longest idle gaps, with the host calls issued during each;
* ``nvcc -Xptxas -v`` of the two sources: registers, shared memory and
  spills per kernel instantiation.

Run it for two checkouts in one call (parent, change, change, parent) to
compare them on one card. Prints the card's name and power limit, then one
JSON line per run. The helpers (timing, inputs, bounds) are those of
``chip_smoke.py`` in this script's checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def ptxas_summary(report: str):
    """Per kernel entry of an ``nvcc -Xptxas -v`` report: registers, shared
    memory bytes, stack and spill bytes."""
    out, cur = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = dict(entry=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", ln)
            cur["smem"] = int(s.group(1)) if s else 0
    return out


def ptxas_reports(cuda_build, names):
    """``nvcc -Xptxas -v`` of each source, compiled apart into a temporary
    directory (the build may have been cached), all started together."""
    with tempfile.TemporaryDirectory() as tmp:
        procs = {n: subprocess.Popen(
            [cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(cuda_build.CSRC), "-o",
             f"{tmp}/{n}.so", str(cuda_build.CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for n in names}
        return {n: ptxas_summary(p.communicate()[0]) for n, p in procs.items()}


def k6(cs, dev):
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    cfg = CaduceusConfig.preset("l20-ssd")
    rows, L, H, NG, N, T = cs.TRAIN_ROWS, 512, cfg.n_heads, cfg.n_groups, cfg.d_state, \
        cfg.chunk_size
    kw = dict(d_state=N, eps=cfg.norm_epsilon, chunk=T)
    gen = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        mixer, ssd = cs.ssd_inputs(cfg, rows, L, dtype, dev, gen, 23)
        g = torch.randn((rows, L, cfg.d_inner), generator=gen, device=dev).to(dtype)
        for d in (0, 1):
            rev = d == 1
            _, fe = cuda_ssd.ssd_dir(*ssd(d), T, rev, emit_fentry=True)
            a5 = mixer(d)
            _, accx, accB, accC, fe5, _ = cuda_mixer2.mamba2_mixer_interior(
                *a5, **kw, reverse=rev, emit_residuals=True)
            calls = {
                "ssd_bwd": (*ssd(d), fe, g),
                "ssd_bwd_pre_silu": (accx, a5[4], a5[12], accB.reshape(rows, L, NG, N),
                                     accC.reshape(rows, L, NG, N), a5[13], a5[14], fe5, g)}
            for name, args in calls.items():
                pre = name.endswith("pre_silu")

                def fn(a=args, r=rev, p=pre):
                    return cuda_ssd.ssd_dir_bwd(*a, T, r, pre_silu=p)

                b, by, _ = cs.work_bound(cs.ssd_train_work(rows, L, H, NG, dtype.itemsize,
                                                           name), dn)
                out.setdefault(name, {}).setdefault(dn, {})["rev" if rev else "fwd"] = dict(
                    ms=cs.time_ms(fn, 10), bound_ms=b, bound_by=by,
                    split_ms=cs.device_ms_by_kernel(fn))
            del calls, fe, fe5, accx, accB, accC
        del mixer, ssd, g
        torch.cuda.empty_cache()
    return out


def k3(cs, dev):
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    cfg = CaduceusConfig.preset("l20")
    rows, L = cs.TRAIN_ROWS, 512
    D, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
    w = cs.layer_weights(cfg, 5, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        x = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        gy = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
        for g in (0, 1):
            margs = (x, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                     w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g],
                     g == 1)
            res = cuda_mixer.mixer_fwd(*margs, emit_res=True)
            kargs = (x, gy, res[2], A[g], res[3], res[4], w["D"][g], w["dt_proj_b"][g],
                     res[5], w["dt_proj_w"][g], g == 1)

            def fn(a=kargs):
                return cuda_scan.scan_bwd(*a)

            b, by, _ = cs.bound_ms(*cs.scan_bwd_work(rows, L, D, N, R, dtype.itemsize))
            out.setdefault(dn, {})["rev" if g else "fwd"] = dict(
                ms=cs.time_ms(fn, 10), bound_ms=b, bound_by=by,
                split_ms=cs.device_ms_by_kernel(fn))
            del res, kargs
        del x, gy
        torch.cuda.empty_cache()
    return out


def idle_gaps(trace_path, top=5):
    """The ``top`` longest gaps between device activities in a chrome trace,
    each with the host runtime calls and operators that began inside it."""
    with open(trace_path) as f:
        ev = json.load(f)["traceEvents"]
    dev = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in ev
                 if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    host = [e for e in ev if e.get("cat") in ("cuda_runtime", "cuda_driver", "cpu_op")]
    if not dev:
        return []
    t0, gaps, end = dev[0][0], [], dev[0][1]
    for s, e in dev[1:]:
        if s > end:
            gaps.append((s - end, end, s))
        end = max(end, e)
    out = []
    for length, a, b in sorted(gaps, reverse=True)[:top]:
        inside = Counter(e["name"] for e in host if a <= e["ts"] < b)
        out.append(dict(ms=length / 1e3, at_ms=(a - t0) / 1e3,
                        host=dict(inside.most_common(8))))
    return out


def train_step(cs, preset, dev, steps=8):
    """Mean ms per training step over ``steps`` after three warm ones, then
    one profiled step: wall, busy, busy share and the longest idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
    from plantcaduceus_tpu_torch.train.step import make_train_step, to_device

    cfg = CaduceusConfig.preset(preset)
    model = Caduceus(cfg, init_params(cfg, seed=32))
    opt = make_optimizer(learning_rate=1e-3, warmup_steps=5, total_steps=30,
                         params=dict(model.named_parameters()))
    init, step, _ = make_train_step(cfg, opt, model, dtype=torch.bfloat16, remat=True,
                                    device=dev)
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=64, seed=32)
    ds = data_lib.PretrainDataset(seqs, DnaTokenizer(), 32, seed=32)
    state = init()
    for i in range(3):
        state, m = step(state, ds.batch_at(i))
        float(m["loss"])
    torch.cuda.synchronize()
    times = []
    for i in range(3, 3 + steps):
        t = time.perf_counter()
        state, m = step(state, ds.batch_at(i))
        float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    batch = to_device(ds.batch_at(3 + steps), dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kern) / 1e3
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        prof.export_chrome_trace(f.name)
        gaps = idle_gaps(f.name)
    top = {e.key[:80]: e.self_device_time_total / 1e3
           for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]}
    del state, model
    torch.cuda.empty_cache()
    return dict(step_ms=sum(times) / len(times), step_ms_each=times, wall_ms=wall,
                busy_ms=busy, busy_share=busy / wall, idle_gaps=gaps, top_kernels_ms=top)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="name of this run in the JSON line")
    ap.add_argument("--skip-steps", action="store_true", help="kernel timings only")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.repo).resolve()))
    import torch

    # chip_smoke.py of this checkout, whichever checkout the port comes from
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from plantcaduceus_tpu_torch.ops import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    cs.log(card)
    t = time.perf_counter()
    cuda_build.build_all(("ssd_bwd", "scan_bwd", "ssd_fwd", "mixer2_fwd", "mixer_fwd",
                          "scan_fwd"))
    build_s = time.perf_counter() - t
    ptxas = ptxas_reports(cuda_build, ("ssd_bwd", "scan_bwd"))
    dev = torch.device("cuda")
    res = dict(label=a.label, repo=str(Path(a.repo).resolve()), card=card, build_s=build_s,
               ptxas=ptxas, k6=k6(cs, dev), k3=k3(cs, dev))
    if not a.skip_steps:
        res["steps"] = {p: train_step(cs, p, dev) for p in ("l20", "l20-ssd")}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
