#!/usr/bin/env python3
"""K2 and K5 (the fused Mamba-1 and Mamba-2 mixers) on the card, split by
kernel, with the scoring rates and training steps they carry, for one
checkout.

    python3 tools/mixer_bench.py [--repo DIR] [--label NAME] [--skip-steps]

Imports ``plantcaduceus_tpu_torch`` from DIR (default: the checkout this
script sits in), builds its sources and measures, on one CUDA card (CUDA
events over 10 launches after 2 warm-up; the split by kernel from
torch.profiler over 10 calls, each kernel's device time per call):

* K2 (``mixer_fwd``) at ``chip_smoke.py`` phase 3's shape (256 rows x 512 x
  768, N 16, R 24) and K2-res (``emit_res``) at phase 3b's (64 rows), both
  directions, bf16 and fp32, each beside its bound;
* K5 (``mamba2_mixer_interior``) at phase 3c's shape (256 rows x 512, H 6,
  P = N = chunk = 128) and K5-res (``emit_residuals``) at phase 3d's (64
  rows), likewise;
* the l20 and l20-ssd scoring rates (bf16, batch 128 x 512 bp, model
  resident, 1536 windows after a warm batch: phases 6 and 6b's steady
  state);
* the l20 and l20-ssd training steps (bf16, batch 32 x 512, remat; the
  mean of 8 and one profiled step, as ``tools/scan_bench.py``);
* ``nvcc -Xptxas -v`` of ``mixer_fwd.cu`` and ``mixer2_fwd.cu`` (and of the
  sources that share their headers): registers, shared memory and spills per
  kernel instantiation.

Run it for two checkouts in one call (parent, change, change, parent) to
compare them on one card. Prints the card's name and power limit, then one
JSON line per run. The helpers (timing, inputs, bounds, the training step)
are those of ``chip_smoke.py`` and ``tools/scan_bench.py`` in this
script's checkout.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _module(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def split_per_call(fn, iters=10):
    """Device ms per call of ``fn`` by kernel name (torch.profiler over
    ``iters`` calls after one warm call): a kernel launched k times a call
    counts k times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("<")[0].split("(")[0].split()[-1].split("::")[-1]:
            e.self_device_time_total / 1e3 / iters for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def timed(cs, fn, work):
    b, by, _ = work
    return dict(ms=cs.time_ms(fn, 10), bound_ms=b, bound_by=by, split_ms=split_per_call(fn))


def k2(cs, dev):
    """K2 at phase 3's shape, K2-res at phase 3b's; both directions."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    cfg = CaduceusConfig.preset("l20")
    D, N, R, K = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv
    J = R + 2 * N
    w = cs.layer_weights(cfg, 1, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, rows, res in (("mixer_fwd", 256, False), ("mixer_fwd_res", cs.TRAIN_ROWS, True)):
        L = 512
        pts = rows * L * D
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            s = dtype.itemsize
            xi = torch.randn((rows, L, D), generator=gen, device=dev).to(dtype)
            if res:
                nbytes = (3 * s * pts + 4 * rows * L * J + 4 * rows * -(-L // HB_CHUNK) * D * N
                          + 4 * (D * (K + 1 + J + N + 2) + R * D))
            else:
                nbytes = 2 * rows * L * D * s + 4 * (D * (K + 1 + J + N + 2) + R * D)
            work = cs.bound_ms(nbytes, pts * (2 * K + 2 * J + 2 * R + 6 * N + 10), pts * (N + 3))
            for g in (0, 1):
                args = (xi, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                        w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g],
                        g == 1)

                def fn(a=args):
                    return cuda_mixer.mixer_fwd(*a, emit_res=res)

                out.setdefault(name, {}).setdefault(dn, {})["rev" if g else "fwd"] = timed(
                    cs, fn, work)
            del xi
            torch.cuda.empty_cache()
    return out


def k5(cs, dev):
    """K5 at phase 3c's shape, K5-res at phase 3d's; both directions."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    cfg = CaduceusConfig.preset("l20-ssd")
    kw = dict(d_state=cfg.d_state, eps=cfg.norm_epsilon, chunk=cfg.chunk_size)
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, rows, res in (("mixer2_fwd", 256, False), ("mixer2_fwd_res", cs.TRAIN_ROWS, True)):
        L = 512
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            mixer, _ = cs.ssd_inputs(cfg, rows, L, dtype, dev, gen, 21)
            if res:
                work = cs.ssd_train_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize,
                                         "mixer2_fwd_res")
            else:
                work = cs.ssd_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize,
                                   mixer=True)
            bound = cs.work_bound(work, dn)
            for g in (0, 1):
                def fn(a=mixer(g), r=g == 1):
                    return cuda_mixer2.mamba2_mixer_interior(*a, **kw, reverse=r,
                                                             emit_residuals=res)

                out.setdefault(name, {}).setdefault(dn, {})["rev" if g else "fwd"] = timed(
                    cs, fn, bound)
            del mixer
            torch.cuda.empty_cache()
    return out


def scoring_rate(preset, dev, n=1536, bs=128, L=512, seed=0):
    """Windows/s of the engine at batch ``bs`` (bf16, model resident) over
    ``n`` seeded windows after one warm batch, as phases 6 and 6b."""
    import numpy as np
    import torch

    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.io.tokenizer import nucleotide_ids
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    model, cfg, tok = load_model_and_tokenizer(preset)
    runner = InferenceRunner(model, cfg, dtype=torch.bfloat16, batch_size=bs, device=dev)
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(n)]
    ids = zero_shot.mask_and_encode(seqs, tok, L // 2 - 1)
    runner.masked_probs(ids[:bs], nucleotide_ids(tok), L // 2 - 1, progress=False)
    torch.cuda.synchronize()
    t = time.perf_counter()
    probs = runner.masked_probs(ids, nucleotide_ids(tok), L // 2 - 1, progress=False)
    wps = n / (time.perf_counter() - t)
    if not np.isfinite(probs).all():
        raise RuntimeError(f"{preset} scoring produced non-finite probabilities")
    del runner, model
    torch.cuda.empty_cache()
    return wps


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="name of this run in the JSON line")
    ap.add_argument("--skip-steps", action="store_true",
                    help="kernel timings only (no scoring rates or training steps)")
    a = ap.parse_args()
    sys.path.insert(0, str(Path(a.repo).resolve()))
    import torch

    cs = _module("chip_smoke", HERE / "chip_smoke.py")
    sb = _module("scan_bench", HERE / "tools" / "scan_bench.py")
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
    cuda_build.build_all()
    build_s = time.perf_counter() - t
    ptxas = sb.ptxas_reports(cuda_build, ("mixer_fwd", "mixer2_fwd"))
    dev = torch.device("cuda")
    res = dict(label=a.label, repo=str(Path(a.repo).resolve()), card=card, build_s=build_s,
               ptxas=ptxas, k2=k2(cs, dev), k5=k5(cs, dev))
    if not a.skip_steps:
        res["scoring_wps"] = {p: scoring_rate(p, dev) for p in ("l20", "l20-ssd")}
        res["steps"] = {p: sb.train_step(cs, p, dev) for p in ("l20", "l20-ssd")}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
