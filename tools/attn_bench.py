#!/usr/bin/env python3
"""K7/K8 on the card beside SDPA, and the BERT-Base profile, for one checkout.

    python3 tools/attn_bench.py [--repo DIR] [--label NAME] [--skip-profile]

Imports ``plantcaduceus_tpu_torch`` from DIR (default: the checkout this
script sits in), builds its two attention sources and measures, on one
CUDA card, at the shapes of ``chip_smoke.py`` phase 3e (H 12, hd 64,
ALiBi; CUDA events over 10 launches after 2 warm-up):

* K7 (``flash_fwd``) at 128 x 512 and 32 x 512, bf16 and fp32, and at
  1 x 8192 in bf16; K8 (``flash_bwd``) at 32 x 512, bf16 and fp32; each
  beside ``scaled_dot_product_attention`` with the ALiBi bias materialised
  (forward, and its autograd backward for K8), and beside its bound;
* K8's device time split by kernel (torch.profiler over 10 calls);
* the BERT-Base profile of ``chip_smoke.py`` phase 10c (one bf16 forward
  batch of 128 x 512 and one training step of 32 x 512): wall and busy ms,
  and how many host-to-device copies and stream or device synchronisations
  the host issued in that window.

Run it for two checkouts in one call (parent, change, change, parent) to
compare them on one card. Prints the card's name and power limit, then one
JSON line per run. The helpers (timing, bounds, BERT-Base's trainer) are
``chip_smoke.py``'s, from this script's checkout.
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


def kernels(cs, dev):
    import torch

    from plantcaduceus_tpu_torch.ops import cuda_attention as ca
    from plantcaduceus_tpu_torch.ops.attention import alibi_bias, alibi_slopes

    H, hd, L = 12, 64, 512
    gen = torch.Generator(device=dev).manual_seed(41)
    slopes = alibi_slopes(H, dev)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        for B in (128, 32):
            q, k, v, do = cs.attn_inputs(B, L, H, hd, dtype, dev, gen)
            bias = alibi_bias(H, L, dev).to(dtype)
            o, lse = ca.flash_fwd(q, k, v, slopes)
            r = out.setdefault(f"attn_fwd_{B}x{L}", {})
            r[dn] = dict(ms=cs.time_ms(lambda: ca.flash_fwd(q, k, v, slopes), 10),
                         sdpa_ms=cs.time_ms(cs.sdpa_fn(q, k, v, bias, False), 10),
                         bound_ms=cs.work_bound(cs.attn_work(B, L, H, hd, dtype.itemsize,
                                                             "attn_fwd"), dn)[0])
            if B == 32:
                args = (q, k, v, o, do, lse, slopes)
                r = out.setdefault(f"attn_bwd_{B}x{L}", {})
                r[dn] = dict(ms=cs.time_ms(lambda: ca.flash_bwd(*args), 10),
                             sdpa_ms=cs.time_ms(cs.sdpa_fn(q, k, v, bias, True), 10),
                             bound_ms=cs.work_bound(cs.attn_work(B, L, H, hd, dtype.itemsize,
                                                                 "attn_bwd"), dn)[0],
                             split_ms=cs.device_ms_by_kernel(lambda: ca.flash_bwd(*args)))
            del q, k, v, do, o, lse, bias
            torch.cuda.empty_cache()
    B8, L8 = 1, cs.LONG_L
    q, k, v, _ = cs.attn_inputs(B8, L8, H, hd, torch.bfloat16, dev, gen)
    bias = alibi_bias(H, L8, dev).to(torch.bfloat16)
    out[f"attn_fwd_{B8}x{L8}"] = {"bfloat16": dict(
        ms=cs.time_ms(lambda: ca.flash_fwd(q, k, v, slopes), 10),
        sdpa_ms=cs.time_ms(cs.sdpa_fn(q, k, v, bias, False), 10),
        bound_ms=cs.work_bound(cs.attn_work(B8, L8, H, hd, 2, "attn_fwd"), "bfloat16")[0])}
    return out


def profile_bert(cs, dev):
    """Phase 10c's two windows: wall, busy, and the host's copies and
    synchronisations in each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plantcaduceus_tpu_torch.train.step import to_device

    _, model, step = cs.bert_trainer(dev, 49)
    ids = torch.randint(7, 11, (cs.BERT_BATCH[0], cs.BERT_L), device=dev)
    batches = [to_device(b, dev) for b in cs.mlm_batches(cs.BERT_BATCH[1], 2, 50)]
    out = {}
    for label, warm, run in (("forward_batch", lambda: model(ids), lambda: model(ids)),
                             ("training_step", lambda: step(batches[0]),
                              lambda: step(batches[1]))):
        with torch.inference_mode(label == "forward_batch"):
            warm()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t) * 1e3
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

        def n(pred):
            return sum(e.count for e in ev if pred(e.key))

        out[label] = dict(
            wall_ms=wall, busy_ms=busy,
            htod_copies=n(lambda k: k.startswith("Memcpy HtoD")),
            memcpy_calls=n(lambda k: k.startswith("cudaMemcpy")),
            sync_calls=n(lambda k: k in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                         "cudaEventSynchronize")),
            attn_ms={e.key.split("<")[0].split()[-1]: e.self_device_time_total / 1e3
                     for e in ev if e.device_type == torch.autograd.DeviceType.CUDA
                     and "attn_" in e.key})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="name of this run in the JSON line")
    ap.add_argument("--skip-profile", action="store_true", help="kernel timings only")
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
    cuda_build.build_all(("attn_fwd", "attn_bwd"))
    build_s = time.perf_counter() - t
    for name, rep in cuda_build.ptxas_reports.items():
        cs.log(f"{name}: " + "; ".join(ln.strip() for ln in rep.splitlines()
                                       if "registers" in ln or "spill" in ln))
    dev = torch.device("cuda")
    res = dict(label=a.label, repo=str(Path(a.repo).resolve()), card=card,
               build_s=build_s, kernels=kernels(cs, dev))
    if not a.skip_profile:
        res["bert_profile"] = profile_bert(cs, dev)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
