#!/usr/bin/env python3
"""The forward kernels K1, K2, K4 and K5 on the card, split by kernel, with
the scoring rates and training steps they carry, for one checkout.

    python3 tools/mixer_bench.py [--repo DIR] [--label NAME] [--skip-steps]
                                 [--no-train] [--only k1,k2,k2x,k4,k5]
                                 [--variant NAME] [--sass] [--sass-of SRC,...]
                                 [--no-ptxas]

Imports ``plantcaduceus_tpu_torch`` from DIR (default: the checkout this
script sits in), builds its sources and measures, on one CUDA card (CUDA
events over 10 launches after 2 warm-up; the split by kernel from
torch.profiler over 10 calls, each kernel's device time per call):

* K1 (``scan_fwd``), dt given and fused, at phase 3's shape (256 rows x
  512 x 768, N 16, R 24) and K1-hb (``hb_chunk`` 16) at phase 3b's (64
  rows), both directions, bf16 and fp32, each beside its bound; and K1 at
  64 rows with steep decays (a third of the channels' dt' near 25), where
  chunks take exp2f's full path;
* K4 (``ssd_dir``) at phase 3c's shape (256 rows x 512, H 6, P = N = chunk
  = 128) and K4-fentry (``emit_fentry``) at phase 3d's (64 rows), likewise;
* K2 (``mixer_fwd``) at ``chip_smoke.py`` phase 3's shape (256 rows x 512 x
  768, N 16, R 24) and K2-res (``emit_res``) at phase 3b's (64 rows), both
  directions, bf16 and fp32, each beside its bound;
* K2's ``fuse_in`` variant (``--only k2x``: ``mixer_fwd(w_in=)``, x [256,
  512, 384] and l20's in_proj x half) at the same shape, both directions,
  bf16 and fp32, beside its bound, the decomposed route (``torch.matmul``
  for xi, then K2 with xi given) in the same process, its largest error
  against the plain version, and its build unit's ``-Xptxas -v`` (when
  this process built it);
* K5 (``mamba2_mixer_interior``) at phase 3c's shape (256 rows x 512, H 6,
  P = N = chunk = 128) and K5-res (``emit_residuals``) at phase 3d's (64
  rows), likewise;
* the l20 and l20-ssd scoring rates (bf16, batch 128 x 512 bp, model
  resident, 1536 windows after a warm batch: phases 6 and 6b's steady
  state), and one profiled batch of each (phases 7 and 7b: the device's
  busy ms and its mixer kernels', K2's or K5's);
* the l20 and l20-ssd training steps (bf16, batch 32 x 512, remat; the
  mean of 8 and one profiled step, as ``tools/scan_bench.py``);
* ``nvcc -Xptxas -v`` of ``scan_fwd.cu``, ``mixer_fwd.cu``, ``ssd_fwd.cu``
  and ``mixer2_fwd.cu``: registers, shared memory and spills per kernel
  instantiation;
* with ``--sass``, the SASS of the forward scans (``cuobjdump -sass``): for
  each N = 16 instantiation, the instructions of the innermost loop that
  holds the recurrence's ``MUFU.EX2``, by opcode, and per ``MUFU.EX2``;
* with ``--sass-of SRC,...``, every kernel of those sources whole: its
  instructions by opcode, its local-memory ones, and for each global load
  the instructions until its value is first read (none when it is read in
  a later pass of the loop: loaded ahead), beside its ``-Xptxas -v``.

Every timed call's outputs are hashed (SHA-256 of their bytes) and the call
is made twice: two checkouts' JSON lines show whether they give the same
bits, and ``same_twice`` whether two launches do. ``--only`` picks the
kernels; ``--variant NAME`` first copies the port of ``--repo`` into
``build/variant_NAME/`` with one of the named diagnostic edits of
``VARIANTS`` applied (e.g. the recurrence without its exp2) and measures
that copy.

Run it for two checkouts in one call (parent, change, change, parent) to
compare them on one card. Prints the card's name and power limit, then one
JSON line per run. The helpers (timing, inputs, bounds, the training step)
are those of ``chip_smoke.py`` and ``tools/scan_bench.py`` in this
script's checkout.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
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


# Diagnostic copies: name -> the edits (source file under csrc/, text,
# replacement) that make it. Each changes one part of a kernel's work or
# layout, so its time shows that part's share; the outputs of the ones that
# drop work are wrong on purpose.
VARIANTS = {
    # the shared forward scan (scan_core.cuh scan_fwd_kernel, K1 and K2)
    "fwd_noexp2": [("scan_core.cuh", "decltype(fast)::value ? ex2_ftz(arg) : exp2f(arg)",
                    "arg")],
    "fwd_nosoftplus": [("scan_core.cuh", "softplus(dv[k] + bias)", "(dv[k] + bias)")],
    "fwd_nodt": [("scan_core.cuh", "for (int r = 0; r < R; ++r) {",
                  "for (int r = 0; r < 0; ++r) {")],
    "fwd_exp2f": [("scan_core.cuh",
                   "if (__all_sync(0xffffffffu, dtmax * kLog2e * amin >= -126.f))",
                   "if (false)")],
    # without the store of y (kept only where acc is -1.2345e-30, so its sum
    # stays), or of hb: what each store costs in each dtype
    "fwd_noystore": [("scan_core.cuh", "if (live && p < L) y[",
                      "if (live && p < L && acc == -1.2345e-30f) y[")],
    "fwd_nohbstore": [("scan_core.cuh", "if (p < L && live) store_state<N>(hb",
                       "if (false) store_state<N>(hb")],
    # K2 fuse_in (bf16) without its products: the scan's tiles and the conv
    # window's xi left as they are (zeros or stale), to show what the
    # products cost in each kernel
    "x_noproj": [("mixer_fwd.cu", "for (int k0 = 0; k0 < Dm; k0 += 4 * 16) {",
                  "for (int k0 = 0; k0 < 0; k0 += 4 * 16) {")],
    "x_nomma": [("mixer_fwd.cu", "for (int k0 = 0; k0 < Dm; k0 += 16) {\n        uint32_t an[2][4]",
                 "for (int k0 = 0; k0 < 0; k0 += 16) {\n        uint32_t an[2][4]")],
    # the conv kernel's products on its first k-step's fragments (no later
    # ldmatrix), or its ldmatrix without the products; the scan's products
    # on constant x fragments (no x loads), or its loads without products
    "x_noldsm": [("mixer_fwd.cu", "        if (k0 + 16 < Dm) frags(an, bn, k0 + 16);",
                  "        if (k0 < 0) frags(an, bn, k0 + 16);")],
    "x_noprod": [("mixer_fwd.cu",
                  "            mma_bf16(v[m][2 * j], fa[m], fb[j][0], fb[j][1]);\n"
                  "            mma_bf16(v[m][2 * j + 1], fa[m], fb[j][2], fb[j][3]);",
                  "            v[m][2 * j][0] += __uint_as_float(fa[m][0] ^ fb[j][0] ^ fb[j][3]);")],
    "x_noxload": [("mixer_fwd.cu",
                   "        a[s][0] = xa && in ? ld_u32(xa + k) : 0u;\n"
                   "        a[s][1] = xb && in ? ld_u32(xb + k) : 0u;\n"
                   "        a[s][2] = xa && in ? ld_u32(xa + k + 8) : 0u;\n"
                   "        a[s][3] = xb && in ? ld_u32(xb + k + 8) : 0u;",
                   "        a[s][0] = k; a[s][1] = k + 1; a[s][2] = k + 2; a[s][3] = k + 3;")],
    "x_noprodb": [("mixer_fwd.cu",
                   "          mma_bf16(v[2 * j], a[s], bb[0], bb[1]);\n"
                   "          mma_bf16(v[2 * j + 1], a[s], bb[2], bb[3]);",
                   "          v[2 * j][0] += __uint_as_float(a[s][0] ^ a[s][1] ^ a[s][2] ^ a[s][3]"
                   " ^ bb[0] ^ bb[3]);")],
}


# The build unit of each kernel's library.
SOURCE = dict(k1="scan_fwd", k2="mixer_fwd", k2x="mixer_fwd_x", k4="ssd_fwd", k5="mixer2_fwd")


def make_variant(repo: Path, name: str) -> Path:
    """A copy of ``repo``'s port under ``build/variant_<name>/`` with the
    edits ``VARIANTS[name]`` applied; raises if a text is not there."""
    dst = HERE / "build" / f"variant_{name}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(repo / "plantcaduceus_tpu_torch", dst / "plantcaduceus_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for fname, old, new in VARIANTS[name]:
        f = dst / "plantcaduceus_tpu_torch" / "csrc" / fname
        text = f.read_text()
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} not in {fname}")
        f.write_text(text.replace(old, new))
    return dst


def digest(out):
    """SHA-256 (first 16 hex digits) of the bytes of every tensor of ``out``."""
    import torch

    h = hashlib.sha256()
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def timed(cs, fn, work):
    b, by, _ = work
    d = digest(fn())
    return dict(ms=cs.time_ms(fn, 10), bound_ms=b, bound_by=by, split_ms=split_per_call(fn),
                digest=d, same_twice=digest(fn()) == d)


def k1(cs, dev):
    """K1 at phase 3's shape, K1-hb at phase 3b's; dt given and fused,
    both directions."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_scan
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    cfg = CaduceusConfig.preset("l20")
    D, N, R = cfg.d_inner, cfg.d_state, cfg.dt_rank
    w = cs.layer_weights(cfg, 1, dev)
    A = -torch.exp(w["A_log"])
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, rows, hbc in (("scan_fwd", 256, None), ("scan_fwd_hb", cs.TRAIN_ROWS, HB_CHUNK)):
        L = 512
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            r = lambda *s, sc=1.0: (torch.randn(s, generator=gen, device=dev) * sc).to(dtype)
            x, Bm, Cm = r(rows, L, D), r(rows, L, N), r(rows, L, N)
            for fuse in (True, False):
                dt = r(rows, L, R if fuse else D, sc=0.5)
                bound = cs.bound_ms(*cs.scan_fwd_work(rows, L, D, N, R if fuse else 0,
                                                      dtype.itemsize, hbc))
                for g in (0, 1):
                    args = (x, dt, A[g], Bm, Cm, w["D"][g], w["dt_proj_b"][g],
                            w["dt_proj_w"][g] if fuse else None, g == 1)

                    def fn(a=args):
                        return cuda_scan.scan_fwd(*a, hb_chunk=hbc)

                    out.setdefault(name, {}).setdefault(dn, {}).setdefault(
                        "fused" if fuse else "dt_given", {})["rev" if g else "fwd"] = timed(
                        cs, fn, bound)
                del dt
            del x, Bm, Cm
            torch.cuda.empty_cache()
    # Steep decays at the training shape: every third channel's dt' near 25,
    # so chunks whose exponents fall below -126 take exp2f's full path.
    rows, L = cs.TRAIN_ROWS, 512
    steep = w["dt_proj_b"][0] + 25.0 * (torch.arange(D, device=dev) % 3 == 0)
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        r = lambda *s, sc=1.0: (torch.randn(s, generator=gen, device=dev) * sc).to(dtype)
        x, Bm, Cm, dt = r(rows, L, D), r(rows, L, N), r(rows, L, N), r(rows, L, D, sc=0.5)
        bound = cs.bound_ms(*cs.scan_fwd_work(rows, L, D, N, 0, dtype.itemsize))
        for g in (0, 1):
            def fn(a=(x, dt, A[0], Bm, Cm, w["D"][0], steep, None, g == 1)):
                return cuda_scan.scan_fwd(*a)

            out.setdefault("scan_fwd_steep", {}).setdefault(dn, {})["rev" if g else "fwd"] = \
                timed(cs, fn, bound)
    return out


def k4(cs, dev):
    """K4 at phase 3c's shape, K4-fentry at phase 3d's; both directions."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    cfg = CaduceusConfig.preset("l20-ssd")
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for name, rows, fentry in (("ssd_fwd", 256, False), ("ssd_fwd_fentry", cs.TRAIN_ROWS, True)):
        L = 512
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            _, ssd = cs.ssd_inputs(cfg, rows, L, dtype, dev, gen, 21)
            if fentry:
                work = cs.ssd_train_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize,
                                         "ssd_fwd_fentry")
            else:
                work = cs.ssd_work(rows, L, cfg.n_heads, cfg.n_groups, dtype.itemsize)
            bound = cs.work_bound(work, dn)
            for g in (0, 1):
                def fn(a=ssd(g), r=g == 1):
                    return cuda_ssd.ssd_dir(*a, cfg.chunk_size, r, emit_fentry=fentry)

                out.setdefault(name, {}).setdefault(dn, {})["rev" if g else "fwd"] = timed(
                    cs, fn, bound)
            del ssd
            torch.cuda.empty_cache()
    return out


def sass_functions(cuda_build, name):
    """{kernel: [(address, instruction)]} of one source's library, from
    ``cuobjdump -sass``."""
    tool = Path(cuda_build.find_nvcc()).with_name("cuobjdump")
    lib = cuda_build.build_all((name,))[name]
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=600, check=True).stdout
    out = {}
    for fn in re.split(r"\n\s*Function : ", text)[1:]:
        out[fn.split("\n", 1)[0].strip()] = [
            (int(m.group(1), 16), m.group(2))
            for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(\S.*?);", fn)]
    return out


def _opcode(t):
    return re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]


def _back_branch(a, t):
    m = re.search(r"\bBRA\S*\s.*?0x([0-9a-f]+)", t)
    return m is not None and int(m.group(1), 16) < a


def load_use(ins):
    """For each global load of ``ins``: the instructions until the first one
    that reads its destination, or None when a backward branch comes first
    (the value is used in a later pass of the loop, i.e. loaded ahead)."""
    out = []
    for i, (_, t) in enumerate(ins):
        op = _opcode(t)
        if not op.startswith("LDG"):
            continue
        m = re.search(r"\bLDG\S*\s+R(\d+)", t)
        if not m:
            continue
        w = 4 if ".128" in op else 2 if ".64" in op else 1
        regs = {f"R{int(m.group(1)) + k}" for k in range(w)}
        dist = None
        for j in range(i + 1, len(ins)):
            a, u = ins[j]
            if set(re.findall(r"\bR\d+\b", u.split(",", 1)[1] if "," in u else "")) & regs or (
                    _opcode(u).startswith("ST") and set(re.findall(r"\bR\d+\b", u)) & regs):
                dist = j - i
                break
            if _back_branch(a, u):
                break
        out.append(dist)
    return out


def sass_kernels(cuda_build, names):
    """Per kernel of these sources: its SASS instructions, by opcode, the
    local-memory ones, and for its global loads how soon each is used."""
    out = {}
    for n in names:
        for kname, ins in sass_functions(cuda_build, n).items():
            ops = Counter(_opcode(t) for _, t in ins)
            use = load_use(ins)
            near = sorted(d for d in use if d is not None)
            out[kname] = dict(
                instructions=len(ins), opcodes=dict(ops.most_common(24)),
                local=sum(v for k, v in ops.items() if k.startswith(("LDL", "STL"))),
                ldg=len(use), ldg_ahead=use.count(None),
                ldg_use_median=near[len(near) // 2] if near else None,
                ldg_use_min=near[0] if near else None)
    return out


def sass_loops(cuda_build, names=("scan_fwd", "mixer_fwd")):
    """For each N = 16 kernel of these sources that holds MUFU.EX2: the
    innermost loop (the shortest span closed by a backward branch) that
    holds them, its instructions by opcode and per MUFU.EX2, and how soon
    its global loads are used (``load_use``)."""
    out = {}
    for n in names:
        for kname, ins in sass_functions(cuda_build, n).items():
            if "Li16E" not in kname:
                continue
            ex2 = [a for a, t in ins if "MUFU.EX2" in t]
            if not ex2:
                continue
            best = None
            for a, t in ins:
                m = re.search(r"\bBRA\S*\s.*?0x([0-9a-f]+)", t)
                if m and int(m.group(1), 16) < a:
                    lo = int(m.group(1), 16)
                    if any(lo <= e <= a for e in ex2) and (best is None or a - lo < best[1] - best[0]):
                        best = (lo, a)
            if best is None:  # no loop found: the whole function
                best = (ins[0][0], ins[-1][0])
            body = [t for a, t in ins if best[0] <= a <= best[1]]
            ops = Counter(_opcode(t) for t in body)
            n_ex2 = ops.get("MUFU.EX2", 0)
            use = load_use(ins)
            near = sorted(d for d in use if d is not None)
            out[kname] = dict(loop_instructions=len(body), mufu_ex2=n_ex2,
                              per_ex2=len(body) / max(n_ex2, 1),
                              predicated=sum(t.startswith("@") for t in body),
                              fsetp=sorted({t.strip() for t in body if "FSETP" in t})[:6],
                              opcodes=dict(ops.most_common(14)),
                              instructions=len(ins), ldg=len(use), ldg_ahead=use.count(None),
                              ldg_use_median=near[len(near) // 2] if near else None)
    return out


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


def k2x(cs, dev):
    """K2 fuse_in at phase 3's shape, both directions, beside the decomposed
    route and against the plain version."""
    import torch

    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_build, cuda_mixer

    cfg = CaduceusConfig.preset("l20")
    D, N, R, K, Dm = cfg.d_inner, cfg.d_state, cfg.dt_rank, cfg.d_conv, cfg.d_model
    rows, L = 256, 512
    w = cs.layer_weights(cfg, 1, dev)
    A = -torch.exp(w["A_log"])
    w_in = w["in_proj_x"][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        x = torch.randn((rows, L, Dm), generator=gen, device=dev).to(dtype)
        w_x = w_in.to(dtype)
        work = cs.mixer_fwd_x_work(rows, L, Dm, D, N, R, K, dtype.itemsize)
        bound = (cs.bound_ms(*work) if dtype == torch.bfloat16
                 else cs.bound_ms(work[0], work[1] + work[3], work[2]))
        for g in (0, 1):
            args = (x, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                    w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g])

            def fn(a=args, r=g == 1):
                return cuda_mixer.mixer_fwd(*a, reverse=r, w_in=w_in)

            def decomposed(a=args, r=g == 1):
                return cuda_mixer.mixer_fwd(torch.matmul(x, w_x), *a[1:], reverse=r)

            res = timed(cs, fn, bound)
            res["decomposed_ms"] = cs.time_ms(decomposed, 10)
            want = cuda_mixer.mixer_fwd_plain(*args, reverse=g == 1, w_in=w_in).float()
            res["max_rel_err"] = ((fn().float() - want).abs().max() / want.abs().max()).item()
            out.setdefault(dn, {})["rev" if g else "fwd"] = res
            del want
        del x
        torch.cuda.empty_cache()
    out["ptxas"] = cuda_build.ptxas_reports.get("mixer_fwd_x", "")
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
    split = split_per_call(lambda: runner.masked_probs(ids[:bs], nucleotide_ids(tok),
                                                       L // 2 - 1, progress=False), iters=2)
    mixer = sum(v for k, v in split.items() if "conv_xproj" in k or "scan_fwd_kernel" in k
                or "mamba2" in k or "ssd" in k)
    del runner, model
    torch.cuda.empty_cache()
    return dict(wps=wps, busy_ms=sum(split.values()), mixer_ms=mixer)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE), help="checkout to import the port from")
    ap.add_argument("--label", default="", help="name of this run in the JSON line")
    ap.add_argument("--skip-steps", action="store_true",
                    help="kernel timings only (no scoring rates or training steps)")
    ap.add_argument("--no-train", action="store_true",
                    help="the scoring rates without the training steps")
    ap.add_argument("--only", default="k1,k2,k4,k5", help="kernels to time, comma-separated")
    ap.add_argument("--variant", choices=sorted(VARIANTS), help="measure a diagnostic copy")
    ap.add_argument("--sass", action="store_true", help="count the forward scans' SASS")
    ap.add_argument("--sass-of", default="",
                    help="sources (e.g. mixer2_fwd,scan_fwd) whose kernels' SASS to count, "
                         "each kernel whole, with their -Xptxas -v")
    ap.add_argument("--no-ptxas", action="store_true", help="skip the -Xptxas -v compiles")
    a = ap.parse_args()
    repo = Path(a.repo).resolve()
    if a.variant:
        repo = make_variant(repo, a.variant)
    sys.path.insert(0, str(repo))
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
    only = [k for k in a.only.split(",") if k]
    sass_of = [n for n in a.sass_of.split(",") if n]
    sources = [SOURCE[k] for k in only] + (["mixer_fwd"] if a.sass else []) + sass_of
    t = time.perf_counter()
    cuda_build.build_all(tuple(dict.fromkeys(sources)) if a.skip_steps else cuda_build.SOURCES)
    build_s = time.perf_counter() - t
    ptxas = {} if a.no_ptxas else sb.ptxas_reports(
        cuda_build, tuple(dict.fromkeys([cuda_build.UNITS[SOURCE[k]][0] for k in only]
                                        + sass_of)))
    dev = torch.device("cuda")
    res = dict(label=a.label, repo=str(repo), variant=a.variant, card=card, build_s=build_s,
               ptxas=ptxas)
    if a.sass:
        res["sass"] = sass_loops(cuda_build)
    if sass_of:
        res["sass_kernels"] = sass_kernels(cuda_build, sass_of)
    benches = dict(k1=k1, k2=k2, k2x=k2x, k4=k4, k5=k5)
    for k in only:
        res[k] = benches[k](cs, dev)
    if not a.skip_steps:
        res["scoring_wps"] = {p: scoring_rate(p, dev) for p in ("l20", "l20-ssd")}
        if not a.no_train:
            res["steps"] = {p: sb.train_step(cs, p, dev) for p in ("l20", "l20-ssd")}
    print(json.dumps(res))


if __name__ == "__main__":
    main()
