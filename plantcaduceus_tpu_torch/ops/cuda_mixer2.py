"""K5: the Mamba-2 mixer interior as a hand-written CUDA kernel, and its
gradient.

Counterpart of ``plantcaduceus_tpu.ops.pallas_mixer2``.
``mamba2_mixer_interior`` runs ``csrc/mixer2_fwd.cu`` for one direction:
the depthwise convs of x, B and C with SiLU, K4's chunk math
(``csrc/ssd_core.cuh``) run chunk-parallel, and the gated RMS norm; its
training variant (``emit_residuals``) also returns what the backward needs.
``mamba2_mixer_interior_plain`` is the plain PyTorch version of the same
function (JAX ``_interior_xla``), computed in the kernel's types: conv taps
and biases rounded to xi's dtype and summed in float32, the SSD output y
kept in float32, the norm in float32. :class:`Mamba2InteriorFn` is the
differentiable interior, JAX ``_interior`` with its custom VJP: K5-res
forward; in the backward the gated-norm adjoint in PyTorch, K6
(``ops.cuda_ssd.ssd_dir_bwd``) in ``pre_silu`` mode, and the conv
transposes.

``mamba2_mixer_interior`` takes the plain version for tensors on the CPU
only. For CUDA tensors it launches the kernel or raises; it never falls
back. Shapes as K4 (:func:`.cuda_ssd.check_kernel_shapes`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_bwd
from plantcaduceus_tpu_torch.ops.cuda_ssd import (KERNEL_DTYPES, MAX_ROWS, SSD_TILE,
                                                  check_kernel_shapes, ssd_dir_bwd)
from plantcaduceus_tpu_torch.ops.norms import rms_norm
from plantcaduceus_tpu_torch.ops.selective_scan import softplus
from plantcaduceus_tpu_torch.ops.ssd import chunk_scan, fit_chunk

MAX_TAPS = 8  # kMaxTaps in csrc/mixer2_fwd.cu
SSD_PARTS = 2  # sums of v^2 per (row, t, head), at most: TileFrag::kParts in csrc/mixer2_fwd.cu


def mamba2_mixer_interior_plain(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw,
                                A, Dsk, dtb, *, d_state: int, eps: float, chunk: int,
                                reverse: bool, emit_residuals: bool = False):
    """Plain version of :func:`mamba2_mixer_interior`: same arguments, same
    results."""
    R, L, di = xi.shape
    H = dt.shape[-1]
    NG = Braw.shape[-1] // d_state
    fit_chunk(chunk, L)
    mm = torch.bfloat16 if xi.dtype == torch.bfloat16 else torch.float32

    def conv(inp, w, b):  # the pre-SiLU accumulator, float32
        return causal_conv1d(inp.float(), w.to(xi.dtype).float(), b.to(xi.dtype).float(),
                             activation=None, anticausal=reverse)

    acc_x, acc_B, acc_C = conv(xi, cxw, cxb), conv(Braw, cbw, cbb), conv(Craw, ccw, ccb)
    xc = F.silu(acc_x)
    dtp = softplus(dt.float() + dtb.float())
    y, fentry = chunk_scan(xc.reshape(R, L, H, di // H), dtp, A.float(),
                           F.silu(acc_B).reshape(R, L, NG, d_state),
                           F.silu(acc_C).reshape(R, L, NG, d_state), chunk, reverse, mm,
                           emit_fentry=True)
    y = (y + Dsk.float()[:, None] * xc.reshape(R, L, H, di // H)).reshape(R, L, di)
    u = rms_norm(y * F.silu(z.float()), nw, eps).to(xi.dtype)
    if not emit_residuals:
        return u
    return (u, acc_x.to(xi.dtype), acc_B.to(xi.dtype), acc_C.to(xi.dtype), fentry,
            y.to(xi.dtype))


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mamba2_mixer_interior: {msg}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mixer2_fwd")
    if lib.pc_mixer2_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pc_mixer2_fwd.restype = I
        lib.pc_mixer2_fwd.argtypes = [P] * 26 + [I] * 6 + [ctypes.c_float, I, P]
    return lib


def mamba2_mixer_interior(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk,
                          dtb, *, d_state: int, eps: float, chunk: int, reverse: bool,
                          emit_residuals: bool = False):
    """One direction of the Mamba-2 mixer interior (JAX
    ``pallas_mixer2._interior_pallas_call``): xi, z [R, L, di]; Braw, Craw
    [R, L, NG*N]; dt [R, L, H] raw; all of one dtype (float32 or bfloat16).
    cxw [di, K], cxb [di], cbw/ccw [NG*N, K], cbb/ccb [NG*N]: conv taps (tap
    K-1 = the current step) and biases, any float dtype, rounded to xi's
    dtype; nw [di] the gated-norm weight; A, Dsk, dtb [H] float32.
    ``reverse`` makes the convs anticausal and the scan run right to left.
    Returns u [R, L, di] in xi's dtype: everything up to the out_proj. With
    ``emit_residuals`` (the training variant) returns ``(u, accx, accB,
    accC, fentry, y)``: the pre-SiLU conv accumulators and the pre-gate SSD
    output y (D-skip included) in xi's dtype, and the float32 chunk-entry
    states ``[R, L/128, N, di]``. ``launches`` counts the inference variant,
    ``res_launches`` the training one."""
    if xi.device.type == "cpu":
        return mamba2_mixer_interior_plain(
            xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk, dtb,
            d_state=d_state, eps=eps, chunk=chunk, reverse=reverse,
            emit_residuals=emit_residuals)
    _require(xi.device.type == "cuda", f"tensors on {xi.device}; need cuda or cpu")
    R, L, di = xi.shape
    H = dt.shape[-1]
    NGN = Braw.shape[-1]
    K = cxw.shape[-1]
    _require(di % H == 0 and NGN % d_state == 0,
             f"d_inner {di} / n_heads {H} or B width {NGN} / d_state {d_state} not whole")
    NG = NGN // d_state
    check_kernel_shapes("mamba2_mixer_interior", L, H, di // H, NG, d_state, chunk)
    _require(xi.dtype in KERNEL_DTYPES, f"xi dtype {xi.dtype} not in {KERNEL_DTYPES}")
    _require(0 < R <= MAX_ROWS, f"rows {R} outside 1..{MAX_ROWS}")
    _require(0 < K <= MAX_TAPS, f"d_conv {K} outside 1..{MAX_TAPS}")
    for name, t, shape in (("xi", xi, (R, L, di)), ("z", z, (R, L, di)),
                           ("Braw", Braw, (R, L, NGN)), ("Craw", Craw, (R, L, NGN)),
                           ("dt", dt, (R, L, H))):
        _require(t.device == xi.device, f"{name} on {t.device}, xi on {xi.device}")
        _require(t.dtype == xi.dtype, f"{name} dtype {t.dtype} != xi dtype {xi.dtype}")
        _require(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name, t, shape in (("cxw", cxw, (di, K)), ("cxb", cxb, (di,)),
                           ("cbw", cbw, (NGN, K)), ("cbb", cbb, (NGN,)),
                           ("ccw", ccw, (NGN, K)), ("ccb", ccb, (NGN,)), ("nw", nw, (di,)),
                           ("A", A, (H,)), ("Dsk", Dsk, (H,)), ("dtb", dtb, (H,))):
        _require(t.device == xi.device, f"{name} on {t.device}, xi on {xi.device}")
        _require(t.is_floating_point(), f"{name} dtype {t.dtype} is not a float type")
        _require(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")

    def f32(t):  # float32, contiguous (the kernel rounds the taps to xi's dtype)
        return t.float().contiguous()

    taps = [f32(t) for t in (cxw, cxb, cbw, cbb, ccw, ccb)]
    nw32, A32, D32, dtb32 = (f32(t) for t in (nw, A, Dsk, dtb))
    lib = _lib()
    kw32 = dict(dtype=torch.float32, device=xi.device)
    nc = L // SSD_TILE
    # the chunk states (fentry itself in the training variant); float32
    # scratch: the chunks' total decays, the gated y and its sums of squares;
    # SiLU of the B and C convs in xi's dtype
    fe = torch.empty((R, nc, d_state, di), **kw32)
    tot = torch.empty((R, nc, H), **kw32)
    u = torch.empty((R, L, di), **kw32)
    part = torch.empty((R, L, H, SSD_PARTS), **kw32)
    Ba, Ca = torch.empty_like(Braw), torch.empty_like(Craw)
    out = torch.empty_like(xi)
    res = ((torch.empty_like(xi), torch.empty_like(Braw), torch.empty_like(Craw),
            torch.empty_like(xi)) if emit_residuals else (None,) * 4)
    rc = lib.pc_mixer2_fwd(
        xi.data_ptr(), z.data_ptr(), Braw.data_ptr(), Craw.data_ptr(), dt.data_ptr(),
        *(t.data_ptr() for t in taps), nw32.data_ptr(), A32.data_ptr(), D32.data_ptr(),
        dtb32.data_ptr(),
        *(t.data_ptr() for t in (fe, tot, u, part, Ba, Ca, out)),
        *(t.data_ptr() if t is not None else None for t in res),
        R, L, H, NG, K, int(bool(reverse)), float(eps), int(xi.dtype == torch.bfloat16),
        torch.cuda.current_stream(xi.device).cuda_stream)
    cuda_build.check(lib, rc, "mamba2_mixer_interior")
    if emit_residuals:
        mamba2_mixer_interior.res_launches += 1
        accx, accB, accC, y = res
        return out, accx, accB, accC, fe, y
    mamba2_mixer_interior.launches += 1
    return out


mamba2_mixer_interior.launches = 0
mamba2_mixer_interior.res_launches = 0


class Mamba2InteriorFn(torch.autograd.Function):
    """:func:`mamba2_mixer_interior` with its gradient, the counterpart of
    JAX ``_interior``'s custom VJP (``pallas_mixer2.py:240-322``).

    Forward: K5's residual variant. Backward, as ``_interior_bwd``: the
    gated-RMS-norm adjoint in PyTorch (float32) from the saved pre-gate y;
    K6 in ``pre_silu`` mode on the saved accumulators, which gives the
    cotangents of the accumulators and dA, dD, dt_bias's from its outputs;
    the depthwise-conv transposes (``ops.conv.causal_conv1d_bwd``, float32
    master taps). On CPU tensors K5 and K6 run their plain versions.
    Arguments as :func:`mamba2_mixer_interior`, the keywords last and
    positional."""

    @staticmethod
    def forward(ctx, xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk, dtb,
                d_state, eps, chunk, reverse):
        acts = [t.contiguous() for t in (xi, z, Braw, Craw, dt)]
        weights = (cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk, dtb)
        out, *res = mamba2_mixer_interior(*acts, *weights, d_state=d_state, eps=eps,
                                          chunk=chunk, reverse=reverse, emit_residuals=True)
        ctx.save_for_backward(*acts, *weights, *res)
        ctx.cfg = (d_state, eps, chunk, reverse)
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors  # read once (checkpointing unpacks each tensor once)
        xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk, dtb = saved[:15]
        accx, accB, accC, fentry, y = saved[15:]
        N, eps, chunk, reverse = ctx.cfg
        R, L, di = xi.shape
        NG = Braw.shape[-1] // N

        # gated RMS norm: u = rmsnorm(y * silu(z)) * nw
        g = g.float()
        zf = z.float()
        sig = torch.sigmoid(zf)
        silu_z = zf * sig
        yf = y.float()
        v = yf * silu_z
        r = torch.rsqrt(v.square().mean(-1, keepdim=True) + eps)
        gnw = g * nw.float()
        dnw = (g * v * r).sum((0, 1))
        dv = r * gnw - v * r.pow(3) * (gnw * v).mean(-1, keepdim=True)
        dz = (dv * yf * (sig + silu_z * (1 - sig))).to(z.dtype)
        dy = (dv * silu_z).to(xi.dtype)

        # the SSD adjoint on the accumulators (SiLU and SiLU' in K6)
        dacc_x, dB, dC, ddt_raw, dmass, gx, dtp = ssd_dir_bwd(
            accx, dt, A, accB.reshape(R, L, NG, N), accC.reshape(R, L, NG, N), Dsk, dtb,
            fentry, dy, chunk, reverse, pre_silu=True)
        dA = torch.einsum("rlh,rlh->h", dmass, dtp)

        def conv_bwd(dacc, inp, w):
            return causal_conv1d_bwd(inp.float(), w.float(), dacc, anticausal=reverse)

        dxi, dcxw, dcxb = conv_bwd(dacc_x, xi, cxw)
        dBraw, dcbw, dcbb = conv_bwd(dB.reshape(R, L, -1), Braw, cbw)
        dCraw, dccw, dccb = conv_bwd(dC.reshape(R, L, -1), Craw, ccw)
        return (dxi.to(xi.dtype), dz, dBraw.to(Braw.dtype), dCraw.to(Craw.dtype),
                ddt_raw.to(dt.dtype), dcxw.to(cxw.dtype), dcxb.to(cxb.dtype),
                dcbw.to(cbw.dtype), dcbb.to(cbb.dtype), dccw.to(ccw.dtype), dccb.to(ccb.dtype),
                dnw.to(nw.dtype), dA.to(A.dtype), gx.sum((0, 1)).to(Dsk.dtype),
                ddt_raw.sum((0, 1)).to(dtb.dtype), None, None, None, None)


def mamba2_mixer_interior_train(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A,
                                Dsk, dtb, *, d_state: int, eps: float, chunk: int,
                                reverse: bool) -> torch.Tensor:
    """Differentiable :func:`mamba2_mixer_interior` (:class:`Mamba2InteriorFn`)."""
    return Mamba2InteriorFn.apply(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A,
                                  Dsk, dtb, d_state, eps, chunk, reverse)
