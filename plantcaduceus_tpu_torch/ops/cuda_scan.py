"""K1 and K3: the selective scan and its backward as hand-written CUDA kernels.

Counterpart of ``plantcaduceus_tpu.ops.pallas_scan``. K1 (``scan_fwd``,
``csrc/scan_fwd.cu``, device code in ``csrc/scan_core.cuh``) is the forward;
with ``hb_chunk`` it also emits the chunk-entry states the backward needs.
K3 (``scan_bwd``, ``csrc/scan_bwd.cu``) is the adjoint of one direction.
``scan_fwd_plain`` and ``scan_bwd_plain`` are the plain PyTorch versions of
the same functions, and :class:`SelectiveScanFn` ties them into autograd as
JAX's ``_scan_op`` custom VJP does.

The wrappers take the plain versions for tensors on the CPU only. For CUDA
tensors they launch the kernel or raise; they never fall back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.selective_scan import (HB_CHUNK, scan_direction,
                                                         scan_direction_bwd)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_STATES = (4, 8, 16, 32)
MAX_ROWS = 65535  # grid.y
BWD_THREADS = 512  # threads per block of K3, one a (channel, state) (kBwdThreads, scan_bwd.cu)
MAX_HB_CHUNK = 16   # steps a K3 lane keeps in registers (kMaxHbChunk, scan_bwd.cu)


def scan_fwd_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w=None,
                   reverse: bool = False, hb_chunk: Optional[int] = None):
    """Plain version of :func:`scan_fwd`: same arguments, same result."""
    if dt_proj_w is not None:
        dt = dt.float() @ dt_proj_w.float()
    out = scan_direction(x, dt, A, Bm, Cm, Dskip, dt_bias, reverse, hb_chunk)
    if hb_chunk:
        return out[0].to(x.dtype), out[1]
    return out.to(x.dtype)


# Plain version of :func:`scan_bwd`: same arguments, same results.
scan_bwd_plain = scan_direction_bwd


_require, _lib = cuda_build.require, cuda_build.bind
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGS = [_P] * 10 + [_I] * 9 + [_P]
_BWD_ARGS = [_P] * 16 + [_I] * 8 + [_LL] * 4 + [_I] * 2 + [_P]


def _check_scan_args(what, x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, others=()):
    """Device, dtype and shape checks shared by K1 and K3. x (and each tensor
    of ``others``, e.g. gy) must be contiguous; dt, Bm and Cm may be strided
    views whose last axis is contiguous, with Bm and Cm sharing strides."""
    _require(x.device.type == "cuda", what, f"tensors on {x.device}; need cuda or cpu")
    fuse = dt_proj_w is not None
    rows, L, D = x.shape
    N = A.shape[-1]
    R = dt_proj_w.shape[0] if fuse else D
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, Dskip=Dskip, dt_bias=dt_bias,
                   **{f"in{i}": t for i, t in enumerate(others)})
    if fuse:
        tensors["dt_proj_w"] = dt_proj_w
    for name, t in tensors.items():
        _require(t.device == x.device, what, f"{name} on {t.device}, x on {x.device}")
    for name in ("x", "A", "Dskip", "dt_bias") + tuple(
            f"in{i}" for i in range(len(others))) + (("dt_proj_w",) if fuse else ()):
        _require(tensors[name].is_contiguous(), what, f"{name} must be contiguous")
    for name in ("dt", "Bm", "Cm"):
        t = tensors[name]
        _require(t.stride(-1) == 1, what, f"{name} must be contiguous in its last axis")
    _require(Bm.stride() == Cm.stride(), what, "Bm and Cm must share strides")
    _require(x.dtype in KERNEL_DTYPES, what, f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    for t in others:
        _require(t.dtype == x.dtype and t.shape == x.shape, what,
                 "gy must match x in dtype and shape")
    _require(dt.dtype in KERNEL_DTYPES and Bm.dtype == dt.dtype == Cm.dtype, what,
             "dt, Bm and Cm must share one dtype (float32 or bfloat16)")
    for name in ("A", "Dskip", "dt_bias") + (("dt_proj_w",) if fuse else ()):
        _require(tensors[name].dtype == torch.float32, what, f"{name} must be float32")
    _require(N in KERNEL_STATES, what, f"d_state {N} not in {KERNEL_STATES}")
    _require(0 < rows <= MAX_ROWS, what, f"rows {rows} outside 1..{MAX_ROWS}")
    _require(tuple(dt.shape) == (rows, L, R), what, f"dt shape {tuple(dt.shape)} != {(rows, L, R)}")
    for name in ("Bm", "Cm"):
        _require(tuple(tensors[name].shape) == (rows, L, N), what, f"{name} shape != {(rows, L, N)}")
    _require(tuple(A.shape) == (D, N), what, f"A shape {tuple(A.shape)} != {(D, N)}")
    _require(tuple(Dskip.shape) == (D,) and tuple(dt_bias.shape) == (D,), what,
             "Dskip and dt_bias must be [D]")
    if fuse:
        _require(tuple(dt_proj_w.shape) == (R, D), what, f"dt_proj_w shape != {(R, D)}")
    return fuse, rows, L, D, N, R


def scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, Dskip: torch.Tensor,
             dt_bias: torch.Tensor, dt_proj_w: Optional[torch.Tensor] = None,
             reverse: bool = False, hb_chunk: Optional[int] = None):
    """One scan direction over rows (K1).

    x: [rows, L, D]; dt: [rows, L, D], or the low-rank ``dt_lr [rows, L, R]``
    when ``dt_proj_w [R, D]`` is given (then projected up inside the
    kernel); Bm, Cm: [rows, L, N]; A: [D, N] (negative); Dskip, dt_bias: [D].
    x, dt, Bm, Cm share one dtype (float32 or bfloat16); A, Dskip, dt_bias
    and dt_proj_w are float32. ``reverse`` scans from L-1 down to 0. Returns
    y [rows, L, D] in x's dtype; with ``hb_chunk`` the training variant also
    returns the float32 chunk-entry states ``hb [rows, ceil(L/hb_chunk), D,
    N]`` in processing order (``launches`` counts the inference variant,
    ``hb_launches`` the training one)."""
    if x.device.type == "cpu":
        return scan_fwd_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse, hb_chunk)
    fuse, rows, L, D, N, R = _check_scan_args("scan_fwd", x, dt, A, Bm, Cm, Dskip,
                                              dt_bias, dt_proj_w)
    _require(dt.is_contiguous() and Bm.is_contiguous() and Cm.is_contiguous(), "scan_fwd",
             "dt, Bm and Cm must be contiguous")
    lib = _lib("scan_fwd", "pc_scan_fwd", _FWD_ARGS)
    y = torch.empty_like(x)
    hb = (torch.empty((rows, -(-L // hb_chunk), D, N), dtype=torch.float32, device=x.device)
          if hb_chunk else None)
    rc = lib.pc_scan_fwd(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
        Dskip.data_ptr(), dt_bias.data_ptr(), dt_proj_w.data_ptr() if fuse else None,
        y.data_ptr(), hb.data_ptr() if hb_chunk else None, rows, L, D, N,
        R if fuse else 0, int(fuse), int(reverse), int(x.dtype == torch.bfloat16),
        hb_chunk or 0, torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "scan_fwd")
    if hb_chunk:
        scan_fwd.hb_launches += 1
        return y, hb
    scan_fwd.launches += 1
    return y


scan_fwd.launches = 0
scan_fwd.hb_launches = 0


def scan_bwd(x: torch.Tensor, gy: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, Dskip: torch.Tensor,
             dt_bias: torch.Tensor, hb: torch.Tensor,
             dt_proj_w: Optional[torch.Tensor] = None, reverse: bool = False,
             hb_chunk: int = HB_CHUNK):
    """Adjoint of one scan direction (K3), the counterpart of JAX
    ``_pallas_bwd_group``. Inputs as :func:`scan_fwd`, plus the cotangent
    ``gy`` (x's dtype and shape) and the forward's ``hb``. dt, Bm and Cm may
    be views with a contiguous last axis (K2's fp32 dt_lr | B | C rows).
    Returns float32 ``(dx, ddt, dB, dC, dA, ddt_bias, dD, dW)``: ddt is the
    gradient of dt_lr ``[rows, L, R]`` when fused, else of dt ``[rows, L,
    D]``; dW is that of dt_proj_w ``[R, D]``, None when not fused."""
    if x.device.type == "cpu":
        return scan_bwd_plain(x, gy, dt, A, Bm, Cm, Dskip, dt_bias, hb, dt_proj_w,
                              reverse, hb_chunk)
    fuse, rows, L, D, N, R = _check_scan_args("scan_bwd", x, dt, A, Bm, Cm, Dskip,
                                              dt_bias, dt_proj_w, others=(gy,))
    _require(hb.device == x.device and hb.dtype == torch.float32 and hb.is_contiguous()
             and tuple(hb.shape) == (rows, -(-L // hb_chunk), D, N), "scan_bwd",
             f"hb must be contiguous float32 [rows, ceil(L/{hb_chunk}), D, N]")
    _require(1 <= hb_chunk <= MAX_HB_CHUNK, "scan_bwd",
             f"hb_chunk {hb_chunk} outside 1..{MAX_HB_CHUNK}")
    lib = _lib("scan_bwd", "pc_scan_bwd", _BWD_ARGS)
    Rk = R if fuse else 0
    J = Rk + 2 * N
    P = D * N + 2 * D + Rk * D
    ntiles = -(-D // (BWD_THREADS // N))
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((rows, L, D), **f32)
    ddt = None if fuse else torch.empty((rows, L, D), **f32)
    part_pos = torch.empty((ntiles, rows, L, J), **f32)
    part_run = torch.empty((rows, P), **f32)
    out_pos = torch.empty((rows, L, J), **f32)
    out_run = torch.empty((P,), **f32)
    rc = lib.pc_scan_bwd(
        x.data_ptr(), gy.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        A.data_ptr(), Dskip.data_ptr(), dt_bias.data_ptr(),
        dt_proj_w.data_ptr() if fuse else None, hb.data_ptr(), dx.data_ptr(),
        ddt.data_ptr() if ddt is not None else None, part_pos.data_ptr(),
        part_run.data_ptr(), out_pos.data_ptr(), out_run.data_ptr(), rows, L, D, N, Rk,
        int(fuse), int(reverse), hb_chunk, dt.stride(0), dt.stride(1), Bm.stride(0),
        Bm.stride(1), int(x.dtype == torch.bfloat16), int(dt.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "scan_bwd")
    scan_bwd.launches += 1
    dB, dC = out_pos[..., Rk:Rk + N], out_pos[..., Rk + N:]
    dA = out_run[:D * N].view(D, N)
    ddt_bias, dD = out_run[D * N:D * N + D], out_run[D * N + D:D * N + 2 * D]
    if fuse:
        return dx, out_pos[..., :Rk], dB, dC, dA, ddt_bias, dD, out_run[D * N + 2 * D:].view(Rk, D)
    return dx, ddt, dB, dC, dA, ddt_bias, dD, None


scan_bwd.launches = 0


class SelectiveScanFn(torch.autograd.Function):
    """One scan direction with its gradient: the counterpart of JAX
    ``_scan_op`` under differentiation (``pallas_scan.py:660-739``). The
    forward is K1 with ``hb`` (chunk ``HB_CHUNK``), the backward K3; on CPU
    tensors both run their plain versions. Arguments as :func:`scan_fwd`;
    dt is projected inside the kernels when ``dt_proj_w`` is given (G=2),
    and given at full width otherwise (G=1), as ``caduceus.py:556-567``.
    Gradients come back in each input's dtype; A, Dskip, dt_bias and
    dt_proj_w get float32 ones."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse):
        x, dt, Bm, Cm = (t.contiguous() for t in (x, dt, Bm, Cm))
        y, hb = scan_fwd(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse,
                         hb_chunk=HB_CHUNK)
        ctx.save_for_backward(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, hb)
        ctx.reverse = reverse
        return y

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, hb = ctx.saved_tensors
        dx, ddt, dB, dC, dA, ddtb, dD, dW = scan_bwd(
            x, gy.to(x.dtype).contiguous(), dt, A, Bm, Cm, Dskip, dt_bias, hb,
            dt_proj_w, ctx.reverse, HB_CHUNK)
        return (dx.to(x.dtype), ddt.to(dt.dtype), dA, dB.to(Bm.dtype), dC.to(Cm.dtype),
                dD, ddtb, dW, None)


def selective_scan(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w=None, reverse=False):
    """Differentiable one-direction scan (:class:`SelectiveScanFn`)."""
    return SelectiveScanFn.apply(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse)
