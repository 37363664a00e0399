"""K4 and K6: the SSD (Mamba-2) chunk scan and its adjoint as hand-written
CUDA kernels.

Counterpart of ``plantcaduceus_tpu.ops.pallas_ssd``. ``ssd_dir`` (K4) runs
``csrc/ssd_fwd.cu`` (device code in ``csrc/ssd_core.cuh``, which K5 shares)
on the flat contract of JAX ``ssd_dir``; with ``emit_fentry`` (the training
variant) it also returns the chunk-entry states. ``ssd_dir_bwd`` (K6) runs
``csrc/ssd_bwd.cu``, the adjoint of one direction, in plain or ``pre_silu``
mode. ``ssd_dir_plain`` and ``ssd_dir_bwd_plain`` (``ops/ssd_bwd.py``) are
the plain PyTorch versions of the same functions, and :class:`SsdDirFn`
ties them into autograd as JAX ``ssd_dir``'s custom VJP does.

The wrappers take the plain versions for tensors on the CPU only. For CUDA
tensors they launch the kernel or raise; they never fall back. The kernels
take the shapes of the ``*-ssd`` presets: head dim P = 128, state size
N = 128, chunk 128 dividing L, NG dividing H, float32 or bfloat16 (JAX
``pallas_ssd.supported``; where the JAX package falls back to XLA on other
shapes, the port raises).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.selective_scan import softplus
from plantcaduceus_tpu_torch.ops.ssd import chunk_scan, fit_chunk
from plantcaduceus_tpu_torch.ops.ssd_bwd import ssd_dir_bwd as ssd_dir_bwd_plain

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
SSD_TILE = 128       # P, N and the chunk (kSsdP, kSsdN, kSsdT in csrc/ssd_core.cuh)
MAX_ROWS = 65535     # grid.y


def ssd_dir_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk: int, reverse: bool,
                  emit_fentry: bool = False):
    """Plain version of :func:`ssd_dir`: same arguments, same results."""
    R, L, HP = x.shape
    H = dt.shape[-1]
    mm = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    xf = x.float().reshape(R, L, H, HP // H)
    dtp = softplus(dt.float() + dt_bias.float())
    y, fentry = chunk_scan(xf, dtp, A.float(), Bm.float(), Cm.float(), chunk, bool(reverse),
                           mm, emit_fentry=True)
    y = (y + Dskip.float()[:, None] * xf).reshape(R, L, HP).to(x.dtype)
    return (y, fentry) if emit_fentry else y


def check_kernel_shapes(what: str, L: Optional[int], H: int, P: int, NG: int, N: int,
                        chunk: int) -> None:
    """Raise ``ValueError`` unless K4, K5 and K6 take these shapes (the
    sequence length ``L`` too, unless it is None)."""
    T = chunk if L is None else fit_chunk(chunk, L)
    for name, v in (("head dim", P), ("d_state", N), ("chunk", T)):
        if v != SSD_TILE:
            raise ValueError(f"{what}: {name} {v} != {SSD_TILE}, the only size the "
                             "CUDA SSD kernels take (the *-ssd presets' shapes)")
    if NG < 1 or H % NG:
        raise ValueError(f"{what}: n_groups {NG} does not divide n_heads {H}")


_require, _lib = cuda_build.require, cuda_build.bind


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 9 + [_I] * 6 + [_P]
_BWD_ARGS = [_P] * 22 + [_I] * 7 + [_P]


def _check_ssd_args(what, x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, others=()):
    """Device, dtype, shape and contiguity checks shared by K4 and K6; each
    tensor of ``others`` (name, tensor, shape, dtype) is checked too.
    Returns (R, L, H, NG)."""
    _require(x.device.type == "cuda", what, f"tensors on {x.device}; need cuda or cpu")
    R, L, HP = x.shape
    H = dt.shape[-1]
    NG, N = Bm.shape[-2:]
    _require(HP % H == 0, what, f"x width {HP} is not a multiple of n_heads {H}")
    check_kernel_shapes(what, L, H, HP // H, NG, N, chunk)
    _require(x.dtype in KERNEL_DTYPES, what, f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    _require(0 < R <= MAX_ROWS, what, f"rows {R} outside 1..{MAX_ROWS}")
    for name, t, shape, dtype in (("x", x, (R, L, HP), x.dtype), ("dt", dt, (R, L, H), x.dtype),
                                  ("Bm", Bm, (R, L, NG, N), x.dtype),
                                  ("Cm", Cm, (R, L, NG, N), x.dtype),
                                  ("A", A, (H,), torch.float32),
                                  ("Dskip", Dskip, (H,), torch.float32),
                                  ("dt_bias", dt_bias, (H,), torch.float32), *others):
        _require(t.device == x.device, what, f"{name} on {t.device}, x on {x.device}")
        _require(t.dtype == dtype, what, f"{name} dtype {t.dtype} != {dtype}")
        _require(tuple(t.shape) == shape, what, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), what, f"{name} must be contiguous")
    return R, L, H, NG


def ssd_dir(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, Dskip: torch.Tensor, dt_bias: torch.Tensor, chunk: int,
            reverse: bool, emit_fentry: bool = False):
    """One SSD direction on flat tensors (JAX ``pallas_ssd.ssd_dir``): x [R,
    L, H*P], dt [R, L, H] raw (bias and softplus in the kernel), A/Dskip/
    dt_bias [H] float32, Bm/Cm [R, L, NG, N]; x, dt, Bm and Cm of one dtype.
    Returns y [R, L, H*P] in x's dtype; with ``emit_fentry`` (the training
    variant, JAX ``_ssd_pallas_one(emit_fentry=True)``) ``(y, fentry)``, the
    float32 state each chunk starts from, ``[R, L/128, N, H*P]`` by chunk
    index. ``launches`` counts the inference variant, ``fentry_launches``
    the training one."""
    if x.device.type == "cpu":
        return ssd_dir_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse, emit_fentry)
    R, L, H, NG = _check_ssd_args("ssd_dir", x, dt, A, Bm, Cm, Dskip, dt_bias, chunk)
    lib = _lib("ssd_fwd", "pc_ssd_fwd", _FWD_ARGS)
    y = torch.empty_like(x)
    fentry = (torch.empty((R, L // SSD_TILE, SSD_TILE, x.shape[-1]), dtype=torch.float32,
                          device=x.device) if emit_fentry else None)
    rc = lib.pc_ssd_fwd(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        A.data_ptr(), Dskip.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
                        fentry.data_ptr() if emit_fentry else None,
                        R, L, H, NG, int(bool(reverse)), int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "ssd_dir")
    if emit_fentry:
        ssd_dir.fentry_launches += 1
        return y, fentry
    ssd_dir.launches += 1
    return y


ssd_dir.launches = 0
ssd_dir.fentry_launches = 0


def ssd_dir_bwd(x, dt, A, Bm, Cm, Dskip, dt_bias, fentry, g, chunk: int, reverse: bool,
                pre_silu: bool = False):
    """The adjoint of :func:`ssd_dir` for one direction (K6, JAX
    ``pallas_ssd._ssd_dir_bwd_kernel_call``): the arguments of ``ssd_dir``
    (with ``pre_silu``, x, Bm and Cm are the fused mixer's pre-SiLU conv
    accumulators), the forward's ``fentry`` and the output's cotangent ``g``
    [R, L, H*P] in x's dtype. Returns ``(dx, dB, dC, ddt_raw, dmass)`` and,
    with ``pre_silu``, also ``(gx, dtp)``; all float32 (see
    ``ops/ssd_bwd.py``). ``launches`` counts the plain mode,
    ``pre_silu_launches`` the other."""
    if x.device.type == "cpu":
        return ssd_dir_bwd_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, fentry, g, chunk, reverse,
                                 pre_silu)
    R, L, HP = x.shape
    NG, N = Bm.shape[-2:]
    H = dt.shape[-1]
    _check_ssd_args(
        "ssd_dir_bwd", x, dt, A, Bm, Cm, Dskip, dt_bias, chunk,
        (("g", g, (R, L, HP), x.dtype),
         ("fentry", fentry, (R, L // SSD_TILE, N, HP), torch.float32)))
    lib = _lib("ssd_bwd", "pc_ssd_bwd", _BWD_ARGS)

    def f32(*shape):
        return torch.empty(shape, dtype=torch.float32, device=x.device)

    dx, dB, dC, ddt, dmass = f32(R, L, HP), f32(R, L, NG, N), f32(R, L, NG, N), f32(R, L, H), \
        f32(R, L, H)
    gx, dtp = (f32(R, L, H), f32(R, L, H)) if pre_silu else (None, None)
    # scratch: the per-head dB and dC, the cotangent state entering each
    # chunk (fentry's layout), each chunk's total decay and, with pre_silu,
    # SiLU of B and C
    dBh, dCh = f32(R, L, H, N), f32(R, L, H, N)
    rv, tot = f32(R, L // SSD_TILE, N, HP), f32(R, L // SSD_TILE, H)
    Ba, Ca = (f32(R, L, NG, N), f32(R, L, NG, N)) if pre_silu else (None, None)
    rc = lib.pc_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), g.data_ptr(),
        fentry.data_ptr(), A.data_ptr(), Dskip.data_ptr(), dt_bias.data_ptr(), dx.data_ptr(),
        dB.data_ptr(), dC.data_ptr(), ddt.data_ptr(), dmass.data_ptr(),
        gx.data_ptr() if pre_silu else None, dtp.data_ptr() if pre_silu else None,
        dBh.data_ptr(), dCh.data_ptr(), rv.data_ptr(), tot.data_ptr(),
        Ba.data_ptr() if pre_silu else None, Ca.data_ptr() if pre_silu else None, R, L, H, NG,
        int(bool(reverse)), int(bool(pre_silu)), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "ssd_dir_bwd")
    if pre_silu:
        ssd_dir_bwd.pre_silu_launches += 1
        return dx, dB, dC, ddt, dmass, gx, dtp
    ssd_dir_bwd.launches += 1
    return dx, dB, dC, ddt, dmass


ssd_dir_bwd.launches = 0
ssd_dir_bwd.pre_silu_launches = 0


class SsdDirFn(torch.autograd.Function):
    """:func:`ssd_dir` with its gradient, the counterpart of JAX ``ssd_dir``'s
    custom VJP (``pallas_ssd.py:259-287``): forward K4 with ``emit_fentry``,
    backward K6 in plain mode; dA = Σ dmass·dt', ddt_bias = Σ ddt_raw and
    dD = Σ g·x are reductions outside the kernel, as in JAX. On CPU tensors
    both run their plain versions. Arguments as :func:`ssd_dir`."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse):
        args = [t.contiguous() for t in (x, dt, A, Bm, Cm, Dskip, dt_bias)]
        y, fentry = ssd_dir(*args, chunk, reverse, emit_fentry=True)
        ctx.save_for_backward(*args, fentry)
        ctx.chunk, ctx.reverse = chunk, reverse
        return y

    @staticmethod
    def backward(ctx, gy):
        x, dt, A, Bm, Cm, Dskip, dt_bias, fentry = ctx.saved_tensors  # read once
        g = gy.to(x.dtype).contiguous()
        dx, dB, dC, ddt_raw, dmass = ssd_dir_bwd(x, dt, A, Bm, Cm, Dskip, dt_bias, fentry, g,
                                                 ctx.chunk, ctx.reverse)
        R, L, HP = x.shape
        H = dt.shape[-1]
        dtp = softplus(dt.float() + dt_bias.float())
        dA = torch.einsum("rlh,rlh->h", dmass, dtp)
        dD = (g.float() * x.float()).reshape(R, L, H, HP // H).sum((0, 1, 3))
        return (dx.to(x.dtype), ddt_raw.to(dt.dtype), dA.to(A.dtype), dB.to(Bm.dtype),
                dC.to(Cm.dtype), dD.to(Dskip.dtype), ddt_raw.sum((0, 1)).to(dt_bias.dtype),
                None, None)


def ssd_dir_train(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk: int, reverse: bool):
    """Differentiable :func:`ssd_dir` (:class:`SsdDirFn`)."""
    return SsdDirFn.apply(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse)
