"""K5: the Mamba-2 mixer interior as a hand-written CUDA kernel.

Counterpart of ``plantcaduceus_tpu.ops.pallas_mixer2`` (forward).
``mamba2_mixer_interior`` runs ``csrc/mixer2_fwd.cu`` for one direction:
the depthwise convs of x, B and C with SiLU, K4's chunk core
(``csrc/ssd_core.cuh``) and the gated RMS norm; ``mamba2_mixer_interior_plain``
is the plain PyTorch version of the same function (JAX ``_interior_xla``),
computed in the kernel's types: conv taps and biases rounded to xi's dtype
and summed in float32, the SSD output y kept in float32, the norm in
float32.

``mamba2_mixer_interior`` takes the plain version for tensors on the CPU
only. For CUDA tensors it launches the kernel or raises; it never falls
back. Shapes as K4 (:func:`.cuda_ssd.check_kernel_shapes`).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d
from plantcaduceus_tpu_torch.ops.cuda_ssd import KERNEL_DTYPES, MAX_ROWS, check_kernel_shapes
from plantcaduceus_tpu_torch.ops.norms import rms_norm
from plantcaduceus_tpu_torch.ops.selective_scan import softplus
from plantcaduceus_tpu_torch.ops.ssd import chunk_scan, fit_chunk

MAX_TAPS = 8  # kMaxTaps in csrc/mixer2_fwd.cu
SSD_PARTS = 2  # partial sums of u^2 per (row, t, head): kSsdParts in csrc/ssd_core.cuh


def mamba2_mixer_interior_plain(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw,
                                A, Dsk, dtb, *, d_state: int, eps: float, chunk: int,
                                reverse: bool) -> torch.Tensor:
    """Plain version of :func:`mamba2_mixer_interior`: same arguments, same
    result."""
    R, L, di = xi.shape
    H = dt.shape[-1]
    NG = Braw.shape[-1] // d_state
    fit_chunk(chunk, L)
    mm = torch.bfloat16 if xi.dtype == torch.bfloat16 else torch.float32

    def conv(inp, w, b):
        return causal_conv1d(inp.float(), w.to(xi.dtype).float(), b.to(xi.dtype).float(),
                             activation="silu", anticausal=reverse)

    xc = conv(xi, cxw, cxb)
    Bc = conv(Braw, cbw, cbb).reshape(R, L, NG, d_state)
    Cc = conv(Craw, ccw, ccb).reshape(R, L, NG, d_state)
    dtp = softplus(dt.float() + dtb.float())
    y = chunk_scan(xc.reshape(R, L, H, di // H), dtp, A.float(), Bc, Cc, chunk, reverse, mm)
    y = (y + Dsk.float()[:, None] * xc.reshape(R, L, H, di // H)).reshape(R, L, di)
    return rms_norm(y * F.silu(z.float()), nw, eps).to(xi.dtype)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mamba2_mixer_interior: {msg}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mixer2_fwd")
    if lib.pc_mixer2_fwd.argtypes is None:
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.pc_mixer2_fwd.restype = I
        lib.pc_mixer2_fwd.argtypes = [P] * 21 + [I] * 6 + [ctypes.c_float, I, P]
    return lib


def mamba2_mixer_interior(xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk,
                          dtb, *, d_state: int, eps: float, chunk: int,
                          reverse: bool) -> torch.Tensor:
    """One direction of the Mamba-2 mixer interior (JAX
    ``pallas_mixer2.mamba2_mixer_interior``, forward): xi, z [R, L, di];
    Braw, Craw [R, L, NG*N]; dt [R, L, H] raw; all of one dtype (float32 or
    bfloat16). cxw [di, K], cxb [di], cbw/ccw [NG*N, K], cbb/ccb [NG*N]: conv
    taps (tap K-1 = the current step) and biases, any float dtype, rounded
    to xi's dtype; nw [di] the gated-norm weight; A, Dsk, dtb [H] float32.
    ``reverse`` makes the convs anticausal and the scan run right to left.
    Returns u [R, L, di] in xi's dtype: everything up to the out_proj.
    ``launches`` counts kernel launches."""
    if xi.device.type == "cpu":
        return mamba2_mixer_interior_plain(
            xi, z, Braw, Craw, dt, cxw, cxb, cbw, cbb, ccw, ccb, nw, A, Dsk, dtb,
            d_state=d_state, eps=eps, chunk=chunk, reverse=reverse)
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

    def f32(t, rounded=False):  # float32, contiguous; taps rounded to xi's dtype first
        return (t.to(xi.dtype) if rounded else t).float().contiguous()

    taps = [f32(t, rounded=True) for t in (cxw, cxb, cbw, cbb, ccw, ccb)]
    nw32, A32, D32, dtb32 = (f32(t) for t in (nw, A, Dsk, dtb))
    lib = _lib()
    # float32 scratch: the conv outputs, the gated y and the partial sums of u^2
    xc, u = (torch.empty((R, L, di), dtype=torch.float32, device=xi.device) for _ in range(2))
    Bc, Cc = (torch.empty((R, L, NGN), dtype=torch.float32, device=xi.device) for _ in range(2))
    part = torch.empty((R, L, H, SSD_PARTS), dtype=torch.float32, device=xi.device)
    out = torch.empty_like(xi)
    rc = lib.pc_mixer2_fwd(
        xi.data_ptr(), z.data_ptr(), Braw.data_ptr(), Craw.data_ptr(), dt.data_ptr(),
        *(t.data_ptr() for t in taps), nw32.data_ptr(), A32.data_ptr(), D32.data_ptr(),
        dtb32.data_ptr(), xc.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), u.data_ptr(),
        part.data_ptr(), out.data_ptr(),
        R, L, H, NG, K, int(bool(reverse)), float(eps), int(xi.dtype == torch.bfloat16),
        torch.cuda.current_stream(xi.device).cuda_stream)
    cuda_build.check(lib, rc, "mamba2_mixer_interior")
    mamba2_mixer_interior.launches += 1
    return out


mamba2_mixer_interior.launches = 0
