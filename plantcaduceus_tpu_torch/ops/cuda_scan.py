"""K1: the selective-scan forward as a hand-written CUDA kernel.

Counterpart of ``plantcaduceus_tpu.ops.pallas_scan`` (forward only). The
kernel is ``csrc/scan_fwd.cu`` (device code in ``csrc/scan_core.cuh``);
``scan_fwd_plain`` is the plain PyTorch version of the same function.

``scan_fwd`` takes the plain version for tensors on the CPU only. For CUDA
tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.selective_scan import scan_direction

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_STATES = (4, 8, 16, 32)
MAX_ROWS = 65535  # grid.y


def scan_fwd_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w=None,
                   reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`scan_fwd`: same arguments, same result."""
    if dt_proj_w is not None:
        dt = dt.float() @ dt_proj_w.float()
    return scan_direction(x, dt, A, Bm, Cm, Dskip, dt_bias, reverse).to(x.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("scan_fwd")
    if lib.pc_scan_fwd.argtypes is None:
        lib.pc_scan_fwd.restype = ctypes.c_int
        lib.pc_scan_fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"scan_fwd: {msg}")


def scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, Dskip: torch.Tensor,
             dt_bias: torch.Tensor, dt_proj_w: Optional[torch.Tensor] = None,
             reverse: bool = False) -> torch.Tensor:
    """One scan direction over rows.

    x: [rows, L, D]; dt: [rows, L, D], or the low-rank ``dt_lr [rows, L, R]``
    when ``dt_proj_w [R, D]`` is given (then projected up inside the
    kernel); Bm, Cm: [rows, L, N]; A: [D, N] (negative); Dskip, dt_bias: [D].
    x, dt, Bm, Cm share one dtype (float32 or bfloat16); A, Dskip, dt_bias
    and dt_proj_w are float32. ``reverse`` scans from L-1 down to 0. Returns
    y [rows, L, D] in x's dtype.
    """
    if x.device.type == "cpu":
        return scan_fwd_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, dt_proj_w, reverse)
    _require(x.device.type == "cuda", f"tensors on {x.device}; need cuda or cpu")
    fuse = dt_proj_w is not None
    rows, L, D = x.shape
    N = A.shape[-1]
    R = dt_proj_w.shape[0] if fuse else D
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, Dskip=Dskip, dt_bias=dt_bias)
    if fuse:
        tensors["dt_proj_w"] = dt_proj_w
    for name, t in tensors.items():
        _require(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(x.dtype in KERNEL_DTYPES, f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    for name in ("dt", "Bm", "Cm"):
        _require(tensors[name].dtype == x.dtype, f"{name} dtype must match x ({x.dtype})")
    for name in ("A", "Dskip", "dt_bias") + (("dt_proj_w",) if fuse else ()):
        _require(tensors[name].dtype == torch.float32, f"{name} must be float32")
    _require(N in KERNEL_STATES, f"d_state {N} not in {KERNEL_STATES}")
    _require(0 < rows <= MAX_ROWS, f"rows {rows} outside 1..{MAX_ROWS}")
    _require(tuple(dt.shape) == (rows, L, R), f"dt shape {tuple(dt.shape)} != {(rows, L, R)}")
    for name in ("Bm", "Cm"):
        _require(tuple(tensors[name].shape) == (rows, L, N), f"{name} shape != {(rows, L, N)}")
    _require(tuple(A.shape) == (D, N), f"A shape {tuple(A.shape)} != {(D, N)}")
    _require(tuple(Dskip.shape) == (D,) and tuple(dt_bias.shape) == (D,),
             "Dskip and dt_bias must be [D]")
    if fuse:
        _require(tuple(dt_proj_w.shape) == (R, D), f"dt_proj_w shape != {(R, D)}")

    lib = _lib()
    y = torch.empty_like(x)
    rc = lib.pc_scan_fwd(
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
        Dskip.data_ptr(), dt_bias.data_ptr(), dt_proj_w.data_ptr() if fuse else None,
        y.data_ptr(), rows, L, D, N, R if fuse else 0, int(fuse), int(reverse),
        int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "scan_fwd")
    scan_fwd.launches += 1
    return y


scan_fwd.launches = 0

