"""K4: the SSD (Mamba-2) chunk scan as a hand-written CUDA kernel.

Counterpart of ``plantcaduceus_tpu.ops.pallas_ssd`` (forward). ``ssd_dir``
runs ``csrc/ssd_fwd.cu`` (device code in ``csrc/ssd_core.cuh``, which K5
shares) on the flat contract of JAX ``ssd_dir``; ``ssd_dir_plain`` is the
plain PyTorch version of the same function (JAX ``ssd_dir_xla``).

``ssd_dir`` takes the plain version for tensors on the CPU only. For CUDA
tensors it launches the kernel or raises; it never falls back. The kernel
takes the shapes of the ``*-ssd`` presets: head dim P = 128, state size
N = 128, chunk 128 dividing L, NG dividing H, float32 or bfloat16 (JAX
``pallas_ssd.supported``; where the JAX package falls back to XLA on other
shapes, the port raises).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.ssd import fit_chunk, ssd_chunked

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
SSD_TILE = 128       # P, N and the chunk (kSsdP, kSsdN, kSsdT in csrc/ssd_core.cuh)
MAX_ROWS = 65535     # grid.y


def ssd_dir_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk: int, reverse: bool):
    """Plain version of :func:`ssd_dir`: same arguments, same result."""
    R, L, HP = x.shape
    H = dt.shape[-1]
    y = ssd_chunked(x.reshape(1, R, L, H, HP // H), dt[None], A[None], Bm[None], Cm[None],
                    Dskip[None], dt_bias=dt_bias[None], chunk=chunk,
                    directions=(bool(reverse),))
    return y.reshape(R, L, HP)


def check_kernel_shapes(what: str, L: Optional[int], H: int, P: int, NG: int, N: int,
                        chunk: int) -> None:
    """Raise ``ValueError`` unless K4/K5 take these shapes (the sequence
    length ``L`` too, unless it is None)."""
    T = chunk if L is None else fit_chunk(chunk, L)
    for name, v in (("head dim", P), ("d_state", N), ("chunk", T)):
        if v != SSD_TILE:
            raise ValueError(f"{what}: {name} {v} != {SSD_TILE}, the only size the "
                             "CUDA SSD kernels take (the *-ssd presets' shapes)")
    if NG < 1 or H % NG:
        raise ValueError(f"{what}: n_groups {NG} does not divide n_heads {H}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssd_dir: {msg}")


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("ssd_fwd")
    if lib.pc_ssd_fwd.argtypes is None:
        lib.pc_ssd_fwd.restype = ctypes.c_int
        lib.pc_ssd_fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def ssd_dir(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
            Cm: torch.Tensor, Dskip: torch.Tensor, dt_bias: torch.Tensor, chunk: int,
            reverse: bool) -> torch.Tensor:
    """One SSD direction on flat tensors (JAX ``pallas_ssd.ssd_dir``): x [R,
    L, H*P], dt [R, L, H] raw (bias and softplus in the kernel), A/Dskip/
    dt_bias [H] float32, Bm/Cm [R, L, NG, N]; x, dt, Bm and Cm of one dtype.
    Returns y [R, L, H*P] in x's dtype. ``launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return ssd_dir_plain(x, dt, A, Bm, Cm, Dskip, dt_bias, chunk, reverse)
    _require(x.device.type == "cuda", f"tensors on {x.device}; need cuda or cpu")
    R, L, HP = x.shape
    H = dt.shape[-1]
    NG, N = Bm.shape[-2:]
    _require(HP % H == 0, f"x width {HP} is not a multiple of n_heads {H}")
    check_kernel_shapes("ssd_dir", L, H, HP // H, NG, N, chunk)
    _require(x.dtype in KERNEL_DTYPES, f"x dtype {x.dtype} not in {KERNEL_DTYPES}")
    _require(0 < R <= MAX_ROWS, f"rows {R} outside 1..{MAX_ROWS}")
    for name, t, shape in (("x", x, (R, L, HP)), ("dt", dt, (R, L, H)),
                           ("Bm", Bm, (R, L, NG, N)), ("Cm", Cm, (R, L, NG, N))):
        _require(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _require(t.dtype == x.dtype, f"{name} dtype {t.dtype} != x dtype {x.dtype}")
        _require(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("A", A), ("Dskip", Dskip), ("dt_bias", dt_bias)):
        _require(t.device == x.device, f"{name} on {t.device}, x on {x.device}")
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(tuple(t.shape) == (H,), f"{name} shape {tuple(t.shape)} != {(H,)}")
        _require(t.is_contiguous(), f"{name} must be contiguous")

    lib = _lib()
    y = torch.empty_like(x)
    rc = lib.pc_ssd_fwd(x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                        A.data_ptr(), Dskip.data_ptr(), dt_bias.data_ptr(), y.data_ptr(),
                        R, L, H, NG, int(bool(reverse)), int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(lib, rc, "ssd_dir")
    ssd_dir.launches += 1
    return y


ssd_dir.launches = 0
