"""K2: the Mamba-1 mixer interior as a hand-written CUDA kernel.

Counterpart of ``plantcaduceus_tpu.ops.pallas_mixer`` (forward only, the
x-projection given). The kernel is ``csrc/mixer_fwd.cu``:
conv + bias + SiLU, x_proj to dt_lr/B/C, dt_proj + softplus and K1's scan
with the D-skip, for one direction. ``mixer_fwd_plain`` is the plain
PyTorch version of the same function.

``mixer_fwd`` takes the plain version for tensors on the CPU only. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d
from plantcaduceus_tpu_torch.ops.cuda_scan import KERNEL_DTYPES, KERNEL_STATES, MAX_ROWS
from plantcaduceus_tpu_torch.ops.selective_scan import scan_direction

MAX_PROJ = 128  # R + 2N: x_proj outputs a block keeps in registers
MAX_TAPS = 8


def mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias,
                    A, Dskip, reverse: bool = False) -> torch.Tensor:
    """Plain version of :func:`mixer_fwd`: same arguments, same result, all
    intermediates in float32."""
    xg = causal_conv1d(xi.float(), conv_w.float(), conv_b.float(),
                       activation="silu", anticausal=reverse)
    dt = (xg @ w_dtlr.float()) @ dt_proj_w.float()
    y = scan_direction(xg, dt, A, xg @ w_B.float(), xg @ w_C.float(),
                       Dskip, dt_bias, reverse)
    return y.to(xi.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mixer_fwd")
    if lib.pc_mixer_fwd.argtypes is None:
        lib.pc_mixer_fwd.restype = ctypes.c_int
        lib.pc_mixer_fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fwd: {msg}")


def mixer_fwd(xi: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
              w_dtlr: torch.Tensor, w_B: torch.Tensor, w_C: torch.Tensor,
              dt_proj_w: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor,
              Dskip: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """One direction of the mixer interior, the contract of JAX
    ``mixer_scan_fused``: xi [B, L, D] (float32 or bfloat16); conv_w [D, K],
    conv_b [D], w_dtlr [D, R], w_B/w_C [D, N], dt_proj_w [R, D], dt_bias
    [D], A [D, N] (negative), Dskip [D], all float32. ``reverse`` makes the
    conv anticausal and the scan run right to left. Returns y [B, L, D] in
    xi's dtype."""
    if xi.device.type == "cpu":
        return mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                               dt_bias, A, Dskip, reverse)
    _require(xi.device.type == "cuda", f"tensors on {xi.device}; need cuda or cpu")
    Bn, L, D = xi.shape
    K = conv_w.shape[-1]
    R, N = w_dtlr.shape[-1], w_B.shape[-1]
    weights = dict(conv_w=(conv_w, (D, K)), conv_b=(conv_b, (D,)),
                   w_dtlr=(w_dtlr, (D, R)), w_B=(w_B, (D, N)), w_C=(w_C, (D, N)),
                   dt_proj_w=(dt_proj_w, (R, D)), dt_bias=(dt_bias, (D,)),
                   A=(A, (D, N)), Dskip=(Dskip, (D,)))
    _require(xi.dtype in KERNEL_DTYPES, f"xi dtype {xi.dtype} not in {KERNEL_DTYPES}")
    _require(xi.is_contiguous(), "xi must be contiguous")
    for name, (t, shape) in weights.items():
        _require(t.device == xi.device, f"{name} on {t.device}, xi on {xi.device}")
        _require(t.dtype == torch.float32, f"{name} must be float32")
        _require(tuple(t.shape) == shape, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(N in KERNEL_STATES, f"d_state {N} not in {KERNEL_STATES}")
    _require(R + 2 * N <= MAX_PROJ, f"dt_rank + 2*d_state = {R + 2 * N} > {MAX_PROJ}")
    _require(K <= MAX_TAPS, f"d_conv {K} > {MAX_TAPS}")
    _require(0 < Bn <= MAX_ROWS, f"rows {Bn} outside 1..{MAX_ROWS}")

    lib = _lib()
    wx = torch.cat([w_dtlr, w_B, w_C], dim=1).contiguous()          # [D, R+2N]
    xg = torch.empty((Bn, L, D), dtype=torch.float32, device=xi.device)
    dbc = torch.empty((Bn, L, R + 2 * N), dtype=torch.float32, device=xi.device)
    y = torch.empty_like(xi)
    rc = lib.pc_mixer_fwd(
        xi.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), wx.data_ptr(),
        dt_proj_w.data_ptr(), dt_bias.data_ptr(), A.data_ptr(), Dskip.data_ptr(),
        xg.data_ptr(), dbc.data_ptr(), y.data_ptr(), Bn, L, D, N, R, K,
        int(reverse), int(xi.dtype == torch.bfloat16),
        torch.cuda.current_stream(xi.device).cuda_stream)
    cuda_build.check(lib, rc, "mixer_fwd")
    mixer_fwd.launches += 1
    return y


mixer_fwd.launches = 0


def bimamba_mixer_fused(xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                        dt_bias, A, Dskip, use_kernels: bool = True) -> torch.Tensor:
    """Tied-weight, ``add``-combined bidirectional interior:
    ``(y_fwd + y_rev) * silu(z)``, summed and gated in float32 then cast,
    as JAX ``bimamba_mixer_fused``. Per-direction weights are stacked on a
    leading axis of 2. ``use_kernels=False`` runs the plain version on any
    device (for holding the kernel against it on the card)."""
    fn = mixer_fwd if use_kernels else mixer_fwd_plain
    ys = [fn(xi, conv_w[g], conv_b[g], w_dtlr[g], w_B[g], w_C[g], dt_proj_w[g],
             dt_bias[g], A[g], Dskip[g], reverse=(g == 1)) for g in range(2)]
    return ((ys[0].float() + ys[1].float()) * F.silu(z.float())).to(xi.dtype)
