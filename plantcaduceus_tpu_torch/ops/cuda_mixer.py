"""K2: the Mamba-1 mixer interior as a hand-written CUDA kernel, and its
gradient.

Counterpart of ``plantcaduceus_tpu.ops.pallas_mixer`` (the x-projection
given). The kernel is ``csrc/mixer_fwd.cu``: conv + bias + SiLU, x_proj to
dt_lr/B/C, dt_proj + softplus and K1's scan with the D-skip, for one
direction; its training variant (``emit_res``) also returns the residuals
the backward needs. ``mixer_fwd_plain`` is the plain PyTorch version of the
same function. :class:`BimambaMixerFn` is the differentiable bidirectional
interior, JAX ``bimamba_mixer_fused`` with its custom VJP: K2-res forward,
K3 (``ops.cuda_scan.scan_bwd``) per direction in the backward.

``mixer_fwd`` takes the plain version for tensors on the CPU only. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_bwd
from plantcaduceus_tpu_torch.ops.cuda_scan import (KERNEL_DTYPES, KERNEL_STATES, MAX_ROWS,
                                                   scan_bwd)
from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK, scan_direction

MAX_PROJ = 128  # R + 2N: x_proj outputs a block keeps in registers
MAX_TAPS = 8


def mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias,
                    A, Dskip, reverse: bool = False, emit_res: bool = False):
    """Plain version of :func:`mixer_fwd`: same arguments, same results, all
    intermediates in float32."""
    acc = causal_conv1d(xi.float(), conv_w.float(), conv_b.float(),
                        activation=None, anticausal=reverse)
    xg = F.silu(acc)
    dt_lr, Bm, Cm = xg @ w_dtlr.float(), xg @ w_B.float(), xg @ w_C.float()
    out = scan_direction(xg, dt_lr @ dt_proj_w.float(), A, Bm, Cm, Dskip, dt_bias,
                         reverse, HB_CHUNK if emit_res else None)
    if emit_res:
        return out[0].to(xi.dtype), acc.to(xi.dtype), dt_lr, Bm, Cm, out[1]
    return out.to(xi.dtype)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("mixer_fwd")
    if lib.pc_mixer_fwd.argtypes is None:
        lib.pc_mixer_fwd.restype = ctypes.c_int
        lib.pc_mixer_fwd.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    return lib


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fwd: {msg}")


def mixer_fwd(xi: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
              w_dtlr: torch.Tensor, w_B: torch.Tensor, w_C: torch.Tensor,
              dt_proj_w: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor,
              Dskip: torch.Tensor, reverse: bool = False, emit_res: bool = False):
    """One direction of the mixer interior, the contract of JAX
    ``mixer_scan_fused``: xi [B, L, D] (float32 or bfloat16); conv_w [D, K],
    conv_b [D], w_dtlr [D, R], w_B/w_C [D, N], dt_proj_w [R, D], dt_bias
    [D], A [D, N] (negative), Dskip [D], all float32. ``reverse`` makes the
    conv anticausal and the scan run right to left. Returns y [B, L, D] in
    xi's dtype. With ``emit_res`` (the training variant, JAX
    ``emit_residuals``) returns ``(y, acc, dt_lr, B, C, hb)``: the pre-SiLU
    conv output in xi's dtype, the float32 x_proj outputs (views of one
    [B, L, R+2N] buffer) and the float32 chunk-entry states ``hb [B,
    ceil(L/HB_CHUNK), D, N]``. ``launches`` counts the inference variant,
    ``res_launches`` the training one."""
    if xi.device.type == "cpu":
        return mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                               dt_bias, A, Dskip, reverse, emit_res)
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
    acc = torch.empty_like(xi) if emit_res else None
    hb = (torch.empty((Bn, -(-L // HB_CHUNK), D, N), dtype=torch.float32, device=xi.device)
          if emit_res else None)
    rc = lib.pc_mixer_fwd(
        xi.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), wx.data_ptr(),
        dt_proj_w.data_ptr(), dt_bias.data_ptr(), A.data_ptr(), Dskip.data_ptr(),
        xg.data_ptr(), dbc.data_ptr(), y.data_ptr(),
        acc.data_ptr() if emit_res else None, hb.data_ptr() if emit_res else None,
        Bn, L, D, N, R, K, int(reverse), int(xi.dtype == torch.bfloat16), HB_CHUNK,
        torch.cuda.current_stream(xi.device).cuda_stream)
    cuda_build.check(lib, rc, "mixer_fwd")
    if emit_res:
        mixer_fwd.res_launches += 1
        return y, acc, dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:], hb
    mixer_fwd.launches += 1
    return y


mixer_fwd.launches = 0
mixer_fwd.res_launches = 0


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


class BimambaMixerFn(torch.autograd.Function):
    """:func:`bimamba_mixer_fused` with its gradient, the counterpart of JAX
    ``bimamba_mixer_fused``'s custom VJP (``pallas_mixer.py:427-534``).

    Forward: K2's residual variant once per direction, the float32 sum
    ``y_sum`` and ``(y_sum * silu(z))`` cast to xi's dtype. Backward, as
    ``_bimamba_mixer_bwd``: dz and the scan cotangent ``gy * silu(z)``; per
    direction ``xg = silu(acc)`` in xi's dtype and K3 with the dt projection
    fused; the x_proj transposes as matrix products; the SiLU' and
    depthwise-conv transposes (causal for direction 0, anticausal for 1).
    On CPU tensors K2 and K3 run their plain versions. Inputs: xi, z [B, L,
    D]; conv_w [2, D, K], conv_b [2, D], w_dtlr [2, D, R], w_B, w_C [2, D,
    N], dt_proj_w [2, R, D], dt_bias [2, D], A [2, D, N], Dskip [2, D]."""

    @staticmethod
    def forward(ctx, xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias, A, Dskip):
        xi = xi.contiguous()
        w = [t.contiguous() for t in (conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                                      dt_bias, A, Dskip)]
        res = [mixer_fwd(xi, *(t[g] for t in w), reverse=(g == 1), emit_res=True)
               for g in range(2)]
        y_sum = res[0][0].float() + res[1][0].float()
        out = (y_sum * F.silu(z.float())).to(xi.dtype)
        ctx.save_for_backward(xi, z, *w, y_sum, *res[0][1:], *res[1][1:])
        return out

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors  # read once (checkpointing unpacks each tensor once)
        xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias, A, Dskip, y_sum = saved[:12]
        res = (saved[12:17], saved[17:22])
        gy = gy.float()
        zf = z.float()
        sig = torch.sigmoid(zf)
        silu = zf * sig
        dz = (gy * y_sum * (sig + silu * (1 - sig))).to(z.dtype)
        gy_scan = (gy * silu).to(xi.dtype)
        dxi = torch.zeros(xi.shape, dtype=torch.float32, device=xi.device)
        grads = []
        for g in range(2):
            acc, dt_lr, Bm, Cm, hb = res[g]
            accf = acc.float()
            sig_a = torch.sigmoid(accf)
            xg = (accf * sig_a).to(xi.dtype)
            dxg, ddtlr, dB, dC, dA, ddtb, dD, dWdt = scan_bwd(
                xg, gy_scan, dt_lr, A[g], Bm, Cm, Dskip[g], dt_bias[g], hb,
                dt_proj_w[g], reverse=(g == 1))
            xgf = xg.float().flatten(0, 1)                       # [B*L, D]
            dxg = (dxg + ddtlr @ w_dtlr[g].T + dB @ w_B[g].T + dC @ w_C[g].T)
            dw_dtlr = xgf.T @ ddtlr.flatten(0, 1)
            dw_B = xgf.T @ dB.flatten(0, 1)
            dw_C = xgf.T @ dC.flatten(0, 1)
            dacc = dxg * (sig_a * (1 + accf * (1 - sig_a)))
            dxi_g, dcw, dcb = causal_conv1d_bwd(xi, conv_w[g], dacc, anticausal=(g == 1))
            dxi += dxi_g
            grads.append((dcw, dcb, dw_dtlr, dw_B, dw_C, dWdt, ddtb, dA, dD))
        stacked = [torch.stack([grads[0][i], grads[1][i]]) for i in range(9)]
        return (dxi.to(xi.dtype), dz, *stacked)


def bimamba_mixer(xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias, A, Dskip):
    """Differentiable :func:`bimamba_mixer_fused` (:class:`BimambaMixerFn`)."""
    return BimambaMixerFn.apply(xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                                dt_bias, A, Dskip)
