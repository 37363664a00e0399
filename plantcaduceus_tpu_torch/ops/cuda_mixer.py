"""K2: the Mamba-1 mixer interior as a hand-written CUDA kernel, and its
gradient.

Counterpart of ``plantcaduceus_tpu.ops.pallas_mixer``. The kernel is
``csrc/mixer_fwd.cu``: conv + bias + SiLU, x_proj to dt_lr/B/C, dt_proj +
softplus and K1's scan with the D-skip, for one direction; its training
variant (``emit_res``) also returns the residuals the backward needs, and
its ``fuse_in`` variant (``w_in=``) computes in_proj's x half inside the
kernel, so the [B, L, d_inner] xi never reaches device memory.
``mixer_fwd_plain`` is the plain PyTorch version of the same function.
:class:`BimambaMixerFn` is the differentiable bidirectional interior, JAX
``bimamba_mixer_fused`` with its custom VJP: K2-res forward, K3
(``ops.cuda_scan.scan_bwd``) per direction in the backward;
:func:`bimamba_mixer_fused_x` is JAX's ``bimamba_mixer_fused_x`` (the
in_proj fused).

The two directions' outputs are summed in their own dtype and the sum is
cast to float32 before the gate, as JAX does (``pallas_mixer.py:396``,
``:444-445``, ``:465``); in float32 that is the float32 sum.

``mixer_fwd`` takes the plain version for tensors on the CPU only. For
CUDA tensors it launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.conv import causal_conv1d, causal_conv1d_bwd
from plantcaduceus_tpu_torch.ops.cuda_scan import (KERNEL_DTYPES, KERNEL_STATES, MAX_ROWS,
                                                   scan_bwd)
from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK, scan_direction

MAX_PROJ = 128  # R + 2N: the widest register tiling of K2's x_proj
MAX_TAPS = 8
FUSE_IN_K = 16  # d_model must be a multiple of the in_proj products' depth (mma k16)
FUSE_IN_RES_MSG = "w_in fusion is inference-path only"  # pallas_mixer.py:223-224
SMEM_MAX = 232_448  # bytes of shared memory one block may take on an H100


def fuse_in_smem(d_model: int, d_state: int, dt_rank: int, bf16: bool = True):
    """Shared memory (bytes) a block of each of K2 ``fuse_in``'s two
    kernels takes, ``(conv_xproj, scan)``, as ``csrc/mixer_fwd.cu`` sizes
    it. bf16: the conv + x_proj block holds its x window (72 rows) and one
    pass's 32 w_in^T rows at ``d_model + 8`` elements a row; the scan block
    holds four rows' staged B | C | dt_lr chunks, the W_dt columns, its 128
    channels' w_in^T rows (resident) and four 32-step float32 xi tiles.
    float32 stages w_in^T in chunks of 64 of d_model, so its sizes do not
    grow with d_model."""
    J = dt_rank + 2 * d_state
    # xg^T [32][68] and the x_proj's W rows [32][64 or 128], float32
    conv = 4 * (32 * 68 + 32 * (64 if J <= 64 else MAX_PROJ))
    chunk_rows = 8 * J  # one 8-step chunk of dt_lr | B | C, float32
    if bf16:
        ld = d_model + 8
        return (conv + 4 * 71 * 40 + 2 * (72 + 32) * ld,
                4 * (4 * 2 * chunk_rows + dt_rank * 128) + 2 * 128 * ld + 4 * 4 * 32 * 136)
    return (conv + 4 * 71 * 32 + 4 * (32 + 80) * 68,
            4 * (2 * chunk_rows + dt_rank * 128 + 32 * 136 + 128 * 68))


def in_proj_f32(x: torch.Tensor, w_in: torch.Tensor) -> torch.Tensor:
    """in_proj's x half as the ``fuse_in`` kernel takes it: the product in
    x's dtype (``w_in`` cast to it, as JAX ``bimamba_mixer_fused_x`` casts
    it) with a float32 sum, kept in float32 (JAX's
    ``preferred_element_type=jnp.float32``; bf16 products are exact in
    float32)."""
    return x.float() @ w_in.to(x.dtype).float()


def mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias,
                    A, Dskip, reverse: bool = False, emit_res: bool = False,
                    w_in: Optional[torch.Tensor] = None):
    """Plain version of :func:`mixer_fwd`: same arguments, same results, all
    intermediates in float32."""
    if w_in is not None and emit_res:
        raise ValueError(FUSE_IN_RES_MSG)
    xf = in_proj_f32(xi, w_in) if w_in is not None else xi.float()
    acc = causal_conv1d(xf, conv_w.float(), conv_b.float(),
                        activation=None, anticausal=reverse)
    xg = F.silu(acc)
    dt_lr, Bm, Cm = xg @ w_dtlr.float(), xg @ w_B.float(), xg @ w_C.float()
    out = scan_direction(xg, dt_lr @ dt_proj_w.float(), A, Bm, Cm, Dskip, dt_bias,
                         reverse, HB_CHUNK if emit_res else None)
    if emit_res:
        return out[0].to(xi.dtype), acc.to(xi.dtype), dt_lr, Bm, Cm, out[1]
    return out.to(xi.dtype)


_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGS = [_P] * 12 + [_I] * 9 + [_P]
_FWD_X_ARGS = [_P] * 11 + [_I] * 9 + [_P]  # fuse_in: its own build unit


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"mixer_fwd: {msg}")


def mixer_fwd(xi: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
              w_dtlr: torch.Tensor, w_B: torch.Tensor, w_C: torch.Tensor,
              dt_proj_w: torch.Tensor, dt_bias: torch.Tensor, A: torch.Tensor,
              Dskip: torch.Tensor, reverse: bool = False, emit_res: bool = False,
              w_in: Optional[torch.Tensor] = None):
    """One direction of the mixer interior, the contract of JAX
    ``mixer_scan_fused``: xi [B, L, D] (float32 or bfloat16); conv_w [D, K],
    conv_b [D], w_dtlr [D, R], w_B/w_C [D, N], dt_proj_w [R, D], dt_bias
    [D], A [D, N] (negative), Dskip [D], all float32. ``reverse`` makes the
    conv anticausal and the scan run right to left. Returns y [B, L, D] in
    xi's dtype. With ``emit_res`` (the training variant, JAX
    ``emit_residuals``) returns ``(y, acc, dt_lr, B, C, hb)``: the pre-SiLU
    conv output in xi's dtype, the float32 x_proj outputs (views of one
    [B, L, R+2N] buffer) and the float32 chunk-entry states ``hb [B,
    ceil(L/HB_CHUNK), D, N]``. With ``w_in [d_model, D]`` (JAX's
    ``fuse_in``; inference only) the first argument is the block input ``x
    [B, L, d_model]`` (d_model a multiple of 16) and the kernel computes xi
    itself, in x's dtype with a float32 sum, kept in float32
    (:func:`in_proj_f32`); y comes in x's dtype. ``launches`` counts the
    inference variant, ``res_launches`` the training one, ``x_launches``
    the ``fuse_in`` one."""
    if w_in is not None and emit_res:
        raise ValueError(FUSE_IN_RES_MSG)
    if xi.device.type == "cpu":
        return mixer_fwd_plain(xi, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                               dt_bias, A, Dskip, reverse, emit_res, w_in)
    _require(xi.device.type == "cuda", f"tensors on {xi.device}; need cuda or cpu")
    Bn, L, D = xi.shape
    Dm = D
    if w_in is not None:
        Dm, D = w_in.shape
        _require(tuple(xi.shape[2:]) == (Dm,), f"x width {xi.shape[-1]} != w_in rows {Dm}")
        _require(w_in.device == xi.device, f"w_in on {w_in.device}, x on {xi.device}")
        _require(Dm % FUSE_IN_K == 0, f"d_model {Dm} is not a multiple of {FUSE_IN_K}")
        _require(xi.data_ptr() % 16 == 0, "x must be 16-byte aligned")
        smem = max(fuse_in_smem(Dm, w_B.shape[-1], w_dtlr.shape[-1], xi.dtype == torch.bfloat16))
        _require(smem <= SMEM_MAX, f"d_model {Dm} too wide for fuse_in: its blocks would take "
                                   f"{smem} bytes of shared memory, more than {SMEM_MAX}")
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

    # [D, 64] (R + 2N <= 64) or [D, 128], zero past R + 2N: the kernel's
    # register tiling of the x_proj reads whole 16-byte rows
    J = R + 2 * N
    wx = torch.zeros((D, 64 if J <= 64 else MAX_PROJ), dtype=torch.float32, device=xi.device)
    wx[:, :J] = torch.cat([w_dtlr, w_B, w_C], dim=1)
    dbc = torch.empty((Bn, L, R + 2 * N), dtype=torch.float32, device=xi.device)
    # fuse_in: w_in^T [D, d_model] in x's dtype (the products' operand
    # layout), the only extra buffer; no [B, L, D] tensor but y
    win_t = w_in.to(xi.dtype).t().contiguous() if w_in is not None else None
    y = torch.empty((Bn, L, D), dtype=xi.dtype, device=xi.device)
    acc = torch.empty_like(xi) if emit_res else None
    hb = (torch.empty((Bn, -(-L // HB_CHUNK), D, N), dtype=torch.float32, device=xi.device)
          if emit_res else None)
    head = (xi.data_ptr(), conv_w.data_ptr(), conv_b.data_ptr(), wx.data_ptr(),
            dt_proj_w.data_ptr(), dt_bias.data_ptr(), A.data_ptr(), Dskip.data_ptr(),
            dbc.data_ptr(), y.data_ptr())
    bf16, stream = int(xi.dtype == torch.bfloat16), torch.cuda.current_stream(xi.device).cuda_stream
    if w_in is not None:
        lib = cuda_build.bind("mixer_fwd_x", "pc_mixer_fwd_x", _FWD_X_ARGS)
        rc = lib.pc_mixer_fwd_x(*head, win_t.data_ptr(), Bn, L, D, N, R, K, int(reverse), bf16,
                                Dm, stream)
    else:
        lib = cuda_build.bind("mixer_fwd", "pc_mixer_fwd", _FWD_ARGS)
        rc = lib.pc_mixer_fwd(*head, acc.data_ptr() if emit_res else None,
                              hb.data_ptr() if emit_res else None, Bn, L, D, N, R, K,
                              int(reverse), bf16, HB_CHUNK, stream)
    cuda_build.check(lib, rc, "mixer_fwd")
    if emit_res:
        mixer_fwd.res_launches += 1
        return y, acc, dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:], hb
    if w_in is not None:
        mixer_fwd.x_launches += 1
    else:
        mixer_fwd.launches += 1
    return y


mixer_fwd.launches = 0
mixer_fwd.res_launches = 0
mixer_fwd.x_launches = 0


def _sum_gate(ys, z, dtype):
    """The two directions summed in their own dtype, then cast to float32
    and gated: ``(y_sum, (y_sum * silu(z)) in dtype)``."""
    y_sum = (ys[0] + ys[1]).float()
    return y_sum, (y_sum * F.silu(z.float())).to(dtype)


def bimamba_mixer_fused(xi, z, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                        dt_bias, A, Dskip, use_kernels: bool = True) -> torch.Tensor:
    """Tied-weight, ``add``-combined bidirectional interior:
    ``(y_fwd + y_rev) * silu(z)``, the sum in xi's dtype, cast to float32,
    gated and cast back, as JAX ``bimamba_mixer_fused``. Per-direction
    weights are stacked on a leading axis of 2. ``use_kernels=False`` runs
    the plain version on any device (for holding the kernel against it on
    the card)."""
    fn = mixer_fwd if use_kernels else mixer_fwd_plain
    ys = [fn(xi, conv_w[g], conv_b[g], w_dtlr[g], w_B[g], w_C[g], dt_proj_w[g],
             dt_bias[g], A[g], Dskip[g], reverse=(g == 1)) for g in range(2)]
    return _sum_gate(ys, z, xi.dtype)[1]


def bimamba_mixer_fused_x(x, z, w_in, conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w,
                          dt_bias, A, Dskip, use_kernels: bool = True) -> torch.Tensor:
    """:func:`bimamba_mixer_fused` with in_proj's x half fused into each
    direction's kernel (JAX ``bimamba_mixer_fused_x``,
    ``pallas_mixer.py:374-417``): ``x [B, L, d_model]`` and ``w_in
    [d_model, d_inner]`` instead of xi. Without a gradient to take, K2's
    ``fuse_in`` variant once per direction (the plain version on CPU
    tensors or with ``use_kernels=False``): xi is kept in float32 and
    never written to device memory. When a gradient is needed (grad
    enabled and an input requiring it) it does what JAX's VJP does: ``xi =
    x @ w_in`` in x's dtype, then :class:`BimambaMixerFn` (the plain
    version differentiated by autograd with ``use_kernels=False``), the
    in_proj adjoint chained on by autograd."""
    w = (conv_w, conv_b, w_dtlr, w_B, w_C, dt_proj_w, dt_bias, A, Dskip)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, z, w_in, *w)):
        xi = x @ w_in.to(x.dtype)
        if use_kernels:
            return bimamba_mixer(xi, z, *w)
        return bimamba_mixer_fused(xi, z, *w, use_kernels=False)
    fn = mixer_fwd if use_kernels else mixer_fwd_plain
    x = x.contiguous()
    ys = [fn(x, *(t[g] for t in w), reverse=(g == 1), w_in=w_in) for g in range(2)]
    return _sum_gate(ys, z, x.dtype)[1]


class BimambaMixerFn(torch.autograd.Function):
    """:func:`bimamba_mixer_fused` with its gradient, the counterpart of JAX
    ``bimamba_mixer_fused``'s custom VJP (``pallas_mixer.py:427-534``).

    Forward: K2's residual variant once per direction, ``y_sum`` (their sum
    in xi's dtype, cast to float32) and ``(y_sum * silu(z))`` cast to xi's
    dtype. Backward, as
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
        y_sum, out = _sum_gate([r[0] for r in res], z, xi.dtype)
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
