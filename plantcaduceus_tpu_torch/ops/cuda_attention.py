"""K7 and K8: flash attention with a structured bias (ALiBi, local window,
causal) as hand-written CUDA kernels, forward and backward.

Counterpart of ``plantcaduceus_tpu.ops.pallas_attention``. ``flash_fwd``
(K7) runs ``csrc/attn_fwd.cu``, ``flash_bwd`` (K8) ``csrc/attn_bwd.cu``
(shared device code in ``csrc/attn_core.cuh``); ``flash_fwd_plain`` and
``flash_bwd_plain`` (``ops/flash_plain.py``) are the plain PyTorch versions
of the same functions, and :class:`FlashAttentionFn` ties them into
autograd as ``_flash``'s custom VJP does (``pallas_attention.py:295-318``).

The wrappers take the plain versions for tensors on the CPU only. For CUDA
tensors they launch the kernel or raise ``ValueError``; they never fall
back. The kernels take float32 or bfloat16, head dim 32, 64, 128 or a
multiple of 128 above it (the "wide" kernels, in 128-wide slices), and any
sequence length (the TPU kernel needs L tileable by 128; the card's kernel
masks the ragged last tile). q, k and v are read through their strides:
views of one fused qkv projection need no copy. :func:`flash_attention`
takes any head dim: it zero-pads q, k and v to the next kernel width (32,
64 or 128, and above 128 the next multiple of 128, as the TPU path's
``_pad_heads`` pads, ``pallas_attention.py:172-186``), which is exact.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from plantcaduceus_tpu_torch.ops import cuda_build
from plantcaduceus_tpu_torch.ops.flash_plain import (default_scale, flash_bwd_plain,
                                                     flash_fwd_plain)

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)  # and the multiples of WIDE_SLICE above them
WIDE_SLICE = 128
MAX_ROWS = 65535  # grid.y = B * H

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# B, L, H, hd, use_slopes, symmetric, causal, window; scale; bf16, stream
_TAIL = [_I] * 8 + [_F, _I, _P]
_FWD_ARGS = [_P] * 3 + [_LL] * 3 + [_P] * 3 + _TAIL
_BWD_ARGS = [_P] * 3 + [_LL] * 3 + [_P] * 8 + _TAIL


_require, _lib = cuda_build.require, cuda_build.bind


def _kernel_layout(t: torch.Tensor, ref: torch.Tensor) -> bool:
    """t has ref's strides, a unit last stride and 16-byte aligned rows (the
    kernels' 16-byte row loads)."""
    vec = 16 // t.element_size()
    return (t.stride() == ref.stride() and t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s in t.stride()[:3]))


def _check_args(what, q, k, v, slopes, window):
    """Device, dtype, shape, stride and alignment checks shared by K7 and K8.
    Returns (B, L, H, hd)."""
    _require(q.device.type == "cuda", what, f"tensors on {q.device}; need cuda or cpu")
    _require(q.dim() == 4, what, f"q must be [B, L, H, hd], got shape {tuple(q.shape)}")
    B, L, H, hd = q.shape
    _require(kernel_head_dim(hd), what,
             f"head dim {hd} not in {HEAD_DIMS} nor a multiple of {WIDE_SLICE} above them")
    _require(q.dtype in KERNEL_DTYPES, what, f"dtype {q.dtype} not in {KERNEL_DTYPES}")
    _require(0 < B * H <= MAX_ROWS and L > 0, what, f"B*H {B * H} outside 1..{MAX_ROWS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require(t.device == q.device, what, f"{name} on {t.device}, q on {q.device}")
        _require(t.dtype == q.dtype, what, f"{name} dtype {t.dtype} != {q.dtype}")
        _require(tuple(t.shape) == (B, L, H, hd), what,
                 f"{name} shape {tuple(t.shape)} != {(B, L, H, hd)}")
        _require(t.stride() == q.stride(), what,
                 f"{name} strides {t.stride()} != q's {q.stride()}")
        _require(_kernel_layout(t, q), what,
                 f"{name} rows must be unit-stride and 16-byte aligned")
    if slopes is not None:
        _require(slopes.device == q.device and slopes.dtype == torch.float32
                 and tuple(slopes.shape) == (H,) and slopes.is_contiguous(), what,
                 f"slopes must be contiguous float32 [{H}] on {q.device}")
    _require(window is None or int(window) >= 0, what, f"window {window} < 0")
    return B, L, H, hd


def kernel_head_dim(hd: int) -> bool:
    """Whether K7 and K8 take head dim ``hd`` as it is."""
    return hd in HEAD_DIMS or (hd > WIDE_SLICE and hd % WIDE_SLICE == 0)


def _count(fn, hd: int) -> None:
    if hd > WIDE_SLICE:
        fn.wide_launches += 1
    else:
        fn.launches += 1


def _check_contiguous(what, q, others):
    """Each of ``others`` (name, tensor, shape, dtype) on q's device and
    contiguous."""
    for name, t, shape, dtype in others:
        _require(t.device == q.device, what, f"{name} on {t.device}, q on {q.device}")
        _require(t.dtype == dtype, what, f"{name} dtype {t.dtype} != {dtype}")
        _require(tuple(t.shape) == shape, what, f"{name} shape {tuple(t.shape)} != {shape}")
        _require(t.is_contiguous(), what, f"{name} must be contiguous")


def _tail(q, B, L, H, hd, slopes, causal, window, symmetric, scale):
    return (B, L, H, hd, int(slopes is not None), int(bool(symmetric)), int(bool(causal)),
            -1 if window is None else int(window), default_scale(hd, scale),
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              slopes: Optional[torch.Tensor] = None, causal: bool = False,
              window: Optional[int] = None, symmetric: bool = True,
              scale: Optional[float] = None):
    """K7 (JAX ``pallas_attention._fwd``): q, k, v ``[B, L, H, hd]`` of one
    dtype and one set of strides; ``slopes`` ``[H]`` float32 for ALiBi
    (``-slope * |i - j|``, or ``(i - j)`` when not ``symmetric``);
    ``window`` keeps ``|i - j| <= window``; ``scale`` defaults to
    ``1/sqrt(hd)``. Returns ``(o [B, L, H, hd] contiguous in q's dtype, lse
    [B*H, L] float32)``. ``launches`` counts kernel launches at hd <= 128,
    ``wide_launches`` those above."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, slopes, causal, window, symmetric, scale)
    B, L, H, hd = _check_args("flash_fwd", q, k, v, slopes, window)
    lib = _lib("attn_fwd", "pc_attn_fwd", _FWD_ARGS)
    o = torch.empty((B, L, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B * H, L), dtype=torch.float32, device=q.device)
    rc = lib.pc_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
                         slopes.data_ptr() if slopes is not None else None, o.data_ptr(),
                         lse.data_ptr(), *_tail(q, B, L, H, hd, slopes, causal, window,
                                                 symmetric, scale))
    cuda_build.check(lib, rc, "flash_fwd")
    _count(flash_fwd, hd)
    return o, lse


flash_fwd.launches = 0
flash_fwd.wide_launches = 0


def flash_bwd(q, k, v, o, do, lse, slopes=None, causal: bool = False,
              window: Optional[int] = None, symmetric: bool = True,
              scale: Optional[float] = None):
    """K8 (JAX ``pallas_attention._bwd``): the gradients ``(dq, dk, dv)``,
    contiguous ``[B, L, H, hd]`` in the inputs' dtype, from q, k, v and the
    bias arguments as :func:`flash_fwd`, its ``o`` and ``lse`` and the
    cotangent ``do`` (contiguous, in q's dtype). ``launches`` counts kernel
    launches (one call: the dq kernel, which computes delta first, and the
    dk/dv kernel) at hd <= 128, ``wide_launches`` those above."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, do, lse, slopes, causal, window, symmetric, scale)
    B, L, H, hd = _check_args("flash_bwd", q, k, v, slopes, window)
    _check_contiguous("flash_bwd", q, (("o", o, (B, L, H, hd), q.dtype),
                                       ("do", do, (B, L, H, hd), q.dtype),
                                       ("lse", lse, (B * H, L), torch.float32)))
    lib = _lib("attn_bwd", "pc_attn_bwd", _BWD_ARGS)
    dq, dk, dv = (torch.empty((B, L, H, hd), dtype=q.dtype, device=q.device)
                  for _ in range(3))
    delta = torch.empty((B * H, L), dtype=torch.float32, device=q.device)  # scratch
    rc = lib.pc_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3],
                         slopes.data_ptr() if slopes is not None else None, o.data_ptr(),
                         do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                         dk.data_ptr(), dv.data_ptr(),
                         *_tail(q, B, L, H, hd, slopes, causal, window, symmetric, scale))
    cuda_build.check(lib, rc, "flash_bwd")
    _count(flash_bwd, hd)
    return dq, dk, dv


flash_bwd.launches = 0
flash_bwd.wide_launches = 0


def _fit(q, k, v):
    """q, k and v in one dtype (the widest: casts are exact) and, on the
    card, one set of kernel-ready strides (copies only where they differ)."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    q, k, v = (t.to(dt) for t in (q, k, v))
    if q.device.type == "cuda" and not all(_kernel_layout(t, q) for t in (q, k, v)):
        q, k, v = (t.contiguous() for t in (q, k, v))
    return q, k, v


class FlashAttentionFn(torch.autograd.Function):
    """:func:`flash_fwd` with its gradient, the counterpart of JAX
    ``_flash``'s custom VJP: forward K7 (saving q, k, v, o and lse),
    backward K8; the slopes are constants (no gradient, as JAX's zeros).
    On CPU tensors both run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, slopes, causal, window, symmetric, scale):
        o, lse = flash_fwd(q, k, v, slopes, causal, window, symmetric, scale)
        ctx.save_for_backward(q, k, v, o, lse, slopes)
        ctx.args = (causal, window, symmetric, scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, slopes = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, do.to(q.dtype).contiguous(), lse, slopes,
                               *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def padded_head_dim(hd: int) -> int:
    """The kernel width that head dim ``hd`` runs at: the next of
    :data:`HEAD_DIMS` up to 128, above it the next multiple of 128 (JAX
    ``pallas_attention._common``'s ``hd_pad``, ``:184``)."""
    for width in HEAD_DIMS:
        if hd <= width:
            return width
    return -(-hd // WIDE_SLICE) * WIDE_SLICE


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    alibi_slopes: Optional[torch.Tensor] = None, causal: bool = False,
                    local_window: Optional[int] = None, alibi_symmetric: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v ``[B, L, H, hd]`` -> ``[B, L, H, hd]`` (JAX
    ``pallas_attention.flash_attention``), differentiable in q, k and v.
    ``alibi_slopes`` ``[H]``: bias ``-slope * |i - j|`` (``(i - j)`` with
    ``alibi_symmetric=False``); ``local_window`` keeps ``|i - j| <=
    window``; ``sm_scale`` defaults to ``1/sqrt(hd)``. K7 and K8 on the
    card, their plain versions on the CPU. A head dim that the kernels do
    not take runs zero-padded to :func:`padded_head_dim`'s width, on every
    device (zero columns add nothing to q.k and give zero output columns;
    the scale stays that of the true hd)."""
    hd = q.shape[-1]
    width = padded_head_dim(hd)
    sm_scale = default_scale(hd, sm_scale)  # the true hd's, not the padded one's
    if width != hd:
        q, k, v = (torch.nn.functional.pad(t, (0, width - hd)) for t in (q, k, v))
    q, k, v = _fit(q, k, v)
    slopes = None
    if alibi_slopes is not None:
        slopes = alibi_slopes.to(device=q.device, dtype=torch.float32).contiguous()
    o = FlashAttentionFn.apply(q, k, v, slopes, causal, local_window, alibi_symmetric,
                               sm_scale)
    return o[..., :hd]
