"""The port's attention ops and K7/K8's plain versions against the JAX
package, on the CPU.

``ops/attention.py`` (ALiBi slopes and bias, window mask, the einsum path),
``ops/rotary.py`` (the four scalings), the plain K7/K8 of
``ops/flash_plain.py`` against the Pallas kernels ``_fwd``/``_bwd`` in
interpret mode (L 256 and window 64, so a row's first key tile is all
masked), and ``FlashAttentionFn`` (the plain versions under autograd, as the
CPU path runs it) against ``jax.grad`` of the JAX XLA path, and
``flash_attention`` at head dims the kernels do not take (zero-padded to
the next kernel width) against JAX's ``flash_attention`` in interpret mode,
forward and gradients. Inputs from numpy with a seed; float32 on both
sides unless stated. Tolerances are those of
``tests/test_pallas_attention.py``: 2e-5 for float32 outputs, 2e-2 for
bfloat16, 5e-4 for gradients; tables within 1e-6; the padded path 1e-5 of
each output's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.ops import attention as jattn
from plantcaduceus_tpu.ops import pallas_attention as jflash
from plantcaduceus_tpu.ops import rotary as jrope
from plantcaduceus_tpu_torch.ops import attention as tattn
from plantcaduceus_tpu_torch.ops import cuda_attention, flash_plain
from plantcaduceus_tpu_torch.ops import rotary as trope
from tests.torch_threads import one_torch_thread  # noqa: F401

TABLE_TOL = 1e-6
F32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_TOL = 5e-4
PAD_TOL = 1e-5  # of each output's max |value|: zero columns change no sum


def _qkv(rng, B=2, L=64, H=4, hd=32):
    return [rng.standard_normal((B, L, H, hd)).astype(np.float32) for _ in range(3)]


def _np(t):
    return np.asarray(t.detach().float() if isinstance(t, torch.Tensor) else t, np.float32)


@pytest.mark.parametrize("heads", [6, 8, 12])
def test_alibi_tables_match_jax(heads):
    """12 heads takes the non-power-of-two extension. The slopes are made
    once per (heads, device): a second call returns the cached tensor, with
    JAX's values."""
    first = tattn.alibi_slopes(heads)
    cached = tattn.alibi_slopes(heads, torch.device("cpu"))
    assert cached is first
    for got in (first, cached):
        np.testing.assert_allclose(_np(got), _np(jattn.alibi_slopes(heads)), atol=TABLE_TOL,
                                   rtol=0)
    np.testing.assert_allclose(_np(tattn.alibi_bias(heads, 100)),
                               _np(jattn.alibi_bias(heads, 100)), atol=TABLE_TOL, rtol=0)
    assert (_np(tattn.local_window_mask(100, heads)) ==
            _np(jattn.local_window_mask(100, heads))).all()


@pytest.mark.parametrize("scaling", ["none", "interpolate", "ntk", "yarn"])
def test_rope_tables_match_jax(scaling):
    kw = dict(scaling=scaling, scale=4.0, original_max_len=128)
    for hd in (32, 64):
        for got, want in zip(trope.rope_tables(256, hd, **kw), jrope.rope_tables(256, hd, **kw)):
            np.testing.assert_allclose(_np(got), _np(want), atol=TABLE_TOL, rtol=0)
    with pytest.raises(ValueError, match="unknown rope scaling"):
        trope.rope_tables(16, 32, scaling="linear", scale=2.0)


def test_apply_rotary_matches_jax(rng):
    x = rng.standard_normal((2, 48, 3, 32)).astype(np.float32)
    cos, sin = jrope.rope_tables(48, 32, scaling="yarn", scale=2.0, original_max_len=32)
    want = jrope.apply_rotary(jnp.asarray(x), cos, sin)
    got = trope.apply_rotary(torch.from_numpy(x), torch.from_numpy(np.array(cos)),
                             torch.from_numpy(np.array(sin)))
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=0)


EINSUM_CASES = {"plain": {}, "alibi": dict(alibi=True), "causal": dict(causal=True),
                "window": dict(local_window=5), "bias": "bias", "mask": "mask"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(EINSUM_CASES))
def test_einsum_path_matches_jax(rng, case, dtype):
    q, k, v = _qkv(rng, L=40, H=3)
    kw = EINSUM_CASES[case]
    jkw, tkw = kw, kw
    if case in ("bias", "mask"):
        if case == "bias":
            arr = rng.standard_normal((3, 40, 40)).astype(np.float32)
        else:  # -inf off a kept diagonal: no row is wholly masked
            arr = np.where(rng.random((40, 40)) < 0.3, -np.inf, 0.0).astype(np.float32)
            np.fill_diagonal(arr, 0.0)
        jkw, tkw = {case: jnp.asarray(arr)}, {case: torch.from_numpy(arr)}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = jattn.multi_head_attention(*(jnp.asarray(t, jd) for t in (q, k, v)), impl="xla",
                                      **jkw)
    got = tattn.multi_head_attention(*(torch.from_numpy(t).to(td) for t in (q, k, v)),
                                     impl="xla", **tkw)
    assert got.dtype == td
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def _fold(x):
    B, L, H, hd = x.shape
    return jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, L, hd)


def _pallas_kw(H, slopes, causal=False, window=None, symmetric=True):
    sl = np.zeros((1, H), np.float32) if slopes is None else slopes.reshape(1, H)
    return (jnp.asarray(sl), 1.0 / np.sqrt(32), H, slopes is not None, causal, window,
            symmetric, jflash.DEF_BQ, jflash.DEF_BK)


@pytest.mark.parametrize("case", ["alibi", "window64"])
def test_plain_fwd_matches_pallas(rng, case):
    """o and lse of the plain K7 against ``_fwd`` in interpret mode; with a
    window of 64 at L 256, rows 192-255 see their first key tile masked."""
    q, k, v = _qkv(rng, B=1, L=256, H=2)
    slopes = np.array(jattn.alibi_slopes(2)) if case == "alibi" else None
    window = 64 if case == "window64" else None
    with pltpu.force_tpu_interpret_mode():
        o_w, lse_w = jflash._fwd(_fold(q), _fold(k), _fold(v),
                                 *_pallas_kw(2, slopes, window=window))
    o, lse = cuda_attention.flash_fwd(
        *(torch.from_numpy(t) for t in (q, k, v)),
        None if slopes is None else torch.from_numpy(slopes), window=window)
    np.testing.assert_allclose(_np(o.permute(0, 2, 1, 3).reshape(2, 256, 32)), _np(o_w),
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(_np(lse), _np(lse_w)[..., 0], atol=F32_TOL, rtol=F32_TOL)


def test_plain_bwd_matches_pallas(rng):
    """dq, dk, dv of the plain K8 against ``_bwd`` in interpret mode, ALiBi
    with a window of 64 at L 256."""
    q, k, v, do = _qkv(rng, B=1, L=256, H=2) + _qkv(rng, B=1, L=256, H=2)[:1]
    slopes = np.array(jattn.alibi_slopes(2))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = flash_plain.flash_fwd_plain(*t[:3], torch.from_numpy(slopes), window=64)
    got = cuda_attention.flash_bwd(*t[:3], o, t[3], lse, torch.from_numpy(slopes), window=64)
    lse_w = jnp.broadcast_to(jnp.asarray(_np(lse))[..., None], (2, 256, 128))
    with pltpu.force_tpu_interpret_mode():
        want = jflash._bwd(_fold(q), _fold(k), _fold(v), jnp.asarray(slopes.reshape(1, 2)),
                           lse_w, _fold(_np(o)), _fold(do), 1.0 / np.sqrt(32), 2, True, False,
                           64, True, jflash.DEF_BQ, jflash.DEF_BK)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        scale = np.abs(_np(w)).max()
        err = np.abs(_np(g.permute(0, 2, 1, 3).reshape(2, 256, 32)) - _np(w)).max()
        assert err <= F32_TOL * scale, f"{name}: {err} > {F32_TOL} * {scale}"


def _xla_ref(q, k, v, slopes, causal, window, symmetric):
    """JAX's XLA attention with the structured bias given as arrays."""
    bias = None
    if slopes is not None:
        pos = jnp.arange(q.shape[1])
        delta = (pos[:, None] - pos[None, :]).astype(jnp.float32)
        bias = -slopes[:, None, None] * (jnp.abs(delta) if symmetric else delta)[None]
    mask = jattn.local_window_mask(q.shape[1], window) if window else None
    return jattn.multi_head_attention(q, k, v, bias=bias, mask=mask, causal=causal,
                                      impl="xla")


@pytest.mark.parametrize("case", ["alibi", "causal", "window", "alibi_asym"])
def test_flash_attention_grads_match_jax(rng, case):
    """FlashAttentionFn (the CPU path: plain K7 forward, plain K8 backward)
    against jax.grad of the XLA path, with a cotangent from numpy. L 96
    with a window of 24: rows see their first keys masked."""
    q, k, v = _qkv(rng, B=1, L=96, H=2)
    w = rng.standard_normal(q.shape).astype(np.float32)
    slopes = np.array(jattn.alibi_slopes(2)) if case.startswith("alibi") else None
    causal = case in ("causal", "alibi_asym")
    window = 24 if case == "window" else None
    symmetric = case != "alibi_asym"

    def loss(q, k, v):
        o = _xla_ref(q, k, v, None if slopes is None else jnp.asarray(slopes), causal, window,
                     symmetric)
        return jnp.sum(o * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = cuda_attention.flash_attention(
        *ins, alibi_slopes=None if slopes is None else torch.from_numpy(slopes), causal=causal,
        local_window=window, alibi_symmetric=symmetric)
    np.testing.assert_allclose(_np(o), _np(_xla_ref(
        *(jnp.asarray(t) for t in (q, k, v)), None if slopes is None else jnp.asarray(slopes),
        causal, window, symmetric)), atol=F32_TOL, rtol=F32_TOL)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ins)
    for g, wt, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(_np(g), _np(wt), atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"d{name}")


def test_structured_dispatch_on_cpu(rng):
    """On CPU tensors a structured form runs the plain K7 (no launch) and
    agrees with the einsum path; arrays with ``impl="flash"`` raise, as
    ALiBi with an explicit bias does."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, L=48, H=4))
    before = (cuda_attention.flash_fwd.launches, cuda_attention.flash_bwd.launches)
    got = tattn.multi_head_attention(q, k, v, alibi=True, local_window=8)
    want = tattn.multi_head_attention(q, k, v, alibi=True, local_window=8, impl="xla")
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_TOL, rtol=F32_TOL)
    assert (cuda_attention.flash_fwd.launches, cuda_attention.flash_bwd.launches) == before
    with pytest.raises(ValueError, match="structured bias forms only"):
        tattn.multi_head_attention(q, k, v, mask=torch.zeros(48, 48), impl="flash")
    with pytest.raises(ValueError, match="either alibi"):
        tattn.multi_head_attention(q, k, v, bias=torch.zeros(4, 48, 48), alibi=True)


@pytest.mark.parametrize("hd", [16, 48])
def test_padded_head_dim_matches_pallas(rng, hd):
    """flash_attention at a head dim the kernels do not take runs zero-padded
    to the next width (32, 64) with the scale of the true hd, and returns o,
    dq, dk and dv at the true width: against JAX's flash_attention (which
    pads to 128) in interpret mode, ALiBi, L 128, forward and jax.grad."""
    q, k, v = _qkv(rng, B=1, L=128, H=2, hd=hd)
    w = rng.standard_normal(q.shape).astype(np.float32)
    slopes = np.array(jattn.alibi_slopes(2))

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, alibi_slopes=jnp.asarray(slopes))
        return jnp.sum(o * jnp.asarray(w)), o

    with pltpu.force_tpu_interpret_mode():
        (_, o_w), g_w = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *(jnp.asarray(t) for t in (q, k, v)))
    ins = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    o = cuda_attention.flash_attention(*ins, alibi_slopes=torch.from_numpy(slopes))
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(), ins)
    assert o.shape == q.shape and all(g.shape == q.shape for g in got)
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *got), (o_w, *g_w)):
        scale = np.abs(_np(b)).max()
        err = np.abs(_np(a) - _np(b)).max()
        assert err <= PAD_TOL * scale, f"{name}: {err} > {PAD_TOL} * {scale}"


def test_head_dim_above_128_raises(rng):
    """Above 128 flash_attention no longer raises: the kernels take the
    multiples of 128 there (in 128-wide slices), so hd 160 runs zero-padded
    to 256, as JAX pads it, and gives the plain attention's o at its true
    width. What still raises is a kernel wrapper given a width it does not
    take, on the card (tests/test_torch_gpu.py)."""
    q, k, v = (torch.from_numpy(t) for t in _qkv(rng, B=1, L=16, H=2, hd=160))
    o = cuda_attention.flash_attention(q, k, v)
    want, _ = flash_plain.flash_fwd_plain(q, k, v)
    assert cuda_attention.padded_head_dim(160) == 256 and o.shape == q.shape
    np.testing.assert_allclose(_np(o), _np(want), atol=F32_TOL, rtol=F32_TOL)
