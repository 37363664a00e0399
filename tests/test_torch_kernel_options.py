"""The TPU kernels' last options in the port, against the JAX package on the
CPU: K2's ``fuse_in`` (in_proj inside the mixer kernel), K1's ``combine``
epilogue and the ``PCAD_GATED_KERNEL`` route it serves, attention above
head dim 128, and the bf16 direction sum of the bidirectional mixer.

The port's side runs the kernels' plain versions (the wrappers' CPU path);
JAX's Pallas calls run in interpret mode, as ``tests/test_pallas_scan.py``
runs them. Inputs come from numpy with a seed. Tolerances, with their
reasons:

* ``TOL`` (3e-4, float32): the kernels' own bound against the sequential
  reference (``tests/test_torch_kernels.py``): the dt projection, the C
  readout and the in_proj sum in other orders over up to 64 steps.
* ``GRAD_TOL`` (2e-3 of each gradient's max): the Pallas adjoint's bound
  against autodiff (``tests/test_pallas_scan.py``), sums over every step
  and row in other orders.
* ``BF16_TOL`` (2**-6 of the output's max): bf16 outputs of two float32
  computations that sum in other orders round apart by a bf16 step
  (2**-8 relative) at a few elements, and the bf16 direction sum adds one
  more rounding on each side.
* ``ATTN_TOL`` (2e-5 of each output's max): float32 attention over 128
  keys and up to 256 head columns; the zero columns of the padding change
  no sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.models import caduceus as jcad
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu.ops import pallas_attention as jflash
from plantcaduceus_tpu.ops import pallas_mixer, pallas_scan
from plantcaduceus_tpu_torch.compat.params import from_jax_params
from plantcaduceus_tpu_torch.models import caduceus as tcad
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.ops import cuda_attention, cuda_mixer, cuda_scan, flash_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=3e-4, atol=3e-4)
GRAD_TOL = 2e-3
BF16_TOL = 2 ** -6
ATTN_TOL = 2e-5
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for this module's tiny JAX programs: the
    same functions, compiled in less time."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _close_to_scale(got, want, rel, name):
    got, want = _np(got), _np(want)
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, f"{name}: {err:.3e} > {rel:.1e} * {scale:.3e}"


def _mixer_weights(rng, D=32, N=8, R=4, K=4):
    """Per-direction weights stacked on a leading axis of 2, float32."""
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return [f(2, D, K), f(2, D), f(2, D, R), f(2, D, N), f(2, D, N), f(2, R, D), f(2, D),
            -np.abs(f(2, D, N)) - 0.3, f(2, D)]


# ---------------------------------------------------------------------------
# F6: the bf16 direction sum
# ---------------------------------------------------------------------------


def test_bf16_direction_sum_matches_jax(monkeypatch):
    """With both packages' per-direction kernels patched to give the same
    fixed bf16 outputs, the combined bf16 output of bimamba_mixer_fused and
    bimamba_mixer_fused_x equals JAX's bit for bit, and BimambaMixerFn's
    saved y_sum equals JAX's (pallas_mixer.py:465) on the same outputs: the
    two directions summed in bf16, then cast to float32."""
    rng = np.random.default_rng(70)
    B, L, Dm, D = 2, 16, 16, 32
    ys = [(rng.standard_normal((B, L, D)) * 3).astype(np.float32) for _ in range(2)]
    ys_j = [jnp.asarray(y, jnp.bfloat16) for y in ys]
    ys_t = [T(y).to(torch.bfloat16) for y in ys]
    z = rng.standard_normal((B, L, D)).astype(np.float32)
    x = rng.standard_normal((B, L, Dm)).astype(np.float32)
    w_in = (rng.standard_normal((Dm, D)) * 0.3).astype(np.float32)
    w = _mixer_weights(rng, D)

    def jax_fake(*a, reverse=False, emit_residuals=False, **kw):
        y = ys_j[int(reverse)]
        return (y,) + (y, None, None, None, None) if emit_residuals else y

    def port_fake(*a, reverse=False, emit_res=False, **kw):
        y = ys_t[int(reverse)]
        return (y,) + (y, y, y, y, y) if emit_res else y

    monkeypatch.setattr(pallas_mixer, "mixer_scan_fused", jax_fake)
    monkeypatch.setattr(cuda_mixer, "mixer_fwd", port_fake)
    zb, xb = jnp.asarray(z, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16)
    zt, xt = T(z).to(torch.bfloat16), T(x).to(torch.bfloat16)
    jw, tw = [jnp.asarray(a) for a in w], [T(a) for a in w]
    want = pallas_mixer.bimamba_mixer_fused(xb, zb, *jw)
    got = cuda_mixer.bimamba_mixer_fused(xt, zt, *tw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got), np.asarray(want, np.float32))
    want_x = pallas_mixer.bimamba_mixer_fused_x(xb, zb, jnp.asarray(w_in), *jw)
    got_x = cuda_mixer.bimamba_mixer_fused_x(xt, zt, T(w_in), *tw)
    np.testing.assert_array_equal(_np(got_x), np.asarray(want_x, np.float32))
    # the training forward's saved sum: JAX's _bimamba_mixer_fwd on the same outputs
    _, saved = pallas_mixer._bimamba_mixer_fwd(xb, zb, *jw)
    out = cuda_mixer.BimambaMixerFn.apply(xt.requires_grad_(), zt, *tw)
    y_sum = out.grad_fn.saved_tensors[11]
    assert y_sum.dtype == torch.float32
    np.testing.assert_array_equal(_np(y_sum), np.asarray(saved[11]))


def test_float32_direction_sum_is_unchanged(rng):
    """In float32 the sum in the outputs' dtype is the float32 sum: the
    combined output equals the per-direction plain outputs summed and gated
    in float32, bit for bit."""
    B, L, D = 2, 32, 32
    xi = (rng.standard_normal((B, L, D)) * 0.5).astype(np.float32)
    z = rng.standard_normal((B, L, D)).astype(np.float32)
    w = [T(a) for a in _mixer_weights(rng, D)]
    ys = [cuda_mixer.mixer_fwd_plain(T(xi), *(t[g] for t in w), reverse=g == 1)
          for g in range(2)]
    want = (ys[0].float() + ys[1].float()) * torch.nn.functional.silu(T(z))
    got = cuda_mixer.bimamba_mixer_fused(T(xi), T(z), *w)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# K2 fuse_in
# ---------------------------------------------------------------------------


def _fuse_in_inputs(rng, B=2, L=32, Dm=16, D=32):
    x = rng.standard_normal((B, L, Dm)).astype(np.float32)
    z = rng.standard_normal((B, L, D)).astype(np.float32)
    w_in = (rng.standard_normal((Dm, D)) * 0.3).astype(np.float32)
    return x, z, w_in, _mixer_weights(rng, D)


@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_fwd_w_in_matches_pallas(rng, reverse):
    """The plain mixer_fwd(w_in=) against JAX mixer_scan_fused(w_in=), one
    direction, float32; emit_res with w_in raises JAX's message; no kernel
    launches for CPU tensors."""
    x, _, w_in, w = _fuse_in_inputs(rng)
    g = int(reverse)
    one = [a[g] for a in w]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mixer.mixer_scan_fused(jnp.asarray(x), *map(jnp.asarray, one),
                                             reverse=reverse, bl=16, w_in=jnp.asarray(w_in))
    before = cuda_mixer.mixer_fwd.x_launches
    got = cuda_mixer.mixer_fwd(T(x), *map(T, one), reverse=reverse, w_in=T(w_in))
    assert cuda_mixer.mixer_fwd.x_launches == before
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="w_in fusion is inference-path only"):
        cuda_mixer.mixer_fwd(T(x), *map(T, one), emit_res=True, w_in=T(w_in))


def test_fused_x_keeps_xi_in_float32(rng):
    """bf16: the plain fuse_in output equals bit for bit the plain xi-given
    function fed the float32 xi (x @ w_in in bf16 products with a float32
    sum) and cast to bf16, both directions: xi is never rounded to bf16.
    Rounding xi first gives other bits."""
    x, _, w_in, w = _fuse_in_inputs(rng)
    xb = T(x).to(torch.bfloat16)
    xi32 = xb.float() @ T(w_in).to(torch.bfloat16).float()
    rounded_differs = False
    for g in (0, 1):
        one = [T(a[g]) for a in w]
        got = cuda_mixer.mixer_fwd_plain(xb, *one, reverse=g == 1, w_in=T(w_in))
        want = cuda_mixer.mixer_fwd_plain(xi32, *one, reverse=g == 1).to(torch.bfloat16)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
        rounded = cuda_mixer.mixer_fwd_plain(xi32.to(torch.bfloat16), *one, reverse=g == 1)
        rounded_differs |= not torch.equal(got, rounded)
    assert rounded_differs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bimamba_fused_x_matches_pallas(rng, dtype):
    """The port's bimamba_mixer_fused_x against JAX's (interpret mode):
    float32 within TOL, bf16 within BF16_TOL of the output's max."""
    x, z, w_in, w = _fuse_in_inputs(rng)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mixer.bimamba_mixer_fused_x(
            jnp.asarray(x, jdt), jnp.asarray(z, jdt), jnp.asarray(w_in), *map(jnp.asarray, w))
    got = cuda_mixer.bimamba_mixer_fused_x(T(x).to(tdt), T(z).to(tdt), T(w_in), *map(T, w))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    else:
        _close_to_scale(got, np.asarray(want, np.float32), BF16_TOL, "bf16 output")


def test_bimamba_fused_x_gradients_match_pallas(rng):
    """Gradients through bimamba_mixer_fused_x, dx and dw_in included (the
    in_proj then BimambaMixerFn, the in_proj adjoint by autograd), against
    jax.grad through JAX's custom VJP in interpret mode; float32."""
    x, z, w_in, w = _fuse_in_inputs(rng, L=16)
    gw = rng.standard_normal(z.shape).astype(np.float32)
    ins = [x, z, w_in, *w]

    def loss(*a):
        return jnp.sum(pallas_mixer.bimamba_mixer_fused_x(*a) * jnp.asarray(gw))

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(len(ins))))(*map(jnp.asarray, ins))
    tins = [T(a).requires_grad_() for a in ins]
    before = cuda_mixer.mixer_fwd.res_launches
    out = cuda_mixer.bimamba_mixer_fused_x(*tins)
    got = torch.autograd.grad((out * T(gw)).sum(), tins)
    assert cuda_mixer.mixer_fwd.res_launches == before  # CPU tensors: plain K2-res
    names = ["dx", "dz", "dw_in", "dconv_w", "dconv_b", "dw_dtlr", "dw_B", "dw_C", "ddt_proj_w",
             "ddt_bias", "dA", "dD"]
    for name, g, r in zip(names, got, want):
        _close_to_scale(g, r, GRAD_TOL, name)


# ---------------------------------------------------------------------------
# K1 combine and bimamba_scan_gated
# ---------------------------------------------------------------------------


def _gated_inputs(rng, B=2, L=32, D=16, N=4, R=3):
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(x=f(2, B, L, D), dt_lr=f(2, B, L, R, sc=0.5), A=-np.exp(f(2, D, N, sc=0.5)),
                Bm=f(2, B, L, N), Cm=f(2, B, L, N), Dskip=f(2, D), dt_bias=f(2, D, sc=0.3),
                dt_proj_w=f(2, R, D, sc=0.3), z=f(B, L, D))


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_combine_matches_pallas(rng, fuse, reverse):
    """scan_fwd(y_prev=, z=) (the plain K1 with the combine epilogue)
    against JAX _pallas_scan_group(y_prev=, z=), both dt modes and
    directions, float32 over two 16-step L-chunks; combine with hb_chunk
    raises."""
    a = _gated_inputs(rng)
    D = a["x"].shape[-1]
    x, Bm, Cm = a["x"][0], a["Bm"][0], a["Cm"][0]
    dt = a["dt_lr"][0] if fuse else (rng.standard_normal(x.shape) * 0.5).astype(np.float32)
    y_prev = rng.standard_normal(x.shape).astype(np.float32)
    z = a["z"]
    A, Ds, dtb, wdt = a["A"][0], a["Dskip"][0], a["dt_bias"][0], a["dt_proj_w"][0]
    with pltpu.force_tpu_interpret_mode():
        want, _ = pallas_scan._pallas_scan_group(
            *(jnp.asarray(v[None]) for v in (x, dt, A, Bm, Cm, Ds, dtb)),
            jnp.asarray(wdt[None]) if fuse else None, bl=16, bd=D, t_inner=1, bb=1,
            reverse=reverse, y_prev=jnp.asarray(y_prev[None]), z=jnp.asarray(z[None]),
            emit_hb=False)
    before = cuda_scan.scan_fwd.combine_launches
    got = cuda_scan.scan_fwd(T(x), T(dt), T(A), T(Bm), T(Cm), T(Ds), T(dtb),
                             T(wdt) if fuse else None, reverse, y_prev=T(y_prev), z=T(z))
    assert cuda_scan.scan_fwd.combine_launches == before
    np.testing.assert_allclose(_np(got), np.asarray(want)[0], **TOL)
    with pytest.raises(ValueError, match="inference-only"):
        cuda_scan.scan_fwd(T(x), T(dt), T(A), T(Bm), T(Cm), T(Ds), T(dtb),
                           T(wdt) if fuse else None, reverse, hb_chunk=16,
                           y_prev=T(y_prev), z=T(z))


def test_bimamba_scan_gated_value_and_gradients_match_pallas(rng):
    """bimamba_scan_gated without grad (K1 forward, K1 reverse with combine)
    and under grad (BimambaScanGatedFn: K1-hb both ways, K3) against JAX's
    bimamba_scan_gated and its custom VJP in interpret mode; float32."""
    a = _gated_inputs(rng, L=16)
    names = list(a)
    gw = rng.standard_normal(a["z"].shape).astype(np.float32)
    ja = {k: jnp.asarray(v) for k, v in a.items()}

    def loss(*v):
        return jnp.sum(pallas_scan.bimamba_scan_gated(*v) * jnp.asarray(gw))

    with pltpu.force_tpu_interpret_mode():
        want = pallas_scan.bimamba_scan_gated(*ja.values())
        want_g = jax.grad(loss, argnums=tuple(range(len(names))))(*ja.values())
    with torch.no_grad():
        got = cuda_scan.bimamba_scan_gated(*map(T, a.values()))
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    tins = [T(v).requires_grad_() for v in a.values()]
    before = (cuda_scan.scan_fwd.hb_launches, cuda_scan.scan_bwd.launches)
    out = cuda_scan.bimamba_scan_gated(*tins)
    assert isinstance(out.grad_fn, cuda_scan.BimambaScanGatedFn._backward_cls)
    got_g = torch.autograd.grad((out * T(gw)).sum(), tins)
    assert (cuda_scan.scan_fwd.hb_launches, cuda_scan.scan_bwd.launches) == before
    np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
    for name, g, r in zip(names, got_g, want_g):
        _close_to_scale(g, r, GRAD_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# The routes in mamba_mixer and the model
# ---------------------------------------------------------------------------

SMALL = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)


def _layer(seed=0, **kw):
    """One layer's weights of a tiny tied + add config, both packages."""
    jcfg = JaxConfig(**SMALL, scan_impl="pallas", **kw)
    params = jcad.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = {k: v[0] for k, v in params["blocks"].items()}
    return jcfg, CaduceusConfig(**SMALL, **kw), jp, {k: T(np.asarray(v)) for k, v in jp.items()}


def _lora(rng, cfg, r=2):
    """Adapters at in_proj_x, x_proj_dt and out_proj with nonzero b,
    dropout 0: (JAX's context, the port's)."""
    d, di, R = cfg.d_model, cfg.d_inner, cfg.dt_rank
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    ad = {"in_proj_x": (f(1, d, r), f(1, r, di)), "x_proj_dt": (f(2, di, r), f(2, r, R)),
          "out_proj": (f(1, di, r), f(1, r, d))}
    j = {"adapters": {k: {"a": jnp.asarray(a), "b": jnp.asarray(b)} for k, (a, b) in ad.items()},
         "scale": 2.0, "dropout": 0.0, "rng": None}
    t = {"adapters": {k: {"a": T(a).requires_grad_(), "b": T(b).requires_grad_()}
                      for k, (a, b) in ad.items()}, "scale": 2.0, "dropout": 0.0, "seed": None}
    return j, t


def test_gated_route_matches_jax(rng, monkeypatch):
    """With both packages' _USE_GATED_KERNEL on: mamba_mixer's inference
    output, and one training gradient with LoRA adapters (the input, every
    weight and the adapters), against JAX's (scan_impl "pallas", interpret
    mode), float32; the port's route runs bimamba_scan_gated."""
    monkeypatch.setattr(jcad, "_USE_GATED_KERNEL", True)
    monkeypatch.setattr(tcad, "_USE_GATED_KERNEL", True)
    jcfg, tcfg, jp, tp = _layer(1)
    x = rng.standard_normal((2, 16, tcfg.d_model)).astype(np.float32)
    gw = rng.standard_normal(x.shape).astype(np.float32)
    jl, tl = _lora(rng, tcfg)
    calls = []
    monkeypatch.setattr(tcad, "bimamba_scan_gated",
                        lambda *a, **k: calls.append(1) or cuda_scan.bimamba_scan_gated(*a, **k))

    def loss(p, x, ad):
        return jnp.sum(jcad.mamba_mixer(p, x, jcfg, lora=dict(jl, adapters=ad)) * gw)

    with pltpu.force_tpu_interpret_mode():
        want = jcad.mamba_mixer(jp, jnp.asarray(x), jcfg)
        want_g = jax.grad(loss, argnums=(0, 1, 2))(jp, jnp.asarray(x), jl["adapters"])
    with torch.no_grad():
        got = tcad.mamba_mixer(tp, T(x), tcfg)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    # every leaf but norm_weight, which the block applies before the mixer
    p = {k: v.clone().requires_grad_(k != "norm_weight") for k, v in tp.items()}
    leaves = [(f"d{k}", v, want_g[0][k]) for k, v in p.items() if v.requires_grad]
    leaves += [(f"dlora {k}.{s}", t, want_g[2][k][s])
               for k, ab in tl["adapters"].items() for s, t in ab.items()]
    xt = T(x).requires_grad_()
    out = tcad.mamba_mixer(p, xt, tcfg, lora=tl)
    grads = torch.autograd.grad((out * T(gw)).sum(), [xt] + [t for _, t, _ in leaves])
    _close_to_scale(grads[0], want_g[1], GRAD_TOL, "dx")
    for (name, _, w), g in zip(leaves, grads[1:]):
        _close_to_scale(g, w, GRAD_TOL, name)
    assert len(calls) == 2


def test_fuse_in_route_matches_jax_forward(rng, monkeypatch):
    """A tiny tied + add model (d_inner 32 <= 768) takes the fuse_in route
    under inference (bimamba_mixer_fused_x once a layer, no kernel launch
    on CPU tensors): logits against JAX's forward with scan_impl "pallas"
    (bimamba_mixer_fused_x in interpret mode), float32."""
    jcfg = JaxConfig(**SMALL, scan_impl="pallas")
    params = jcad.init_params(jax.random.PRNGKey(2), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), CaduceusConfig(**SMALL))
    ids = rng.integers(7, 11, size=(2, 32)).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jcad.forward(params, jnp.asarray(ids), jcfg, dtype=jnp.float32)["logits"]
    calls = []
    fused_x = cuda_mixer.bimamba_mixer_fused_x
    monkeypatch.setattr(tcad, "bimamba_mixer_fused_x",
                        lambda *a, **k: calls.append(1) or fused_x(*a, **k))
    before = cuda_mixer.mixer_fwd.x_launches
    with torch.inference_mode():
        got = model(T(ids).long(), dtype=torch.float32)["logits"]
    assert len(calls) == SMALL["n_layer"] and cuda_mixer.mixer_fwd.x_launches == before
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert tcad.FUSE_IN_MAX_D_INNER == 768  # JAX's caduceus.py:455


# ---------------------------------------------------------------------------
# Attention above head dim 128
def test_fuse_in_smem_sizes():
    """K2 fuse_in's shared memory a block, as the wrapper checks it before
    a launch: at l20 (d_model 384, N 16, R 24) in bf16 the conv + x_proj
    block fits twice on an SM and the four-row scan block once; bf16 grows
    with d_model (an x window of 72 rows and 32 w_in^T rows; 128 resident
    w_in^T rows), float32 does not; the widest bf16 d_model at l20's N, R."""
    conv, scan = cuda_mixer.fuse_in_smem(384, 16, 24)
    assert (conv, scan) == (109_792, 196_608)
    assert 2 * (conv + 1024) <= 233_472 and scan <= cuda_mixer.SMEM_MAX
    assert cuda_mixer.fuse_in_smem(400, 16, 24) == (conv + 2 * 104 * 16, scan + 2 * 128 * 16)
    assert cuda_mixer.fuse_in_smem(384, 16, 24, bf16=False) == \
        cuda_mixer.fuse_in_smem(768, 16, 24, bf16=False) == (56_448, 68_096)
    fits = [dm for dm in range(16, 1024, 16)
            if max(cuda_mixer.fuse_in_smem(dm, 16, 24)) <= cuda_mixer.SMEM_MAX]
    assert fits[-1] == 512 and fits == list(range(16, 528, 16))
    # the x_proj's wider register tiling past R + 2N = 64
    assert cuda_mixer.fuse_in_smem(384, 32, 24)[0] == conv + 4 * 32 * 64


# ---------------------------------------------------------------------------


def test_padded_head_dim_widths():
    """32, 64 and 128 up to 128 (the port's widths), then the next multiple
    of 128 (JAX's hd_pad, pallas_attention.py:184)."""
    assert [cuda_attention.padded_head_dim(h) for h in (16, 32, 48, 64, 96, 128)] == \
        [32, 32, 64, 64, 128, 128]
    assert [cuda_attention.padded_head_dim(h) for h in (129, 160, 256, 257, 384)] == \
        [256, 256, 256, 384, 384]
    assert all(cuda_attention.kernel_head_dim(h) for h in (32, 64, 128, 256, 384))
    assert not any(cuda_attention.kernel_head_dim(h) for h in (16, 96, 160, 200))


@pytest.mark.parametrize("hd", [160, 256])
def test_flash_attention_above_128_matches_pallas(rng, hd):
    """flash_attention at hd 160 (zero-padded to 256) and 256: o and the q,
    k, v gradients against JAX's flash_attention and jax.grad (interpret
    mode), ALiBi, L 128; the outputs at the true width."""
    B, L, H = 1, 128, 2
    q, k, v = ((rng.standard_normal((B, L, H, hd)) * 0.5).astype(np.float32) for _ in range(3))
    w = rng.standard_normal(q.shape).astype(np.float32)
    slopes = np.array([0.5, 0.125], np.float32)

    def loss(q, k, v):
        o = jflash.flash_attention(q, k, v, alibi_slopes=jnp.asarray(slopes))
        return jnp.sum(o * jnp.asarray(w)), o

    with pltpu.force_tpu_interpret_mode():
        (_, o_w), g_w = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            *map(jnp.asarray, (q, k, v)))
    ins = [T(t).requires_grad_() for t in (q, k, v)]
    o = cuda_attention.flash_attention(*ins, alibi_slopes=T(slopes))
    got = torch.autograd.grad((o * T(w)).sum(), ins)
    assert o.shape == q.shape and all(g.shape == q.shape for g in got)
    for name, a, b in zip(("o", "dq", "dk", "dv"), (o, *got), (o_w, *g_w)):
        _close_to_scale(a, b, ATTN_TOL, name)
    o_plain, _ = flash_plain.flash_fwd_plain(*(T(t) for t in (q, k, v)), T(slopes))
    _close_to_scale(o, o_plain, ATTN_TOL, "o vs unpadded plain")
