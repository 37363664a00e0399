"""The port's training kernels (their plain versions, which the wrappers and
autograd Functions run on CPU tensors) against the JAX package.

* ``SelectiveScanFn`` (K1 with hb forward, K3 backward) against ``jax.grad``
  of ``selective_scan_pallas``, whose VJP runs the Pallas backward kernel in
  interpret mode; both directions, fused and full-width dt.
* ``BimambaMixerFn`` (K2's residual variant, K3, the x_proj/conv
  transposes) against ``jax.grad`` of ``pallas_mixer.bimamba_mixer_fused``
  in interpret mode, all 11 inputs.
* The emitted chunk-entry states ``hb`` and K2's residuals against the
  Pallas kernels' own (``emit_hb`` / ``emit_residuals``) at the port's chunk.
* ``scan_direction_bwd`` against torch autograd through the plain forward,
  at two chunk lengths, and against the chunk-recompute reference
  ``ops.scan_bwd``, which is itself held to JAX ``selective_scan_grads``.

Float32 throughout, inputs from numpy with a seed. Tolerances: 1e-4
(relative to each output's scale) where both sides run the same algorithm
in float32 and differ only in summation order and in exp vs exp2; 2e-3 for
the whole mixer (the Pallas test's own bound, tests/test_pallas_scan.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.ops import pallas_mixer, pallas_scan
from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan, scan_bwd
from plantcaduceus_tpu_torch.ops.selective_scan import (HB_CHUNK, scan_direction,
                                                         scan_direction_bwd)


def _close(got, want, rel, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{name}: max err {err:.3e} vs scale {scale:.3e}"


def _scan_inputs(rng, fuse, G=2, B=2, L=64, D=16, N=4, R=4):
    return dict(
        x=rng.standard_normal((G, B, L, D)).astype(np.float32),
        dt=(rng.standard_normal((G, B, L, R if fuse else D)) * 0.5).astype(np.float32),
        A=-np.exp(rng.standard_normal((G, D, N)) * 0.5).astype(np.float32),
        Bm=rng.standard_normal((G, B, L, N)).astype(np.float32),
        Cm=rng.standard_normal((G, B, L, N)).astype(np.float32),
        Dskip=rng.standard_normal((G, D)).astype(np.float32),
        dt_bias=(rng.standard_normal((G, D)) * 0.3).astype(np.float32),
        dt_proj_w=((rng.standard_normal((G, R, D)) * 0.3).astype(np.float32)
                   if fuse else None))


@pytest.mark.parametrize("fuse", [True, False])
def test_selective_scan_fn_grads_match_pallas_vjp(rng, fuse):
    a = _scan_inputs(rng, fuse, L=32)
    gw = rng.standard_normal(a["x"].shape).astype(np.float32)
    names = [k for k in a if a[k] is not None]

    def loss(*vals):
        kw = dict(zip(names, vals))
        y = pallas_scan.selective_scan_pallas(
            kw["x"], kw["dt"], kw["A"], kw["Bm"], kw["Cm"], kw["Dskip"],
            dt_bias=kw["dt_bias"], dt_proj_w=kw.get("dt_proj_w"),
            directions=(False, True), bd=16)
        return jnp.sum(y * gw)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(len(names))))(
            *(jnp.asarray(a[k]) for k in names))
    t = {k: torch.from_numpy(a[k]).requires_grad_() for k in names}
    total = 0
    for g in range(2):
        y = cuda_scan.selective_scan(t["x"][g], t["dt"][g], t["A"][g], t["Bm"][g],
                                     t["Cm"][g], t["Dskip"][g], t["dt_bias"][g],
                                     t["dt_proj_w"][g] if fuse else None, reverse=(g == 1))
        total = total + (y * torch.from_numpy(gw[g])).sum()
    total.backward()
    for k, w in zip(names, want):
        _close(t[k].grad.numpy(), w, 1e-4, k)


def _mixer_args(rng, B=2, L=64, D=16, N=4, R=8, K=4):
    f = lambda *s, sc=0.3: (rng.standard_normal(s) * sc).astype(np.float32)
    return [f(B, L, D, sc=1.0), f(B, L, D, sc=1.0), f(2, D, K, sc=0.5), f(2, D, sc=0.1),
            f(2, D, R), f(2, D, N), f(2, D, N), f(2, R, D), f(2, D),
            (-np.exp(rng.standard_normal((2, D, N)) * 0.5)).astype(np.float32),
            f(2, D, sc=1.0)]


def test_bimamba_mixer_fn_grads_match_pallas_vjp(rng):
    args = _mixer_args(rng)
    gw = rng.standard_normal(args[0].shape).astype(np.float32)

    def loss(*a):
        return jnp.sum(pallas_mixer.bimamba_mixer_fused(*a).astype(jnp.float32) * gw)

    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=tuple(range(11)))(*map(jnp.asarray, args))
    t = [torch.from_numpy(v).requires_grad_() for v in args]
    before = (cuda_mixer.mixer_fwd.res_launches, cuda_scan.scan_bwd.launches)
    (cuda_mixer.bimamba_mixer(*t) * torch.from_numpy(gw)).sum().backward()
    assert (cuda_mixer.mixer_fwd.res_launches, cuda_scan.scan_bwd.launches) == before
    names = ["dxi", "dz", "dconv_w", "dconv_b", "dw_dtlr", "dw_B", "dw_C", "dw_dt",
             "ddtb", "dA", "dD"]
    for n, g, w in zip(names, t, want):
        np.testing.assert_allclose(g.grad.numpy(), np.asarray(w), rtol=2e-3, atol=2e-3,
                                   err_msg=n)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_hb_matches_pallas_emit_hb(rng, fuse, reverse):
    """scan_fwd's training variant: y and the chunk-entry states against the
    Pallas forward kernel's emit_hb at the same chunk (processing order)."""
    a = _scan_inputs(rng, fuse, G=1, L=64)
    with pltpu.force_tpu_interpret_mode():
        y_j, hb_j = pallas_scan._pallas_scan_group(
            *(jnp.asarray(a[k]) for k in ("x", "dt", "A", "Bm", "Cm", "Dskip", "dt_bias")),
            jnp.asarray(a["dt_proj_w"]) if fuse else None, HB_CHUNK, 16, 1, 1,
            reverse=reverse)
    t = {k: torch.from_numpy(v[0]) for k, v in a.items() if v is not None}
    y, hb = cuda_scan.scan_fwd(t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["Dskip"],
                               t["dt_bias"], t.get("dt_proj_w"), reverse=reverse,
                               hb_chunk=HB_CHUNK)
    _close(y.numpy(), np.asarray(y_j)[0], 1e-4, "y")
    _close(hb.numpy(), np.asarray(hb_j), 1e-4, "hb")


@pytest.mark.parametrize("reverse", [False, True])
def test_hb_equals_sequential_states(rng, reverse):
    """hb[:, c] is the state before processing step c*chunk, with a ragged
    last chunk (L = 41)."""
    R, L, D, N = 2, 41, 8, 4
    x, dt = rng.standard_normal((R, L, D)), rng.standard_normal((R, L, D)) * 0.5
    A = -np.exp(rng.standard_normal((D, N)) * 0.5)
    Bm, Cm = rng.standard_normal((R, L, N)), rng.standard_normal((R, L, N))
    bias = rng.standard_normal(D) * 0.3
    t = [torch.from_numpy(v.astype(np.float32)) for v in (x, dt, A, Bm, Cm)]
    _, hb = scan_direction(*t, torch.zeros(D), torch.from_numpy(bias.astype(np.float32)),
                           reverse, hb_chunk=8)
    dtp = np.log1p(np.exp(dt + bias))
    h = np.zeros((R, D, N))
    want = []
    for p, s in enumerate(range(L - 1, -1, -1) if reverse else range(L)):
        if p % 8 == 0:
            want.append(h.copy())
        h = np.exp(dtp[:, s, :, None] * A) * h + (dtp[:, s] * x[:, s])[..., None] * Bm[:, s, None]
    assert hb.shape == (R, 6, D, N)
    _close(hb.numpy(), np.stack(want, axis=1), 1e-5, "hb")


@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_residuals_match_pallas(rng, reverse):
    """K2's residual variant (acc, dt_lr/B/C, hb) against the Pallas
    kernel's emit_residuals at the port's chunk."""
    args = _mixer_args(rng, B=2, L=64, D=16, N=4, R=8)
    one = [args[0]] + [w[1 if reverse else 0] for w in args[2:]]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mixer.mixer_scan_fused(*map(jnp.asarray, one), reverse=reverse,
                                             bl=HB_CHUNK, bd=16, emit_residuals=True)
    got = cuda_mixer.mixer_fwd(*map(torch.from_numpy, one), reverse=reverse, emit_res=True)
    for n, g, w in zip(["y", "acc", "dt_lr", "B", "C", "hb"], got, want):
        _close(g.numpy(), np.asarray(w), 1e-4, n)


@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_direction_bwd_matches_autograd(rng, fuse, reverse):
    """The plain K3 against torch autograd through the plain forward, at two
    chunk lengths (16 and a ragged 7): the chunking is a tiling choice only."""
    a = _scan_inputs(rng, fuse, G=1, L=45, D=8, N=4, R=3)
    t = {k: torch.from_numpy(v[0]).requires_grad_() for k, v in a.items() if v is not None}
    keys = list(t)
    gy = torch.from_numpy(rng.standard_normal(t["x"].shape).astype(np.float32))
    dt_full = t["dt"] @ t["dt_proj_w"] if fuse else t["dt"]
    y = scan_direction(t["x"], dt_full, t["A"], t["Bm"], t["Cm"], t["Dskip"],
                       t["dt_bias"], reverse)
    want = dict(zip(keys, torch.autograd.grad((y * gy).sum(), [t[k] for k in keys])))
    order = ["x", "dt", "Bm", "Cm", "A", "dt_bias", "Dskip", "dt_proj_w"]
    for chunk in (16, 7):
        got = scan_direction_bwd(*(t[k].detach() for k in ("x",)), gy,
                                 *(t[k].detach() for k in ("dt", "A", "Bm", "Cm", "Dskip",
                                                           "dt_bias")),
                                 None, t["dt_proj_w"].detach() if fuse else None,
                                 reverse, chunk)
        for name, g in zip(order, got):
            if name in want:
                _close(g.numpy(), want[name].numpy(), 1e-5, f"{name} chunk {chunk}")


def test_selective_scan_grads_matches_jax(rng):
    """ops.scan_bwd (chunked recompute, no hb and with hb) against JAX's."""
    from plantcaduceus_tpu.ops.scan_bwd import selective_scan_grads as jax_grads

    a = _scan_inputs(rng, False, G=2, B=2, L=32, D=8, N=4)
    gy = rng.standard_normal(a["x"].shape).astype(np.float32)
    args = [a[k] for k in ("x", "dt", "A", "Bm", "Cm", "Dskip", "dt_bias")] + [gy]
    want = jax_grads(*map(jnp.asarray, args), chunk=8)
    got = scan_bwd.selective_scan_grads(*map(torch.from_numpy, args), chunk=8)
    for n, g, w in zip(["dx", "ddt", "dA", "dB", "dC", "dD", "ddtb"], got, want):
        _close(g.numpy(), np.asarray(w), 1e-4, n)
    # with the forward's boundary states (one per 8 steps, forward direction)
    t = [torch.from_numpy(v) for v in args]
    hb = torch.cat([scan_direction(t[0][g], t[1][g], t[2][g], t[3][g], t[4][g], t[5][g],
                                   t[6][g], False, hb_chunk=8)[1] for g in range(2)])
    got_hb = scan_bwd.selective_scan_grads(*t, hb=hb, chunk=8)
    for n, g, w in zip(["dx", "ddt", "dA", "dB", "dC", "dD", "ddtb"], got_hb, got):
        _close(g.numpy(), w.numpy(), 1e-5, n + " with hb")


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_direction_bwd_matches_scan_bwd_reference(rng, reverse):
    """The plain K3 (exp2, per-row layout, HB_CHUNK chunks, both directions)
    against ops.scan_bwd (exp, [G, B, L, D], forward direction only: the
    reverse direction is the forward one on time-flipped inputs)."""
    a = _scan_inputs(rng, False, G=1, B=2, L=48, D=8, N=4)
    gy = rng.standard_normal(a["x"].shape).astype(np.float32)
    t = {k: torch.from_numpy(v) for k, v in a.items() if v is not None}
    t["gy"] = torch.from_numpy(gy)
    got = scan_direction_bwd(t["x"][0], t["gy"][0], t["dt"][0], t["A"][0], t["Bm"][0],
                             t["Cm"][0], t["Dskip"][0], t["dt_bias"][0], reverse=reverse)
    flip = (lambda v: v.flip(2)) if reverse else (lambda v: v)
    ref = scan_bwd.selective_scan_grads(
        *(t[k] if k == "A" else flip(t[k]) for k in ("x", "dt", "A", "Bm", "Cm")),
        t["Dskip"], t["dt_bias"], flip(t["gy"]), chunk=8)
    ref_dx, ref_ddt, ref_dA, ref_dB, ref_dC, ref_dD, ref_ddtb = ref
    want = dict(dx=flip(ref_dx)[0], ddt=flip(ref_ddt)[0], dB=flip(ref_dB)[0],
                dC=flip(ref_dC)[0], dA=ref_dA[0], ddt_bias=ref_ddtb[0], dD=ref_dD[0])
    for name, g in zip(["dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD"], got):
        _close(g.numpy(), want[name].numpy(), 1e-4, name)
    assert got[7] is None
