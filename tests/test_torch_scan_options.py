"""K1's carry options and the scan experiment of ``tools/exp_inloop.py``,
held against the JAX package's Pallas kernels in interpret mode.

The plain K1 (``cuda_scan.scan_fwd_plain``, which the kernel is held to on
the card) with ``h0`` and ``emit_hfin``, both directions and both dt modes,
against ``pallas_scan._pallas_scan_group(..., h0=..., emit_hfin=True)`` as
``tests/test_pallas_scan.py`` runs it; then the plain K1 with dt given, no
dt bias and no D-skip against the three variants of ``exp_inloop``'s
kernel, whose function it computes. Inputs from numpy with a seed, float32.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.ops import pallas_scan
from plantcaduceus_tpu_torch.ops.cuda_scan import scan_fwd_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def test_carry_options_match_pallas():
    """y and hfin with a given h0 over two 16-step L-chunks (the carry
    crosses a grid step), both directions, fused and given dt; 2e-4, as
    test_pallas_scan.py (exp against exp2, softplus forms, sum orders)."""
    rng = np.random.default_rng(90)
    B, L, D, N, R = 1, 32, 16, 4, 3
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x, Bm, Cm, h0 = f(B, L, D), f(B, L, N), f(B, L, N), f(B, D, N, sc=0.5)
    A, Ds, dtb = -np.exp(f(D, N, sc=0.5)), f(D), f(D, sc=0.3)
    w = f(R, D, sc=0.3)
    for fuse in (True, False):
        dt = f(B, L, R if fuse else D, sc=0.5)
        for reverse in (False, True):
            with pltpu.force_tpu_interpret_mode():
                want_y, _, want_h = pallas_scan._pallas_scan_group(
                    *(jnp.asarray(v[None]) for v in (x, dt, A, Bm, Cm, Ds, dtb)),
                    jnp.asarray(w[None]) if fuse else None, bl=16, bd=16, t_inner=1, bb=1,
                    reverse=reverse, h0=jnp.asarray(h0), emit_hfin=True)
            T = torch.from_numpy
            got_y, got_h = scan_fwd_plain(T(x), T(dt), T(A), T(Bm), T(Cm), T(Ds), T(dtb),
                                          T(w) if fuse else None, reverse, h0=T(h0),
                                          emit_hfin=True)
            np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y)[0], rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-4)


@pytest.fixture
def exp_inloop():
    """tools/exp_inloop.py as a module, its JAX names set as its main() does."""
    spec = importlib.util.spec_from_file_location("exp_inloop", REPO / "tools" / "exp_inloop.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.jax, mod.jnp, mod.pl, mod.pltpu = jax, jnp, pl, pltpu
    return mod


def test_exp_inloop_variants_match_plain_k1(exp_inloop):
    """Its three variants (decays formed up front, in the loop, both in
    the loop) compute K1 in the unfused mode with no dt bias and no D-skip;
    the kernel's output is bf16, so one bf16 step (2**-7) of y's scale."""
    rng = np.random.default_rng(91)
    R, L, D, N = 1, 16, 16, 4
    x = rng.standard_normal((R, L, D)).astype(np.float32)
    dt = (rng.standard_normal((R, L, D)) - 1.5).astype(np.float32)
    Bm, Cm = (rng.standard_normal((R, L, N)).astype(np.float32) for _ in range(2))
    A = -np.exp(rng.standard_normal((1, D, N)) * 0.5).astype(np.float32)
    T = torch.from_numpy
    want = scan_fwd_plain(T(x), T(dt), T(A[0]), T(Bm), T(Cm), torch.zeros(D),
                          torch.zeros(D)).numpy()
    scale = np.abs(want).max()
    for variant in ("upfront", "a_loop", "ab_loop"):
        with pltpu.force_tpu_interpret_mode():
            got = exp_inloop.build(variant, R, L, D, N, L, D)(
                *(jnp.asarray(v) for v in (A, x, dt, Bm, Cm)))
        err = np.abs(np.asarray(got, np.float32) - want).max()
        assert err <= 2 ** -7 * scale, (variant, err, scale)
