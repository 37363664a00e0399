"""The port's Mamba-2 (SSD) training ops against the JAX package, on the CPU.

* K6's plain version (``ops/ssd_bwd.py``, through ``cuda_ssd.ssd_dir_bwd``
  on CPU tensors) against the Pallas adjoint ``_ssd_dir_bwd_kernel_call``
  in interpret mode: both modes, both directions, NG = 1 and 2, every
  output (dmass, ∂L/∂ log-decay, has no counterpart in JAX's XLA path).
* K4's ``emit_fentry`` and K5's ``emit_residuals`` (plain versions) against
  the Pallas kernels' residual outputs in interpret mode (K5 also at four
  chunks, L 512, with two groups).
* ``SsdDirFn`` and ``Mamba2InteriorFn`` gradients of every input against
  ``jax.grad`` of ``ssd_dir_xla`` and ``_interior_xla``.

Inputs from numpy with a seed, float32 on both sides. The interpret-mode
cases use the kernels' shapes (R 2, L 256, P = N = chunk = 128, the shapes
of tests/test_pallas_ssd.py); the gradient cases small ones (P = N = 16,
chunk 32). Tolerances, relative to each output's max |value|: 1e-4 for the
adjoint (the same float32 sums, taken as prefix sums here and as mask
products there; measured ~4e-6), 2e-5 for the forward residuals (the
forward's own tolerance in tests/test_torch_ssd.py), 5e-4 for the
gradients (the bound of tests/test_pallas_mixer2.py:66-68).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.ops import pallas_mixer2 as jmix2
from plantcaduceus_tpu.ops import pallas_ssd as jpssd
from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd
from tests.torch_threads import one_torch_thread  # noqa: F401

BWD_TOL = 1e-4
RES_TOL = 2e-5
GRAD_TOL = 5e-4
BWD_NAMES = ("dx", "dB", "dC", "ddt_raw", "dmass", "gx", "dtp")


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _ssd_case(seed, R=2, L=256, H=2, P=128, NG=1, N=128):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    return dict(x=f(R, L, H * P), dt=f(R, L, H, sc=0.5) - 1.0, A=-np.exp(f(H, sc=0.5)),
                Bm=f(R, L, NG, N, sc=0.5), Cm=f(R, L, NG, N, sc=0.5), Dskip=f(H),
                dt_bias=f(H, sc=0.3)), f(R, L, H * P)


ARGS = ("x", "dt", "A", "Bm", "Cm", "Dskip", "dt_bias")


@pytest.mark.parametrize("pre_silu", [False, True], ids=["plain", "pre_silu"])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_bwd_matches_pallas(pre_silu, reverse, ng):
    """Every output of K6's plain version against the Pallas adjoint, fed
    the same chunk-entry states (the Pallas forward's, with SiLU applied to
    the accumulators in ``pre_silu`` mode, as the fused mixer's forward
    does)."""
    a, g = _ssd_case(11 + 4 * ng + 2 * reverse + pre_silu, H=2 * ng, NG=ng)
    j = {k: jnp.asarray(v) for k, v in a.items()}
    fwd_in = dict(j, **({k: jax.nn.silu(j[k]) for k in ("x", "Bm", "Cm")} if pre_silu else {}))
    with pltpu.force_tpu_interpret_mode():
        _, fentry = jpssd._ssd_pallas_one(*(fwd_in[k] for k in ARGS), 128, reverse,
                                          emit_fentry=True)
        want = jpssd._ssd_dir_bwd_kernel_call(*(j[k] for k in ARGS), fentry, jnp.asarray(g),
                                              128, reverse, pre_silu=pre_silu)
    got = cuda_ssd.ssd_dir_bwd(*(torch.from_numpy(a[k]) for k in ARGS),
                               torch.from_numpy(np.array(fentry)), torch.from_numpy(g), 128,
                               reverse, pre_silu=pre_silu)
    assert len(got) == len(want) == (7 if pre_silu else 5)
    for name, gv, wv in zip(BWD_NAMES, got, want):
        assert gv.dtype == torch.float32, name
        _close(gv, wv, BWD_TOL, name)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_fentry_matches_pallas(reverse, ng):
    """K4's training variant: y and the chunk-entry states [R, L/T, N, H*P]
    by chunk index, against ``_ssd_pallas_one(emit_fentry=True)``."""
    a, _ = _ssd_case(31 + ng + 2 * reverse, H=2 * ng, NG=ng)
    with pltpu.force_tpu_interpret_mode():
        want = jpssd._ssd_pallas_one(*(jnp.asarray(a[k]) for k in ARGS), 128, reverse,
                                     emit_fentry=True)
    got = cuda_ssd.ssd_dir(*(torch.from_numpy(a[k]) for k in ARGS), 128, reverse,
                           emit_fentry=True)
    for name, gv, wv in zip(("y", "fentry"), got, want):
        _close(gv, wv, RES_TOL, name)


def _mixer2_case(seed, R=2, L=256, H=2, P=128, NG=1, N=128, K=4):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    di, NGN = H * P, NG * N
    return dict(xi=f(R, L, di), z=f(R, L, di), Braw=f(R, L, NGN), Craw=f(R, L, NGN),
                dt=f(R, L, H, sc=0.5) - 1.0, cxw=f(di, K, sc=0.3), cxb=f(di, sc=0.1),
                cbw=f(NGN, K, sc=0.3), cbb=f(NGN, sc=0.1), ccw=f(NGN, K, sc=0.3),
                ccb=f(NGN, sc=0.1), nw=1.0 + 0.1 * f(di), A=-np.exp(f(H, sc=0.5)),
                Dsk=f(H), dtb=f(H, sc=0.3))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_mixer2_residuals_match_pallas(reverse):
    """K5's training variant: u, the pre-SiLU accumulators, the entry
    states and the pre-gate y, against ``_interior_pallas_call(
    emit_residuals=True)``."""
    a = _mixer2_case(41 + reverse)
    with pltpu.force_tpu_interpret_mode():
        want = jmix2._interior_pallas_call(*(jnp.asarray(v) for v in a.values()), N=128,
                                           eps=1e-5, chunk=128, reverse=reverse,
                                           emit_residuals=True)
    got = cuda_mixer2.mamba2_mixer_interior(
        *(torch.from_numpy(v) for v in a.values()), d_state=128, eps=1e-5, chunk=128,
        reverse=reverse, emit_residuals=True)
    assert len(got) == len(want) == 6
    for name, gv, wv in zip(("u", "accx", "accB", "accC", "fentry", "y"), got, want):
        assert gv.dtype == (torch.float32), name
        _close(gv, wv, RES_TOL, name)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_mixer2_residuals_match_pallas_four_chunks(reverse):
    """K5's training variant at four chunks (L 512), two heads in two groups
    (each head its own B and C): every chunk but the first starts from a
    state passed across a chunk boundary, the path of K5's chunk-parallel
    state pass; against ``_interior_pallas_call(emit_residuals=True)``."""
    a = _mixer2_case(45 + reverse, R=1, L=512, H=2, NG=2)
    with pltpu.force_tpu_interpret_mode():
        want = jmix2._interior_pallas_call(*(jnp.asarray(v) for v in a.values()), N=128,
                                           eps=1e-5, chunk=128, reverse=reverse,
                                           emit_residuals=True)
    got = cuda_mixer2.mamba2_mixer_interior(
        *(torch.from_numpy(v) for v in a.values()), d_state=128, eps=1e-5, chunk=128,
        reverse=reverse, emit_residuals=True)
    assert got[4].shape == (1, 4, 128, 256)
    for name, gv, wv in zip(("u", "accx", "accB", "accC", "fentry", "y"), got, want):
        assert gv.dtype == torch.float32, name
        _close(gv, wv, RES_TOL, name)


SMALL = dict(R=2, L=64, P=16, N=16)


def _grads(jfn, tfn, a, seed_shape, seed):
    """Gradients of sum(f(*inputs) * cotangent) for every input, JAX and
    port, from the same numpy inputs."""
    ct = np.random.default_rng(seed).standard_normal(seed_shape).astype(np.float32)
    names = list(a)
    want = jax.grad(lambda *v: jnp.sum(jfn(*v) * ct), argnums=tuple(range(len(names))))(
        *(jnp.asarray(a[k]) for k in names))
    ins = [torch.from_numpy(a[k]).requires_grad_() for k in names]
    (tfn(*ins) * torch.from_numpy(ct)).sum().backward()
    return names, [t.grad for t in ins], want


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_dir_fn_grads_match_jax(reverse, ng):
    """``SsdDirFn`` (K4-fentry forward, K6 plain mode, the dA/dD/ddt_bias
    reductions) against ``jax.grad`` of ``ssd_dir_xla``, every input."""
    a, _ = _ssd_case(51 + ng + 2 * reverse, H=2 * ng, NG=ng, **SMALL)
    names, got, want = _grads(
        lambda *v: jpssd.ssd_dir_xla(*v, 32, reverse),
        lambda *v: cuda_ssd.ssd_dir_train(*v, 32, reverse), a, a["x"].shape, 3)
    for n, gv, wv in zip(names, got, want):
        _close(gv, wv, GRAD_TOL, n)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ng", [1, 2])
def test_mamba2_interior_fn_grads_match_jax(reverse, ng):
    """``Mamba2InteriorFn`` (K5-res forward; gated-norm adjoint, K6
    pre_silu, conv transposes) against ``jax.grad`` of ``_interior_xla``,
    every one of its 15 inputs."""
    a = _mixer2_case(61 + ng + 2 * reverse, H=2 * ng, NG=ng, **SMALL)
    kw = dict(eps=1e-5, chunk=32, reverse=reverse)
    names, got, want = _grads(
        lambda *v: jmix2._interior_xla(*v, N=16, **kw),
        lambda *v: cuda_mixer2.mamba2_mixer_interior_train(*v, d_state=16, **kw), a,
        a["xi"].shape, 4)
    assert len(names) == 15
    for n, gv, wv in zip(names, got, want):
        _close(gv, wv, GRAD_TOL, n)
