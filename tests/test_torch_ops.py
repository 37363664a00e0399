"""PyTorch port's building blocks against the JAX package, on the CPU.

Inputs come from numpy with a seed and go through both implementations in
float32. Tolerances: norms and the conv are a handful of float32 roundings
(1e-6); the scans accumulate over L=128 steps, so 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.ops import conv as jconv
from plantcaduceus_tpu.ops import norms as jnorms
from plantcaduceus_tpu.ops import selective_scan as jscan
from plantcaduceus_tpu_torch.ops import conv, norms, selective_scan
from tests.torch_threads import one_torch_thread  # noqa: F401


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("kind", ["rms", "layer", "layer_bias"])
def test_norms_match_jax(rng, kind):
    x = rng.standard_normal((3, 17, 48)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(48).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    if kind == "rms":
        want, got = jnorms.rms_norm(jx, jw), norms.rms_norm(tx, tw)
    elif kind == "layer":
        want, got = jnorms.layer_norm(jx, jw), norms.layer_norm(tx, tw)
    else:
        want, got = jnorms.layer_norm(jx, jw, jb), norms.layer_norm(tx, tw, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_norms_return_input_dtype():
    x = torch.randn(2, 8, dtype=torch.bfloat16)
    w = torch.ones(8)
    assert norms.rms_norm(x, w).dtype == torch.bfloat16
    assert norms.layer_norm(x, w).dtype == torch.bfloat16


@pytest.mark.parametrize("anticausal", [False, True])
@pytest.mark.parametrize("activation", ["silu", None])
def test_causal_conv_matches_jax(rng, anticausal, activation):
    x = rng.standard_normal((2, 3, 40, 24)).astype(np.float32)   # [G, B, L, D]
    w = rng.standard_normal((2, 1, 24, 4)).astype(np.float32)    # [G, 1, D, K]
    b = rng.standard_normal((2, 1, 24)).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = _both(x), _both(w), _both(b)
    want = jconv.causal_conv1d(jx, jw, jb, activation=activation, anticausal=anticausal)
    got = conv.causal_conv1d(tx, tw, tb, activation=activation, anticausal=anticausal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _scan_inputs(rng, G=2, B=2, L=128, D=24, N=8):
    return dict(
        x=rng.standard_normal((G, B, L, D)).astype(np.float32),
        dt=(rng.standard_normal((G, B, L, D)) * 0.5 - 1.0).astype(np.float32),
        A=-np.exp(rng.standard_normal((G, D, N)) * 0.5).astype(np.float32),
        Bm=rng.standard_normal((G, B, L, N)).astype(np.float32),
        Cm=rng.standard_normal((G, B, L, N)).astype(np.float32),
        Dskip=rng.standard_normal((G, D)).astype(np.float32),
        dt_bias=(rng.standard_normal((G, D)) * 0.3).astype(np.float32))


@pytest.mark.parametrize("impl", ["sequential", "associative"])
def test_plain_scans_match_jax_sequential(rng, impl):
    a = _scan_inputs(rng)
    want = jscan.selective_scan_sequential(**{k: jnp.asarray(v) for k, v in a.items()})
    fn = getattr(selective_scan, f"selective_scan_{impl}")
    got = fn(**{k: torch.from_numpy(v) for k, v in a.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_scan_direction_matches_flipped_sequential(rng, reverse):
    """The kernels' one-direction oracle (exp2 decay, native reverse) equals
    the sequential scan of the time-flipped inputs."""
    a = _scan_inputs(rng, G=1)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    flip = (lambda v: v.flip(2)) if reverse else (lambda v: v)
    want = flip(selective_scan.selective_scan_sequential(
        flip(t["x"]), flip(t["dt"]), t["A"], flip(t["Bm"]), flip(t["Cm"]),
        t["Dskip"], t["dt_bias"]))
    got = selective_scan.scan_direction(
        t["x"][0], t["dt"][0], t["A"][0], t["Bm"][0], t["Cm"][0], t["Dskip"][0],
        t["dt_bias"][0], reverse)
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), rtol=1e-5, atol=1e-5)


def test_softplus_matches_jax():
    import jax

    x = np.linspace(-30, 30, 2001).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = selective_scan.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
