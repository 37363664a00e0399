"""The port's kernel modules (their plain versions, which the wrappers run on
CPU tensors) against the JAX Pallas kernels in interpret mode.

K1: ``cuda_scan`` vs ``pallas_scan.selective_scan_pallas``; K2:
``cuda_mixer`` vs ``pallas_mixer.mixer_scan_fused``. Float32 throughout.
Tolerance 3e-4: the Pallas tests' own bound for these kernels against the
sequential reference (tests/test_pallas_scan.py), since both sides sum the
dt projection and the C readout in different orders over up to 128 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from plantcaduceus_tpu.ops import pallas_mixer, pallas_scan
from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=3e-4, atol=3e-4)


def _scan_inputs(rng, fuse, G=2, B=2, L=64, D=32, N=8, R=4):
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
def test_scan_plain_matches_pallas(rng, fuse):
    a = _scan_inputs(rng, fuse)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_scan.selective_scan_pallas(
            **{k: (jnp.asarray(v) if v is not None else None) for k, v in a.items()},
            directions=(False, True), bl=32, bd=32)
    t = {k: (torch.from_numpy(v) if v is not None else None) for k, v in a.items()}
    before = cuda_scan.scan_fwd.launches
    got = torch.stack([
        cuda_scan.scan_fwd(t["x"][g], t["dt"][g], t["A"][g], t["Bm"][g], t["Cm"][g],
                           t["Dskip"][g], t["dt_bias"][g],
                           t["dt_proj_w"][g] if fuse else None, reverse=(g == 1))
        for g in range(2)])
    assert cuda_scan.scan_fwd.launches == before  # CPU tensors: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _mixer_inputs(rng, B=2, L=128, D=32, N=8, R=8, K=4):
    f = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)
    return [f(B, L, D), f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -np.abs(f(D, N)) - 0.3, f(D)]


@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_plain_matches_pallas(rng, reverse):
    args = _mixer_inputs(rng)
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mixer.mixer_scan_fused(*map(jnp.asarray, args),
                                             reverse=reverse, bl=64, bd=32)
    before = cuda_mixer.mixer_fwd.launches
    got = cuda_mixer.mixer_fwd(*map(torch.from_numpy, args), reverse=reverse)
    assert cuda_mixer.mixer_fwd.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bimamba_combine_matches_pallas(rng):
    """Both directions plus the fp32 gate, against JAX bimamba_mixer_fused."""
    one = [_mixer_inputs(rng, B=1, L=32, D=16, N=4, R=4) for _ in range(2)]
    xi = one[0][0]
    z = (rng.standard_normal(xi.shape) * 0.5).astype(np.float32)
    w = [np.stack([one[0][i], one[1][i]]) for i in range(1, 10)]
    with pltpu.force_tpu_interpret_mode():
        want = pallas_mixer.bimamba_mixer_fused(
            jnp.asarray(xi), jnp.asarray(z), *map(jnp.asarray, w))
    got = cuda_mixer.bimamba_mixer_fused(
        torch.from_numpy(xi), torch.from_numpy(z), *map(torch.from_numpy, w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="need cuda or cpu"):
        cuda_scan.scan_fwd(x, x, x[0], x, x, x[0, 0], x[0, 0])
    with pytest.raises(ValueError, match="need cuda or cpu"):
        cuda_mixer.mixer_fwd(x, *([x[0]] * 9))
