"""K3's cotangent carried across several hb chunks, against JAX.

The plain K3 (``scan_direction_bwd``, which the kernel is held to on the
card) in the reverse direction at L = 56: its cotangent crosses three
hb-chunk boundaries (16-step chunks, the last one ragged), walking from
chunk 0. Held against JAX's ``selective_scan_grads`` (forward direction
only) on the time-flipped inputs. Float32, inputs from numpy with a seed;
1e-4 of each output's scale (the same math in float32, differing in
summation order, in chunking and in exp against exp2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.ops.scan_bwd import selective_scan_grads as jax_grads
from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK, scan_direction_bwd
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("fuse", [True, False])
def test_reverse_carry_across_hb_chunks_matches_jax(fuse):
    rng = np.random.default_rng(56)
    B, L, D, N, R = 2, 56, 8, 4, 3
    assert -(-L // HB_CHUNK) == 4
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    x, gy, Bm, Cm = f(B, L, D), f(B, L, D), f(B, L, N), f(B, L, N)
    dt = f(B, L, R if fuse else D, sc=0.5)
    A, Dskip, dt_bias = -np.exp(f(D, N, sc=0.5)), f(D), f(D, sc=0.3)
    w = f(R, D, sc=0.3) if fuse else None
    got = scan_direction_bwd(*map(torch.from_numpy, (x, gy, dt, A, Bm, Cm, Dskip, dt_bias)),
                             dt_proj_w=torch.from_numpy(w) if fuse else None, reverse=True)
    dt_full = dt @ w if fuse else dt
    flip = lambda v: jnp.asarray(v[None, :, ::-1])  # [1, B, L, .], time reversed
    ref = jax_grads(flip(x), flip(dt_full), jnp.asarray(A[None]), flip(Bm), flip(Cm),
                    jnp.asarray(Dskip[None]), jnp.asarray(dt_bias[None]), flip(gy), chunk=8)
    unflip = lambda v: np.asarray(v)[0, :, ::-1]
    r_dx, r_ddt, r_dA, r_dB, r_dC, r_dD, r_ddtb = ref
    want = dict(dx=unflip(r_dx), dB=unflip(r_dB), dC=unflip(r_dC), dA=np.asarray(r_dA)[0],
                ddt_bias=np.asarray(r_ddtb)[0], dD=np.asarray(r_dD)[0])
    want["ddt"] = unflip(r_ddt) @ w.T if fuse else unflip(r_ddt)
    if fuse:  # dW = dt_lr^T ddt_raw over rows and steps
        want["dW"] = np.einsum("blk,bld->kd", dt, unflip(r_ddt))
    for name, g in zip(["dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD", "dW"], got):
        if name not in want:
            assert g is None
            continue
        g, w_ = g.numpy().astype(np.float64), np.asarray(want[name], np.float64)
        assert g.shape == w_.shape, name
        assert np.abs(g - w_).max() <= 1e-4 * max(np.abs(w_).max(), 1e-30), name
