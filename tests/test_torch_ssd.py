"""The port's SSD (Mamba-2) ops against the JAX package, on the CPU.

``ops/ssd.py`` (sequential and chunked), K4's plain version
``ssd_dir_plain`` and K5's ``mamba2_mixer_interior_plain``, each through its
CUDA wrapper (which takes the plain version for CPU tensors), against JAX
``ssd_sequential``/``ssd_chunked``, ``ssd_dir_xla`` and ``_interior_xla``.
Small shapes (H = 2..4, P = 8..16, N = 8..16, chunk 16..32, L = 64), inputs
from numpy with a seed. Float32 on both sides: tolerance 2e-5 relative to
the output's scale (sums over 64 steps and 16 states in another order;
measured ~1e-6). bfloat16: the product operands round to 8 mantissa bits
in both packages, at other points in the interior, so 2**-6 of the scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.ops import pallas_mixer2 as jmix2
from plantcaduceus_tpu.ops import pallas_ssd as jpssd
from plantcaduceus_tpu.ops import ssd as jssd
from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd
from plantcaduceus_tpu_torch.ops import ssd as tssd
from tests.torch_threads import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
BF16_TOL = 2 ** -6


def _close(got, want, tol, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= tol * scale, f"{what}: {err} > {tol} * {scale}"


def _ssd_inputs(rng, G=2, B=2, L=64, H=4, P=8, NG=2, N=8):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(x=f(G, B, L, H, P), dt=f(G, B, L, H) * 0.5,
                A=-np.exp(f(G, H) * 0.5), Bm=f(G, B, L, NG, N), Cm=f(G, B, L, NG, N),
                Dskip=f(G, H), dt_bias=f(G, H) * 0.3)


def _call(fn, a, conv, **kw):
    return fn(conv(a["x"]), conv(a["dt"]), conv(a["A"]), conv(a["Bm"]), conv(a["Cm"]),
              conv(a["Dskip"]), dt_bias=conv(a["dt_bias"]), **kw)


@pytest.mark.parametrize("name", ["ssd_sequential", "ssd_chunked"])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_matches_jax(rng, name, ng):
    """Both directions (group 1 runs right to left), NG = 1 and 2."""
    a = _ssd_inputs(rng, NG=ng)
    kw = dict(directions=(False, True), **({"chunk": 16} if name == "ssd_chunked" else {}))
    want = _call(getattr(jssd, name), a, jnp.asarray, **kw)
    got = _call(getattr(tssd, name), a, torch.from_numpy, **kw)
    _close(got, want, F32_TOL, name)


def test_chunk_lengths_agree(rng):
    """Chunking is a tiling choice: chunks of 16 and 32 give the sequential
    result, for the SSD and for the mixer interior."""
    a = _ssd_inputs(rng)
    seq = _call(tssd.ssd_sequential, a, torch.from_numpy, directions=(False, True))
    for chunk in (16, 32):
        got = _call(tssd.ssd_chunked, a, torch.from_numpy, directions=(False, True),
                    chunk=chunk)
        _close(got, seq, F32_TOL, f"chunk {chunk}")
    args, kw = _interior_inputs(rng)
    outs = [cuda_mixer2.mamba2_mixer_interior(*map(torch.from_numpy, args),
                                              **dict(kw, chunk=c, reverse=rev))
            for rev in (False, True) for c in (16, 32)]
    _close(outs[1], outs[0], F32_TOL, "interior fwd")
    _close(outs[3], outs[2], F32_TOL, "interior rev")


def test_non_dividing_chunk_raises(rng):
    a = _ssd_inputs(rng)
    with pytest.raises(ValueError, match="does not divide"):
        _call(tssd.ssd_chunked, a, torch.from_numpy, chunk=24)
    args, kw = _interior_inputs(rng)
    with pytest.raises(ValueError, match="does not divide"):
        cuda_mixer2.mamba2_mixer_interior(*map(torch.from_numpy, args),
                                          **dict(kw, chunk=24, reverse=False))


@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_dir_matches_jax(rng, reverse):
    """K4's flat contract on the CPU: the wrapper runs ``ssd_dir_plain``."""
    R, L, H, P, NG, N = 3, 64, 4, 8, 2, 8
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    args = (f(R, L, H * P), f(R, L, H) * 0.5, -np.exp(f(H) * 0.5), f(R, L, NG, N),
            f(R, L, NG, N), f(H), f(H) * 0.3)
    want = jpssd.ssd_dir_xla(*map(jnp.asarray, args), 32, reverse)
    got = cuda_ssd.ssd_dir(*map(torch.from_numpy, args), 32, reverse)
    _close(got, want, F32_TOL, "ssd_dir")
    assert cuda_ssd.ssd_dir.launches == 0  # CPU tensors launch nothing


def _interior_inputs(rng, R=2, L=64, H=2, P=16, NG=1, N=16, K=4):
    f = lambda *s, sc=1.0: (rng.standard_normal(s) * sc).astype(np.float32)
    di, NGN = H * P, NG * N
    args = (f(R, L, di), f(R, L, di), f(R, L, NGN), f(R, L, NGN), f(R, L, H, sc=0.5),
            f(di, K, sc=0.5), f(di, sc=0.3), f(NGN, K, sc=0.5), f(NGN, sc=0.3),
            f(NGN, K, sc=0.5), f(NGN, sc=0.3), 1 + f(di, sc=0.2),
            -np.exp(f(H, sc=0.5)), f(H), f(H, sc=0.3))
    return args, dict(d_state=N, eps=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_interior_matches_jax(rng, reverse):
    """K5's plain version against JAX ``_interior_xla`` (conv, SiLU, SSD,
    gated RMS norm), through the wrapper on CPU tensors."""
    args, kw = _interior_inputs(rng)
    want = jmix2._interior_xla(*map(jnp.asarray, args), N=kw["d_state"], eps=kw["eps"],
                               chunk=32, reverse=reverse)
    got = cuda_mixer2.mamba2_mixer_interior(*map(torch.from_numpy, args), **kw, chunk=32,
                                            reverse=reverse)
    _close(got, want, F32_TOL, "interior")
    assert cuda_mixer2.mamba2_mixer_interior.launches == 0


def test_bf16_within_bound(rng):
    """bfloat16 inputs: the chunked SSD and the interior against the JAX
    package's own bfloat16 results, within 2**-6 of the output's scale."""
    a = _ssd_inputs(rng)
    bf = lambda v: torch.from_numpy(v).to(torch.bfloat16)
    jbf = lambda v: jnp.asarray(v, jnp.bfloat16)
    kw = dict(directions=(False, True), chunk=32)
    want = _call(jssd.ssd_chunked, a, jbf, **kw)
    got = _call(tssd.ssd_chunked, a, bf, **kw)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16_TOL, "ssd_chunked bf16")
    args, ikw = _interior_inputs(rng)
    act = 5  # xi, z, Braw, Craw, dt in bfloat16; weights in float32
    want = jmix2._interior_xla(*(jbf(v) if i < act else jnp.asarray(v)
                                 for i, v in enumerate(args)),
                               N=ikw["d_state"], eps=ikw["eps"], chunk=32, reverse=True)
    got = cuda_mixer2.mamba2_mixer_interior(*(bf(v) if i < act else torch.from_numpy(v)
                                              for i, v in enumerate(args)),
                                            **ikw, chunk=32, reverse=True)
    assert got.dtype == torch.bfloat16
    _close(got.float(), np.asarray(want, np.float32), BF16_TOL, "interior bf16")


def test_kernel_shape_check():
    """The shapes the CUDA kernels take (the *-ssd presets') pass; others
    raise before anything is built."""
    cuda_ssd.check_kernel_shapes("l20-ssd", 512, 6, 128, 1, 128, 128)
    cuda_ssd.check_kernel_shapes("l20-ssd", None, 6, 128, 1, 128, 128)
    for args, msg in (((512, 6, 64, 1, 128, 128), "head dim"),
                      ((512, 6, 128, 1, 64, 128), "d_state"),
                      ((512, 6, 128, 1, 128, 64), "chunk"),
                      ((500, 6, 128, 1, 128, 128), "does not divide"),
                      ((512, 6, 128, 4, 128, 128), "n_groups")):
        with pytest.raises(ValueError, match=msg):
            cuda_ssd.check_kernel_shapes("cfg", *args)
