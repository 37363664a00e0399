"""The kernels' last options against their plain PyTorch versions, on the
card: K2's ``fuse_in`` variant, K1's ``combine`` epilogue (and the
``bimamba_scan_gated`` route), K7/K8 above head dim 128.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none. Run on a machine with an H100 with ``python -m pytest
tests/test_torch_gpu_options.py -m gpu --noconftest``. No JAX here (the
card's machine has none); ``tests/test_torch_kernel_options.py`` holds the
plain versions to JAX on the CPU. Inputs come from numpy with a seed; TF32
is off so the plain versions' products are full float32. Tolerances as
``tests/test_torch_gpu.py``'s, with their reasons there: float32 sums in
other orders (2e-4), bf16 outputs one bf16 step apart (2e-2, 2**-7 of the
scale for attention).
"""

import numpy as np
import pytest
import torch

from plantcaduceus_tpu_torch.ops import cuda_attention, cuda_mixer, cuda_scan, flash_plain
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu

TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 2e-2)}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)


def _close_to_scale(got, want, rel, name=""):
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(scale, 1e-30), (name, err, scale)


def _mixer_args(rng, dev, D, N=16, R=8, K=4):
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, dev)
    return (f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -torch.abs(f(D, N)) - 0.3, f(D))


# (rows, d_model, d_conv): three rows in one four-row scan block, one row
# with l20's d_model and a shorter conv, five rows over two blocks
FUSE_IN_SHAPES = [(3, 64, 4), (1, 384, 2), (5, 384, 4)]


@pytest.mark.parametrize("shape", FUSE_IN_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("L", [1, 37, 200, 512, 600])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_fuse_in_matches_plain(cuda, dtype, reverse, L, shape):
    """K2 fuse_in (x and w_in in, xi computed inside both kernels) against
    its plain version at the edges of its tiling: L 1, 37, 200 and 600 end
    in a ragged 64-step block and a ragged 32-step xi tile (L 1 and 37 stop
    inside the first tile of every staggered row), D 160 in a ragged channel
    block, rows 1, 3 and 5 fill four-row scan blocks in part; one launch
    counted as x_launches; two launches give equal bits."""
    rng = np.random.default_rng(11)
    B, D = shape[0], 160
    Dm, K = shape[1], shape[2]
    x = _t(rng.standard_normal((B, L, Dm)), cuda, dtype)
    w_in = _t(rng.standard_normal((Dm, D)) * (0.2 * (64 / Dm) ** 0.5), cuda)
    args = _mixer_args(rng, cuda, D, K=K)
    before = (cuda_mixer.mixer_fwd.x_launches, cuda_mixer.mixer_fwd.launches)
    got = cuda_mixer.mixer_fwd(x, *args, reverse=reverse, w_in=w_in)
    again = cuda_mixer.mixer_fwd(x, *args, reverse=reverse, w_in=w_in)
    torch.cuda.synchronize()
    assert (cuda_mixer.mixer_fwd.x_launches, cuda_mixer.mixer_fwd.launches) == \
        (before[0] + 2, before[1])
    assert got.dtype == dtype and got.shape == (B, L, D) and torch.equal(got, again)
    want = cuda_mixer.mixer_fwd_plain(x, *args, reverse=reverse, w_in=w_in)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_mixer_fuse_in_refusals(cuda):
    rng = np.random.default_rng(12)
    args = _mixer_args(rng, cuda, 32)
    x = _t(rng.standard_normal((1, 64, 24)), cuda)
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_mixer.mixer_fwd(x, *args, w_in=_t(np.ones((24, 32)), cuda))
    x = _t(rng.standard_normal((1, 64, 32)), cuda)
    with pytest.raises(ValueError, match="inference-path only"):
        cuda_mixer.mixer_fwd(x, *args, emit_res=True, w_in=_t(np.ones((32, 32)), cuda))
    # bf16 keeps a scan block's w_in^T rows resident: at N 16, R 8 d_model
    # 576 needs more shared memory than a block has; float32 streams them
    x = _t(rng.standard_normal((1, 64, 576)), cuda)
    w_in = _t(rng.standard_normal((576, 32)) * 0.05, cuda)
    with pytest.raises(ValueError, match="too wide for fuse_in"):
        cuda_mixer.mixer_fwd(x.bfloat16(), *args, w_in=w_in)
    got = cuda_mixer.mixer_fwd(x, *args, w_in=w_in)
    want = cuda_mixer.mixer_fwd_plain(x, *args, w_in=w_in)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32][0], atol=TOL[torch.float32][1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bimamba_fused_x_kernels_match_plain(cuda, dtype):
    """Both directions and the gate through K2 fuse_in (two launches)
    against the plain version."""
    rng = np.random.default_rng(13)
    B, L, Dm, D = 2, 256, 64, 128
    x = _t(rng.standard_normal((B, L, Dm)), cuda, dtype)
    z = _t(rng.standard_normal((B, L, D)), cuda, dtype)
    w_in = _t(rng.standard_normal((Dm, D)) * 0.2, cuda)
    w = [torch.stack([a, b]) for a, b in zip(_mixer_args(rng, cuda, D), _mixer_args(rng, cuda, D))]
    before = cuda_mixer.mixer_fwd.x_launches
    with torch.no_grad():
        got = cuda_mixer.bimamba_mixer_fused_x(x, z, w_in, *w)
        want = cuda_mixer.bimamba_mixer_fused_x(x, z, w_in, *w, use_kernels=False)
    torch.cuda.synchronize()
    assert cuda_mixer.mixer_fwd.x_launches == before + 2
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def _scan_args(rng, dev, dtype, fuse, rows=3, L=200, D=160, N=16, R=12):
    x = _t(rng.standard_normal((rows, L, D)), dev, dtype)
    dt = _t(rng.standard_normal((rows, L, R if fuse else D)) * 0.5, dev, dtype)
    A = -torch.exp(_t(rng.standard_normal((D, N)) * 0.5, dev))
    Bm, Cm = (_t(rng.standard_normal((rows, L, N)), dev, dtype) for _ in range(2))
    Ds, dtb = _t(rng.standard_normal(D), dev), _t(rng.standard_normal(D) * 0.3, dev)
    wdt = _t(rng.standard_normal((R, D)) * 0.3, dev) if fuse else None
    return (x, dt, A, Bm, Cm, Ds, dtb, wdt)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_combine_matches_plain(cuda, dtype, fuse, reverse):
    """K1 with the combine epilogue ((y + y_prev) * silu(z)) against its
    plain version, ragged chunk and channel tiles; one launch counted as
    combine_launches; hb with combine raises."""
    rng = np.random.default_rng(14)
    args = _scan_args(rng, cuda, dtype, fuse)
    y_prev, z = (_t(rng.standard_normal(args[0].shape), cuda, dtype) for _ in range(2))
    before = (cuda_scan.scan_fwd.combine_launches, cuda_scan.scan_fwd.launches)
    got = cuda_scan.scan_fwd(*args, reverse=reverse, y_prev=y_prev, z=z)
    torch.cuda.synchronize()
    assert (cuda_scan.scan_fwd.combine_launches, cuda_scan.scan_fwd.launches) == \
        (before[0] + 1, before[1])
    want = cuda_scan.scan_fwd_plain(*args, reverse=reverse, y_prev=y_prev, z=z)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    with pytest.raises(ValueError, match="inference-only"):
        cuda_scan.scan_fwd(*args, reverse=reverse, hb_chunk=16, y_prev=y_prev, z=z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bimamba_scan_gated_kernels_match_plain(cuda, dtype):
    """bimamba_scan_gated without grad (K1, then K1 with combine) and its
    gradients under BimambaScanGatedFn (K1-hb twice, K3 twice) against the
    plain versions differentiated by autograd (fp32 gradients within 1e-4 of
    each one's scale; bf16 outputs within TOL)."""
    rng = np.random.default_rng(15)
    G = [_scan_args(rng, cuda, dtype, True, rows=2, L=160, D=128) for _ in range(2)]
    x, dt, A, Bm, Cm, Ds, dtb, wdt = (torch.stack(pair) for pair in zip(*G))
    z = _t(rng.standard_normal(x.shape[1:]), cuda, dtype)
    ins = (x, dt, A, Bm, Cm, Ds, dtb, wdt, z)
    before = (cuda_scan.scan_fwd.launches, cuda_scan.scan_fwd.combine_launches)
    with torch.no_grad():
        got = cuda_scan.bimamba_scan_gated(*ins)
        want = cuda_scan.bimamba_scan_gated(*ins, use_kernels=False)
    torch.cuda.synchronize()
    assert (cuda_scan.scan_fwd.launches - before[0],
            cuda_scan.scan_fwd.combine_launches - before[1]) == (1, 1)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)
    if dtype != torch.float32:
        return
    tins = [t.clone().requires_grad_(t.is_floating_point()) for t in ins]
    gw = torch.randn_like(z)
    want_g = torch.autograd.grad(
        (cuda_scan.bimamba_scan_gated(*tins, use_kernels=False) * gw).sum(), tins)
    before = (cuda_scan.scan_fwd.hb_launches, cuda_scan.scan_bwd.launches)
    got_g = torch.autograd.grad((cuda_scan.bimamba_scan_gated(*tins) * gw).sum(), tins)
    assert (cuda_scan.scan_fwd.hb_launches - before[0],
            cuda_scan.scan_bwd.launches - before[1]) == (2, 2)
    for name, g, r in zip(("x", "dt_lr", "A", "Bm", "Cm", "Dskip", "dt_bias", "dt_proj_w", "z"),
                          got_g, want_g):
        _close_to_scale(g, r, 1e-4, name)


def test_model_forward_takes_fuse_in(cuda):
    """A tied + add model at d_inner 128 (<= 768) scores through K2 fuse_in,
    two launches a layer and no xi-given K2 launch; fp32 logits against the
    plain path within 1e-4 of their scale."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=64, n_layer=2)
    model = Caduceus(cfg, init_params(cfg, seed=4)).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(2).integers(7, 11, (4, 96))).to(cuda)
    before = (cuda_mixer.mixer_fwd.x_launches, cuda_mixer.mixer_fwd.launches)
    with torch.inference_mode():
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        after = (cuda_mixer.mixer_fwd.x_launches, cuda_mixer.mixer_fwd.launches)
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
    assert (after[0] - before[0], after[1] - before[1]) == (2 * cfg.n_layer, 0)
    _close_to_scale(got, want, 1e-4, "logits")


@pytest.mark.parametrize("hd", [160, 256, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_wide_head_dims_match_plain(cuda, dtype, hd):
    """flash_attention above hd 128 (160 zero-padded to 256; 256 and 384 as
    they are): o and the q/k/v gradients through the wide K7/K8 (one launch
    each, counted as wide_launches) against the plain versions; ALiBi with
    a window of 100, L 200 (a ragged last tile)."""
    from plantcaduceus_tpu_torch.ops.attention import alibi_slopes

    rng = np.random.default_rng(16)
    B, L, H = 2, 200, 3
    q, k, v, do = (_t(rng.standard_normal((B, L, H, hd)), cuda, dtype) for _ in range(4))
    slopes = alibi_slopes(H, cuda)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (cuda_attention.flash_fwd.wide_launches, cuda_attention.flash_bwd.wide_launches)
    o = cuda_attention.flash_attention(*ins, alibi_slopes=slopes, local_window=100)
    grads = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    assert (cuda_attention.flash_fwd.wide_launches - before[0],
            cuda_attention.flash_bwd.wide_launches - before[1]) == (1, 1)
    o_w, lse_w = flash_plain.flash_fwd_plain(q, k, v, slopes, window=100)
    want = flash_plain.flash_bwd_plain(q, k, v, o_w, do, lse_w, slopes, window=100)
    assert o.shape == q.shape and o.dtype == dtype
    _close_to_scale(o, o_w, ATTN_TOL[dtype], "o")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        _close_to_scale(g, w, ATTN_TOL[dtype], name)


def test_attn_wide_kernels_lse_and_determinism(cuda):
    """The wide K7's lse against the plain version's, and two launches of
    the wide K8 give equal bits (no atomics); a width the kernels do not
    take raises, naming it."""
    rng = np.random.default_rng(17)
    q, k, v, do = (_t(rng.standard_normal((1, 130, 2, 256)), cuda, torch.bfloat16)
                   for _ in range(4))
    o, lse = cuda_attention.flash_fwd(q, k, v, causal=True)
    _, lse_w = flash_plain.flash_fwd_plain(q, k, v, causal=True)
    _close_to_scale(lse, lse_w, 1e-5, "lse")
    a = cuda_attention.flash_bwd(q, k, v, o, do, lse, causal=True)
    b = cuda_attention.flash_bwd(q, k, v, o, do, lse, causal=True)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    x = torch.zeros((1, 64, 2, 160), device=cuda)
    with pytest.raises(ValueError, match="head dim 160"):
        cuda_attention.flash_fwd(x, x, x)
