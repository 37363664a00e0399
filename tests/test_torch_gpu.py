"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
where there is none (on the CPU-only test hosts). Run on a machine with an
H100 with ``python -m pytest tests/test_torch_gpu.py -m gpu``. Inputs come
from numpy with a seed; TF32 is off so the plain versions' products are
full float32.
"""

import numpy as np
import pytest
import torch

from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan
from tests.torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev, dtype)


# float32: the kernel and the plain version differ only in summation order
# (the dt projection and the C readout); bfloat16: outputs round to 8 bits
# of mantissa, so one bf16 step (2**-8 relative) of the output scale.
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2e-2, 2e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_kernel_matches_plain(cuda, dtype, fuse, reverse):
    rng = np.random.default_rng(0)
    rows, L, D, N, R = 3, 200, 160, 16, 12   # ragged chunk and channel tiles
    x = _t(rng.standard_normal((rows, L, D)), cuda, dtype)
    dt = _t(rng.standard_normal((rows, L, R if fuse else D)) * 0.5, cuda, dtype)
    Bm = _t(rng.standard_normal((rows, L, N)), cuda, dtype)
    Cm = _t(rng.standard_normal((rows, L, N)), cuda, dtype)
    A = _t(-np.exp(rng.standard_normal((D, N)) * 0.5), cuda)
    Ds = _t(rng.standard_normal(D), cuda)
    dtb = _t(rng.standard_normal(D) * 0.3, cuda)
    w = _t(rng.standard_normal((R, D)) * 0.3, cuda) if fuse else None
    before = cuda_scan.scan_fwd.launches
    got = cuda_scan.scan_fwd(x, dt, A, Bm, Cm, Ds, dtb, w, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_scan.scan_fwd.launches == before + 1
    want = cuda_scan.scan_fwd_plain(x, dt, A, Bm, Cm, Ds, dtb, w, reverse=reverse)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_kernel_matches_plain(cuda, dtype, reverse):
    rng = np.random.default_rng(1)
    B, L, D, N, R, K = 3, 200, 96, 16, 8, 4
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, cuda)
    xi = _t(rng.standard_normal((B, L, D)), cuda, dtype)
    args = (f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -torch.abs(f(D, N)) - 0.3, f(D))
    before = cuda_mixer.mixer_fwd.launches
    got = cuda_mixer.mixer_fwd(xi, *args, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_mixer.mixer_fwd.launches == before + 1
    want = cuda_mixer.mixer_fwd_plain(xi, *args, reverse=reverse)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_wrappers_reject_bad_input(cuda):
    x = torch.zeros((2, 8, 16), device=cuda)
    A = torch.zeros((16, 5), device=cuda)  # d_state 5 has no kernel
    bc = torch.zeros((2, 8, 5), device=cuda)
    v = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="d_state"):
        cuda_scan.scan_fwd(x, x, A, bc, bc, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_scan.scan_fwd(x.transpose(1, 2).contiguous().transpose(1, 2), x,
                           A[:, :4].contiguous(), bc[..., :4].contiguous(),
                           bc[..., :4].contiguous(), v, v)


def test_scan_fwd_rejects_mixed_dtypes(cuda):
    """K1 reads x, dt, Bm and Cm through one type: x in bf16 beside fp32
    dt, Bm and Cm must raise, not be misread."""
    x = torch.zeros((2, 8, 16), device=cuda)
    bc = torch.zeros((2, 8, 4), device=cuda)
    v = torch.zeros(16, device=cuda)
    with pytest.raises(ValueError, match="one dtype"):
        cuda_scan.scan_fwd(x.bfloat16(), x, torch.zeros((16, 4), device=cuda), bc, bc, v, v)


def _scan_case(rng, dev, dtype, fuse, rows=3, L=200, D=160, N=16, R=12):
    x = _t(rng.standard_normal((rows, L, D)), dev, dtype)
    dt = _t(rng.standard_normal((rows, L, R if fuse else D)) * 0.5, dev, dtype)
    Bm = _t(rng.standard_normal((rows, L, N)), dev, dtype)
    Cm = _t(rng.standard_normal((rows, L, N)), dev, dtype)
    A = _t(-np.exp(rng.standard_normal((D, N)) * 0.5), dev)
    Ds = _t(rng.standard_normal(D), dev)
    dtb = _t(rng.standard_normal(D) * 0.3, dev)
    w = _t(rng.standard_normal((R, D)) * 0.3, dev) if fuse else None
    return x, dt, A, Bm, Cm, Ds, dtb, w


def _close_to_scale(got, want, rel, name=""):
    """max |got - want| within ``rel`` of max |want| (sums over channels and
    steps are taken in other orders by the kernel and the plain version)."""
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * max(scale, 1e-30), (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_hb_matches_plain(cuda, dtype, fuse, reverse):
    """K1's training variant: y and the chunk-entry states hb (ragged last
    chunk: L = 200 is not a multiple of 16)."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    args = _scan_case(np.random.default_rng(3), cuda, dtype, fuse)
    before = cuda_scan.scan_fwd.hb_launches
    y, hb = cuda_scan.scan_fwd(*args, reverse=reverse, hb_chunk=HB_CHUNK)
    torch.cuda.synchronize()
    assert cuda_scan.scan_fwd.hb_launches == before + 1
    y_p, hb_p = cuda_scan.scan_fwd_plain(*args, reverse=reverse, hb_chunk=HB_CHUNK)
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
    _close_to_scale(hb, hb_p, 1e-4, "hb")  # both float32 from the same inputs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N", [4, 8, 16, 32])
@pytest.mark.parametrize("L", [200, 512])
def test_scan_bwd_kernel_matches_plain(cuda, dtype, fuse, reverse, N, L):
    """K3 against its plain version on the same inputs and hb: every output
    float32, within 1e-4 of its scale (only the order of sums differs).
    Every state size the kernel takes; a ragged last hb chunk (L 200) and
    the model's 512 steps; 160 channels, a ragged last channel tile."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, dtype, fuse, L=L, N=N)
    gy = _t(rng.standard_normal(tuple(x.shape)), cuda, dtype)
    _, hb = cuda_scan.scan_fwd_plain(x, dt, A, Bm, Cm, Ds, dtb, w, reverse, HB_CHUNK)
    before = cuda_scan.scan_bwd.launches
    got = cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse)
    torch.cuda.synchronize()
    assert cuda_scan.scan_bwd.launches == before + 1
    want = cuda_scan.scan_bwd_plain(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse)
    names = ["dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD", "dW"]
    for n, g, wnt in zip(names, got, want):
        if wnt is None:
            assert g is None, n
            continue
        assert g.shape == wnt.shape, n
        _close_to_scale(g, wnt, 1e-4, n)


def test_scan_bwd_is_deterministic_with_strided_inputs(cuda):
    """K3 on the mixer's inputs (bf16 x/gy, float32 dt_lr/B/C as views of one
    buffer): two launches give bit-identical results (no atomics)."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(5)
    rows, L, D, N, R = 4, 256, 384, 16, 24
    x = _t(rng.standard_normal((rows, L, D)), cuda, torch.bfloat16)
    gy = _t(rng.standard_normal((rows, L, D)), cuda, torch.bfloat16)
    dbc = _t(rng.standard_normal((rows, L, R + 2 * N)) * 0.5, cuda)
    dt_lr, Bm, Cm = dbc[..., :R], dbc[..., R:R + N], dbc[..., R + N:]
    A = _t(-np.exp(rng.standard_normal((D, N)) * 0.5), cuda)
    Ds, dtb = _t(rng.standard_normal(D), cuda), _t(rng.standard_normal(D) * 0.3, cuda)
    w = _t(rng.standard_normal((R, D)) * 0.3, cuda)
    _, hb = cuda_scan.scan_fwd_plain(x, dt_lr, A, Bm, Cm, Ds, dtb, w, True, HB_CHUNK)
    a = cuda_scan.scan_bwd(x, gy, dt_lr, A, Bm, Cm, Ds, dtb, hb, w, reverse=True)
    b = cuda_scan.scan_bwd(x, gy, dt_lr, A, Bm, Cm, Ds, dtb, hb, w, reverse=True)
    want = cuda_scan.scan_bwd_plain(x, gy, dt_lr, A, Bm, Cm, Ds, dtb, hb, w, reverse=True)
    for u, v, p in zip(a, b, want):
        assert torch.equal(u, v)
        _close_to_scale(u, p, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixer_res_kernel_matches_plain(cuda, dtype, reverse):
    """K2's residual variant: y, acc (xi's dtype), dt_lr/B/C and hb (float32)."""
    rng = np.random.default_rng(6)
    B, L, D, N, R, K = 3, 200, 96, 16, 8, 4
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, cuda)
    xi = _t(rng.standard_normal((B, L, D)), cuda, dtype)
    args = (f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -torch.abs(f(D, N)) - 0.3, f(D))
    before = cuda_mixer.mixer_fwd.res_launches
    got = cuda_mixer.mixer_fwd(xi, *args, reverse=reverse, emit_res=True)
    torch.cuda.synchronize()
    assert cuda_mixer.mixer_fwd.res_launches == before + 1
    want = cuda_mixer.mixer_fwd_plain(xi, *args, reverse=reverse, emit_res=True)
    rtol, atol = TOL[dtype]
    for name, g, w in zip(["y", "acc"], got[:2], want[:2]):
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)
    for name, g, w in zip(["dt_lr", "B", "C", "hb"], got[2:], want[2:]):
        _close_to_scale(g, w, 1e-4, name)


@pytest.mark.parametrize("emit_res", [False, True], ids=["fwd", "res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N", [4, 32])
@pytest.mark.parametrize("L", [1, 17, 200, 513])
def test_mixer_kernel_ragged_lengths(cuda, L, N, reverse, dtype, emit_res):
    """K2 and K2-res at lengths ragged against the 16-step hb groups, the
    scan's chunk (max(16, N) steps) and the x_proj's 64-step time tile, at
    N 4 and 32 (the reduce-scatter's narrowest and widest groups; J = R + 2N
    takes both register tilings of the x_proj), D ragged against every
    channel tile."""
    rng = np.random.default_rng(40 + L + N)
    B, D, R, K = 2, 72, 8, 4
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, cuda)
    xi = _t(rng.standard_normal((B, L, D)), cuda, dtype)
    args = (f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -torch.abs(f(D, N)) - 0.3, f(D))
    got = cuda_mixer.mixer_fwd(xi, *args, reverse=reverse, emit_res=emit_res)
    torch.cuda.synchronize()
    want = cuda_mixer.mixer_fwd_plain(xi, *args, reverse=reverse, emit_res=emit_res)
    got, want = (got, want) if emit_res else ((got,), (want,))
    rtol, atol = TOL[dtype]
    for name, g, w in zip(["y", "acc"], got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)
    for name, g, w in zip(["dt_lr", "B", "C", "hb"], got[2:], want[2:]):
        assert g.shape == w.shape, name
        _close_to_scale(g, w, 1e-4, name)


@pytest.mark.parametrize("emit_res", [False, True], ids=["fwd", "res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_kernel_is_deterministic(cuda, dtype, emit_res):
    """Two launches of K2 (each variant) give equal bits: every sum has one
    order (no atomics)."""
    rng = np.random.default_rng(44)
    B, L, D, N, R, K = 2, 300, 160, 16, 24, 4
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, cuda)
    xi = _t(rng.standard_normal((B, L, D)), cuda, dtype)
    args = (f(D, K), f(D), f(D, R), f(D, N), f(D, N), f(R, D), f(D),
            -torch.abs(f(D, N)) - 0.3, f(D))
    for rev in (False, True):
        a = cuda_mixer.mixer_fwd(xi, *args, reverse=rev, emit_res=emit_res)
        b = cuda_mixer.mixer_fwd(xi, *args, reverse=rev, emit_res=emit_res)
        for u, v in zip(*((a, b) if emit_res else ((a,), (b,)))):
            assert torch.equal(u, v)


def test_autograd_functions_match_plain_autograd(cuda):
    """SelectiveScanFn (both dt modes) and BimambaMixerFn gradients on the
    card against autograd through the plain versions, float32."""
    rng = np.random.default_rng(7)
    for fuse, reverse in ((True, False), (False, True)):
        ins = [t.requires_grad_() if t is not None else None
               for t in _scan_case(rng, cuda, torch.float32, fuse, rows=2, L=96, D=130)]
        gw = _t(rng.standard_normal(tuple(ins[0].shape)), cuda)
        leaves = [t for t in ins if t is not None]
        want = torch.autograd.grad((cuda_scan.scan_fwd_plain(*ins, reverse) * gw).sum(), leaves)
        got = torch.autograd.grad((cuda_scan.selective_scan(*ins, reverse=reverse) * gw).sum(),
                                  leaves)
        for g, w in zip(got, want):
            _close_to_scale(g, w, 1e-4)
    B, L, D, N, R, K = 2, 96, 64, 16, 8, 4
    f = lambda *s: _t(rng.standard_normal(s) * 0.3, cuda).requires_grad_()
    ins = [f(B, L, D), f(B, L, D), f(2, D, K), f(2, D), f(2, D, R), f(2, D, N), f(2, D, N),
           f(2, R, D), f(2, D), (-torch.abs(f(2, D, N)) - 0.3).detach().requires_grad_(),
           f(2, D)]
    gw = _t(rng.standard_normal((B, L, D)), cuda)
    want = torch.autograd.grad(
        (cuda_mixer.bimamba_mixer_fused(*ins, use_kernels=False) * gw).sum(), ins)
    before = (cuda_mixer.mixer_fwd.res_launches, cuda_scan.scan_bwd.launches)
    got = torch.autograd.grad((cuda_mixer.bimamba_mixer(*ins) * gw).sum(), ins)
    assert (cuda_mixer.mixer_fwd.res_launches - before[0],
            cuda_scan.scan_bwd.launches - before[1]) == (2, 2)
    for g, w in zip(got, want):
        _close_to_scale(g, w, 1e-4)


@pytest.mark.parametrize("overrides, k2, k1", [
    ({}, 2, 0),                                    # tied + add: K2 fuse_in per direction
    (dict(bidirectional_weight_tie=False), 0, 2),  # general path, dt in the kernel
    (dict(bidirectional=False, rcps=False), 0, 1),  # general path, dt outside
])
def test_model_forward_kernels_match_plain_path(cuda, overrides, k2, k1):
    """A 2-layer model's logits through the kernels against the plain path
    on the card (fp32, 1e-4 of the logits' scale), with the launch counts
    each mixer path must show."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=64, n_layer=2, **overrides)
    model = Caduceus(cfg, init_params(cfg, seed=4)).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(2).integers(7, 11, (4, 96))).to(cuda)
    before = (cuda_mixer.mixer_fwd.x_launches, cuda_scan.scan_fwd.launches)
    with torch.inference_mode():
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        after = (cuda_mixer.mixer_fwd.x_launches, cuda_scan.scan_fwd.launches)
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
    assert (after[0] - before[0], after[1] - before[1]) == (k2 * 2, k1 * 2)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("overrides", [{}, dict(bidirectional_weight_tie=False)],
                         ids=["tied_add", "untied"])
def test_frozen_layer_gradient_flows_through_kernels(cuda, overrides):
    """Layer 0 frozen, the rest trained: the embedding's gradient through
    the kernels' autograd Functions equals the plain path's (fp32, 1e-4 of
    its scale), and layer 0 launches K3 like every other layer."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, forward, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=64, n_layer=2, **overrides)
    params = init_params(cfg, seed=4)
    ids = torch.from_numpy(np.random.default_rng(3).integers(7, 11, (2, 96))).to(cuda)
    grads = {}
    for use_kernels in (True, False):
        model = Caduceus(cfg, params).requires_grad_().to(cuda)
        model.layers[0].requires_grad_(False)
        before = cuda_scan.scan_bwd.launches
        forward(model, ids, dtype=torch.float32,
                use_kernels=use_kernels)["logits"].square().mean().backward()
        torch.cuda.synchronize()
        assert cuda_scan.scan_bwd.launches - before == (4 if use_kernels else 0)
        grads[use_kernels] = model.embedding.grad
    assert grads[False].abs().max() > 0
    _close_to_scale(grads[True], grads[False], 1e-4)


# -- Mamba-2: K4 (ssd_fwd) and K5 (mixer2_fwd) -------------------------------------

# Kernel vs plain version at P = N = chunk = 128: float32, only the order of
# sums differs (products over 128, the state across chunks); bfloat16, both
# round the product operands to 8 mantissa bits but at other points (the
# plain version folds dt' into the scores, the kernel into x), and the
# output itself to bfloat16: 2**-7 of the output's scale.
SSD_TOL = {torch.float32: 1e-3, torch.bfloat16: 2 ** -7}


def _ssd_case(rng, dev, dtype, R=2, L=256, H=2, NG=1):
    P = N = 128
    x = _t(rng.standard_normal((R, L, H * P)), dev, dtype)
    dt = _t(rng.standard_normal((R, L, H)) * 0.5 - 1.0, dev, dtype)
    Bm = _t(rng.standard_normal((R, L, NG, N)) * 0.3, dev, dtype)
    Cm = _t(rng.standard_normal((R, L, NG, N)) * 0.3, dev, dtype)
    A = _t(-np.exp(rng.standard_normal(H) * 0.5), dev)
    Ds = _t(rng.standard_normal(H), dev)
    dtb = _t(rng.standard_normal(H) * 0.3, dev)
    return x, dt, A, Bm, Cm, Ds, dtb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ng", [1, 2])
def test_ssd_kernel_matches_plain(cuda, dtype, reverse, ng):
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    args = _ssd_case(np.random.default_rng(5), cuda, dtype, NG=ng)
    before = cuda_ssd.ssd_dir.launches
    got = cuda_ssd.ssd_dir(*args, 128, reverse)
    torch.cuda.synchronize()
    assert cuda_ssd.ssd_dir.launches == before + 1
    want = cuda_ssd.ssd_dir_plain(*args, 128, reverse)
    assert got.dtype == dtype
    _close_to_scale(got, want, SSD_TOL[dtype], "ssd_dir")


def _mixer2_case(rng, dev, dtype, R=2, L=256, H=2, NG=1, K=4):
    di, NGN = H * 128, NG * 128
    f = lambda *s, sc=1.0: _t(rng.standard_normal(s) * sc, dev)
    acts = [_t(rng.standard_normal(s) * sc, dev, dtype)
            for s, sc in (((R, L, di), 1.0), ((R, L, di), 1.0), ((R, L, NGN), 1.0),
                          ((R, L, NGN), 1.0), ((R, L, H), 0.5))]
    weights = [f(di, K, sc=0.5), f(di, sc=0.3), f(NGN, K, sc=0.5), f(NGN, sc=0.3),
               f(NGN, K, sc=0.5), f(NGN, sc=0.3), 1 + f(di, sc=0.2),
               -torch.exp(f(H, sc=0.5)), f(H), f(H, sc=0.3)]
    return acts + weights, dict(d_state=128, eps=1e-5, chunk=128)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixer2_kernel_matches_plain(cuda, dtype, reverse):
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    args, kw = _mixer2_case(np.random.default_rng(6), cuda, dtype)
    before = cuda_mixer2.mamba2_mixer_interior.launches
    got = cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=reverse)
    torch.cuda.synchronize()
    assert cuda_mixer2.mamba2_mixer_interior.launches == before + 1
    want = cuda_mixer2.mamba2_mixer_interior_plain(*args, **kw, reverse=reverse)
    assert got.dtype == dtype
    _close_to_scale(got, want, SSD_TOL[dtype], "mamba2_mixer_interior")


def test_ssd_kernels_are_deterministic(cuda):
    """Two launches of K4 and of K5 give equal bits (no atomics: K5's norm
    sums its per-head partials in head order)."""
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    args = _ssd_case(np.random.default_rng(7), cuda, torch.bfloat16)
    assert torch.equal(cuda_ssd.ssd_dir(*args, 128, True), cuda_ssd.ssd_dir(*args, 128, True))
    margs, kw = _mixer2_case(np.random.default_rng(8), cuda, torch.float32, H=3)
    a = cuda_mixer2.mamba2_mixer_interior(*margs, **kw, reverse=False)
    b = cuda_mixer2.mamba2_mixer_interior(*margs, **kw, reverse=False)
    assert torch.equal(a, b)


def test_ssd_wrappers_reject_bad_input(cuda):
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    x, dt, A, Bm, Cm, Ds, dtb = _ssd_case(np.random.default_rng(9), cuda, torch.float32)
    with pytest.raises(ValueError, match="chunk"):
        cuda_ssd.ssd_dir(x, dt, A, Bm, Cm, Ds, dtb, 64, False)
    with pytest.raises(ValueError, match="does not divide"):
        cuda_ssd.ssd_dir(x[:, :200].contiguous(), dt[:, :200].contiguous(), A,
                         Bm[:, :200].contiguous(), Cm[:, :200].contiguous(), Ds, dtb, 128,
                         False)
    with pytest.raises(ValueError, match="head dim"):
        cuda_ssd.ssd_dir(x.reshape(2, 256, 4, 64).reshape(2, 256, 256),
                         torch.cat([dt, dt], -1), torch.cat([A, A]), Bm, Cm,
                         torch.cat([Ds, Ds]), torch.cat([dtb, dtb]), 128, False)
    with pytest.raises(ValueError, match="dtype"):
        cuda_ssd.ssd_dir(x.half(), dt.half(), A, Bm.half(), Cm.half(), Ds, dtb, 128, False)
    with pytest.raises(ValueError, match="dtype"):
        cuda_ssd.ssd_dir(x, dt.bfloat16(), A, Bm, Cm, Ds, dtb, 128, False)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_ssd.ssd_dir(x, dt, A, Bm.transpose(0, 1).contiguous().transpose(0, 1), Cm, Ds,
                         dtb, 128, False)
    margs, kw = _mixer2_case(np.random.default_rng(10), cuda, torch.float32)
    with pytest.raises(ValueError, match="d_state"):
        cuda_mixer2.mamba2_mixer_interior(*margs, **dict(kw, d_state=64), reverse=False)
    bad = list(margs)
    bad[1] = bad[1].bfloat16()  # z in another dtype than xi
    with pytest.raises(ValueError, match="dtype"):
        cuda_mixer2.mamba2_mixer_interior(*bad, **kw, reverse=False)


@pytest.mark.parametrize("overrides", [{}, dict(bidirectional_weight_tie=False, n_groups=2),
                                       dict(bidirectional=False, rcps=False)],
                         ids=["tied_add", "untied_ng2", "unidirectional"])
def test_model2_forward_kernels_match_plain_path(cuda, overrides):
    """A 2-layer l20-ssd-width model (d_model 384, H 6, P = N = 128): logits
    through K5 against the plain path (fp32, 1e-3 of the logits' scale),
    with one K5 launch per direction and layer."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    cfg = CaduceusConfig.preset("l20-ssd", n_layer=2, **overrides)
    model = Caduceus(cfg, init_params(cfg, seed=4)).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(2).integers(7, 11, (4, 256))).to(cuda)
    before = cuda_mixer2.mamba2_mixer_interior.launches
    with torch.inference_mode():
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        launched = cuda_mixer2.mamba2_mixer_interior.launches - before
        want = model(ids, dtype=torch.float32, use_kernels=False)["logits"]
    assert launched == cfg.n_directions * cfg.n_layer
    _close_to_scale(got, want, 1e-3, "logits")


# -- Mamba-2 training: K4-fentry, K5-res and K6 (ssd_bwd) ------------------------------

# float32 outputs computed by kernel and plain version from the same inputs
# (K6's gradients, the entry states): only the order of sums differs.
F32_TOL = 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_ssd_fentry_kernel_matches_plain(cuda, dtype, reverse):
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    args = _ssd_case(np.random.default_rng(21), cuda, dtype, H=4, NG=2)
    before = cuda_ssd.ssd_dir.fentry_launches
    y, fe = cuda_ssd.ssd_dir(*args, 128, reverse, emit_fentry=True)
    torch.cuda.synchronize()
    assert cuda_ssd.ssd_dir.fentry_launches == before + 1
    y_p, fe_p = cuda_ssd.ssd_dir_plain(*args, 128, reverse, emit_fentry=True)
    assert y.dtype == dtype and fe.dtype == torch.float32 and fe.shape == fe_p.shape
    _close_to_scale(y, y_p, SSD_TOL[dtype], "y")
    _close_to_scale(fe, fe_p, SSD_TOL[dtype] if dtype == torch.bfloat16 else F32_TOL, "fentry")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_mixer2_res_kernel_matches_plain(cuda, dtype, reverse):
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    args, kw = _mixer2_case(np.random.default_rng(22), cuda, dtype)
    before = cuda_mixer2.mamba2_mixer_interior.res_launches
    got = cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=reverse, emit_residuals=True)
    torch.cuda.synchronize()
    assert cuda_mixer2.mamba2_mixer_interior.res_launches == before + 1
    want = cuda_mixer2.mamba2_mixer_interior_plain(*args, **kw, reverse=reverse,
                                                   emit_residuals=True)
    for name, g, w in zip(("u", "accx", "accB", "accC", "fentry", "y"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = SSD_TOL[dtype] if (dtype == torch.bfloat16 or name != "fentry") else F32_TOL
        _close_to_scale(g, w, tol, name)


@pytest.mark.parametrize("emit", [False, True], ids=["fwd", "res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [128, 1024])
def test_mixer2_kernel_chunk_counts(cuda, L, reverse, dtype, emit):
    """K5 and K5-res at one chunk (no state enters any chunk: the pass only
    writes zeros) and at eight (the state passed across seven boundaries),
    with H 4 in NG 2 groups (the group's first head writes accB and accC)."""
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    args, kw = _mixer2_case(np.random.default_rng(50 + L), cuda, dtype, L=L, H=4, NG=2)
    got = cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=reverse, emit_residuals=emit)
    torch.cuda.synchronize()
    want = cuda_mixer2.mamba2_mixer_interior_plain(*args, **kw, reverse=reverse,
                                                   emit_residuals=emit)
    names = ("u", "accx", "accB", "accC", "fentry", "y")
    for name, g, w in zip(names, *((got, want) if emit else ((got,), (want,)))):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = SSD_TOL[dtype] if (dtype == torch.bfloat16 or name != "fentry") else F32_TOL
        _close_to_scale(g, w, tol, name)


@pytest.mark.parametrize("emit", [False, True], ids=["fwd", "res"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer2_kernel_is_deterministic(cuda, dtype, emit):
    """Two launches of K5 (each variant) give equal bits: the pass chains
    the states in one order, the norm sums the heads in order."""
    from plantcaduceus_tpu_torch.ops import cuda_mixer2

    args, kw = _mixer2_case(np.random.default_rng(56), cuda, dtype, L=512, H=4, NG=2)
    for rev in (False, True):
        a = cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=rev, emit_residuals=emit)
        b = cuda_mixer2.mamba2_mixer_interior(*args, **kw, reverse=rev, emit_residuals=emit)
        for u, v in zip(*((a, b) if emit else ((a,), (b,)))):
            assert torch.equal(u, v)


def _ssd_bwd_case(rng, dev, dtype, pre_silu, reverse, NG=1, H=None, L=256):
    """K6's arguments: _ssd_case's (H defaults to two heads a group), the
    plain forward's entry states (from SiLU of the accumulators in pre_silu
    mode) and a cotangent."""
    import torch.nn.functional as F

    from plantcaduceus_tpu_torch.ops import cuda_ssd

    x, dt, A, Bm, Cm, Ds, dtb = _ssd_case(rng, dev, dtype, L=L, H=H or 2 * NG, NG=NG)
    act = (lambda t: F.silu(t.float()).to(dtype)) if pre_silu else (lambda t: t)
    _, fe = cuda_ssd.ssd_dir_plain(act(x), dt, A, act(Bm), act(Cm), Ds, dtb, 128, reverse,
                                   emit_fentry=True)
    g = _t(rng.standard_normal(tuple(x.shape)), dev, dtype)
    return (x, dt, A, Bm, Cm, Ds, dtb, fe, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pre_silu", [False, True])
@pytest.mark.parametrize("ng", [1, 2])
@pytest.mark.parametrize("heads, L", [(None, 256), (6, 512)], ids=["small", "l20ssd"])
def test_ssd_bwd_kernel_matches_plain(cuda, dtype, reverse, pre_silu, ng, heads, L):
    """K6 in both modes against its plain version (ops/ssd_bwd.py), every
    output: float32, 1e-3 of each output's scale; bfloat16 inputs, 2**-7
    (both round the same product operands; an operand whose float32 value
    lies near a rounding boundary can round the other way). Two layouts:
    two heads a group over two chunks, and l20-ssd's six heads over four
    chunks, so the cotangent state crosses three chunk boundaries."""
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    args = _ssd_bwd_case(np.random.default_rng(23 + ng), cuda, dtype, pre_silu, reverse, ng,
                         H=heads, L=L)
    counter = "pre_silu_launches" if pre_silu else "launches"
    before = getattr(cuda_ssd.ssd_dir_bwd, counter)
    got = cuda_ssd.ssd_dir_bwd(*args, 128, reverse, pre_silu=pre_silu)
    torch.cuda.synchronize()
    assert getattr(cuda_ssd.ssd_dir_bwd, counter) == before + 1
    want = cuda_ssd.ssd_dir_bwd_plain(*args, 128, reverse, pre_silu=pre_silu)
    assert len(got) == len(want) == (7 if pre_silu else 5)
    tol = F32_TOL if dtype == torch.float32 else SSD_TOL[dtype]
    for name, g, w in zip(("dx", "dB", "dC", "ddt_raw", "dmass", "gx", "dtp"), got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        _close_to_scale(g, w, tol, name)


def test_ssd_bwd_is_deterministic(cuda):
    """Two launches of K6 give equal bits in both modes (no atomics: the
    heads' partials are summed in head order)."""
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    for pre_silu in (False, True):
        args = _ssd_bwd_case(np.random.default_rng(31), cuda, torch.bfloat16, pre_silu, True,
                             NG=2)
        a = cuda_ssd.ssd_dir_bwd(*args, 128, True, pre_silu=pre_silu)
        b = cuda_ssd.ssd_dir_bwd(*args, 128, True, pre_silu=pre_silu)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_ssd_training_functions_match_plain_autograd(cuda):
    """Mamba2InteriorFn (K5-res, K6 pre_silu) and SsdDirFn (K4-fentry, K6)
    gradients of every input on the card against autograd through the plain
    versions, float32, 1e-3 of each gradient's scale."""
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    for reverse in (False, True):
        args, kw = _mixer2_case(np.random.default_rng(41 + reverse), cuda, torch.float32)
        ins = [t.requires_grad_() for t in args]
        gw = _t(np.random.default_rng(5).standard_normal(tuple(args[0].shape)), cuda)
        want = torch.autograd.grad((cuda_mixer2.mamba2_mixer_interior_plain(
            *ins, **kw, reverse=reverse) * gw).sum(), ins)
        before = (cuda_mixer2.mamba2_mixer_interior.res_launches,
                  cuda_ssd.ssd_dir_bwd.pre_silu_launches)
        got = torch.autograd.grad((cuda_mixer2.mamba2_mixer_interior_train(
            *ins, **kw, reverse=reverse) * gw).sum(), ins)
        assert (cuda_mixer2.mamba2_mixer_interior.res_launches - before[0],
                cuda_ssd.ssd_dir_bwd.pre_silu_launches - before[1]) == (1, 1)
        for i, (g, w) in enumerate(zip(got, want)):
            _close_to_scale(g, w, F32_TOL, f"interior input {i}")

        ins = [t.requires_grad_() for t in _ssd_case(np.random.default_rng(43 + reverse), cuda,
                                                     torch.float32, H=4, NG=2)]
        gw = _t(np.random.default_rng(6).standard_normal(tuple(ins[0].shape)), cuda)
        want = torch.autograd.grad(
            (cuda_ssd.ssd_dir_plain(*ins, 128, reverse) * gw).sum(), ins)
        before = (cuda_ssd.ssd_dir.fentry_launches, cuda_ssd.ssd_dir_bwd.launches)
        got = torch.autograd.grad((cuda_ssd.ssd_dir_train(*ins, 128, reverse) * gw).sum(), ins)
        assert (cuda_ssd.ssd_dir.fentry_launches - before[0],
                cuda_ssd.ssd_dir_bwd.launches - before[1]) == (1, 1)
        for i, (g, w) in enumerate(zip(got, want)):
            _close_to_scale(g, w, F32_TOL, f"ssd_dir input {i}")


@pytest.mark.parametrize("overrides", [{}, dict(bidirectional_weight_tie=False, n_groups=2)],
                         ids=["tied_add", "untied_ng2"])
def test_model2_train_kernels_match_plain_path(cuda, overrides):
    """One fp32 training step of a 2-layer l20-ssd-width model with layer 0
    frozen: every trained parameter's gradient through K5-res and K6 against
    the plain path (1e-3 of its max |grad|), with one K5-res and one K6
    launch per direction and layer."""
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params, mlm_loss
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd

    cfg = CaduceusConfig.preset("l20-ssd", n_layer=2, **overrides)
    params = init_params(cfg, seed=5)
    ids = torch.from_numpy(np.random.default_rng(4).integers(7, 11, (2, 256))).to(cuda)
    grads = {}
    for use_kernels in (True, False):
        model = Caduceus(cfg, params).requires_grad_().to(cuda)
        model.layers[0].requires_grad_(False)
        before = (cuda_mixer2.mamba2_mixer_interior.res_launches,
                  cuda_ssd.ssd_dir_bwd.pre_silu_launches)
        mlm_loss(model(ids, dtype=torch.float32, use_kernels=use_kernels)["logits"],
                 ids).backward()
        torch.cuda.synchronize()
        n = cfg.n_directions * cfg.n_layer if use_kernels else 0
        assert (cuda_mixer2.mamba2_mixer_interior.res_launches - before[0],
                cuda_ssd.ssd_dir_bwd.pre_silu_launches - before[1]) == (n, n)
        grads[use_kernels] = {k: p.grad for k, p in model.named_parameters()
                              if p.grad is not None}
    assert grads[True].keys() == grads[False].keys() and "embedding" in grads[False]
    for k, w in grads[False].items():
        _close_to_scale(grads[True][k], w, 1e-3, k)


# K7/K8 (flash attention) cases: ALiBi symmetric and asymmetric (the latter
# with causal), causal, window 128, ALiBi + window 128.
ATTN_CASES = {"alibi": dict(alibi=True), "causal": dict(causal=True),
              "window128": dict(window=128), "alibi_window128": dict(alibi=True, window=128),
              "alibi_asym": dict(alibi=True, causal=True, symmetric=False)}
# bfloat16: the kernel rounds the score operand of p.v (and ds, p^T of the
# backward products) to bf16 and the outputs to bf16: 2**-7 of the scale.
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


def _attn_case(rng, dev, dtype, case, B=2, L=200, H=3, hd=64):
    from plantcaduceus_tpu_torch.ops.attention import alibi_slopes

    q, k, v, do = (_t(rng.standard_normal((B, L, H, hd)), dev, dtype) for _ in range(4))
    kw = dict(ATTN_CASES[case])
    slopes = alibi_slopes(H, dev) if kw.pop("alibi", False) else None
    return (q, k, v, slopes), do, kw


@pytest.mark.parametrize("L", [256, 200])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attn_kernels_match_plain(cuda, case, dtype, hd, L):
    """K7 (o, lse) and K8 (dq, dk, dv) against their plain versions; L 200
    ends in a ragged tile."""
    from plantcaduceus_tpu_torch.ops import cuda_attention, flash_plain

    args, do, kw = _attn_case(np.random.default_rng(51), cuda, dtype, case, L=L, hd=hd)
    before = (cuda_attention.flash_fwd.launches, cuda_attention.flash_bwd.launches)
    o, lse = cuda_attention.flash_fwd(*args, **kw)
    grads = cuda_attention.flash_bwd(*args[:3], o, do, lse, args[3], **kw)
    torch.cuda.synchronize()
    assert (cuda_attention.flash_fwd.launches - before[0],
            cuda_attention.flash_bwd.launches - before[1]) == (1, 1)
    o_w, lse_w = flash_plain.flash_fwd_plain(*args, **kw)
    assert o.dtype == dtype and lse.dtype == torch.float32 and lse.shape == (2 * 3, L)
    _close_to_scale(o, o_w, ATTN_TOL[dtype], "o")
    _close_to_scale(lse, lse_w, 1e-5, "lse")
    want = flash_plain.flash_bwd_plain(*args[:3], o, do, lse, args[3], **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        _close_to_scale(g, w, ATTN_TOL[dtype], name)


@pytest.mark.parametrize("hd", [16, 48, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attn_padded_head_dims_match_plain(cuda, dtype, hd):
    """flash_attention at a head dim the kernels do not take (zero-padded to
    32, 64 or 128): o and the q/k/v gradients through K7/K8 (one launch
    each) against the plain versions at the true width; ALiBi, L 200."""
    from plantcaduceus_tpu_torch.ops import cuda_attention, flash_plain

    (q, k, v, slopes), do, _ = _attn_case(np.random.default_rng(57), cuda, dtype, "alibi",
                                          L=200, hd=hd)
    ins = [t.clone().requires_grad_() for t in (q, k, v)]
    before = (cuda_attention.flash_fwd.launches, cuda_attention.flash_bwd.launches)
    o = cuda_attention.flash_attention(*ins, alibi_slopes=slopes)
    grads = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    assert (cuda_attention.flash_fwd.launches - before[0],
            cuda_attention.flash_bwd.launches - before[1]) == (1, 1)
    o_w, lse_w = flash_plain.flash_fwd_plain(q, k, v, slopes)
    want = flash_plain.flash_bwd_plain(q, k, v, o_w, do, lse_w, slopes)
    assert o.shape == q.shape and o.dtype == dtype
    _close_to_scale(o, o_w, ATTN_TOL[dtype], "o")
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        assert g.shape == w.shape and g.dtype == dtype, name
        _close_to_scale(g, w, ATTN_TOL[dtype], name)


def test_attn_bwd_is_deterministic(cuda):
    """Two K8 launches give equal bits (no atomics), for a fused-qkv view."""
    from plantcaduceus_tpu_torch.ops import cuda_attention

    rng = np.random.default_rng(53)
    qkv = _t(rng.standard_normal((2, 192, 3 * 4, 64)), cuda, torch.bfloat16)
    q, k, v = qkv.split(4, dim=2)
    slopes = torch.linspace(0.5, 0.01, 4, device=cuda)
    o, lse = cuda_attention.flash_fwd(q, k, v, slopes, window=40)
    do = torch.randn_like(o)
    a = cuda_attention.flash_bwd(q, k, v, o, do, lse, slopes, window=40)
    b = cuda_attention.flash_bwd(q, k, v, o, do, lse, slopes, window=40)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    # the strided views give what contiguous copies give
    o2, _ = cuda_attention.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(), slopes,
                                     window=40)
    assert torch.equal(o, o2)


def test_attn_wrappers_reject_bad_input(cuda):
    from plantcaduceus_tpu_torch.ops import cuda_attention

    x = torch.zeros((1, 64, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        cuda_attention.flash_fwd(x, x, x)
    x = torch.zeros((1, 64, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        cuda_attention.flash_fwd(x.half(), x.half(), x.half())
    with pytest.raises(ValueError, match="strides"):
        cuda_attention.flash_fwd(x, x.transpose(1, 2).contiguous().transpose(1, 2), x)
    with pytest.raises(ValueError, match="slopes"):
        cuda_attention.flash_fwd(x, x, x, torch.zeros(3, device=cuda))
    o, lse = cuda_attention.flash_fwd(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.flash_bwd(x, x, x, o, o.transpose(1, 2).contiguous().transpose(1, 2),
                                 lse)


@pytest.mark.parametrize("overrides", [{}, dict(position="rope", local_window=48),
                                       dict(d_model=384, n_heads=8)],
                         ids=["alibi", "rope_window", "alibi_hd48"])
def test_bert_kernels_match_plain_path(cuda, overrides):
    """A 2-layer BERT of MosaicBERT-Base width (d_model 768, 12 heads; and
    d_model 384 with 8 heads of 48, which K7/K8 run zero-padded to 64):
    forward logits through K7 against the einsum path (fp32, 1e-4 of max
    |logit|, one K7 launch per layer), and the mlm_loss gradients through
    K7/K8 against autograd through the einsum path (1e-3 of each max
    |grad|, one K8 launch per layer)."""
    from plantcaduceus_tpu_torch.models import bert
    from plantcaduceus_tpu_torch.models.caduceus import mlm_loss
    from plantcaduceus_tpu_torch.ops import cuda_attention

    cfg = bert.BertConfig(**{"d_model": 768, "n_layer": 2, "n_heads": 12, **overrides})
    rng = np.random.default_rng(55)
    ids = torch.from_numpy(rng.integers(7, 11, (2, 320))).to(cuda)
    labels = torch.where(torch.from_numpy(rng.random((2, 320)) < 0.15).to(cuda), ids, -100)
    params = bert.init_params(cfg, seed=6)
    out, grads = {}, {}
    for use_kernels in (True, False):
        model = bert.build(cfg, params, device=cuda).requires_grad_()
        before = (cuda_attention.flash_fwd.launches, cuda_attention.flash_bwd.launches)
        out[use_kernels] = model(ids, dtype=torch.float32, use_kernels=use_kernels)["logits"]
        mlm_loss(out[use_kernels], labels).backward()
        torch.cuda.synchronize()
        n = cfg.n_layer if use_kernels else 0
        assert (cuda_attention.flash_fwd.launches - before[0],
                cuda_attention.flash_bwd.launches - before[1]) == (n, n)
        grads[use_kernels] = {k: p.grad for k, p in model.named_parameters()}
    _close_to_scale(out[True], out[False], 1e-4, "logits")
    for k, w in grads[False].items():
        _close_to_scale(grads[True][k], w, 1e-3, k)


# ---------------------------------------------------------------------------
# K1 (scan_core.cuh's forward scan with K1's load policy) at its edges, its
# carry options, and K4 (ssd_chunk.cuh's chunk-parallel kernels with K4's
# policy) at one chunk and at eight.


@pytest.mark.parametrize("hb", [False, True], ids=["fwd", "hb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("N", [4, 32])
@pytest.mark.parametrize("L", [1, 7, 513])
def test_scan_kernel_ragged_lengths(cuda, L, N, fuse, reverse, dtype, hb):
    """K1 and K1-hb at lengths ragged against the 8-step chunk and the
    16-step hb chunk, N 4 and 32 (at N 32 with R 12 the rows exceed the
    row prefetch's 1024 values), D ragged against the 128-channel block."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    args = _scan_case(np.random.default_rng(60 + L + N), cuda, dtype, fuse, rows=2, L=L, D=136,
                      N=N)
    kw = dict(reverse=reverse, hb_chunk=HB_CHUNK if hb else None)
    got = cuda_scan.scan_fwd(*args, **kw)
    torch.cuda.synchronize()
    want = cuda_scan.scan_fwd_plain(*args, **kw)
    got, want = (got, want) if hb else ((got,), (want,))
    rtol, atol = TOL[dtype]
    assert got[0].dtype == dtype and got[0].shape == want[0].shape
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=rtol, atol=atol)
    if hb:
        assert got[1].shape == want[1].shape
        _close_to_scale(got[1], want[1], 1e-4, "hb")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
def test_scan_kernel_steep_decays(cuda, dtype, fuse):
    """K1 where some chunks' decay exponents fall below -126 (dt' up to ~30
    against |A| up to ~10), so those chunks take exp2f's full path and the
    others the bare MUFU.EX2: both against the plain version."""
    rng = np.random.default_rng(61)
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, dtype, fuse, rows=2, L=160, D=130)
    dtb = dtb + _t(np.where(np.arange(130) % 3 == 0, 25.0, 0.0), cuda)
    A = A * 3
    for reverse in (False, True):
        got = cuda_scan.scan_fwd(x, dt, A, Bm, Cm, Ds, dtb, w, reverse=reverse)
        want = cuda_scan.scan_fwd_plain(x, dt, A, Bm, Cm, Ds, dtb, w, reverse=reverse)
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("L, split", [(512, 256), (513, 200)])
def test_scan_carry_chains_bit_for_bit(cuda, L, split, fuse, dtype):
    """K1's h0 / emit_hfin: two calls chained hfin -> h0 give the full
    call's y and hfin bit for bit, in both directions (reverse: the later
    part of the sequence first); with hb too, whose chunks line up where the
    split is a multiple of 16. h0 seeds the plain version alike."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(np.random.default_rng(62), cuda, dtype, fuse,
                                              rows=2, L=L, D=136)
    hbc = HB_CHUNK if split % HB_CHUNK == 0 else None
    part = lambda t, a, b: t[:, a:b].contiguous()
    for reverse in (False, True):
        full = cuda_scan.scan_fwd(x, dt, A, Bm, Cm, Ds, dtb, w, reverse, hbc, emit_hfin=True)
        spans = [(0, split), (split, L)]
        if reverse:
            spans = spans[::-1]
        h, ys, hbs = None, {}, []
        for a, b in spans:
            out = cuda_scan.scan_fwd(part(x, a, b), part(dt, a, b), A, part(Bm, a, b),
                                     part(Cm, a, b), Ds, dtb, w, reverse, hbc, h0=h,
                                     emit_hfin=True)
            ys[a], h = out[0], out[-1]
            if hbc:
                hbs.append(out[1])
        assert torch.equal(torch.cat([ys[0], ys[split]], 1), full[0])
        assert torch.equal(h, full[-1])
        if hbc:
            assert torch.equal(torch.cat(hbs, 1), full[1])
        torch.cuda.synchronize()
        want = cuda_scan.scan_fwd_plain(part(x, *spans[1]), part(dt, *spans[1]), A,
                                        part(Bm, *spans[1]), part(Cm, *spans[1]), Ds, dtb, w,
                                        reverse, h0=cuda_scan.scan_fwd_plain(
                                            part(x, *spans[0]), part(dt, *spans[0]), A,
                                            part(Bm, *spans[0]), part(Cm, *spans[0]), Ds, dtb,
                                            w, reverse, emit_hfin=True)[1], emit_hfin=True)
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(ys[spans[1][0]].float(), want[0].float(), rtol=rtol,
                                   atol=atol)
        _close_to_scale(h, want[1], 1e-4, "hfin")


@pytest.mark.parametrize("hb", [False, True], ids=["fwd", "hb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_kernel_is_deterministic(cuda, dtype, hb):
    """Two launches of K1 (each variant, both dt modes and directions, with
    h0 and hfin) give equal bits."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(63)
    for fuse in (True, False):
        args = _scan_case(rng, cuda, dtype, fuse, rows=2, L=300, D=136)
        h0 = _t(rng.standard_normal((2, 136, 16)), cuda)
        for rev in (False, True):
            kw = dict(reverse=rev, hb_chunk=HB_CHUNK if hb else None, h0=h0, emit_hfin=True)
            for u, v in zip(cuda_scan.scan_fwd(*args, **kw), cuda_scan.scan_fwd(*args, **kw)):
                assert torch.equal(u, v)


def test_scan_rejects_misaligned_h0(cuda):
    """h0 is read as float4s: a contiguous view that starts one float into
    its buffer is refused before the launch."""
    args = _scan_case(np.random.default_rng(64), cuda, torch.float32, False, rows=2, L=16,
                      D=136)
    h0 = torch.zeros(2 * 136 * 16 + 1, device=cuda)[1:].view(2, 136, 16)
    assert h0.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        cuda_scan.scan_fwd(*args, h0=h0)


@pytest.mark.parametrize("emit", [False, True], ids=["fwd", "fentry"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("L", [128, 1024])
def test_ssd_kernel_chunk_counts(cuda, L, reverse, dtype, emit):
    """K4 and K4-fentry at one chunk (no state enters any chunk: the pass
    only writes zeros) and at eight (the state passed across seven
    boundaries), H 4 in NG 2 groups."""
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    args = _ssd_case(np.random.default_rng(70 + L), cuda, dtype, L=L, H=4, NG=2)
    got = cuda_ssd.ssd_dir(*args, 128, reverse, emit_fentry=emit)
    torch.cuda.synchronize()
    want = cuda_ssd.ssd_dir_plain(*args, 128, reverse, emit_fentry=emit)
    got, want = (got, want) if emit else ((got,), (want,))
    for name, g, w in zip(("y", "fentry"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        tol = SSD_TOL[dtype] if (dtype == torch.bfloat16 or name == "y") else F32_TOL
        _close_to_scale(g, w, tol, name)


@pytest.mark.parametrize("emit", [False, True], ids=["fwd", "fentry"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_variants_are_deterministic(cuda, dtype, emit):
    """Two launches of K4 (each variant, both directions) give equal bits."""
    from plantcaduceus_tpu_torch.ops import cuda_ssd

    args = _ssd_case(np.random.default_rng(71), cuda, dtype, L=512, H=4, NG=2)
    for rev in (False, True):
        a = cuda_ssd.ssd_dir(*args, 128, rev, emit_fentry=emit)
        b = cuda_ssd.ssd_dir(*args, 128, rev, emit_fentry=emit)
        for u, v in zip(*((a, b) if emit else ((a,), (b,)))):
            assert torch.equal(u, v)


# The AR Mamba LM (models/mamba_lm.py): Mamba-1 through K1 with dt given
# (K1-hb and K3 under grad), Mamba-2 at the SSD kernels' shapes through K4
# (K4-fentry and K6 in plain mode under grad). 2 layers at the l20 widths.
MAMBA_LM = {"mamba1": dict(d_model=384, n_layer=2, vocab_size=256, d_state=16),
            "mamba2": dict(d_model=384, n_layer=2, vocab_size=256, ssm_variant="mamba2",
                           d_state=128, head_dim=128, chunk_size=128)}


def _lm_counts():
    from plantcaduceus_tpu_torch.ops import cuda_scan, cuda_ssd

    return dict(k1=cuda_scan.scan_fwd.launches, k1_hb=cuda_scan.scan_fwd.hb_launches,
                k3=cuda_scan.scan_bwd.launches, k4=cuda_ssd.ssd_dir.launches,
                k4_fentry=cuda_ssd.ssd_dir.fentry_launches, k6=cuda_ssd.ssd_dir_bwd.launches)


@pytest.mark.parametrize("variant", list(MAMBA_LM))
def test_mamba_lm_kernels_match_plain_path(cuda, variant):
    """fp32 logits (1e-3 of max |logit|) and ``nll_loss`` gradients (1e-3 of
    each parameter's max |grad|) with the kernels against the plain path,
    with one launch per layer of each kernel the path runs."""
    from plantcaduceus_tpu_torch.models import mamba_lm

    cfg = mamba_lm.MambaLmConfig(**MAMBA_LM[variant])
    model = mamba_lm.MambaLm(cfg, mamba_lm.init_params(cfg, seed=2)).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 256))).to(cuda)
    fwd, train = (("k1",), ("k1_hb", "k3")) if variant == "mamba1" else \
        (("k4",), ("k4_fentry", "k6"))
    logits, grads = {}, {}
    for use_kernels in (True, False):
        before = _lm_counts()
        with torch.no_grad():
            logits[use_kernels] = model(ids, dtype=torch.float32, use_kernels=use_kernels)[
                "logits"]
        model.requires_grad_()
        names, ps = zip(*model.named_parameters())
        loss = mamba_lm.nll_loss(model, ids, dtype=torch.float32, use_kernels=use_kernels)
        grads[use_kernels] = dict(zip(names, torch.autograd.grad(loss, ps)))
        model.requires_grad_(False)
        torch.cuda.synchronize()
        n = cfg.n_layer if use_kernels else 0
        got = {k: v - before[k] for k, v in _lm_counts().items()}
        assert got == {k: n if k in fwd + train else 0 for k in got}, got
    _close_to_scale(logits[True], logits[False], 1e-3, "logits")
    for k, w in grads[False].items():
        _close_to_scale(grads[True][k], w, 1e-3, k)


def test_mamba_lm_raises_where_ssd_kernels_lack_the_shape(cuda):
    """Head dim 256: JAX takes its SSD kernel there (a multiple of 128), K4
    and K6 take only 128, so the port raises on the card, with and without
    grad, rather than run the plain path on card tensors."""
    from plantcaduceus_tpu_torch.models import mamba_lm

    cfg = mamba_lm.MambaLmConfig(d_model=128, n_layer=1, vocab_size=16, ssm_variant="mamba2",
                                 d_state=128, head_dim=256, chunk_size=128)
    assert mamba_lm.ssd_supported(cfg, 128)
    model = mamba_lm.MambaLm(cfg, mamba_lm.init_params(cfg, seed=2)).to(cuda)
    ids = torch.from_numpy(np.random.default_rng(3).integers(0, 16, (2, 128))).to(cuda)
    with pytest.raises(ValueError, match="head dim 256"), torch.no_grad():
        model(ids, dtype=torch.float32)
    model.requires_grad_()
    with pytest.raises(ValueError, match="head dim 256"):
        mamba_lm.nll_loss(model, ids, dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixer_kernel_at_pc2_small_length(cuda, dtype):
    """K2 at PlantCAD2's 8192-bp window and pc2-small's widths (d_inner 1536,
    N 16, R 48), both directions, against its plain version (TOL)."""
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig.preset("pc2-small", n_layer=1)
    w = {k: v[0].to(cuda) for k, v in init_params(cfg, seed=4)["blocks"].items()}
    rng = np.random.default_rng(8)
    xi = _t(rng.standard_normal((2, 8192, cfg.d_inner)), cuda, dtype)
    A = -torch.exp(w["A_log"])
    for g in (0, 1):
        args = (xi, w["conv_w"][g], w["conv_b"][g], w["x_proj_dt"][g], w["x_proj_B"][g],
                w["x_proj_C"][g], w["dt_proj_w"][g], w["dt_proj_b"][g], A[g], w["D"][g])
        got = cuda_mixer.mixer_fwd(*args, reverse=bool(g))
        want = cuda_mixer.mixer_fwd_plain(*args, reverse=bool(g))
        rtol, atol = TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol, atol=atol)


def test_center_embeddings_kernels_match_plain_path(cuda):
    """The XGBoost and /embed path: fp32 ``center_embeddings`` through K2
    (two launches a layer a batch) against the model's plain path, within
    1e-3 of the largest |embedding| (20 layers of fp32 sums in two orders)."""
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=128, n_layer=4)
    model = Caduceus(cfg, init_params(cfg, seed=6))
    runner = InferenceRunner(model, cfg, dtype=torch.float32, batch_size=8, device=cuda)
    ids = np.random.default_rng(6).integers(7, 11, (12, 256))
    before = cuda_mixer.mixer_fwd.x_launches
    got = runner.center_embeddings(ids, 127, progress=False)
    assert cuda_mixer.mixer_fwd.x_launches == before + 2 * cfg.n_layer * 2
    with torch.inference_mode():
        h = model(torch.from_numpy(ids).to(cuda), dtype=torch.float32, output_hidden_states=True,
                  use_kernels=False)["hidden_states"][:, 127, :]
    d = h.shape[-1] // 2
    want = ((h[:, :d] + h[:, d:].flip(-1)) * 0.5).cpu().numpy()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_server_on_the_card_matches_in_process_scores(cuda):
    """``ScoringServer`` over a card runner, fp32: concurrent /score requests
    give ``score_table``'s scores within 1e-4, through K2."""
    import json
    import threading
    import urllib.request

    from plantcaduceus_tpu_torch.engine import zero_shot
    from plantcaduceus_tpu_torch.engine.runner import InferenceRunner
    from plantcaduceus_tpu_torch.engine.server import ScoringServer, ScoringService
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(d_model=128, n_layer=2)
    runner = InferenceRunner(Caduceus(cfg, init_params(cfg, seed=7)), cfg, dtype=torch.float32,
                             batch_size=16, device=cuda)
    tok = DnaTokenizer()
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), 128)) for _ in range(24)]
    rows = [{"sequences": s, "ref": s[63], "alt": "A" if s[63] != "A" else "C"} for s in seqs]
    want = zero_shot.score_table(runner, tok, zero_shot.Table(["ref", "alt", "sequences"], rows),
                                 token_idx=63, progress=False)  # the server's default, L // 2 - 1
    want = np.array([r["zeroShotScore"] for r in want.rows])
    server = ScoringServer(ScoringService(runner, tok), port=0)
    server.start_background()
    got = [None] * 4
    before = cuda_mixer.mixer_fwd.x_launches

    def one(i):
        body = {"items": [{"sequence": r["sequences"], "ref": r["ref"], "alt": r["alt"]}
                          for r in rows[i::4]]}
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/score",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got[i] = json.loads(r.read())["scores"]

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        server.shutdown()
    assert cuda_mixer.mixer_fwd.x_launches > before
    flat = np.empty(len(rows))
    for i in range(4):
        flat[i::4] = got[i]
    np.testing.assert_allclose(flat, want, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# LoRA and fine-tuning (train/lora.py)

LORA_CONFIGS = {
    "tied_add": dict(d_model=64, n_layer=2, d_state=16),
    "mamba2": dict(d_model=128, n_layer=2, ssm_variant="mamba2", d_state=128, head_dim=128,
                   chunk_size=128),
}


def _lora_case(cuda, name, seed=5):
    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import lora

    cfg = CaduceusConfig(**LORA_CONFIGS[name])
    model = Caduceus(cfg, init_params(cfg, seed=seed)).to(cuda)
    gen = torch.Generator().manual_seed(seed)
    adapters = lora.init_lora(gen, model, lora.LoraConfig(r=4))
    for ab in adapters.values():
        ab["b"].normal_(0.0, 0.05, generator=gen)
    head = heads.init_head(gen, cfg, 2)
    ids = torch.from_numpy(np.random.default_rng(seed).integers(7, 11, (3, 256))).to(cuda)
    return cfg, model, adapters, head, ids


@pytest.mark.parametrize("name", list(LORA_CONFIGS))
def test_lora_mixer_kernels_match_plain_path(cuda, name):
    """The activation path at dropout 0.1 (the same seeded masks both ways):
    fp32 logits (1e-3 of max |logit|) and adapter and head gradients (1e-3
    of each leaf's max |grad|) with the kernels (Mamba-1 tied/add: K1-hb and
    K3, dt fused, both directions; Mamba-2: K5-res and K6 pre_silu) against
    the plain path."""
    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd
    from plantcaduceus_tpu_torch.train import lora

    cfg, model, adapters, head, ids = _lora_case(cuda, name)
    cfg_l = lora.LoraConfig(r=4, dropout=0.1)
    counters = ((cuda_scan.scan_fwd, "hb_launches"), (cuda_scan.scan_bwd, "launches"),
                (cuda_mixer.mixer_fwd, "res_launches"),
                (cuda_mixer2.mamba2_mixer_interior, "res_launches"),
                (cuda_ssd.ssd_dir_bwd, "pre_silu_launches"))
    logits, grads = {}, {}
    for use_kernels in (True, False):
        before = [getattr(f, a) for f, a in counters]
        ad, hd = lora.trainable_copy(adapters, cuda), lora.trainable_copy(head, cuda)
        out = heads.sequence_logits(model, hd, ids, cfg, dtype=torch.float32, remat=True,
                                    lora=lora.lora_ctx(ad, cfg_l, dropout_seed=3),
                                    use_kernels=use_kernels)
        heads.task_loss(out, torch.tensor([0, 1, 1], device=cuda), "classification").backward()
        torch.cuda.synchronize()
        got = [getattr(f, a) - b for (f, a), b in zip(counters, before)]
        nl2 = 2 * cfg.n_layer if use_kernels else 0
        assert got == ([2 * nl2, nl2, 0, 0, 0] if name == "tied_add"
                       else [0, 0, 0, 2 * nl2, nl2]), got
        logits[use_kernels] = out.detach()
        grads[use_kernels] = {f"{n}.{k}": t.grad for n, ab in ad.items() for k, t in ab.items()}
        grads[use_kernels].update({f"head.{k}": t.grad for k, t in hd.items()})
    _close_to_scale(logits[True], logits[False], 1e-3, "logits")
    for k, w in grads[False].items():
        _close_to_scale(grads[True][k], w, 1e-3, k)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scan_hb_and_bwd_at_pc2_small_600(cuda, dtype):
    """K1-hb and K3 at the PlantCAD2 LoRA recipe's shape (600 bp = 37
    chunks of 16 and a tail of 8; pc2-small: d_inner 1536, N 16, R 48), dt
    fused, both directions, against their plain versions."""
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    cfg = CaduceusConfig.preset("pc2-small", n_layer=1)
    w = {k: v[0].to(cuda) for k, v in init_params(cfg, seed=6)["blocks"].items()}
    rng = np.random.default_rng(9)
    rows, L, D, N, R = 2, 600, cfg.d_inner, cfg.d_state, cfg.dt_rank
    x = _t(rng.standard_normal((rows, L, D)), cuda, dtype)
    gy = _t(rng.standard_normal((rows, L, D)), cuda, dtype)
    dt = _t(rng.standard_normal((rows, L, R)) * 0.5, cuda, dtype)
    Bm = _t(rng.standard_normal((rows, L, N)), cuda, dtype)
    Cm = _t(rng.standard_normal((rows, L, N)), cuda, dtype)
    A = -torch.exp(w["A_log"])
    rtol, atol = TOL[dtype]
    for g in (0, 1):
        args = (x, dt, A[g], Bm, Cm, w["D"][g], w["dt_proj_b"][g], w["dt_proj_w"][g], g == 1)
        y, hb = cuda_scan.scan_fwd(*args, hb_chunk=HB_CHUNK)
        y_p, hb_p = cuda_scan.scan_fwd_plain(*args, hb_chunk=HB_CHUNK)
        torch.testing.assert_close(y.float(), y_p.float(), rtol=rtol, atol=atol)
        _close_to_scale(hb, hb_p, 1e-3, f"hb {g}")
        got = cuda_scan.scan_bwd(x, gy, *args[1:7], hb, w["dt_proj_w"][g], g == 1)
        want = cuda_scan.scan_bwd_plain(x, gy, *args[1:7], hb, w["dt_proj_w"][g], g == 1)
        for n, a, b in zip(("dx", "ddt_lr", "dB", "dC", "dA", "ddt_bias", "dD", "dW"), got, want):
            _close_to_scale(a, b, 1e-3, f"{n} {g}")


def test_merged_infer_runs_k2_and_equals_the_activation_path(cuda):
    """``infer_fn`` merges the adapters and runs K2 (2 launches a layer);
    its fp32 logits equal the activation path's at dropout 0 (K1, dt
    fused) within 1e-4 of max |logit|."""
    from plantcaduceus_tpu_torch.models import heads
    from plantcaduceus_tpu_torch.train import lora
    from plantcaduceus_tpu_torch.train.optimizer import make_optimizer

    cfg, model, adapters, head, ids = _lora_case(cuda, "tied_add", seed=7)
    cfg_l = lora.LoraConfig(r=4, dropout=0.0)
    _, infer = lora.make_lora_train_step(cfg, cfg_l, make_optimizer(total_steps=1), model,
                                         dtype=torch.float32, device=cuda)
    state = lora.LoraTrainState(lora.trainable_copy(adapters, cuda),
                                lora.trainable_copy(head, cuda), None, 0)
    k2, k1 = cuda_mixer.mixer_fwd.x_launches, cuda_scan.scan_fwd.launches
    merged = infer(state, model, {"input_ids": ids.cpu().numpy()})
    torch.cuda.synchronize()
    assert cuda_mixer.mixer_fwd.x_launches - k2 == 2 * cfg.n_layer
    with torch.no_grad():
        act = heads.sequence_logits(model, state.head, ids, cfg, dtype=torch.float32,
                                    lora=lora.lora_ctx(state.adapters, cfg_l))
    assert cuda_scan.scan_fwd.launches - k1 == 2 * cfg.n_layer
    _close_to_scale(merged, act, 1e-4, "logits")


CONVERGENCE = dict(d_model=64, n_layer=2, vocab_size=16, d_state=8)  # train/convergence's


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_convergence_shape_kernels_match_plain_path(cuda, dtype):
    """The planted-structure harness's config (d_inner 128, N 8, R 4, 128
    bp, batch 16, no remat): one training step's loss and gradients through
    K2-res and K3 against the plain path (fp32: 1e-3 of each leaf's max
    |grad|; bf16: within twice the plain path's own worst bf16 gap from its
    fp32 gradient, the bound phase 11b of chip_smoke.py measures), and the
    probe forward through K2."""
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, forward, init_params, mlm_loss
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.train import convergence
    from plantcaduceus_tpu_torch.train.data import PretrainDataset
    from plantcaduceus_tpu_torch.train.step import to_device

    cfg = CaduceusConfig(**CONVERGENCE)
    assert (cfg.d_inner, cfg.d_state, cfg.dt_rank) == (128, 8, 4)
    corpus = convergence.planted_corpus(64, 128, seed=3)
    batch = to_device(PretrainDataset(corpus, DnaTokenizer(), 16, seed=3).batch_at(0), cuda)
    params = init_params(cfg, seed=4)
    grads = {}
    for use_kernels in (True, False):
        for dt in {dtype, torch.float32}:
            model = Caduceus(cfg, params).requires_grad_().to(cuda)
            res, bwd = cuda_mixer.mixer_fwd.res_launches, cuda_scan.scan_bwd.launches
            logits = forward(model, batch["input_ids"], dtype=dt, use_kernels=use_kernels)
            mlm_loss(logits["logits"], batch["labels"], batch["loss_weights"]).backward()
            torch.cuda.synchronize()
            n = 2 * cfg.n_layer if use_kernels else 0
            assert (cuda_mixer.mixer_fwd.res_launches - res, cuda_scan.scan_bwd.launches - bwd) \
                == (n, n)
            grads[use_kernels, dt] = {k: p.grad for k, p in model.named_parameters()}
    tol = 1e-3
    if dtype == torch.bfloat16:
        ref = grads[False, torch.float32]
        tol = 2 * max((grads[False, dtype][k].float() - w).abs().max().item()
                      / w.abs().max().item() for k, w in ref.items())
    for k, w in grads[False, dtype].items():
        _close_to_scale(grads[True, dtype][k], w, tol, k)
    with torch.inference_mode():
        k2 = cuda_mixer.mixer_fwd.x_launches
        got = forward(model, batch["input_ids"], dtype=torch.float32)["logits"]
        assert cuda_mixer.mixer_fwd.x_launches - k2 == 2 * cfg.n_layer
        want = forward(model, batch["input_ids"], dtype=torch.float32, use_kernels=False)
    _close_to_scale(got, want["logits"], 1e-3, "logits")


def test_distill_gradients_match_plain_path(cuda):
    """One fp32 distillation objective of an l20-width Mamba-1 teacher (K2,
    no grad) and an l20-ssd-width student (K5-res, K6 pre_silu), 2 layers, 2
    rows x 512 bp: every student gradient within 1e-3 of its leaf's max
    |grad| of the plain path, and the teacher records no graph."""
    from plantcaduceus_tpu_torch.io.tokenizer import DnaTokenizer
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.ops import cuda_mixer2, cuda_ssd
    from plantcaduceus_tpu_torch.train import data as data_lib
    from plantcaduceus_tpu_torch.train.distill import distill_objective
    from plantcaduceus_tpu_torch.train.step import to_device

    tcfg = CaduceusConfig.preset("l20", n_layer=2)
    scfg = CaduceusConfig.preset("l20-ssd", n_layer=2)
    teacher = Caduceus(tcfg, init_params(tcfg, seed=1)).to(cuda)
    seqs = data_lib.sequence_source("synthetic", window=512, synthetic_n=8, seed=2)
    batch = to_device(data_lib.PretrainDataset(seqs, DnaTokenizer(), 2, seed=2).batch_at(0),
                      cuda)
    sp = init_params(scfg, seed=3)
    counters = ((cuda_mixer.mixer_fwd, "x_launches"), (cuda_mixer.mixer_fwd, "res_launches"),
                (cuda_mixer2.mamba2_mixer_interior, "res_launches"),
                (cuda_ssd.ssd_dir_bwd, "pre_silu_launches"))
    grads = {}
    for use_kernels in (True, False):
        student = Caduceus(scfg, sp).requires_grad_().to(cuda)
        before = [getattr(f, a) for f, a in counters]
        obj, (_, t_logits, *_) = distill_objective(teacher, student, batch, torch.float32,
                                                   remat=True, use_kernels=use_kernels)
        assert not t_logits.requires_grad
        obj.backward()
        torch.cuda.synchronize()
        got = [getattr(f, a) - b for (f, a), b in zip(counters, before)]
        n = 2 * scfg.n_layer
        assert got == ([2 * tcfg.n_layer, 0, 2 * n, n] if use_kernels else [0, 0, 0, 0]), got
        grads[use_kernels] = {k: p.grad for k, p in student.named_parameters()}
    for k, w in grads[False].items():
        _close_to_scale(grads[True][k], w, 1e-3, k)


def test_safetensors_checkpoint_scores_on_the_card(cuda, tmp_path):
    """A checkpoint of safetensors shards (the port's writer) imports and
    runs on the card through K2, with logits equal bit for bit to those of
    the ``pytorch_model.bin`` dir holding the same weights."""
    from plantcaduceus_tpu_torch.compat.hf_export import export_hf_dir
    from plantcaduceus_tpu_torch.io import safetensors
    from plantcaduceus_tpu_torch.models.caduceus import init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig
    from plantcaduceus_tpu_torch.utils.model_loading import load_model_and_tokenizer

    cfg = CaduceusConfig(d_model=64, n_layer=2)
    export_hf_dir(tmp_path / "bin", init_params(cfg, seed=4), cfg)
    (tmp_path / "st").mkdir()
    (tmp_path / "st" / "config.json").write_text((tmp_path / "bin" / "config.json").read_text())
    safetensors.save_sharded(torch.load(tmp_path / "bin" / "pytorch_model.bin",
                                        weights_only=True), tmp_path / "st", 2)
    ids = torch.from_numpy(np.random.default_rng(2).integers(7, 11, (4, 96))).to(cuda)
    logits = {}
    for name in ("bin", "st"):
        model = load_model_and_tokenizer(str(tmp_path / name))[0].to(cuda)
        before = cuda_mixer.mixer_fwd.x_launches
        with torch.inference_mode():
            logits[name] = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        assert cuda_mixer.mixer_fwd.x_launches - before == 2 * cfg.n_layer
    assert torch.isfinite(logits["st"]).all() and torch.equal(logits["st"], logits["bin"])


# ---------------------------------------------------------------------------
# K3's g0 / emit_dh0 (the context-parallel scan's backward) and the
# sequence-sharded scan on 2 ranks sharing the card.


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
def test_scan_bwd_g0_dh0_matches_plain(cuda, dtype, fuse, reverse):
    """K3 with a g0 seed and emit_dh0 against its plain version (every
    output within 1e-4 of its scale); and with g0 = 0 the other outputs
    equal the launch without the options bit for bit."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(70)
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, dtype, fuse, rows=2, L=200, D=136)
    gy = _t(rng.standard_normal(tuple(x.shape)), cuda, dtype)
    g0 = _t(rng.standard_normal((2, 136, 16)), cuda)
    _, hb = cuda_scan.scan_fwd_plain(x, dt, A, Bm, Cm, Ds, dtb, w, reverse, HB_CHUNK)
    before = cuda_scan.scan_bwd.g0_launches
    got = cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse, g0=g0,
                             emit_dh0=True)
    torch.cuda.synchronize()
    assert cuda_scan.scan_bwd.g0_launches == before + 1
    want = cuda_scan.scan_bwd_plain(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse, g0=g0,
                                    emit_dh0=True)
    names = ["dx", "ddt", "dB", "dC", "dA", "ddt_bias", "dD", "dW", "dh0"]
    for n, g, wnt in zip(names, got, want):
        if wnt is None:
            assert g is None, n
            continue
        _close_to_scale(g, wnt, 1e-4, n)
    plain = cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse)
    zero = cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse,
                              g0=torch.zeros_like(g0), emit_dh0=True)
    for n, a, b in zip(names, plain, zero):
        assert (a is None and b is None) or torch.equal(a, b), n


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fuse", [True, False])
def test_scan_bwd_g0_chains_halves(cuda, dtype, fuse):
    """Two K3 calls over the halves, the later-processed half's dh0 seeding
    the earlier one's g0, against one call over the whole (both starting
    from one g0): the per-step outputs and dh0 bit for bit, the whole-run
    sums (dA, ddt_bias, dD, dW: two partial sums added) within 1e-5."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(71)
    L, split = 512, 256
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, dtype, fuse, rows=2, L=L, D=136)
    gy = _t(rng.standard_normal(tuple(x.shape)), cuda, dtype)
    g0 = _t(rng.standard_normal((2, 136, 16)), cuda)
    part = lambda t, a, b: t[:, a:b].contiguous()
    nl = split // HB_CHUNK
    for reverse in (False, True):
        _, hb = cuda_scan.scan_fwd(x, dt, A, Bm, Cm, Ds, dtb, w, reverse, HB_CHUNK)
        full = cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, reverse, g0=g0,
                                  emit_dh0=True)
        # processing order: the first-processed half's hb chunks come first
        spans = [((0, split), hb[:, :nl]), ((split, L), hb[:, nl:])]
        if reverse:
            spans = [((split, L), hb[:, :nl]), ((0, split), hb[:, nl:])]
        g, outs = g0, {}
        for (a, b), hbp in reversed(spans):  # the adjoint runs the processing order back
            outs[a] = cuda_scan.scan_bwd(part(x, a, b), part(gy, a, b), part(dt, a, b), A,
                                         part(Bm, a, b), part(Cm, a, b), Ds, dtb,
                                         hbp.contiguous(), w, reverse, g0=g, emit_dh0=True)
            g = outs[a][-1]
        for i, n in enumerate(["dx", "ddt", "dB", "dC"]):
            assert torch.equal(torch.cat([outs[0][i], outs[split][i]], 1), full[i]), n
        assert torch.equal(g, full[-1]), "dh0"
        for i, n in zip(range(4, 8), ["dA", "ddt_bias", "dD", "dW"]):
            if full[i] is not None:
                _close_to_scale(outs[0][i] + outs[split][i], full[i], 1e-5, n)


def test_scan_bwd_rejects_bad_g0(cuda):
    """g0 is held to K1's h0 checks: device, float32, contiguous, shape,
    16-byte alignment."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(72)
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, torch.float32, True, rows=2, L=64,
                                              D=32)
    gy = _t(rng.standard_normal(tuple(x.shape)), cuda)
    _, hb = cuda_scan.scan_fwd_plain(x, dt, A, Bm, Cm, Ds, dtb, w, False, HB_CHUNK)
    good = torch.zeros((2, 32, 16), device=cuda)
    flat = torch.zeros(2 * 32 * 16 + 1, device=cuda)
    for bad in (good.cpu(), good.double(), good.transpose(1, 2).contiguous().transpose(1, 2),
                good[:1], flat[1:].view(2, 32, 16)):
        with pytest.raises((ValueError, RuntimeError), match="g0"):
            cuda_scan.scan_bwd(x, gy, dt, A, Bm, Cm, Ds, dtb, hb, w, g0=bad, emit_dh0=True)


def test_seq_sharded_scan_two_ranks_on_the_card(cuda, tmp_path):
    """``selective_scan_seq_sharded`` on 2 gloo ranks whose tensors share
    ``cuda:0`` (K1 with h0/hfin, K3 with g0/dh0): the gathered y and the
    summed gradients against the single-device scan (``SelectiveScanFn``,
    K1-hb and K3) on the same card; 1e-4 and 1e-3 of each output's scale."""
    from tests.torch_parallel_ranks import Ranks, scan_inputs

    inp = scan_inputs()
    np.savez(tmp_path / "inputs.npz", **inp)
    Ranks(2, "tests.torch_parallel_ranks:scans_on_card", tmp_path).wait()
    for pre, fuse in (("m1f_", True), ("m1u_", False)):
        got = dict(np.load(tmp_path / f"{pre}scan.npz"))
        names = ["x", "dt", "A", "Bm", "Cm", "Ds", "dtb"] + (["W"] if fuse else [])
        t = {k: _t(inp[pre + k], cuda).requires_grad_(True) for k in names}
        ys = [cuda_scan.selective_scan(t["x"][g], t["dt"][g], t["A"][g], t["Bm"][g],
                                       t["Cm"][g], t["Ds"][g], t["dtb"][g],
                                       t["W"][g] if fuse else None, reverse=(g == 1))
              for g in range(2)]
        y = torch.stack(ys)
        (y * _t(inp[pre + "cot"], cuda)).sum().backward()
        _close_to_scale(torch.from_numpy(got["y"]), y.detach().cpu(), 1e-4, "y")
        for k in names:
            _close_to_scale(torch.from_numpy(got["d_" + k]), t[k].grad.cpu(), 1e-3, k)


def test_fsdp_step_two_ranks_on_the_card(cuda, tmp_path):
    """2 fp32 train steps at fsdp 2 on 2 gloo ranks whose tensors share
    ``cuda:0`` (K2-res and K3 under remat; the blocks gathered and the
    gradients reduce-scattered through the host) against one process on
    the card: metrics 1e-5 relative, the weights after within 1e-4 of each
    leaf's max |value|; and ``psum_scatter``, ``all_gather_tiled`` (with
    their adjoints) and ``broadcast`` on card tensors against their
    definitions."""
    import json

    from tests.torch_multirank_jobs import CARD, train_run
    from tests.torch_parallel_ranks import Ranks, randn32

    rng = np.random.default_rng(31)
    np.savez(tmp_path / "inputs.npz", ps_x=randn32(rng, 2, 4, 3), ps_c=randn32(rng, 2, 2, 3),
             ag_x=randn32(rng, 2, 2, 3), ag_c=randn32(rng, 2, 2, 6))
    (tmp_path / "tiny.json").write_text(json.dumps(CARD))
    Ranks(2, "tests.torch_multirank_jobs:fsdp_on_card", tmp_path).wait()
    got = dict(np.load(tmp_path / "train_fsdp2.npz"))
    want = train_run(device="cuda", model_kw=CARD)
    for k, v in want.items():
        if k.startswith("p_"):
            _close_to_scale(torch.from_numpy(got[k]), v, 1e-4, k)
        else:
            assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
    assert int(got["held_module"]) == 0 and 2 * int(got["held_blocks"]) == int(got["full"])
    inp = dict(np.load(tmp_path / "inputs.npz"))
    col = dict(np.load(tmp_path / "collectives2.npz"))
    x, c, t, ct = inp["ps_x"], inp["ps_c"], inp["ag_x"], inp["ag_c"]
    for r in range(2):
        np.testing.assert_allclose(col["ps"][r], x.sum(0)[2 * r:2 * r + 2], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(col["d_ps"][r], np.concatenate(list(c), 0))
        np.testing.assert_array_equal(col["ag"][r], np.concatenate(list(t), 1))
        np.testing.assert_allclose(col["d_ag"][r], ct.sum(0)[:, 3 * r:3 * r + 3], rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(col["bc"][r], t[1])


def test_nccl_collectives_take_card_tensors_and_refuse_host_ones(cuda):
    """Under NCCL (an axis not staged through the host) the new collectives
    refuse a host tensor before the backend sees it, and hand the backend a
    card tensor as it is."""
    from plantcaduceus_tpu_torch.parallel import collectives
    from plantcaduceus_tpu_torch.parallel.mesh import Axis

    nccl = Axis("fsdp", 2, 0, (0, 1), None, staged=False)
    for op in (collectives.psum_scatter, collectives.all_gather_tiled, collectives.broadcast):
        with pytest.raises(ValueError, match="NCCL takes tensors on the rank's card"):
            op(torch.ones(2, 3), nccl)
    t = torch.ones(2, 3, device=cuda)
    buf = collectives._buffer(t, nccl)
    assert buf.device == t.device and buf.data_ptr() != t.data_ptr() and torch.equal(buf, t)
