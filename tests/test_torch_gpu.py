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
    ({}, 2, 0),                                    # tied + add: K2 per direction
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
    before = (cuda_mixer.mixer_fwd.launches, cuda_scan.scan_fwd.launches)
    with torch.inference_mode():
        got = model(ids, dtype=torch.float32)["logits"]
        torch.cuda.synchronize()
        after = (cuda_mixer.mixer_fwd.launches, cuda_scan.scan_fwd.launches)
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
