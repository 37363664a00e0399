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
def test_scan_bwd_kernel_matches_plain(cuda, dtype, fuse, reverse):
    """K3 against its plain version on the same inputs and hb: every output
    float32, within 1e-4 of its scale (only the order of sums differs)."""
    from plantcaduceus_tpu_torch.ops.selective_scan import HB_CHUNK

    rng = np.random.default_rng(4)
    x, dt, A, Bm, Cm, Ds, dtb, w = _scan_case(rng, cuda, dtype, fuse)
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
    with one K5 launch per direction and layer; under grad the kernel route
    raises."""
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
    model.requires_grad_()
    with pytest.raises(NotImplementedError, match="next slice"):
        model(ids, dtype=torch.float32)
