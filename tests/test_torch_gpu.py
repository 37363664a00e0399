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
