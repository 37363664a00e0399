"""``plantcaduceus_tpu_torch.ops.quant`` against ``plantcaduceus_tpu.ops.quant``
on seeded inputs: the int8 tensors and int32 products equal, the scales
and rescaled outputs within 1e-6 of each output's max |value|. On the CPU
the port's integer product is an exact int32 product (``torch._int_mm`` on
the card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6


def _inputs(seed=11):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 24, 64)) * 2.0).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    return x, w


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_matches_jax(axis):
    from plantcaduceus_tpu.ops import quant as jq
    from plantcaduceus_tpu_torch.ops import quant

    _, w = _inputs()
    w8, s = quant.quantize_weight(torch.from_numpy(w), reduce_axis=axis)
    jw8, js = jq.quantize_weight(jnp.asarray(w), reduce_axis=axis)
    assert w8.dtype == torch.int8 and np.array_equal(w8.numpy(), np.asarray(jw8))
    _close(s.numpy(), js)


def test_quantize_activation_dynamic_and_static_match_jax():
    from plantcaduceus_tpu.ops import quant as jq
    from plantcaduceus_tpu_torch.ops import quant

    x, _ = _inputs()
    x8, s = quant.quantize_activation(torch.from_numpy(x))
    jx8, js = jq.quantize_activation(jnp.asarray(x))
    assert x8.dtype == torch.int8 and np.array_equal(x8.numpy(), np.asarray(jx8))
    _close(s.numpy(), js)
    a_scale = np.float32(np.abs(x).max() * 0.5 / 127.0)   # half the range: values saturate
    got = quant.quantize_activation_static(torch.from_numpy(x), torch.tensor(a_scale))
    want = jq.quantize_activation_static(jnp.asarray(x), jnp.asarray(a_scale))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert (np.abs(got.numpy()) == 127).any()


def test_int8_matmul_matches_jax():
    """The int32 products equal; the rescaled outputs within 1e-6; the
    output dtype as asked."""
    import jax

    from plantcaduceus_tpu.ops import quant as jq
    from plantcaduceus_tpu_torch.ops import quant

    x, w = _inputs()
    x8, sx = quant.quantize_activation(torch.from_numpy(x))
    w8, sw = quant.quantize_weight(torch.from_numpy(w))
    y32 = quant._int8_product(x8.reshape(-1, 64), w8)
    want32 = jax.lax.dot_general(jnp.asarray(x8.numpy()).reshape(-1, 64), jnp.asarray(w8.numpy()),
                                 (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
    assert y32.dtype == torch.int32 and np.array_equal(y32.numpy(), np.asarray(want32))
    got = quant.int8_matmul(x8, w8, sx * sw)
    want = jq.int8_matmul(jnp.asarray(x8.numpy()), jnp.asarray(w8.numpy()),
                          jnp.asarray((sx * sw).numpy()))
    _close(got.numpy(), want)
    half = quant.int8_matmul(x8, w8, sx * sw, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.shape == (3, 24, 48)


def test_int8_dense_dynamic_and_static_match_jax():
    from plantcaduceus_tpu.ops import quant as jq
    from plantcaduceus_tpu_torch.ops import quant

    x, w = _inputs()
    w8, sw = quant.quantize_weight(torch.from_numpy(w))
    jw8, jsw = jq.quantize_weight(jnp.asarray(w))
    _close(quant.int8_dense(torch.from_numpy(x), w8, sw).numpy(),
           jq.int8_dense(jnp.asarray(x), jw8, jsw))
    a_scale = np.float32(np.abs(x).max() / 127.0)
    _close(quant.int8_dense_static(torch.from_numpy(x), w8, sw, torch.tensor(a_scale)).numpy(),
           jq.int8_dense_static(jnp.asarray(x), jw8, jsw, jnp.asarray(a_scale)))
    # and near the float product: the quantisation error of 8 bits
    ref = x @ w
    assert np.abs(quant.int8_dense(torch.from_numpy(x), w8, sw).numpy() - ref).max() \
        < 0.05 * np.abs(ref).max()


def test_int8_product_refuses_other_dtypes():
    from plantcaduceus_tpu_torch.ops import quant

    with pytest.raises(ValueError, match="both must be int8"):
        quant._int8_product(torch.zeros(4, 8, dtype=torch.int32),
                            torch.zeros(8, 8, dtype=torch.int8))
