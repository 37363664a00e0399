"""The port's BERT baseline (``models/bert.py``) against the JAX package's, on
the CPU.

Weights come from JAX ``bert.init_params`` and cross as the numpy pytree
(``compat.params.bert_from_jax_params``); token ids, labels and loss
weights from numpy with a seed. The port's CPU path runs the plain K7/K8
under ``FlashAttentionFn`` for ALiBi and windows, JAX the XLA path. Float32
forwards within 1e-4 of max |logit| (two layers of float32 sums in another
order); bfloat16 within 2e-2 (both round every matmul to 8 mantissa bits,
at other points); ``mlm_loss`` gradients within 5e-4 of each parameter's
max |grad| (the bound of ``tests/test_pallas_attention.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.models import bert as jbert
from plantcaduceus_tpu.models import caduceus as jcad
from plantcaduceus_tpu_torch.compat.params import bert_from_jax_params, bert_to_jax_params
from plantcaduceus_tpu_torch.models import bert as tbert
from plantcaduceus_tpu_torch.models.caduceus import mlm_loss
from tests.torch_threads import one_torch_thread  # noqa: F401

FWD_TOL = 1e-4
BF16_TOL = 2e-2
GRAD_TOL = 5e-4

SMALL = dict(d_model=64, n_layer=2, n_heads=2)  # head dim 32
CONFIGS = {
    "alibi-glu": {},
    "rope-yarn-window": dict(position="rope", rope_scaling="yarn", rope_scale=2.0,
                             original_max_len=64, local_window=16),
    "none-noglu": dict(position="none", glu=False),
}


def _pair(name, seed=0):
    jcfg = jbert.BertConfig(**SMALL, **CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, jbert.init_params(jax.random.PRNGKey(seed), jcfg))
    tcfg = tbert.BertConfig(**dataclasses.asdict(jcfg))
    return jcfg, params, bert_from_jax_params(params, tcfg)


def _ids(rng, B=2, L=96):
    return rng.integers(7, 11, size=(B, L)).astype(np.int32)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(rng, name):
    jcfg, params, model = _pair(name)
    ids = _ids(rng)
    want = jbert.forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids), jcfg,
                         dtype=jnp.float32)
    got = model(torch.from_numpy(ids).long(), dtype=torch.float32)
    for key in ("logits", "hidden_states"):
        assert got[key].dtype == torch.float32
        assert _rel_err(got[key], want[key]) <= FWD_TOL, key
    # the einsum path agrees with the structured one
    plain = model(torch.from_numpy(ids).long(), dtype=torch.float32, use_kernels=False)
    assert _rel_err(plain["logits"], got["logits"]) <= FWD_TOL


def test_bf16_forward_matches_jax(rng):
    jcfg, params, model = _pair("alibi-glu", seed=1)
    ids = _ids(rng)
    want = jbert.forward(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(ids), jcfg,
                         dtype=jnp.bfloat16)["logits"]
    got = model(torch.from_numpy(ids).long(), dtype=torch.bfloat16)["logits"]
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert _rel_err(got.float(), want) <= BF16_TOL


def test_mlm_loss_grads_match_jax(rng):
    """Gradients of the masked-LM loss (15% of positions scored, weights
    from numpy) with respect to every leaf, through ALiBi attention."""
    jcfg, params, model = _pair("alibi-glu", seed=2)
    ids = _ids(rng)
    labels = np.where(rng.random(ids.shape) < 0.15, ids, -100).astype(np.int32)
    weights = rng.uniform(0.5, 1.0, ids.shape).astype(np.float32)

    def loss(p):
        logits = jbert.forward(p, jnp.asarray(ids), jcfg, dtype=jnp.float32)["logits"]
        return jcad.mlm_loss(logits, jnp.asarray(labels), jnp.asarray(weights))

    want = bert_to_jax_params(model)  # the layout, filled from jax.grad below
    jgrads = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, params))
    model.requires_grad_()
    logits = model(torch.from_numpy(ids).long(), dtype=torch.float32)["logits"]
    mlm_loss(logits, torch.from_numpy(labels).long(), torch.from_numpy(weights)).backward()
    for k in tbert.TOP_KEYS:
        want[k] = getattr(model, k).grad
    for k in tbert.LAYER_KEYS:
        want["blocks"][k] = torch.stack([getattr(layer, k).grad for layer in model.layers])
    got_leaves = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: np.asarray(t, np.float32), want))
    ref = dict(jax.tree_util.tree_leaves_with_path(jgrads))
    assert len(got_leaves) == len(ref) == len(tbert.TOP_KEYS) + len(tbert.LAYER_KEYS)
    for path, g in got_leaves:
        w = np.asarray(ref[path], np.float32)
        scale = np.abs(w).max()
        err = np.abs(g - w).max()
        assert err <= GRAD_TOL * max(scale, 1e-12), f"{jax.tree_util.keystr(path)}: {err}"


def test_weights_round_trip():
    _, params, model = _pair("alibi-glu", seed=3)
    back = bert_to_jax_params(model)
    flat = jax.tree_util.tree_leaves_with_path(params)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    back_d = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in flat:
        assert np.array_equal(back_d[path], leaf), jax.tree_util.keystr(path)
    with pytest.raises(KeyError, match="head_bias"):
        bert_from_jax_params({k: v for k, v in params.items() if k != "head_bias"},
                             model.cfg)


def test_init_params_shapes_match_jax():
    for name in CONFIGS:
        jcfg, params, _ = _pair(name)
        ours = tbert.init_params(tbert.BertConfig(**dataclasses.asdict(jcfg)), seed=4)
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), params)
        assert jax.tree_util.tree_map(lambda t: tuple(t.shape), ours) == shapes


def test_default_device_is_the_card():
    """``build`` puts the model on the card unless asked for the CPU, and
    raises where there is none."""
    cfg = tbert.BertConfig(**SMALL)
    assert next(tbert.build(cfg, device="cpu").parameters()).device.type == "cpu"
    if torch.cuda.is_available():
        assert next(tbert.build(cfg).parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbert.build(cfg)
