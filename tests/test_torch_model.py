"""The port's Mamba-1 Caduceus forward against the JAX package, on the CPU.

Weights come from JAX ``init_params`` and cross over by ``from_jax_params``
(and, in one test, through the HF state dict). Float32 on both sides.
Tolerance 2e-5: two layers of float32 work whose scans, projections and
norms sum in different orders (measured differences are ~2e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.compat.hf_export import export_state_dict
from plantcaduceus_tpu.models import caduceus as jcad
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu_torch.compat import hf_import
from plantcaduceus_tpu_torch.compat.params import from_jax_params
from plantcaduceus_tpu_torch.models import caduceus as tcad
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
BASE = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)
CONFIGS = {
    "tied_add": {},
    "untied": dict(bidirectional_weight_tie=False),
    "ew_multiply": dict(bidirectional_strategy="ew_multiply"),
    "unidirectional": dict(bidirectional=False, rcps=False),
    "untied_lm_head": dict(tie_word_embeddings=False, lm_head_strategy="mean"),
}


def _setup(overrides, seed=0):
    kw = dict(BASE, **overrides)
    jcfg, tcfg = JaxConfig(**kw), CaduceusConfig(**kw)
    params = jcad.init_params(jax.random.PRNGKey(seed), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _ids(rng, B=2, L=32):
    return rng.integers(7, 11, size=(B, L)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(rng, name):
    jcfg, _, params, model = _setup(CONFIGS[name])
    ids = _ids(rng)
    want = jcad.forward(params, jnp.asarray(ids), jcfg, dtype=jnp.float32,
                        all_hidden_states=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(ids).long(), dtype=torch.float32,
                    all_hidden_states=True)
    for k in ("logits", "hidden_states", "all_hidden_states"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)


def test_rc_equivariance(rng):
    """Logits of the reverse complement are the reverse complement of the
    logits: f(RC(x)) = RC(f(x)), with the complement acting on the vocab."""
    _, cfg, _, model = _setup({}, seed=3)
    ids = torch.from_numpy(_ids(rng, B=3, L=24)).long()
    cmap = torch.tensor(cfg.complement_map)
    with torch.inference_mode():
        fwd = model(ids, dtype=torch.float32)["logits"]
        rc = model(tcad.rc_ids(ids, cmap), dtype=torch.float32)["logits"]
    torch.testing.assert_close(rc, fwd.flip(1)[..., cmap], rtol=1e-5, atol=1e-5)


def test_mlm_loss_matches_jax(rng):
    logits = rng.standard_normal((2, 8, 16)).astype(np.float32)
    labels = rng.integers(0, 16, size=(2, 8))
    labels[0, :3] = -100
    w = rng.uniform(0, 1, size=(2, 8)).astype(np.float32)
    want = jcad.mlm_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(w))
    got = tcad.mlm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_init_params_layout_matches_jax():
    """Same leaves, shapes and deterministic values (norms, A_log, D) as the
    JAX init; random leaves within the distributions' bounds."""
    kw = dict(BASE, bidirectional_weight_tie=False)
    want = jax.tree.map(np.asarray, jcad.init_params(jax.random.PRNGKey(0), JaxConfig(**kw)))
    got = tcad.init_params(CaduceusConfig(**kw), seed=0)
    assert set(got) == set(want) and set(got["blocks"]) == set(want["blocks"])
    for k in want["blocks"]:
        assert tuple(got["blocks"][k].shape) == want["blocks"][k].shape, k
    for k in ("norm_weight", "A_log", "D"):
        np.testing.assert_allclose(got["blocks"][k].numpy(), want["blocks"][k], rtol=1e-6)
    R = CaduceusConfig(**kw).dt_rank
    assert float(got["blocks"]["dt_proj_w"].abs().max()) <= R ** -0.5
    sp = torch.nn.functional.softplus(got["blocks"]["dt_proj_b"])
    assert float(sp.min()) >= 1e-4 * 0.999 and float(sp.max()) <= 0.1 * 1.001
    again = tcad.init_params(CaduceusConfig(**kw), seed=0)
    assert torch.equal(again["blocks"]["in_proj_x"], got["blocks"]["in_proj_x"])


def _write_bin(tmp_path, sd, cfg_json_src):
    import shutil

    d = tmp_path / "ckpt"
    d.mkdir()
    torch.save({k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()},
               d / "pytorch_model.bin")
    shutil.copy(cfg_json_src / "config.json", d / "config.json")
    return d


@pytest.fixture
def exported(tmp_path):
    from plantcaduceus_tpu.compat.hf_export import export_hf_dir

    jcfg, tcfg, params, model = _setup(dict(bidirectional_weight_tie=False), seed=5)
    export_hf_dir(tmp_path / "exp", params, jcfg)
    return jcfg, tcfg, params, model, tmp_path / "exp"


def test_hf_import_equals_from_jax_params(exported, rng):
    jcfg, _, params, model, d = exported
    imported, cfg = hf_import.import_model(d)
    assert cfg == CaduceusConfig(**dict(BASE, bidirectional_weight_tie=False))
    ref = model.state_dict()
    for k, v in imported.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0, msg=k)
    ids = torch.from_numpy(_ids(rng)).long()
    with torch.inference_mode():
        torch.testing.assert_close(imported(ids, dtype=torch.float32)["logits"],
                                   model(ids, dtype=torch.float32)["logits"])


def test_strict_import_rejects_stray_key(exported, tmp_path):
    jcfg, _, params, _, d = exported
    sd = export_state_dict(params, jcfg)
    sd["caduceus.backbone.extra_adapter.weight"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="never consumed"):
        hf_import.import_params(_write_bin(tmp_path, sd, d))


def test_strict_import_rejects_transposed_tensor(exported, tmp_path):
    jcfg, _, params, _, d = exported
    sd = export_state_dict(params, jcfg)
    key = next(k for k in sd if k.endswith("layers.0.mixer.submodule.mamba_fwd.x_proj.weight"))
    sd[key] = np.ascontiguousarray(sd[key].T)
    with pytest.raises(ValueError, match="shapes disagree"):
        hf_import.import_params(_write_bin(tmp_path, sd, d))


def test_mamba2_is_refused():
    """The export refused Mamba-2 models until their pre-training was
    ported; it now takes them and writes mamba_ssm ``Mamba2``'s packing
    (values held to JAX's export in tests/test_torch_train2.py): one in_proj
    [z | x | B | C | dt] and one conv over [x | B | C] per direction."""
    from plantcaduceus_tpu_torch.compat.hf_export import export_state_dict as port_export

    cfg = CaduceusConfig(**dict(BASE, ssm_variant="mamba2", d_state=16, head_dim=16))
    params = tcad.init_params(cfg)
    sd = port_export(params, cfg)
    m = "caduceus.backbone.layers.0.mixer.submodule.mamba_fwd"
    di, NGN, H = cfg.d_inner, cfg.n_groups * cfg.d_state, cfg.n_heads
    assert sd[f"{m}.in_proj.weight"].shape == (2 * di + 2 * NGN + H, cfg.d_model)
    assert sd[f"{m}.conv1d.weight"].shape == (di + 2 * NGN, 1, cfg.d_conv)
    assert not any(".x_proj." in k for k in sd)


def test_bf16_forward_close_to_fp32(rng):
    """The default compute type (bf16, fp32 residual) stays within bf16
    rounding of the fp32 forward: 5e-2 on logits of magnitude ~1."""
    _, _, _, model = _setup({})
    ids = torch.from_numpy(_ids(rng)).long()
    with torch.inference_mode():
        lo = model(ids)["logits"]
        hi = model(ids, dtype=torch.float32)["logits"]
    assert lo.dtype == torch.bfloat16
    torch.testing.assert_close(lo.float(), hi, rtol=5e-2, atol=5e-2)
    assert dataclasses.asdict(model.cfg)["residual_in_fp32"]
