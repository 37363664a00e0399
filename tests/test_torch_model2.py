"""The port's Mamba-2 (SSD) Caduceus against the JAX package, on the CPU.

Weights come from JAX ``init_params`` (tests/test_caduceus2.py's tiny
config: d_state 4, head_dim 8, n_groups 2, chunk 16) and cross over by
``from_jax_params``, or through an HF dir written by the JAX package's
``export_hf_dir``. Float32 on both sides. Forward tolerance 2e-5 (two
layers whose SSD products, convs and norms sum in other orders; measured
~1e-6); CLI scores 1e-4 absolute, as for Mamba-1 (tests/test_torch_zero_shot.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.compat import hf_import as jimport
from plantcaduceus_tpu.compat.hf_export import export_hf_dir
from plantcaduceus_tpu.models import caduceus as jcad
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu_torch.compat import hf_import
from plantcaduceus_tpu_torch.compat.params import from_jax_params, to_jax_params
from plantcaduceus_tpu_torch.models import caduceus as tcad
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
TINY2 = dict(d_model=16, n_layer=2, vocab_size=16, ssm_variant="mamba2",
             d_state=4, head_dim=8, n_groups=2, chunk_size=16)
CONFIGS = {
    "tied_add": {},
    "untied": dict(bidirectional_weight_tie=False),
    "ew_multiply": dict(bidirectional_strategy="ew_multiply"),
    "unidirectional": dict(bidirectional=False, rcps=False),
}


def _setup(overrides, seed=0):
    kw = dict(TINY2, **overrides)
    jcfg, tcfg = JaxConfig(**kw), CaduceusConfig(**kw)
    params = jcad.init_params(jax.random.PRNGKey(seed), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    return jcfg, tcfg, params, model


def _ids(rng, B=2, L=32):
    return rng.integers(7, 11, size=(B, L)).astype(np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(rng, name):
    """The plain path (K5's plain version on CPU tensors) against JAX
    ``forward``: logits and every layer's hidden states."""
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
    back = to_jax_params(model)
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][k], np.asarray(v), err_msg=k)


def test_rc_equivariance(rng):
    """f(RC(x)) = RC(f(x)), the complement acting on the vocab."""
    _, cfg, _, model = _setup({}, seed=3)
    ids = torch.from_numpy(_ids(rng, B=3, L=48)).long()
    cmap = torch.tensor(cfg.complement_map)
    with torch.inference_mode():
        fwd = model(ids, dtype=torch.float32)["logits"]
        rc = model(tcad.rc_ids(ids, cmap), dtype=torch.float32)["logits"]
    torch.testing.assert_close(rc, fwd.flip(1)[..., cmap], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tied_add", "untied"])
def test_init_params_layout(name):
    """The port's initialiser gives the JAX pytree's leaves and shapes, with
    the distributions' fixed parts (D = 1, A in [1, 16], zero B/C conv
    biases, unit norm weights)."""
    kw = dict(TINY2, **CONFIGS[name])
    want = jax.eval_shape(lambda: jcad.init_params(jax.random.PRNGKey(0), JaxConfig(**kw)))
    got = tcad.init_params(CaduceusConfig(**kw), seed=1)
    assert set(got["blocks"]) == set(want["blocks"]) == set(tcad.LAYER_KEYS_MAMBA2)
    for k, v in want["blocks"].items():
        assert tuple(got["blocks"][k].shape) == v.shape, k
    b = got["blocks"]
    assert torch.equal(b["D"], torch.ones_like(b["D"]))
    A = torch.exp(b["A_log"])
    assert A.min() >= 1 and A.max() <= 16
    assert not b["conv_B_b"].any() and not b["conv_C_b"].any()
    assert torch.equal(b["mixer_norm_weight"], torch.ones_like(b["mixer_norm_weight"]))


WINDOW, IDX = 48, 23


@pytest.fixture(scope="module")
def ssd_ckpt(tmp_path_factory):
    cfg = JaxConfig(**TINY2)
    params = jcad.init_params(jax.random.PRNGKey(5), cfg)
    d = tmp_path_factory.mktemp("ckpt") / "tiny-ssd"
    export_hf_dir(d, params, cfg)
    return d, params


def test_hf_dir_scores_match_jax_cli(ssd_ckpt, tmp_path):
    """An HF dir written by the JAX package: the port's strict import gives
    the JAX importer's pytree, and the two CLIs score a synthetic TSV to the
    same rows and scores (the port on the CPU)."""
    from plantcaduceus_tpu.cli.zero_shot_score import main as jax_main
    from plantcaduceus_tpu_torch.cli.zero_shot_score import main as torch_main

    d, params = ssd_ckpt
    jp, jcfg = jimport.import_params(d)
    tp, tcfg = hf_import.import_params(d)
    assert tcfg.ssm_variant == "mamba2"
    assert (tcfg.head_dim, tcfg.n_groups, tcfg.chunk_size, tcfg.d_state) == \
        (jcfg.head_dim, jcfg.n_groups, jcfg.chunk_size, jcfg.d_state)
    for k, v in jp["blocks"].items():
        np.testing.assert_array_equal(tp["blocks"][k], np.asarray(v), err_msg=k)

    rng = np.random.default_rng(13)
    seqs = ["".join(rng.choice(list("ACGT"), WINDOW)) for _ in range(9)]
    refs = [s[IDX] for s in seqs]
    alts = [next(b for b in "ACGT" if b != r) for r in refs]
    refs[3] = "N"  # filtered out by both
    table = tmp_path / "snps.tsv"
    with open(table, "w") as fh:
        fh.write("chr\tpos\tref\talt\tsequences\n")
        for i, (s, r, a) in enumerate(zip(seqs, refs, alts)):
            fh.write(f"chr1\t{100 + i}\t{r}\t{a}\t{s}\n")
    rows = {}
    for name, fn, extra in (("jax", jax_main, []), ("torch", torch_main, ["-device", "cpu"])):
        out = tmp_path / f"{name}.tsv"
        fn(["-input-table", str(table), "-model", str(d), "-tokenIdx", str(IDX),
            "-output", str(out), "-batchSize", "8", "-dtype", "float32",
            "-no-progress"] + extra)
        rows[name] = [ln.split("\t") for ln in out.read_text().splitlines()[1:]]
    assert len(rows["torch"]) == len(rows["jax"]) == 8
    assert [r[:5] for r in rows["torch"]] == [r[:5] for r in rows["jax"]]
    scores = np.array([float(r[5]) for r in rows["torch"]])
    assert np.isfinite(scores).all()
    np.testing.assert_allclose(scores, [float(r[5]) for r in rows["jax"]],
                               rtol=1e-4, atol=1e-4)


def test_untied_export_imports(tmp_path):
    """An untied Mamba-2 export carries one gated-norm weight and out_proj
    per direction even where they are equal (as at init): the port keeps
    both, following in_proj's tying, and builds the model."""
    kw = dict(TINY2, bidirectional_weight_tie=False)
    params = jcad.init_params(jax.random.PRNGKey(2), JaxConfig(**kw))
    export_hf_dir(tmp_path / "untied", params, JaxConfig(**kw))
    model, cfg = hf_import.import_model(tmp_path / "untied")
    back = to_jax_params(model)
    for k, v in params["blocks"].items():
        np.testing.assert_array_equal(back["blocks"][k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_kernel_route_under_grad_takes_interior_fn(monkeypatch, rng, name):
    """Under training the kernel route takes ``Mamba2InteriorFn`` (K5-res
    and K6; their plain versions on CPU tensors) once per direction and
    layer, and gives the plain path's gradients (autograd through K5's plain
    version). Layer 0 is frozen: its mixer still takes the autograd route
    (its input needs a gradient), and the embedding's gradient passes
    through it. Tolerance 1e-5 of each parameter's max |grad| (the same
    float32 math, summed in other orders; measured ~1e-6)."""
    _, cfg, _, model = _setup(CONFIGS[name], seed=6)
    params = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ids = torch.from_numpy(_ids(rng)).long()
    routed = []
    fn = tcad.mamba2_mixer_interior_train
    monkeypatch.setattr(tcad, "mamba2_mixer_interior_train",
                        lambda *a, **k: routed.append(1) or fn(*a, **k))
    grads = {}
    for use_kernels in (True, False):
        model.load_state_dict(params)
        model.requires_grad_()
        model.layers[0].requires_grad_(False)
        model.zero_grad(set_to_none=True)
        routed.clear()
        logits = model(ids, dtype=torch.float32, use_kernels=use_kernels)["logits"]
        tcad.mlm_loss(logits, ids).backward()
        assert len(routed) == (cfg.n_directions * cfg.n_layer if use_kernels else 0)
        grads[use_kernels] = {n: p.grad for n, p in model.named_parameters()}
    assert all(g is None for n, g in grads[True].items() if n.startswith("layers.0."))
    trained = {n: g for n, g in grads[False].items() if g is not None}
    assert model.layers[1].in_proj_dt.grad.abs().sum() > 0
    assert trained["embedding"].abs().max() > 0
    for n, g in trained.items():
        got = grads[True][n]
        assert got is not None and torch.isfinite(got).all(), n
        assert (got - g).abs().max() <= 1e-5 * g.abs().max(), n
