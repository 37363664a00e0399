"""The port's AR Mamba LM (``plantcaduceus_tpu_torch.models.mamba_lm``) and
its CLI (``cli/ar_lm.py``) against the JAX package's, on the CPU.

The same weights (the JAX ``init_params`` pytree carried across with
``compat.params.mamba_lm_from_jax_params``) and the same token ids (numpy,
seeded) go through both. JAX runs the associative scan and ``ssd_chunked``;
the port runs its kernels' plain versions (K1/K3 for Mamba-1, K4/K6 at the
SSD kernels' shapes, ``ssd_chunked`` elsewhere). Configurations:

* ``mamba1`` — d_model 32, 2 layers, N 4;
* ``mamba2`` — d_model 32, 2 layers, head_dim 16, N 8, chunk 8 (JAX's and
  the port's ``ssd_chunked``);
* ``mamba2_k`` — one layer at the SSD kernels' shapes (d_model 64, head_dim
  = N = chunk = 128, L 128): the port's ``ssd_dir`` route;
* ``mamba2_p256`` — one layer at head_dim 256 (d_model 128, N = chunk =
  128, L 128): JAX's kernel predicate holds, so the port takes the
  ``ssd_dir`` route too (on the card K4 raises for this head dim).

Tolerances (float32 unless stated): logits and loss within 1e-5 of max
|logit| (only the order of sums differs); each gradient leaf within 1e-4 of
its max |grad| (the scans' adjoints sum over steps in another order); bf16
logits within 2**-6 of max |logit| (both round every product to 8 mantissa
bits, in different places).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.models import mamba_lm as J
from plantcaduceus_tpu_torch.compat.params import mamba_lm_from_jax_params, to_jax_params
from plantcaduceus_tpu_torch.models import mamba_lm as T
from tests.torch_threads import one_torch_thread  # noqa: F401

CONFIGS = {
    "mamba1": (dict(d_model=32, n_layer=2, vocab_size=16, d_state=4), 24),
    "mamba2": (dict(d_model=32, n_layer=2, vocab_size=16, ssm_variant="mamba2", d_state=8,
                    head_dim=16, chunk_size=8), 24),
    "mamba2_k": (dict(d_model=64, n_layer=1, vocab_size=16, ssm_variant="mamba2",
                      d_state=128, head_dim=128, chunk_size=128), 128),
    "mamba2_p256": (dict(d_model=128, n_layer=1, vocab_size=16, ssm_variant="mamba2",
                         d_state=128, head_dim=256, chunk_size=128), 128),
}
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
BF16_TOL = 2 ** -6


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for this module's tiny JAX programs: the
    same functions, compiled in less time."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


@pytest.fixture(scope="module", params=list(CONFIGS))
def case(request):
    kw, L = CONFIGS[request.param]
    jcfg, tcfg = J.MambaLmConfig(**kw), T.MambaLmConfig(**kw)
    params = J.init_params(jax.random.PRNGKey(0), jcfg)
    model = mamba_lm_from_jax_params(jax.tree.map(np.asarray, params), tcfg)
    ids = np.random.default_rng(0).integers(0, kw["vocab_size"], (2, L))
    return request.param, jcfg, params, model, ids


def _close(got, want, tol):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol:.0e} x {scale:.3e}"


def test_ssd_route_by_shape(case):
    """The port takes the SSD kernel route exactly where JAX's
    ``pallas_ssd.supported`` does."""
    from plantcaduceus_tpu.ops.pallas_ssd import supported

    name, jcfg, _, model, ids = case
    if model.cfg.ssm_variant == "mamba2":
        B, L = ids.shape
        c = model.cfg
        want = supported((1, B, L, c.n_heads, c.head_dim), (c.n_groups, c.d_state),
                         c.chunk_size)
        assert want == (name in ("mamba2_k", "mamba2_p256"))
        assert T.ssd_supported(c, L) == want
        for L2 in (64, 256, 384):
            assert T.ssd_supported(c, L2) == supported(
                (1, B, L2, c.n_heads, c.head_dim), (c.n_groups, c.d_state), c.chunk_size)


@pytest.mark.parametrize("impl", ["associative", "sequential"])
def test_plain_scan_impl_skips_the_kernels(monkeypatch, impl):
    """A plain ``scan_impl`` takes the plain path (``ssd_chunked`` for
    Mamba-2, as JAX), and an unknown one raises."""
    def no_kernel(*a, **k):
        raise AssertionError("kernel route taken")

    for name in ("ssd_dir", "ssd_dir_plain", "ssd_dir_train", "scan_fwd", "selective_scan"):
        monkeypatch.setattr(T, name, no_kernel)
    for variant in ("mamba1", "mamba2_k"):
        kw, L = CONFIGS[variant]
        cfg = T.MambaLmConfig(**kw, scan_impl=impl)
        model = T.MambaLm(cfg, T.init_params(cfg, seed=1)).requires_grad_()
        ids = torch.from_numpy(np.random.default_rng(0).integers(0, 16, (1, L)))
        loss = T.nll_loss(model, ids, dtype=torch.float32)
        torch.autograd.grad(loss, list(model.parameters()))
        assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="scan_impl"):
        T.MambaLmConfig(**kw, scan_impl="xla")


def test_forward_and_loss_match_jax(case):
    _, jcfg, params, model, ids = case
    out, want_loss = jax.jit(lambda p, i: (J.forward(p, i, jcfg, dtype=jnp.float32),
                                           J.nll_loss(p, i, jcfg, dtype=jnp.float32)))(
        params, jnp.asarray(ids, jnp.int32))
    want_loss = float(want_loss)
    with torch.no_grad():
        got = T.forward(model, torch.from_numpy(ids), dtype=torch.float32)
        loss = float(T.nll_loss(model, torch.from_numpy(ids), dtype=torch.float32))
    want = np.asarray(out["logits"])
    _close(got["logits"].numpy(), want, LOGIT_TOL)
    _close(got["hidden_states"].numpy(), np.asarray(out["hidden_states"]), LOGIT_TOL)
    assert abs(loss - want_loss) <= LOGIT_TOL * abs(want_loss)
    assert abs(float(T.bits_per_dim(loss)) - float(J.bits_per_dim(want_loss))) < 1e-5


def test_bf16_forward_within_bound(case):
    _, jcfg, params, model, ids = case
    want = np.asarray(jax.jit(lambda p, i: J.forward(p, i, jcfg)["logits"].astype(jnp.float32))(
        params, jnp.asarray(ids, jnp.int32)))
    with torch.no_grad():
        got = T.forward(model, torch.from_numpy(ids))["logits"]
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, BF16_TOL)


def test_gradients_match_jax(case):
    """fp32 ``nll_loss`` gradients: autograd through the kernels' autograd
    Functions (their plain versions on the CPU) against ``jax.grad``."""
    _, jcfg, params, model, ids = case
    want = jax.jit(jax.grad(lambda p: J.nll_loss(p, jnp.asarray(ids, jnp.int32), jcfg,
                                                 dtype=jnp.float32)))(params)
    model.requires_grad_()
    try:
        names, ps = zip(*model.named_parameters())
        loss = T.nll_loss(model, torch.from_numpy(ids), dtype=torch.float32)
        grads = dict(zip(names, torch.autograd.grad(loss, ps)))
    finally:
        model.requires_grad_(False)
    assert len(grads) == 2 + len(model.layers) * len(T.layer_keys(model.cfg))
    for name, g in grads.items():
        parts = name.split(".")
        w = (want["blocks"][parts[2]][int(parts[1])] if parts[0] == "layers"
             else want[name])
        w = np.asarray(w)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= GRAD_TOL * float(np.abs(w).max()) + 1e-12, (name, err)


def test_step_matches_jax(case):
    """Recurrent decode: ``step`` logits over the first tokens, fp32."""
    _, jcfg, params, model, ids = case
    n = 6
    jcache = J.init_cache(jcfg, ids.shape[0])
    tcache = T.init_cache(model.cfg, ids.shape[0])
    jstep = jax.jit(lambda p, c, tok: J.step(p, c, tok, jcfg, dtype=jnp.float32))
    for t in range(n):
        jl, jcache = jstep(params, jcache, jnp.asarray(ids[:, t], jnp.int32))
        with torch.no_grad():
            tl, tcache = T.step(model, tcache, torch.from_numpy(ids[:, t]), dtype=torch.float32)
        _close(tl.numpy(), np.asarray(jl), LOGIT_TOL)
    assert set(tcache) == set(jcache)
    for k in jcache:
        _close(tcache[k].numpy(), np.asarray(jcache[k]), LOGIT_TOL)


def test_greedy_generate_matches_jax(case):
    _, jcfg, params, model, ids = case
    prompt = ids[:, :5]
    want = np.asarray(J.generate(params, jcfg, jnp.asarray(prompt, jnp.int32), 8,
                                 dtype=jnp.float32))
    got = T.generate(model, torch.from_numpy(prompt), 8, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampling_in_range_and_seeded():
    cfg = T.MambaLmConfig(d_model=32, n_layer=2, vocab_size=16, d_state=4)
    model = T.MambaLm(cfg, T.init_params(cfg, seed=3))
    prompt = torch.randint(0, 16, (2, 4), generator=torch.Generator().manual_seed(0))

    def draw(seed):
        return T.generate(model, prompt, 6, generator=torch.Generator().manual_seed(seed),
                          temperature=0.8, top_k=4, dtype=torch.float32)

    a, b = draw(5), draw(5)
    assert a.shape == (2, 6) and ((a >= 0) & (a < 16)).all()
    assert torch.equal(a, b)


def test_missing_leaf_raises():
    cfg = T.MambaLmConfig(d_model=16, n_layer=1, vocab_size=8, d_state=4)
    params = to_jax_params(T.MambaLm(cfg, T.init_params(cfg)))
    del params["blocks"]["dt_proj_w"]
    with pytest.raises(KeyError, match="dt_proj_w"):
        mamba_lm_from_jax_params(params, cfg)


# ---------------------------------------------------------------------------
# cli/ar_lm.py: each package's sample reads the other's checkpoint
# ---------------------------------------------------------------------------

TRAIN = ["--steps", "3", "--batch", "4", "--side", "8", "--levels", "8", "--d-model", "32",
         "--n-layer", "2", "--d-state", "4", "--log-every", "1"]


def _sample(main, ckpt, capsys, extra=()):
    main(["sample", str(ckpt), "--prompt-len", "6", "--n-new", "10", *extra])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["mamba1", "mamba2"])
def test_checkpoints_cross_both_ways(tmp_path, capsys, variant):
    """A JAX-written ``.npz`` sampled by the port, and the port's read back by
    JAX's ``_load_ckpt``: the same keys, and the same greedy tokens."""
    from plantcaduceus_tpu.cli import ar_lm as jcli
    from plantcaduceus_tpu_torch.cli import ar_lm as tcli

    extra = ["--ssm-variant", variant, "--head-dim", "16", "--chunk-size", "16"]
    jck, tck = tmp_path / "jax.npz", tmp_path / "port.npz"
    jcli.main(["train", "--output", str(jck), *TRAIN, *extra])
    tcli.main(["train", "--output", str(tck), "--device", "cpu", *TRAIN, *extra])
    capsys.readouterr()
    jz, tz = np.load(jck), np.load(tck)
    assert sorted(jz.files) == sorted(tz.files)
    for k in set(jz.files) - {"__config__"}:
        assert jz[k].dtype == tz[k].dtype == np.float32 and jz[k].shape == tz[k].shape, k
    jconf, tconf = (json.loads(str(z["__config__"])) for z in (jz, tz))
    assert {k: v for k, v in tconf.items() if k not in ("output", "device")} == \
        {k: v for k, v in jconf.items() if k != "output"}

    for ck in (jck, tck):
        got = _sample(tcli.main, ck, capsys, ["--device", "cpu"])
        want = _sample(jcli.main, ck, capsys)
        assert got == want, ck.name
        assert len(got["generated"]) == 10 and len(got["prompt"]) == 6
    # fp32 greedy decode from each package's reading of the port's checkpoint
    targs, params = jcli._load_ckpt(tck)
    cfg_kw = dict(d_model=32, n_layer=2, vocab_size=8, d_state=4, ssm_variant=variant,
                  head_dim=16, chunk_size=16)
    prompt = np.random.default_rng(1).integers(0, 8, (2, 6))
    want = J.generate(jax.tree.map(jnp.asarray, params), J.MambaLmConfig(**cfg_kw),
                      jnp.asarray(prompt, jnp.int32), 10, dtype=jnp.float32)
    _, tparams = tcli._load_ckpt(tck)
    model = mamba_lm_from_jax_params(tparams, T.MambaLmConfig(**cfg_kw))
    got = T.generate(model, torch.from_numpy(prompt), 10, dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert targs["d_model"] == 32 and targs["ssm_variant"] == variant


def test_train_bits_per_dim_falls(tmp_path, capsys):
    """The port's trainer on the synthetic gratings: bits/dim below the
    uniform floor's log2(8) = 3 by step 20 and lower at step 40 (CPU, fp32
    master weights, bf16 compute)."""
    from plantcaduceus_tpu_torch.cli import ar_lm as tcli

    tcli.main(["train", "--output", str(tmp_path / "m.npz"), "--device", "cpu", "--steps", "40",
               "--batch", "8", "--side", "8", "--d-model", "32", "--n-layer", "2", "--d-state",
               "4", "--log-every", "20"])
    bpd = [float(ln.split("bits/dim ")[1].split()[0])
           for ln in capsys.readouterr().err.splitlines() if "bits/dim" in ln]
    assert len(bpd) == 2 and bpd[-1] < bpd[0] < 3.0, bpd
