"""The port's task heads and activation-path LoRA against the JAX package, on
the CPU.

* ``models/heads``: ``rc_average``, ``pool``, ``task_loss`` (all three task
  types) and ``sequence_logits`` against JAX's, float32, within 1e-5 of max
  |logit|.
* The activation path (``lora=``) at dropout 0 against JAX
  ``sequence_logits(lora=lora_ctx(...))`` and against the port's merged
  weights (``apply_lora``), for Mamba-1 tied/add, Mamba-1 untied and
  Mamba-2; adapter and head gradients against ``jax.grad`` within 1e-4 of
  each leaf's max |grad|.
* Three LoRA train steps and two full fine-tune steps with ``grad_accum=2``,
  dropout 0 and the same optimizer (linear schedule, clipping, decay on
  every leaf) against JAX's ``make_lora_train_step`` /
  ``make_full_finetune_step`` on a one-device mesh: every leaf within 1e-4
  of its max |value|.
* The dropout structure: one mask shared within a drop group, distinct
  across groups, directions and layers, the same after a recompute, and a
  gradient with ``remat`` equal to one without at p = 0.1.
* ``_batch_at`` byte-equal to the JAX CLI's.

One tiny config per variant (d_model 16, 2 layers, 32-bp windows); every
JAX function is compiled once per config, with XLA's optimisation passes
off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plantcaduceus_tpu.models import heads as jheads
from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
from plantcaduceus_tpu.train import lora as jlora
from plantcaduceus_tpu_torch.compat.params import from_jax_params, to_jax_params
from plantcaduceus_tpu_torch.models import caduceus, heads
from plantcaduceus_tpu_torch.models.config import CaduceusConfig
from plantcaduceus_tpu_torch.train import lora
from plantcaduceus_tpu_torch.train.optimizer import make_optimizer
from tests.torch_threads import one_torch_thread  # noqa: F401

TINY = dict(d_model=16, n_layer=2, vocab_size=16, d_state=4)
CONFIGS = {
    "tied_add": TINY,
    "untied": dict(TINY, bidirectional_weight_tie=False),
    "mamba2": dict(TINY, ssm_variant="mamba2", head_dim=8, n_groups=2, chunk_size=16),
}
ROWS, L, RANK = 4, 32, 4
LOGIT_TOL = 1e-5
GRAD_TOL = 1e-4
PARAM_TOL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return np.abs(got - want).max() / (scale if scale else 1.0)


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().cpu().numpy()
    return np.asarray(tree, np.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_trees_close(got, want, tol, what):
    got, want = _leaves(_np_tree(got)), _leaves(_np_tree(want))
    assert got.keys() == want.keys(), what
    for k in want:
        assert _rel(got[k], want[k]) <= tol, f"{what} {k}: {_rel(got[k], want[k]):.3e}"


class Case:
    """One config: the base weights, adapters with nonzero b, a head and a
    batch, as numpy arrays both packages take."""

    def __init__(self, name):
        self.name = name
        self.kw = CONFIGS[name]
        # JAX's sequential reference scan: the associative one's function,
        # compiled in two thirds of the time
        self.cfg, self.jcfg = CaduceusConfig(**self.kw), JaxConfig(**self.kw,
                                                                   scan_impl="sequential")
        self.params = to_jax_params(caduceus.Caduceus(
            self.cfg, caduceus.init_params(self.cfg, seed=3)))
        self.cfg_l = lora.LoraConfig(r=RANK, alpha=16.0, dropout=0.0)
        rng = np.random.default_rng(5)
        ad = lora.init_lora(torch.Generator().manual_seed(4), self.model(), self.cfg_l)
        self.adapters = {n: {"a": ab["a"].numpy(),
                             "b": (0.3 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                         for n, ab in ad.items()}
        self.head = {"w": (0.3 * rng.standard_normal((16, 3))).astype(np.float32),
                     "b": (0.1 * rng.standard_normal(3)).astype(np.float32)}
        self.ids = rng.integers(7, 11, (ROWS, L)).astype(np.int32)
        self.labels = rng.integers(0, 3, ROWS)

    def model(self):
        return from_jax_params(self.params, self.cfg)


CASES = {}


@pytest.fixture(autouse=True, scope="module")
def _fast_jax_compiles():
    """XLA's optimisation passes off for this module's tiny JAX programs: the
    same functions, compiled in less time."""
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", False)


def case(name) -> Case:
    if name not in CASES:
        CASES[name] = Case(name)
    return CASES[name]


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


def test_head_functions_match_jax():
    rng = np.random.default_rng(1)
    cfg, jcfg = CaduceusConfig(**TINY), JaxConfig(**TINY)
    hidden = rng.standard_normal((3, 8, 32)).astype(np.float32)
    np.testing.assert_allclose(heads.rc_average(torch.from_numpy(hidden), cfg).numpy(),
                               np.asarray(jheads.rc_average(hidden, jcfg)), rtol=1e-6)
    for pooling in ("mean", "last", "first"):
        feats = rng.standard_normal((3, 8, 16)).astype(np.float32)
        c = CaduceusConfig(**TINY, pooling=pooling)
        got = heads.pool(torch.from_numpy(feats), c).numpy()
        assert _rel(got, jheads.pool(feats, JaxConfig(**TINY, pooling=pooling))) <= 1e-6, pooling
    with pytest.raises(ValueError, match="unknown pooling"):
        heads.pool(torch.zeros(1, 2, 3), CaduceusConfig(**TINY, pooling="max"))
    logits = (3 * rng.standard_normal((6, 3))).astype(np.float32)
    for task, labels in (("classification", rng.integers(0, 3, 6)),
                         ("regression", rng.standard_normal(6).astype(np.float32)),
                         ("multi_label", rng.integers(0, 2, (6, 3)))):
        got = heads.task_loss(torch.from_numpy(logits), torch.from_numpy(labels), task)
        want = jheads.task_loss(jnp.asarray(logits), jnp.asarray(labels), task)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, err_msg=task)
    with pytest.raises(ValueError, match="unknown task_type"):
        heads.task_loss(torch.zeros(2, 2), torch.zeros(2), "ranking")
    head = heads.init_head(torch.Generator().manual_seed(0), cfg, 5)
    assert head["w"].shape == (16, 5) and head["w"].dtype == torch.float32
    assert torch.equal(head["b"], torch.zeros(5))


@pytest.mark.parametrize("num_labels", [2, 1, 3])
def test_sequence_logits_match_jax(num_labels):
    """Without adapters: the RC-averaged, mean-pooled features through the
    head, for a classification, a regression and a multi-label head."""
    c = case("tied_add")
    head = {k: v[..., :num_labels] for k, v in c.head.items()}
    if not hasattr(c, "plain_logits"):  # JAX once, for the widest head
        c.plain_logits = np.asarray(jheads.sequence_logits(c.params, c.head, c.ids, c.jcfg,
                                                           dtype=jnp.float32))
    want = c.plain_logits[:, :num_labels]
    got = heads.sequence_logits(c.model(), {k: torch.from_numpy(v) for k, v in head.items()},
                                torch.from_numpy(c.ids).long(), c.cfg, dtype=torch.float32)
    assert got.shape == (ROWS, num_labels)
    assert _rel(got.detach().numpy(), want) <= LOGIT_TOL


# ---------------------------------------------------------------------------
# the activation path and its gradients
# ---------------------------------------------------------------------------


def _jax_value_and_grad(c):
    def loss(trainable, params, ids, labels):
        adapters, head = trainable
        logits = jheads.sequence_logits(params, head, ids, c.jcfg, dtype=jnp.float32,
                                        lora=jlora.lora_ctx(adapters, c.cfg_l))
        return jheads.task_loss(logits, labels, "classification"), logits

    return jax.jit(jax.value_and_grad(loss, has_aux=True))((c.adapters, c.head), c.params,
                                                           c.ids, c.labels)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_activation_path_and_gradients_match_jax(name):
    c = case(name)
    (_, want_logits), (want_ga, want_gh) = _jax_value_and_grad(c)
    model = c.model()
    state = lora.LoraTrainState(lora.trainable_copy(c.adapters, "cpu"),
                                lora.trainable_copy(c.head, "cpu"), None, 0)
    ids = torch.from_numpy(c.ids).long()
    logits = heads.sequence_logits(model, state.head, ids, c.cfg, dtype=torch.float32,
                                   lora=lora.lora_ctx(state.adapters, c.cfg_l))
    assert _rel(logits.detach().numpy(), want_logits) <= LOGIT_TOL
    heads.task_loss(logits, torch.from_numpy(c.labels), "classification").backward()
    _assert_trees_close({n: {k: t.grad for k, t in ab.items()} for n, ab in state.adapters.items()},
                        want_ga, GRAD_TOL, f"{name} adapter grad")
    _assert_trees_close({k: t.grad for k, t in state.head.items()}, want_gh, GRAD_TOL,
                        f"{name} head grad")
    with torch.no_grad():
        merged = heads.sequence_logits(lora.apply_lora(model, state.adapters, c.cfg_l),
                                       state.head, ids, c.cfg, dtype=torch.float32)
    assert _rel(merged.numpy(), logits.detach().numpy()) <= LOGIT_TOL
    # the base stays frozen and its weights untouched by the merge
    assert all(not p.requires_grad for p in model.parameters())
    _assert_trees_close(to_jax_params(model), c.params, 0.0, f"{name} base")


def test_lora_mamba1_leaves_k2_for_the_decomposed_route(monkeypatch):
    """Tied + add under LoRA takes the K1 route (SelectiveScanFn under
    grad), as JAX leaves its whole-interior kernel; without adapters K2."""
    from plantcaduceus_tpu_torch.ops import cuda_mixer, cuda_scan

    c = case("tied_add")
    calls = []
    for mod, fn in ((cuda_scan.SelectiveScanFn, "apply"), (cuda_mixer.BimambaMixerFn, "apply")):
        orig = getattr(mod, fn)
        monkeypatch.setattr(mod, fn, lambda *a, _o=orig, _m=mod.__name__: (calls.append(_m),
                                                                         _o(*a))[1])
    state = lora.LoraTrainState(lora.trainable_copy(c.adapters, "cpu"),
                                lora.trainable_copy(c.head, "cpu"), None, 0)
    model, ids = c.model(), torch.from_numpy(c.ids).long()
    heads.sequence_logits(model, state.head, ids, c.cfg, dtype=torch.float32,
                          lora=lora.lora_ctx(state.adapters, c.cfg_l)).sum().backward()
    assert calls == ["SelectiveScanFn"] * 4
    calls.clear()
    model.requires_grad_(True)
    heads.sequence_logits(model, state.head, ids, c.cfg, dtype=torch.float32).sum().backward()
    assert calls == ["BimambaMixerFn"] * 2


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

OPT = dict(learning_rate=1e-2, schedule="linear", warmup_steps=1, total_steps=3,
           weight_decay=0.01, grad_clip=1.0)


def _jax_mesh():
    from plantcaduceus_tpu.parallel import mesh as meshlib

    return meshlib.make_mesh(meshlib.MeshConfig(data=1), devices=jax.devices()[:1])


def _replicated(tree, mesh):
    """On the mesh as the step returns it, so its second call reuses the
    first's compilation."""
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(tree, NamedSharding(mesh, PartitionSpec()))


def _batches(c, n):
    rng = np.random.default_rng(9)
    return [{"input_ids": rng.integers(7, 11, (ROWS, L)).astype(np.int32),
             "labels": rng.integers(0, 3, ROWS)} for _ in range(n)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_three_lora_steps_match_jax(name):
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt

    c = case(name)
    jopt, mesh = jax_opt(**OPT), _jax_mesh()
    params = _replicated(c.params, mesh)
    jstep, _ = jlora.make_lora_train_step(c.jcfg, c.cfg_l, jopt, mesh, params,
                                          dtype=jnp.float32, remat=False, grad_accum=2)
    trainable = jax.tree.map(jnp.asarray, (c.adapters, c.head))
    jstate = _replicated(jlora.LoraTrainState(*trainable, jopt.init(trainable),
                                              jnp.zeros((), jnp.int32)), mesh)

    opt = make_optimizer(**OPT)
    model = c.model()
    step, infer = lora.make_lora_train_step(c.cfg, c.cfg_l, opt, model, dtype=torch.float32,
                                            remat=True, grad_accum=2, device="cpu")
    state = lora.LoraTrainState(lora.trainable_copy(c.adapters, "cpu"),
                                lora.trainable_copy(c.head, "cpu"), None, 0)
    state.opt_state = opt.init(lora.trainable(state))
    for batch in _batches(c, 3):
        jstate, jm = jstep(jstate, params, batch, jax.random.PRNGKey(0))
        state, m = step(state, model, batch, 0)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    assert state.step == 3 == int(jstate.step)
    _assert_trees_close(state.adapters, jstate.adapters, PARAM_TOL, f"{name} adapters")
    _assert_trees_close(state.head, jstate.head, PARAM_TOL, f"{name} head")
    with pytest.raises(ValueError, match="must divide by grad_accum"):
        step(state, model, {k: v[:3] for k, v in batch.items()}, 0)
    assert infer(state, model, batch).shape == (ROWS, 3)


def test_two_full_finetune_steps_match_jax():
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt

    c = case("tied_add")
    jopt, mesh = jax_opt(**OPT), _jax_mesh()
    jstep, _ = jlora.make_full_finetune_step(c.jcfg, jopt, mesh, dtype=jnp.float32,
                                             remat=False, grad_accum=2)
    trainable = jax.tree.map(jnp.asarray, (c.params, c.head))
    jstate = _replicated(jlora.LoraTrainState(*trainable, jopt.init(trainable),
                                              jnp.zeros((), jnp.int32)), mesh)

    opt = make_optimizer(**OPT)
    model = c.model()
    step, _ = lora.make_full_finetune_step(c.cfg, opt, model, dtype=torch.float32, remat=True,
                                           grad_accum=2, device="cpu")
    state = lora.init_full_state(model, {k: torch.from_numpy(v) for k, v in c.head.items()}, opt)
    for batch in _batches(c, 2):
        jstate, jm = jstep(jstate, None, batch, None)
        state, m = step(state, model, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_trees_close(to_jax_params(model), jstate.adapters, PARAM_TOL, "full params")
    _assert_trees_close(state.head, jstate.head, PARAM_TOL, "full head")


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_structure():
    x = torch.randn(2, 8, 16)
    xg = torch.randn(2, 8, 32)

    def ctx(seed):
        return {"adapters": {}, "scale": 1.0, "dropout": 0.5, "seed": seed}

    c = ctx(caduceus.fold_in(7, 0))
    d_x = caduceus._dropped(c, "in_proj_x", x, None)
    # one mask per drop group: the in_proj sites share it, every direction too
    assert caduceus._dropped(c, "in_proj_z", x, None) is d_x
    assert caduceus._dropped(c, "in_proj_B", x, 1) is d_x
    keep = d_x != 0
    assert 0.3 < keep.float().mean() < 0.7
    torch.testing.assert_close(d_x[keep], x[keep] * 2.0)
    # the same seed draws the same mask again (a recompute, a resumed run)
    assert torch.equal(caduceus._dropped(ctx(caduceus.fold_in(7, 0)), "in_proj_x", x, None), d_x)
    # distinct across groups, directions and layers
    m_out = caduceus._dropped(c, "out_proj", x, 0) != 0
    m_x0 = caduceus._dropped(c, "x_proj_dt", xg, 0) != 0
    m_x1 = caduceus._dropped(c, "x_proj_B", xg, 1) != 0
    assert caduceus._dropped(c, "x_proj_C", xg, 0) is caduceus._dropped(c, "x_proj_dt", xg, 0)
    m_l1 = caduceus._dropped(ctx(caduceus.fold_in(7, 1)), "in_proj_x", x, None) != 0
    assert not torch.equal(m_out, keep) and not torch.equal(m_x0, m_x1)
    assert not torch.equal(m_l1, keep)
    # off at p = 0 or without a seed
    assert caduceus._dropped({"dropout": 0.1, "seed": None}, "in_proj_x", x, None) is x
    assert caduceus._dropped({"dropout": 0.0, "seed": 3}, "in_proj_x", x, None) is x


@pytest.mark.parametrize("name", ["tied_add", "mamba2"])
def test_remat_recomputes_the_same_masks(name):
    """torch.utils.checkpoint does not restore an explicit generator; the
    masks are seeded per (layer, group, direction), so the recompute draws
    the forward's masks and the gradient is exact."""
    c = case(name)
    cfg_l = c.cfg_l._replace(dropout=0.1)
    model, ids = c.model(), torch.from_numpy(c.ids).long()
    grads = []
    for remat in (False, True):
        adapters = lora.trainable_copy(c.adapters, "cpu")
        out = heads.sequence_logits(model, {k: torch.from_numpy(v) for k, v in c.head.items()},
                                    ids, c.cfg, dtype=torch.float32, remat=remat,
                                    lora=lora.lora_ctx(adapters, cfg_l, dropout_seed=11))
        (out ** 2).sum().backward()
        grads.append({f"{n}.{k}": t.grad for n, ab in adapters.items() for k, t in ab.items()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k
    # and the dropout is live: another seed gives another gradient
    adapters = lora.trainable_copy(c.adapters, "cpu")
    heads.sequence_logits(model, {k: torch.from_numpy(v) for k, v in c.head.items()}, ids, c.cfg,
                          dtype=torch.float32, lora=lora.lora_ctx(adapters, cfg_l, 12)
                          ).pow(2).sum().backward()
    assert not torch.equal(adapters["out_proj"]["a"].grad, grads[0]["out_proj.a"])


def test_init_lora_layout_matches_jax():
    """Targets absent from the model are skipped, the shapes are JAX's, a
    ~ N(0, 1/r²), b = 0; no target at all raises."""
    for name in CONFIGS:
        c = case(name)
        cfg_l = lora.LoraConfig(r=8)
        got = lora.init_lora(torch.Generator().manual_seed(0), c.model(), cfg_l)
        want = jax.eval_shape(lambda: jlora.init_lora(jax.random.PRNGKey(0), c.params,
                                                      jlora.LoraConfig(r=8)))
        assert sorted(got) == sorted(want)
        for n in want:
            for k in ("a", "b"):
                assert tuple(got[n][k].shape) == want[n][k].shape, (name, n, k)
            assert torch.equal(got[n]["b"], torch.zeros_like(got[n]["b"]))
        a = torch.cat([got[n]["a"].flatten() for n in got])
        assert abs(float(a.std()) - 1 / 8) < 0.01
    assert set(lora.DEFAULT_TARGETS) == set(caduceus._LORA_SITE_IDS) == set(jlora.DEFAULT_TARGETS)
    with pytest.raises(ValueError, match="no LoRA targets"):
        lora.init_lora(torch.Generator(), case("tied_add").model(),
                       lora.LoraConfig(targets=("in_proj_B",)))


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n, bs, step, shuffle", [(10, 4, 0, True), (10, 4, 2, True),
                                                   (7, 16, 3, True), (9, 4, 5, False)])
def test_batch_at_is_byte_equal(n, bs, step, shuffle):
    from plantcaduceus_tpu.cli.lora_fine_tune import _batch_at as jax_batch_at
    from plantcaduceus_tpu_torch.cli.lora_fine_tune import _batch_at

    rng = np.random.default_rng(n)
    ids = rng.integers(0, 16, (n, 6)).astype(np.int32)
    labels = rng.standard_normal((n, 2)).astype(np.float32)
    got = _batch_at(ids, labels, bs, step, seed=42, shuffle=shuffle)
    want = jax_batch_at(ids, labels, bs, step, seed=42, shuffle=shuffle)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
