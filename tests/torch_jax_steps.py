"""JAX's one-device reference for the port's tensor- and pipeline-parallel
train steps (``tests/test_torch_tensor.py``, ``tests/test_torch_pipeline.py``):
2 fp32 steps of ``make_grad_fn`` (grad-accum 2, the ranks' 8-row batches)
and optax's update, from the weights the port's tiny model starts from.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tests.torch_multirank_jobs import _mlm_batches


def _paths(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def jax_two_steps(model_kw: dict):
    """(each step's loss, grad_norm and gradients by JAX path, the weights
    by JAX path after both, the port's model at the start)."""
    from plantcaduceus_tpu.models.config import CaduceusConfig as JaxConfig
    from plantcaduceus_tpu.parallel import mesh as jax_mesh
    from plantcaduceus_tpu.train import step as jax_step
    from plantcaduceus_tpu.train.optimizer import make_optimizer as jax_opt
    from plantcaduceus_tpu_torch.compat.params import to_jax_params
    from plantcaduceus_tpu_torch.models.caduceus import Caduceus, init_params
    from plantcaduceus_tpu_torch.models.config import CaduceusConfig

    cfg = CaduceusConfig(**model_kw)
    model = Caduceus(cfg, init_params(cfg, seed=2))
    params = jax.tree.map(jnp.asarray, to_jax_params(model))
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(data=1), devices=jax.devices()[:1])
    grad_fn = jax.jit(jax_step.make_grad_fn(
        JaxConfig(**model_kw, scan_impl="sequential"), mesh, jax_mesh.param_pspec_tree(params),
        dtype=jnp.float32, remat=False, grad_accum=2))
    tx = jax_opt(learning_rate=1e-3, warmup_steps=1, total_steps=3, params=params)
    opt_state, ds, steps = tx.init(params), _mlm_batches(), []
    for s in range(2):
        loss, _, grads = grad_fn(params, {k: jnp.asarray(v) for k, v in ds.batch_at(s).items()})
        steps.append({"loss": float(loss), "grad_norm": float(optax.global_norm(grads)),
                      "grads": _paths(grads)})
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return steps, _paths(params), model


def as_jax_paths(model, by_name: dict) -> dict:
    """Tensors keyed by the port's parameter names, in the JAX layout by
    path (``model``'s parameters are overwritten with them)."""
    from plantcaduceus_tpu_torch.compat.params import to_jax_params

    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(torch.as_tensor(by_name[n]))
    return _paths(to_jax_params(model))


def assert_close(got, want, tol, what=""):
    """Max |got - want| within ``tol`` of max |want| (1e-12 for a leaf of
    zeros)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), 1e-12)
    assert err <= tol * scale, f"{what}: max err {err:.3e} > {tol} x {scale:.3e}"
