"""Schedules and AdamW with optax's semantics, in PyTorch.

Counterpart of ``plantcaduceus_tpu.train.optimizer`` (optax
``chain(clip_by_global_norm, adamw(schedule, mask=decay_mask))``), written
out so the port's updates are optax's:

* the schedule is evaluated at the count BEFORE the update, so the first
  step's learning rate is 0 under warmup;
* clipping scales by ``max_norm / g_norm`` with no epsilon, and only when
  ``g_norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* Adam's bias corrections use the incremented count; decoupled weight decay
  ``wd * param`` joins the update before the learning rate scales it;
* the decay mask is decided on the JAX leaf (its path name and its stacked
  ``[n_layer, ...]`` rank), not on the port's per-layer tensors.

The update is a hand-written multi-tensor pass (``torch._foreach_*``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init -> end over ``steps``, then end."""
    if steps <= 0:
        return lambda count: init

    def f(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def f(count):
        cos = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init * ((1 - alpha) * cos + alpha)
    return f


def _join(schedules, boundaries) -> Schedule:
    """optax.join_schedules: the next schedule from each boundary on, fed
    the count minus that boundary."""
    def f(count):
        out = schedules[0](count)
        for b, s in zip(boundaries, schedules[1:]):
            if count >= b:
                out = s(count - b)
        return out
    return f


def make_schedule(name: str, learning_rate: float, warmup_steps: int = 0,
                  total_steps: Optional[int] = None) -> Schedule:
    if name == "constant_with_warmup":
        if warmup_steps == 0:
            return lambda count: learning_rate
        return _join([_linear(0.0, learning_rate, warmup_steps),
                      lambda count: learning_rate], [warmup_steps])
    if name == "linear":
        if total_steps is None:
            raise ValueError("linear schedule needs total_steps")
        return _join([_linear(0.0, learning_rate, max(warmup_steps, 1)),
                      _linear(learning_rate, 0.0, total_steps - warmup_steps)],
                     [warmup_steps])
    if name == "cosine":
        if total_steps is None:
            raise ValueError("cosine schedule needs total_steps")
        return _join([_linear(0.0, learning_rate, warmup_steps),
                      _cosine(learning_rate, total_steps - warmup_steps)], [warmup_steps])
    raise ValueError(f"unknown schedule {name!r}")


def jax_leaf(name: str, ndim: int):
    """The JAX pytree path and rank of a port parameter: block weights
    ``layers.<i>.<key>`` are the leaves ``blocks/<key>`` stacked on n_layer."""
    parts = name.split(".")
    if parts[0] == "layers":
        return f"blocks/{parts[-1]}", ndim + 1
    return name, ndim


def decays(jax_name: str, jax_ndim: int) -> bool:
    """The JAX ``_decay_mask`` rule: decay matrix-like weights, skip norms,
    biases (``_b`` suffix included), A_log and D."""
    skip = (any(s in jax_name for s in ("norm", "bias", "A_log", "/D"))
            or jax_name.endswith("_b"))
    return (not skip) and jax_ndim >= 2


def decay_mask(params: Dict[str, torch.Tensor]) -> Dict[str, bool]:
    return {n: decays(*jax_leaf(n, p.dim())) for n, p in params.items()}


class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(schedule, b1, b2,
    eps, weight_decay, mask))`` over a dict of named float32 tensors.
    ``decay=None`` decays every tensor (optax's ``mask=None``)."""

    def __init__(self, schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 decay: Optional[Dict[str, bool]] = None,
                 grad_clip: Optional[float] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.decay = decay
        self.grad_clip = grad_clip

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: dict,
               params: Dict[str, torch.Tensor],
               g_norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply one update to ``params`` in place and advance ``state``.
        Returns the global gradient norm before clipping: that of ``grads``,
        or ``g_norm`` where the caller holds only part of the gradient (an
        fsdp rank's blocks; ``train.step.FsdpParams.global_norm``)."""
        names = list(params)
        g = [grads[n].float() for n in names]
        if g_norm is None:
            g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        if self.grad_clip:
            # optax's select(g_norm < clip, t, t / g_norm * clip) on the device,
            # with no host sync: dividing and multiplying by 1 leaves t exact.
            keep = g_norm < self.grad_clip
            g = torch._foreach_div(g, torch.where(keep, 1.0, g_norm))
            torch._foreach_mul_(g, torch.where(keep, 1.0, self.grad_clip))
        mu = [state["mu"][n] for n in names]
        nu = [state["nu"][n] for n in names]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        lr = self.schedule(state["count"])
        state["count"] += 1
        count = state["count"]
        m_hat = torch._foreach_div(mu, 1 - self.b1 ** count)
        denom = torch._foreach_div(nu, 1 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(m_hat, denom)
        if self.weight_decay:
            idx = [i for i, n in enumerate(names) if self.decay is None or self.decay[n]]
            torch._foreach_add_([upd[i] for i in idx], [params[names[i]] for i in idx],
                                alpha=self.weight_decay)
        torch._foreach_add_([params[n] for n in names], upd, alpha=-lr)
        return g_norm


def make_optimizer(
    learning_rate: float = 2e-4,
    schedule: str = "constant_with_warmup",
    warmup_steps: int = 1000,
    total_steps: Optional[int] = None,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    grad_clip: Optional[float] = 1.0,
    params: Optional[Dict[str, torch.Tensor]] = None,
) -> AdamW:
    """The JAX ``make_optimizer``'s optimizer. ``params`` (the model's named
    parameters) sets the decay mask, as the JAX pytree does there."""
    sched = make_schedule(schedule, learning_rate, warmup_steps, total_steps)
    mask = decay_mask(params) if (params is not None and weight_decay > 0) else None
    return AdamW(sched, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, decay=mask,
                 grad_clip=grad_clip or None)
