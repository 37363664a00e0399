"""Differentiable collectives over one mesh axis: the ``jax.lax``
primitives the sharded code uses (``all_gather``, untiled and tiled,
``psum_scatter``, ``ppermute``, ``psum``; ``axis_index`` is
``Axis.index``), as ``torch.autograd`` Functions over
``torch.distributed``, and ``broadcast`` (not differentiable) for the
server's leader.

Adjoints, as JAX transposes them:
* ``all_gather`` stacks every rank's tensor; its adjoint is the sum over
  the ranks of their cotangents, each rank taking its own slice (a
  reduce-scatter: each rank receives only the sum of its slice);
  ``all_gather_tiled`` concatenates along a dimension instead, and its
  adjoint is ``psum_scatter`` along it;
* ``psum_scatter`` (``tiled=True``) sums over the ranks and leaves rank i
  the i-th block of ``dim``; its adjoint is the tiled all_gather;
* ``ppermute`` moves tensors along (source, destination) pairs of axis
  coordinates, a rank that receives nothing getting zeros; its adjoint is
  the reverse ``ppermute``;
* ``psum`` sums over the axis; its adjoint sums the cotangents.

The tensor-parallel mixers pin their sums' adjoints down as JAX's custom
VJPs do (``models/caduceus.py`` ``_psum_id_bwd``, ``_psum_psum_bwd``,
``_tp_boundary``):
* ``psum_id_bwd``: a sum forward, the identity backward (out_proj's
  partial products, summed into the replicated residual stream, whose
  cotangent is already whole on every rank);
* ``psum_psum_bwd``: a sum both ways (x_proj's dt/B/C and the Mamba-2
  gated norm's sum of squares, consumed by every rank's shard, each of
  which returns only its part of the cotangent);
* ``tp_boundary``: the identity forward, a sum backward (the replicated
  input entering the sharded projections).

Under gloo (``Axis.staged``) every collective copies its tensors to the
host, runs there and copies the result back to the tensor's device,
whatever the device: nothing depends on which device operations gloo
supports. Under NCCL the tensors stay on the rank's card, and a tensor on
the host is refused. On an axis of size 1 each is the identity (or a stack
of one).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from plantcaduceus_tpu_torch.parallel.mesh import Axis


def _buffer(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A contiguous copy of ``t`` for the backend to work in: on the host
    under gloo, on ``t``'s card under NCCL, which takes no host tensor."""
    if axis.staged:
        return t.detach().to("cpu", copy=True)
    if t.device.type != "cuda":
        raise ValueError(f"collective over {axis.name!r}: NCCL takes tensors on the rank's "
                         f"card, got one on {t.device}")
    return t.detach().clone(memory_format=torch.contiguous_format)


def _all_reduce(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    buf = _buffer(t, axis)
    dist.all_reduce(buf, group=axis.group)
    return buf.to(t.device)


def _all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    buf = _buffer(t, axis)
    out = [torch.empty_like(buf) for _ in range(axis.size)]
    dist.all_gather(out, buf, group=axis.group)
    return torch.stack(out).to(t.device)


def _reduce_scatter(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[axis.size, *s] -> [*s]``: the sum over the ranks of their
    ``t[axis.index]``."""
    buf = _buffer(t, axis)
    out = torch.empty_like(buf[0])
    dist.reduce_scatter(out, list(buf.unbind(0)), group=axis.group)
    return out.to(t.device)


def _ppermute(t: torch.Tensor, axis: Axis, perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    buf = _buffer(t, axis)
    recv = torch.zeros_like(buf)
    ops = []
    for src, dst in perm:
        if src == dst == axis.index:  # to itself: no message
            recv = buf
        elif src == axis.index:
            ops.append(dist.P2POp(dist.isend, buf, axis.ranks[dst], axis.group))
        elif dst == axis.index:
            ops.append(dist.P2POp(dist.irecv, recv, axis.ranks[src], axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(t.device)


def _psum_scatter(t: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    if t.shape[dim] % axis.size:
        raise ValueError(f"psum_scatter over {axis.name!r}: dimension {dim} of size "
                         f"{t.shape[dim]} does not divide over {axis.size} ranks")
    return _reduce_scatter(torch.stack(t.chunk(axis.size, dim)), axis)


def _broadcast(t: torch.Tensor, axis: Axis, src: int) -> torch.Tensor:
    buf = _buffer(t, axis)
    dist.broadcast(buf, src=axis.ranks[src], group=axis.group)
    return buf.to(t.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_gather(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.axis), None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _psum_scatter(t, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return torch.cat(list(_all_gather(g, ctx.axis)), dim=ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _ppermute(t, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.axis, tuple((d, s) for s, d in ctx.perm)), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _PsumIdBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return _all_reduce(t, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpBoundary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def all_gather(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``[axis.size, *t.shape]``: every rank's ``t`` in axis order
    (``jax.lax.all_gather``, untiled)."""
    if axis.size == 1:
        return t[None]
    return _AllGather.apply(t, axis)


def all_gather_tiled(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in axis order
    (``jax.lax.all_gather(..., axis=dim, tiled=True)``); its adjoint is
    :func:`psum_scatter` along ``dim``."""
    if axis.size == 1:
        return t
    return torch.cat(list(_AllGather.apply(t, axis)), dim=dim)


def psum_scatter(t: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """The sum of ``t`` over the axis, of which rank i keeps the i-th of
    ``axis.size`` equal blocks along ``dim``
    (``jax.lax.psum_scatter(..., scatter_dimension=dim, tiled=True)``);
    raises when ``dim`` does not divide over the ranks."""
    if axis.size == 1:
        return t
    return _PsumScatter.apply(t, axis, dim)


def broadcast(t: torch.Tensor, axis: Axis, src: int = 0) -> torch.Tensor:
    """The ``t`` of the rank at coordinate ``src`` on every rank of the axis
    (every rank passes a tensor of the same shape and dtype; the others'
    values are ignored). Not differentiable."""
    if axis.size == 1:
        return t
    return _broadcast(t, axis, src)


def ppermute(t: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``t`` from coordinate ``src`` to ``dst`` for each pair of
    ``perm``; a rank that receives nothing gets zeros
    (``jax.lax.ppermute``)."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    if axis.size == 1:
        return t if (0, 0) in perm else torch.zeros_like(t)
    return _Ppermute.apply(t, axis, perm)


def psum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of ``t`` over the axis (``jax.lax.psum``)."""
    if axis.size == 1:
        return t
    return _Psum.apply(t, axis)


def psum_id_bwd(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``t`` over the axis, with the identity as its adjoint
    (JAX ``_psum_id_bwd``); ``t`` itself without an axis."""
    if axis is None or axis.size == 1:
        return t
    return _PsumIdBwd.apply(t, axis)


def psum_psum_bwd(t: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``t`` over the axis, its adjoint a sum too (JAX
    ``_psum_psum_bwd``: :func:`psum`); ``t`` itself without an axis."""
    if axis is None or axis.size == 1:
        return t
    return _Psum.apply(t, axis)


def tp_boundary(t: torch.Tensor, axis) -> torch.Tensor:
    """``t``, with the sum over the axis as its adjoint (JAX
    ``_tp_boundary``); ``t`` itself without an axis."""
    if axis is None or axis.size == 1:
        return t
    return _TpBoundary.apply(t, axis)
