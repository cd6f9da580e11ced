"""The collectives of the distributed schedules, on ``torch.distributed``.

Each wrapper takes a tensor and a ``ProcessGroup`` and returns a new
tensor on the input's device; the input is not changed. A group of None
is a line of one rank: the collective is the identity and returns the
input itself. Each call feeds the ``collective_bytes.<kind>`` counter (``obs.metrics.record_collective_bytes``)
with the bytes of the rank's result, as the reference counts a compiled
module's collectives from their result shapes: ``all-reduce`` the reduced
buffer, ``reduce-scatter`` the rank's chunk, ``all-gather`` the gathered
stack. With tracing on (``obs.enable()``) each call also waits for the
device before and after and records its seconds in the histogram
``collective_seconds.<kind>``; with it off (the default) nothing waits.

The collectives run outside any kernel, over NCCL (one card per rank) or
gloo. gloo takes CUDA tensors for all three on the torch versions the port
runs on (2.11 on the card, 2.13 here), so ranks that share one card need
no staging through host memory.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch import obs

__all__ = ["all_reduce", "reduce_scatter", "all_gather", "group_size", "all_gather_dim",
           "reduce_scatter_dim", "gather_replicas", "gather_params", "reduce_replicas",
           "sum_grads"]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _timed(kind: str, x: torch.Tensor, run) -> None:
    if not obs.enabled():
        run()
        return
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    t0 = time.perf_counter()
    run()
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    obs.metrics.observe(f"collective_seconds.{kind}", time.perf_counter() - t0)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, on every rank."""
    if group_size(group) == 1:
        return x
    out = x.clone(memory_format=torch.contiguous_format)
    obs.metrics.record_collective_bytes({"all-reduce": out.numel() * out.element_size()})
    _timed("all-reduce", out, lambda: dist.all_reduce(out, group=group))
    return out


def reduce_scatter(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, dealt in equal chunks along dim
    0: the rank at group position ``g`` gets chunk ``g``."""
    p = group_size(group)
    if p == 1:
        return x
    if x.shape[0] % p:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over {p} ranks")
    out = x.new_empty((x.shape[0] // p, *x.shape[1:]))
    obs.metrics.record_collective_bytes({"reduce-scatter": out.numel() * out.element_size()})
    _timed("reduce-scatter", out,
           lambda: dist.reduce_scatter_tensor(out, x.contiguous(), group=group))
    return out


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` stacked along dim 0 in group order (concatenated:
    the result has ``p·x.shape[0]`` rows)."""
    p = group_size(group)
    if p == 1:
        return x
    out = x.new_empty((p * x.shape[0], *x.shape[1:]))
    obs.metrics.record_collective_bytes({"all-gather": out.numel() * out.element_size()})
    _timed("all-gather", out,
           lambda: dist.all_gather_into_tensor(out, x.contiguous(), group=group))
    return out


# ---------------------------------------------------------------------------
# along a mesh axis, and under autograd
# ---------------------------------------------------------------------------
#
# The model code's split regions (context-parallel attention, the split SSD,
# the expert-parallel MoE) run inside a computation every ``model`` rank
# otherwise repeats whole: the same input, the same weights, the same loss.
# Their collectives are differentiable under that rule, as Megatron's are:
#
# * :func:`gather_replicas` gathers the ranks' slices along a dim; what
#   follows is repeated on every rank, so each rank's cotangent of the
#   gathered tensor is the whole one, and the backward pass keeps this
#   rank's slice of it (no collective);
# * :func:`reduce_replicas` sums (or takes the maximum of) the ranks'
#   partial results; the cotangent of the result is the same on every rank
#   and passes to each rank's part unchanged (for the maximum: to the ranks
#   that hold it);
# * :func:`sum_grads` is the identity forward and sums the cotangent over
#   the ranks backward: it marks a replicated tensor (an input of the
#   region, or a weight the region reads whole) whose gradient each rank
#   computes only in part, from its own slice of the work;
# * :func:`gather_params` gathers the ranks' blocks of a tensor that each
#   rank then uses whole for its own part of the work (a weight block held
#   under ``param_specs`` that a region reads whole, or a sequence slice a
#   layer needs whole); each rank's cotangent of the gathered tensor is
#   partial, so the backward pass sums the cotangents and gives each rank
#   its block (a reduce-scatter).
#
# A region that reads a replicated weight or input and omits
# :func:`sum_grads` leaves that gradient partial; one that adds it to a
# tensor used whole by every rank multiplies its gradient by the rank
# count.


def all_gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` of the line along ``axes`` concatenated along
    ``dim``, in the order of :meth:`Mesh.axis_index` (for merged axes, the
    first named slowest). Not differentiable."""
    group = mesh.group(axes)
    p = group_size(group)
    if p == 1:
        return x
    moved = x.movedim(dim, 0).contiguous()
    out = all_gather(moved, group)
    order = mesh.pool_order(axes) if not isinstance(axes, str) else None
    if order is not None:
        chunks = out.chunk(p, 0)
        out = torch.cat([chunks[order.index(i)] for i in range(p)], 0)
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over the line along ``axes``, cut along ``dim``
    into equal blocks: this rank gets the block of its
    :meth:`Mesh.axis_index`. Not differentiable."""
    group = mesh.group(axes)
    p = group_size(group)
    if p == 1:
        return x
    moved = x.movedim(dim, 0)
    order = mesh.pool_order(axes) if not isinstance(axes, str) else None
    if order is not None:
        chunks = moved.chunk(p, 0)
        moved = torch.cat([chunks[order[g]] for g in range(p)], 0)
    return reduce_scatter(moved.contiguous(), group).movedim(0, dim)


class _GatherParams(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _GatherReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim, ctx.size = mesh, axes, dim, x.shape[dim]
        return all_gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axes)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


class _ReduceReplicas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, op):
        group = mesh.group(axes)
        if op == "sum":
            out = all_reduce(x, group)
        else:
            out = x.clone(memory_format=torch.contiguous_format)
            obs.metrics.record_collective_bytes({"all-reduce": out.numel() * out.element_size()})
            _timed("all-reduce", out,
                   lambda: dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group))
            ctx.save_for_backward(x == out)
        ctx.op = op
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.op == "sum":
            return g, None, None, None
        (holds,) = ctx.saved_tensors
        return g * holds, None, None, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh.group(ctx.axes)), None, None


def gather_replicas(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """:func:`all_gather_dim`, differentiable for ranks that repeat what
    follows: the backward pass keeps this rank's slice of the cotangent."""
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherReplicas.apply(x, mesh, axes, dim)


def gather_params(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` along ``axes`` concatenated along ``dim``
    (:func:`all_gather_dim`), for a rank that uses the whole tensor for its
    own part of the work: the backward pass sums the ranks' cotangents and
    keeps this rank's block of the sum (a reduce-scatter)."""
    if mesh.axis_size(axes) == 1:
        return x
    return _GatherParams.apply(x, mesh, axes, dim)


def reduce_replicas(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """Sum (``op="sum"``) or maximum (``op="max"``) of ``x`` over the line
    along ``axes``, differentiable for ranks that repeat what follows: the
    cotangent passes to each rank's ``x`` unchanged (sum) or to the ranks
    whose ``x`` holds the maximum (max)."""
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', got {op!r}")
    if mesh.axis_size(axes) == 1:
        return x
    return _ReduceReplicas.apply(x, mesh, axes, op)


def sum_grads(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` itself; its cotangent is summed over the line along ``axes``
    (the gradient of a replicated tensor each rank uses in part)."""
    if mesh.axis_size(axes) == 1 or not torch.is_grad_enabled():
        return x
    return _SumGrads.apply(x, mesh, axes)
