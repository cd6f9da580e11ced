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

__all__ = ["all_reduce", "reduce_scatter", "all_gather", "group_size"]


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
