"""Thread a frozen Plan into the port's executables (port of
``repro.tune.apply``).

The consumers (``core.ata``, ``core.strassen``, ``solve``, ``kernels.ops``)
accept ``plan=`` and read their tunables from it; this module holds what
looks *down* the stack — the base engines a plan selects — and the
callable the autotuner times.
"""

from __future__ import annotations

import functools
from typing import Optional

from repro_torch.tune import cost

__all__ = [
    "base_fns",
    "fused_fns",
    "engine",
    "build_callable",
    "ata_with_plan",
    "ata_distributed_with_plan",
    "gemm_tn_with_plan",
    "lstsq_with_plan",
]


def engine(plan: Optional[cost.Plan], *dtypes):
    """The ``kernels.ops.Bases`` for operands and accumulation of
    ``dtypes`` under a plan: a plan without ``use_kernels`` takes the plain
    versions; one with it, or no plan (a pinned call), takes
    ``ops.bases`` — the ``ops`` wrappers (the CUDA kernel on a CUDA
    tensor), or the plain versions for float64, which no kernel takes."""
    from repro_torch.kernels import ops

    if plan is not None and not plan.use_kernels:
        return ops.PLAIN
    return ops.bases(*dtypes)


def base_fns(plan: cost.Plan):
    """(base_syrk, base_dot) for the recursion bottom under this plan: the
    ``kernels.ops`` wrappers of :func:`engine`'s kernel path with the plan's
    block shapes, or ``(None, None)`` when the plan does not use kernels,
    so the recursion keeps its plain base case (the reference's contract).
    """
    if not plan.use_kernels:
        return None, None
    eng = engine(plan)
    return (functools.partial(eng.syrk, blocks=plan.syrk_blocks),
            functools.partial(eng.gemm_tn, blocks=plan.gemm_blocks))


def fused_fns(plan: cost.Plan):
    """(fused_syrk, fused_dot) for ``leaf_dispatch='fused'`` under this
    plan: the ``syrk_gather`` and ``gemm_tn_fused`` wrappers of
    :func:`engine` with the plan's block shapes, or ``(None, None)`` when
    the plan does not use kernels (the recursion then gathers per leaf)."""
    if not plan.use_kernels:
        return None, None
    eng = engine(plan)
    return (functools.partial(eng.syrk_gather, blocks=plan.syrk_blocks),
            functools.partial(eng.gemm_tn_fused, blocks=plan.gemm_blocks))


def ata_with_plan(a, plan: cost.Plan, **kw):
    """``ata``/``ata_batched`` dispatched exactly as the plan says."""
    from repro_torch.core.ata import ata, ata_batched

    fn = ata_batched if plan.batch else ata
    return fn(a, plan=plan, out=plan.out, **kw)


def ata_distributed_with_plan(a, mesh, plan: cost.Plan, *, task_axis: str = "model",
                              row_axis=None, **kw):
    """Distributed ATA dispatched exactly as the plan says: a
    ``comm_schedule`` with a ``'B'`` runs ``ata_bfs_dfs`` (the tri-direct
    reduce-scatter over the merged pool); None or a pure-``'D'`` string
    runs ``ata_tile_parallel``, which a pure-``'D'`` ``ata_bfs_dfs`` equals
    bitwise anyway. ``a`` is this rank's view (see the schedules)."""
    from repro_torch.core.distributed import ata_bfs_dfs, ata_tile_parallel

    cs = plan.comm_schedule
    if cs and "B" in cs:
        return ata_bfs_dfs(a, mesh, task_axis=task_axis, row_axis=row_axis, plan=plan,
                           interleaving=cs, out=plan.out, **kw)
    return ata_tile_parallel(a, mesh, task_axis=task_axis, row_axis=row_axis, plan=plan,
                             out=plan.out, **kw)


def gemm_tn_with_plan(a, b, plan: cost.Plan, **kw):
    from repro_torch.core.strassen import strassen_tn

    return strassen_tn(a, b, plan=plan, **kw)


def lstsq_with_plan(a, b, plan: cost.Plan, **kw):
    """``solve.lstsq`` dispatched exactly as the plan says (method, gram
    tunables, base engines)."""
    from repro_torch.solve.lstsq import lstsq

    return lstsq(a, b, plan=plan, **kw)


def build_callable(plan: cost.Plan):
    """A plain closure executing the plan: what the autotuner times."""
    if plan.op == "gemm_tn":
        return lambda a, b: gemm_tn_with_plan(a, b, plan)
    if plan.op == "solve":
        return lambda a, b: lstsq_with_plan(a, b, plan)
    return lambda a: ata_with_plan(a, plan)
