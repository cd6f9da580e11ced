"""Matrix-free conjugate gradient on the gram *operator* (port of
``repro.solve.cg``).

``cg_lstsq`` solves the ridge normal equations

    (AᵀA + λI)·x = Aᵀb

without ever forming ``AᵀA``: each CG iteration applies the operator as one
TN product pair,

    p ↦ Aᵀ(A·p) + λp        (``A·p`` a plain float32 ``torch.matmul``,
                             ``Aᵀ(·)`` the port's ``strassen_tn`` — ``Aᵀ``
                             is never materialized),

so the device holds ``O(m·r + n·r)`` beside ``A`` instead of the packed
gram's ``O(n²)``. Multi-RHS: the textbook iteration runs vectorized over
the ``r`` columns with per-column step sizes; converged columns freeze
(their updates are masked to zero with ``torch.where``), so one Python loop
with a fixed trip count serves every column and nothing waits on the host:
no ``.item()``, no truth value of a tensor, no branch on data.

``cg_gram`` is the generic SPD-operator CG the lstsq wrapper builds on.
The TN products' dispatch comes from ``gemm_plan``, pins, the solve
``plan`` or the planner, in the reference's order (:func:`cg_lstsq`);
planning runs on the host only (after the first product, a memo lookup).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import obs

__all__ = ["cg_gram", "cg_lstsq"]


def cg_gram(
    matvec: Callable,
    b: torch.Tensor,
    *,
    iters: int,
    tol: float = 1e-6,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """CG for ``G·x = b`` with SPD operator ``matvec: (n, r) → (n, r)``.

    ``b``: ``(n,)`` or ``(n, r)``; columns iterate independently (separate
    α/β per column) inside one vectorized loop. A column stops *updating*
    once its residual norm falls below ``tol·‖b‖``; the loop itself always
    runs ``iters`` trips, so the launches of a solve are fixed in advance.
    """
    vector = b.ndim == 1
    if vector:
        b = b[:, None]
    b = b.to(torch.float32)
    x = torch.zeros_like(b) if x0 is None else x0.to(torch.float32)
    r = b - matvec(x) if x0 is not None else b
    stop2 = (tol * tol) * torch.clamp(torch.sum(b * b, dim=0), min=1e-30)
    p = r
    rs = torch.sum(r * r, dim=0)
    for _ in range(iters):
        live = rs > stop2                           # per-column progress mask
        gp = matvec(p)
        denom = torch.sum(p * gp, dim=0)
        alpha = torch.where(live, rs / torch.clamp(denom, min=1e-30), 0.0)
        x = x + alpha * p
        r = r - alpha * gp
        rs_new = torch.sum(r * r, dim=0)
        beta = torch.where(live, rs_new / torch.clamp(rs, min=1e-30), 0.0)
        p = r + beta * p
        rs = rs_new
    return x[:, 0] if vector else x


def cg_lstsq(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ridge: float = 0.0,
    iters: Optional[int] = None,
    tol: Optional[float] = None,
    plan=None,
    gemm_plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
) -> torch.Tensor:
    """Ridge least squares via CG on the normal-equations operator.

    ``a``: ``(m, n)``; ``b``: ``(m,)`` or ``(m, r)``. Each iteration is one
    TN product pair; the dispatch of the ``Aᵀ(·)`` product and of ``Aᵀb``
    comes, in order, from ``gemm_plan`` (an ``op='gemm_tn'`` plan), the
    ``n_base``/``variant`` pins (the static dispatch, bitwise reproducible:
    what ``lstsq(method='cg')`` passes), the solve ``plan``'s algorithm
    tunables, or the ``repro_torch.tune.plan`` front door. Iteration
    budget and tolerance default to ``repro_torch.tune.defaults``
    (``CG_MAX_ITERS`` capped by ``n`` — exact termination in exact
    arithmetic — and ``CG_TOL``).
    """
    from repro_torch.core.strassen import strassen_tn
    from repro_torch.tune import defaults

    if a.ndim != 2:
        raise ValueError(f"cg_lstsq expects a 2-D operand, got {tuple(a.shape)}")
    m, n = a.shape
    if iters is None:
        iters = min(n, defaults.CG_MAX_ITERS)
    if tol is None:
        tol = defaults.CG_TOL
    a = a.to(torch.float32)
    vector = b.ndim == 1
    b2 = (b[:, None] if vector else b).to(torch.float32)
    kw = {}
    if gemm_plan is not None:
        kw["plan"] = gemm_plan
    elif n_base is not None or variant is not None:
        kw = dict(n_base=n_base, variant=variant)
    elif plan is not None:
        # the solve plan's algorithm tunables ('dense' as a cutoff covering
        # the whole operand, as resolve_tunables expresses it)
        kw = dict(n_base=max(plan.n_base, m, n) if plan.algorithm == "dense" else plan.n_base,
                  variant=plan.variant)

    obs.metrics.inc("solve.cg.calls")
    # the fixed trip count IS the iteration budget (columns converge by
    # freezing inside the loop, not by leaving it)
    obs.metrics.set_gauge("solve.cg.iters", iters)

    def matvec(p):
        ap = torch.matmul(a, p)            # (m, r) plain float32 product
        atap = strassen_tn(a, ap, **kw)    # Aᵀ(A·p): the planned TN product
        return atap + ridge * p if ridge else atap

    with obs.span("solve.cg", iters=iters, m=m, n=n):
        rhs = strassen_tn(a, b2, **kw)     # Aᵀb — the same TN dispatch
        x = cg_gram(matvec, rhs, iters=iters, tol=tol)
    return x[:, 0] if vector else x
