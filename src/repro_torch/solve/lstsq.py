"""``solve.lstsq`` — the front door of the packed solver layer (port of
``repro.solve.lstsq``).

    x = lstsq(A, b, ridge=…)

dispatched through ``repro_torch.tune.plan(op="solve", m, n, k=r)``, which
prices the two methods and picks per shape and RHS count:

* ``method='factor'`` — planned ``ata(A, out='packed')`` → packed blocked
  Cholesky → two packed triangular substitutions, with no dense ``(n, n)``
  anywhere. ``Aᵀb`` is a plain float32 ``torch.matmul`` (the reference
  leaves it to XLA too).
* ``method='cg'`` — matrix-free CG on the gram operator
  (:func:`repro_torch.solve.cg.cg_lstsq`): one TN product pair per
  iteration, the gram never formed.

Pinning ``method=`` bypasses the planner: the inner products run on the
static ``n_base``/``variant`` defaults, bitwise reproducible whatever the
plan cache holds. A frozen ``plan`` is followed as it stands.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import obs
from repro_torch.backend import planner_key
from repro_torch.core.ata import ata
from repro_torch.core.strassen import _dot_tn
from repro_torch.solve.cg import cg_lstsq
from repro_torch.solve.cholesky import cholesky
from repro_torch.solve.triangular import solve_cholesky
from repro_torch.tune import defaults as _defaults

__all__ = ["lstsq"]


def lstsq(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ridge: float = 0.0,
    plan=None,
    method: Optional[str] = None,
    packed_block: Optional[int] = None,
    iters: Optional[int] = None,
    tol: Optional[float] = None,
) -> torch.Tensor:
    """Least squares ``min_x ‖A·x − b‖² + ridge·‖x‖²`` via the normal
    equations, packed-native.

    Args:
      a: ``(m, n)`` design matrix.
      b: ``(m,)`` or ``(m, r)`` right-hand side(s).
      ridge: Tikhonov ``λ``, added on the gram's logical diagonal (factor
        path) or inside the CG operator.
      plan: frozen ``repro_torch.tune.Plan`` with ``op='solve'`` carrying
        every tunable (method, gram algorithm and cutoff, packed block,
        base engines). With no plan and no ``method`` the call is planned
        by ``repro_torch.tune.plan`` for ``a``'s device and dtype.
      method: ``'factor'`` or ``'cg'``; pinning it bypasses the planner
        (static defaults for the rest).
      packed_block: packed grid block size (factor path).
      iters, tol: CG budget overrides (CG path).

    Returns:
      ``x``: ``(n,)`` or ``(n, r)``, matching ``b``.
    """
    if a.ndim != 2:
        raise ValueError(f"lstsq expects a 2-D design matrix, got {tuple(a.shape)}")
    m, n = a.shape
    r = 1 if b.ndim == 1 else b.shape[-1]
    if b.shape[0] != m:
        raise ValueError(f"rhs rows {b.shape[0]} != design rows {m}")

    if plan is None and method is None:
        from repro_torch import tune

        backend, dtype = planner_key(a)
        plan = tune.plan(op="solve", m=m, n=n, k=r, dtype=dtype, out="packed",
                         backend=backend)
    if method is None:
        method = plan.method or _defaults.DEFAULT_SOLVE_METHOD
    if method not in ("factor", "cg"):
        raise ValueError(f"unknown solve method {method!r}; use 'factor' or 'cg'")
    # a pinned method with no plan: the inner products run on the static
    # defaults (the reference's pinned regime), bitwise reproducible
    static_kw = {}
    if plan is None:
        static_kw = dict(n_base=_defaults.DEFAULT_N_BASE, variant=_defaults.DEFAULT_VARIANT)

    obs.metrics.inc(f"dispatch.solve.{method}")
    t0 = obs.dispatch_start(plan, a)
    if method == "cg":
        with obs.span("solve.lstsq", method="cg", m=m, n=n, r=r):
            x = cg_lstsq(a, b, ridge=ridge, iters=iters, tol=tol, plan=plan, **static_kw)
            return obs.dispatch_finish(plan, t0, x)

    ata_plan = None
    if plan is not None:
        if packed_block is None:
            packed_block = plan.packed_block
        # predicted_s=None: the solve's prediction prices the whole
        # pipeline, not the inner gram, which must not record a row of it
        ata_plan = dataclasses.replace(plan, op="ata", k=n, out="packed", method=None,
                                       predicted_s=None)
    with obs.span("solve.lstsq", method="factor", m=m, n=n, r=r):
        a32 = a.to(torch.float32)
        with obs.span("solve.gram"):
            gram = ata(a32, plan=ata_plan, out="packed", packed_block=packed_block, **static_kw)
        if ridge:
            gram = gram.add_scaled_identity(ridge)
        vector = b.ndim == 1
        b2 = (b[:, None] if vector else b).to(torch.float32)
        rhs = _dot_tn(a32, b2, torch.float32)          # Aᵀb, Aᵀ never formed
        with obs.span("solve.cholesky"):
            factor = cholesky(gram, plan=plan)
        with obs.span("solve.substitution"):
            x = solve_cholesky(factor, rhs, plan=plan)
        x = x[..., 0] if vector else x
        return obs.dispatch_finish(plan, t0, x)
