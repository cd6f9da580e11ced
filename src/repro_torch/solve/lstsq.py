"""``solve.lstsq`` — the front door of the packed solver layer (port of
``repro.solve.lstsq``).

    x = lstsq(A, b, ridge=…)

* ``method='factor'`` — ``ata(A, out='packed')`` → packed blocked Cholesky
  → two packed triangular substitutions, with no dense ``(n, n)``
  anywhere. ``Aᵀb`` is a plain float32 ``torch.matmul`` (the reference
  leaves it to XLA too).
* ``method='cg'`` — matrix-free CG on the gram operator
  (:func:`repro_torch.solve.cg.cg_lstsq`): one TN product pair per
  iteration, the gram never formed.

Until the planner is ported, the port behaves as the reference does with
``method=`` pinned: ``method=None`` is ``DEFAULT_SOLVE_METHOD`` and the
inner products run on the static ``n_base``/``variant``/``packed_block``
defaults, bitwise reproducible.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
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
      method: ``'factor'`` or ``'cg'``; ``None`` is ``DEFAULT_SOLVE_METHOD``.
      packed_block: packed grid block size (factor path; default 128).
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
    method = method or _defaults.DEFAULT_SOLVE_METHOD
    if method not in ("factor", "cg"):
        raise ValueError(f"unknown solve method {method!r}; use 'factor' or 'cg'")
    # a pinned method: the inner products run on the static defaults (the
    # reference's pinned regime), so the call is bitwise reproducible
    static_kw = dict(n_base=_defaults.DEFAULT_N_BASE, variant=_defaults.DEFAULT_VARIANT)

    obs.metrics.inc(f"dispatch.solve.{method}")
    t0 = obs.dispatch_start(None, a)   # no plan until the planner is ported
    if method == "cg":
        with obs.span("solve.lstsq", method="cg", m=m, n=n, r=r):
            x = cg_lstsq(a, b, ridge=ridge, iters=iters, tol=tol, **static_kw)
            return obs.dispatch_finish(None, t0, x)

    with obs.span("solve.lstsq", method="factor", m=m, n=n, r=r):
        a32 = a.to(torch.float32)
        with obs.span("solve.gram"):
            gram = ata(a32, out="packed", packed_block=packed_block, **static_kw)
        if ridge:
            gram = gram.add_scaled_identity(ridge)
        vector = b.ndim == 1
        b2 = (b[:, None] if vector else b).to(torch.float32)
        rhs = _dot_tn(a32, b2, torch.float32)          # Aᵀb, Aᵀ never formed
        with obs.span("solve.cholesky"):
            factor = cholesky(gram)
        with obs.span("solve.substitution"):
            x = solve_cholesky(factor, rhs)
        x = x[..., 0] if vector else x
        return obs.dispatch_finish(None, t0, x)
