"""``solve.lstsq`` — the front door of the packed solver layer (port of
``repro.solve.lstsq``, factor path).

    x = lstsq(A, b, ridge=…)

runs ``ata(A, out='packed')`` → packed blocked Cholesky → two packed
triangular substitutions, with no dense ``(n, n)`` anywhere. Until the
planner is ported, the port behaves as the reference does with
``method='factor'`` pinned: the static ``n_base``/``variant``/
``packed_block`` defaults, bitwise reproducible. ``Aᵀb`` is a plain
float32 ``torch.matmul`` (the reference leaves it to XLA too).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.ata import ata
from repro_torch.core.strassen import _dot_tn
from repro_torch.solve.cholesky import cholesky
from repro_torch.solve.triangular import solve_cholesky

__all__ = ["lstsq"]

CG_NOT_PORTED = (
    "method='cg' is not ported yet (ROADMAP.md, remaining queue item 2: "
    "solve/cg.py and the CG branch of lstsq)"
)


def lstsq(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    ridge: float = 0.0,
    method: Optional[str] = None,
    packed_block: Optional[int] = None,
) -> torch.Tensor:
    """Least squares ``min_x ‖A·x − b‖² + ridge·‖x‖²`` via the normal
    equations, packed-native.

    Args:
      a: ``(m, n)`` design matrix.
      b: ``(m,)`` or ``(m, r)`` right-hand side(s).
      ridge: Tikhonov ``λ``, added on the gram's logical diagonal.
      method: ``'factor'`` (the default and only ported method).
      packed_block: packed grid block size (default 128).

    Returns:
      ``x``: ``(n,)`` or ``(n, r)``, matching ``b``.
    """
    if a.ndim != 2:
        raise ValueError(f"lstsq expects a 2-D design matrix, got {tuple(a.shape)}")
    m, n = a.shape
    if b.shape[0] != m:
        raise ValueError(f"rhs rows {b.shape[0]} != design rows {m}")
    method = method or "factor"
    if method == "cg":
        raise NotImplementedError(CG_NOT_PORTED)
    if method != "factor":
        raise ValueError(f"unknown solve method {method!r}; use 'factor' or 'cg'")

    a32 = a.to(torch.float32)
    gram = ata(a32, out="packed", packed_block=packed_block)
    if ridge:
        gram = gram.add_scaled_identity(ridge)
    vector = b.ndim == 1
    b2 = (b[:, None] if vector else b).to(torch.float32)
    rhs = _dot_tn(a32, b2, torch.float32)          # Aᵀb, Aᵀ never formed
    factor = cholesky(gram)
    x = solve_cholesky(factor, rhs)
    return x[..., 0] if vector else x
