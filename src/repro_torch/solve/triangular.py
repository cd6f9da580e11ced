"""Blocked forward/backward substitution against a packed Cholesky factor
(port of ``repro.solve.triangular``).

    forward  (L·y = b):     y_i = L[i,i]⁻¹·(b_i − Σ_{j<i} L[i,j]·y_j)
    backward (Lᵀ·x = y):    x_i = L[i,i]⁻ᵀ·(y_i − Σ_{j>i} L[j,i]ᵀ·x_j)

The Σ terms are one float32 block einsum per step or, on a walk that runs
on kernels (``cholesky._kernel_walk``: CUDA float32 or bfloat16 under a
plan with kernels, or none), ONE ``ops.gemm_tn`` launch per step whose
contraction is the stacked ``(j, b)`` axis in ascending order, the
subtraction rounded once: the forward pass reads each ``L[i,j]``
transposed once (the step that uses it), the backward pass ``L[j,i]`` as
it is. Each right-hand-side column is summed on its own and in the same
order whatever the batch, so zero columns and batching leave the other
columns' bits unchanged (``repro_torch.serve``). The diagonal solves go
to the plan's trsm engine on the transposed right-hand-side tile: with
``plan.use_kernels`` or no plan ``ops.trsm`` (the CUDA kernel on a CUDA
tensor, its plain version on a CPU one), without kernels the plain
version. A float64 factor or right-hand side, which no kernel takes, goes
to the plain version on every device. ``solve_cholesky`` composes the two into ``A·x = b`` for
``A = L·Lᵀ``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.solve.cholesky import CholeskyFactor, _acc, _flat_call, _kernel_walk, _tn

__all__ = ["solve_triangular", "solve_cholesky"]


def _left_solve(l, c, *, transpose: bool, plan=None):
    """Left solve on ``(..., bn, r)`` tiles through the right-sided trsm of
    the plan's engine (``ops.bases`` with no plan):

        L·y = c   ⇔  yᵀ·Lᵀ = cᵀ    (trsm transpose=True)
        Lᵀ·y = c  ⇔  yᵀ·L  = cᵀ    (trsm transpose=False)

    ``cᵀ`` is a view: the plain version reads it in place; the kernel
    wrapper copies it once, counted in ``kernels.copy.trsm``.
    """
    from repro_torch.tune.apply import engine

    ct = c.transpose(-1, -2)
    acc = torch.promote_types(torch.promote_types(l.dtype, c.dtype), torch.float32)
    trsm = functools.partial(engine(plan, acc).trsm, out_dtype=acc)
    yt = _flat_call(lambda lf, cf: trsm(lf, cf, transpose=not transpose), l, ct)
    return yt.transpose(-1, -2)


def solve_triangular(
    f: CholeskyFactor,
    b: torch.Tensor,
    *,
    transpose: bool = False,
    plan=None,
    base_trsm: Optional[Callable] = None,
) -> torch.Tensor:
    """Solve ``L·y = b`` (``transpose=False``) or ``Lᵀ·x = b`` against the
    packed factor, blockwise. ``b``: ``(..., n)`` or ``(..., n, r)``;
    returns the same shape. ``plan`` chooses the diagonal solves' engine;
    ``base_trsm(l, c, transpose=...)``, if given, solves the left
    diagonal-tile system on ``(..., bn, r)`` tiles instead."""
    nb, bn, n = f.nb, f.bn, f.n
    vector = b.ndim == f.blocks.ndim - 2
    if vector:
        b = b[..., None]
    if b.shape[-2] != n:
        raise ValueError(f"rhs rows {b.shape[-2]} != factor n {n}")
    pad = nb * bn - n
    if pad:
        b = F.pad(b, (0, 0, 0, pad))
    batch = tuple(b.shape[:-2])
    r = b.shape[-1]
    bs = b.reshape(*batch, nb, bn, r)
    solve_diag = base_trsm or functools.partial(_left_solve, plan=plan)
    kernels = _kernel_walk(f.blocks, plan)

    xs: dict = {}
    order = range(nb) if not transpose else range(nb - 1, -1, -1)
    for i in order:
        c = bs[..., i, :, :]
        done = range(i) if not transpose else range(i + 1, nb)
        if done and kernels:
            # rows (j, b): L[i,j]ᵀ (forward) or L[j,i] (backward), and x_j
            lt = [f.block(i, j).mT if not transpose else f.block(j, i) for j in done]
            c = c - _tn(torch.cat(lt, -2), torch.cat([xs[j] for j in done], -2))
        elif done:
            lt = torch.stack([f.block(i, j) if not transpose else f.block(j, i)
                              for j in done], dim=0)
            xt = torch.stack([xs[j] for j in done], dim=0)
            eq = "k...ab,k...br->...ar" if not transpose else "k...ba,k...br->...ar"
            c = c - torch.einsum(eq, _acc(lt), _acc(xt))
        xs[i] = solve_diag(f.block(i, i), c, transpose=transpose)

    x = torch.cat([xs[i] for i in range(nb)], dim=-2)[..., :n, :]
    return x[..., 0] if vector else x


def solve_cholesky(
    f: CholeskyFactor,
    b: torch.Tensor,
    *,
    plan=None,
    base_trsm: Optional[Callable] = None,
) -> torch.Tensor:
    """Full SPD solve ``A·x = b`` given the packed factor ``A = L·Lᵀ``."""
    y = solve_triangular(f, b, transpose=False, plan=plan, base_trsm=base_trsm)
    return solve_triangular(f, y, transpose=True, plan=plan, base_trsm=base_trsm)
