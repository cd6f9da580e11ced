"""Blocked right-looking Cholesky on the packed block grid (port of
``repro.solve.cholesky``).

``cholesky`` factors an SPD :class:`SymmetricMatrix` (or a dense square,
packed first) into a :class:`CholeskyFactor` on the same ``(..., T, bn,
bn)`` geometry; no dense ``(n, n)`` of the gram or the factor is formed:

    for block column j:
        S_jj   = A[j,j] − Σ_{k<j} L[j,k]·L[j,k]ᵀ   (one float32 einsum)
        L[j,j] = potrf(sym_tile(S_jj))              (diagonal kernel)
        S_ij   = A[i,j] − Σ_{k<j} L[i,k]·L[j,k]ᵀ   (one float32 einsum)
        L[i,j] = trsm(L[j,j], S_ij)  for all i > j  (ONE batched launch)

On a walk that runs on kernels (a CUDA float32 or bfloat16 gram whose
plan uses kernels, or no plan) the Σ terms of block column j are ONE
``ops.gemm_tn`` launch instead (:func:`_tn`): the diagonal's and the
panel's rows stacked, each output one ``fmaf`` chain over the stacked
``(k, b)`` axis in ascending order, the subtraction rounded once. That
order depends on neither the batch index nor the batch size, so a batched
walk equals its entries' own walks bitwise (``repro_torch.serve``);
cuBLAS, which the einsums reach, picks its kernel from the batch. The
launch's operand is a view of one float32 buffer that holds ``Lᵀ``'s
strict upper block triangle: each finished panel ``L[i,k]`` is written
there transposed, once, when its ``trsm`` made it, so no step copies the
panels again (an ``(n, n)``-sized scratch of the walk; the factor stays
packed). On the CPU and in float64 the einsums stay, as in the reference.

Base engines follow the plan, as in the reference: with
``plan.use_kernels`` (and with no plan) ``ops.potrf``/``ops.trsm``, which
launch the CUDA kernels for CUDA tensors and run their plain versions for
CPU tensors; a plan without kernels takes the plain versions. A float64
gram takes the plain versions on every device. The panel solve passes
``L[j,j]`` expanded over the panel (batch stride 0), so the factor is not
copied per row block.

The pad rows/cols of the grid (``nb·bn > n``) are masked to the identity in
the trailing diagonal block before its ``potrf``, so the factor is the
identity there and zero-padded right-hand sides solve to zeros.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.backend import device_table, resolve_device
from repro_torch.core.symmetric import (
    SymmetricMatrix,
    default_block_size,
    diag_block_indices,
    sym_tile,
    tri_block_indices,
    tri_index,
)

__all__ = ["CholeskyFactor", "cholesky", "base_solver_fns"]


class CholeskyFactor:
    """Lower-triangular Cholesky factor in packed block storage: the
    geometry of :class:`SymmetricMatrix`, with lower-triangular diagonal
    tiles (strict upper half zero) and no mirror anywhere."""

    __slots__ = ("blocks", "n", "bn")

    def __init__(self, blocks, n: int, bn: int):
        self.blocks = blocks
        self.n = int(n)
        self.bn = int(bn)

    @property
    def nb(self) -> int:
        return -(-self.n // self.bn)

    @property
    def t_total(self) -> int:
        return self.nb * (self.nb + 1) // 2

    @property
    def shape(self):
        return tuple(self.blocks.shape[:-3]) + (self.n, self.n)

    @property
    def dtype(self):
        return self.blocks.dtype

    @property
    def nbytes(self) -> int:
        return self.blocks.numel() * self.blocks.element_size()

    @classmethod
    def identity(cls, n: int, bn: int, batch=(), dtype=torch.float32, device=None):
        """The identity factor (L = I)."""
        bn = default_block_size(n, bn)
        nb = -(-n // bn)
        t = nb * (nb + 1) // 2
        base = np.zeros((t, bn, bn), np.float32)
        base[diag_block_indices(nb)] = np.eye(bn, dtype=np.float32)
        blocks = torch.as_tensor(base, dtype=dtype, device=resolve_device(device))
        return cls(blocks.expand(*batch, t, bn, bn).clone(), n, bn)

    def block(self, i: int, j: int):
        """The ``(..., bn, bn)`` factor tile at block position ``(i, j)``."""
        if j > i:
            raise ValueError(f"block ({i}, {j}) lies in the upper triangle")
        return self.blocks[..., i * (i + 1) // 2 + j, :, :]

    def to_dense(self):
        """Dense lower-triangular ``(..., n, n)`` L (conversion boundary)."""
        nb, bn, n = self.nb, self.bn, self.n
        i_idx, j_idx = tri_index(nb, self.blocks.device)
        batch = self.blocks.shape[:-3]
        z = self.blocks.new_zeros((*batch, nb, nb, bn, bn))
        z[..., i_idx, j_idx, :, :] = self.blocks
        return z.transpose(-3, -2).reshape(*batch, nb * bn, nb * bn)[..., :n, :n]

    def __repr__(self):
        return (f"CholeskyFactor(n={self.n}, bn={self.bn}, "
                f"blocks={tuple(self.blocks.shape)}, dtype={self.blocks.dtype})")


def _acc(x):
    """``x`` in its accumulation dtype (at least float32): the reference
    pins the Schur einsums' accumulator with preferred_element_type."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _kernel_walk(x, plan) -> bool:
    """Whether a walk over ``x`` (a block tensor) runs its Schur products
    on ``ops.gemm_tn``: a CUDA float32 or bfloat16 tensor under a plan that
    uses kernels, or no plan."""
    return (x.is_cuda and x.dtype in (torch.float32, torch.bfloat16)
            and (plan is None or plan.use_kernels))


def _tn(x, y):
    """``XᵀY`` of stacks ``(..., K, p)`` and ``(..., K, q)`` in float32, as
    ONE ``ops.gemm_tn`` launch: each output one ``fmaf`` chain over the K
    rows in ascending order, whatever the batch. Leading dims broadcast and
    ride the kernel's batch."""
    from repro_torch.kernels import ops

    lead = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
    x, y = (_acc(t).expand(*lead, *t.shape[-2:]) for t in (x, y))
    return _flat_call(lambda xf, yf: ops.gemm_tn(xf, yf, out_dtype=torch.float32), x, y)


def _flat_call(fn: Callable, *ops_):
    """Call a base kernel with all leading dims flattened into the one
    leading batch dim of the kernels (2-D operands pass through)."""
    lead = ops_[0].shape[:-2]
    if not lead:
        return fn(*ops_)
    flat = [o.reshape(-1, *o.shape[-2:]) for o in ops_]
    out = fn(*flat)
    return out.reshape(*lead, *out.shape[-2:])


def base_solver_fns(plan=None, dtype=torch.float32):
    """(base_potrf, base_trsm) of the walk for a gram of ``dtype``, storing
    its accumulation dtype (float32, or float64 for float64): the plan's
    engine (``tune.apply.engine``: the ``ops`` wrappers with
    ``use_kernels``, else the plain versions) or, with no plan,
    :func:`repro_torch.kernels.ops.bases` — the kernels on CUDA tensors and
    the plain versions on CPU ones. float64 takes the plain versions
    either way."""
    from repro_torch.tune.apply import engine

    acc = torch.promote_types(dtype, torch.float32)
    eng = engine(plan, acc)
    return (functools.partial(eng.potrf, out_dtype=acc),
            functools.partial(eng.trsm, transpose=True, out_dtype=acc))


def _pad_identity_mask(n: int, nb: int, bn: int, like):
    """(valid, eye_pad) masks for the trailing diagonal block, kept on
    ``like``'s device (``backend.device_table``)."""
    d = n - (nb - 1) * bn

    def valid():
        v = np.zeros((bn, bn), np.float32)
        v[:d, :d] = 1.0
        return torch.as_tensor(v, dtype=like.dtype)

    def eye_pad():
        e = np.zeros((bn, bn), np.float32)
        e[range(d, bn), range(d, bn)] = 1.0
        return torch.as_tensor(e, dtype=like.dtype)

    key = (n, nb, bn, str(like.dtype))
    return (device_table(("pad_valid", *key), like.device, valid),
            device_table(("pad_eye", *key), like.device, eye_pad))


def cholesky(
    a: Union[SymmetricMatrix, torch.Tensor],
    *,
    ridge: float = 0.0,
    plan=None,
    packed_block: Optional[int] = None,
    base_potrf: Optional[Callable] = None,
    base_trsm: Optional[Callable] = None,
) -> CholeskyFactor:
    """Packed blocked Cholesky ``A = L·Lᵀ`` on the block grid.

    ``a``: SPD :class:`SymmetricMatrix` (any leading batch dims), or a dense
    ``(..., n, n)`` square packed first with ``packed_block`` (else the
    plan's, else 128) — the walk is the same, so both factor
    bitwise-identically. ``ridge`` adds ``ridge·I`` on the logical diagonal
    first. ``plan`` (a ``repro_torch.tune.Plan``) supplies that block size
    and the base engines (:func:`base_solver_fns`). ``base_potrf`` and
    ``base_trsm`` (``X·Lᵀ = P``) must take one leading batch dim.
    """
    if not isinstance(a, SymmetricMatrix):
        if packed_block is None and plan is not None:
            packed_block = plan.packed_block
        if packed_block is None:
            from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

            packed_block = DEFAULT_PACKED_BLOCK
        a = SymmetricMatrix.from_dense(a, packed_block)
    if ridge:
        a = a.add_scaled_identity(ridge)
    if base_potrf is None and base_trsm is None:
        base_potrf, base_trsm = base_solver_fns(plan, a.dtype)
    elif base_potrf is None or base_trsm is None:
        raise ValueError("pass both base_potrf and base_trsm, or neither")

    nb, bn, n = a.nb, a.bn, a.n
    pad = nb * bn - n
    i_idx, j_idx = tri_block_indices(nb)
    kernels = _kernel_walk(a.blocks, plan)
    lead = tuple(a.blocks.shape[:-3])
    out = {}
    if kernels and nb > 1:
        # row block k, column block i - 1: L[i,k]ᵀ (i > k)
        lt = a.blocks.new_empty((*lead, (nb - 1) * bn, (nb - 1) * bn), dtype=torch.float32)
    for j in range(nb):
        s = a.block(j, j)
        rows = range(j + 1, nb)
        p = torch.movedim(a.col_panel(j), -3, 0) if rows else None
        if j and kernels:
            # rows (k, b), columns (i, a): L[i,k]ᵀ for i ≥ j, k < j
            z = lt[..., :j * bn, (j - 1) * bn:]
            schur = _tn(z, z[..., :bn])                        # (..., (nb-j)·bn, bn)
            s = s - schur[..., :bn, :]
            if rows:
                p = p - torch.movedim(schur[..., bn:, :].reshape(*lead, len(rows), bn, bn),
                                      -3, 0)
        elif j:
            lrow = torch.stack([out[(j, k)] for k in range(j)], dim=0)
            s = s - torch.einsum("k...ab,k...cb->...ac", _acc(lrow), _acc(lrow))
            if rows:
                li = torch.stack([torch.stack([out[(i, k)] for k in range(j)], 0)
                                  for i in rows], 0)
                p = p - torch.einsum("rk...ab,k...cb->r...ac", _acc(li), _acc(lrow))
        # the lower half of a packed diagonal tile is authoritative; mirror it
        s = sym_tile(s)
        if pad and j == nb - 1:
            valid, eye_pad = _pad_identity_mask(n, nb, bn, s)
            s = s * valid + eye_pad
        out[(j, j)] = _flat_call(base_potrf, s.contiguous())
        if not rows:
            continue
        ljj = out[(j, j)].expand(p.shape)
        panel = _flat_call(base_trsm, ljj, p.contiguous())
        for r, i in enumerate(rows):
            out[(i, j)] = panel[r]
        if kernels:
            # (R, ..., a, b) -> (..., b, R, a): each tile transposed, once
            lt[..., j * bn:(j + 1) * bn, j * bn:].unflatten(-1, (len(rows), bn)).copy_(
                torch.movedim(panel, 0, -3).movedim(-1, -3))

    blocks = torch.stack([out[(int(i_idx[t]), int(j_idx[t]))] for t in range(a.t_total)],
                         dim=-3)
    return CholeskyFactor(blocks, n, bn)
