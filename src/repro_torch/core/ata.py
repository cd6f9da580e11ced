"""ATA — Strassen-based ``C = alpha·AᵀA`` (port of ``repro.core.ata``).

The paper's Algorithm 1, for ``A`` split into 2×2 quadrants:

    C11 = A11ᵀA11 + A21ᵀA21      (recursive ATA)
    C22 = A12ᵀA12 + A22ᵀA22      (recursive ATA)
    C21 = A12ᵀA11 + A22ᵀA21      (rectangular TN Strassen)
    C12 = C21ᵀ                   (never computed)

organized as a *slab sum*: each node computes ``Σ_k A_kᵀA_k`` over a list
of row slabs for one column range and returns a ``(c11, c21, c22)``
:class:`_TriNode`, so the lower triangle is assembled once at the root —
straight into packed storage for ``out='packed'``, or mirrored once into a
dense square for ``out='dense'``.

Leaf dispatch: ``'unrolled'`` calls the bases once per leaf (``4^L``
diagonal syrks and ``Σ_ℓ 2^{2ℓ-1}·7^{L-ℓ}`` Strassen leaves);
``'batched'`` runs the same tree level-synchronously — all diagonal leaves
as ONE ``base_syrk`` call and every Strassen leaf as ONE ``base_dot`` call —
and decodes into the identical node tree. ``'fused'`` keeps that decode but
builds no operand stack: with the default bases, one ``ops.gemm_tn_fused``
launch per ATA level reads the root-padded input through per-leaf slot
tables, and one ``ops.syrk_gather`` launch computes every diagonal leaf;
with caller bases, each leaf operand is combined from slices of the input
and each leaf is one base call. Classical variant only.

Tunables come from a plan or, pinned, from the static defaults
(``core.strassen.resolve_tunables``). The bases default to the plan's
engine: ``ops.syrk``/``ops.gemm_tn`` — the CUDA kernels for a CUDA input,
their plain versions for a CPU input — where the plan uses kernels (and
always when pinned), the plain versions where it does not. With a
float64 input or ``acc_dtype`` they are the plain versions on every
device, and the fused dispatch gathers instead of launching, as the
reference's kernel-free defaults do. The root assembly writes into its output buffer in place.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from repro_torch.core.strassen import (
    DEFAULT_N_BASE,
    _block_getter,
    _combine_slots,
    _encode_fns,
    _leaf_dot,
    _pad_root,
    _rec_strassen,
    _rec_winograd,
    _slot_tables,
    _to_blocks,
    _unblock,
    resolve_tunables,
    tree_depth,
)
from repro_torch.core.symmetric import (
    SymmetricMatrix,
    default_block_size,
    sym_tile,
    write_packed_region,
)
from repro_torch import obs
from repro_torch.backend import planner_key
from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

__all__ = ["ata", "ata_batched", "DEFAULT_N_BASE", "DEFAULT_PACKED_BLOCK"]


class _TriNode(NamedTuple):
    """One level of the symmetric product: C = [[c11, ·], [c21, c22]]."""

    c11: object
    c21: torch.Tensor
    c22: object


def _rec_ata(slabs, n_base, base_syrk, strassen_rec, base_dot, acc_dtype):
    """``Σ_k slab_kᵀ·slab_k`` for one column range, as a _TriNode tree."""
    n = slabs[0].shape[-1]
    m_max = max(s.shape[-2] for s in slabs)
    if n <= n_base or m_max <= n_base:
        with obs.span("ata.rec.base", n=n, slabs=len(slabs)):
            out = base_syrk(slabs[0])
            for s in slabs[1:]:
                out = out + base_syrk(s)
            return out

    halves = []
    for s in slabs:
        m1 = s.shape[-2] // 2
        if m1:
            halves.append(s[..., :m1, :])
        halves.append(s[..., m1:, :])
    n1 = n // 2
    left = [h[..., :n1] for h in halves]
    right = [h[..., n1:] for h in halves]

    rec = functools.partial(_rec_ata, n_base=n_base, base_syrk=base_syrk,
                            strassen_rec=strassen_rec, base_dot=base_dot,
                            acc_dtype=acc_dtype)
    st = functools.partial(strassen_rec, n_base=n_base, base_dot=base_dot,
                           acc_dtype=acc_dtype)
    with obs.span(f"ata.rec.n{n}", slabs=len(slabs)):
        c11 = rec(left)
        c22 = rec(right)
        c21 = st(right[0], left[0])
        for r, l in zip(right[1:], left[1:]):
            c21 = c21 + st(r, l)
        return _TriNode(c11, c21, c22)


# ---------------------------------------------------------------------------
# level-synchronous batched-leaf formulation of the same tree
# ---------------------------------------------------------------------------


def _accum_axis1(x):
    """Left-to-right sum over axis 1 — the unrolled slab loop's add order."""
    acc = x[:, 0]
    for r in range(1, x.shape[1]):
        acc = acc + x[:, r]
    return acc


@functools.lru_cache(maxsize=None)
def _level_tables(L, lev):
    """Slot tables of ATA level ``lev`` in root-grid coordinates.

    One row per (slab parent ``p``, Strassen leaf ``t``), parent-major like
    the encode stacks (``p·7^{L-ℓ} + t``): the level's ``_slot_tables(L-ℓ)``
    shifted to parent ``p``'s block rows and its right (A side) or left (B
    side) block columns of the ``2^L × 2^L`` root grid. Handing these to
    ``ops.gemm_tn_fused`` with the root grid is the reference's per-level
    call on that level's block grids, without building the grids.
    """
    R, Rl, H = 1 << L, 1 << lev, 1 << (lev - 1)
    q = R // Rl
    (ar, ac, asg), (br, bc, bsg) = _slot_tables(L - lev)
    h, rb = np.divmod(np.arange(H * Rl), Rl)
    shift_r = (rb * q)[:, None, None]

    def side(rows, cols, sgn, which):
        shift_c = ((2 * h + which) * q)[:, None, None]
        T, W = rows.shape
        flat = lambda x: x.reshape(H * Rl * T, W).astype(np.int32)
        return (flat(rows[None] + shift_r), flat(cols[None] + shift_c),
                flat(np.broadcast_to(sgn[None], (H * Rl, T, W))))

    return side(ar, ac, asg, 1), side(br, bc, bsg, 0)


def _combine_level(a, L, lev):
    """Fused leaf operands of ATA level ``lev`` as sums of slices of ``a``,
    one (A, B) pair per row of :func:`_level_tables`; every slot block is a
    view of the root-padded input, so no operand stack is materialized."""
    get = _block_getter(a, L)
    sides = []
    for rows, cols, sgn in _level_tables(L, lev):
        sides.append([_combine_slots(get, r, c, g) for r, c, g in zip(rows, cols, sgn)])
    return sides


def _ata_level_sync(a, L, *, variant, base_syrk, base_dot, fused=False, kernels=None):
    """The whole ATA tree level-synchronously: every off-diagonal Strassen
    leaf, all ``4^L`` diagonal leaves, decoded into the same _TriNode tree.
    ``a`` arrives root-padded (both dims divisible by ``2^L``).

    * batched (``fused=False``): every Strassen leaf in ONE ``base_dot``
      call on encoded operand stacks, the diagonal in ONE ``base_syrk``;
    * fused with ``kernels = (fused_dot, gather_syrk)``: one ``fused_dot``
      launch per level and one ``gather_syrk`` launch, both reading views of
      ``a`` through slot and gather tables;
    * fused without kernels: one ``base_dot`` per leaf on operands combined
      from slices of ``a``; the diagonal as in the batched path.
    """
    if L == 0:
        return base_syrk(a)
    batch = tuple(a.shape[:-2])
    enc, dec = _encode_fns(variant)
    R = 1 << L
    ab = _to_blocks(a, L)           # (R, R, *batch, mL, nL): a view of a
    mL, nL = ab.shape[-2:]

    parts_a, parts_b, sizes, P_levels = [], [], [], []
    for lev in range(1, L + 1):
        with obs.span(f"ata.encode.L{lev}", fused=fused):
            if fused and kernels is not None:
                tables = _level_tables(L, lev)
                with obs.span(f"ata.fused_dot.L{lev}", leaves=tables[0][0].shape[0]):
                    P_levels.append(kernels[0](ab[None], ab[None], tables))
                continue
            if fused:
                la, lb = _combine_level(a, L, lev)
                P_levels.append(torch.stack([base_dot(x, y) for x, y in zip(la, lb)]))
                continue
            Rl, H = 1 << lev, 1 << (lev - 1)
            q = R // Rl
            g = ab.reshape(Rl, q, H, 2, q, *batch, mL, nL)
            right = torch.movedim(g[:, :, :, 1], 2, 0)   # (H, Rl, q, q, ...)
            left = torch.movedim(g[:, :, :, 0], 2, 0)
            A = right.reshape(H * Rl, q, q, *batch, mL, nL)
            B = left.reshape(H * Rl, q, q, *batch, mL, nL)
            for _ in range(L - lev):
                A, B = enc(A, B)
            parts_a.append(A[:, 0, 0])
            parts_b.append(B[:, 0, 0])
            sizes.append(A.shape[0])
    if not fused:
        with obs.span("ata.leaf_dot", leaves=sum(sizes)):
            P = _leaf_dot(base_dot, torch.cat(parts_a, 0), torch.cat(parts_b, 0))
        P_levels = list(torch.split(P, sizes, dim=0))

    # diagonal leaves ordered (column block i, slab r)
    with obs.span("ata.syrk_batch", leaves=R * R, fused=fused):
        if fused and kernels is not None:
            s = np.arange(R * R)
            Dp = kernels[1](ab, s % R, s // R)
        else:
            D = ab.transpose(0, 1).reshape(R * R, *batch, mL, nL)
            Dp = base_syrk(D.reshape(-1, mL, nL))
    Dp = Dp.reshape(R, R, *batch, *Dp.shape[-2:])
    diag = _accum_axis1(Dp)  # (2^L, *batch, nL, nL)

    c21 = {}
    for lev, p in zip(range(1, L + 1), P_levels):
        with obs.span(f"ata.decode.L{lev}"):
            p = p[:, None, None]
            for _ in range(L - lev):
                p = dec(p)
            Rl, Hl = 1 << lev, 1 << (lev - 1)
            q = R // Rl
            p = _accum_axis1(p.reshape(Hl, Rl, q, q, *p.shape[3:]))
            c21[lev] = _unblock(p)      # (H, *batch, N/2^ℓ, N/2^ℓ)

    def build(lev, idx):
        if lev == L:
            return diag[idx]
        return _TriNode(build(lev + 1, 2 * idx), c21[lev + 1][idx], build(lev + 1, 2 * idx + 1))

    return build(0, 0)


# ---------------------------------------------------------------------------
# root assembly (crop-aware: the node tree covers the padded N ≥ n)
# ---------------------------------------------------------------------------


def _first_leaf(node):
    while isinstance(node, _TriNode):
        node = node.c11
    return node


def _assemble_lower(node, buf, off, lim):
    """Write the lower-triangular content of ``node`` into ``buf`` at
    diagonal offset ``off``, clipped to ``lim``, each piece once."""
    if not isinstance(node, _TriNode):
        h = min(node.shape[-1], lim - off)
        if h > 0:
            buf[..., off:off + h, off:off + h] = node[..., :h, :h]
        return buf
    n1 = node.c21.shape[-1]
    m2 = node.c21.shape[-2]
    _assemble_lower(node.c11, buf, off, lim)
    r0 = off + n1
    h, w = min(m2, lim - r0), min(n1, lim - off)
    if h > 0 and w > 0:
        buf[..., r0:r0 + h, off:off + w] = node.c21[..., :h, :w]
    return _assemble_lower(node.c22, buf, off + n1, lim)


def _finalize_dense(node, n):
    if not isinstance(node, _TriNode):
        return node  # single base tile: already full and bitwise symmetric
    leaf = _first_leaf(node)
    buf = leaf.new_zeros((*leaf.shape[:-2], n, n))
    return sym_tile(_assemble_lower(node, buf, 0, n))


def _assemble_packed(node, buf, off, bn, lim):
    if not isinstance(node, _TriNode):
        h = min(node.shape[-1], lim - off)
        if h > 0:
            write_packed_region(buf, node[..., :h, :h], off, off, bn)
        return buf
    n1 = node.c21.shape[-1]
    m2 = node.c21.shape[-2]
    _assemble_packed(node.c11, buf, off, bn, lim)
    r0 = off + n1
    h, w = min(m2, lim - r0), min(n1, lim - off)
    if h > 0 and w > 0:
        write_packed_region(buf, node.c21[..., :h, :w], r0, off, bn)
    return _assemble_packed(node.c22, buf, off + n1, bn, lim)


def _finalize_packed(node, n, packed_block):
    """Pack the node tree directly; the dense square is never formed."""
    bn = default_block_size(n, packed_block)
    nb = -(-n // bn)
    leaf = _first_leaf(node)
    buf = leaf.new_zeros((*leaf.shape[:-2], nb * (nb + 1) // 2, bn, bn))
    return SymmetricMatrix(_assemble_packed(node, buf, 0, bn, nb * bn), n, bn)


def _ata_impl(a, *, alpha, c, beta, plan, n_base, variant, leaf_dispatch, base_syrk,
              base_dot, acc_dtype, out, packed_block):
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")
    backend, dtype = planner_key(a)
    plan, n_base, variant, packed_block, leaf_dispatch = resolve_tunables(
        plan, n_base, variant, packed_block, op="ata", m=a.shape[-2], n=a.shape[-1],
        batch=a.shape[0] if a.ndim > 2 else 0, dtype=dtype, out=out,
        leaf_dispatch=leaf_dispatch, backend=backend)
    from repro_torch.tune.apply import engine

    eng = engine(plan, a.dtype, acc_dtype)
    kernels = None
    if (leaf_dispatch == "fused" and base_syrk is None and base_dot is None
            and eng.gemm_tn_fused is not None):
        kernels = (functools.partial(eng.gemm_tn_fused, out_dtype=acc_dtype),
                   functools.partial(eng.syrk_gather, out_dtype=acc_dtype))
    if base_syrk is None:   # dense mode: a full, bitwise-symmetric tile
        base_syrk = functools.partial(eng.syrk, out_dtype=acc_dtype)
    if base_dot is None:
        base_dot = functools.partial(eng.gemm_tn, out_dtype=acc_dtype)

    n = a.shape[-1]
    L = tree_depth(a.shape[-2:], n_base)
    obs.metrics.inc(f"dispatch.ata.{leaf_dispatch}")
    # leaf accounting, the same under the three dispatches (the tree is a
    # function of L only): 4^L diagonal syrk leaves, Σ_ℓ 2^{2ℓ-1}·7^{L-ℓ}
    # off-diagonal Strassen leaves
    obs.metrics.inc("ata.leaves.syrk", 4 ** L)
    obs.metrics.inc("ata.leaves.strassen",
                    sum(2 ** (2 * lev - 1) * 7 ** (L - lev) for lev in range(1, L + 1)))
    t0 = obs.dispatch_start(plan, a)
    with obs.span("ata", m=a.shape[-2], n=n, levels=L, leaf_dispatch=leaf_dispatch):
        ap = _pad_root(a, L) if L else a
        if leaf_dispatch in ("batched", "fused"):
            node = _ata_level_sync(ap, L, variant=variant, base_syrk=base_syrk,
                                   base_dot=base_dot, fused=leaf_dispatch == "fused",
                                   kernels=kernels)
        else:
            strassen_rec = _rec_strassen if variant == "strassen" else _rec_winograd
            node = _rec_ata([ap], n_base=n_base, base_syrk=base_syrk,
                            strassen_rec=strassen_rec, base_dot=base_dot,
                            acc_dtype=acc_dtype)

        if out == "packed":
            result = _finalize_packed(node, n, packed_block)
            if alpha != 1.0:
                result = result.scale(alpha)
            if c is not None:
                if not isinstance(c, SymmetricMatrix):
                    raise TypeError(
                        "ata(..., out='packed') accumulates only into a "
                        f"SymmetricMatrix c, got {type(c).__name__}"
                    )
                result = result.add(c.scale(beta) if beta != 1.0 else c)
            return obs.dispatch_finish(plan, t0, result)

        result = _finalize_dense(node, n)
        if alpha != 1.0:
            result = alpha * result
        if c is not None:
            if isinstance(c, SymmetricMatrix):
                c = c.to_dense()
            result = result + (beta * c if beta != 1.0 else c)
        return obs.dispatch_finish(plan, t0, result)


def ata(
    a: torch.Tensor,
    *,
    alpha: float = 1.0,
    c: Optional[Union[torch.Tensor, SymmetricMatrix]] = None,
    beta: float = 1.0,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    base_syrk: Optional[Callable] = None,
    base_dot: Optional[Callable] = None,
    acc_dtype=torch.float32,
    out: str = "dense",
    packed_block: Optional[int] = None,
) -> Union[torch.Tensor, SymmetricMatrix]:
    """``C = alpha·AᵀA (+ beta·C)`` via the paper's ATA algorithm.

    ``a``: ``(m, n)``, any rectangular shape. ``out='dense'`` → ``(n, n)``
    bitwise symmetric; ``out='packed'`` → :class:`SymmetricMatrix` on the
    ``default_block_size(n, packed_block)`` grid (then ``c`` must be a
    SymmetricMatrix of the same layout). ``plan``: a frozen
    ``repro_torch.tune.Plan`` carrying every tunable. With no plan and
    neither ``n_base`` nor ``variant`` pinned, the call is planned by
    ``repro_torch.tune.plan`` for ``a``'s device and dtype (``out`` does
    not change the recursion, so packed stays bitwise equal to dense);
    pinning either takes the static defaults for the rest (``n_base=512``,
    ``variant='strassen'``, ``leaf_dispatch='unrolled'``,
    ``packed_block=128``). ``leaf_dispatch`` or ``packed_block`` alone does
    not bypass the planner. ``base_syrk(a) -> aᵀa`` (full,
    bitwise-symmetric tile) and ``base_dot(a, b) -> aᵀb`` must accept one
    leading batch dim; by default they are the plan's engine.
    ``leaf_dispatch='fused'`` with neither base given runs
    ``ops.gemm_tn_fused`` once per level and ``ops.syrk_gather`` once
    where the engine has them.
    """
    if a.ndim != 2:
        raise ValueError(f"ata expects a 2-D operand, got shape {tuple(a.shape)}")
    return _ata_impl(a, alpha=alpha, c=c, beta=beta, plan=plan, n_base=n_base, variant=variant,
                     leaf_dispatch=leaf_dispatch, base_syrk=base_syrk, base_dot=base_dot,
                     acc_dtype=acc_dtype, out=out, packed_block=packed_block)


def ata_batched(
    a: torch.Tensor,
    *,
    alpha: float = 1.0,
    c: Optional[Union[torch.Tensor, SymmetricMatrix]] = None,
    beta: float = 1.0,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    base_syrk: Optional[Callable] = None,
    base_dot: Optional[Callable] = None,
    acc_dtype=torch.float32,
    out: str = "dense",
    packed_block: Optional[int] = None,
) -> Union[torch.Tensor, SymmetricMatrix]:
    """Batched ``C_b = alpha·A_bᵀA_b`` for ``a: (B, m, n)``: the batch dim
    rides through the recursion, so every base call covers the whole batch
    (with ``'batched'`` leaves, leaf stack × batch is one launch)."""
    if a.ndim != 3:
        raise ValueError(f"ata_batched expects a (B, m, n) operand, got {tuple(a.shape)}")
    return _ata_impl(a, alpha=alpha, c=c, beta=beta, plan=plan, n_base=n_base, variant=variant,
                     leaf_dispatch=leaf_dispatch, base_syrk=base_syrk, base_dot=base_dot,
                     acc_dtype=acc_dtype, out=out, packed_block=packed_block)
