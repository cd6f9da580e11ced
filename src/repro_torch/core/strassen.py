"""Rectangular TN Strassen ``C = alpha·AᵀB`` (port of ``repro.core.strassen``).

The paper's FastStrassen with the TN form kept all the way down: with
``X = Aᵀ`` split into quadrants, each of the seven products is again a TN
product of combinations of ``A`` blocks in their own orientation, so ``Aᵀ``
is never formed. Odd sizes take one root pad to multiples of ``2^L`` and
one crop; interior levels split exactly in half.

Leaf dispatch:

* ``'unrolled'`` — the recursion calls ``base_dot`` once per leaf.
* ``'batched'`` — level-synchronous: the operands are transposed once into
  the leaf-block-major layout (``_to_blocks``), each level *encodes* the
  seven ±1 combinations into a stack with a leading leaf axis, all ``7^L``
  leaves run as ONE batched ``base_dot``, and each level *decodes* back.
  The same elementwise adds run on the same values, so with a base whose
  per-output summation order does not depend on the batch (the CUDA
  kernel's) the two dispatches agree bitwise.
* ``'fused'`` — no operand stack at all: per-leaf ±1 slot tables
  (:func:`_slot_tables`) say which root blocks each leaf operand sums, and
  with no caller ``base_dot`` ONE ``ops.gemm_tn_fused`` launch gathers and
  combines them inside the kernel and runs every leaf product. With a
  caller ``base_dot`` the combinations are built per leaf as slices of the
  root-padded operand (:func:`_combine_slots`) and each leaf is one
  ``base_dot`` call. The decode is the batched dispatch's. Classical
  variant only.

Tunables come from a plan (``plan=``, or the ``repro_torch.tune.plan``
front door when no algorithm tunable is pinned) or, pinned, from the
static defaults (:func:`resolve_tunables`). The base is the plan's engine:
:func:`repro_torch.kernels.ops.gemm_tn`, which runs the CUDA kernel on a
CUDA tensor and the plain matmul on a CPU tensor, where the plan uses
kernels (and always when pinned); the plain matmul where it does not. With
a float64 operand or ``acc_dtype`` it is the plain matmul on every device
(no kernel takes float64), and the fused dispatch gathers instead of
launching — the reference's kernel-free default.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.backend import planner_key
from repro_torch.kernels.gemm_tn import gemm_tn_plain
from repro_torch.tune import defaults as _defaults
from repro_torch.tune.defaults import DEFAULT_N_BASE

__all__ = ["strassen_tn", "DEFAULT_N_BASE", "resolve_tunables", "tree_depth"]


def resolve_tunables(
    plan,
    n_base,
    variant,
    packed_block,
    *,
    op: str,
    m: int,
    n: int,
    k: Optional[int] = None,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    leaf_dispatch: Optional[str] = None,
    backend: Optional[str] = None,
):
    """Fill unset tunables (shared by ``strassen_tn`` and ``ata``). Three
    regimes, in order, as in the reference:

    * a ``plan`` was handed in → unset arguments come from it;
    * no algorithm tunable (``n_base``/``variant``) was pinned → the
      ``repro_torch.tune.plan`` front door (memo, cache file or analytic
      model) for the operand's ``backend`` and ``dtype``. Pinning
      ``packed_block`` or ``leaf_dispatch`` alone does not bypass it: they
      are layout and scheduling, not algorithm, and ``leaf_dispatch``
      never changes values;
    * an algorithm tunable was pinned → the static defaults fill the rest,
      without the planner, so explicit calls stay bitwise reproducible
      whatever the cache holds.

    Returns ``(plan_or_None, n_base, variant, packed_block,
    leaf_dispatch)``; a plan with ``algorithm='dense'`` comes back with an
    ``n_base`` covering the whole operand, which is how one classical
    product is expressed to the recursion.
    """
    if plan is None and n_base is None and variant is None:
        from repro_torch.tune import plan as _plan_fn

        plan = _plan_fn(op=op, m=m, n=n, k=k, batch=batch, dtype=dtype, out=out,
                        backend=backend)
    if plan is not None:
        n_base = plan.n_base if n_base is None else n_base
        variant = plan.variant if variant is None else variant
        packed_block = plan.packed_block if packed_block is None else packed_block
        leaf_dispatch = plan.leaf_dispatch if leaf_dispatch is None else leaf_dispatch
        if plan.algorithm == "dense":
            n_base = max(n_base, m, n, k or n)
    else:
        n_base = _defaults.DEFAULT_N_BASE if n_base is None else n_base
        variant = _defaults.DEFAULT_VARIANT if variant is None else variant
        packed_block = _defaults.DEFAULT_PACKED_BLOCK if packed_block is None else packed_block
    leaf_dispatch = _defaults.DEFAULT_LEAF_DISPATCH if leaf_dispatch is None else leaf_dispatch
    if leaf_dispatch not in ("unrolled", "batched", "fused"):
        raise ValueError(
            f"unknown leaf_dispatch {leaf_dispatch!r}; use 'unrolled', 'batched' or 'fused'"
        )
    if variant not in ("strassen", "winograd"):
        raise ValueError(f"unknown variant {variant!r}")
    if leaf_dispatch == "fused" and variant != "strassen":
        raise ValueError(
            "leaf_dispatch='fused' supports variant='strassen' only: "
            "Winograd's chained within-level combinations do not fit the "
            "per-leaf ±1 slot tables"
        )
    return plan, n_base, variant, packed_block, leaf_dispatch


def _dot_tn(a, b, acc_dtype):
    """Plain ``AᵀB`` over the last two dims (leading dims are batch), with
    an ``acc_dtype`` accumulator, ``Aᵀ`` never formed.

    On a CUDA device, float32 or bfloat16 operands of at most
    ``UNSPLIT_MAX_ROWS`` rows go to ``ops.gemm_tn``, which launches the
    narrow-output kernel (``csrc/tn_narrow.cu``) for ``B`` of at most 64
    columns and the tile engine (``csrc/tn_tile.cuh``) above: both sum each
    output as one ``fmaf`` chain over ascending rows, and each column of
    ``B`` on its own, so zero rows and zero columns leave every other
    output's bits as they were, whichever kernel a padded shape lands on. The serving layer bands ``m`` and
    ``r`` on that (``repro_torch.serve.bucketing``). Above it, or in
    float64, ``torch.matmul``: cuBLAS picks its split of the contraction
    from the shape, and a serving bucket keeps ``m`` and ``r`` exact there.

    On the CPU a one-column ``B`` is the first column of a two-column
    product: MKL sums a matrix-vector product in another order than a
    matrix product, so a vector right-hand side would otherwise round
    differently from the same column inside a wider ``B``."""
    if a.is_cuda:
        from repro_torch.kernels import ops
        from repro_torch.kernels.syrk import UNSPLIT_MAX_ROWS

        if a.shape[-2] <= UNSPLIT_MAX_ROWS and torch.float64 not in (a.dtype, b.dtype, acc_dtype):
            return ops.gemm_tn(a, b, out_dtype=acc_dtype)
        return gemm_tn_plain(a, b, out_dtype=acc_dtype)
    if b.shape[-1] == 1:
        return gemm_tn_plain(a, F.pad(b, (0, 1)), out_dtype=acc_dtype)[..., :1]
    return gemm_tn_plain(a, b, out_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# root padding
# ---------------------------------------------------------------------------


def tree_depth(dims, n_base: int) -> int:
    """Levels the recursion performs: smallest ``L`` with
    ``min(⌈d/2^L⌉) ≤ n_base``."""
    L = 0
    while min(-(-d // (1 << L)) for d in dims) > n_base:
        L += 1
    return L


def _pad_root(x, L: int):
    """Zero-pad the last two dims up to multiples of ``2^L``."""
    step = 1 << L
    m, n = x.shape[-2:]
    pm, pn = (-m) % step, (-n) % step
    if pm or pn:
        x = F.pad(x, (0, pn, 0, pm))
    return x


def _quadrants(x):
    m2, n2 = x.shape[-2] // 2, x.shape[-1] // 2
    return x[..., :m2, :n2], x[..., :m2, n2:], x[..., m2:, :n2], x[..., m2:, n2:]


def _block2(c11, c12, c21, c22):
    return torch.cat([torch.cat([c11, c12], -1), torch.cat([c21, c22], -1)], -2)


# ---------------------------------------------------------------------------
# unrolled leaf dispatch: one base_dot per leaf
# ---------------------------------------------------------------------------


def _rec_strassen(a, b, n_base, base_dot, acc_dtype):
    """Classical Strassen recursion on the TN product (7 mults, 18 adds);
    operands arrive root-padded."""
    m, n = a.shape[-2:]
    k = b.shape[-1]
    if min(m, n, k) <= n_base:
        return base_dot(a, b)
    a11, a12, a21, a22 = _quadrants(a)
    b11, b12, b21, b22 = _quadrants(b)
    rec = functools.partial(_rec_strassen, n_base=n_base, base_dot=base_dot,
                            acc_dtype=acc_dtype)
    m1 = rec(a11 + a22, b11 + b22)
    m2 = rec(a12 + a22, b11)
    m3 = rec(a11, b12 - b22)
    m4 = rec(a22, b21 - b11)
    m5 = rec(a11 + a21, b22)
    m6 = rec(a12 - a11, b11 + b12)
    m7 = rec(a21 - a22, b21 + b22)
    # the reference's balanced association (keeps the dispatches bitwise)
    c11 = (m1 + m4) + (m7 - m5)
    c12 = m3 + m5
    c21 = m2 + m4
    c22 = (m1 - m2) + (m3 + m6)
    return _block2(c11, c12, c21, c22)


def _rec_winograd(a, b, n_base, base_dot, acc_dtype):
    """Strassen-Winograd recursion (7 mults, 15 adds)."""
    m, n = a.shape[-2:]
    k = b.shape[-1]
    if min(m, n, k) <= n_base:
        return base_dot(a, b)
    a11, a12, a21, a22 = _quadrants(a)
    b11, b12, b21, b22 = _quadrants(b)
    rec = functools.partial(_rec_winograd, n_base=n_base, base_dot=base_dot,
                            acc_dtype=acc_dtype)
    s1 = a12 + a22
    s2 = s1 - a11
    s3 = a11 - a12
    s4 = a21 - s2
    t1 = b12 - b11
    t2 = b22 - t1
    t3 = b22 - b12
    t4 = t2 - b21
    p1 = rec(a11, b11)
    p2 = rec(a21, b21)
    p3 = rec(s4, b22)
    p4 = rec(a22, t4)
    p5 = rec(s1, t1)
    p6 = rec(s2, t2)
    p7 = rec(s3, t3)
    u2 = p1 + p6
    u3 = u2 + p7
    u4 = u2 + p5
    return _block2(p1 + p2, u4 + p3, u3 - p4, u3 + p5)


# ---------------------------------------------------------------------------
# batched leaf dispatch: level-synchronous encode → one dot → decode
#
# Stack layout (block-major): (S, R, C, *batch, mb, nb) — leaf axis first,
# then the leaf-block grid, then operand batch dims. One encode level turns
# S into 7S (child s·7+t is product t of parent s) and halves R, C.
# ---------------------------------------------------------------------------


def _to_blocks(x, L):
    """(*batch, M, N) → block-major (2^L, 2^L, *batch, M/2^L, N/2^L)."""
    R = 1 << L
    *batch, M, N = x.shape
    nbd = len(batch)
    x = x.reshape(*batch, R, M // R, R, N // R)
    x = torch.movedim(x, nbd, 0)
    return torch.movedim(x, nbd + 2, 1)


def _unblock(x):
    """(S, R, C, *batch, h, w) → (S, *batch, R·h, C·w)."""
    S, R, C = x.shape[:3]
    batch = tuple(x.shape[3:-2])
    h, w = x.shape[-2:]
    nbd = len(batch)
    perm = (0,) + tuple(range(3, 3 + nbd)) + (1, 3 + nbd, 2, 4 + nbd)
    return x.permute(perm).reshape(S, *batch, R * h, C * w)


def _quadrants_b(x):
    m2, n2 = x.shape[1] // 2, x.shape[2] // 2
    return x[:, :m2, :n2], x[:, :m2, n2:], x[:, m2:, :n2], x[:, m2:, n2:]


def _stack7(parts):
    e = torch.stack(parts, dim=1)
    return e.reshape(e.shape[0] * 7, *e.shape[2:])


def _encode_strassen(A, B):
    a11, a12, a21, a22 = _quadrants_b(A)
    b11, b12, b21, b22 = _quadrants_b(B)
    ea = _stack7([a11 + a22, a12 + a22, a11, a22, a11 + a21, a12 - a11, a21 - a22])
    eb = _stack7([b11 + b22, b11, b12 - b22, b21 - b11, b22, b11 + b12, b21 + b22])
    return ea, eb


def _encode_winograd(A, B):
    a11, a12, a21, a22 = _quadrants_b(A)
    b11, b12, b21, b22 = _quadrants_b(B)
    s1 = a12 + a22
    s2 = s1 - a11
    s3 = a11 - a12
    s4 = a21 - s2
    t1 = b12 - b11
    t2 = b22 - t1
    t3 = b22 - b12
    t4 = t2 - b21
    return (_stack7([a11, a21, s4, a22, s1, s2, s3]),
            _stack7([b11, b21, b22, t4, t1, t2, t3]))


def _cat_quads(c11, c12, c21, c22):
    top = torch.cat([c11, c12], dim=2)
    bot = torch.cat([c21, c22], dim=2)
    return torch.cat([top, bot], dim=1)


def _decode_strassen(P):
    """(7S, R, C, ...) products → (S, 2R, 2C, ...)."""
    P = P.reshape(P.shape[0] // 7, 7, *P.shape[1:])
    m1, m2, m3, m4, m5, m6, m7 = (P[:, t] for t in range(7))
    c11 = (m1 + m4) + (m7 - m5)
    c12 = m3 + m5
    c21 = m2 + m4
    c22 = (m1 - m2) + (m3 + m6)
    return _cat_quads(c11, c12, c21, c22)


def _decode_winograd(P):
    P = P.reshape(P.shape[0] // 7, 7, *P.shape[1:])
    p1, p2, p3, p4, p5, p6, p7 = (P[:, t] for t in range(7))
    u2 = p1 + p6
    u3 = u2 + p7
    u4 = u2 + p5
    return _cat_quads(p1 + p2, u4 + p3, u3 - p4, u3 + p5)


def _encode_fns(variant):
    if variant == "strassen":
        return _encode_strassen, _decode_strassen
    return _encode_winograd, _decode_winograd


def _leaf_dot(base_dot, A, B):
    """A whole leaf stack ``(S, *batch, m, n) × (S, *batch, m, k)`` as ONE
    batched base call: flattened to the kernels' one leading dim."""
    S = A.shape[0]
    batch = tuple(A.shape[1:-2])
    out = base_dot(A.reshape(-1, *A.shape[-2:]), B.reshape(-1, *B.shape[-2:]))
    return out.reshape(S, *batch, *out.shape[-2:])


def _strassen_batched(a, b, L, base_dot, variant):
    """Level-synchronous Strassen on root-padded operands."""
    if L == 0:
        return base_dot(a, b)
    enc, dec = _encode_fns(variant)
    A, B = _to_blocks(a, L)[None], _to_blocks(b, L)[None]
    for lev in range(1, L + 1):
        with obs.span(f"strassen.encode.L{lev}"):
            A, B = enc(A, B)
    with obs.span("strassen.leaf_dot", leaves=A.shape[0]):
        P = _leaf_dot(base_dot, A[:, 0, 0], B[:, 0, 0])[:, None, None]
    for lev in range(L, 0, -1):
        with obs.span(f"strassen.decode.L{lev}"):
            P = dec(P)
    return _unblock(P)[0]


# ---------------------------------------------------------------------------
# fused leaf dispatch: per-leaf ±1 slot tables instead of operand stacks
#
# Every classical-Strassen leaf operand is a signed sum of root leaf blocks:
# one level doubles the slot count (the first and second term of each of
# the seven combinations), so a leaf of an L-level tree has W = 2^L slots.
# x − y ≡ x + (−y) and −(x + y) ≡ (−x) + (−y) in IEEE arithmetic, and
# slicing commutes with the elementwise adds, so the slot tree evaluated in
# `_combine_slots`' balanced order gives the recursion's operands bitwise.
# ---------------------------------------------------------------------------

_FUSED_A_COMBOS = ((0, 3, 1), (1, 3, 1), (0, None, 0), (3, None, 0),
                   (0, 2, 1), (1, 0, -1), (2, 3, -1))
_FUSED_B_COMBOS = ((0, 3, 1), (0, None, 0), (1, 3, -1), (2, 0, -1),
                   (3, None, 0), (0, 1, 1), (2, 3, 1))


@functools.lru_cache(maxsize=None)
def _slot_tables(L: int):
    """Per-leaf ±1 coefficient tables of the fused dispatch.

    Returns ``((a_rows, a_cols, a_sgn), (b_rows, b_cols, b_sgn))`` — six
    ``(7**L, 2**L)`` int32 arrays. Row ``s`` describes leaf product ``s``
    (the ``_stack7`` order: the level-1 digit is the most significant
    base-7 digit); sign 0 marks a dead slot.
    """

    def build(combos):
        R = 1 << L
        r, c = np.indices((R, R))
        # (S, rows, cols, slots, {row, col, sign}) — starts as the identity
        slots = np.stack([r, c, np.ones((R, R), np.int64)], axis=-1)
        slots = slots[None, :, :, None, :]
        for _ in range(L):
            S, Rg, Cg, W, _ = slots.shape
            h, w = Rg // 2, Cg // 2
            quad = (slots[:, :h, :w], slots[:, :h, w:],
                    slots[:, h:, :w], slots[:, h:, w:])
            parts = []
            for p, q, sg in combos:
                first = quad[p]
                if q is None:
                    second = np.zeros_like(first)
                else:
                    second = quad[q].copy()
                    second[..., 2] *= sg
                parts.append(np.concatenate([first, second], axis=3))
            slots = np.stack(parts, axis=1).reshape(S * 7, h, w, 2 * W, 3)
        slots = slots[:, 0, 0]
        return (slots[..., 0].astype(np.int32),
                slots[..., 1].astype(np.int32),
                slots[..., 2].astype(np.int32))

    return build(_FUSED_A_COMBOS), build(_FUSED_B_COMBOS)


def _combine_slots(get_block, rows, cols, sgn):
    """One leaf operand from its slot table: the perfect binary add tree of
    the unrolled recursion. ``get_block(r, c)`` fetches root leaf block
    (r, c); dead (sign-0) slots drop out, so exactly the adds the unrolled
    recursion performs on this operand run."""

    def ev(lo, hi):
        if hi - lo == 1:
            s = int(sgn[lo])
            if s == 0:
                return None
            blk = get_block(int(rows[lo]), int(cols[lo]))
            return -blk if s < 0 else blk
        mid = (lo + hi) // 2
        left, right = ev(lo, mid), ev(mid, hi)
        if left is None:
            return right
        if right is None:
            return left
        return left + right

    return ev(0, len(sgn))


def _block_getter(x, L):
    """Leaf-block fetcher in ``_to_blocks`` coordinates, as direct slices
    of the unblocked operand (views, no block-major copy)."""
    mb, nb = x.shape[-2] >> L, x.shape[-1] >> L

    def get(r, c):
        return x[..., r * mb:(r + 1) * mb, c * nb:(c + 1) * nb]

    return get


def _strassen_fused(a, b, L, base_dot, fused_dot=None):
    """Fused-operand Strassen on root-padded operands: slot-table gather
    and combine per leaf, then the batched dispatch's decode.

    With ``fused_dot`` (``ops.gemm_tn_fused``) the gather and combine run
    in ONE kernel launch against ``_to_blocks`` views of the operands;
    otherwise each leaf operand is combined from slices and each leaf is
    one ``base_dot`` call — only the product stack is materialized.
    """
    if L == 0:
        return base_dot(a, b)
    with obs.span("strassen.fused_leaves", leaves=7 ** L, kernel=fused_dot is not None):
        if fused_dot is not None:
            batch = tuple(a.shape[:-2])
            if len(batch) > 1:  # the kernel takes one batch dim
                a, b = a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:])
            P = fused_dot(_to_blocks(a, L)[None], _to_blocks(b, L)[None], _slot_tables(L))
            P = P.reshape(P.shape[0], *batch, *P.shape[-2:])
        else:
            (ar, ac, asg), (br, bc, bsg) = _slot_tables(L)
            ga, gb = _block_getter(a, L), _block_getter(b, L)
            P = torch.stack([
                base_dot(_combine_slots(ga, ar[s], ac[s], asg[s]),
                         _combine_slots(gb, br[s], bc[s], bsg[s]))
                for s in range(7 ** L)
            ])
    P = P[:, None, None]
    for lev in range(L, 0, -1):
        with obs.span(f"strassen.decode.L{lev}"):
            P = _decode_strassen(P)
    return _unblock(P)[0]


def strassen_tn(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    alpha: float = 1.0,
    c: Optional[torch.Tensor] = None,
    beta: float = 1.0,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    base_dot: Optional[Callable] = None,
    acc_dtype=torch.float32,
) -> torch.Tensor:
    """``C = alpha·AᵀB (+ beta·C)`` via rectangular TN Strassen.

    ``a: (..., m, n)``, ``b: (..., m, k)`` with matching leading batch dims.
    ``plan``: a frozen ``repro_torch.tune.Plan`` carrying every tunable.
    With no plan and neither ``n_base`` nor ``variant`` pinned, the call is
    planned by ``repro_torch.tune.plan`` for ``a``'s device and dtype;
    pinning either takes the static defaults for the rest (``n_base=512``,
    ``variant='strassen'``, ``leaf_dispatch='unrolled'``), bitwise
    reproducible. ``leaf_dispatch`` alone does not bypass the planner.
    ``base_dot(a, b) -> aᵀb`` must accept one leading batch dim; it
    defaults to the plan's engine (``ops.gemm_tn``: the CUDA kernel on the
    card, the plain matmul on the CPU) or, pinned, to ``ops.gemm_tn``.
    ``leaf_dispatch='fused'`` with no ``base_dot`` runs every leaf in one
    ``ops.gemm_tn_fused`` launch.
    """
    if a.ndim < 2 or b.ndim < 2 or a.ndim != b.ndim:
        raise ValueError(f"strassen_tn expects 2-D+ operands, got {tuple(a.shape)}, {tuple(b.shape)}")
    if a.shape[-2] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(
            f"contracting/batch dims mismatch: A is {tuple(a.shape)}, B is {tuple(b.shape)}"
        )
    m, n = a.shape[-2:]
    k = b.shape[-1]
    backend, dtype = planner_key(a)
    plan, n_base, variant, _, leaf_dispatch = resolve_tunables(
        plan, n_base, variant, None, op="gemm_tn", m=m, n=n, k=k,
        batch=math.prod(a.shape[:-2]) if a.ndim > 2 else 0, dtype=dtype,
        leaf_dispatch=leaf_dispatch, backend=backend)
    fused_dot = None
    if base_dot is None:
        from repro_torch.tune.apply import engine

        eng = engine(plan, a.dtype, b.dtype, acc_dtype)
        base_dot = functools.partial(eng.gemm_tn, out_dtype=acc_dtype)
        if leaf_dispatch == "fused" and eng.gemm_tn_fused is not None:
            fused_dot = functools.partial(eng.gemm_tn_fused, out_dtype=acc_dtype)
    L = tree_depth((m, n, k), n_base)
    obs.metrics.inc(f"dispatch.gemm_tn.{leaf_dispatch}")
    obs.metrics.inc("gemm_tn.leaves", 7 ** L)
    t0 = obs.dispatch_start(plan, a)
    with obs.span("strassen_tn", m=m, n=n, k=k, levels=L, leaf_dispatch=leaf_dispatch):
        if L:
            a, b = _pad_root(a, L), _pad_root(b, L)
        if leaf_dispatch == "batched":
            out = _strassen_batched(a, b, L, base_dot, variant)
        elif leaf_dispatch == "fused":
            out = _strassen_fused(a, b, L, base_dot, fused_dot)
        else:
            rec = _rec_strassen if variant == "strassen" else _rec_winograd
            out = rec(a, b, n_base=n_base, base_dot=base_dot, acc_dtype=acc_dtype)
        out = out[..., :n, :k]
        if alpha != 1.0:
            out = alpha * out
        if c is not None:
            out = out + (beta * c if beta != 1.0 else c)
        return obs.dispatch_finish(plan, t0, out)
