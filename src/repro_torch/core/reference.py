"""Naive oracles and exact flop counters (port of ``repro.core.reference``).

The oracles are the classical products; the counters walk the same
recursion as the implementations (same splits, same cutoff) and are plain
integer functions, so they equal the reference's exactly for every shape.
"""

from __future__ import annotations

import functools

__all__ = [
    "syrk_ref",
    "gemm_tn_ref",
    "classical_syrk_flops",
    "classical_gemm_flops",
    "strassen_tn_flops",
    "strassen_tn_flops_winograd",
    "ata_flops",
    "potrf_flops",
    "trsm_flops",
    "blocked_potrf_flops",
    "cg_iteration_flops",
]


def syrk_ref(a, alpha=1.0, c=None, beta=1.0):
    """Classical ``C = alpha·AᵀA (+ beta·C)`` oracle (full symmetric output)."""
    out = alpha * (a.transpose(-1, -2) @ a)
    if c is not None:
        out = out + beta * c
    return out


def gemm_tn_ref(a, b, alpha=1.0, c=None, beta=1.0):
    """Classical ``C = alpha·AᵀB (+ beta·C)`` oracle."""
    out = alpha * (a.transpose(-1, -2) @ b)
    if c is not None:
        out = out + beta * c
    return out


def classical_syrk_flops(m: int, n: int) -> int:
    """Flops of classical syrk exploiting symmetry: n(n+1)/2 dots of length m."""
    return m * n * (n + 1)


def classical_gemm_flops(m: int, n: int, k: int) -> int:
    """Flops of classical ``AᵀB`` with A:(m,n), B:(m,k)."""
    return 2 * m * n * k


@functools.lru_cache(maxsize=None)
def strassen_tn_flops(m: int, n: int, k: int, n_base: int) -> int:
    """Exact flop count of the rectangular TN Strassen (classical variant):
    cutoff when any dim ≤ n_base, odd dims counted padded to even."""
    if min(m, n, k) <= n_base:
        return classical_gemm_flops(m, n, k)
    mp, np_, kp = m + (m & 1), n + (n & 1), k + (k & 1)
    m2, n2, k2 = mp // 2, np_ // 2, kp // 2
    mults = 7 * strassen_tn_flops(m2, n2, k2, n_base)
    # 10 operand-side additions + 8 additions combining the 7 products
    adds = 5 * m2 * n2 + 5 * m2 * k2 + 8 * n2 * k2
    return mults + adds


@functools.lru_cache(maxsize=None)
def strassen_tn_flops_winograd(m: int, n: int, k: int, n_base: int) -> int:
    """Flop count for the Winograd variant (7 mults, 15 adds)."""
    if min(m, n, k) <= n_base:
        return classical_gemm_flops(m, n, k)
    mp, np_, kp = m + (m & 1), n + (n & 1), k + (k & 1)
    m2, n2, k2 = mp // 2, np_ // 2, kp // 2
    mults = 7 * strassen_tn_flops_winograd(m2, n2, k2, n_base)
    adds = 4 * m2 * n2 + 4 * m2 * k2 + 7 * n2 * k2
    return mults + adds


def potrf_flops(n: int) -> int:
    """Exact flops of the unblocked right-looking Cholesky of an ``n × n``
    SPD matrix, symmetric-aware: per column one sqrt, ``n−1−j`` divisions
    and the rank-1 update of the trailing lower triangle."""
    total = 0
    for j in range(n):
        t = n - 1 - j
        total += 1 + t + t * (t + 1)
    return total


def trsm_flops(n: int, r: int) -> int:
    """Exact flops of one triangular solve against an ``n × n`` factor with
    ``r`` right-hand sides: ``n²·r``."""
    return n * n * r


def blocked_potrf_flops(n: int, bn: int) -> int:
    """Exact flops of the packed blocked Cholesky walk
    (``repro_torch.solve.cholesky``), padded tail blocks counted full."""
    nb = -(-n // bn)
    gemm = classical_gemm_flops(bn, bn, bn)
    total = 0
    for j in range(nb):
        rows = nb - 1 - j
        total += j * gemm
        total += potrf_flops(bn)
        total += rows * j * gemm
        total += rows * trsm_flops(bn, bn)
    return total


def cg_iteration_flops(m: int, n: int, r: int) -> int:
    """Exact flops of one CG iteration on the gram *operator*
    ``x ↦ Aᵀ(A·x) + λx`` with ``r`` simultaneous right-hand sides: the two
    TN products (``2mnr`` each — ``A·p`` then ``Aᵀ(Ap)``) plus the ridge
    axpy and the 5 length-``n·r`` vector updates/dots of the textbook
    iteration."""
    return 2 * classical_gemm_flops(m, n, r) + 12 * n * r


@functools.lru_cache(maxsize=None)
def ata_flops(m: int, n: int, n_base: int, winograd: bool = False) -> int:
    """Exact flop count of ATA (paper Algorithm 1) with this cutoff:
    4 recursive ATA calls + 2 Strassen TN calls + the block additions."""
    if min(m, n) <= n_base:
        return classical_syrk_flops(m, n)
    mp, np_ = m + (m & 1), n + (n & 1)
    m2, n2 = mp // 2, np_ // 2
    s = strassen_tn_flops_winograd if winograd else strassen_tn_flops
    rec = 4 * ata_flops(m2, n2, n_base, winograd)
    strassen = 2 * s(m2, n2, n2, n_base)
    adds = 2 * (n2 * (n2 + 1) // 2) + n2 * n2
    return rec + strassen + adds
