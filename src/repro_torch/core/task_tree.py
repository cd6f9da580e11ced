"""The paper's task-tree scheduler (Section 4.1) — faithful reproduction.

Implements:

* the parallel-level formulas ℓ(P) for ATA-D (Eq. 5) and ATA-S (Eq. 6);
* the task tree 𝒯: a BFS expansion of the recursion tree of ATA-naive
  (recursive-GEMM instead of Strassen), interrupted once 𝒯 has ≥ P leaves;
* leaf tasks carrying ``computation_type ∈ {ATA, ATB}`` and the row/column
  offsets+sizes of the A/B/C sub-matrices (paper §4.1.1, items 1-3);
* the α = 1/2 load-balancing rule (an AᵀB task costs ≈ 2× an AᵀA task of the
  same size, paper §4.1.2) and an LPT assignment of leaves to P processes.

Two expansion modes mirror the paper:

* ``mode='distributed'`` (ATA-D): an ATA node fans out into **6** children
  (4 recursive ATA + 2 recursive-GEMM), an ATB node into **8** (the 2×2×2
  recursive-GEMM splits) — Algorithm 1 + Algorithm 2.
* ``mode='shared'`` (ATA-S): vertical/horizontal striping (Fig. 2, Eq. 7)
  so every task writes a **disjoint** block of C: an ATA node fans out into
  **3** children (ATA on the left column stripe → C11, ATA on the right
  stripe → C22, one full-height ATB stripe product → C21) and an ATB node
  into **4** (one per C quadrant, full contraction height).

The SPMD executor (`repro_torch.core.distributed`) uses a shape-uniform
block-cyclic realization of the same disjoint-task principle (see its
docstring); this module is the faithful model — used for tests, the
analytic speedup benchmarks (paper Fig. 5/6), and for choosing stripe
widths.

A copy of ``repro.core.task_tree``: plain Python, no tensors, so the port
keeps the reference's code as it is and its results are equal.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Literal, Optional, Tuple

__all__ = [
    "Task",
    "ell_distributed",
    "ell_shared",
    "build_task_tree",
    "assign_tasks",
    "task_flops",
    "modeled_speedup",
]

ALPHA = 0.5  # paper's load-balancing parameter (§4.1.2)


def ell_distributed(p: int) -> int:
    """Eq. (5): number of parallel levels in the ATA-D task tree."""
    if p < 1:
        raise ValueError("P must be >= 1")
    if p == 1:
        return 0
    if p <= 6:
        return 1
    q = p / 4.0
    k = max(0, math.floor(math.log(q, 8)))  # max k with q / 8^k >= 1
    rem = q % (8 ** max(k, 1))
    return 1 + k + (1 if rem > 0 else 0)


def ell_shared(p: int) -> int:
    """Eq. (6): number of parallel levels in the ATA-S task tree."""
    if p < 1:
        raise ValueError("P must be >= 1")
    if p == 1:
        return 0
    if p <= 3:
        return 1
    q = p / 2.0
    k = max(0, math.floor(math.log(q, 4)))  # max k with q / 4^k >= 1
    rem = q % (4 ** max(k, 1))
    return 1 + k + (1 if rem > 0 else 0)


@dataclasses.dataclass(frozen=True)
class Task:
    """A node of the task tree 𝒯 (leaf tasks = actual multiplications).

    Offsets/sizes address sub-matrices of the *original* A (and of C):
    ``ATA``: C[c_off : c_off+c_rows, c_off : c_off+c_cols] += A_aᵀ·A_a
    ``ATB``: C[...] += A_aᵀ·A_b  where A_a/A_b are column×row windows of A.
    """

    kind: Literal["ATA", "ATB"]
    # A operand window: rows [ar0, ar1), cols [ac0, ac1)
    ar0: int
    ar1: int
    ac0: int
    ac1: int
    # B operand window (ATB only; for ATA it mirrors the A window)
    br0: int = -1
    br1: int = -1
    bc0: int = -1
    bc1: int = -1
    # C output window: rows [cr0, cr1), cols [cc0, cc1)
    cr0: int = 0
    cr1: int = 0
    cc0: int = 0
    cc1: int = 0
    parent: int = -1  # index of the parent node (result-retrieval edge, ATA-D)
    depth: int = 0

    def weight(self) -> float:
        """Relative cost model used for α-balancing: ATB ≈ 2× ATA (§4.1.2)."""
        m = self.ar1 - self.ar0
        n = self.ac1 - self.ac0
        if self.kind == "ATA":
            return m * n * (n + 1) / 2.0
        k = self.bc1 - self.bc0
        return float(m * n * k)


def _children_distributed(t: Task, idx: int) -> List[Task]:
    """ATA → 6 children (Alg. 1); ATB → 8 children (Alg. 2)."""
    m1 = (t.ar0 + t.ar1) // 2
    n1 = (t.ac0 + t.ac1) // 2
    d = t.depth + 1
    if t.kind == "ATA":
        c1 = (t.ac1 - t.ac0) // 2  # cols in the C11 block
        out = [
            # four recursive ATA calls (lines 7-10)
            Task("ATA", t.ar0, m1, t.ac0, n1, cr0=t.cr0, cr1=t.cr0 + c1,
                 cc0=t.cc0, cc1=t.cc0 + c1, parent=idx, depth=d),
            Task("ATA", m1, t.ar1, t.ac0, n1, cr0=t.cr0, cr1=t.cr0 + c1,
                 cc0=t.cc0, cc1=t.cc0 + c1, parent=idx, depth=d),
            Task("ATA", t.ar0, m1, n1, t.ac1, cr0=t.cr0 + c1, cr1=t.cr1,
                 cc0=t.cc0 + c1, cc1=t.cc1, parent=idx, depth=d),
            Task("ATA", m1, t.ar1, n1, t.ac1, cr0=t.cr0 + c1, cr1=t.cr1,
                 cc0=t.cc0 + c1, cc1=t.cc1, parent=idx, depth=d),
            # two AᵀB calls for C21 (lines 11-12): A12ᵀA11 and A22ᵀA21
            Task("ATB", t.ar0, m1, n1, t.ac1, br0=t.ar0, br1=m1, bc0=t.ac0,
                 bc1=n1, cr0=t.cr0 + c1, cr1=t.cr1, cc0=t.cc0, cc1=t.cc0 + c1,
                 parent=idx, depth=d),
            Task("ATB", m1, t.ar1, n1, t.ac1, br0=m1, br1=t.ar1, bc0=t.ac0,
                 bc1=n1, cr0=t.cr0 + c1, cr1=t.cr1, cc0=t.cc0, cc1=t.cc0 + c1,
                 parent=idx, depth=d),
        ]
        return out
    # ATB → RecursiveGEMM's 2×2×2 split (Algorithm 2)
    out = []
    bn1 = (t.bc0 + t.bc1) // 2
    cr_mid = (t.cr0 + t.cr1) // 2
    cc_mid = (t.cc0 + t.cc1) // 2
    for i in range(2):  # C row-block = A column half
        a_c = (t.ac0, n1) if i == 0 else (n1, t.ac1)
        c_r = (t.cr0, cr_mid) if i == 0 else (cr_mid, t.cr1)
        for j in range(2):  # C col-block = B column half
            b_c = (t.bc0, bn1) if j == 0 else (bn1, t.bc1)
            c_c = (t.cc0, cc_mid) if j == 0 else (cc_mid, t.cc1)
            for kk in range(2):  # contraction half
                a_r = (t.ar0, m1) if kk == 0 else (m1, t.ar1)
                out.append(
                    Task("ATB", a_r[0], a_r[1], a_c[0], a_c[1],
                         br0=a_r[0], br1=a_r[1], bc0=b_c[0], bc1=b_c[1],
                         cr0=c_r[0], cr1=c_r[1], cc0=c_c[0], cc1=c_c[1],
                         parent=idx, depth=d)
                )
    return out


def _children_shared(t: Task, idx: int) -> List[Task]:
    """ATA → 3 children, ATB → 4 children (Fig. 2 striping, disjoint C)."""
    n1 = (t.ac0 + t.ac1) // 2
    d = t.depth + 1
    if t.kind == "ATA":
        c1 = (t.ac1 - t.ac0) // 2
        return [
            # full-height column stripes: disjoint C blocks, no k-split
            Task("ATA", t.ar0, t.ar1, t.ac0, n1, cr0=t.cr0, cr1=t.cr0 + c1,
                 cc0=t.cc0, cc1=t.cc0 + c1, parent=idx, depth=d),
            Task("ATA", t.ar0, t.ar1, n1, t.ac1, cr0=t.cr0 + c1, cr1=t.cr1,
                 cc0=t.cc0 + c1, cc1=t.cc1, parent=idx, depth=d),
            Task("ATB", t.ar0, t.ar1, n1, t.ac1, br0=t.ar0, br1=t.ar1,
                 bc0=t.ac0, bc1=n1, cr0=t.cr0 + c1, cr1=t.cr1, cc0=t.cc0,
                 cc1=t.cc0 + c1, parent=idx, depth=d),
        ]
    bn1 = (t.bc0 + t.bc1) // 2
    cr_mid = (t.cr0 + t.cr1) // 2
    cc_mid = (t.cc0 + t.cc1) // 2
    out = []
    for i in range(2):
        a_c = (t.ac0, n1) if i == 0 else (n1, t.ac1)
        c_r = (t.cr0, cr_mid) if i == 0 else (cr_mid, t.cr1)
        for j in range(2):
            b_c = (t.bc0, bn1) if j == 0 else (bn1, t.bc1)
            c_c = (t.cc0, cc_mid) if j == 0 else (cc_mid, t.cc1)
            out.append(
                Task("ATB", t.ar0, t.ar1, a_c[0], a_c[1], br0=t.ar0,
                     br1=t.ar1, bc0=b_c[0], bc1=b_c[1], cr0=c_r[0],
                     cr1=c_r[1], cc0=c_c[0], cc1=c_c[1], parent=idx, depth=d)
            )
    return out


def build_task_tree(
    m: int,
    n: int,
    p: int,
    mode: Literal["shared", "distributed"] = "shared",
    min_dim: int = 1,
) -> List[Task]:
    """BFS-expand the ATA-naive recursion tree until ≥ P leaves (paper §4.1.1).

    Returns the leaf tasks in BFS order. Expansion stops early on tasks whose
    dimensions would drop below ``min_dim``.
    """
    if p < 1:
        raise ValueError("P must be >= 1")
    children = _children_shared if mode == "shared" else _children_distributed
    root = Task("ATA", 0, m, 0, n, cr0=0, cr1=n, cc0=0, cc1=n, parent=-1)
    leaves = deque([(root, 0)])
    node_count = 1
    while len(leaves) < p:
        # expand the oldest (shallowest) expandable leaf — BFS order
        for _ in range(len(leaves)):
            t, idx = leaves[0]
            dims = (t.ar1 - t.ar0, t.ac1 - t.ac0)
            if min(dims) >= 2 * min_dim:
                leaves.popleft()
                for ch in children(t, idx):
                    node_count += 1
                    leaves.append((ch, node_count))
                break
            leaves.rotate(-1)
        else:
            break  # nothing expandable
        continue
    return [t for t, _ in leaves]


def assign_tasks(tasks: List[Task], p: int) -> List[List[Task]]:
    """LPT (longest-processing-time) assignment of leaf tasks to P processes.

    Realizes the α = 1/2 balance: ATB leaves weigh ≈2× same-size ATA leaves
    via :meth:`Task.weight`.
    """
    buckets: List[List[Task]] = [[] for _ in range(p)]
    loads = [0.0] * p
    for t in sorted(tasks, key=lambda t: -t.weight()):
        i = loads.index(min(loads))
        buckets[i].append(t)
        loads[i] += t.weight()
    return buckets


def task_flops(tasks: List[Task]) -> float:
    return sum(t.weight() for t in tasks)


def modeled_speedup(n: int, p: int, mode: str = "shared") -> float:
    """Analytic speedup model: serial weight / critical-path weight.

    Mirrors paper Eq. (8): T(n,P) = O(P) + O(n^{log₂7} / 4^{ℓ(P)}); we use
    the actual LPT-balanced makespan of the task tree, which reproduces the
    step-wise curves of Fig. 5/6.
    """
    tasks = build_task_tree(n, n, p, mode=mode)
    buckets = assign_tasks(tasks, p)
    serial = task_flops(tasks)
    makespan = max(task_flops(b) for b in buckets)
    return serial / max(makespan, 1.0)
