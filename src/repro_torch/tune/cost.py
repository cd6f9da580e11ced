"""Analytic cost model of the port's planner (port of ``repro.tune.cost``,
single-device branch).

The model joins the exact flop counters of ``repro_torch.core.reference``
(split here into multiply flops of the base products and addition flops of
the operand combinations) with the write-traffic models of
``repro_torch.analysis.roofline``. Per candidate the prediction is

    compute_s  = mult_flops / (peak · eff(d_base)),  eff(d) = d / (d + d_half)
    memory_s   = (stream_bytes + output_bytes) / hbm_bw
    predicted  = max(compute_s, memory_s) + combine_s + calls · launch_overhead_s

with ``stream_bytes = (mult/2)·(1/bn + 1/bk)`` words of operand streaming
for a ``bn × bk`` output tile of the base engine, and ``combine_s`` the
operand-combination traffic of the leaf dispatch (``add_word_cost`` words
an addition flop unrolled, ``stack_word_cost`` batched, the ``3^L`` slot
gather fused). The algorithm and ``n_base`` are scored with the dense
output term, so ``out='packed'`` and ``out='dense'`` plans of one problem
run the same recursion and packed results stay bitwise equal to dense.

Two machines: ``"cpu"`` carries the reference's CPU numbers exactly, so a
CPU tensor plans as the reference does on its CPU backend; ``"cuda"`` is
an NVIDIA H100 (``cuda_h100``) whose base engine is the port's CUDA
kernels. Its parameters are data-sheet values and nominal constants, not
yet fitted to measurements (see :data:`MACHINES`). The cuda machine also
has a memory budget: a candidate whose :func:`peak_bytes` exceed the
card's memory is not offered.

The distributed branch (``devices > 1`` task ranks, ``row_devices``
row ranks) is the reference's: :func:`distributed_tiling` and
:func:`bfs_tiling` choose the stripe grid of the tile schedules
(``repro_torch.core.distributed``), :func:`retrieval_bytes` prices the
packed retrieval, and the α-β model (:func:`comm_levels`,
:func:`comm_seconds`, :func:`comm_memory_bytes`,
:func:`choose_comm_schedule`) prices and picks the BFS/DFS interleaving
(``Plan.comm_schedule``) against the machine's per-device memory budget.
On the cpu machine every function equals the reference's.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

from repro_torch.core.reference import (
    ata_flops,
    blocked_potrf_flops,
    cg_iteration_flops,
    classical_gemm_flops,
    classical_syrk_flops,
    strassen_tn_flops,
    strassen_tn_flops_winograd,
    trsm_flops,
)
from repro_torch.tune import defaults

__all__ = [
    "Plan",
    "Machine",
    "MACHINES",
    "machine_for",
    "predict_seconds",
    "peak_bytes",
    "retrieval_bytes",
    "comm_levels",
    "comm_seconds",
    "comm_memory_bytes",
    "comm_schedule_candidates",
    "choose_comm_schedule",
    "dispatch_calls",
    "solve_dispatch_calls",
    "candidates",
    "analytic_plan",
    "default_plan",
    "distributed_tiling",
    "bfs_tiling",
]

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}
# output tile edge of the CUDA kernels' base engine (csrc/tn_tile.cuh kTile)
_KERNEL_TILE = 128


# ---------------------------------------------------------------------------
# the frozen dispatch plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """One fully resolved ``ata``/``strassen_tn``/``lstsq`` dispatch: the
    problem key and every tunable, frozen and JSON-serializable.

    ``algorithm``: for ``op='ata'``, 'strassen'/'winograd' select the C21
    variant of the ATA recursion and 'dense' one classical TN product; for
    ``op='gemm_tn'`` they select the Strassen variant. ``syrk_blocks`` and
    ``gemm_blocks`` are the reference's Pallas block shapes: in the port
    they set the packed block size of ``ops.syrk`` and the plan's identity,
    never a CUDA tile.
    """

    op: str                      # 'ata' | 'gemm_tn' | 'solve'
    m: int
    n: int
    k: int                       # == n for op='ata'; rhs count for op='solve'
    batch: int                   # leading batch size (0 = unbatched)
    dtype: str                   # 'float32' | 'bfloat16' | 'float64' | 'float16'
    backend: str                 # 'cuda' | 'cpu': the operand's device type
    out: str                     # 'dense' | 'packed'
    algorithm: str               # 'dense' | 'strassen' | 'winograd'
    n_base: int
    packed_block: int
    use_kernels: bool            # the CUDA kernels (ops wrappers) vs the plain bases
    syrk_blocks: Tuple[int, int]
    gemm_blocks: Tuple[int, int, int]
    # 'unrolled' | 'batched' | 'fused'; entries older than the field load
    # as 'unrolled', which is what they were measured with
    leaf_dispatch: str = "unrolled"
    # op='solve' only: 'factor' or 'cg'
    method: Optional[str] = None
    # the distributed branch: task-axis size, stripe count and width of the
    # tile schedule (devices > 1), row-axis size, and the BFS/DFS
    # interleaving (None: the plain all-reduce schedule)
    devices: int = 1
    nb: Optional[int] = None
    tile_w: Optional[int] = None
    row_devices: int = 1
    comm_schedule: Optional[str] = None
    source: str = "analytic"     # 'analytic' | 'measured' | 'cache' | 'default'
    predicted_s: Optional[float] = None
    measured_s: Optional[float] = None
    # seconds of the static default dispatch, timed interleaved with this
    # plan by the autotuner: baseline_s / measured_s is its speedup
    baseline_s: Optional[float] = None

    @property
    def variant(self) -> str:
        """Strassen variant the recursion runs ('dense' plans included: the
        recursion never splits because n_base covers the whole operand)."""
        return "winograd" if self.algorithm == "winograd" else "strassen"

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["syrk_blocks"] = list(self.syrk_blocks)
        d["gemm_blocks"] = list(self.gemm_blocks)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Plan":
        d = dict(d)
        d["syrk_blocks"] = tuple(d["syrk_blocks"])
        d["gemm_blocks"] = tuple(d["gemm_blocks"])
        return cls(**d)


# ---------------------------------------------------------------------------
# machine models
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Machine:
    """Roofline parameters of one backend."""

    name: str
    peak_flops: float      # base-product peak, flops/s
    hbm_bw: float          # bytes/s
    d_half: int            # product dim at which efficiency reaches 1/2
    kernels: bool          # the base products run the hand-written kernels
    add_word_cost: float   # memory words charged per addition flop (unrolled)
    # words per addition flop of the batched dispatch, whose combinations
    # materialize as stacks the leaf product re-reads (write + read = 2.0)
    stack_word_cost: float = 2.0
    xla_tile: int = 256    # nominal output tile of a library matmul
    # host time of one dispatched call; unrolled pays it per leaf, batched
    # and fused per level
    launch_overhead_s: float = 5e-6
    # α-β collective model of the distributed branch: seconds a message
    # (one step of a ring collective) and a byte cost
    alpha_s: float = 1e-6
    beta_s_per_byte: float = 2.5e-11
    # bytes a rank may hold: the distributed branch drops interleavings
    # whose residency (:func:`comm_memory_bytes`) exceeds it, as the
    # reference does; with ``budget_single_device`` single-device
    # candidates whose :func:`peak_bytes` exceed it are dropped too
    device_memory_bytes: float = 16e9
    budget_single_device: bool = False

    def mxu_eff(self, d: int) -> float:
        d = max(int(d), 1)
        return d / (d + self.d_half)


MACHINES = {
    # the reference's "cpu" machine, unchanged (its numbers were fitted to
    # the reference's CPU runs), so CPU tensors plan as the reference does;
    # its 2 GB budget prices only the distributed schedules, as there
    "cpu": lambda: Machine("cpu", 2.2e11, 2.0e10, 512, False, 1.5,
                           stack_word_cost=5.5, launch_overhead_s=5e-5,
                           alpha_s=5e-5, beta_s_per_byte=7e-10,
                           device_memory_bytes=2e9),
    # NVIDIA H100 SXM with the port's CUDA kernels. None of these is
    # calibrated yet (ROADMAP B):
    "cuda": lambda: Machine(
        "cuda_h100",
        peak_flops=67e12,          # data sheet: float32 outside the tensor cores
        hbm_bw=3.35e12,            # data sheet: HBM3
        d_half=128,                # nominal: half rate at the engine's tile edge
        kernels=True,
        add_word_cost=1.0,         # nominal: one word an addition flop
        stack_word_cost=2.0,       # nominal: write + read of a stack word
        launch_overhead_s=35e-6,   # chip run: host time of one wrapper call,
                                   # 32–47 µs (PERF.md §5–6, NVIDIA H100 80GB
                                   # HBM3, 700.00 W)
        alpha_s=1e-5,              # nominal: an NCCL ring step between
                                   # cards of one host, about 10 µs
        beta_s_per_byte=1 / 450e9,  # data sheet: NVLink 4, 450 GB/s a
                                    # direction (900 GB/s both)
        device_memory_bytes=80e9,  # data sheet: 80 GB HBM3
        budget_single_device=True,
    ),
}


def machine_for(backend: str) -> Machine:
    return MACHINES.get(backend, MACHINES["cpu"])()


# ---------------------------------------------------------------------------
# mult/add flop split (exact, mirrors the recursions)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _strassen_mult_flops(m: int, n: int, k: int, n_base: int) -> int:
    """Flops of the TN Strassen recursion's base products only."""
    if min(m, n, k) <= n_base:
        return classical_gemm_flops(m, n, k)
    mp, np_, kp = m + (m & 1), n + (n & 1), k + (k & 1)
    return 7 * _strassen_mult_flops(mp // 2, np_ // 2, kp // 2, n_base)


@functools.lru_cache(maxsize=None)
def _ata_mult_flops(m: int, n: int, n_base: int) -> int:
    """Flops of the ATA recursion's base products (syrk tiles + Strassen
    leaves; the C11/C22/C21 accumulations are additions)."""
    if min(m, n) <= n_base:
        return classical_syrk_flops(m, n)
    mp, np_ = m + (m & 1), n + (n & 1)
    m2, n2 = mp // 2, np_ // 2
    return 4 * _ata_mult_flops(m2, n2, n_base) + 2 * _strassen_mult_flops(m2, n2, n2, n_base)


@functools.lru_cache(maxsize=None)
def _strassen_leaves(m: int, n: int, k: int, n_base: int) -> int:
    """Leaf (base-product) count of the TN Strassen recursion."""
    if min(m, n, k) <= n_base:
        return 1
    mp, np_, kp = m + (m & 1), n + (n & 1), k + (k & 1)
    return 7 * _strassen_leaves(mp // 2, np_ // 2, kp // 2, n_base)


@functools.lru_cache(maxsize=None)
def _ata_leaves(m: int, n: int, n_base: int) -> Tuple[int, int]:
    """(syrk_leaves, gemm_leaves) of the ATA tree."""
    if min(m, n) <= n_base:
        return 1, 0
    mp, np_ = m + (m & 1), n + (n & 1)
    m2, n2 = mp // 2, np_ // 2
    s, g = _ata_leaves(m2, n2, n_base)
    return 4 * s, 4 * g + 2 * _strassen_leaves(m2, n2, n2, n_base)


def _levels(op, m, n, k, n_base) -> int:
    # the recursion's own depth rule, so pricing counts the tree the
    # dispatch runs (imported here: core reaches tune only lazily too)
    from repro_torch.core.strassen import tree_depth

    return tree_depth((m, n, k) if op == "gemm_tn" else (m, n), n_base)


def dispatch_calls(op, algorithm, m, n, k, n_base, leaf_dispatch) -> int:
    """Calls the dispatch makes from the host — the launch-overhead
    multiplier. Unrolled: one per leaf (``7^L`` for Strassen, ``4^L``
    syrks + the off-diagonal leaves for ATA); batched: the two batched leaf
    calls plus O(levels) encode/decode passes; fused: one launch and one
    decode pass per level (ATA: plus the gathered diagonal syrk); dense:
    one call.
    """
    if algorithm == "dense":
        return 1
    if leaf_dispatch == "fused":
        lv = _levels(op, m, n, k, n_base)
        if op == "ata":
            return 2 + 2 * lv
        return 1 + lv
    if leaf_dispatch == "batched":
        return 2 + 4 * _levels(op, m, n, k, n_base)
    if op == "ata":
        s, g = _ata_leaves(m, n, n_base)
        return s + g
    return _strassen_leaves(m, n, k, n_base)


def solve_dispatch_calls(n: int, packed_block: int) -> int:
    """Calls of the packed factor-and-substitute pipeline beyond the gram:
    per block column one potrf, one batched panel trsm and up to two Schur
    updates; per substitution pass one diagonal solve and one update per
    block row, twice."""
    nb = -(-n // packed_block)
    factor = nb + (nb - 1) + 2 * max(nb - 1, 0)
    substitute = 2 * 2 * nb
    return factor + substitute


def _solve_predict(method, algorithm, m, n, r, n_base, *, dtype, packed_block, machine,
                   blocks, leaf_dispatch="unrolled") -> float:
    """Prediction for one op='solve' candidate: the packed gram plus the
    factor and substitution tail (``'factor'``), or ``CG_MAX_ITERS``-capped
    iterations that each stream the operand twice (``'cg'``)."""
    from repro_torch.analysis.roofline import normal_eq_write_traffic

    itemsize = _ITEMSIZE.get(dtype, 4)
    if method == "cg":
        iters = min(n, defaults.CG_MAX_ITERS)
        flops = iters * cg_iteration_flops(m, n, r)
        d = min(m, n)
        compute_s = flops / (machine.peak_flops * machine.mxu_eff(d))
        mem = iters * (2 * m * n + 6 * n * r) * itemsize
        overhead = iters * 8 * machine.launch_overhead_s
        return max(compute_s, mem / machine.hbm_bw) + overhead

    gram_s = predict_seconds(
        "ata", algorithm, m, n, n, n_base, dtype=dtype, out="packed",
        packed_block=packed_block, machine=machine, blocks=blocks,
        leaf_dispatch=leaf_dispatch)
    flops = blocked_potrf_flops(n, packed_block) + 2 * trsm_flops(n, r)
    compute_s = flops / (machine.peak_flops * machine.mxu_eff(packed_block))
    mem = normal_eq_write_traffic(n, packed_block, r, itemsize=itemsize)
    overhead = solve_dispatch_calls(n, packed_block) * machine.launch_overhead_s
    return gram_s + max(compute_s, mem / machine.hbm_bw) + overhead


def _flop_split(op, algorithm, m, n, k, n_base):
    """(mult_flops, add_flops) of one candidate; adds = total − mults."""
    if algorithm == "dense":
        return classical_gemm_flops(m, n, k), 0
    winograd = algorithm == "winograd"
    if op == "ata":
        total = ata_flops(m, n, n_base, winograd=winograd)
        mult = _ata_mult_flops(m, n, n_base)
    else:
        s = strassen_tn_flops_winograd if winograd else strassen_tn_flops
        total = s(m, n, k, n_base)
        mult = _strassen_mult_flops(m, n, k, n_base)
    return mult, max(total - mult, 0)


def _output_bytes(op, out, n, k, packed_block, itemsize) -> int:
    """Bytes written for the final output."""
    from repro_torch.analysis.roofline import syrk_write_traffic

    if op == "ata":
        mode = "packed" if out == "packed" else "dual"
        return syrk_write_traffic(n, packed_block, mode, itemsize)
    return n * k * itemsize


def retrieval_bytes(out: str, nb: int, tile_w: int, itemsize: int = 4) -> int:
    """Retrieval payload of the distributed tile schedule, per rank: the
    gathered tile stack ``T·w² ≈ n²/2`` words for ``out='packed'`` (the
    paper's packed low(C) saving as collective bytes), the mirrored
    ``(nb·w)²`` square for ``out='dense'``."""
    t_total = nb * (nb + 1) // 2
    if out == "packed":
        return t_total * tile_w * tile_w * itemsize
    return (nb * tile_w) ** 2 * itemsize


# ---------------------------------------------------------------------------
# α-β communication model of the BFS/DFS schedule (CAPS-style, paper §5)
# ---------------------------------------------------------------------------


def _bfs_makespan(nb: int, devices: int, comm_schedule: Optional[str]) -> int:
    """Tiles on the busiest task rank under the interleaving (the
    contiguous ``ceil(T/devices)`` for pure DFS and the all-reduce
    schedule)."""
    t_total = nb * (nb + 1) // 2
    if not comm_schedule or "B" not in comm_schedule:
        return -(-t_total // devices)
    from repro_torch.core.distributed import bfs_dfs_assignment

    owned, _ = bfs_dfs_assignment(nb, devices, comm_schedule)
    return max(len(o) for o in owned)


def comm_levels(comm_schedule: Optional[str], nb: int, tile_w: int, devices: int,
                row_devices: int = 1, *, out: str = "packed", itemsize: int = 4) -> list:
    """Per-level ``{'tag', 'msgs', 'words'}`` of one interleaving, priced
    with ring-collective α-β counts (the reference's model, kept as is):

    * any ``'B'`` level switches the root exchange to the **tri-direct
      reduce-scatter** over the merged ``P = devices·row_devices`` pool of
      the ``T``-padded staging stack ``S_pad = T_pad·w²`` (``P−1`` steps,
      ``S_pad·(P−1)/P`` words), spread over the ``'B'`` levels; dense out
      adds a gather of the stack at the last level;
    * a pure-``'D'`` string (or None, the all-reduce schedule) pays the
      row-axis all-reduce of the slot stack (``2(d−1)`` steps,
      ``2·S·(d−1)/d`` words) over the ``'D'`` levels, then at the last
      level the root gather of the packed result (dense: plus the mirrored
      square) and the reference's diagonal-symmetrization gather
      (``P−1`` steps, ``nb·w²`` words).
    """
    sched = comm_schedule or "D"
    t_total = nb * (nb + 1) // 2
    pool = devices * max(row_devices, 1)
    scatter = "B" in sched and pool > 1
    levels = [dict(tag=c, msgs=0.0, words=0.0) for c in sched]
    if scatter:
        t_pad = -(-t_total // pool) * pool
        s_pad = t_pad * tile_w * tile_w
        red_msgs, red_words = pool - 1, s_pad * (pool - 1) / pool
        carriers = [lv for lv in levels if lv["tag"] == "B"]
        for lv in carriers:
            lv["msgs"] += red_msgs / len(carriers)
            lv["words"] += red_words / len(carriers)
        if out == "dense":
            levels[-1]["msgs"] += pool - 1
            levels[-1]["words"] += s_pad * (pool - 1) / pool
        return levels
    s_max = _bfs_makespan(nb, devices, sched)
    stack_words = s_max * tile_w * tile_w
    d = max(row_devices, 1)
    if d > 1:
        red_msgs, red_words = 2 * (d - 1), 2 * stack_words * (d - 1) / d
        carriers = [lv for lv in levels if lv["tag"] == "D"] or levels
        for lv in carriers:
            lv["msgs"] += red_msgs / len(carriers)
            lv["words"] += red_words / len(carriers)
    res_words = t_total * tile_w * tile_w
    if out == "dense":
        res_words += (nb * tile_w) ** 2
    levels[-1]["msgs"] += pool - 1
    levels[-1]["words"] += res_words * (pool - 1) / pool
    if pool > 1:
        levels[-1]["msgs"] += pool - 1
        levels[-1]["words"] += nb * tile_w * tile_w
    return levels


def comm_seconds(machine: Machine, comm_schedule: Optional[str], nb: int, tile_w: int,
                 devices: int, row_devices: int = 1, *, out: str = "packed",
                 itemsize: int = 4) -> float:
    """Total α-β time of one interleaving: ``Σ msgs·α + Σ bytes·β``."""
    levels = comm_levels(comm_schedule, nb, tile_w, devices, row_devices, out=out,
                         itemsize=itemsize)
    msgs = sum(lv["msgs"] for lv in levels)
    words = sum(lv["words"] for lv in levels)
    return msgs * machine.alpha_s + words * itemsize * machine.beta_s_per_byte


def comm_memory_bytes(comm_schedule: Optional[str], nb: int, tile_w: int, devices: int,
                      row_devices: int = 1, *, m: int, out: str = "packed",
                      itemsize: int = 4) -> int:
    """Per-rank residency of one interleaving (the CAPS memory side): a
    ``'B'`` schedule holds the operand slab, its partial stack, the full
    ``T``-padded staging buffer and its scattered chunk (dense: the square);
    a pure-``'D'`` one the slab, the slot stack, the all-reduce's reduced
    copy and the packed result (dense: plus the square)."""
    sched = comm_schedule or "D"
    t_total = nb * (nb + 1) // 2
    d = max(row_devices, 1)
    pool = devices * d
    scatter = "B" in sched and pool > 1
    s_max = _bfs_makespan(nb, devices, sched)
    tile = tile_w * tile_w * itemsize
    operand = (m // d) * nb * tile_w * itemsize
    local_stack = s_max * tile
    if scatter:
        t_pad = -(-t_total // pool) * pool
        staging = (t_pad + 1) * tile
        chunk = (t_pad // pool) * tile
        result = chunk if out == "packed" else (nb * tile_w) ** 2 * itemsize
        return operand + local_stack + staging + result
    reduced = s_max * tile if d > 1 else 0
    result = t_total * tile
    if out == "dense":
        result += (nb * tile_w) ** 2 * itemsize
    return operand + local_stack + reduced + result


def comm_schedule_candidates(nb: int, max_levels: Optional[int] = None) -> list:
    """Interleavings the planner enumerates for one stripe grid: None (the
    all-reduce schedule) first, then every string over {'B', 'D'} of up to
    ``min(max_levels, tile-tree depth)`` characters."""
    if max_levels is None:
        max_levels = defaults.MAX_COMM_SCHEDULE_LEVELS
    depth = max(1, (nb - 1).bit_length())  # ceil(log2(nb))
    max_levels = min(max_levels, depth)
    out = [None]
    frontier = [""]
    for _ in range(max_levels):
        frontier = [s + c for s in frontier for c in ("D", "B")]
        out.extend(frontier)
    return out


def choose_comm_schedule(nb: int, tile_w: int, devices: int, row_devices: int = 1, *, m: int,
                         out: str = "packed", itemsize: int = 4,
                         machine: Optional[Machine] = None, backend: str = "cpu",
                         n: Optional[int] = None) -> Optional[str]:
    """The interleaving argmin for one (shape, mesh, memory budget): α-β
    time plus the compute imbalance of the subgroup assignment (extra tiles
    on the busiest rank, priced as launches), among the candidates within
    ``device_memory_bytes`` (else the least-memory one). With ``n``, the
    BFS candidates are priced on their own :func:`bfs_tiling` grid."""
    mach = machine or machine_for(backend)
    pool = devices * max(row_devices, 1)
    scored, overflow = [], []
    for sched in comm_schedule_candidates(nb):
        nb_s, w_s = (nb, tile_w)
        if sched and "B" in sched and pool > 1 and n is not None:
            nb_s, w_s = bfs_tiling(n, pool, devices=devices, out=out)
        secs = comm_seconds(mach, sched, nb_s, w_s, devices, row_devices, out=out,
                            itemsize=itemsize)
        t_per = -(-(nb_s * (nb_s + 1) // 2) // devices)
        secs += (_bfs_makespan(nb_s, devices, sched) - t_per) * mach.launch_overhead_s
        mem = comm_memory_bytes(sched, nb_s, w_s, devices, row_devices, m=m, out=out,
                                itemsize=itemsize)
        (scored if mem <= mach.device_memory_bytes else overflow).append((secs, mem, sched))
    if not scored:
        return min(overflow, key=lambda t: (t[1], t[0]))[2]
    return min(scored, key=lambda t: t[0])[2]


def predict_seconds(
    op: str,
    algorithm: str,
    m: int,
    n: int,
    k: int,
    n_base: int,
    *,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    packed_block: int = defaults.DEFAULT_PACKED_BLOCK,
    machine: Optional[Machine] = None,
    backend: str = "cpu",
    blocks: Optional[Tuple[int, int]] = None,
    devices: int = 1,
    nb: Optional[int] = None,
    tile_w: Optional[int] = None,
    leaf_dispatch: str = "unrolled",
    row_devices: int = 1,
    comm_schedule: Optional[str] = None,
) -> float:
    """Prediction for one candidate (module docstring).

    ``blocks``: the ``(bn, bk)`` output tile of the base engine; None is the
    machine's nominal ``xla_tile``. The combine traffic is charged on top of
    the compute/memory max, not inside it: the combination passes run
    beside the leaf products, not under them. For ``op='ata'`` over more
    than one rank the output term is the schedule's retrieval payload
    (:func:`retrieval_bytes`) on the ``nb``/``tile_w`` grid, and the α-β
    time of ``comm_schedule`` plus its compute imbalance is added.
    """
    mach = machine or machine_for(backend)
    itemsize = _ITEMSIZE.get(dtype, 4)
    b = max(batch, 1)

    mult, adds = _flop_split(op, algorithm, m, n, k, n_base)
    d_base = min(n_base, m, n, k) if algorithm != "dense" else min(m, n, k)
    compute_s = b * mult / (mach.peak_flops * mach.mxu_eff(d_base))

    bn, bk = blocks or (mach.xla_tile, mach.xla_tile)
    bn = min(bn, max(d_base, 1))
    bk = min(bk, max(d_base, 1))
    stream_bytes = (mult / 2) * (1.0 / bn + 1.0 / bk) * itemsize
    if leaf_dispatch == "fused" and algorithm != "dense":
        # the slot gather reads each root leaf block once per live slot
        # (3^L amplification) plus the six (7^L, 2^L) int32 tables
        lv = _levels(op, m, n, k, n_base)
        operand_words = (m * n + m * k) if op == "gemm_tn" else 2 * m * n
        combine_bytes = operand_words * 3.0 ** lv * itemsize + 6 * 14 ** lv * 4
        if not mach.kernels:
            # without the fused kernel the combinations materialize per leaf
            combine_bytes += mach.add_word_cost * adds * itemsize
    else:
        add_word_cost = (mach.stack_word_cost
                         if leaf_dispatch == "batched" and algorithm != "dense"
                         else mach.add_word_cost)
        combine_bytes = add_word_cost * adds * itemsize
    comm_s = 0.0
    pool = devices * max(row_devices, 1)
    if op == "ata" and pool > 1:
        if nb is None or tile_w is None:
            if comm_schedule and "B" in comm_schedule:
                nb, tile_w = bfs_tiling(n, pool, devices=devices, out=out)
            else:
                nb, tile_w = distributed_tiling(n, devices, out=out, packed_block=packed_block)
        out_bytes = retrieval_bytes(out, nb, tile_w, itemsize)
        comm_s = comm_seconds(mach, comm_schedule, nb, tile_w, devices, row_devices, out=out,
                              itemsize=itemsize)
        t_per = -(-(nb * (nb + 1) // 2) // devices)
        comm_s += (_bfs_makespan(nb, devices, comm_schedule) - t_per) * mach.launch_overhead_s
    else:
        out_bytes = _output_bytes(op, out, n, k, packed_block, itemsize)
    memory_s = b * (stream_bytes + out_bytes) / mach.hbm_bw
    combine_s = b * combine_bytes / mach.hbm_bw
    overhead_s = (dispatch_calls(op, algorithm, m, n, k, n_base, leaf_dispatch)
                  * mach.launch_overhead_s)
    return max(compute_s, memory_s) + combine_s + overhead_s + comm_s


def peak_bytes(
    op: str,
    algorithm: str,
    m: int,
    n: int,
    k: int,
    n_base: int,
    leaf_dispatch: str = "unrolled",
    *,
    batch: int = 0,
    dtype: str = "float32",
    kernels: bool = True,
) -> int:
    """Device bytes one candidate holds at once: an estimate, read by the
    memory filter of :func:`candidates`.

    Every candidate holds its operands, their root-padded copy where a
    dim is not a multiple of ``2^L``, and the output (products and outputs
    in float32, float64 for float64). On top:

    * ``'unrolled'``: half the operands and four outputs more (along one
      path of the recursion, each level holds a quadrant sum of each
      operand, and up to seven quarter-size products, their four
      combinations and the joined output: 1 + 1/4 + 1/16 + … of three
      outputs);
    * ``'batched'``: both leaf operand stacks twice (ATA: each level's
      stack and their concatenation; TN: the last encode's input and
      output), and the product stack three times, as in ``'fused'``;
    * ``'fused'``: the product stack three times (a decode holds its
      input, the four quadrant sums, the two concatenated halves and
      its output: 1 + 3·4/7 of the stack); without the fused kernels
      (``kernels=False``) ATA also combines level 1's leaf operands from
      slices, one pair per leaf;
    * ATA's level-synchronous dispatches: the diagonal slab copy and its
      ``4^L`` syrk products.

    A ``'dense'`` algorithm, or a cutoff at or above the operand, holds
    only the first line.
    """
    it = _ITEMSIZE.get(dtype, 4)
    ot = max(it, 4)
    b = max(batch, 1)
    L = 0 if algorithm == "dense" else _levels(op, m, n, k, n_base)
    R = 1 << L
    mL, nL, kL = -(-m // R), -(-n // R), -(-k // R)
    width = n + k if op == "gemm_tn" else n
    ragged = any(d % R for d in ((m, n, k) if op == "gemm_tn" else (m, n)))
    padded = R * mL * R * (nL + kL if op == "gemm_tn" else nL) if ragged else 0
    held = (m * width + padded) * it + n * k * ot
    if L == 0:
        return b * held
    if leaf_dispatch == "unrolled":
        return b * (held + (padded + m * width // 2) * it + 4 * n * k * ot)
    if op == "ata":
        leaves = sum(2 ** (2 * lev - 1) * 7 ** (L - lev) for lev in range(1, L + 1))
        stacks = 2 * leaves * mL * nL
        work = 3 * leaves * nL * nL * ot + R * R * (mL * nL * it + nL * nL * ot)
        if leaf_dispatch == "fused" and not kernels:
            work += 2 * 2 * 7 ** (L - 1) * mL * nL * it
    else:
        leaves = 7 ** L
        stacks = leaves * mL * (nL + kL)
        work = 3 * leaves * nL * kL * ot
    if leaf_dispatch == "batched":
        work += 2 * stacks * it
    return b * (held + work)


# ---------------------------------------------------------------------------
# candidate enumeration and the analytic argmin
# ---------------------------------------------------------------------------


def _kernel_blocks(machine):
    """(syrk_blocks, gemm_blocks) of a plan: the reference's choice under
    its VMEM budget (fewest output-tile re-reads, then the smaller
    footprint), kept for output geometry and plan identity."""
    vmem = 12 * 2**20
    syrk = [(bm, bn) for bm, bn in defaults.SYRK_BLOCK_CANDIDATES
            if 2 * bm * bn * 4 + bn * bn * 4 <= vmem]
    gemm = [(bm, bn, bk) for bm, bn, bk in defaults.GEMM_BLOCK_CANDIDATES
            if bm * (bn + bk) * 4 + bn * bk * 4 <= vmem]
    syrk = sorted(syrk or [defaults.SYRK_BLOCKS],
                  key=lambda b: (2.0 / b[1], 2 * b[0] * b[1] + b[1] * b[1]))
    gemm = sorted(gemm or [defaults.GEMM_BLOCKS],
                  key=lambda b: (1.0 / b[1] + 1.0 / b[2], b[0] * (b[1] + b[2]) + b[1] * b[2]))
    return syrk[0], gemm[0]


def _base_tile(mach):
    """The ``(bn, bk)`` output tile that prices operand streaming: the CUDA
    engine's own tile where the kernels run (they choose their CTA tiles,
    whatever the plan's blocks say), else the machine's nominal tile."""
    return (_KERNEL_TILE, _KERNEL_TILE) if mach.kernels else None


def candidates(
    op: str,
    m: int,
    n: int,
    k: Optional[int] = None,
    *,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    backend: str = "cpu",
    devices: int = 1,
    row_devices: int = 1,
) -> list:
    """Scored candidate Plans, best predicted first.

    The algorithm/n_base order is scored with ``out='dense'`` (packed stays
    bitwise equal to dense); each plan then carries the requested ``out``
    and its prediction. ``op='solve'`` (``k`` = RHS count) scores the two
    solver methods. 'fused' is offered with the classical variant only.
    On a machine with ``budget_single_device``, single-device candidates
    whose :func:`peak_bytes` exceed ``device_memory_bytes`` are dropped
    (the reference's single-device planner has no budget; the cpu machine
    applies none either).

    Over more than one rank (``devices`` task ranks × ``row_devices``) each
    algorithm entry expands into one plan per interleaving
    (``comm_schedule``) whose residency fits the budget, ranked within the
    entry by prediction; BFS interleavings carry their own
    :func:`bfs_tiling` grid with ``packed_block = tile_w``.
    """
    k = n if k is None else k
    if op == "solve":
        return _solve_candidates(m, n, k, batch=batch, dtype=dtype, out=out, backend=backend)
    mach = machine_for(backend)
    syrk_bs, gemm_bs = _kernel_blocks(mach)
    base_tile = _base_tile(mach)
    itemsize = _ITEMSIZE.get(dtype, 4)

    nb, tile_w = (None, None)
    comm_scheds = [None]
    sched_tiling = {}
    pool = devices * max(row_devices, 1)
    if devices > 1:
        nb, tile_w = distributed_tiling(n, devices, out=out,
                                        packed_block=defaults.DEFAULT_PACKED_BLOCK)
    if op == "ata" and pool > 1:
        # BFS strings run (and are priced) on their pool-divisible grid; a
        # pure row-sharded mesh (devices == 1) enumerates None and the BFS
        # strings only, since a pure-'D' string has no task axis to split
        nb_b, w_b = bfs_tiling(n, pool, devices=devices, out=out)
        for cs in comm_schedule_candidates(nb if nb is not None else nb_b):
            bfs = bool(cs) and "B" in cs
            if devices == 1 and cs is not None and not bfs:
                continue
            sched_tiling[cs] = (nb_b, w_b) if bfs else (nb, tile_w)
        comm_scheds = [
            cs for cs, (nb_s, w_s) in sched_tiling.items()
            if nb_s is None or comm_memory_bytes(cs, nb_s, w_s, devices, row_devices, m=m,
                                                 out=out, itemsize=itemsize)
            <= mach.device_memory_bytes
        ] or [choose_comm_schedule(nb_b, w_b, devices, row_devices, m=m, out=out,
                                   itemsize=itemsize, machine=mach, n=n)]

    n_bases = sorted({min(nb_c, max(m, n, k)) for nb_c in defaults.N_BASE_CANDIDATES})
    scored = []
    seen_degenerate = False
    for algo in ("dense", "strassen", "winograd"):
        for n_base in n_bases if algo != "dense" else [defaults.DEFAULT_N_BASE]:
            lds = defaults.LEAF_DISPATCH_CANDIDATES
            if algo != "strassen":
                # the fused slot tables hold the classical combinations only
                lds = tuple(ld for ld in lds if ld != "fused")
            if algo == "dense":
                lds = ("unrolled",)
            elif min(m, n, k) <= n_base:
                # the recursion bottoms out at once: every such cutoff and
                # dispatch is the same call; keep one representative
                if seen_degenerate:
                    continue
                seen_degenerate = True
                lds = ("unrolled",)
            for ld in lds:
                pred = predict_seconds(op, algo, m, n, k, n_base, batch=batch, dtype=dtype,
                                       out="dense", machine=mach, blocks=base_tile,
                                       leaf_dispatch=ld)
                peak = peak_bytes(op, algo, m, n, k, n_base, ld, batch=batch, dtype=dtype,
                                  kernels=mach.kernels)
                scored.append((pred, algo, n_base, ld, peak))
    if mach.budget_single_device and pool == 1:
        # a candidate the card cannot hold is no candidate; if none fits,
        # the one that holds least
        fits = [s for s in scored if s[4] <= mach.device_memory_bytes]
        scored = fits or [min(scored, key=lambda s: s[4])]
    scored.sort(key=lambda s: s[0])

    plans = []
    for _, algo, n_base, ld, _ in scored:
        variants = []
        for cs in comm_scheds:
            nb_s, w_s = sched_tiling.get(cs, (nb, tile_w))
            # a BFS plan's stripe is its packed block: the scattered chunks
            # are packed storage as they stand
            pb = (w_s if cs and "B" in cs and w_s is not None
                  else defaults.DEFAULT_PACKED_BLOCK)
            pred_out = predict_seconds(op, algo, m, n, k, n_base, batch=batch, dtype=dtype,
                                       out=out, machine=mach, blocks=base_tile,
                                       devices=devices, nb=nb_s, tile_w=w_s, leaf_dispatch=ld,
                                       row_devices=row_devices, comm_schedule=cs)
            variants.append(Plan(
                op=op, m=m, n=n, k=k, batch=batch, dtype=dtype, backend=backend, out=out,
                algorithm=algo, n_base=n_base, packed_block=pb, use_kernels=mach.kernels,
                syrk_blocks=syrk_bs, gemm_blocks=gemm_bs, leaf_dispatch=ld,
                devices=devices, nb=nb_s, tile_w=w_s, row_devices=row_devices,
                comm_schedule=cs, source="analytic", predicted_s=pred_out))
        # the α-β term does not depend on the algorithm, so interleavings
        # rank within each entry and the algorithm order stays out-invariant
        variants.sort(key=lambda p: p.predicted_s)
        plans.extend(variants)
    return plans


def _solve_candidates(m, n, r, *, batch=0, dtype="float32", out="packed", backend="cpu") -> list:
    """Scored op='solve' candidates: the factor pipeline with the best
    packed-gram candidate's tunables, and CG with the best TN-product
    candidate's."""
    if batch:
        raise ValueError(f"op='solve' plans are unbatched (lstsq is 2-D); got batch={batch}")
    mach = machine_for(backend)
    syrk_bs, gemm_bs = _kernel_blocks(mach)
    base_tile = _base_tile(mach)
    common = dict(op="solve", m=m, n=n, k=r, batch=batch, dtype=dtype, backend=backend, out=out,
                  packed_block=defaults.DEFAULT_PACKED_BLOCK, use_kernels=mach.kernels,
                  syrk_blocks=syrk_bs, gemm_blocks=gemm_bs, source="analytic")
    gram = candidates("ata", m, n, batch=batch, dtype=dtype, out="packed", backend=backend)[0]
    gemm = candidates("gemm_tn", m, n, r, batch=batch, dtype=dtype, out="dense",
                      backend=backend)[0]
    plans = []
    for method, donor in (("factor", gram), ("cg", gemm)):
        pred = _solve_predict(method, donor.algorithm, m, n, r, donor.n_base, dtype=dtype,
                              packed_block=donor.packed_block, machine=mach, blocks=base_tile,
                              leaf_dispatch=donor.leaf_dispatch)
        plans.append(Plan(algorithm=donor.algorithm, n_base=donor.n_base,
                          leaf_dispatch=donor.leaf_dispatch, method=method, predicted_s=pred,
                          **common))
    plans.sort(key=lambda p: p.predicted_s)
    return plans


def analytic_plan(op, m, n, k=None, **kw) -> Plan:
    """The analytic argmin: what ``repro_torch.tune.plan`` returns on a
    cache miss."""
    return candidates(op, m, n, k, **kw)[0]


def default_plan(
    op: str,
    m: int,
    n: int,
    k: Optional[int] = None,
    *,
    batch: int = 0,
    dtype: str = "float32",
    out: str = "dense",
    backend: str = "cpu",
    devices: int = 1,
    row_devices: int = 1,
) -> Plan:
    """The static defaults as a Plan: the baseline the autotuner times
    every candidate against. Over several task ranks it carries
    :func:`distributed_tiling`'s grid and ``comm_schedule=None`` (the plain
    all-reduce schedule)."""
    k = n if k is None else k
    mach = machine_for(backend)
    nb, tile_w = (None, None)
    if devices > 1:
        nb, tile_w = distributed_tiling(n, devices, out=out,
                                        packed_block=defaults.DEFAULT_PACKED_BLOCK)
    return Plan(
        op=op, m=m, n=n, k=k, batch=batch, dtype=dtype, backend=backend, out=out,
        algorithm=defaults.DEFAULT_VARIANT, n_base=defaults.DEFAULT_N_BASE,
        packed_block=defaults.DEFAULT_PACKED_BLOCK, use_kernels=mach.kernels,
        syrk_blocks=defaults.SYRK_BLOCKS, gemm_blocks=defaults.GEMM_BLOCKS,
        leaf_dispatch=defaults.DEFAULT_LEAF_DISPATCH,
        method=defaults.DEFAULT_SOLVE_METHOD if op == "solve" else None,
        devices=devices, nb=nb, tile_w=tile_w, row_devices=row_devices, source="default")


# ---------------------------------------------------------------------------
# distributed branch: the lower-triangle stripe grids
# ---------------------------------------------------------------------------


def _strassen_depth(w: int, n_base: int) -> int:
    """Levels the leaf recursion splits a ``w``-wide stripe (ceil halving)."""
    d = 0
    while w > n_base:
        w -= w // 2
        d += 1
    return d


def distributed_tiling(
    n: int,
    p: int,
    target_tiles_per_dev: Optional[int] = None,
    *,
    out: str = "dense",
    packed_block: Optional[int] = None,
    n_base: Optional[int] = None,
):
    """``(nb, w)``: stripe count and stripe width (a multiple of 8) of the
    contiguous lower-triangle schedule of ``ata_tile_parallel``.

    Wants ``T = nb(nb+1)/2 ≥ p`` tasks, small ``T mod p`` (balance) and
    wide stripes. Ranked by balance (``waste·w²``), then leaf Strassen depth
    of a stripe (``n_base`` defaults to the static cutoff), then, for
    ``out='packed'``, alignment with the packed block grid (``w ==
    default_block_size(n, packed_block)``: retrieval is then a slice, and
    the aligned count ``⌈n/bn⌉`` joins the candidates), then width.
    """
    from repro_torch.core.symmetric import default_block_size

    if target_tiles_per_dev is None:
        target_tiles_per_dev = defaults.TARGET_TILES_PER_DEVICE
    if n_base is None:
        n_base = defaults.DEFAULT_N_BASE
    bn_pack = None
    if out == "packed":
        bn_pack = default_block_size(n, packed_block or defaults.DEFAULT_PACKED_BLOCK)

    nb_min = max(1, math.ceil((math.sqrt(8 * p + 1) - 1) / 2))
    cand = list(range(nb_min, 4 * nb_min + 8))
    if bn_pack is not None:
        nb_aligned = -(-n // bn_pack)
        if nb_aligned >= nb_min and nb_aligned not in cand:
            cand.append(nb_aligned)
    best = None
    for nb in cand:
        t = nb * (nb + 1) // 2
        if t < p:
            continue
        per = -(-t // p)
        waste = per * p - t
        w = -(-n // nb)
        w = -(-w // 8) * 8
        misaligned = 1 if (bn_pack is not None and w != bn_pack) else 0
        score = (waste * w * w, -_strassen_depth(w, n_base), misaligned, -w)
        if best is None or score < best[0]:
            best = (score, nb, w)
        if t >= target_tiles_per_dev * p and waste == 0 and not misaligned:
            break
    _, nb, w = best
    return nb, w


def bfs_tiling(
    n: int,
    pool: int,
    *,
    devices: Optional[int] = None,
    out: str = "packed",
    packed_block: Optional[int] = None,
    n_base: Optional[int] = None,
):
    """``(nb, w)`` for the BFS tri-direct reduce-scatter schedule: ``T =
    nb(nb+1)/2`` divisible by the merged ``pool``, so the scatter deals
    exact ``T/pool``-tile chunks and retrieval is a slice. Among those,
    ranked by the single-``'B'`` assignment's makespan excess over
    ``ceil(T/devices)`` (with ``devices`` given, weighted ``w²``), leaf
    Strassen depth, packed-grid alignment (``w == default_block_size(n,
    w)``), width, then ``nb``. ``nb = 2·pool−1`` always qualifies.
    """
    from repro_torch.core.symmetric import default_block_size

    if pool <= 1:
        return distributed_tiling(n, pool, out=out, packed_block=packed_block)
    if n_base is None:
        n_base = defaults.DEFAULT_N_BASE
    nb_min = max(1, math.ceil((math.sqrt(8 * pool + 1) - 1) / 2))
    best = None
    for nb in range(nb_min, nb_min + 2 * pool + 8):
        t = nb * (nb + 1) // 2
        if t < pool or t % pool:
            continue
        w = -(-n // nb)
        w = -(-w // 8) * 8
        grid = default_block_size(n, packed_block or w)
        misaligned = 1 if w != grid else 0
        extra = 0
        if devices is not None and devices > 1:
            extra = _bfs_makespan(nb, devices, "B") - (-(-t // devices))
        score = (extra * w * w, -_strassen_depth(w, n_base), misaligned, -w, nb)
        if best is None or score < best[0]:
            best = (score, nb, w)
    _, nb, w = best
    return nb, w
