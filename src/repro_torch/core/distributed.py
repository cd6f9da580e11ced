"""Distributed schedules of the ``AᵀA`` product on ``torch.distributed``
(port of ``repro.core.distributed``; paper §4.2–4.3).

The paper's parallel insight: schedule the symmetric product as disjoint,
α-balanced tasks over the lower triangle of C (ranks never collide on
writes), and retrieve only packed lower-triangular payloads. The reference
runs each schedule as one ``shard_map`` program over a mesh; the port runs
one process per rank, each calling the same function on its own view of
the operands with a :class:`repro_torch.launch.mesh.Mesh`:

* :func:`gram_rowshard` — A row-sharded: local ATA, then one
  ``all_reduce`` of the packed block stack (``T·bn² ≈ n²/2`` words) or of
  the dense square.
* :func:`ata_tile_parallel` — C's lower triangle in ``nb(nb+1)/2``
  uniform ``w×w`` tiles dealt contiguously over the task axis; each rank
  computes its tiles with ``strassen_tn`` at leaf level (any leaf
  dispatch), sums row-axis partials with one ``all_reduce`` of the tile
  stack, and ``all_gather``-s the packed tile stacks of the task axis (the
  reference's ``out_specs`` concatenation, made explicit: the paper's
  packed low(C) retrieval).
* :func:`ata_bfs_dfs` — the CAPS-style BFS/DFS schedule: a static slot
  table from :func:`bfs_dfs_assignment`, and with any ``'B'`` level the
  tri-direct exchange (one ``reduce_scatter_tensor`` over the merged
  ``(task, row)`` pool, local diagonal symmetrization, one gather).
* :func:`gemm_tn_colshard` — ``AᵀB`` with B column-sharded: each rank's
  stripe by ``strassen_tn``, ``all_reduce`` over the row axis, gathered
  over the task axis.

Every rank gets back what the reference's global output holds (the
replicated ``(n, n)`` array or :class:`SymmetricMatrix`; colshard's full
``(n, k)`` product). Each rank's CUDA tensors run the hand kernels
(``repro_torch.kernels``), CPU tensors their plain versions; the
collectives (``repro_torch.launch.collectives``) run outside any kernel
and count their bytes. Spans and counters carry the reference's names.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.backend import planner_key
from repro_torch.core.ata import ata
from repro_torch.core.strassen import strassen_tn
from repro_torch.core.symmetric import SymmetricMatrix, sym_tile
from repro_torch.launch import collectives
from repro_torch.launch.mesh import Mesh, merged_axis

__all__ = [
    "gram_rowshard",
    "ata_tile_parallel",
    "ata_bfs_dfs",
    "bfs_dfs_assignment",
    "gemm_tn_colshard",
    "choose_tiling",
    "tile_parallel_device_flops",
]


def _group(axis, mesh: Optional[Mesh]):
    """The process group ``axis`` names: a mesh axis name (or a tuple of
    names, merged) looked up on ``mesh``, else a ``ProcessGroup`` itself
    (None: one rank)."""
    if isinstance(axis, (str, tuple)):
        if mesh is None:
            raise ValueError(f"axis {axis!r} names a mesh axis: pass mesh=")
        return mesh.group(axis)
    return axis


def _label(axis) -> str:
    return str(axis) if isinstance(axis, (str, tuple)) else "group"


def _dense_tn(a, b, acc_dtype, plan=None):
    """One classical ``AᵀB`` on the plan's base engine (the gemm_tn kernel
    on a CUDA tensor, its plain version on the CPU)."""
    from repro_torch.tune.apply import engine

    return engine(plan, a.dtype, b.dtype, acc_dtype).gemm_tn(a, b, out_dtype=acc_dtype)


# ---------------------------------------------------------------------------
# rowshard: C = Σ_p A_pᵀ A_p
# ---------------------------------------------------------------------------


def gram_rowshard(
    a_local: torch.Tensor,
    axis,
    *,
    mesh: Optional[Mesh] = None,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    use_ata: Optional[bool] = None,
    out: str = "dense",
    packed_block: Optional[int] = None,
) -> Union[torch.Tensor, SymmetricMatrix]:
    """Per-rank gram + all-reduce: ``a_local`` is this rank's row block,
    the result the full ``AᵀA`` on every rank of the group.

    ``axis``: a ``ProcessGroup`` (the ranks that hold the row blocks), or a
    mesh axis name (or tuple of names) together with ``mesh=``. The local
    product is ``ata`` (planned on the local shape unless pinned, any leaf
    dispatch); ``use_ata=False``, or a plan whose algorithm is ``'dense'``,
    takes one classical product. ``out='packed'`` keeps low(C) across the
    reduce: the all-reduce moves the packed ``(T, bn, bn)`` block stack
    (``≈ n²/2`` words, not ``n²``) and every rank gets a
    :class:`SymmetricMatrix`.
    """
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")
    if use_ata is None:
        use_ata = plan is None or plan.algorithm != "dense"
    group = _group(axis, mesh)
    obs.metrics.inc("dispatch.gram_rowshard")
    with obs.span("distributed.gram_rowshard", out=out, use_ata=use_ata):
        if use_ata:
            local = ata(a_local, plan=plan, n_base=n_base, variant=variant,
                        leaf_dispatch=leaf_dispatch, out=out, packed_block=packed_block)
        else:
            local = _dense_tn(a_local, a_local, torch.float32, plan)
            if out == "packed":
                if packed_block is None:
                    from repro_torch.tune.defaults import DEFAULT_PACKED_BLOCK

                    packed_block = plan.packed_block if plan is not None else DEFAULT_PACKED_BLOCK
                local = SymmetricMatrix.from_dense(local, packed_block)
        with obs.span("distributed.psum", axis=_label(axis), out=out):
            if out == "packed":
                return SymmetricMatrix(collectives.all_reduce(local.blocks, group),
                                       local.n, local.bn)
            return collectives.all_reduce(local, group)


# ---------------------------------------------------------------------------
# tile-parallel: contiguous lower-triangle tiles over a mesh axis
# ---------------------------------------------------------------------------


def choose_tiling(
    n: int,
    p: int,
    target_tiles_per_dev: Optional[int] = None,
    *,
    out: str = "dense",
    packed_block: Optional[int] = None,
) -> tuple[int, int]:
    """``(nb, w)``: stripe count and width (a multiple of 8) — the
    planner's :func:`repro_torch.tune.cost.distributed_tiling`, under the
    name the schedules use. ``out='packed'`` lets the width snap to the
    packed block grid (retrieval is then a slice)."""
    from repro_torch.tune.cost import distributed_tiling

    return distributed_tiling(n, p, target_tiles_per_dev, out=out, packed_block=packed_block)


def _tri_coords(t: int) -> tuple[int, int]:
    """Block ``(i, j)``, ``j ≤ i``, of tri-order tile ``t = i(i+1)/2 + j``."""
    i = (math.isqrt(8 * t + 1) - 1) // 2
    return i, t - i * (i + 1) // 2


def _resolve(plan, n_base, variant, leaf_dispatch, packed_block, use_strassen):
    """Leaf tunables from a plan, where the caller left them unset."""
    if plan is not None:
        n_base = plan.n_base if n_base is None else n_base
        variant = plan.variant if variant is None else variant
        if leaf_dispatch is None:
            leaf_dispatch = plan.leaf_dispatch
        if packed_block is None:
            packed_block = plan.packed_block
        if plan.algorithm == "dense":
            use_strassen = False
    return n_base, variant, leaf_dispatch, packed_block, use_strassen


def _stripe_width(n: int, nb: int) -> int:
    w = -(-n // nb)
    return -(-w // 8) * 8


class _TileBody:
    """The tile products of one rank: tile ``t`` is ``A[:, i]ᵀ·A[:, j]``
    over stripes ``i, j`` of width ``w`` (``strassen_tn`` at leaf level,
    or one classical product), and a dummy slot is a zero tile that is
    never computed."""

    def __init__(self, a, w, *, use_strassen, n_base, variant, leaf_dispatch, acc_dtype):
        self.a, self.w = a, w
        self.use_strassen, self.acc_dtype = use_strassen, acc_dtype
        self.n_base, self.variant, self.leaf_dispatch = n_base, variant, leaf_dispatch

    def tile(self, t: int) -> torch.Tensor:
        i, j = _tri_coords(t)
        w = self.w
        ai, aj = self.a[:, i * w:(i + 1) * w], self.a[:, j * w:(j + 1) * w]
        if self.use_strassen:
            return strassen_tn(ai, aj, n_base=self.n_base, variant=self.variant,
                               leaf_dispatch=self.leaf_dispatch, acc_dtype=self.acc_dtype)
        return _dense_tn(ai, aj, self.acc_dtype)

    def stack(self, ids) -> torch.Tensor:
        """Tiles ``ids`` as one ``(len(ids), w, w)`` stack; ``-1`` is a
        dummy slot (zeros of the accumulation dtype)."""
        w = self.w
        out = torch.zeros((len(ids), w, w), dtype=self.acc_dtype, device=self.a.device)
        for q, t in enumerate(ids):
            if t >= 0:
                out[q] = self.tile(t)
        return out


def ata_tile_parallel(
    a: torch.Tensor,
    mesh: Mesh,
    *,
    task_axis: str = "model",
    row_axis: Optional[str] = None,
    alpha: float = 1.0,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    use_strassen: bool = True,
    nb: Optional[int] = None,
    out: str = "dense",
    packed_block: Optional[int] = None,
    acc_dtype=torch.float32,
) -> Union[torch.Tensor, SymmetricMatrix]:
    """Distributed ``C = alpha·AᵀA`` with disjoint lower-triangle tile tasks.

    Call contract: every rank of ``mesh`` calls it with its view of ``A``:
    the whole ``(m, n)`` operand, or with ``row_axis`` its ``(m/d, n)`` row
    block (the reference's ``P(row_axis, None)``; ``Mesh.local_block``
    cuts it). ``task_axis`` owns disjoint tiles: task rank ``p`` computes
    the tri-order tiles ``[p·t_per, (p+1)·t_per)`` (dummy slots past ``T``
    are zero tiles, never computed); row-axis partials are summed by one
    ``all_reduce`` of the ``(t_per, w, w)`` tile stack, and the stacks are
    ``all_gather``-ed over the task axis — the packed retrieval, ``T·w²``
    words. Tiling: ``nb``, else the plan's (when it was made for this
    ``n`` and task-axis size), else :func:`choose_tiling`.

    Return contract: every rank gets ``alpha·AᵀA``: a :class:`SymmetricMatrix`
    built from the gathered stack (a slice where ``w`` is the packed block
    size) for ``out='packed'``, its ``to_dense()`` for ``'dense'``.

    Tunables: ``plan`` (default: ``repro_torch.tune.plan`` with
    ``devices`` = the task-axis size, unless ``n_base``, ``variant`` or
    ``nb`` is pinned) feeds ``n_base``/``variant``/``leaf_dispatch`` to
    every tile's ``strassen_tn`` (any leaf dispatch; the values do not
    depend on it); ``use_strassen=False`` or a ``'dense'`` plan takes one
    classical product a tile. ``acc_dtype``: the tiles' accumulation dtype,
    the dummy tiles' too. ``alpha`` scales the packed blocks
    (``SymmetricMatrix.scale``) in both modes.
    """
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")
    m_local, n = a.shape
    p_task = mesh.axis_size(task_axis)
    p_row = mesh.axis_size(row_axis) if row_axis is not None else 1
    m = m_local * p_row
    backend, dtype = planner_key(a)
    if plan is None and n_base is None and variant is None and nb is None:
        from repro_torch.tune import plan as _plan_fn

        plan = _plan_fn(op="ata", m=m, n=n, dtype=dtype, devices=p_task, out=out,
                        backend=backend)
    n_base, variant, leaf_dispatch, packed_block, use_strassen = _resolve(
        plan, n_base, variant, leaf_dispatch, packed_block, use_strassen)
    w = None
    # adopt the plan's grid only if it was made for THIS problem: another
    # width's grid would cover the wrong columns
    if plan is not None and nb is None and plan.devices == p_task and plan.n == n and plan.nb:
        nb, w = plan.nb, plan.tile_w
    if nb is None:
        nb, w = choose_tiling(n, p_task, out=out, packed_block=packed_block)
    elif w is None:
        w = _stripe_width(n, nb)
    n_pad = nb * w
    t_total = nb * (nb + 1) // 2
    t_per = -(-t_total // p_task)
    if n_pad > n:
        a = F.pad(a, (0, n_pad - n))

    obs.metrics.inc("dispatch.ata_tile_parallel")
    obs.metrics.inc("ata_tile_parallel.tiles", t_total)
    body = _TileBody(a, w, use_strassen=use_strassen, n_base=n_base, variant=variant,
                     leaf_dispatch=leaf_dispatch, acc_dtype=acc_dtype)
    p = mesh.axis_index(task_axis)
    ids = [g if g < t_total else -1 for g in range(p * t_per, (p + 1) * t_per)]
    with obs.span("distributed.tile_body", t_per=t_per, w=w):
        tiles = body.stack(ids)
    tiles = _reduce_gather(tiles, mesh, task_axis, row_axis)
    return _finish(tiles, n, nb, packed_block, alpha, out, presymmetrized=False)


def _reduce_gather(tiles, mesh, task_axis, row_axis):
    """The all-reduce schedule's exchange: the row partials of the slot
    stack summed (the packed stack, not a dense square), then the task
    ranks' stacks gathered in task order."""
    if row_axis is not None:
        with obs.span("distributed.psum", axis=row_axis, out="packed"):
            tiles = collectives.all_reduce(tiles, mesh.group(row_axis))
    with obs.span("distributed.gather", axis=task_axis, out="packed"):
        return collectives.all_gather(tiles, mesh.group(task_axis))


def _finish(tiles, n, nb, packed_block, alpha, out, *, presymmetrized):
    """The gathered tri-order stack as the caller's output."""
    sym = SymmetricMatrix.from_tile_stack(tiles, n, nb=nb, packed_block=packed_block,
                                          presymmetrized=presymmetrized)
    if alpha != 1.0:
        sym = sym.scale(alpha)
    return sym if out == "packed" else sym.to_dense()


# ---------------------------------------------------------------------------
# CAPS-style BFS/DFS schedule (paper §5 / Prop. 4.2 × CAPS, arxiv 1202.3173)
# ---------------------------------------------------------------------------


def _region_tiles(region) -> list:
    """Stripe-index (i, j) tiles of one schedule region (lower triangle)."""
    if region[0] == "tri":
        _, lo, hi = region
        return [(i, j) for i in range(lo, hi) for j in range(lo, i + 1)]
    _, rlo, rhi, clo, chi = region
    return [(i, j) for i in range(rlo, rhi) for j in range(clo, chi)]


def _region_children(region):
    """One recursion level of the ATA tree in tile space, or None at a leaf:
    a triangle splits into ``C11`` (triangle, ceil-half), ``C21`` (the
    off-diagonal rectangle) and ``C22`` (triangle); a rectangle splits
    2×2."""
    if region[0] == "tri":
        _, lo, hi = region
        if hi - lo < 2:
            return None
        mid = lo + (hi - lo + 1) // 2
        return [("tri", lo, mid), ("rect", mid, hi, lo, mid), ("tri", mid, hi)]
    _, rlo, rhi, clo, chi = region
    if rhi - rlo < 2 and chi - clo < 2:
        return None
    rows = [(rlo, rhi)] if rhi - rlo < 2 else [
        (rlo, rlo + (rhi - rlo + 1) // 2), (rlo + (rhi - rlo + 1) // 2, rhi)]
    cols = [(clo, chi)] if chi - clo < 2 else [
        (clo, clo + (chi - clo + 1) // 2), (clo + (chi - clo + 1) // 2, chi)]
    return [("rect", a, b, c, d) for a, b in rows for c, d in cols]


def bfs_dfs_assignment(nb: int, pool: int, interleaving: str, *, emit_spans: bool = False):
    """Static BFS/DFS tile ownership over a ``pool``-rank task axis.

    ``interleaving`` is a string over ``{'B', 'D'}``; character ℓ tags
    level ℓ of the ATA tree in tile space (level 0 splits the ``nb``-stripe
    lower triangle). A ``'B'`` level splits every group of two or more
    ranks into disjoint subgroups, one per child subproblem, with ranks
    allotted in proportion to child tile counts (largest remainder, every
    nonempty child at least one rank while they last; with fewer ranks
    than children, children are LPT-packed onto the ranks). A ``'D'``
    level keeps each group whole. After the last character each group's
    tiles are dealt contiguously (tri order) to its ranks, so a pure-``'D'``
    string gives :func:`ata_tile_parallel`'s split exactly.

    Returns ``(owned, levels)``: ``owned[r]`` the sorted tri-order tile ids
    rank ``r`` computes, ``levels`` one ``{'tag', 'groups'}`` dict a
    character (with ``emit_spans`` each level runs inside a
    ``distributed.bfs`` / ``distributed.dfs`` span).
    """
    if not interleaving or any(c not in "BD" for c in interleaving):
        raise ValueError(
            f"interleaving must be a non-empty string over {{'B','D'}}; got {interleaving!r}")
    groups = [([("tri", 0, nb)], list(range(pool)))]
    levels = []

    def split_level() -> None:
        nonlocal groups
        new_groups = []
        for regions, devs in groups:
            if len(devs) < 2:
                new_groups.append((regions, devs))
                continue
            kids = []
            for r in regions:
                ch = _region_children(r)
                kids.extend(ch if ch else [r])
            kids = [(k, len(_region_tiles(k))) for k in kids]
            kids = [(k, c) for k, c in kids if c]
            if len(kids) < 2:
                new_groups.append(([k for k, _ in kids], devs))
                continue
            g = len(devs)
            if g >= len(kids):
                total = sum(c for _, c in kids)
                quota = [c * g / total for _, c in kids]
                alloc = [max(1, int(q)) for q in quota]
                while sum(alloc) > g:
                    over = [i for i in range(len(alloc)) if alloc[i] > 1]
                    i = max(over, key=lambda i: alloc[i] - quota[i])
                    alloc[i] -= 1
                while sum(alloc) < g:
                    i = min(range(len(alloc)), key=lambda i: (alloc[i] - quota[i], -quota[i]))
                    alloc[i] += 1
                pos = 0
                for (k, _), a in zip(kids, alloc):
                    new_groups.append(([k], devs[pos:pos + a]))
                    pos += a
            else:
                buckets = [[[], 0] for _ in range(g)]
                for k, c in sorted(kids, key=lambda kc: -kc[1]):
                    b = min(buckets, key=lambda b: b[1])
                    b[0].append(k)
                    b[1] += c
                new_groups.extend((regs, [dev]) for (regs, _), dev in zip(buckets, devs))
        groups = new_groups

    for lv, ch in enumerate(interleaving):
        if ch == "B":
            if emit_spans:
                with obs.span("distributed.bfs", level=lv):
                    split_level()
            else:
                split_level()
        elif emit_spans:
            with obs.span("distributed.dfs", level=lv, groups=len(groups)):
                pass
        levels.append(dict(tag=ch, groups=len(groups)))

    owned = [[] for _ in range(pool)]
    for regions, devs in groups:
        ts = sorted(i * (i + 1) // 2 + j for r in regions for i, j in _region_tiles(r))
        per = -(-len(ts) // len(devs))
        for idx, dev in enumerate(devs):
            owned[dev] = ts[idx * per:(idx + 1) * per]
    return owned, levels


def ata_bfs_dfs(
    a: torch.Tensor,
    mesh: Mesh,
    *,
    task_axis: str = "model",
    row_axis: Optional[str] = None,
    interleaving: Optional[str] = None,
    alpha: float = 1.0,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    use_strassen: bool = True,
    nb: Optional[int] = None,
    out: str = "dense",
    packed_block: Optional[int] = None,
    acc_dtype=torch.float32,
) -> Union[torch.Tensor, SymmetricMatrix]:
    """Distributed ``C = alpha·AᵀA`` under a CAPS-style BFS/DFS schedule.

    Each level of the lower-triangle tile tree is tagged BFS (``'B'``) or
    DFS (``'D'``) by ``interleaving`` (contract: :func:`bfs_dfs_assignment`);
    task rank ``p`` computes the tiles ``owned[p]`` of that assignment.
    With any ``'B'`` level and more than one rank in the merged ``(task,
    row)`` pool the exchange is **tri-direct**: each rank stages its partial
    tiles at their global tri positions in a ``T_pad``-tile buffer
    (``T_pad`` = ``T`` rounded up to the pool), ONE ``reduce_scatter_tensor``
    over the merged pool sums the row partials and deals rank ``k`` (task
    major: ``k = task·d + row``) the tri-order chunk ``[k·T_pad/P,
    (k+1)·T_pad/P)``, the rank symmetrizes the diagonal tiles of its chunk,
    and one ``all_gather`` of the chunks retrieves the packed stack
    (``from_tile_stack(presymmetrized=True)``). A pure-``'D'`` string runs
    :func:`ata_tile_parallel`'s program (same assignment, same all-reduce,
    same gather). Tile products and their reduction order do not depend on
    the tags (the scatter adds only zeros beside at most two row partials
    when the row axis has two ranks or one), so on one mesh every
    interleaving equals :func:`ata_tile_parallel` bitwise at the same grid.

    ``interleaving=None`` takes the plan's ``comm_schedule`` (default plan:
    ``repro_torch.tune.plan`` with ``devices``/``row_devices`` of the mesh,
    unless ``n_base``, ``variant``, ``nb`` or ``interleaving`` is pinned),
    else pure DFS. Without ``nb`` a BFS string runs on
    :func:`~repro_torch.tune.cost.bfs_tiling`'s pool-divisible grid with
    ``packed_block`` = the stripe width. Call and return contracts and the
    other arguments: as :func:`ata_tile_parallel`.
    """
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")
    m_local, n = a.shape
    p_task = mesh.axis_size(task_axis)
    d_row = mesh.axis_size(row_axis) if row_axis is not None else 1
    m = m_local * d_row
    backend, dtype = planner_key(a)
    if (plan is None and n_base is None and variant is None and nb is None
            and interleaving is None):
        from repro_torch.tune import plan as _plan_fn

        plan = _plan_fn(op="ata", m=m, n=n, dtype=dtype, devices=p_task, out=out,
                        row_devices=d_row, backend=backend)
    n_base, variant, leaf_dispatch, packed_block, use_strassen = _resolve(
        plan, n_base, variant, leaf_dispatch, packed_block, use_strassen)
    w = None
    if plan is not None:
        if interleaving is None:
            interleaving = plan.comm_schedule
        if (nb is None and plan.devices == p_task and plan.n == n and plan.nb
                and plan.row_devices == d_row):
            nb, w = plan.nb, plan.tile_w
    if interleaving is None:
        interleaving = "D"
    pool = p_task * d_row
    scatter = "B" in interleaving and pool > 1
    if nb is None:
        if scatter:
            from repro_torch.tune.cost import bfs_tiling

            nb, w = bfs_tiling(n, pool, devices=p_task, out=out, packed_block=packed_block)
            if packed_block is None:
                packed_block = w
        else:
            nb, w = choose_tiling(n, p_task, out=out, packed_block=packed_block)
    elif w is None:
        w = _stripe_width(n, nb)
    n_pad = nb * w
    t_total = nb * (nb + 1) // 2

    owned, _ = bfs_dfs_assignment(nb, p_task, interleaving, emit_spans=True)
    s_eff = max(len(o) for o in owned)
    if n_pad > n:
        a = F.pad(a, (0, n_pad - n))

    obs.metrics.inc("dispatch.ata_bfs_dfs")
    obs.metrics.inc("ata_bfs_dfs.tiles", t_total)
    obs.metrics.inc("ata_bfs_dfs.bfs_levels", interleaving.count("B"))
    obs.metrics.inc("ata_bfs_dfs.dfs_levels", interleaving.count("D"))

    body = _TileBody(a, w, use_strassen=use_strassen, n_base=n_base, variant=variant,
                     leaf_dispatch=leaf_dispatch, acc_dtype=acc_dtype)
    mine = owned[mesh.axis_index(task_axis)]
    with obs.span("distributed.tile_body", t_per=s_eff, w=w):
        tiles = body.stack(mine + [-1] * (s_eff - len(mine)))
    if not scatter:
        tiles = _reduce_gather(tiles, mesh, task_axis, row_axis)
        return _finish(tiles, n, nb, packed_block, alpha, out, presymmetrized=False)

    merged = merged_axis(task_axis, row_axis)
    group = mesh.group(merged)
    t_pad = -(-t_total // pool) * pool
    chunk = t_pad // pool
    # group position g receives scatter chunk g: put the chunk of merged
    # (task-major) index order[g] there, so rank k gets tri chunk k
    order = mesh.pool_order(merged)
    pos = list(range(pool)) if order is None else [order.index(k) for k in range(pool)]
    buf = tiles.new_zeros((t_pad, w, w))
    if mine:
        ids = torch.tensor([pos[t // chunk] * chunk + t % chunk for t in mine],
                           device=tiles.device)
        buf[ids] = tiles[:len(mine)]
    with obs.span("distributed.psum_scatter", axis=str(merged), out="packed"):
        part = collectives.reduce_scatter(buf, group)
    # the chunk's diagonal tiles, symmetrized here so retrieval need not
    k = mesh.axis_index(merged)
    diag = [t - k * chunk for t in (i * (i + 1) // 2 + i for i in range(nb))
            if k * chunk <= t < (k + 1) * chunk]
    if diag:
        part[diag] = sym_tile(part[diag])
    with obs.span("distributed.gather", axis=str(merged), out="packed"):
        stack = collectives.all_gather(part, group)
    if order is not None:
        stack = stack.view(pool, chunk, w, w)[torch.tensor(pos, device=stack.device)]
        stack = stack.reshape(t_pad, w, w)
    return _finish(stack, n, nb, packed_block, alpha, out, presymmetrized=True)


def tile_parallel_device_flops(
    m: int,
    n: int,
    p: int,
    *,
    nb: Optional[int] = None,
    n_base: Optional[int] = None,
    use_strassen: Optional[bool] = None,
    dtype: str = "float32",
    out: str = "dense",
    packed_block: Optional[int] = None,
    backend: Optional[str] = None,
) -> list:
    """Exact per-rank flops of :func:`ata_tile_parallel`: rank ``d``
    computes its valid contiguous slots only (dummy slots are zero tiles),
    so the counts sum to ``T`` tiles' worth — the LPT model of ``T`` equal
    tasks. Unpinned ``n_base``/``use_strassen`` resolve through the planner
    as the dispatch does, for ``backend`` (the operand's device type;
    None: the planner's default, the card)."""
    from repro_torch.core.reference import classical_gemm_flops, strassen_tn_flops

    if n_base is None or use_strassen is None:
        from repro_torch.tune import plan as _plan_fn

        pl = _plan_fn(op="ata", m=m, n=n, dtype=dtype, devices=p, out=out, backend=backend)
        n_base = pl.n_base if n_base is None else n_base
        use_strassen = (pl.algorithm != "dense") if use_strassen is None else use_strassen
    if nb is None:
        nb, w = choose_tiling(n, p, out=out, packed_block=packed_block)
    else:
        w = _stripe_width(n, nb)
    t_total = nb * (nb + 1) // 2
    t_per = -(-t_total // p)
    tile = strassen_tn_flops(m, w, w, n_base) if use_strassen else classical_gemm_flops(m, w, w)
    return [tile * max(0, min(t_per, t_total - d * t_per)) for d in range(p)]


# ---------------------------------------------------------------------------
# colshard gemm: C = AᵀB with B column-sharded (disjoint C column stripes)
# ---------------------------------------------------------------------------


def gemm_tn_colshard(
    a: torch.Tensor,
    b: torch.Tensor,
    mesh: Mesh,
    *,
    task_axis: str = "model",
    row_axis: Optional[str] = None,
    plan=None,
    n_base: Optional[int] = None,
    variant: Optional[str] = None,
    leaf_dispatch: Optional[str] = None,
    use_strassen: bool = True,
) -> torch.Tensor:
    """Distributed ``C = AᵀB``: each task rank owns C's column stripe of its
    B stripe — the FastStrassen leaves of the task tree, collision-free.

    Call contract: ``a`` is this rank's view of the ``(m, n)`` A (whole, or
    its row block with ``row_axis``: ``P(row_axis, None)``), ``b`` its
    ``(m/d, k/p)`` block of B (``P(row_axis, task_axis)``;
    ``Mesh.local_block`` cuts both). The stripe is ``strassen_tn`` (planned
    on the stripe's shape unless pinned, any leaf dispatch; one classical
    product with ``use_strassen=False`` or a ``'dense'`` plan), summed over
    the row axis by one ``all_reduce``.

    Return contract: every rank gets the full ``(n, k)`` product, its task
    axis's stripes ``all_gather``-ed in task order (the reference's
    ``out_specs=P(None, task_axis)``).
    """
    m, n = a.shape
    mb, _ = b.shape
    if m != mb:
        raise ValueError(f"contraction mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if plan is not None:
        n_base = plan.n_base if n_base is None else n_base
        variant = plan.variant if variant is None else variant
        if leaf_dispatch is None:
            leaf_dispatch = plan.leaf_dispatch
        if plan.algorithm == "dense":
            use_strassen = False
    obs.metrics.inc("dispatch.gemm_tn_colshard")
    with obs.span("distributed.colshard_body", use_strassen=use_strassen):
        if use_strassen:
            c_local = strassen_tn(a, b, n_base=n_base, variant=variant,
                                  leaf_dispatch=leaf_dispatch)
        else:
            c_local = _dense_tn(a, b, torch.float32)
    if row_axis is not None:
        with obs.span("distributed.psum", axis=row_axis, out="dense"):
            c_local = collectives.all_reduce(c_local, mesh.group(row_axis))
    with obs.span("distributed.gather", axis=task_axis, out="dense"):
        # gather the stripes' transposes along dim 0: the rows of the
        # (k, n) stack are C's columns in task order
        c_t = collectives.all_gather(c_local.T.contiguous(), mesh.group(task_axis))
    return c_t.T.contiguous()
