"""The port's CUDA kernels on the card: each against its plain version, the
wrappers' input checks, and the bitwise contracts that hold only where the
kernels sum in a batch-independent order.

Every test here needs an NVIDIA card and ``nvcc`` (the kernels build at
first use) and skips without one; on the card run

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ``8·√k·eps·max|ref|`` for contraction length k (float32).
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.core import ata, ata_batched, strassen_tn
from repro_torch.core.ata import _level_tables
from repro_torch.core.strassen import _pad_root, _slot_tables, _to_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.gemm_tn import (_fused_tables, combine_fused_operands,
                                         fused_launch_tables, gemm_tn_fused_plain, gemm_tn_plain,
                                         vec16)
from repro_torch.kernels.potrf import potrf_plain
from repro_torch.kernels import _build
from repro_torch.kernels.syrk import syrk_gather_plain, syrk_plain, syrk_splits
from repro_torch.kernels.trsm import trsm_plain
from repro_torch.solve import cholesky, lstsq

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(rng, shape, dev):
    return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=dev)


def _close(got, ref, k):
    err = float((got - ref).abs().max())
    tol = 8 * math.sqrt(k) * 1.19e-7 * float(ref.abs().max())
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _spd(rng, batch, n, dev):
    x = torch.as_tensor(rng.standard_normal((batch, 2 * n, n)), device=dev)
    return (x.transpose(1, 2) @ x / (2 * n) + torch.eye(n, device=dev, dtype=x.dtype)).float()


@pytest.mark.parametrize("b,m,n,k", [(1, 8, 128, 128), (3, 40, 100, 60), (2, 513, 257, 129)])
def test_gemm_tn_kernel_matches_plain(dev, b, m, n, k):
    rng = np.random.default_rng(m)
    a, c = _t(rng, (b, m, n), dev), _t(rng, (b, m, k), dev)
    got = ops.gemm_tn(a, c, alpha=-2.0)
    _close(got, gemm_tn_plain(a, c, alpha=-2.0), m)
    assert torch.equal(got[-1], ops.gemm_tn(a[-1], c[-1], alpha=-2.0))
    # a column-sliced view passes uncopied (row stride ≠ width)
    _close(ops.gemm_tn(a[0, :, 1:], c[0]), gemm_tn_plain(a[0, :, 1:], c[0]), m)


# (n, k) with k <= narrow_max_k() = 64 run the narrow-output kernel
# (csrc/tn_narrow.cu), the rest the tile engine; k = 65 is the engine's
NARROW_EDGES = ((127, 1), (1, 8), (129, 4), (4096, 8), (127, 32), (129, 33), (127, 64))


@pytest.mark.parametrize("m", [1, 7, 8, 9, 15, 17, 33, 513])
def test_gemm_tn_kernel_depths_and_ragged_edges(dev, m):
    """Contraction lengths around the depth-8 summation slabs and the
    depth-16 ring stages; n and k of 1 and one short of and one past a
    128 tile, the narrow kernel's shapes (a partial strip, one or two
    columns of B short of a pair or of 16 bytes, k at the threshold and one
    past it); a batch of 2. Within tolerance of the plain version, bitwise
    equal to gemm_tn_fused on W = 1 tables of the same operands (the same
    fmaf chain over the same depth-8 slabs), and bitwise equal to each batch
    entry launched alone."""
    rng = np.random.default_rng(m)
    for n, k in ((1, 129), (129, 127), (127, 129), (129, 65)) + NARROW_EDGES:
        a, b = _t(rng, (2, m, n), dev), _t(rng, (2, m, k), dev)
        got = ops.gemm_tn(a, b, alpha=0.75)
        _close(got, gemm_tn_plain(a, b, alpha=0.75), m)
        fused = ops.gemm_tn_fused(a[None, None, None], b[None, None, None], _slot_tables(0),
                                  alpha=0.75)
        assert torch.equal(got, fused.reshape(got.shape)), (n, k)
        assert torch.equal(got[1], ops.gemm_tn(a[1], b[1], alpha=0.75)), (n, k)


def test_gemm_tn_kernel_unaligned_views(dev):
    """A base one float past a 16-byte boundary and an odd row stride make
    the engine copy floats instead of 16-byte quads; the product is bitwise
    the one of the aligned operands."""
    rng = np.random.default_rng(11)
    m, n, k = 70, 200, 132
    a, b = _t(rng, (3, m, n), dev), _t(rng, (3, m, k), dev)
    assert vec16(a, a.stride(0), a.stride(1)) and vec16(b, b.stride(0), b.stride(1))
    want = ops.gemm_tn(a, b)
    ua = torch.empty(a.numel() + 1, device=dev)[1:].view(a.shape)
    ua.copy_(a)
    wide = torch.empty(3, m, k + 1, device=dev)[..., :k]   # row stride 133
    wide.copy_(b)
    assert not vec16(ua, ua.stride(0), ua.stride(1))
    assert not vec16(wide, wide.stride(0), wide.stride(1))
    got = ops.gemm_tn(ua, wide)
    _close(got, gemm_tn_plain(a, b), m)
    assert torch.equal(got, want)
    assert torch.equal(ops.gemm_tn(a, wide), want)


def test_gemm_tn_kernel_batch_past_grid_limit(dev):
    """65,537 entries: the grid's z extent stops at 65,535 and the rest of
    the stack strides over it."""
    rng = np.random.default_rng(12)
    a, b = _t(rng, (65537, 3, 5), dev), _t(rng, (65537, 3, 4), dev)
    got = ops.gemm_tn(a, b)
    _close(got, gemm_tn_plain(a, b), 3)
    for e in (0, 65534, 65535, 65536):
        assert torch.equal(got[e], ops.gemm_tn(a[e], b[e])), e


@pytest.mark.parametrize("b,m,n,req", [(1, 8, 128, 128), (3, 70, 200, 128), (2, 300, 700, 256)])
def test_syrk_kernel_matches_plain(dev, b, m, n, req):
    rng = np.random.default_rng(n)
    a = _t(rng, (b, m, n), dev)
    dense = ops.syrk(a)
    _close(dense, syrk_plain(a), m)
    assert torch.equal(dense, dense.transpose(-1, -2))
    packed = ops.syrk(a, blocks=(512, req), out="packed")
    _close(packed.blocks, syrk_plain(a, out="packed", bn=packed.bn), m)
    assert torch.equal(packed.to_dense(), dense)


@pytest.mark.parametrize("n", [1, 100, 128, 129, 512])
@pytest.mark.parametrize("m", [1, 8, 31, 255, 256, 257, 513, 2048, 4100])
def test_syrk_kernel_split_edges(dev, m, n):
    """Across the edges of the contraction split K = syrk_splits(m, n) and of
    the 128-tile grid: dense and packed against the plain version, and the
    bitwise contracts — symmetric, packed == dense, batch entry == its single
    launch."""
    rng = np.random.default_rng(m * 1000 + n)
    a = _t(rng, (2, m, n), dev)
    dense = ops.syrk(a, alpha=0.5)
    _close(dense, syrk_plain(a, alpha=0.5), m)
    assert torch.equal(dense, dense.transpose(-1, -2))
    packed = ops.syrk(a, alpha=0.5, out="packed")
    _close(packed.blocks, syrk_plain(a, alpha=0.5, out="packed", bn=packed.bn), m)
    assert torch.equal(packed.to_dense(), dense)
    assert torch.equal(ops.syrk(a[1].contiguous(), alpha=0.5), dense[1])


def test_syrk_gather_equals_syrk_at_split_m(dev):
    """Gathered leaves of lstsq's size (m = 2048, K = 4) and a batched grid
    (m = 1050) sum in the order of syrk on the stacked leaves."""
    rng = np.random.default_rng(15)
    for x, L in ((_t(rng, (4096, 1024), dev), 1), (_t(rng, (2, 2100, 300), dev), 1)):
        ab = _to_blocks(_pad_root(x, L), L)
        assert syrk_splits(*ab.shape[-2:]) > 1
        rows, cols = np.array([0, 1, 1, 0]), np.array([0, 0, 1, 1])
        got = ops.syrk_gather(ab, rows, cols)
        _close(got, syrk_gather_plain(ab, rows, cols), ab.shape[-2])
        stacked = ab[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]
        want = ops.syrk(stacked.reshape(-1, *ab.shape[-2:]))
        assert torch.equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("m", [700, 2048])
def test_syrk_kernel_unaligned_ld_scalar_epilogue(dev, m):
    """n = 129: rows are not 16-byte aligned, so the epilogue writes scalar
    runs; split or not, the output matches and stays bitwise symmetric."""
    rng = np.random.default_rng(m)
    a = _t(rng, (m, 129), dev)
    assert syrk_splits(m, 129) > 1
    got = ops.syrk(a, alpha=-0.75)
    _close(got, syrk_plain(a, alpha=-0.75), m)
    assert torch.equal(got, got.T)
    sub = ops.syrk(a[:, 1:])  # an unaligned view: 4-byte copies as well
    _close(sub, syrk_plain(a[:, 1:]), m)


def test_syrk_info_resources(dev):
    """Every instance fits two CTAs an SM without spills, at every cluster
    size the split uses."""
    for v in (1, 0):
        for k in (1, 2, 4, 8):
            r = _build.resources("syrk_info", v, k)
            assert r["registers"] <= 128 and r["local_bytes"] == 0, r
            assert r["ctas_per_sm"] == 2 and r["cluster_size"] == k, r
            assert r["active_clusters"] >= 1, r


@pytest.mark.parametrize("n", [1, 8, 31, 32, 33, 104, 128, 200, 256])
def test_potrf_kernel_matches_plain(dev, n):
    """Panel edges (31, 32, 33), ragged last panels (104, 200), the largest
    tile, a stack of 3 and a single tile."""
    s = _spd(np.random.default_rng(n), 3, n, dev)
    got = ops.potrf(s)
    _close(got, potrf_plain(s), n)
    assert not torch.triu(got, 1).any()
    one = ops.potrf(s[1].contiguous())
    _close(one, potrf_plain(s[1]), n)
    assert not torch.triu(one, 1).any()
    assert torch.equal(one, got[1])   # a stack entry is the tile factored alone


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m,n", [(8, 16), (300, 128), (70, 256)])
def test_trsm_kernel_matches_plain(dev, transpose, m, n):
    rng = np.random.default_rng(m + n)
    l = potrf_plain(_spd(rng, 4, n, dev))
    b = _t(rng, (4, m, n), dev)
    _close(ops.trsm(l, b, transpose=transpose), trsm_plain(l, b, transpose=transpose), n)
    le = l[0].expand(4, n, n)  # batch stride 0: no copy
    _close(ops.trsm(le, b, transpose=transpose), trsm_plain(le, b, transpose=transpose), n)


@pytest.mark.parametrize("m", [1, 8, 12, 33, 300])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 100, 128, 200, 256])
def test_trsm_kernel_panel_edges(dev, n, m):
    """The 32-column panels: one column short of, at and past a panel edge,
    ragged last panels (100, 200) and the largest factor; row counts that
    run 1 (m <= 8) and 4 rows a warp, with idle warps (m = 12) and several
    CTAs (m = 300); both transposes, own factors and one factor expanded
    over the stack."""
    rng = np.random.default_rng(1000 * n + m)
    ls = potrf_plain(_spd(rng, 3, n, dev))
    b = _t(rng, (3, m, n), dev)
    for tr in (True, False):
        for l in (ls, ls[1].expand(3, n, n)):
            _close(ops.trsm(l, b, transpose=tr), trsm_plain(l, b, transpose=tr), n)


def test_wrappers_reject_what_kernels_do_not_take(dev):
    """The wrappers raise on what no kernel takes (float64, empty operands,
    mixed devices). What a kernel cannot read as it lies — a column stride
    other than 1, a potrf/trsm operand that is not contiguous, a tile over
    256 — the wrapper copies once (``kernels.copy.<name>``) or splits, and
    computes as the CPU path does."""
    from repro_torch.obs import metrics

    a = torch.zeros(16, 8, device=dev)
    with pytest.raises(TypeError):
        ops.gemm_tn(a.double(), a.double())
    # a bfloat16 output is taken since the kernels store float32 or bfloat16
    ops.reset_launches()
    got = ops.gemm_tn(a + 1, a + 1, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16 and ops.launches["gemm_tn"] == 1
    assert torch.equal(got, torch.full((8, 8), 16.0, device=dev, dtype=torch.bfloat16))
    copies = metrics.get("kernels.copy.gemm_tn")
    at = (a + 2).t()                     # column stride ≠ 1: copied once a operand
    assert torch.equal(ops.gemm_tn(at, at), gemm_tn_plain(at, at))
    assert metrics.get("kernels.copy.gemm_tn") == copies + 2
    with pytest.raises(ValueError):
        ops.syrk(torch.zeros(0, 8, device=dev))
    ops.reset_launches()
    assert torch.equal(ops.potrf(torch.eye(264, device=dev)), torch.eye(264, device=dev))
    assert {k: v for k, v in ops.launches.items() if v} == ops.split_launches("potrf", 264)
    copies = metrics.get("kernels.copy.trsm")
    x = ops.trsm(torch.eye(8, device=dev).t(), torch.ones(3, 8, device=dev))
    assert torch.equal(x, torch.ones(3, 8, device=dev))
    assert metrics.get("kernels.copy.trsm") == copies + 1     # the transposed tile, once
    with pytest.raises(ValueError):
        ops.gemm_tn(a, torch.zeros(16, 8))  # one operand on the CPU


def test_dispatches_bitwise_on_card(dev):
    rng = np.random.default_rng(1)
    a = _t(rng, (700, 520), dev)
    b = _t(rng, (700, 390), dev)
    u = ata(a, n_base=64, out="packed")
    bt = ata(a, n_base=64, out="packed", leaf_dispatch="batched")
    assert torch.equal(u.blocks, bt.blocks)
    assert torch.equal(u.to_dense(), ata(a, n_base=64))
    assert torch.equal(strassen_tn(a, b, n_base=64),
                       strassen_tn(a, b, n_base=64, leaf_dispatch="batched"))


def test_lstsq_runs_every_kernel(dev):
    rng = np.random.default_rng(2)
    a, b = _t(rng, (2100, 1100), dev), _t(rng, (2100, 4), dev)
    ops.reset_launches()
    x = lstsq(a, b, ridge=1e-3, method="factor")
    torch.cuda.synchronize()
    assert min(ops.launches[k] for k in ("syrk", "gemm_tn", "potrf", "trsm")) > 0, ops.launches
    ad = a.double()
    x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(1100, device=dev, dtype=torch.float64),
                             ad.T @ b.double())
    assert float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64)) <= 1e-3
    g = ata(a, out="packed", n_base=512).add_scaled_identity(1.0)
    assert torch.equal(cholesky(g).blocks, cholesky(g.to_dense(), packed_block=128).blocks)


def _fused_vs_gemm_tn(ab, tables, alpha, bb=None):
    """The fused launch against its plain version, and bitwise against
    gemm_tn on the materialized combined operands."""
    bb = ab if bb is None else bb
    got = ops.gemm_tn_fused(ab, bb, tables, alpha=alpha)
    _close(got, gemm_tn_fused_plain(ab, bb, tables, alpha=alpha), ab.shape[-2])
    xa, xb = combine_fused_operands(ab, *tables[0]), combine_fused_operands(bb, *tables[1])
    want = ops.gemm_tn(xa.reshape(-1, *xa.shape[-2:]), xb.reshape(-1, *xb.shape[-2:]),
                       alpha=alpha)
    assert torch.equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("shape,L,lev", [((512, 512), 2, 1), ((3, 1000, 520), 2, 1),
                                         ((2, 700, 390), 3, 1), ((700, 390), 3, 2)])
def test_gemm_tn_fused_kernel_ata_levels(dev, shape, L, lev):
    """ATA level launches over the root grid: ragged leaves (130, 49 or 98
    columns), a batch of 2 or 3."""
    rng = np.random.default_rng(sum(shape) + lev)
    ab = _to_blocks(_pad_root(_t(rng, shape, dev), L), L)[None]
    _fused_vs_gemm_tn(ab, _level_tables(L, lev), -2.0)


def _unaligned(rng, shape, dev):
    """A contiguous operand that starts one float past a 16-byte boundary."""
    flat = _t(rng, (math.prod(shape) + 1,), dev)
    return flat[1:].view(shape)


def _vec16(ab, bb, tables):
    """Whether the kernel copies these grids in 16-byte quads."""
    sides, T, W = _fused_tables(ab, bb, tables)
    return fused_launch_tables(ab, bb, sides, T, W)[-1]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("L", [0, 1, 2, 3, 4, 5])
def test_gemm_tn_fused_kernel_every_slot_count(dev, L, aligned):
    """Strassen slot tables with W = 1 … 32: every instantiation of the
    kernel, with the 16-byte and the 4-byte copy paths."""
    rng = np.random.default_rng(L)
    make = _t if aligned else _unaligned
    ab = _to_blocks(make(rng, (9 << L, 5 << L), dev), L)[None]
    assert aligned or not _vec16(ab, ab, _slot_tables(L))
    _fused_vs_gemm_tn(ab, _slot_tables(L), 1.0)


@pytest.mark.parametrize("n,k,batch,aligned,vec16", [
    (384, 640, 1, True, True),     # 3 x 5 tiles: a cluster row and column half beyond the edge
    (640, 132, 3, True, True),     # 5 x 2 tiles, a batch of 3
    (640, 130, 3, True, False),    # 130-column blocks: offsets not 16-byte multiples
    (130, 390, 3, False, False),   # ragged 130/390 columns, unaligned start
    (257, 129, 1, False, False),   # one column past a tile on both axes
])
@pytest.mark.parametrize("L", [0, 1, 2])
def test_gemm_tn_fused_kernel_partial_clusters(dev, n, k, batch, aligned, vec16, L):
    """Tile counts that are odd along either axis leave part of a CTA
    cluster beyond the edge: those CTAs still combine their share. W = 1, 2
    and 4 slots run without a cluster, in 2 x 2 and in 4 x 4 clusters."""
    rng = np.random.default_rng(n + k + batch + L)
    make = _t if aligned else _unaligned
    x = make(rng, (batch, 40 << L, n << L), dev)
    y = make(rng, (batch, 40 << L, k << L), dev)
    ab, bb = _to_blocks(x, L)[None], _to_blocks(y, L)[None]
    tables = _slot_tables(L)
    assert _vec16(ab, bb, tables) == vec16
    _fused_vs_gemm_tn(ab, tables, 0.5, bb)


@pytest.mark.parametrize("shape,L", [((512, 512), 2), ((2, 1000, 520), 2), ((300, 700), 1)])
def test_syrk_gather_kernel_matches_plain(dev, shape, L):
    rng = np.random.default_rng(sum(shape))
    ab = _to_blocks(_pad_root(_t(rng, shape, dev), L), L)
    R = 1 << L
    for rows, cols in ((np.arange(R * R) % R, np.arange(R * R) // R),
                       (rng.integers(0, R, 5), rng.integers(0, R, 5))):
        got = ops.syrk_gather(ab, rows, cols, alpha=0.5)
        _close(got, syrk_gather_plain(ab, rows, cols, alpha=0.5), ab.shape[-2])
        stacked = ab[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]
        want = ops.syrk(stacked.reshape(-1, *ab.shape[-2:]), alpha=0.5)
        assert torch.equal(got, want.reshape(got.shape))
        assert torch.equal(got, got.transpose(-1, -2))


def test_fused_wrappers_reject_what_kernels_do_not_take(dev):
    grid = torch.zeros(1, 2, 2, 8, 8, device=dev)
    with pytest.raises(TypeError):
        ops.gemm_tn_fused(grid.double(), grid.double(), _slot_tables(1))
    wide = ((np.zeros((1, 64), np.int32),) * 2 + (np.ones((1, 64), np.int32),),) * 2
    with pytest.raises(ValueError):
        ops.gemm_tn_fused(grid, grid, wide)                 # 64 slots: not instantiated
    with pytest.raises(TypeError):
        ops.syrk_gather(grid[0].double(), np.array([0]), np.array([0]))


def test_ata_fused_bitwise_on_card(dev):
    """An odd shape at the default n_base (L = 2): the three dispatches agree
    bitwise; fused launches only the fused kernels, once per level and once."""
    rng = np.random.default_rng(3)
    a = _t(rng, (3000, 2000), dev)
    out = {}
    for ld in ("unrolled", "batched", "fused"):
        ops.reset_launches()
        out[ld] = ata(a, n_base=512, out="packed", leaf_dispatch=ld)
        torch.cuda.synchronize()
        if ld == "fused":
            assert ops.launches == {"syrk": 0, "gemm_tn": 0, "gemm_tn_fused": 2,
                                    "syrk_gather": 1, "potrf": 0, "trsm": 0}, ops.launches
    assert torch.equal(out["unrolled"].blocks, out["batched"].blocks)
    assert torch.equal(out["unrolled"].blocks, out["fused"].blocks)
    ab = _t(rng, (2, 300, 260), dev)
    assert torch.equal(ata_batched(ab, n_base=64), ata_batched(ab, n_base=64, leaf_dispatch="fused"))
    x, y = _t(rng, (700, 520), dev), _t(rng, (700, 390), dev)
    ops.reset_launches()
    f = strassen_tn(x, y, n_base=64, leaf_dispatch="fused")
    assert ops.launches["gemm_tn_fused"] == 1 and ops.launches["gemm_tn"] == 0
    assert torch.equal(strassen_tn(x, y, n_base=64), f)


@pytest.mark.parametrize("n", [200, 1000])
def test_cholesky_packed_and_dense_bitwise_on_card(dev, n):
    """The walk factors a packed gram and its dense square bitwise alike,
    through the panel-blocked potrf (a ragged last block at n = 200)."""
    rng = np.random.default_rng(n)
    a = _t(rng, (3 * n, n), dev)
    g = ata(a, out="packed", n_base=512).add_scaled_identity(1.0)
    ops.reset_launches()
    packed = cholesky(g)
    assert ops.launches["potrf"] > 0
    assert torch.equal(packed.blocks, cholesky(g.to_dense(), packed_block=g.bn).blocks)


# ---------------------------------------------------------------------------
# bfloat16 operands and outputs, float64 on the card, CG, spans
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7   # spacing of bfloat16 values relative to their magnitude


def _close_dt(got, ref, k, out):
    """Kernel against its plain version on the same bfloat16 operands: every
    product of two bfloat16 values is exact in float32, so the two float32
    results differ by summation order alone (the float32 bound); a
    bfloat16 output may then round the two to neighbouring values, one
    bfloat16 ulp apart."""
    assert got.dtype == ref.dtype == out, (got.dtype, ref.dtype, out)
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    tol = 8 * math.sqrt(k) * 1.19e-7 * scale + (BF16_ULP * scale if out == torch.bfloat16 else 0)
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


OUTS = [torch.float32, torch.bfloat16]


def _bf(rng, shape, dev):
    return _t(rng, shape, dev).bfloat16()


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("m", [1, 7, 8, 9, 15, 16, 17, 33, 64, 65, 513])
def test_gemm_tn_kernel_bf16_depths_and_ragged_edges(dev, m, out):
    """bfloat16 operands on the tensor-core kernel (TMA stages of 64 rows,
    k16 steps), float32 or bfloat16 output, at the depth and edge shapes of
    the float32 sweep and the narrow ones (every k runs wgmma in
    bfloat16): within tolerance of the plain version, one wgmma launch a
    call, bitwise equal to the W = 1 fused launch and a batch entry
    bitwise equal to its single launch."""
    rng = np.random.default_rng(m)
    for n, k in ((1, 129), (127, 1), (129, 127), (127, 129), (129, 65)) + NARROW_EDGES:
        a, b = _bf(rng, (2, m, n), dev), _bf(rng, (2, m, k), dev)
        ops.reset_launches()
        got = ops.gemm_tn(a, b, alpha=0.75, out_dtype=out)
        assert ops.wgmma_launches["gemm_tn_wgmma"] == 1, (n, k)
        assert ops.narrow_launches["gemm_tn_narrow"] == 0, (n, k)
        _close_dt(got, gemm_tn_plain(a, b, alpha=0.75, out_dtype=out), m, out)
        assert _bits_equal(got, _fused_w1(a, b, alpha=0.75, out_dtype=out)), (n, k)
        assert torch.equal(got[1], ops.gemm_tn(a[1], b[1], alpha=0.75, out_dtype=out)), (n, k)


@pytest.mark.parametrize("out", OUTS)
def test_gemm_tn_kernel_bf16_unaligned_views(dev, out):
    """A bfloat16 base off a 16-byte boundary or a row stride that is not a
    multiple of 8 elements: the tensor-core kernel's producer warp fills
    the swizzled stages by element loads instead of TMA, the same product
    bit for bit."""
    rng = np.random.default_rng(21)
    a, b = _bf(rng, (3, 70, 201), dev), _bf(rng, (3, 70, 136), dev)
    assert vec16(a[..., :200], a.stride(0), a.stride(1)) is False
    assert vec16(b, b.stride(0), b.stride(1)) and not vec16(b[..., 1:], b.stride(0), b.stride(1))
    want = ops.gemm_tn(a[..., 1:].contiguous(), b[..., 1:].contiguous(), out_dtype=out)
    got = ops.gemm_tn(a[..., 1:], b[..., 1:], out_dtype=out)
    _close_dt(got, gemm_tn_plain(a[..., 1:], b[..., 1:], out_dtype=out), 70, out)
    assert torch.equal(got, want)


@pytest.mark.parametrize("out", OUTS)
def test_gemm_tn_bf16_copies_chosen_per_operand(dev, out):
    """PowerSGD's B of 4 bfloat16 columns has 8-byte rows, which TMA cannot
    take: the tensor-core kernel takes the aligned operand by TMA and fills
    the other's side by element copies. Every mix of the two gives the bits
    of both operands by TMA (B padded to a 16-byte row stride)."""
    rng = np.random.default_rng(26)
    m, n, k = 700, 300, 4
    a, b = _bf(rng, (2, m, n), dev), _bf(rng, (2, m, k), dev)
    padded = torch.zeros(2, m, 8, device=dev, dtype=torch.bfloat16)[..., :k].copy_(b)
    ua = torch.empty(a.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(a.shape).copy_(a)
    assert vec16(padded, padded.stride(0), padded.stride(1)) and not vec16(b, b.stride(0), b.stride(1))
    want = ops.gemm_tn(a, padded, out_dtype=out)
    _close_dt(want, gemm_tn_plain(a, b, out_dtype=out), m, out)
    for x, y in ((a, b), (ua, padded), (ua, b)):
        ops.reset_launches()
        assert _bits_equal(ops.gemm_tn(x, y, out_dtype=out), want)
        assert ops.wgmma_launches["gemm_tn_wgmma"] == 1


def test_gemm_tn_kernel_mixed_operands_widen(dev):
    """A bfloat16 operand beside a float32 one is widened (exactly): the
    float32 kernel's result."""
    rng = np.random.default_rng(22)
    a, b = _bf(rng, (300, 100), dev), _t(rng, (300, 60), dev)
    assert torch.equal(ops.gemm_tn(a, b), ops.gemm_tn(a.float(), b))


@pytest.mark.parametrize("k", [1, 8, 9])
def test_gemm_tn_kernel_narrow_output_at_lstsq_depth(dev, k):
    """lstsq's CG products: A (16384, 4096) against k columns, in float32
    on the narrow kernel and on bfloat16 operands on the tensor-core
    kernel: within tolerance of the plain version and bitwise equal to
    gemm_tn_fused on W = 1 tables (the same summation order: the tile
    engine's chain in float32, the k16 steps in bfloat16)."""
    rng = np.random.default_rng(k)
    a, p = _t(rng, (16384, 4096), dev), _t(rng, (16384, k), dev)
    got = ops.gemm_tn(a, p)
    assert got.shape == (4096, k)
    _close(got, gemm_tn_plain(a, p), 16384)
    assert _bits_equal(got, _fused_w1(a, p))
    a16, p16 = a.bfloat16(), p.bfloat16()
    ops.reset_launches()
    got16 = ops.gemm_tn(a16, p16)
    assert ops.wgmma_launches["gemm_tn_wgmma"] == 1 and ops.narrow_launches["gemm_tn_narrow"] == 0
    _close_dt(got16, gemm_tn_plain(a16, p16), 16384, torch.float32)
    assert _bits_equal(got16, _fused_w1(a16, p16))


def _fused_w1(a, b, alpha=1.0, out_dtype=torch.float32):
    """gemm_tn_fused on W = 1 tables of the same operands: the tile engine's
    fmaf chain (float32) or the k16 steps (bfloat16), whatever kernel
    gemm_tn picks."""
    lead = (None,) * 3
    out = ops.gemm_tn_fused(a[lead], b[lead], _slot_tables(0), alpha=alpha, out_dtype=out_dtype)
    return out.reshape(*a.shape[:-2], a.shape[-1], b.shape[-1])


def _bits_equal(x, y):
    """Bit patterns equal (torch.equal takes -0 for +0)."""
    view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    return x.dtype == y.dtype and torch.equal(x.view(view), y.view(view))


@pytest.mark.parametrize("m", [5, 8])
def test_gemm_tn_narrow_keeps_the_engines_signed_zero(dev, m):
    """Products that underflow make a sum of -0. The engine's zero rows up
    to its next depth-8 slab add +0 to it, which gives +0 when m is not a
    multiple of 8: the narrow kernel gives the same bit patterns."""
    a = torch.full((m, 40), -2.0 ** -100, device=dev)
    b = torch.full((m, 3), 2.0 ** -100, device=dev)
    b[:, 1] = -b[:, 1]   # a column of +0 sums beside the -0 ones
    got = ops.gemm_tn(a, b)
    assert _bits_equal(got, _fused_w1(a, b))
    assert bool(torch.signbit(got[:, 0]).all()) == (m % 8 == 0)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("m,n,k", [(513, 129, 4), (100, 4096, 8), (37, 127, 32), (8, 1, 1)])
def test_gemm_tn_narrow_bf16_bitwise_to_the_engine(dev, m, n, k, out):
    """bfloat16 operands at the narrow kernel's shapes, float32 or bfloat16
    output, now on the tensor-core kernel (bfloat16 takes wgmma at every
    k): bitwise equal to the W = 1 fused launch, within tolerance of the
    plain version, a batch entry bitwise equal to its single launch."""
    rng = np.random.default_rng(m + n + k)
    a, b = _bf(rng, (2, m, n), dev), _bf(rng, (2, m, k), dev)
    ops.reset_launches()
    got = ops.gemm_tn(a, b, alpha=-0.5, out_dtype=out)
    assert ops.wgmma_launches["gemm_tn_wgmma"] == 1 and ops.narrow_launches["gemm_tn_narrow"] == 0
    _close_dt(got, gemm_tn_plain(a, b, alpha=-0.5, out_dtype=out), m, out)
    assert _bits_equal(got, _fused_w1(a, b, alpha=-0.5, out_dtype=out))
    assert _bits_equal(got[1], ops.gemm_tn(a[1], b[1], alpha=-0.5, out_dtype=out))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_gemm_tn_narrow_unaligned_views(dev, dt):
    """A base 4 bytes off a 16-byte boundary and odd row strides: the kernel
    copies elements instead of bulk rows (float32: the narrow kernel;
    bfloat16: the tensor-core kernel's element fill instead of TMA); the
    same bits as the aligned operands (bulk copies) and as the W = 1 fused
    launch."""
    rng = np.random.default_rng(23)
    m, n, k = 300, 200, 8
    a, b = _t(rng, (2, m, n), dev).to(dt), _t(rng, (2, m, k), dev).to(dt)
    assert vec16(a, a.stride(0), a.stride(1)) and vec16(b, b.stride(0), b.stride(1))
    want = ops.gemm_tn(a, b)
    shift = 4 // a.element_size()
    ua = torch.empty(a.numel() + shift, device=dev, dtype=dt)[shift:].view(a.shape)
    ua.copy_(a)
    wide = torch.empty(2, m, k + 1, device=dev, dtype=dt)[..., :k]   # row stride 9
    wide.copy_(b)
    assert not vec16(ua, ua.stride(0), ua.stride(1))
    assert not vec16(wide, wide.stride(0), wide.stride(1))
    for x, y in ((ua, wide), (ua, b), (a, wide)):
        got = ops.gemm_tn(x, y)
        _close_dt(got, gemm_tn_plain(a, b), m, torch.float32)
        assert _bits_equal(got, want)
    assert _bits_equal(want, _fused_w1(a, b))


def test_gemm_tn_narrow_batch_past_grid_limit(dev):
    """65,537 entries of (40, 70)ᵀ × (40, 8) on the narrow kernel: the
    grid's z extent stops at 65,535 and the rest of the stack strides over
    it, its ring's stages running on across entries."""
    rng = np.random.default_rng(24)
    a, b = _t(rng, (65537, 40, 70), dev), _t(rng, (65537, 40, 8), dev)
    got = ops.gemm_tn(a, b)
    _close(got, gemm_tn_plain(a, b), 40)
    for e in (0, 1, 65534, 65535, 65536):
        assert _bits_equal(got[e], ops.gemm_tn(a[e], b[e])), e
        assert _bits_equal(got[e], _fused_w1(a[e], b[e])), e


def test_gemm_tn_narrow_info_and_launch_count(dev):
    """The narrow kernel's plan at the three timed shapes (a grid that
    covers the SMs), no spills; gemm_tn counts a narrow launch for k <= 64
    only, and one gemm_tn launch either way."""
    from repro_torch.kernels.gemm_tn import narrow_max_k

    assert narrow_max_k() == 64
    for (n, k), w in (((4096, 8), 32), ((2816, 4), 16), ((1024, 4), 8)):
        r = _build.resources("gemm_tn_narrow_info", n, k, 1)
        assert r["strip_columns"] == w and r["ctas"] == -(-n // w), r
        assert r["local_bytes"] == 0 and r["ctas_per_sm"] >= 1, r
        assert r["max_k"] == 64 and r["ring_stages"] * r["stage_rows"] >= 8, r
    rng = np.random.default_rng(25)
    a = _t(rng, (64, 100), dev)
    for k, narrow in ((64, 1), (65, 0)):
        ops.reset_launches()
        ops.gemm_tn(a, _t(rng, (64, k), dev))
        assert ops.launches["gemm_tn"] == 1
        assert ops.narrow_launches["gemm_tn_narrow"] == narrow, k


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("n", [1, 100, 129, 512])
@pytest.mark.parametrize("m", [1, 31, 257, 2048])
def test_syrk_kernel_bf16_split_edges(dev, m, n, out):
    """bfloat16 operands across the split and tile edges, dense and packed:
    within the bound of the plain version, bitwise symmetric, packed ==
    dense, a batch entry == its single launch."""
    rng = np.random.default_rng(m * 1000 + n + 7)
    a = _bf(rng, (2, m, n), dev)
    dense = ops.syrk(a, alpha=0.5, out_dtype=out)
    _close_dt(dense, syrk_plain(a, alpha=0.5, out_dtype=out), m, out)
    assert torch.equal(dense, dense.transpose(-1, -2))
    packed = ops.syrk(a, alpha=0.5, out="packed", out_dtype=out)
    _close_dt(packed.blocks, syrk_plain(a, alpha=0.5, out="packed", bn=packed.bn, out_dtype=out),
              m, out)
    assert torch.equal(packed.to_dense(), dense)
    assert torch.equal(ops.syrk(a[1].contiguous(), alpha=0.5, out_dtype=out), dense[1])
    if m == 2048 and n > 1:
        sub = ops.syrk(a[0, :, 1:], out_dtype=out)   # unaligned: element loads
        _close_dt(sub, syrk_plain(a[0, :, 1:], out_dtype=out), m, out)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("L", [0, 1, 2, 3, 4, 5])
def test_gemm_tn_fused_kernel_bf16_every_slot_count(dev, L, aligned, out):
    """bfloat16 slot blocks with W = 1 … 32, quad (8-byte) and element
    copies, on the tensor-core kernel: the combine rounds each add to
    bfloat16 as the plain version does, so the two differ by the multiply's
    summation order alone, and the launch is bitwise equal to gemm_tn on
    the materialized bfloat16 combined operands."""
    rng = np.random.default_rng(L + 40)
    x = _bf(rng, (9 << L, 5 << L), dev)
    if not aligned:
        flat = torch.empty(x.numel() + 1, device=dev, dtype=torch.bfloat16)
        x = flat[1:].view(x.shape).copy_(x)
    ab = _to_blocks(x, L)[None]
    assert aligned or not _vec16(ab, ab, _slot_tables(L))
    tables = _slot_tables(L)
    ops.reset_launches()
    got = ops.gemm_tn_fused(ab, ab, tables, alpha=0.5, out_dtype=out)
    assert ops.wgmma_launches["gemm_tn_fused_wgmma"] == 1
    _close_dt(got, gemm_tn_fused_plain(ab, ab, tables, alpha=0.5, out_dtype=out),
              ab.shape[-2], out)
    xa, xb = combine_fused_operands(ab, *tables[0]), combine_fused_operands(ab, *tables[1])
    assert xa.dtype == torch.bfloat16
    want = ops.gemm_tn(xa.reshape(-1, *xa.shape[-2:]), xb.reshape(-1, *xb.shape[-2:]),
                       alpha=0.5, out_dtype=out)
    assert _bits_equal(got, want.reshape(got.shape))


def test_gemm_tn_fused_kernel_bf16_then_float32_at_one_offset(dev):
    """A bfloat16 launch and then a float32 one with the same tables,
    shapes and strides, both 8 bytes past a 16-byte boundary: the bfloat16
    grid may be copied in 16-byte quads, the float32 one may not, so the
    second launch must not reuse the first one's copy width."""
    rng = np.random.default_rng(41)
    tables = _slot_tables(1)
    for dt, pad in ((torch.bfloat16, 4), (torch.float32, 2)):
        x = _t(rng, (64, 64), dev).to(dt)
        flat = torch.empty(x.numel() + pad, device=dev, dtype=dt)
        ab = _to_blocks(flat[pad:].view(x.shape).copy_(x), 1)[None]
        assert ab.data_ptr() % 16 == 8 and _vec16(ab, ab, tables) == (dt == torch.bfloat16)
        got = ops.gemm_tn_fused(ab, ab, tables)
        torch.cuda.synchronize()
        _close_dt(got, gemm_tn_fused_plain(ab, ab, tables), ab.shape[-2], torch.float32)


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("shape,L", [((512, 512), 2), ((2, 1000, 520), 2), ((300, 700), 1)])
def test_syrk_gather_kernel_bf16_matches_plain(dev, shape, L, out):
    rng = np.random.default_rng(sum(shape) + 3)
    ab = _to_blocks(_pad_root(_bf(rng, shape, dev), L), L)
    R = 1 << L
    rows, cols = np.arange(R * R) % R, np.arange(R * R) // R
    got = ops.syrk_gather(ab, rows, cols, alpha=0.5, out_dtype=out)
    _close_dt(got, syrk_gather_plain(ab, rows, cols, alpha=0.5, out_dtype=out), ab.shape[-2], out)
    assert torch.equal(got, got.transpose(-1, -2))


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("n", [1, 8, 31, 32, 33, 104, 128, 200, 256])
def test_potrf_kernel_bf16_matches_plain(dev, n, out):
    """A bfloat16 tile is factored in float32: the plain recurrence's
    result within the float32 bound, stored as float32 or bfloat16."""
    s = _spd(np.random.default_rng(n + 5), 3, n, dev).bfloat16()
    got = ops.potrf(s, out_dtype=out)
    _close_dt(got, potrf_plain(s, out_dtype=out), n, out)
    assert not torch.triu(got.float(), 1).any()


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("m", [1, 8, 33])
@pytest.mark.parametrize("n", [1, 31, 33, 100, 128, 256])
def test_trsm_kernel_bf16_panel_edges(dev, n, m, out):
    rng = np.random.default_rng(1000 * n + m + 9)
    ls = potrf_plain(_spd(rng, 3, n, dev)).bfloat16()
    b = _bf(rng, (3, m, n), dev)
    for tr in (True, False):
        for l in (ls, ls[1].expand(3, n, n)):
            _close_dt(ops.trsm(l, b, transpose=tr, out_dtype=out),
                      trsm_plain(l, b, transpose=tr, out_dtype=out), n, out)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_every_wrapper_launches_for_float32_and_bfloat16(dev, dt):
    """float32 and bfloat16 on the card always reach a kernel: each
    wrapper call adds one to its launch count."""
    rng = np.random.default_rng(23)
    a = _t(rng, (2, 64, 40), dev).to(dt)
    s = _spd(rng, 2, 40, dev).to(dt)
    ab = _to_blocks(a, 1)
    calls = {
        "gemm_tn": lambda: ops.gemm_tn(a, a),
        "syrk": lambda: ops.syrk(a),
        "gemm_tn_fused": lambda: ops.gemm_tn_fused(ab[None], ab[None], _slot_tables(1)),
        "syrk_gather": lambda: ops.syrk_gather(ab, np.array([0, 1]), np.array([1, 0])),
        "potrf": lambda: ops.potrf(s),
        "trsm": lambda: ops.trsm(potrf_plain(s).to(dt), a[:, :8].contiguous()),
    }
    for name, call in calls.items():
        ops.reset_launches()
        call()
        torch.cuda.synchronize()
        assert ops.launches[name] == 1 and sum(ops.launches.values()) == 1, (name, ops.launches)


def test_float64_computes_on_card_with_plain_bases(dev):
    """float64 — the operand's dtype or acc_dtype — goes to the plain bases
    before any launch: ata (three dispatches), strassen_tn and cholesky
    compute on the card, where they used to raise, within 8·√k·eps64 of the
    same call on the CPU, and no kernel is launched."""
    rng = np.random.default_rng(24)
    a = torch.as_tensor(rng.standard_normal((700, 520)), device=dev)
    b = torch.as_tensor(rng.standard_normal((700, 390)), device=dev)

    def close64(got, want, k):
        tol = 8 * math.sqrt(k) * 2.2e-16 * float(want.abs().max())
        assert float((got.cpu() - want).abs().max()) <= tol

    ops.reset_launches()
    for ld in ("unrolled", "batched", "fused"):
        got = ata(a, n_base=64, out="packed", leaf_dispatch=ld, acc_dtype=torch.float64)
        assert got.blocks.dtype == torch.float64 and got.blocks.is_cuda
        close64(got.blocks, ata(a.cpu(), n_base=64, out="packed", leaf_dispatch=ld,
                                acc_dtype=torch.float64).blocks, 700)
        f32 = ata(a.float(), n_base=64, leaf_dispatch=ld, acc_dtype=torch.float64)
        close64(f32, ata(a.float().cpu(), n_base=64, leaf_dispatch=ld, acc_dtype=torch.float64),
                700)
    close64(strassen_tn(a, b, n_base=64, acc_dtype=torch.float64),
            strassen_tn(a.cpu(), b.cpu(), n_base=64, acc_dtype=torch.float64), 700)
    f64 = dict(out="packed", acc_dtype=torch.float64)
    g = ata(a, **f64).add_scaled_identity(1.0)
    f = cholesky(g)
    assert f.blocks.dtype == torch.float64
    close64(f.blocks, cholesky(ata(a.cpu(), **f64).add_scaled_identity(1.0)).blocks, 520)
    torch.cuda.synchronize()
    assert sum(ops.launches.values()) == 0, ops.launches


def test_ata_bf16_dispatches_on_card(dev):
    """bfloat16 ata and strassen_tn: unrolled == batched == fused bitwise
    (the same bfloat16 combinations — the fused kernel rounds each add to
    bfloat16 as the recursion does — and one summation order of the
    tensor-core kernels); all within the reference's bfloat16 rtol (2e-2,
    normwise) of the exact product of the same values; fused launches its
    two kernels only, its gemm_tn_fused on wgmma."""
    rng = np.random.default_rng(25)
    a = _bf(rng, (1500, 1100), dev)
    exact = a.double().T @ a.double()
    out = {}
    for ld in ("unrolled", "batched", "fused"):
        ops.reset_launches()
        out[ld] = ata(a, n_base=256, leaf_dispatch=ld)
        torch.cuda.synchronize()
        rel = float(torch.linalg.norm(out[ld].double() - exact) / torch.linalg.norm(exact))
        assert rel <= 2e-2, (ld, rel)
        if ld == "fused":
            assert ops.launches["gemm_tn_fused"] > 0 and ops.launches["syrk_gather"] == 1
            assert ops.launches["gemm_tn"] == ops.launches["syrk"] == 0
            assert ops.wgmma_launches["gemm_tn_fused_wgmma"] == ops.launches["gemm_tn_fused"]
        else:
            assert ops.wgmma_launches["gemm_tn_wgmma"] == ops.launches["gemm_tn"] > 0
    assert torch.equal(out["unrolled"], out["batched"])
    assert torch.equal(out["unrolled"], out["fused"])
    x, y = _bf(rng, (700, 520), dev), _bf(rng, (700, 390), dev)
    exact = x.double().T @ y.double()
    st = {ld: strassen_tn(x, y, n_base=64, leaf_dispatch=ld)
          for ld in ("unrolled", "batched", "fused")}
    for ld, got in st.items():
        rel = float(torch.linalg.norm(got.double() - exact) / torch.linalg.norm(exact))
        assert rel <= 2e-2, (ld, rel)
    assert torch.equal(st["unrolled"], st["batched"]) and torch.equal(st["unrolled"], st["fused"])


@pytest.mark.parametrize("k", [1, 64, 65, 512])
def test_wgmma_launches_counted_by_operand_type(dev, k):
    """bfloat16 operands launch the tensor-core kernels at every k, float32
    the narrow kernel (k <= 64) or the tile engine, each counted once; the
    wgmma instances spill nothing and fit on an SM."""
    rng = np.random.default_rng(k + 27)
    a, b = _t(rng, (3, 96, 130), dev), _t(rng, (3, 96, k), dev)
    for dt, tc, narrow in ((torch.bfloat16, 1, 0), (torch.float32, 0, int(k <= 64))):
        ops.reset_launches()
        ops.gemm_tn(a.to(dt), b.to(dt))
        assert ops.launches["gemm_tn"] == 1
        assert ops.wgmma_launches == {"gemm_tn_wgmma": tc, "gemm_tn_fused_wgmma": 0,
                                      "syrk_wgmma": 0, "syrk_gather_wgmma": 0}, dt
        assert ops.narrow_launches["gemm_tn_narrow"] == narrow, dt
        ab = _to_blocks(a.to(dt), 1)[None]
        ops.reset_launches()
        ops.gemm_tn_fused(ab, ab, _slot_tables(1))
        assert ops.wgmma_launches == {"gemm_tn_wgmma": 0, "gemm_tn_fused_wgmma": tc,
                                      "syrk_wgmma": 0, "syrk_gather_wgmma": 0}, dt
    r = _build.resources("gemm_tn_wgmma_info")
    assert r["local_bytes"] == 0 and r["ctas_per_sm"] >= 1, r
    for w in (1, 2, 4, 8, 16, 32):
        r = _build.resources("gemm_tn_fused_wgmma_info", w)
        assert r["local_bytes"] == 0 and r["ctas_per_sm"] >= 1 and r["active_clusters"] >= 1, r


def _syrk_counts():
    from repro_torch.kernels.syrk import tma_refused

    return ({k: ops.wgmma_launches[k] for k in ("syrk_wgmma", "syrk_gather_wgmma")},
            dict(tma_refused))


def test_syrk_bf16_runs_on_the_tensor_cores(dev):
    """bfloat16 syrk (dense and packed) and syrk_gather launch the
    tensor-core kernel, each counted once in ``wgmma_launches`` and, on
    aligned operands, by TMA (no tensor map refused); float32 never does.
    Every wgmma instance spills nothing and is resident two CTAs an SM."""
    rng = np.random.default_rng(61)
    x = _t(rng, (2, 300, 260), dev)
    ab = _to_blocks(_t(rng, (512, 512), dev), 1)
    rows, cols = np.array([0, 1]), np.array([0, 1])
    for dt, tc in ((torch.bfloat16, 1), (torch.float32, 0)):
        for call, key in ((lambda: ops.syrk(x.to(dt)), "syrk_wgmma"),
                          (lambda: ops.syrk(x.to(dt), out="packed"), "syrk_wgmma"),
                          (lambda: ops.syrk_gather(ab.to(dt), rows, cols), "syrk_gather_wgmma")):
            ops.reset_launches()
            call()
            torch.cuda.synchronize()
            want = {"syrk_wgmma": 0, "syrk_gather_wgmma": 0}
            want[key] = tc
            assert _syrk_counts() == (want, {"syrk_wgmma": 0, "syrk_gather_wgmma": 0}), (dt, key)
            assert ops.launches["syrk" if key == "syrk_wgmma" else "syrk_gather"] == 1
    for k in (1, 2, 4, 8):
        r = _build.resources("syrk_wgmma_info", k)
        assert r["local_bytes"] == 0 and r["ctas_per_sm"] == 2 and r["cluster_size"] == k, r
        assert r["active_clusters"] >= 1, r


@pytest.mark.parametrize("out", OUTS)
@pytest.mark.parametrize("case", ["split_m", "ata_8192", "unaligned"])
def test_syrk_gather_bf16_equals_syrk_on_stacked_leaves(dev, case, out):
    """The gathered leaves, read in place by box coordinates (TMA) or from
    their offsets by element loads (an unaligned grid), sum in the order of
    syrk on the stacked leaves, bitwise: at a split m (m = 1050, K > 1),
    at ata 8192²'s diagonal gather (R = 16, S = 256) and on a grid whose
    base is off a 16-byte boundary."""
    from repro_torch.kernels.syrk import tma_refused

    rng = np.random.default_rng(62)
    if case == "split_m":
        ab = _to_blocks(_pad_root(_bf(rng, (2, 2100, 300), dev), 1), 1)
        rows, cols = np.array([0, 1, 1, 0]), np.array([0, 0, 1, 1])
        assert ab.shape[-2] == 1050 and syrk_splits(*ab.shape[-2:]) > 1
    elif case == "ata_8192":
        ab = _to_blocks(_bf(rng, (8192, 8192), dev), 4)
        s = np.arange(256)
        rows, cols = s % 16, s // 16
    else:
        x = _bf(rng, (700, 260), dev)
        flat = torch.empty(x.numel() + 1, device=dev, dtype=torch.bfloat16)
        ab = _to_blocks(flat[1:].view(x.shape).copy_(x), 1)
        rows, cols = np.array([1, 0, 1]), np.array([1, 0, 0])
        assert not vec16(ab, ab.stride(-2))
    ops.reset_launches()
    got = ops.syrk_gather(ab, rows, cols, alpha=0.5, out_dtype=out)
    assert ops.wgmma_launches["syrk_gather_wgmma"] == 1 and tma_refused["syrk_gather_wgmma"] == 0
    _close_dt(got, syrk_gather_plain(ab, rows, cols, alpha=0.5, out_dtype=out), ab.shape[-2], out)
    stacked = ab[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]
    want = ops.syrk(stacked.reshape(-1, *ab.shape[-2:]).contiguous(), alpha=0.5, out_dtype=out)
    assert _bits_equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("n,req", [(300, 104), (500, 256)])
@pytest.mark.parametrize("m,splits", [(300, 1), (600, 2), (1100, 4), (2100, 8)])
def test_syrk_bf16_packed_equals_dense_at_every_split(dev, m, splits, n, req):
    """Packed blocks of edge 104 and 256 against dense, bitwise, at K = 1,
    2, 4 and 8: a tile's columns past its block's edge (bn = 104) now arrive
    as values, and only make entries that are never written; the pad
    entries stay exact zeros. Batch entries equal their single launches."""
    rng = np.random.default_rng(m + req)
    assert syrk_splits(m, n) == splits
    a = _bf(rng, (2, m, n), dev)
    dense = ops.syrk(a, alpha=-0.5)
    assert _bits_equal(dense, dense.transpose(-1, -2).contiguous())
    packed = ops.syrk(a, alpha=-0.5, blocks=(512, req), out="packed")
    assert packed.bn == req
    _close_dt(packed.blocks, syrk_plain(a, alpha=-0.5, out="packed", bn=req), m, torch.float32)
    assert _bits_equal(packed.to_dense(), dense)
    nb = -(-n // req)
    last = packed.blocks[:, -1]   # the corner block: rows and columns past n are pad
    edge = n - (nb - 1) * req
    assert not last[:, edge:].any() and not last[:, :, edge:].any()
    assert _bits_equal(ops.syrk(a[1].contiguous(), alpha=-0.5), dense[1])


@pytest.mark.parametrize("aligned", [True, False])
def test_syrk_bf16_batch_past_grid_limit(dev, aligned):
    """65,537 entries: a CTA runs a second entry after its first partial was
    staged over the ring (the producer refills it only after the epilogue),
    by TMA or by element loads (whose dead columns' zeros are stored anew);
    each entry equals its single launch."""
    rng = np.random.default_rng(63)
    a = _bf(rng, (65537, 40, 72), dev)
    if not aligned:
        a = a[..., 1:]
    assert vec16(a, a.stride(0), a.stride(1)) == aligned
    got = ops.syrk(a)
    _close_dt(got, syrk_plain(a), 40, torch.float32)
    for e in (0, 65534, 65535, 65536):
        assert _bits_equal(got[e], ops.syrk(a[e])), e


def test_gemm_tn_entry_refuses_a_kernel_that_cannot_take_the_operands(dev):
    """gemm_tn's C entry point launches the kernel the wrapper names
    (``tn_route``) and refuses, launching nothing, a tensor-core kernel for
    float32 operands, any other for bfloat16 ones, the narrow kernel past
    kNarrowMaxK and an unknown kernel index."""
    from repro_torch.kernels.gemm_tn import TN_KERNELS

    rng = np.random.default_rng(29)
    lib = _build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for dt, k, kernel, ok in ((torch.float32, 64, "narrow", True),
                              (torch.float32, 65, "narrow", False),
                              (torch.float32, 8, "tile", True),
                              (torch.float32, 8, "wgmma", False),
                              (torch.bfloat16, 8, "wgmma", True),
                              (torch.bfloat16, 8, "tile", False),
                              (torch.bfloat16, 8, "narrow", False),
                              (torch.float32, 8, 3, False)):
        a, b = _t(rng, (40, 24), dev).to(dt), _t(rng, (40, k), dev).to(dt)
        c = torch.zeros(24, k, device=dev)
        index = TN_KERNELS.index(kernel) if isinstance(kernel, str) else kernel
        err = lib.gemm_tn_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), 1, 40, 24, k, 0, 24, 0,
                              k, 1.0, 3, int(dt == torch.bfloat16), index, stream)
        torch.cuda.synchronize()
        assert (err == 0) == ok, (dt, k, kernel, err)
        if ok:
            _close(c, gemm_tn_plain(a, b), 40)
        else:
            assert not c.any(), (dt, k, kernel)


def test_cg_lstsq_never_syncs_with_the_host(dev):
    """The CG loop runs under torch.cuda.set_sync_debug_mode('error'): no
    .item(), no truth value of a tensor, no copy to the host. It makes
    iters + 1 gemm_tn launches (A·p is torch.matmul) and reaches the
    float64 solution."""
    from repro_torch.solve import cg_lstsq

    rng = np.random.default_rng(26)
    a, b = _t(rng, (4096, 1024), dev), _t(rng, (4096, 8), dev)
    cg_lstsq(a[:64, :32], b[:64], iters=2)       # build and load the kernels first
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        x = cg_lstsq(a, b, ridge=1e-3, iters=40)
        y = lstsq(a, b, ridge=1e-3, method="cg", iters=40)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launches["gemm_tn"] == 2 * 41 and sum(ops.launches.values()) == 82
    assert torch.equal(x, y)
    ad, bd = a.double(), b.double()
    x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(1024, device=dev, dtype=torch.float64),
                             ad.T @ bd)
    assert float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64)) <= 1e-3


def test_spans_on_cuda_tensors(dev):
    """With obs on, card calls record the same spans as CPU calls (kernel
    wrappers included, NVTX ranges pushed and popped) and compute bitwise
    what they compute with obs off."""
    from repro_torch import obs

    rng = np.random.default_rng(27)
    a = _t(rng, (700, 520), dev)
    off = ata(a, n_base=128, out="packed", leaf_dispatch="fused").blocks
    obs.trace.reset()
    obs.enable()
    try:
        on = ata(a, n_base=128, out="packed", leaf_dispatch="fused").blocks
        cuda_spans = obs.trace.span_counts()
        obs.trace.reset()
        ata(a.cpu(), n_base=128, out="packed", leaf_dispatch="fused")
        cpu_spans = obs.trace.span_counts()
    finally:
        obs.disable()
        obs.trace.reset()
    assert torch.equal(on, off)
    assert cuda_spans == cpu_spans
    assert cuda_spans["kernels.gemm_tn_fused"] == 3 and cuda_spans["kernels.syrk_gather"] == 1


# ---------------------------------------------------------------------------
# the planner on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def plan_cache(tmp_path, monkeypatch):
    """A cache file of the test's own and a fresh memo."""
    from repro_torch import tune

    path = tmp_path / "plans.json"
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(path))
    tune.cache.clear_memo()
    yield path
    tune.cache.clear_memo()


def test_planned_calls_launch_the_kernels(dev, plan_cache):
    """Unpinned ata, strassen_tn and lstsq on CUDA tensors are planned for
    the cuda machine (kernels on) and launch kernels; the planned result
    agrees with the pinned one."""
    from repro_torch import tune

    rng = np.random.default_rng(30)
    a, b = _t(rng, (2100, 1100), dev), _t(rng, (2100, 4), dev)
    p = tune.plan(op="ata", m=2100, n=1100, out="packed", backend="cuda")
    assert p.backend == "cuda" and p.use_kernels
    ops.reset_launches()
    got = ata(a, out="packed")
    torch.cuda.synchronize()
    assert sum(ops.launches.values()) > 0, ops.launches
    # packed storage leaves the upper corners of diagonal tiles unspecified
    _close(got.to_dense(), ata(a, out="packed", n_base=512).to_dense(), 2100)
    ops.reset_launches()
    got = strassen_tn(a, a[:, :700])
    torch.cuda.synchronize()
    assert ops.launches["gemm_tn"] + ops.launches["gemm_tn_fused"] > 0, ops.launches
    _close(got, strassen_tn(a, a[:, :700], n_base=512), 2100)
    ops.reset_launches()
    x = lstsq(a, b, ridge=1e-3)
    torch.cuda.synchronize()
    assert sum(ops.launches.values()) > 0, ops.launches
    ad = a.double()
    x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(1100, device=dev, dtype=torch.float64),
                             ad.T @ b.double())
    assert float(torch.linalg.norm(x.double() - x64) / torch.linalg.norm(x64)) <= 1e-3


def test_cuda_plan_key_names_the_card(dev, plan_cache):
    from repro_torch.tune.cache import plan_key

    key = plan_key("ata", 64, 64, 64, 0, "float32", "dense", "cuda")
    assert key.endswith(f"|dev={torch.cuda.get_device_name()}|torch={torch.__version__}")


def test_autotune_persists_on_the_card(dev, plan_cache):
    """A measured plan for ata 1024² on the card, written to the cache file
    and served from it by a fresh memo."""
    import json

    from repro_torch import tune

    p = tune.plan(op="ata", m=1024, n=1024, out="packed", backend="cuda", autotune=True)
    assert p.source == "measured" and p.measured_s > 0 and p.baseline_s > 0
    assert json.loads(plan_cache.read_text())["plans"]
    tune.cache.clear_memo()
    again = tune.plan(op="ata", m=1024, n=1024, out="packed", backend="cuda")
    assert again.source == "cache"
    assert (again.algorithm, again.n_base, again.leaf_dispatch) == (
        p.algorithm, p.n_base, p.leaf_dispatch)


@pytest.mark.parametrize("op,dims,n_base", [("ata", (4096, 2048, 2048), 256),
                                            ("ata", (3000, 2900, 2900), 512),
                                            ("gemm_tn", (2048, 1024, 1536), 256)])
@pytest.mark.parametrize("ld", ["unrolled", "batched", "fused"])
def test_peak_bytes_bounds_the_card(dev, op, dims, n_base, ld):
    """The planner's memory model (``cost.peak_bytes``, which the cuda
    machine's budget reads) holds no less than a call allocates: the
    measured peak above what was held before, plus the operands, which
    the model counts too."""
    from repro_torch.tune import cost

    m, n, k = dims
    rng = np.random.default_rng(31)
    a = _t(rng, (m, n), dev)
    b = _t(rng, (m, k), dev) if op == "gemm_tn" else None
    operands = a.nbytes + (b.nbytes if b is not None else 0)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if op == "ata":
        out = ata(a, n_base=n_base, leaf_dispatch=ld)
    else:
        out = strassen_tn(a, b, n_base=n_base, leaf_dispatch=ld)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base + operands
    del out
    assert measured <= cost.peak_bytes(op, "strassen", m, n, k, n_base, ld)


# ---------------------------------------------------------------------------
# optimizers (repro_torch.optim) and the packed path's tables on the card
# ---------------------------------------------------------------------------


def _optim_tree(rng, dev):
    return {"w": _t(rng, (96, 48), dev), "embed": _t(rng, (40, 8), dev),
            "layers": {"attn": {"wq": _t(rng, (2, 48, 4, 16), dev)}, "b": _t(rng, (48,), dev)}}


def _normwise(x, y):
    return float(torch.linalg.norm(x.double() - y.double()) / torch.linalg.norm(y.double()))


def _sync_free(fn):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("p", [2, 4])
def test_shampoo_step_on_card_matches_cpu(dev, p):
    """Shampoo (packed, 32-blocks, 16-block grams, the cutoff pinned at 16
    so the grams recurse) on CUDA tensors against the same steps on CPU
    tensors (plain versions): updates and stats within the reference's
    packed-vs-dense band (2e-3 for p = 2, 1e-4 for p = 4, normwise); p = 4
    packed bitwise equal to dense on the card."""
    from repro_torch.optim import _tree, constant, shampoo

    rng = np.random.default_rng(41)
    params, grads = _optim_tree(rng, dev), _optim_tree(rng, dev)
    to_cpu = lambda t: _tree.tree_map(lambda x: x.cpu(), t)  # noqa: E731
    runs = {}
    for where, prm, grd in (("cuda", params, grads), ("cpu", to_cpu(params), to_cpu(grads))):
        for packed in (True, False):
            opt = shampoo(constant(1e-2), block=32, update_every=2, precond_p=p,
                          packed_grams=packed, gram_block=16, n_base=16)
            st = opt.init(prm)
            us = []
            for _ in range(4):
                u, st = opt.update(grd, st, prm)
                us.append(u)
            runs[where, packed] = (us, st)
    band = 2e-3 if p == 2 else 1e-4
    (cu, cs), (pu, ps) = runs["cuda", True], runs["cpu", True]
    for a, b in zip(cu, pu):
        for x, y in zip(_tree.tree_leaves(a), _tree.tree_leaves(b)):
            assert _normwise(x.cpu(), y) <= band
    w, wc = cs["shampoo"]["w"], ps["shampoo"]["w"]
    assert _normwise(w["l"].to_dense().cpu(), wc["l"].to_dense()) <= band
    assert cs["step"].device.type == "cpu"
    if p == 4:
        for a, b in zip(runs["cuda", True][0], runs["cuda", False][0]):
            for x, y in zip(_tree.tree_leaves(a), _tree.tree_leaves(b)):
                assert torch.equal(x, y)


def test_shampoo_non_refresh_step_is_sync_free(dev):
    """After a refresh, a p = 2 packed step that does not refresh makes no
    host sync (sync debug 'error'): the step lives on the CPU and every
    table of the packed path is already on the card."""
    from repro_torch.optim import constant, shampoo

    rng = np.random.default_rng(42)
    params, grads = _optim_tree(rng, dev), _optim_tree(rng, dev)
    opt = shampoo(constant(1e-2), block=32, update_every=2, precond_p=2, gram_block=16,
                  n_base=16)
    st = opt.init(params)
    for _ in range(2):
        _, st = opt.update(grads, st, params)
    u, st = _sync_free(lambda: opt.update(grads, st, params))
    assert int(st["step"]) == 3 and torch.isfinite(u["w"]).all()


@pytest.mark.parametrize("pinned", [True, False], ids=["n_base8", "planned"])
def test_powersgd_compress_on_card_matches_cpu(dev, pinned):
    from repro_torch.optim import powersgd

    rng = np.random.default_rng(43)
    u, v = rng.standard_normal((300, 4)), rng.standard_normal((200, 4))
    g = torch.as_tensor((u @ v.T + 0.1 * rng.standard_normal((300, 200))).astype(np.float32))
    st = powersgd.init_state(torch.Generator().manual_seed(0), g.shape, 4, device="cpu")
    cst = powersgd.PowerSGDState(q=st.q.to(dev), error=st.error.to(dev))
    n_base = 8 if pinned else None
    for _ in range(2):
        p, q, st = powersgd.compress(g, st, n_base=n_base)
        cp, cq, cst = powersgd.compress(g.to(dev), cst, n_base=n_base)
        assert _normwise(cp.cpu(), p) <= 1e-4 and _normwise(cq.cpu(), q) <= 1e-4
        assert _normwise(cst.error.cpu(), st.error) <= 1e-4


def test_packed_gram_ridge_cholesky_is_sync_free(dev):
    """A packed gram, its ridge on the diagonal and the packed Cholesky
    (ragged: a pad block) copy no table to the card once the tables of
    that geometry are there."""
    from repro_torch.solve import cholesky

    a = _t(np.random.default_rng(44), (4, 300, 200), dev)

    def chain():
        g = ata_batched(a, out="packed", packed_block=64, n_base=128)
        ridge = (g.trace() / 200)[:, None, None, None]
        return cholesky(g.add_scaled_identity(ridge))

    first = chain()
    again = _sync_free(chain)
    assert torch.equal(first.blocks, again.blocks)


def test_syrk_gather_offsets_stay_on_the_card(dev):
    """syrk_gather's offset table is kept per table: a repeated launch
    copies nothing to the card (sync debug 'error')."""
    blocks = _t(np.random.default_rng(45), (4, 4, 64, 32), dev)
    rows, cols = np.array([0, 1, 3, 2]), np.array([1, 1, 0, 3])
    first = ops.syrk_gather(blocks, rows, cols)
    again = _sync_free(lambda: ops.syrk_gather(blocks, rows, cols))
    assert torch.equal(first, again)
    _close(again, syrk_gather_plain(blocks, rows, cols), 64)


# ---------------------------------------------------------------------------
# the distributed schedules on the card (2 ranks: NCCL with two cards, else
# gloo with both on card 0)
# ---------------------------------------------------------------------------


def _dist_rank(rank: int, world: int, backend: str) -> dict:
    from repro_torch.core.distributed import ata_bfs_dfs, ata_tile_parallel, gram_rowshard
    from repro_torch.launch.mesh import make_mesh

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    rng = np.random.default_rng(46)
    a = torch.as_tensor(rng.standard_normal((512, 600)).astype(np.float32), device=dev)
    mesh = make_mesh((2,), ("model",), backend=backend, device=dev)
    launches0 = dict(ops.launches)
    bfs = ata_bfs_dfs(a, mesh, interleaving="BD", nb=4, n_base=128, out="packed")
    tile = ata_tile_parallel(a, mesh, nb=4, n_base=128, out="packed")
    gram = gram_rowshard(mesh.local_block(a, ("model", None)), "model", mesh=mesh, n_base=128,
                         out="packed")
    launched = {k: ops.launches[k] - launches0[k] for k in launches0}
    return dict(bfs=bfs.to_dense().cpu().numpy(), gram=gram.to_dense().cpu().numpy(),
                bfs_is_tile=bool(torch.equal(bfs.blocks, tile.blocks)), launched=launched)


def test_distributed_schedules_on_the_card(dev):
    """``ata_bfs_dfs("BD")`` and a packed ``gram_rowshard`` over 2 ranks:
    each within tolerance of the single-device ``ata`` on the card, every
    rank bitwise alike, "BD" bitwise equal to ``ata_tile_parallel`` at the
    same grid, and the tile bodies on the gemm_tn kernel."""
    from repro_torch.launch.mesh import spawn

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    rng = np.random.default_rng(46)
    a = torch.as_tensor(rng.standard_normal((512, 600)).astype(np.float32), device=dev)
    want = ata(a, n_base=128).cpu()
    ranks = spawn(_dist_rank, 2, backend=backend, timeout_s=300.0, args=(backend,))
    for r in ranks:
        _close(torch.as_tensor(r["bfs"]), want, 512)
        _close(torch.as_tensor(r["gram"]), want, 512)
        assert r["bfs_is_tile"] and r["launched"]["gemm_tn"] > 0 and r["launched"]["syrk"] > 0
    assert np.array_equal(ranks[0]["bfs"], ranks[1]["bfs"])
    assert np.array_equal(ranks[0]["gram"], ranks[1]["gram"])


# ---------------------------------------------------------------------------
# the serving layer on the card: one captured CUDA graph per bucket
# ---------------------------------------------------------------------------


def _serve_twin(server, ticket):
    """The per-request twin of a served ticket on the card, as numpy."""
    import dataclasses

    from repro_torch.solve import solve_triangular

    req = ticket.request
    a = torch.as_tensor(req.a, device=server.device)
    b = torch.as_tensor(req.b, device=server.device)
    twin = server.request_twin(ticket.bucket, a.shape[0], 1 if b.ndim == 1 else b.shape[-1])
    if req.op == "lstsq":
        return lstsq(a, b, ridge=req.ridge, plan=twin).cpu().numpy()
    ata_plan = dataclasses.replace(twin, op="ata", k=twin.n, out="packed", method=None,
                                   predicted_s=None)
    gram = ata(a.float(), plan=ata_plan, out="packed",
               packed_block=twin.packed_block).add_scaled_identity(req.ridge)
    return solve_triangular(cholesky(gram, plan=twin), b.float(), transpose=False,
                            plan=twin).cpu().numpy()


@pytest.fixture(scope="module")
def smoke_server():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    from repro_torch.serve.engine import Server, smoke_config

    server = Server(smoke_config())
    server.warm()
    return server


def test_serve_smoke_bitwise_to_twins_without_recapture(dev, smoke_server):
    """The smoke lattice, the reference's: every served slice of the
    CLI's mixed workload bitwise equals its twin on the card, each bucket
    was captured once, and no dispatch captured again."""
    from repro_torch.serve.__main__ import _mixed_workload, _run_workload

    served, rejected = _run_workload(smoke_server, _mixed_workload(48, 3))
    assert served and all(t.done() for t in served) and rejected == 0
    assert smoke_server.retraces() == 0
    for t in served:
        np.testing.assert_array_equal(_serve_twin(smoke_server, t), t.result(),
                                      err_msg=t.bucket.label())
    progs = smoke_server.stats()["programs"]
    assert all(p["builds"] == 1 for p in progs.values())
    used = [p for p in progs.values() if p["replays"]]
    assert used and all(p["launches_per_replay"]["syrk"] == 1 for p in used)
    # m and r band as in the reference; one packed block, so the one
    # gemm_tn launch of an lstsq flush is its batched Aᵀb
    assert smoke_server.buckets == smoke_server.config.buckets
    assert any(t.request.a.shape[0] < t.bucket.m for t in served)
    assert any(t.request.b.ndim == 2 and t.request.b.shape[-1] < t.bucket.r for t in served)
    for s in smoke_server.buckets:
        p = progs.get(s.label())
        if p and p["replays"]:
            assert p["launches_per_replay"].get("gemm_tn", 0) == (s.op == "lstsq")


def _flush_launches(spec, nb):
    """Kernel launches of one flush of ``spec`` whose gram spans ``nb``
    packed blocks: the gram, the batched walk (one potrf a block column, one
    panel trsm and one Schur gemm_tn a column past the first), ``Aᵀb``
    (lstsq), and the substitutions (a Schur gemm_tn a block row past the
    first, the diagonal solves one trsm a batch slice), twice for lstsq."""
    passes = 2 if spec.op == "lstsq" else 1
    return {"syrk": 1, "potrf": nb, "trsm": (nb - 1) + passes * nb * spec.batch,
            "gemm_tn": (nb - 1) + (spec.op == "lstsq") + passes * (nb - 1)}


def test_serve_pads_m_and_r_across_the_syrk_split(dev):
    """Buckets whose m band crosses the syrk chunks (a request of 700 rows
    splits its gram over 2 CTAs a tile, the band over 4) at an n of two
    packed blocks: requests of fewer rows and fewer right-hand sides are
    admitted and served bitwise equal to their twins, each flush one replay
    of the batched program, whose launches are the batched walk's."""
    from repro_torch.core.symmetric import default_block_size
    from repro_torch.serve.bucketing import make_buckets
    from repro_torch.serve.engine import Server, ServeConfig
    from repro_torch.serve.queue import Request

    m_band, n = 2048, 256
    assert syrk_splits(700, n) < syrk_splits(1500, n) == syrk_splits(m_band, n)
    buckets = make_buckets(ops=("lstsq", "whiten"), n_values=(n,), m_bands=(m_band,),
                           r_bands=(4,), batch=2)
    server = Server(ServeConfig(buckets=buckets, capacity=8))
    assert server.buckets == buckets
    server.warm()
    rng = np.random.default_rng(60)
    served = []
    for op, m, r in (("whiten", 700, 3), ("whiten", 1500, 4), ("lstsq", 700, 2),
                     ("lstsq", m_band, 0), ("lstsq", 1500, 4)):
        rows = m if op == "lstsq" else n
        b = rng.standard_normal((rows, r) if r else (rows,), dtype=np.float32)
        served.append(server.submit(Request(op=op, a=rng.standard_normal((m, n), dtype=np.float32),
                                            b=b, ridge=1e-3)))
    server.drain()
    assert server.retraces() == 0
    for t in served:
        np.testing.assert_array_equal(_serve_twin(server, t), t.result(),
                                      err_msg=f"{t.bucket.label()} m={t.request.a.shape[0]}")
    for spec in buckets:
        fn, sp = server.bucket_callable(spec)
        nb = -(-n // default_block_size(n, sp.packed_block))
        assert nb > 1
        launched = {k: v for k, v in fn.capture_launches.items() if v}
        assert launched == _flush_launches(spec, nb), spec.label()


def _padded(x, rows):
    """``x`` with zero rows appended up to ``rows`` (leading dims kept)."""
    out = x.new_zeros((*x.shape[:-2], rows, x.shape[-1]))
    out[..., :x.shape[-2], :] = x
    return out


# (a request's m, the band it is padded to): across the chunk edges and the
# cap F(n) of CTAs a tile, 8 at n = 256 and 4 at n = 1024
SYRK_PADS = ((300, 512), (700, 2048), (1500, 2048), (1500, 8192), (2100, 4096), (4100, 8192))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("m,band", SYRK_PADS)
def test_syrk_keeps_its_bits_under_zero_row_padding(dev, dt, n, m, band):
    """syrk dense and packed and syrk_gather: a batch of m-row operands
    padded with zero rows to the band gives the operands' own grams bitwise,
    whether or not K(m, n) and K(band, n) differ."""
    rng = np.random.default_rng(m + n)
    a = _t(rng, (2, m, n), dev).to(dt)
    p = _padded(a, band)
    for out in ("dense", "packed"):
        got, want = ops.syrk(p, out=out), ops.syrk(a, out=out)
        if out == "packed":
            got, want = got.blocks, want.blocks
        assert _bits_equal(got, want), (out, syrk_splits(m, n), syrk_splits(band, n))
    grid = torch.stack([a, a.flip(0)])                      # (R, C, m, n)
    rows, cols = np.array([0, 1, 1]), np.array([0, 0, 1])
    assert _bits_equal(ops.syrk_gather(_padded(grid, band), rows, cols),
                       ops.syrk_gather(grid, rows, cols))


@pytest.mark.parametrize("m,n,r,mp,rp", [
    (33, 32, 3, 48, 4), (300, 256, 8, 512, 8), (512, 256, 37, 512, 64), (256, 512, 1, 512, 8),
    (1500, 256, 5, 8192, 8), (4100, 512, 60, 8192, 64), (700, 256, 40, 2048, 100),
    (600, 512, 70, 700, 100)])
def test_dot_tn_keeps_its_bits_under_padding_and_batching(dev, m, n, r, mp, rp):
    """``Aᵀb`` is one gemm_tn launch at every m (the narrow kernel for r ≤
    64, the tile engine above), and zero rows, zero columns and the batch
    leave its bits as they were, whichever kernel each shape lands on."""
    from repro_torch.core.strassen import _dot_tn

    rng = np.random.default_rng(m + r)
    a, b = _t(rng, (m, n), dev), _t(rng, (m, r), dev)
    ap, bp = _padded(a, mp), torch.zeros((mp, rp), device=dev)
    bp[:m, :r] = b
    ops.reset_launches()
    got = _dot_tn(a, b, torch.float32)
    pad = _dot_tn(ap, bp, torch.float32)
    assert ops.launches["gemm_tn"] == 2
    assert torch.equal(got, pad[:, :r]), (m, n, r)
    _close(got, torch.matmul(a.T, b), m)
    other = _t(rng, (mp, n), dev), _t(rng, (mp, rp), dev)
    batched = _dot_tn(torch.stack([other[0], ap]), torch.stack([other[1], bp]), torch.float32)
    assert torch.equal(batched[1, :, :r], got)
    assert torch.equal(_dot_tn(a, b[:, :1], torch.float32), got[:, :1])


@pytest.mark.parametrize("n,bn", [(512, 128), (300, 128), (1024, 256)])
def test_walk_keeps_its_bits_batched_and_padded_in_r(dev, n, bn):
    """The packed Cholesky walk of a batch of grams equals each gram's own
    walk bitwise, one Schur gemm_tn launch a block column past the first;
    the substitutions, batched and with the right-hand sides padded by zero
    columns (the diagonal solves a slice at a time, as a bucket runs them),
    equal each entry's own, the vector right-hand side included."""
    from repro_torch.serve.engine import per_slice_trsm
    from repro_torch.solve import solve_cholesky, solve_triangular

    rng = np.random.default_rng(n + bn)
    B, r, rp = 3, 5, 8
    s = _spd(rng, B, n, dev)
    nb = -(-n // bn)
    ops.reset_launches()
    f = cholesky(s, packed_block=bn)
    assert ops.launches["gemm_tn"] == nb - 1 and ops.launches["potrf"] == nb
    b = _t(rng, (B, n, r), dev)
    bp = torch.zeros((B, n, rp), device=dev)
    bp[..., :r] = b
    x = solve_cholesky(f, bp, base_trsm=per_slice_trsm)
    z = solve_triangular(f, bp, transpose=False, base_trsm=per_slice_trsm)
    for i in range(B):
        fi = cholesky(s[i], packed_block=bn)
        assert torch.equal(f.blocks[i], fi.blocks), i
        xi = solve_cholesky(fi, b[i])
        assert torch.equal(x[i, :, :r], xi), i
        assert torch.equal(z[i, :, :r], solve_triangular(fi, b[i], transpose=False)), i
        assert torch.equal(solve_cholesky(fi, b[i, :, 0]), xi[:, 0]), i
        want = torch.linalg.solve(s[i].double(), b[i].double())
        assert _normwise(xi, want) <= 1e-4


def test_serve_eager_work_on_a_flush_counts_as_a_recapture(dev):
    """A flush whose program runs the pipeline eagerly instead of replaying
    its graph launches kernels through the wrappers: the engine counts the
    launches in ``serve.retraces`` and raises."""
    from repro_torch.serve.bucketing import BucketSpec
    from repro_torch.serve.engine import Server, ServeConfig
    from repro_torch.serve.queue import Request

    spec = BucketSpec(op="lstsq", m=48, n=32, r=4, batch=2)
    server = Server(ServeConfig(buckets=(spec,), capacity=8))
    server.warm()
    fn, _ = server.bucket_callable(spec)
    per_replay = sum(fn.capture_launches.values())
    assert fn.capture_launches["syrk"] == 1 and fn.capture_launches["gemm_tn"] == 1

    class EagerGraph:
        def replay(self):
            fn._out.copy_(fn.run(*fn._inputs()))

    fn._graph = EagerGraph()
    start = server.retraces()
    rng = np.random.default_rng(65)
    with pytest.raises(RuntimeError, match="zero-recapture"):
        server.submit(Request(op="lstsq", a=rng.standard_normal((40, 32), dtype=np.float32),
                              b=rng.standard_normal((40, 2), dtype=np.float32)))
        server.drain()
    assert server.retraces() - start == per_replay
    from repro_torch.obs import metrics as obs_metrics

    obs_metrics.inc("serve.retraces", start - server.retraces())   # process-global


def test_serve_tables_survive_the_lru(dev, smoke_server):
    """Cycle the device tables' LRU past its 256 entries (every table a
    graph read is dropped from it), overwrite freed memory, and replay: the
    results stay bitwise, because the programs hold the tables."""
    from repro_torch import backend
    from repro_torch.serve.__main__ import _mixed_workload, _run_workload

    first, _ = _run_workload(smoke_server, _mixed_workload(16, 4))
    for i in range(backend._TABLES_MAX + 44):
        backend.device_table(("serve_lru_cycle", i), dev, lambda: np.full(4096, i, np.float32))
    junk = [torch.full((1 << 16,), float("nan"), device=dev) for _ in range(64)]
    again, _ = _run_workload(smoke_server, _mixed_workload(16, 4))
    del junk
    for t0, t1 in zip(first, again):
        np.testing.assert_array_equal(t0.result(), t1.result(), err_msg=t0.bucket.label())
    assert smoke_server.retraces() == 0


def test_dispatch_finish_records_nothing_while_capturing(dev):
    """A planned lstsq with obs on, captured in a CUDA graph: the
    calibration hook neither synchronises (which would break the capture)
    nor records a row."""
    from repro_torch import obs, tune

    a = _t(np.random.default_rng(61), (256, 64), dev)
    b = _t(np.random.default_rng(62), (256, 4), dev)
    plan = tune.plan(op="solve", m=256, n=64, k=4, out="packed", backend="cuda")
    assert plan.predicted_s is not None
    stream = torch.cuda.Stream()
    obs.enable()
    try:
        with torch.cuda.stream(stream):
            lstsq(a, b, plan=plan)
            torch.cuda.synchronize()
            rows = len(obs.calibrate.rows())
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream):
                x = lstsq(a, b, plan=plan)
            assert len(obs.calibrate.rows()) == rows
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(x, lstsq(a, b, plan=plan))
    finally:
        obs.disable()


def test_serve_failed_capture_raises_and_runs_nothing_eagerly(dev, monkeypatch):
    """A host sync inside the bucket's pipeline breaks the capture: warm
    raises, and a dispatch raises too instead of serving an eager result."""
    from repro_torch.serve.bucketing import BucketSpec
    from repro_torch.serve.engine import Server, ServeConfig
    from repro_torch.serve.queue import Request

    real = ops.potrf

    def syncing_potrf(*args, **kw):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()          # not permitted while capturing
        return real(*args, **kw)

    spec = BucketSpec(op="whiten", m=48, n=32, r=4, batch=2)
    server = Server(ServeConfig(buckets=(spec,), capacity=8))
    monkeypatch.setattr(ops, "potrf", syncing_potrf)
    with pytest.raises(RuntimeError):
        server.warm()
    rng = np.random.default_rng(63)
    t = None
    with pytest.raises(RuntimeError):
        t = server.submit(Request(op="whiten", a=rng.standard_normal((40, 32), dtype=np.float32),
                                  b=rng.standard_normal((32, 2), dtype=np.float32)))
        server.drain()
    assert t is None or not t.done()
    fn, _ = server.bucket_callable(spec)
    assert fn._graph is None
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# packed blocks over the kernels' 256-wide tiles: the wrappers' split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bn", [384, 512])
def test_lstsq_and_cholesky_at_wide_packed_blocks(dev, bn, dt):
    """lstsq and cholesky at a packed block over 256 compute on the card
    (each diagonal tile through the split) within the existing tolerances
    of float64, and the packed gram's factor equals the dense one's."""
    rng = np.random.default_rng(bn)
    a = _t(rng, (2048, 1024), dev).to(dt)
    b = _t(rng, (2048, 8), dev).to(dt)
    ops.reset_launches()
    x = lstsq(a, b, ridge=1e-3, method="factor", packed_block=bn)
    torch.cuda.synchronize()
    # every padded bn × bn diagonal tile splits in two
    nbk = -(-1024 // bn)
    assert ops.launches["potrf"] == nbk * ops.split_launches("potrf", bn)["potrf"], ops.launches
    assert ops.launches["syrk"] > nbk and ops.launches["gemm_tn"] > 1
    ad, bd = a.double(), b.double()
    x64 = torch.linalg.solve(ad.T @ ad + 1e-3 * torch.eye(1024, device=dev, dtype=torch.float64),
                             ad.T @ bd)
    assert _normwise(x, x64) <= 1e-3
    g = ata(a, n_base=512, out="packed", packed_block=bn)
    fp = cholesky(g, ridge=1.0)
    fd = cholesky(g.to_dense(), ridge=1.0, packed_block=bn)
    assert torch.equal(fp.blocks, fd.blocks)
    l64 = torch.linalg.cholesky(g.to_dense().double() + torch.eye(1024, device=dev,
                                                                 dtype=torch.float64))
    assert _normwise(fp.to_dense(), l64) <= 1e-5


@pytest.mark.parametrize("bn", [384, 512])
def test_shampoo_p2_at_wide_gram_blocks(dev, bn, monkeypatch):
    """Shampoo p = 2 with ``gram_block`` over 256 on the card: each refresh
    factors 384- or 512-wide tiles through the split. Each packed factor
    lies within 1e-5 (normwise) of the float64 Cholesky factor of its own
    ridged stats, and every update lies within the card-vs-CPU band of
    ``test_shampoo_step_on_card_matches_cpu`` (2e-3, normwise) of the same
    steps on CPU tensors through the same split (``ops.on_cuda`` made to
    answer True there, as in ``tests/test_torch_split.py``), so the two
    sides differ only by the kernels' rounding against the plain versions'.
    The split itself moves the updates: on the CPU, split against unsplit
    reads up to 1.70e-3 at step 1
    (``test_torch_split.py::test_shampoo_p2_split_against_unsplit``)."""
    from repro_torch.optim import _tree, constant, shampoo

    rng = np.random.default_rng(bn + 1)
    params = {"w": _t(rng, (768, 640), dev)}
    grads = [{"w": _t(rng, (768, 640), dev)} for _ in range(3)]
    runs = {}
    for where, cast in (("cuda", lambda t: t), ("cpu", lambda t: t.cpu())):
        with monkeypatch.context() as mp:
            if where == "cpu":
                mp.setattr(ops, "on_cuda", lambda *tensors: True)
            opt = shampoo(constant(1e-2), block=1024, update_every=1, precond_p=2,
                          packed_grams=True, gram_block=bn, n_base=512)
            prm = _tree.tree_map(cast, params)
            st = opt.init(prm)
            ops.reset_launches()
            us = []
            for g in grads:
                u, st = opt.update(_tree.tree_map(cast, g), st, prm)
                us.append(u["w"].cpu())
            runs[where] = (us, st, dict(ops.launches))
    (cu, st, launches), (cpu, _, _) = runs["cuda"], runs["cpu"]
    assert launches["potrf"] >= 3 * ops.split_launches("potrf", bn)["potrf"], launches
    w = st["shampoo"]["w"]
    for stat, factor in ((w["l"], w["pl"]), (w["r"], w["pr"])):
        g = stat.to_dense().double()
        d = g.shape[-1]
        tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)
        ridge = 1e-6 * (tr / d + 1e-30) + 1e-30
        l64 = torch.linalg.cholesky(g + ridge[:, None, None] * torch.eye(d, device=dev,
                                                                         dtype=torch.float64))
        assert _normwise(factor.to_dense(), l64) <= 1e-5
    assert all(torch.isfinite(x).all() for x in cu)
    for x, y in zip(cu, cpu):
        assert _normwise(x, y) <= 2e-3


def test_trace_op_nodes_equal_launches_on_the_card(dev):
    """A fake-tensor trace of one planned ata on the card records one
    ``repro_torch.*`` node per kernel launch of a real run of the same
    callable, and leaves no fake tensor in the table cache."""
    from torch._subclasses.fake_tensor import FakeTensor

    from repro_torch import backend, tune
    from repro_torch.check import run, trace_plan
    from repro_torch.check.artifacts import is_kernel
    from repro_torch.tune import apply

    plan = tune.plan(op="ata", m=4096, n=4096, out="packed", backend="cuda", dtype="float32")
    art = trace_plan(plan, device=dev)
    nodes = sum(1 for s in art.sites() if is_kernel(s.node))
    assert not any(isinstance(v, FakeTensor) for v in backend._TABLES.values())
    rng = np.random.default_rng(5)
    a = _t(rng, (4096, 4096), dev)
    ops.reset_launches()
    apply.build_callable(plan)(a)
    torch.cuda.synchronize()
    assert nodes == sum(ops.launches.values()) > 0, (nodes, ops.launches)
    assert run(art).exit_code == 0


# --- the trainer (models/, train/) ---------------------------------------------


def _smoke_train(arch, opt, device, steps=1, **opt_kw):
    """``steps`` train steps of ``arch``'s SMOKE config from one seeded init
    (made on the CPU, copied to ``device``), float32 compute; the metrics
    and the final parameters on the CPU."""
    from repro_torch.configs.base import OptimizerConfig, RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_smoke
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_map
    from repro_torch.train.train_step import make_train_step

    cfg, shape = get_smoke(arch), ShapeConfig("small", 64, 4, "train")
    params = tree_map(lambda x: x.to(device),
                      init(torch.Generator().manual_seed(0), cfg, device="cpu"))
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                    optimizer=OptimizerConfig(name=opt, lr=1e-3, warmup_steps=5, **opt_kw))
    step_fn, o = make_train_step(cfg, None, run, total_steps=50)
    state = {"params": params, "opt": o.init(params), "step": torch.zeros((), dtype=torch.int32)}
    metrics, launches = [], []
    for i in range(steps):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in make_batch(cfg, shape, 0, i).items()}
        ops.reset_launches()
        state, m = step_fn(state, batch)
        launches.append(dict(ops.launches))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, tree_map(lambda x: x.cpu(), state["params"]), launches


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "gemma-7b", "command-r-plus-104b"])
def test_forward_train_on_the_card_matches_the_cpu(dev, arch):
    """The smoke model's float32 logits on the card against the same
    weights and tokens on the CPU, within ``8·√k·eps32·max|ref|`` (k the
    longest contraction); bfloat16 within 2e-2 normwise."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.transformer import forward_train, init
    from repro_torch.optim._tree import tree_map

    cfg = get_smoke(arch)
    p = init(torch.Generator().manual_seed(1), cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=torch.Generator().manual_seed(2))
    pc = tree_map(lambda x: x.to(dev), p)
    for dt in (torch.float32, torch.bfloat16):
        ref, _ = forward_train(p, {"tokens": toks}, cfg, compute_dtype=dt)
        got, _ = forward_train(pc, {"tokens": toks.to(dev)}, cfg, compute_dtype=dt)
        assert got.device.type == "cuda" and got.dtype == dt
        got, ref = got.float().cpu(), ref.float()
        if dt == torch.float32:
            _close(got, ref, max(cfg.d_model, cfg.d_ff, 40))
        else:
            assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) <= 2e-2


def test_train_step_on_the_card_matches_the_cpu(dev):
    """One AdamW step of the qwen smoke model: loss and grad norm within
    1e-5 relative of the CPU's, every updated leaf finite and within 1e-3
    normwise of the CPU's update (Adam's first step amplifies tiny
    gradient differences where |g| is near ε)."""
    m_cpu, p_cpu, _ = _smoke_train("qwen1.5-0.5b", "adamw", "cpu")
    m_gpu, p_gpu, _ = _smoke_train("qwen1.5-0.5b", "adamw", dev)
    for k in ("loss", "grad_norm"):
        assert abs(m_gpu[0][k] - m_cpu[0][k]) <= 1e-5 * abs(m_cpu[0][k]), k
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_flatten_with_path

    p0 = tree_flatten_with_path(init(torch.Generator().manual_seed(0),
                                     get_smoke("qwen1.5-0.5b"), device="cpu"))[0]
    for (k, g), (_, c), (_, b) in zip(tree_flatten_with_path(p_gpu)[0],
                                      tree_flatten_with_path(p_cpu)[0], p0):
        assert torch.isfinite(g).all(), k
        rel = float(torch.linalg.norm(g - c) / torch.linalg.norm(c - b))
        assert rel <= 1e-3, (k, rel)


def test_shampoo_train_step_launches_the_gram_kernels(dev):
    """Two Shampoo steps of the qwen smoke model at its own widths, the
    reference's Shampoo defaults (1024-blocks, so the smoke leaves are one
    block each, and no refresh before step 10), the grams planned on
    cuda_h100: every gram stack has a side of at most 128, so each plan is
    one leaf and a step launches syrk once per gram stack (L and R of each
    of the 10 Shampoo leaves) and nothing else; the losses and grad norms
    are finite and within 1e-5 of the CPU's."""
    m_gpu, p_gpu, launches = _smoke_train("qwen1.5-0.5b", "shampoo", dev, steps=2)
    m_cpu, _, _ = _smoke_train("qwen1.5-0.5b", "shampoo", "cpu", steps=2)
    for step in launches:
        assert {k: v for k, v in step.items() if v} == {"syrk": 20}, step
    for g, c in zip(m_gpu, m_cpu):
        for k in ("loss", "grad_norm"):
            assert math.isfinite(g[k]) and abs(g[k] - c[k]) <= 1e-5 * abs(c[k]), k
    from repro_torch.optim._tree import tree_leaves

    assert all(torch.isfinite(x).all() for x in tree_leaves(p_gpu))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-1.3b", "hymba-1.5b",
                                  "deepseek-moe-16b", "musicgen-medium"])
def test_decode_step_on_the_card_matches_the_cpu(dev, arch):
    """Prefill 20 tokens and decode 3 of the smoke model, float32, on the
    card and on the CPU with the same weights: every step's logits and the
    final cache within ``8·√k·eps32·max|ref|`` (k the longest contraction
    of the model)."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.models.transformer import init
    from repro_torch.optim._tree import tree_flatten_with_path, tree_map
    from repro_torch.train.serve_step import make_decode_step, make_prefill_step

    cfg = get_smoke(arch)
    k = max(cfg.d_model, cfg.d_ff, cfg.moe.d_ff_expert if cfg.moe else 0,
            cfg.ssm.d_inner(cfg.d_model) if cfg.ssm else 0)
    p = init(torch.Generator().manual_seed(1), cfg, device="cpu")
    shape = (2, 23, cfg.num_codebooks) if cfg.num_codebooks > 1 else (2, 23)
    toks = torch.randint(0, cfg.vocab_size, shape, generator=torch.Generator().manual_seed(2))

    def run(device):
        pd = tree_map(lambda x: x.to(device), p)
        td = toks.to(device)
        lg, cache = make_prefill_step(cfg, compute_dtype=torch.float32, cache_len=23)(
            pd, {"tokens": td[:, :20]})
        outs = [lg]
        dec = make_decode_step(cfg, compute_dtype=torch.float32)
        for t in range(20, 23):
            lg, cache = dec(pd, td[:, t:t + 1], cache,
                            torch.full((2,), t, dtype=torch.int32, device=device))
            outs.append(lg)
        return outs, cache

    got, gcache = run(dev)
    ref, rcache = run("cpu")
    for g, r in zip(got, ref):
        assert g.device.type == "cuda"
        _close(g.cpu(), r, k)
    for (key, g), (_, r) in zip(tree_flatten_with_path(gcache)[0],
                                tree_flatten_with_path(rcache)[0]):
        _close(g.float().cpu(), r.float(), k)


def test_moe_combine_repeats_bitwise_on_the_card(dev):
    """The MoE layer in bfloat16 on the card, twice on the same inputs:
    bitwise equal outputs (the combine sums each token's slots in expert
    order, never with atomics), and within 2e-2 normwise of the CPU."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models.moe import init_moe, moe_layer

    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=16))
    p = init_moe(torch.Generator(device=dev).manual_seed(3), cfg, device=dev)
    x = torch.randn((4, 64, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev).bfloat16()
    a, aux_a = moe_layer(p, x, cfg)
    b, aux_b = moe_layer(p, x, cfg)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16)) and torch.equal(aux_a, aux_b)
    c, _ = moe_layer({k: v.cpu() for k, v in p.items()}, x.cpu(), cfg)
    assert float(torch.linalg.norm(a.float().cpu() - c.float()) / torch.linalg.norm(c.float())) \
        <= 2e-2
