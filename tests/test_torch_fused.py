"""The port's fused leaf dispatch against the reference, on the CPU.

``leaf_dispatch='fused'`` builds no operand stack: per-leaf ±1 slot tables
(``_slot_tables``) say which root blocks each Strassen leaf operand sums,
and the two fused kernels (``ops.gemm_tn_fused``, ``ops.syrk_gather``)
read the root-padded input through them. On a CPU tensor the wrappers run
their plain versions, which are held here against the reference's Pallas
kernels in interpret mode; the CUDA kernels run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Tolerance: ``8·√k·eps·max|ref|`` for contraction length k. Float64 cases
run the reference under a scoped ``jax.enable_x64(True)``. The reference's
three leaf dispatches agree bitwise (``tests/test_leaf_dispatch.py``); the
slowest reference calls use its batched dispatch under ``jax.jit`` instead
of its eager fused one (noted per test) to keep this file's run short.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ata as jata
from repro.core import ata_batched as jata_batched
from repro.core import strassen_tn as jstrassen
from repro.core import strassen as jstr
from repro.kernels import ops as jops
from repro_torch.core import ata, ata_batched, strassen_tn
from repro_torch.core import strassen as tstr
from repro_torch.core.ata import _level_tables
from repro_torch.kernels import ops

EPS = {np.float32: 1.19e-7, np.float64: 2.2e-16}


def _close(got, want, k, dt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 8 * math.sqrt(k) * EPS[dt] * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _per_leaf_dot(a, b):
    """A float64 plain TN base that calls matmul once per leaf, so a stack
    and its entries give the same bits."""
    if a.ndim == 2:
        return a.transpose(0, 1) @ b
    return torch.stack([x.transpose(0, 1) @ y for x, y in zip(a, b)])


def _per_leaf_syrk(a):
    if a.ndim == 2:
        c = a.transpose(0, 1) @ a
        return torch.tril(c) + torch.tril(c, -1).transpose(0, 1)
    return torch.stack([_per_leaf_syrk(x) for x in a])


# ---------------------------------------------------------------------------
# slot tables and the fused kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [0, 1, 2, 3, 4])
def test_slot_tables_equal_reference(L):
    for got_side, want_side in zip(tstr._slot_tables(L), jstr._slot_tables(L)):
        for got, want in zip(got_side, want_side):
            assert got.dtype == want.dtype == np.int32
            np.testing.assert_array_equal(got, want)
    assert tstr._slot_tables(L)[0][0].shape == (7 ** L, 2 ** L)


def _fused_inputs(shape_a, shape_b, L, seed):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = rng.standard_normal(shape_b).astype(np.float32)
    with jax.enable_x64(False):
        ja = jstr._pad_root(jnp.asarray(a), L)
        jb = jstr._pad_root(jnp.asarray(b), L)
        want = jops.gemm_tn_fused(jstr._to_blocks(ja, L)[None], jstr._to_blocks(jb, L)[None],
                                  jstr._slot_tables(L), blocks=(64, 64, 64), interpret=True)
        want = np.asarray(want)
    ta = tstr._to_blocks(tstr._pad_root(torch.as_tensor(a), L), L)[None]
    tb = tstr._to_blocks(tstr._pad_root(torch.as_tensor(b), L), L)[None]
    return ta, tb, want


@pytest.mark.parametrize("m,n,k,L", [(256, 192, 128, 1), (67, 53, 41, 1), (96, 96, 96, 2)])
def test_gemm_tn_fused_plain_matches_pallas(m, n, k, L):
    ta, tb, want = _fused_inputs((m, n), (m, k), L, m + n + k)
    got = ops.gemm_tn_fused(ta, tb, tstr._slot_tables(L))
    assert got.dtype == torch.float32
    _close(got, want, ta.shape[-2], np.float32)


@pytest.mark.parametrize("B", [1, 3])
def test_gemm_tn_fused_batched_plain_matches_pallas(B):
    ta, tb, want = _fused_inputs((B, 128, 96), (B, 128, 64), 1, 20 + B)
    got = ops.gemm_tn_fused(ta, tb, tstr._slot_tables(1), alpha=-0.5)
    assert got.shape == (7, B, 48, 32)
    _close(got, -0.5 * want, 64, np.float32)
    one = ops.gemm_tn_fused(ta[:, :, :, 0], tb[:, :, :, 0], tstr._slot_tables(1), alpha=-0.5)
    np.testing.assert_array_equal(got[:, 0].numpy(), one.numpy())


@pytest.mark.parametrize("L,batch", [(1, ()), (2, ()), (1, (2,))])
def test_syrk_gather_plain_matches_pallas(L, batch):
    rng = np.random.default_rng(40 + L + len(batch))
    size = 128 if batch else 256
    a = rng.standard_normal((*batch, size, size)).astype(np.float32)
    R = 1 << L
    s = np.arange(R * R, dtype=np.int32)
    with jax.enable_x64(False):
        jab = jstr._to_blocks(jnp.asarray(a), L)
        want = np.asarray(jops.syrk_gather(jab, s % R, s // R, blocks=(64, 64), interpret=True))
    tab = tstr._to_blocks(torch.as_tensor(a), L)
    got = ops.syrk_gather(tab, s % R, s // R)
    _close(got, want, tab.shape[-2], np.float32)
    g = got.numpy()
    np.testing.assert_array_equal(g, np.swapaxes(g, -1, -2))  # bitwise symmetric
    # the gathered stack equals syrk on the copied stack, bitwise
    stacked = tab.transpose(0, 1).reshape(R * R, *batch, *tab.shape[-2:])
    flat = ops.syrk(stacked.reshape(-1, *tab.shape[-2:]))
    np.testing.assert_array_equal(g.reshape(flat.shape), flat.numpy())


@pytest.mark.parametrize("L,lev", [(2, 1), (2, 2), (3, 1), (3, 2), (3, 3)])
def test_level_tables_equal_level_grids(L, lev):
    """One launch over the root grid with level tables computes what the
    reference's launch over that level's block grids does, bitwise."""
    rng = np.random.default_rng(L * 10 + lev)
    a = torch.as_tensor(rng.standard_normal((8 << L, 4 << L)))
    ab = tstr._to_blocks(a, L)
    R, Rl, H = 1 << L, 1 << lev, 1 << (lev - 1)
    q = R // Rl
    g = ab.reshape(Rl, q, H, 2, q, *ab.shape[-2:])
    A = torch.movedim(g[:, :, :, 1], 2, 0).reshape(H * Rl, q, q, *ab.shape[-2:])
    B = torch.movedim(g[:, :, :, 0], 2, 0).reshape(H * Rl, q, q, *ab.shape[-2:])
    want = ops.gemm_tn_fused(A, B, tstr._slot_tables(L - lev), out_dtype=torch.float64)
    got = ops.gemm_tn_fused(ab[None], ab[None], _level_tables(L, lev), out_dtype=torch.float64)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# the slice end to end against the reference
# ---------------------------------------------------------------------------


def _jit_ref(fn, *args, **kw):
    """The reference under ``jax.jit``: one compiled program instead of
    thousands of eagerly compiled ops (seconds instead of tens of them)."""
    return jax.jit(lambda *xs: fn(*xs, **kw))(*(jnp.asarray(x) for x in args))


@pytest.mark.parametrize("m,n", [(64, 64), (67, 53), (200, 100), (257, 129)])
def test_ata_fused_matches_reference(m, n):
    """Reference: its fused dispatch for the dense result of the two small
    shapes; its bitwise-equal batched dispatch, jitted, for the packed
    blocks and the larger shapes (at (257, 129), L = 5, the fused one runs
    10522 eager leaf dots)."""
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.standard_normal((m, n))
    jkw = dict(n_base=8, variant="strassen", acc_dtype=jnp.float64)
    with jax.enable_x64(True):
        if m < 100:
            want = np.asarray(jata(jnp.asarray(a), leaf_dispatch="fused", **jkw))
        else:
            want = np.asarray(_jit_ref(jata, a, leaf_dispatch="batched", **jkw))
        want_p = np.asarray(_jit_ref(jata, a, leaf_dispatch="batched", out="packed",
                                     packed_block=32, **jkw).blocks)
    ta = torch.as_tensor(a)
    got = ata(ta, n_base=8, leaf_dispatch="fused", acc_dtype=torch.float64)
    _close(got, want, m, np.float64)
    np.testing.assert_array_equal(got.numpy(), got.numpy().T)
    packed = ata(ta, n_base=8, leaf_dispatch="fused", acc_dtype=torch.float64, out="packed",
                 packed_block=32)
    _close(packed.blocks, want_p, m, np.float64)
    np.testing.assert_array_equal(packed.to_dense().numpy(), got.numpy())


@pytest.mark.parametrize("B", [1, 5])
@pytest.mark.parametrize("out", ["dense", "packed"])
def test_ata_batched_fused_matches_reference(B, out):
    rng = np.random.default_rng(22 + B)
    a = rng.standard_normal((B, 48, 28))
    kw = dict(n_base=8, variant="strassen", out=out)
    if out == "packed":
        kw["packed_block"] = 16
    with jax.enable_x64(True):
        w = jata_batched(jnp.asarray(a), leaf_dispatch="fused", acc_dtype=jnp.float64, **kw)
        want = np.asarray(w.blocks if out == "packed" else w)
    got = ata_batched(torch.as_tensor(a), leaf_dispatch="fused", acc_dtype=torch.float64, **kw)
    _close(got.blocks if out == "packed" else got, want, 48, np.float64)


@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (128, 96, 80), (67, 53, 41), (100, 200, 50),
                                   (33, 1, 7)])
def test_strassen_fused_matches_reference(m, n, k):
    """Reference: its fused dispatch, except (128, 96, 80) (L = 4, 2401
    eager leaf dots) where its bitwise-equal batched dispatch, jitted,
    stands in."""
    rng = np.random.default_rng(m + n + k)
    a, b = rng.standard_normal((m, n)), rng.standard_normal((m, k))
    jkw = dict(n_base=8, variant="strassen", acc_dtype=jnp.float64)
    with jax.enable_x64(True):
        if m == 128:
            want = np.asarray(_jit_ref(jstrassen, a, b, leaf_dispatch="batched", **jkw))
        else:
            want = np.asarray(jstrassen(jnp.asarray(a), jnp.asarray(b), leaf_dispatch="fused",
                                        **jkw))
    got = strassen_tn(torch.as_tensor(a), torch.as_tensor(b), n_base=8, leaf_dispatch="fused",
                      acc_dtype=torch.float64)
    _close(got, want, m, np.float64)


def test_strassen_fused_float32_alpha_beta_and_batch():
    rng = np.random.default_rng(5)
    a, b = rng.standard_normal((2, 3, 40, 24)), rng.standard_normal((2, 3, 40, 30))
    c = rng.standard_normal((2, 3, 24, 30))
    a, b, c = (x.astype(np.float32) for x in (a, b, c))
    with jax.enable_x64(False):
        want = np.asarray(_jit_ref(jstrassen, a, b, alpha=2.5, c=jnp.asarray(c), beta=-0.5,
                                   n_base=8, variant="strassen", leaf_dispatch="batched"))
    got = strassen_tn(torch.as_tensor(a), torch.as_tensor(b), alpha=2.5, c=torch.as_tensor(c),
                      beta=-0.5, n_base=8, leaf_dispatch="fused")
    _close(got, want, 40, np.float32)


# ---------------------------------------------------------------------------
# inside the port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(67, 53, 41), (200, 100, 77)])
def test_fused_bitwise_equals_unrolled_with_per_leaf_base(m, n, k):
    """With a base that multiplies leaf by leaf, the fused slice-gather path
    performs the unrolled recursion's adds on the same values: bitwise."""
    rng = np.random.default_rng(m * n)
    a = torch.as_tensor(rng.standard_normal((m, n)))
    b = torch.as_tensor(rng.standard_normal((m, k)))
    kw = dict(n_base=8, base_dot=_per_leaf_dot, acc_dtype=torch.float64)
    for out in ("dense", "packed"):
        u = ata(a, leaf_dispatch="unrolled", base_syrk=_per_leaf_syrk, out=out, **kw)
        f = ata(a, leaf_dispatch="fused", base_syrk=_per_leaf_syrk, out=out, **kw)
        if out == "packed":
            u, f = u.blocks, f.blocks
        np.testing.assert_array_equal(u.numpy(), f.numpy())
    np.testing.assert_array_equal(strassen_tn(a, b, leaf_dispatch="unrolled", **kw).numpy(),
                                  strassen_tn(a, b, leaf_dispatch="fused", **kw).numpy())


class _Spy:
    """Wraps the ops wrappers; records each call's operand storage."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("gemm_tn_fused", "syrk_gather", "gemm_tn", "syrk"):
            real = getattr(ops, name)

            def spy(*args, _name=name, _real=real, **kw):
                ptrs = [x.untyped_storage().data_ptr() for x in args
                        if isinstance(x, torch.Tensor)]
                self.calls.append((_name, ptrs))
                return _real(*args, **kw)

            monkeypatch.setattr(ops, name, spy)

    def names(self):
        return [c[0] for c in self.calls]


@pytest.mark.parametrize("batched", [False, True])
def test_fused_grids_share_storage_with_input(monkeypatch, batched):
    """No level grid or diagonal stack is copied: every grid that reaches a
    fused wrapper is a view of the (here unpadded) input, one gemm_tn_fused
    call per level and one syrk_gather call, no gemm_tn or syrk."""
    rng = np.random.default_rng(9)
    shape = (2, 64, 64) if batched else (64, 64)
    a = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    spy = _Spy(monkeypatch)
    fn = ata_batched if batched else ata
    fn(a, n_base=8, leaf_dispatch="fused", out="packed")
    L = 3
    assert spy.names() == ["gemm_tn_fused"] * L + ["syrk_gather"]
    base = a.untyped_storage().data_ptr()
    for _, ptrs in spy.calls:
        assert ptrs and all(p == base for p in ptrs)
    spy.calls.clear()
    strassen_tn(a, a, n_base=8, leaf_dispatch="fused")
    assert spy.names() == ["gemm_tn_fused"]
    assert all(p == base for p in spy.calls[0][1])


def test_fused_with_caller_base_makes_no_fused_launch(monkeypatch):
    spy = _Spy(monkeypatch)
    a = torch.zeros(32, 24)
    ata(a, n_base=8, leaf_dispatch="fused", base_dot=_per_leaf_dot)
    assert "gemm_tn_fused" not in spy.names() and "syrk_gather" not in spy.names()
    assert _level_tables(2, 1)[0][0].shape == (2 * 7, 2)


def test_fused_winograd_raises():
    a = torch.zeros(32, 32)
    with pytest.raises(ValueError, match="fused"):
        strassen_tn(a, a, n_base=8, variant="winograd", leaf_dispatch="fused")
    with pytest.raises(ValueError, match="fused"):
        ata(a, n_base=8, variant="winograd", leaf_dispatch="fused")
    with pytest.raises(ValueError, match="fused"):
        ata_batched(a[None], n_base=8, variant="winograd", leaf_dispatch="fused")


def test_fused_wrappers_reject_bad_tables():
    grid = torch.zeros(1, 2, 2, 8, 8)
    tables = tstr._slot_tables(1)
    with pytest.raises(ValueError):
        ops.gemm_tn_fused(grid, grid[..., :4, :], tables)        # row counts differ
    bad = ((tables[0][0] + 2, tables[0][1], tables[0][2]), tables[1])
    with pytest.raises(ValueError):
        ops.gemm_tn_fused(grid, grid, bad)                       # block row outside the grid
    with pytest.raises(ValueError):
        ops.gemm_tn_fused(grid, grid, (tables[0][:2], tables[1]))
    with pytest.raises(ValueError):
        ops.syrk_gather(grid[0], np.array([0, 2]), np.array([0, 0]))
    with pytest.raises(ValueError):
        ops.syrk_gather(grid[0, 0], np.array([0]), np.array([0]))


@pytest.mark.parametrize("batched", [False, True])
def test_fused_launch_tables_address_every_slot_block(batched):
    """The kernel's (side, leaf, slot) element offsets point at the slot
    blocks the tables name, in the grid the caller passed (a view)."""
    from repro_torch.kernels.gemm_tn import _fused_tables, fused_launch_tables

    rng = np.random.default_rng(5)
    shape = (2, 64, 96) if batched else (64, 96)
    a = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
    ab = tstr._to_blocks(a, 2)[None]
    tables = _level_tables(2, 1)
    sides, T, W = _fused_tables(ab, ab, tables)
    off, sgn, lds, sbs, vec16 = fused_launch_tables(ab, ab, sides, T, W)
    assert off.shape == (2, T, W) and sgn.shape == (2, T, W) and sgn.dtype == np.int32
    assert vec16 and lds == [96, 96] and sbs == ([64 * 96] * 2 if batched else [0, 0])
    flat = a.reshape(-1)
    for side, (rows, cols, sg) in enumerate(sides):
        assert (sgn[side] == sg).all()
        for t in range(T):
            for w in range(W):
                blk = ab[0, rows[t, w], cols[t, w]]
                first = blk.reshape(-1)[0] if not batched else blk[0, 0, 0]
                assert float(flat[off[side, t, w]]) == float(first)


def test_fused_launch_tables_choose_the_copy_width():
    """16-byte copies only where every slot base, row stride and batch
    stride is a multiple of 4 floats from a 16-byte aligned pointer."""
    from repro_torch.kernels.gemm_tn import _fused_tables, fused_launch_tables

    def vec16(x, L):
        ab = tstr._to_blocks(x, L)[None]
        tables = tstr._slot_tables(L)
        sides, T, W = _fused_tables(ab, ab, tables)
        return fused_launch_tables(ab, ab, sides, T, W)[-1]

    base = torch.zeros(1 + 64 * 64)
    assert vec16(base[:4096].view(64, 64), 2)
    assert not vec16(base[1:].view(64, 64), 2)          # starts 4 bytes past 16
    assert not vec16(torch.zeros(64, 40), 2)           # 10-column blocks
    assert not vec16(torch.zeros(64, 66)[:, :64], 2)   # row stride 66
    assert vec16(torch.zeros(3, 64, 64), 1)
    odd_batch = torch.zeros(3 * 4097).as_strided((3, 64, 64), (4097, 64, 1))
    assert not vec16(odd_batch, 1)                     # batch stride 4097


def test_fused_device_tables_kept_per_tables_object():
    """A repeated launch with the same (cached) tables object reuses its
    device tables; another object, alignment, stride or level gets its own,
    with the same contents for equal tables."""
    from repro_torch.kernels.gemm_tn import _device_launch_tables

    base = torch.zeros(1 + 64 * 64)
    ab = tstr._to_blocks(base[:4096].view(64, 64), 2)[None]
    tables = _level_tables(2, 1)
    first = _device_launch_tables(ab, ab, tables)
    assert _device_launch_tables(ab, ab, _level_tables(2, 1)) is first and first[-1]
    copy = tuple(tuple(np.array(x) for x in s) for s in tables)
    again = _device_launch_tables(ab, ab, copy)
    assert again is not first
    assert all(torch.equal(x, y) for x, y in zip(again[3:5], first[3:5]))
    shifted = tstr._to_blocks(base[1:].view(64, 64), 2)[None]
    other = _device_launch_tables(shifted, shifted, tables)
    assert other is not first and not other[-1]
    level2 = _device_launch_tables(ab, ab, _level_tables(2, 2))
    assert level2[2] == 1 and level2 is not first
