"""``repro_torch.core.symmetric`` against ``repro.core.symmetric``, bitwise.

Everything in the module but ``trace`` (a reduction) is data movement or
elementwise IEEE arithmetic, so the port must reproduce the reference
exactly (``assert_array_equal``).
Inputs come from numpy and pass to both as arrays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import symmetric as ref
from repro_torch import convert
from repro_torch.core import symmetric as port
from repro_torch.kernels.syrk import tri_coords


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _ref_packed(dense, bn):
    with jax.enable_x64(False):
        return ref.SymmetricMatrix.from_dense(jnp.asarray(dense), bn)


def _sym(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x + np.swapaxes(x, -1, -2)


@pytest.mark.parametrize("shape", [(5, 5), (3, 40, 40), (2, 3, 17, 17)])
def test_sym_tile_bitwise(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[..., 0, 0] = -0.0
    with jax.enable_x64(False):
        want = ref.sym_tile(jnp.asarray(x))
    _eq(port.sym_tile(torch.as_tensor(x)), want)


def test_default_block_size_grid():
    for n in range(1, 700, 7):
        for bn in (8, 16, 32, 64, 100, 128, 256, 512):
            assert port.default_block_size(n, bn) == ref.default_block_size(n, bn), (n, bn)


def test_index_helpers():
    for nb in (1, 2, 5, 13):
        _eq(port.diag_block_indices(nb), ref.diag_block_indices(nb))
        for a, b in zip(port.tri_block_indices(nb), ref.tri_block_indices(nb)):
            _eq(a, b)
        for j in range(nb):
            _eq(port.col_panel_indices(nb, j), ref.col_panel_indices(nb, j))


def test_tri_coords_exhaustive():
    """The kernel's (i, j) map equals tri_block_indices for every T < 10⁵."""
    nb = 446  # T = nb(nb+1)/2 = 99681
    i, j = tri_coords(np.arange(nb * (nb + 1) // 2))
    wi, wj = ref.tri_block_indices(nb)
    _eq(i, wi)
    _eq(j, wj)


@pytest.mark.parametrize("n,bn", [(40, 16), (200, 128), (64, 64), (37, 8), (129, 32)])
def test_from_dense_and_to_dense_bitwise(n, bn):
    rng = np.random.default_rng(n + bn)
    dense = _sym(rng, (n, n))
    want = _ref_packed(dense, bn)
    got = port.SymmetricMatrix.from_dense(torch.as_tensor(dense), bn)
    assert (got.n, got.bn, got.nb, got.t_total) == (want.n, want.bn, want.nb, want.t_total)
    _eq(got.blocks, want.blocks)
    _eq(got.to_dense(), want.to_dense())
    _eq(got.diagonal(), want.diagonal())
    # trace is a reduction: summation order differs, so not bitwise
    np.testing.assert_allclose(float(got.trace()), float(want.trace()), rtol=8 * n * 1.19e-7)


def test_from_dense_lower_batched_bitwise():
    rng = np.random.default_rng(1)
    lower = np.tril(rng.standard_normal((2, 3, 50, 50)).astype(np.float32))
    with jax.enable_x64(False):
        want = ref.SymmetricMatrix.from_dense_lower(jnp.asarray(lower), 16)
    got = port.SymmetricMatrix.from_dense_lower(torch.as_tensor(lower), 16)
    _eq(got.blocks, want.blocks)
    _eq(got.to_dense(), want.to_dense())


def test_block_views_bitwise():
    rng = np.random.default_rng(2)
    dense = _sym(rng, (3, 70, 70))
    want = _ref_packed(dense, 16)
    got = port.SymmetricMatrix.from_dense(torch.as_tensor(dense), 16)
    _eq(got.diag_blocks(), want.diag_blocks())
    for j in range(got.nb):
        _eq(got.col_panel(j), want.col_panel(j))
        for i in range(j, got.nb):
            _eq(got.block(i, j), want.block(i, j))
    with pytest.raises(ValueError):
        got.block(0, 1)


@pytest.mark.parametrize("s", [0.5, 3.0, 1e-3])
def test_add_scaled_identity_bitwise(s):
    rng = np.random.default_rng(3)
    dense = _sym(rng, (45, 45))
    with jax.enable_x64(False):
        want = _ref_packed(dense, 16).add_scaled_identity(s)
        wb = np.asarray(want.blocks)
    got = port.SymmetricMatrix.from_dense(torch.as_tensor(dense), 16).add_scaled_identity(s)
    _eq(got.blocks, wb)


def test_arithmetic_bitwise():
    rng = np.random.default_rng(4)
    d1, d2 = _sym(rng, (33, 33)), _sym(rng, (33, 33))
    with jax.enable_x64(False):
        w1, w2 = _ref_packed(d1, 8), _ref_packed(d2, 8)
        want = np.asarray((w1 + w2 * 0.25).scale(-3.0).blocks)
    g1 = port.SymmetricMatrix.from_dense(torch.as_tensor(d1), 8)
    g2 = port.SymmetricMatrix.from_dense(torch.as_tensor(d2), 8)
    _eq((g1 + g2 * 0.25).scale(-3.0).blocks, want)
    with pytest.raises(ValueError):
        g1.add(port.SymmetricMatrix.from_dense(torch.as_tensor(d1), 16))


def test_zeros_and_geometry():
    z = port.SymmetricMatrix.zeros(200, 128, batch=(2,), device="cpu")
    w = ref.SymmetricMatrix.zeros(200, 128, batch=(2,))
    assert tuple(z.blocks.shape) == tuple(w.blocks.shape) and z.bn == w.bn == 104
    assert z.shape == w.shape and z.nbytes == w.nbytes
    assert port.SymmetricMatrix.dense_nbytes(200, (2,)) == w.dense_nbytes(200, (2,))


@pytest.mark.parametrize("w,nb_tiles,n,packed_block", [
    (16, 4, 60, 16),    # aligned: a pure slice
    (24, 3, 70, 16),    # misaligned: re-tiled with write_packed_region
    (32, 3, 90, 128),   # misaligned, packed block clamped to n
    (20, 5, 97, 24),    # misaligned both ways, the stripes past the packed grid cut
    (40, 4, 150, 16),   # a stripe spans three block rows
    (12, 6, 64, 16),    # blocks wider than the stripes
    (30, 4, 70, 16),    # the stripe grid past the packed grid: the last stripe dropped
])
@pytest.mark.parametrize("batch", [(), (2,)])
def test_from_tile_stack_bitwise(w, nb_tiles, n, packed_block, batch):
    rng = np.random.default_rng(w + n)
    t = nb_tiles * (nb_tiles + 1) // 2
    tiles = rng.standard_normal((*batch, t + 2, w, w)).astype(np.float32)
    with jax.enable_x64(False):
        want = ref.SymmetricMatrix.from_tile_stack(jnp.asarray(tiles), n, nb=nb_tiles,
                                                   packed_block=packed_block)
        wb = np.asarray(want.blocks)
    got = port.SymmetricMatrix.from_tile_stack(torch.as_tensor(tiles), n, nb=nb_tiles,
                                               packed_block=packed_block)
    assert got.bn == want.bn
    _eq(got.blocks, wb)


def test_write_packed_region_bitwise():
    rng = np.random.default_rng(5)
    arr = rng.standard_normal((2, 30, 25)).astype(np.float32)
    buf = np.zeros((2, 10, 16, 16), np.float32)
    with jax.enable_x64(False):
        want = np.asarray(ref.write_packed_region(jnp.asarray(buf), jnp.asarray(arr), 20, 5, 16))
    got = port.write_packed_region(torch.as_tensor(buf.copy()), torch.as_tensor(arr), 20, 5, 16)
    _eq(got, want)


def test_convert_round_trip():
    rng = np.random.default_rng(6)
    dense = _sym(rng, (50, 50))
    want = _ref_packed(dense, 16)
    got = convert.symmetric_from_numpy(np.asarray(want.blocks), want.n, want.bn, device="cpu")
    _eq(got.to_dense(), want.to_dense())
    blocks, n, bn = convert.to_numpy(got)
    _eq(blocks, want.blocks)
    assert (n, bn) == (want.n, want.bn)
    with pytest.raises(ValueError):
        convert.symmetric_from_numpy(np.asarray(want.blocks)[:-1], 50, 16, device="cpu")
