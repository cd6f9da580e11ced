"""``repro_torch.solve`` against ``repro.solve`` on the same numpy inputs.

The port's CPU path runs the plain versions of potrf/trsm (column
recurrences) where the reference runs LAPACK-lowered bases, so results
agree within tolerance: ``8·√k·eps·max|ref|`` with k the tile or system
size for factors, and relative errors stated per test for solutions (both
sides run the same blocked algorithm; only summation order differs).
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import solve as jsolve
from repro.core.ata import ata as jata
from repro_torch import convert
from repro_torch.core import SymmetricMatrix, ata
from repro_torch.solve import CholeskyFactor, cholesky, lstsq, solve_cholesky, solve_triangular

EPS32 = 1.19e-7


def _close(got, want, k):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 8 * math.sqrt(k) * EPS32 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def _grams(m, n, bn, seed, ridge=None):
    """The same packed gram on both sides: (reference, port)."""
    a = np.random.default_rng(seed).standard_normal((m, n)).astype(np.float32)
    ridge = float(n) if ridge is None else ridge
    with jax.enable_x64(False):
        jg = jata(jnp.asarray(a), n_base=32, out="packed", packed_block=bn)
        jg = jg.add_scaled_identity(ridge)
        blocks = np.asarray(jg.blocks)
    tg = convert.symmetric_from_numpy(blocks, jg.n, jg.bn, device="cpu")
    return jg, tg


# several blocks plus a pad block (n % bn != 0), and an aligned grid
@pytest.mark.parametrize("m,n,bn", [(150, 100, 32), (80, 41, 16), (96, 64, 32)])
def test_cholesky_matches_reference(m, n, bn):
    jg, tg = _grams(m, n, bn, seed=n + bn)
    with jax.enable_x64(False):
        jf = jsolve.cholesky(jg)
        want = np.asarray(jf.blocks)
    f = cholesky(tg)
    assert isinstance(f, CholeskyFactor) and f.blocks.shape == tg.blocks.shape
    _close(f.blocks, want, n)
    dense = f.to_dense().numpy()
    assert not np.triu(dense, 1).any()
    np.testing.assert_allclose(dense @ dense.T, tg.to_dense().numpy(), rtol=1e-4,
                               atol=1e-4 * float(np.abs(tg.blocks.numpy()).max()))


def test_cholesky_dense_and_packed_inputs_bitwise():
    """The walk is the same for a dense square and its packed form."""
    _, tg = _grams(120, 72, 32, seed=3)
    f_packed = cholesky(tg)
    f_dense = cholesky(tg.to_dense(), packed_block=32)
    np.testing.assert_array_equal(f_packed.blocks.numpy(), f_dense.blocks.numpy())


def test_cholesky_ridge_and_batch_dims():
    rng = np.random.default_rng(4)
    a = torch.as_tensor(rng.standard_normal((2, 60, 40)).astype(np.float32))
    from repro_torch.core import ata_batched

    g = ata_batched(a, n_base=16, out="packed", packed_block=16)
    f = cholesky(g, ridge=40.0)
    ref = torch.linalg.cholesky(g.add_scaled_identity(40.0).to_dense())
    _close(f.to_dense(), ref, 40)
    with pytest.raises(ValueError):
        cholesky(g, base_potrf=lambda s: s)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("r", [1, 5])
def test_solve_triangular_matches_reference(transpose, r):
    jg, tg = _grams(150, 100, 32, seed=7)
    b = np.random.default_rng(8).standard_normal((100, r)).astype(np.float32)
    with jax.enable_x64(False):
        jf = jsolve.cholesky(jg)
        want = np.asarray(jsolve.solve_triangular(jf, jnp.asarray(b), transpose=transpose))
        fblocks = np.asarray(jf.blocks)
    # the reference factor, carried across: isolates the substitution stage
    f = convert.factor_from_numpy(fblocks, jg.n, jg.bn, device="cpu")
    got = solve_triangular(f, torch.as_tensor(b), transpose=transpose)
    assert _rel(got, want) <= 1e-5


def test_solve_cholesky_vector_rhs():
    jg, tg = _grams(80, 41, 16, seed=9)
    b = np.random.default_rng(10).standard_normal(41).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jsolve.solve_cholesky(jsolve.cholesky(jg), jnp.asarray(b)))
    x = solve_cholesky(cholesky(tg), torch.as_tensor(b))
    assert x.shape == (41,)
    assert _rel(x, want) <= 1e-5


def test_stage_isolated_reference_gram_into_port_cholesky():
    """The JAX packed gram goes through ``convert`` into the port's walk;
    the port's factor then solves like the reference's."""
    jg, tg = _grams(150, 100, 32, seed=11, ridge=1e-3)
    rhs = np.random.default_rng(12).standard_normal((100, 3)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jsolve.solve_cholesky(jsolve.cholesky(jg), jnp.asarray(rhs)))
    x = solve_cholesky(cholesky(tg), torch.as_tensor(rhs))
    assert _rel(x, want) <= 1e-4


@pytest.mark.parametrize("packed_block", [32, 64])
def test_lstsq_matches_reference(packed_block):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((300, 150)).astype(np.float32)
    b = rng.standard_normal((300, 4)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jsolve.lstsq(jnp.asarray(a), jnp.asarray(b), method="factor",
                                       ridge=1e-3, packed_block=packed_block))
    got = lstsq(torch.as_tensor(a), torch.as_tensor(b), ridge=1e-3, packed_block=packed_block)
    assert _rel(got, want) <= 1e-4


def test_lstsq_vector_rhs_and_errors():
    rng = np.random.default_rng(14)
    a = torch.as_tensor(rng.standard_normal((120, 40)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(120).astype(np.float32))
    x = lstsq(a, b, method="factor")
    assert x.shape == (40,)
    np.testing.assert_allclose(x.numpy(), torch.linalg.lstsq(a, b[:, None]).solution[:, 0],
                               rtol=1e-3, atol=1e-4)
    xc = lstsq(a, b, method="cg")      # the CG branch computes (it raised before it was ported)
    assert xc.shape == (40,)
    np.testing.assert_allclose(xc.numpy(), x.numpy(), rtol=1e-3, atol=1e-4)
    with pytest.raises(ValueError):
        lstsq(a, b, method="qr")
    with pytest.raises(ValueError):
        lstsq(a[:, :, None], b)
    with pytest.raises(ValueError):
        lstsq(a, b[:-1])


def test_whole_slice_lstsq_against_reference():
    """lstsq at (1100, 600): a gram with L = 1 and 5 packed blocks (bn 120),
    against the reference's ``lstsq(method='factor')``; float32, relative
    error of x ≤ 1e-4 (same algorithm, different summation order)."""
    rng = np.random.default_rng(15)
    a = rng.standard_normal((1100, 600)).astype(np.float32)
    b = rng.standard_normal((1100, 3)).astype(np.float32)
    g = ata(torch.as_tensor(a), out="packed")
    assert (g.nb, g.bn) == (5, 120)
    with jax.enable_x64(False):
        want = np.asarray(jsolve.lstsq(jnp.asarray(a), jnp.asarray(b), method="factor"))
    got = lstsq(torch.as_tensor(a), torch.as_tensor(b))
    assert _rel(got, want) <= 1e-4


def test_identity_factor_and_repr():
    f = CholeskyFactor.identity(40, 16, batch=(2,), device="cpu")
    np.testing.assert_array_equal(f.to_dense().numpy(), np.stack([np.eye(40, dtype=np.float32)] * 2))
    assert "CholeskyFactor" in repr(f) and "SymmetricMatrix" in repr(
        SymmetricMatrix.zeros(8, 8, device="cpu"))
