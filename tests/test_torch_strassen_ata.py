"""``repro_torch`` Strassen TN and ATA against the reference's XLA path.

Float64 cases run the reference under a scoped ``jax.enable_x64(True)``
(never a module-level switch, which would leak into other test files of
the same worker) and compare with ``8·√k·eps64·max|ref|``; float32 cases
compare with ``8·√k·eps32·max|ref|``, k the contraction length. Both sides
run the same recursion and differ only in how the base products sum.

Inside the port: packed equals dense bitwise. Unrolled and batched leaf
dispatch agree here within tolerance only, because on the CPU the plain
``torch.matmul`` base may sum a batched stack in another order than its
entries; on the card the CUDA kernel's per-output order does not depend on
the batch, and ``chip_smoke.py`` asserts the two dispatches bitwise equal.
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
from repro_torch.core import SymmetricMatrix, ata, ata_batched, strassen_tn
from repro_torch.core.strassen import tree_depth

EPS = {np.float32: 1.19e-7, np.float64: 2.2e-16}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}


def _close(got, want, k, dt):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 8 * math.sqrt(k) * EPS[dt] * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e}"


def _x64(dt):
    return jax.enable_x64(dt is np.float64)


# (m, n, n_base, variant, dtype): odd, rectangular and wide shapes at two or
# three levels; float64 covers both variants, float32 the paper's schedule.
# (Each new shape costs the reference seconds of eager compilation.)
ATA_CASES = [
    (67, 53, 8, "strassen", np.float64), (67, 53, 8, "winograd", np.float64),
    (200, 100, 16, "strassen", np.float64), (200, 100, 16, "winograd", np.float64),
    (257, 129, 32, "strassen", np.float64), (257, 129, 32, "winograd", np.float64),
    (67, 53, 8, "strassen", np.float32), (64, 96, 16, "strassen", np.float32),
]


@pytest.mark.parametrize("m,n,n_base,variant,dt", ATA_CASES,
                         ids=lambda v: getattr(v, "__name__", str(v)))
def test_ata_matches_reference(m, n, n_base, variant, dt):
    """Both leaf dispatches of the port against the reference, in both
    output modes (the reference's own dispatches agree bitwise)."""
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.standard_normal((m, n)).astype(dt)
    kw = dict(n_base=n_base, variant=variant)
    with _x64(dt):
        jkw = dict(kw, acc_dtype=JDT[dt])
        want = np.asarray(jata(jnp.asarray(a), **jkw))
        wp = jata(jnp.asarray(a), out="packed", packed_block=32, **jkw)
        wpb = np.asarray(wp.blocks)
    ta = torch.as_tensor(a)
    for leaf_dispatch in ("unrolled", "batched"):
        got = ata(ta, leaf_dispatch=leaf_dispatch, acc_dtype=TDT[dt], **kw)
        _close(got, want, m, dt)
        np.testing.assert_array_equal(got.numpy(), got.numpy().T)
        packed = ata(ta, leaf_dispatch=leaf_dispatch, acc_dtype=TDT[dt], out="packed",
                     packed_block=32, **kw)
        assert isinstance(packed, SymmetricMatrix) and packed.bn == wp.bn
        _close(packed.blocks, wpb, m, dt)
        np.testing.assert_array_equal(packed.to_dense().numpy(), got.numpy())  # bitwise


@pytest.mark.parametrize("m,n,k,n_base,variant,dt", [
    (67, 53, 41, 16, "strassen", np.float64), (67, 53, 41, 16, "winograd", np.float64),
    (200, 100, 77, 32, "strassen", np.float64), (128, 96, 80, 32, "winograd", np.float64),
    (67, 53, 41, 16, "strassen", np.float32), (128, 96, 80, 32, "strassen", np.float32),
], ids=lambda v: getattr(v, "__name__", str(v)))
def test_strassen_tn_matches_reference(m, n, k, n_base, variant, dt):
    rng = np.random.default_rng(m + n + k)
    a, b = rng.standard_normal((m, n)).astype(dt), rng.standard_normal((m, k)).astype(dt)
    with _x64(dt):
        want = np.asarray(jstrassen(jnp.asarray(a), jnp.asarray(b), n_base=n_base,
                                    variant=variant, acc_dtype=JDT[dt]))
    for leaf_dispatch in ("unrolled", "batched"):
        got = strassen_tn(torch.as_tensor(a), torch.as_tensor(b), n_base=n_base,
                          variant=variant, leaf_dispatch=leaf_dispatch, acc_dtype=TDT[dt])
        _close(got, want, m, dt)


def test_strassen_alpha_beta_and_batch():
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((3, 40, 24)), rng.standard_normal((3, 40, 30))
    c = rng.standard_normal((3, 24, 30))
    with jax.enable_x64(True):
        want = np.asarray(jstrassen(jnp.asarray(a), jnp.asarray(b), alpha=2.5, c=jnp.asarray(c),
                                    beta=-0.5, n_base=8, acc_dtype=jnp.float64))
    got = strassen_tn(torch.as_tensor(a), torch.as_tensor(b), alpha=2.5, c=torch.as_tensor(c),
                      beta=-0.5, n_base=8, acc_dtype=torch.float64)
    _close(got, want, 40, np.float64)


@pytest.mark.parametrize("out", ["dense", "packed"])
def test_ata_alpha_c_beta(out):
    rng = np.random.default_rng(2)
    a = rng.standard_normal((90, 70))
    c0 = rng.standard_normal((70, 70))
    c0 = c0 + c0.T
    with jax.enable_x64(True):
        jc = jnp.asarray(c0)
        if out == "packed":
            from repro.core.symmetric import SymmetricMatrix as JSym

            jc = JSym.from_dense(jc, 32)
        want = jata(jnp.asarray(a), alpha=0.25, c=jc, beta=2.0, n_base=16,
                    acc_dtype=jnp.float64, out=out, packed_block=32)
        want = np.asarray(want.to_dense() if out == "packed" else want)
    tc = torch.as_tensor(c0)
    if out == "packed":
        tc = SymmetricMatrix.from_dense(tc, 32)
    got = ata(torch.as_tensor(a), alpha=0.25, c=tc, beta=2.0, n_base=16,
              acc_dtype=torch.float64, out=out, packed_block=32)
    got = got.to_dense() if out == "packed" else got
    _close(got, want, 90, np.float64)
    if out == "packed":
        with pytest.raises(TypeError):
            ata(torch.as_tensor(a), c=torch.as_tensor(c0), n_base=8, out="packed")


@pytest.mark.parametrize("out", ["dense", "packed"])
def test_ata_batched_matches_reference(out):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((3, 70, 45))
    with jax.enable_x64(True):
        w = jata_batched(jnp.asarray(a), n_base=8, acc_dtype=jnp.float64, out=out,
                         packed_block=16)
        want = np.asarray(w.blocks if out == "packed" else w)
    for leaf_dispatch in ("unrolled", "batched"):
        g = ata_batched(torch.as_tensor(a), n_base=8, acc_dtype=torch.float64, out=out,
                        packed_block=16, leaf_dispatch=leaf_dispatch)
        g = g.blocks if out == "packed" else g
        _close(g, want, 70, np.float64)
        # every batch entry agrees with its own single-matrix call
        one = ata(torch.as_tensor(a[1]), n_base=8, acc_dtype=torch.float64, out=out,
                  packed_block=16, leaf_dispatch=leaf_dispatch)
        _close(g[1], one.blocks if out == "packed" else one, 70, np.float64)


@pytest.mark.parametrize("m,n,n_base", [(300, 260, 32), (257, 129, 16), (512, 384, 64)])
def test_unrolled_and_batched_agree_float32(m, n, n_base):
    rng = np.random.default_rng(m + n)
    a = torch.as_tensor(rng.standard_normal((m, n)).astype(np.float32))
    u = ata(a, n_base=n_base, out="packed")
    b = ata(a, n_base=n_base, out="packed", leaf_dispatch="batched")
    _close(b.blocks, u.blocks, m, np.float32)
    d = ata(a, n_base=n_base)
    np.testing.assert_array_equal(u.to_dense().numpy(), d.numpy())


def test_ata_float32_matches_float64_product():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((512, 384)).astype(np.float32)
    got = ata(torch.as_tensor(a), n_base=64, out="packed").to_dense().double().numpy()
    want = a.astype(np.float64).T @ a.astype(np.float64)
    rel = np.linalg.norm(np.tril(got - want)) / np.linalg.norm(np.tril(want))
    assert rel <= 1e-5


def test_tree_depth_and_leaf_counts():
    assert tree_depth((8192, 8192), 512) == 4
    assert tree_depth((16384, 4096), 512) == 3
    assert tree_depth((1100, 600), 512) == 1
    L = 4
    assert 4 ** L == 256
    assert sum(2 ** (2 * lev - 1) * 7 ** (L - lev) for lev in range(1, L + 1)) == 1430


def test_unported_options_raise():
    """Options the port refuses: the fused dispatch with the Winograd
    variant (as the reference does), and unknown names."""
    a = torch.zeros(16, 16)
    with pytest.raises(ValueError, match="fused"):
        ata(a, n_base=4, variant="winograd", leaf_dispatch="fused")
    with pytest.raises(ValueError, match="fused"):
        strassen_tn(a, a, n_base=4, variant="winograd", leaf_dispatch="fused")
    with pytest.raises(ValueError):
        ata(a, leaf_dispatch="nope")
    with pytest.raises(ValueError):
        strassen_tn(a, a, variant="nope")
    with pytest.raises(ValueError):
        ata(torch.zeros(2, 3, 4))
    with pytest.raises(ValueError):
        ata(a, out="full")
