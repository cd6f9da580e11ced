"""The port's matrix-free CG (``solve/cg.py``, ``lstsq(method='cg')``)
against the reference, on the CPU.

The same numpy inputs go through ``repro.solve.cg`` (each call inside a
scoped ``jax.enable_x64(False)``) and ``repro_torch.solve.cg``. The designs
are ``A = U·diag(s)·Vᵀ`` with ``s`` in ``[1, 3]``, so ``κ(AᵀA) = 9 ≤ 10``.

Tolerances: both packages run float32 CG with per-column steps and sum in
different orders, so iterates agree to rounding, not bitwise. After a
converged solve (the float32 floor at ``κ ≤ 10``) ``x`` agrees within a
relative ``1e-4`` (Frobenius); after a few iterations (not converged) the
iterates agree within ``1e-4`` as well — each step is well conditioned.
Exact zeros (frozen columns) are compared exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro.solve import cg as jcg
from repro.solve.lstsq import lstsq as jlstsq
from repro_torch.core import reference as tref
from repro_torch.kernels import ops
from repro_torch.obs import metrics
from repro_torch.solve import cg_gram, cg_lstsq, lstsq

REL = 1e-4


def _design(m, n, seed):
    """(A, U, s, V) with A = U·diag(s)·Vᵀ, s in [1, 3]: κ(AᵀA) = 9."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((m, n)))
    v, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.linspace(3.0, 1.0, n)
    return (u * s) @ v.T, u, s, v


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ref(fn, *args, **kw):
    with jax.enable_x64(False):
        return np.asarray(fn(*args, **kw))


def test_design_condition_number():
    a, _, _, _ = _design(200, 30, 0)
    assert np.linalg.cond(a.T @ a) <= 10.0


@pytest.mark.parametrize("iters,tol", [(30, 1e-6), (5, 1e-6), (40, 1e-3)])
@pytest.mark.parametrize("r", [None, 1, 3])
def test_cg_gram_matches_reference(iters, tol, r):
    """Generic SPD-operator CG: vector and matrix right-hand sides, budgets
    that converge and that stop early, a loose tolerance that freezes
    columns early."""
    a, _, _, _ = _design(120, 30, 1)
    g = (a.T @ a + 0.1 * np.eye(30)).astype(np.float32)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((30,) if r is None else (30, r)).astype(np.float32)
    want = _ref(jcg.cg_gram, lambda x: jnp.asarray(g) @ x, jnp.asarray(b), iters=iters, tol=tol)
    gt = torch.as_tensor(g)
    got = cg_gram(lambda x: gt @ x, torch.as_tensor(b), iters=iters, tol=tol)
    assert got.dtype == torch.float32 and tuple(got.shape) == b.shape
    assert _rel(got, want) <= REL


def test_cg_gram_freezes_converged_columns():
    """A zero right-hand side column is converged before the first step:
    its x stays exactly zero while the other columns iterate; a column whose
    right-hand side is an eigenvector converges in one step and then stays
    where that step put it."""
    a, _, s, v = _design(150, 24, 3)
    g = (a.T @ a).astype(np.float32)
    rng = np.random.default_rng(4)
    b = rng.standard_normal((24, 3)).astype(np.float32)
    b[:, 1] = 0.0
    b[:, 2] = v[:, 0].astype(np.float32)            # eigenvector of g, eigenvalue s[0]²
    gt = torch.as_tensor(g)
    got = cg_gram(lambda x: gt @ x, torch.as_tensor(b), iters=24)
    want = _ref(jcg.cg_gram, lambda x: jnp.asarray(g) @ x, jnp.asarray(b), iters=24)
    assert torch.equal(got[:, 1], torch.zeros(24))
    np.testing.assert_array_equal(want[:, 1], np.zeros(24, np.float32))
    one = cg_gram(lambda x: gt @ x, torch.as_tensor(b[:, 2]), iters=1)
    assert torch.equal(got[:, 2], one), "the eigenvector column moved after converging"
    np.testing.assert_allclose(got[:, 2].numpy(), v[:, 0] / s[0] ** 2, rtol=1e-5, atol=1e-6)
    assert _rel(got, want) <= REL


@pytest.mark.parametrize("ridge", [0.0, 0.25])
@pytest.mark.parametrize("r", [None, 4])
def test_cg_lstsq_matches_reference(ridge, r):
    """Ridge off and on, vector and matrix right-hand sides, against the
    reference pinned to the same static dispatch (``n_base``/``variant``),
    and both within REL of the float64 solution."""
    a, _, _, _ = _design(400, 48, 5)
    rng = np.random.default_rng(6)
    b = rng.standard_normal((400,) if r is None else (400, r))
    a32, b32 = a.astype(np.float32), b.astype(np.float32)
    want = _ref(jcg.cg_lstsq, jnp.asarray(a32), jnp.asarray(b32), ridge=ridge, n_base=512,
                variant="strassen")
    got = cg_lstsq(torch.as_tensor(a32), torch.as_tensor(b32), ridge=ridge, n_base=512,
                   variant="strassen")
    assert tuple(got.shape) == want.shape
    assert _rel(got, want) <= REL
    exact = np.linalg.solve(a.T @ a + ridge * np.eye(48), a.T @ b)
    assert _rel(got, exact) <= REL


def test_cg_lstsq_iters_and_tol_overrides():
    """``iters``/``tol`` reach the loop: 3 iterations are not converged and
    agree with the reference's 3; the default budget is min(n, 64)."""
    a, _, _, _ = _design(300, 40, 7)
    b = np.random.default_rng(8).standard_normal((300, 2)).astype(np.float32)
    a32 = a.astype(np.float32)
    kw = dict(ridge=1e-3, n_base=512, variant="strassen")
    short = cg_lstsq(torch.as_tensor(a32), torch.as_tensor(b), iters=3, tol=1e-4, **kw)
    want = _ref(jcg.cg_lstsq, jnp.asarray(a32), jnp.asarray(b), iters=3, tol=1e-4, **kw)
    assert _rel(short, want) <= REL
    full = cg_lstsq(torch.as_tensor(a32), torch.as_tensor(b), **kw)
    assert _rel(short, full) > 1e-3, "3 iterations should not be converged"
    metrics.reset()
    cg_lstsq(torch.as_tensor(a32), torch.as_tensor(b), **kw)
    assert metrics.gauges()["solve.cg.iters"] == 40.0


def test_cg_lstsq_runs_one_tn_product_per_iteration():
    """Each iteration applies Aᵀ(·) through strassen_tn, which at r ≤
    n_base is one leaf product; Aᵀb is one more: iters + 1 in all. The
    unpinned call is planned (on the CPU the plan's bases are the plain
    versions, which no ``kernels.launch`` counter sees); the pinned one
    calls the ``ops.gemm_tn`` wrapper once a product."""
    a, _, _, _ = _design(300, 40, 9)
    b = torch.as_tensor(np.random.default_rng(10).standard_normal((300, 8)).astype(np.float32))
    metrics.reset()
    cg_lstsq(torch.as_tensor(a.astype(np.float32)), b, iters=7)
    assert sum(metrics.counters("dispatch.gemm_tn.").values()) == 8
    assert metrics.get("gemm_tn.leaves") == 8
    assert metrics.get("solve.cg.calls") == 1
    metrics.reset()
    cg_lstsq(torch.as_tensor(a.astype(np.float32)), b, iters=7, n_base=512)
    assert metrics.get("kernels.launch.gemm_tn") == 8


@pytest.mark.parametrize("ridge", [0.0, 1e-2])
def test_lstsq_cg_matches_reference(ridge):
    """The front door with ``method='cg'`` pinned, against the reference's
    pinned ``method='cg'``, and against the port's factor path."""
    a, _, _, _ = _design(500, 64, 11)
    b = np.random.default_rng(12).standard_normal((500, 3)).astype(np.float32)
    a32 = a.astype(np.float32)
    want = _ref(jlstsq, jnp.asarray(a32), jnp.asarray(b), ridge=ridge, method="cg")
    got = lstsq(torch.as_tensor(a32), torch.as_tensor(b), ridge=ridge, method="cg")
    assert _rel(got, want) <= REL
    factor = lstsq(torch.as_tensor(a32), torch.as_tensor(b), ridge=ridge, method="factor")
    assert _rel(got, factor) <= REL
    vec = lstsq(torch.as_tensor(a32), torch.as_tensor(b[:, 0]), ridge=ridge, method="cg",
                iters=10, tol=1e-3)
    want_vec = _ref(jlstsq, jnp.asarray(a32), jnp.asarray(b[:, 0]), ridge=ridge,
                    method="cg", iters=10, tol=1e-3)
    assert vec.shape == (64,) and _rel(vec, want_vec) <= REL


def test_lstsq_default_method_is_factor():
    from repro_torch.tune import defaults

    assert defaults.DEFAULT_SOLVE_METHOD == "factor"
    assert (defaults.CG_MAX_ITERS, defaults.CG_TOL) == (64, 1e-6)
    a, _, _, _ = _design(120, 20, 13)
    b = torch.as_tensor(np.random.default_rng(14).standard_normal(120).astype(np.float32))
    metrics.reset()
    lstsq(torch.as_tensor(a.astype(np.float32)), b)
    assert metrics.get("dispatch.solve.factor") == 1 and metrics.get("dispatch.solve.cg") == 0


def test_cg_lstsq_rejects_bad_shapes():
    with pytest.raises(ValueError):
        cg_lstsq(torch.zeros(4, 3, 2), torch.zeros(4))


@pytest.mark.parametrize("m", [1, 7, 512, 16384])
@pytest.mark.parametrize("n", [1, 33, 4096])
@pytest.mark.parametrize("r", [1, 8, 9])
def test_cg_iteration_flops_equal_reference(m, n, r):
    assert tref.cg_iteration_flops(m, n, r) == jref.cg_iteration_flops(m, n, r)


def test_cg_iteration_flops_at_lstsq_shape():
    assert tref.cg_iteration_flops(16384, 4096, 8) == 2_147_876_864


def test_cpu_cg_launches_no_kernel():
    """On CPU tensors the wrappers run their plain versions: the CUDA launch
    counters stay at zero."""
    a, _, _, _ = _design(100, 16, 15)
    ops.reset_launches()
    cg_lstsq(torch.as_tensor(a.astype(np.float32)), torch.ones(100), iters=4)
    assert all(v == 0 for v in ops.launches.values())
    assert ops.narrow_launches == {"gemm_tn_narrow": 0}
