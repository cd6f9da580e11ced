"""bfloat16 and float64 in the port, against the reference, on the CPU.

* bfloat16: each kernel's plain version (what a CPU tensor runs; the card
  tests hold the CUDA kernels against it) on bfloat16 operands, storing
  float32 or bfloat16, against the reference's Pallas kernel in interpret
  mode on the same bfloat16 values. Both load bfloat16 and sum in float32,
  in different orders; the bands are the reference's own for bfloat16:
  ``rtol=2e-2, atol=2e-2`` (``tests/test_kernels.py::_tol``) and, for the
  fused leaf launch, ``rtol=2e-2, atol=2e-1``
  (``tests/test_kernels.py::test_gemm_tn_fused_bf16_storage_f32_accumulate``).
  ``ata`` under its three leaf dispatches and ``strassen_tn`` on
  bfloat16 operands are held to the band's ``rtol`` normwise (relative
  Frobenius error ``≤ 2e-2``) against the exact product of the same
  values, as the reference is, so the two lie within twice that of each
  other: both packages round the Strassen operand
  combinations to bfloat16 at every level (XLA on the CPU may keep them in
  float32; the fused dispatch combines in float32 in both), so elementwise
  differences scale with the operands, not with each output, and the
  reference states no bitwise contract between dispatches in bfloat16.
* float64: ``ata``, ``strassen_tn`` and ``cholesky`` on float64 run the
  plain versions (no kernel takes float64; the reference's defaults compute
  float64 through ``dot_general``), held against the reference under a
  scoped ``jax.enable_x64(True)`` within ``8·√k·eps64·max|ref|`` for
  contraction length ``k``. The reference's Cholesky accumulates its Schur
  updates in float32 (``preferred_element_type``), so the port's float64
  factor is held to the exact factor within the float64 bound and to the
  reference's within the float32 one (``eps32 = 1.19e-7``).

bfloat16 values are made by rounding one float32 numpy array in each
package (both round to nearest even), so both see the same operands.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ata as jata
from repro.core import strassen_tn as jstrassen
from repro.core.strassen import _pad_root as jpad
from repro.core.strassen import _slot_tables as jslots
from repro.core.strassen import _to_blocks as jblocks
from repro.kernels import ops as jops
from repro.solve import cholesky as jcholesky
from repro_torch.backend import kernel_dtypes
from repro_torch.core import ata, strassen_tn
from repro_torch.core.ata import _level_tables
from repro_torch.core.strassen import _pad_root, _slot_tables, _to_blocks
from repro_torch.kernels import ops
from repro_torch.kernels.gemm_tn import _device_launch_tables, combine_fused_operands
from repro_torch.kernels.syrk import syrk_plain
from repro_torch.solve import cholesky

BF16 = dict(rtol=2e-2, atol=2e-2)
BF16_FUSED = dict(rtol=2e-2, atol=2e-1)
EPS64 = 2.2e-16
OUT = [torch.float32, torch.bfloat16]


def _f32(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(x):
    """The same bfloat16 values in each package."""
    return jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()


def _jout(dt):
    return jnp.bfloat16 if dt == torch.bfloat16 else jnp.float32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ref(fn, *args, **kw):
    with jax.enable_x64(False):
        out = fn(*args, **kw)
        return out if isinstance(out, tuple) else _np(getattr(out, "blocks", out))


def _check_out(got, dt):
    assert got.dtype == dt, (got.dtype, dt)


@pytest.mark.parametrize("out", OUT)
@pytest.mark.parametrize("m,n,k", [(64, 128, 128), (40, 100, 60), (130, 70, 9)])
def test_gemm_tn_plain_bf16_matches_reference_kernel(m, n, k, out):
    (ja, ta), (jb, tb) = _both(_f32((m, n), m)), _both(_f32((m, k), n))
    want = _ref(jops.gemm_tn, ja, jb, blocks=(64, 64, 64), interpret=True, out_dtype=_jout(out))
    got = ops.gemm_tn(ta, tb, out_dtype=out)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16)


@pytest.mark.parametrize("out", OUT)
@pytest.mark.parametrize("mode", ["dense", "packed"])
@pytest.mark.parametrize("m,n", [(40, 100), (64, 256), (130, 70)])
def test_syrk_plain_bf16_matches_reference_kernel(m, n, mode, out):
    ja, ta = _both(_f32((m, n), m + n))
    want = _ref(jops.syrk, ja, blocks=(64, 64), interpret=True, out_dtype=_jout(out), out=mode)
    got = ops.syrk(ta, blocks=(64, 64), out_dtype=out, out=mode)
    got = getattr(got, "blocks", got)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16)


@pytest.mark.parametrize("out", OUT)
@pytest.mark.parametrize("L", [1, 2])
def test_gemm_tn_fused_plain_bf16_matches_reference_kernel(L, out):
    (ja, ta), (jb, tb) = _both(_f32((128, 96), 30 + L)), _both(_f32((128, 64), 40 + L))
    with jax.enable_x64(False):
        jab, jbb = jblocks(jpad(ja, L), L)[None], jblocks(jpad(jb, L), L)[None]
    tab, tbb = _to_blocks(_pad_root(ta, L), L)[None], _to_blocks(_pad_root(tb, L), L)[None]
    want = _ref(jops.gemm_tn_fused, jab, jbb, jslots(L), blocks=(64, 64, 64), interpret=True,
                out_dtype=_jout(out))
    got = ops.gemm_tn_fused(tab, tbb, _slot_tables(L), out_dtype=out)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16_FUSED)


@pytest.mark.parametrize("out", OUT)
def test_syrk_gather_plain_bf16_matches_reference_kernel(out):
    L, R = 2, 4
    ja, ta = _both(_f32((2, 200, 130), 50))
    with jax.enable_x64(False):
        jab = jblocks(jpad(ja, L), L)
    tab = _to_blocks(_pad_root(ta, L), L)
    s = np.arange(R * R)
    want = _ref(jops.syrk_gather, jab, s % R, s // R, blocks=(64, 64), interpret=True,
                out_dtype=_jout(out))
    got = ops.syrk_gather(tab, s % R, s // R, out_dtype=out)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16)


def _spd(n, seed):
    x = np.random.default_rng(seed).standard_normal((3, 2 * n, n))
    return (np.einsum("bki,bkj->bij", x, x) / (2 * n) + np.eye(n)).astype(np.float32)


@pytest.mark.parametrize("out", OUT)
@pytest.mark.parametrize("n", [1, 33, 64])
def test_potrf_plain_bf16_matches_reference_kernel(n, out):
    js, ts = _both(_spd(n, n))
    want = _ref(jops.potrf, js, interpret=True, out_dtype=_jout(out))
    got = ops.potrf(ts, out_dtype=out)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16)
    assert not torch.triu(got.float(), 1).any()


@pytest.mark.parametrize("out", OUT)
@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m,n", [(8, 32), (12, 33)])
def test_trsm_plain_bf16_matches_reference_kernel(m, n, transpose, out):
    l = np.linalg.cholesky(_spd(n, m + n).astype(np.float64)).astype(np.float32)
    (jl, tl), (jb, tb) = _both(l), _both(_f32((3, m, n), n))
    want = _ref(jops.trsm, jl, jb, transpose=transpose, interpret=True, out_dtype=_jout(out))
    got = ops.trsm(tl, tb, transpose=transpose, out_dtype=out)
    _check_out(got, out)
    np.testing.assert_allclose(_np(got), want, **BF16)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_ata_bf16_matches_reference(leaf_dispatch):
    """bfloat16 operands, float32 accumulation, all three dispatches (L = 3):
    the port against the reference's pinned call, and both against the
    exact product of the same bfloat16 values, within the band's rtol
    normwise."""
    ja, ta = _both(_f32((96, 80), 60))
    want = _ref(jata, ja, n_base=16, leaf_dispatch=leaf_dispatch)
    got = ata(ta, n_base=16, leaf_dispatch=leaf_dispatch)
    assert got.dtype == torch.float32
    _both_in_band(got, want, (ta.double().T @ ta.double()).numpy())


def _both_in_band(got, want, exact):
    """Port and reference each within the band's rtol of the exact product
    (normwise), hence within twice it of each other."""
    assert _rel(got, exact) <= BF16["rtol"] and _rel(want, exact) <= BF16["rtol"]
    diff = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    assert np.linalg.norm(diff) <= 2 * BF16["rtol"] * np.linalg.norm(exact)


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_strassen_tn_bf16_matches_reference(leaf_dispatch):
    """L = 2 (n_base 24): the rounding of the combinations grows with the
    depth, and at L = 3 (n_base 16) both packages' unrolled products land at
    2.1e-2 of the exact one, past the band — the algorithm's, not the
    port's (the port's fused dispatch combines in float32 and stays near
    float32 accuracy)."""
    (ja, ta), (jb, tb) = _both(_f32((96, 80), 61)), _both(_f32((96, 70), 62))
    want = _ref(jstrassen, ja, jb, n_base=24, leaf_dispatch=leaf_dispatch)
    got = strassen_tn(ta, tb, n_base=24, leaf_dispatch=leaf_dispatch)
    _both_in_band(got, want, (ta.double().T @ tb.double()).numpy())


def _close64(got, want, k):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    tol = 8 * math.sqrt(k) * EPS64 * np.abs(want).max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
@pytest.mark.parametrize("acc", ["operand", "acc_dtype"])
def test_ata_float64_matches_reference(leaf_dispatch, acc):
    """float64 as the operand's dtype, or as ``acc_dtype`` of a float32
    operand: the plain bases, no kernel wrapper called."""
    a = np.random.default_rng(63).standard_normal((90, 70))
    if acc == "acc_dtype":
        a = a.astype(np.float32)
    with jax.enable_x64(True):
        want = np.asarray(jata(jnp.asarray(a), n_base=16, leaf_dispatch=leaf_dispatch,
                               acc_dtype=jnp.float64))
    from repro_torch.obs import metrics

    metrics.reset()
    got = ata(torch.as_tensor(a), n_base=16, leaf_dispatch=leaf_dispatch,
              acc_dtype=torch.float64)
    assert got.dtype == torch.float64
    assert not metrics.counters("kernels."), metrics.counters("kernels.")
    _close64(got, want, 90)


@pytest.mark.parametrize("leaf_dispatch", ["unrolled", "batched", "fused"])
def test_strassen_tn_float64_matches_reference(leaf_dispatch):
    rng = np.random.default_rng(64)
    a, b = rng.standard_normal((90, 70)), rng.standard_normal((90, 50))
    with jax.enable_x64(True):
        want = np.asarray(jstrassen(jnp.asarray(a), jnp.asarray(b), n_base=16,
                                    leaf_dispatch=leaf_dispatch, acc_dtype=jnp.float64))
    got = strassen_tn(torch.as_tensor(a), torch.as_tensor(b), n_base=16,
                      leaf_dispatch=leaf_dispatch, acc_dtype=torch.float64)
    assert got.dtype == torch.float64
    _close64(got, want, 90)


def test_cholesky_float64_matches_reference():
    """A float64 packed gram factors through the plain potrf/trsm."""
    rng = np.random.default_rng(65)
    x = rng.standard_normal((300, 100))
    g64 = x.T @ x / 300 + np.eye(100)
    with jax.enable_x64(True):
        want = np.asarray(jcholesky(jnp.asarray(g64), packed_block=32).to_dense())
    got = cholesky(torch.as_tensor(g64), packed_block=32)
    assert got.blocks.dtype == torch.float64
    _close64(got.to_dense(), np.linalg.cholesky(g64), 100)
    err = np.abs(got.to_dense().numpy() - want).max()
    assert err <= 8 * math.sqrt(100) * 1.19e-7 * np.abs(want).max()


def test_kernel_dtypes_rule():
    """What a CUDA launch is handed: float32 or bfloat16 operands in one
    load type (a bfloat16 beside a float32 widened, exactly), a float32 or
    bfloat16 output; float64 refused."""
    f, h = torch.ones(2, 3), torch.ones(2, 3, dtype=torch.bfloat16)
    (x, y), code = kernel_dtypes(f, h, out_dtype=torch.float32, what="t")
    assert code == 0 and x.dtype == y.dtype == torch.float32
    (x, y), code = kernel_dtypes(h, h, out_dtype=torch.bfloat16, what="t")
    assert code == 3 and x.dtype == torch.bfloat16
    assert kernel_dtypes(h, out_dtype=torch.float32, what="t")[1] == 1
    assert kernel_dtypes(f, out_dtype=torch.bfloat16, what="t")[1] == 2
    with pytest.raises(TypeError):
        kernel_dtypes(f.double(), out_dtype=torch.float32, what="t")
    with pytest.raises(TypeError):
        kernel_dtypes(f, out_dtype=torch.float64, what="t")
    assert ops.bases(torch.float32, torch.float64).gemm_tn_fused is None
    assert ops.bases(torch.float64).syrk is syrk_plain
    assert ops.bases(torch.bfloat16, torch.float32).gemm_tn is ops.gemm_tn


def test_level_tables_unchanged_by_dtype():
    """The fused level launch reads the same slot tables whatever the
    element type: only the load, the combine's rounding (bfloat16 blocks
    are combined in bfloat16, each add rounded, as the reference's kernel
    and the unrolled recursion do) and the store change. Each launch is
    gemm_tn on its own type's combined operands of the same tables, and
    the two lie within the reference's band for the fused bfloat16 launch
    of each other."""
    a16 = torch.as_tensor(_f32((64, 48), 66)).bfloat16()
    tables = _level_tables(2, 1)
    b16, b32 = _to_blocks(a16, 2)[None], _to_blocks(a16.float(), 2)[None]
    got = ops.gemm_tn_fused(b16, b16, tables)
    want = ops.gemm_tn_fused(b32, b32, tables)
    for blocks, out in ((b16, got), (b32, want)):
        xa, xb = (combine_fused_operands(blocks, *side) for side in tables)
        assert xa.dtype == blocks.dtype
        assert torch.equal(out, ops.gemm_tn(xa, xb))
    np.testing.assert_allclose(_np(got), _np(want), **BF16_FUSED)


def _offset_view(shape, dtype, nbytes):
    """A contiguous ``shape`` view that starts ``nbytes`` past its buffer."""
    pad = nbytes // torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(math.prod(shape) + pad, dtype=dtype)
    assert flat.data_ptr() % 16 == 0
    return flat[pad:].view(shape)


def test_fused_launch_tables_keyed_by_dtype():
    """The fused launch's cached tables hold ``vec16``, which depends on the
    element size: a bfloat16 and a float32 grid with the same shapes,
    strides and pointer offset (8 bytes past a 16-byte boundary) and the
    same tables object get their own entries — 16-byte copies for the
    bfloat16 one, element copies for the float32 one."""
    tables = _slot_tables(1)
    got = {}
    for dt in (torch.bfloat16, torch.float32, torch.bfloat16):
        ab = _to_blocks(_offset_view((64, 64), dt, 8), 1)[None]
        got.setdefault(dt, set()).add(_device_launch_tables(ab, ab, tables)[-1])
    assert got == {torch.bfloat16: {True}, torch.float32: {False}}
