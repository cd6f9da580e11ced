"""The port's kernel wrappers on the CPU (their plain versions) against the
reference's Pallas kernels in interpret mode, on the same numpy inputs.

On a CPU tensor each ``repro_torch.kernels.ops`` wrapper runs the kernel's
plain PyTorch version; the CUDA kernels themselves run only on the card
(``chip_smoke.py``). Tolerance: for a product with contraction length k,
``|port − ref| ≤ 8·√k·eps·max|ref|`` with float32 ``eps = 1.19e-7`` — the
two sides sum in different orders. The reference's own fixed 1e-5 is too
tight for float32 at these lengths and is not used.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro.kernels.gemm_tn import gemm_tn_pallas
from repro.kernels.potrf import potrf_pallas
from repro.kernels.syrk import syrk_pallas
from repro.kernels.trsm import trsm_pallas
from repro_torch.core import reference as tref
from repro_torch.core.symmetric import SymmetricMatrix
from repro_torch.kernels import ops

EPS32 = 1.19e-7


def assert_scaled_close(got, want, k):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    tol = 8 * math.sqrt(k) * EPS32 * np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol, f"max abs err {err:.3e} > tol {tol:.3e} (k={k})"


def _f32(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _spd(rng, batch, n):
    x = rng.standard_normal((batch, 2 * n, n))
    s = np.einsum("bmi,bmj->bij", x, x) / (2 * n) + np.eye(n)
    return s.astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 128, 128), (40, 100, 60), (3, 70, 200, 130),
                                   (2, 257, 129, 65), (5, 64, 96, 48),
                                   # narrow outputs (the card's tn_narrow.cu)
                                   (600, 300, 8), (2, 257, 130, 4)])
def test_gemm_tn_plain_matches_pallas(shape):
    *bt, m, n, k = shape
    rng = np.random.default_rng(sum(shape))
    a, b = _f32(rng, (*bt, m, n)), _f32(rng, (*bt, m, k))
    with jax.enable_x64(False):
        want = gemm_tn_pallas(jnp.asarray(a), jnp.asarray(b), alpha=-1.5,
                              blocks=(64, 128, 128), interpret=True)
    got = ops.gemm_tn(torch.as_tensor(a), torch.as_tensor(b), alpha=-1.5)
    assert got.dtype == torch.float32
    assert_scaled_close(got, want, m)


@pytest.mark.parametrize("shape", [(8, 128), (40, 100), (3, 70, 200), (2, 130, 300)])
def test_syrk_dense_plain_matches_pallas(shape):
    *bt, m, n = shape
    rng = np.random.default_rng(sum(shape))
    a = _f32(rng, (*bt, m, n))
    with jax.enable_x64(False):
        want = syrk_pallas(jnp.asarray(a), alpha=0.5, blocks=(64, 128), interpret=True)
    got = ops.syrk(torch.as_tensor(a), alpha=0.5)
    assert_scaled_close(got, want, m)
    g = got.numpy()
    np.testing.assert_array_equal(g, np.swapaxes(g, -1, -2))  # bitwise symmetric


@pytest.mark.parametrize("shape,request_bn", [((70, 200), 128),     # ragged: bn 104
                                              ((2, 64, 256), 128),
                                              ((40, 100), 256),
                                              ((3, 33, 150), 64)])
def test_syrk_packed_plain_matches_pallas(shape, request_bn):
    *bt, m, n = shape
    rng = np.random.default_rng(sum(shape) + request_bn)
    a = _f32(rng, (*bt, m, n))
    with jax.enable_x64(False):
        want = syrk_pallas(jnp.asarray(a), blocks=(64, request_bn), interpret=True,
                           out="packed")
        wb, wbn = np.asarray(want.blocks), want.bn
    got = ops.syrk(torch.as_tensor(a), blocks=(64, request_bn), out="packed")
    assert isinstance(got, SymmetricMatrix) and got.bn == wbn
    if (n, request_bn) == (200, 128):
        assert got.bn == 104
    assert_scaled_close(got.blocks, wb, m)
    # packed and dense agree bitwise inside the port
    np.testing.assert_array_equal(got.to_dense().numpy(),
                                  ops.syrk(torch.as_tensor(a)).numpy())


@pytest.mark.parametrize("n", [8, 64, 104, 128])
def test_potrf_plain_matches_pallas(n):
    rng = np.random.default_rng(n)
    s = _spd(rng, 3, n)
    with jax.enable_x64(False):
        want = potrf_pallas(jnp.asarray(s), interpret=True)
    got = ops.potrf(torch.as_tensor(s))
    assert_scaled_close(got, want, n)
    assert not np.triu(got.numpy(), 1).any()  # factor-tile contract
    single = ops.potrf(torch.as_tensor(s[1]))
    np.testing.assert_array_equal(single.numpy(), got[1].numpy())


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m", [8, 24, 300])
@pytest.mark.parametrize("n", [16, 64])
def test_trsm_plain_matches_pallas(transpose, m, n):
    rng = np.random.default_rng(m * n + transpose)
    with jax.enable_x64(False):
        ls = np.array(potrf_pallas(jnp.asarray(_spd(rng, 4, n)), interpret=True))
        b = _f32(rng, (4, m, n))
        want = trsm_pallas(jnp.asarray(ls), jnp.asarray(b), transpose=transpose,
                           interpret=True)
    got = ops.trsm(torch.as_tensor(ls), torch.as_tensor(b), transpose=transpose)
    assert_scaled_close(got, want, n)


@pytest.mark.parametrize("transpose", [True, False])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n", [31, 32, 33, 63, 64, 65])
def test_trsm_plain_matches_pallas_panel_edges(transpose, m, n):
    """The CUDA kernel solves in panels of 32 columns (ascending, or
    descending for ``transpose=False``): its plain version against the
    reference at one panel, one column short of and past a panel, and the
    r = 1 and r = 8 row counts of the substitutions."""
    rng = np.random.default_rng(31 * n + m + transpose)
    with jax.enable_x64(False):
        ls = np.array(potrf_pallas(jnp.asarray(_spd(rng, 2, n)), interpret=True))
        b = _f32(rng, (2, m, n))
        want = trsm_pallas(jnp.asarray(ls), jnp.asarray(b), transpose=transpose,
                           interpret=True)
    got = ops.trsm(torch.as_tensor(ls), torch.as_tensor(b), transpose=transpose)
    assert_scaled_close(got, want, n)


def _entry_points():
    """``name -> argument count`` of every ``extern "C" int name(...)`` in
    the port's CUDA sources."""
    import re

    from repro_torch.kernels import _build

    found = {}
    for path in sorted(_build.CSRC.glob("*.cu")):
        text = path.read_text()
        for match in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            args = [a for a in match.group(2).split(",") if a.strip()]
            assert match.group(1) not in found, f"{match.group(1)} defined twice"
            found[match.group(1)] = len(args)
    return found


def test_c_entry_points_match_signatures():
    """ctypes passes exactly the declared arguments: an entry point whose
    declaration lost or gained one would be called with the wrong values
    (or a pointer cut to 32 bits) without an error. Every C entry point has
    a signature of its own length, every signature an entry point, and
    every ``*_info`` entry point its resource fields."""
    from repro_torch.kernels import _build

    found = _entry_points()
    assert found, "no extern \"C\" entry points found"
    assert set(found) == set(_build.SIGNATURES), (sorted(found), sorted(_build.SIGNATURES))
    for name, count in found.items():
        assert len(_build.SIGNATURES[name]) == count, (name, count, _build.SIGNATURES[name])
    infos = {name for name in found if name.endswith("_info")}
    assert infos == set(_build.RESOURCE_FIELDS), (sorted(infos), sorted(_build.RESOURCE_FIELDS))
    assert {"gemm_tn_info", "trsm_info"} <= infos


def test_vec16_decides_the_copy_path():
    """The tile engine fills its ring in 16-byte copies only from a 16-byte
    aligned base with every stride a multiple of 4 floats."""
    from repro_torch.kernels.gemm_tn import vec16

    flat = torch.zeros(4 * 64 + 8)
    base = flat[: 4 * 64].view(4, 64)
    assert base.data_ptr() % 16 == 0 and vec16(base, 64, 0)
    assert not vec16(flat[1:4 * 64 + 1].view(4, 64), 64, 0)   # base one float past 16 B
    assert not vec16(flat[:4 * 63].view(4, 63), 63, 0)        # odd row stride
    assert not vec16(base, 64, 6)                              # batch stride 6 floats


def test_trsm_expanded_factor_matches_stacked():
    """A factor broadcast over the panel (the walk's expand) solves like the
    same factor repeated."""
    rng = np.random.default_rng(7)
    l = ops.potrf(torch.as_tensor(_spd(rng, 1, 32)[0]))
    p = torch.as_tensor(_f32(rng, (5, 32, 32)))
    np.testing.assert_array_equal(
        ops.trsm(l.expand(5, 32, 32), p).numpy(),
        ops.trsm(l.repeat(5, 1, 1), p).numpy())


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the wrappers run the plain versions: no launch counted."""
    ops.reset_launches()
    rng = np.random.default_rng(8)
    a = torch.as_tensor(_f32(rng, (16, 24)))
    ops.syrk(a)
    ops.gemm_tn(a, a)
    l = ops.potrf(ops.syrk(a) + 24 * torch.eye(24))
    ops.trsm(l, a)
    grid = a.reshape(2, 8, 2, 12).movedim(2, 1)
    ops.gemm_tn_fused(grid[None], grid[None], ((np.zeros((1, 1), np.int32),) * 2
                                               + (np.ones((1, 1), np.int32),),) * 2)
    ops.syrk_gather(grid, np.array([0, 1]), np.array([1, 0]))
    assert ops.launches == {"syrk": 0, "gemm_tn": 0, "gemm_tn_fused": 0, "syrk_gather": 0,
                            "potrf": 0, "trsm": 0}


def test_wrapper_shape_errors():
    a = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError):
        ops.gemm_tn(a, torch.zeros(3, 16, 8))
    with pytest.raises(ValueError):
        ops.gemm_tn(a, torch.zeros(16, 8))
    with pytest.raises(ValueError):
        ops.syrk(a, out="full")
    with pytest.raises(ValueError):
        ops.potrf(torch.zeros(4, 5))
    with pytest.raises(ValueError):
        ops.trsm(torch.eye(4), torch.zeros(3, 5))


def test_mixed_devices_raise():
    meta = torch.zeros(16, 8, device="meta")
    with pytest.raises(ValueError):
        ops.gemm_tn(torch.zeros(16, 8), meta)


@pytest.mark.parametrize("m,n,k", [(1, 5, 3), (67, 53, 41), (100, 200, 50), (512, 512, 512),
                                   (4096, 1024, 2048), (8192, 8192, 8192)])
@pytest.mark.parametrize("n_base", [8, 32, 128, 512])
def test_flop_counters_equal_reference(m, n, k, n_base):
    assert tref.strassen_tn_flops(m, n, k, n_base) == jref.strassen_tn_flops(m, n, k, n_base)
    assert (tref.strassen_tn_flops_winograd(m, n, k, n_base)
            == jref.strassen_tn_flops_winograd(m, n, k, n_base))
    for w in (False, True):
        assert tref.ata_flops(m, n, n_base, w) == jref.ata_flops(m, n, n_base, w)
    assert tref.classical_syrk_flops(m, n) == jref.classical_syrk_flops(m, n)
    assert tref.classical_gemm_flops(m, n, k) == jref.classical_gemm_flops(m, n, k)


@pytest.mark.parametrize("n", [1, 8, 104, 128, 600, 4096])
def test_solver_flop_counters_equal_reference(n):
    assert tref.potrf_flops(min(n, 600)) == jref.potrf_flops(min(n, 600))
    for r in (1, 8, 128):
        assert tref.trsm_flops(n, r) == jref.trsm_flops(n, r)
    for bn in (8, 32, 128):
        assert tref.blocked_potrf_flops(n, bn) == jref.blocked_potrf_flops(n, bn)


def test_reference_oracles_match():
    rng = np.random.default_rng(9)
    a, b, c = _f32(rng, (30, 20)), _f32(rng, (30, 10)), _f32(rng, (20, 10))
    with jax.enable_x64(False):
        want_g = jref.gemm_tn_ref(jnp.asarray(a), jnp.asarray(b), 2.0, jnp.asarray(c), -1.0)
        want_s = jref.syrk_ref(jnp.asarray(a), 0.5)
    assert_scaled_close(tref.gemm_tn_ref(torch.as_tensor(a), torch.as_tensor(b), 2.0,
                                         torch.as_tensor(c), -1.0), want_g, 30)
    assert_scaled_close(tref.syrk_ref(torch.as_tensor(a), 0.5), want_s, 30)


_SPLIT_MS = sorted({*range(1, 9000, 7), 32, 256, 511, 512, 513, 1024, 2047, 2048, 4100, 16384,
                    100_000})


@pytest.mark.parametrize("n", [1, 100, 129, 512, 1000, 1100, 2048, 4096])
def test_syrk_splits_bounded_and_monotone_in_m(n):
    """The syrk kernels' split K(m, n) is a power of two in [1, 8] (a
    portable cluster), does not fall as m grows, is 1 up to one chunk of
    CHUNK_ROWS rows, and is the chunk count rounded up to a power of two
    until it reaches the card's cap F(n), where it stays."""
    from repro_torch.kernels.syrk import CHUNK_ROWS, syrk_splits

    ks = [syrk_splits(m, n) for m in _SPLIT_MS]
    assert all(1 <= k <= 8 and k & (k - 1) == 0 for k in ks), ks
    assert all(a <= b for a, b in zip(ks, ks[1:])), ks
    cap = ks[-1]
    for m, k in zip(_SPLIT_MS, ks):
        chunks = -(-m // CHUNK_ROWS)
        assert k == min(cap, 1 << (chunks - 1).bit_length()), (m, k)
    assert syrk_splits(CHUNK_ROWS, n) == 1
    assert syrk_splits(512, 512) == 1          # the ata 8192² diagonal leaves stay unsplit
    if n <= 512:
        assert syrk_splits(2048, n) == 4       # lstsq's single leaf: its four chunks


def _cta_chunks(m, n):
    """The kernels' assignment (csrc/syrk.cu): CTA r of K = syrk_splits(m, n)
    sums chunks r, r + K, r + 2K, ... of the ceil(m / CHUNK_ROWS) chunks, in
    that order, and the K partials are added in rank order."""
    from repro_torch.kernels.syrk import CHUNK_ROWS, syrk_splits

    k = syrk_splits(m, n)
    return [list(range(r, -(-m // CHUNK_ROWS), k)) for r in range(k)]


# n with F(n) = 8, 8, 4, 2, 1 CTAs a tile at most
@pytest.mark.parametrize("n", [1, 512, 1024, 1536, 2048])
@pytest.mark.parametrize("m_req,m_cap", [
    (1, 512), (300, 513), (512, 513), (513, 2048), (1500, 2048), (1500, 8192), (2048, 2049),
    (2049, 4096), (4096, 4097), (3000, 5000), (4097, 8192), (5000, 100_000), (700, 700)])
def test_syrk_split_padding_invariant(n, m_req, m_cap):
    """A request of m_req rows padded with zero rows to m_cap: every chunk
    that holds real rows goes to the same CTA, in the same order, under
    K(m_cap) as under K(m_req), and the CTAs that K(m_cap) adds hold only
    zero rows — so the padded gram keeps the request's bits."""
    from repro_torch.kernels.syrk import CHUNK_ROWS

    req, cap = _cta_chunks(m_req, n), _cta_chunks(m_cap, n)
    real = -(-m_req // CHUNK_ROWS)
    assert len(cap) >= len(req)
    for r, chunks in enumerate(cap):
        assert [c for c in chunks if c < real] == (req[r] if r < len(req) else []), (r, req, cap)
    assert sorted(c for chunks in req for c in chunks) == list(range(real))


@pytest.fixture
def stub_syrk_lib(monkeypatch):
    """The syrk wrappers against a stand-in for the CUDA library that records
    each entry point's arguments (no card needed)."""
    import contextlib
    import types

    from repro_torch.kernels import _build

    calls = []

    class Lib:
        def __getattr__(self, name):
            def entry(*args):
                calls.append((name, args))
                return 0
            return entry

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    return calls


def _syrk_launches(rng, m, n):
    """(name, m, n) of each launch made: dense single, dense batched, packed
    and gathered, all of one (m, n) leaf."""
    from repro_torch.kernels.syrk import syrk_cuda, syrk_gather_cuda

    a = torch.as_tensor(_f32(rng, (3, m, n)))
    syrk_cuda(a[0])
    syrk_cuda(a)
    syrk_cuda(a, out="packed", bn=8 * (-(-n // 16)))
    grid = torch.as_tensor(_f32(rng, (2, 2, m, n)))
    syrk_gather_cuda(grid, np.array([0, 1, 1]), np.array([1, 0, 1]))


@pytest.mark.parametrize("m,n", [(1100, 40), (2048, 24), (300, 17), (4100, 9)])
def test_syrk_wrappers_pass_syrk_splits_alone(stub_syrk_lib, monkeypatch, m, n):
    """Both C entry points get K from syrk_splits(m, n) and from nothing else:
    the same value for a single leaf, a batch, packed output and a gather,
    so every dispatch sums a leaf in one order."""
    import importlib

    from repro_torch.kernels import _build

    ksyrk = importlib.import_module("repro_torch.kernels.syrk")
    rng = np.random.default_rng(m + n)
    _syrk_launches(rng, m, n)
    assert [c[0] for c in stub_syrk_lib] == ["syrk_f32"] * 3 + ["syrk_gather_f32"]
    for name, args in stub_syrk_lib:
        assert len(args) == len(_build.SIGNATURES[name]), name
        assert args[10] == ksyrk.syrk_splits(m, n), (name, args)

    asked = []
    monkeypatch.setattr(ksyrk, "syrk_splits", lambda mm, nn: asked.append((mm, nn)) or 5)
    stub_syrk_lib.clear()
    _syrk_launches(rng, m, n)
    assert asked == [(m, n)] * 4
    assert all(args[10] == 5 for _, args in stub_syrk_lib)
