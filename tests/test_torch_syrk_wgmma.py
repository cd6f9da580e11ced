"""The bfloat16 tensor-core path of syrk and syrk_gather, on the CPU.

On the card, bfloat16 operands of ``syrk`` and ``syrk_gather`` run
``syrk_wgmma_kernel`` (``csrc/syrk.cu``), float32 ones the FMA tile
engine. What of that choice lives on the host is held here:

* the route (``syrk_route``): a pure function of the operand type and the
  alignment, float32 never on the tensor cores;
* the gathered launch's two tables: the box coordinates ``(rows[s],
  cols[s])`` that the tensor map reads and the element offsets that the
  element fill reads name the same leaf, for every entry of ata's gathers;
* the counters: ``wgmma_launches`` has the two syrk keys, and
  ``ops.reset_launches`` clears them and ``tma_refused``;
* each wrapper calls the C entry point of its route with the split
  ``syrk_splits(m, n)``, the copy flag, and (gathered) the grid's shape and
  strides, against a stand-in for the CUDA library.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import contextlib
import importlib
import types

import numpy as np
import pytest
import torch

from repro_torch.core.strassen import _pad_root, _to_blocks
from repro_torch.kernels import _build, ops
from repro_torch.kernels.gemm_tn import vec16

ksyrk = importlib.import_module("repro_torch.kernels.syrk")


def _bf(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
                           ).bfloat16()


@pytest.mark.parametrize("aligned", [True, False])
def test_syrk_route_is_a_function_of_dtype_and_alignment(aligned):
    """bfloat16 runs the tensor-core kernel, by TMA where aligned (1) and by
    element loads otherwise (0); float32 the FMA engine with 16-byte or
    element copies, never the tensor cores; other types raise."""
    assert ksyrk.syrk_route(torch.bfloat16, aligned) == ("wgmma", int(aligned))
    assert ksyrk.syrk_route(torch.float32, aligned) == ("fma", int(aligned))
    for dt in (torch.float64, torch.float16):
        with pytest.raises(TypeError):
            ksyrk.syrk_route(dt, aligned)


def _ata_grids(L):
    """ata's gathers at depth L, single and batched: the block grid of the
    padded root and the fused dispatch's diagonal tables s % R, s // R."""
    for shape in ((37 << L, 11 << L), (2, 21 << L, 9 << L)):
        ab = _to_blocks(_pad_root(_bf(shape, L), L), L)
        R = 1 << L
        s = np.arange(R * R)
        yield ab, s % R, s // R


@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_gather_coordinates_and_offsets_name_the_same_leaf(L):
    """For every entry of ata's grids (batched and not): the element that the
    tensor map reads at box coordinates (column j, row i, batch b, cols[s],
    rows[s]) through the grid's strides, and the one the element fill reads
    at offs[s] + b·sab + i·lda + j, are both element (i, j) of leaf
    ``a_blocks[rows[s], cols[s]]``."""
    for ab, rows, cols in _ata_grids(L):
        coords = ksyrk.gather_coords(rows, cols)
        assert coords.dtype == np.int32 and coords.shape == (rows.size, 2)
        offs = rows * ab.stride(0) + cols * ab.stride(1)
        flat = ab.as_strided((ab.untyped_storage().nbytes() // 2,), (1,), 0)
        base = ab.storage_offset()
        batched = ab.ndim == 5
        B = ab.shape[2] if batched else 1
        sab = ab.stride(2) if batched else 0
        mL, nL = ab.shape[-2:]
        for s, (r, c) in enumerate(coords):
            for b in range(B):
                leaf = ab[r, c, b] if batched else ab[r, c]
                i = np.arange(mL)[:, None]
                j = np.arange(nL)[None, :]
                by_box = base + r * ab.stride(0) + c * ab.stride(1) + b * sab \
                    + i * ab.stride(-2) + j
                by_off = base + offs[s] + b * sab + i * ab.stride(-2) + j
                assert np.array_equal(by_box, by_off)
                assert torch.equal(flat[torch.as_tensor(by_box)], leaf), (L, s, b)


def test_wgmma_launches_has_the_syrk_keys_and_reset_clears_them():
    assert set(ops.wgmma_launches) == {"gemm_tn_wgmma", "gemm_tn_fused_wgmma", "syrk_wgmma",
                                       "syrk_gather_wgmma"}
    assert set(ksyrk.tma_refused) == {"syrk_wgmma", "syrk_gather_wgmma"}
    for counts in (ops.wgmma_launches, ksyrk.tma_refused):
        for key in counts:
            counts[key] = 3
    ops.reset_launches()
    assert not any(ops.wgmma_launches.values()) and not any(ksyrk.tma_refused.values())


@pytest.fixture
def stub_lib(monkeypatch):
    """The syrk wrappers against a stand-in for the CUDA library that records
    each entry point's arguments and returns success, leaving the launch's
    TMA flag unset (a refused tensor map)."""
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
    ops.reset_launches()
    yield calls
    ops.reset_launches()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,n", [(1100, 40), (2048, 24), (300, 17)])
def test_syrk_wrappers_call_their_routes_entry_point(stub_lib, dt, m, n):
    """bfloat16 goes to syrk_wgmma / syrk_gather_wgmma, float32 to syrk_f32
    / syrk_gather_f32, each with syrk_splits(m, n), the copy flag of
    ``syrk_route`` and the right number of arguments; the gathered
    tensor-core launch gets the grid's (R, C) and block strides. Only the
    tensor-core launches count in ``wgmma_launches``, and a stand-in that
    never sets the TMA flag shows up in ``tma_refused`` where the operand
    was aligned."""
    rng = np.random.default_rng(m + n)
    a = torch.as_tensor(rng.standard_normal((3, m, n), dtype=np.float32)).to(dt)
    grid = torch.as_tensor(rng.standard_normal((2, 3, m, n), dtype=np.float32)).to(dt)
    rows, cols = np.array([0, 1, 1]), np.array([2, 0, 1])
    ksyrk.syrk_cuda(a)
    ksyrk.syrk_cuda(a, out="packed", bn=8 * (-(-n // 16)))
    ksyrk.syrk_gather_cuda(grid, rows, cols)
    tc = dt == torch.bfloat16
    names = ["syrk_wgmma"] * 2 + ["syrk_gather_wgmma"] if tc else \
        ["syrk_f32"] * 2 + ["syrk_gather_f32"]
    assert [c[0] for c in stub_lib] == names
    k = ksyrk.syrk_splits(m, n)
    for name, args in stub_lib:
        assert len(args) == len(_build.SIGNATURES[name]), name
    dense_args, gather_args = stub_lib[0][1], stub_lib[2][1]
    assert dense_args[10] == k and dense_args[11] == int(vec16(a, a.stride(0), a.stride(1)))
    if tc:
        assert gather_args[15] == k
        assert gather_args[10:14] == (2, 3, grid.stride(0), grid.stride(1))
        aligned = [dense_args[11]] * 2 + [gather_args[16]]
    else:
        assert gather_args[10] == k
        aligned = [0, 0, 0]
    assert ops.wgmma_launches == {"gemm_tn_wgmma": 0, "gemm_tn_fused_wgmma": 0,
                                  "syrk_wgmma": 2 * tc, "syrk_gather_wgmma": int(tc)}
    assert ksyrk.tma_refused == {"syrk_wgmma": aligned[0] + aligned[1],
                                 "syrk_gather_wgmma": aligned[2]}
