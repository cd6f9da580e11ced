"""The bfloat16 tensor-core path of gemm_tn and gemm_tn_fused, on the CPU.

On the card, bfloat16 operands of ``gemm_tn`` and bfloat16 slot blocks of
``gemm_tn_fused`` run the ``wgmma`` kernels (``csrc/tn_wgmma.cuh``), whose
bitwise contract is that the fused launch combines each leaf operand in
bfloat16, pairwise and rounded at every add, exactly as the unrolled
recursion's adds of bfloat16 tensors do, and then multiplies it in
gemm_tn's summation order. What of that lives on the host is held here:

* ``combine_fused_operands`` on bfloat16 equals the unrolled recursion's
  ``_combine_slots`` bitwise (the plain version of the kernel's combine);
* ``gemm_tn_fused_plain`` on bfloat16 blocks combines in bfloat16, so it
  equals ``gemm_tn_plain`` on the materialized combined operands, and the
  fused dispatch equals the batched one bitwise on the CPU;
* the host-side choice of kernel (``tn_route``, whose answer the C entry
  point is told and launches): a pure function of the operand type, ``k``
  and alignment, and the alignment rule (``vec16``) under which the stages
  arrive by TMA.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import strassen_tn
from repro_torch.core.ata import _level_tables
from repro_torch.core.strassen import _block_getter, _combine_slots, _pad_root, _slot_tables, _to_blocks
from repro_torch.kernels.gemm_tn import (TN_KERNELS, combine_fused_operands,
                                         gemm_tn_fused_plain, gemm_tn_plain, tn_route, vec16)


def _bf(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
                           ).bfloat16()


def _bits(x):
    return x.view(torch.int16)


def _tables(L):
    """The strassen_tn slot tables of depth L and ata's level tables."""
    yield _slot_tables(L)
    for lev in range(1, L + 1):
        yield _level_tables(L, lev)


@pytest.mark.parametrize("L", [1, 2, 3])
def test_combine_fused_operands_bf16_is_the_recursions_combine(L):
    """Every leaf operand of every table, both sides: the kernel's plain
    combine (``combine_fused_operands`` in bfloat16) and the unrolled
    recursion's (``_combine_slots`` on bfloat16 views) are bitwise equal."""
    x = _pad_root(_bf((7 << L, 5 << L), L), L)
    blocks = _to_blocks(x, L)[None]
    get = _block_getter(x, L)
    for tables in _tables(L):
        for rows, cols, sgn in tables:
            got = combine_fused_operands(blocks, rows, cols, sgn)
            assert got.dtype == torch.bfloat16
            for t in range(rows.shape[0]):
                want = _combine_slots(get, rows[t], cols[t], sgn[t])
                if want is None:   # every slot dead: the operand is zero
                    assert not got[t].float().any()
                    continue
                assert torch.equal(_bits(got[t]), _bits(want.contiguous())), (L, t)


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [1, 2])
def test_gemm_tn_fused_plain_bf16_is_gemm_tn_on_bf16_combines(L, out):
    """The plain fused launch on bfloat16 blocks combines in bfloat16 (not in
    the float32 accumulation type), as the kernel does: the same bits as
    ``gemm_tn_plain`` on the bfloat16 combined operands."""
    ab = _to_blocks(_pad_root(_bf((2, 24 << L, 40 << L), 10 + L), L), L)[None]
    bb = _to_blocks(_pad_root(_bf((2, 24 << L, 24 << L), 20 + L), L), L)[None]
    tables = _slot_tables(L)
    got = gemm_tn_fused_plain(ab, bb, tables, alpha=0.5, out_dtype=out)
    xa, xb = combine_fused_operands(ab, *tables[0]), combine_fused_operands(bb, *tables[1])
    assert xa.dtype == xb.dtype == torch.bfloat16
    want = gemm_tn_plain(xa.reshape(-1, *xa.shape[-2:]), xb.reshape(-1, *xb.shape[-2:]),
                         alpha=0.5, out_dtype=out)
    assert torch.equal(got, want.reshape(got.shape))
    # float32 blocks still combine in float32: the float32 contract is unchanged
    f32 = gemm_tn_fused_plain(ab.float(), bb.float(), tables)
    xa32 = combine_fused_operands(ab.float(), *tables[0])
    xb32 = combine_fused_operands(bb.float(), *tables[1])
    assert torch.equal(f32, gemm_tn_plain(xa32.reshape(-1, *xa32.shape[-2:]),
                                          xb32.reshape(-1, *xb32.shape[-2:])).reshape(f32.shape))


@pytest.mark.parametrize("L", [1, 2])
def test_strassen_tn_bf16_fused_equals_batched_on_cpu(L):
    """bfloat16 strassen_tn on the CPU: the fused dispatch's leaf operands
    are the batched dispatch's bfloat16 stack, bit for bit, and both reach
    the same plain matmul, so the results agree bitwise."""
    x, y = _bf((33 << L, 20 << L), 30 + L), _bf((33 << L, 12 << L), 40 + L)
    fused = strassen_tn(x, y, n_base=8, leaf_dispatch="fused")
    batched = strassen_tn(x, y, n_base=8, leaf_dispatch="batched")
    assert fused.dtype == torch.float32
    assert torch.equal(fused, batched)


def _narrow_max_k():
    """kNarrowMaxK as csrc/tn_narrow.cuh defines it (the built library's
    ``narrow_max_k()`` needs the card)."""
    text = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
            / "tn_narrow.cuh").read_text()
    return int(re.search(r"constexpr int kNarrowMaxK = (\d+);", text).group(1))


@pytest.mark.parametrize("k", [1, 8, 63, 64, 65, 129, 512])
@pytest.mark.parametrize("aligned", [(True, True), (True, False), (False, True), (False, False)])
def test_tn_route_is_a_function_of_dtype_k_and_alignment(k, aligned):
    """bfloat16 runs the wgmma kernel at every k, each aligned operand by
    TMA and the other by element copies (mask bit 0 A, bit 1 B: PowerSGD's
    B of 4 columns has 8-byte rows); float32 the narrow kernel up to
    kNarrowMaxK columns, the tile engine above, both operands by TMA /
    16-byte copies where both are aligned (3), by element copies otherwise
    (0). The kernel names index the C entry point's kernel argument."""
    max_k = _narrow_max_k()
    assert max_k == 64
    kernel, mask = tn_route(torch.bfloat16, k, aligned, max_k)
    assert kernel == "wgmma" and TN_KERNELS.index(kernel) == 2
    assert mask == int(aligned[0]) + 2 * int(aligned[1])
    kernel, mask = tn_route(torch.float32, k, aligned, max_k)
    assert kernel == ("narrow" if k <= max_k else "tile")
    assert TN_KERNELS.index(kernel) == (1 if k <= max_k else 0)
    assert mask == (3 if all(aligned) else 0)
    assert tn_route(torch.float32, k, aligned, 0)[0] == "tile"
    with pytest.raises(TypeError):
        tn_route(torch.float64, k, aligned, max_k)


def _offset(x, elems):
    """x's values in a tensor whose base lies `elems` elements past an
    allocation's start."""
    flat = torch.empty(x.numel() + elems, dtype=x.dtype)
    return flat[elems:].view(x.shape).copy_(x)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_tma_eligibility_on_aligned_offset_and_odd_stride_views(dt):
    """The TMA rule (``vec16`` of both operands): a 16-byte aligned base and
    row and batch strides that are multiples of 16 bytes — 8 bfloat16 or 4
    float32 elements. Contiguous stacks and column slices by whole 16-byte
    groups qualify; a base off a 16-byte boundary, an odd row stride or a
    batch stride off the grain do not."""
    per = 16 // torch.empty((), dtype=dt).element_size()
    x = torch.zeros(3, 40, 8 * per, dtype=dt)
    assert x.data_ptr() % 16 == 0
    assert vec16(x, x.stride(0), x.stride(1))
    view = x[:, :, per:]                        # a column slice by one 16-byte group
    assert vec16(view, view.stride(0), view.stride(1))
    odd = x[:, :, 1:]                           # one element off the boundary
    assert not vec16(odd, odd.stride(0), odd.stride(1))
    assert not vec16(_offset(x, 1), x.stride(0), x.stride(1))
    assert vec16(_offset(x, per), x.stride(0), x.stride(1))
    wide = torch.zeros(3, 40, 8 * per + 1, dtype=dt)[..., :8 * per]   # row stride 8 per + 1
    assert not vec16(wide, wide.stride(0), wide.stride(1))
    rows = torch.zeros(3 * 40 + 1, 8 * per, dtype=dt)[1:].view(3, 40, 8 * per)
    assert vec16(rows, rows.stride(0), rows.stride(1))   # one 128-byte row in: still aligned
    batch = torch.zeros(3 * (40 * 8 * per + 1), dtype=dt)
    stack = batch.as_strided((3, 40, 8 * per), (40 * 8 * per + 1, 8 * per, 1))
    assert not vec16(stack, stack.stride(0), stack.stride(1))   # batch stride off the grain
    assert vec16(stack[0], stack.stride(1))                       # one entry alone: aligned
