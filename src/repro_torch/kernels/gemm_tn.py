"""TN matmul ``C = alpha·AᵀB`` — CUDA kernels and plain versions.

* ``gemm_tn``: port of ``repro.kernels.gemm_tn.gemm_tn_pallas``; the kernel
  is ``csrc/gemm_tn.cu``. ``A: (m, n)`` or ``(B, m, n)``, ``B: (m, k)`` or
  ``(B, m, k)``; a leading batch dim is the kernel's ``blockIdx.z``, so a
  whole Strassen leaf stack is one launch.
* ``gemm_tn_fused``: port of ``gemm_tn_fused_pallas``; the kernel is
  ``csrc/gemm_tn_fused.cu``. The operands are block-major leaf grids
  ``(G, R, C, [B,] mb, ·)`` (any strides, unit column stride) and six
  ``(T, W)`` slot tables; leaf ``g·T + t`` multiplies the balanced ± sums of
  its ``W`` slot blocks, combined inside the kernel. The wrapper turns the
  tables into per-(leaf, slot) element offsets on the host, so the kernel
  reads views of the caller's operand without a copy.

Both kernels load float32 or bfloat16 operands, sum in float32 and store
``out_dtype`` (float32 or bfloat16); a float64 operand or output raises on
the card (``backend.kernel_dtypes``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import device_cached, kernel_dtypes
from repro_torch.tune.defaults import GEMM_BLOCKS as DEFAULT_BLOCKS

__all__ = ["DEFAULT_BLOCKS", "gemm_tn_plain", "gemm_tn_cuda", "check_tn_shapes", "vec16", "combine_fused_operands",
           "gemm_tn_fused_plain", "gemm_tn_fused_cuda", "fused_launch_tables", "FUSED_MAX_SLOTS"]

# slot counts the fused kernel is instantiated for (csrc/gemm_tn_fused.cu)
FUSED_MAX_SLOTS = 32


def check_tn_shapes(a, b):
    if a.ndim not in (2, 3) or a.ndim != b.ndim:
        raise ValueError(f"bad TN shapes: {tuple(a.shape)} x {tuple(b.shape)}")
    if a.shape[-2] != b.shape[-2] or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"bad TN shapes: {tuple(a.shape)} x {tuple(b.shape)}")


def _acc_dtype(*dtypes):
    """float32 accumulation, float64 when any operand or the output is."""
    return torch.float64 if torch.float64 in dtypes else torch.float32


def gemm_tn_plain(a, b, *, alpha: float = 1.0, out_dtype=torch.float32):
    """Plain PyTorch ``alpha·AᵀB``: one matmul in the accumulation dtype."""
    check_tn_shapes(a, b)
    acc = _acc_dtype(a.dtype, b.dtype, out_dtype)
    out = torch.matmul(a.to(acc).transpose(-1, -2), b.to(acc))
    if alpha != 1.0:
        out = alpha * out
    return out.to(out_dtype)


def _operand(x):
    """(batch stride, row stride) of a CUDA operand the kernel takes: unit
    column stride; any row and batch strides (views pass uncopied)."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("gemm_tn kernel needs a unit column stride; pass .contiguous()")
    sb = x.stride(0) if x.ndim == 3 else 0
    return sb, x.stride(-2)


def vec16(x, *strides) -> bool:
    """Whether the tile engine (``csrc/tn_tile.cuh``) may fill its ring from
    ``x`` in 16-byte copies: a 16-byte aligned base and every stride (row,
    batch, entry offsets) a multiple of 16 bytes — 4 float32 or 8 bfloat16
    elements. Otherwise it copies elements."""
    per = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and all(int(s) % per == 0 for s in strides)


def gemm_tn_cuda(a, b, *, alpha: float = 1.0, out_dtype=torch.float32):
    """Launch ``csrc/gemm_tn.cu`` once on the current stream."""
    from repro_torch.kernels import _build

    check_tn_shapes(a, b)
    (a, b), dtypes = kernel_dtypes(a, b, out_dtype=out_dtype, what="gemm_tn")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    m, n = a.shape[-2:]
    k = b.shape[-1]
    batch = a.shape[0] if a.ndim == 3 else 1
    if min(batch, m, n, k) == 0:
        raise ValueError(f"gemm_tn kernel takes no empty operands: {tuple(a.shape)} x {tuple(b.shape)}")
    sab, lda = _operand(a)
    sbb, ldb = _operand(b)
    if a.device.index != torch.cuda.current_device():
        # the kernel launches on the current device: make it the operands'
        with torch.cuda.device(a.device):
            return gemm_tn_cuda(a, b, alpha=alpha, out_dtype=out_dtype)
    c = torch.empty((*a.shape[:-2], n, k), dtype=out_dtype, device=a.device)
    v16 = vec16(a, sab, lda) and vec16(b, sbb, ldb)
    err = _build.load().gemm_tn_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k,
                                    sab, lda, sbb, ldb, float(alpha), int(v16), dtypes,
                                    torch.cuda.current_stream().cuda_stream)
    _build.check(err, "gemm_tn")
    return c


# ---------------------------------------------------------------------------
# fused-operand leaf launch (leaf_dispatch='fused')
# ---------------------------------------------------------------------------


def _fused_tables(a_blocks, b_blocks, tables):
    """Validate the grids and tables; returns ``((rows, cols, sgn) × 2, T, W)``
    as int64 numpy arrays."""
    if a_blocks.ndim not in (5, 6) or a_blocks.ndim != b_blocks.ndim:
        raise ValueError(f"bad fused block grids: {tuple(a_blocks.shape)} x {tuple(b_blocks.shape)}")
    if a_blocks.shape[:-1] != b_blocks.shape[:-1]:
        raise ValueError(f"bad fused block grids: {tuple(a_blocks.shape)} x {tuple(b_blocks.shape)}")
    (ar, ac, asg), (br, bc, bsg) = tables
    sides = tuple(tuple(np.asarray(x, np.int64) for x in side)
                  for side in ((ar, ac, asg), (br, bc, bsg)))
    shape = sides[0][0].shape
    if len(shape) != 2 or any(x.shape != shape for side in sides for x in side):
        raise ValueError("fused slot tables must be six arrays of one (T, W) shape")
    R, C = a_blocks.shape[1:3]
    for rows, cols, sgn in sides:
        live = sgn != 0
        if (rows[live].min(initial=0) < 0 or rows[live].max(initial=0) >= R
                or cols[live].min(initial=0) < 0 or cols[live].max(initial=0) >= C):
            raise ValueError(f"fused slot table indexes outside the ({R}, {C}) block grid")
        if not np.isin(sgn, (-1, 0, 1)).all():
            raise ValueError("fused slot signs must be -1, 0 or +1")
    return sides, shape[0], shape[1]


def combine_fused_operands(blocks, rows, cols, sgn, dtype=None):
    """Materialize the combined leaf operands of one side of a fused launch.

    ``blocks``: ``(G, R, C, [B,] mb, w)``; ``rows``/``cols``/``sgn``:
    ``(T, W)``. Returns ``(G·T, [B,] mb, w)``: leaf ``g·T + t`` is the
    balanced pairwise sum over the ``W`` signed slot blocks — the order of
    ``core.strassen._combine_slots`` (a dead slot adds an exact zero).
    """
    dtype = blocks.dtype if dtype is None else dtype
    dev = blocks.device
    rows = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    cols = torch.as_tensor(np.asarray(cols, np.int64), device=dev)
    sgn = torch.as_tensor(np.asarray(sgn), device=dev).to(dtype)
    G, T, W = blocks.shape[0], rows.shape[0], rows.shape[1]
    if W & (W - 1):
        raise ValueError(f"slot count {W} is not a power of two")
    x = blocks[:, rows, cols].to(dtype)                 # (G, T, W, [B,] mb, w)
    x = x * sgn.reshape(1, T, W, *([1] * (x.ndim - 3)))
    while x.shape[2] > 1:
        x = x[:, :, 0::2] + x[:, :, 1::2]
    return x[:, :, 0].reshape(G * T, *x.shape[3:])


def gemm_tn_fused_plain(a_blocks, b_blocks, tables, *, alpha: float = 1.0,
                        out_dtype=torch.float32):
    """Plain PyTorch fused leaf launch: combine every leaf operand, then
    one batched TN matmul. Returns ``(G·T, [B,] n, k)``."""
    (sa, sb), _, _ = _fused_tables(a_blocks, b_blocks, tables)
    acc = _acc_dtype(a_blocks.dtype, b_blocks.dtype, out_dtype)
    xa = combine_fused_operands(a_blocks, *sa, acc)
    xb = combine_fused_operands(b_blocks, *sb, acc)
    lead = xa.shape[:-2]
    out = gemm_tn_plain(xa.reshape(-1, *xa.shape[-2:]), xb.reshape(-1, *xb.shape[-2:]),
                        alpha=alpha, out_dtype=out_dtype)
    return out.reshape(*lead, *out.shape[-2:])


def _grid_strides(x):
    """(group, block-row, block-col, batch, row) element strides of a CUDA
    block grid with unit column stride."""
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("gemm_tn_fused kernel needs a unit column stride")
    sb = x.stride(3) if x.ndim == 6 else 0
    return x.stride(0), x.stride(1), x.stride(2), sb, x.stride(-2)


def fused_launch_tables(a_blocks, b_blocks, sides, T, W):
    """Host preparation of a ``gemm_tn_fused`` launch.

    Returns ``(off, sgn, lds, sbs, vec16)``: ``off`` the ``(2, G·T, W)``
    int64 element offsets of every (side, leaf, slot) block in its grid,
    ``sgn`` the matching int32 signs, the row and batch strides of the two
    grids, and ``vec16``: whether every slot base, batch stride and row
    stride is a multiple of 4 elements from a pointer aligned to 4 elements,
    so the kernel may copy its raw slabs in quads of 4 elements (16 bytes of
    float32, 8 of bfloat16; else it copies elements).
    """
    G = a_blocks.shape[0]
    offs, sgns, lds, sbs = [], [], [], []
    vec16 = True
    for x, (rows, cols, sgn) in zip((a_blocks, b_blocks), sides):
        sg, sr, sc, sbat, srow = _grid_strides(x)
        g = np.arange(G, dtype=np.int64)[:, None, None]
        off = (g * sg + rows[None] * sr + cols[None] * sc).reshape(G * T, W)
        offs.append(off)
        sgns.append(np.broadcast_to(sgn[None], (G, T, W)).reshape(G * T, W))
        lds.append(srow)
        sbs.append(sbat)
        vec16 = vec16 and x.data_ptr() % (4 * x.element_size()) == 0 and srow % 4 == 0 \
            and sbat % 4 == 0 and not (off % 4).any()
    return np.stack(offs), np.stack(sgns).astype(np.int32), lds, sbs, vec16


def _device_launch_tables(a_blocks, b_blocks, tables):
    """:func:`fused_launch_tables` with ``off``/``sgn`` on the grids' device.

    Returns ``((rows, cols, sgn) × 2, T, W, off, sgn, lds, sbs, vec16)``.
    Kept per table memory (``backend.device_cached``), which is treated as
    immutable: the slot and level tables are cached (``_slot_tables``,
    ``_level_tables``) and ``ops.gemm_tn_fused`` hands the operator views
    of them, so the launches of one level read the same memory and a
    repeated launch validates nothing anew and copies nothing to the card.
    The key holds each table's address, shape, strides and dtype, and the
    grids' shapes, strides, dtypes (vec16 depends on the element size: the
    same pointer and strides may allow 16-byte copies of bfloat16 and not
    of float32), pointer alignment and device; the entry holds the tables,
    so their memory is not reused while it is kept.
    """
    tables = tuple(tuple(x if isinstance(x, torch.Tensor) else torch.as_tensor(x) for x in side)
                   for side in tables)
    key = ("gemm_tn_fused",
           tuple((x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
                 for side in tables for x in side),
           tuple(a_blocks.shape), a_blocks.stride(),
           a_blocks.data_ptr() % 16, a_blocks.dtype, tuple(b_blocks.shape), b_blocks.stride(),
           b_blocks.data_ptr() % 16, b_blocks.dtype, str(a_blocks.device))

    def make():
        sides, T, W = _fused_tables(a_blocks, b_blocks, tables)
        off, sgn, lds, sbs, vec16 = fused_launch_tables(a_blocks, b_blocks, sides, T, W)
        dev = a_blocks.device
        return tables, (sides, T, W, torch.as_tensor(off, device=dev),
                        torch.as_tensor(sgn, device=dev), lds, sbs, vec16)

    return device_cached(key, make)[1]


def gemm_tn_fused_cuda(a_blocks, b_blocks, tables, *, alpha: float = 1.0,
                       out_dtype=torch.float32):
    """Launch ``csrc/gemm_tn_fused.cu`` once on the current stream."""
    from repro_torch.kernels import _build

    if a_blocks.device != b_blocks.device:
        raise ValueError(f"operands on {a_blocks.device} and {b_blocks.device}")
    (a_blocks, b_blocks), dtypes = kernel_dtypes(a_blocks, b_blocks, out_dtype=out_dtype,
                                                 what="gemm_tn_fused")
    sides, T, W, off, sgn, ld, sb, vec16 = _device_launch_tables(a_blocks, b_blocks, tables)
    if W & (W - 1) or W > FUSED_MAX_SLOTS:
        raise ValueError(f"gemm_tn_fused kernel takes 1, 2, 4, ... {FUSED_MAX_SLOTS} slots, got {W}")
    G = a_blocks.shape[0]
    batch = a_blocks.shape[3] if a_blocks.ndim == 6 else 1
    m, n = a_blocks.shape[-2:]
    k = b_blocks.shape[-1]
    if min(G, T, batch, m, n, k) == 0:
        raise ValueError("gemm_tn_fused kernel takes no empty operands")
    dev = a_blocks.device
    lead = (G * T, batch) if a_blocks.ndim == 6 else (G * T,)
    c = torch.empty((*lead, n, k), dtype=out_dtype, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gemm_tn_fused_f32(a_blocks.data_ptr(), b_blocks.data_ptr(), off.data_ptr(),
                                    sgn.data_ptr(), c.data_ptr(), G * T, batch, W, m, n, k,
                                    sb[0], ld[0], sb[1], ld[1], float(alpha), int(vec16),
                                    dtypes, stream)
    _build.check(err, "gemm_tn_fused")
    return c
