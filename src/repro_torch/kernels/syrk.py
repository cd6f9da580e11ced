"""Symmetric product ``C = alpha·AᵀA`` — CUDA kernel and plain version.

Port of ``repro.kernels.syrk.syrk_pallas``; the kernel is ``csrc/syrk.cu``.
``A: (m, n)`` or ``(B, m, n)``. Only lower tile pairs are computed; the
grid enumerates them as ``t = i(i+1)/2 + j`` and recovers ``(i, j)`` with
:func:`tri_coords`, the map shared with the reference's ``_tri_coords``.

* ``out='dense'``: ``(..., n, n)``, bitwise symmetric (lower tiles and
  their transposes written once each from the accumulator).
* ``out='packed'``: ``(..., T, bn, bn)`` with ``bn = default_block_size(n,
  blocks[1])``, returned by :mod:`repro_torch.kernels.ops` as a
  :class:`~repro_torch.core.symmetric.SymmetricMatrix`; diagonal tiles are
  ``sym_tile``'d, pad entries are zero.

``syrk_gather`` (port of ``syrk_gather_pallas``, same kernel file) is the
dense mode over gathered leaves: ``C[s] = alpha·ÂᵀÂ`` with ``Â =
a_blocks[rows[s], cols[s]]`` of a block-major grid ``(R, C, [B,] mL, nL)``.
Each stack entry starts at its own element offset, computed on the host
and kept on the card per grid geometry and gather table
(``backend.device_table``), so the ``(S, …)`` stack of the batched
dispatch is never copied and a repeated call copies nothing to the card.

Both launches split the contraction over :func:`syrk_splits` ``(m, n)``
CTAs per output tile (a thread-block cluster), the one input that decides
the kernel's summation order besides the operands: the rows are cut into
chunks of :data:`CHUNK_ROWS`, and CTA ``r`` of ``K`` sums chunks ``r, r +
K, r + 2K, …`` as one chain. Neither the chunks nor the CTA that holds a
chunk move when zero rows are appended, so a serving bucket may pad ``m``
(:mod:`repro_torch.serve.bucketing`).

The kernels load float32 or bfloat16, sum in float32 and store
``out_dtype`` (float32 or bfloat16); float64 raises on the card. Which
kernel runs is :func:`syrk_route`'s answer, by the operand type alone:
float32 operands the FMA tile engine (``syrk_f32`` /
``syrk_gather_f32``), bfloat16 ones the tensor-core kernel
(``syrk_wgmma`` / ``syrk_gather_wgmma``, counted in
``gemm_tn.wgmma_launches``), which reads the gathered leaves by TMA at
box coordinates ``(rows[s], cols[s])`` from a second device table kept
beside the offsets.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.backend import device_table, kernel_dtypes
from repro_torch.core.symmetric import SymmetricMatrix, sym_tile
from repro_torch.kernels.gemm_tn import vec16, wgmma_launches
from repro_torch.tune.defaults import SYRK_BLOCKS as DEFAULT_BLOCKS

__all__ = ["DEFAULT_BLOCKS", "tri_coords", "syrk_splits", "syrk_plain", "syrk_cuda", "syrk_gather_plain",
           "syrk_gather_cuda", "syrk_route", "gather_coords", "tma_refused"]

# tensor-core launches since the last ops.reset_launches() whose operand
# the wrapper found aligned but whose tensor map the card refused to encode
# (so the producer warp filled the stages by element loads: the same bits)
tma_refused = {"syrk_wgmma": 0, "syrk_gather_wgmma": 0}

# The split rule's constants (tools/kernel_variants.py times the choices).
RESIDENT_CTAS = 264     # 132 SMs x 2 CTAs (96 KiB of ring each)
CHUNK_ROWS = 512        # rows of one chunk of the contraction (kChunkRows, csrc/syrk.cu)
MAX_SPLITS = 8          # the portable cluster size


def syrk_splits(m: int, n: int) -> int:
    """CTAs ``K`` (a power of two in [1, 8]) that share each output tile of
    the syrk kernels: ``min(F(n), next_pow2(ceil(m / CHUNK_ROWS)))``, with
    ``F(n)`` the most CTAs of one entry (``T`` lower 128-tile pairs of
    ``n``, ``K·T`` of them) that fit on the card at once. A function of
    ``(m, n)`` alone — never of the batch, the output mode or the gather —
    so every dispatch that computes a leaf sums it in the same order. Does
    not fall as ``m`` grows, and ``m ≤ CHUNK_ROWS`` runs unsplit.

    With the kernel's chunks (module docstring) the rule is
    padding-invariant: a request with at most ``F(n)`` chunks has each of
    them alone and first in CTA ``c`` under any ``K`` that large, and one
    with more runs at ``K = F(n)`` whatever its padding."""
    nb = -(-n // 128)
    tiles = nb * (nb + 1) // 2
    cap = max(1, min(MAX_SPLITS, RESIDENT_CTAS // tiles))
    cap = 1 << (cap.bit_length() - 1)
    chunks = max(1, -(-m // CHUNK_ROWS))
    return min(cap, 1 << (chunks - 1).bit_length())


def syrk_route(dtype, aligned: bool):
    """What the syrk launches run, as ``(kernel, copies)``: the kernel and
    its copy flag. bfloat16 operands run the tensor-core kernel
    ``"wgmma"`` (``syrk_wgmma`` / ``syrk_gather_wgmma``), by TMA where
    ``aligned`` (1) and by the producer warp's element loads otherwise (0);
    float32 operands the FMA tile engine ``"fma"`` (``syrk_f32`` /
    ``syrk_gather_f32``), by 16-byte copies where ``aligned`` (1), element
    copies otherwise (0).
    ``aligned`` is :func:`~repro_torch.kernels.gemm_tn.vec16` of the operand
    with its strides (and, gathered, its entry offsets)."""
    if dtype == torch.bfloat16:
        return "wgmma", int(aligned)
    if dtype != torch.float32:
        raise TypeError(f"syrk kernels take float32 or bfloat16 operands, got {dtype}")
    return "fma", int(aligned)


def tri_coords(t):
    """Packed triangular index ``t`` → ``(i, j)``, ``j ≤ i``: a float32
    square root and an integer correction — the arithmetic of the kernel's
    device function, on numpy integer arrays."""
    t = np.asarray(t, np.int64)
    tf = t.astype(np.float32)
    root = np.sqrt(np.float32(8.0) * tf + np.float32(1.0))
    i = np.floor((root - np.float32(1.0)) / np.float32(2.0)).astype(np.int64)
    i = np.where((i + 1) * (i + 2) // 2 <= t, i + 1, i)
    i = np.where(i * (i + 1) // 2 > t, i - 1, i)
    return i, t - i * (i + 1) // 2


def _check(a, out):
    if a.ndim not in (2, 3):
        raise ValueError(f"syrk expects (m, n) or (B, m, n) input, got {tuple(a.shape)}")
    if out not in ("dense", "packed"):
        raise ValueError(f"unknown output mode {out!r}; use 'dense' or 'packed'")


def syrk_plain(a, *, alpha: float = 1.0, out_dtype=torch.float32, out="dense", bn=None):
    """Plain PyTorch ``alpha·AᵀA``: one matmul, lower half mirrored up.

    ``out='packed'`` packs that dense result on the ``bn`` grid, so packed
    and dense agree bitwise here as they do in the kernel.
    """
    _check(a, out)
    acc = torch.float64 if torch.float64 in (a.dtype, out_dtype) else torch.float32
    x = a.to(acc)
    c = torch.matmul(x.transpose(-1, -2), x)
    if alpha != 1.0:
        c = alpha * c
    c = sym_tile(c.to(out_dtype))
    if out == "dense":
        return c
    return SymmetricMatrix.from_dense_lower(c, bn).blocks


def syrk_cuda(a, *, alpha: float = 1.0, out_dtype=torch.float32, out="dense", bn=None):
    """Launch ``csrc/syrk.cu`` once on the current stream. Returns the raw
    ``(..., n, n)`` or ``(..., T, bn, bn)`` tensor."""
    from repro_torch.kernels import _build

    _check(a, out)
    (a,), dtypes = kernel_dtypes(a, out_dtype=out_dtype, what="syrk")
    if a.stride(-1) != 1 and a.shape[-1] > 1:
        raise ValueError("syrk kernel needs a unit column stride; pass .contiguous()")
    m, n = a.shape[-2:]
    batch = a.shape[0] if a.ndim == 3 else 1
    if min(batch, m, n) == 0:
        raise ValueError(f"syrk kernel takes no empty operand: {tuple(a.shape)}")
    sab = a.stride(0) if a.ndim == 3 else 0
    lead = tuple(a.shape[:-2])
    if out == "packed":
        nb = -(-n // bn)
        c = torch.empty((*lead, nb * (nb + 1) // 2, bn, bn), dtype=out_dtype, device=a.device)
    else:
        bn = 0
        c = torch.empty((*lead, n, n), dtype=out_dtype, device=a.device)
    lib = _build.load()
    kernel, copies = syrk_route(a.dtype, vec16(a, sab, a.stride(-2)))
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "wgmma":
            used = ctypes.c_int(0)
            err = lib.syrk_wgmma(a.data_ptr(), c.data_ptr(), batch, m, n, sab, a.stride(-2),
                                 float(alpha), int(out == "packed"), bn, syrk_splits(m, n),
                                 copies, dtypes, ctypes.byref(used), stream)
        else:
            err = lib.syrk_f32(a.data_ptr(), c.data_ptr(), batch, m, n, sab, a.stride(-2),
                               float(alpha), int(out == "packed"), bn, syrk_splits(m, n), copies,
                               dtypes, stream)
    _build.check(err, "syrk")
    if kernel == "wgmma":
        wgmma_launches["syrk_wgmma"] += 1
        tma_refused["syrk_wgmma"] += int(copies and not used.value)
    return c


def _gather_index(a_blocks, rows, cols):
    if a_blocks.ndim not in (4, 5):
        raise ValueError(f"bad gathered block grid: {tuple(a_blocks.shape)}")
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    if rows.ndim != 1 or rows.shape != cols.shape:
        raise ValueError(f"gather tables must be two (S,) arrays, got {rows.shape}, {cols.shape}")
    R, C = a_blocks.shape[:2]
    if rows.size and (rows.min() < 0 or rows.max() >= R or cols.min() < 0 or cols.max() >= C):
        raise ValueError(f"gather tables index outside the ({R}, {C}) block grid")
    return rows, cols


def syrk_gather_plain(a_blocks, rows, cols, *, alpha: float = 1.0, out_dtype=torch.float32):
    """Plain PyTorch gathered syrk: stack the leaves, then :func:`syrk_plain`
    dense. Returns ``(S, [B,] nL, nL)``."""
    rows, cols = _gather_index(a_blocks, rows, cols)
    dev = a_blocks.device
    stacked = a_blocks[torch.as_tensor(rows, device=dev), torch.as_tensor(cols, device=dev)]
    out = syrk_plain(stacked.reshape(-1, *stacked.shape[-2:]), alpha=alpha, out_dtype=out_dtype)
    return out.reshape(*stacked.shape[:-2], *out.shape[-2:])


def gather_coords(rows, cols):
    """The tensor-core launch's table of box coordinates: ``(S, 2)`` int32,
    entry ``s`` holding ``(rows[s], cols[s])``, the block of the grid whose
    element offset is ``rows[s]·stride(0) + cols[s]·stride(1)``."""
    return np.stack([np.asarray(rows, np.int64), np.asarray(cols, np.int64)], 1).astype(np.int32)


def syrk_gather_cuda(a_blocks, rows, cols, *, alpha: float = 1.0, out_dtype=torch.float32):
    """Launch the gathered entry of ``csrc/syrk.cu`` once on the current
    stream: the dense syrk grid with a per-entry base offset (float32), or
    per-entry box coordinates in the grid's tensor map (bfloat16)."""
    from repro_torch.kernels import _build

    rows, cols = _gather_index(a_blocks, rows, cols)
    (a_blocks,), dtypes = kernel_dtypes(a_blocks, out_dtype=out_dtype, what="syrk_gather")
    if a_blocks.stride(-1) != 1 and a_blocks.shape[-1] > 1:
        raise ValueError("syrk_gather kernel needs a unit column stride")
    m, n = a_blocks.shape[-2:]
    S = rows.shape[0]
    batch = a_blocks.shape[2] if a_blocks.ndim == 5 else 1
    if min(S, batch, m, n) == 0:
        raise ValueError(f"syrk_gather kernel takes no empty operand: {tuple(a_blocks.shape)}")
    sab = a_blocks.stride(2) if a_blocks.ndim == 5 else 0
    dev = a_blocks.device
    off_host = rows * a_blocks.stride(0) + cols * a_blocks.stride(1)
    off = device_table(("syrk_gather_off", tuple(a_blocks.shape[:2]), a_blocks.stride(0),
                        a_blocks.stride(1), rows.tobytes(), cols.tobytes()), dev, lambda: off_host)
    lead = (S, batch) if a_blocks.ndim == 5 else (S,)
    c = torch.empty((*lead, n, n), dtype=out_dtype, device=dev)
    lib = _build.load()
    kernel, copies = syrk_route(a_blocks.dtype, vec16(a_blocks, sab, a_blocks.stride(-2))
                                and not (off_host % (16 // a_blocks.element_size())).any())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if kernel == "wgmma":
            coords = device_table(("syrk_gather_coords", rows.tobytes(), cols.tobytes()), dev,
                                  lambda: gather_coords(rows, cols))
            used = ctypes.c_int(0)
            R, C = a_blocks.shape[:2]
            err = lib.syrk_gather_wgmma(a_blocks.data_ptr(), off.data_ptr(), coords.data_ptr(),
                                        c.data_ptr(), S, batch, m, n, sab, a_blocks.stride(-2),
                                        R, C, a_blocks.stride(0), a_blocks.stride(1),
                                        float(alpha), syrk_splits(m, n), copies, dtypes,
                                        ctypes.byref(used), stream)
        else:
            err = lib.syrk_gather_f32(a_blocks.data_ptr(), off.data_ptr(), c.data_ptr(), S,
                                      batch, m, n, sab, a_blocks.stride(-2), float(alpha),
                                      syrk_splits(m, n), copies, dtypes, stream)
    _build.check(err, "syrk_gather")
    if kernel == "wgmma":
        wgmma_launches["syrk_gather_wgmma"] += 1
        tma_refused["syrk_gather_wgmma"] += int(copies and not used.value)
    return c
