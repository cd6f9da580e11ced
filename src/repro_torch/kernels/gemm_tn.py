"""TN matmul ``C = alpha·AᵀB`` — CUDA kernel and plain version.

Port of ``repro.kernels.gemm_tn.gemm_tn_pallas``; the kernel is
``csrc/gemm_tn.cu``. ``A: (m, n)`` or ``(B, m, n)``, ``B: (m, k)`` or
``(B, m, k)``; a leading batch dim is the kernel's ``blockIdx.z``, so a
whole Strassen leaf stack is one launch.
"""

from __future__ import annotations

import torch

__all__ = ["gemm_tn_plain", "gemm_tn_cuda", "check_tn_shapes"]


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
    """(batch stride, row stride) of a float32 CUDA operand the kernel takes:
    unit column stride; any row and batch strides (views pass uncopied)."""
    if x.dtype != torch.float32:
        raise TypeError(f"gemm_tn kernel takes float32 operands, got {x.dtype}")
    if x.stride(-1) != 1 and x.shape[-1] > 1:
        raise ValueError("gemm_tn kernel needs a unit column stride; pass .contiguous()")
    sb = x.stride(0) if x.ndim == 3 else 0
    return sb, x.stride(-2)


def gemm_tn_cuda(a, b, *, alpha: float = 1.0, out_dtype=torch.float32):
    """Launch ``csrc/gemm_tn.cu`` once on the current stream."""
    from repro_torch.kernels import _build

    check_tn_shapes(a, b)
    if out_dtype != torch.float32:
        raise TypeError(f"gemm_tn kernel writes float32, got out_dtype={out_dtype}")
    if a.device != b.device:
        raise ValueError(f"operands on {a.device} and {b.device}")
    m, n = a.shape[-2:]
    k = b.shape[-1]
    batch = a.shape[0] if a.ndim == 3 else 1
    if min(batch, m, n, k) == 0:
        raise ValueError(f"gemm_tn kernel takes no empty operands: {tuple(a.shape)} x {tuple(b.shape)}")
    sab, lda = _operand(a)
    sbb, ldb = _operand(b)
    c = torch.empty((*a.shape[:-2], n, k), dtype=torch.float32, device=a.device)
    lib = _build.load()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gemm_tn_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), batch, m, n, k,
                              sab, lda, sbb, ldb, float(alpha), stream)
    _build.check(err, "gemm_tn")
    return c
