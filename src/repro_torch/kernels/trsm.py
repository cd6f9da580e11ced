"""Triangular panel solve — CUDA kernel and plain version.

Port of ``repro.kernels.trsm.trsm_pallas``; the kernel is ``csrc/trsm.cu``.
Solves ``X·Lᵀ = B`` (``transpose=True``, the Cholesky panel op) or
``X·L = B`` (``transpose=False``, the backward-substitution form) for
``L: (n, n)`` or ``(B, n, n)`` lower triangular and ``B: (m, n)`` or
``(B, m, n)``, one factor per stack entry. The kernel reads the factor
through its batch stride, so ``L`` may be an ``expand``-ed single factor
(stride 0) and is then not copied. One launch takes ``n ≤ 256``
(:data:`MAX_N`; ``ops.trsm`` splits a wider factor into launches of it).
It loads float32 or bfloat16, solves in
float32 and stores ``out_dtype`` (float32 or bfloat16), as the reference's
kernel casts both inputs to float32.
"""

from __future__ import annotations

import torch

from repro_torch.backend import kernel_dtypes

__all__ = ["trsm_plain", "trsm_cuda", "MAX_N"]

MAX_N = 256


def check_shapes(l, b):
    if l.ndim not in (2, 3) or l.shape[-1] != l.shape[-2]:
        raise ValueError(f"trsm expects (n, n) or (B, n, n) factor, got {tuple(l.shape)}")
    if b.ndim != l.ndim or b.shape[-1] != l.shape[-1] or b.shape[:-2] != l.shape[:-2]:
        raise ValueError(f"bad trsm shapes: {tuple(l.shape)} x {tuple(b.shape)}")


def trsm_plain(l, b, *, transpose: bool = True, out_dtype=torch.float32):
    """Plain PyTorch column recurrence, as the kernel's row recurrence:

        X[:,j] = (B[:,j] − Σ_k X[:,k]·op(L)[k,j]) / L[j,j]

    ``j`` ascending for ``X·Lᵀ = B``, descending for ``X·L = B``. ``X``
    is contiguous whatever ``B``'s layout, so the sums' order is too.
    """
    check_shapes(l, b)
    acc = torch.float64 if torch.float64 in (l.dtype, b.dtype, out_dtype) else torch.float32
    lf, bf = l.to(acc), b.to(acc)
    n = l.shape[-1]
    x = torch.zeros(bf.shape, dtype=acc, device=bf.device)
    for step in range(n):
        j = step if transpose else n - 1 - step
        if transpose:   # op(L)[k, j] = L[j, k], known for k < j
            xs, lvec = x[..., :, :j], lf[..., j, :j]
        else:           # op(L)[k, j] = L[k, j], known for k > j
            xs, lvec = x[..., :, j + 1:], lf[..., j + 1:, j]
        s = (xs * lvec[..., None, :]).sum(-1)
        x[..., :, j] = (bf[..., :, j] - s) / lf[..., j, j][..., None]
    return x.to(out_dtype)


def trsm_cuda(l, b, *, transpose: bool = True, out_dtype=torch.float32):
    """Launch ``csrc/trsm.cu`` once on the current stream."""
    from repro_torch.kernels import _build

    check_shapes(l, b)
    (l, b), dtypes = kernel_dtypes(l, b, out_dtype=out_dtype, what="trsm")
    n = l.shape[-1]
    if n > MAX_N:
        raise ValueError(f"trsm kernel takes factors up to {MAX_N}, got n={n}")
    if l.stride(-1) != 1 or l.stride(-2) != n:
        raise ValueError("trsm kernel needs each factor tile contiguous (any batch stride)")
    if not b.is_contiguous():
        raise ValueError("trsm kernel needs a contiguous panel; pass .contiguous()")
    m = b.shape[-2]
    batch = b.shape[0] if b.ndim == 3 else 1
    if min(batch, m, n) == 0:
        raise ValueError(f"trsm kernel takes no empty panel: {tuple(b.shape)}")
    if b.device.index != torch.cuda.current_device():
        # the kernel launches on the current device: make it the panel's
        with torch.cuda.device(b.device):
            return trsm_cuda(l, b, transpose=transpose, out_dtype=out_dtype)
    slb = l.stride(0) if l.ndim == 3 else 0
    x = torch.empty_like(b, dtype=out_dtype)
    err = _build.load().trsm_f32(l.data_ptr(), b.data_ptr(), x.data_ptr(), batch, m, n, slb,
                                 int(bool(transpose)), dtypes,
                                 torch.cuda.current_stream().cuda_stream)
    _build.check(err, "trsm")
    return x
