"""Diagonal-tile Cholesky ``A = L·Lᵀ`` — CUDA kernel and plain version.

Port of ``repro.kernels.potrf.potrf_pallas``; the kernel is
``csrc/potrf.cu``. ``a: (n, n)`` or ``(B, n, n)`` SPD tiles; the output's
strict upper half is zero. The kernel holds a tile's lower triangle and one
32-column panel in shared memory, which bounds one launch at ``n ≤ 256``
(161 KB: :data:`MAX_N`; ``ops.potrf`` splits a wider tile into launches of
it), and factors it in panels of 32 columns, one CTA per tile. It loads float32
or bfloat16 tiles, factors in float32 and stores ``out_dtype`` (float32 or
bfloat16), as the reference's kernel casts any input to float32.
"""

from __future__ import annotations

import torch

from repro_torch.backend import kernel_dtypes

__all__ = ["potrf_plain", "potrf_cuda", "MAX_N"]

MAX_N = 256


def check_shape(a):
    if a.ndim not in (2, 3) or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"potrf expects (n, n) or (B, n, n) SPD input, got {tuple(a.shape)}")


def potrf_plain(a, *, out_dtype=torch.float32):
    """Plain PyTorch unblocked right-looking recurrence — the kernel's
    column loop written with tensor slices:

        L[j,j] = sqrt(A[j,j]);  L[j+1:,j] = A[j+1:,j] / L[j,j]
        A[j+1:,j+1:] -= L[j+1:,j]·L[j+1:,j]ᵀ
    """
    check_shape(a)
    acc = torch.float64 if torch.float64 in (a.dtype, out_dtype) else torch.float32
    x = a.to(acc).clone()
    for j in range(x.shape[-1]):
        d = torch.sqrt(x[..., j, j])
        below = x[..., j + 1:, j] / d[..., None]
        x[..., j, j] = d
        x[..., j + 1:, j] = below
        x[..., j + 1:, j + 1:] -= below[..., :, None] * below[..., None, :]
    return torch.tril(x).to(out_dtype)


def potrf_cuda(a, *, out_dtype=torch.float32):
    """Launch ``csrc/potrf.cu`` once on the current stream."""
    from repro_torch.kernels import _build

    check_shape(a)
    (a,), dtypes = kernel_dtypes(a, out_dtype=out_dtype, what="potrf")
    if not a.is_contiguous():
        raise ValueError("potrf kernel needs contiguous tiles; pass .contiguous()")
    n = a.shape[-1]
    if n > MAX_N:
        raise ValueError(f"potrf kernel takes tiles up to {MAX_N}, got n={n}")
    batch = a.shape[0] if a.ndim == 3 else 1
    if min(batch, n) == 0:
        raise ValueError(f"potrf kernel takes no empty stack: {tuple(a.shape)}")
    if a.device.index != torch.cuda.current_device():
        # the kernel launches on the current device: make it the tile's
        with torch.cuda.device(a.device):
            return potrf_cuda(a, out_dtype=out_dtype)
    out = torch.empty_like(a, dtype=out_dtype)
    err = _build.load().potrf_f32(a.data_ptr(), out.data_ptr(), batch, n, dtypes,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(err, "potrf")
    return out
