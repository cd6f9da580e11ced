"""Plain PyTorch oracles of the TN kernels (port of ``repro.kernels.ref``).

The references the kernels' tests and benchmarks hold the kernels against:
float32 accumulation and output, whatever the operands' device.
"""

from __future__ import annotations

import torch

__all__ = ["syrk_ref", "gemm_tn_ref"]


def gemm_tn_ref(a: torch.Tensor, b: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``C = alpha·AᵀB`` with float32 accumulation, float32 output."""
    out = torch.matmul(a.to(torch.float32).transpose(-1, -2), b.to(torch.float32))
    return (alpha * out).to(torch.float32)


def syrk_ref(a: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """``C = alpha·AᵀA`` full symmetric, float32 accumulation and output.

    Mirrors the kernel's exact-symmetry contract: the lower triangle is
    computed and reflected, so ``C == Cᵀ`` bitwise.
    """
    c = gemm_tn_ref(a, a, alpha)
    return torch.tril(c) + torch.tril(c, -1).transpose(-1, -2)
