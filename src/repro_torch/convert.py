"""Carry state between the reference and the port as numpy arrays.

The reference's packed objects (``repro.core.symmetric.SymmetricMatrix``,
``repro.solve.cholesky.CholeskyFactor``) are a ``(..., T, bn, bn)`` block
array plus ``(n, bn)``; so are the port's. These converters move the block
array across unchanged, so one stage's reference output can feed the
port's next stage (for example, the JAX packed gram into the port's
``cholesky``) and back.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.symmetric import SymmetricMatrix
from repro_torch.solve.cholesky import CholeskyFactor

__all__ = ["symmetric_from_numpy", "factor_from_numpy", "to_numpy"]


def _blocks(blocks, n, bn, device):
    arr = np.asarray(blocks)
    nb = -(-int(n) // int(bn))
    if arr.ndim < 3 or arr.shape[-3:] != (nb * (nb + 1) // 2, bn, bn):
        raise ValueError(
            f"blocks of shape {arr.shape} do not hold a packed grid with n={n}, bn={bn}"
        )
    return torch.tensor(arr, device=resolve_device(device))  # a copy: arr may be read-only


def symmetric_from_numpy(blocks, n: int, bn: int, *, device="cuda") -> SymmetricMatrix:
    """A port :class:`SymmetricMatrix` from packed blocks given as an array."""
    return SymmetricMatrix(_blocks(blocks, n, bn, device), n, bn)


def factor_from_numpy(blocks, n: int, bn: int, *, device="cuda") -> CholeskyFactor:
    """A port :class:`CholeskyFactor` from packed factor blocks."""
    return CholeskyFactor(_blocks(blocks, n, bn, device), n, bn)


def to_numpy(x):
    """A tensor as a numpy array; a packed object as ``(blocks, n, bn)``."""
    if isinstance(x, (SymmetricMatrix, CholeskyFactor)):
        return x.blocks.detach().cpu().numpy(), x.n, x.bn
    return x.detach().cpu().numpy()
