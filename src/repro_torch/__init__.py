"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its layout
and names module for module, so each counterpart sits at the same dotted
path (``repro.core.ata`` ↔ ``repro_torch.core.ata``). It imports ``torch``,
``numpy`` and the standard library only.

Where work runs: library functions run on the device of their input
tensors. On a CUDA tensor every kernel of the path is a hand-written CUDA
C++ kernel for ``sm_90a`` (``repro_torch.kernels``); on a CPU tensor the
same wrappers run each kernel's plain PyTorch version. Functions that make
tensors from nothing take ``device=`` and default to ``"cuda"``.

Precision: the plain float32 products that the reference computes outside
any kernel (Schur updates, ``Aᵀb``) stay in IEEE float32 on the card, so
TF32 is switched off for matmuls and cuDNN here, once, at import.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.core import SymmetricMatrix, ata, ata_batched, strassen_tn  # noqa: E402
from repro_torch.solve import cholesky, lstsq, solve_cholesky, solve_triangular  # noqa: E402

__all__ = [
    "SymmetricMatrix",
    "ata",
    "ata_batched",
    "strassen_tn",
    "cholesky",
    "lstsq",
    "solve_cholesky",
    "solve_triangular",
]
