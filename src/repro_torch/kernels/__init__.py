"""Hand-written CUDA kernels of the port, each beside its plain version.

* ``syrk``    — lower-tile ``alpha·AᵀA``, dense (dual write) or packed
  (``csrc/syrk.cu``; replaces ``repro.kernels.syrk.syrk_pallas``).
* ``gemm_tn`` — ``alpha·AᵀB`` without forming ``Aᵀ`` (``csrc/gemm_tn.cu``;
  replaces ``gemm_tn_pallas``).
* ``gemm_tn_fused`` — every Strassen leaf product of a fused level, the
  ±1 slot combinations summed inside the kernel, once per CTA cluster
  (``csrc/gemm_tn_fused.cu``; replaces ``gemm_tn_fused_pallas``).
* ``syrk_gather`` — dense syrk of gathered diagonal leaves
  (``csrc/syrk.cu``; replaces ``syrk_gather_pallas``).
* ``potrf``   — lower Cholesky factor of SPD tiles (``csrc/potrf.cu``;
  replaces ``potrf_pallas``).
* ``trsm``    — triangular panel solve (``csrc/trsm.cu``; replaces
  ``trsm_pallas``).

Contracts shared by all six, as in the reference package:

* **Device routing** (the counterpart of interpret mode): a CUDA operand
  launches the kernel or raises; a CPU operand runs the plain version.
* **Batched grid**: an optional leading stack dim is a grid dimension of
  one launch, never a Python loop of launches.
* **Summation order**: each kernel sums every output in an order that
  depends on neither the batch index nor the batch size, so a stack and its
  entries launched one by one agree bitwise on the card.

The kernels build at first use (``_build.load``); importing this package
needs no CUDA toolkit.
"""

from repro_torch.kernels import ops
from repro_torch.kernels.ops import gemm_tn, gemm_tn_fused, potrf, syrk, syrk_gather, trsm

__all__ = ["ops", "gemm_tn", "gemm_tn_fused", "syrk", "syrk_gather", "potrf", "trsm"]
