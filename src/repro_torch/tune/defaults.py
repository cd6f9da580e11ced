"""Static tunables of the port — a copy of ``repro.tune.defaults``.

The port does not import the reference package, so the constants that the
slice's pinned regime needs are repeated here with the reference's values.
``SYRK_BLOCKS``/``GEMM_BLOCKS`` keep their meaning for output geometry only
(the packed ``syrk`` block size derives from ``SYRK_BLOCKS[1]``); the CUDA
kernels choose their own CTA tiles.
"""

from __future__ import annotations

__all__ = [
    "DEFAULT_N_BASE",
    "DEFAULT_PACKED_BLOCK",
    "SYRK_BLOCKS",
    "GEMM_BLOCKS",
    "DEFAULT_VARIANT",
    "DEFAULT_LEAF_DISPATCH",
    "DEFAULT_SOLVE_METHOD",
    "CG_MAX_ITERS",
    "CG_TOL",
]

# Recursion cutoff of the Strassen/ATA recursion.
DEFAULT_N_BASE = 512

# Block size of the packed (SymmetricMatrix) output grid.
DEFAULT_PACKED_BLOCK = 128

# syrk blocks (bm, bn): contraction block, output block.
SYRK_BLOCKS = (512, 256)

# gemm_tn blocks (bm, bn, bk): contraction, C-row, C-col.
GEMM_BLOCKS = (512, 256, 256)

# Strassen variant for the off-diagonal products when nothing chose one.
DEFAULT_VARIANT = "strassen"

# How the recursion's leaf products reach the hardware when nothing chose.
DEFAULT_LEAF_DISPATCH = "unrolled"

# Normal-equations solver (repro_torch.solve) when nothing chose a method:
# 'factor' = packed gram → packed Cholesky → two substitutions; 'cg' =
# matrix-free CG on the gram operator.
DEFAULT_SOLVE_METHOD = "factor"

# CG budget: iteration cap (also capped by n — exact termination in exact
# arithmetic) and relative residual tolerance.
CG_MAX_ITERS = 64
CG_TOL = 1e-6
