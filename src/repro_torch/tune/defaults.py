"""Tunables of the port — a copy of ``repro.tune.defaults``.

The port does not import the reference package, so its constants are
repeated here with the reference's values: the static defaults of the
pinned regime and the candidate grids the planner (``repro_torch.tune``)
sweeps. ``SYRK_BLOCKS``/``GEMM_BLOCKS`` and their candidates keep their
meaning for output geometry and plan identity only (the packed ``syrk``
block size derives from ``SYRK_BLOCKS[1]``); the CUDA kernels choose their
own CTA tiles.

Like the reference's, this module imports nothing, so ``core`` and
``kernels`` may import it without a cycle.
"""

from __future__ import annotations

__all__ = [
    "DEFAULT_N_BASE",
    "DEFAULT_PACKED_BLOCK",
    "SYRK_BLOCKS",
    "GEMM_BLOCKS",
    "DEFAULT_VARIANT",
    "DEFAULT_LEAF_DISPATCH",
    "LEAF_DISPATCH_CANDIDATES",
    "DEFAULT_SOLVE_METHOD",
    "CG_MAX_ITERS",
    "CG_TOL",
    "TARGET_TILES_PER_DEVICE",
    "MAX_COMM_SCHEDULE_LEVELS",
    "N_BASE_CANDIDATES",
    "SYRK_BLOCK_CANDIDATES",
    "GEMM_BLOCK_CANDIDATES",
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

# Leaf-dispatch axis the planner enumerates ('fused' is dropped for the
# winograd variant and for dense/degenerate candidates by `cost.candidates`).
LEAF_DISPATCH_CANDIDATES = ("unrolled", "batched", "fused")

# Normal-equations solver (repro_torch.solve) when nothing chose a method:
# 'factor' = packed gram → packed Cholesky → two substitutions; 'cg' =
# matrix-free CG on the gram operator.
DEFAULT_SOLVE_METHOD = "factor"

# CG budget: iteration cap (also capped by n — exact termination in exact
# arithmetic) and relative residual tolerance.
CG_MAX_ITERS = 64
CG_TOL = 1e-6

# Distributed tile schedule: lower-triangle tiles a device of the task axis
# aims for. Read by the distributed branch of the planner (ROADMAP A5).
TARGET_TILES_PER_DEVICE = 2

# BFS/DFS interleaving search depth of the distributed branch (ROADMAP A5).
MAX_COMM_SCHEDULE_LEVELS = 3

# Candidate grids swept by the analytic model and the measured autotuner.
N_BASE_CANDIDATES = (128, 256, 512, 1024)
SYRK_BLOCK_CANDIDATES = ((256, 128), (512, 128), (512, 256), (1024, 256))
GEMM_BLOCK_CANDIDATES = (
    (256, 128, 128),
    (512, 256, 256),
    (512, 512, 256),
    (1024, 256, 256),
)
