"""Packed normal-equations solvers of the port: the factor path and
matrix-free CG."""

from repro_torch.solve.cg import cg_gram, cg_lstsq
from repro_torch.solve.cholesky import CholeskyFactor, cholesky
from repro_torch.solve.lstsq import lstsq
from repro_torch.solve.triangular import solve_cholesky, solve_triangular

__all__ = ["CholeskyFactor", "cg_gram", "cg_lstsq", "cholesky", "lstsq", "solve_cholesky",
           "solve_triangular"]
