"""Packed normal-equations solvers of the port (factor path)."""

from repro_torch.solve.cholesky import CholeskyFactor, cholesky
from repro_torch.solve.lstsq import lstsq
from repro_torch.solve.triangular import solve_cholesky, solve_triangular

__all__ = ["CholeskyFactor", "cholesky", "lstsq", "solve_cholesky", "solve_triangular"]
