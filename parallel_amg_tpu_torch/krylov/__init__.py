"""Krylov solvers over any operator exposing ``matvec``: AMG-preconditioned
CG and flexible GMRES."""

from parallel_amg_tpu_torch.krylov.cg import cg, CGResult
from parallel_amg_tpu_torch.krylov.gmres import fgmres, GMRESResult

__all__ = ["cg", "CGResult", "fgmres", "GMRESResult"]
