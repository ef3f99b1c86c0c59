"""Top-level solver entry point: AMG-preconditioned CG.

Counterpart of ``parallel_amg_tpu/solver.py::amg_pcg``.
"""

from __future__ import annotations

from parallel_amg_tpu_torch.amg.cycle import _cycle
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy
from parallel_amg_tpu_torch.krylov.cg import cg, CGResult
from parallel_amg_tpu_torch.parallel import pgrid


def amg_pcg(A, hierarchy: Hierarchy, b, tol: float = 1e-8,
            maxiter: int = 500) -> CGResult:
    """AMG-preconditioned CG: one multigrid cycle per CG iteration.

    Pass A=None to solve with the hierarchy's own fine operator.  On the
    distributed structured path b is a PGrid (``distribute_grid``) and so
    is the solution.
    """
    if A is None:
        A = hierarchy.levels[0].A
    gamma = 1 if hierarchy.config.cycle == "V" else 2
    bg = hierarchy.to_grid(b)

    def M(r):
        return _cycle(hierarchy, 0, pgrid.zeros_like(r), r, gamma)

    res = cg(A.matvec, bg, M=M, tol=tol, maxiter=maxiter)
    return res._replace(x=pgrid.reshape(res.x, b.shape))
