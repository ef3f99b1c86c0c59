"""Preconditioned conjugate gradient as a Python loop over tensors.

Counterpart of ``parallel_amg_tpu/krylov/cg.py``: the same recurrences and
the same history layout (``maxiter + 1`` entries, inf-padded).  The stopping
test reads the residual norm back to the host once per iteration.  Inner
products flatten their operands, as ``jnp.vdot`` does, so b may be an N-D
grid (the structured path) or a PGrid split over a row mesh (the distributed
structured path), through the helpers of ``parallel/pgrid.py``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from parallel_amg_tpu_torch.parallel import pgrid


def _dot(a, b):
    return pgrid.vdot(a, b)


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int  # number of iterations performed
    residual_history: torch.Tensor  # (maxiter+1,), inf-padded past `iters`
    converged: bool


def cg(A_matvec: Callable, b, M: Optional[Callable] = None, tol: float = 1e-8,
       maxiter: int = 500) -> CGResult:
    """Preconditioned CG to relative residual `tol`.

    Args:
      A_matvec: callable y = A @ x.
      b: right-hand side.
      M: preconditioner callable z = M(r) — e.g. one V-cycle. None=identity.
      tol, maxiter: stopping parameters.
    """
    precond = M if M is not None else (lambda r: r)
    nb = pgrid.norm(b)
    target = tol * nb

    x = pgrid.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    hist = torch.full((maxiter + 1,), float("inf"), dtype=b.dtype,
                      device=b.device)
    hist[0] = nb
    k = 0
    converged = bool(nb <= target)
    while not converged and k < maxiter:
        q = A_matvec(p)
        alpha = rz / _dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        r_norm = pgrid.norm(r)
        hist[k + 1] = r_norm
        k += 1
        converged = bool(r_norm <= target)  # one device→host read
        if converged:
            break  # z, β and p of a finished solve are never read
        z = precond(r)
        rz_new = _dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
    return CGResult(x=x, iters=k, residual_history=hist, converged=converged)
