"""Flexible GMRES(m): restarted and right-preconditioned, for nonsymmetric
operators and preconditioners that change between applications.

Counterpart of ``parallel_amg_tpu/krylov/gmres.py``, with the same
algorithm: each restart cycle runs exactly m Arnoldi steps (a happy
breakdown zero-pads the basis instead of leaving early), orthogonalises
each new vector against the basis twice (one Gram–Schmidt pass and one
re-orthogonalisation pass, as block products with the basis), stores the
preconditioned vectors Z (Saad's flexible variant) and solves the small
least-squares problem by a QR of H and a triangular solve with an ``eps·I``
guard.  Convergence is tested at restart boundaries only.  A Python loop
replaces ``lax.fori_loop`` and ``lax.while_loop``; the stopping test reads
the true residual norm back to the host once per restart cycle.  The basis
products and the QR are torch calls, as the JAX package computes them
outside any kernel.

b may be a PGrid split over a row mesh (the distributed algebraic path,
``parallel/pvector.py``), where the JAX package's FGMRES runs over sharded
vectors.  The cycle works on a list of parts either way (a tensor is one
part): each part holds its own (m+1, n_p) block of the basis and its
(m, n_p) block of Z, the products ``Vj @ w`` are the per-part products
summed over the parts (``exchange.psum``; one part is its own sum), and
``Vj.T @ h`` and ``Z.T @ y`` stay per part.  The small problem (H, g, y)
lives on the first local part's device, the same on every process.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from parallel_amg_tpu_torch.parallel import exchange, pgrid
from parallel_amg_tpu_torch.parallel.pgrid import PGrid

_EPS_BREAKDOWN = 1e-30


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int  # restart cycles executed
    residual_norm: torch.Tensor  # ‖b − A x‖ of the returned x, 0-d
    converged: bool


def _unit(v, norm):
    """v / norm, or zeros where the norm is at the breakdown floor."""
    return torch.where(norm > _EPS_BREAKDOWN,
                       1.0 / torch.clamp(norm, min=_EPS_BREAKDOWN), 0.0) * v


def fgmres(A_matvec: Callable, b, M: Optional[Callable] = None,
           tol: float = 1e-8, restart: int = 30,
           max_restarts: int = 50) -> GMRESResult:
    """Right-preconditioned flexible GMRES(restart) for a 1-D b.

    Args:
      A_matvec: callable y = A @ x on 1-D tensors (on PGrids where b is one).
      b: right-hand side, a 1-D tensor or a PGrid.
      M: preconditioner callable z = M(r), e.g. one V-cycle; None=identity.
      tol: relative residual target ‖b − A x‖ ≤ tol·‖b‖.
      restart: Arnoldi steps per cycle (m).
      max_restarts: cycles at most.
    """
    precond = M if M is not None else (lambda r: r)
    if isinstance(b, PGrid):
        mesh = b.mesh

        def parts(v):
            return v.parts

        def whole(ps):
            return PGrid(ps, mesh)

        psum = exchange.psum
    else:
        def parts(v):
            return [v]

        def whole(ps):
            return ps[0]

        def psum(ps):
            return ps[0]

    dtype, dev0 = b.dtype, parts(b)[0].device
    m = int(restart)
    nb = pgrid.norm(b)
    target = tol * nb
    eye_eps = _EPS_BREAKDOWN * torch.eye(m, dtype=dtype, device=dev0)

    def project(V, j, w):
        """(h on the first part's device, w − Vjᵀh per part) for basis rows
        0..j (the rest are zero)."""
        h = psum([Vp[:j + 1] @ wp for Vp, wp in zip(V, w)])
        return h, [wp - Vp[:j + 1].T @ h.to(wp.device) for Vp, wp in zip(V, w)]

    def arnoldi_cycle(x):
        r = b - A_matvec(x)
        beta = pgrid.norm(r)
        V = [torch.zeros((m + 1,) + tuple(p.shape), dtype=dtype, device=p.device)
             for p in parts(b)]
        Z = [torch.zeros((m,) + tuple(p.shape), dtype=dtype, device=p.device)
             for p in parts(b)]
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev0)
        for Vp, rp in zip(V, parts(r)):
            Vp[0] = _unit(rp, beta.to(rp.device))
        for j in range(m):
            z = precond(whole([Vp[j] for Vp in V]))
            w = parts(A_matvec(z))
            h, w = project(V, j, w)
            h2, w = project(V, j, w)  # re-orthogonalisation pass
            hn = pgrid.norm(whole(w))
            for Vp, Zp, wp, zp in zip(V, Z, w, parts(z)):
                Vp[j + 1] = _unit(wp, hn.to(wp.device))
                Zp[j] = zp
            H[:j + 1, j] = h + h2
            H[j + 1, j] = hn
        g = torch.zeros(m + 1, dtype=dtype, device=dev0)
        g[0] = beta
        Q, R = torch.linalg.qr(H, mode="reduced")
        y = torch.linalg.solve_triangular(R + eye_eps, (Q.T @ g)[:, None],
                                          upper=True)[:, 0]
        return x + whole([Zp.T @ y.to(Zp.device) for Zp in Z])

    x = pgrid.zeros_like(b)
    k = 0
    r_norm = nb
    while k < max_restarts and bool(r_norm > target):  # one host read a cycle
        x = arnoldi_cycle(x)
        r_norm = pgrid.norm(b - A_matvec(x))
        k += 1
    return GMRESResult(x=x, iters=k, residual_norm=r_norm,
                       converged=bool(r_norm <= target))
