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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

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
      A_matvec: callable y = A @ x on 1-D tensors.
      b: right-hand side.
      M: preconditioner callable z = M(r), e.g. one V-cycle; None=identity.
      tol: relative residual target ‖b − A x‖ ≤ tol·‖b‖.
      restart: Arnoldi steps per cycle (m).
      max_restarts: cycles at most.
    """
    precond = M if M is not None else (lambda r: r)
    n = b.shape[0]
    dtype, dev = b.dtype, b.device
    m = int(restart)
    nb = torch.linalg.norm(b)
    target = tol * nb
    eye_eps = _EPS_BREAKDOWN * torch.eye(m, dtype=dtype, device=dev)

    def arnoldi_cycle(x):
        r = b - A_matvec(x)
        beta = torch.linalg.norm(r)
        V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        Z = torch.zeros((m, n), dtype=dtype, device=dev)
        H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
        V[0] = _unit(r, beta)
        for j in range(m):
            z = precond(V[j])
            w = A_matvec(z)
            # Gram–Schmidt against basis rows 0..j (the rest are zero)
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w  # re-orthogonalisation pass
            w = w - Vj.T @ h2
            hn = torch.linalg.norm(w)
            V[j + 1] = _unit(w, hn)
            Z[j] = z
            H[:j + 1, j] = h + h2
            H[j + 1, j] = hn
        g = torch.zeros(m + 1, dtype=dtype, device=dev)
        g[0] = beta
        Q, R = torch.linalg.qr(H, mode="reduced")
        y = torch.linalg.solve_triangular(R + eye_eps, (Q.T @ g)[:, None],
                                          upper=True)[:, 0]
        return x + Z.T @ y

    x = torch.zeros_like(b)
    k = 0
    r_norm = nb
    while k < max_restarts and bool(r_norm > target):  # one host read a cycle
        x = arnoldi_cycle(x)
        r_norm = torch.linalg.norm(b - A_matvec(x))
        k += 1
    return GMRESResult(x=x, iters=k, residual_norm=r_norm,
                       converged=bool(r_norm <= target))
