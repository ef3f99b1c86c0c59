"""Multigrid cycles as plain functions on tensors.

Counterpart of ``parallel_amg_tpu/amg/cycle.py``.  The V/W-cycle is a Python
recursion over the hierarchy's levels; each operator application launches its
own kernels (no tracing), and ``solve`` reads one residual norm back to the
host per cycle for its stopping test.  Iterates may be PGrids (the
distributed structured path, ``parallel/pgrid.py``).
"""

from __future__ import annotations

import torch

from parallel_amg_tpu_torch.amg import smoothers
from parallel_amg_tpu_torch.parallel import pgrid


def coarse_solve(hierarchy, b):
    """Dense coarse solve: one matmul with the precomputed M⁻¹.  A PGrid
    right-hand side is gathered on M⁻¹'s device and the solution split
    back over its mesh."""
    Minv = hierarchy.coarse_inv
    if isinstance(b, pgrid.PGrid):
        return pgrid.PGrid.from_global(
            coarse_solve(hierarchy, b.to_global(Minv.device)), b.mesh)
    x = Minv @ b.reshape(-1).to(Minv.dtype)
    return x.to(b.dtype).reshape(b.shape)


def _zeros_coarse(P, b):
    if hasattr(P, "zeros_coarse"):
        return P.zeros_coarse(b.dtype)
    return torch.zeros(P.shape[1], dtype=b.dtype, device=b.device)


def _apply_transfer(T, level, v):
    """Apply P or R; linked block transfers borrow the level's operator and
    d_inv, so the hierarchy holds the fine operator once."""
    if getattr(T, "linked", False):
        return T.matvec_linked(level.A, level.d_inv, v)
    return T.matvec(v)


def _cycle(hierarchy, lvl: int, x, b, gamma: int):
    cfg = hierarchy.config
    if lvl == hierarchy.n_levels - 1:
        return coarse_solve(hierarchy, b)
    level = hierarchy.levels[lvl]
    x = smoothers.smooth(level, x, b, cfg, cfg.nu_pre)
    r = b - level.A.matvec(x)
    bc = _apply_transfer(level.R, level, r)
    xc = _zeros_coarse(level.P, b)
    for _ in range(gamma):
        xc = _cycle(hierarchy, lvl + 1, xc, bc, gamma)
    x = x + _apply_transfer(level.P, level, xc)
    x = smoothers.smooth(level, x, b, cfg, cfg.nu_post)
    return x


def vcycle(hierarchy, x, b):
    """One multigrid cycle (V or W per config) starting from iterate x."""
    gamma = 1 if hierarchy.config.cycle == "V" else 2
    out = _cycle(hierarchy, 0, hierarchy.to_grid(x), hierarchy.to_grid(b), gamma)
    return pgrid.reshape(out, x.shape)


def solve(hierarchy, b, tol: float = 1e-8, maxiter: int = 100):
    """Standalone multigrid: cycle until ||r|| ≤ tol·||b|| or maxiter.

    Returns (x, residual_history, n_cycles) with the history padded to
    ``maxiter`` (inf past the end).
    """
    target = tol * pgrid.norm(b)
    bg = hierarchy.to_grid(b)
    gamma = 1 if hierarchy.config.cycle == "V" else 2
    hist = torch.full((maxiter,), float("inf"), dtype=b.dtype, device=b.device)
    x = pgrid.zeros_like(bg)
    k = 0
    while k < maxiter:
        x = _cycle(hierarchy, 0, x, bg, gamma)
        r_norm = pgrid.norm(bg - hierarchy.levels[0].A.matvec(x))
        hist[k] = r_norm
        k += 1
        if r_norm <= target:  # one device→host read per cycle
            break
    return pgrid.reshape(x, b.shape), hist, k
