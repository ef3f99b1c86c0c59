"""Top-level solver entry points: AMG-preconditioned CG, its mixed-precision
form to a true 1e-8, and AMG-preconditioned flexible GMRES.

Counterpart of ``parallel_amg_tpu/solver.py``.  The JAX package's
``utils/precision.py::x64_scope`` has no counterpart: torch has float64
tensors natively, so ``amg_pcg_mp`` makes its Krylov vectors float64 without
a global switch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from parallel_amg_tpu_torch.amg.cycle import _cycle, vcycle
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy
from parallel_amg_tpu_torch.krylov.cg import cg, CGResult
from parallel_amg_tpu_torch.krylov.gmres import fgmres, GMRESResult
from parallel_amg_tpu_torch.parallel import pgrid


def amg_pcg(A, hierarchy: Hierarchy, b, tol: float = 1e-8,
            maxiter: int = 500) -> CGResult:
    """AMG-preconditioned CG: one multigrid cycle per CG iteration.

    Pass A=None to solve with the hierarchy's own fine operator.  On the
    distributed structured path b is a PGrid (``distribute_grid``) and so
    is the solution.  A float32 operator with a bfloat16 hierarchy runs the
    cycle's vectors in float32 (the kernels take bfloat16 values with
    float32 vectors, as jnp's promotion does in the JAX package).
    """
    if A is None:
        A = hierarchy.levels[0].A
    gamma = 1 if hierarchy.config.cycle == "V" else 2
    bg = hierarchy.to_grid(b)

    def M(r):
        return _cycle(hierarchy, 0, pgrid.zeros_like(r), r, gamma)

    res = cg(A.matvec, bg, M=M, tol=tol, maxiter=maxiter)
    return res._replace(x=pgrid.reshape(res.x, b.shape))


def _dia_matvec_f64(diags, offsets, x):
    """Σ_d diags[d] ⊙ x[r + offsets[d]] over one zero-padded 1-D x, in
    offset order, in x's dtype."""
    n = x.shape[0]
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    xp = F.pad(x, (lo, hi))
    y = torch.zeros_like(x)
    for d, off in enumerate(offsets):
        y = y + diags[d] * xp[lo + off:lo + off + n]
    return y


def f64_matvec(A):
    """The float64 A·p of ``amg_pcg_mp``: A's own float32 values widened to
    float64 once (a copy that lives as long as the returned callable), then
    applied with plain torch ops.

    This is not a fallback from a kernel.  The JAX package computes the same
    product with XLA ops on its f32 planes promoted to f64 (its contract:
    "A must be an XLA-backend operator"), and no Pallas kernel computes it
    there either; the port's kernels take float32 or bfloat16 only.
    Stencil: its shifted-slice matvec on float64 planes.  FlatDIA: its
    Stencil form where one exists, else the shifted-slice sum over its flat
    planes.  DIA: the shifted-slice sum.  ELL: the gather sum.  Every other
    format (TWELL, BSR, BTWELL, BlockStencil, ...) raises ``TypeError``.
    """
    from parallel_amg_tpu_torch.ops.dia import DIA
    from parallel_amg_tpu_torch.ops.ell import ELL
    from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    if isinstance(A, FlatDIA):
        st = A.to_stencil()
        if st is None:
            diags, offsets = A.diags.double(), A.offsets
            return lambda x: _dia_matvec_f64(
                diags, offsets, x.reshape(-1)).reshape(x.shape)
        A = st
    if isinstance(A, Stencil):
        return Stencil(A.weights.double(), A.offsets, A.dims).matvec
    if isinstance(A, DIA):
        diags, offsets = A.diags.double(), A.offsets
        return lambda x: _dia_matvec_f64(diags, offsets, x)
    if isinstance(A, ELL):
        return ELL(A.cols, A.vals.double(), A.row_nnz, A.shape).matvec
    raise TypeError(
        f"amg_pcg_mp applies A in float64 with torch ops on a Stencil, "
        f"FlatDIA, DIA or ELL operator, not {type(A).__name__} (the JAX "
        f"package's contract: A must be an XLA-backend operator)")


def _cycle_dtype(hierarchy: Hierarchy):
    """The dtype of the V-cycle's vectors: the hierarchy's (``d_inv``'s),
    except float32 for a bfloat16 hierarchy, whose kernels take bfloat16
    values with float32 vectors."""
    dtype = hierarchy.levels[0].d_inv.dtype
    return torch.float32 if dtype == torch.bfloat16 else dtype


def amg_pcg_mp(A, hierarchy: Hierarchy, b, tol: float = 1e-8,
               maxiter: int = 500) -> CGResult:
    """Mixed-precision AMG-PCG to a true relative residual of ``tol``.

    Krylov vectors, dot products, the residual history and A·p run in
    float64; the preconditioner is the hierarchy's V-cycle unchanged, on
    its own formats and kernels: r is cast down to the cycle's dtype
    (``_cycle_dtype``) and z back up.  A float32 CG cannot report 1e-8
    honestly: its recursive residual keeps falling below the true residual,
    which stalls orders of magnitude higher.

    ``A`` (None: the hierarchy's fine operator) applies through
    ``f64_matvec``, which takes Stencil, FlatDIA, DIA and ELL and raises
    ``TypeError`` on the kernel-only formats.  ``b`` is a tensor or numpy
    array, 1-D or in the grid's shape; it is widened to float64 on the
    hierarchy's device.  The JAX package drops its hierarchy to XLA for this
    solve only because Pallas cannot trace under x64; the port keeps every
    level on its kernels.
    """
    if A is None:
        A = hierarchy.levels[0].A
    A_mv = f64_matvec(A)
    gamma = 1 if hierarchy.config.cycle == "V" else 2
    dev = hierarchy.coarse_inv.device
    shape = tuple(b.shape)
    bg = hierarchy.to_grid(torch.as_tensor(b, dtype=torch.float64,
                                           device=dev).reshape(-1))
    pdtype = _cycle_dtype(hierarchy)

    def M(r):
        z = _cycle(hierarchy, 0, torch.zeros(r.shape, dtype=pdtype,
                                             device=r.device),
                   r.to(pdtype), gamma)
        return z.to(r.dtype)

    res = cg(A_mv, bg, M=M, tol=tol, maxiter=maxiter)
    return res._replace(x=res.x.reshape(shape))


def amg_fgmres(A, hierarchy: Hierarchy, b, tol: float = 1e-8,
               restart: int = 30, max_restarts: int = 50) -> GMRESResult:
    """AMG-preconditioned flexible GMRES for nonsymmetric operators.

    GMRES stacks basis vectors, so it runs in the flat 1-D layout; on a
    structured hierarchy (``grid_dims`` set) each operator application
    reshapes to the grid and back.  On a distributed PCSR hierarchy b is a
    PGrid (``pvector``) and so is the solution.  M is one ``vcycle``.  Pass
    A=None to solve with the hierarchy's fine operator.
    """
    if A is None:
        A = hierarchy.levels[0].A
    dims = hierarchy.grid_dims

    if dims is None:
        A_mv = A.matvec
    else:
        def A_mv(v):
            return A.matvec(v.reshape(dims)).reshape(-1)

    def M(r):
        return vcycle(hierarchy, pgrid.zeros_like(r), r)

    return fgmres(A_mv, b, M=M, tol=tol, restart=restart,
                  max_restarts=max_restarts)
