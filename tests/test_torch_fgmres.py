"""The port's flexible GMRES and nonsymmetric convection-diffusion against
the JAX package.

``convection2d`` is a numpy copy and must be bit-equal.  ``fgmres`` with a
Jacobi preconditioner and ``amg_fgmres`` with the V-cycle must take the JAX
package's restart-cycle counts; x agrees to float32 tolerance (rtol 1e-4,
atol 1e-5·max|x|: two float32 GMRES runs whose basis products sum in
another order).  At 128² and at the JAX test's 256² the port's
``amg_fgmres`` must converge where its ``amg_pcg`` fails, within 2 restart
cycles of scipy's GMRES(30) preconditioned by the float64 oracle V-cycle on
the same matrix (``tests/test_convection_fgmres.py``).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.krylov.gmres import fgmres as j_fgmres
from parallel_amg_tpu.ops.ell import ELL as JELL
from parallel_amg_tpu.problems import convection2d as j_convection2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.krylov.gmres import GMRESResult, fgmres
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.oracle import oracle_setup, oracle_vcycle
from parallel_amg_tpu_torch.problems import convection2d

torch.set_num_threads(2)

PE = 5.0


def _cfg(mod):
    return mod.AMGConfig(coarsening="rs", smoother="jacobi", n_coarse_max=128,
                         interpolation="extended_i")


def _rhs(n):
    return np.random.default_rng(0).normal(size=n)


def _rel(A_sp, x, b):
    x = np.asarray(x.detach().cpu(), np.float64).reshape(-1)
    return np.linalg.norm(b - A_sp @ x) / np.linalg.norm(b)


@pytest.mark.parametrize("args", [
    dict(nx=16), dict(nx=12, ny=20, pe_x=5.0, pe_y=2.5),
    dict(nx=10, pe_x=0.0, pe_y=0.0), dict(nx=9, ny=7, pe_x=3.0, row_range=(5, 40)),
    dict(nx=8, dtype=np.float32)])
def test_convection2d_bit_equal(args):
    mine, theirs = convection2d(**args), j_convection2d(**args)
    assert mine.shape == theirs.shape
    for a, b in ((mine.row, theirs.row), (mine.col, theirs.col),
                 (mine.val, theirs.val)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_matrix_shape_and_upwind_sign():
    coo = convection2d(64, pe_x=PE, pe_y=0.5 * PE)
    A_sp = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    d = A_sp.diagonal()
    assert np.all(d > 0)
    off = A_sp - sp.diags(d)
    assert off.nnz and np.all(off.data <= 0)
    assert np.all(np.asarray(A_sp.sum(axis=1)).ravel() >= -1e-12)
    assert abs(A_sp - A_sp.T).max() > PE - 1e-12


@pytest.mark.parametrize("restart", [10, 30])
def test_fgmres_jacobi_matches_jax(restart):
    """The same matrix and a Jacobi M: the same restart count, x to float32
    tolerance, on the port's ELL and the JAX package's."""
    csr = convection2d(32, pe_x=PE, pe_y=0.5 * PE).to_csr()
    A = ELL.from_csr(csr)
    jA = JELL.from_csr(j_convection2d(32, pe_x=PE, pe_y=0.5 * PE).to_csr(),
                       dtype=jnp.float32)
    d_inv = 1.0 / A.diagonal()
    b = _rhs(csr.n_rows).astype(np.float32)
    res = fgmres(A.matvec, torch.from_numpy(b), M=lambda r: d_inv * r,
                 tol=1e-6, restart=restart, max_restarts=40)
    jd = jnp.asarray(d_inv.numpy())
    jres = j_fgmres(jA.matvec, jnp.asarray(b), M=lambda r: jd * r, tol=1e-6,
                    restart=restart, max_restarts=40)
    assert isinstance(res, GMRESResult)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    x, jx = res.x.numpy(), np.asarray(jres.x)
    np.testing.assert_allclose(x, jx, rtol=1e-4, atol=1e-5 * np.abs(jx).max())
    assert float(res.residual_norm) <= 1e-6 * float(np.linalg.norm(b))
    assert _rel(csr.to_scipy(), res.x, b.astype(np.float64)) <= 2e-6


def test_fgmres_zero_rhs_and_identity_preconditioner():
    """b = 0 converges at once; without M the unpreconditioned GMRES(m) on a
    diagonal matrix is exact in one cycle."""
    A = ELL.from_csr(convection2d(8).to_csr())
    res = fgmres(A.matvec, torch.zeros(64), tol=1e-6)
    assert res.converged and res.iters == 0 and float(res.x.abs().max()) == 0.0
    D = torch.arange(1.0, 9.0)
    res = fgmres(lambda v: D * v, torch.ones(8), tol=1e-6, restart=8)
    assert res.converged and res.iters == 1
    np.testing.assert_allclose(res.x.numpy(), 1.0 / D.numpy(), rtol=1e-5)


def test_amg_fgmres_matches_jax_64():
    coo = convection2d(64, pe_x=PE, pe_y=0.5 * PE)
    A_sp = coo.to_csr().to_scipy()
    h = ptt.setup(coo.to_csr(), _cfg(ptt), device="cpu")
    jh = pat.setup(j_convection2d(64, pe_x=PE, pe_y=0.5 * PE).to_csr(), _cfg(pat))
    b = _rhs(A_sp.shape[0])
    res = ptt.amg_fgmres(h.levels[0].A, h, torch.from_numpy(b.astype(np.float32)),
                         tol=1e-6, restart=30, max_restarts=20)
    jres = pat.amg_fgmres(jh.levels[0].A, jh, jnp.asarray(b, jnp.float32),
                          tol=1e-6, restart=30, max_restarts=20)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert _rel(A_sp, res.x, b) < 5e-6


@pytest.mark.parametrize("n", [128, 256])
def test_amg_pcg_fails_where_fgmres_converges(n):
    """CG has no SPD inner product on the Péclet-5 operator and must fail
    within 80 iterations; AMG-FGMRES converges and truly solves it, within
    2 restart cycles of scipy GMRES(30) over the oracle V-cycle."""
    coo = convection2d(n, pe_x=PE, pe_y=0.5 * PE)
    A_sp = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    h = ptt.setup(coo.to_csr(), _cfg(ptt), device="cpu")
    b = _rhs(A_sp.shape[0])
    b32 = torch.from_numpy(b.astype(np.float32))
    res_cg = ptt.amg_pcg(h.levels[0].A, h, b32, tol=1e-6, maxiter=80)
    assert not res_cg.converged
    res = ptt.amg_fgmres(None, h, b32, tol=1e-6, restart=30, max_restarts=20)
    assert res.converged
    assert _rel(A_sp, res.x, b) < 5e-6

    oh = oracle_setup(A_sp, _cfg(ptt))
    M = spla.LinearOperator(
        A_sp.shape, matvec=lambda r: oracle_vcycle(oh, np.zeros_like(r), r))
    outer = {"n": 0}

    def cb(_):
        outer["n"] += 1

    _, info = spla.gmres(A_sp, b, M=M, restart=30, maxiter=20, rtol=1e-6,
                         callback=cb, callback_type="pr_norm")
    assert info == 0
    oracle_cycles = max(outer["n"] // 30 + 1, 1)
    assert res.iters <= oracle_cycles + 2


def test_amg_fgmres_structured_layout():
    """On a structured hierarchy (grid dims) GMRES runs flat and reshapes at
    each operator application; the result is 1-D and solves the system."""
    from parallel_amg_tpu_torch.problems import poisson2d

    n = 32
    csr = poisson2d(n).to_csr()
    cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                        smoother="chebyshev", n_coarse_max=64)
    h = ptt.setup(csr, cfg, device="cpu", dims=(n, n))
    assert h.grid_dims == (n, n)
    b = _rhs(n * n)
    res = ptt.amg_fgmres(None, h, torch.from_numpy(b.astype(np.float32)),
                         tol=1e-6, restart=10, max_restarts=10)
    assert res.converged and res.x.shape == (n * n,)
    assert _rel(csr.to_scipy(), res.x, b) < 5e-6
