"""The port's host-oracle distributed structured setup
(parallel/pstructured.py) against the JAX package's, on 8 parts.

Both packages start from the same scipy matrix and the same float64 oracle
setup, so their levels are the same numbers rounded to float32.  Tolerances:
- V-cycles: rtol 2e-5, atol 2e-6 (the backend-swap tolerance of
  tests/test_backend_swap.py);
- the level-1 matvec against the oracle's float64 operator: rtol 2e-4,
  atol 2e-5 (tests/test_pstructured.py:71);
- PCG iteration counts and the distribute/collect round trip: equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pstructured as jps
from parallel_amg_tpu.problems import poisson2d as j_poisson2d, poisson3d as j_poisson3d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.oracle import oracle_setup
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.parallel.pstructured import SBlockProlongator

torch.set_num_threads(2)

V_RTOL, V_ATOL = 2e-5, 2e-6
DIMS = (16, 16, 16)


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=2,
                         smoother="chebyshev", n_coarse_max=64)


def _sp(coo):
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


def _rhs(n, seed):
    return np.random.default_rng(seed).normal(size=n)


@functools.cache
def _setups():
    A = _sp(j_poisson3d(*DIMS))
    mesh, jmesh = ptt.make_row_mesh(8, device="cpu"), j_make_row_mesh(8)
    h = ptt.structured_distributed_setup(A, _cfg(ptt), mesh, DIMS)
    jh = jps.structured_distributed_setup(A, _cfg(pat), jmesh, DIMS)
    return A, h, jh, mesh, jmesh


@functools.cache
def _jax_vcycle(seed):
    A, _, jh, _, jmesh = _setups()
    jb = jps.distribute_grid(_rhs(A.shape[0], seed), DIMS, jh, jmesh)
    return jps.collect_grid(jax.jit(pat.vcycle)(jh, jnp.zeros_like(jb), jb), DIMS)


def test_structured_distributed_levels_and_vcycle_match_jax():
    A, h, jh, mesh, _ = _setups()
    assert h.n_levels == jh.n_levels
    for l, jl in zip(h.levels, jh.levels):
        assert isinstance(l.A, ShardedStencil) and l.A.dims == jl.A.dims
        assert l.A.offsets == jl.A.offsets and l.true_n == jl.true_n
        np.testing.assert_array_equal(l.A.global_weights().numpy(),
                                      np.asarray(jl.A.weights))
        np.testing.assert_array_equal(l.d_inv.to_global().numpy(), np.asarray(jl.d_inv))
    assert isinstance(h.levels[0].P, SBlockProlongator) and not h.levels[0].P.linked
    np.testing.assert_allclose(h.complexity(), jh.complexity(), rtol=1e-12)
    b = _rhs(A.shape[0], 1)
    bd = ptt.distribute_grid(b, DIMS, h, mesh)
    mine = ptt.collect_grid(ptt.vcycle(h, bd.zeros_like(), bd), DIMS)
    np.testing.assert_allclose(mine, _jax_vcycle(1), rtol=V_RTOL, atol=V_ATOL)


def test_structured_distributed_pcg_iterations_equal_jax():
    A, h, jh, mesh, jmesh = _setups()
    b = _rhs(A.shape[0], 2)
    res = ptt.amg_pcg(None, h, ptt.distribute_grid(b, DIMS, h, mesh), tol=1e-6,
                      maxiter=60)
    jres = pat.amg_pcg(jh.levels[0].A, jh, jps.distribute_grid(b, DIMS, jh, jmesh),
                       tol=1e-6, maxiter=60)
    assert res.converged and res.iters == int(jres.iters)
    x = ptt.collect_grid(res.x, DIMS).astype(np.float64)
    assert np.linalg.norm(b - A @ x) <= 5e-6 * np.linalg.norm(b)
    # and the single-device structured path's count
    h1 = ptt.setup(A, _cfg(ptt), device="cpu", dims=DIMS)
    res1 = ptt.amg_pcg(None, h1, torch.tensor(b, dtype=torch.float32), tol=1e-6,
                       maxiter=60)
    assert abs(res.iters - res1.iters) <= 2


def test_interop_carries_jax_structured_distributed_hierarchy():
    A, _, jh, mesh, _ = _setups()

    def op(T):
        if T is None:
            return None
        if type(T).__name__ == "ShardedStencil":
            return {"format": "ShardedStencil", "weights": np.asarray(T.weights),
                    "offsets": T.offsets, "dims": T.dims, "halo_mode": T.halo_mode}
        return {"format": type(T).__name__, "scale": np.asarray(T.scale),
                "coef": np.asarray(T.coef), "dims": T.dims, "cdims": T.cdims,
                "block": T.block, "true_d0": T.true_d0}

    levels = [{"A": op(l.A), "P": op(l.P), "R": op(l.R), "d_inv": np.asarray(l.d_inv),
               "lam_max": np.asarray(l.lam_max), "true_n": l.true_n} for l in jh.levels]
    carried = interop.hierarchy_from_numpy(
        levels, np.asarray(jh.coarse_inv), ptt.AMGConfig(**dataclasses.asdict(jh.config)),
        mesh=mesh)
    assert carried.levels[0].P.linked and isinstance(carried.levels[0].d_inv, PGrid)
    bd = ptt.distribute_grid(_rhs(A.shape[0], 1), DIMS, carried, mesh)
    mine = ptt.collect_grid(ptt.vcycle(carried, bd.zeros_like(), bd), DIMS)
    np.testing.assert_allclose(mine, _jax_vcycle(1), rtol=V_RTOL, atol=V_ATOL)
    with pytest.raises(ValueError):
        interop.hierarchy_from_numpy(levels, np.asarray(jh.coarse_inv),
                                     ptt.AMGConfig(), device="cpu")  # no mesh


def test_distribute_collect_round_trip():
    _, h, _, mesh, _ = _setups()
    dims = (13, 16, 16)  # a true grid shorter than the padded one
    v = np.random.default_rng(3).normal(size=int(np.prod(dims))).astype(np.float32)
    g = ptt.distribute_grid(v, dims, h, mesh)
    assert isinstance(g, PGrid) and g.shape == h.levels[0].A.dims
    np.testing.assert_array_equal(ptt.collect_grid(g, dims), v)
    full = g.to_global().numpy()
    assert not full[13:].any()


def test_sharded_stencil_halo2_matches_oracle():
    """Coarse stencils reach 2 planes on axis 0: the halo copies carry two
    planes (tests/test_pstructured.py:56-76)."""
    dims = (24, 24)
    A = _sp(j_poisson2d(*dims))
    mesh = ptt.make_row_mesh(8, device="cpu")
    h = ptt.structured_distributed_setup(A, _cfg(ptt), mesh, dims)
    A1 = h.levels[1].A
    assert A1.halo >= 2
    oh = oracle_setup(A, _cfg(ptt), dims=dims)
    tdims = oh.levels[0].cdims
    x = np.random.default_rng(4).normal(size=oh.levels[1].A.shape[0])
    g = np.zeros(A1.dims)
    g[tuple(slice(0, d) for d in tdims)] = x.reshape(tdims)
    xd = PGrid.from_global(torch.tensor(g, dtype=torch.float32), mesh)
    for mode in ("xla", "pallas_async"):
        y = ptt.collect_grid(A1.with_halo_mode(mode).matvec(xd), tdims)
        np.testing.assert_allclose(y, oh.levels[1].A @ x, rtol=2e-4, atol=2e-5)


def test_standalone_solve_takes_a_pgrid():
    """``solve`` cycles on a PGrid right-hand side and returns a PGrid."""
    A, h, _, mesh, _ = _setups()
    b = _rhs(A.shape[0], 5)
    x, hist, k = ptt.solve(h, ptt.distribute_grid(b, DIMS, h, mesh), tol=1e-6,
                           maxiter=40)
    assert isinstance(x, PGrid) and k < 40
    assert float(hist[k - 1]) <= 1e-6 * np.linalg.norm(b) * (1 + 1e-5)
    xr = ptt.collect_grid(x, DIMS).astype(np.float64)
    assert np.linalg.norm(b - A @ xr) <= 2e-6 * np.linalg.norm(b)
