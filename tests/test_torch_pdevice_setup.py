"""The port's on-device distributed structured setup (parallel/pdevice_setup.py)
against the JAX package's on its CPU mesh.

Both packages get the same inputs.  The power iteration's start vector is
the port's own ``ops/prng.uniform`` draw over the padded global dims,
bit-equal to the JAX package's ``jax.random.uniform``, so whole setups are
compared with no patch.
Tolerances:
- problem planes, level plans and halo schedules: equal;
- level operators, the slab kernel with a padding mask and λ_max: bit for
  bit (the port adds in XLA's CPU order; at this size the split level's
  power iteration gives the JAX package's λ too, ROADMAP C7a lists where it
  does not);
- V-cycles of a carried hierarchy: rtol 2e-5, atol 2e-6 (the backend-swap
  tolerance of tests/test_backend_swap.py);
- 1 part against 4 parts after one V-cycle: rtol 2e-4, atol 2e-6
  (tests/test_pdevice_setup.py:134);
- PCG iteration counts: equal.
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
from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pdevice_setup as jpd
from parallel_amg_tpu.parallel.pstencil import ShardedStencil as JShardedStencil
from parallel_amg_tpu.parallel.pstructured import (
    collect_grid as j_collect_grid,
    distribute_grid as j_distribute_grid,
)

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import anisotropic2d, poisson3d, poisson_stencil

from float_bits import assert_bits

torch.set_num_threads(2)

V_RTOL, V_ATOL = 2e-5, 2e-6
DIMS = (24, 12, 10)


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=64, agglomerate_n=256,
                         on_device_setup=True)


def _rhs(seed=0):
    return np.random.default_rng(seed).normal(size=int(np.prod(DIMS)))


@functools.cache
def _setups():
    """(port hierarchy on 4 CPU parts, JAX hierarchy on 4 devices, their
    meshes) of the on-device distributed setup at DIMS."""
    mesh = ptt.make_row_mesh(4, device="cpu")
    A, td = ptt.poisson_stencil_sharded(DIMS, mesh, _cfg(ptt))
    h = ptt.sharded_device_setup(A, _cfg(ptt), true_dims=td)
    jmesh = j_make_row_mesh(4)
    jA, jtd = jpd.poisson_stencil_sharded(DIMS, jmesh, _cfg(pat))
    jh = jpd.sharded_device_setup(jA, _cfg(pat), true_dims=jtd)
    return h, jh, mesh, jmesh


def _level_weights(A):
    """Global (D, d0, *rest) weights of a port level operator."""
    return (A.global_weights() if isinstance(A, ShardedStencil) else A.weights).numpy()


@pytest.mark.parametrize("kind,dims", [("poisson", (24, 10, 9)), ("aniso", (48, 20))])
def test_sharded_problem_planes_equal_jax(kind, dims):
    mesh, jmesh = ptt.make_row_mesh(4, device="cpu"), j_make_row_mesh(4)
    if kind == "poisson":
        A, td = ptt.poisson_stencil_sharded(dims, mesh, _cfg(ptt))
        jA, jtd = jpd.poisson_stencil_sharded(dims, jmesh, _cfg(pat))
    else:
        A, td = ptt.anisotropic_stencil_sharded(dims, mesh, _cfg(ptt), epsilon=1e-3)
        jA, jtd = jpd.anisotropic_stencil_sharded(dims, jmesh, _cfg(pat), epsilon=1e-3)
    assert td == jtd and A.dims == jA.dims and A.offsets == jA.offsets
    np.testing.assert_array_equal(A.global_weights().numpy(), np.asarray(jA.weights))
    # and on the true grid it is the host problem
    ref = poisson3d(*dims) if kind == "poisson" else anisotropic2d(*dims, epsilon=1e-3)
    st = ptt.Stencil(A.global_weights()[:, :dims[0]], A.offsets, dims)
    np.testing.assert_allclose(st.to_csr().to_dense(),
                               ref.to_csr().to_scipy().toarray(), atol=1e-6)


@pytest.mark.parametrize("dims,S", [((468,) * 3, 8), ((128,) * 3, 4), ((20, 7, 6), 4),
                                    ((48, 20), 4)])
def test_plan_sharded_levels_equals_jax(dims, S):
    cfg3 = dict(coarsening="sa", aggregate="block", block_size=3, smoother="chebyshev",
                n_coarse_max=512, on_device_setup=True)
    for kw in (cfg3, dict(cfg3, n_coarse_max=64, agglomerate_n=256)):
        assert (pd.plan_sharded_levels(dims, ptt.AMGConfig(**kw), S)
                == jpd.plan_sharded_levels(dims, pat.AMGConfig(**kw), S))
    for b in (2, 3):
        assert pd.setup_halo_schedule(5, b) == jpd.setup_halo_schedule(5, b)


def test_plan_of_the_two_chip_cells():
    cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                        smoother="chebyshev", n_coarse_max=512, on_device_setup=True)
    assert pd.plan_sharded_levels((128,) * 3, cfg, 4) == (2, 144)
    assert pd.plan_sharded_levels((468,) * 3, cfg, 8) == (2, 504)


def test_slab_kernel_mask_matches_jax():
    """``_slab_coarse_operator`` with a padding mask, both packages."""
    rng = np.random.default_rng(3)
    st = poisson_stencil((6, 5, 4), device="cpu")
    halo, b, cc = 6, 3, 2
    dims_slab = (cc * b + 2 * halo, 5, 4)
    W = (st.weights.numpy()[:, :1].repeat(dims_slab[0], axis=1)
         * rng.uniform(0.5, 1.5, size=(7,) + dims_slab)).astype(np.float32)
    W[st.offsets.index((0, 0, 0))] = 6.0
    d = (1.0 / W[st.offsets.index((0, 0, 0))]).astype(np.float32)
    scale = rng.uniform(0.2, 0.5, size=(cc + 2, 2, 2)).astype(np.float32)
    mask = (np.arange(dims_slab[0]) < 10).astype(np.float32).reshape(-1, 1, 1)
    kw = dict(offsets=st.offsets, dims_slab=dims_slab, cdims_slab=(cc, 2, 2), block=b,
              halo=halo, rc=1, it=5e-3)
    coef = np.float32(0.6)
    mine = ds._slab_coarse_operator(torch.from_numpy(W), torch.from_numpy(d),
                                    torch.from_numpy(scale), torch.tensor(coef), 0,
                                    mask=torch.from_numpy(mask), **kw)
    theirs = jds._jit_slab(jnp.asarray(W), jnp.asarray(d), jnp.asarray(scale),
                           jnp.asarray(coef), jnp.asarray(0, jnp.int32),
                           mask=jnp.asarray(mask), **kw)
    theirs = np.asarray(theirs)
    assert mine.weights.shape == theirs.shape
    assert_bits(mine.weights, theirs)
    unmasked = ds._slab_coarse_operator(torch.from_numpy(W), torch.from_numpy(d),
                                        torch.from_numpy(scale), torch.tensor(coef), 0,
                                        **kw)
    assert not torch.equal(unmasked.weights, mine.weights)


def test_sharded_setup_operators_match_jax():
    h, jh, _, _ = _setups()
    assert h.n_levels == jh.n_levels == 3
    assert h.setup_stats["sharded_levels"] == 1
    assert [l.n for l in h.levels] == [l.n for l in jh.levels] == [2880, 128, 12]
    for i, (l, jl) in enumerate(zip(h.levels, jh.levels)):
        assert type(l.A).__name__ == type(jl.A).__name__
        assert l.A.offsets == jl.A.offsets and l.A.dims == jl.A.dims, f"level {i}"
        assert_bits(_level_weights(l.A), jl.A.weights, f"level {i} operator:")
        assert l.lam_max == float(jl.lam_max), f"level {i} λ_max"
    P, jP = h.levels[0].P, jh.levels[0].P
    assert type(P).__name__ == type(jP).__name__ == "SBoundaryProlongator"
    assert P.true_cdims == jP.true_cdims and P.inner.true_d0 == jP.inner.true_d0 == 24
    np.testing.assert_allclose(P.inner.scale.to_global().numpy(),
                               np.asarray(jP.inner.scale), rtol=1e-6)
    np.testing.assert_allclose(h.complexity(), jh.complexity(), rtol=1e-6)


@functools.cache
def _jax_pcg():
    _, jh, _, jmesh = _setups()
    b = _rhs()
    res = pat.amg_pcg(jh.levels[0].A, jh, j_distribute_grid(b, DIMS, jh, jmesh),
                      tol=1e-8, maxiter=60)
    return int(res.iters), j_collect_grid(res.x, DIMS)


def test_sharded_setup_pcg_iterations_equal_jax():
    h, _, mesh, _ = _setups()
    b = _rhs()
    res = ptt.amg_pcg(None, h, ptt.distribute_grid(b, DIMS, h, mesh), tol=1e-8,
                      maxiter=60)
    assert res.converged and isinstance(res.x, ptt.PGrid)
    j_iters, j_x = _jax_pcg()
    assert res.iters == j_iters
    x = ptt.collect_grid(res.x, DIMS).astype(np.float64)
    A_sp = poisson3d(*DIMS).to_csr().to_scipy()
    assert np.linalg.norm(b - A_sp @ x) / np.linalg.norm(b) < 1e-6
    np.testing.assert_allclose(x, j_x, rtol=1e-3, atol=1e-5)


def _jax_level_arrays(l):
    def op(T):
        if T is None:
            return None
        name = type(T).__name__
        if name == "ShardedStencil":
            return {"format": name, "weights": np.asarray(T.weights),
                    "offsets": T.offsets, "dims": T.dims, "halo_mode": T.halo_mode}
        if name == "Stencil":
            return {"format": name, "weights": np.asarray(T.weights),
                    "offsets": T.offsets, "dims": T.dims}
        if name.startswith("SBoundary"):
            return {"format": name, "inner": op(T.inner), "true_cdims": T.true_cdims}
        if name.startswith("SBlock"):
            return {"format": name, "scale": np.asarray(T.scale),
                    "coef": np.asarray(T.coef), "dims": T.dims, "cdims": T.cdims,
                    "block": T.block, "true_d0": T.true_d0}
        return {"format": name, "scale": np.asarray(T.scale), "coef": np.asarray(T.coef),
                "dims": T.dims, "cdims": T.cdims, "block": T.block}

    return {"A": op(l.A), "P": op(l.P), "R": op(l.R), "d_inv": np.asarray(l.d_inv),
            "lam_max": np.asarray(l.lam_max), "true_n": l.true_n}


def test_interop_carries_jax_sharded_device_hierarchy():
    _, jh, mesh, jmesh = _setups()
    carried = interop.hierarchy_from_numpy(
        [_jax_level_arrays(l) for l in jh.levels], np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), mesh=mesh)
    assert isinstance(carried.levels[0].A, ShardedStencil)
    assert carried.levels[0].P.linked and carried.levels[0].true_n == 2880
    rng = np.random.default_rng(7)
    b = rng.normal(size=int(np.prod(DIMS)))
    bd = ptt.distribute_grid(b, DIMS, carried, mesh)
    mine = ptt.collect_grid(ptt.vcycle(carried, bd.zeros_like(), bd), DIMS)
    jbd = j_distribute_grid(b, DIMS, jh, jmesh)
    theirs = j_collect_grid(jax.jit(pat.vcycle)(jh, jnp.zeros_like(jbd), jbd), DIMS)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)


def test_one_part_and_four_parts_agree_after_one_vcycle():
    dims = (24, 8, 8)
    b = np.random.default_rng(8).normal(size=int(np.prod(dims)))
    outs = []
    for S in (1, 4):
        mesh = ptt.make_row_mesh(S, device="cpu")
        A, td = ptt.poisson_stencil_sharded(dims, mesh, _cfg(ptt))
        h = ptt.sharded_device_setup(A, _cfg(ptt), true_dims=td)
        bd = ptt.distribute_grid(b, dims, h, mesh)
        outs.append(ptt.collect_grid(ptt.vcycle(h, bd.zeros_like(), bd), dims))
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-6)


def test_sharded_setup_from_a_stencil_and_halo_modes():
    """A host Stencil padded and split here gives the device-born setup's
    hierarchy; both halo modes give the same PCG."""
    mesh = ptt.make_row_mesh(4, device="cpu")
    dims = (20, 7, 6)
    A, td = ptt.poisson_stencil_sharded(dims, mesh, _cfg(ptt))
    h1 = ptt.sharded_device_setup(A, _cfg(ptt), true_dims=td)
    h2 = ptt.sharded_device_setup(poisson_stencil(dims, device="cpu"),
                                  _cfg(ptt), mesh=mesh)
    for l1, l2 in zip(h1.levels, h2.levels):
        np.testing.assert_array_equal(_level_weights(l1.A), _level_weights(l2.A))
    b = np.random.default_rng(9).normal(size=int(np.prod(dims)))
    iters = []
    for mode in ("xla", "pallas_async"):
        h = ptt.sharded_device_setup(A, dataclasses.replace(_cfg(ptt), halo_mode=mode),
                                     true_dims=td)
        assert h.levels[0].A.halo_mode == mode
        res = ptt.amg_pcg(None, h, ptt.distribute_grid(b, dims, h, mesh), tol=1e-8,
                          maxiter=60)
        assert res.converged
        iters.append(res.iters)
    assert iters[0] == iters[1]
    with pytest.raises(ValueError):
        ptt.sharded_device_setup(A, _cfg(ptt))  # true_dims missing


def test_sharded_anisotropic_converges():
    dims = (48, 20)
    mesh = ptt.make_row_mesh(4, device="cpu")
    A, td = ptt.anisotropic_stencil_sharded(dims, mesh, _cfg(ptt), epsilon=1e-3)
    h = ptt.sharded_device_setup(A, _cfg(ptt), true_dims=td)
    A_sp = anisotropic2d(*dims, epsilon=1e-3).to_csr().to_scipy()
    b = np.random.default_rng(10).normal(size=A_sp.shape[0])
    res = ptt.amg_pcg(None, h, ptt.distribute_grid(b, dims, h, mesh), tol=1e-8,
                      maxiter=80)
    assert res.converged
    x = ptt.collect_grid(res.x, dims).astype(np.float64)
    # ε=1e-3: the float32 recurrence bottoms out near 1e-5 true residual
    assert np.linalg.norm(b - A_sp @ x) / np.linalg.norm(b) < 1e-4
