"""The port's vector (BSR) path against the JAX package: the coupled vector
Laplacian L ⊗ C, BSR and BlockStencil operators, the vector block transfers,
``setup_vector_kron`` for the three fine formats, and interop.

Both packages get the same numpy inputs, made from a seed.  The power
iteration's start vector is the port's own ``ops/prng.uniform`` draw,
bit-equal to the JAX package's ``jax.random.uniform``, so whole setups are
compared with no patch.  On the
CPU the port runs kernels B6 and B7 as their plain versions; the JAX BTWELL
runs its Pallas kernel in interpret mode.  Tolerances:
- operator products: rtol 2e-5, atol 1e-5 (tests/test_vector_bsr.py:39);
- coarse weights, D⁻¹ and λ_max: bit for bit (the scalar setup's Galerkin
  products and power iterations add in XLA's CPU order); ω/λ: rtol 1e-5;
- V-cycles: rtol 2e-5, atol 2e-6 (tests/test_backend_swap.py);
- layouts, offsets, level sizes and PCG iteration counts: equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg.vector import setup_vector_kron as j_setup_vector_kron
from parallel_amg_tpu.ops.bsr import BSR as JBSR
from parallel_amg_tpu.ops.bstencil import (
    BlockStencil as JBlockStencil,
    VectorBlockProlongator as JVectorBlockProlongator,
    VectorBlockRestrictor as JVectorBlockRestrictor,
    bsr_from_kron_stencil as j_bsr_from_kron_stencil,
)
from parallel_amg_tpu.ops.stencil import Stencil as JStencil
from parallel_amg_tpu.problems.elasticity import coupled_laplacian as j_coupled_laplacian

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
from parallel_amg_tpu_torch.ops.bstencil import (
    BlockStencil,
    BSRGridOperator,
    VectorBlockProlongator,
    VectorBlockRestrictor,
    bsr_from_kron_stencil,
)
from parallel_amg_tpu_torch.ops.btwell import BTWELL
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.problems import (
    coupled_laplacian,
    coupled_laplacian_scipy,
    poisson_stencil,
)

from float_bits import assert_bits

torch.set_num_threads(2)

P_RTOL, P_ATOL = 2e-5, 1e-5
W_RTOL, W_ATOL = 1e-4, 1e-5
V_RTOL, V_ATOL = 2e-5, 2e-6


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=48,
                         on_device_setup=True)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- operators -----------------------------------------------------------------

def test_bsr_kron_matvec_diagonal_match_jax_and_scipy():
    dims, bs, gamma = (7, 6, 5), 3, 0.3
    L, C = coupled_laplacian(dims, bs, gamma, device="cpu")
    jL, _ = j_coupled_laplacian(dims, bs, gamma)
    A_sp = coupled_laplacian_scipy(dims, bs, gamma)
    bsr = bsr_from_kron_stencil(L, C)
    jb = j_bsr_from_kron_stencil(jL, C)
    np.testing.assert_array_equal(bsr.bcols.numpy(), np.asarray(jb.bcols).T)
    np.testing.assert_array_equal(bsr.vals.numpy(),
                                  np.stack([np.asarray(v) for v in jb.vals]))
    assert bsr.nnz == int(jb.nnz) == A_sp.nnz
    x = _x(A_sp.shape[1], 1)
    y = bsr.matvec(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y, A_sp @ x, rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(y, np.asarray(jb.matvec(jnp.asarray(x))),
                               rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(bsr.diagonal().numpy(), A_sp.diagonal(), rtol=1e-6)
    op = BSRGridOperator(bsr, dims)
    assert op.dims == dims + (bs,) and op.n_rows == A_sp.shape[0]
    np.testing.assert_array_equal(op.matvec(torch.from_numpy(x).reshape(op.dims)).numpy(),
                                  y.reshape(op.dims))


def test_blockstencil_matvec_diagonal_match_jax_and_scipy():
    dims, bs, gamma = (6, 9), 3, 0.4
    L, C = coupled_laplacian(dims, bs, gamma, device="cpu")
    jL, _ = j_coupled_laplacian(dims, bs, gamma)
    A_sp = coupled_laplacian_scipy(dims, bs, gamma)
    B = BlockStencil(L.weights, L.offsets, L.dims, torch.tensor(C, dtype=torch.float32))
    jB = JBlockStencil(jL.weights, jL.offsets, jL.dims, jnp.asarray(C, jnp.float32))
    assert B.dims == dims + (bs,) and B.nnz == int(jB.nnz)
    x = _x(A_sp.shape[1], 2)
    y = B.matvec(torch.from_numpy(x).reshape(B.dims)).numpy()
    np.testing.assert_allclose(y.reshape(-1), A_sp @ x, rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(y, np.asarray(jB.matvec(jnp.asarray(x).reshape(B.dims))),
                               rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(B.diagonal().numpy().reshape(-1), A_sp.diagonal(),
                               rtol=1e-6)
    d = abs(B.to_csr().to_scipy() - A_sp)
    assert (d.max() if d.nnz else 0.0) < 1e-6


@pytest.mark.parametrize("linked", [False, True], ids=["own_L", "linked"])
@pytest.mark.parametrize("dims", [(12, 12), (9, 9, 9)])
def test_vector_transfers_match_jax(dims, linked):
    bs, block, coef = 3, 3, 0.57
    st = poisson_stencil(dims, device="cpu")
    w = (st.weights.numpy() * np.random.default_rng(3).uniform(
        0.5, 2.0, size=st.weights.shape)).astype(np.float32)
    L, jL = Stencil(torch.from_numpy(w), st.offsets, dims), JStencil(jnp.asarray(w), st.offsets, dims)
    cdims = tuple(-(-d // block) for d in dims)
    scale = 1.0 / torch.sqrt(downsample_sum_nd(torch.ones(dims), cdims, block))
    jscale = jnp.asarray(scale.numpy())
    C = np.eye(bs)
    if linked:
        A = BlockStencil(L.weights, L.offsets, dims, torch.tensor(C, dtype=torch.float32))
        jA = JBlockStencil(jL.weights, jL.offsets, dims, jnp.asarray(C, jnp.float32))
        own, jown = (None, None), (None, None)
    else:
        A = jA = None
        dL = L.diagonal()
        own, jown = (L, 1.0 / dL), (jL, jnp.asarray(1.0 / dL.numpy()))
    args = (scale, coef, dims, cdims, block, bs)
    jargs = (jscale, coef, dims, cdims, block, bs)
    P, R = VectorBlockProlongator(*own, *args), VectorBlockRestrictor(*own, *args)
    jP, jR = JVectorBlockProlongator(*jown, *jargs), JVectorBlockRestrictor(*jown, *jargs)
    assert P.linked == linked and P.shape == jP.shape and R.shape == jR.shape
    xc, r = _x(cdims + (bs,), 4), _x(dims + (bs,), 5)
    p = P.matvec_linked(A, None, torch.from_numpy(xc)).numpy()
    jp = jP.matvec_linked(jA, None, jnp.asarray(xc))
    q = R.matvec_linked(A, None, torch.from_numpy(r)).numpy()
    jq = jR.matvec_linked(jA, None, jnp.asarray(r))
    np.testing.assert_allclose(p, np.asarray(jp), rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_allclose(q, np.asarray(jq), rtol=P_RTOL, atol=P_ATOL)
    zc = P.zeros_coarse(torch.float32)
    assert zc.shape == cdims + (bs,) and not bool(zc.any())


# -- setup_vector_kron ---------------------------------------------------------

CASES = {"2d_12": (12, 12), "3d_15": (15, 15, 15)}
FORMATS = ["bsr", "btwell", "bstencil"]
# The JAX BTWELL runs in interpret mode, whose compile costs ~28 s at 15³:
# there the port's "btwell" is held to its own "bsr" and to JAX's "bsr"
# (test_btwell_15_matches_bsr).
PAIRS = [(c, f) for c in sorted(CASES) for f in FORMATS
         if (c, f) != ("3d_15", "btwell")]


@functools.cache
def _setups(case, fmt):
    """(port hierarchy, JAX hierarchy) of setup_vector_kron."""
    dims = CASES[case]
    jL, jC = j_coupled_laplacian(dims, 3, 0.3)
    return (_port_setup(dims, fmt),
            j_setup_vector_kron(jL, jC, _cfg(pat), fine_format=fmt))


def _assert_close_w(mine, theirs):
    w, jw = np.asarray(mine), np.asarray(theirs)
    np.testing.assert_allclose(w, jw, rtol=W_RTOL, atol=W_ATOL * np.abs(jw).max())


def _vcycle_pair(h, jh, seed):
    n = h.levels[0].A.n_rows
    x, b = _x(n, seed), _x(n, seed + 1)
    return (ptt.vcycle(h, torch.from_numpy(x), torch.from_numpy(b)).numpy(),
            np.asarray(pat.vcycle(jh, jnp.asarray(x), jnp.asarray(b))))


@pytest.mark.parametrize("case,fmt", PAIRS)
def test_setup_vector_kron_matches_jax(case, fmt):
    h, jh = _setups(case, fmt)
    assert [l.n for l in h.levels] == [l.n for l in jh.levels]
    assert h.grid_dims == jh.grid_dims == CASES[case] + (3,)
    for i, (l, jl) in enumerate(zip(h.levels, jh.levels)):
        assert type(l.A).__name__ == type(jl.A).__name__
        if isinstance(l.A, BlockStencil):
            assert l.A.offsets == jl.A.offsets
            assert_bits(l.A.weights, jl.A.weights)
            np.testing.assert_array_equal(l.A.C.numpy(), np.asarray(jl.A.C))
        elif fmt == "bsr":
            np.testing.assert_array_equal(l.A.bsr.bcols.numpy(), np.asarray(jl.A.bsr.bcols).T)
            np.testing.assert_array_equal(l.A.bsr.vals.numpy(),
                                          np.stack([np.asarray(v) for v in jl.A.bsr.vals]))
        else:
            assert isinstance(l.A.bsr, BTWELL)
            d = abs(l.A.to_csr().to_scipy() - jl.A.bsr.to_bsr().to_csr().to_scipy())
            assert (d.max() if d.nnz else 0.0) < 1e-6
        assert_bits(l.d_inv, jl.d_inv)
        assert l.lam_max == float(jl.lam_max)
        if l.P is None:
            continue
        for T, jT in ((l.P, jl.P), (l.R, jl.R)):
            assert T.linked == jT.linked == (i > 0 or fmt == "bstencil")
            assert (T.node_dims, T.cdims, T.block, T.bs) == (jT.node_dims, jT.cdims, jT.block, jT.bs)
            np.testing.assert_allclose(T.coef, float(jT.coef), rtol=1e-5)
            np.testing.assert_allclose(T.scale.numpy(), np.asarray(jT.scale), rtol=2e-7)
            if not T.linked:
                np.testing.assert_array_equal(T.L.weights.numpy(), np.asarray(jT.L.weights))
                _assert_close_w(T.d_inv_L.numpy(), jT.d_inv_L)
    inv, jinv = h.coarse_inv.numpy(), np.asarray(jh.coarse_inv)
    np.testing.assert_allclose(inv, jinv, rtol=1e-3, atol=1e-5 * np.abs(jinv).max())
    mine, theirs = _vcycle_pair(h, jh, 6)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)
    gc, oc = h.complexity()
    jgc, joc = jh.complexity()
    assert gc == jgc and oc == joc


@pytest.mark.parametrize("case,fmt", PAIRS)
def test_vector_pcg_iterations_match_jax(case, fmt):
    h, jh = _setups(case, fmt)
    n = h.levels[0].A.n_rows
    b = _x(n, 7)
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    A = coupled_laplacian_scipy(CASES[case], 3, 0.3)
    x = res.x.double().numpy()
    assert res.x.shape == (n,)
    assert np.linalg.norm(b - A @ x) <= 5e-6 * np.linalg.norm(b)


def _port_setup(dims, fmt):
    L, C = coupled_laplacian(dims, 3, 0.3, device="cpu")
    return ptt.setup_vector_kron(L, C, _cfg(ptt), fine_format=fmt)


def test_btwell_15_matches_bsr():
    """At 15³ the port's "btwell" hierarchy is its "bsr" hierarchy with the
    zero blocks dropped: the same operators and transfers, and JAX's "bsr"
    PCG count."""
    h, jh = _setups("3d_15", "bsr")
    ht = _port_setup(CASES["3d_15"], "btwell")
    assert isinstance(ht.levels[0].A.bsr, BTWELL)
    d = abs(ht.levels[0].A.to_csr().to_scipy() - h.levels[0].A.to_csr().to_scipy())
    assert (d.max() if d.nnz else 0.0) == 0.0
    assert ht.levels[0].A.nnz == h.levels[0].A.nnz
    for lt, l in zip(ht.levels[1:], h.levels[1:]):
        np.testing.assert_array_equal(lt.A.weights.numpy(), l.A.weights.numpy())
    b = _x(h.levels[0].A.n_rows, 7)
    res = ptt.amg_pcg(None, ht, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    assert res.converged and res.iters == int(jres.iters)


def test_bsr_and_bstencil_give_the_same_iterations():
    """The two fine formats store one operator: equal PCG counts
    (tests/test_vector_bsr.py:135-147)."""
    iters = []
    for fmt in ("bsr", "bstencil"):
        h, _ = _setups("2d_12", fmt)
        b = _x(h.levels[0].A.n_rows, 8)
        iters.append(ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=60).iters)
    assert iters[0] == iters[1]


# -- interop -------------------------------------------------------------------

def _jax_arrays(op):
    if op is None:
        return None
    name = type(op).__name__
    if name == "BSRGridOperator":
        b = op.bsr
        return {"format": "BSR", "bcols": np.asarray(b.bcols),
                "vals": np.stack([np.asarray(v) for v in b.vals]),
                "brow_nnz": np.asarray(b.brow_nnz), "shape": b.shape, "bs": b.bs,
                "node_dims": op.node_dims}
    if name == "BlockStencil":
        return {"format": name, "weights": np.asarray(op.weights),
                "offsets": op.offsets, "dims": op.node_dims, "C": np.asarray(op.C)}
    if name == "Stencil":
        return {"format": name, "weights": np.asarray(op.weights),
                "offsets": op.offsets, "dims": op.dims}
    return {"format": name, "L": _jax_arrays(op.L),
            "d_inv_L": None if op.d_inv_L is None else np.asarray(op.d_inv_L),
            "scale": np.asarray(op.scale), "coef": np.asarray(op.coef),
            "dims": op.node_dims, "cdims": op.cdims, "block": op.block, "bs": op.bs}


def test_interop_carries_jax_vector_hierarchy():
    _, jh = _setups("2d_12", "bsr")
    levels = [{"A": _jax_arrays(l.A), "P": _jax_arrays(l.P), "R": _jax_arrays(l.R),
               "d_inv": np.asarray(l.d_inv), "lam_max": np.asarray(l.lam_max)}
              for l in jh.levels]
    carried = interop.hierarchy_from_numpy(
        levels, np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), device="cpu")
    assert isinstance(carried.levels[0].A, BSRGridOperator)
    assert not carried.levels[0].P.linked and carried.grid_dims == (12, 12, 3)
    assert all(isinstance(l.A, BlockStencil) for l in carried.levels[1:])
    mine, theirs = _vcycle_pair(carried, jh, 9)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)

