"""The port's structured block-SA path (on-device setup, structured host
setup, with_spmv_backend, interop) against the JAX package.

Both packages get the same inputs.  The power iteration's start vector is
the port's own ``ops/prng.uniform`` draw, bit-equal to the JAX package's
``jax.random.uniform``, so whole setups are compared with no patch.
Tolerances:
- whole on-device setups (dense and bucketed products): every level's
  weights, D⁻¹, block scale and λ_max bit for bit;
- the JAX package's functions run eagerly (one XLA program per operation,
  so no fused multiply-add), and the bucketed product in 2-D and on a
  13 × 11 / 8 × 7 × 6 grid, whose fused multiply-adds LLVM forms otherwise
  (ROADMAP C7c): rtol 1e-4, atol 1e-5·max|w|;
- V-cycles: rtol 2e-5, atol 2e-6 (the JAX package's own backend-swap
  tolerance, tests/test_backend_swap.py);
- offset sets, product-path choices and PCG iteration counts: equal.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.amg.hierarchy import with_spmv_backend as j_with_spmv_backend
from parallel_amg_tpu.ops.flatdia import FlatDIA as JFlatDIA
from parallel_amg_tpu.ops.stencil import Stencil as JStencil
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_poisson_stencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.transfers import BlockProlongator, downsample_sum_nd
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.oracle.serial_amg import (
    block_aggregation,
    smoothed_prolongator,
    tentative_prolongator,
)
from parallel_amg_tpu_torch.problems import poisson3d, poisson_stencil

from float_bits import assert_bits

torch.set_num_threads(2)

W_RTOL, W_ATOL = 1e-4, 1e-5
V_RTOL, V_ATOL = 2e-5, 2e-6


def _cfg(mod, **kw):
    base = dict(coarsening="sa", aggregate="block", block_size=3,
                smoother="chebyshev", on_device_setup=True)
    return mod.AMGConfig(**{**base, **kw})


CASES = {
    "2d_24": ((24, 24), dict(n_coarse_max=16)),
    "3d_12": ((12, 12, 12), dict(n_coarse_max=64)),
    "3d_12_bucketed": ((12, 12, 12), dict(n_coarse_max=64,
                                           setup_product_path="bucketed")),
}


@functools.cache
def _setups(name):
    """(port hierarchy, JAX hierarchy) of the on-device setup."""
    dims, kw = CASES[name]
    h = ptt.setup(poisson_stencil(dims, device="cpu"), _cfg(ptt, **kw),
                  device="cpu")
    jh = pat.setup(j_poisson_stencil(dims), _cfg(pat, **kw))
    return h, jh


def _assert_close_weights(mine, theirs):
    w, jw = mine.numpy(), np.asarray(theirs)
    np.testing.assert_allclose(w, jw, rtol=W_RTOL, atol=W_ATOL * np.abs(jw).max())


def _vcycle_pair(h, jh, seed):
    n = h.levels[0].A.n_rows
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n).astype(np.float32)
    b = rng.normal(size=n).astype(np.float32)
    return (ptt.vcycle(h, torch.from_numpy(x), torch.from_numpy(b)).numpy(),
            np.asarray(pat.vcycle(jh, jnp.asarray(x), jnp.asarray(b))))


# -- setup stages ----------------------------------------------------------

@pytest.mark.parametrize("dims,block", [((18, 14), 2), ((10, 9, 8), 3)])
def test_galerkin_block_pinned_coef(dims, block):
    """With ω/λ pinned, S, Sᵀ, the stencil products and the pooled Galerkin
    reduction equal the JAX package's and the oracle's explicit Pᵀ A P."""
    coef = 0.71
    st, jst = poisson_stencil(dims, device="cpu"), j_poisson_stencil(dims)
    d_inv = 1.0 / st.diagonal()
    jd_inv = 1.0 / jst.diagonal()
    M = ds.smoothing_operator_T(st, d_inv, coef).matmul(
        st.matmul(ds.smoothing_operator(st, d_inv, coef)))
    jM = jds.smoothing_operator_T(jst, jd_inv, coef).matmul(
        jst.matmul(jds.smoothing_operator(jst, jd_inv, coef)))
    assert M.offsets == jM.offsets
    _assert_close_weights(M.weights, jM.weights)
    agg, cdims = block_aggregation(dims, block)
    counts = downsample_sum_nd(torch.ones(dims), cdims, block)
    scale = 1.0 / torch.sqrt(torch.clamp(counts, min=1.0))
    A_c = ds.galerkin_block(M, cdims, block, scale)
    jA_c = jds.galerkin_block(jM, cdims, block, jnp.asarray(scale.numpy()))
    assert A_c.offsets == jA_c.offsets == tuple(ds.galerkin_out_offsets(M.offsets, block))
    _assert_close_weights(A_c.weights, jA_c.weights)
    A_sp = st.to_csr().to_scipy()
    P = smoothed_prolongator(A_sp, tentative_prolongator(agg), omega=coef, lam_max=1.0)
    np.testing.assert_allclose(A_c.to_csr().to_dense(), (P.T @ A_sp @ P).toarray(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("dims", [(13, 11), (8, 7, 6)])
def test_bucketed_product_matches_jax_and_oracle(dims):
    """The bucketed (transfer-first) Galerkin product is exact: it matches
    the JAX package's and the oracle's Pᵀ A P with no sparsification."""
    b, coef = 3, 0.55
    st, jst = poisson_stencil(dims, device="cpu"), j_poisson_stencil(dims)
    d_inv = ds.diag_inverse(st)
    agg, cdims = block_aggregation(dims, b)
    scale = 1.0 / torch.sqrt(torch.clamp(
        downsample_sum_nd(torch.ones(dims), cdims, b), min=1.0))
    A_c = ds.bucketed_coarse_operator(st, d_inv, coef, cdims, b, scale)
    jA_c = jds.bucketed_coarse_operator(jst, jnp.asarray(d_inv.numpy()), coef,
                                        cdims, b, jnp.asarray(scale.numpy()))
    assert A_c.offsets == jA_c.offsets
    _assert_close_weights(A_c.weights, jA_c.weights)
    A_sp = st.to_csr().to_scipy()
    P = smoothed_prolongator(A_sp, tentative_prolongator(agg), omega=coef, lam_max=1.0)
    np.testing.assert_allclose(A_c.to_csr().to_dense(), (P.T @ A_sp @ P).toarray(),
                               rtol=2e-4, atol=2e-5)


def test_power_iteration_from_jax_start_vector():
    dims = (9, 8, 7)
    st, jst = poisson_stencil(dims, device="cpu"), j_poisson_stencil(dims)
    d_inv = ds.diag_inverse(st)
    lam = ds.power_iteration_lambda_max(st, d_inv, 15, seed=3)
    jlam = jds.power_iteration_lambda_max(jst, 1.0 / jst.diagonal(), 15, seed=3)
    assert lam.shape == () and lam.dtype == torch.float32
    assert float(lam) == float(jlam)
    # the port's start is JAX's, bit for bit, and in [−0.5, 0.5)
    v = ds.start_vector(dims, torch.float32, "cpu", seed=3)
    jv = jax.random.uniform(jax.random.PRNGKey(3), dims, jnp.float32) - 0.5
    assert torch.equal(v, torch.from_numpy(np.asarray(jv)))
    assert v.shape == dims and float(v.abs().max()) <= 0.5


def test_sparsify_symmetrize_prune_match_jax():
    rng = np.random.default_rng(4)
    st = poisson_stencil((9, 10), device="cpu")
    w = (st.weights.numpy() * rng.uniform(0.01, 2.0, size=st.weights.shape)).astype(np.float32)
    w[0] = 0.0  # one all-zero plane for the prune
    mine = Stencil(torch.from_numpy(w), st.offsets, st.dims)
    theirs = JStencil(jnp.asarray(w), st.offsets, st.dims)
    out = ds._prune_zero_planes(ds.symmetrize_stencil(ds.sparsify_stencil(mine, 0.3)))
    jout = jds._prune_zero_planes(jds.symmetrize_stencil(jds.sparsify_stencil(theirs, 0.3)))
    assert out.offsets == jout.offsets
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights),
                               rtol=1e-6, atol=1e-7)
    assert ds.sparsify_stencil(mine, 0.0) is mine


@pytest.mark.parametrize("dims,points", [((128, 128, 128), 7), ((43, 43, 43), 27),
                                         ((15, 15, 15), 27), ((256, 256, 256), 7),
                                         ((512, 512), 9)])
def test_product_path_choice_matches_jax(dims, points):
    """"auto" picks the same path as the JAX package; at 128³ (acceptance
    config #3) bucketed at level 0 and dense below."""
    offs = (sorted(set(tuple(c) for c in np.ndindex(*(3,) * len(dims))))
            if points == 3 ** len(dims) else
            sorted({tuple(0 for _ in dims)} | {
                tuple(s if i == a else 0 for i in range(len(dims)))
                for a in range(len(dims)) for s in (-1, 1)}))
    offs = [tuple(c - 1 for c in o) if points == 3 ** len(dims) else o for o in offs]
    n = int(np.prod(dims))
    mine = types.SimpleNamespace(weights=torch.zeros(1), offsets=offs, dims=dims, n=n)
    theirs = types.SimpleNamespace(weights=np.zeros(1, np.float32), offsets=offs,
                                   dims=dims, n=n)
    for kw in ({}, {"setup_chunk_budget_mb": 256}):
        assert ds.select_product_path(mine, _cfg(ptt, **kw)) == \
            jds.select_product_path(theirs, _cfg(pat, **kw))
    if dims == (128, 128, 128):
        assert ds.select_product_path(mine, _cfg(ptt)) == "bucketed"
    if dims == (43, 43, 43):
        assert ds.select_product_path(mine, _cfg(ptt)) == "dense"


# -- whole setups ----------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_device_setup_matches_jax(name):
    h, jh = _setups(name)
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert h.n_levels >= 2
    for l, jl in zip(h.levels, jh.levels):
        assert isinstance(l.A, Stencil) and l.A.offsets == jl.A.offsets
        assert_bits(l.A.weights, jl.A.weights)
        assert_bits(l.d_inv, jl.d_inv)
        assert l.lam_max == float(jl.lam_max)
        if l.P is not None:
            assert l.P.linked and l.R.linked
            assert (l.P.dims, l.P.cdims, l.P.block) == (jl.P.dims, jl.P.cdims, jl.P.block)
            np.testing.assert_allclose(l.P.coef, float(jl.P.coef), rtol=1e-5)
            # XLA's 1/sqrt (an rsqrt and a Newton step): ds.block_scale
            assert_bits(l.P.scale, jl.P.scale)
    np.testing.assert_allclose(h.coarse_inv.numpy(), np.asarray(jh.coarse_inv),
                               rtol=1e-3, atol=1e-5 * np.abs(np.asarray(jh.coarse_inv)).max())
    mine, theirs = _vcycle_pair(h, jh, 1)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)


@pytest.mark.parametrize("name", ["2d_24", "3d_12"])
def test_device_setup_pcg_iterations_match_jax(name):
    h, jh = _setups(name)
    n = h.levels[0].A.n_rows
    b = np.random.default_rng(2).normal(size=n).astype(np.float32)
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    assert res.x.shape == (n,)
    if len(h.grid_dims) == 3:
        A = poisson3d(*h.grid_dims).to_csr().to_scipy()
        x = res.x.double().numpy()
        assert np.linalg.norm(b - A @ x) <= 5e-6 * np.linalg.norm(b)


def test_structured_host_setup_matches_jax():
    dims = (12, 12, 12)
    A = poisson3d(*dims).to_csr()
    kw = dict(n_coarse_max=64, on_device_setup=False)
    h = ptt.setup(A, _cfg(ptt, **kw), device="cpu", dims=dims)
    jh = pat.setup(A.to_scipy(), _cfg(pat, **kw), dims=dims)
    assert [type(l.A).__name__ for l in h.levels] == [type(l.A).__name__ for l in jh.levels]
    for l, jl in zip(h.levels, jh.levels):
        assert l.A.offsets == jl.A.offsets
        np.testing.assert_array_equal(l.A.weights.numpy(), np.asarray(jl.A.weights))
        np.testing.assert_array_equal(l.d_inv.numpy(), np.asarray(jl.d_inv))
        assert l.lam_max == float(jl.lam_max)
        if l.P is not None:
            assert isinstance(l.P, BlockProlongator) and l.P.linked
            assert l.P.coef == float(jl.P.coef)
            np.testing.assert_array_equal(l.R.scale.numpy(), np.asarray(jl.R.scale))
    np.testing.assert_array_equal(h.coarse_inv.numpy(), np.asarray(jh.coarse_inv))
    mine, theirs = _vcycle_pair(h, jh, 3)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)


# -- backends and interop --------------------------------------------------

def test_with_spmv_backend_round_trip():
    h, jh = _setups("2d_24")
    mixed = ptt.with_spmv_backend(h, "mixed")
    assert [type(l.A).__name__ for l in mixed.levels] == [
        "FlatDIA" if l.A.n_points >= 9 else "Stencil" for l in h.levels]
    hp = ptt.with_spmv_backend(h, "pallas")
    assert all(isinstance(l.A, FlatDIA) for l in hp.levels)
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.normal(size=h.grid_dims or (h.levels[0].A.n,)).astype(np.float32))
    x0 = torch.zeros_like(b)
    y = ptt.vcycle(h, x0, b).numpy()
    for hh in (mixed, hp):
        np.testing.assert_allclose(ptt.vcycle(hh, x0, b).numpy(), y,
                                   rtol=V_RTOL, atol=V_ATOL)
    jy = np.asarray(pat.vcycle(j_with_spmv_backend(jh, "pallas"), jnp.asarray(x0.numpy()),
                               jnp.asarray(b.numpy())))
    np.testing.assert_allclose(ptt.vcycle(hp, x0, b).numpy(), jy, rtol=V_RTOL, atol=V_ATOL)
    hx = ptt.with_spmv_backend(hp, "xla")
    for la, lb in zip(h.levels, hx.levels):
        assert isinstance(lb.A, Stencil) and la.A.offsets == lb.A.offsets
        np.testing.assert_array_equal(la.A.weights.numpy(), lb.A.weights.numpy())
    with pytest.raises(ValueError):
        ptt.with_spmv_backend(h, "triton")


def _jax_operator_arrays(op):
    if op is None:
        return None
    if isinstance(op, JStencil):
        return {"format": "Stencil", "weights": np.asarray(op.weights),
                "offsets": op.offsets, "dims": op.dims}
    if isinstance(op, JFlatDIA):
        return {"format": "FlatDIA", "diags": np.asarray(op.diags), "offsets": op.offsets,
                "n": op.n, "dims": op.dims, "nd_offsets": op.nd_offsets}
    return {"format": type(op).__name__, "scale": np.asarray(op.scale),
            "coef": np.asarray(op.coef), "dims": op.dims, "cdims": op.cdims,
            "block": op.block}


def test_interop_carries_jax_structured_hierarchy():
    _, jh = _setups("3d_12")
    jh = j_with_spmv_backend(jh, "pallas")  # FlatDIA levels, tile-padded
    levels = [{"A": _jax_operator_arrays(l.A), "P": _jax_operator_arrays(l.P),
               "R": _jax_operator_arrays(l.R), "d_inv": np.asarray(l.d_inv),
               "lam_max": np.asarray(l.lam_max)} for l in jh.levels]
    carried = interop.hierarchy_from_numpy(
        levels, np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), device="cpu")
    assert all(isinstance(l.A, FlatDIA) for l in carried.levels)
    assert carried.levels[0].P.linked and carried.grid_dims == (12, 12, 12)
    mine, theirs = _vcycle_pair(carried, jh, 6)
    np.testing.assert_allclose(mine, theirs, rtol=V_RTOL, atol=V_ATOL)
