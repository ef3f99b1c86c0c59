"""The slab Galerkin product (``setup_product_path="slab"``) against the JAX
package's and against the port's own dense product.

The slab path computes the dense path's triple product Tᵀ Sᵀ A S T in axis-0
slabs with halos, so per level it must agree with the dense product to
float32 rounding (the dense path prunes all-zero planes of its intermediates
and the slab path does not, which adds exact zeros only) and with the JAX
package's slab product.  Against the JAX package: coarse weights bit for
bit (the port adds in XLA's CPU order, as tests/test_torch_structured.py
holds the dense path); against the port's dense product (another function,
in the JAX package too): rtol 1e-4, atol 1e-5·max|w|; offsets, slab sizes
and PCG iteration counts equal.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.ops.stencil import Stencil as JStencil
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_poisson_stencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.problems import poisson_stencil

from float_bits import assert_bits

torch.set_num_threads(2)

W_RTOL, W_ATOL = 1e-4, 1e-5
SEVEN = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))


def _cfg(mod, **kw):
    base = dict(coarsening="sa", aggregate="block", block_size=3,
                smoother="chebyshev", n_coarse_max=32, on_device_setup=True)
    return mod.AMGConfig(**{**base, **kw})


def _assert_close(mine, theirs):
    w, jw = np.asarray(mine), np.asarray(theirs)
    np.testing.assert_allclose(w, jw, rtol=W_RTOL, atol=W_ATOL * np.abs(jw).max())


def _planes_by_offset(st):
    return {o: st.weights[d].numpy() for d, o in enumerate(st.offsets)}


def _level_inputs(dims, b=3):
    """A variable-coefficient 7-point level, its D⁻¹, ω/λ and scale, in both
    packages from the same numpy planes."""
    rng = np.random.default_rng(7)
    st = poisson_stencil(dims, device="cpu")
    w = (st.weights.numpy() * rng.uniform(0.8, 1.25, size=st.weights.shape)).astype(np.float32)
    w[st.offsets.index((0, 0, 0))] = 7.0
    st = Stencil(torch.from_numpy(w), st.offsets, dims)
    jst = JStencil(jnp.asarray(w), st.offsets, dims)
    d_inv = ds.diag_inverse(st)
    cdims = tuple(-(-d // b) for d in dims)
    scale = 1.0 / torch.sqrt(torch.clamp(
        downsample_sum_nd(torch.ones(dims), cdims, b), min=1.0))
    coef = torch.tensor(0.61, dtype=torch.float32)
    return st, jst, d_inv, coef, cdims, scale


def test_slab_plan_at_config5_and_small():
    """The slab sizes: config #5's level 0 (324³) and the 24³ case below."""
    plan = ds.slab_plan(SEVEN, (324,) * 3, (108,) * 3, 3, 2048 * 2**20)
    assert plan == {"halo": 6, "rc": 1, "cc": 23, "n_slabs": 5, "planes": 63,
                    "slab_rows": 81}
    small = ds.slab_plan(SEVEN, (24,) * 3, (8,) * 3, 3, 22 * 24 * 24 * 4 * 63)
    assert (small["cc"], small["n_slabs"]) == (3, 3)  # a padded tail slab
    # "auto" picks the slab path at 324³, as the JAX package does
    for mod, sel, w in ((ptt, ds, torch.zeros(1)), (pat, jds, np.zeros(1, np.float32))):
        A = types.SimpleNamespace(weights=w, offsets=SEVEN, dims=(324,) * 3, n=324 ** 3)
        assert sel.select_product_path(A, _cfg(mod)) == "slab"


@pytest.mark.parametrize("budget_rows", [22, 16])
def test_chunked_coarse_operator_matches_jax_and_dense(budget_rows):
    """24³ in 3 slabs (the last padded) or 4 slabs: the JAX package's slab
    product, and the port's dense product on the same level."""
    dims = (24, 24, 24)
    st, jst, d_inv, coef, cdims, scale = _level_inputs(dims)
    budget = budget_rows * 24 * 24 * 4 * 63
    assert ds.slab_plan(st.offsets, dims, cdims, 3, budget)["n_slabs"] >= 3
    it = 5e-3
    A_c = ds.chunked_coarse_operator(st, d_inv, coef, cdims, 3, scale, it, budget)
    jA_c = jds.chunked_coarse_operator(
        jst, jnp.asarray(d_inv.numpy()), jnp.asarray(coef.numpy()), cdims, 3,
        jnp.asarray(scale.numpy()), it, budget)
    assert A_c.offsets == jA_c.offsets and A_c.dims == cdims
    assert_bits(A_c.weights, jA_c.weights)
    dense = ds.coarse_operator(st, d_inv, coef, cdims,
                               _cfg(ptt, setup_product_path="dense"), scale)
    mine, ref = _planes_by_offset(A_c), _planes_by_offset(dense)
    assert set(ref) <= set(mine)
    scale_w = max(np.abs(p).max() for p in ref.values())
    for o, p in mine.items():
        want = ref.get(o, np.zeros_like(p))
        np.testing.assert_allclose(p, want, rtol=W_RTOL, atol=W_ATOL * scale_w)


@functools.cache
def _slab_setups():
    dims = (12, 10, 9)
    kw = dict(setup_product_path="slab", setup_chunk_budget_mb=1)
    h = ptt.setup(poisson_stencil(dims, device="cpu"), _cfg(ptt, **kw), device="cpu")
    hd = ptt.setup(poisson_stencil(dims, device="cpu"),
                   _cfg(ptt, setup_product_path="dense"), device="cpu")
    jh = pat.setup(j_poisson_stencil(dims), _cfg(pat, **kw))
    return h, hd, jh


def test_slab_setup_matches_jax_level_for_level():
    h, hd, jh = _slab_setups()
    assert h.setup_stats["product_paths"] == ["slab"] * (h.n_levels - 1)
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert h.n_levels >= 3
    for l, jl, ld in zip(h.levels, jh.levels, hd.levels):
        assert l.A.offsets == jl.A.offsets
        assert_bits(l.A.weights, jl.A.weights)
        assert l.lam_max == float(jl.lam_max)
        # the port's dense setup: the same levels
        assert l.A.offsets == ld.A.offsets
        _assert_close(l.A.weights.numpy(), ld.A.weights.numpy())
    n = h.levels[0].A.n_rows
    b = np.random.default_rng(8).normal(size=n).astype(np.float32)
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=50)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=50)
    assert res.converged and res.iters == int(jres.iters)

