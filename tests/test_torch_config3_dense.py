"""Config #3's dense Galerkin levels, bit for bit against the JAX package on
the CPU: the dense ``coarse_operator`` at 43³ → 15³ and 15³ → 5³ (config #3's
levels 1 and 2) on seeded, symmetric, diagonally dominant 27-point
stencils == the JAX package's jitted dense stages (smoothers, stencil
products, sparsify, prune, ``_jit_galerkin``): their one-hot dots, (27,
343, 3375) and (27, 343, 125), are k-blocked (``device_setup._dot_order``).

Inputs are drawn with numpy from a seed; comparisons are of float32 bits.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.ops.stencil import Stencil as JStencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
from parallel_amg_tpu_torch.ops.stencil import Stencil

from float_bits import assert_bits

torch.set_num_threads(2)


def _cfg(**kw):
    return ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", on_device_setup=True, **kw)


def _random_27pt(dims, seed):
    """A symmetric, diagonally dominant 27-point stencil: w[o](p) =
    w[−o](p + o) = −r, r uniform in [0.1, 1.1) times powers of 2 where p + o
    is on the grid, the centre 1 + Σ|w|."""
    rng = np.random.default_rng(seed)
    offs = tuple(itertools.product((-1, 0, 1), repeat=3))
    W = np.zeros((27,) + dims, np.float64)
    idx = np.indices(dims)
    for k, o in enumerate(offs):
        if o <= (0, 0, 0):
            continue
        inside = np.ones(dims, bool)
        for a in range(3):
            inside &= (idx[a] + o[a] >= 0) & (idx[a] + o[a] < dims[a])
        r = rng.uniform(0.1, 1.1, dims) * np.exp2(rng.integers(-3, 3, dims))
        W[k] = np.where(inside, -r, 0.0)
        neg = offs.index(tuple(-c for c in o))
        sl = tuple(slice(max(0, c), d + min(0, c)) for c, d in zip(o, dims))
        dst = tuple(slice(max(0, -c), d + min(0, -c)) for c, d in zip(o, dims))
        W[neg][sl] = W[k][dst]
    W[offs.index((0, 0, 0))] = 1.0 + np.abs(W).sum(axis=0)
    return offs, W.astype(np.float32)


@pytest.mark.parametrize("n", [43, 15])
def test_dense_coarse_operator_bit_equal_to_jax(n):
    dims = (n,) * 3
    b = 3
    cdims = tuple(-(-d // b) for d in dims)
    offs, W = _random_27pt(dims, seed=n)
    A, jA = Stencil(torch.from_numpy(W), offs, dims), JStencil(jnp.asarray(W), offs, dims)
    d_inv = ds.diag_inverse(A)
    jd = jds._jit_dinv(jA)
    assert_bits(d_inv.numpy(), np.asarray(jd))
    coef = np.float32(0.6) / np.float32(1.37)
    scale = ds.block_scale(downsample_sum_nd(torch.ones(dims), cdims, b))
    cfg = _cfg(setup_product_path="dense")
    it = cfg.setup_intermediate_tol
    got = ds.coarse_operator(A, d_inv, torch.tensor(coef), cdims, cfg, scale)
    jcoef = jnp.asarray(coef)
    S, St = jds._jit_smooth(jA, jd, jcoef), jds._jit_smooth_T(jA, jd, jcoef)
    AS = jds._prune_zero_planes(jds._jit_sparsify(jds._jit_matmul(jA, S), it))
    M = jds._prune_zero_planes(jds._jit_sparsify_sym(jds._jit_matmul(St, AS), it))
    want = jds._jit_galerkin(M, cdims, b, jnp.asarray(scale.numpy()))
    assert got.offsets == tuple(want.offsets)
    assert_bits(got.weights, np.asarray(want.weights))
