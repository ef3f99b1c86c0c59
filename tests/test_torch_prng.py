"""The port's uniform draw (``ops/prng.uniform``) against ``jax.random``.

The draw must equal ``jax.random.uniform(PRNGKey(seed), shape, dtype)`` bit
for bit, in float32 and in bfloat16, and the setups that draw from it must
pick what the JAX package picks with no patch: the C/F splits and the
columns of P of an on-device RS setup exactly, and the λ_max and PCG
iteration count of a structured SA setup (λ_max bit for bit wherever the
level's operator is the JAX package's bit for bit, else to rtol 1e-5: the
coarse Galerkin weights add in another order).  The
permutation draw (``ops/prng.permutation``, the distance-2 MIS weights of
the distributed SA setup) must equal ``jax.random.permutation`` bit for
bit: no round for one row, one round of key split and sort up to 1,625
rows, two up to 2.6 million.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg import device_rs as jrs
from parallel_amg_tpu.problems import poisson2d as j_poisson2d
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_poisson_stencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg import device_rs
from parallel_amg_tpu_torch.ops import prng
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.problems import poisson2d, poisson_stencil

torch.set_num_threads(2)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


@pytest.mark.parametrize("shape", [(10,), (1_000_003,), (12, 13, 14)])
@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_f32_bit_equal_jax(seed, shape):
    got = prng.uniform(shape, seed, torch.float32)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32))
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


@pytest.mark.parametrize("shape", [(10,), (1_000_003,), (12, 13, 14)])
@pytest.mark.parametrize("seed", [0, 7])
def test_uniform_bf16_bit_equal_jax(seed, shape):
    got = prng.uniform(shape, seed, torch.bfloat16)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.bfloat16))
    assert got.shape == shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), want.view(np.int16))


@pytest.mark.parametrize("seed,n", [(0, 10), (0, 1000), (3, 262_144), (5, 1)])
def test_permutation_bit_equal_jax(seed, n):
    got = prng.permutation(n, seed)
    want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
    assert got.dtype == torch.int64 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


# -- setups that draw from it, unpatched --------------------------------------

def _rs_cfg(mod):
    """Acceptance config #2's AMGConfig on the device, coarsened to 64 rows."""
    return mod.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=64,
                         interpolation="extended_i", on_device_setup=True)


@functools.cache
def _rs_setups():
    h = ptt.setup(poisson2d(32).to_csr(), _rs_cfg(ptt), device="cpu")
    jh = pat.setup(j_poisson2d(32).to_csr(), _rs_cfg(pat))
    return h, jh


def _split(A: ELL, lvl: int):
    return device_rs.pmis_split_device(
        A, device_rs.classical_strength_mask(A, 0.25), seed=lvl).numpy()


def _jsplit(jA, lvl: int):
    return np.asarray(jrs.pmis_split_device(
        jA, jrs.classical_strength_mask(jA, 0.25), seed=lvl))


@pytest.mark.parametrize("lvl", [0, 1, 2])
def test_rs_setup_split_and_p_columns_equal_jax(lvl):
    """Each level's C/F split, on each package's own operator, and the
    columns of its P are the JAX package's exactly."""
    h, jh = _rs_setups()
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert lvl < h.n_levels - 1
    l, jl = h.levels[lvl], jh.levels[lvl]
    np.testing.assert_array_equal(_split(l.A, lvl), _jsplit(jl.A, lvl))
    np.testing.assert_array_equal(l.P.row_nnz.numpy(), np.asarray(jl.P.row_nnz))
    mask = l.P.mask().numpy()
    np.testing.assert_array_equal(np.where(mask, l.P.cols.numpy(), -1),
                                  np.where(mask, np.asarray(jl.P.cols), -1))


def _sa_cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=64,
                         on_device_setup=True)


@pytest.mark.parametrize("n", [12, 24])
def test_structured_setup_lam_max_and_pcg_equal_jax(n):
    dims = (n, n, n)
    h = ptt.setup(poisson_stencil(dims, device="cpu"), _sa_cfg(ptt), device="cpu")
    jh = pat.setup(j_poisson_stencil(dims), _sa_cfg(pat))
    assert h.n_levels == jh.n_levels
    for l, jl in zip(h.levels, jh.levels):
        if np.array_equal(l.A.weights.numpy().view(np.int32),
                          np.asarray(jl.A.weights).view(np.int32)):
            assert l.lam_max == float(jl.lam_max)
        else:
            np.testing.assert_allclose(l.lam_max, float(jl.lam_max), rtol=1e-5)
    b = np.random.default_rng(3).normal(size=int(np.prod(dims))).astype(np.float32)
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
