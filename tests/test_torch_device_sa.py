"""The port's on-device algebraic SA setup (``amg/device_sa.py``) against
the JAX package's, at 2D sizes.

Index algebra is exact: the strength mask is bool-equal and the MIS
aggregate ids and counts are equal to the JAX package's (the port's draw is
its threefry uniform, its transposes keep its slot order and ``argmax``
takes the first maximum as ``jnp.argmax`` does).  A whole setup at 32² must
give the same level rows, the same P, R and coarse operators as per-row
(col, val) sets to float32 tolerance (same columns; values to rtol 1e-5,
atol 1e-6·max|entry|: the products add in the JAX package's ESC order, and
P's smoothing weight ω/λ_max is the JAX package's, λ_max held bit for bit:
the power iteration adds in XLA's order) and the same PCG iteration count; and, as
``tests/test_device_sa.py`` holds the JAX package, a valid cover and the
oracle's greedy-SA band.  The 3D case is ``test_torch_device_sa_3d.py``.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg import device_sa as jsa
from parallel_amg_tpu.ops.ell import ELL as JELL
from parallel_amg_tpu.problems import anisotropic2d as j_aniso2d
from parallel_amg_tpu.problems import poisson2d as j_poisson2d
from parallel_amg_tpu.problems import poisson3d as j_poisson3d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg import device_sa
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
from parallel_amg_tpu_torch.problems import anisotropic2d, poisson2d, poisson3d

torch.set_num_threads(2)

RTOL = 1e-5

PROBLEMS = {
    "poisson_24": (lambda: poisson2d(24), lambda: j_poisson2d(24)),
    "poisson_32": (lambda: poisson2d(32), lambda: j_poisson2d(32)),
    "poisson3d_10": (lambda: poisson3d(10), lambda: j_poisson3d(10)),
    "aniso_24": (lambda: anisotropic2d(24, epsilon=1e-3),
                 lambda: j_aniso2d(24, epsilon=1e-3)),
}


def _ells(name):
    mine, theirs = PROBLEMS[name]
    return (ELL.from_csr(mine().to_csr()),
            JELL.from_csr(theirs().to_csr(), dtype=jnp.float32))


@pytest.mark.parametrize("theta", [0.0, 0.08, 0.25])
@pytest.mark.parametrize("name", ["poisson_24", "poisson3d_10", "aniso_24"])
def test_sa_strength_mask_matches_jax(name, theta):
    A, jA = _ells(name)
    S = device_sa.sa_strength_mask(A, theta)
    assert S.dtype == torch.bool
    np.testing.assert_array_equal(S.numpy(), np.asarray(
        jsa.sa_strength_mask(jA, theta)))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", ["poisson_24", "poisson_32", "poisson3d_10"])
def test_mis_aggregate_matches_jax(name, seed):
    """Aggregate ids and counts equal to the JAX package's, and a valid
    cover: contiguous ids, every node in one aggregate, MIS aggregates of
    three or more nodes on average."""
    A, jA = _ells(name)
    agg, nc = device_sa.mis_aggregate(A, device_sa.sa_strength_mask(A, 0.0),
                                      seed=seed)
    jagg, jnc = jsa.mis_aggregate(jA, jsa.sa_strength_mask(jA, 0.0), seed=seed)
    assert nc == int(jnc)
    assert agg.dtype == torch.int32
    np.testing.assert_array_equal(agg.numpy(), np.asarray(jagg))
    a = agg.numpy()
    assert a.min() >= 0 and a.max() == nc - 1
    assert len(np.unique(a)) == nc
    assert nc <= A.n_rows // 3


@pytest.mark.parametrize("width", [1, 5, 7, 32, 33, 200, 1024])
def test_argmax_takes_the_first_maximum(width):
    """``attach`` breaks ties between equal |a_ij| by slot, as jnp.argmax
    does: torch.argmax must return the first maximum of all-equal rows and
    of rows with repeated maxima.  (``chip_smoke.py``'s device_sa phase
    holds the same on the card.)"""
    equal = torch.full((4096, width), 0.25)
    assert int(equal.argmax(1).max()) == 0
    vals = np.random.default_rng(width).integers(0, 3, size=(4096, width))
    want = np.argmax(vals, axis=1)  # numpy: the first maximum
    got = torch.from_numpy(vals.astype(np.float32)).argmax(1).numpy()
    np.testing.assert_array_equal(got, want)


def _csr_of(M):
    c = M.to_csr().to_scipy()
    c.sort_indices()
    return c


def assert_same_sets(mine, theirs):
    """Per-row (col, val) sets: equal columns, values to float32 tolerance."""
    a, b = _csr_of(mine), _csr_of(theirs)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_allclose(a.data, b.data, rtol=RTOL,
                               atol=1e-6 * np.abs(b.data).max())


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="greedy",
                         smoother="chebyshev", n_coarse_max=64,
                         on_device_setup=True)


@functools.cache
def setups(name):
    """(port hierarchy, JAX hierarchy, scipy A) of one device SA setup."""
    mine, theirs = PROBLEMS[name]
    h = ptt.setup(mine().to_csr(), _cfg(ptt), device="cpu")
    jh = pat.setup(theirs().to_csr(), _cfg(pat))
    coo = mine()
    return h, jh, sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


def check_setup_parity(name, rhs_seed):
    """Level rows, operators, λ_max and PCG iterations against the JAX
    package; returns the port's hierarchy, its PCG result, A and b."""
    h, jh, A_sp = setups(name)
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert h.n_levels >= 3
    for l, jl in zip(h.levels, jh.levels):
        assert isinstance(l.A, ELL)
        for part in ("A", "P", "R"):
            if getattr(jl, part) is None:
                assert getattr(l, part) is None
            else:
                assert_same_sets(getattr(l, part), getattr(jl, part))
        assert l.lam_max == float(jl.lam_max)
    assert h.complexity() == pytest.approx(jh.complexity(), rel=1e-12)
    b = np.random.default_rng(rhs_seed).normal(size=A_sp.shape[0])
    res = ptt.amg_pcg(None, h, torch.from_numpy(b.astype(np.float32)),
                      tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(jh.levels[0].A, jh, jnp.asarray(b, jnp.float32),
                       tol=1e-6, maxiter=60)
    assert res.converged
    assert res.iters == int(jres.iters)
    return h, res, A_sp, b


def test_device_sa_setup_matches_jax_2d():
    h, res, A_sp, b = check_setup_parity("poisson_32", 0)
    gc, oc = h.complexity()
    assert gc < 2.0 and oc < 3.0, (gc, oc)
    x = res.x.numpy().astype(np.float64)
    assert np.linalg.norm(b - A_sp @ x) <= 5e-5 * np.linalg.norm(b)
    # oracle band: serial greedy SA on the same matrix
    oh = oracle_setup(A_sp, ptt.AMGConfig(coarsening="sa", aggregate="greedy",
                                          smoother="chebyshev", n_coarse_max=64))
    _, oit, _ = oracle_pcg(A_sp, b, oh, tol=1e-6, maxiter=60)
    assert res.iters <= int(oit) + 4


def test_device_sa_setup_is_reproducible():
    """A second setup gives the same hierarchy bit for bit."""
    h, _, _ = setups("poisson_32")
    h2 = ptt.setup(poisson2d(32).to_csr(), _cfg(ptt), device="cpu")
    for l, l2 in zip(h.levels, h2.levels):
        for part in ("cols", "vals", "row_nnz"):
            assert torch.equal(getattr(l.A, part), getattr(l2.A, part))
    assert torch.equal(h.coarse_inv, h2.coarse_inv)


def test_device_sa_solve_formats():
    """with_best_formats turns the ELL levels into DIA/TWELL with the same
    PCG count; the fine operator stays a DIA that amg_pcg_mp takes."""
    h, _, A_sp = setups("poisson_32")
    hf = ptt.with_best_formats(h, device=True)
    assert type(hf.levels[0].A).__name__ == "DIA"
    b = np.random.default_rng(0).normal(size=A_sp.shape[0])
    bt = torch.from_numpy(b.astype(np.float32))
    assert (ptt.amg_pcg(None, hf, bt, tol=1e-6, maxiter=60).iters
            == ptt.amg_pcg(None, h, bt, tol=1e-6, maxiter=60).iters)
    res = ptt.amg_pcg_mp(None, hf, b, tol=1e-8, maxiter=60)
    assert res.converged
    assert (np.linalg.norm(b - A_sp @ res.x.numpy()) / np.linalg.norm(b)) <= 2e-8


def test_sparsify_lumped_matches_oracle():
    """The lumped drop keeps row sums and symmetry and drops what the
    oracle's ``sparsify_lumped`` drops."""
    from parallel_amg_tpu_torch.oracle.serial_amg import sparsify_lumped

    rng = np.random.default_rng(4)
    M = sp.random(60, 60, density=0.15, random_state=4, format="csr")
    M = M + M.T + sp.diags(rng.uniform(4.0, 6.0, 60))
    M = M.tocsr().astype(np.float32).astype(np.float64)
    from parallel_amg_tpu_torch.ops.csr import CSR

    out = device_sa._ell_sparsify_lumped(ELL.from_csr(CSR.from_scipy(M)), 0.3)
    ref = sparsify_lumped(M, 0.3)
    got = _csr_of(out)
    ref.sort_indices()
    ref.eliminate_zeros()
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    np.testing.assert_allclose(got.data, ref.data, rtol=1e-6, atol=1e-6)


def reference_counts(n: int) -> dict:
    """Level rows and PCG iterations to 1e-6 of the JAX package's and the
    port's device SA setups on poisson2d(n), both on the CPU, beside the
    float64 oracle's greedy SA: the configuration and right-hand side of
    ``chip_smoke.py``'s device_sa phase."""
    h, jh, A_sp = setups_at(n)
    b = np.random.default_rng(0).normal(size=n * n).astype(np.float32)
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(jh.levels[0].A, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    oh = oracle_setup(A_sp, ptt.AMGConfig(coarsening="sa", aggregate="greedy",
                                          smoother="chebyshev", n_coarse_max=64))
    _, oit, _ = oracle_pcg(A_sp, b.astype(np.float64), oh, tol=1e-6, maxiter=60)
    return {"problem": f"poisson2d({n})",
            "jax_rows": [l.A.n_rows for l in jh.levels],
            "port_rows": [l.A.n_rows for l in h.levels],
            "jax_pcg_iters": int(jres.iters), "port_pcg_iters": res.iters,
            "oracle_greedy_iters": int(oit),
            "oracle_rows": [l.A.shape[0] for l in oh.levels]}


def setups_at(n: int):
    h = ptt.setup(poisson2d(n).to_csr(), _cfg(ptt), device="cpu")
    jh = pat.setup(j_poisson2d(n).to_csr(), _cfg(pat))
    return h, jh, poisson2d(n).to_csr().to_scipy()


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python3 tests/test_torch_device_sa.py 128 1024
    # (minutes a size: the JAX package compiles each eager operation once)
    import json
    import sys

    for size in [int(a) for a in sys.argv[1:]] or [1024]:
        print(json.dumps(reference_counts(size)), flush=True)
