"""The port's on-device Ruge–Stüben setup against the JAX package's.

Both run on the CPU: the port's SpGEMM through its kernels' plain versions,
the JAX package eagerly (``device_rs_setup`` with its ESC products).  The
port's PMIS weights and power-iteration start vector are its own
``ops/prng.uniform`` draws, bit-equal to ``jax.random.uniform``, so the two
setups take the same C/F splits with no patch.

Index algebra (strength, PMIS, transpose, prune, level sizes) and every
operator (A, P, R on each level, and d⁻¹) are held equal, floats bit for
bit: the port adds its float32 row sums in the JAX package's CPU order
(``ops/ordered_sum.py``) and its Galerkin products in the JAX package's ESC
order (``ell_spgemm``), and λ_max too: the power iteration's row sums and
norm add in XLA's order (``ordered_sum.ell_dot_lanes``, ``ordered_sum.norm``).  PCG takes the same
iteration count.  Whole setups run at 32² (the JAX eager setup spends about
a minute compiling), built once per module.
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
from parallel_amg_tpu.amg import device_rs as jrs
from parallel_amg_tpu.ops import ell_setup as jes
from parallel_amg_tpu.ops.ell import ELL as JELL
from parallel_amg_tpu.problems import anisotropic2d as j_aniso2d
from parallel_amg_tpu.problems import poisson2d as j_poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.amg import device_rs
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.ell_setup import (
    ell_prune,
    ell_spgemm,
    ell_transpose,
)
from parallel_amg_tpu_torch.ops.format_device import (
    best_format_from_ell,
    dia_from_ell,
    twell_from_ell,
)
from parallel_amg_tpu_torch.ops.select import best_format
from parallel_amg_tpu_torch.ops.twell import TWELL
from parallel_amg_tpu_torch.problems import anisotropic2d, poisson2d

torch.set_num_threads(2)

RTOL = 1e-5

PROBLEMS = {
    "poisson": (lambda: poisson2d(32), lambda: j_poisson2d(32)),
    "aniso": (lambda: anisotropic2d(32, epsilon=1e-3),
              lambda: j_aniso2d(32, epsilon=1e-3)),
}


def _cfg(mod):
    """Acceptance config #2's AMGConfig on the device, coarsened to 64 rows."""
    return mod.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=64,
                         interpolation="extended_i", on_device_setup=True)


@functools.cache
def jax_hierarchy(name):
    return pat.setup(PROBLEMS[name][1]().to_csr(), _cfg(pat))


@functools.cache
def port_hierarchy(name):
    return ptt.setup(PROBLEMS[name][0]().to_csr(), _cfg(ptt), device="cpu")


def to_port(M) -> ELL:
    return ELL(torch.from_numpy(np.array(M.cols, np.int32)),
               torch.from_numpy(np.array(M.vals, np.float32)),
               torch.from_numpy(np.array(M.row_nnz, np.int32)), M.shape)


def to_jax(M: ELL) -> JELL:
    return JELL(jnp.asarray(M.cols.numpy()), jnp.asarray(M.vals.numpy()),
                jnp.asarray(M.row_nnz.numpy()), M.shape)


def assert_operator_equal(mine, theirs):
    """The same ELL planes, values bit for bit."""
    assert tuple(mine.shape) == tuple(theirs.shape)
    np.testing.assert_array_equal(mine.cols.numpy(), np.asarray(theirs.cols))
    np.testing.assert_array_equal(mine.row_nnz.numpy(), np.asarray(theirs.row_nnz))
    np.testing.assert_array_equal(mine.vals.numpy().view(np.int32),
                                  np.asarray(theirs.vals).view(np.int32))


def check_whole_setup(name):
    """Level sizes equal, every operator equal, PCG iterations equal."""
    h, jh = port_hierarchy(name), jax_hierarchy(name)
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert h.n_levels >= 3
    for l, jl in zip(h.levels, jh.levels):
        assert isinstance(l.A, ELL)
        assert_operator_equal(l.A, jl.A)
        assert (l.P is None) == (jl.P is None)
        if l.P is not None:
            assert_operator_equal(l.P, jl.P)
            assert_operator_equal(l.R, jl.R)
        np.testing.assert_array_equal(l.d_inv.numpy().view(np.int32),
                                      np.asarray(jl.d_inv).view(np.int32))
        assert l.lam_max == float(jl.lam_max)
    np.testing.assert_allclose(h.complexity(), jh.complexity(), rtol=1e-12)
    b = np.random.default_rng(0).normal(size=h.levels[0].A.n_rows).astype(np.float32)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    assert bool(jres.converged)
    for hh in (h, ptt.with_best_formats(h, device=True),
               ptt.with_best_formats(h, device=False)):
        res = ptt.amg_pcg(None, hh, torch.from_numpy(b), tol=1e-6, maxiter=60)
        assert res.converged and res.iters == int(jres.iters)


@pytest.mark.parametrize("name", ["poisson"])
def test_whole_setup_matches_jax(name):
    check_whole_setup(name)


def test_setup_stats_and_chunking():
    h = port_hierarchy("poisson")
    stats = h.setup_stats
    assert [s["rows"] for s in stats["levels"]] == [l.A.n_rows for l in h.levels]
    first = stats["levels"][0]
    assert first["RA"]["K"] == h.levels[0].R.width * h.levels[0].A.width
    assert first["RAP"]["w"] >= h.levels[1].A.width
    assert {"strength_pmis", "interpolation", "transpose", "products"} <= set(
        stats["seconds"])
    # chunked extended+i equals the one-chunk result exactly
    A, S, state = _level_inputs(0)
    one = device_rs.extended_i_interpolation_device(A, S, state, 4)
    stats = {}
    many = device_rs.extended_i_interpolation_device(A, S, state, 4,
                                                     row_chunk=100, stats=stats)
    assert stats["interp_chunks"] == -(-A.n_rows // 100)
    for a, b in ((one.cols, many.cols), (one.vals, many.vals),
                 (one.row_nnz, many.row_nnz)):
        assert torch.equal(a, b)


def test_ell_transpose_matches_jax_restriction():
    """R = ell_transpose(P) on JAX's own P is JAX's R, bit for bit."""
    jh = jax_hierarchy("poisson")
    for jl in jh.levels[:-1]:
        R = ell_transpose(to_port(jl.P))
        jR = to_port(jl.R)
        assert R.shape == jR.shape and R.width == jR.width
        assert torch.equal(R.cols, jR.cols) and torch.equal(R.row_nnz, jR.row_nnz)
        assert torch.equal(R.vals.view(torch.int32), jR.vals.view(torch.int32))


def test_ell_transpose_above_jax_chunk_ceiling():
    """Above 2^19 rows the JAX package's transpose calls an undefined
    function, so the port is held against scipy there."""
    rng = np.random.default_rng(3)
    n_rows, n_cols = (1 << 19) + 4321, 2000
    cols = rng.integers(0, n_cols, size=(n_rows, 2)).astype(np.int32)
    nnz = rng.integers(0, 3, size=n_rows).astype(np.int32)
    vals = rng.normal(size=(n_rows, 2)).astype(np.float32)
    mask = np.arange(2)[None, :] < nnz[:, None]
    cols[~mask], vals[~mask] = 0, 0.0
    M = ELL(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(nnz),
            (n_rows, n_cols))
    T = ell_transpose(M)
    ref = M.to_csr().to_scipy().T.tocsr()
    got = T.to_csr().to_scipy()
    assert got.shape == ref.shape and (got != ref).nnz == 0
    # rows of T list their source rows in ascending order
    assert (np.diff(got.indices)[np.diff(np.repeat(
        np.arange(n_cols), np.diff(got.indptr))) == 0] > 0).all()


def test_ell_prune_matches_jax_and_scipy():
    rng = np.random.default_rng(5)
    m = sp.random(90, 70, density=0.1, random_state=np.random.RandomState(5),
                  format="csr")
    m.data[:] = rng.normal(size=m.nnz).astype(np.float32)
    m.data[rng.random(m.nnz) < 0.2] = 0.0
    M = ELL.from_csr(CSR.from_scipy(m))
    # shuffle the stored entries of each row: prune re-sorts by column
    key = torch.where(M.mask(), torch.from_numpy(rng.random(M.cols.shape)), 2.0)
    perm = key.argsort(1)
    Ms = ELL(M.cols.gather(1, perm), M.vals.gather(1, perm), M.row_nnz, M.shape)
    for tol in (0.0, 0.5):
        mine = ell_prune(Ms, tol)
        theirs = to_port(jes.ell_prune(to_jax(Ms), tol))
        for a, b in ((mine.cols, theirs.cols), (mine.vals, theirs.vals),
                     (mine.row_nnz, theirs.row_nnz)):
            assert torch.equal(a, b)
        ref = m.astype(np.float32)
        ref.data[np.abs(ref.data) <= tol] = 0.0
        ref.eliminate_zeros()
        got = mine.to_csr().to_scipy()
        assert got.nnz == ref.nnz and (got != ref).nnz == 0


def test_galerkin_product_matches_jax_level():
    """prune((R·A)·P) on JAX's level-0 operators is JAX's level-1 A."""
    jl0, jl1 = jax_hierarchy("poisson").levels[:2]
    R, A, P = to_port(jl0.R), to_port(jl0.A), to_port(jl0.P)
    Ac = ell_prune(ell_spgemm(ell_spgemm(R, A), P))
    jAc = to_port(jl1.A)
    assert Ac.shape == jAc.shape
    assert torch.equal(Ac.cols, jAc.cols) and torch.equal(Ac.row_nnz, jAc.row_nnz)
    assert torch.equal(Ac.vals.view(torch.int32), jAc.vals.view(torch.int32))


@functools.cache
def _level_inputs(lvl):
    """(A, S, state) of a JAX hierarchy level, from the JAX functions."""
    jA = jax_hierarchy("poisson").levels[lvl].A
    jS = jrs.classical_strength_mask(jA, 0.25)
    jstate = jrs.pmis_split_device(jA, jS, seed=lvl)
    return (to_port(jA), torch.from_numpy(np.array(jS)),
            torch.from_numpy(np.array(jstate)))


@pytest.mark.parametrize("lvl", [0, 1])
def test_strength_and_pmis_match_jax(lvl):
    A, S, state = _level_inputs(lvl)
    mine = device_rs.classical_strength_mask(A, 0.25)
    assert torch.equal(mine, S)
    got = device_rs.pmis_split_device(A, mine, seed=lvl)
    assert got.dtype == torch.int32 and torch.equal(got, state)
    assert set(got.unique().tolist()) <= {device_rs.FINE, device_rs.COARSE}


def test_strength_mask_matches_jax_anisotropic():
    A = ELL.from_csr(anisotropic2d(10).to_csr())
    S = device_rs.classical_strength_mask(A, 0.25)
    jS = jrs.classical_strength_mask(to_jax(A), 0.25)
    assert torch.equal(S, torch.from_numpy(np.array(jS)))


@pytest.mark.parametrize("interp", ["direct", "extended_i", "smoothed_direct"])
def test_interpolation_matches_jax(interp):
    """Each interpolation on the same (A, S, state) as JAX's."""
    A, S, state = _level_inputs(1)
    jA, jS, jstate = to_jax(A), jnp.asarray(S.numpy()), jnp.asarray(state.numpy())
    if interp == "extended_i":
        P = device_rs.extended_i_interpolation_device(A, S, state, 4)
        jP = jrs.extended_i_interpolation_device(jA, jS, jstate, 4)
    else:
        P = device_rs.direct_interpolation_device(A, S, state, 8)
        jP = jrs.direct_interpolation_device(jA, jS, jstate, 8)
        if interp == "smoothed_direct":
            P = device_rs.smooth_interpolation(A, P, 2.0 / 3.0, 4)
            jP = jrs.smooth_interpolation(jA, jP, 2.0 / 3.0, 4)
    assert P.shape == tuple(jP.shape)
    assert_operator_equal(P, jP)


def test_topk_stable_takes_lower_index_on_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0], [0.0, 0.0, 0.0, 1.0, 0.0, 0.0]])
    v, i = device_rs.topk_stable(x, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert i.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 3], [3, 0, 1, 2]]
    assert v.tolist() == np.asarray(jv).tolist()


def _format_cases():
    h = port_hierarchy("poisson")
    dup = ELL(torch.tensor([[0, 1, 1], [1, 0, 0]], dtype=torch.int32),
              torch.tensor([[1.0, 2.0, 3.0], [4.0, 0.0, 0.0]]),
              torch.tensor([3, 1], dtype=torch.int32), (2, 2))
    return {"A0": h.levels[0].A, "A1": h.levels[1].A, "P0": h.levels[0].P,
            "R1": h.levels[1].R, "duplicates": dup}


@pytest.mark.parametrize("name", ["A0", "A1", "P0", "R1", "duplicates"])
def test_format_conversion_on_device(name):
    """dia_from_ell / twell_from_ell give scipy's matvec; the policy picks
    what the host best_format picks."""
    M = _format_cases()[name]
    ref = M.to_csr().to_scipy()  # CSR sums duplicate entries
    x = np.random.default_rng(2).normal(size=M.n_cols).astype(np.float32)
    want = ref @ x.astype(np.float64)
    tol = dict(rtol=RTOL, atol=1e-6 * np.abs(ref).sum(1).max())
    tw = twell_from_ell(M)
    assert tw.indptr.dtype == tw.indices.dtype == torch.int32
    assert (np.diff(tw.to_csr().to_scipy().indices)[np.diff(np.repeat(
        np.arange(M.n_rows), np.diff(tw.indptr.numpy()))) == 0] >= 0).all()
    np.testing.assert_allclose(tw.matvec(torch.from_numpy(x)).numpy(), want, **tol)
    dia, nnz = dia_from_ell(M)
    if M.n_rows == M.n_cols:
        assert nnz == M.nnz and dia is not None
        np.testing.assert_allclose(dia.matvec(torch.from_numpy(x)).numpy(), want,
                                   **tol)
    else:
        assert dia is None
    fast = best_format_from_ell(M)
    assert type(fast) is type(best_format(M.to_csr()))
    np.testing.assert_allclose(fast.matvec(torch.from_numpy(x)).numpy(), want, **tol)


def test_dia_from_ell_refuses_wide_bands():
    m = sp.random(300, 300, density=0.05, random_state=np.random.RandomState(1),
                  format="csr")
    dia, nnz = dia_from_ell(ELL.from_csr(CSR.from_scipy(m)))
    assert dia is None and nnz == m.nnz


def test_with_best_formats_device_and_host_agree():
    h = port_hierarchy("poisson")
    hd = ptt.with_best_formats(h, device=True)
    hh = ptt.with_best_formats(h, device=False)
    for ld, lh in zip(hd.levels, hh.levels):
        for a, b in ((ld.A, lh.A), (ld.P, lh.P), (ld.R, lh.R)):
            assert type(a) is type(b)
            assert a is None or isinstance(a, (DIA, TWELL))
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=h.levels[0].A.n_rows).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=h.levels[0].A.n_rows).astype(np.float32))
    ref = ptt.vcycle(h, x, b)
    for hf in (hd, hh):
        out = ptt.vcycle(hf, x, b)
        assert float(torch.linalg.norm(out - ref)) <= 1e-5 * float(torch.linalg.norm(ref))


def test_interop_carries_jax_device_rs_hierarchy():
    jh = jax_hierarchy("poisson")

    def ell(M):
        return None if M is None else {
            "format": "ELL", "cols": np.asarray(M.cols), "vals": np.asarray(M.vals),
            "row_nnz": np.asarray(M.row_nnz), "shape": M.shape}

    levels = [{"A": ell(l.A), "P": ell(l.P), "R": ell(l.R),
               "d_inv": np.asarray(l.d_inv), "lam_max": np.asarray(l.lam_max)}
              for l in jh.levels]
    carried = interop.hierarchy_from_numpy(
        levels, np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), device="cpu")
    assert all(isinstance(l.A, ELL) for l in carried.levels)
    for l, jl in zip(carried.levels, jh.levels):
        assert torch.equal(l.A.cols, torch.from_numpy(np.array(jl.A.cols)))
    rng = np.random.default_rng(5)
    x = rng.normal(size=jh.levels[0].A.n_rows).astype(np.float32)
    b = rng.normal(size=jh.levels[0].A.n_rows).astype(np.float32)
    out = ptt.vcycle(carried, torch.from_numpy(x), torch.from_numpy(b)).numpy()
    theirs = np.asarray(pat.vcycle(jh, jnp.asarray(x), jnp.asarray(b)))
    assert np.linalg.norm(out - theirs) <= 1e-5 * np.linalg.norm(theirs)
