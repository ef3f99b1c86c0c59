"""The port's ``pallas_spgemm`` (kernel B9's product, routed to B3 + B5 + B4)
against the JAX package's, on the three cases of tests/test_pspgemm.py at
poisson2d(12) (the JAX side runs its Pallas kernels in interpret mode).

Column order follows the candidate order in the port and the TWELL piece
order in the JAX package, so products are compared as column sets per row
and nnz per row (equal: both keep every column with a nonzero candidate
product) and as values (scipy matrices with duplicates summed).  Tolerance
on values: 1e-5·max|C| (float32 sums of the same products in another
order; a sum that cancels may be exactly 0 in one and 1e-9 in the other).
The CUDA case holds the kernels' product against the plain versions' on the
card.  The Galerkin-chain case sits in ``test_torch_pspgemm_chain.py`` so that
its JAX compiling runs beside these.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax.numpy as jnp

    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.ell import ELL as JELL
    from parallel_amg_tpu.ops.pspgemm import (
        PallasSpgemmPlan as JPallasSpgemmPlan,
        pallas_spgemm as j_pallas_spgemm,
    )
    from parallel_amg_tpu.oracle.serial_amg import (
        classical_strength,
        pmis_split,
        smoothed_direct_interpolation,
    )
    from parallel_amg_tpu.problems import poisson2d as j_poisson2d
except ImportError:  # a machine without JAX runs the cuda cases only
    jnp = None

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.ops import gspgemm, pspgemm
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

N = 12


def _to_sp(C, shape):
    cols, vals = np.asarray(C.cols), np.asarray(C.vals)
    R, W = cols.shape
    m = sp.csr_matrix((vals.ravel(), (np.repeat(np.arange(R), W), cols.ravel())),
                      shape=shape)
    m.sum_duplicates()
    m.eliminate_zeros()
    return m


def _ell(A_sp):
    return ELL.from_csr(CSR.from_scipy(A_sp.tocsr()), dtype=torch.float32)


def _jell(A_sp):
    return JELL.from_csr(JCSR.from_scipy(A_sp.tocsr()), dtype=jnp.float32)


def _col_sets(C):
    """Per row, the sorted columns of the live slots (the merge's leaders:
    every column with a nonzero candidate product, whatever its sum)."""
    cols, nnz = np.asarray(C.cols), np.asarray(C.row_nnz)
    return [sorted(cols[r, :nnz[r]].tolist()) for r in range(cols.shape[0])]


def _assert_same_product(C, jC, shape):
    np.testing.assert_array_equal(np.asarray(C.row_nnz), np.asarray(jC.row_nnz))
    assert _col_sets(C) == _col_sets(jC)
    mine, theirs = _to_sp(C, shape), _to_sp(jC, shape)
    d = abs(mine - theirs)
    assert (d.max() if d.nnz else 0.0) <= 1e-5 * abs(theirs).max()


@functools.cache
def _poisson():
    return poisson2d(N).to_csr().to_scipy()


@functools.cache
def _galerkin_operands():
    A_sp = _poisson()
    S = classical_strength(A_sp, 0.25)
    P_sp = smoothed_direct_interpolation(A_sp, S, pmis_split(S, seed=0), 2 / 3, 4)
    return A_sp, P_sp.tocsr(), P_sp.T.tocsr()


def test_pallas_spgemm_square_matches_jax():
    A_sp = _poisson()
    np.testing.assert_array_equal(
        A_sp.toarray(), sp.csr_matrix((j_poisson2d(N).val, (j_poisson2d(N).row,
                                                            j_poisson2d(N).col))).toarray())
    C = ptt.pallas_spgemm(_ell(A_sp), _ell(A_sp))
    jC = j_pallas_spgemm(_jell(A_sp), _jell(A_sp))
    _assert_same_product(C, jC, A_sp.shape)
    ref = (A_sp @ A_sp).astype(np.float32)
    d = abs(_to_sp(C, A_sp.shape) - ref)
    assert (d.max() if d.nnz else 0.0) < 1e-4


def test_pallas_spgemm_plan_reuse_matches_jax():
    """One plan serves products with several right-hand operands."""
    A_sp = _poisson()
    A, jA = _ell(A_sp), _jell(A_sp)
    plan, jplan = ptt.PallasSpgemmPlan.from_ell(A), JPallasSpgemmPlan.from_ell(jA)
    assert plan.A is A
    B_sp = (A_sp * 2.0).tocsr()
    C1 = ptt.pallas_spgemm(A, A, plan=plan)
    C2 = ptt.pallas_spgemm(None, _ell(B_sp), plan=plan)
    jC2 = j_pallas_spgemm(jA, _jell(B_sp), plan=jplan)
    _assert_same_product(C2, jC2, A_sp.shape)
    d = abs(_to_sp(C2, A_sp.shape) - 2.0 * _to_sp(C1, A_sp.shape))
    assert (d.max() if d.nnz else 0.0) < 1e-4


def test_pallas_spgemm_drops_zeros_and_clamps_width():
    """Products equal to 0 drop; an explicit out_width below a row's count
    keeps that row's first out_width columns, with row_nnz clamped."""
    A_sp = sp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 0.0, 0.0], [3.0, 4.0, 0.0]]))
    B_sp = sp.csr_matrix(np.array([[1.0, 1.0, 1.0, 0.0], [0.0, 0.0, 0.0, 5.0],
                                   [0.0, 2.0, 0.0, 1.0]]))
    A = _ell(A_sp)
    A.vals[0, 1] = 0.0  # an explicit zero: its products drop
    C = ptt.pallas_spgemm(A, _ell(B_sp))
    np.testing.assert_array_equal(C.row_nnz.numpy(), [3, 0, 4])
    np.testing.assert_allclose(_to_sp(C, (3, 4)).toarray(),
                               np.array([[1, 1, 1, 0], [0, 0, 0, 0], [3, 3, 3, 20]]))
    Cw = ptt.pallas_spgemm(A, _ell(B_sp), out_width=2)
    assert Cw.width == 2
    np.testing.assert_array_equal(Cw.row_nnz.numpy(), [2, 0, 2])
    np.testing.assert_array_equal(Cw.cols.numpy(), C.cols.numpy()[:, :2])


# -- the route on the card --------------------------------------------------------

@pytest.mark.cuda
def test_pallas_spgemm_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("kernels B3, B5 and B4 are CUDA C++ and need a CUDA card")
    A_sp = poisson2d(32).to_csr().to_scipy()
    A = _ell(A_sp).to("cuda")
    before = dict(pspgemm.LAUNCHES)
    C = ptt.pallas_spgemm(A, A)
    torch.cuda.synchronize()
    assert all(pspgemm.LAUNCHES[k] == before[k] + 1 for k in before)
    Cp = gspgemm.plain_spgemm(A, A)
    assert torch.equal(C.cols, Cp.cols) and torch.equal(C.row_nnz, Cp.row_nnz)
    np.testing.assert_allclose(C.vals.cpu().numpy(), Cp.vals.cpu().numpy(), rtol=1e-5,
                               atol=1e-6)


# -- the merge's order of summation (the plain versions and B4) -------------------

def _slot_order_sums(cc, cv, sent):
    """Each row's column sums at its leader slots, added one after another in
    ascending slot order with float32 rounding at every step."""
    cc, cv = cc.numpy(), cv.numpy()
    out = np.zeros(cc.shape, np.float32)
    for r in range(cc.shape[0]):
        lead = {}
        for k in range(cc.shape[1]):
            c = int(cc[r, k])
            if c == sent:
                continue
            j = lead.setdefault(c, k)
            out[r, j] = np.float32(out[r, j] + cv[r, k])
    return out


def _cancelling_candidates():
    """50 rows of K = 40 candidates over 5 columns, magnitudes spread over
    eight decades, so that sums in different orders round differently."""
    rng = np.random.default_rng(40)
    sent = 5
    cc = rng.integers(0, sent + 1, size=(50, 40)).astype(np.int32)
    cv = (rng.normal(size=cc.shape)
          * 10.0 ** rng.integers(-4, 5, size=cc.shape)).astype(np.float32)
    return torch.from_numpy(cc), torch.from_numpy(cv), sent


def test_merge_sums_in_slot_order():
    """The plain merge adds each column's values in ascending slot order, as
    merge_kernel does, bit for bit; a torch reduction over the equality
    matrix (the order torch picks) rounds differently on this case."""
    cc, cv, sent = _cancelling_candidates()
    leader, sums = pspgemm.merge_rows_plain(cc, cv, sent)
    want = _slot_order_sums(cc, cv, sent)
    lead = leader.numpy()
    np.testing.assert_array_equal(sums.numpy()[lead].view(np.int32),
                                  want[lead].view(np.int32))
    valid = cc != sent
    E = (cc[:, :, None] == cc[:, None, :]) & valid[:, :, None]
    torch_order = (cv[:, :, None] * E).sum(1).numpy()
    assert (torch_order[lead] != want[lead]).any()
    _, ov, _ = pspgemm.dedup(cc, cv, sent)
    np.testing.assert_array_equal(ov.numpy()[lead], want[lead])
    _, cvals, counts = gspgemm.dedup_compact(cc, cv, sent, 5)
    for r in range(cc.shape[0]):
        np.testing.assert_array_equal(cvals[r, :int(counts[r])].numpy(),
                                      want[r][lead[r]])


@pytest.mark.cuda
def test_b4_bit_equal_to_plain_64():
    """B4 (and B5 in place) bit-equal to the plain merge at 64²: the
    candidates of R·A for the classical-AMG R of poisson2d(64)."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B3, B5 and B4 are CUDA C++ and need a CUDA card")
    from parallel_amg_tpu_torch.oracle.serial_amg import oracle_setup

    A_sp = poisson2d(64).to_csr().to_scipy()
    oh = oracle_setup(A_sp, ptt.AMGConfig(coarsening="rs", n_coarse_max=64))
    R, A = _ell(oh.levels[0].R).to("cuda"), _ell(A_sp).to("cuda")
    sent = A.n_cols
    cc, cv = gspgemm.gather_candidates(R, A)
    qc, qv, qn = pspgemm._dedup_plain(cc, cv, sent)
    oc, ov, on = pspgemm.dedup(cc, cv, sent)
    assert torch.equal(oc, qc) and torch.equal(on, qn) and torch.equal(ov, qv)
    w = int(qn.max())
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, w)
    qc, qv, qn = gspgemm._dedup_compact_plain(cc, cv, sent, w)
    torch.cuda.synchronize()
    assert torch.equal(oc, qc) and torch.equal(on, qn) and torch.equal(ov, qv)
