"""The port's setup SpGEMM (kernels B3, B4, B5) against the JAX package.

On the CPU the port's wrappers run their plain torch versions; the JAX side
runs its Pallas kernels in interpret mode (``gather_candidates``,
``_dedup_call``, ``_dedup_compact_call``) on at most 400 rows.  Columns and
counts must be equal exactly.  B3's candidate values are single float32
products and must be bit-equal; a merged value sums the same float32
products in another order, so it is held to
|Δ| ≤ 1e-6 + 1e-5·Σ|merged candidates|.  Whole
products are held against scipy as (column, value) sets at 1e-5.  The CUDA
cases hold each kernel against its plain version on the card with the same
bounds.  ``TILING`` holds shapes at the edges of B3's tiling on the card
(ragged row tiles, K not a multiple of 4, B's rows off 16-byte alignment,
Wa > 32, tiles off alignment, rows split into m ranges, empty rows and
zeros): on the CPU the plain version against JAX's kernel, on the card the
kernel against the plain version, bit for bit.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parallel_amg_tpu_torch.ops import gspgemm, pspgemm
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.ell_setup import (
    ell_prune,
    ell_spgemm,
    ell_spgemm_pairwise,
)
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _random(n_rows, n_cols, density, seed, zeros=0.0):
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data[:] = rng.normal(size=m.nnz).astype(np.float32)
    m.data[rng.random(m.nnz) < zeros] = 0.0  # explicit zeros stay stored
    m.sort_indices()
    return m


def _poisson(n):
    return poisson2d(n).to_csr().to_scipy().tocsr()


def _ell(m):
    return ELL.from_csr(CSR.from_scipy(m), dtype=torch.float32)


@functools.cache
def _galerkin_pair():
    """(A, P) of a Galerkin-shaped product on a 16² Poisson."""
    A = _poisson(16)
    n = A.shape[0]
    P = (sp.random(n, 70, density=0.02, random_state=1, format="csr")
         + sp.eye(n, 70) * 0.5).tocsr()
    P.sort_indices()
    return A, P


CASES = {
    "square_poisson": lambda: (_poisson(16), _poisson(16)),
    "rect_AP": lambda: _galerkin_pair(),
    "rect_RAP": lambda: (_galerkin_pair()[1].T.tocsr(),
                         (_galerkin_pair()[0] @ _galerkin_pair()[1]).tocsr()),
    "explicit_zeros": lambda: (_random(120, 90, 0.06, 3, zeros=0.3),
                               _random(90, 140, 0.05, 4, zeros=0.3)),
}


def _widths(n_rows, n_cols, width, seed, empty=0.0, zeros=0.0):
    """A random CSR whose widest row holds exactly ``width`` entries (its ELL
    width), with a share of empty rows and of stored zeros."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, width + 1, size=n_rows)
    nnz[rng.random(n_rows) < empty] = 0
    nnz[0] = width
    cols = [np.sort(rng.choice(n_cols, size=k, replace=False)) for k in nnz]
    vals = rng.normal(size=int(nnz.sum())).astype(np.float32)
    vals[rng.random(vals.size) < zeros] = 0.0
    return sp.csr_matrix((vals, np.concatenate(cols).astype(np.int32),
                          np.concatenate([[0], np.cumsum(nnz)])),
                         shape=(n_rows, n_cols))


def _tiling_pair(rows, wa, wb, inner=300, seed=0, **extra):
    """A (rows × inner) of width wa times B (inner × 400) of width wb."""
    return (_widths(rows, inner, wa, seed, **extra),
            _widths(inner, 400, wb, seed + 1, **extra))


# Shapes at the edges of B3's tiling on the card (csrc/spgemm.cu::
# expand_plan, 2,048 slots a tile): K = Wa·Wb and the tile each one makes.
TILING = {
    # K 24: 84-row tiles, the last one ragged (203 rows, not a multiple of 4)
    "ragged_rows_K24": lambda: _tiling_pair(203, 6, 4),
    # K 21 (not a multiple of 4), Wb 3: B's rows not 16-byte-aligned, and
    # the last tile ends in the middle of a 16-byte word
    "K21_Wb3": lambda: _tiling_pair(250, 7, 3),
    # Wb 5: B's rows 20 bytes, read a word at a time
    "K45_Wb5": lambda: _tiling_pair(150, 9, 5),
    # Wa 40 > 32: a tile's 480 entries pass the block's 256 threads
    "Wa40": lambda: _tiling_pair(90, 40, 4),
    # K 665: 3-row tiles that start off 16-byte alignment
    "three_row_tiles_K665": lambda: _tiling_pair(31, 35, 19),
    # K 2,310: one row splits into m ranges of 29 and 4
    "split_m_K2310": lambda: _tiling_pair(9, 70, 33),
    # empty rows of A and of B (rows of all SENT) and stored zeros in both
    "empty_rows_zeros": lambda: _tiling_pair(120, 10, 6, empty=0.4, zeros=0.2),
}
# On the card only (its JAX run in interpret mode takes some 40 s on a
# CPU): Wa 2,100 alone passes a tile, so k splits into ranges of 2,048 and
# 52 of one m.
TILING_CUDA = {**TILING,
               "split_k_Wa2100": lambda: _tiling_pair(3, 2100, 2, inner=2500)}


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.ell import ELL as JELL
    from parallel_amg_tpu.ops import gspgemm as jg
    from parallel_amg_tpu.ops import pspgemm as jp
    return jnp, JCSR, JELL, jg, jp


def _jax_candidates(a, b):
    jnp, JCSR, JELL, jg, _ = _jax()
    A = JELL.from_csr(JCSR.from_scipy(a), dtype=jnp.float32)
    B = JELL.from_csr(JCSR.from_scipy(b), dtype=jnp.float32)
    cc, cv = jg.gather_candidates(jg.GatherSpgemmPlan.from_ell(A), B)
    return np.asarray(cc)[:a.shape[0]], np.asarray(cv)[:a.shape[0]]


def _merge_bound(cand_c, cand_v, sent):
    """Σ|merged candidates| at each leader (B5's in-place layout)."""
    return pspgemm._dedup_plain(cand_c, cand_v.abs(), sent)[1]


# test_expand_matches_jax_gather_candidates: two of CASES and the shapes at
# the edges of the card's tiling, plain version against the JAX kernel in
# interpret mode
EXPAND_CASES = {"rect_AP": CASES["rect_AP"],
                "explicit_zeros": CASES["explicit_zeros"], **TILING}


@pytest.mark.parametrize("name", list(EXPAND_CASES))
def test_expand_matches_jax_gather_candidates(name):
    a, b = EXPAND_CASES[name]()
    cc, cv = gspgemm.gather_candidates(_ell(a), _ell(b))
    jc, jv = _jax_candidates(a, b)
    assert cc.shape == jc.shape and cc.dtype == torch.int32
    np.testing.assert_array_equal(cc.numpy(), jc)
    # every candidate is one float32 product: bit-equal.  Empty slots are 0
    # here; the JAX kernel leaves some of them −0.0 (its sum of a signed
    # zero product), which no merge reads.
    real = jc < b.shape[1]
    np.testing.assert_array_equal(cv.numpy().view(np.int32)[real],
                                  jv.view(np.int32)[real])
    assert (cv.numpy().view(np.int32)[~real] == 0).all()
    assert (jv[~real] == 0).all()


@pytest.mark.parametrize("name", ["rect_AP", "explicit_zeros"])
def test_dedup_matches_jax(name):
    a, b = CASES[name]()
    _, _, _, _, jp = _jax()
    sent = b.shape[1]
    cc, cv = gspgemm.gather_candidates(_ell(a), _ell(b))
    oc, ov, on = pspgemm.dedup(cc, cv, sent)
    jc, jv, jn = (np.asarray(t) for t in jp._dedup_call(cc.numpy(), cv.numpy(), sent))
    np.testing.assert_array_equal(oc.numpy(), jc)
    np.testing.assert_array_equal(on.numpy(), jn)
    bound = ATOL + RTOL * _merge_bound(cc, cv, sent).numpy()
    assert (np.abs(ov.numpy() - jv) <= bound).all()
    np.testing.assert_array_equal(
        pspgemm.dedup(cc, cv, sent, counts_only=True).numpy(), jn)


def _hand_case():
    """tests/test_gspgemm.py's hand case: duplicates, an all-SENT row and a
    row over out_width=3."""
    sent = 100
    cand_c = torch.tensor([[3, 7, 3, sent, 9, 7],
                           [5, sent, sent, 5, 5, 5],
                           [sent] * 6,
                           [1, 2, 3, 4, 5, 6]], dtype=torch.int32)
    cand_v = torch.tensor([[1.0, 2.0, 10.0, 0.0, 4.0, 20.0],
                           [1.0, 0.0, 0.0, 1.0, 1.0, 1.0],
                           [0.0] * 6,
                           [1.0] * 6], dtype=torch.float32)
    return cand_c, cand_v, sent, 3


def _random_candidates():
    """250 rows of K = 40 candidates over 12 columns: many duplicates."""
    rng = np.random.default_rng(9)
    sent = 12
    cc = rng.integers(0, sent + 1, size=(250, 40)).astype(np.int32)
    cv = np.where(cc < sent, rng.normal(size=cc.shape), 0.0).astype(np.float32)
    return torch.from_numpy(cc), torch.from_numpy(cv), sent, 8


@pytest.mark.parametrize("make", [_hand_case, _random_candidates],
                         ids=["hand", "random"])
def test_dedup_compact_matches_jax(make):
    _, _, _, jg, _ = _jax()
    cc, cv, sent, w = make()
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, w)
    jc, jv, jn = (np.asarray(t) for t in jg._dedup_compact_call(
        cc.numpy(), cv.numpy(), sent, out_width=w))
    np.testing.assert_array_equal(on.numpy(), jn)
    np.testing.assert_array_equal(oc.numpy(), jc)
    bound = ATOL + RTOL * gspgemm._dedup_compact_plain(cc, cv.abs(), sent, w)[1]
    assert (np.abs(ov.numpy() - jv) <= bound.numpy()).all()
    if make is _hand_case:
        assert on.tolist() == [3, 1, 0, 6]
        assert oc[0].tolist() == [3, 7, 9] and ov[0].tolist() == [11.0, 22.0, 4.0]
        assert oc[3].tolist() == [1, 2, 3]


def _assert_same_sets(C: ELL, ref):
    ref = ref.tocsr()
    ref.eliminate_zeros()
    got = C.to_csr().to_scipy()
    assert got.shape == ref.shape
    assert got.nnz == ref.nnz
    d = abs(got - ref)
    assert (d.max() if d.nnz else 0.0) <= RTOL * max(abs(ref).max(), 1.0)
    # every row's columns are distinct and padding is (0, 0)
    m = C.mask()
    assert bool((C.cols[~m] == 0).all()) and bool((C.vals[~m] == 0).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_spgemm_matches_scipy(name):
    a, b = CASES[name]()
    ref = a @ b
    for C in (gspgemm.gather_spgemm(_ell(a), _ell(b)), ell_spgemm(_ell(a), _ell(b)),
              ell_spgemm_pairwise(_ell(a), _ell(b))):
        _assert_same_sets(C, ref)
    # the pairwise formulation is gather_spgemm's three steps: same layout
    C1 = gspgemm.gather_spgemm(_ell(a), _ell(b))
    C2 = ell_spgemm_pairwise(_ell(a), _ell(b))
    assert torch.equal(C1.cols, C2.cols) and torch.equal(C1.row_nnz, C2.row_nnz)


@pytest.mark.parametrize("name", ["square_poisson", "rect_AP", "rect_RAP"])
def test_ell_spgemm_bit_equal_to_jax_esc(name):
    """``ell_spgemm`` against the JAX package's ESC ``ell_spgemm`` on its
    CPU backend, on products with no zero terms: the same planes bit for
    bit; with ``sort=False`` the same operator once ``ell_prune`` has
    sorted the rows."""
    jnp, JCSR, JELL, _, _ = _jax()
    from parallel_amg_tpu.ops import ell_setup as jell

    a, b = CASES[name]()
    J = jell.ell_spgemm(*(JELL.from_csr(JCSR.from_scipy(m), dtype=jnp.float32)
                          for m in (a, b)))
    Jp = jell.ell_prune(J, tol=0.0)
    for C, ref in ((ell_spgemm(_ell(a), _ell(b)), J),
                   (ell_prune(ell_spgemm(_ell(a), _ell(b), sort=False)), Jp)):
        for mine, theirs in ((C.cols, ref.cols), (C.row_nnz, ref.row_nnz),
                             (C.vals.view(torch.int32),
                              np.asarray(ref.vals).view(np.int32))):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))


def test_strict_out_width():
    a, b = CASES["rect_AP"]()
    ref = (a @ b).tocsr()
    ref.eliminate_zeros()
    widest = int(np.diff(ref.indptr).max())
    _assert_same_sets(gspgemm.gather_spgemm(_ell(a), _ell(b), out_width=widest), ref)
    with pytest.raises(ValueError, match="out_width"):
        gspgemm.gather_spgemm(_ell(a), _ell(b), out_width=widest - 1)
    with pytest.raises(ValueError, match="out_width"):
        ell_spgemm_pairwise(_ell(a), _ell(b), out_width=widest - 1)
    C = gspgemm.gather_spgemm(_ell(a), _ell(b), out_width=widest - 1, strict=False)
    assert C.width == widest - 1
    assert int(C.row_nnz.max()) == widest - 1
    full = gspgemm.gather_spgemm(_ell(a), _ell(b))
    # clamped rows keep their first columns
    keep = torch.arange(widest - 1)[None, :] < C.row_nnz[:, None]
    assert torch.equal(torch.where(keep, full.cols[:, :widest - 1], 0), C.cols)


def test_wrapper_checks():
    a, b = CASES["rect_AP"]()
    with pytest.raises(ValueError, match="inner"):
        gspgemm.gather_candidates(_ell(b), _ell(b))
    A = _ell(a)
    with pytest.raises(TypeError):
        gspgemm.gather_candidates(ELL(A.cols, A.vals.double(), A.row_nnz, A.shape),
                                  _ell(b))
    cc, cv = gspgemm.gather_candidates(A, _ell(b))
    with pytest.raises(TypeError):
        pspgemm.dedup(cc.long(), cv, b.shape[1])
    with pytest.raises(ValueError):
        gspgemm.dedup_compact(cc, cv, b.shape[1], 0)


# -- the kernels on the card ---------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernels B3, B4 and B5 are CUDA C++ and need a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernels_match_plain(name):
    dev = _cuda()
    a, b = CASES[name]()
    A, B = _ell(a).to(dev), _ell(b).to(dev)
    sent = B.n_cols
    before = dict(pspgemm.LAUNCHES)
    cc, cv = gspgemm.gather_candidates(A, B)
    pc, pv = gspgemm._gather_candidates_plain(A, B)
    torch.cuda.synchronize()
    assert torch.equal(cc, pc) and torch.equal(cv, pv)
    oc, ov, on = pspgemm.dedup(cc, cv, sent)
    qc, qv, qn = pspgemm._dedup_plain(cc, cv, sent)
    counts = pspgemm.dedup(cc, cv, sent, counts_only=True)
    torch.cuda.synchronize()
    assert torch.equal(oc, qc) and torch.equal(on, qn) and torch.equal(counts, qn)
    assert bool(((ov - qv).abs() <= ATOL + RTOL * _merge_bound(cc, cv, sent)).all())
    w = max(int(qn.max()) - 1, 1)  # one row over out_width
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, w)
    qc, qv, qn = gspgemm._dedup_compact_plain(cc, cv, sent, w)
    bound = ATOL + RTOL * gspgemm._dedup_compact_plain(cc, cv.abs(), sent, w)[1]
    torch.cuda.synchronize()
    assert torch.equal(oc, qc) and torch.equal(on, qn)
    assert bool(((ov - qv).abs() <= bound).all())
    assert pspgemm.LAUNCHES == {"spgemm_expand": before["spgemm_expand"] + 1,
                                "spgemm_dedup": before["spgemm_dedup"] + 2,
                                "spgemm_dedup_compact": before["spgemm_dedup_compact"] + 1}
    _assert_same_sets(gspgemm.gather_spgemm(A, B).to("cpu"), a @ b)


# B3's plan per tiling case: (rows, m, k) a tile, m a work item, B's load
# width in words
TILING_PLANS = {
    "ragged_rows_K24": (84, 4, 6, 4, 4),
    "K21_Wb3": (96, 3, 7, 3, 1),
    "K45_Wb5": (44, 5, 9, 5, 1),
    "Wa40": (12, 4, 40, 4, 4),
    "three_row_tiles_K665": (3, 19, 35, 10, 1),
    "split_m_K2310": (1, 29, 70, 10, 1),
    "empty_rows_zeros": (32, 6, 10, 6, 2),
    "split_k_Wa2100": (1, 1, 2048, 1, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(TILING_CUDA))
def test_cuda_expand_tiling_matches_plain(name):
    """B3 on the card against its plain version, bit for bit, at the edges
    of its tiling; its plan as csrc/spgemm.cu::expand_plan states it."""
    dev = _cuda()
    A, B = (_ell(m).to(dev) for m in TILING_CUDA[name]())
    plan = gspgemm.expand_plan(A.width, B.width)
    assert (plan["rows_per_tile"], plan["m_per_tile"], plan["k_per_tile"],
            plan["m_per_item"], plan["b_load_words"]) == TILING_PLANS[name]
    before = pspgemm.LAUNCHES["spgemm_expand"]
    cc, cv = gspgemm.gather_candidates(A, B)
    pc, pv = gspgemm._gather_candidates_plain(A, B)
    torch.cuda.synchronize()
    assert pspgemm.LAUNCHES["spgemm_expand"] == before + 1
    assert torch.equal(cc, pc) and torch.equal(cv, pv)
    if name == "empty_rows_zeros":
        assert bool((cc == B.n_cols).all(1).any())  # rows of all SENT


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 31, 32, 33, 100, 1100, 5000, 9000])
def test_cuda_merge_wide_rows(K):
    """All three modes of the merge (B5 counting, B5 in place, B4) against
    their plain versions: around one 32-slot chunk, at config #2's K 100,
    past 4096 (the in-place and compact tables in global scratch) and past
    8192 (the count-only table in global scratch too)."""
    dev = _cuda()
    rng = np.random.default_rng(4)
    sent = 300
    cc = torch.from_numpy(rng.integers(0, sent + 1, size=(64, K)).astype(np.int32))
    cv = torch.where(cc < sent, torch.from_numpy(
        rng.normal(size=cc.shape).astype(np.float32)), 0.0)
    cc, cv = cc.to(dev), cv.to(dev)
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, 290)
    qc, qv, qn = gspgemm._dedup_compact_plain(cc, cv, sent, 290)
    bound = ATOL + RTOL * gspgemm._dedup_compact_plain(cc, cv.abs(), sent, 290)[1]
    counts = pspgemm.dedup(cc, cv, sent, counts_only=True)
    fc, fv, fn = pspgemm.dedup(cc, cv, sent)
    rc, rv, rn = pspgemm._dedup_plain(cc, cv, sent)
    torch.cuda.synchronize()
    assert torch.equal(oc, qc) and torch.equal(on, qn)
    assert bool(((ov - qv).abs() <= bound).all())
    assert torch.equal(counts, qn) and torch.equal(fn, qn) and torch.equal(fc, rc)
    assert bool(((fv - rv).abs() <= ATOL + RTOL * _merge_bound(cc, cv, sent)).all())
    _assert_b4_is_b5_compacted(cc, cv, sent, 290)


def _assert_b4_is_b5_compacted(cc, cv, sent, w):
    """B4's output equals B5's in-place merge compacted in slot order, bit
    for bit: both sum each column's values in ascending slot order."""
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, w)
    bc, bv, bn = gspgemm.compact_merged(*pspgemm.dedup(cc, cv, sent)[:2], sent, w)
    torch.cuda.synchronize()
    assert torch.equal(on, bn) and torch.equal(oc, bc)
    assert torch.equal(ov.view(torch.int32), bv.view(torch.int32))


def _b4_case(name, rng):
    """(cand_cols, cand_vals, sent, out_width) of a B4 stress case."""
    R, K, sent = 200, 100, 5000
    cols = rng.integers(0, sent, size=(R, K))
    if name == "one_column":          # every slot of a row on one column
        cols[:] = rng.integers(0, sent, size=(R, 1))
    elif name == "equal_mod_table":   # columns equal modulo the 256-slot table
        cols = 7 + 256 * rng.integers(0, 19, size=(R, K))
    elif name == "all_sent":          # every other row all SENT
        cols[::2] = sent
    cols[rng.random((R, K)) < 0.2] = sent
    vals = np.where(cols < sent, rng.normal(size=(R, K)), 0.0)
    w = 5 if name == "narrow_out" else K
    return (torch.from_numpy(cols.astype(np.int32)),
            torch.from_numpy(vals.astype(np.float32)), sent, w)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_column", "equal_mod_table", "all_sent",
                                  "narrow_out", "random"])
def test_cuda_b4_equals_b5_compacted(name):
    dev = _cuda()
    cc, cv, sent, w = _b4_case(name, np.random.default_rng(21))
    cc, cv = cc.to(dev), cv.to(dev)
    _assert_b4_is_b5_compacted(cc, cv, sent, w)
    oc, ov, on = gspgemm.dedup_compact(cc, cv, sent, w)
    qc, qv, qn = gspgemm._dedup_compact_plain(cc, cv, sent, w)
    assert torch.equal(oc, qc) and torch.equal(on, qn)
    if name == "narrow_out":
        assert int(on.max()) > w
    if name == "all_sent":
        assert not bool(on[::2].any()) and not bool(oc[::2].any())
