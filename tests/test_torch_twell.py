"""The port's TWELL against the JAX package's Pallas TWELL.

On the CPU the port's TWELL.matvec runs its plain torch version and the JAX
TWELL.matvec runs its Pallas kernel in interpret mode.  Tolerance rtol 2e-4,
atol 2e-5: the JAX package's own TWELL tolerance (tests/test_formats_fast.py);
the two sum each row in another order.  The CUDA case holds the kernel
against the plain version on the card: |Δy| ≤ 1e-6 + 1e-5·(|A|·|x|), the
bound of two float32 sums of the same products taken in another order.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import twell
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.twell import TWELL, _matvec_plain
from parallel_amg_tpu_torch.oracle import oracle_setup
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

RTOL, ATOL = 2e-4, 2e-5


def _random(n_rows, n_cols, density, seed, diag=False):
    rng = np.random.default_rng(seed)
    m = sp.random(n_rows, n_cols, density=density,
                  random_state=np.random.RandomState(seed), format="csr")
    m.data[:] = rng.normal(size=m.nnz).astype(np.float32)
    if diag:
        m = m + sp.identity(n_rows)
    return m.tocsr()


def _long_row():
    """A row with 40 entries inside one 128-column window (the JAX TWELL's
    slot-overflow case)."""
    n = 140
    row = np.zeros(n)
    row[:40] = np.random.default_rng(1).normal(size=40).astype(np.float32)
    return sp.csr_matrix(np.eye(n) + np.outer(np.eye(n)[:, 3], row))


@functools.cache
def _rs_levels():
    A = poisson2d(48).to_csr().to_scipy()
    cfg = AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=64,
                    interpolation="extended_i")
    return oracle_setup(A, cfg).levels


def _mixed_long_rows():
    """300 rows of 0–20 entries with three rows longer than the kernel's
    shared-memory capacity (the long-row path) and one just under it."""
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 21, size=300)
    lengths[[7, 150, 299]] = [5000, 9000, twell.STREAM_CAP + 1]
    lengths[200] = twell.LONG_ROW
    rows = np.repeat(np.arange(300), lengths)
    cols = np.concatenate([rng.choice(12000, size=n, replace=False) for n in lengths])
    vals = rng.normal(size=rows.size).astype(np.float32)
    return sp.csr_matrix((vals, (rows, cols)), shape=(300, 12000))


# shapes the plan must cut right besides CASES
EDGE_CASES = {
    "zero_rows": lambda: sp.csr_matrix((0, 4)),
    "one_row": lambda: sp.csr_matrix(([1.0, 2.0, 3.0], ([0, 0, 0], [1, 4, 8])),
                                     shape=(1, 10)),
    "empty_rows": lambda: sp.csr_matrix(([1.0, 2.0], ([0, 3], [1, 4])), shape=(5, 6)),
    "all_empty_5000": lambda: sp.csr_matrix((5000, 3)),
    "one_entry_rows_5000": lambda: sp.identity(5000, format="csr"),
    "long_rows_mixed": _mixed_long_rows,
}

CASES = {
    "random_square": lambda: _random(500, 500, 0.02, 6, diag=True),
    "random_rect": lambda: _random(330, 97, 0.05, 8),
    "long_row": _long_row,
    "rs_A1": lambda: _rs_levels()[1].A,
    "rs_P0": lambda: _rs_levels()[0].P,
    "rs_R0": lambda: _rs_levels()[0].R,
}


def _jax():
    """The JAX side, imported per test: the CUDA case also runs on a machine
    without JAX (``pytest -m cuda --noconftest``)."""
    jnp = pytest.importorskip("jax.numpy")
    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.twell import TWELL as JTWELL
    return jnp, JCSR, JTWELL


def _both(m, dtype):
    jnp, JCSR, JTWELL = _jax()
    m = m.tocsr()
    m.sort_indices()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return (TWELL.from_csr(CSR.from_scipy(m), dtype=dtype),
            JTWELL.from_csr(JCSR.from_scipy(m), dtype=jdtype), jnp)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_twell_plain_matches_jax_pallas(name, dtype):
    m = CASES[name]()
    tw, jtw, jnp = _both(m, dtype)
    x = np.random.default_rng(2).normal(size=m.shape[1]).astype(np.float32)
    y = tw.matvec(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (m.shape[0],)
    np.testing.assert_allclose(y.numpy(), np.asarray(jtw.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twell_roundtrip_diagonal_matmat(name):
    m = CASES[name]().tocsr()
    m.sort_indices()
    csr = CSR.from_scipy(m)
    tw, jtw, jnp = _both(m, torch.float32)
    back = tw.to_csr()
    np.testing.assert_array_equal(back.indptr, csr.indptr)
    np.testing.assert_array_equal(back.indices, csr.indices)
    np.testing.assert_array_equal(back.data, csr.data.astype(np.float32))
    assert tw.nnz == csr.nnz and tw.shape == csr.shape
    assert tw.indptr.dtype == tw.indices.dtype == torch.int32
    np.testing.assert_allclose(tw.diagonal().numpy(), np.asarray(jtw.diagonal()),
                               rtol=1e-6, atol=1e-7)
    X = np.random.default_rng(3).normal(size=(m.shape[1], 2)).astype(np.float32)
    np.testing.assert_allclose(tw.matmat(torch.from_numpy(X)).numpy(),
                               np.asarray(jtw.matmat(jnp.asarray(X))),
                               rtol=RTOL, atol=ATOL)


def test_twell_edge_shapes_and_checks():
    empty_rows = sp.csr_matrix(([1.0, 2.0], ([0, 3], [1, 4])), shape=(5, 6))
    tw = TWELL.from_csr(CSR.from_scipy(empty_rows))
    x = torch.arange(6, dtype=torch.float32)
    np.testing.assert_array_equal(tw.matvec(x).numpy(), [1.0, 0, 0, 8.0, 0])
    none = TWELL.from_csr(CSR.from_scipy(sp.csr_matrix((0, 4))))
    assert none.matvec(torch.zeros(4)).shape == (0,)
    with pytest.raises(ValueError):
        tw.matvec(torch.zeros(5))
    with pytest.raises(TypeError):
        tw.matvec(torch.zeros(6, dtype=torch.float64))
    with pytest.raises(TypeError):
        TWELL.from_csr(CSR.from_scipy(empty_rows), dtype=torch.float64)
    # the plan rides along: from_csr builds it, .to carries it
    assert tw.blocks.tolist() == [0, 5] and tw.to("cpu").blocks is tw.blocks
    assert none.blocks.tolist() == [0] and none.n_blocks == 0


@pytest.mark.parametrize("name", sorted(CASES) + sorted(EDGE_CASES))
def test_row_blocks_plan(name):
    m = {**CASES, **EDGE_CASES}[name]().tocsr()
    tw = TWELL.from_csr(CSR.from_scipy(m))
    blocks = twell.row_blocks(tw.indptr)
    assert torch.equal(blocks, tw.blocks) and blocks.dtype == torch.int32
    first = blocks.long()
    # every row in exactly one block: block starts rise from 0 to n_rows
    assert int(first[0]) == 0 and int(first[-1]) == m.shape[0]
    assert bool((first.diff() > 0).all())
    ptr = torch.from_numpy(m.indptr.astype(np.int64))
    nnz, rows = ptr[first[1:]] - ptr[first[:-1]], first.diff()
    # a block of several rows fits the kernel's shared memory; only a row
    # longer than LONG_ROW is a block alone, and it may pass the capacity
    assert bool((nnz[rows > 1] <= twell.STREAM_CAP).all())
    assert bool((rows <= twell.BLOCK_ROWS).all())
    lengths = ptr.diff()
    long_rows = torch.nonzero(lengths > twell.LONG_ROW).flatten()
    starts = set(first[:-1].tolist())
    assert all(int(r) in starts and int(r) + 1 in set(first.tolist())
               for r in long_rows)
    if name == "long_rows_mixed":
        assert bool((nnz > twell.STREAM_CAP).any())
        np.testing.assert_allclose(
            tw.matvec(torch.ones(m.shape[1])).numpy(), m @ np.ones(m.shape[1]),
            rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_twell_cuda_kernel_matches_plain(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("the TWELL kernel is CUDA C++ and needs a CUDA card")
    m = CASES[name]().tocsr()
    m.sort_indices()
    tw = TWELL.from_csr(CSR.from_scipy(m), dtype=dtype).to("cuda")
    x = torch.from_numpy(
        np.random.default_rng(4).normal(size=m.shape[1]).astype(np.float32)).cuda()
    before = twell.LAUNCHES
    y = tw.matvec(x)
    torch.cuda.synchronize()
    assert twell.LAUNCHES == before + 1
    ref = _matvec_plain(tw, x)
    bound = 1e-6 + 1e-5 * _matvec_plain(
        TWELL(tw.indptr, tw.indices, tw.vals.abs(), tw.shape, tw.blocks), x.abs())
    assert bool(((y - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_twell_cuda_long_rows_bit_equal_calls(dtype):
    """Rows past the kernel's shared-memory capacity (its long-row path)
    among short ones, against plain; y bit-equal over 20 calls."""
    if not torch.cuda.is_available():
        pytest.skip("the TWELL kernel is CUDA C++ and needs a CUDA card")
    m = _mixed_long_rows()
    tw = TWELL.from_csr(CSR.from_scipy(m), dtype=dtype).to("cuda")
    x = torch.from_numpy(
        np.random.default_rng(6).normal(size=m.shape[1]).astype(np.float32)).cuda()
    y = tw.matvec(x)
    ref = _matvec_plain(tw, x)
    bound = 1e-6 + 1e-5 * _matvec_plain(
        TWELL(tw.indptr, tw.indices, tw.vals.abs(), tw.shape, tw.blocks), x.abs())
    torch.cuda.synchronize()
    assert bool(((y - ref).abs() <= bound).all())
    for _ in range(20):
        assert torch.equal(tw.matvec(x).view(torch.int32), y.view(torch.int32))
