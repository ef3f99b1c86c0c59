"""Kernels B6 (block SpMV) and B7 (multi-RHS flattened-diagonal product):
the port's BSR, BTWELL, ``Stencil.matmat`` and ``dia_spmm`` against the JAX
package on the same numpy inputs, made from a seed.

On the CPU the port runs each kernel's plain torch version; the JAX BTWELL
and ``dia_spmm`` run their Pallas kernels in interpret mode, as the JAX
package's own tests run them.  Tolerances: rtol 3e-5 and atol 3e-6·max|y|
for block products (float32 on both sides, sums in another order, as
tests/test_vector_bsr.py holds BTWELL), rtol 1e-5 / atol 1e-5 for stencil
products; layouts, block columns and pure data movement must be equal.  The
CUDA cases hold each kernel against its plain version on the card:
|Δy| ≤ 1e-6 + 1e-5·(|A|·|x|), two float32 sums of the same products.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax.numpy as jnp

    from parallel_amg_tpu.ops.bsr import BSR as JBSR
    from parallel_amg_tpu.ops.btwell import (
        BTWELL as JBTWELL,
        btwell_from_kron_stencil as j_btwell_from_kron_stencil,
    )
    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.flatdia import FlatDIA as JFlatDIA
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu.problems.elasticity import (
        coupled_laplacian as j_coupled_laplacian,
    )
except ImportError:  # a machine without JAX runs the cuda cases only
    jnp = None

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.ops import bsr as bsr_mod
from parallel_amg_tpu_torch.ops import flatdia
from parallel_amg_tpu_torch.ops.bsr import BSR, launch_args, plane_offsets
from parallel_amg_tpu_torch.ops.btwell import BTWELL, btwell_from_kron_stencil
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA, dia_spmm
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.problems import (
    coupled_laplacian,
    coupled_laplacian_scipy,
    poisson_stencil,
)

torch.set_num_threads(2)

B_RTOL, B_ATOL = 3e-5, 3e-6
S_RTOL, S_ATOL = 1e-5, 1e-5


def _need_jax():
    if jnp is None:
        pytest.skip("the JAX package is not installed")


def _random_blocks(seed, RB=50, bs=3, empty_rows=(7, 8, 30)):
    """A random block matrix (the pattern of tests/test_vector_bsr.py:81-86)
    with a few empty block rows and some all-zero stored blocks."""
    rng = np.random.default_rng(seed)
    pat = sp.random(RB, RB, density=0.15, random_state=2, format="csr")
    pat = (pat + sp.identity(RB)).tolil()
    for r in empty_rows:
        pat[r, :] = 0
    pat = pat.tocsr()
    pat.eliminate_zeros()
    pat.data[:] = 1.0
    K = sp.kron(pat, np.ones((bs, bs))).tocsr()
    K.data = rng.normal(size=K.nnz)
    # two stored blocks of block row 0 hold zeros (kept as stored entries)
    rows = np.repeat(np.arange(K.shape[0]), np.diff(K.indptr)) // bs
    zero = pat.indices[pat.indptr[0]:pat.indptr[0] + 2]
    K.data[(rows == 0) & np.isin(K.indices // bs, zero)] = 0.0
    return K


def _close(y, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(y), ref, rtol=B_RTOL,
                               atol=B_ATOL * max(np.abs(ref).max(), 1e-30))


# -- B6: BSR and BTWELL --------------------------------------------------------

def test_bsr_from_csr_matches_jax_layout_and_scipy():
    _need_jax()
    K = _random_blocks(0)
    bsr = BSR.from_csr(CSR.from_scipy(K), 3)
    jb = JBSR.from_csr(JCSR.from_scipy(K), 3)
    np.testing.assert_array_equal(bsr.bcols.numpy(), np.asarray(jb.bcols).T)
    np.testing.assert_array_equal(bsr.vals.numpy(),
                                  np.stack([np.asarray(v) for v in jb.vals]))
    np.testing.assert_array_equal(bsr.brow_nnz.numpy(), np.asarray(jb.brow_nnz))
    assert bsr.nnz == int(jb.nnz) and bsr.vals_nbytes == jb.vals_nbytes
    x = np.random.default_rng(1).normal(size=K.shape[1]).astype(np.float32)
    _close(bsr.matvec(torch.from_numpy(x)).numpy(), K @ x)
    _close(bsr.matvec(torch.from_numpy(x)).numpy(),
           jb.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(bsr.diagonal().numpy(), K.diagonal(), rtol=1e-6)
    d = abs(bsr.to_csr().to_scipy() - K)
    assert (d.max() if d.nnz else 0.0) < 1e-6  # float32 values


def test_btwell_matches_jax_random_blocks():
    """BTWELL drops the zero blocks and packs rows; matvec, matvec_planes,
    diagonal and the round trip against JAX's BTWELL in interpret mode."""
    _need_jax()
    K = _random_blocks(3)
    bsr = BSR.from_csr(CSR.from_scipy(K), 3)
    bt = BTWELL.from_bsr(bsr)
    jbt = JBTWELL.from_bsr(JBSR.from_csr(JCSR.from_scipy(K), 3))
    assert bt.nnz == int(jbt.nnz) == bsr.nnz
    live = bt.brow_nnz.numpy()
    assert live.sum() * 9 == bt.nnz and live.max() == bt.width
    assert (live[[7, 8, 30]] == 0).all() and live[0] < bsr.brow_nnz.numpy()[0]
    x = np.random.default_rng(4).normal(size=K.shape[1]).astype(np.float32)
    y = bt.matvec(torch.from_numpy(x)).numpy()
    _close(y, K @ x)
    _close(y, jbt.matvec(jnp.asarray(x)))
    xp = np.ascontiguousarray(x.reshape(-1, 3).T)
    yp = bt.matvec_planes(torch.from_numpy(xp))
    assert tuple(yp.shape) == (3, bt.n_block_rows)
    _close(yp.numpy(), jbt.matvec_planes(jnp.asarray(xp)))
    np.testing.assert_allclose(bt.diagonal().numpy(), np.asarray(jbt.diagonal()),
                               rtol=1e-6, atol=1e-7)
    d = abs(bt.to_bsr().to_csr().to_scipy() - K)
    assert (d.max() if d.nnz else 0.0) < 1e-6  # float32 values


def test_btwell_from_block_entries_kron_pair():
    K = _random_blocks(5)
    bsr = BSR.from_csr(CSR.from_scipy(K), 3)
    w, r = np.nonzero(np.arange(bsr.width)[:, None] < bsr.brow_nnz.numpy()[None])
    blocks = bsr.vals.numpy().reshape(bsr.width, 9, -1)[w, :, r].reshape(-1, 3, 3)
    bt = BTWELL.from_block_entries(r, bsr.bcols.numpy()[w, r], blocks, K.shape, 3)
    d = abs(bt.to_csr().to_scipy() - K)
    assert (d.max() if d.nnz else 0.0) < 1e-6  # float32 values
    C = np.array([[2.0, 0.5], [0.5, 1.0]])
    s = np.array([1.0, -2.0, 3.0], np.float32)
    kt = BTWELL.from_block_entries([0, 0, 1], [1, 0, 1], (s, C), (4, 4), 2)
    want = np.kron(np.array([[-2.0, 1.0], [0.0, 3.0]]), C)
    np.testing.assert_allclose(kt.to_csr().to_dense(), want, rtol=1e-6)


def test_btwell_from_kron_stencil_matches_jax_and_scipy():
    _need_jax()
    dims, bs, gamma = (9, 7, 6), 3, 0.3
    L, C = coupled_laplacian(dims, bs, gamma, device="cpu")
    A_sp = coupled_laplacian_scipy(dims, bs, gamma)
    bt = btwell_from_kron_stencil(L, C)
    jL, _ = j_coupled_laplacian(dims, bs, gamma)
    jbt = j_btwell_from_kron_stencil(jL, C)
    assert bt.nnz == A_sp.nnz == int(jbt.nnz)
    assert bt.width == 7 and int(bt.brow_nnz.min()) == 4  # corners lose 3
    x = np.random.default_rng(6).normal(size=A_sp.shape[1]).astype(np.float32)
    y = bt.matvec(torch.from_numpy(x)).numpy()
    _close(y, A_sp @ x)
    _close(y, jbt.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(bt.diagonal().numpy(), A_sp.diagonal(), rtol=1e-6)


def test_plane_offsets_are_64_bit_past_2_31():
    """The builders' and the kernel's plane offsets at shapes past 2^31
    elements, computed without allocating the planes."""
    bs, WB = 3, 7
    for RB in (34_012_224, 40_000_000):  # 324³ nodes, and one past 2^31
        last = plane_offsets([WB - 1], [bs * bs - 1], [RB - 1], RB, bs)
        assert last.dtype == torch.int64
        assert int(last) == WB * bs * bs * RB - 1
    assert int(last) > 2**31
    # the kernel's arguments from tensors that hold no memory
    meta = dict(device="meta")
    bcols = torch.empty((WB, RB), dtype=torch.int32, **meta)
    vals = torch.empty((WB * bs * bs, RB), dtype=torch.float32, **meta)
    nnz = torch.empty((RB,), dtype=torch.int32, **meta)
    xp = torch.empty((bs, RB), dtype=torch.float32, **meta)
    args = launch_args(bcols, vals, nnz, xp.T, xp.T, bs, RB)
    assert args[5:] == (RB, WB, bs, RB, 1, RB, 1, RB)
    assert vals.numel() == WB * bs * bs * RB > 2**31
    import ctypes

    fn_types = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_longlong] * 5
    assert all(t(a).value == a for t, a in zip(fn_types, args[5:]))


# -- B7: Stencil.matmat, dia_spmm, FlatDIA.matmat ------------------------------

def _random_stencil(dims, seed, offgrid=False):
    st = poisson_stencil(dims, device="cpu")
    rng = np.random.default_rng(seed)
    w = (st.weights.numpy() * rng.uniform(0.5, 2.0, size=st.weights.shape))
    if offgrid:  # every weight nonzero, off the grid too
        w = rng.uniform(0.5, 2.0, size=st.weights.shape) * np.sign(w + 0.1)
    return st.offsets, w.astype(np.float32)


@pytest.mark.parametrize("k", [1, 3, 8])
def test_stencil_matmat_and_dia_spmm_match_jax(k):
    _need_jax()
    dims = (7, 6, 5)
    offs, w = _random_stencil(dims, 10 + k)
    st, jst = Stencil(torch.from_numpy(w), offs, dims), JStencil(jnp.asarray(w), offs, dims)
    X = np.random.default_rng(20 + k).normal(size=dims + (k,)).astype(np.float32)
    Y = st.matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, np.asarray(jst.matmat(jnp.asarray(X))),
                               rtol=S_RTOL, atol=S_ATOL)
    fd, jfd = FlatDIA.from_stencil(st), JFlatDIA.from_stencil(jst)
    Xf = X.reshape(-1, k)
    Yd = dia_spmm(fd.diags, fd.offsets, torch.from_numpy(Xf)).numpy()
    np.testing.assert_allclose(Yd, np.asarray(jfd.matmat(jnp.asarray(Xf))),
                               rtol=S_RTOL, atol=S_ATOL)
    np.testing.assert_allclose(fd.matmat(torch.from_numpy(X)).numpy(), Y,
                               rtol=S_RTOL, atol=S_ATOL)
    # the planes B7 reads on the card give the same product
    planes, poffs = st.flat_planes()
    np.testing.assert_allclose(
        dia_spmm(planes, poffs, torch.from_numpy(Xf)).numpy().reshape(Y.shape), Y,
        rtol=S_RTOL, atol=S_ATOL)


def test_matmat_offgrid_weights_masked_planes():
    """A Stencil whose weights are nonzero where the neighbor leaves the
    grid: the padded product ignores them, the flattened planes must be
    masked to agree (unmasked, they wrap onto the next grid line)."""
    _need_jax()
    dims = (6, 5, 4)
    offs, w = _random_stencil(dims, 30, offgrid=True)
    st, jst = Stencil(torch.from_numpy(w), offs, dims), JStencil(jnp.asarray(w), offs, dims)
    X = np.random.default_rng(31).normal(size=dims + (3,)).astype(np.float32)
    Y = st.matmat(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(Y, np.asarray(jst.matmat(jnp.asarray(X))),
                               rtol=S_RTOL, atol=S_ATOL)
    planes, poffs = st.flat_planes()
    assert st.flat_planes()[0] is planes  # built once, kept
    Yf = dia_spmm(planes, poffs, torch.from_numpy(X.reshape(-1, 3))).numpy()
    np.testing.assert_allclose(Yf.reshape(Y.shape), Y, rtol=S_RTOL, atol=S_ATOL)
    raw = FlatDIA.from_stencil(st)
    assert not np.allclose(raw.matmat(torch.from_numpy(X)).numpy(), Y,
                           rtol=S_RTOL, atol=S_ATOL)
    # the masked planes: zero off the grid, the weights on it
    p = planes.numpy().reshape((len(poffs),) + dims)
    for d, off in enumerate(offs):
        ok = st._in_grid(off).numpy()
        np.testing.assert_array_equal(p[d][ok], w[d][ok])
        assert not p[d][~ok].any()


def test_flat_planes_alias_and_share():
    """Aliased planes on a tiny grid are summed; a stencil that is already
    zero off the grid lends its own weights (no copy)."""
    dims, offs = (4, 3), ((0, 0), (0, 3), (1, 0))
    w = np.random.default_rng(40).normal(size=(3,) + dims).astype(np.float32)
    st = Stencil(torch.from_numpy(w), offs, dims)
    planes, poffs = st.flat_planes()
    assert poffs == (0, 3)
    X = np.random.default_rng(41).normal(size=dims + (2,)).astype(np.float32)
    np.testing.assert_allclose(
        dia_spmm(planes, poffs, torch.from_numpy(X.reshape(-1, 2))).numpy(),
        st.matmat(torch.from_numpy(X)).numpy().reshape(-1, 2), rtol=1e-6, atol=1e-6)
    p7 = poisson_stencil((5, 4, 3), device="cpu")
    assert p7.flat_planes()[0].data_ptr() == p7.weights.data_ptr()


def test_matmat_plain_float64():
    """The plain version takes float64 (the true-residual check); the
    kernel route raises for it."""
    offs, w = _random_stencil((5, 4), 50)
    st = Stencil(torch.from_numpy(w).double(), offs, (5, 4))
    X = torch.from_numpy(np.random.default_rng(51).normal(size=(5, 4, 3)))
    Y = st._matmat_plain(X)
    A = st.to_csr().to_scipy()
    np.testing.assert_allclose(Y.numpy().reshape(-1, 3), A @ X.numpy().reshape(-1, 3),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        dia_spmm(st.weights.reshape(len(offs), -1), (0,) * len(offs),
                 X.reshape(-1, 3))


# -- the kernels on the card ---------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernels B6 and B7 are CUDA C++ and need a CUDA card")
    return torch.device("cuda")


def _b6_cases():
    L, C = coupled_laplacian((12, 11, 10), 3, 0.3, device="cpu")
    from parallel_amg_tpu_torch.ops.bstencil import bsr_from_kron_stencil

    K = _random_blocks(60, RB=400)
    return {"kron": bsr_from_kron_stencil(L, C),
            "kron_btwell": btwell_from_kron_stencil(L, C),
            "random_empty_rows": BSR.from_csr(CSR.from_scipy(K), 3),
            "bs2": BSR.from_csr(CSR.from_scipy(sp.random(
                90, 70, density=0.05, random_state=7, format="csr")), 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["kron", "kron_btwell", "random_empty_rows", "bs2"])
def test_bsr_cuda_kernel_matches_plain(name, dtype):
    dev = _cuda()
    A = _b6_cases()[name]
    A = type(A)(A.bcols, A.vals.to(dtype), A.brow_nnz, A.shape, A.bs).to(dev)
    x = torch.from_numpy(np.random.default_rng(61).normal(
        size=A.n_block_cols * A.bs).astype(np.float32)).to(dev)
    xb = x.reshape(-1, A.bs)
    before = bsr_mod.LAUNCHES
    y = A.matvec(x)
    yp = BTWELL.matvec_planes(A, xb.T.contiguous())
    torch.cuda.synchronize()
    assert bsr_mod.LAUNCHES == before + 2
    ref = bsr_mod._matvec_plain(A.bcols, A.vals, A.bs, xb)
    bound = 1e-6 + 1e-5 * bsr_mod._matvec_plain(A.bcols, A.vals.abs(), A.bs, xb.abs())
    assert bool(((y.reshape(-1, A.bs) - ref).abs() <= bound).all())
    assert bool(((yp.T - ref).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 11])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dia_spmm_cuda_kernel_matches_plain(k, dtype):
    dev = _cuda()
    offs, w = _random_stencil((20, 17, 13), 70, offgrid=True)
    st = Stencil(torch.from_numpy(w).to(dtype), offs, (20, 17, 13)).to(dev)
    X = torch.from_numpy(np.random.default_rng(71).normal(
        size=(20, 17, 13, k)).astype(np.float32)).to(dev)
    before = flatdia.LAUNCHES["flatdia_spmm"]
    Y = st.matmat(X)
    torch.cuda.synchronize()
    assert flatdia.LAUNCHES["flatdia_spmm"] == before + -(-k // flatdia.MAX_COLS)
    ref = st._matmat_plain(X)
    bound = 1e-6 + 1e-5 * Stencil(st.weights.abs(), offs, st.dims)._matmat_plain(X.abs())
    assert bool(((Y - ref).abs() <= bound).all())


@pytest.mark.cuda
def test_dia_spmm_cuda_wide_operator():
    """201 offsets: two launches per column chunk, the second accumulates."""
    dev = _cuda()
    offsets = tuple(range(-100, 100)) + (150,)
    rng = np.random.default_rng(72)
    W = torch.from_numpy(rng.normal(size=(201, 400)).astype(np.float32)).to(dev)
    X = torch.from_numpy(rng.normal(size=(400, 3)).astype(np.float32)).to(dev)
    before = flatdia.LAUNCHES["flatdia_spmm"]
    Y = dia_spmm(W, offsets, X)
    torch.cuda.synchronize()
    assert flatdia.LAUNCHES["flatdia_spmm"] == before + 2
    ref = flatdia._matmat_plain(W, offsets, X)
    bound = 1e-6 + 1e-5 * flatdia._matmat_plain(W.abs(), offsets, X.abs())
    assert bool(((Y - ref).abs() <= bound).all())


_VECTOR_CFG = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                            smoother="chebyshev", n_coarse_max=48,
                            on_device_setup=True)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["bsr", "btwell", "bstencil"])
def test_vector_setup_on_the_card_matches_the_cpu(fmt):
    """setup_vector_kron on the card: B6 and B7 carry the solve, and the
    iteration count is the CPU run's."""
    _cuda()
    dims = (15, 15, 15)
    b = np.random.default_rng(10).normal(size=int(np.prod(dims)) * 3).astype(np.float32)
    iters = {}
    for dev in ("cpu", "cuda"):
        L, C = coupled_laplacian(dims, 3, 0.3, device=dev)
        h = ptt.setup_vector_kron(L, C, _VECTOR_CFG, fine_format=fmt)
        bsr_mod.LAUNCHES = 0
        flatdia.LAUNCHES["flatdia_spmm"] = 0
        res = ptt.amg_pcg(None, h, torch.from_numpy(b).to(dev), tol=1e-6, maxiter=60)
        assert res.converged
        iters[dev] = res.iters
        if dev == "cuda":
            assert flatdia.LAUNCHES["flatdia_spmm"] > 0
            assert (bsr_mod.LAUNCHES > 0) == (fmt != "bstencil")
    assert iters["cuda"] == iters["cpu"]
