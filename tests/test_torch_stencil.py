"""The port's Stencil, FlatDIA, block transfers and stencil problems against
the JAX package on the same numpy inputs, made from a seed.

On the CPU the port's FlatDIA runs its plain torch version; the JAX FlatDIA
runs its Pallas kernel in interpret mode, as tests/test_flatdia.py runs it.
Tolerances: rtol 1e-5 / atol 1e-5 for products (float32 on both sides, sums
in another order); problem planes and pure data movement (reshapes, pads,
shifts, one-term bucket sums) must be equal bit for bit.  The CUDA cases hold
kernel B2 against its plain version on the card:
|Δy| ≤ 1e-6 + 1e-5·(|W|·|x|), two float32 sums of the same products.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax.numpy as jnp

    from parallel_amg_tpu.amg import transfers as jtransfers
    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.dia import DIA as JDIA
    from parallel_amg_tpu.ops.flatdia import FlatDIA as JFlatDIA
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu.problems.stencil_problems import (
        anisotropic_stencil as j_anisotropic_stencil,
        poisson_stencil as j_poisson_stencil,
    )
except ImportError:  # a machine without JAX runs the cuda cases only
    jnp = None

from parallel_amg_tpu_torch import device as port_device
from parallel_amg_tpu_torch.amg import transfers
from parallel_amg_tpu_torch.ops import flatdia
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA, dia_spmv, _matvec_plain
from parallel_amg_tpu_torch.ops.stencil import Stencil, bucket_add
from parallel_amg_tpu_torch.problems import (
    anisotropic_stencil,
    poisson3d,
    poisson_stencil,
)

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-5
DIMS = [(12, 9), (6, 7, 5), (64,)]


def _random_stencils(dims, seed):
    """A variable-coefficient Poisson-like stencil (zero where the neighbor
    leaves the grid) in both packages (the port's alone without JAX), from
    the same numpy planes."""
    st = poisson_stencil(dims, device="cpu")
    rng = np.random.default_rng(seed)
    w = st.weights.numpy() * rng.uniform(0.5, 2.0, size=st.weights.shape)
    w = w.astype(np.float32)
    return (Stencil(torch.from_numpy(w), st.offsets, dims),
            None if jnp is None else JStencil(jnp.asarray(w), st.offsets, dims))


def _aliased_stencils(seed):
    """(0, 3) aliases (1, 0) once flattened on a 3-wide grid."""
    dims = (4, 3)
    offs = ((0, 0), (1, 0), (0, 3))
    w = np.random.default_rng(seed).normal(size=(3,) + dims).astype(np.float32)
    for d, o in enumerate(offs):
        for i in range(dims[0]):
            for j in range(dims[1]):
                if not (0 <= i + o[0] < dims[0] and 0 <= j + o[1] < dims[1]):
                    w[d, i, j] = 0.0
    return (Stencil(torch.from_numpy(w), offs, dims),
            None if jnp is None else JStencil(jnp.asarray(w), offs, dims))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# -- problems --------------------------------------------------------------

@pytest.mark.parametrize("name,dims", [("poisson", (12, 12)), ("poisson", (7, 8, 9)),
                                       ("poisson", (5,)), ("anisotropic", (10, 11))])
def test_problem_planes_bit_equal(name, dims):
    if name == "poisson":
        mine, theirs = poisson_stencil(dims, device="cpu"), j_poisson_stencil(dims)
    else:
        mine = anisotropic_stencil(dims, epsilon=1e-3, device="cpu")
        theirs = j_anisotropic_stencil(dims, epsilon=1e-3)
    assert mine.offsets == theirs.offsets and mine.dims == theirs.dims
    assert mine.weights.dtype == torch.float32
    np.testing.assert_array_equal(mine.weights.numpy(), np.asarray(theirs.weights))


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        poisson_stencil((4, 4))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        port_device.resolve_device(None)
    assert port_device.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert port_device.resolve_device(None) == torch.device("cuda")


# -- Stencil ---------------------------------------------------------------

def test_stencil_from_csr_to_csr_match_jax():
    m = poisson3d(5, 6, 4).to_csr().to_scipy()
    m = m + sp.diags(np.linspace(0.1, 1.0, m.shape[0]))  # variable diagonal
    m = m.tocsr()
    m.sort_indices()
    dims = (5, 6, 4)
    mine = Stencil.from_csr(CSR.from_scipy(m), dims)
    theirs = JStencil.from_csr(JCSR.from_scipy(m), dims)
    assert mine.offsets == theirs.offsets
    np.testing.assert_array_equal(mine.weights.numpy(), np.asarray(theirs.weights))
    a, b = mine.to_csr(), theirs.to_csr()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, np.asarray(b.data))
    assert mine.nnz == int(theirs.nnz)
    assert Stencil.from_csr(CSR.from_scipy(m), dims, max_points=3) is None


@pytest.mark.parametrize("dims", DIMS)
def test_stencil_matvec_matches_jax(dims):
    st, jst = _random_stencils(dims, 1)
    x = _x(dims, 2)
    np.testing.assert_allclose(st.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jst.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(st.diagonal().numpy(), np.asarray(jst.diagonal()))


@pytest.mark.parametrize("dims", DIMS)
def test_stencil_algebra_matches_jax(dims):
    a, ja = _random_stencils(dims, 4)
    b, jb = _random_stencils(dims, 5)
    s = np.random.default_rng(6).uniform(0.5, 2.0, size=dims).astype(np.float32)
    off = tuple(1 if i == 0 else -1 for i in range(len(dims)))
    np.testing.assert_array_equal(a.shifted_plane(1, off).numpy(),
                                  np.asarray(ja.shifted_plane(1, off)))
    np.testing.assert_array_equal(a.scale_rows(torch.from_numpy(s)).weights.numpy(),
                                  np.asarray(ja.scale_rows(jnp.asarray(s)).weights))
    np.testing.assert_array_equal(a.scale_cols(torch.from_numpy(s)).weights.numpy(),
                                  np.asarray(ja.scale_cols(jnp.asarray(s)).weights))
    added, jadded = a.add(b, alpha=0.5), ja.add(jb, alpha=0.5)
    assert added.offsets == jadded.offsets
    np.testing.assert_allclose(added.weights.numpy(), np.asarray(jadded.weights),
                               rtol=RTOL, atol=ATOL)
    prod, jprod = a.matmul(b), ja.matmul(jb)
    assert prod.offsets == jprod.offsets
    np.testing.assert_allclose(prod.weights.numpy(), np.asarray(jprod.weights),
                               rtol=RTOL, atol=ATOL)
    ref = a.to_csr().to_scipy() @ b.to_csr().to_scipy()
    np.testing.assert_allclose(prod.to_csr().to_dense(), ref.toarray(),
                               rtol=1e-4, atol=1e-5)
    keep = [d % 2 == 0 for d in range(a.n_points)]
    pruned, jpruned = a.prune(keep), ja.prune(keep)
    assert pruned.offsets == jpruned.offsets
    np.testing.assert_array_equal(pruned.weights.numpy(), np.asarray(jpruned.weights))


def test_bucket_add_sums_duplicates_in_order():
    terms = torch.tensor([[1.0, 2.0], [10.0, 20.0], [100.0, 200.0], [5.0, 6.0]])
    acc = bucket_add(torch.zeros(3, 2), [2, 0, 2, 2], terms)
    np.testing.assert_array_equal(acc.numpy(), [[10, 20], [0, 0], [106, 208]])
    assert bucket_add(torch.ones(2, 2), [], torch.zeros(0, 2)).sum() == 4


# -- FlatDIA (plain version on the CPU) ----------------------------------------

@pytest.mark.parametrize("dims", DIMS)
def test_flatdia_plain_matches_jax_pallas(dims):
    st, jst = _random_stencils(dims, 7)
    fd, jfd = FlatDIA.from_stencil(st), JFlatDIA.from_stencil(jst)
    assert fd.offsets == jfd.offsets and fd.nd_offsets == jfd.nd_offsets
    assert tuple(fd.diags.shape) == (fd.n_points, st.n)  # no tile padding
    x = _x(dims, 8)
    y = fd.matvec(torch.from_numpy(x))
    assert y.shape == dims and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(jfd.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(y.numpy(), st.matvec(torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(fd.diagonal().numpy(), np.asarray(jfd.diagonal()))
    s = np.random.default_rng(9).uniform(0.5, 2.0, size=dims).astype(np.float32)
    np.testing.assert_allclose(
        fd.scale_rows(torch.from_numpy(s)).matvec(torch.from_numpy(x)).numpy(),
        np.asarray(jfd.scale_rows(jnp.asarray(s)).matvec(jnp.asarray(x))),
        rtol=RTOL, atol=ATOL)
    back = fd.to_stencil()
    assert back.offsets == st.offsets
    np.testing.assert_array_equal(back.weights.numpy(), st.weights.numpy())
    assert fd.nnz == st.nnz


def test_flatdia_aliased_planes_merge_like_jax():
    st, jst = _aliased_stencils(10)
    fd, jfd = FlatDIA.from_stencil(st), JFlatDIA.from_stencil(jst)
    assert fd.n_points == jfd.n_points == 2
    assert fd.nd_offsets is None and jfd.nd_offsets is None
    assert fd.to_stencil() is None
    x = _x(st.dims, 11)
    np.testing.assert_allclose(fd.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jfd.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fd.matvec(torch.from_numpy(x)).numpy(),
                               st.matvec(torch.from_numpy(x)).numpy(),
                               rtol=RTOL, atol=ATOL)


def _band(n, offsets, seed):
    rng = np.random.default_rng(seed)
    diags = np.zeros((len(offsets), n), np.float32)
    for d, o in enumerate(offsets):
        lo, hi = max(0, -o), max(0, o)
        diags[d, lo:n - hi] = rng.normal(size=n - lo - hi)
    return diags


def test_flatdia_from_dia_and_dia_matvec_match_jax():
    n, offsets = 200, (-14, -1, 0, 1, 14)
    diags = _band(n, offsets, 12)
    dia = DIA(torch.from_numpy(diags), offsets, (n, n))
    jdia = JDIA(jnp.asarray(diags), offsets, (n, n))
    x = _x(n, 13)
    want = np.asarray(JFlatDIA.from_dia(jdia).matvec(jnp.asarray(x)))
    np.testing.assert_allclose(FlatDIA.from_dia(dia).matvec(torch.from_numpy(x)).numpy(),
                               want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dia.matvec(torch.from_numpy(x)).numpy(),
                               np.asarray(jdia.matvec(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)
    # columns past either end read 0, as the kernel's bounds check does
    dense = np.zeros((n, n))
    for d, o in enumerate(offsets):
        r = np.arange(max(0, -o), n - max(0, o))
        dense[r, r + o] = diags[d, r]
    np.testing.assert_allclose(dia_spmv(dia.diags, offsets, torch.from_numpy(x)).numpy(),
                               dense @ x, rtol=1e-4, atol=1e-4)


def test_dia_spmv_checks():
    W = torch.zeros(2, 5)
    with pytest.raises(ValueError):
        dia_spmv(W, (0, 1), torch.zeros(4))
    with pytest.raises(ValueError):
        dia_spmv(W, (0,), torch.zeros(5))
    with pytest.raises(TypeError):
        dia_spmv(W, (0, 1), torch.zeros(5, dtype=torch.float64))
    assert dia_spmv(torch.zeros(0, 3), (), torch.ones(3)).tolist() == [0, 0, 0]
    bf = _matvec_plain(torch.ones(1, 3, dtype=torch.bfloat16), (1,), torch.ones(3))
    assert bf.dtype == torch.float32 and bf.tolist() == [1, 1, 0]


# -- block transfers -------------------------------------------------------

@pytest.mark.parametrize("dims,block", [((10, 11), 3), ((7, 6, 5), 2), ((8, 8, 8), 3)])
def test_transfers_match_jax(dims, block):
    cdims = tuple(-(-d // block) for d in dims)
    xc = _x(cdims, 14)
    y = _x(dims, 15)
    np.testing.assert_array_equal(
        transfers.upsample_nd(torch.from_numpy(xc), dims, block).numpy(),
        np.asarray(jtransfers.upsample_nd(jnp.asarray(xc), dims, block)))
    np.testing.assert_allclose(
        transfers.downsample_sum_nd(torch.from_numpy(y), cdims, block).numpy(),
        np.asarray(jtransfers.downsample_sum_nd(jnp.asarray(y), cdims, block)),
        rtol=RTOL, atol=ATOL)
    st, jst = _random_stencils(dims, 16)
    d_inv = 1.0 / st.diagonal()
    scale = _x(cdims, 17)
    coef = 0.61
    for linked in (False, True):
        A, jA = (None, None) if linked else (st, jst)
        di, jdi = (None, None) if linked else (d_inv, jnp.asarray(d_inv.numpy()))
        P = transfers.BlockProlongator(A, di, torch.from_numpy(scale), coef,
                                       dims, cdims, block)
        R = transfers.BlockRestrictor(A, di, torch.from_numpy(scale), coef,
                                      dims, cdims, block)
        jP = jtransfers.BlockProlongator(jA, jdi, jnp.asarray(scale), coef,
                                         dims, cdims, block)
        jR = jtransfers.BlockRestrictor(jA, jdi, jnp.asarray(scale), coef,
                                        dims, cdims, block)
        assert P.linked == jP.linked == linked and P.shape == jP.shape
        assert R.shape == jR.shape
        if linked:
            p = P.matvec_linked(st, d_inv, torch.from_numpy(xc))
            jp = jP.matvec_linked(jst, jnp.asarray(d_inv.numpy()), jnp.asarray(xc))
            r = R.matvec_linked(st, d_inv, torch.from_numpy(y))
            jr = jR.matvec_linked(jst, jnp.asarray(d_inv.numpy()), jnp.asarray(y))
        else:
            p, jp = P.matvec(torch.from_numpy(xc)), jP.matvec(jnp.asarray(xc))
            r, jr = R.matvec(torch.from_numpy(y)), jR.matvec(jnp.asarray(y))
        np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), rtol=RTOL, atol=ATOL)
        zc = P.zeros_coarse(torch.float32)
        assert zc.shape == cdims and not bool(zc.any())


# -- kernel B2 on the card ---------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("the FlatDIA kernel is CUDA C++ and needs a CUDA card")
    return torch.device("cuda")


def _kernel_cases():
    st, _ = _random_stencils((20, 17, 13), 18)
    al, _ = _aliased_stencils(19)
    wide = (tuple(range(-100, 100)) + (150,))  # 201 offsets: two launches
    return {
        "stencil_3d": FlatDIA.from_stencil(st),
        "aliased": FlatDIA.from_stencil(al),
        "band_1d": FlatDIA(torch.from_numpy(_band(300, (-14, -1, 0, 1, 14), 20)),
                           (-14, -1, 0, 1, 14), 300),
        "wide_201": FlatDIA(torch.from_numpy(_band(400, wide, 21)), wide, 400),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["stencil_3d", "aliased", "band_1d", "wide_201"])
def test_flatdia_cuda_kernel_matches_plain(name, dtype):
    dev = _cuda()
    fd = _kernel_cases()[name]
    W = fd.diags.to(dtype).to(dev).contiguous()
    x = torch.from_numpy(_x(fd.n, 22)).to(dev)
    before = flatdia.LAUNCHES["flatdia_spmv"]
    y = dia_spmv(W, fd.offsets, x)
    torch.cuda.synchronize()
    assert flatdia.LAUNCHES["flatdia_spmv"] == before + -(-fd.n_points // flatdia.MAX_DIAGS)
    ref = _matvec_plain(W, fd.offsets, x)
    bound = 1e-6 + 1e-5 * _matvec_plain(W.abs(), fd.offsets, x.abs())
    assert bool(((y - ref).abs() <= bound).all())


@pytest.mark.cuda
def test_dia_matvec_cuda_launches_the_kernel():
    dev = _cuda()
    offsets = (-14, -1, 0, 1, 14)
    dia = DIA(torch.from_numpy(_band(300, offsets, 23)), offsets, (300, 300)).to(dev)
    x = torch.from_numpy(_x(300, 24)).to(dev)
    before = flatdia.LAUNCHES["flatdia_spmv"]
    y = dia.matvec(x)
    torch.cuda.synchronize()
    assert flatdia.LAUNCHES["flatdia_spmv"] == before + 1
    ref = _matvec_plain(dia.diags, offsets, x)
    bound = 1e-6 + 1e-5 * _matvec_plain(dia.diags.abs(), offsets, x.abs())
    assert bool(((y - ref).abs() <= bound).all())
