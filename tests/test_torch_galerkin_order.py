"""The structured setups' Galerkin building blocks, bit for bit against the
JAX package's jitted functions on the CPU.

Each case draws random non-constant float32 weights with numpy from a seed,
runs the JAX package's function as its setup runs it (``jax.jit``) and the
port's function on the same inputs, and compares the float32 bits
(``.view(int32)``): the port adds in XLA's CPU order (fused multiply-adds in
the smoothers' centre planes, the windows rule over the offset axis in the
sparsifier's lump, the one-hot dot's chain or four lanes in the pooled
reduction, XLA's 1/√c in the block scale, the bucketed product's whole-box
updates before its sliced ones and its padded window sum).  The coarse
inverse's device form is held at float32 tolerance (an eigendecomposition in
another library).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.amg.hierarchy import coarse_inverse as j_coarse_inverse
from parallel_amg_tpu.ops.stencil import Stencil as JStencil

from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.hierarchy import coarse_inverse
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
from parallel_amg_tpu_torch.ops.stencil import Stencil

torch.set_num_threads(2)


def _offsets(nd, reach, kind):
    box = itertools.product(range(-reach, reach + 1), repeat=nd)
    if kind == "star":
        return tuple(o for o in box if sum(map(abs, o)) <= reach)
    return tuple(box)


def _pair(rng, offs, dims, spread=True):
    """(port Stencil, JAX Stencil) of one random variable-coefficient operator
    with a dominant centre; ``spread`` scales entries by powers of 2."""
    w = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims)
    if spread:
        w = w * np.exp2(rng.integers(-6, 3, size=w.shape))
    zero = tuple(0 for _ in dims)
    if zero in offs:
        w[offs.index(zero)] = rng.uniform(4.0, 8.0, size=dims)
    w = w.astype(np.float32)
    return (Stencil(torch.from_numpy(w), offs, dims),
            JStencil(jnp.asarray(w), offs, dims))


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.int32)


def _assert_bits(mine, theirs):
    a, b = _bits(mine), _bits(theirs)
    assert a.shape == b.shape
    assert np.array_equal(a, b), f"{int((a != b).sum())} of {a.size} floats differ"


def _smooth_inputs(rng, dims, kind="star"):
    st, jst = _pair(rng, _offsets(len(dims), 1, kind), dims, spread=False)
    d = (1.0 / st.diagonal()).numpy()
    coef = np.float32(rng.uniform(0.3, 0.7))
    return st, jst, d, coef


def _case_smoothing(rng, dims):
    st, jst, d, coef = _smooth_inputs(rng, dims)
    mine = ds.smoothing_operator(st, torch.from_numpy(d), torch.tensor(coef))
    theirs = jds._jit_smooth(jst, jnp.asarray(d), jnp.asarray(coef))
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


def _case_smoothing_T(rng, dims):
    st, jst, d, coef = _smooth_inputs(rng, dims)
    mine = ds.smoothing_operator_T(st, torch.from_numpy(d), torch.tensor(coef))
    theirs = jds._jit_smooth_T(jst, jnp.asarray(d), jnp.asarray(coef))
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


def _case_matmul(rng, dims):
    a, ja = _pair(rng, _offsets(len(dims), 1, "box"), dims)
    b, jb = _pair(rng, _offsets(len(dims), 1, "star"), dims)
    mine, theirs = a.matmul(b), jds._jit_matmul(ja, jb)
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


def _sparsify(reach, sym):
    def case(rng, dims):
        m, jm = _pair(rng, _offsets(len(dims), reach, "box"), dims)
        if sym:
            return (ds.symmetrize_stencil(ds.sparsify_stencil(m, 0.2)).weights,
                    jds._jit_sparsify_sym(jm, 0.2).weights)
        return ds.sparsify_stencil(m, 0.2).weights, jds._jit_sparsify(jm, 0.2).weights
    return case


def _case_galerkin(rng, dims):
    b = 3
    m, jm = _pair(rng, _offsets(len(dims), 2, "box"), dims)
    cdims = tuple(-(-n // b) for n in dims)
    scale = rng.uniform(0.2, 1.0, size=cdims).astype(np.float32)
    mine = ds.galerkin_block(m, cdims, b, torch.from_numpy(scale))
    theirs = jds._jit_galerkin(jm, cdims, b, jnp.asarray(scale))
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


def _case_block_scale(rng, dims):
    b = 3
    cdims = tuple(-(-n // b) for n in dims)
    counts = downsample_sum_nd(torch.ones(dims), cdims, b)
    return (ds.block_scale(counts),
            jds._jit_scale(jnp.ones(dims, jnp.float32), cdims, b))


def _case_slab(rng, dims):
    """One masked slab of the triple product (the distributed setup's
    kernel) over a 7-point level, halo 6, two coarse rows."""
    halo, b, cc = 6, 3, 2
    dims_slab = (cc * b + 2 * halo,) + dims
    st, _ = _pair(rng, _offsets(3, 1, "star"), dims_slab, spread=False)
    w = st.weights.numpy()
    d = (1.0 / w[st.offsets.index((0, 0, 0))]).astype(np.float32)
    cd = tuple(-(-n // b) for n in dims)
    scale = rng.uniform(0.2, 0.5, size=(cc + 2,) + cd).astype(np.float32)
    mask = (np.arange(dims_slab[0]) < 10).astype(np.float32).reshape(-1, 1, 1)
    kw = dict(offsets=st.offsets, dims_slab=dims_slab, cdims_slab=(cc,) + cd,
              block=b, halo=halo, rc=1, it=5e-3)
    coef = np.float32(0.6)
    mine = ds._slab_coarse_operator(torch.from_numpy(w), torch.from_numpy(d),
                                    torch.from_numpy(scale), torch.tensor(coef), 0,
                                    mask=torch.from_numpy(mask), **kw)
    theirs = jds._jit_slab(jnp.asarray(w), jnp.asarray(d), jnp.asarray(scale),
                           jnp.asarray(coef), jnp.asarray(0, jnp.int32),
                           mask=jnp.asarray(mask), **kw)
    return mine.weights, theirs


def _case_bucketed(rng, dims, kind="star"):
    """The bucketed (transfer-first) product of a random level, a star (5 or
    7 points) or a box (9 or 27 points) on ``dims`` (2 or 3 axes)."""
    st, jst, d, coef = _smooth_inputs(rng, dims, kind)
    b = 3
    cdims = tuple(-(-n // b) for n in dims)
    scale = rng.uniform(0.2, 1.0, size=cdims).astype(np.float32)
    mine = ds.bucketed_coarse_operator(st, torch.from_numpy(d), torch.tensor(coef),
                                       cdims, b, torch.from_numpy(scale))
    theirs = jds._jit_bucketed(jst, jnp.asarray(d), jnp.asarray(coef), cdims, b,
                               jnp.asarray(scale))
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


# Grids where the JAX package's whole jitted product departs from the stage
# order (``bucket_stage._DEPARTURES``), held live: (dims, kind).
BUCKETED_DEPARTURES = {
    "bucketed_2d_5pt_11x10": ((11, 10), "star"),
    "bucketed_2d_9pt_11x10": ((11, 10), "box"),
    "bucketed_3d_7pt_13x12x11": ((13, 12, 11), "star"),
}


def _case_dense_level(rng, dims):
    """The dense path's whole level product (S, Sᵀ, A·S, sparsify, Sᵀ·(AS),
    sparsify + symmetrize, prune, pooled reduction), as the JAX setup's
    jitted stages compose it."""
    st, jst, d, coef = _smooth_inputs(rng, dims, kind="star")
    b, it = 3, 5e-3
    cdims = tuple(-(-n // b) for n in dims)
    scale = ds.block_scale(downsample_sum_nd(torch.ones(dims), cdims, b))
    cfg = type("C", (), {"block_size": b, "setup_product_path": "dense",
                         "setup_intermediate_tol": it})()
    mine = ds.coarse_operator(st, torch.from_numpy(d), torch.tensor(coef), cdims,
                              cfg, scale)
    jd, jc = jnp.asarray(d), jnp.asarray(coef)
    S, St = jds._jit_smooth(jst, jd, jc), jds._jit_smooth_T(jst, jd, jc)
    AS = jds._prune_zero_planes(jds._jit_sparsify(jds._jit_matmul(jst, S), it))
    M = jds._prune_zero_planes(jds._jit_sparsify_sym(jds._jit_matmul(St, AS), it))
    theirs = jds._jit_galerkin(M, cdims, b, jnp.asarray(scale.numpy()))
    assert mine.offsets == theirs.offsets
    return mine.weights, theirs.weights


CASES = {
    "smoothing_2d": (_case_smoothing, (11, 10)),
    "smoothing_3d": (_case_smoothing, (7, 6, 5)),
    "smoothing_T_2d": (_case_smoothing_T, (11, 10)),
    "smoothing_T_3d": (_case_smoothing_T, (7, 6, 5)),
    "matmul_2d": (_case_matmul, (11, 10)),
    "matmul_3d": (_case_matmul, (7, 6, 5)),
    "sparsify_2d_25": (_sparsify(2, False), (11, 10)),
    "sparsify_3d_125": (_sparsify(2, False), (7, 6, 5)),
    "sparsify_sym_3d_343": (_sparsify(3, True), (7, 6, 5)),
    "galerkin_chain_2d": (_case_galerkin, (24, 23)),
    "galerkin_lanes_2d": (_case_galerkin, (9, 8)),
    "galerkin_chain_3d": (_case_galerkin, (9, 9, 8)),
    "galerkin_lanes_3d": (_case_galerkin, (7, 6, 5)),
    "block_scale_3d": (_case_block_scale, (11, 10, 8)),
    "bucketed_3d_7pt": (_case_bucketed, (7, 6, 5)),
    "bucketed_3d_7pt_20": (_case_bucketed, (20, 20, 20)),
    "slab_mask_3d": (_case_slab, (5, 4)),
    "dense_level_2d": (_case_dense_level, (20, 19)),
    "dense_level_3d": (_case_dense_level, (10, 9, 8)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_product_bits_equal_jax(name):
    fn, dims = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 11)
    mine, theirs = fn(rng, dims)
    _assert_bits(mine.numpy(), theirs)


@pytest.mark.parametrize("name", sorted(BUCKETED_DEPARTURES))
def test_bucketed_departures_equal_jax(name):
    """The bucketed product at grids where XLA rounds some products before
    adding them (the centre's and the first two whole-box ones, a sliced
    update's scalar remainder): the port's ``product_orders`` gives the JAX
    package's bits."""
    dims, kind = BUCKETED_DEPARTURES[name]
    rng = np.random.default_rng(sorted(BUCKETED_DEPARTURES).index(name) + 41)
    mine, theirs = _case_bucketed(rng, dims, kind)
    _assert_bits(mine.numpy(), theirs)


@pytest.mark.parametrize("indefinite", [False, True])
def test_coarse_inverse_matches_jax(indefinite):
    """The device pseudo-inverse equals the JAX function at float32
    tolerance, zeroing the same modes of a slightly indefinite matrix."""
    rng = np.random.default_rng(5)
    n = 24
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    w = rng.uniform(0.5, 4.0, size=n)
    if indefinite:
        w[:2] = (-0.04 * w.max(), 1e-9)
    dense = ((q * w) @ q.T).astype(np.float32)
    mine = coarse_inverse(torch.from_numpy(dense))
    theirs = np.asarray(j_coarse_inverse(jnp.asarray(dense)))
    assert mine.dtype == torch.float32 and mine.shape == (n, n)
    scale = np.abs(theirs).max()
    np.testing.assert_allclose(mine.numpy(), theirs, rtol=1e-4, atol=1e-5 * scale)
    exact = np.linalg.pinv(np.diag(np.where(w > 1e-6 * np.abs(w).max(), w, 0.0)))
    want = q @ exact @ q.T
    np.testing.assert_allclose(mine.double().numpy(), want, rtol=1e-3,
                               atol=1e-4 * np.abs(want).max())
