"""The port's row-partitioned PCSR (parallel/pcsr.py, partition.py,
pvector.py, native/) against the JAX package's on its CPU mesh.

Both packages get the same matrices: 2D Poisson 16² and a rectangular
interpolation-shaped matrix, on 8 parts (the JAX package's 8-device CPU
mesh against ``make_row_mesh(8, device="cpu")``) and on 3 parts, where the
last part holds padding rows.
Tolerances:
- halo plans, partition planes, the ring plan's tables, triplets,
  ``to_csr`` and repartitioned planes: equal;
- matvec, ``consistent`` and ``assemble``: rtol 1e-6, atol 1e-6 (float32
  sums over the same entries in another order; tests/test_passembly_device.py
  holds the JAX package's own PCSRs to the same);
- the ring plan's matvec: bit-equal to the dense plan's (same ghosts, same
  sums).
The CUDA cases hold kernel B1 on each part's TWELL against the plain
two-plane gather-sum on the card.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax
    import jax.numpy as jnp

    from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
    from parallel_amg_tpu.parallel import pvector as j_pvector
    from parallel_amg_tpu.parallel.partition import build_halo_plan as j_build_halo_plan
    from parallel_amg_tpu.parallel.partition import uniform_row_partition as j_urp
    from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
except ImportError:  # a machine without JAX runs the cuda cases only
    jax = None

from parallel_amg_tpu_torch.parallel import partition
from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pvector import dot, norm, pvector, to_global
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 1e-6
FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")


def _scipy(coo):
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


@pytest.fixture(scope="module")
def A16():
    return _scipy(poisson2d(16))


@pytest.fixture(scope="module")
def P16():
    """A 256×90 interpolation-shaped matrix (1–4 entries a row)."""
    rng = np.random.default_rng(3)
    n, nc = 256, 90
    rows = np.repeat(np.arange(n), rng.integers(1, 5, size=n))
    cols = np.minimum(rows * nc // n + rng.integers(-6, 7, size=rows.size), nc - 1)
    cols = np.maximum(cols, 0)
    M = sp.csr_matrix((rng.uniform(0.1, 1.0, size=rows.size), (rows, cols)),
                      shape=(n, nc))
    M.sum_duplicates()
    return M


def _meshes(S):
    return j_make_row_mesh(S), make_row_mesh(S, device="cpu")


def _port(P, field):
    return np.stack([t.numpy() for t in getattr(P, field)])


def _assert_planes_equal(J, P, fields=FIELDS):
    for f in fields:
        a, b = np.asarray(getattr(J, f)), _port(P, f)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert J.true_shape == P.true_shape
    for name in ("row_partition", "col_partition"):
        jp, tp = getattr(J, name), getattr(P, name)
        assert (jp.n_global, jp.n_shards, jp.rows_per_shard) == (
            tp.n_global, tp.n_shards, tp.rows_per_shard)


def _jvec(x, n_padded):
    return jnp.asarray(np.concatenate([x, np.zeros(n_padded - len(x))]),
                       jnp.float32)


@pytest.mark.parametrize("S", [8, 3])
def test_halo_plan_arrays_equal(S):
    rng = np.random.default_rng(S)
    n = 200
    part = partition.uniform_row_partition(n, S)
    sets = []
    for s in range(S):
        lo, hi = part.own_range(s)
        cand = np.setdiff1d(rng.integers(0, n, size=30), np.arange(lo, hi))
        sets.append(np.unique(cand).astype(np.int64))
    ours = partition.build_halo_plan(sets, part)
    ref = j_build_halo_plan(sets, j_urp(n, S))
    for f in ("send_idx", "send_count", "recv_map", "ghost_gids", "n_ghost"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f), err_msg=f)
    assert (ours.C, ours.G) == (ref.C, ref.G)


@pytest.mark.parametrize("S", [8, 3])
@pytest.mark.parametrize("which", ["square", "rect"])
def test_native_equals_numpy(S, which, A16, P16):
    mesh = make_row_mesh(S, device="cpu")
    if which == "square":
        M, kw = A16, {}
    else:
        M, kw = P16, dict(col_partition=partition.uniform_row_partition(90, S),
                          pad_identity=False)
    a = PCSR.from_csr(M, mesh, native=True, **kw)
    b = PCSR.from_csr(M, mesh, native=False, **kw)
    for f in FIELDS:
        np.testing.assert_array_equal(_port(a, f), _port(b, f), err_msg=f)


@pytest.mark.parametrize("S", [8, 3])
@pytest.mark.parametrize("which", ["square", "rect"])
def test_from_csr_planes_equal_jax(S, which, A16, P16):
    jm, tm = _meshes(S)
    if which == "square":
        J, P = JPCSR.from_csr(A16, jm), PCSR.from_csr(A16, tm)
    else:
        J = JPCSR.from_csr(P16, jm, col_partition=j_urp(90, S), pad_identity=False)
        P = PCSR.from_csr(P16, tm, col_partition=partition.uniform_row_partition(90, S),
                          pad_identity=False)
    _assert_planes_equal(J, P)


@pytest.mark.parametrize("S", [8, 3])
def test_matvec_and_ring_plan_vs_jax(S, A16):
    jm, tm = _meshes(S)
    J, P = JPCSR.from_csr(A16, jm), PCSR.from_csr(A16, tm)
    x = np.random.default_rng(0).normal(size=A16.shape[0])
    yj = np.asarray(J.matvec(_jvec(x, J.shape[1])))
    xp = pvector(x, P.col_partition, tm)
    y = P.matvec(xp).to_global().numpy()
    np.testing.assert_allclose(y, yj, rtol=RTOL, atol=ATOL)
    # the ring plan: its tables equal the JAX package's, its matvec is
    # bit-equal to the dense plan's
    Jr, Pr = J.with_neighbor_plan(), P.with_neighbor_plan()
    assert tuple(Jr.nb_offsets) == Pr.nb_offsets
    for a, b in zip(Jr.nb_send, Pr.nb_send):
        np.testing.assert_array_equal(np.asarray(a), np.stack([t.numpy() for t in b]))
    np.testing.assert_array_equal(np.asarray(Jr.nb_recv_map), _port(Pr, "nb_recv_map"))
    assert torch.equal(Pr.matvec(xp).to_global(), P.matvec(xp).to_global())
    # each part's B1 operator (plain version here) computes the same rows
    g = P.ghosts(xp)
    y_tw = torch.cat([tw.matvec(torch.cat([xp.parts[p], g[p]]))
                      for p, tw in enumerate(P.twell_parts())])
    np.testing.assert_allclose(y_tw.numpy(), yj, rtol=RTOL, atol=ATOL)
    # A @ x on the true rows against scipy
    np.testing.assert_allclose(y[: A16.shape[0]], A16 @ x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [8, 3])
def test_consistent_and_assemble_vs_jax(S, A16):
    jm, tm = _meshes(S)
    J, P = JPCSR.from_csr(A16, jm), PCSR.from_csr(A16, tm)
    rng = np.random.default_rng(2)
    x = rng.normal(size=A16.shape[0])
    gj = np.asarray(J.consistent(_jvec(x, J.shape[1])))
    gp = P.consistent(pvector(x, P.col_partition, tm))
    np.testing.assert_array_equal(np.stack([t.numpy() for t in gp.parts]), gj)
    gv = rng.normal(size=gj.shape).astype(np.float32)
    aj = np.asarray(J.assemble(jnp.asarray(gv)))
    ap = P.assemble(PGrid([torch.from_numpy(r) for r in gv], tm)).to_global().numpy()
    np.testing.assert_allclose(ap, aj, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [8, 3])
def test_to_csr_and_triplets_exact(S, A16, P16):
    jm, tm = _meshes(S)
    P = PCSR.from_csr(A16, tm)
    B = P.to_csr().to_scipy()
    assert B.shape == A16.shape and abs(B - A16).max() == 0
    J = JPCSR.from_csr(A16, jm)
    for a, b in zip(J.to_triplets(), P.to_triplets()):
        np.testing.assert_array_equal(np.asarray(a), np.stack([t.numpy() for t in b.parts]))
    Pr = PCSR.from_csr(P16, tm, col_partition=partition.uniform_row_partition(90, S),
                       pad_identity=False)
    B = Pr.to_csr().to_scipy()
    assert B.shape == P16.shape
    np.testing.assert_array_equal(B.toarray(), P16.toarray().astype(np.float32))


def test_repartition_realign_and_shrink(A16):
    jm, tm = _meshes(8)
    J, P = JPCSR.from_csr(A16, jm), PCSR.from_csr(A16, tm)
    m = P.row_partition.rows_per_shard
    x = np.random.default_rng(5).normal(size=A16.shape[0])
    # same mesh, re-aligned ownership (m + 8 rows a part)
    Jr = J.repartition(jm, rows_per_shard=m + 8)
    Pr = P.repartition(tm, rows_per_shard=m + 8)
    _assert_planes_equal(Jr, Pr)
    y = Pr.matvec(pvector(x, Pr.col_partition, tm)).to_global().numpy()
    np.testing.assert_allclose(y[: len(x)], A16 @ x, rtol=1e-5, atol=1e-5)
    # shrink to 4 parts
    jm4, tm4 = _meshes(4)
    Js, Ps = J.repartition(jm4), P.repartition(tm4)
    _assert_planes_equal(Js, Ps)
    y = Ps.matvec(pvector(x, Ps.col_partition, tm4)).to_global().numpy()
    np.testing.assert_allclose(y[: len(x)], A16 @ x, rtol=1e-5, atol=1e-5)
    assert abs(Ps.to_csr().to_scipy() - A16).max() == 0


@pytest.mark.parametrize("S", [8, 3])
def test_pcsr_from_numpy_carries_jax_arrays(S, P16):
    """``interop.pcsr_from_numpy`` turns the JAX package's PCSR arrays into
    the port's: the same planes, plans and partitions, and the ring plan
    when the JAX operator has one."""
    from parallel_amg_tpu_torch.interop import pcsr_from_numpy

    jm, tm = _meshes(S)
    J = JPCSR.from_csr(P16, jm, col_partition=j_urp(90, S),
                       pad_identity=False).with_neighbor_plan()
    arrays = {f: np.asarray(getattr(J, f)) for f in FIELDS}
    arrays.update(row_partition=J.row_partition, col_partition=J.col_partition,
                  true_shape=J.true_shape, nb_offsets=J.nb_offsets)
    P = pcsr_from_numpy(arrays, tm)
    _assert_planes_equal(J, P)
    np.testing.assert_array_equal(np.asarray(J.nb_recv_map), _port(P, "nb_recv_map"))
    x = np.random.default_rng(4).normal(size=90)
    y = P.matvec(pvector(x, P.col_partition, tm)).to_global().numpy()
    np.testing.assert_allclose(y, np.asarray(J.matvec(_jvec(x, J.shape[1]))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("S", [8, 3])
def test_pvector_dot_norm(S):
    jm, tm = _meshes(S)
    part = partition.uniform_row_partition(100, S)
    rng = np.random.default_rng(S)
    x, y = rng.normal(size=100), rng.normal(size=100)
    xp, yp = pvector(x, part, tm), pvector(y, part, tm)
    assert [p.shape[0] for p in xp.parts] == [part.rows_per_shard] * S
    assert xp.parts[-1].device == tm.device(S - 1)
    xj = j_pvector(x, j_urp(100, S), jm)
    np.testing.assert_array_equal(xp.to_global().numpy(), np.asarray(xj))
    np.testing.assert_array_equal(to_global(xp, part), x.astype(np.float32))
    np.testing.assert_allclose(float(dot(xp, yp)),
                               float(jnp.vdot(xj, j_pvector(y, j_urp(100, S), jm))),
                               rtol=1e-6)
    np.testing.assert_allclose(float(norm(xp)), float(jnp.linalg.norm(xj)), rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [8, 3])
def test_pcsr_b1_matvec_matches_plain_cuda(S):
    """Kernel B1 per part against the plain two-plane gather-sum, on the
    card (``pytest -m cuda --noconftest``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from parallel_amg_tpu_torch.ops import twell

    A = _scipy(poisson2d(96))
    tm = make_row_mesh(S)
    P = PCSR.from_csr(A, tm).with_neighbor_plan()
    x = pvector(np.random.default_rng(1).normal(size=A.shape[0]), P.col_partition, tm)
    before = twell.LAUNCHES
    y = P.matvec(x).to_global()
    assert twell.LAUNCHES - before == S
    g = P.ghosts(x)
    ref = torch.cat([(P.diag_vals[p] * x.parts[p][P.diag_cols[p].long()]).sum(1)
                     + (P.off_vals[p] * g[p][P.off_cols[p].long()]).sum(1)
                     for p in range(S)])
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.cpu().numpy()[: A.shape[0]],
                               A @ to_global(x, P.col_partition), rtol=1e-5, atol=1e-5)
