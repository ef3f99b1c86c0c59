"""The port's row mesh, PGrid and ShardedStencil matvec (both halo modes)
against the JAX package's ShardedStencil on its 8-device CPU mesh.

The same numpy inputs, made from a seed, go to both packages.  On the CPU
kernel B8 (``parallel/phalo_async.py``) runs its plain version; the JAX
``async_halo_matvec`` runs its Pallas kernel in interpret mode, as
tests/test_phalo_async.py runs it.  Tolerances: rtol 1e-5 / atol 1e-6 for
matvecs (float32 products summed in the same order; XLA may fuse a multiply
and an add); within the port, B8's plain path and the "xla" path take the
same sums and must be equal bit for bit.  The CUDA cases hold kernel B8
against its plain version on the card: the one-launch path for parts on one
card and the exchange route of parts on several cards or processes (one
interior and one boundary launch a card), both bit-equal (all take unfused
float32 products and sums in offset order), bit-equal over 20 calls, one
launch per matvec on one card and none where m0 ≤ h.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
    from parallel_amg_tpu.parallel.phalo_async import (
        async_halo_matvec as j_async_halo_matvec,
    )
    from parallel_amg_tpu.parallel.pstencil import ShardedStencil as JShardedStencil
except ImportError:  # a machine without JAX runs the cuda cases only
    jax = None

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import launch
from parallel_amg_tpu_torch.parallel import mesh as pmesh
from parallel_amg_tpu_torch.parallel import exchange, phalo_async, pgrid
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import (
    ShardedStencil,
    boundary_plain,
    interior_plain,
)
from parallel_amg_tpu_torch.problems import poisson_stencil

import torch_ranks

torch.set_num_threads(2)

M_RTOL, M_ATOL = 1e-5, 1e-6

# (dims, S, reach 2) of kernel B8's cases, on the CPU and on the card
B8_SHAPES = [
    ((20, 17, 13), 4, False),
    ((40, 24), 4, True),
    ((30, 11, 9), 3, True),
    ((20, 17, 13), 2, False),   # 3-D, reach 1
    ((8, 9, 12), 4, False),     # m0 2 = h + 1, four points a thread
    ((40, 12, 16), 8, False),
    ((10, 7), 2, False),        # 2-D, reach 1, one point a thread
    ((12, 24), 4, True),        # 2-D, m0 3 = h + 1 < 2h: both halos per plane
    ((80, 24), 8, True),
    ((30, 11, 9), 2, True),     # 3-D, reach 2
    ((24, 8, 8), 8, True),      # m0 3 < 2h
]


def _stencil_arrays(dims, seed, reach2=False):
    """(weights, offsets) of a Poisson-pattern stencil with random weights
    (reach 2: the stencil squared)."""
    st = poisson_stencil(dims, device="cpu")
    if reach2:
        st = st.matmul(st)
    rng = np.random.default_rng(seed)
    W = st.weights.numpy() * rng.uniform(0.5, 2.0, size=st.weights.shape)
    return W.astype(np.float32), st.offsets


def _pair(dims, S, seed, reach2=False):
    """(port ShardedStencil on S CPU parts, JAX ShardedStencil on S devices,
    the padded-grid x as numpy)."""
    W, offsets = _stencil_arrays(dims, seed, reach2)
    A = ShardedStencil.from_stencil(ptt.Stencil(torch.from_numpy(W), offsets, dims),
                                    ptt.make_row_mesh(S, device="cpu"))
    jA = JShardedStencil.from_stencil(JStencil(jnp.asarray(W), offsets, dims),
                                      j_make_row_mesh(S))
    x = np.random.default_rng(seed + 1).standard_normal(A.dims).astype(np.float32)
    return A, jA, x


def _jx(jA, x):
    return jax.device_put(jnp.asarray(x), NamedSharding(jA.mesh, P("rows")))


def _px(A, x):
    return PGrid.from_global(torch.from_numpy(x), A.mesh)


def _bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dims,reach2", [((20, 20, 20), False), ((24, 24), True)],
                         ids=["20^3", "24^2_reach2"])
def test_xla_matvec_matches_jax(dims, reach2):
    A, jA, x = _pair(dims, 8, 11, reach2)
    assert A.dims == jA.dims and A.offsets == jA.offsets
    assert A.halo == jA.halo == (2 if reach2 else 1)
    y = A.matvec(_px(A, x)).to_global().numpy()
    jy = np.asarray(jA.matvec(_jx(jA, x)))
    np.testing.assert_allclose(y, jy, rtol=M_RTOL, atol=M_ATOL)
    for W, jW in zip(A.weights, np.split(np.asarray(jA.weights), 8, axis=1)):
        np.testing.assert_array_equal(W.numpy(), jW)


def test_b8_plain_matches_jax_async_interpret():
    A, jA, x = _pair((16, 8, 8), 8, 12)
    assert A.m0 > A.halo  # B8 proper, not the m0 ≤ h branch
    y = phalo_async.async_halo_matvec(A, _px(A, x)).to_global().numpy()
    jy = np.asarray(j_async_halo_matvec(jA, _jx(jA, x), interpret=True))
    np.testing.assert_allclose(y, jy, rtol=M_RTOL, atol=M_ATOL)


@pytest.mark.parametrize("dims,S,reach2,kernel_path", [
    ((20, 12, 10), 4, False, True),
    ((32, 12), 8, True, True),      # m0 4 > h 2
    ((16, 12), 8, True, False),     # m0 2 = h 2: the xla branch
    ((12, 9), 1, False, False),     # one part: no exchange
])
def test_b8_plain_path_equals_xla_and_branch_rule(monkeypatch, dims, S, reach2,
                                                  kernel_path):
    W, offsets = _stencil_arrays(dims, 13, reach2)
    A = ShardedStencil.from_stencil(ptt.Stencil(torch.from_numpy(W), offsets, dims),
                                    ptt.make_row_mesh(S, device="cpu"))
    x = _px(A, np.random.default_rng(14).standard_normal(A.dims).astype(np.float32))
    calls = []
    real = phalo_async.stencil_interior
    monkeypatch.setattr(phalo_async, "stencil_interior",
                        lambda A_, x_, *a: calls.append(len(x_.parts)) or real(A_, x_, *a))
    y = A.with_halo_mode("pallas_async").matvec(x)
    # the route's interior entry: one call over every part, or none
    assert calls == ([S] if kernel_path else [])
    ref = A.matvec(x)
    for a, b in zip(y.parts, ref.parts):
        assert torch.equal(a, b)
    # and both equal the single-grid Stencil on the true rows
    st = ptt.Stencil(torch.from_numpy(W), offsets, dims)
    xt = x.to_global()[:dims[0]]
    np.testing.assert_allclose(y.to_global()[:dims[0]].numpy(),
                               st.matvec(xt).numpy(), rtol=M_RTOL, atol=M_ATOL)


@pytest.mark.parametrize("dims,S,reach2", B8_SHAPES)
def test_b8_route_entries_equal_plain_parts_and_xla(dims, S, reach2):
    """The exchange route's two multi-part entries on the CPU, at the card
    cases' shapes: bit for bit each part's plain interior then its plain
    boundary, and the "xla" path, through the entries and through
    ``matvec_copy_streams``."""
    W, offsets = _stencil_arrays(dims, 16, reach2)
    A = ShardedStencil.from_stencil(ptt.Stencil(torch.from_numpy(W), offsets, dims),
                                    ptt.make_row_mesh(S, device="cpu"))
    x = _px(A, np.random.default_rng(17).standard_normal(A.dims).astype(np.float32))
    h = A.halo
    assert A.m0 > h
    halos = exchange.halos(x.parts, h)
    ys = phalo_async.stencil_interior(A, x)
    assert len(ys) == S
    assert phalo_async.stencil_boundary(A, ys, halos) is ys
    xla = A.matvec(x)
    for i, (Wi, xi) in enumerate(zip(A.weights, x.parts)):
        want = boundary_plain(interior_plain(Wi, xi, A.offsets, h), Wi, *halos[i],
                              A.offsets, h)
        assert _bits(ys[i], want) and _bits(ys[i], xla.parts[i])
    route = phalo_async.matvec_copy_streams(A, x)
    assert all(_bits(a, b) for a, b in zip(route.parts, xla.parts))


def test_sharded_stencil_from_stencil_pads_identity():
    st = poisson_stencil((10, 6), device="cpu")
    A = ShardedStencil.from_stencil(st, ptt.make_row_mesh(4, device="cpu"))
    assert A.dims == (12, 6) and A.m0 == 3 and A.n_points == 5
    Wg = A.global_weights()
    d = A.offsets.index((0, 0))
    assert bool((Wg[d, 10:] == 1).all())
    assert not bool(Wg[[i for i in range(5) if i != d]][:, 10:].any())
    assert A.nnz == st.nnz + 2 * 6
    diag = A.diagonal()
    assert isinstance(diag, PGrid) and diag.shape == (12, 6)
    assert torch.equal(diag.to_global(), Wg[d])
    with pytest.raises(ValueError):
        A.with_halo_mode("ppermute")


def test_pgrid_arithmetic_and_reductions():
    mesh = ptt.make_row_mesh(4, device="cpu")
    rng = np.random.default_rng(15)
    a_np, b_np = rng.standard_normal((2, 8, 5, 3)).astype(np.float32)
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    pa, pb = PGrid.from_global(a, mesh), PGrid.from_global(b, mesh)
    assert pa.shape == (8, 5, 3) and pa.ndim == 3 and len(pa.parts) == 4
    two = torch.tensor(2.0)
    for got, want in ((pa + pb, a + b), (pa - pb, a - b), (pa * pb, a * b),
                      (pa / 3.0, a / 3.0), (2.0 * pa, 2.0 * a), (pa * two, a * two),
                      (two * pa, two * a), (1.0 - pa, 1.0 - a), (-pa, -a),
                      (pa + [p * 0 + 1 for p in pb.parts], a + 1)):
        assert torch.equal(got.to_global(), want)
    np.testing.assert_allclose(float(pa.dot(pb)), float(torch.vdot(a.reshape(-1),
                                                                     b.reshape(-1))),
                               rtol=1e-5)  # float32 partial sums in another order
    np.testing.assert_allclose(float(pa.norm()), float(torch.linalg.norm(a)), rtol=1e-5)
    assert float(pgrid.vdot(pa, pb)) == float(pa.dot(pb))
    assert float(pgrid.norm(pa)) == float(pa.norm())
    assert torch.equal(pgrid.zeros_like(pa).to_global(), torch.zeros_like(a))
    assert pgrid.reshape(pa, (120,)) is pa
    assert pgrid.reshape(a, (120,)).shape == (120,)
    with pytest.raises(ValueError):
        PGrid.from_global(torch.zeros(7, 2), mesh)
    with pytest.raises(TypeError):
        pa + torch.zeros(8, 5, 3)


def test_row_mesh_devices_and_errors(monkeypatch):
    mesh = ptt.make_row_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.device(2) == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ptt.make_row_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    mesh = ptt.make_row_mesh(4)
    assert [str(d) for d in mesh.devices] == ["cuda:0", "cuda:1", "cuda:2", "cuda:0"]
    assert ptt.make_row_mesh().size == 3
    pmesh.runtime_init()  # single process: nothing to do
    # two processes join through a FileStore and split the mesh's parts
    views = launch.spawn(torch_ranks.process_view, 2, args=(4,), timeout_s=60)
    assert views == [(0, 2, [0, 1]), (1, 2, [2, 3])]


def test_kernel_layout_helpers():
    assert phalo_async.grid3((5, 7), [(1, 0, -1)]) == ((5, 7), ((1, 0, -1),))
    assert phalo_async.grid3((7,), [(-2, 1)]) == ((1, 7), ((-2, 0, 1),))
    assert phalo_async.grid3((), [(1,)]) == ((1, 1), ((1, 0, 0),))
    with pytest.raises(ValueError):
        phalo_async.grid3((2, 3, 4), [(0, 0, 0, 0)])
    s = phalo_async._offsets_struct(((1, 0, -1), (0, 2, 0)))
    assert s.count == 2 and (s.o0[0], s.o1[1], s.o2[0]) == (1, 2, -1)
    with pytest.raises(ValueError):
        phalo_async._offsets_struct(tuple((0, 0, i) for i in range(200)))


@pytest.mark.parametrize("S", [2, 5, 16, 20])
def test_part_tables_link_neighbors(S):
    """The one-card launch's part tables: W, x and y of each part, its left
    neighbor part p − 1's slab and its right one part p + 1's, null at the
    grid's two ends, across groups of MAX_PARTS parts."""
    A = ShardedStencil([torch.zeros(3, 2, 4) for _ in range(S)],
                       ((-1, 0), (0, 0), (1, 0)), (2 * S, 4),
                       ptt.make_row_mesh(S, device="cpu"))
    xs = [torch.zeros(2, 4) for _ in range(S)]
    assert phalo_async.inner_parts(A) == tuple(range(S))
    (card,) = phalo_async.route(A, range(S)).cards
    assert card.split == () and card.boundary_tables == []
    ptrs = {p: x.data_ptr() for p, x in enumerate(xs)}
    phalo_async.fill_interior(card, ptrs, 4096, 32)
    assert [c0 for c0, _ in card.interior_tables] == list(range(0, S, phalo_async.MAX_PARTS))
    for c0, t in card.interior_tables:
        for i in range(t.count):
            p = c0 + i
            assert t.W[i] == A.weights[p].data_ptr() and t.x[i] == ptrs[p]
            assert t.y[i] == 4096 + 32 * p
            assert t.left[i] == (ptrs[p - 1] if p > 0 else None)
            assert t.right[i] == (ptrs[p + 1] if p < S - 1 else None)
    assert sum(t.count for _, t in card.interior_tables) == S


# -- kernel B8 on the card ----------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("kernel B8 is CUDA C++ and needs a CUDA card")
    return torch.device("cuda")


def _cuda_case(dims, S, reach2, seed=16):
    W, offsets = _stencil_arrays(dims, seed, reach2)
    mesh = ptt.make_row_mesh(S)
    A = ShardedStencil.from_stencil(
        ptt.Stencil(torch.from_numpy(W).cuda(), offsets, dims), mesh)
    x = PGrid.from_global(torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        A.dims).astype(np.float32)).cuda(), mesh)
    return A, x


def _launches_since(before):
    return {k: phalo_async.LAUNCHES[k] - before[k] for k in before}


@pytest.mark.cuda
@pytest.mark.parametrize("dims,S,reach2", B8_SHAPES)
def test_halo_stencil_cuda_matches_plain(dims, S, reach2):
    _cuda()
    A, x = _cuda_case(dims, S, reach2)
    assert A.m0 > A.halo
    before = dict(phalo_async.LAUNCHES)
    y = A.with_halo_mode("pallas_async").matvec(x)
    torch.cuda.synchronize()
    assert _launches_since(before) == {"halo_stencil_matvec": 1,
                                       "halo_stencil_interior": 0,
                                       "halo_stencil_boundary": 0}
    ref = A.matvec(x)
    for a, b in zip(y.parts, ref.parts):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    A_k = A.with_halo_mode("pallas_async")
    for _ in range(20):
        again = A_k.matvec(x)
        assert all(torch.equal(a, b) for a, b in zip(again.parts, y.parts))
    # the exchange route, run on one card, takes the same sums: one
    # interior and one boundary launch for every part
    before = dict(phalo_async.LAUNCHES)
    copies = phalo_async.matvec_copy_streams(A, x)
    torch.cuda.synchronize()
    assert _launches_since(before) == {"halo_stencil_matvec": 0,
                                       "halo_stencil_interior": 1,
                                       "halo_stencil_boundary": 1}
    for a, b in zip(copies.parts, ref.parts):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_halo_stencil_cuda_no_launch_when_m0_le_h():
    _cuda()
    A, x = _cuda_case((16, 12), 8, True)
    assert A.m0 == A.halo == 2
    before = dict(phalo_async.LAUNCHES)
    y = A.with_halo_mode("pallas_async").matvec(x)
    torch.cuda.synchronize()
    assert not any(_launches_since(before).values())
    for a, b in zip(y.parts, A.matvec(x).parts):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_halo_stencil_cuda_rejects_float64():
    dev = _cuda()
    mesh = ptt.make_row_mesh(2)
    A = ShardedStencil([torch.ones((3, 4, 5), dtype=torch.float64, device=dev)
                        for _ in range(2)], ((-1, 0), (0, 0), (1, 0)), (8, 5), mesh)
    x = PGrid([torch.ones((4, 5), dtype=torch.float64, device=dev)
               for _ in range(2)], mesh)
    with pytest.raises(TypeError):
        phalo_async.stencil_interior(A, x)
