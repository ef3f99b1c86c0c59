"""The host side of kernel B8's exchange route: its launch tables.

The route (``parallel/phalo_async.py``: ``stencil_interior``, the halo
exchange, ``stencil_boundary``) runs each part's plain version on the CPU;
``tests/test_torch_pstencil.py`` holds its results bit for bit.  The tables
the card launches from are built on the host, so their contents are held
here with CPU tensors: the offsets with o₀ ≠ 0 compacted in offset order,
the inner and split parts of a rank and their null sides, the planes each
split part's boundary launch reaches, groups of MAX_PARTS parts, and one
launch a card.  No JAX: nothing here compiles a setup.
"""

import types

import pytest
import torch

from parallel_amg_tpu_torch.parallel import phalo_async
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import poisson_stencil

torch.set_num_threads(2)


@pytest.mark.parametrize("dims,reach2,want", [
    ((6, 5, 4), False, ((0, -1, 0, 0), (6, 1, 0, 0))),
    ((6, 5), False, ((0, -1, 0, 0), (4, 1, 0, 0))),
    ((6, 5), True, None),
])
def test_halo_terms_compacted_in_offset_order(dims, reach2, want):
    st = poisson_stencil(dims, device="cpu")
    if reach2:
        st = st.matmul(st)
    (_, _), offs3 = phalo_async.grid3(dims[1:], st.offsets)
    terms = phalo_async.halo_terms(offs3)
    if want is not None:
        assert terms == want
    assert [t[0] for t in terms] == [d for d, o in enumerate(offs3) if o[0] != 0]
    assert all(offs3[d] == (a, b, c) for d, a, b, c in terms)
    assert [t[0] for t in terms] == sorted(t[0] for t in terms)
    s = phalo_async._terms_struct(offs3)
    assert s.count == len(terms)
    assert [(s.d[i], s.o0[i], s.o1[i], s.o2[i]) for i in range(s.count)] == list(terms)


def _rank_stencil(local, size, m0=3, n=4):
    """A ShardedStencil of a process that holds the parts ``local`` of
    ``size``, on the CPU, with a 3-point axis-0 stencil."""
    mesh = types.SimpleNamespace(local=range(local[0], local[-1] + 1), size=size,
                                 n_local=len(local))
    offsets = ((-1, 0), (0, 0), (1, 0))
    return ShardedStencil([torch.rand(3, m0, n) for _ in local], offsets,
                          (size * m0, n), mesh)


@pytest.mark.parametrize("local,inner,interior,split", [
    # parts {0, 1} of 4: part 0's neighbours are the grid's end and part 1
    ([0, 1], (0,), ((0, None, 1), (1, None, None)), (1,)),
    # parts {1, 2} of 4: each has a neighbour in another process
    ([1, 2], (), ((0, None, None), (1, None, None)), (0, 1)),
    # every part in one process: one launch computes them all
    ([0, 1, 2, 3], (0, 1, 2, 3), ((0, None, 1), (1, 0, 2), (2, 1, 3), (3, 2, None)),
     ()),
])
def test_route_tables_of_a_rank(local, inner, interior, split):
    A = _rank_stencil(local, 4)
    assert phalo_async.inner_parts(A) == inner
    r = phalo_async.route(A, inner)
    assert phalo_async.route(A, inner) is r          # kept on A
    (card,) = r.cards
    assert card.interior == interior and card.split == split
    assert card.positions == list(range(len(local)))
    # the compacted terms: the two axis-0 offsets, with their planes of W
    assert phalo_async.halo_terms(phalo_async.grid3((4,), A.offsets)[1]) == (
        (0, -1, 0, 0), (2, 1, 0, 0))
    assert r.terms.count == 2 and r.step == 4 * 3 * 4
    xs = [torch.zeros(3, 4) for _ in local]
    ptrs = {i: x.data_ptr() for i, x in enumerate(xs)}
    phalo_async.fill_interior(card, ptrs, 1 << 20, r.step)
    (_, t), = card.interior_tables
    assert t.count == len(local)
    for k, (i, left, right) in enumerate(interior):
        assert t.W[k] == A.weights[i].data_ptr() and t.x[k] == ptrs[i]
        assert t.y[k] == (1 << 20) + k * r.step
        # a split part gets null on both sides; an inner one its neighbours
        assert t.left[k] == (None if left is None else ptrs[left])
        assert t.right[k] == (None if right is None else ptrs[right])
    if not split:
        assert card.boundary_tables == []
        return
    lands = [torch.zeros(1, 4) for _ in split]
    assert r.reach == (1, 1)
    phalo_async.fill_boundary(card, [1000 + i for i in split],
                              [l.data_ptr() for l in lands], [None] * len(split),
                              r.reach, r.m0)
    (_, b), = card.boundary_tables
    assert b.count == len(split)
    for k, i in enumerate(split):
        assert b.W[k] == A.weights[i].data_ptr() and b.y[k] == 1000 + i
        assert b.left[k] == lands[k].data_ptr() and b.right[k] is None
        # the one plane its left halo terms reach, none on the null side
        assert (b.lo[k], b.hi[k]) == (1, 0)


@pytest.mark.parametrize("left,right,reach,m0,want", [
    (1, 1, (1, 1), 32, (1, 1)),      # an inner part of the grid
    (None, 1, (1, 1), 32, (0, 1)),   # the grid's first part: no left plane
    (1, None, (2, 2), 32, (2, 0)),   # the grid's last part
    (None, None, (1, 1), 32, (0, 0)),
    (1, 1, (2, 2), 3, (3, 0)),       # m0 < 2h: the whole slab, once
    (1, 1, (2, 2), 4, (2, 2)),       # m0 = 2h: every plane, once
    (1, None, (2, 1), 1, (1, 0)),    # reach past the slab
    (None, 1, (0, 2), 5, (0, 2)),    # a stencil reaching one way
])
def test_boundary_planes_only_where_halo_terms_land(left, right, reach, m0, want):
    lo, hi = phalo_async.boundary_planes(left, right, reach, m0)
    assert (lo, hi) == want and lo + hi <= m0


def test_boundary_needs_the_interiors_inner_parts():
    """The boundary launch takes the tables of the interior launch before
    it: another ``inner`` would add an inner part's halo terms twice."""
    A = _rank_stencil([0, 1, 2, 3], 4)
    with pytest.raises(ValueError):
        phalo_async.interior_route(A, ())
    r = phalo_async.route(A, (0,))
    assert phalo_async.interior_route(A, (0,)) is r
    with pytest.raises(ValueError):
        phalo_async.interior_route(A, ())


def test_route_plan_groups_by_card():
    """One launch a card and entry: parts round-robin over two cards are all
    split; two neighbours on one card keep each other."""
    c0, c1 = "cuda:0", "cuda:1"
    assert phalo_async.route_plan(range(4), 4, [c0, c1, c0, c1], ()) == [
        (c0, ((0, None, None), (2, None, None)), (0, 2)),
        (c1, ((1, None, None), (3, None, None)), (1, 3))]
    assert phalo_async.route_plan(range(4), 4, [c0, c0, c1, c1], (0, 3)) == [
        (c0, ((0, None, 1), (1, None, None)), (1,)),
        (c1, ((2, None, None), (3, 2, None)), (2,))]
    # a part whose neighbour is on another card cannot be inner
    with pytest.raises(ValueError):
        phalo_async.route_plan(range(4), 4, [c0, c1, c0, c1], (1,))
    # a rank's positions count from its first part
    assert phalo_async.route_plan(range(2, 4), 4, [c0, c0], (1,)) == [
        (c0, ((0, None, None), (1, 0, None)), (0,))]


@pytest.mark.parametrize("S", [17, 20, 33])
def test_route_tables_in_groups_of_max_parts(S):
    """More than MAX_PARTS parts on a card take one launch a group: the
    interior tables and the boundary tables alike."""
    A = _rank_stencil(list(range(S)), S, m0=2)
    r = phalo_async.route(A, ())
    (card,) = r.cards
    M = phalo_async.MAX_PARTS
    for tables in (card.interior_tables, card.boundary_tables):
        assert [c0 for c0, _ in tables] == list(range(0, S, M))
        assert [t.count for _, t in tables] == [min(M, S - c0) for c0 in range(0, S, M)]
        assert [t.W[k] for c0, t in tables for k in range(t.count)] == [
            W.data_ptr() for W in A.weights]
    lefts = [None] + [100 + i for i in range(1, S)]
    phalo_async.fill_boundary(card, [1000 + i for i in range(S)], lefts, [None] * S,
                              r.reach, r.m0)
    assert [t.y[k] for _, t in card.boundary_tables for k in range(t.count)] == [
        1000 + i for i in range(S)]
    assert [t.left[k] for _, t in card.boundary_tables for k in range(t.count)] == lefts
    assert [t.lo[k] for _, t in card.boundary_tables for k in range(t.count)] == [
        0] + [1] * (S - 1)


def test_route_rejects_what_the_kernels_do_not_take():
    A = _rank_stencil([0, 1], 2)
    A64 = ShardedStencil([W.double() for W in A.weights], A.offsets, A.dims, A.mesh)
    with pytest.raises(TypeError):
        phalo_async.Route(A64, ())
    r = phalo_async.route(A, ())
    xs = [torch.zeros(3, 4), torch.zeros(3, 5)]
    with pytest.raises(ValueError):
        phalo_async._interior(r, xs, "halo_stencil_interior")
    with pytest.raises(ValueError):
        phalo_async._interior(r, xs[:1], "halo_stencil_interior")
    ys = [torch.zeros(3, 4), torch.zeros(3, 4)]
    bad_halo = torch.zeros(4, 8)[:, ::2]  # not contiguous
    with pytest.raises(ValueError):
        phalo_async._boundary(r, ys, [(None, bad_halo[:1]), (None, None)])
