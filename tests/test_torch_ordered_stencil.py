"""The power iterations' stencil matvec (``ops/ordered_stencil.py``) against
an independent formulation of the same order, bit for bit.

The reference reads x through global indices: per point a chain of
``ordered_sum.fma_plain`` from +0.0 over the planes in ``chain_order`` (the
centre's product rounded and added on the rows i1 below the split's row
bound), x read as 0 off the part's slab on axis 0 and off the grid on the
other axes; then, for a split grid, each offset with o₀ ≠ 0 in offset order
adds fma(W, x, y) on the |o₀| planes at the slab's end it reaches past, x
read in the neighbour's slab (0 past the grid's ends); then D⁻¹.  Cases:
config #3's two split levels in 4 parts and 468³'s in 8 parts scaled down,
a part of one plane (m0 = h), a reach-2 stencil, parts and one-device grids
with the centre unfused on every row, on the rows a row bound gives, and on
none.  On the card (``-m cuda``) the kernel ``ordered_stencil_matvec``
against the plain version and against the ``ordered_sum`` launches the
power iterations took before it, ``==``, one launch a card.
"""

import itertools

import numpy as np
import pytest
import torch

from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.ops import halo_kernels as hk
from parallel_amg_tpu_torch.ops import ordered_stencil, ordered_sum
from parallel_amg_tpu_torch.ops.ordered_stencil import Plan, chain_order
from parallel_amg_tpu_torch.ops.stencil import Stencil

torch.set_num_threads(2)


def _offsets(points: int, reach: int = 1):
    r = range(-reach, reach + 1)
    return tuple(o for o in itertools.product(r, repeat=3)
                 if points == 27 or sum(map(abs, o)) <= 1 or (
                     points == 13 and max(map(abs, o)) == sum(map(abs, o))))


def _problem(dims, points, parts, seed, reach=1):
    """Seeded weights (K, *dims) with signed zeros among them, D⁻¹ and x."""
    rng = np.random.default_rng(seed)
    offs = _offsets(points, reach)
    w = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = -0.0
    w[offs.index((0, 0, 0))] = rng.uniform(4.0, 8.0, size=dims).astype(np.float32)
    x = rng.uniform(-0.5, 0.5, size=dims).astype(np.float32)
    x[rng.random(dims) < 0.05] = 0.0
    d = (1.0 / w[offs.index((0, 0, 0))]).astype(np.float32)
    return offs, w, d, x


def _reference(offs, w, d, x, parts, split=None, rows=None):
    """y = D⁻¹·(A·x) per part in the order of the module, from global
    indices (see the module docstring); the split's product unfused on the
    rows i1 < ``rows`` (all where None)."""
    W, D, X = (torch.from_numpy(a) for a in (w, d, x))
    d0, n1, n2 = x.shape
    m0 = d0 // parts
    idx = np.indices((m0, n1, n2))
    sharded = parts > 1

    def read(p, off, inside_slab):
        j0 = idx[0] + off[0]
        g0 = p * m0 + j0
        j1, j2 = idx[1] + off[1], idx[2] + off[2]
        ok = (j1 >= 0) & (j1 < n1) & (j2 >= 0) & (j2 < n2)
        ok &= (j0 >= 0) & (j0 < m0) if inside_slab else (g0 >= 0) & (g0 < d0)
        v = X[np.clip(g0, 0, d0 - 1), np.clip(j1, 0, n1 - 1), np.clip(j2, 0, n2 - 1)]
        return torch.where(torch.from_numpy(ok), v, torch.zeros(()))

    out = []
    for p in range(parts):
        Wp = W[:, p * m0:(p + 1) * m0]
        acc = torch.zeros((m0, n1, n2))
        for k, dd in enumerate(chain_order(len(offs))):
            xv = read(p, offs[dd], True)
            fused = ordered_sum.fma_plain(Wp[dd], xv, acc)
            if k == split:
                row = torch.from_numpy(idx[1] < (n1 if rows is None else rows))
                fused = torch.where(row, acc + Wp[dd] * xv, fused)
            acc = fused
        for dd, off in enumerate(offs):
            if not sharded or off[0] == 0:
                continue
            end = slice(0, -off[0]) if off[0] < 0 else slice(m0 - off[0], m0)
            acc[end] = ordered_sum.fma_plain(Wp[dd][end], read(p, off, False)[end],
                                             acc[end])
        out.append(D[p * m0:(p + 1) * m0] * acc)
    return out


def _plan_and_inputs(offs, w, d, x, parts, device, split=None, rows=None):
    m0 = x.shape[0] // parts
    t = {k: torch.from_numpy(a).to(device) for k, a in (("w", w), ("d", d), ("x", x))}
    plan = Plan([t["w"][:, p * m0:(p + 1) * m0] for p in range(parts)],
                [t["d"][p * m0:(p + 1) * m0] for p in range(parts)], offs,
                sharded=parts > 1, split=split, rows=rows)
    xs = [t["x"][p * m0:(p + 1) * m0].contiguous() for p in range(parts)]
    h = plan.h
    halos = [(xs[p - 1][m0 - h:] if p > 0 else None,
              xs[p + 1][:h] if p < parts - 1 else None) for p in range(parts)]
    return plan, xs, halos if parts > 1 else None


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


# (grid, points, parts, reach): config #3's split levels in 4 parts
# (144×128×128 and 48×43×43) and 468³'s in 8 parts (504×468×468 and
# 168×156×156) scaled down, a part of one plane (m0 = h), a reach-2 stencil
CASES = [((24, 16, 12), 7, 4, 1), ((12, 9, 7), 27, 4, 1), ((16, 20, 8), 7, 8, 1),
         ((8, 12, 12), 27, 8, 1), ((8, 6, 5), 27, 8, 1), ((12, 10, 9), 13, 3, 2)]


@pytest.mark.parametrize("dims,points,parts,reach", CASES + [((16, 21, 8), 7, 8, 1),
                                                             ((16, 45, 6), 7, 8, 1)])
def test_sharded_matvec_bit_equal_to_reference(dims, points, parts, reach):
    """The parts' chains (the centre unfused on the rows ``unfused_centre``
    gives for a 7-point part with 5 ≤ n2 ≤ 8), halo terms and D⁻¹."""
    offs, w, d, x = _problem(dims, points, parts, seed=sum(dims) + points, reach=reach)
    split, rows = ordered_stencil.unfused_centre(offs, (dims[0] // parts,) + dims[1:],
                                                 sharded=True)
    plan, xs, halos = _plan_and_inputs(offs, w, d, x, parts, "cpu", split, rows)
    got = ordered_stencil.matvec(plan, xs, halos)
    for g, want in zip(got, _reference(offs, w, d, x, parts, split, rows)):
        assert torch.equal(_bits(g), _bits(want))


@pytest.mark.parametrize("dims,points,rows", [
    ((6, 8, 5), 7, 8), ((4, 8, 8), 7, 8), ((9, 7, 6), 7, 0), ((5, 6, 7), 27, 0),
    ((3, 21, 5), 7, 20), ((2, 18, 8), 7, 16)])
def test_one_device_matvec_bit_equal_to_reference(dims, points, rows):
    """One device: no halo terms; a 7-point grid with 5 ≤ n2 ≤ 8 takes the
    centre unfused on the rows ``_unfused_centre`` gives (n1 = 8 all, n1 = 7
    none, n1 = 21 and 18 all but the rows past whole vectors), the others
    one chain."""
    offs, w, d, x = _problem(dims, points, 1, seed=7 * sum(dims))
    A = Stencil(torch.from_numpy(w), offs, dims)
    split, got_rows = ds._unfused_centre(A)
    assert got_rows == rows and (split is not None) == (rows > 0)
    plan = Plan.one_device(A, torch.from_numpy(d), split, rows)
    (got,) = ordered_stencil.matvec(plan, [torch.from_numpy(x)])
    (want,) = _reference(offs, w, d, x, 1, split, rows)
    assert torch.equal(_bits(got), _bits(want))
    if split is not None:  # the split and its rows decide these bits
        for other in (0, dims[1]):
            if other != rows:
                (fused,) = _reference(offs, w, d, x, 1, split, other)
                assert not torch.equal(_bits(fused), _bits(want)), other


def test_matvec_refuses_other_devices():
    offs, w, d, x = _problem((4, 5, 6), 7, 1, seed=1)
    plan = Plan([torch.from_numpy(w)], None, offs, sharded=False)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ordered_stencil.matvec(plan, [torch.from_numpy(x).to("meta")])


@pytest.mark.parametrize("n2,with_scale", [(8, True), (8, False), (6, True)])
def test_card_tables_carry_weights_and_d_inv(n2, with_scale):
    """The kernel's part tables (``halo_kernels.Card``, shared with kernel
    B8): W and D⁻¹ of each part in position order, across groups of
    MAX_PARTS parts, null D⁻¹ where a part has none, and four points a
    thread only where n2 is a multiple of 4."""
    n = hk.MAX_PARTS + 3
    weights = [torch.zeros(7, 2, 3, n2) for _ in range(n)]
    scales = [torch.zeros(2, 3, n2) if with_scale and i % 5 else None for i in range(n)]
    card = hk.Card(torch.device("cpu"), [(i, None, None) for i in range(n)], weights, n2,
                   scales=scales)
    assert [c0 for c0, _ in card.interior_tables] == [0, hk.MAX_PARTS]
    assert card.split == () and card.boundary_tables == []
    got_w = [t.W[k] for _, t in card.interior_tables for k in range(t.count)]
    got_s = [t.scale[k] for _, t in card.interior_tables for k in range(t.count)]
    assert got_w == [W.data_ptr() for W in weights]
    assert got_s == [None if s is None else s.data_ptr() for s in scales]
    ptrs = got_w + [p for p in got_s if p is not None]
    assert card.vec == (n2 % 4 == 0 and all(p % 16 == 0 for p in ptrs))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,points,parts,reach", CASES + [
    ((6, 8, 5), 7, 1, 1), ((33, 20, 17), 27, 1, 1), ((3, 21, 5), 7, 1, 1),
    ((2, 18, 8), 7, 1, 1), ((16, 21, 8), 7, 8, 1), ((16, 45, 6), 7, 8, 1)])
def test_kernel_bit_equal_to_plain_cuda(dims, points, parts, reach):
    """The kernel against the plain version and the earlier launch sequence
    (a stack, ``ordered_sum_lanes`` and ``ordered_fma``), one launch; the
    centre unfused on the rows ``unfused_centre`` gives (n2 = 8 with four
    points a thread, n2 = 5 and 6 with one)."""
    if not torch.cuda.is_available():
        pytest.skip("ordered_stencil_matvec is CUDA C++ and needs a CUDA card")
    offs, w, d, x = _problem(dims, points, parts, seed=sum(dims) + points, reach=reach)
    split, rows = ordered_stencil.unfused_centre(offs, (dims[0] // parts,) + dims[1:],
                                                 sharded=parts > 1)
    plan, xs, halos = _plan_and_inputs(offs, w, d, x, parts, "cuda", split, rows)
    before = ordered_sum.LAUNCHES["ordered_stencil_matvec"]
    got = ordered_stencil.matvec(plan, xs, halos)
    assert ordered_sum.LAUNCHES["ordered_stencil_matvec"] == before + 1
    halos = halos or [(None, None)] * parts
    plain = ordered_stencil.matvec_plain(plan, xs, halos)
    seq = ordered_stencil.matvec_plain(plan, xs, halos, launch=True)
    for g, p, s, want in zip(got, plain, seq, _reference(offs, w, d, x, parts, split, rows)):
        assert torch.equal(_bits(g), _bits(p))
        assert torch.equal(_bits(g), _bits(s))
        assert torch.equal(_bits(g), _bits(want))
