"""The halo stencil matvec: kernel B8 and its orchestration.

Counterpart of ``parallel_amg_tpu/parallel/phalo_async.py``, the engine of
``ShardedStencil.matvec`` under ``halo_mode="pallas_async"``.  The JAX
kernel enforces comm/compute overlap inside one Pallas call per chip:
barrier, start remote DMAs of the h boundary planes, interior stencil, wait
on the semaphores, boundary corrections.

Where the parts lie picks the CUDA path, not a flag.  A local part is
*inner* when its neighbours on the grid lie in this process and on its own
card (``inner_parts``), else *split*:

- **Every part inner** (one process, one card: ``make_row_mesh(S)`` with
  one card): one launch of ``halo_stencil_matvec`` (``csrc/halo_stencil.cu``)
  per matvec computes every part.  A part table passed by value holds each
  part's W, x and y and its neighbors' x slabs; the halo terms read the
  neighbor's boundary planes in place, so there are no copies, streams or
  events.
- **Some part split** (parts on several cards or processes): the exchange
  route (``matvec_copy_streams``) keeps the JAX kernel's overlap:

  1. ``exchange.start_halos`` starts the halo exchange: planes bound for
     another card are copied on its copy stream, and planes bound for
     another process are staged to the host on a side stream (gloo);
  2. ``stencil_interior``: one launch a card of ``halo_stencil_matvec``
     over every local part on the card (counted as
     ``halo_stencil_interior``): the inner parts whole, with their
     neighbours' slabs, and the split parts with null on both sides, so
     they get their interior terms only;
  3. the halos arrive (``wait``: the point-to-point messages between
     processes, the copy streams' events) and ``stencil_boundary`` adds
     every split part's halo terms from its landing buffers in one
     ``halo_stencil_boundary`` launch a card, on the planes they reach.

  So a rank's route is two launches a matvec.  The parts at the grid's two
  ends get the zero halo (a null pointer).

The launch tables (``Route``: per card the part tables with their W
pointers, the offsets and the halo terms, the offsets with o0 ≠ 0
compacted in offset order) are built once and kept on the ShardedStencil;
each matvec fills in the x, y and halo pointers, and each card's parts write
one y buffer, viewed per part.  A card holds MAX_PARTS parts a launch.  The
boundary launch reaches, per split part, the planes its halo terms land on:
none on a side with no neighbour.

Every sum is taken in a fixed order, so the result does not depend on timing,
and both paths equal the "xla" path bit for bit.  On the CPU each part runs
the kernels' plain version, the "xla" formulation of ``parallel/pstencil.py``
(``interior_plain``, then ``boundary_plain``: every part is split there); a
CUDA part launches the kernels or raises.  ``LAUNCHES`` counts the launches
of the one-launch matvec and the route's interior and boundary (launches,
not parts).
"""

from __future__ import annotations

import functools

import torch

from parallel_amg_tpu_torch.ops.halo_kernels import (
    MAX_PARTS,
    MAX_POINTS,
    Card,
    Offsets,
    Terms,
    check_slab,
    check_weights,
    grid3,
    halo_terms,
    launch,
    terms_struct,
)
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import (
    ShardedStencil,
    boundary_plain,
    interior_plain,
)

# kernel launches by entry point; callers may reset them
LAUNCHES = {"halo_stencil_matvec": 0, "halo_stencil_interior": 0,
            "halo_stencil_boundary": 0}


@functools.lru_cache(maxsize=256)
def _offsets_struct(offs3) -> Offsets:
    if len(offs3) > MAX_POINTS:
        raise ValueError(f"{len(offs3)} offsets exceed the kernel's {MAX_POINTS}")
    s = Offsets()
    s.count = len(offs3)
    for i, (a, b, c) in enumerate(offs3):
        s.o0[i], s.o1[i], s.o2[i] = a, b, c
    return s


@functools.lru_cache(maxsize=256)
def _terms_struct(offs3) -> Terms:
    return terms_struct(halo_terms(offs3))


def _launch(symbol: str, key: str, device, *args) -> None:
    """One launch of the C entry ``symbol``, counted under ``key``."""
    launch(symbol, device, *args)
    LAUNCHES[key] += 1


def inner_parts(A: ShardedStencil):
    """Positions of the local parts whose neighbours on the grid lie in this
    process and on the part's own card: the parts that one launch computes
    whole."""
    local, S = list(A.mesh.local), A.mesh.size
    devices = [W.device for W in A.weights]

    def inner(i):
        for q in (local[i] - 1, local[i] + 1):
            j = q - local[0]
            if 0 <= q < S and not (0 <= j < len(local) and devices[j] == devices[i]):
                return False
        return True

    return tuple(i for i in range(len(local)) if inner(i))


def route_plan(local, size: int, devices, inner):
    """The launches of a process's parts, per card in order of first
    appearance: (device, interior, split).  ``interior`` lists every local
    part on the card as (position, left, right), the positions of the
    neighbours whose slabs its interior launch reads in place: an inner
    part's neighbours (None at the grid's ends), None on both sides of a
    split part.  ``split`` lists the positions the boundary launch takes."""
    local, inner = list(local), set(inner)
    cards = {}
    for i, p in enumerate(local):
        interior, split = cards.setdefault(devices[i], ([], []))
        if i not in inner:
            interior.append((i, None, None))
            split.append(i)
            continue
        sides = []
        for q in (p - 1, p + 1):
            j = q - local[0]
            if not 0 <= q < size:
                sides.append(None)
            elif 0 <= j < len(local) and devices[j] == devices[i]:
                sides.append(j)
            else:
                raise ValueError(f"part {p} is not inner: its neighbour {q} is "
                                 "not on its card in this process")
        interior.append((i, *sides))
    return [(dev, tuple(a), tuple(b)) for dev, (a, b) in cards.items()]


class Route:
    """What B8's launches for A's local parts need that does not change
    between matvecs, for the inner parts at the positions ``inner``: the
    offsets, the compacted halo terms, how many planes the halo terms reach
    from each side (``reach``: left, right), the (n1, n2) plane and per card
    (``Card``) the part tables with their W pointers.  Built once and kept
    on A (``A.launch_table``): do not swap a part's weight tensor after
    that."""

    def __init__(self, A: ShardedStencil, inner):
        self.inner = tuple(inner)
        (self.n1, self.n2), offs3 = grid3(A.dims[1:], A.offsets)
        self.offsets = _offsets_struct(offs3)
        self.terms = _terms_struct(offs3)
        o0 = [o[0] for o in offs3]
        self.reach = (max([-o for o in o0 if o < 0], default=0),
                      max([o for o in o0 if o > 0], default=0))
        self.m0, self.h = A.m0, A.halo
        self.slab = (A.m0,) + tuple(A.dims[1:])
        for W in A.weights:
            check_weights(W, self.slab, A.offsets)
        self.n_parts = len(A.weights)
        self.cards = [Card(dev, interior, A.weights, self.n2, split)
                      for dev, interior, split in route_plan(
                          A.mesh.local, A.mesh.size,
                          [W.device for W in A.weights], self.inner)]

    @property
    def step(self) -> int:
        """Bytes between two parts' y in a card's buffer."""
        return 4 * self.m0 * self.n1 * self.n2


def route(A: ShardedStencil, inner) -> Route:
    """A's launch tables for the inner parts ``inner``, built at the first
    call and kept on A while ``inner`` stays the same."""
    r = A.launch_table
    if r is None or r.inner != tuple(inner):
        r = A.launch_table = Route(A, inner)
    return r


def interior_route(A: ShardedStencil, inner) -> Route:
    """The launch tables of A's last interior launch, which must have been
    for the inner parts ``inner``: a boundary launch for other inner parts
    would add an inner part's halo terms twice or leave a split part's
    out."""
    r = A.launch_table
    if r is None or r.inner != tuple(inner):
        raise ValueError(f"a boundary launch for the inner parts {tuple(inner)} "
                         "after an interior launch for "
                         f"{'none' if r is None else r.inner}")
    return r


def fill_interior(card: Card, ptrs, y_ptr: int, step: int) -> None:
    """The x, y and neighbour pointers of a card's interior tables: ``ptrs``
    maps a position to its x slab's pointer, part k of the card writes
    ``y_ptr + k·step``."""
    for c0, t in card.interior_tables:
        rows = card.interior[c0:c0 + t.count]
        t.x[:t.count] = [ptrs[i] for i, _, _ in rows]
        t.y[:t.count] = [y_ptr + k * step for k in range(c0, c0 + t.count)]
        t.left[:t.count] = [None if l is None else ptrs[l] for _, l, _ in rows]
        t.right[:t.count] = [None if r is None else ptrs[r] for _, _, r in rows]


def boundary_planes(left, right, reach, m0: int):
    """(lo, hi): the planes at a slab's start and end that a split part's
    halo terms reach, none on a side with no landing buffer (None), the
    whole slab as (m0, 0) where the two sides overlap."""
    lo = reach[0] if left is not None else 0
    hi = reach[1] if right is not None else 0
    return (m0, 0) if lo + hi > m0 else (lo, hi)


def fill_boundary(card: Card, y_ptrs, lefts, rights, reach, m0: int) -> None:
    """The y and landing-buffer pointers of a card's boundary tables, one
    of each per split part in ``card.split`` order (None: the zero halo),
    and each part's planes (``boundary_planes``)."""
    for c0, t in card.boundary_tables:
        for k in range(t.count):
            left, right = lefts[c0 + k], rights[c0 + k]
            t.y[k], t.left[k], t.right[k] = y_ptrs[c0 + k], left, right
            t.lo[k], t.hi[k] = boundary_planes(left, right, reach, m0)


def _interior(r: Route, xs, key: str):
    """y of every local part: one ``halo_stencil_matvec`` launch a card (and
    MAX_PARTS parts), counted under ``key``, the inner parts whole, the
    split ones their interior terms."""
    if len(xs) != r.n_parts:
        raise ValueError(f"{len(xs)} slabs for {r.n_parts} parts")
    m0, step = r.m0, r.step
    ys = [None] * len(xs)
    for card in r.cards:
        ptrs = {i: check_slab(xs[i], r.slab, card.device, "slab")
                for i in card.positions}
        y = torch.empty((len(card.positions) * m0,) + r.slab[1:], device=card.device)
        fill_interior(card, ptrs, y.data_ptr(), step)
        vec = int(card.vec and y.data_ptr() % 16 == 0)
        for _, t in card.interior_tables:
            _launch("halo_stencil_matvec", key, card.device, t, m0, r.n1, r.n2, r.h,
                    r.offsets, vec)
        for i, yi in zip(card.positions, y.split(m0)):
            ys[i] = yi
    return ys


def _boundary(r: Route, ys, halos) -> None:
    """Add every split part's halo terms to its y in place: one
    ``halo_stencil_boundary`` launch a card (and MAX_PARTS parts)."""
    halo_shape = (r.h,) + r.slab[1:]

    def landing(t, dev):
        return None if t is None else check_slab(t, halo_shape, dev, "halo")

    for card in r.cards:
        if not card.split:
            continue
        y_ptrs = [check_slab(ys[i], r.slab, card.device, "y") for i in card.split]
        fill_boundary(card, y_ptrs, [landing(halos[i][0], card.device) for i in card.split],
                      [landing(halos[i][1], card.device) for i in card.split],
                      r.reach, r.m0)
        vec = int(card.vec and all(p % 16 == 0 for p in y_ptrs))
        for _, t in card.boundary_tables:
            _launch("halo_stencil_boundary", "halo_stencil_boundary", card.device, t,
                    r.m0, r.n1, r.n2, r.h, r.terms, vec)


def _on_cpu(tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def stencil_interior(A: ShardedStencil, x: PGrid, inner=()):
    """Every local part's y before its halo terms, as a list: plain on the
    CPU (each part's ``interior_plain``, zero halo); on CUDA one interior
    launch a card, in which the parts at the positions ``inner`` come out
    whole and the others with their interior terms.  A card's parts' y are
    views of one buffer."""
    if _on_cpu(x.parts):
        return [interior_plain(W, xl, A.offsets, A.halo)
                for W, xl in zip(A.weights, x.parts)]
    return _interior(route(A, inner), x.parts, "halo_stencil_interior")


def stencil_boundary(A: ShardedStencil, ys, halos, inner=()):
    """Add the halo terms to ``ys`` in place (``halos``: per part (left,
    right), None at the grid's ends), after ``stencil_interior``: plain on
    the CPU (``boundary_plain`` for every part); on CUDA one
    ``halo_stencil_boundary`` launch a card for the parts not in
    ``inner``, which must be the ``inner`` of the ``stencil_interior`` call
    that made ``ys`` (it raises otherwise: an inner part would get its halo
    terms twice)."""
    if _on_cpu(ys):
        for y, W, (left, right) in zip(ys, A.weights, halos):
            boundary_plain(y, W, left, right, A.offsets, A.halo)
        return ys
    _boundary(interior_route(A, inner), ys, halos)
    return ys


def matvec_copy_streams(A: ShardedStencil, x: PGrid, inner=()) -> PGrid:
    """The exchange route, steps 1–3 of the module docstring: the halo
    exchange started, one interior launch a card, the halos waited for,
    one boundary launch a card.  The local parts at the positions ``inner``
    (neighbours on their card in this process) come out of the interior
    launch whole.  It runs on one card too (the halos are then views of the
    neighbours' slabs)."""
    pending = exchange.start_halos(x.parts, A.halo)
    ys = stencil_interior(A, x, inner)
    stencil_boundary(A, ys, pending.wait(), inner)
    return PGrid(ys, A.mesh)


def matvec_one_card(A: ShardedStencil, x: PGrid) -> PGrid:
    """Every part of A on one card, whole: one ``halo_stencil_matvec``
    launch per MAX_PARTS parts (one for every mesh up to 16 parts)."""
    r = route(A, range(len(A.weights)))
    return PGrid(_interior(r, x.parts, "halo_stencil_matvec"), A.mesh)


def async_halo_matvec(A: ShardedStencil, x: PGrid) -> PGrid:
    """y = A @ x by kernel B8: one launch where every local part is inner
    (one process, one card), else the exchange route.

    The JAX package's rule stays: with no halo, one part, or a slab no
    thicker than the halo (m0 ≤ h: no interior to overlap with) the matvec
    takes the plain "xla" path.
    """
    S = A.mesh.size
    h = A.halo
    if h == 0 or S == 1 or A.m0 <= h:
        return ShardedStencil.matvec(A.with_halo_mode("xla"), x)
    kinds = {xl.device.type for xl in x.parts}
    if kinds == {"cpu"}:
        return matvec_copy_streams(A, x)
    if kinds != {"cuda"}:
        raise ValueError(f"async_halo_matvec runs on cpu or cuda parts, not {kinds}")
    inner = inner_parts(A)
    if len(inner) == len(A.weights):
        return matvec_one_card(A, x)
    return matvec_copy_streams(A, x, inner)
