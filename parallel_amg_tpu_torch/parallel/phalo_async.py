"""The halo stencil matvec: kernel B8 and its orchestration.

Counterpart of ``parallel_amg_tpu/parallel/phalo_async.py``, the engine of
``ShardedStencil.matvec`` under ``halo_mode="pallas_async"``.  The JAX
kernel enforces comm/compute overlap inside one Pallas call per chip:
barrier, start remote DMAs of the h boundary planes, interior stencil, wait
on the semaphores, boundary corrections.

Where the parts lie picks the CUDA path, not a flag:

- **All parts on one card in one process** (``make_row_mesh(S)`` with one
  card): one launch of ``halo_stencil_matvec`` (``csrc/halo_stencil.cu``)
  per matvec computes every part.  A part table passed by value holds each
  part's W, x and y and its neighbors' x slabs; the halo terms read the
  neighbor's boundary planes in place, so there are no copies, streams or
  events.  The W pointers of the table are built once and kept on the
  ShardedStencil; y is one buffer viewed per part.
- **Parts on several cards or processes**: the exchange path
  (``matvec_copy_streams``) keeps the JAX kernel's overlap:

  1. ``exchange.start_halos`` starts the halo exchange: planes bound for
     another card are copied on its copy stream, and planes bound for
     another process are staged to the host on a side stream (gloo);
  2. the compute stream launches the interior kernel
     (``halo_stencil_interior``) of every part that has a halo to wait for;
  3. the halos arrive (``wait``: the point-to-point messages between
     processes, the copy streams' events) and each such part's boundary
     kernel (``halo_stencil_boundary``) runs.

  In a multi-process run the local parts whose neighbours all lie in the
  same process and on one card take one ``halo_stencil_matvec`` launch
  between steps 1 and 2, as on one card.  The parts at the grid's two ends
  get the zero halo (a null pointer).

Every sum is taken in a fixed order, so the result does not depend on timing,
and both paths equal the "xla" path bit for bit.  On the CPU each part runs
the kernels' plain version, the "xla" formulation of ``parallel/pstencil.py``
(``interior_plain``, ``boundary_plain``); a CUDA part launches the kernels or
raises.  ``LAUNCHES`` counts the launches of the three entry points.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parallel_amg_tpu_torch.ops import _build
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

MAX_POINTS = 192  # kMaxPoints of csrc/halo_stencil.cu
MAX_PARTS = 16    # kMaxParts of csrc/halo_stencil.cu


class _Offsets(ctypes.Structure):
    """``struct HaloOffsets`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int), ("o0", ctypes.c_int * MAX_POINTS),
                ("o1", ctypes.c_int * MAX_POINTS),
                ("o2", ctypes.c_int * MAX_POINTS)]


class _Parts(ctypes.Structure):
    """``struct HaloParts`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int)] + [
        (f, ctypes.c_void_p * MAX_PARTS)
        for f in ("W", "x", "y", "left", "right")]


_ARGTYPES = {
    "halo_stencil_matvec": [_Parts, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, _Offsets, ctypes.c_int,
                            ctypes.c_void_p],
    "halo_stencil_interior": [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _Offsets,
        ctypes.c_void_p],
    "halo_stencil_boundary": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _Offsets,
        ctypes.c_void_p],
}


@functools.cache
def _kernel(symbol: str):
    fn = getattr(_build.load("halo_stencil"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def grid3(rest, offsets):
    """(n1, n2) and 3-D offsets of a slab (m0, *rest) with at most two
    non-sharded axes: a 2-D grid is (m0, 1, n), a 1-D one (m0, 1, 1)."""
    nd = len(rest) + 1
    if nd > 3:
        raise ValueError(f"kernel B8 takes grids of up to 3 axes, not {nd}")
    pad = 3 - nd
    n1, n2 = ((1,) * pad + tuple(rest))
    offs3 = tuple((o[0],) + (0,) * pad + tuple(o[1:]) for o in offsets)
    return (int(n1), int(n2)), offs3


@functools.lru_cache(maxsize=256)
def _offsets_struct(offs3) -> _Offsets:
    if len(offs3) > MAX_POINTS:
        raise ValueError(f"{len(offs3)} offsets exceed the kernel's {MAX_POINTS}")
    s = _Offsets()
    s.count = len(offs3)
    for i, (a, b, c) in enumerate(offs3):
        s.o0[i], s.o1[i], s.o2[i] = a, b, c
    return s


def _launch(symbol: str, device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    LAUNCHES[symbol] += 1


def _check_weights(W, slab, offsets, device):
    """W as kernel B8 takes it for a slab of shape ``slab`` on ``device``."""
    if W.dtype != torch.float32:
        raise TypeError(f"kernel B8 takes float32 weights, got {W.dtype}")
    if tuple(W.shape) != (len(offsets),) + tuple(slab):
        raise ValueError(f"weights {tuple(W.shape)} do not match the slab "
                         f"{tuple(slab)} and {len(offsets)} offsets")
    if W.device != device or W.device.type != "cuda":
        raise ValueError(f"weights on {W.device} and slab on {device}: "
                         "kernel B8 needs both on one CUDA device")
    if not W.is_contiguous():
        raise ValueError("weights must be contiguous")


def _check_part(W, xl, offsets):
    if xl.dtype != torch.float32:
        raise TypeError(f"kernel B8 takes float32, got {xl.dtype}")
    _check_weights(W, xl.shape, offsets, xl.device)
    if not xl.is_contiguous():
        raise ValueError("the slab must be contiguous")


def stencil_interior(W, xl, offsets, h: int):
    """Interior contribution of one part (zero halo): plain on the CPU,
    ``halo_stencil_interior`` on a CUDA tensor."""
    if xl.device.type == "cpu":
        return interior_plain(W, xl, offsets, h)
    _check_part(W, xl, offsets)
    (n1, n2), offs3 = grid3(xl.shape[1:], offsets)
    y = torch.empty_like(xl)
    _launch("halo_stencil_interior", xl.device, W.data_ptr(), xl.data_ptr(),
            y.data_ptr(), xl.shape[0], n1, n2, _offsets_struct(offs3))
    return y


def stencil_boundary(y, W, left, right, offsets, h: int):
    """Add one part's boundary corrections to y in place (halos None at the
    grid's ends): plain on the CPU, ``halo_stencil_boundary`` on CUDA."""
    if y.device.type == "cpu":
        return boundary_plain(y, W, left, right, offsets, h)
    _check_part(W, y, offsets)
    halo_shape = (h,) + tuple(y.shape[1:])
    for halo in (left, right):
        if halo is not None and (tuple(halo.shape) != halo_shape
                                 or halo.dtype != torch.float32
                                 or halo.device != y.device
                                 or not halo.is_contiguous()):
            raise ValueError(f"a halo must be a contiguous float32 {halo_shape} "
                             f"tensor on {y.device}")
    (n1, n2), offs3 = grid3(y.shape[1:], offsets)
    _launch("halo_stencil_boundary", y.device, W.data_ptr(),
            None if left is None else left.data_ptr(),
            None if right is None else right.data_ptr(), y.data_ptr(),
            y.shape[0], n1, n2, h, _offsets_struct(offs3))
    return y


def matvec_copy_streams(A: ShardedStencil, x: PGrid, one_launch=()) -> PGrid:
    """The exchange path, steps 1–3 of the module docstring: two launches
    per part, the halo exchange between them.  The local parts at the
    positions ``one_launch`` (neighbours all local, on one card) take one
    ``halo_stencil_matvec`` launch instead.  It runs on one card too (the
    halos are then views of the neighbours' slabs)."""
    h, offsets, parts = A.halo, A.offsets, x.parts
    pending = exchange.start_halos(parts, h)
    ys = [None] * len(parts)
    if one_launch:
        for i, y in zip(one_launch, one_launch_parts(A, x, one_launch)):
            ys[i] = y
    split = [i for i in range(len(parts)) if ys[i] is None]
    for i in split:
        ys[i] = stencil_interior(A.weights[i], parts[i], offsets, h)
    halos = pending.wait()
    for i in split:
        stencil_boundary(ys[i], A.weights[i], *halos[i], offsets, h)
    return PGrid(ys, A.mesh)


class _LaunchTable:
    """What a one-card launch of A's local parts at the positions ``which``
    needs that does not change between matvecs: the part tables (one per
    group of MAX_PARTS parts) with their W pointers, the offsets, the (n1,
    n2) plane and whether W allows the four-points-a-thread route.  Built
    once and kept on A."""

    def __init__(self, A: ShardedStencil, which):
        self.which = tuple(which)
        weights = [A.weights[i] for i in self.which]
        self.device = weights[0].device
        (self.n1, self.n2), offs3 = grid3(A.dims[1:], A.offsets)
        self.offsets = _offsets_struct(offs3)
        self.slab = (A.m0,) + tuple(A.dims[1:])
        for W in weights:
            _check_weights(W, self.slab, A.offsets, self.device)
        self.tables = part_tables(weights)
        self.vec = self.n2 % 4 == 0 and all(W.data_ptr() % 16 == 0
                                            for W in weights)


def part_tables(weights):
    """[(first part, part table)] for groups of MAX_PARTS parts, with the
    parts' W pointers filled."""
    tables = []
    for c0 in range(0, len(weights), MAX_PARTS):
        t = _Parts()
        t.count = min(MAX_PARTS, len(weights) - c0)
        t.W[:t.count] = [W.data_ptr() for W in weights[c0:c0 + t.count]]
        tables.append((c0, t))
    return tables


def fill_tables(tables, xs, y_ptr: int, step: int, lefts=None, rights=None):
    """Fill the x, y and neighbor pointers of the part ``tables`` for the
    slabs ``xs`` and the parts' y at ``y_ptr + p·step``: by default the
    left neighbor of part p is part p − 1's slab, the right one part
    p + 1's, null at the grid's ends; ``lefts`` and ``rights`` give them per
    part instead.  Returns the slabs' pointers."""
    ptrs = [xl.data_ptr() for xl in xs]
    if lefts is None:
        lefts = [None] + ptrs[:-1]
        rights = ptrs[1:] + [None]
    for c0, t in tables:
        k = t.count
        t.x[:k] = ptrs[c0:c0 + k]
        t.y[:k] = [y_ptr + p * step for p in range(c0, c0 + k)]
        t.left[:k] = lefts[c0:c0 + k]
        t.right[:k] = rights[c0:c0 + k]
    return ptrs


def matvec_one_card(A: ShardedStencil, x: PGrid) -> PGrid:
    """Every part of A on one card, one ``halo_stencil_matvec`` launch per
    MAX_PARTS parts (one for every mesh up to 16 parts)."""
    return PGrid(one_launch_parts(A, x, range(len(x.parts))), A.mesh)


def one_launch_parts(A: ShardedStencil, x: PGrid, which):
    """y of A's local parts at the positions ``which``, on one card with
    their neighbours: one ``halo_stencil_matvec`` launch per MAX_PARTS of
    them.  Returns their y, in the order of ``which``."""
    which = tuple(which)
    lt = A.launch_table
    if lt is None or lt.which != which:
        lt = A.launch_table = _LaunchTable(A, which)
    dev, slab = lt.device, lt.slab
    if len(x.parts) != len(A.weights):
        raise ValueError(f"{len(x.parts)} slabs for {len(A.weights)} parts")
    for xl in x.parts:
        if (xl.dtype != torch.float32 or xl.device != dev
                or xl.shape != slab or not xl.is_contiguous()):
            raise ValueError(f"kernel B8 takes contiguous float32 {slab} slabs "
                             f"on {dev}, got {xl.dtype} {tuple(xl.shape)} on "
                             f"{xl.device}")
    m0 = slab[0]
    y = torch.empty((len(which) * m0,) + slab[1:], device=dev)
    step = 4 * m0 * lt.n1 * lt.n2
    local, S = list(A.mesh.local), A.mesh.size

    def neighbour(i, d):
        return None if not 0 <= local[i] + d < S else x.parts[i + d].data_ptr()

    ptrs = fill_tables(lt.tables, [x.parts[i] for i in which], y.data_ptr(),
                       step, [neighbour(i, -1) for i in which],
                       [neighbour(i, 1) for i in which])
    vec = int(lt.vec and all(p % 16 == 0 for p in ptrs)
              and all(x.parts[i].data_ptr() % 16 == 0 for i in range(len(x.parts))))
    for _, t in lt.tables:
        _launch("halo_stencil_matvec", dev, t, m0, lt.n1, lt.n2, A.halo,
                lt.offsets, vec)
    return list(y.split(m0))


def _inner_parts(A: ShardedStencil):
    """Positions of the local parts whose neighbours are local too."""
    local, S = list(A.mesh.local), A.mesh.size
    return tuple(i for i, p in enumerate(local)
                 if all(q in A.mesh.local or not 0 <= q < S
                        for q in (p - 1, p + 1)))


def async_halo_matvec(A: ShardedStencil, x: PGrid) -> PGrid:
    """y = A @ x by kernel B8: one launch for the parts on one card in one
    process, the exchange path where parts lie on several cards or
    processes (with one launch for the parts whose neighbours are local).

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
    if len({W.device for W in A.weights}) > 1:
        return matvec_copy_streams(A, x)
    if A.mesh.world == 1:
        return matvec_one_card(A, x)
    return matvec_copy_streams(A, x, _inner_parts(A))
