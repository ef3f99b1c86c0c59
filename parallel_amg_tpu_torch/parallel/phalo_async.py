"""The halo stencil matvec: kernel B8 and its orchestration.

Counterpart of ``parallel_amg_tpu/parallel/phalo_async.py``, the engine of
``ShardedStencil.matvec`` under ``halo_mode="pallas_async"``.  The JAX
kernel enforces comm/compute overlap inside one Pallas call per chip:
barrier, start remote DMAs of the h boundary planes, interior stencil, wait
on the semaphores, boundary corrections.

Where the parts lie picks the CUDA path, not a flag:

- **All parts on one card** (``make_row_mesh(S)`` with one card): one launch
  of ``halo_stencil_matvec`` (``csrc/halo_stencil.cu``) per matvec computes
  every part.  A part table passed by value holds each part's W, x and y and
  its neighbors' x slabs; the halo terms read the neighbor's boundary planes
  in place, so there are no copies, streams or events.  The W pointers of
  the table are built once and kept on the ShardedStencil; y is one buffer
  viewed per part.
- **Parts on several cards**: the copy-stream path (``matvec_copy_streams``)
  keeps the JAX kernel's overlap with streams and events:

  1. each device's copy stream waits on the compute (current) stream, so x
     is ready;
  2. on the copy stream, each part's landing buffers take the neighbors' h
     boundary planes (``copy_(…, non_blocking=True)``), and an event is
     recorded per part;
  3. the compute stream launches every part's interior kernel
     (``halo_stencil_interior``);
  4. the compute stream waits on each part's event and launches its boundary
     kernel (``halo_stencil_boundary``).

  The landing buffers are allocated on the compute stream before step 1, so
  the copy stream waits for every earlier user of their memory, and
  ``record_stream`` marks them and the source slabs as used by the copy
  stream.  The parts at the grid's two ends get the zero halo (a null
  pointer).

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
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import (
    ShardedStencil,
    boundary_plain,
    halo_planes,
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


@functools.cache
def _copy_stream(index: int):
    return torch.cuda.Stream(device=index)


def matvec_copy_streams(A: ShardedStencil, x: PGrid) -> PGrid:
    """The several-card path, steps 1–4 of the module docstring over every
    part: two launches per part, the halo planes copied between them.  It
    runs on one card too (the parts' copies are then device-local)."""
    h, offsets, parts = A.halo, A.offsets, x.parts
    S = len(parts)
    rest = tuple(parts[0].shape[1:])
    # landing buffers first, on the compute streams (see the docstring)
    lands = [(None if p == 0 else torch.empty((h,) + rest, device=xl.device),
              None if p == S - 1 else torch.empty((h,) + rest, device=xl.device))
             for p, xl in enumerate(parts)]
    ready = {}
    for xl in parts:
        if xl.device not in ready:
            ready[xl.device] = torch.cuda.current_stream(xl.device).record_event()
    landed = []
    for p, xl in enumerate(parts):
        cs = _copy_stream(xl.device.index)
        for q in (p - 1, p, p + 1):
            if 0 <= q < S:
                cs.wait_event(ready[parts[q].device])
        left, right = lands[p]
        with torch.cuda.stream(cs):
            if left is not None:
                left.copy_(parts[p - 1][-h:], non_blocking=True)
                left.record_stream(cs)
                parts[p - 1].record_stream(cs)
            if right is not None:
                right.copy_(parts[p + 1][:h], non_blocking=True)
                right.record_stream(cs)
                parts[p + 1].record_stream(cs)
            landed.append(cs.record_event())
    ys = [stencil_interior(W, xl, offsets, h)
          for W, xl in zip(A.weights, parts)]
    for p, (W, y) in enumerate(zip(A.weights, ys)):
        torch.cuda.current_stream(y.device).wait_event(landed[p])
        stencil_boundary(y, W, *lands[p], offsets, h)
    return PGrid(ys, A.mesh)


class _LaunchTable:
    """What a one-card launch of A needs that does not change between
    matvecs: the part tables (one per group of MAX_PARTS parts) with their W
    pointers, the offsets, the (n1, n2) plane and whether W allows the
    four-points-a-thread route.  Built once and kept on A."""

    def __init__(self, A: ShardedStencil):
        self.device = A.weights[0].device
        (self.n1, self.n2), offs3 = grid3(A.dims[1:], A.offsets)
        self.offsets = _offsets_struct(offs3)
        self.slab = (A.m0,) + tuple(A.dims[1:])
        for W in A.weights:
            _check_weights(W, self.slab, A.offsets, self.device)
        self.tables = part_tables(A.weights)
        self.vec = self.n2 % 4 == 0 and all(W.data_ptr() % 16 == 0
                                            for W in A.weights)


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


def fill_tables(tables, xs, y_ptr: int, step: int):
    """Fill the x, y and neighbor pointers of the part ``tables`` for the
    slabs ``xs`` and the parts' y at ``y_ptr + p·step``: the left neighbor
    of part p is part p − 1's slab, the right one part p + 1's, null at the
    grid's ends.  Returns the slabs' pointers."""
    S = len(xs)
    ptrs = [xl.data_ptr() for xl in xs]
    for c0, t in tables:
        k = t.count
        t.x[:k] = ptrs[c0:c0 + k]
        t.y[:k] = [y_ptr + p * step for p in range(c0, c0 + k)]
        t.left[:k] = [ptrs[p - 1] if p > 0 else None for p in range(c0, c0 + k)]
        t.right[:k] = [ptrs[p + 1] if p < S - 1 else None
                       for p in range(c0, c0 + k)]
    return ptrs


def matvec_one_card(A: ShardedStencil, x: PGrid) -> PGrid:
    """Every part of A on one card, one ``halo_stencil_matvec`` launch per
    MAX_PARTS parts (one for every mesh up to 16 parts)."""
    lt = A.launch_table
    if lt is None:
        lt = A.launch_table = _LaunchTable(A)
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
    y = torch.empty((len(x.parts) * m0,) + slab[1:], device=dev)
    step = 4 * m0 * lt.n1 * lt.n2
    ptrs = fill_tables(lt.tables, x.parts, y.data_ptr(), step)
    vec = int(lt.vec and all(p % 16 == 0 for p in ptrs))
    for _, t in lt.tables:
        _launch("halo_stencil_matvec", dev, t, m0, lt.n1, lt.n2, A.halo,
                lt.offsets, vec)
    return PGrid(list(y.split(m0)), A.mesh)


def async_halo_matvec(A: ShardedStencil, x: PGrid) -> PGrid:
    """y = A @ x by kernel B8: one launch for the parts on one card, the
    copy-stream path for parts on several cards.

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
        out = []
        for p, (W, xl) in enumerate(zip(A.weights, x.parts)):
            y = stencil_interior(W, xl, A.offsets, h)
            out.append(stencil_boundary(y, W, *halo_planes(x.parts, p, h),
                                        A.offsets, h))
        return PGrid(out, A.mesh)
    if kinds != {"cuda"}:
        raise ValueError(f"async_halo_matvec runs on cpu or cuda parts, not {kinds}")
    if len({W.device for W in A.weights}) == 1:
        return matvec_one_card(A, x)
    return matvec_copy_streams(A, x)
