"""The ctypes binding of ``csrc/halo_stencil.cu``: its by-value structs,
its entry points, the checks of what they read and the per-card part tables.

Two modules launch its entries: ``parallel/phalo_async.py`` (kernel B8, the
sharded stencil matvec: ``halo_stencil_matvec`` and ``halo_stencil_boundary``)
and ``ops/ordered_stencil.py`` (the power iterations' ``ordered_stencil_matvec``).
Both take the same part table (``Parts``: per part W, x, y, the neighbours'
halos and D⁻¹) and the same 3-D view of a slab (``grid3``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parallel_amg_tpu_torch.ops import _build

MAX_POINTS = 192  # kMaxPoints of csrc/halo_stencil.cu
MAX_PARTS = 16    # kMaxParts of csrc/halo_stencil.cu


class Offsets(ctypes.Structure):
    """``struct HaloOffsets`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int), ("o0", ctypes.c_int * MAX_POINTS),
                ("o1", ctypes.c_int * MAX_POINTS),
                ("o2", ctypes.c_int * MAX_POINTS)]


class Terms(ctypes.Structure):
    """``struct HaloTerms`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int)] + [
        (f, ctypes.c_int * MAX_POINTS) for f in ("d", "o0", "o1", "o2")]


class Parts(ctypes.Structure):
    """``struct HaloParts`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int)] + [
        (f, ctypes.c_void_p * MAX_PARTS)
        for f in ("W", "x", "y", "left", "right", "scale")]


class Boundary(ctypes.Structure):
    """``struct HaloBoundary`` of csrc/halo_stencil.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int)] + [
        (f, ctypes.c_void_p * MAX_PARTS) for f in ("W", "y", "left", "right")] + [
        (f, ctypes.c_int * MAX_PARTS) for f in ("lo", "hi")]


_GRID = [ctypes.c_int] * 4  # m0, n1, n2, h
_ARGTYPES = {
    "halo_stencil_matvec": [Parts, *_GRID, Offsets, ctypes.c_int,
                            ctypes.c_void_p],
    "halo_stencil_boundary": [Boundary, *_GRID, Terms, ctypes.c_int,
                              ctypes.c_void_p],
    # the table, the chain's length and split, vec
    "ordered_stencil_matvec": [Parts, *_GRID, Terms, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}


@functools.cache
def kernel(symbol: str):
    """The C entry ``symbol``, built at its first use."""
    fn = getattr(_build.load("halo_stencil"), symbol)
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = ctypes.c_int
    return fn


def launch(symbol: str, device, *args) -> None:
    """One launch of the C entry ``symbol`` on ``device``'s current stream;
    raises if it fails."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


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


def halo_terms(offs3):
    """The boundary launch's terms: the offsets with o₀ ≠ 0, in offset
    order, each as (d, o₀, o₁, o₂) with d the plane of W it reads."""
    return tuple((d,) + tuple(o) for d, o in enumerate(offs3) if o[0] != 0)


def terms_struct(rows) -> Terms:
    """``Terms`` of the (d, o₀, o₁, o₂) ``rows``."""
    if len(rows) > MAX_POINTS:
        raise ValueError(f"{len(rows)} terms exceed the kernel's {MAX_POINTS}")
    s = Terms()
    s.count = len(rows)
    for i, (d, a, b, c) in enumerate(rows):
        s.d[i], s.o0[i], s.o1[i], s.o2[i] = d, a, b, c
    return s


def check_weights(W, slab, offsets):
    """W as kernel B8 takes it for a slab of shape ``slab``."""
    if W.dtype != torch.float32:
        raise TypeError(f"kernel B8 takes float32 weights, got {W.dtype}")
    if tuple(W.shape) != (len(offsets),) + tuple(slab):
        raise ValueError(f"weights {tuple(W.shape)} do not match the slab "
                         f"{tuple(slab)} and {len(offsets)} offsets")
    if not W.is_contiguous():
        raise ValueError("weights must be contiguous")


def check_slab(t, shape, device, what: str) -> int:
    """The pointer of ``t``, a contiguous float32 ``shape`` tensor on
    ``device`` (the card of its part's weights)."""
    if t.dtype != torch.float32:
        raise TypeError(f"kernel B8 takes float32, got {t.dtype} for {what}")
    if tuple(t.shape) != tuple(shape) or t.device != device or not t.is_contiguous():
        raise ValueError(f"kernel B8 takes a contiguous float32 {tuple(shape)} "
                         f"{what} on {device}, got {tuple(t.shape)} on {t.device}")
    return t.data_ptr()


def part_tables(struct, weights):
    """[(first part, table)] of ``struct`` (``Parts`` or ``Boundary``)
    for groups of MAX_PARTS parts, with the parts' W pointers filled."""
    tables = []
    for c0 in range(0, len(weights), MAX_PARTS):
        t = struct()
        t.count = min(MAX_PARTS, len(weights) - c0)
        t.W[:t.count] = [W.data_ptr() for W in weights[c0:c0 + t.count]]
        tables.append((c0, t))
    return tables


class Card:
    """One card's launches: ``interior`` as (position, left, right) per
    part (the positions of the neighbours whose slabs the launch reads in
    place, or None), the ``split`` positions a boundary launch takes, their
    part tables with the W pointers (and D⁻¹'s, from ``scales``, a tensor
    or None per position), and whether they allow four points a thread (n2
    a multiple of 4, every pointer 16-byte aligned)."""

    def __init__(self, device, interior, weights, n2: int, split=(), scales=None):
        self.device, self.interior, self.split = device, tuple(interior), tuple(split)
        self.positions = [i for i, _, _ in self.interior]
        self.interior_tables = part_tables(Parts, [weights[i] for i in self.positions])
        self.boundary_tables = part_tables(Boundary, [weights[i] for i in self.split])
        ptrs = [weights[i].data_ptr() for i in self.positions]
        if scales is not None:
            for c0, t in self.interior_tables:
                t.scale[:t.count] = [
                    None if scales[i] is None else scales[i].data_ptr()
                    for i in self.positions[c0:c0 + t.count]]
            ptrs += [scales[i].data_ptr() for i in self.positions if scales[i] is not None]
        self.vec = n2 % 4 == 0 and all(p % 16 == 0 for p in ptrs)
