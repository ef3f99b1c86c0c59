"""One stage of the bucketed ("transfer-first") Galerkin product in the JAX
package's CPU order, and the binding of its kernel ``ordered_bucket_stage``
(``csrc/ordered_sum.cu``).

A stage computes Y[O](p) = Σ_off factor_off(p) · X[O − δ_off(p)](p + off)
over coarse offsets O in a box (``amg/device_setup.bucketed_coarse_operator``
takes three).  Each fine offset ``off`` reaches, from p, the coarse shift
δ_off(p) = (p mod b + off) div b, one of the deltas of ``delta_support``;
an update is one (off, δ) pair, its factor masked to the points whose δ it
is (select(mask, factor, 0)), its X read at p + off (0 off the grid), and
its target the box offsets O for which O − δ lies in X's box.  The order is
XLA's CPU code for the JAX package's stage (read off its optimised HLO and
object code; ``tests/test_torch_galerkin_order.py`` holds it): the updates
that cover the whole output box first, in program order, except that the
first two swap places (the first product fused into the rounded second),
each later one a fused multiply-add; then every sliced update in program
order, a fused multiply-add into its slice.  With no whole-box update the
stage starts from +0 and takes its first slice's rounded product.

Inside the JAX package's whole jitted product (``_jit_bucketed``) LLVM
departs from that order at some grids (``Order``, ``product_orders``): a
product computed in another basic block than its add is rounded and then
added (kind 2); a sliced update's scalar remainder loop on the last axis
adds its product rounded from a column R on (``Term.tail``); XLA's
simplifier stores a product where it sees zeros (kind 0); and a consumer
fusion that recomputes the previous stage's last update may round its
product (the next stage's terms of those offsets read that ``alt`` X).

``terms`` lists the updates in that order (``Term``).  ``stage`` makes it
and runs ``stage_plain`` (torch over the list, each float32 fused
multiply-add ``ordered_sum.fma_plain``; other types in torch's order, a
rounded product and a rounded add) on CPU tensors and on types other than
float32, and on float32 CUDA tensors one ``ordered_bucket_stage`` launch
(the kernel's design is in ``csrc/ordered_sum.cu``) over the table
``kernel_table`` builds, kept on the card per stage shape
(``_device_table``).  The kernel takes grids of one to three axes.  A failed
build or launch raises.  ``ordered_sum.LAUNCHES["ordered_bucket_stage"]``
counts the launches.
"""

from __future__ import annotations

import functools
import itertools
import math
import warnings
from typing import NamedTuple

import numpy as np
import torch

from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.ops.stencil import shift_nd

TERM_INTS = 12  # csrc/ordered_sum.cu's kTermInts
BOX_GROUP = 27  # csrc/ordered_sum.cu's kBoxGroup
NO_TAIL = 1 << 30  # a tail bound past every grid: the term's kind everywhere


class Term(NamedTuple):
    """One update of a stage: ``kind`` 0 (store the rounded product), 1
    (fused multiply-add) or 2 (add the rounded product), the factor plane
    ``k``, the fine offset, δ, the target and source slices of the output
    and input boxes; on the last axis from column ``tail`` on the product
    is added rounded (kind 2); ``alt``: X is read from the previous stage's
    ``alt`` output."""
    kind: int
    k: int
    off: tuple
    delta: tuple
    tgt: tuple
    src: tuple
    tail: int = NO_TAIL
    alt: bool = False


class Order(NamedTuple):
    """A stage's departures from the module's order: ``rounded`` maps an
    update (off, δ) to the column R from which its product is added rounded
    (0: everywhere), ``store`` lists updates that store their rounded
    product, ``alt`` the offsets whose terms read the previous stage's
    ``alt`` output (its last update added rounded)."""
    rounded: tuple = ()
    store: tuple = ()
    alt: tuple = ()


def delta_support(off, b: int):
    """Support of δ(p) = (p%b + off)//b, per axis then product."""
    axes = [sorted({(r + off[i]) // b for r in range(b)})
            for i in range(len(off))]
    return list(itertools.product(*axes))


def residue_mask(dims, off, delta, b: int, device):
    """Indicator of δ_off(p) == delta (bool), broadcastable to dims."""
    m = None
    for i in range(len(dims)):
        shape = [1] * len(dims)
        shape[i] = dims[i]
        r = torch.arange(dims[i], device=device).reshape(shape) % b
        c = ((r + off[i]) // b) == delta[i]
        m = c if m is None else (m & c)
    return m


def updates(offsets, box_in, box_out, b: int):
    """The stage's (off, k, δ, tgt, src) updates in program order, split
    into those that cover the whole output box and the sliced ones; an
    update whose target is empty is dropped."""
    nd = len(offsets[0])
    out_shape = tuple(h - l + 1 for l, h in box_out)
    full, part = [], []
    for k, off in enumerate(offsets):
        for delta in delta_support(off, b):
            tgt, src = [], []
            for i in range(nd):
                lo = max(box_out[i][0], box_in[i][0] + delta[i])
                hi = min(box_out[i][1], box_in[i][1] + delta[i])
                if lo > hi:
                    break
                tgt.append(slice(lo - box_out[i][0], hi - box_out[i][0] + 1))
                src.append(slice(lo - delta[i] - box_in[i][0],
                                 hi - delta[i] - box_in[i][0] + 1))
            else:
                whole = all(t.stop - t.start == n for t, n in zip(tgt, out_shape))
                (full if whole else part).append(
                    (tuple(off), k, tuple(delta), tuple(tgt), tuple(src)))
    return full, part


def terms(offsets, box_in, box_out, b: int, order: Order | None = None) -> list:
    """The stage's terms in the JAX package's CPU order (module docstring),
    with ``order``'s departures."""
    full, part = updates(offsets, box_in, box_out, b)
    if len(full) >= 2:
        full = [full[1], full[0]] + full[2:]
    order = order or Order()
    rounded, store, alt = dict(order.rounded), set(order.store), set(order.alt)
    out = []
    for i, (off, k, delta, tgt, src) in enumerate(full + part):
        kind, tail = (0 if i == 0 else 1), NO_TAIL
        if (off, delta) in store:
            kind = 0
        elif (off, delta) in rounded:
            tail = rounded[(off, delta)]
            kind = 2 if tail == 0 else kind
        out.append(Term(kind, k, off, delta, tgt, src, tail if tail else NO_TAIL, off in alt))
    return out


# The departures of the JAX package's whole jitted bucketed product from the
# module's order (jaxlib 0.9.0 on an AVX-512 CPU, b = 3), by (axes, points,
# dims): one ``Order`` per stage (S·T seed, A·, Sᵀ·).  Read with
# ``scripts/probe_xla_galerkin_order.py --bucketed`` (the product, port
# against the JAX package) and ``--bucketed-solve`` (each stage against the
# jitted product's own intermediates, and the term whose rounding gives
# them).  The kinds follow the object code: at 11 × 10 and 13 × 12 × 11 the
# whole-box fusion's vector loop divides lane by lane in predicated blocks
# (b reaches it as a parameter), and the products computed before them (the
# centre's, whose mask needs no division, and at 11 × 10 with 9 points and
# 13 × 12 × 11 the first two) are rounded where they are added; at 32³ the
# pad fusions of the offsets (0, 0, ±1) recompute stage 2's last update with
# its product selected through a phi (rounded); the 27-point sliced updates
# listed run their last columns in a scalar loop that rounds the product,
# from the column R given.
_S = ((-1, -1, -1), (-1, -1, 0))
_DEPARTURES = {
    (2, 5, (11, 10)): (Order(), Order(rounded=((((0, 0), (0, 0)), 0),)),
                       Order(rounded=((((0, 0), (0, 0)), 0),))),
    (2, 9, (11, 10)): (Order(), Order(rounded=((((-1, -1), (0, 0)), 0),
                                               (((-1, 1), (-1, 1)), 8))),
                       Order(rounded=((((-1, -1), (0, 0)), 0),))),
    (3, 7, (13, 12, 11)): (Order(),) + (Order(rounded=(
        (((-1, 0, 0), (0, 0, 0)), 0), (((0, 0, 0), (0, 0, 0)), 0))),) * 2,
    (3, 7, (32, 32, 32)): (Order(), Order(), Order(alt=((0, 0, -1), (0, 0, 1)))),
    (3, 27, (8, 7, 6)): (Order(store=(_S,)), Order(rounded=(
        (((-1, 1, 1), (-1, 1, 0)), 4), (((-1, 1, -1), (-1, 1, 0)), 5))), Order()),
    (3, 27, (16, 16, 16)): (Order(store=(_S,)), Order(rounded=tuple(
        (u, 14) for u in (((1, -1, 1), (0, -1, 1)), ((0, -1, 1), (0, -1, 1)),
                          ((-1, 1, 1), (-1, 0, 1)), ((-1, -1, 1), (0, -1, 1)),
                          ((-1, -1, 1), (-1, 0, 1)), ((-1, 1, -1), (-1, 1, 0))))
        + ((((-1, 1, 0), (-1, 1, 0)), 15),)), Order()),
}
# Grids read with no departure, by (axes, points, dims): 3-D 7-point n³ for
# n of 5 to 28 but 9 (the scalar remainder column of 9³ takes another
# whole-box chain, not read), 44³, 48³ and 128³ (config #3's level 0), 7 × 6 ×
# 5 and 8 × 7 × 6; the 27-point 52³ (468³'s gathered tail); 2-D 5-point 13 ×
# 11 (``tests/test_torch_structured.py``).
_READ = ({(3, 7, (n,) * 3) for n in list(range(5, 9)) + list(range(10, 29)) + [44, 48, 128]}
         | {(3, 7, (7, 6, 5)), (3, 7, (8, 7, 6)), (3, 27, (52, 52, 52)), (2, 5, (13, 11))})


def product_orders(offsets, dims, b: int) -> tuple:
    """The three stages' ``Order`` of the bucketed product of a level with
    these fine ``offsets`` on ``dims`` (``_DEPARTURES``); where the JAX
    package's order at this grid was not read, a warning and the module's
    order."""
    nd, pts, dims = len(dims), len(offsets), tuple(int(n) for n in dims)
    key = (nd, pts, dims)
    if b == 3 and key in _DEPARTURES:
        return _DEPARTURES[key]
    if b != 3 or key not in _READ:
        warnings.warn(f"the JAX package's order of the bucketed Galerkin product at "
                      f"{pts} points on {dims} (b = {b}) is not read (ROADMAP C7c): "
                      f"the read order, its coarse operator may differ in last bits",
                      stacklevel=3)
    return (Order(),) * 3


def stage(F, offsets, X, box_in, box_out, b: int, dims, order: Order | None = None,
          X_alt=None, alt_out: bool = False):
    """Y of one stage: ``F`` the (K, *dims) factor planes of the fine
    ``offsets``, ``X`` the (*box_in shape, *dims) input (``X_alt`` its
    alternative, read by ``order.alt``'s offsets).  With ``alt_out`` the
    pair (Y, Y with the last update's product added rounded).  The plain
    version on CPU tensors and on types other than float32, one
    ``ordered_bucket_stage`` launch on float32 CUDA tensors."""
    kinds = {F.device.type, X.device.type}
    if not kinds <= {"cpu", "cuda"} or F.device != X.device:
        raise ValueError(f"bucket_stage runs on one cpu or cuda device, not {kinds}")
    if F.dtype != X.dtype:
        raise TypeError(f"bucket_stage: factors of {F.dtype}, X of {X.dtype}")
    if order is not None and order.alt and X_alt is None:
        raise ValueError("bucket_stage: the order reads an alt X and none is given")
    if kinds == {"cpu"} or X.dtype != torch.float32:
        return stage_plain(F, offsets, X, box_in, box_out, b, dims, order, X_alt, alt_out)
    return _stage_cuda(F, X, X_alt, tuple(tuple(o) for o in offsets), box_in, box_out, b,
                       dims, order or Order(), alt_out)


def stage_plain(F, offsets, X, box_in, box_out, b: int, dims, order: Order | None = None,
                X_alt=None, alt_out: bool = False):
    """The plain version of ``stage`` (any device): Y from +0, then each
    term on its target slice of the box, the factor masked by
    ``residue_mask`` and X shifted by the offset, as a rounded product
    (kind 0), a fused multiply-add (kind 1; other types than float32 a
    rounded product and a rounded add) or a rounded product added (kind 2),
    the last axis from ``tail`` on by kind 2."""
    out_shape = tuple(h - l + 1 for l, h in box_out)
    nd = len(dims)
    fused = X.dtype == torch.float32
    Y = torch.zeros(out_shape + tuple(dims), dtype=X.dtype, device=X.device)
    table = terms(offsets, box_in, box_out, b, order)
    cols = torch.arange(dims[-1], device=X.device)
    Y_alt = None
    shifted = {}

    def apply(kind, fm, xs, y):
        if kind == 0:
            return fm * xs
        if kind == 1 and fused:
            return ordered_sum.fma_plain(fm, xs, y)
        return y + fm * xs

    for i, t in enumerate(table):
        key = (t.off, t.alt)
        if key not in shifted:  # one shifted copy of X alive at a time
            shifted.clear()
            shifted[key] = shift_nd(X_alt if t.alt else X, t.off, dims)
        fm = torch.where(residue_mask(dims, t.off, t.delta, b, X.device), F[t.k], 0.0)
        fm = fm.reshape((1,) * nd + tuple(dims))
        xs = shifted[key][t.src]
        y = apply(t.kind, fm, xs, Y[t.tgt])
        if t.tail < dims[-1]:
            y = torch.where(cols >= t.tail, apply(2, fm, xs, Y[t.tgt]), y)
        if alt_out and i == len(table) - 1:
            Y_alt = Y.clone()
            Y_alt[t.tgt] = apply(2, fm, xs, Y[t.tgt])
        Y[t.tgt] = y
    if alt_out:
        return Y, (Y if Y_alt is None else Y_alt)
    return Y


def kernel_table(table, box_in, box_out, b: int):
    """The kernel's int32 tables as numpy arrays: ``rows`` (n_terms,
    ``TERM_INTS``): kind, the kind from the tail on (2), tail, alt, k, the
    offset and the residue window's start lo = δ·b − off on each axis (a
    point's δ is the term's where lo ≤ p mod b < lo + b), 0; ``src``
    (n_terms, n_cols): each term's source box (row-major in X's box) for
    every output box (row-major), −1 where the output box is not in its
    target, padded with −1 to a multiple of ``BOX_GROUP`` columns.  A stage
    of one or two axes is taken as 3-D with leading axes of one."""
    nd = len(box_out)
    pad = 3 - nd
    in_shape = np.array([h - l + 1 for l, h in box_in])
    out_shape = np.array([h - l + 1 for l, h in box_out])
    n_out = int(out_shape.prod())
    n_cols = -(-n_out // BOX_GROUP) * BOX_GROUP
    rows = np.zeros((len(table), TERM_INTS), np.int32)
    src = np.full((len(table), n_cols), -1, np.int32)
    if not table:
        return rows, src
    off = np.array([t.off for t in table]).reshape(len(table), nd)
    delta = np.array([t.delta for t in table]).reshape(len(table), nd)
    rows[:, 0] = [t.kind for t in table]
    rows[:, 1] = 2
    rows[:, 2] = [t.tail for t in table]
    rows[:, 3] = [t.alt for t in table]
    rows[:, 4] = [t.k for t in table]
    rows[:, 5 + pad:8] = off
    rows[:, 8 + pad:11] = delta * b - off
    # every output box o, row-major; its source o − (tgt.start − src.start)
    grid = np.stack(np.unravel_index(np.arange(n_out), tuple(out_shape)), axis=1)
    start = np.array([[g.start for g in t.tgt] for t in table]).reshape(len(table), nd)
    stop = np.array([[g.stop for g in t.tgt] for t in table]).reshape(len(table), nd)
    shift = start - np.array([[g.start for g in t.src] for t in table]).reshape(
        len(table), nd)
    inside = ((grid[None] >= start[:, None]) & (grid[None] < stop[:, None])).all(axis=2)
    s = grid[None] - shift[:, None]
    lin = np.ravel_multi_index(tuple(np.moveaxis(np.where(inside[..., None], s, 0), 2, 0)),
                               tuple(in_shape))
    src[:, :n_out] = np.where(inside, lin, -1)
    return rows, src


@functools.lru_cache(maxsize=64)
def _device_table(offsets, box_in, box_out, b: int, order: Order, device: torch.device):
    """One stage shape's kernel table on the card, built once: one int32
    tensor (the rows, then the source boxes), copied asynchronously from
    pinned memory."""
    table = terms(offsets, box_in, box_out, b, order)
    rows, src = kernel_table(table, box_in, box_out, b)
    flat = torch.from_numpy(np.concatenate([rows.ravel(), src.ravel()])).pin_memory()
    return (flat.to(device, non_blocking=True), len(table), src.shape[1],
            max((t.k for t in table), default=-1), any(t.alt for t in table))


def _stage_cuda(F, X, X_alt, offsets, box_in, box_out, b: int, dims, order: Order,
                alt_out: bool):
    nd = len(dims)
    if not 1 <= nd <= 3:
        raise ValueError(f"ordered_bucket_stage takes grids of 1 to 3 axes, not {nd}")
    out_shape = tuple(h - l + 1 for l, h in box_out)
    in_shape = tuple(h - l + 1 for l, h in box_in)
    dev = X.device
    F = F.contiguous()
    X = X.contiguous()
    flat, n_terms, n_cols, k_max, reads_alt = _device_table(
        offsets, tuple(map(tuple, box_in)), tuple(map(tuple, box_out)), b, order, dev)
    if (tuple(F.shape[1:]) != tuple(dims) or tuple(X.shape) != in_shape + tuple(dims)
            or F.shape[0] <= k_max):
        raise ValueError(f"bucket_stage: F {tuple(F.shape)}, X {tuple(X.shape)} for "
                         f"dims {tuple(dims)} and boxes {in_shape} in")
    if reads_alt:
        X_alt = X_alt.contiguous()
        if X_alt.shape != X.shape or X_alt.device != dev or X_alt.dtype != X.dtype:
            raise ValueError("bucket_stage: X_alt must be X's shape, type and device")
    Y = torch.empty(out_shape + tuple(dims), dtype=torch.float32, device=dev)
    Y_alt = torch.empty_like(Y) if alt_out else None
    reach = [0, 0, 0]
    for o in offsets:
        for i, c in enumerate(o):
            reach[3 - nd + i] = max(reach[3 - nd + i], abs(c))
    n0, n1, n2 = (1,) * (3 - nd) + tuple(int(d) for d in dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = ordered_sum._kernels()[3](
            F.data_ptr(), X.data_ptr(), X_alt.data_ptr() if reads_alt else None,
            Y.data_ptr(), Y_alt.data_ptr() if alt_out else None,
            flat.data_ptr(), flat[n_terms * TERM_INTS:].data_ptr(),
            n_terms, math.prod(in_shape), math.prod(out_shape), n_cols, F.shape[0], n0, n1, n2, b,
            *reach, stream)
    ordered_sum._check_err(err, "ordered_bucket_stage")
    ordered_sum.LAUNCHES["ordered_bucket_stage"] += 1
    return (Y, Y_alt) if alt_out else Y
