"""Float32 row sums in the order the JAX package's CPU backend adds them,
and the binding of ``csrc/ordered_sum.cu``.

A float32 sum depends on the order of its adds.  The JAX package's RS
setups compute ``jnp.sum(x, axis=1)`` and ``jnp.sum(x, axis=(1, 2))`` over
masked rows; the port must add in XLA's order to get the same bits, or a
last-bit change near θ flips a strength test on a coarse level and the
hierarchy drifts.  torch's own ``sum`` takes other orders (vectorised lanes
on the CPU, a tree on the card).

The power iterations' matvecs and norms (λ_max(D⁻¹A), which sets the
Chebyshev interval) take XLA's order too, so that the smoother is the JAX
package's.

The order (XLA's CPU pipeline: ``TreeReductionRewriter`` with a window of 32,
then loops that add one element at a time from an accumulator of +0.0):

- The reduced axes are the last ``dims`` axes (1 or 2) of ``x``; every other
  axis is a row.
- If no reduced axis is longer than 32, the row's elements are added to +0.0
  one after another in row-major order.
- Otherwise each reduced axis of length d > 32 is cut into ⌈d/32⌉ windows of
  32, zero-padded by p = 32·⌈d/32⌉ − d elements, ⌊p/2⌋ before the first
  element and the rest after the last; an axis of length d ≤ 32 is one window
  of d.  Each window (a block over all reduced axes) is summed as above, in
  row-major order within the block, skipping the padding.  The windows'
  partial sums form a smaller array with the same reduced axes, which is
  summed by the same rule.

So width 33 adds elements 0–16 and 17–32 in two partial sums; width 100 adds
0–17, 18–49, 50–81 and 82–99.  The rule was read from the optimised HLO of
``jnp.sum`` and is held bit-equal to it for every width and table shape the
setups reach by ``tests/test_torch_ordered_sum.py``.  Padding adds +0.0,
which leaves a sum that starts from +0.0 unchanged.

XLA marks its CPU reductions ``reassoc``, so LLVM may vectorise a row's loop
and reorder it.  Where it does, the sum follows LLVM's loop vectoriser
instead, given as ``lanes=(vf, ic, evf)`` (one axis of at most 32): the row's
first ⌊w/(vf·ic)⌋·vf·ic elements go to ic accumulators of vf lanes (element
j to accumulator (j mod vf·ic) // vf, lane j mod vf, added one block of
vf·ic after another; lane 0 of accumulator 0 starts at +0.0, every other
lane at −0.0, LLVM's neutral element); the accumulators are added lanewise
in order, and the vf lanes reduced by halving (lane l + lane l + vf/2, ...); then, where evf
> 0 and evf elements remain, a vector of evf lanes starting from that sum in
lane 0 (−0.0 in the others) takes whole blocks of evf elements and is reduced the same way; the
last elements are added one at a time.  Which reductions LLVM vectorises,
and how, depends on the fused loop body and the row's width.  Of the RS
setups' sums only one is vectorised: the one-device extended+i's weak
couplings, whose schedule ``weak_lanes`` gives.

Products.  XLA's CPU backend lets LLVM contract a product and the sum it
feeds into one fused multiply-add (``fma``): Σ_k a_k·b_k over a row of at
most 32, with the product fused into the reduction, adds ``fma(a_k, b_k,
acc)``, in the same kind of schedule (``row_dot``'s ``lanes``).  A reduction
over windows (``reduce-window``) does not fuse its product: above 32 the
products are rounded first and summed by the windows rule.  The orders the
power iterations need were read off the JAX package's own functions inside
a loop of two or more iterations (a loop of one is compiled otherwise), and
``tests/test_torch_ordered_sum.py`` holds them:

- the ELL matvec's row sums Σ v·x[c] (one-device ``_ell_lambda_max``) and the
  two planes of the PCSR matvec (own and ghost, added after):
  ``ell_dot_lanes``;
- a Stencil matvec Σ_d w_d·x_d: one fma chain over the offsets, except that
  the first two products are taken in the order (1, 0): XLA's first add of
  two products contracts the first operand's product (``STENCIL_FIRST``);
- a norm's Σ y² (``sumsq``): one fma chain in row-major order where no axis
  is longer than 32, otherwise the windows rule on the rounded squares (on
  a grid of three axes: blocks of up to 32 per axis, then the partials in
  row-major order, or in lanes across their middle axis where it is 2, 4
  or 8 long; a structured 2-D grid's squares or partials in lanes across
  its first axis, ``_sumsq_2d``); over parts (``pgrid.ordered_norm``) each
  part's Σ y², then the parts' sums left to right; then the correctly
  rounded square root (``sqrt``).

The structured setups' Galerkin products (``amg/device_setup.py``) take two
more of XLA's orders: an elementwise a·b + c that the CPU backend contracts
into one fused multiply-add (``fma``: the smoothers' centre planes; the
bucketed product's updates are ``ops/bucket_stage.py``'s kernel), and a sum
over the leading (planes) axis of a (D, ...) array, which the windows rule
orders over D like any reduced axis (``planes_sum``: the lumps of
``sparsify_stencil``).

``row_sum`` and ``row_dot`` run the plain version (``row_sum_plain``,
``row_dot_plain``: torch ops, one IEEE add or one fused multiply-add, emulated
exactly in float64 by ``fma_plain``, per element position; so they give the
same bits on every device) on a CPU tensor, and launch ``csrc/ordered_sum.cu``
on a CUDA tensor: the whole tree of windows in one launch (a row of more
than 32,768 floats through the span kernel, whose last block finishes the
tree); a lanes schedule in one.
``LAUNCHES`` counts the launches by kernel name.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import warnings

import numpy as np
import torch

from parallel_amg_tpu_torch.ops import _build

WINDOW = 32
MAX_STAGED_ROW = 64  # csrc/ordered_sum.cu's kMaxStagedRow
MAX_PARTS = 1024     # csrc/ordered_sum.cu's kMaxParts
CHAIN = (1, 1, 0)    # lanes of one chain, left to right (any row length)
# the first two products of a Stencil matvec in XLA's order (see the module)
STENCIL_FIRST = (1, 0)

# kernel launches by kernel, counted where each is launched (here,
# ``ops/ordered_stencil.py`` for the power iterations' stencil matvec and
# ``ops/bucket_stage.py`` for the bucketed Galerkin stages); callers may
# reset them
LAUNCHES = {"ordered_sum_staged": 0, "ordered_sum_windows": 0,
            "ordered_sum_lanes": 0, "ordered_fma": 0, "ordered_stencil_matvec": 0,
            "ordered_bucket_stage": 0}

# lanes schedules with a kernel instance in csrc/ordered_sum.cu, besides CHAIN
# (the 2-D norms' ``_rows_lanes`` take (vf, 1, 0) over rows of any length)
_ADD_LANES = {(4, 2, 0), (4, 4, 4), (8, 2, 0), (2, 1, 0), (4, 1, 0), (8, 1, 0)}
_FMA_LANES = {(8, 1, 4), (8, 1, 0), (2, 1, 0), (4, 1, 0)}
_ANY_LENGTH = {(2, 1, 0), (4, 1, 0), (8, 1, 0)}


def windows(d: int):
    """(window length, number of windows, leading padding) of one reduced
    axis of length d."""
    if d <= WINDOW:
        return d, 1, 0
    nw = -(-d // WINDOW)
    return WINDOW, nw, (nw * WINDOW - d) // 2


def weak_lanes(W: int, several_chunks: bool):
    """The order of the JAX package's one-device extended+i weak-coupling
    sum (``parallel_amg_tpu/amg/device_rs.py:265-266``) over rows of width
    W, as ``row_sum``'s ``lanes`` (None: XLA's own order).

    LLVM vectorises that fused loop for 17 ≤ W ≤ 32, by trip count and by
    whether ``lax.map`` runs one chunk of rows or several (``jax_row_chunks``
    > 1): 4 lanes × 2 accumulators, except 4 × 4 with a 4-lane epilogue for
    W 20–23 in one chunk and 8 × 2 for W 32 in several.  The table was
    measured through the JAX package's own function by
    ``scripts/probe_xla_weak_sum.py`` with jax and jaxlib 0.9.0 (XLA's CPU
    backend and the LLVM it bundles) on an x86-64 CPU with AVX-512; another
    jaxlib, LLVM or instruction set may vectorise otherwise, and that
    script and ``tests/test_torch_ordered_sum.py`` then show it."""
    if W == 32 and several_chunks:
        return (8, 2, 0)
    if 20 <= W <= 23 and not several_chunks:
        return (4, 4, 4)
    if 17 <= W <= 32:
        return (4, 2, 0)
    return None


def ell_dot_lanes(W: int, plane: str = "ell"):
    """``row_dot``'s lanes for the JAX package's ELL product row sums
    ``jnp.sum(vals * x[cols], axis=1)`` over width W inside its power
    iterations (None: W > 32, the rounded products by the windows rule).

    ``plane`` "ell", the one-device ``_ell_lambda_max`` (``parallel_amg_tpu/
    amg/device_rs.py:1002``): one fma chain up to W 22, 8 lanes over the
    whole blocks of 8 with a 4-lane epilogue at 23, 8 lanes at 24–32.
    "own", the own-part plane of the PCSR matvec (``parallel_amg_tpu/
    parallel/pcsr.py:272``): one chain up to W 27, 8 lanes at 28–32.
    "ghost", its ghost plane: one chain at every W up to 32.  Read with jax
    and jaxlib 0.9.0 on an x86-64 CPU with AVX-512, as ``weak_lanes``;
    ``tests/test_torch_ordered_sum.py`` holds each width."""
    if W > WINDOW:
        return None
    last_chain = {"ell": 22, "own": 27, "ghost": WINDOW}[plane]
    if W <= last_chain:
        return CHAIN
    return (8, 1, 4) if W == 23 else (8, 1, 0)


def jax_row_chunks(n: int, f_max: int, W: int, K: int) -> int:
    """The row chunks the JAX package's one-device extended+i maps over
    (its default ``row_chunk``, ``parallel_amg_tpu/amg/device_rs.py:236``)
    for n rows and tables of widths f_max, W and K."""
    row_chunk = max(min(4096, (1 << 26) // max(f_max * W * K, 1)), 64)
    return -(-n // row_chunk)


def _check(x, dims: int):
    if dims not in (1, 2) or x.dim() < dims:
        raise ValueError(f"row_sum reduces the last 1 or 2 axes, not {dims} "
                         f"of a {x.dim()}-axis tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"row_sum takes float32, not {x.dtype}")


def _check_lanes(width: int, lanes) -> None:
    vf, ic, evf = lanes
    if tuple(lanes) == CHAIN:
        return
    if width > WINDOW and tuple(lanes) not in _ANY_LENGTH:
        raise ValueError(f"lanes {lanes} order a row of at most {WINDOW}, "
                         f"not {width}")
    if not (vf in (2, 4, 8, 16) and 1 <= ic and vf * ic <= 32
            and evf in (0, 2, 4, 8, 16)):
        raise ValueError(f"lanes {lanes}: vf and evf powers of 2 to 16, "
                         f"vf·ic ≤ 32")


def row_sum(x, dims: int = 1, lanes=None):
    """Σ over the last ``dims`` axes of float32 ``x``, in XLA's CPU order
    (LLVM's vectorised order where ``lanes`` is given; ``CHAIN``: one add
    after another over a row of any length)."""
    _check(x, dims)
    if lanes is not None:
        if dims != 1:
            raise ValueError("lanes order one reduced axis")
        _check_lanes(x.shape[-1], lanes)
    if x.device.type == "cpu":
        return row_sum_plain(x, dims, lanes)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum runs on cpu or cuda, not {x.device}")
    if lanes is not None:
        return _lanes_cuda(x, None, lanes)
    return _row_sum_cuda(x, dims)


def row_dot(a, b, lanes=None):
    """Σ_k a[..., k]·b[..., k] over the last axis of float32 ``a`` and
    ``b`` (same shape): with ``lanes`` each step a fused multiply-add in
    that schedule (LLVM's contraction), without, the rounded products
    summed by ``row_sum``'s windows rule."""
    if a.shape != b.shape or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"row_dot takes two float32 tensors of one shape, not "
                        f"{a.dtype}{tuple(a.shape)} and {b.dtype}{tuple(b.shape)}")
    if lanes is None:
        return row_sum(a * b)
    _check_lanes(a.shape[-1], lanes)
    if a.device.type == "cpu":
        return row_dot_plain(a, b, lanes)
    if a.device.type != "cuda":
        raise ValueError(f"row_dot runs on cpu or cuda, not {a.device}")
    return _lanes_cuda(a, b, lanes)


def planes_dot(a, b):
    """Σ_k a[k]·b[k] over the planes of float32 (K, ...) ``a`` and ``b``: one
    fma chain in plane order, from +0.0 (a Stencil matvec's products, in
    XLA's order once the caller has put the planes in ``STENCIL_FIRST``
    order)."""
    if a.shape != b.shape or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("planes_dot takes two float32 tensors of one shape")
    if a.device.type == "cpu":
        return planes_dot_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"planes_dot runs on cpu or cuda, not {a.device}")
    K = a.shape[0]
    out = _lanes_cuda(a.reshape(K, -1), b.reshape(K, -1), CHAIN, planes=True)
    return out.reshape(a.shape[1:])


def planes_dot_plain(a, b):
    """The plain version of ``planes_dot``."""
    s = torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device)
    for k in range(a.shape[0]):
        s = fma_plain(a[k], b[k], s)
    return s


def sumsq(y, structured: bool = False, points: int = 0):
    """Σ y² over every axis of float32 ``y`` (1 to 3 axes), in the order of
    ``jnp.linalg.norm``'s sum on the JAX package's CPU backend inside its
    power iterations: where no axis is longer than 32, one fma chain
    fma(y, y, acc) in row-major order; otherwise the rounded squares by the
    windows rule (three axes: blocks of up to 32 per axis, each summed in
    row-major order, then the block partials in row-major order).

    Where ``structured`` says y is a structured power iteration's D⁻¹A·x
    (a fusion of its own, which LLVM vectorises; not the sharded norm's
    per-part sums) and LLVM unrolls the last axis and vectorises the loop
    before it (read off the optimised IR of the norm's fusion), the grid is
    summed in lanes across the axis before the last (``_middle_lanes_vf``,
    ``_middle_lanes``).  Other small 3-D grids that LLVM vectorises (7 ×
    16 × 5) still take the rule above: ROADMAP C7b.

    A structured 2-D grid (``_sumsq_2d``; ``points`` is its stencil's
    count) is read whole: its squares or, past 32 on an axis, its window
    partials are summed in ``_middle_lanes_vf`` lanes across the first
    axis.

    A three-axis grid longer than 32 on some axis: XLA rounds the squares
    (a fusion of their own), sums each window of up to 32³ as one chain in
    row-major order (``reduce-window``), and reduces the (p0, p1, p2) block
    partials in a fusion that LLVM vectorises where p1 is 2, 4 or 8: p1
    lanes across the middle axis (``_middle_lanes``), slab by slab; other
    partials (3³, 5³, 11³, 7 × 5 × 3) are one chain in row-major order.
    Read off the optimised IR of the JAX package's power iteration at 43³,
    64 × 128 × 128, 96³, 100³, 108³, 128³, 128 × 64 × 128, 128 × 128 × 64,
    160³, 256³ and 324³, and of its sharded power iteration in 4 parts at
    144 × 128 × 128 and 48 × 43 × 43 (the parts' own sums, before the
    all-reduce), so it holds with or without ``structured``.  Config #3's
    128³ grid has (4, 4, 4) partials in four lanes, its 4-part level 0
    (2, 4, 4) per part.
    """
    if y.dim() == 0 or y.dim() > 3:
        raise ValueError(f"sumsq takes 1 to 3 axes, not {y.dim()}")
    if structured and y.dim() == 2:
        return _sumsq_2d(y, points)
    vf = _middle_lanes_vf(tuple(y.shape)) if structured else 0
    if vf:
        return _middle_lanes(y if y.dim() == 3 else y[None], vf)
    if max(y.shape) <= WINDOW:
        flat = y.reshape(1, -1)
        return row_dot(flat, flat, CHAIN)[0]
    sq = y * y
    if y.dim() < 3:
        return row_sum(sq, y.dim())
    parts = _block_sums(sq)
    if max(parts.shape) > WINDOW:
        raise ValueError(f"sumsq: a grid of {tuple(y.shape)} leaves partials "
                         f"{tuple(parts.shape)} longer than {WINDOW}")
    if parts.shape[1] in (2, 4, 8):
        # LLVM adds the partials in p1 lanes across the middle axis
        return _middle_lanes(parts, parts.shape[1], square=False)
    return row_sum(parts.reshape(1, -1), 1, CHAIN)[0]


def _middle_lanes_vf(shape, square: bool = False) -> int:
    """The lanes LLVM gives a power iteration's Σ y² across the axis before
    the last, or 0 (read with jax and jaxlib 0.9.0 on AVX-512, held by
    tests/test_torch_ordered_sum.py).  Three axes: 4 for (n0, 4, n2 ≤ 5), 8
    for (n0, 8 or 16, n2) with n1·n2 ≤ 64.  Two axes (p0, p1): the squares
    of a grid of at most 32 a side (``square``), or a larger grid's window
    partials (adds): the vector loop runs over p0, the p1 floats of a row
    unrolled, where 2 ≤ p1 ≤ 8 and p0 ≤ 32 (the trip count LLVM's cost
    model weighs): p0 lanes where p0 is 2, 4 or 8, none for other p0 below
    16 (a loop that short is vectorised only without a remainder), and from
    16 on 8 lanes, or 4 where p0 mod 8 is 4 to 7 (but 8 at p0 28 to 31 with
    rows of 2) or, adding partials, the rows are 7 or 8 floats.
    ``scripts/probe_xla_galerkin_order.py --norms2d`` reads both tables off
    the JAX package's reductions."""
    if len(shape) == 2:
        p0, p1 = shape
        if not (2 <= p1 <= 8 and 2 <= p0 <= WINDOW):
            return 0
        if p0 in (2, 4, 8):
            return p0
        if p0 < 16:
            return 0
        if (p1 >= 7 and not square) or (p0 % 8 >= 4 and not (p0 >= 28 and p1 == 2)):
            return 4
        return 8
    if len(shape) != 3 or max(shape) > WINDOW:
        return 0
    n0, n1, n2 = shape
    if n1 == 4 and n2 <= 5:
        return 4
    if n1 in (8, 16) and n1 * n2 <= 64:
        return 8
    return 0


# 2-D grids small enough that XLA's CPU backend compiles the whole power
# iteration body into one function (its cost model weighs the stencil's
# points), whose Σ y² is one fma chain, by the stencil's points
ONE_CALL = {
    5: lambda n0, n1: n0 * n1 <= 12 or (min(n0, n1) == 1 and max(n0, n1) <= 13),
    9: lambda n0, n1: n0 * n1 <= 8 or (n0 == 1 and n1 <= 11) or (n1 == 1 and n0 <= 10),
}
ONE_CALL_SPAN = 13  # the longest axis of a grid in ONE_CALL


def _sumsq_2d(y, points: int):
    """Σ y² of a structured power iteration's (n0, n1) D⁻¹A·x, in XLA's CPU
    order, read off the optimised IR and the machine code of the norm's
    fusions in the JAX package's power iteration (jax and jaxlib 0.9.0,
    AVX-512; ``scripts/probe_xla_galerkin_order.py --norms2d``):

    - both axes at most 32: the squares in ``_middle_lanes_vf`` lanes across
      axis 0 (``_rows_lanes``; fused multiply-adds where the rows are at
      most 4 floats, the products rounded first on longer rows, the rows
      past the last whole block fused one at a time), else one fma chain in
      row-major order; on the grids whose loop body XLA compiles into one
      function (``ONE_CALL``), one fma chain;
    - longer: the rounded squares by the windows rule down to partials of at
      most 32 a side, one level of windows after another
      (``_block_sums``), then the partials as the squares above, adds in
      place of fused multiply-adds.

    A tiny grid (no axis past 13) of a stencil whose points ``ONE_CALL``
    has no entry for is not read: a warning (ROADMAP C7b) and the rule
    above."""
    n0, n1 = (int(n) for n in y.shape)
    if max(n0, n1) <= WINDOW:
        one_call = ONE_CALL.get(points)
        if one_call is None and max(n0, n1) <= ONE_CALL_SPAN:
            _warn_2d(y.shape, points)
        vf = (0 if one_call is not None and one_call(n0, n1)
              else _middle_lanes_vf((n0, n1), square=True))
        if vf:
            return _rows_lanes(y[None], vf, square=True)[0]
        flat = y.reshape(1, -1)
        return row_dot(flat, flat, CHAIN)[0]
    parts = y * y
    while max(parts.shape) > WINDOW:
        parts = _block_sums(parts)
    vf = _middle_lanes_vf(tuple(parts.shape))
    if vf:
        return _rows_lanes(parts[None], vf, square=False)[0]
    return row_sum(parts.reshape(1, -1), 1, CHAIN)[0]


_WARNED_2D: set = set()


def _warn_2d(shape, points: int) -> None:
    key = (tuple(int(n) for n in shape), points)
    if key in _WARNED_2D:
        return
    _WARNED_2D.add(key)
    warnings.warn(f"the JAX package's order of the power iteration's norm on a 2-D "
                  f"grid of {key[0]} with a {points}-point stencil is not read "
                  f"(ROADMAP C7b): λ may differ in its last bits", stacklevel=4)


def _rows_lanes(y, vf: int, square: bool):
    """Σ over each (p0, p1) grid of a (B, p0, p1) batch in vf lanes across
    axis 0 (``_sumsq_2d``): lane l starts at +0.0 (l = 0) or −0.0, and
    takes the p1 values of row b + l, in order, for each whole block b of
    vf rows; the lanes are halved into one sum; the rows left over are
    added one value at a time.  With ``square`` the values are y², fused
    into their adds (``fma``) where a row is at most 4 floats and on the
    rows left over, rounded first elsewhere.  As the ``ordered_sum_lanes``
    schedule (vf, 1, 0) over the blocks' values in lane order, then one
    chain from that sum: one launch each on the card."""
    B, p0, p1 = y.shape
    j = p0 // vf * vf
    z = y[:, :j].reshape(B, j // vf, vf, p1).transpose(2, 3).reshape(B, -1)
    lanes = (vf, 1, 0)
    if not square:
        s = row_sum(z, 1, lanes)
    elif p1 <= 4:
        s = row_dot(z, z, lanes)
    else:
        s = row_sum(z * z, 1, lanes)
    if j == p0:
        return s
    rest = y[:, j:].reshape(B, -1)
    head = torch.cat([s[:, None], rest], 1)
    if not square:
        return row_sum(head, 1, CHAIN)
    # fma(s, 1, +0.0) = s starts the chain of the rows left over
    return row_dot(head, torch.cat([torch.ones_like(s)[:, None], rest], 1), CHAIN)


def _middle_lanes(y, vf: int, square: bool = True):
    """Σ y² of a (n0, n1, n2) grid in vf lanes across the middle axis (see
    ``sumsq``): per slab i0, lanes l start at (sum so far, −0.0, ...), take
    y² for rows i1 = b + l of each block b of vf rows and i2 in order, and
    are halved into the sum.  Where a row is at most 4 floats the square and
    its add are one fused multiply-add; longer rows are deinterleaved by a
    shuffle between the product and the add, which keeps the product
    rounded.  Without ``square``, y's values themselves are added (a
    three-axis norm's block partials)."""
    fused = y.shape[2] <= 4
    acc = torch.zeros((), dtype=y.dtype, device=y.device)
    for i0 in range(y.shape[0]):
        lanes = torch.full((vf,), -0.0, dtype=y.dtype, device=y.device)
        lanes[0] = acc
        for b in range(0, y.shape[1], vf):
            for i2 in range(y.shape[2]):
                v = y[i0, b:b + vf, i2]
                if not square:
                    lanes = lanes + v
                else:
                    lanes = fma(v, v, lanes) if fused else lanes + v * v
        while lanes.numel() > 1:
            h = lanes.numel() // 2
            lanes = lanes[:h] + lanes[h:]
        acc = lanes[0]
    return acc


def sqrt(x):
    """The correctly rounded float32 square root, on any device: taken in
    float64 and rounded once more, which is exact for a square root.
    torch's vectorised CPU ``sqrt`` is not always correctly rounded (it gave
    2.4681997 for √6.0920105, whose float32 root is 2.4682), XLA's is."""
    return torch.sqrt(x.double()).to(x.dtype)


def norm(y, structured: bool = False, points: int = 0):
    """``jnp.linalg.norm(y)`` of the JAX package's power iterations:
    ``sqrt(sumsq(y, structured, points))``."""
    return sqrt(sumsq(y, structured, points))


def _block_sums(sq):
    """One level of windows over a grid of two or three axes, as XLA's
    ``reduce-window`` kernel adds them (its loop runs over a window's rows,
    each row's floats unrolled, and checks the rows and columns that may
    fall in the padding): the (n0, n1, ...) window sums, each a chain in
    row-major order (padding +0.0), except

    - where the last axis is padded by exactly one float (lo 0, hi 1: only
      a window's last column may be padding), where LLVM takes that
      column's check out of the row loop: each row's first w − 1 floats in
      row-major order, then the last column's floats down the rows;
    - on a 2-D grid with no padding, where LLVM vectorises the window loop
      as it does a reduce of the window's shape: ``_middle_lanes_vf`` lanes
      across the window's rows (``_rows_lanes``)."""
    win = [windows(int(d)) for d in sq.shape]
    pads = []
    for (w, n, lo), d in zip(reversed(win), reversed(sq.shape)):
        pads += [lo, n * w - d - lo]
    xp = torch.nn.functional.pad(sq, pads)
    nd = len(win)
    blocks = xp.reshape([v for w, n, _ in win for v in (n, w)])
    blocks = blocks.permute(list(range(0, 2 * nd, 2)) + list(range(1, 2 * nd, 2)))
    counts = [n for _, n, _ in win]
    blocks = blocks.reshape(math.prod(counts), -1, win[-1][0])
    vf = 0 if nd != 2 or any(pads) else _middle_lanes_vf(tuple(blocks.shape[1:]))
    if vf:
        return _rows_lanes(blocks, vf, square=False).reshape(counts)
    if pads[:2] == [0, 1]:
        blocks = torch.cat([blocks[..., :-1].flatten(1), blocks[..., -1]], 1)
    return row_sum(blocks.flatten(1).contiguous(), 1, CHAIN).reshape(counts)


def _as_rows(x, dims: int):
    """(x as (R, d1, d2) with d1 = 1 for one axis, the rows' shape)."""
    lead = tuple(x.shape[: x.dim() - dims])
    red = tuple(x.shape[x.dim() - dims:])
    d1, d2 = (1,) + red if dims == 1 else red
    return x.reshape(math.prod(lead), d1, d2), lead


def fma_plain(a, b, c):
    """float32 fma(a, b, c) = a·b + c rounded once, on any device: the
    product is exact in float64, TwoSum gives the float64 sum and its exact
    error, and rounding that sum to odd (its last bit set where the error is
    not 0) makes the final rounding to float32 the correct one."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    bits = s.view(torch.int64)
    away = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + away, bits)
    return bits.view(torch.float64).float()


def _f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _fma_scalar(a: float, b: float, c: float) -> float:
    """``fma_plain`` on Python floats holding float32 values."""
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    if err != 0:
        bits = struct.unpack("<q", struct.pack("<d", s))[0]
        if bits & 1 == 0:
            bits += 1 if (err > 0) == (s > 0) else -1
            s = struct.unpack("<d", struct.pack("<q", bits))[0]
    return _f32(s)


def _chain_scalar(a, b):
    """One chain of fused multiply-adds over a single long row, in Python
    floats (a torch loop of tiny ops would take seconds)."""
    s = 0.0
    for u, v in zip(a.tolist(), b.tolist()):
        s = _fma_scalar(u, v, s)
    return s


def _halving(v):
    """LLVM's reduction of a (R, n) vector of lanes, n a power of 2."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _start(R: int, n: int, like, first=None):
    """(R, n) lanes at −0.0, lane 0 at ``first`` (+0.0 when None)."""
    v = torch.full((R, n), -0.0, dtype=like.dtype, device=like.device)
    v[:, 0] = 0.0 if first is None else first
    return v


def _lanes_plain(a2, b2, lanes):
    """Rows of (R, W) a2 in the lanes schedule: adds, or with b2 fused
    multiply-adds."""
    vf, ic, evf = lanes
    R, W = a2.shape
    if tuple(lanes) == CHAIN and b2 is None and W > WINDOW:
        # numpy's accumulate adds left to right in float32, from a +0.0 column
        acc = np.cumsum(np.concatenate([np.zeros((R, 1), np.float32), a2.cpu().numpy()], 1),
                        axis=1, dtype=np.float32)
        return torch.from_numpy(np.ascontiguousarray(acc[:, -1])).to(a2.device)
    if tuple(lanes) == CHAIN and R == 1 and W > WINDOW:
        s = _chain_scalar(a2[0].cpu(), b2[0].cpu())
        return torch.tensor([s], dtype=a2.dtype, device=a2.device)

    def step(acc, k0, k1):
        if b2 is None:
            return acc + a2[:, k0:k1]
        return fma_plain(a2[:, k0:k1], b2[:, k0:k1], acc)

    span = vf * ic
    j = W // span * span
    s = torch.zeros(R, dtype=a2.dtype, device=a2.device)
    if j:
        acc = torch.cat([_start(R, vf, a2)] + [
            torch.full((R, vf), -0.0, dtype=a2.dtype, device=a2.device)
        ] * (ic - 1), 1)
        for k in range(0, j, span):
            acc = step(acc, k, k + span)
        acc = acc.reshape(R, ic, vf)
        comb = acc[:, 0]
        for p in range(1, ic):
            comb = comb + acc[:, p]
        s = _halving(comb)
    if evf and W - j >= evf:
        lanes_v = _start(R, evf, a2, s)
        end = j + (W - j) // evf * evf
        for k in range(j, end, evf):
            lanes_v = step(lanes_v, k, k + evf)
        s, j = _halving(lanes_v), end
    for k in range(j, W):
        s = step(s[:, None], k, k + 1)[:, 0]
    return s


def row_sum_plain(x, dims: int = 1, lanes=None):
    """The plain version: one float32 add per element position, in order."""
    _check(x, dims)
    if lanes is not None:
        if dims != 1:
            raise ValueError("lanes order one reduced axis")
        _check_lanes(x.shape[-1], lanes)
        x3, lead = _as_rows(x, dims)
        return _lanes_plain(x3[:, 0], None, lanes).reshape(lead)
    x3, lead = _as_rows(x, dims)
    while True:
        R, d1, d2 = x3.shape
        (w1, n1, lo1), (w2, n2, lo2) = windows(d1), windows(d2)
        if n1 == 1 and n2 == 1:
            acc = torch.zeros(R, dtype=x.dtype, device=x.device)
            flat = x3.reshape(R, d1 * d2)
            for j in range(d1 * d2):
                acc = acc + flat[:, j]
            return acc.reshape(lead)
        # zero-pad to whole windows; (R, n1, w1, n2, w2) → per window
        xp = torch.nn.functional.pad(
            x3, (lo2, n2 * w2 - d2 - lo2, lo1, n1 * w1 - d1 - lo1))
        xw = xp.reshape(R, n1, w1, n2, w2).permute(0, 1, 3, 2, 4).reshape(
            R, n1 * n2, w1 * w2)
        acc = torch.zeros(R, n1 * n2, dtype=x.dtype, device=x.device)
        for j in range(w1 * w2):
            acc = acc + xw[:, :, j]
        x3 = acc.reshape(R, n1, n2)


def row_dot_plain(a, b, lanes=None):
    """The plain version of ``row_dot``."""
    if lanes is None:
        return row_sum_plain(a * b)
    _check_lanes(a.shape[-1], lanes)
    lead = tuple(a.shape[:-1])
    W = a.shape[-1]
    out = _lanes_plain(a.reshape(-1, W), b.reshape(-1, W), lanes)
    return out.reshape(lead)


def fma(a, b, c, out=None):
    """float32 fma(a, b, c) = a·b + c rounded once, elementwise over the
    broadcast shape of the three tensors (one device): ``fma_plain`` on the
    CPU, the ``ordered_fma`` kernel of csrc/ordered_sum.cu on the card (an
    operand whose shape is a suffix of the result's, a scalar among them,
    repeats over the leading axes; any other is expanded).  ``out``, a
    contiguous tensor of the result's shape, takes the result in place; it
    may be ``c`` itself (each element is read before it is written)."""
    for t in (a, b, c):
        if t.dtype != torch.float32:
            raise TypeError(f"fma takes float32, not {t.dtype}")
    dev = a.device
    shape = _broadcast_shape(a.shape, b.shape, c.shape)
    if out is not None and (tuple(out.shape) != tuple(shape) or not out.is_contiguous()
                            or out.dtype != torch.float32 or out.device != dev):
        raise ValueError(f"fma: out must be a contiguous float32 {tuple(shape)} on {dev}")
    if dev.type == "cpu":
        return fma_plain(a, b, c) if out is None else out.copy_(fma_plain(a, b, c))
    if dev.type != "cuda":
        raise ValueError(f"fma runs on cpu or cuda, not {dev}")
    ops, counts = [], []
    for t in (a, b, c):
        while t.dim() > 0 and t.shape[0] == 1 and t.numel() > 1:
            t = t[0]  # leading axes of one element broadcast anyway
        if t.numel() == 1:
            t = t.reshape(1)
        elif tuple(t.shape) != tuple(shape[len(shape) - t.dim():]):
            t = t.expand(shape)
        t = t.contiguous()
        ops.append(t)
        counts.append(t.numel())
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[2](ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
                            out.data_ptr(), out.numel(), *counts, stream)
    _check_err(err, "ordered_fma")
    LAUNCHES["ordered_fma"] += 1
    return out


def _broadcast_shape(*shapes):
    """numpy's broadcast of the shapes (``torch.broadcast_shapes`` imports
    sympy, seconds at a process's first call)."""
    n = max(len(sh) for sh in shapes)
    out = []
    for i in range(n):
        dims = {sh[len(sh) - n + i] for sh in shapes if len(sh) - n + i >= 0} - {1}
        if len(dims) > 1:
            raise ValueError(f"shapes {shapes} do not broadcast")
        out.append(dims.pop() if dims else 1)
    return tuple(out)


def planes_sum(x):
    """Σ over the leading axis of float32 (D, ...) ``x`` in XLA's CPU order:
    the windows rule over D (one chain from +0.0 where D ≤ 32, else windows
    of 32 with the padding split, each a chain, then their partials by the
    same rule), elementwise over the trailing axes.  One chain is the lanes
    kernel's plane mode on the card (one launch a window), plain adds on the
    CPU: every add is one IEEE float32 add, so both give the same bits."""
    if x.dtype != torch.float32 or x.dim() < 1:
        raise TypeError("planes_sum takes a float32 tensor of one axis or more")
    D = x.shape[0]
    w, nw, lo = windows(D)
    if nw == 1:
        return _planes_chain(x)
    parts = [_planes_chain(x[max(0, i * w - lo):min(D, i * w + w - lo)])
             for i in range(nw)]
    return planes_sum(torch.stack(parts))


def _planes_chain(x):
    """One chain of adds over the leading axis, from +0.0."""
    if x.device.type == "cuda":
        K = x.shape[0]
        return _lanes_cuda(x.reshape(K, -1), None, CHAIN,
                           planes=True).reshape(x.shape[1:])
    if x.device.type != "cpu":
        raise ValueError(f"planes_sum runs on cpu or cuda, not {x.device}")
    acc = torch.zeros(x.shape[1:], dtype=x.dtype)
    for k in range(x.shape[0]):
        acc = acc + x[k]
    return acc


@functools.cache
def _kernels():
    lib = _build.load("ordered_sum")
    rows_fn, lanes_fn, fma_fn = lib.ordered_sum, lib.ordered_sum_lanes, lib.ordered_fma
    stage_fn = lib.ordered_bucket_stage
    rows_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [
        ctypes.c_int] * 2 + [ctypes.c_void_p]
    lanes_fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fma_fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [
        ctypes.c_void_p]
    stage_fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    rows_fn.restype = lanes_fn.restype = fma_fn.restype = stage_fn.restype = ctypes.c_int
    return rows_fn, lanes_fn, fma_fn, stage_fn


def _kernel_name(d1: int, d2: int) -> str:
    """The kernel ``ordered_sum`` in csrc/ordered_sum.cu launches for rows
    of (d1, d2), by the name ``LAUNCHES`` counts it under (the span kernel
    of rows past ``MAX_PARTS`` windows as ``ordered_sum_windows``)."""
    if windows(d1)[1] * windows(d2)[1] == 1 and 0 < d1 * d2 <= MAX_STAGED_ROW:
        return "ordered_sum_staged"
    return "ordered_sum_windows"


def _check_err(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


_COUNTERS: dict = {}


def _counter(device):
    """The span kernel's completion counter on ``device`` (0 between
    launches: the last block resets it), made once."""
    c = _COUNTERS.get(device)
    if c is None:
        c = _COUNTERS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return c


def _row_sum_cuda(x, dims: int):
    x3, lead = _as_rows(x, dims)
    x3 = x3.contiguous()
    R, d1, d2 = x3.shape
    out = torch.empty(R, dtype=x.dtype, device=x.device)
    if R == 0:
        return out.reshape(lead)
    n1, n2 = windows(d1)[1], windows(d2)[1]
    scratch = counter = None
    if d1 == 1 and n2 > MAX_PARTS:
        n3 = windows(n2)[1]
        if windows(n3)[1] > MAX_PARTS:
            raise ValueError(f"row_sum on the card: a row of {d2} is too long")
        scratch = torch.empty((R, n3), dtype=x.dtype, device=x.device)
        counter = _counter(x.device)
    elif n1 * n2 > MAX_PARTS:
        raise ValueError(f"row_sum on the card: rows of ({d1}, {d2}) have "
                         f"more than {MAX_PARTS} windows")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[0](x3.data_ptr(), out.data_ptr(),
                            None if scratch is None else scratch.data_ptr(),
                            None if counter is None else counter.data_ptr(),
                            R, d1, d2, stream)
    _check_err(err, "ordered_sum")
    LAUNCHES[_kernel_name(d1, d2)] += 1
    return out.reshape(lead)


def _lanes_cuda(a, b, lanes, planes: bool = False):
    """Rows of a (and b) in the lanes schedule on the card: row-major
    (..., W), or with ``planes`` (W, R) planes."""
    vf, ic, evf = lanes = tuple(lanes)
    if lanes != CHAIN and lanes not in (_ADD_LANES if b is None else _FMA_LANES):
        raise ValueError(f"lanes {lanes} ({'fma' if b is not None else 'add'}) "
                         f"have no kernel instance in csrc/ordered_sum.cu")
    if planes:
        W, R = a.shape
        lead = (R,)
    else:
        W = a.shape[-1]
        lead = tuple(a.shape[:-1])
        R = math.prod(lead)
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    out = torch.empty(R, dtype=a.dtype, device=a.device)
    if R == 0:
        return out.reshape(lead)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernels()[1](a.data_ptr(), None if b is None else b.data_ptr(),
                            out.data_ptr(), R, W, vf, ic, evf, int(planes),
                            stream)
    _check_err(err, "ordered_sum_lanes")
    LAUNCHES["ordered_sum_lanes"] += 1
    return out.reshape(lead)
