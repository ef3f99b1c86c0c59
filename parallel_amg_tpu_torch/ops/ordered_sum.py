"""Float32 row sums in the order the JAX package's CPU backend adds them,
and the binding of ``csrc/ordered_sum.cu``.

A float32 sum depends on the order of its adds.  The JAX package's RS
setups compute ``jnp.sum(x, axis=1)`` and ``jnp.sum(x, axis=(1, 2))`` over
masked rows; the port must add in XLA's order to get the same bits, or a
last-bit change near θ flips a strength test on a coarse level and the
hierarchy drifts.  torch's own ``sum`` takes other orders (vectorised lanes
on the CPU, a tree on the card).

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
vf·ic after another); the accumulators are added lanewise in order, and the
vf lanes reduced by halving (lane l + lane l + vf/2, ...); then, where evf
> 0 and evf elements remain, a vector of evf lanes starting from that sum in
lane 0 takes whole blocks of evf elements and is reduced the same way; the
last elements are added one at a time.  Which reductions LLVM vectorises,
and how, depends on the fused loop body and the row's width.  Of the RS
setups' sums only one is vectorised: the one-device extended+i's weak
couplings, whose schedule ``weak_lanes`` gives.

``row_sum`` runs the plain version (``row_sum_plain``, one elementwise add
per element position: IEEE adds are exact, so it gives the same bits on
every device) on a CPU tensor, and launches ``csrc/ordered_sum.cu`` (one
thread per output, ``__fadd_rn``) on a CUDA tensor, once per level of
windows.  Each launch runs one of three kernels, chosen as the C entry
point chooses it (``_kernel_name``), and ``LAUNCHES`` counts them by name.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from parallel_amg_tpu_torch.ops import _build

WINDOW = 32
MAX_STAGED_ROW = 64  # csrc/ordered_sum.cu's kMaxStagedRow

# kernel launches by kernel, counted in ``_launch``; callers may reset them
LAUNCHES = {"ordered_sum_staged": 0, "ordered_sum_windows": 0,
            "ordered_sum_lanes": 0}


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


def _check_lanes(x, dims: int, lanes) -> None:
    if lanes is None:
        return
    vf, ic, evf = lanes
    if dims != 1 or x.shape[-1] > WINDOW:
        raise ValueError(f"lanes order one axis of at most {WINDOW}, not "
                         f"{tuple(x.shape[x.dim() - dims:])}")
    if not (vf in (2, 4, 8, 16) and 1 <= ic and vf * ic <= 32
            and evf in (0, 2, 4, 8, 16)):
        raise ValueError(f"lanes {lanes}: vf and evf powers of 2 to 16, "
                         f"vf·ic ≤ 32")


def row_sum(x, dims: int = 1, lanes=None):
    """Σ over the last ``dims`` axes of float32 ``x``, in XLA's CPU order
    (LLVM's vectorised order where ``lanes`` is given)."""
    _check(x, dims)
    _check_lanes(x, dims, lanes)
    if x.device.type == "cpu":
        return row_sum_plain(x, dims, lanes)
    if x.device.type != "cuda":
        raise ValueError(f"row_sum runs on cpu or cuda, not {x.device}")
    return _row_sum_cuda(x, dims, lanes)


def _as_rows(x, dims: int):
    """(x as (R, d1, d2) with d1 = 1 for one axis, the rows' shape)."""
    lead = tuple(x.shape[: x.dim() - dims])
    red = tuple(x.shape[x.dim() - dims:])
    d1, d2 = (1,) + red if dims == 1 else red
    return x.reshape(math.prod(lead), d1, d2), lead


def _halving(v):
    """LLVM's reduction of a (R, n) vector of lanes, n a power of 2."""
    while v.shape[1] > 1:
        h = v.shape[1] // 2
        v = v[:, :h] + v[:, h:]
    return v[:, 0]


def _lanes_plain(x2, vf: int, ic: int, evf: int):
    R, W = x2.shape
    step = vf * ic
    j = W // step * step
    s = torch.zeros(R, dtype=x2.dtype, device=x2.device)
    if j:
        acc = torch.zeros((R, ic, vf), dtype=x2.dtype, device=x2.device)
        for b in range(0, j, step):
            acc = acc + x2[:, b:b + step].reshape(R, ic, vf)
        comb = acc[:, 0]
        for p in range(1, ic):
            comb = comb + acc[:, p]
        s = _halving(comb)
    if evf and W - j >= evf:
        lanes = torch.zeros((R, evf), dtype=x2.dtype, device=x2.device)
        lanes[:, 0] = s
        end = j + (W - j) // evf * evf
        for b in range(j, end, evf):
            lanes = lanes + x2[:, b:b + evf]
        s, j = _halving(lanes), end
    for k in range(j, W):
        s = s + x2[:, k]
    return s


def row_sum_plain(x, dims: int = 1, lanes=None):
    """The plain version: one float32 add per element position, in order."""
    _check(x, dims)
    _check_lanes(x, dims, lanes)
    if lanes is not None:
        x3, lead = _as_rows(x, dims)
        return _lanes_plain(x3[:, 0], *lanes).reshape(lead)
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


@functools.cache
def _kernel():
    fn = _build.load("ordered_sum").ordered_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _kernel_name(d1: int, d2: int, n, lanes) -> str:
    """The kernel ``ordered_sum`` in csrc/ordered_sum.cu launches."""
    if lanes[0] > 0:
        return "ordered_sum_lanes"
    if n == (1, 1) and 0 < d1 * d2 <= MAX_STAGED_ROW:
        return "ordered_sum_staged"
    return "ordered_sum_windows"


def _launch(x3, out, w, n, lo, lanes=(0, 0, 0)) -> None:
    """One level: out (R, n1, n2) = the windows' sums of x3 (R, d1, d2)
    (``lanes`` ≠ (0, 0, 0): one window, in LLVM's vectorised order)."""
    R, d1, d2 = x3.shape
    with torch.cuda.device(x3.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(x3.data_ptr(), out.data_ptr(), R, d1, d2, w[0], w[1],
                        n[0], n[1], lo[0], lo[1], *lanes, stream)
    if err != 0:
        raise RuntimeError(f"ordered_sum launch failed: cudaError {err}")
    LAUNCHES[_kernel_name(d1, d2, tuple(n), lanes)] += 1


def _row_sum_cuda(x, dims: int, lanes=None):
    x3, lead = _as_rows(x, dims)
    x3 = x3.contiguous()
    if x3.shape[0] == 0:
        return torch.zeros(lead, dtype=x.dtype, device=x.device)
    if lanes is not None:
        R, d1, d2 = x3.shape
        out = torch.empty((R, 1, 1), dtype=x.dtype, device=x.device)
        _launch(x3, out, (d1, d2), (1, 1), (0, 0), tuple(lanes))
        return out.reshape(lead)
    while True:
        R, d1, d2 = x3.shape
        (w1, n1, lo1), (w2, n2, lo2) = windows(d1), windows(d2)
        out = torch.empty((R, n1, n2), dtype=x.dtype, device=x.device)
        _launch(x3, out, (w1, w2), (n1, n2), (lo1, lo2))
        if n1 == 1 and n2 == 1:
            return out.reshape(lead)
        x3 = out
