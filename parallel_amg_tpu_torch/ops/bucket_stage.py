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

``terms`` lists the updates in that order (``Term``: kind 0 stores the
rounded product, kind 1 adds a fused multiply-add).  ``stage`` makes it and
runs ``stage_plain`` (torch over the list, each float32 fused multiply-add
``ordered_sum.fma_plain``; other types in torch's order, a rounded product
and a rounded add) on CPU tensors and on types other than float32, and on
float32 CUDA tensors one ``ordered_bucket_stage`` launch: a thread a grid
point walks the terms in order, computes each one's mask from its residues
and its factor once, and applies it to every output box of its target (up
to 27 boxes a thread, their sums in registers; ``kernel_table`` gives each
term's source box per output box, copied to the card in one int32 tensor),
X read in place, so no shifted copy of X and no mask is made.  The kernel
takes grids of one to three axes.  A failed build or launch raises.
``ordered_sum.LAUNCHES["ordered_bucket_stage"]`` counts the launches.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import torch

from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.ops.stencil import shift_nd

TERM_INTS = 8   # csrc/ordered_sum.cu's kTermInts
BOX_GROUP = 27  # csrc/ordered_sum.cu's kBoxGroup


class Term(NamedTuple):
    """One update of a stage: ``kind`` 0 (store the rounded product) or 1
    (fused multiply-add), the factor plane ``k``, the fine offset, δ, and the
    target and source slices of the output and input boxes."""
    kind: int
    k: int
    off: tuple
    delta: tuple
    tgt: tuple
    src: tuple


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


def terms(offsets, box_in, box_out, b: int) -> list:
    """The stage's terms in the JAX package's CPU order (module docstring)."""
    full, part = updates(offsets, box_in, box_out, b)
    if len(full) >= 2:
        full = [full[1], full[0]] + full[2:]
    return [Term(0 if i == 0 else 1, k, off, delta, tgt, src)
            for i, (off, k, delta, tgt, src) in enumerate(full + part)]


def stage(F, offsets, X, box_in, box_out, b: int, dims):
    """Y of one stage: ``F`` the (K, *dims) factor planes of the fine
    ``offsets``, ``X`` the (*box_in shape, *dims) input.  The plain version
    on CPU tensors and on types other than float32, one
    ``ordered_bucket_stage`` launch on float32 CUDA tensors."""
    kinds = {F.device.type, X.device.type}
    if not kinds <= {"cpu", "cuda"} or F.device != X.device:
        raise ValueError(f"bucket_stage runs on one cpu or cuda device, not {kinds}")
    if F.dtype != X.dtype:
        raise TypeError(f"bucket_stage: factors of {F.dtype}, X of {X.dtype}")
    if kinds == {"cpu"} or X.dtype != torch.float32:
        return stage_plain(F, offsets, X, box_in, box_out, b, dims)
    return _stage_cuda(F, X, terms(offsets, box_in, box_out, b), box_in, box_out, b, dims)


def stage_plain(F, offsets, X, box_in, box_out, b: int, dims):
    """The plain version of ``stage`` (any device): Y from +0, then each
    term on its target slice of the box, the factor masked by
    ``residue_mask`` and X shifted by the offset, as a rounded product
    (kind 0) or, in float32, an ``ordered_sum.fma_plain`` (other types: a
    rounded product and a rounded add)."""
    out_shape = tuple(h - l + 1 for l, h in box_out)
    nd = len(dims)
    fused = X.dtype == torch.float32
    Y = torch.zeros(out_shape + tuple(dims), dtype=X.dtype, device=X.device)
    shifted = {}
    for t in terms(offsets, box_in, box_out, b):
        if t.off not in shifted:  # one shifted copy of X alive at a time
            shifted.clear()
            shifted[t.off] = shift_nd(X, t.off, dims)
        fm = torch.where(residue_mask(dims, t.off, t.delta, b, X.device), F[t.k], 0.0)
        fm = fm.reshape((1,) * nd + tuple(dims))
        xs = shifted[t.off][t.src]
        if t.kind == 0:
            Y[t.tgt] = fm * xs
        else:
            Y[t.tgt] = ordered_sum.fma_plain(fm, xs, Y[t.tgt]) if fused else Y[t.tgt] + fm * xs
    return Y


def kernel_table(table, box_in, box_out, b: int):
    """The kernel's int32 tables: per term ``TERM_INTS`` values (kind, k,
    off, and the residue window's start lo = δ·b − off per axis: a point's δ
    is the term's where lo ≤ p mod b < lo + b), and per term the source box
    (row-major in X's box) of every output box (row-major), −1 where the
    output box is not in its target, padded with −1 to a multiple of
    ``BOX_GROUP`` columns.  A stage of one or two axes is taken as 3-D with
    leading axes of one."""
    nd = len(box_out)
    pad = (0,) * (3 - nd)
    in_shape = tuple(h - l + 1 for l, h in box_in)
    out_shape = tuple(h - l + 1 for l, h in box_out)
    n_cols = -(-math.prod(out_shape) // BOX_GROUP) * BOX_GROUP
    rows, src = [], []
    for t in table:
        lo = tuple(d * b - c for d, c in zip(t.delta, t.off))
        rows.append((t.kind, t.k) + pad + tuple(t.off) + pad + lo)
        cols = [-1] * n_cols
        for o in itertools.product(*[range(g.start, g.stop) for g in t.tgt]):
            s = tuple(c - g.start + r.start for c, g, r in zip(o, t.tgt, t.src))
            cols[_linear(o, out_shape)] = _linear(s, in_shape)
        src.append(cols)
    return rows, src


def _linear(idx, shape) -> int:
    out = 0
    for i, n in zip(idx, shape):
        out = out * n + i
    return out


def _stage_cuda(F, X, table, box_in, box_out, b: int, dims):
    nd = len(dims)
    if not 1 <= nd <= 3:
        raise ValueError(f"ordered_bucket_stage takes grids of 1 to 3 axes, not {nd}")
    out_shape = tuple(h - l + 1 for l, h in box_out)
    in_shape = tuple(h - l + 1 for l, h in box_in)
    dev = X.device
    F = F.contiguous()
    X = X.contiguous()
    if (tuple(F.shape[1:]) != tuple(dims) or tuple(X.shape) != in_shape + tuple(dims)
            or F.shape[0] <= max(t.k for t in table)):
        raise ValueError(f"bucket_stage: F {tuple(F.shape)}, X {tuple(X.shape)} for "
                         f"dims {tuple(dims)} and boxes {in_shape} in")
    rows, src = kernel_table(table, box_in, box_out, b)
    n_cols = len(src[0])
    flat = torch.tensor([v for r in rows for v in r] + [v for c in src for v in c],
                        dtype=torch.int32).to(dev)
    Y = torch.empty(out_shape + tuple(dims), dtype=torch.float32, device=dev)
    n0, n1, n2 = (1,) * (3 - nd) + tuple(int(d) for d in dims)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = ordered_sum._kernels()[3](F.data_ptr(), X.data_ptr(), Y.data_ptr(),
                                        flat.data_ptr(), flat[len(table) * TERM_INTS:].data_ptr(),
                                        len(table), math.prod(out_shape), n_cols, n0, n1, n2,
                                        b, stream)
    ordered_sum._check_err(err, "ordered_bucket_stage")
    ordered_sum.LAUNCHES["ordered_bucket_stage"] += 1
    return Y
