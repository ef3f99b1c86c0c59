"""The bucketed Galerkin stage as the port ran it before ``ordered_bucket_stage``:
a sequence of torch operations and ``ordered_sum.fma`` launches, kept
unchanged as the witness that ``ops/bucket_stage.py`` (its plain version
and its kernel) is held against (``tests/test_torch_bucket_stage.py`` and
``chip_smoke.py``).  It builds its own updates, masks and shifted copies of
X, so it shares no code with the module it checks but ``ordered_sum.fma``
and ``shift_nd``.

``earlier_sequence(factors, offsets, X, box_in, box_out, b, dims)`` gives
Y[O](p) = Σ_off factor_off(p) · X[O − δ_off(p)](p + off).  Writes landing
outside box_out are structurally zero and are dropped by the slice
intersection.  In the order the JAX package's CPU backend compiles it to
(read off its optimised HLO and object code): XLA first sums every update
that covers the whole box (δ = 0), in program order, then applies the
sliced updates in program order, each a fused multiply-add into its slice,
with factor·mask as select(mask, factor, 0); the whole-box sum takes the
first product fused into the rounded second, each later one fused.  A stage
with no whole-box update starts from its first slice's rounded product.
Float32 fused multiply-adds go through ``ordered_sum.fma`` (one launch per
contiguous block on a CUDA tensor); other types take torch's order.
"""

import itertools

import torch

from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.ops.stencil import shift_nd


def _delta_support(off, b: int):
    """Support of δ(p) = (p%b + off)//b, per axis then product."""
    axes = [sorted({(r + off[i]) // b for r in range(b)})
            for i in range(len(off))]
    return list(itertools.product(*axes))


def _residue_mask(dims, off, delta, b: int, dtype, device):
    """Indicator of δ_off(p) == delta, broadcastable to dims."""
    m = None
    for i in range(len(dims)):
        shape = [1] * len(dims)
        shape[i] = dims[i]
        r = torch.arange(dims[i], device=device).reshape(shape) % b
        c = ((r + off[i]) // b) == delta[i]
        m = c if m is None else (m & c)
    return m.to(dtype)


def earlier_sequence(factors, offsets, X, box_in, box_out, b: int, dims):
    """Y of one stage (the module docstring)."""
    nd = len(dims)
    out_shape = tuple(h - l + 1 for l, h in box_out)
    fused = X.dtype == torch.float32
    full, part = [], []
    for off, fac in zip(offsets, factors):
        for delta in _delta_support(off, b):
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
                    (off, fac, delta, tuple(tgt), tuple(src)))

    shifted = {}

    def operands(u):
        """(factor·mask, X shifted and sliced) of one update; one shifted
        copy of X alive at a time."""
        off, fac, delta, _, src = u
        if off not in shifted:
            shifted.clear()
            shifted[off] = shift_nd(X, off, dims).contiguous()
        mask = _residue_mask(dims, off, delta, b, torch.bool, X.device)
        return torch.where(mask, fac, 0.0), shifted[off][src]

    def fmadd(Yt, u):
        """Yt ← fma(factor·mask, X slice, Yt) in place, one launch per
        contiguous block: the whole box where the target and the X slice are
        contiguous, else a launch for each index of the fewest leading box
        axes after which both are."""
        fm, xs = operands(u)
        if not fused:
            Yt += fm * xs
            return
        j = next(j for j in range(nd + 1) if Yt[(0,) * j].is_contiguous()
                 and (xs[(0,) * j].is_contiguous() or j == nd))
        for s in itertools.product(*[range(n) for n in Yt.shape[:j]]):
            ordered_sum.fma(fm, xs[s], Yt[s], out=Yt[s])

    if full:
        # the first product fused into the rounded second, then the rest
        order = [full[1], full[0]] + full[2:] if len(full) >= 2 else full
        fm, xs = operands(order[0])
        Y = (fm * xs).contiguous()
        del fm, xs
        for u in order[1:]:
            fmadd(Y, u)
    else:
        Y = torch.zeros(out_shape + tuple(dims), dtype=X.dtype, device=X.device)
        fm, xs = operands(part[0])
        Y[part[0][3]] = fm * xs
        del fm, xs
        part = part[1:]
    for u in part:
        fmadd(Y[u[3]], u)
    shifted.clear()
    return Y
