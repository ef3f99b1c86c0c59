"""The power iterations' stencil matvec y = D⁻¹·(A·x) in the JAX package's
CPU order, and the binding of its kernel ``ordered_stencil_matvec``
(``csrc/halo_stencil.cu``).

λ_max(D⁻¹A) sets the Chebyshev interval, so the port's power iterations add
their products in the float32 order of the JAX package's CPU backend (read
off its optimised HLO and object code; ``tests/test_torch_ordered_sum.py``,
``tests/test_torch_config3_sharded.py`` and ``tests/test_torch_p468_order.py``
hold it):

- per point one fused multiply-add chain from +0.0 over the planes in
  ``chain_order`` (``ordered_sum.STENCIL_FIRST``, then offset order), x
  read as 0 where the neighbour lies off the grid, or, for a part of a grid
  split along axis 0, off its slab.  Where LLVM vectorises a 7-point grid
  across its middle axis (``unfused_centre``: n2 of 5 to 8, on one device
  and in parts) the centre's product is rounded and then added on the rows
  its vector loop covers (``split`` and ``rows``);
- a part of a split grid (``parallel/pdevice_setup._sharded_power``, the
  JAX package's sharded ``_jit_power``, whose matvec is the "xla"
  ``ShardedStencil.matvec``) then adds, in offset order, each offset with
  o₀ ≠ 0 on the |o₀| planes at its slab's end that it reaches past:
  fma(W, halo plane, y), with a zero plane at the grid's ends;
- then y = D⁻¹·y, one rounded multiply.

``matvec`` runs the plain version (``matvec_plain``: the torch formulation,
each fused multiply-add emulated exactly by ``ordered_sum.fma_plain``) on CPU
tensors, and on CUDA tensors one ``ordered_stencil_matvec`` launch a card
(and ``halo_kernels.MAX_PARTS`` parts) for every local part, on kernel B8's
part table (``ops/halo_kernels``): the halos are read in place (views of the
neighbours' slabs on the card, or the exchanged buffers).  A failed build or
launch raises.  ``ordered_sum.LAUNCHES["ordered_stencil_matvec"]`` counts
the launches.
"""

from __future__ import annotations

import warnings

import torch

from parallel_amg_tpu_torch.ops import halo_kernels as hk
from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.ops.stencil import Stencil


def chain_order(K: int):
    """The plane order of the JAX package's CPU stencil product of K
    offsets in its power iterations: one fma chain, the first two planes
    taken as ``ordered_sum.STENCIL_FIRST``, then the rest in offset
    order."""
    return list(ordered_sum.STENCIL_FIRST) + list(range(2, K)) if K > 1 else [0]


def ordered_apply(order, planes, A: Stencil, x, split=None, launch=False, rows=None,
                  swap_from=None):
    """A x for float32 ``planes``, A's planes in ``order``
    (``chain_order``), added in that order: one fma chain, or, where
    ``split`` is the centre's position (``unfused_centre``), the centre's
    product added rounded on the rows i1 < ``rows`` of axis 1 (all rows
    where None), as LLVM's vector loop adds it, and fused on the rest; on
    the columns from ``swap_from`` on (the last axis; ``plan_2d``) the
    chain's first two planes are taken the other way round.  The chain and
    fmas are ``ordered_sum``'s plain versions; with ``launch`` its kernels
    on a CUDA tensor (``planes_dot`` and ``fma``)."""
    dot = ordered_sum.planes_dot if launch else ordered_sum.planes_dot_plain
    fma = ordered_sum.fma if launch else ordered_sum.fma_plain
    shifted = A.shifted(x)
    xs = torch.stack([shifted[d] for d in order])
    if swap_from is not None:
        head = dot(planes[:2], xs[:2])
        swapped = dot(planes[[1, 0]], xs[[1, 0]])
        s = torch.cat([head[..., :swap_from], swapped[..., swap_from:]], -1)
        for k in range(2, len(order)):
            s = fma(planes[k], xs[k], s)
        return s
    if split is None:
        return dot(planes, xs)
    s = dot(planes[:split], xs[:split])
    unfused = s + planes[split] * xs[split]
    if rows is None or rows >= s.shape[1]:
        s = unfused
    else:
        s = torch.cat([unfused[:, :rows], fma(planes[split], xs[split], s)[:, rows:]], 1)
    for k in range(split + 1, len(order)):
        s = fma(planes[k], xs[k], s)
    return s


# The vector loop LLVM makes of the JAX package's 7-point 3-D matvec when
# n2 (the last axis) is 5 to 8: it runs over i1 (the middle axis), n2 chains
# a trip, and adds the centre's product rounded (the centre is x itself, not
# a slice of the padded x, and its wide product reaches the chains through
# a shuffle, which the backend does not contract); the scalar loop after it
# fuses.  Read off the optimised LLVM IR of the matvec's fusion (XLA_FLAGS
# --xla_dump_to with --xla_dump_hlo_as_text; jaxlib 0.9.0, x86-64 with
# AVX-512) at n1 = 1 to 100 and 468, one device with n0 = 1, 2, 4 and 16
# and 8 parts with m0 = 1, 2, 3 and 8 (n1 = 37 to 109 in steps of 8 where
# the sweep was sparse), and the rows checked on the bits
# (scripts/jax_p468_power.py --interior):
# - n1 < 16: LLVM vectorises only a trip count that whole vectors cover:
#   n1 = 4 and 8 take every row unfused, every other n1 below 16 none;
# - n2 = 7, 8: vectors of 4 rows and no scalar epilogue: R = 4·⌊n1/4⌋;
# - n2 = 5, 6: the loads of x interleave with gaps, so at least one trip
#   runs scalar, R = n1 − (n1 mod vf or vf), and the width vf is the cost
#   model's for the known trip count, which weighs whole vectors against the
#   rows left over: with n1 = 8q + r, vf = 4 where r ≥ 4 and q is below a
#   threshold, else 8.  The threshold (``_VF4_BELOW``) depends on n2 and on
#   the fusion: one device (D⁻¹ fused into it) with n0 = 1 or more, or the
#   interior of a part.
# Not read (``unfused_centre`` warns and takes one chain): a part of one
# plane (m0 = 1), whose zero neighbour planes XLA folds out of the chain
# (another chain, not a row bound), and a one-device grid with n1 = 1, whose
# vector loop runs over i0.
_VF4_BELOW = {("one_device", 1, 5): 8, ("one_device", 1, 6): 7,
              ("one_device", 2, 5): 10, ("one_device", 2, 6): 9,
              ("sharded", 2, 5): 11, ("sharded", 2, 6): 9}


def unfused_centre(offsets, slab, sharded: bool):
    """(split, rows) of the JAX package's power-iteration matvec on a grid
    (one device) or a part (``sharded``) of shape ``slab`` (m0, n1, n2):
    the centre's position in ``chain_order`` and R (the comment above), its
    product added unfused on the rows i1 < R and fused on the rest; (None,
    0) where every row fuses (any stencil but a 3-D 7-point one, or n2
    outside 5 to 8)."""
    offsets = tuple(tuple(o) for o in offsets)
    if len(slab) != 3 or len(offsets) != 7 or not 5 <= slab[2] <= 8:
        return None, 0
    m0, n1, n2 = (int(a) for a in slab)
    if (m0 == 1 and sharded) or n1 == 1:
        warnings.warn(f"the JAX package's order of the power iteration's matvec on a "
                      f"{'part' if sharded else 'grid'} of {tuple(slab)} is not read "
                      f"(ROADMAP C7a): one fma chain, λ may differ in its last bits",
                      stacklevel=3)
        return None, 0
    key = ("sharded" if sharded else "one_device", min(m0, 2), n2)
    rows = _vector_rows(n1, n2, _VF4_BELOW.get(key))
    if rows == 0 or (0, 0, 0) not in offsets:
        return None, 0
    return chain_order(7).index(offsets.index((0, 0, 0))), rows


def _vector_rows(n, m: int, vf4_below) -> int:
    """R of the vector loop over n rows of m floats (5 ≤ m ≤ 8; the comment
    above): every row where n is 4 or 8, none for other n below 16, 4·⌊n/4⌋
    for m of 7 or 8, else n − (n mod vf or vf) with vf 4 where n = 8q + r
    has r ≥ 4 and q < ``vf4_below``, else 8."""
    if n < 16:
        return n if n in (4, 8) else 0
    if m >= 7:
        return 4 * (n // 4)
    q, r = divmod(n, 8)
    vf = 4 if r >= 4 and q < vf4_below else 8
    return n - (n % vf or vf)


# A 2-D grid (n0, n1), read off the matvec fusion's object code the same
# way and on the bits of the JAX package's jitted matvec (5 and 9 points,
# n1 of 1 to 12 at n0 of 1 to 70 and up to 342, n1 of 5 and 6 at n0 up to
# 140, n1 of 9 to 80 at a few n0; ``scripts/probe_xla_galerkin_order.py
# --norms2d`` re-reads n1 of 1 to 12): where n1 is 5 to 8, LLVM
# vectorises the loop over i0 as it does the 3-D grid's over i1, n1 chains
# a trip, the centre added rounded on the rows i0 < R (``_vector_rows``,
# thresholds ``_VF4_BELOW_2D`` by points and n1); where n1 is 9 on 9
# points it vectorises i1 by 8 and the scalar code of the last column
# contracts the chain's first add the other way: the first two planes
# taken (0, 1).  The matvec runs on the (1, n0, n1) view of the grid, so
# that R bounds axis 1 as on a 3-D grid.  Grids small enough that XLA
# compiles the whole loop body into one function (``ordered_sum.ONE_CALL``)
# keep one chain.
_VF4_BELOW_2D = {(5, 5): 9, (5, 6): 8, (9, 5): 8, (9, 6): 7}


def plan_2d(offsets, dims):
    """(split, rows, swap_from) of the JAX package's power-iteration matvec
    on a 2-D grid ``dims`` (the comment above): the centre's position in
    ``chain_order`` and R of its rounded rows, and the first column whose
    chain starts the other way round; (None, 0, None) for one fma chain.
    Another stencil than one of 5 or 9 points on a grid of 5 to 9 columns
    is not read: a warning and one chain."""
    offsets = tuple(tuple(int(c) for c in o) for o in offsets)
    n0, n1 = (int(n) for n in dims)
    pts = len(offsets)
    one_call = ordered_sum.ONE_CALL.get(pts)
    if not 5 <= n1 <= 9 or (0, 0) not in offsets or (one_call and one_call(n0, n1)):
        return None, 0, None
    if pts not in (5, 9):
        warnings.warn(f"the JAX package's order of the power iteration's matvec on a 2-D "
                      f"grid of {(n0, n1)} with {pts} points is not read (ROADMAP C7b): "
                      f"one fma chain, λ may differ in its last bits", stacklevel=3)
        return None, 0, None
    if n1 == 9:
        return (None, 0, 8) if pts == 9 else (None, 0, None)
    rows = _vector_rows(n0, n1, _VF4_BELOW_2D.get((pts, n1)))
    if rows == 0:
        return None, 0, None
    return chain_order(pts).index(offsets.index((0, 0))), rows, None


class Plan:
    """What the matvec reads on every iteration of one power iteration:
    the local parts' float32 weights (K, m0, *rest) and D⁻¹ (m0, *rest; None:
    no scaling), the offsets, the chain's plane order and ``split``, and
    the halo terms (``sharded``: the offsets with o₀ ≠ 0 in offset order;
    one device: none), and ``swap_from`` (``ordered_apply``; one device).
    Built once per power iteration; the kernel's part tables and the plain
    version's plane copies are made at their first use and kept."""

    def __init__(self, weights, scales, offsets, sharded: bool, split=None, rows=None,
                 swap_from=None):
        self.weights = [W.contiguous() for W in weights]
        self.scales = ([None] * len(self.weights) if scales is None else
                       [None if s is None else s.contiguous() for s in scales])
        self.offsets = tuple(tuple(int(c) for c in o) for o in offsets)
        self.slab = tuple(self.weights[0].shape[1:])
        self.order = chain_order(len(self.offsets))
        self.split = split
        self.rows = rows
        self.swap_from = swap_from
        self.corr = [d for d, o in enumerate(self.offsets) if o[0] != 0] if sharded else []
        self.h = max((abs(self.offsets[d][0]) for d in self.corr), default=0)
        self._plain = None
        self._cards = None

    @classmethod
    def one_device(cls, A: Stencil, d_inv, split=None, rows=None, swap_from=None):
        """The plan of one device's power iteration on A."""
        return cls([A.weights], [d_inv], A.offsets, sharded=False, split=split, rows=rows,
                   swap_from=swap_from)

    def plain_parts(self):
        """Per part the plain version's Stencil on its slab, its planes in
        chain order and each halo term's rows of W, contiguous."""
        if self._plain is None:
            m0 = self.slab[0]
            self._plain = []
            for W in self.weights:
                local = Stencil(W, self.offsets, self.slab)
                rows = [W[d][_rows(self.offsets[d][0], m0)].contiguous()
                        for d in self.corr]
                self._plain.append((local, W[self.order], rows))
        return self._plain


def _rows(o0: int, m0: int):
    """The planes of a slab of m0 whose offset o₀ reaches past its end."""
    return slice(0, -o0) if o0 < 0 else slice(m0 - o0, m0)


def matvec(plan: Plan, xs, halos=None):
    """y = D⁻¹·(A·x) of every local part in the JAX package's CPU order, as a
    list: ``xs`` the parts' x (m0, *rest), ``halos`` per part (left, right),
    the (h, *rest) halos of the neighbours or None (the grid's ends; None for
    all: no neighbours).  The plain version on CPU tensors; on CUDA tensors
    one ``ordered_stencil_matvec`` launch a card."""
    if halos is None:
        halos = [(None, None)] * len(xs)
    kinds = {x.device.type for x in xs}
    if kinds == {"cpu"}:
        return matvec_plain(plan, xs, halos)
    if kinds != {"cuda"}:
        raise ValueError(f"ordered_stencil.matvec runs on cpu or cuda parts, not {kinds}")
    return _matvec_cuda(plan, xs, halos)


def matvec_plain(plan: Plan, xs, halos, launch=False):
    """The plain version of ``matvec`` (any device): per part
    ``ordered_apply`` on its slab, then each halo term's fma on the planes
    it reaches (its halo zero-padded on the other axes, a zero plane at the
    grid's ends), then D⁻¹.  With ``launch`` on CUDA tensors, the sequence
    of ``ordered_sum`` kernels the power iterations took before this
    kernel: a stack of the shifted planes, one ``ordered_sum_lanes`` chain
    and one ``ordered_fma`` a halo term."""
    fma = ordered_sum.fma if launch else ordered_sum.fma_plain
    h, m0 = plan.h, plan.slab[0]
    rest = plan.slab[1:]
    reach = [max(abs(o[i]) for o in plan.offsets) for i in range(1, len(plan.offsets[0]))]
    pads = [p for r in reversed(reach) for p in (r, r)]
    out = []
    for (local, planes, w_rows), xl, sides, scale in zip(plan.plain_parts(), xs, halos,
                                                         plan.scales):
        y = ordered_apply(plan.order, planes, local, xl, plan.split, launch, plan.rows,
                          plan.swap_from)
        if plan.corr:  # each side's halo planes, zero-padded on the other axes
            padded = {s: torch.nn.functional.pad(
                torch.zeros((h,) + rest, dtype=xl.dtype, device=xl.device)
                if hs is None else hs, pads) for s, hs in zip((-1, 1), sides)}
        for d, Wr in zip(plan.corr, w_rows):
            off = plan.offsets[d]
            o0 = off[0]
            src = padded[1 if o0 > 0 else -1][
                (slice(h + o0, h) if o0 < 0 else slice(0, o0),)
                + tuple(slice(r + c, r + c + n) for r, c, n in zip(reach, off[1:], rest))]
            rows = _rows(o0, m0)
            if launch:
                fma(Wr, src, y[rows], out=y[rows])
            else:
                y[rows] = fma(Wr, src, y[rows])
        out.append(y if scale is None else scale * y)
    return out


def _tables(plan: Plan):
    """The kernel's terms (the chain in its order, then the halo terms) and
    per card its part tables (``halo_kernels.Card``, with D⁻¹), made once
    per plan."""
    if plan._cards is not None:
        return plan._cards
    (n1, n2), offs3 = hk.grid3(plan.slab[1:], plan.offsets)
    terms = hk.terms_struct([(d,) + offs3[d] for d in plan.order] + list(
        hk.halo_terms(offs3) if plan.corr else ()))
    for W, s in zip(plan.weights, plan.scales):
        hk.check_weights(W, plan.slab, plan.offsets)
        if s is not None:
            hk.check_slab(s, plan.slab, W.device, "D⁻¹")
    cards = {}
    for i, W in enumerate(plan.weights):
        cards.setdefault(W.device, []).append((i, None, None))
    plan._cards = (terms, (n1, n2), [hk.Card(dev, rows, plan.weights, n2,
                                             scales=plan.scales)
                                     for dev, rows in cards.items()])
    return plan._cards


def _matvec_cuda(plan: Plan, xs, halos):
    terms, (n1, n2), cards = _tables(plan)
    if len(xs) != len(plan.weights):
        raise ValueError(f"{len(xs)} slabs for {len(plan.weights)} parts")
    m0, h = plan.slab[0], plan.h
    halo_shape = (h,) + plan.slab[1:]
    step = 4 * m0 * n1 * n2
    chain = len(plan.order)
    split = -1 if plan.split is None else plan.split
    rows = n1 if plan.rows is None else plan.rows
    swap = n2 if plan.swap_from is None else plan.swap_from
    ys = [None] * len(xs)
    for card in cards:
        y = torch.empty((len(card.positions) * m0,) + plan.slab[1:], device=card.device)
        vec = int(card.vec and y.data_ptr() % 16 == 0 and swap == n2)
        for c0, t in card.interior_tables:
            pos = card.positions[c0:c0 + t.count]
            t.x[:t.count] = [hk.check_slab(xs[i], plan.slab, card.device, "x") for i in pos]
            t.y[:t.count] = [y.data_ptr() + k * step for k in range(c0, c0 + t.count)]
            for k, i in enumerate(pos):
                left, right = halos[i]
                t.left[k], t.right[k] = (
                    None if s is None else hk.check_slab(s, halo_shape, card.device, "halo")
                    for s in (left, right))
            hk.launch("ordered_stencil_matvec", card.device, t, m0, n1, n2, h, terms,
                      chain, split, rows, swap, vec)
            ordered_sum.LAUNCHES["ordered_stencil_matvec"] += 1
        for i, yi in zip(card.positions, y.split(m0)):
            ys[i] = yi
    return ys
