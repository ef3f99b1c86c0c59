"""On-device AMG setup — the structured block-SA path.

Counterpart of ``parallel_amg_tpu/amg/device_setup.py``.  On regular grids
the whole setup reduces to stencil algebra on device tensors:

- tentative aggregation: block partition; its only data is the aggregate
  size normalization, a sum-pool of a ones field;
- prolongator smoothing S = I − (ω/λ)D⁻¹A: plane scaling plus identity;
- Galerkin product A_c = Tᵀ (Sᵀ A S) T, by one of three product paths:
  "dense" (two closed-form stencil products, then a residue-class pooled
  reduction), "slab" (the dense pipeline in axis-0 slabs with halos, for
  grids whose full-grid intermediates exceed the chunk budget) or
  "bucketed" (intermediates indexed by coarse offset, so the plane count
  stays at 3^d);
- λ_max(D⁻¹A): device power iteration;
- sparsification with diagonal lumping, then pruning of all-zero planes (one
  small host read per level).

The host decides shapes only; every O(n) operation runs on the tensors'
device.  The slab kernel ``_slab_coarse_operator`` also serves the
distributed setup (``parallel/pdevice_setup.py``), one part's slab at a
time, with a ``mask`` of the sharded grid's padding rows.
"""

from __future__ import annotations

import functools
import itertools
from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg.hierarchy import (
    Hierarchy,
    Level,
    coarse_inverse_np,
)
from parallel_amg_tpu_torch.amg.transfers import (
    BlockProlongator,
    BlockRestrictor,
    downsample_sum_nd,
)
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import bucket_stage, ordered_stencil, ordered_sum, prng
from parallel_amg_tpu_torch.ops.stencil import Stencil, bucket_add, shift_nd


def start_vector(dims, dtype, device, seed: int = 0):
    """Start of the power iteration: the JAX package's ``uniform`` draw
    minus 0.5, in [−0.5, 0.5), made on the host and copied to ``device``."""
    return (prng.uniform(dims, seed, dtype) - 0.5).to(device)


def power_iteration_lambda_max(A: Stencil, d_inv, iters: int, seed: int = 0):
    """λ_max(D⁻¹A) estimate as a 0-d tensor (1.1 safety factor, as the
    oracle); no host read.  The matvec D⁻¹·A·x adds its products in the JAX
    package's CPU order (``ops/ordered_stencil.py``: one
    ``ordered_stencil_matvec`` launch an iteration on the card, the centre
    unfused on the rows ``_unfused_centre`` gives) and the norm's sum is
    ``ordered_sum.sumsq``, so a float32 λ is the JAX package's bit for bit
    (other types take torch's order); the solve path's ``Stencil.matvec``
    keeps torch's order."""
    x = start_vector(A.dims, A.weights.dtype, A.weights.device, seed)
    ordered = A.weights.dtype == torch.float32
    if ordered:
        plan = power_plan(A, d_inv)
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        if ordered:
            y = ordered_stencil.matvec(plan, [x.reshape(plan.slab)])[0].reshape(A.dims)
            nrm = ordered_sum.norm(y, structured=True, points=A.n_points)
        else:
            y = d_inv * A.matvec(x)
            nrm = torch.linalg.norm(y)
        lam = torch.where(nrm > 0, nrm, lam)
        x = y / torch.clamp(nrm, min=1e-30)
    return 1.1 * lam


# 1/√c for c = 1 ... 64 as the JAX package's CPU backend computes
# ``1.0 / jnp.sqrt(jnp.maximum(counts, 1.0))`` (float32 bits): not the
# correctly rounded value at c = 39, 42, 53, 58, 61, and not torch's float32
# 1/sqrt at others.  Read with jax and jaxlib 0.9.0 on an x86-64 CPU with
# AVX-512 (scripts/probe_xla_galerkin_order.py --rsqrt).
_XLA_RSQRT_BITS = (
    0x3f800000, 0x3f3504f3, 0x3f13cd3a, 0x3f000000, 0x3ee4f92e, 0x3ed105ec,
    0x3ec1848f, 0x3eb504f3, 0x3eaaaaab, 0x3ea1e89b, 0x3e9a5fb2, 0x3e93cd3a,
    0x3e8e00d5, 0x3e88d677, 0x3e8432a5, 0x3e800000, 0x3e785b42, 0x3e715bef,
    0x3e6aebf5, 0x3e64f92e, 0x3e5f7483, 0x3e5a514a, 0x3e5584cd, 0x3e5105ec,
    0x3e4ccccd, 0x3e48d2ab, 0x3e4511a3, 0x3e41848f, 0x3e3e26eb, 0x3e3af4ba,
    0x3e37ea74, 0x3e3504f3, 0x3e32416a, 0x3e2f9d53, 0x3e2d166c, 0x3e2aaaab,
    0x3e285835, 0x3e261d5f, 0x3e23f8a3, 0x3e21e89b, 0x3e1fec04, 0x3e1e01b2,
    0x3e1c2896, 0x3e1a5fb2, 0x3e18a61f, 0x3e16fb06, 0x3e155da2, 0x3e13cd3a,
    0x3e124925, 0x3e10d0c3, 0x3e0f6381, 0x3e0e00d5, 0x3e0ca840, 0x3e0b5948,
    0x3e0a137d, 0x3e08d677, 0x3e07a1d2, 0x3e067531, 0x3e05503e, 0x3e0432a5,
    0x3e031c19, 0x3e020c52, 0x3e01030a, 0x3e000000)


@functools.cache
def _rsqrt_table(device):
    return torch.tensor(_XLA_RSQRT_BITS, dtype=torch.int32).view(
        torch.float32).to(device)


def block_scale(counts):
    """The tentative prolongator's normalisation 1/√max(count, 1) of float32
    block counts, as the JAX package computes it: XLA's values for the
    integer counts a block of up to 4 per axis in 3-D holds (the table
    above), looked up on the counts' device; any other count takes
    1/√c in float64, rounded once."""
    c = torch.clamp(counts, min=1.0)
    if counts.dtype != torch.float32:
        return 1.0 / torch.sqrt(c)
    table = _rsqrt_table(counts.device)
    idx = c.to(torch.int64)
    exact = (idx.to(c.dtype) == c) & (idx <= len(_XLA_RSQRT_BITS))
    other = (1.0 / torch.sqrt(c.double())).to(c.dtype)
    return torch.where(exact, table[(idx.clamp(max=len(_XLA_RSQRT_BITS)) - 1)],
                       other)


def eager_block_scale(counts):
    """1/√max(count, 1) of float32 counts as the JAX package's distributed
    setup computes it (``parallel_amg_tpu/parallel/pdevice_setup.py``,
    eager, not jitted): the square root correctly rounded, then 1 over it
    correctly rounded.  Taken in float64 and rounded once (exact for a
    square root and a quotient of float32 values), so the same on every
    device; it differs from ``block_scale`` at c = 6, 7, 17, 18, 21, 24, 28,
    34, 42, 53 and 55."""
    c = torch.clamp(counts, min=1.0)
    root = torch.sqrt(c.double()).float()
    return (1.0 / root.double()).float()


def power_plan(A: Stencil, d_inv) -> ordered_stencil.Plan:
    """The plan of the power iteration's matvec D⁻¹·A·x on one device, the
    centre unfused on the rows ``_unfused_centre`` gives; a 2-D grid's on
    its (1, n0, n1) view (``ordered_stencil.plan_2d``), whose slab the
    matvec takes x in."""
    if len(A.dims) == 2:
        A3 = Stencil(A.weights[:, None], tuple((0,) + tuple(o) for o in A.offsets),
                     (1,) + tuple(A.dims))
        return ordered_stencil.Plan.one_device(
            A3, d_inv[None], *ordered_stencil.plan_2d(A.offsets, A.dims))
    return ordered_stencil.Plan.one_device(A, d_inv, *_unfused_centre(A))


def _unfused_centre(A: Stencil):
    """(split, rows) of the power iteration's matvec on A, one device:
    where XLA's CPU code for it is LLVM's loop vectorised across the middle
    axis of a 7-point 3-D grid with 5 ≤ n2 ≤ 8, the centre's position in
    the chain and the rows i1 < rows on which its product is added rounded,
    not fused (``ordered_stencil.unfused_centre``); (None, 0) for one fma
    chain."""
    return ordered_stencil.unfused_centre(A.offsets, A.dims, sharded=False)


def diag_inverse(A):
    """1/diag(A), 0 where the diagonal is 0."""
    diag = A.diagonal()
    return torch.where(diag != 0, 1.0 / diag, 0.0)


def _identity(A: Stencil) -> Stencil:
    return Stencil(torch.ones((1,) + A.dims, dtype=A.weights.dtype,
                              device=A.weights.device),
                   (tuple(0 for _ in A.dims),), A.dims)


def _with_centre(A: Stencil, planes, a, b) -> Stencil:
    """I + the stencil ``planes`` on A's offsets, whose centre plane is
    fma(a, b, 1): the JAX package's contracted 1 + a·b, when the planes are
    float32 and A has a centre and sorted offsets (as every setup operator
    does); otherwise the plain ``Stencil.add``."""
    zero = tuple(0 for _ in A.dims)
    if (planes.dtype != torch.float32 or zero not in A.offsets
            or A.offsets != tuple(sorted(A.offsets))):
        return _identity(A).add(Stencil(planes, A.offsets, A.dims))
    planes[A.offsets.index(zero)] = ordered_sum.fma(
        a, b, torch.ones((), dtype=planes.dtype, device=planes.device))
    return Stencil(planes, A.offsets, A.dims)


def smoothing_operator(A: Stencil, d_inv, coef) -> Stencil:
    """S = I − coef·D⁻¹A as a stencil (the prolongator smoother).

    In the JAX package's CPU order: m = (−coef)·D⁻¹ rounded, each plane m·w
    rounded, and the centre plane 1 + m·w₀ contracted into one fused
    multiply-add (``ordered_sum.fma``), float32 (other types take torch's
    order, one rounding per operation)."""
    coef = torch.as_tensor(coef, dtype=A.weights.dtype, device=A.weights.device)
    m = -coef * d_inv
    return _with_centre(A, m[None] * A.weights, m, A.diagonal())


def smoothing_operator_T(A: Stencil, d_inv, coef) -> Stencil:
    """Sᵀ = I − coef·A·D⁻¹ (A symmetric) — the restriction-side factor.

    Each plane −coef·(w·D⁻¹ shifted), products rounded left to right, the
    centre 1 + (−coef)·(w₀·D⁻¹) one fused multiply-add in float32, as the
    JAX package's CPU backend computes it."""
    SA = A.scale_cols(d_inv)
    neg = -torch.as_tensor(coef, dtype=A.weights.dtype, device=A.weights.device)
    return _with_centre(A, neg * SA.weights, neg, SA.diagonal())


def galerkin_out_offsets(offsets, block: int):
    """Coarse offset set of Tᵀ M T given M's fine offsets."""
    nd = len(offsets[0])
    return sorted({
        tuple((rp[i] + o[i]) // block for i in range(nd))
        for o in offsets
        for rp in itertools.product(range(block), repeat=nd)
    })


def _normalize(planes, out_offs, cdims, scale, halo0: int = 0):
    """Tentative normalization: row scale times offset-shifted column scale.

    ``scale`` may carry ``halo0`` extra rows on both ends of axis 0 (the slab
    path): the shifts then read those rows, and the result is cropped to the
    cdims[0] rows of the slab.
    """
    rows = slice(halo0, halo0 + cdims[0])
    col_scales = torch.stack([shift_nd(scale, o, scale.shape)[rows]
                              for o in out_offs])
    return planes * scale[rows][None] * col_scales


# The k-blocked dot's budget: a column tile of w columns takes k-blocks of
# ⌊DOT_BUDGET / w⌋ terms (see ``_dot_order``).
DOT_BUDGET = 32768
# The k-block of a full column tile by n_out, for the n_out that were read,
# as (K below which, k-block): the first entry whose bound exceeds K applies,
# else the last k-block.
_DOT_KC = {9: ((32, 8), (64, 16), (126, 32), (248, 64), (None, 128)),
           27: ((63, 16), (121, 32), (228, 64), (None, 128))}
# n_out ≥ 64 was read at K 343: four lanes at nc 3,375, one chain at 200,000.
_DOT_LANES_NC = 3375


def _dot_order(n_out: int, K: int, nc: int):
    """The order of the JAX package's one-hot dot ``onehot (n_out, K) @ piece
    (K, nc)`` on its CPU backend: ``("lanes", None)``, ``("blocks", (tile,
    kc))`` or ``("chain", None)``.

    Read off XLA's CPU dot (jaxlib 0.9.0, an 8-core x86-64 CPU with AVX-512)
    by revealing the tree of each output's sum: a pair of ±2⁴⁰ among ones
    gives the size of their lowest common subtree
    (``scripts/probe_xla_galerkin_order.py --dot`` re-reads it, checks this
    rule at every shape the setups meet and warns at an n_out not read).

    - "lanes": with nc of 2 to 16 columns and K > 16, or with n_out ≥ 64 and
      nc ≤ 3,375 (read at K 343, nc 3,375), four accumulators, k mod 4, over
      the first ⌊K/4⌋·4 terms, added as (0 + 1) + (2 + 3), then the rest,
      summed as a chain of their own, last.
    - "blocks", for n_out 9 and 27: the columns are cut into tiles of
      ``tile`` from column 0 (the last tile may be narrower); a tile of w
      columns sums k in blocks of kc_w = ⌊32768 / w⌋ terms from k = 0, each
      block one chain from +0.0, and the block sums are chained in k order
      (one chain where kc_w ≥ K).  A full tile's kc = 32768 / tile grows
      with K (``_DOT_KC``: read for K 17 to 344 at nc 8,192, 12,345 and
      20,000).  So config #3's level 1 → 2 dot, (27, 251, 3375), adds k in
      blocks of 128 over columns 0–3327 and in one chain over the 47
      columns after them.
    - "chain": one chain in k order; read for n_out ≥ 64 at (125, 343,
      200,000).  Any other n_out takes it too, not read (ROADMAP C7c): the
      setups of the repo meet n_out 27 only, and where K ≤ 16 every order
      above is this chain.
    """
    if 2 <= nc <= 16 and K > 16:
        return "lanes", None
    if n_out in _DOT_KC:
        kc = next(k for bound, k in _DOT_KC[n_out] if bound is None or K < bound)
        return "blocks", (DOT_BUDGET // kc, kc)
    if n_out >= 64 and nc <= _DOT_LANES_NC:
        return "lanes", None
    return "chain", None


def _onehot_dot(ids, piece, n_out: int, order):
    """Σ_k onehot[o, k]·piece[k] for onehot[o, k] = (ids[k] == o), in the
    order ``order`` of ``_dot_order``: exact adds (``bucket_add``), so the
    bits are the same on every device.  The k-blocks of a column group are
    summed in one ``bucket_add`` (block b's terms into rows b·n_out + o),
    then chained in k order."""
    kind, plan = order
    K = len(ids)
    out = torch.zeros((n_out,) + tuple(piece.shape[1:]), dtype=piece.dtype,
                      device=piece.device)
    if kind == "chain":
        return bucket_add(out, ids, piece)
    if kind == "lanes":
        main = K // 4 * 4
        acc = [bucket_add(torch.zeros_like(out), ids[q:main:4], piece[q:main:4])
               for q in range(4)]
        out = (acc[0] + acc[1]) + (acc[2] + acc[3])
        if main < K:
            out = out + bucket_add(torch.zeros_like(out), ids[main:], piece[main:])
        return out
    tile, _ = plan
    nc = piece.shape[1]
    full = nc // tile * tile
    for lo, hi, w in ((0, full, tile), (full, nc, nc - full)):
        if lo == hi:
            continue
        kc = DOT_BUDGET // w
        nb = -(-K // kc)
        blocks = torch.zeros((nb * n_out, hi - lo), dtype=piece.dtype, device=piece.device)
        bucket_add(blocks, [k // kc * n_out + o for k, o in enumerate(ids)],
                   piece[:, lo:hi])
        acc = blocks[:n_out]
        for b in range(1, nb):
            acc = acc + blocks[b * n_out:(b + 1) * n_out]
        out[:, lo:hi] = acc
    return out


def galerkin_block(M: Stencil, cdims, block: int, scale,
                   scale_halo0: int = 0) -> Stencil:
    """A_c = Tᵀ M T for normalized block-injection T (scale = 1/√|agg|).

    Residue-class pooled reduction: per block residue rp one strided slice
    takes all D planes, and each fine offset o lands in the coarse offset
    floor((rp+o)/b) per axis; the residues' sums are added in residue order.
    The JAX package sums each residue by a one-hot dot, whose order
    ``_dot_order`` gives; the port adds the same terms in that order
    (``_onehot_dot``).

    scale_halo0 > 0 means ``scale`` already carries that many halo rows on
    both ends of axis 0 (the slab path: coarse columns just outside the slab
    have their real normalization, not the zero a local pad would give).
    """
    nd = len(M.dims)
    b = block
    D = M.n_points
    fpad = tuple(cdims[i] * b for i in range(nd))
    Wp = torch.nn.functional.pad(M.weights, [
        p for i in reversed(range(nd)) for p in (0, fpad[i] - M.dims[i])])
    out_offs = galerkin_out_offsets(M.offsets, b)
    oidx = {o: i for i, o in enumerate(out_offs)}
    nc = int(np.prod(cdims))
    acc = torch.zeros((len(out_offs), nc), dtype=M.weights.dtype,
                      device=M.weights.device)
    order = _dot_order(len(out_offs), D, nc)
    for rp in itertools.product(range(b), repeat=nd):
        piece = Wp[(slice(None),) + tuple(slice(rp[i], fpad[i], b)
                                          for i in range(nd))].reshape(D, nc)
        ids = [oidx[tuple((rp[i] + o[i]) // b for i in range(nd))]
               for o in M.offsets]
        acc = acc + _onehot_dot(ids, piece, len(out_offs), order)
    planes = acc.reshape((len(out_offs),) + tuple(cdims))
    r0 = max(abs(o[0]) for o in out_offs)
    if scale_halo0 and scale_halo0 < r0:
        raise ValueError(f"slab scale halo {scale_halo0} < coarse reach {r0}")
    return Stencil(_normalize(planes, out_offs, tuple(cdims), scale,
                              scale_halo0), tuple(out_offs), cdims)


def _slab_coarse_operator(W_ext, d_ext, scale_ext, coef, ca, *, offsets,
                          dims_slab, cdims_slab, block, halo, rc, it,
                          mask=None):
    """One axis-0 slab of the Galerkin triple product.

    W_ext/d_ext are the fine operator and its diagonal inverse padded by
    ``halo`` rows on both ends of axis 0 (and to a whole number of slabs);
    scale_ext is the coarse normalization padded by ``rc`` rows on both
    ends.  Returns the slab's coarse planes, exact because every shift that
    could reach a slab edge stays inside the halo (halo = 2·reach of
    sym(Sᵀ A S)).

    ``mask`` (optional, in slab coordinates, broadcastable to
    ``dims_slab``) zeroes the rows of M = sym(Sᵀ A S) that belong to axis-0
    padding of a sharded grid before the pooled reduction, so the tentative
    prolongator aggregates true fine cells only.  Padding rows carry an
    identity diagonal and do not couple to true rows, so masking rows alone
    gives the masked Tᵀ·M·T exactly.
    """
    b = block
    fa = ca * b  # the slab's first fine row in padded coordinates
    rows = slice(fa, fa + dims_slab[0])
    A_s = Stencil(W_ext[:, rows], offsets, dims_slab)
    ds = d_ext[rows]
    S = smoothing_operator(A_s, ds, coef)
    St = smoothing_operator_T(A_s, ds, coef)
    AS = sparsify_stencil(A_s.matmul(S), it)
    del S
    M = symmetrize_stencil(sparsify_stencil(St.matmul(AS), it))
    del St, AS
    if mask is not None:  # in place: M's planes are this call's own
        M.weights.mul_(mask[None])
    # crop the halo: the reduction reads only fine rows [halo, halo + cc·b),
    # which are exact
    inner = (cdims_slab[0] * b,) + tuple(dims_slab[1:])
    Mc = Stencil(M.weights[:, halo:halo + inner[0]], M.offsets, inner)
    ssl = scale_ext[ca:ca + cdims_slab[0] + 2 * rc]
    return galerkin_block(Mc, cdims_slab, b, ssl, scale_halo0=rc)


def slab_plan(offsets, dims, cdims, block: int, budget_bytes: int) -> dict:
    """Slab sizes of ``chunked_coarse_operator`` (the JAX package's rule):
    halo = 2·axis-0 reach of sym(Sᵀ A S), rc = the coarse reach, and cc
    coarse rows per slab such that the n_M planes of one slab, cc·b + 2·halo
    fine rows, fit the budget in float32."""
    sym_offs = product_offsets(offsets, len(dims))
    halo = 2 * max(abs(o[0]) for o in sym_offs)
    rc = max(abs(o[0]) for o in galerkin_out_offsets(sym_offs, block))
    row_bytes = int(np.prod(dims[1:])) * 4 * len(sym_offs)
    cc = max(1, (budget_bytes // row_bytes - 2 * halo) // block)
    cc = min(cc, cdims[0])
    return {"halo": halo, "rc": rc, "cc": cc, "n_slabs": -(-cdims[0] // cc),
            "planes": len(sym_offs),
            "slab_rows": cc * block + 2 * halo}


def chunked_coarse_operator(A: Stencil, d_inv, coef, cdims, block: int,
                            scale, it: float, budget_bytes: int) -> Stencil:
    """A_c = Tᵀ Sᵀ A S T computed in axis-0 slabs.

    The unchunked path holds the ~D_M-plane intermediate Sᵀ(A S) on the whole
    fine grid; slabbing along axis 0 bounds it to one slab and its halo at a
    time, and gives the dense path's coarse operator (each slab's halo
    covers every shift any stage applies).  Slabs of ``cc`` coarse rows are
    sized so that n_M planes on cc·b + 2·halo fine rows fit the budget; the
    last slab is padded and the result cropped to cdims[0].
    """
    nd = len(A.dims)
    b = block
    plan = slab_plan(A.offsets, A.dims, cdims, b, budget_bytes)
    halo, rc, cc, n_slabs = (plan[k] for k in ("halo", "rc", "cc", "n_slabs"))
    f0_pad = n_slabs * cc * b
    rest = [0, 0] * (nd - 1)
    W_ext = torch.nn.functional.pad(
        A.weights, rest + [halo, halo + f0_pad - A.dims[0]])
    d_ext = torch.nn.functional.pad(
        d_inv, rest + [halo, halo + f0_pad - A.dims[0]])
    scale_ext = torch.nn.functional.pad(
        scale, rest + [rc, rc + n_slabs * cc - cdims[0]])
    dims_slab = (cc * b + 2 * halo,) + tuple(A.dims[1:])
    cdims_slab = (cc,) + tuple(cdims[1:])
    parts = [_slab_coarse_operator(
        W_ext, d_ext, scale_ext, coef, i * cc, offsets=A.offsets,
        dims_slab=dims_slab, cdims_slab=cdims_slab, block=b, halo=halo, rc=rc,
        it=it) for i in range(n_slabs)]
    del W_ext, d_ext
    planes = torch.cat([p.weights for p in parts], dim=1)[:, :cdims[0]]
    return Stencil(planes, parts[0].offsets, tuple(cdims))


def product_offsets(offsets, nd: int):
    """Fine offset set of sym(Sᵀ(A S)) given A's offsets."""
    s_offs = sorted(set(offsets) | {tuple(0 for _ in range(nd))})
    as_offs = sorted({tuple(a[i] + s[i] for i in range(nd))
                      for a in offsets for s in s_offs})
    m_offs = sorted({tuple(a[i] + s[i] for i in range(nd))
                     for a in s_offs for s in as_offs})
    return sorted(set(m_offs) | {tuple(-c for c in o) for o in m_offs})


def triple_product_offsets(A: Stencil):
    """Fine offset set of sym(Sᵀ(A S)) — sizes the dense path."""
    return product_offsets(A.offsets, len(A.dims))


# The JAX package caps the dense path's intermediates here (XLA's
# memory-pressure layouts); the port keeps the same rule so both packages
# pick the same path at every level.
_DENSE_SAFE_BYTES = 256 * 2**20


def select_product_path(A: Stencil, config) -> str:
    """Resolve setup_product_path="auto" by estimated intermediate bytes."""
    if config.setup_product_path != "auto":
        return config.setup_product_path
    budget = config.setup_chunk_budget_mb * 2**20
    bpe = A.weights.element_size()
    dense_bytes = 2 * len(triple_product_offsets(A)) * A.n * bpe
    if dense_bytes <= min(budget, _DENSE_SAFE_BYTES):
        return "dense"
    nd = len(A.dims)
    rA = tuple(max(abs(o[i]) for o in A.offsets) for i in range(nd))
    box3 = _cum_box(tuple(3 * r for r in rA), config.block_size)
    n_planes = int(np.prod([h - l + 1 for l, h in box3]))
    if 3 * n_planes * A.n * bpe <= budget:
        return "bucketed"
    return "slab"


# ---------------------------------------------------------------------------
# Bucketed ("transfer-first") exact Galerkin — A_c = Tᵀ Sᵀ A S T where every
# intermediate is indexed by COARSE offset O rather than fine offset, so the
# plane count stays at the final operator's (3^d at b=3).
#
# Representation: X[O](p) = value the fine row p contributes toward coarse
# column B(p)+O, stored as box_shape + dims whose leading nd axes index O
# within a per-axis offset box.
# ---------------------------------------------------------------------------


def _cum_box(reach, b: int):
    """Coarse-offset range per axis after a total fine shift ≤ reach:
    O = (r + shift)//b with r ∈ [0,b), |shift| ≤ reach."""
    return tuple((-(reach[i]) // b if reach[i] else 0,
                  (b - 1 + reach[i]) // b) for i in range(len(reach)))


def _window_sum(N, cdims, b: int, lead: int):
    """Tᵀ's sum pool of the trailing grid axes of N to cdims: each block of
    bᵈ fine rows (zero-padded to whole blocks) added to +0.0 one element
    after another, in XLA's order for the JAX package's padded
    ``reduce_window``: row-major, except that where an axis after the first
    is padded by exactly one row (the last such axis), the window positions
    below b − 1 on it come first and those at b − 1 after them (read through
    the JAX function by revealing its sum trees, every padding at b = 3 in
    2-D and 3-D).  Exact adds, so the same bits on every device."""
    nd = len(cdims)
    pad = [cdims[i] * b - N.shape[lead + i] for i in range(nd)]
    flat = []
    for i in reversed(range(nd)):
        flat += [0, pad[i]]
    Np = torch.nn.functional.pad(N, flat)
    split = max((i for i in range(1, nd) if pad[i] == 1), default=None)
    order = list(itertools.product(range(b), repeat=nd))
    if split is not None:
        order = ([r for r in order if r[split] < b - 1]
                 + [r for r in order if r[split] == b - 1])
    acc = torch.zeros(tuple(N.shape[:lead]) + tuple(cdims), dtype=N.dtype,
                      device=N.device)
    for r in order:
        acc = acc + Np[(slice(None),) * lead + tuple(slice(r[i], None, b)
                                                      for i in range(nd))]
    return acc


def bucket_stage_factors(A: Stencil, d_inv, coef, b: int):
    """The bucketed product's three stages (S·T seed, A·, Sᵀ·): their
    (K, *dims) factor planes and the four coarse-offset boxes (the seed's
    single box, then after each stage).  S's planes are m·w with m =
    (−coef)·D⁻¹, Sᵀ's (−coef·w)·D⁻¹ shifted, each centre 1 + a·b one fused
    multiply-add in float32, XLA's CPU order (other types a rounded add)."""
    nd = len(A.dims)
    dims = A.dims
    rA = tuple(max(abs(o[i]) for o in A.offsets) for i in range(nd))
    zero = tuple(0 for _ in range(nd))
    boxes = [tuple((0, 0) for _ in range(nd))] + [
        _cum_box(tuple(k * r for r in rA), b) for k in (1, 2, 3)]
    d_idx = A.offsets.index(zero)
    coef = torch.as_tensor(coef, dtype=A.weights.dtype, device=A.weights.device)
    m = -coef * d_inv
    s_planes = m * A.weights
    st_planes = torch.stack([(-coef * A.weights[d]) * shift_nd(d_inv, A.offsets[d], dims)
                             for d in range(A.n_points)])
    if A.weights.dtype == torch.float32:
        one = torch.ones((), dtype=A.weights.dtype, device=A.weights.device)
        s_planes[d_idx] = ordered_sum.fma(m, A.weights[d_idx], one)
        st_planes[d_idx] = ordered_sum.fma(-coef * A.weights[d_idx], d_inv, one)
    else:
        s_planes[d_idx] = s_planes[d_idx] + 1.0
        st_planes[d_idx] = st_planes[d_idx] + 1.0
    return [s_planes, A.weights, st_planes], boxes


def bucketed_coarse_operator(A: Stencil, d_inv, coef, cdims, block: int,
                             scale) -> Stencil:
    """Exact A_c = Tᵀ Sᵀ A S T with coarse-offset-bucketed intermediates.

    Three bucket stages (S·T seed, A·, Sᵀ·) each keep box_shape·n values,
    27·n at b=3 whatever the fine stencil's width, then one sum-pool reduces
    rows to the coarse grid.  No intermediate sparsification: the result is
    the exact Galerkin operator of the smoothed transfers.  The stages are
    ``bucket_stage.stage``: one ``ordered_bucket_stage`` launch each for a
    float32 grid of one to three axes on the card (a grid of more axes
    raises there), the plain version on the CPU and for other types, in the
    JAX package's order for this grid (``bucket_stage.product_orders``: a
    stage whose successor reads an ``alt`` X hands it on).
    """
    nd = len(A.dims)
    b = block
    dims = A.dims
    factors, boxes = bucket_stage_factors(A, d_inv, coef, b)
    orders = bucket_stage.product_orders(A.offsets, dims, b)
    X = torch.ones((1,) * nd + tuple(dims), dtype=A.weights.dtype,
                   device=A.weights.device)
    X_alt = None
    for s, (F, box_in, box_out) in enumerate(zip(factors, boxes, boxes[1:])):
        alt_out = s < 2 and bool(orders[s + 1].alt)
        X = bucket_stage.stage(F, A.offsets, X, box_in, box_out, b, dims, orders[s],
                               X_alt, alt_out)
        X, X_alt = X if alt_out else (X, None)
    pool = _window_sum(X, cdims, b, nd)
    out_offs = sorted(itertools.product(*[range(lo, hi + 1) for lo, hi in boxes[3]]))
    planes = pool.reshape((len(out_offs),) + tuple(cdims))
    return Stencil(_normalize(planes, out_offs, tuple(cdims), scale),
                   tuple(out_offs), tuple(cdims))


def symmetrize_stencil(A: Stencil) -> Stencil:
    """(A + Aᵀ)/2 for a stencil with a symmetric offset set.

    Row-based drop rules (sparsify) can break symmetry by float32 amounts;
    Aᵀ plane: Aᵀ[p, p+o] = A[p+o, p] = w₋ₒ(p+o)."""
    offs = sorted(set(A.offsets) | {tuple(-c for c in o) for o in A.offsets})
    planes = []
    for o in offs:
        w = torch.zeros(A.dims, dtype=A.weights.dtype, device=A.weights.device)
        if o in A.offsets:
            w = w + A.weights[A.offsets.index(o)]
        no = tuple(-c for c in o)
        if no in A.offsets:
            w = w + shift_nd(A.weights[A.offsets.index(no)], o, A.dims)
        planes.append(0.5 * w)
    return Stencil(torch.stack(planes), tuple(offs), A.dims)


def sparsify_stencil(A: Stencil, tol: float) -> Stencil:
    """Drop |w| < tol·rowmax off-diagonal entries, lump them onto the
    diagonal (device analog of oracle.sparsify_lumped).  The lump is the sum
    over the offset axis in XLA's order (``ordered_sum.planes_sum``), so a
    float32 result is the JAX package's bit for bit."""
    if tol <= 0:
        return A
    nd = len(A.dims)
    d_idx = A.offsets.index(tuple(0 for _ in A.dims))
    offd = torch.ones(A.n_points, dtype=torch.bool, device=A.weights.device)
    offd[d_idx] = False
    offd = offd.reshape((-1,) + (1,) * nd)
    absw = A.weights.abs()
    rowmax = torch.where(offd, absw, 0.0).amax(dim=0)
    drop = (absw < tol * rowmax[None]) & offd
    dropped = torch.where(drop, A.weights, 0.0)
    lump = (ordered_sum.planes_sum(dropped)
            if dropped.dtype == torch.float32 else dropped.sum(dim=0))
    del dropped
    W = torch.where(drop, 0.0, A.weights)
    W[d_idx] += lump
    return Stencil(W, A.offsets, A.dims)


def zero_plane_keep_mask(weights, offsets, nd: int):
    """Host bool mask of offset planes to keep (diagonal always kept): one
    small host read of a norm-per-plane vector."""
    norms = weights.abs().sum(dim=tuple(range(1, 1 + nd))).cpu().numpy()
    keep = norms > 0
    keep[offsets.index(tuple(0 for _ in range(nd)))] = True
    return keep


def _prune_zero_planes(A: Stencil) -> Stencil:
    """Drop all-zero offset planes."""
    keep = zero_plane_keep_mask(A.weights, A.offsets, len(A.dims))
    if keep.all():
        return A
    return A.prune(keep.tolist())


def coarse_operator(A: Stencil, d_inv, coef, cdims, config: AMGConfig,
                    scale) -> Stencil:
    """The Galerkin product of one level by the path ``select_product_path``
    picks, before the coarse-level sparsification."""
    b = config.block_size
    path = select_product_path(A, config)
    it = config.setup_intermediate_tol
    if path == "bucketed":
        return bucketed_coarse_operator(A, d_inv, coef, cdims, b, scale)
    if path == "slab":
        return chunked_coarse_operator(A, d_inv, coef, cdims, b, scale, it,
                                       config.setup_chunk_budget_mb * 2**20)
    S = smoothing_operator(A, d_inv, coef)
    St = smoothing_operator_T(A, d_inv, coef)
    AS = _prune_zero_planes(sparsify_stencil(A.matmul(S), it))
    del S
    M = _prune_zero_planes(symmetrize_stencil(sparsify_stencil(St.matmul(AS), it)))
    return galerkin_block(M, cdims, b, scale)


def device_structured_setup(A: Stencil, config: AMGConfig,
                            dtype=torch.float32, seed: int = 0) -> Hierarchy:
    """Block-SA setup from a fine-level Stencil, on the Stencil's device.

    The host loop decides shapes and prunes zero planes (one small read per
    level, plus λ_max, which the Chebyshev smoother takes as a host float).
    ``setup_stats["product_paths"]`` names each level's product path.
    """
    if not (config.coarsening == "sa" and config.aggregate == "block"):
        raise ValueError("device_structured_setup implements the structured "
                         "block-SA path; use host_setup for the algebraic "
                         "configurations")
    b = config.block_size
    A = Stencil(A.weights.to(dtype), A.offsets, A.dims)
    dev = A.weights.device
    levels: List[Level] = []
    paths: List[str] = []
    for lvl in range(config.max_levels):
        d_inv = diag_inverse(A)
        lam = power_iteration_lambda_max(A, d_inv, config.lambda_power_iters,
                                         seed=seed)
        if A.n <= config.n_coarse_max or lvl == config.max_levels - 1:
            levels.append(Level(A, None, None, d_inv, float(lam)))
            break
        dims = A.dims
        cdims = tuple(-(-d // b) for d in dims)
        counts = downsample_sum_nd(torch.ones(dims, dtype=dtype, device=dev),
                                   cdims, b)
        scale = block_scale(counts)
        coef = torch.full_like(lam, config.sa_omega) / torch.clamp(lam, min=1e-30)
        paths.append(select_product_path(A, config))
        A_c = coarse_operator(A, d_inv, coef, cdims, config, scale)
        A_c = _prune_zero_planes(symmetrize_stencil(
            sparsify_stencil(A_c, config.coarse_drop_tol)))
        # linked transfers: borrow the level's A and d_inv at apply time
        P = BlockProlongator(None, None, scale, float(coef), dims, cdims, b)
        R = BlockRestrictor(None, None, scale, float(coef), dims, cdims, b)
        levels.append(Level(A, P, R, d_inv, float(lam)))
        A = A_c
    # dense coarse solve operator (tiny, through the host); the eigh
    # pseudo-inverse survives a slightly indefinite coarsest operator
    coarse_inv = torch.from_numpy(coarse_inverse_np(
        np.asarray(levels[-1].A.to_csr().to_dense(), np.float64))).to(
            torch.float32).to(dev)
    h = Hierarchy(levels, coarse_inv, config)
    h.setup_stats = {"product_paths": paths}
    return h
