"""On-device AMG setup — the structured block-SA path.

Counterpart of ``parallel_amg_tpu/amg/device_setup.py``.  On regular grids
the whole setup reduces to stencil algebra on device tensors:

- tentative aggregation: block partition; its only data is the aggregate
  size normalization, a sum-pool of a ones field;
- prolongator smoothing S = I − (ω/λ)D⁻¹A: plane scaling plus identity;
- Galerkin product A_c = Tᵀ (Sᵀ A S) T, by one of two product paths:
  "dense" (two closed-form stencil products, then a residue-class pooled
  reduction) or "bucketed" (intermediates indexed by coarse offset, so the
  plane count stays at 3^d);
- λ_max(D⁻¹A): device power iteration;
- sparsification with diagonal lumping, then pruning of all-zero planes (one
  small host read per level).

The host decides shapes only; every O(n) operation runs on the tensors'
device.  The JAX package's third product path, "slab" (the dense pipeline
in axis-0 slabs, for grids whose intermediates exceed the chunk budget), is
not ported: choosing it raises ``NotImplementedError``.
"""

from __future__ import annotations

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
from parallel_amg_tpu_torch.ops.stencil import Stencil, bucket_add, shift_nd


def start_vector(dims, dtype, device, seed: int = 0):
    """Start of the power iteration: uniform in [−0.5, 0.5) from a seeded
    CPU generator, so the CPU and the card start from the same vector."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(dims, generator=g, dtype=dtype) - 0.5).to(device)


def power_iteration_lambda_max(A: Stencil, d_inv, iters: int, seed: int = 0):
    """λ_max(D⁻¹A) estimate as a 0-d tensor (1.1 safety factor, as the
    oracle); no host read."""
    x = start_vector(A.dims, A.weights.dtype, A.weights.device, seed)
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        y = d_inv * A.matvec(x)
        nrm = torch.linalg.norm(y)
        lam = torch.where(nrm > 0, nrm, lam)
        x = y / torch.clamp(nrm, min=1e-30)
    return 1.1 * lam


def diag_inverse(A):
    """1/diag(A), 0 where the diagonal is 0."""
    diag = A.diagonal()
    return torch.where(diag != 0, 1.0 / diag, 0.0)


def _identity(A: Stencil) -> Stencil:
    return Stencil(torch.ones((1,) + A.dims, dtype=A.weights.dtype,
                              device=A.weights.device),
                   (tuple(0 for _ in A.dims),), A.dims)


def smoothing_operator(A: Stencil, d_inv, coef) -> Stencil:
    """S = I − coef·D⁻¹A as a stencil (the prolongator smoother)."""
    S = Stencil(-coef * d_inv[None] * A.weights, A.offsets, A.dims)
    return _identity(A).add(S)


def smoothing_operator_T(A: Stencil, d_inv, coef) -> Stencil:
    """Sᵀ = I − coef·A·D⁻¹ (A symmetric) — the restriction-side factor."""
    SA = A.scale_cols(d_inv)
    S = Stencil(-coef * SA.weights, SA.offsets, SA.dims)
    return _identity(A).add(S)


def galerkin_out_offsets(offsets, block: int):
    """Coarse offset set of Tᵀ M T given M's fine offsets."""
    nd = len(offsets[0])
    return sorted({
        tuple((rp[i] + o[i]) // block for i in range(nd))
        for o in offsets
        for rp in itertools.product(range(block), repeat=nd)
    })


def _normalize(planes, out_offs, cdims, scale):
    """Tentative normalization: row scale times offset-shifted column scale."""
    col_scales = torch.stack([shift_nd(scale, o, cdims) for o in out_offs])
    return planes * scale[None] * col_scales


def galerkin_block(M: Stencil, cdims, block: int, scale) -> Stencil:
    """A_c = Tᵀ M T for normalized block-injection T (scale = 1/√|agg|).

    Residue-class pooled reduction: per block residue rp one strided slice
    takes all D planes, and each fine offset o lands in the coarse offset
    floor((rp+o)/b) per axis by ``bucket_add``.
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
    for rp in itertools.product(range(b), repeat=nd):
        piece = Wp[(slice(None),) + tuple(slice(rp[i], fpad[i], b)
                                          for i in range(nd))].reshape(D, nc)
        ids = [oidx[tuple((rp[i] + o[i]) // b for i in range(nd))]
               for o in M.offsets]
        acc = acc + bucket_add(torch.zeros_like(acc), ids, piece)
    planes = acc.reshape((len(out_offs),) + tuple(cdims))
    return Stencil(_normalize(planes, out_offs, tuple(cdims), scale),
                   tuple(out_offs), cdims)


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


def _cum_box(reach, b: int):
    """Coarse-offset range per axis after a total fine shift ≤ reach:
    O = (r + shift)//b with r ∈ [0,b), |shift| ≤ reach."""
    return tuple((-(reach[i]) // b if reach[i] else 0,
                  (b - 1 + reach[i]) // b) for i in range(len(reach)))


def _bucket_stage(factors, offsets, X, box_in, box_out, b: int, dims):
    """Y[O](p) = Σ_off factor_off(p) · X[O − δ_off(p)](p + off).

    Writes landing outside box_out are structurally zero and are dropped by
    the slice intersection.
    """
    nd = len(dims)
    out_shape = tuple(h - l + 1 for l, h in box_out)
    Y = torch.zeros(out_shape + tuple(dims), dtype=X.dtype, device=X.device)
    for off, fac in zip(offsets, factors):
        Xs = shift_nd(X, off, dims)
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
                fm = fac * _residue_mask(dims, off, delta, b, X.dtype, X.device)
                Y[tuple(tgt)] += fm.reshape((1,) * nd + tuple(dims)) * Xs[tuple(src)]
    return Y


def bucketed_coarse_operator(A: Stencil, d_inv, coef, cdims, block: int,
                             scale) -> Stencil:
    """Exact A_c = Tᵀ Sᵀ A S T with coarse-offset-bucketed intermediates.

    Three bucket stages (S·T seed, A·, Sᵀ·) each keep box_shape·n values,
    27·n at b=3 whatever the fine stencil's width, then one sum-pool reduces
    rows to the coarse grid.  No intermediate sparsification: the result is
    the exact Galerkin operator of the smoothed transfers.
    """
    nd = len(A.dims)
    b = block
    dims = A.dims
    rA = tuple(max(abs(o[i]) for o in A.offsets) for i in range(nd))
    zero = tuple(0 for _ in range(nd))
    box0 = tuple((0, 0) for _ in range(nd))
    box1 = _cum_box(rA, b)                                   # after S·T
    box2 = _cum_box(tuple(2 * r for r in rA), b)             # after A·
    box3 = _cum_box(tuple(3 * r for r in rA), b)             # after Sᵀ·

    d_idx = A.offsets.index(zero)
    s_planes = [-coef * d_inv * A.weights[d] for d in range(A.n_points)]
    s_planes[d_idx] = s_planes[d_idx] + 1.0
    st_planes = [-coef * A.weights[d] * shift_nd(d_inv, A.offsets[d], dims)
                 for d in range(A.n_points)]
    st_planes[d_idx] = st_planes[d_idx] + 1.0

    X0 = torch.ones((1,) * nd + tuple(dims), dtype=A.weights.dtype,
                    device=A.weights.device)
    ST = _bucket_stage(s_planes, A.offsets, X0, box0, box1, b, dims)
    AST = _bucket_stage(list(A.weights), A.offsets, ST, box1, box2, b, dims)
    del ST
    N = _bucket_stage(st_planes, A.offsets, AST, box2, box3, b, dims)
    del AST
    pool = downsample_sum_nd(N, cdims, b, lead=nd)
    out_offs = sorted(itertools.product(
        *[range(box3[i][0], box3[i][1] + 1) for i in range(nd)]))
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
    diagonal (device analog of oracle.sparsify_lumped)."""
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
    lump = torch.where(drop, A.weights, 0.0).sum(dim=0)
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
    if path == "bucketed":
        return bucketed_coarse_operator(A, d_inv, coef, cdims, b, scale)
    if path != "dense":
        raise NotImplementedError(
            f"the {path!r} Galerkin product path (the dense product in axis-0 "
            f"slabs, for {A.n} rows of {A.n_points} points over the "
            f"{config.setup_chunk_budget_mb} MB budget) is not ported yet "
            "(ROADMAP A9)")
    it = config.setup_intermediate_tol
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
    """
    if not (config.coarsening == "sa" and config.aggregate == "block"):
        raise ValueError("device_structured_setup implements the structured "
                         "block-SA path; use host_setup for the algebraic "
                         "configurations")
    b = config.block_size
    A = Stencil(A.weights.to(dtype), A.offsets, A.dims)
    dev = A.weights.device
    levels: List[Level] = []
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
        scale = 1.0 / torch.sqrt(torch.clamp(counts, min=1.0))
        coef = torch.full_like(lam, config.sa_omega) / torch.clamp(lam, min=1e-30)
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
    return Hierarchy(levels, coarse_inv, config)
