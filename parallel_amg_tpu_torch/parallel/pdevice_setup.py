"""On-device distributed structured block-SA setup — no host matrix.

Counterpart of ``parallel_amg_tpu/parallel/pdevice_setup.py``, the setup of
the ≥100M-DOF configuration: the fine operator is born on the devices as
sharded stencil planes (``poisson_stencil_sharded``), and every level's
Galerkin triple product runs part by part: each part computes its axis-0
slab of the coarse operator from its weight planes extended by its
neighbors' halo planes (``exchange.halos``, where the JAX package runs two
``ppermute`` exchanges).  No global matrix is ever assembled.

Level layout (as ``parallel/pstructured.py``): axis 0 is padded so every
part owns whole aggregation blocks at every sharded level; padding rows
carry identity diagonals and are masked out of the tentative aggregates, so
they stay exactly zero through the solve.  Once a level is small enough
(``config.agglomerate_n``) or its slab can no longer split evenly, the tiny
operator is gathered on every process (``mesh.home``) and the remaining
levels are built there by the single-device engine (``amg/device_setup.py``)
— the agglomeration of the JAX package, whose tail is replicated on every
chip.

The slab Galerkin kernel is the single-device one
(``device_setup._slab_coarse_operator``, with its padding ``mask``).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import ordered_stencil
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.pgrid import PGrid, ordered_norm
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil, apply_halo_mode
from parallel_amg_tpu_torch.parallel.pstructured import (
    SBlockProlongator,
    SBlockRestrictor,
)


# ---------------------------------------------------------------------------
# halo extension of k planes along an array axis, through the exchange
# ---------------------------------------------------------------------------

def _halos(parts, h: int, axis: int):
    """Per local part its neighbours' h planes along ``axis``
    (``exchange.halos``; None at the grid's ends), or None where h = 0."""
    return exchange.halos(parts, h, axis) if h else [None] * len(parts)


def _halo_concat(x, halos, h: int, axis: int):
    """x extended by its (left, right) ``halos`` on both ends of ``axis``
    (zero planes at the grid's ends)."""
    if h == 0:
        return x
    left, right = halos
    zero = torch.zeros_like(x[(slice(None),) * axis + (slice(0, h),)])
    return torch.cat([zero if left is None else left, x,
                      zero if right is None else right], dim=axis)


_product_offsets = ds.product_offsets


def _local_rows(p: int, m0: int, lo: int, n: int, device):
    """Global axis-0 indices p·m0 + lo + i, i < n."""
    return p * m0 + lo + torch.arange(n, device=device)


# ---------------------------------------------------------------------------
# sharded level step: the Galerkin product, part by part
# ---------------------------------------------------------------------------

def sharded_coarse_operator(A: ShardedStencil, d_inv: PGrid, coef, scale: PGrid,
                            cdims, block: int, it: float,
                            true_d0: int) -> ShardedStencil:
    """A_c = Tmᵀ sym(Sᵀ A S) Tm with Tm = block injection masked to the
    true axis-0 extent; each part produces its own coarse slab."""
    mesh = A.mesh
    nd = len(A.dims)
    b = block
    m0 = A.m0
    sym_offs = _product_offsets(A.offsets, nd)
    halo = 2 * max(abs(o[0]) for o in sym_offs)
    out_offs = ds.galerkin_out_offsets(sym_offs, b)
    rc = max(abs(o[0]) for o in out_offs)
    if m0 % b:
        raise ValueError(f"part slab ({m0} planes) must hold whole blocks of {b}")
    if halo > m0 or rc > m0 // b:
        raise ValueError(f"setup halo ({halo} planes) exceeds the part slab "
                         f"({m0} planes); agglomerate earlier (raise "
                         "config.agglomerate_n)")
    dims_slab = (m0 + 2 * halo,) + A.dims[1:]
    cdims_slab = (m0 // b,) + tuple(cdims[1:])
    parts = []
    hW, hd = _halos(A.weights, halo, 1), _halos(d_inv.parts, halo, 0)
    hs = _halos(scale.parts, rc, 0)
    for i, p in enumerate(mesh.local):
        W_ext = _halo_concat(A.weights[i], hW[i], halo, 1)
        d_ext = _halo_concat(d_inv.parts[i], hd[i], halo, 0)
        sc_ext = _halo_concat(scale.parts[i], hs[i], rc, 0)
        gi = _local_rows(p, m0, -halo, m0 + 2 * halo, W_ext.device)
        mask = ((gi >= 0) & (gi < true_d0)).to(W_ext.dtype)
        mask = mask.reshape((-1,) + (1,) * (nd - 1))
        Wc = ds._slab_coarse_operator(
            W_ext, d_ext, sc_ext, coef.to(W_ext.device), 0, offsets=A.offsets,
            dims_slab=dims_slab, cdims_slab=cdims_slab, block=b, halo=halo,
            rc=rc, it=it, mask=mask).weights
        del W_ext, d_ext
        parts.append(Wc)
    return ShardedStencil(parts, tuple(out_offs), tuple(cdims), mesh)


def _sharded_sparsify_sym(A: ShardedStencil, tol: float) -> ShardedStencil:
    """Row-relative drop and lump, then symmetrize, on a sharded stencil.
    Symmetrization pairs W[o](p) with W[−o](p+o), so it needs a reach-1
    halo of the sparsified planes (sparsify itself is row-local)."""
    offs = sorted(set(A.offsets) | {tuple(-c for c in o) for o in A.offsets})
    h = max(max(abs(o[0]) for o in offs), 0)
    m0 = A.m0
    dims_ext = (m0 + 2 * h,) + A.dims[1:]
    parts = []
    for W, hw in zip(A.weights, _halos(A.weights, h, 1)):
        st = Stencil(_halo_concat(W, hw, h, 1), A.offsets, dims_ext)
        st = ds.symmetrize_stencil(ds.sparsify_stencil(st, tol))
        parts.append(st.weights[:, h:h + m0].contiguous())
    return ShardedStencil(parts, tuple(offs), A.dims, A.mesh)


def _sharded_prune(A: ShardedStencil) -> ShardedStencil:
    """Drop offset planes that are zero on every part (one small host read
    of the planes' norms over all parts)."""
    nd = len(A.dims)
    norms = exchange.psum([W.abs().sum(dim=tuple(range(1, 1 + nd)))
                           for W in A.weights]).cpu()
    keep = (norms > 0).numpy()
    keep[A.offsets.index(tuple(0 for _ in range(nd)))] = True
    if keep.all():
        return A
    idx = np.flatnonzero(keep)
    parts = [W[torch.as_tensor(idx, device=W.device)] for W in A.weights]
    offs = tuple(o for o, k in zip(A.offsets, keep) if k)
    return ShardedStencil(parts, offs, A.dims, A.mesh)


def _fix_pad_diag(A: ShardedStencil, counts: PGrid) -> ShardedStencil:
    """Identity diagonal on coarse rows whose aggregate holds no true fine
    cell (pure axis-0 padding blocks)."""
    di = A.offsets.index(tuple(0 for _ in A.dims))
    parts = []
    for W, c in zip(A.weights, counts.parts):
        W = W.clone()
        W[di] = torch.where(c > 0, W[di], torch.ones((), dtype=W.dtype,
                                                     device=W.device))
        parts.append(W)
    return ShardedStencil(parts, A.offsets, A.dims, A.mesh)


def _sharded_counts(pdims, true_d0, cdims, block, mesh, dtype) -> PGrid:
    """Per-coarse-block count of true fine cells (a part-local sum-pool of
    the axis-0 true mask): the aggregate normalization and the padding
    detector."""
    nd = len(pdims)
    m0 = pdims[0] // mesh.size
    local_cdims = (cdims[0] // mesh.size,) + tuple(cdims[1:])
    parts = []
    for p in mesh.local:
        gi = _local_rows(p, m0, 0, m0, mesh.device(p))
        mask = (gi < true_d0).to(dtype).reshape((-1,) + (1,) * (nd - 1))
        field = mask.expand((m0,) + tuple(pdims[1:]))
        parts.append(downsample_sum_nd(field, local_cdims, block))
    return PGrid(parts, mesh)


def _sharded_dinv(A: ShardedStencil) -> PGrid:
    """1/diag(A), 0 where the diagonal is 0."""
    return A.diagonal().map(lambda d: torch.where(d != 0, 1.0 / d, 0.0))


def power_plan(A: ShardedStencil, d_inv: PGrid) -> ordered_stencil.Plan:
    """The plan of the sharded power iteration's matvec D⁻¹·A·x: every
    part's interior centre unfused on the rows
    ``ordered_stencil.unfused_centre`` gives for the part's slab."""
    split, rows = ordered_stencil.unfused_centre(A.offsets, A.weights[0].shape[1:],
                                                 sharded=True)
    return ordered_stencil.Plan(A.weights, d_inv.parts, A.offsets, sharded=True,
                                split=split, rows=rows)


def _sharded_power(A: ShardedStencil, d_inv: PGrid, iters: int, seed: int = 0):
    """λ_max(D⁻¹A) on a float32 sharded operator (1.1 safety factor): the
    start vector is ``device_setup.start_vector`` over the padded global
    dims, split into parts, so it is the single-device engine's draw.  The
    matvec D⁻¹·A·x is the JAX package's sharded ``_jit_power`` matvec in its
    CPU order (``ops/ordered_stencil.py``: each part's interior chain with a
    zero halo on axis 0, then one fma per halo term in offset order; read
    off its optimised HLO and IR on a 4-device CPU mesh at 48 × 43 × 43, 27
    points: one fusion for the interior and one for each halo update, the
    interior's centre unfused on the rows ``power_plan`` gives; one
    ``ordered_stencil_matvec`` launch a card an iteration on the card) and
    the norm ``ordered_norm`` (XLA's SPMD order), so λ is the JAX package's
    bits; both take float32 only."""
    x = PGrid.from_global(ds.start_vector(A.dims, A.weights[0].dtype,
                                          A.mesh.home, seed), A.mesh)
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    plan = power_plan(A, d_inv)
    for _ in range(iters):
        halos = _halos(x.parts, A.halo, 0) if A.halo else None
        y = PGrid(ordered_stencil.matvec(plan, x.parts, halos), A.mesh)
        nrm = ordered_norm(y)
        lam = torch.where(nrm > 0, nrm, lam)
        x = y / torch.clamp(nrm, min=1e-30)
    return 1.1 * lam


# ---------------------------------------------------------------------------
# transfers across the agglomeration boundary (sharded padded fine grid ↔
# the true-dims coarse grid replicated on every process's mesh.home)
# ---------------------------------------------------------------------------

class SBoundaryProlongator:
    """P across the agglomeration boundary: true-dims coarse grid on
    ``mesh.home`` → sharded padded fine grid (zero-pad axis 0, split over
    the parts, then the SBlock P)."""

    def __init__(self, inner: SBlockProlongator, true_cdims):
        self.inner = inner
        self.true_cdims = tuple(int(d) for d in true_cdims)

    @property
    def linked(self) -> bool:
        return self.inner.linked

    @property
    def shape(self):
        return (self.inner.shape[0], int(np.prod(self.true_cdims)))

    def zeros_coarse(self, dtype):
        return torch.zeros(self.true_cdims, dtype=dtype,
                           device=self.inner.mesh.home)

    def matvec(self, xc):
        return self.matvec_linked(self.inner.A, self.inner.d_inv, xc)

    def matvec_linked(self, A, d_inv, xc):
        pc = self.inner.cdims
        pad = []
        for i in reversed(range(len(pc))):
            pad += [0, pc[i] - self.true_cdims[i]]
        xp = torch.nn.functional.pad(xc, pad)
        return self.inner.matvec_linked(A, d_inv,
                                        PGrid.from_global(xp, self.inner.mesh))


class SBoundaryRestrictor:
    """R across the agglomeration boundary: sharded padded fine residual →
    true-dims coarse right-hand side gathered on every process's
    ``mesh.home`` (SBlock R, gather, crop)."""

    def __init__(self, inner: SBlockRestrictor, true_cdims):
        self.inner = inner
        self.true_cdims = tuple(int(d) for d in true_cdims)

    @property
    def linked(self) -> bool:
        return self.inner.linked

    @property
    def shape(self):
        return (int(np.prod(self.true_cdims)), self.inner.shape[1])

    def matvec(self, r):
        return self.matvec_linked(self.inner.A, self.inner.d_inv, r)

    def matvec_linked(self, A, d_inv, r):
        y = self.inner.matvec_linked(A, d_inv, r).to_global()
        return y[tuple(slice(0, t) for t in self.true_cdims)]


# ---------------------------------------------------------------------------
# device-born sharded problem generators
# ---------------------------------------------------------------------------

def setup_halo_schedule(n_levels: int, block: int, reach0: int = 1):
    """Per-level axis-0 setup halo (planes) from the offset algebra.

    The slab Galerkin kernel needs halo_l = 2·(axis-0 reach of sym(SᵀAS))
    = 6·r_l planes at level l, and the coarse reach follows the Galerkin
    pooling: r_{l+1} = (b−1+3·r_l)//b (constant 1 at b=3).
    """
    halos, r = [], reach0
    for _ in range(n_levels):
        halos.append(6 * r)
        r = (block - 1 + 3 * r) // block
    return halos


def plan_sharded_levels(dims, config: AMGConfig, n_shards: int,
                        max_pad_frac: float = 0.2, reach0: int = 1):
    """(n_sharded_levels, padded axis-0 extent) for a grid of ``dims``.

    A level stays sharded while it is larger than ``config.agglomerate_n``,
    subject to whole blocks per part at every sharded level, a slab at least
    the setup halo at that level (``setup_halo_schedule``), and axis-0
    padding ≤ ``max_pad_frac``.
    """
    b = config.block_size
    thresh = max(config.agglomerate_n, config.n_coarse_max)
    L, cur = 0, tuple(dims)
    while L < config.max_levels - 1:
        nxt = tuple(-(-d // b) for d in cur)
        if int(np.prod(nxt)) <= thresh:
            break
        L += 1
        cur = nxt
    L = max(L, 1)
    while L > 1:
        align = n_shards * b ** L
        d0p = -(-dims[0] // align) * align
        halos = setup_halo_schedule(L, b, reach0)
        slabs_ok = all(
            d0p // (n_shards * b ** l) >= halos[l] for l in range(L))
        if (d0p / dims[0] - 1.0) <= max_pad_frac and slabs_ok:
            break
        L -= 1
    align = n_shards * b ** L
    d0p = -(-dims[0] // align) * align
    return L, d0p


def _sharded_stencil_nd(dims, d0p, mesh, axis_weights, diag_val,
                        dtype=torch.float32) -> ShardedStencil:
    """(2·nd+1)-point operator born sharded: −w_a along each axis where the
    neighbor exists in the TRUE grid, identity diagonal on axis-0 padding
    rows.  Each part builds its own planes on its device."""
    nd = len(dims)
    pdims = (int(d0p),) + tuple(int(d) for d in dims[1:])
    m0 = pdims[0] // mesh.size
    local = (m0,) + pdims[1:]
    offsets = [tuple(0 for _ in range(nd))]
    for axis in range(nd):
        for sgn in (-1, 1):
            offsets.append(tuple(sgn if i == axis else 0 for i in range(nd)))
    order = sorted(range(len(offsets)), key=lambda i: offsets[i])

    def iota(axis, n, lo, dev):
        shape = [1] * nd
        shape[axis] = n
        return (lo + torch.arange(n, device=dev)).reshape(shape)

    parts = []
    for p in mesh.local:
        dev = mesh.device(p)
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        i0 = iota(0, m0, p * m0, dev)
        in_true = (i0 < dims[0]).expand(local)
        planes = [torch.where(in_true, torch.full((), diag_val, dtype=dtype,
                                                  device=dev), one)]
        for axis in range(nd):
            w = torch.full((), -axis_weights[axis], dtype=dtype, device=dev)
            for sgn in (-1, 1):
                if axis == 0:
                    ok = (i0 > 0) & in_true if sgn < 0 else i0 < dims[0] - 1
                else:
                    ia = iota(axis, pdims[axis], 0, dev)
                    ok = (ia > 0) if sgn < 0 else (ia < dims[axis] - 1)
                    ok = ok & in_true
                planes.append(torch.where(ok.expand(local), w, zero))
        parts.append(torch.stack([planes[i] for i in order]))
    return ShardedStencil(parts, tuple(offsets[i] for i in order), pdims, mesh)


def poisson_stencil_sharded(dims, mesh, config: AMGConfig, dtype=torch.float32):
    """N-D Dirichlet Laplacian born split over ``mesh``; returns
    (ShardedStencil on the padded grid, true dims).  Equals
    ``problems.poisson2d/3d`` on the true grid."""
    _, d0p = plan_sharded_levels(dims, config, mesh.size)
    nd = len(dims)
    A = _sharded_stencil_nd(dims, d0p, mesh, [1.0] * nd, 2.0 * nd, dtype)
    return A, tuple(int(d) for d in dims)


def anisotropic_stencil_sharded(dims, mesh, config: AMGConfig,
                                epsilon: float = 1e-3, dtype=torch.float32):
    """2D anisotropic −u_xx − ε u_yy born split over ``mesh`` (equals
    ``problems.anisotropic2d`` on the true grid)."""
    if len(dims) != 2:
        raise ValueError(f"anisotropic_stencil_sharded is 2-D, got {dims}")
    _, d0p = plan_sharded_levels(dims, config, mesh.size)
    A = _sharded_stencil_nd(dims, d0p, mesh, [1.0, epsilon],
                            2.0 + 2.0 * epsilon, dtype)
    return A, tuple(int(d) for d in dims)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def sharded_device_setup(A, config: AMGConfig, mesh=None, true_dims=None,
                         dtype=torch.float32, seed: int = 0) -> Hierarchy:
    """Distributed on-device structured block-SA setup.

    ``A``: a :class:`ShardedStencil` (device-born by
    ``poisson_stencil_sharded``; ``true_dims`` required), or a
    :class:`~parallel_amg_tpu_torch.ops.stencil.Stencil` to be padded and
    split over ``mesh`` here (small problems, tests).

    Per level: d⁻¹ and λ_max(D⁻¹A) on the sharded operator, then the slab
    Galerkin kernel part by part; once the next level would be smaller than
    ``config.agglomerate_n`` (or its slab can no longer split evenly) the
    operator is gathered on every process and the remaining levels are
    built there by the single-device engine, replicated.  ``setup_stats`` holds the
    number of sharded levels and the tail's product paths.
    """
    if not (config.coarsening == "sa" and config.aggregate == "block"):
        raise ValueError("sharded_device_setup implements the structured "
                         "block-SA path")
    b = config.block_size
    if not isinstance(A, ShardedStencil):
        if mesh is None:
            raise ValueError("a mesh is required for a Stencil operator")
        st = A
        true_dims = tuple(st.dims)
        _, d0p = plan_sharded_levels(st.dims, config, mesh.size)
        Wp = torch.nn.functional.pad(
            st.weights.to(dtype), [0, 0] * (len(st.dims) - 1)
            + [0, d0p - st.dims[0]])
        zero = tuple(0 for _ in st.dims)
        if zero in st.offsets:
            Wp[st.offsets.index(zero), st.dims[0]:] = 1.0
        A = ShardedStencil.from_global(Wp, st.offsets, (d0p,) + st.dims[1:],
                                       mesh)
    else:
        if true_dims is None:
            raise ValueError("true_dims required for a device-born "
                             "ShardedStencil")
        mesh = A.mesh
    S_n = mesh.size
    thresh = max(config.agglomerate_n, config.n_coarse_max)

    levels: List[Level] = []
    true_d = tuple(int(d) for d in true_dims)
    while len(levels) < config.max_levels - 1:
        d_inv = _sharded_dinv(A)
        lam = _sharded_power(A, d_inv, config.lambda_power_iters, seed)
        m0 = A.dims[0] // S_n
        sym_offs = _product_offsets(A.offsets, len(A.dims))
        halo = 2 * max(abs(o[0]) for o in sym_offs)
        nxt_true = tuple(-(-t // b) for t in true_d)
        can_shard = (A.dims[0] % S_n == 0 and m0 % b == 0 and halo <= m0
                     and (A.dims[0] // b) % S_n == 0)
        if int(np.prod(true_d)) <= thresh or not can_shard:
            break
        cdims = (A.dims[0] // b,) + tuple(-(-d // b) for d in A.dims[1:])
        counts = _sharded_counts(A.dims, true_d[0], cdims, b, mesh, dtype)
        scale = counts.map(ds.eager_block_scale)
        coef = torch.full_like(lam, config.sa_omega) / torch.clamp(lam, min=1e-30)
        A_c = sharded_coarse_operator(A, d_inv, coef, scale, cdims, b,
                                      config.setup_intermediate_tol, true_d[0])
        A_c = _fix_pad_diag(A_c, counts)
        if config.coarse_drop_tol > 0:
            A_c = _sharded_sparsify_sym(A_c, config.coarse_drop_tol)
            A_c = _fix_pad_diag(A_c, counts)
        A_c = _sharded_prune(A_c)
        P = SBlockProlongator(None, None, scale, float(coef), A.dims, cdims, b,
                              mesh, true_d0=true_d[0])
        R = SBlockRestrictor(None, None, scale, float(coef), A.dims, cdims, b,
                             mesh)
        levels.append(Level(A, P, R, d_inv, float(lam),
                            true_n=int(np.prod(true_d))))
        A = A_c
        true_d = nxt_true

    # gather the (tiny) remaining operator on every process and build the
    # tail there with the single-device engine
    W_tail = A.global_weights()[:, :true_d[0]].contiguous()
    A_tail = Stencil(W_tail, A.offsets, (true_d[0],) + tuple(A.dims[1:]))
    tail = ds.device_structured_setup(A_tail, config, dtype=dtype, seed=seed)

    if levels:
        last = levels[-1]
        levels[-1] = Level(last.A, SBoundaryProlongator(last.P, true_d),
                           SBoundaryRestrictor(last.R, true_d), last.d_inv,
                           last.lam_max, true_n=last.true_n)
    h = Hierarchy(apply_halo_mode(levels, config.halo_mode) + tail.levels,
                  tail.coarse_inv, config)
    h.setup_stats = {"sharded_levels": len(levels),
                     "tail_product_paths": tail.setup_stats["product_paths"]}
    return h
