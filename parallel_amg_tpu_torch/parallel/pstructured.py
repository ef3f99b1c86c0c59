"""Distributed structured-SA hierarchy: sharded stencils and part-local
transfers.

Counterpart of ``parallel_amg_tpu/parallel/pstructured.py``.  The grid's
axis 0 is padded to S·b^(L−1)·k before it is split, so every part owns a
whole number of aggregation blocks at every level.  Then:

- the A-matvec needs only an h-plane halo exchange (``parallel/pstencil.py``);
- P and R (block upsample, sum-pool) are part-local: no copies at all;
- dots and norms reduce the per-part partials (``parallel/pgrid.py``).

Padding planes carry identity diagonals (A), d_inv = 1, aggregate scale 0
and zero right-hand side, so they stay inert through the whole cycle.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level, coarse_inverse_np
from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd, upsample_nd
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil, apply_halo_mode


class _SBlockTransfer:
    """Shared state of the sharded block transfers.

    Pass A=None/d_inv=None for a LINKED transfer that borrows the level's
    operator at apply time (``amg/cycle.py`` ``_apply_transfer``).  ``scale``
    is a PGrid over the padded coarse dims; ``coef`` (ω/λ_max) a Python
    float holding a float32 value.  ``true_d0`` (optional, prolongator
    only): the true axis-0 extent of the fine grid; the tentative upsample
    is masked to it, which keeps axis-0 padding cells exactly zero through
    the cycle (the on-device distributed setup's coarse operators aggregate
    true fine cells only).
    """

    def __init__(self, A, d_inv, scale, coef, dims, cdims, block, mesh,
                 true_d0=None):
        self.A = A
        self.d_inv = d_inv
        self.scale = scale
        self.coef = float(coef)
        self.dims = tuple(int(d) for d in dims)     # padded fine dims
        self.cdims = tuple(int(d) for d in cdims)   # padded coarse dims
        self.block = int(block)
        self.mesh = mesh
        self.true_d0 = None if true_d0 is None else int(true_d0)

    @property
    def linked(self) -> bool:
        return self.A is None

    def matvec(self, v):
        return self.matvec_linked(self.A, self.d_inv, v)


class SBlockProlongator(_SBlockTransfer):
    """P @ xc = (I − coef·D⁻¹A) upsample(xc · scale), upsample part-local."""

    @property
    def shape(self):
        return (int(np.prod(self.dims)), int(np.prod(self.cdims)))

    def zeros_coarse(self, dtype):
        m0c = self.cdims[0] // self.mesh.size
        return PGrid([torch.zeros((m0c,) + self.cdims[1:], dtype=dtype,
                                  device=self.mesh.device(p))
                      for p in self.mesh.local], self.mesh)

    def matvec_linked(self, A, d_inv, xc):
        m0 = self.dims[0] // self.mesh.size
        local_fine = (m0,) + self.dims[1:]
        parts = []
        for p, xl, sl in zip(self.mesh.local, xc.parts, self.scale.parts):
            t = upsample_nd(xl * sl, local_fine, self.block)
            if self.true_d0 is not None:
                gi = p * m0 + torch.arange(m0, device=t.device)
                mask = (gi < self.true_d0).to(t.dtype)
                t = t * mask.reshape((-1,) + (1,) * (len(self.dims) - 1))
            parts.append(t)
        t = PGrid(parts, self.mesh)
        return t - self.coef * (d_inv * A.matvec(t))


class SBlockRestrictor(_SBlockTransfer):
    """R @ r = scale · downsample(r − coef·A(D⁻¹ r)), downsample part-local.

    No true-extent mask is needed here: with zero right-hand side and zero
    iterates on the padding rows (the prolongator's mask), the residual is
    zero there.
    """

    @property
    def shape(self):
        return (int(np.prod(self.cdims)), int(np.prod(self.dims)))

    def matvec_linked(self, A, d_inv, r):
        local_coarse = (self.cdims[0] // self.mesh.size,) + self.cdims[1:]
        s = r - self.coef * A.matvec(d_inv * r)
        return s.map(lambda sl, scl: scl * downsample_sum_nd(
            sl, local_coarse, self.block), self.scale)


def _pad_axis0(arr, d0p, fill=0.0):
    """Pad a numpy array's axis 0 to d0p with a constant."""
    pad = [(0, d0p - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=fill)


def _grid(arr, mesh, dtype) -> PGrid:
    return PGrid.from_global(torch.from_numpy(np.ascontiguousarray(
        arr, np.float64)).to(dtype), mesh)


def structured_distributed_setup(A, config: AMGConfig, mesh, dims,
                                 dtype=torch.float32, seed: int = 0) -> Hierarchy:
    """Host setup (the float64 oracle) → sharded all-stencil hierarchy over
    ``mesh``: ShardedStencil levels with SBlock transfers, and the dense
    coarse inverse over the padded coarse grid on every process's
    ``mesh.home``.  Each process runs the oracle and keeps its parts."""
    from parallel_amg_tpu_torch.oracle.serial_amg import oracle_setup
    from parallel_amg_tpu_torch.parallel.psetup import oracle_arrays

    if isinstance(A, CSR):
        A_sp = A.to_scipy()
    elif hasattr(A, "to_csr"):
        A_sp = A.to_csr().to_scipy()
    else:
        A_sp = A
    if not (config.coarsening == "sa" and config.aggregate == "block"):
        raise ValueError("structured_distributed_setup requires the block-SA "
                         "configuration")
    oh = oracle_setup(A_sp, config, seed=seed, dims=dims)
    exchange.check_replicated(oracle_arrays(oh), mesh.home, "the host oracle")
    S = mesh.size
    b = config.block_size
    # every level's grid must be block- and part-aligned
    align = S * b ** (len(oh.levels) - 1)
    d0p0 = -(-dims[0] // align) * align

    level_dims: List[tuple] = []
    cur = (d0p0,) + tuple(dims[1:])
    for ol in oh.levels:
        level_dims.append(cur)
        if ol.cdims is not None:
            cur = (cur[0] // b,) + tuple(ol.cdims[1:])

    levels: List[Level] = []
    for i, ol in enumerate(oh.levels):
        pdims = level_dims[i]
        tdims = _true_dims(oh, i, dims)
        st = Stencil.from_csr(CSR.from_scipy(ol.A), tdims, dtype=torch.float64,
                              max_points=512)
        if st is None:
            raise ValueError(f"level {i} operator is not stencil-structured")
        W = st.weights.numpy()
        Wp = np.stack([_pad_axis0(W[d], pdims[0]) for d in range(W.shape[0])])
        zero = tuple(0 for _ in pdims)
        if zero in st.offsets:
            Wp[st.offsets.index(zero), st.dims[0]:] = 1.0
        A_dev = ShardedStencil.from_global(torch.from_numpy(Wp).to(dtype),
                                           st.offsets, pdims, mesh)
        d_inv = _grid(_pad_axis0(np.asarray(ol.d_inv).reshape(st.dims),
                                 pdims[0], fill=1.0), mesh, dtype)
        lam = float(torch.tensor(float(ol.lam_max), dtype=torch.float64).to(dtype))
        P_dev = R_dev = None
        if ol.P is not None and i + 1 < len(oh.levels):
            pcdims = level_dims[i + 1]
            scale = _grid(_pad_axis0(np.asarray(ol.agg_scale).reshape(ol.cdims),
                                     pcdims[0]), mesh, dtype)
            coef = float(torch.tensor(config.sa_omega / max(ol.lam_max, 1e-30),
                                      dtype=torch.float64).to(dtype))
            P_dev = SBlockProlongator(A_dev, d_inv, scale, coef, pdims, pcdims,
                                      b, mesh)
            R_dev = SBlockRestrictor(A_dev, d_inv, scale, coef, pdims, pcdims,
                                     b, mesh)
        levels.append(Level(A_dev, P_dev, R_dev, d_inv, lam,
                            true_n=int(np.prod(tdims))))

    # dense coarse inverse over the padded coarse grid: the true operator
    # at the padded index positions, identity on the padding
    cdims_pad = level_dims[-1]
    n_pad = int(np.prod(cdims_pad))
    tdims = _true_dims(oh, len(oh.levels) - 1, dims)
    dense = np.eye(n_pad)
    tidx = _embed_indices(tdims, cdims_pad)
    dense[np.ix_(tidx, tidx)] = oh.levels[-1].A.toarray()
    coarse_inv = torch.from_numpy(coarse_inverse_np(dense)).to(
        torch.float32).to(mesh.home)
    return Hierarchy(apply_halo_mode(levels, config.halo_mode), coarse_inv,
                     config)


def _true_dims(oh, i, dims0):
    """True (unpadded) grid dims of level i."""
    cur = tuple(dims0)
    for j, ol in enumerate(oh.levels):
        if j == i:
            return cur
        cur = tuple(ol.cdims) if ol.cdims is not None else cur
    return cur


def _embed_indices(true_dims, padded_dims):
    """Flat padded-grid indices of the true-grid points (lexicographic)."""
    coords = np.stack(
        np.unravel_index(np.arange(int(np.prod(true_dims))), true_dims), 1)
    return np.ravel_multi_index(tuple(coords.T), padded_dims)


def distribute_grid(v, true_dims, hierarchy: Hierarchy, mesh,
                    dtype=torch.float32) -> PGrid:
    """Host (n,) vector → padded PGrid over ``mesh`` for the solve path."""
    pdims = hierarchy.levels[0].A.dims
    g = np.zeros(pdims, dtype=np.float64)
    g[tuple(slice(0, d) for d in true_dims)] = np.asarray(v).reshape(true_dims)
    return _grid(g, mesh, dtype)


def collect_grid(x: PGrid, true_dims) -> np.ndarray:
    """PGrid → host (n,) vector with the padding stripped."""
    g = x.to_global("cpu").numpy()
    return g[tuple(slice(0, d) for d in true_dims)].reshape(-1)
