"""BTWELL — the block (BSR) SpMV format with zero blocks dropped.

Counterpart of ``parallel_amg_tpu/ops/btwell.py``, under the same class name
and methods.  The JAX BTWELL is TWELL lifted to bs×bs blocks: 128-lane tile
windows, int8 in-window indices and sublane-replicated x, all shaped for
Mosaic's in-tile gather, and built on the host.  A Hopper thread loads any
address, so here BTWELL is the block-ELL layout of ``ops/bsr.py`` with the
all-zero blocks dropped and each row's live blocks packed to the front
(``brow_nnz`` below the width where a row lost blocks), built on the device.
``matvec``, ``matvec_planes`` (x and y as (bs, n) component planes) and the
BSR methods all launch kernel B6 (``csrc/bsr_spmv.cu``) on the card, which
reads only a row's live slots.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.ops.bsr import BSR, bsr_spmv, plane_offsets
from parallel_amg_tpu_torch.ops.bstencil import kron_columns


def pack_slots(keep, cols_of, vals_of, n_block_rows: int, bs: int, dtype):
    """Block-ELL planes from per-slot candidates, live ones packed first.

    keep: (W0, RB) bool, the candidate blocks to keep; ``cols_of(w)`` gives
    slot w's (RB,) block columns and ``vals_of(w)`` its (bs², RB) values.
    Returns (bcols (WB, RB) int32, vals (WB·bs², RB), brow_nnz (RB,) int32)
    with WB the longest row (one host read).  Every destination is a 64-bit
    element offset (``plane_offsets``), so planes past 2^31 elements stay
    addressable.
    """
    RB = n_block_rows
    dev = keep.device
    count = keep.sum(dim=0)
    pos = keep.cumsum(dim=0) - 1
    WB = max(int(count.max()) if RB else 0, 1)
    bcols = torch.zeros((WB, RB), dtype=torch.int32, device=dev)
    vals = torch.zeros((WB * bs * bs, RB), dtype=dtype, device=dev)
    q = torch.arange(bs * bs, device=dev)
    for w in range(keep.shape[0]):
        r = torch.nonzero(keep[w]).reshape(-1)
        s = pos[w, r]
        bcols.view(-1)[s * RB + r] = cols_of(w)[r].to(torch.int32)
        vals.view(-1)[plane_offsets(s, q, r, RB, bs).reshape(-1)] = \
            vals_of(w)[:, r].to(dtype).reshape(-1)
    return bcols, vals, count.to(torch.int32)


class BTWELL(BSR):
    """Block-ELL with zero blocks dropped, rows packed (module docstring)."""

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_block_entries(cls, rows, cols, vals, shape, bs, dtype=None,
                           device="cpu") -> "BTWELL":
        """Host build from block-entry triplets (runs once).

        rows/cols: (nnzb,) block indices; vals: (nnzb, bs, bs) dense blocks,
        or a pair (scalar values (nnzb,), C (bs, bs)) for Kronecker entries.
        Blocks keep their order within a row.
        """
        dtype = dtype or torch.float32
        RB = -(-shape[0] // bs)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        if isinstance(vals, tuple):
            svals, C = vals
            blocks = (np.asarray(svals, np.float32)[:, None, None]
                      * np.asarray(C, np.float32)[None])
        else:
            blocks = np.asarray(vals)
        order = np.argsort(rows, kind="stable")
        rows, cols, blocks = rows[order], cols[order], blocks[order]
        counts = np.bincount(rows, minlength=RB)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(rows)) - starts[rows]
        WB = max(int(counts.max()), 1) if len(rows) else 1
        bcols = np.zeros((WB, RB), np.int32)
        bvals = np.zeros((WB, bs, bs, RB), np.float32)
        bcols[slot, rows] = cols
        bvals[slot, :, :, rows] = blocks
        return cls(torch.from_numpy(bcols).to(device),
                   torch.from_numpy(bvals.reshape(WB * bs * bs, RB)).to(
                       dtype).to(device),
                   torch.from_numpy(counts.astype(np.int32)).to(device),
                   tuple(int(s) for s in shape), bs)

    @classmethod
    def from_bsr(cls, bsr, dtype=None) -> "BTWELL":
        """From a block-ELL BSR on its device: drops padding and all-zero
        blocks and packs each row's live blocks to the front."""
        bs = bsr.bs
        RB, WB = bsr.n_block_rows, bsr.width
        planes = bsr.vals.reshape(WB, bs * bs, RB)
        slot = torch.arange(WB, device=bsr.bcols.device)[:, None]
        keep = (slot < bsr.brow_nnz[None].long()) & (planes != 0).any(dim=1)
        bcols, vals, brow_nnz = pack_slots(
            keep, lambda w: bsr.bcols[w], lambda w: planes[w], RB, bs,
            dtype or bsr.vals.dtype)
        return cls(bcols, vals, brow_nnz, bsr.shape, bs)

    def to_bsr(self) -> BSR:
        """The same block-ELL as a BSR (shares the tensors)."""
        return BSR(self.bcols, self.vals, self.brow_nnz, self.shape, self.bs)

    # -- SpMV -------------------------------------------------------------------
    def matvec_planes(self, xp):
        """y = A @ x with x in component-plane layout: xp (bs, n_block_cols)
        float32.  Returns (bs, n_block_rows) planes; the kernel reads and
        writes the planes through strides, with no transpose copy."""
        yp = torch.empty((self.bs, self.n_block_rows), dtype=torch.float32,
                         device=xp.device)
        bsr_spmv(self.bcols, self.vals, self.brow_nnz, self.bs, xp.T, out=yp.T)
        return yp


def btwell_from_kron_stencil(L, C, dtype=None) -> BTWELL:
    """BTWELL of A = L ⊗ C, built on L's device from its weight planes.

    Block row p (flat node id) keeps the offsets d whose neighbor p + off_d
    lies on the grid and whose weight W_d(p) is not zero, packed in offset
    order; block (p, d) is W_d(p)·C.
    """
    dtype = dtype or torch.float32
    bs = int(np.asarray(C).shape[0])
    Ct = torch.as_tensor(np.asarray(C, np.float32), device=L.weights.device)
    W = L.weights.reshape(L.n_points, -1)
    cols, oks = kron_columns(L)
    keep = torch.stack([oks[d] & (W[d] != 0) for d in range(L.n_points)])
    bcols, vals, brow_nnz = pack_slots(
        keep, lambda d: cols[d],
        lambda d: W[d].float()[None] * Ct.reshape(-1)[:, None], L.n, bs, dtype)
    return BTWELL(bcols, vals, brow_nnz, (L.n * bs, L.n * bs), bs)

