"""Structured SA transfer operators — N-D, reshape and pool based, gather-free.

Counterpart of ``parallel_amg_tpu/amg/transfers.py``.  For aggregate="block"
levels the tentative prolongator T is block injection on a regular grid, so
T@x is repeat-upsampling and Tᵀ@y is sum-pooling, and the smoothed transfers

    P = (I − (ω/λ) D⁻¹A) T        R = Pᵀ = Tᵀ (I − (ω/λ) A D⁻¹)

need only the level's operator A (a Stencil or FlatDIA).  Everything stays
in N-D grid layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def upsample_nd(xc, dims, block):
    """T₀ @ xc: block-repeat each axis, crop to the fine dims."""
    g = xc
    for ax in range(len(dims)):
        g = torch.repeat_interleave(g, block, dim=ax)
    return g[tuple(slice(0, d) for d in dims)]


def downsample_sum_nd(y, cdims, block, lead: int = 0):
    """T₀ᵀ @ y: zero-pad to whole blocks, then sum each block.

    The trailing len(cdims) axes are the grid; ``lead`` leading axes ride
    along.  Pad, reshape each grid axis c·b to (c, b), sum the b axes.
    """
    nd = len(cdims)
    flat = []
    for i in reversed(range(nd)):
        flat += [0, cdims[i] * block - y.shape[lead + i]]
    yp = F.pad(y, flat)
    shape = list(yp.shape[:lead])
    for c in cdims:
        shape += [c, block]
    return yp.reshape(shape).sum(dim=tuple(lead + 2 * i + 1 for i in range(nd)))


class _BlockTransfer:
    """Shared state of the block transfers.

    Pass A=None/d_inv=None to build a LINKED transfer that borrows the
    level's operator at apply time (``matvec_linked``) instead of holding its
    own reference.  ``coef`` is ω/λ_max, a Python float holding a float32
    value.
    """

    def __init__(self, A, d_inv, scale, coef, dims, cdims, block):
        self.A = A            # the level's operator (or None when linked)
        self.d_inv = d_inv    # (*dims,) (or None when linked)
        self.scale = scale    # (*cdims,) tentative column norms 1/√|agg|
        self.coef = float(coef)
        self.dims = tuple(int(d) for d in dims)
        self.cdims = tuple(int(d) for d in cdims)
        self.block = int(block)

    def to(self, device):
        return type(self)(None if self.A is None else self.A.to(device),
                          None if self.d_inv is None else self.d_inv.to(device),
                          self.scale.to(device), self.coef, self.dims,
                          self.cdims, self.block)

    @property
    def linked(self) -> bool:
        return self.A is None

    def matvec(self, v):
        return self.matvec_linked(self.A, self.d_inv, v)


class BlockProlongator(_BlockTransfer):
    """P @ xc = (I − (ω/λ) D⁻¹ A) upsample(xc · scale); N-D in and out."""

    @property
    def shape(self):
        return (int(np.prod(self.dims)), int(np.prod(self.cdims)))

    def zeros_coarse(self, dtype):
        return torch.zeros(self.cdims, dtype=dtype, device=self.scale.device)

    def matvec_linked(self, A, d_inv, xc):
        t = upsample_nd(xc * self.scale, self.dims, self.block)
        return t - self.coef * (d_inv * A.matvec(t))


class BlockRestrictor(_BlockTransfer):
    """R @ r = scale · downsample_sum(r − (ω/λ) A (D⁻¹ r)); N-D in and out."""

    @property
    def shape(self):
        return (int(np.prod(self.cdims)), int(np.prod(self.dims)))

    def matvec_linked(self, A, d_inv, r):
        s = r - self.coef * A.matvec(d_inv * r)
        return self.scale * downsample_sum_nd(s, self.cdims, self.block)
