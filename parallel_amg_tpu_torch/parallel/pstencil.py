"""Sharded stencil operators — the distributed structured path's SpMV.

Counterpart of ``parallel_amg_tpu/parallel/pstencil.py``.  Domain
decomposition along grid axis 0 over a row mesh (``parallel/mesh.py``): part
p owns a slab of m0 grid planes and its weight planes (D, m0, *rest).  A
matvec needs only the h = max |offset₀| boundary planes of each neighbor:
the left halo of part p is part p−1's last h planes, the right halo part
p+1's first h planes, and the two ends of the grid get zeros.  The JAX
package moves them with two ``ppermute`` shifts; here ``exchange.halos``
moves them (on one card the halos are views of the neighbours' slabs; across
processes, point-to-point messages).

The matvec is the JAX package's interior + boundary formulation: the
interior contribution reads the local slab alone (zero halo), and only the
O(h·surface) boundary-row corrections read the halo planes.
``halo_mode="xla"`` runs it in plain torch (``interior_plain`` and
``boundary_plain``, shared with kernel B8's CPU path);
``halo_mode="pallas_async"`` runs kernel B8 (``parallel/phalo_async.py``):
one launch for every part on one card, reading the halo planes in place, or
the halo exchange overlapped with one interior launch a card where parts lie
on several cards or processes.  The mode names are the JAX package's, so
configs carry over.

Transfers stay part-local: the grid is padded so every part owns whole
aggregation blocks (``parallel/pstructured.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.ops.stencil import _pad_nd
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.pgrid import PGrid

HALO_MODES = ("xla", "pallas_async")


def _rest_pads(offsets):
    """Zero padding of the non-sharded axes that every offset's read needs."""
    nd = len(offsets[0])
    return [(max(0, -min(o[i] for o in offsets)),
             max(0, max(o[i] for o in offsets))) for i in range(1, nd)]


def interior_plain(W, xl, offsets, h: int):
    """Σ_d W[d]·x shifted by offset d, reading zero outside the slab on
    axis 0 and outside the grid on the other axes: the interior
    contribution, products and sums in offset order."""
    m0 = xl.shape[0]
    pads = [(h, h)] + _rest_pads(offsets)
    xp = _pad_nd(xl, pads)
    y = torch.zeros_like(xl)
    for d, off in enumerate(offsets):
        idx = (slice(h + off[0], h + off[0] + m0),) + tuple(
            slice(pads[i][0] + off[i], pads[i][0] + off[i] + n)
            for i, n in enumerate(xl.shape[1:], start=1))
        y = y + W[d] * xp[idx]
    return y


def boundary_plain(y, W, left, right, offsets, h: int):
    """Add the boundary-row terms that read the halo planes, in offset order:
    for o₀ < 0, rows i < −o₀ read left-halo plane h + o₀ + i; for o₀ > 0,
    rows i ≥ m0 − o₀ read right-halo plane i + o₀ − m0.  A halo of None is
    the zero halo at the grid's end: its terms add nothing."""
    m0 = y.shape[0]
    rest = tuple(y.shape[1:])
    pads = [(0, 0)] + _rest_pads(offsets)
    lp = None if left is None else _pad_nd(left, pads)
    rp = None if right is None else _pad_nd(right, pads)
    for d, off in enumerate(offsets):
        o0 = off[0]
        if o0 == 0 or (lp if o0 < 0 else rp) is None:
            continue
        sub = tuple(slice(pads[i][0] + off[i], pads[i][0] + off[i] + rest[i - 1])
                    for i in range(1, len(off)))
        if o0 < 0:
            L = -o0
            y[:L] += W[d][:L] * lp[(slice(h + o0, h),) + sub]
        else:
            y[m0 - o0:] += W[d][m0 - o0:] * rp[(slice(0, o0),) + sub]
    return y


def apply_halo_mode(levels, mode: str):
    """Re-tag every ShardedStencil level operator with ``mode``: how
    ``AMGConfig.halo_mode`` reaches the solve path.  Other levels pass
    unchanged."""
    from parallel_amg_tpu_torch.amg.hierarchy import Level

    return [Level(l.A.with_halo_mode(mode) if isinstance(l.A, ShardedStencil)
                  else l.A, l.P, l.R, l.d_inv, l.lam_max, l.true_n)
            for l in levels]


class ShardedStencil:
    """Stencil operator on a grid split along axis 0 over a row mesh.

    weights: one (D, m0, *rest) tensor per local part (``mesh.local``), on
    the part's device; dims: the padded global dims (dims[0] = S·m0).  Padding planes carry an
    identity diagonal so smoothers stay inert there.
    """

    def __init__(self, weights, offsets, dims, mesh, halo_mode="xla"):
        self.weights = list(weights)
        self.offsets = tuple(tuple(int(c) for c in o) for o in offsets)
        self.dims = tuple(int(d) for d in dims)
        self.mesh = mesh
        if halo_mode not in HALO_MODES:
            raise ValueError(f"halo_mode must be one of {HALO_MODES}, got "
                             f"{halo_mode!r}")
        self.halo_mode = halo_mode
        # kernel B8's launch tables (parallel/phalo_async.py: Route), built
        # at its first launch
        self.launch_table = None
        if len(self.weights) != mesh.n_local or self.dims[0] % mesh.size:
            raise ValueError(f"{len(self.weights)} weight parts and dims "
                             f"{self.dims} do not fit a mesh of {mesh.size}")

    def with_halo_mode(self, mode: str) -> "ShardedStencil":
        return ShardedStencil(self.weights, self.offsets, self.dims, self.mesh,
                              mode)

    # -- properties -------------------------------------------------------
    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def n_points(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int(exchange.psum([(W != 0).sum() for W in self.weights]))

    @property
    def halo(self) -> int:
        return max(max(abs(o[0]) for o in self.offsets), 0)

    @property
    def m0(self) -> int:
        """Planes per part."""
        return self.dims[0] // self.mesh.size

    # -- construction -----------------------------------------------------
    @classmethod
    def from_global(cls, W, offsets, dims, mesh, halo_mode="xla"):
        """Split (D, d0p, *rest) global weight planes over the mesh (this
        process keeps its parts)."""
        S = mesh.size
        m0 = int(dims[0]) // S
        parts = [W[:, p * m0:(p + 1) * m0].to(mesh.device(p)).contiguous()
                 for p in mesh.local]
        return cls(parts, offsets, dims, mesh, halo_mode)

    @classmethod
    def from_stencil(cls, st, mesh, dtype=None):
        """Shard a Stencil: pad axis 0 to S·m0 with identity planes, split
        the weight planes over the mesh."""
        S = mesh.size
        d0 = st.dims[0]
        d0p = S * -(-d0 // S)
        W = st.weights.to(dtype or st.weights.dtype)
        Wp = torch.nn.functional.pad(
            W, [0, 0] * (len(st.dims) - 1) + [0, d0p - d0])
        zero = tuple(0 for _ in st.dims)
        if zero in st.offsets:
            Wp[st.offsets.index(zero), d0:] = 1.0  # identity on padding planes
        return cls.from_global(Wp, st.offsets, (d0p,) + st.dims[1:], mesh)

    def global_weights(self, device=None):
        """(D, d0p, *rest) planes gathered on ``device`` (the first local
        part's when None), on every process."""
        dev = self.weights[0].device if device is None else torch.device(device)
        return torch.cat([W.to(dev) for W in exchange.all_gather(self.weights)],
                         dim=1)

    # -- distributed matvec ------------------------------------------------
    def matvec(self, x: PGrid) -> PGrid:
        """y = A @ x for a PGrid x over this operator's mesh."""
        if self.halo_mode == "pallas_async":
            from parallel_amg_tpu_torch.parallel.phalo_async import (
                async_halo_matvec,
            )
            return async_halo_matvec(self, x)
        h = self.halo
        if h > self.m0:
            raise ValueError(f"halo {h} exceeds the {self.m0}-plane part slab")
        halos = exchange.halos(x.parts, h) if h else None
        out = []
        for i, (W, xl) in enumerate(zip(self.weights, x.parts)):
            y = interior_plain(W, xl, self.offsets, h)
            if h:
                y = boundary_plain(y, W, *halos[i], self.offsets, h)
            out.append(y)
        return PGrid(out, self.mesh)

    def diagonal(self) -> PGrid:
        zero = tuple(0 for _ in self.dims)
        if zero in self.offsets:
            d = self.offsets.index(zero)
            return PGrid([W[d] for W in self.weights], self.mesh)
        return PGrid([torch.zeros(W.shape[1:], dtype=W.dtype, device=W.device)
                      for W in self.weights], self.mesh)

    def __matmul__(self, x):
        return self.matvec(x)
