"""Stencil (N-D DIA) format — variable-coefficient stencils on regular grids.

Counterpart of ``parallel_amg_tpu/ops/stencil.py``.  Vectors on the
structured path are N-D grids; the hierarchy converts at the user API
boundary only.  ``matvec`` is Σ_d W_d ⊙ shift_d(x) over one padded copy of x:
plain torch, as the JAX package leaves this format to XLA rather than to a
kernel.  The stencil algebra (``matmul``, ``add``, scalings, shifts) is what
the on-device setup (``amg/device_setup.py``) is built from.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad_nd(t, pads):
    """Zero-pad the trailing len(pads) axes of t; pads = ((lo, hi), ...) in
    axis order (F.pad takes them last axis first)."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [lo, hi]
    return F.pad(t, flat)


def shift_nd(f, s, dims):
    """f[..., p + s] over the trailing grid axes, zero outside the grid."""
    lead = f.dim() - len(dims)
    fp = _pad_nd(f, [(max(0, -c), max(0, c)) for c in s])
    idx = (slice(None),) * lead + tuple(
        slice(max(0, c), max(0, c) + d) for c, d in zip(s, dims))
    return fp[idx]


def bucket_add(acc, ids, terms):
    """acc[ids[k]] += terms[k] along axis 0, exact and in a fixed order.

    Duplicate ids are taken in rounds of distinct ids (the k-th occurrence of
    each id in round k), so no index_add_ ever sees two writes to one row:
    every sum is an exact float32 add in occurrence order, on the CPU and on
    the card alike (CUDA's index_add_ adds duplicates with atomics in no
    fixed order).  This replaces the JAX package's one-hot matmul, which on
    the card would go through cuBLAS.
    """
    ids = np.asarray(ids, np.int64)
    seen: dict = {}
    rank = np.empty(len(ids), np.int64)
    for k, i in enumerate(ids.tolist()):
        rank[k] = seen.get(i, 0)
        seen[i] = rank[k] + 1
    for r in range(int(rank.max()) + 1 if len(ids) else 0):
        sel = np.flatnonzero(rank == r)
        part = terms if len(sel) == len(ids) else terms[
            torch.as_tensor(sel, device=terms.device)]
        acc.index_add_(0, torch.as_tensor(ids[sel], device=acc.device), part)
    return acc


class Stencil:
    """Variable-coefficient stencil operator on an N-D grid.

    Attributes:
      weights: (D, *dims) — weights[d, p] multiplies x[p + offsets[d]]
               (zero where the neighbor falls outside the grid).
      offsets: tuple of D N-D integer tuples.
      dims: grid shape.
    """

    def __init__(self, weights, offsets, dims):
        self.weights = weights
        self.offsets = tuple(tuple(int(c) for c in o) for o in offsets)
        self.dims = tuple(int(d) for d in dims)
        self._flat = None  # (planes, 1-D offsets) of flat_planes, once built

    def to(self, device) -> "Stencil":
        return Stencil(self.weights.to(device), self.offsets, self.dims)

    # -- properties -------------------------------------------------------
    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def n_points(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int((self.weights != 0).sum())

    @property
    def n_rows(self) -> int:
        return self.n

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_csr(cls, csr, dims, dtype=None, max_points: int = 160):
        """Build from host CSR given the grid dims (lexicographic order).
        Returns None if the matrix has more than max_points distinct N-D
        offsets (not stencil-structured).  Tensors on the CPU."""
        dtype = dtype or torch.float32
        dims = tuple(int(d) for d in dims)
        n = int(np.prod(dims))
        if csr.shape != (n, n):
            return None
        rows = np.repeat(np.arange(n), csr.row_nnz)
        rc = np.stack(np.unravel_index(rows, dims), 1)  # (nnz, nd)
        cc = np.stack(np.unravel_index(csr.indices, dims), 1)
        uoff, inv = np.unique(cc - rc, axis=0, return_inverse=True)
        if len(uoff) > max_points:
            return None
        W = np.zeros((len(uoff), n), dtype=np.float64)
        W[inv.reshape(-1), rows] = csr.data
        return cls(
            weights=torch.from_numpy(W.reshape((len(uoff),) + dims)).to(dtype),
            offsets=tuple(tuple(int(c) for c in o) for o in uoff),
            dims=dims,
        )

    def to_csr(self):
        from parallel_amg_tpu_torch.ops.coo import COO

        W = self.weights.detach().cpu().float().numpy().reshape(self.n_points, -1)
        coords = np.stack(np.unravel_index(np.arange(self.n), self.dims), 1)
        rs, cs, vs = [], [], []
        for d, off in enumerate(self.offsets):
            nbr = coords + np.asarray(off)
            ok = np.all((nbr >= 0) & (nbr < np.asarray(self.dims)), axis=1)
            ok &= W[d] != 0
            rows = np.flatnonzero(ok)
            rs.append(rows)
            cs.append(np.ravel_multi_index(tuple(nbr[ok].T), self.dims))
            vs.append(W[d, rows])
        return COO(np.concatenate(rs), np.concatenate(cs), np.concatenate(vs),
                   (self.n, self.n)).to_csr()

    # -- tensor ops (N-D in, N-D out) --------------------------------------
    def _pads(self):
        return [(max(0, -min(o[i] for o in self.offsets)),
                 max(0, max(o[i] for o in self.offsets)))
                for i in range(len(self.dims))]

    def shifted(self, x):
        """x[p + offset] for each offset, zero outside the grid, in offset
        order: views of one padded copy of the N-D grid x."""
        pads = self._pads()
        xp = _pad_nd(x, pads)
        return [xp[tuple(slice(pads[i][0] + off[i], pads[i][0] + off[i] + n)
                         for i, n in enumerate(self.dims))] for off in self.offsets]

    def matvec(self, x):
        """y = A @ x for an N-D grid x of shape dims."""
        y = torch.zeros_like(x)
        for w, xs in zip(self.weights, self.shifted(x)):
            y = y + w * xs
        return y

    def matmat(self, X):
        """Y = A @ X for k right-hand sides, X of shape (*dims, k).

        On the CPU the plain version (``_matmat_plain``); on the card kernel
        B7 over ``flat_planes``, which gives the same sums because the planes
        there are zero wherever the neighbor leaves the grid, where the plain
        version reads zero padding.  Y is float32 on the card.
        """
        if X.device.type == "cpu":
            return self._matmat_plain(X)
        from parallel_amg_tpu_torch.ops.flatdia import dia_spmm

        planes, offsets = self.flat_planes()
        k = X.shape[-1]
        return dia_spmm(planes, offsets,
                        X.reshape(self.n, k).contiguous()).reshape(X.shape)

    def _matmat_plain(self, X):
        """Plain torch Y = A @ X: one padded copy of X, one shifted slice per
        plane, products and sums in offset order (the JAX package's
        ``Stencil.matmat``); any float type."""
        pads = self._pads()
        Xp = _pad_nd(X, pads + [(0, 0)])
        Y = torch.zeros_like(X)
        for d, off in enumerate(self.offsets):
            idx = tuple(slice(pads[i][0] + off[i], pads[i][0] + off[i] + n)
                        for i, n in enumerate(self.dims))
            Y = Y + self.weights[d][..., None].to(X.dtype) * Xp[idx]
        return Y

    def flat_planes(self):
        """(planes (D', n), sorted 1-D offsets): the flattened form of this
        stencil with every weight whose neighbor leaves the grid set to 0
        (where it is not 0 already) and aliased planes summed, as
        ``FlatDIA.from_stencil`` flattens.  Built once and kept: a Stencil's
        weights are not changed in place after it is built."""
        if self._flat is None:
            from parallel_amg_tpu_torch.ops.flatdia import FlatDIA

            ok = [self._in_grid(off) for off in self.offsets]
            off_grid = torch.stack([((w != 0) & ~m).any() for w, m in
                                    zip(self.weights, ok)]).any()
            st = self
            if bool(off_grid):  # one host read, once per Stencil
                st = Stencil(torch.stack([torch.where(m, w, 0.0) for w, m in
                                          zip(self.weights, ok)]),
                             self.offsets, self.dims)
            fd = FlatDIA.from_stencil(st)
            self._flat = (fd.diags.contiguous(), fd.offsets)
        return self._flat

    def _in_grid(self, off):
        """Bool grid: True where p + off lies on the grid."""
        m = torch.ones(self.dims, dtype=torch.bool, device=self.weights.device)
        for i, (c, n) in enumerate(zip(off, self.dims)):
            shape = [1] * len(self.dims)
            shape[i] = n
            p = torch.arange(n, device=self.weights.device).reshape(shape)
            m = m & (p + c >= 0) & (p + c < n)
        return m

    def diagonal(self):
        """Main diagonal as an N-D grid."""
        zero = tuple(0 for _ in self.dims)
        if zero in self.offsets:
            return self.weights[self.offsets.index(zero)]
        return torch.zeros(self.dims, dtype=self.weights.dtype,
                           device=self.weights.device)

    def __matmul__(self, x):
        return self.matvec(x)

    # -- stencil algebra (on-device setup path) ----------------------------
    def shifted_plane(self, d, off):
        """weights[d] translated by `off`: the value that row p+off sees from
        plane d of this operator (zeros shifted in at the boundary)."""
        return shift_nd(self.weights[d], tuple(-c for c in off), self.dims)

    def scale_rows(self, s):
        """diag(s) @ A — elementwise row scaling of every plane."""
        return Stencil(self.weights * s[None], self.offsets, self.dims)

    def scale_cols(self, s):
        """A @ diag(s): plane d scales by s shifted by its offset."""
        planes = [self.weights[d] * shift_nd(s, off, self.dims)
                  for d, off in enumerate(self.offsets)]
        return Stencil(torch.stack(planes), self.offsets, self.dims)

    def add(self, other, alpha=1.0):
        """A + alpha·B for stencils on the same grid (offset union)."""
        offs = sorted(set(self.offsets) | set(other.offsets))
        planes = []
        for o in offs:
            w = torch.zeros(self.dims, dtype=self.weights.dtype,
                            device=self.weights.device)
            if o in self.offsets:
                w = w + self.weights[self.offsets.index(o)]
            if o in other.offsets:
                w = w + alpha * other.weights[other.offsets.index(o)]
            planes.append(w)
        return Stencil(torch.stack(planes), tuple(offs), self.dims)

    def matmul(self, other: "Stencil") -> "Stencil":
        """C = A @ B in closed form: C[o1+o2](p) = Σ A[o1](p)·B[o2](p+o1).

        Per A-offset, all B planes shift in one slice of one padded buffer,
        and the products land in their output planes by ``bucket_add`` (for
        one A-offset the output offsets o1+o2 are distinct, so each is one
        exact add).
        """
        nd = len(self.dims)
        DB = other.n_points
        out_offs = sorted({tuple(o1[i] + o2[i] for i in range(nd))
                           for o1 in self.offsets for o2 in other.offsets})
        oidx = {o: i for i, o in enumerate(out_offs)}
        n = self.n
        r = [max(abs(o1[i]) for o1 in self.offsets) for i in range(nd)]
        wp = _pad_nd(other.weights, [(ri, ri) for ri in r])
        acc = torch.zeros((len(out_offs), n), dtype=self.weights.dtype,
                          device=self.weights.device)
        for d1, o1 in enumerate(self.offsets):
            idx = (slice(None),) + tuple(
                slice(r[i] + o1[i], r[i] + o1[i] + self.dims[i])
                for i in range(nd))
            terms = (self.weights[d1][None] * wp[idx]).reshape(DB, n)
            ids = [oidx[tuple(o1[i] + o2[i] for i in range(nd))]
                   for o2 in other.offsets]
            bucket_add(acc, ids, terms)
        return Stencil(acc.reshape((len(out_offs),) + self.dims),
                       tuple(out_offs), self.dims)

    def prune(self, keep_mask):
        """Host-driven plane pruning: keep_mask is a bool sequence."""
        keep = [d for d, k in enumerate(keep_mask) if k]
        return Stencil(self.weights[torch.as_tensor(keep,
                                                    device=self.weights.device)],
                       tuple(self.offsets[d] for d in keep), self.dims)
