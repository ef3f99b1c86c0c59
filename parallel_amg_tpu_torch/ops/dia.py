"""DIA (diagonal) sparse format over torch tensors.

Counterpart of ``parallel_amg_tpu/ops/dia.py``.  Banded matrices (the Poisson
fine levels, the Ruge–Stüben coarse levels that pass the DIA rule) apply as
``y = Σ_d diag_d ⊙ shift(x, off_d)``.  The diagonals are FlatDIA's (D, n)
layout, so ``matvec`` is ``flatdia.dia_spmv``: one launch of kernel B2 on a
CUDA tensor, where the JAX package leaves DIA to XLA (one pass per
diagonal), and the plain shifted-slice loop on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from parallel_amg_tpu_torch.ops.flatdia import dia_spmv


class DIA:
    """Diagonal-storage sparse matrix (square).

    Attributes:
      diags: (D, n) float — diags[d, r] = A[r, r + offsets[d]] (0 outside).
      offsets: tuple of D ints, sorted.
      shape: (n, n).
    """

    def __init__(self, diags, offsets, shape):
        self.diags = diags
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)

    def to(self, device) -> "DIA":
        return DIA(self.diags.to(device), self.offsets, self.shape)

    # -- properties -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def n_diags(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int((self.diags != 0).sum())

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_csr(cls, csr, dtype=None, max_diags: int = 64):
        """Build from host CSR; returns None if the matrix is not square or
        has more than max_diags distinct diagonals (the caller picks another
        format)."""
        dtype = dtype or torch.float32
        n, m = csr.shape
        if n != m:
            return None
        rows = np.repeat(np.arange(n), csr.row_nnz)
        offs = csr.indices - rows
        uoffs = np.unique(offs)
        if len(uoffs) > max_diags:
            return None
        diags = np.zeros((len(uoffs), n), dtype=np.float64)
        diags[np.searchsorted(uoffs, offs), rows] = csr.data
        return cls(
            diags=torch.from_numpy(diags).to(dtype),
            offsets=tuple(int(o) for o in uoffs),
            shape=(n, m),
        )

    def to_csr(self):
        from parallel_amg_tpu_torch.ops.coo import COO

        n = self.n_rows
        diags = self.diags.cpu().float().numpy()
        rs, cs, vs = [], [], []
        for d, off in enumerate(self.offsets):
            r = np.arange(max(0, -off), min(n, n - off))
            keep = diags[d, r] != 0
            rs.append(r[keep])
            cs.append(r[keep] + off)
            vs.append(diags[d, r[keep]])
        return COO(
            np.concatenate(rs), np.concatenate(cs), np.concatenate(vs), self.shape
        ).to_csr()

    # -- tensor ops -------------------------------------------------------
    def _pad(self):
        return max(0, -min(self.offsets)), max(0, max(self.offsets))

    def matvec(self, x):
        """y = A @ x: kernel B2 (``flatdia.dia_spmv``, one launch) on a CUDA
        tensor, shifted contiguous slices of one padded x on the CPU."""
        return dia_spmv(self.diags, self.offsets, x)

    def matmat(self, X):
        """Y = A @ X for dense (n, k) X — k columns share each shifted pass."""
        n = self.n_rows
        lo, hi = self._pad()
        Xp = F.pad(X, (0, 0, lo, hi))
        Y = torch.zeros_like(X)
        for d, off in enumerate(self.offsets):
            Y = Y + self.diags[d][:, None] * Xp[lo + off:lo + off + n]
        return Y

    def diagonal(self):
        if 0 in self.offsets:
            return self.diags[self.offsets.index(0)]
        return torch.zeros(self.n_rows, dtype=self.diags.dtype,
                           device=self.diags.device)

    def __matmul__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)
