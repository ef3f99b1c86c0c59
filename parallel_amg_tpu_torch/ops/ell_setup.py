"""Device ELL setup operations: transpose, prune and SpGEMM.

Counterpart of ``parallel_amg_tpu/ops/ell_setup.py``.  They run once per
level of the on-device Ruge–Stüben setup, on the tensors' device; the host
reads only output widths.

- ``ell_transpose``: a stable sort of the entries by column, each entry's
  rank within its column, one scatter to unique slots.  The JAX package
  sends operands above 2^19 rows to a chunked transpose it never defines;
  this one takes any row count.
- ``ell_prune``: drop small entries and re-sort each row by column.
- ``ell_spgemm``: the rank-plane product of ``ops/gspgemm.py`` (kernels B3,
  B5, B4 on the card, their plain versions on the CPU) in the JAX package's
  ESC order of adds and sorted layout (``gspgemm.esc_spgemm``).
- ``ell_spgemm_pairwise``: ``gspgemm.gather_spgemm``'s three steps always
  in plain torch (expand, equality-matrix merge, first-occurrence
  compaction).
"""

from __future__ import annotations

import torch

from parallel_amg_tpu_torch.ops import gspgemm
from parallel_amg_tpu_torch.ops.ell import ELL


def ell_transpose(ell: ELL) -> ELL:
    """Aᵀ in ELL (one host read of the widest column).  Each output row
    lists its entries in ascending source row; values are copied exactly."""
    W = ell.width
    n_rows, n_cols = ell.shape
    dev = ell.cols.device
    valid = ell.mask().reshape(-1)
    cols = ell.cols.reshape(-1).long()
    key = torch.where(valid, cols, n_cols)
    counts = torch.bincount(key, minlength=n_cols + 1)[:n_cols]
    out_width = max(int(counts.max()) if n_cols else 0, 1)
    key_s, order = torch.sort(key, stable=True)
    idx = torch.arange(key_s.numel(), device=dev)
    is_first = torch.ones_like(valid)
    is_first[1:] = key_s[1:] != key_s[:-1]
    rank = idx - torch.cummax(torch.where(is_first, idx, 0), 0).values
    ok = key_s < n_cols
    t_cols = torch.zeros((n_cols, out_width), dtype=torch.int32, device=dev)
    t_vals = torch.zeros((n_cols, out_width), dtype=ell.vals.dtype, device=dev)
    src = order[ok]
    t_cols[key_s[ok], rank[ok]] = (src // W).to(torch.int32)
    t_vals[key_s[ok], rank[ok]] = ell.vals.reshape(-1)[src]
    return ELL(t_cols, t_vals, counts.to(torch.int32), (n_cols, n_rows))


def ell_prune(ell: ELL, tol: float = 0.0) -> ELL:
    """Drop entries with |v| ≤ tol and re-compact each row, sorted by
    column (one host read of the width)."""
    keep = ell.mask() & (ell.vals.abs() > tol)
    key = torch.where(keep, ell.cols, ell.n_cols)
    cols_s, order = torch.sort(key, dim=1, stable=True)
    vals_s = ell.vals.gather(1, order)
    row_nnz = keep.sum(1).to(torch.int32)
    out_width = max(int(row_nnz.max()) if row_nnz.numel() else 0, 1)
    cols_o, vals_o = cols_s[:, :out_width], vals_s[:, :out_width]
    w_iota = torch.arange(cols_o.shape[1], device=ell.cols.device)
    pad = w_iota[None, :] >= row_nnz[:, None]
    return ELL(torch.where(pad, 0, cols_o).to(torch.int32),
               torch.where(pad, 0.0, vals_o), row_nnz, ell.shape)


def ell_spgemm(A: ELL, B: ELL, out_width: int | None = None,
               strict: bool = True, sort: bool = True) -> ELL:
    """C = A @ B in ELL (``gspgemm.esc_spgemm``), bit-equal to the JAX
    package's ``ell_spgemm`` on its CPU backend; one host read for the
    width unless ``out_width`` is given.  Columns come sorted (in k-major
    first-occurrence order with ``sort=False``); explicit zeros drop.  An
    explicit ``out_width`` below a row's column count raises with
    ``strict=True`` and clamps the row otherwise."""
    return gspgemm.esc_spgemm(A, B, out_width=out_width, strict=strict,
                              sort=sort)


def ell_spgemm_pairwise(A: ELL, B: ELL, out_width: int | None = None,
                        strict: bool = True) -> ELL:
    """C = A @ B by the plain torch versions of the three steps on any
    device (``gspgemm.plain_spgemm``): gather, equality-matrix merge,
    first-occurrence compaction.  Same result as ``gspgemm.gather_spgemm``
    up to the order of each leader's sum."""
    return gspgemm.plain_spgemm(A, B, out_width=out_width, strict=strict)
