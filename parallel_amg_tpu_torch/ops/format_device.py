"""Solve-format conversion on the device: ELL → DIA or TWELL.

Counterpart of ``parallel_amg_tpu/ops/format_device.py``.  The on-device
setup leaves every level operator as ELL planes; these functions turn them
into the solve formats without moving the planes to the host (only the
diagonal count, the ≤ 192 offsets, the entry count and the TWELL plan's
block count are read back).

- :func:`dia_from_ell`: banded square operators → (D, n) diagonals.
  Entries of one (row, column) sum, as in CSR.
- :func:`twell_from_ell`: any operator → TWELL, whose port is int32 CSR
  (``ops/twell.py``): ``indptr = cumsum(row_nnz)`` and each row's columns
  sorted.  The JAX package's piece-table cost model (``_TUNE_SPACE``) shapes
  the TPU layout and has no counterpart; the TWELL constructor builds the
  kernel's row-block plan (``twell.row_blocks``) on the device.
- :func:`best_format_from_ell`: the policy of ``ops/select.py``.
"""

from __future__ import annotations

import torch

from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.select import DIA_MAX_DIAGS, prefer_dia
from parallel_amg_tpu_torch.ops.twell import TWELL


def dia_from_ell(ell: ELL, max_diags: int = DIA_MAX_DIAGS):
    """(DIA, nnz) of a square ELL, or (None, nnz) past ``max_diags``
    diagonals; (None, None) for a rectangular one."""
    if ell.n_rows != ell.n_cols:
        return None, None
    n, W = ell.cols.shape
    valid = ell.mask()
    rows = torch.arange(n, device=ell.cols.device)[:, None]
    off = ell.cols.long() - rows
    nnz = int(valid.sum())
    uoffs = torch.unique(off[valid])
    if uoffs.numel() > max_diags:
        return None, nnz
    d_idx = torch.searchsorted(uoffs, off).clamp(max=max(uoffs.numel() - 1, 0))
    vals = torch.where(valid, ell.vals, 0.0)
    diags = torch.zeros((uoffs.numel(), n), dtype=ell.vals.dtype,
                        device=ell.vals.device)
    r = rows[:, 0]
    for w in range(W if uoffs.numel() else 0):
        # one entry per row per slot: no target repeats within a call, so
        # duplicates sum exactly, in slot order
        diags.index_put_((d_idx[:, w], r), vals[:, w], accumulate=True)
    return DIA(diags, tuple(uoffs.tolist()), ell.shape), nnz


def twell_from_ell(ell: ELL, dtype=None) -> TWELL:
    """TWELL (int32 CSR) of any ELL, each row sorted by column."""
    valid = ell.mask()
    key = torch.where(valid, ell.cols, ell.n_cols)
    cols_s, order = torch.sort(key, dim=1, stable=True)
    vals_s = ell.vals.gather(1, order)
    indptr = torch.zeros(ell.n_rows + 1, dtype=torch.int32,
                         device=ell.cols.device)
    indptr[1:] = ell.row_nnz.cumsum(0)
    keep = torch.arange(ell.width, device=ell.cols.device)[None, :] \
        < ell.row_nnz[:, None]
    vals = vals_s[keep]
    if dtype is not None:
        vals = vals.to(dtype)
    return TWELL(indptr, cols_s[keep].to(torch.int32), vals, ell.shape)


def best_format_from_ell(T):
    """Solve format of one operator: DIA for a banded square ELL (the rule
    of ``ops/select.py``), TWELL for any other ELL; anything else as is."""
    if not isinstance(T, ELL):
        return T
    dia, nnz = dia_from_ell(T)
    if dia is not None and prefer_dia(nnz, dia.n_diags, T.n_rows):
        return dia
    return twell_from_ell(T)
