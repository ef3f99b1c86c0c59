"""Storage-format selection for the solve path.

Same DIA rule as ``parallel_amg_tpu/ops/select.py``: DIA when the matrix is
square and banded with a bounded diagonal count (shifted contiguous reads,
no gather), otherwise TWELL.  Unlike the JAX package, which falls back to ELL
off the TPU because its Pallas interpreter is slow, TWELL is chosen on every
device: on a CPU tensor its matvec runs the plain torch version, so the CPU
tests walk the same format choice as the card.
"""

from __future__ import annotations

import torch

from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.twell import TWELL

DIA_MAX_DIAGS = 192


def prefer_dia(nnz: int, n_diags: int, n_rows: int) -> bool:
    """DIA unless the band is mostly empty (traffic blow-up): the D·n
    values stored against the nnz actual."""
    fill = nnz / max(n_diags * n_rows, 1)
    return fill > 0.15 or n_diags <= 32


def best_format(csr, dtype=torch.float32):
    """Pick the solve format for a host CSR matrix (tensors on the CPU)."""
    n_rows, n_cols = csr.shape
    if n_rows == n_cols:
        dia = DIA.from_csr(csr, dtype=dtype, max_diags=DIA_MAX_DIAGS)
        if dia is not None and prefer_dia(csr.nnz, dia.n_diags, n_rows):
            return dia
    return TWELL.from_csr(csr, dtype=dtype)
