"""Distributed COO→PCSR assembly on the host — the ``psparse`` analog
(SURVEY.md §3.4).

Counterpart of ``parallel_amg_tpu/parallel/assembly.py``.  Triplets may
reference any (i, j), including rows owned by other parts and duplicate
entries (finite-element assembly semantics): duplicates sum, and off-owner
contributions land at the owning part.  The routing and dedup run in host
numpy (the sort-based ``COO.to_csr``); the PCSR then carries the static
halo plans.  ``passembly_device.pcsr_from_coo_device`` does the same on the
parts' devices.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.ops.coo import COO
from parallel_amg_tpu_torch.parallel.partition import Partition
from parallel_amg_tpu_torch.parallel.pcsr import PCSR


def pcsr_from_coo(rows, cols, vals, shape, mesh,
                  col_partition: Partition | None = None,
                  dtype=None, pad_identity: bool = True) -> PCSR:
    """Assemble a distributed PCSR from (i, j, v) triplets.

    Mirrors PartitionedArrays' ``psparse`` surface: duplicate and off-owner
    entries are legal and are summed at the owning row.
    """
    coo = COO(np.asarray(rows), np.asarray(cols), np.asarray(vals),
              tuple(shape))
    return PCSR.from_csr(coo.to_csr(), mesh, col_partition=col_partition,
                         dtype=dtype or torch.float32,
                         pad_identity=pad_identity)
