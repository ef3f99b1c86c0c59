"""Distributed vectors — the PVector analog (SURVEY.md §2.1).

Counterpart of ``parallel_amg_tpu/parallel/pvector.py``.  A distributed
vector of the algebraic path is a 1-D :class:`PGrid`: part p holds rows
[p·m, (p+1)·m) of the padded global vector (``Partition.n_padded`` rows) on
``mesh.device(p)``, in the process that holds part p, so elementwise
arithmetic runs part by part and ``dot`` and ``norm`` reduce the per-part
partials through ``exchange.psum``, the same value on every process.  These
helpers handle the host boundary (padding, splitting, unpadding).
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.parallel.partition import Partition
from parallel_amg_tpu_torch.parallel.pgrid import PGrid


def pvector(x_host, partition: Partition, mesh, dtype=torch.float32) -> PGrid:
    """Pad a host (n_global,) vector to (n_padded,) and split it over the
    mesh's parts."""
    x = np.asarray(x_host)
    pad = partition.n_padded - x.shape[0]
    if pad < 0:
        raise ValueError(f"vector of {x.shape[0]} rows exceeds the partition's "
                         f"{partition.n_padded}")
    if pad:
        x = np.concatenate([x, np.zeros((pad,), x.dtype)])
    if mesh.size != partition.n_shards:
        raise ValueError(f"a partition of {partition.n_shards} parts on a mesh "
                         f"of {mesh.size}")
    return PGrid.from_global(torch.from_numpy(np.ascontiguousarray(x)).to(dtype),
                             mesh)


def to_global(x: PGrid, partition: Partition) -> np.ndarray:
    """Fetch a split padded vector to the host (on every process) and strip
    the padding."""
    return x.to_global("cpu").numpy()[: partition.n_global]


def dot(x: PGrid, y: PGrid):
    """Distributed dot product: per-part partials summed in part order."""
    return x.dot(y)


def norm(x: PGrid):
    return x.norm()
