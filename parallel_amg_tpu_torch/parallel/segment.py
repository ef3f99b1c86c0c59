"""Segment reductions in a fixed order, on any device.

The JAX package's ``jax.ops.segment_sum`` adds duplicates one after another
on its CPU backend.  ``index_add_`` on a CUDA tensor adds them with atomics in
no fixed order, so a setup run twice would differ in its last bits.  Here a
float segment sum sorts the ids stably and reduces each segment's values
left to right with ``torch.segment_reduce``: the same sum on every call and
on every device, equal to the sequential sum.  The values go in as one
(N, 1) column: for 1-D values torch's CUDA ``segment_reduce`` takes cub's
segmented tree reduction, whose order is not the sequential one; for 2-D
values it runs one thread per segment that adds left to right, as the CPU
does.  Maxima and minima are exact in any order and use ``scatter_reduce``.
"""

from __future__ import annotations

import torch


def segment_sum(vals, ids, n: int, sorted_ids: bool = False):
    """out[k] = Σ vals[i] over ids[i] == k, in the order of i; 0 where no id
    is k.  ``sorted_ids`` skips the sort when ids never decrease."""
    ids = ids.reshape(-1).long()
    vals = vals.reshape(-1)
    if not sorted_ids:
        ids, order = torch.sort(ids, stable=True)
        vals = vals[order]
    lengths = torch.bincount(ids, minlength=n)
    if lengths.numel() > n:
        raise ValueError(f"segment ids reach {lengths.numel() - 1} ≥ {n}")
    if vals.numel() == 0:
        return torch.zeros(n, dtype=vals.dtype, device=vals.device)
    return torch.segment_reduce(vals[:, None], "sum", lengths=lengths,
                                unsafe=True)[:, 0]


def segment_max(vals, ids, n: int, fill):
    """out[k] = max vals[i] over ids[i] == k; ``fill`` where no id is k."""
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids.reshape(-1).long(), vals.reshape(-1),
                               "amax", include_self=True)


def segment_min(vals, ids, n: int, fill):
    """out[k] = min vals[i] over ids[i] == k; ``fill`` where no id is k."""
    out = torch.full((n,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, ids.reshape(-1).long(), vals.reshape(-1),
                               "amin", include_self=True)
