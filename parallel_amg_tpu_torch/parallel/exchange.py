"""The exchange between the parts of a row mesh, in one place.

Every collective of the JAX package's algebraic distributed layer
(``lax.all_to_all``, the ``ppermute`` ring shifts and ``psum``) goes through
the three functions of this module.  The port is one process that holds
every part (``parallel/mesh.py``): where all parts share one device, each
function is one stack or one gather on it; parts on several devices move by
plain ``.to(device)`` copies.  A multi-process run would swap these three
for ``torch.distributed`` calls and touch nothing else.
"""

from __future__ import annotations

import torch


def _one_device(tensors) -> bool:
    dev = tensors[0].device
    return all(t.device == dev for t in tensors)


def all_to_all(bufs):
    """``lax.all_to_all(..., 0, 0, tiled=True)`` over the parts.

    ``bufs[s]`` is part s's (S, ...) send buffer, row d going to part d.
    Returns ``recv`` with ``recv[d][s] = bufs[s][d]``, each on part d's
    device.
    """
    S = len(bufs)
    if _one_device(bufs):
        return list(torch.stack(bufs, 1).unbind(0))
    return [torch.stack([bufs[s][d].to(bufs[d].device) for s in range(S)])
            for d in range(S)]


def ring_shift(bufs, d: int):
    """``ppermute`` with the ring shift (i → (i + d) mod S): part j receives
    ``bufs[(j − d) mod S]``, on part j's device."""
    S = len(bufs)
    return [bufs[(j - d) % S].to(bufs[j].device) for j in range(S)]


def psum(parts):
    """Σ over the parts, on part 0's device (the stack summed in part
    order, so a float sum is the same on every call)."""
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts]).sum(0)
