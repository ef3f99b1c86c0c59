"""Hierarchy checkpoints and casts.

Counterpart of ``parallel_amg_tpu/utils/checkpoint.py``: a setup at 100M
DOF is worth keeping, so a hierarchy (or any graph of tensors, such as a
long CG's (x, r, k) state) saves to one file and loads back onto a device.
``save_pytree`` copies every tensor to the host and writes the graph with
``torch.save``; ``load_pytree`` reads it back onto ``device`` (the CUDA card
when None).  ``cast_hierarchy`` makes a lower-precision copy of a finished
hierarchy, as the JAX bench's ``tree_map(cast16, h)`` does, and
``load_hierarchy(path, dtype=)`` loads through it.  One-device hierarchies
only (``utils/tree.py``).
"""

from __future__ import annotations

import torch

from parallel_amg_tpu_torch.device import resolve_device
from parallel_amg_tpu_torch.utils.tree import map_tensors


def save_pytree(path: str, tree) -> None:
    """Write ``tree`` (tensors, port objects, containers) to ``path``."""
    torch.save(map_tensors(tree, lambda t: t.detach().cpu()), path)


def load_pytree(path: str, dtype=None, device=None):
    """Load a graph saved by ``save_pytree`` onto ``device`` (the CUDA card
    when None); with ``dtype``, floating tensors are cast to it."""
    dev = resolve_device(device)
    tree = torch.load(path, map_location=dev, weights_only=False)
    if dtype is None:
        return tree
    return map_tensors(tree, lambda t: t.to(dtype) if t.is_floating_point()
                       else t)


def cast_hierarchy(h, dtype=torch.bfloat16):
    """A copy of hierarchy ``h`` whose float32 tensors are ``dtype``, with
    ``lam_max`` and the block transfers' ``coef`` rounded to ``dtype``, as
    the JAX package's cast of every float32 leaf rounds them.  The coarse
    inverse stays float32: it is tiny, and the coarse solve runs in
    float32 whatever the levels' dtype."""
    from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy

    levels = map_tensors(
        h.levels, lambda t: t.to(dtype) if t.dtype == torch.float32 else t,
        scalars=lambda v: float(torch.tensor(v, dtype=torch.float32).to(dtype)))
    return Hierarchy(levels, h.coarse_inv.to(torch.float32), h.config)


def save_hierarchy(path: str, hierarchy) -> None:
    save_pytree(path, hierarchy)


def load_hierarchy(path: str, dtype=None, device=None):
    """Load a hierarchy onto ``device``; with ``dtype``, cast it by
    ``cast_hierarchy`` (coarse inverse kept float32)."""
    h = load_pytree(path, device=device)
    return h if dtype is None else cast_hierarchy(h, dtype)
