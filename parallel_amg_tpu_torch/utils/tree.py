"""Walks over the port's object graphs: hierarchies, levels, formats,
transfers and the plain containers that hold them.

The JAX package's hierarchy is a pytree that ``jax.tree_util`` flattens; the
port's is plain Python objects, so ``map_tensors`` rebuilds such a graph
with every tensor passed through a function (a shallow copy of each object,
the originals untouched), and ``tensors`` lists its tensors.  Attributes
whose names begin with ``_`` are caches built on first use (a TWELL's row
ids, a Stencil's flat planes); the rebuilt objects drop them.  A
distributed operator, whose parts live on a mesh, is refused.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch


def map_tensors(obj, fn, scalars=None):
    """``obj`` rebuilt with ``fn(t)`` for every tensor t in it; with
    ``scalars``, the float attributes ``lam_max`` and ``coef`` (the
    Chebyshev bound and the block transfers' ω/λ, which the JAX package
    keeps as array leaves) become ``scalars(value)``."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if (obj is None or isinstance(obj, (bool, int, float, complex, str, bytes,
                                        np.ndarray, np.generic))
            or dataclasses.is_dataclass(obj)):
        return obj
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return type(obj)(*(map_tensors(v, fn, scalars) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn, scalars) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn, scalars) for k, v in obj.items()}
    if hasattr(obj, "__dict__"):
        if hasattr(obj, "mesh"):
            raise TypeError(f"{type(obj).__name__} is split over a mesh; only "
                            "one-device objects are walked")
        new = copy.copy(obj)
        for k, v in vars(obj).items():
            if k.startswith("_"):
                v = None
            elif scalars is not None and k in ("lam_max", "coef") \
                    and isinstance(v, float):
                v = scalars(v)
            else:
                v = map_tensors(v, fn, scalars)
            setattr(new, k, v)
        return new
    return obj


def tensors(obj) -> list:
    """Every tensor in ``obj``, in walk order."""
    out = []

    def keep(t):
        out.append(t)
        return t

    map_tensors(obj, keep)
    return out
