"""Device-native problem generators: Stencil weight planes born on the device.

Counterpart of ``parallel_amg_tpu/problems/stencil_problems.py``: the
(D, *dims) planes are built from broadcast index masks on ``device``, so a
128³ operator never passes through a host COO.  The planes equal the JAX
package's bit for bit.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from parallel_amg_tpu_torch.device import resolve_device
from parallel_amg_tpu_torch.ops.stencil import Stencil


def _axis_mask(dims, axis, sgn, dtype, device):
    """1 where the neighbor at offset sgn along axis exists, else 0."""
    shape = [1] * len(dims)
    shape[axis] = dims[axis]
    idx = torch.arange(dims[axis], device=device).reshape(shape)
    ok = idx < dims[axis] - 1 if sgn > 0 else idx > 0
    return ok.to(dtype).expand(dims)


def _sorted_stencil(offsets, planes, dims) -> Stencil:
    order = sorted(range(len(offsets)), key=lambda i: offsets[i])
    return Stencil(torch.stack([planes[i] for i in order]),
                   tuple(offsets[i] for i in order), dims)


def poisson_stencil(dims, dtype=torch.float32, device=None) -> Stencil:
    """N-D (2N+1)-point Dirichlet Laplacian as a Stencil on ``device``
    (the CUDA card when None): diagonal 2N, −1 where the neighbor exists."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    nd = len(dims)
    offsets = [tuple(0 for _ in dims)]
    planes = [torch.full(dims, 2.0 * nd, dtype=dtype, device=dev)]
    for axis in range(nd):
        for sgn in (-1, 1):
            offsets.append(tuple(sgn if i == axis else 0 for i in range(nd)))
            planes.append(-_axis_mask(dims, axis, sgn, dtype, dev))
    return _sorted_stencil(offsets, planes, dims)


def anisotropic_stencil(dims, epsilon: float = 1e-3, dtype=torch.float32,
                        device=None) -> Stencil:
    """2D anisotropic −u_xx − ε·u_yy operator as a Stencil on ``device``
    (y is the second, fast axis)."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    if len(dims) != 2:
        raise ValueError(f"anisotropic_stencil is 2-D, got dims {dims}")
    offsets = [(0, 0)]
    planes = [torch.full(dims, 2.0 + 2.0 * epsilon, dtype=dtype, device=dev)]
    for axis, w in ((0, 1.0), (1, epsilon)):
        for sgn in (-1, 1):
            offsets.append(tuple(sgn if i == axis else 0 for i in range(2)))
            planes.append(-w * _axis_mask(dims, axis, sgn, dtype, dev))
    return _sorted_stencil(offsets, planes, dims)


def seeded_stencil(dims, points: int, seed: int):
    """A seeded 2-D or 3-D operator for holding power iterations: numpy
    float32 weights (points, *dims) and the offsets (``points`` 5 or 9 in
    2-D, 7 or 27 in 3-D, sorted), off the centre uniform in [−1, 1) and the
    centre uniform in [4, 8), from ``np.random.default_rng(seed)`` (the
    off-centre planes drawn first).  numpy arrays, so that the JAX package
    and the port take the same bits on any machine."""
    dims = tuple(int(d) for d in dims)
    nd = len(dims)
    if nd not in (2, 3) or points not in (2 * nd + 1, 3 ** nd):
        raise ValueError(f"seeded_stencil is 2-D with 5 or 9 points or 3-D with 7 or 27, "
                         f"not {dims}, {points}")
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=nd)
                 if points == 3 ** nd or sum(map(abs, o)) <= 1)
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims).astype(np.float32)
    w[offs.index((0,) * nd)] = rng.uniform(4.0, 8.0, size=dims).astype(np.float32)
    return w, offs
