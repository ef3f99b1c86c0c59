"""2D anisotropic diffusion operator −(u_xx + ε·u_yy) (acceptance config #4).

A numpy copy of ``parallel_amg_tpu/problems/anisotropic.py``.  The ε = 1e-3
stress test: the weak coupling in y makes naive coarsening fail, which
exercises strength-of-connection filtering and Chebyshev smoothing.
"""

from __future__ import annotations

import numpy as np

from parallel_amg_tpu_torch.ops.coo import COO


def anisotropic2d(nx: int, ny: int | None = None, epsilon: float = 1e-3,
                  row_range=None, dtype=np.float64) -> COO:
    """5-point FD discretization of −u_xx − ε·u_yy, Dirichlet boundaries.

    Grid numbered lexicographically with y fastest (stride_x = ny).
    Strong direction: x (weight 1); weak: y (weight ε).
    """
    ny = ny or nx
    n = nx * ny
    lo, hi = (0, n) if row_range is None else (int(row_range[0]), int(row_range[1]))
    rows = np.arange(lo, hi, dtype=np.int64)
    ix, iy = rows // ny, rows % ny

    rs, cs, vs = [rows], [rows], [np.full(rows.shape, 2.0 + 2.0 * epsilon, dtype=dtype)]
    for cond, off, w in (
        (ix > 0, -ny, -1.0),
        (ix < nx - 1, ny, -1.0),
        (iy > 0, -1, -epsilon),
        (iy < ny - 1, 1, -epsilon),
    ):
        r = rows[cond]
        rs.append(r)
        cs.append(r + off)
        vs.append(np.full(r.shape, w, dtype=dtype))
    return COO(np.concatenate(rs), np.concatenate(cs), np.concatenate(vs), (n, n))
