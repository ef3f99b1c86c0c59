"""2D convection-diffusion with first-order upwinding: the nonsymmetric
workload that CG cannot solve and AMG-preconditioned FGMRES can.

A numpy copy of ``parallel_amg_tpu/problems/convection.py``.  The operator
−Δu + (v·∇)u on the unit square, central 5-point diffusion and first-order
upwind convection, scaled by h², has per row

    diag   4 + pe_x + pe_y
    west   −1 − pe_x     east  −1        (for v_x > 0)
    south  −1 − pe_y     north −1        (for v_y > 0)

with pe_* = v_*·h the cell Péclet numbers supplied directly.  For pe ≫ 0 the
matrix is a strongly nonsymmetric M-matrix.
"""

from __future__ import annotations

import numpy as np

from parallel_amg_tpu_torch.ops.coo import COO


def convection2d(nx: int, ny: int | None = None, pe_x: float = 1.0,
                 pe_y: float = 0.5, row_range=None,
                 dtype=np.float64) -> COO:
    """Upwind convection-diffusion matrix, lexicographic (y fastest).

    pe_x/pe_y ≥ 0: cell Péclet numbers of the (positive) velocity field.
    ``row_range`` builds only rows [lo, hi).
    """
    assert pe_x >= 0 and pe_y >= 0, "upwinding assumes v ≥ 0 componentwise"
    ny = ny or nx
    n = nx * ny
    lo, hi = ((0, n) if row_range is None
              else (int(row_range[0]), int(row_range[1])))
    rows = np.arange(lo, hi, dtype=np.int64)
    ix, iy = rows // ny, rows % ny

    rs, cs = [rows], [rows]
    vs = [np.full(rows.shape, 4.0 + pe_x + pe_y, dtype=dtype)]
    for cond, off, w in (
        (ix > 0, -ny, -1.0 - pe_x),   # west (upwind for v_x > 0)
        (ix < nx - 1, ny, -1.0),      # east
        (iy > 0, -1, -1.0 - pe_y),    # south (upwind for v_y > 0)
        (iy < ny - 1, 1, -1.0),       # north
    ):
        r = rows[cond]
        rs.append(r)
        cs.append(r + off)
        vs.append(np.full(r.shape, w, dtype=dtype))
    return COO(np.concatenate(rs), np.concatenate(cs),
               np.concatenate(vs), (n, n))
