"""Roofline accounting: per-format traffic models of the port's SpMVs and
achieved-bandwidth reports, and the static halo-traffic model of a
row-sharded V-cycle.

Counterpart of ``parallel_amg_tpu/utils/roofline.py``.  The traffic models
count the port's layouts, not the TPU's (whose TWELL reads 128-lane x slabs
copied 8× across sublanes): each input read once, each output written once,
the bytes ``chip_smoke.py`` charges each kernel for its bound.

- TWELL (B1, CSR stream): (n_rows+1)·4 + nnz·(4 + value bytes) + n_cols·4
  + n_rows·4
- DIA / FlatDIA (B2) and Stencil: D·n·(value bytes) + 2·n·4; with k
  right-hand sides (B7) D·n·(value bytes) + 2·n·k·4
- ELL: R·W·(4 + value bytes) + n_cols·4 + n_rows·4
- BSR / BTWELL (B6): live blocks·(4 + bs²·value bytes) + block rows·4
  + n_cols·4 + n_rows·4

The JAX package's latency and scaling projections (``cycle_latency_model``,
``scaling_projection``, ``weak_scaling_projection``) are not here: their
constants are a TPU interconnect's, and they wait for the port's
distributed algebraic layer.  ``cycle_collective_volume`` counts bytes
only and depends on no hardware.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RooflineReport:
    op: str
    n: int
    nnz: int
    bytes_model: int
    time_s: float
    achieved_gbps: float
    achieved_gnnz_s: float
    sol_gbps: float
    sol_fraction: float

    def row(self) -> str:
        return (f"{self.op:28s} n={self.n:>12,} nnz={self.nnz:>14,} "
                f"{self.time_s*1e6:9.1f} µs {self.achieved_gbps:8.1f} GB/s "
                f"{self.achieved_gnnz_s:7.2f} Gnnz/s "
                f"{100*self.sol_fraction:6.1f}% of SoL")


def spmv_bytes(op, k: int = 1) -> int:
    """Bytes one y = A·x (k = 1) or Y = A·X (k columns, the stencil
    formats only) must move: each input read once, each output written
    once."""
    name = type(op).__name__
    if k != 1 and name not in ("Stencil", "FlatDIA", "DIA"):
        raise ValueError(f"no multi-column traffic model for {name}")
    if name == "Stencil":
        return op.n_points * op.n * op.weights.element_size() + 2 * op.n * k * 4
    if name in ("FlatDIA", "DIA"):
        n = op.n_rows
        return len(op.offsets) * n * op.diags.element_size() + 2 * n * k * 4
    if name == "TWELL":
        return ((op.n_rows + 1) * 4 + op.nnz * (4 + op.vals.element_size())
                + op.n_cols * 4 + op.n_rows * 4)
    if name == "ELL":
        r, w = op.cols.shape
        return r * w * (4 + op.vals.element_size()) + (op.n_cols + op.n_rows) * 4
    if name in ("BSR", "BTWELL"):
        n_live = int(op.brow_nnz.long().sum())
        return (n_live * (4 + op.bs * op.bs * op.vals.element_size())
                + op.n_block_rows * 4 + op.n_block_cols * op.bs * 4
                + op.n_block_rows * op.bs * 4)
    if name == "BSRGridOperator":
        return spmv_bytes(op.bsr)
    raise ValueError(f"no traffic model for {name}")


def report(op, time_s: float, sol_gbps: float, label: str | None = None
           ) -> RooflineReport:
    """One SpMV's achieved rate against ``sol_gbps`` (a rate measured on
    the same card, such as its device-to-device copy)."""
    b = spmv_bytes(op)
    nnz = int(op.nnz)
    n = op.n_rows if hasattr(op, "n_rows") else int(np.prod(op.dims))
    gbps = b / time_s / 1e9
    return RooflineReport(
        op=label or type(op).__name__,
        n=n,
        nnz=nnz,
        bytes_model=b,
        time_s=time_s,
        achieved_gbps=gbps,
        achieved_gnnz_s=nnz / time_s / 1e9,
        sol_gbps=sol_gbps,
        sol_fraction=gbps / sol_gbps if sol_gbps else 0.0,
    )


def _axis0_reach(A) -> int:
    """Axis-0 halo reach of a structured operator.

    N-D tuple offsets (Stencil, ShardedStencil) give it directly; flat 1-D
    offsets (FlatDIA, e.g. after ``with_spmv_backend(h, "pallas")``) take
    the recorded N-D offsets where there are any, else round against the
    axis-0 stride (exact whenever the in-plane reach is below stride0/2).
    """
    offs = A.offsets
    first = offs[0]
    if isinstance(first, (tuple, list, np.ndarray)):
        return max(abs(int(o[0])) for o in offs)
    nd = getattr(A, "nd_offsets", None)
    if nd is not None:
        return max(abs(int(o[0])) for o in nd)
    stride0 = int(np.prod(A.dims[1:])) if len(A.dims) > 1 else 1
    return max(int(round(abs(int(o)) / stride0)) for o in offs)


def cycle_collective_volume(hierarchy, n_shards: int,
                            agglomerate_n: int = 2048) -> dict:
    """Static per-V-cycle halo traffic of a row-sharded run, per part.

    For each structured level one halo exchange moves 2·h·plane·4 bytes
    per part (both directions), and a V(nu_pre, nu_post) cycle with a
    degree-d Chebyshev smoother does d·(nu_pre+nu_post)+1 halo'd matvecs
    per level.  Levels at or below the agglomeration threshold are
    gathered and move nothing; block transfers are local to a part.
    """
    cfg = getattr(hierarchy, "config", None)
    nu = (cfg.nu_pre + cfg.nu_post) if cfg else 2
    deg = cfg.cheb_degree if (cfg and cfg.smoother == "chebyshev") else 1
    matvecs = deg * nu + 1
    levels = []
    total = 0
    for l in hierarchy.levels:
        A = l.A
        if not hasattr(A, "dims") or not hasattr(A, "offsets") \
                or A.dims is None:
            continue
        n = int(np.prod(A.dims))
        if n <= agglomerate_n or A.dims[0] < n_shards:
            levels.append({"n": n, "halo_bytes_per_matvec": 0,
                           "replicated": True})
            continue
        h = _axis0_reach(A)
        plane = int(np.prod(A.dims[1:])) if len(A.dims) > 1 else 1
        per_mv = 2 * h * plane * 4  # both directions, f32
        levels.append({"n": n, "halo": h,
                       "halo_bytes_per_matvec": per_mv,
                       "matvecs_per_cycle": matvecs,
                       "cycle_bytes": per_mv * matvecs,
                       "replicated": False})
        total += per_mv * matvecs
    return {"n_shards": n_shards, "per_shard_cycle_bytes": total,
            "levels": levels}
