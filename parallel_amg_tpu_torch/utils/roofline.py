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

``cycle_collective_volume`` counts a row-sharded V-cycle's halo bytes and
depends on no hardware.  The latency and scaling projections built on it
(``cycle_latency_model``, ``scaling_projection``,
``weak_scaling_projection``) take the JAX package's arithmetic and return
keys, but not its constants: the link rate and the per-collective latency
are the caller's, required keyword arguments with no default.  The JAX
package's defaults are a TPU interconnect's figures; no H100 figure has been
measured (one card has no link), so the port states none.  They read only a
hierarchy's levels' ``dims`` and ``offsets`` and its ``config``, so they
take the one-device and the sharded structured hierarchies alike.
"""

from __future__ import annotations

import dataclasses
import math

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


def cycle_latency_model(hierarchy, n_shards: int, agglomerate_n: int = 2048, *,
                        link_gbps: float, latency_s: float) -> dict:
    """``cycle_collective_volume`` with each message's latency and the
    coarse boundary, per V-cycle and part: each sharded level's
    ``matvecs_per_cycle`` halo exchanges (a pair of messages on two links
    at once: one latency each) over ``link_gbps`` GB/s; at the
    agglomeration boundary one all-gather of the first replicated level
    (⌈log2 N⌉ hops of ``latency_s``, (N−1)/N·n·4 bytes); and, per CG
    iteration, two all-reduced dots (⌈log2 N⌉ hops each, latency only).
    ``link_gbps`` and ``latency_s`` are the caller's (the module's
    docstring); the result's ``constants`` repeats them under the JAX
    package's key names."""
    vol = cycle_collective_volume(hierarchy, n_shards, agglomerate_n)
    n_msgs = 0
    t_bw = 0.0
    boundary_n = 0
    for lv in vol["levels"]:
        if lv.get("replicated"):
            if boundary_n == 0:
                boundary_n = lv["n"]
            continue
        n_msgs += lv["matvecs_per_cycle"]
        t_bw += lv["cycle_bytes"] / (link_gbps * 1e9)
    hops = max(int(math.ceil(math.log2(max(n_shards, 2)))), 1)
    t_lat_halo = n_msgs * latency_s
    t_gather = (hops * latency_s
                + (boundary_n * 4 * (n_shards - 1) / n_shards)
                / (link_gbps * 1e9)) if boundary_n else 0.0
    t_dots = 2 * hops * latency_s
    return {
        **vol,
        "constants": {"ici_gbps": link_gbps, "collective_latency_s": latency_s},
        "halo_messages_per_cycle": n_msgs,
        "t_halo_bw_s": t_bw,
        "t_halo_latency_s": t_lat_halo,
        "t_boundary_allgather_s": t_gather,
        "t_cycle_comm_s": t_bw + t_lat_halo + t_gather,
        "t_cg_dots_per_iter_s": t_dots,
    }


def scaling_projection(hierarchy, vcycle_s: float, shard_counts,
                       agglomerate_n: int = 2048, *, link_gbps: float,
                       latency_s: float) -> list:
    """Projected strong-scaling efficiency of the V-cycle at each part
    count N: a measured one-device cycle of ``vcycle_s`` split ideally, plus
    ``cycle_latency_model``'s communication at N; efficiency T1/N ÷ (T1/N
    + Tcomm).  A model, not a measurement: each row carries its
    constants."""
    rows = []
    for N in shard_counts:
        m = cycle_latency_model(hierarchy, N, agglomerate_n, link_gbps=link_gbps,
                                latency_s=latency_s)
        t_comp = vcycle_s / N
        rows.append({
            "n_shards": N,
            "mode": "strong",
            "t_compute_s": t_comp,
            "t_comm_s": m["t_cycle_comm_s"],
            "t_halo_bw_s": m["t_halo_bw_s"],
            "t_halo_latency_s": m["t_halo_latency_s"],
            "t_boundary_allgather_s": m["t_boundary_allgather_s"],
            "projected_efficiency": t_comp / (t_comp + m["t_cycle_comm_s"]),
            "constants": m["constants"],
        })
    return rows


def weak_scaling_projection(hierarchy, vcycle_s: float, shard_counts,
                            agglomerate_n: int = 2048, *, link_gbps: float,
                            latency_s: float, scale_rows_to: int | None = None) -> list:
    """Projected weak-scaling efficiency at a constant load per part:
    ``hierarchy`` and ``vcycle_s`` are one part's problem, and the global
    grid grows N-fold along axis 0.  Compute stays ``vcycle_s``; a level
    whose global size N·n passes the agglomeration threshold pays its halo
    exchanges (its boundary planes, constant in N); the levels below are
    replicated behind one all-gather (⌈log2 N⌉ hops, at most the
    threshold·4 bytes).  ``scale_rows_to`` extrapolates the measured part
    to that many rows (compute ∝ n, a 3-D block's boundary ∝ n^(2/3)); its
    rows say ``extrapolated``."""
    base_rows = None
    t_scale = b_scale = 1.0
    if scale_rows_to is not None:
        for l in hierarchy.levels:
            A = l.A
            base_rows = (int(np.prod(A.dims)) if hasattr(A, "dims")
                         and A.dims is not None else A.n_rows)
            break
        ratio = scale_rows_to / base_rows
        t_scale = ratio
        b_scale = ratio ** (2 / 3)
    cfg = getattr(hierarchy, "config", None)
    nu = (cfg.nu_pre + cfg.nu_post) if cfg else 2
    deg = cfg.cheb_degree if (cfg and cfg.smoother == "chebyshev") else 1
    matvecs = deg * nu + 1
    rows = []
    for N in shard_counts:
        n_msgs = 0
        t_bw = 0.0
        boundary_global_n = 0
        for l in hierarchy.levels:
            A = l.A
            if not hasattr(A, "dims") or not hasattr(A, "offsets") \
                    or A.dims is None:
                continue
            n = int(np.prod(A.dims))
            if N * n * t_scale <= agglomerate_n:
                if boundary_global_n == 0:
                    boundary_global_n = int(N * n * t_scale)
                continue
            h = _axis0_reach(A)
            plane = int(np.prod(A.dims[1:])) if len(A.dims) > 1 else 1
            n_msgs += matvecs
            t_bw += (2 * h * plane * 4 * b_scale * matvecs) / (link_gbps * 1e9)
        hops = max(int(math.ceil(math.log2(max(N, 2)))), 1)
        t_gather = (hops * latency_s
                    + boundary_global_n * 4 * (N - 1) / N
                    / (link_gbps * 1e9)) if boundary_global_n else 0.0
        t_comm = t_bw + n_msgs * latency_s + t_gather
        t_comp = vcycle_s * t_scale
        rows.append({
            "n_shards": N,
            "mode": "weak",
            "per_shard_rows": int((base_rows or 0) * t_scale) or None,
            "extrapolated": scale_rows_to is not None,
            "t_compute_s": t_comp,
            "t_comm_s": t_comm,
            "t_halo_bw_s": t_bw,
            "t_halo_latency_s": n_msgs * latency_s,
            "t_boundary_allgather_s": t_gather,
            "projected_efficiency": t_comp / (t_comp + t_comm),
            "constants": {"ici_gbps": link_gbps, "collective_latency_s": latency_s},
        })
    return rows
