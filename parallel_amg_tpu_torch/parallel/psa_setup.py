"""Distributed algebraic smoothed-aggregation setup over PCSR parts, on the
parts' devices.

Counterpart of ``parallel_amg_tpu/parallel/psa_setup.py``: the parallel
Vanek substitution of ``amg/device_sa.py`` — distance-2 Luby-MIS seeding and
strongest-connection attachment — part by part with ghost exchange over the
PCSR halo plan, so no host-global matrix exists in the call graph.

Communication pattern:
- SA strength: one ghost fetch of the diagonal (the symmetric
  |a_ij| ≥ θ√(a_ii·a_jj) test needs d_j for halo columns);
- distance-2 MIS: per Luby round, four ghost fetches (candidate weights,
  one-hop maxima, new-seed flags, one-hop reach), then one host read of the
  candidate count;
- attachment: one ghost fetch of aggregate ids per phase (two phases);
- tentative/smoothed P, Galerkin: the transpose and the B3/B5/B4 products of
  ``prs_setup``.

Strength and attachment traverse OUT-edges only, which equals the full
adjacency when A's sparsity pattern is symmetric (SA's SPD setting).
Diagonal-only rows do not aggregate: they stay inert identity rows.
Aggregate numbering is part-padded (owner s's k-th seed → s·mc_pad+k).

The MIS weights are ``ops/prng.permutation``, the JAX package's
``jax.random.permutation`` draw, so seeds and aggregates equal the JAX
package's.  Attachment takes the first maximum among equal strengths
(``torch.argmax``, as ``jnp.argmax``).
"""

from __future__ import annotations

from typing import List

import torch

from parallel_amg_tpu_torch.amg.device_rs import _Clock
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import prng
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.prs_setup import (
    _NEG,
    _assemble_grow,
    _d_inv,
    _ensure_diag,
    _fetch,
    _pcsr_lambda_max,
    _r_iota,
    coarse_inverse_from_triplets,
    coarse_numbering,
    pcsr_spgemm,
    pcsr_transpose,
)

FINE, COARSE = 1, 2
_NEGI = -(2**31) + 1


# ---------------------------------------------------------------------------
# SA strength (one ghost fetch of the diagonal)
# ---------------------------------------------------------------------------

def pcsr_sa_strength(A: PCSR, theta: float):
    """Symmetric SA strength masks |a_ij| ≥ θ·√(|a_ii·a_jj|) over the
    split-block planes → per-part (m, Wd) and (m, Wo) bool masks."""
    d = []
    for dc, dv in zip(A.diag_cols, A.diag_vals):
        isdiag = (dc == _r_iota(dc)) & (dv != 0)
        d.append(torch.where(isdiag, dv, 0.0).sum(1).abs())
    d_g = _fetch(A, d, 0.0)
    Sd, So = [], []
    for i, (dc, dv, oc, ov) in enumerate(zip(A.diag_cols, A.diag_vals,
                                             A.off_cols, A.off_vals)):
        dmask = (dv != 0) & (dc != _r_iota(dc))
        omask = ov != 0
        da = torch.where(dmask, dv.abs(), 0.0)
        oa = torch.where(omask, ov.abs(), 0.0)
        th_d = theta * torch.sqrt(d[i][:, None] * d[i][dc.long()])
        th_o = theta * torch.sqrt(d[i][:, None] * d_g[i].abs()[oc.long()])
        Sd.append(dmask & (da >= th_d - 1e-30) & (da > 0))
        So.append(omask & (oa >= th_o - 1e-30) & (oa > 0))
    return Sd, So


# ---------------------------------------------------------------------------
# distance-2 MIS seeding (Luby rounds with ghost exchanges)
# ---------------------------------------------------------------------------

def pcsr_mis_seed(A: PCSR, Sd, So, seed: int = 0, max_rounds: int = 64,
                  stats: dict | None = None) -> PGrid:
    """Distance-2 MIS over the strength graph → PGrid of per-part (m,) int32
    states (COARSE on seeds): no two seeds within two hops, every
    strongly-connected node within two hops of a seed.  Diagonal-only rows
    never seed.  ``stats``, where given, receives the number of rounds."""
    S, L = A.n_shards, A.mesh.n_local
    m = A.row_partition.rows_per_shard
    # weights: a random PERMUTATION of row ids — all distinct, exact compares
    w_all = prng.permutation(S * m, seed).to(torch.int32)
    w = [w_all[p * m:(p + 1) * m].to(A.mesh.device(p)) for p in A.mesh.local]
    dcs = [dc.long() for dc in A.diag_cols]
    ocs = [oc.long() for oc in A.off_cols]

    def nmax(v, v_g):
        return [torch.maximum(
            torch.where(Sd[i], v[i][dcs[i]], _NEGI).amax(1),
            torch.where(So[i], v_g[i][ocs[i]], _NEGI).amax(1)) for i in range(L)]

    def reach(f, f_g):
        return [(Sd[i] & (f[i][dcs[i]] > 0)).any(1)
                | (So[i] & (f_g[i][ocs[i]] > 0)).any(1) for i in range(L)]

    cand = [Sd[i].any(1) | So[i].any(1) for i in range(L)]
    seeds = [torch.zeros(m, dtype=torch.bool, device=c.device) for c in cand]

    def n_cand(c):
        return int(exchange.psum([x.sum() for x in c]))

    rounds = 0
    nc = n_cand(cand)
    while nc > 0 and rounds < max_rounds:
        wc = [torch.where(cand[i], w[i], _NEGI) for i in range(L)]
        wc_g = _fetch(A, wc, _NEGI)
        h = [torch.maximum(a, b) for a, b in zip(wc, nmax(wc, wc_g))]
        h_g = _fetch(A, h, _NEGI)
        m2hop = nmax(h, h_g)
        is_max = [cand[i] & (m2hop[i] <= w[i]) for i in range(L)]
        seeds = [s | x for s, x in zip(seeds, is_max)]
        f = [x.to(torch.int32) for x in is_max]
        r1 = reach(f, _fetch(A, f, 0))
        r1i = [x.to(torch.int32) for x in r1]
        r2 = reach(r1i, _fetch(A, r1i, 0))
        cand = [cand[i] & ~is_max[i] & ~r1[i] & ~r2[i] for i in range(L)]
        rounds += 1
        nc = n_cand(cand)
    if stats is not None:
        stats["mis_rounds"] = rounds
    return PGrid([torch.where(s | c, COARSE, FINE).to(torch.int32)
                  for s, c in zip(seeds, cand)], A.mesh)


def pcsr_attach(A: PCSR, Sd, So, cmap: PGrid):
    """Two strongest-connection attachment phases → (agg PGrid of per-part
    (m,) int32: aggregate id, -1 = strongly-connected but unreached, -2 =
    inert (no strong connections); leftover = global count of -1).  Phase 1
    attaches to seed neighborhoods, phase 2 to any aggregated neighbor."""
    L = A.mesh.n_local
    agg = list(cmap.parts)  # seeds carry their id; everyone else -1
    for _ in range(2):
        agg_g = _fetch(A, agg, -1)
        nxt = []
        for i in range(L):
            dc, oc = A.diag_cols[i].long(), A.off_cols[i].long()
            ad_all, ao_all = agg[i][dc], agg_g[i][oc]
            sc_d = torch.where(Sd[i] & (ad_all >= 0), A.diag_vals[i].abs(), _NEG)
            sc_o = torch.where(So[i] & (ao_all >= 0), A.off_vals[i].abs(), _NEG)
            bd, bo = sc_d.amax(1), sc_o.amax(1)
            ad = ad_all.gather(1, sc_d.argmax(1, keepdim=True))[:, 0]
            ao = ao_all.gather(1, sc_o.argmax(1, keepdim=True))[:, 0]
            best = torch.where(bd >= bo, ad, ao)
            score = torch.maximum(bd, bo)
            nxt.append(torch.where((agg[i] < 0) & (score > _NEG), best, agg[i]))
        agg = nxt
    out = []
    for i in range(L):
        has_strong = Sd[i].any(1) | So[i].any(1)
        out.append(torch.where(has_strong | (agg[i] >= 0), agg[i], -2)
                   .to(torch.int32))
    left = int(exchange.psum([(a == -1).sum() for a in out]))
    return PGrid(out, A.mesh), left


# ---------------------------------------------------------------------------
# column scaling through the halo plan
# ---------------------------------------------------------------------------

def pcsr_scale_cols(M: PCSR, s: PGrid) -> PCSR:
    """M · diag(s) for a PGrid s on M's COLUMN partition (one ghost fetch of
    s through M's halo plan)."""
    s_g = _fetch(M, s.parts, 0.0)
    dv = [v * sl[c.long()] for v, sl, c in zip(M.diag_vals, s.parts, M.diag_cols)]
    ov = [v * g[c.long()] for v, g, c in zip(M.off_vals, s_g, M.off_cols)]
    return PCSR(M.diag_cols, dv, M.off_cols, ov, M.send_idx, M.recv_map,
                M.mesh, M.row_partition, M.col_partition, M.true_shape)


def _prolongation_smoother(A: PCSR, d_inv: PGrid, coef) -> PCSR:
    """S_m = I − coef·D⁻¹A as a PCSR (local transform; the +I lands on the
    stored diagonal slot, which every assembled square PCSR carries)."""
    dvs, ovs = [], []
    for dc, dv, ov, di in zip(A.diag_cols, A.diag_vals, A.off_vals, d_inv.parts):
        c = torch.as_tensor(coef).to(dv.device)
        di = di[:, None]
        isdiag = (dc == _r_iota(dc)) & (dv != 0)
        v = torch.where(dv != 0, -c * di * dv, 0.0)
        dvs.append(v + torch.where(isdiag, 1.0, 0.0))
        ovs.append(torch.where(ov != 0, -c * di * ov, 0.0))
    return PCSR(A.diag_cols, dvs, A.off_cols, ovs, A.send_idx, A.recv_map,
                A.mesh, A.row_partition, A.col_partition, A.true_shape)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def distributed_sa_setup(A: PCSR, config: AMGConfig, dtype=torch.float32,
                         seed: int = 0) -> Hierarchy:
    """Fully distributed algebraic-SA setup from a PCSR, on the parts'
    devices.

    Same level loop as ``distributed_rs_setup``: every level stays
    row-split, coarse numbering is part-padded (holes inert), and the
    coarsest operator gathers as triplets into a dense pseudo-inverse on
    every process.  ``setup_stats`` holds per-level rows and MIS rounds and
    seconds per phase."""
    if not isinstance(A, PCSR):
        raise TypeError("distributed_sa_setup takes a PCSR — assemble one with "
                        "pcsr_from_coo_device or PCSR.from_csr")
    mesh = A.mesh
    S = mesh.size
    clock = _Clock(*mesh.devices)
    levels: List[Level] = []
    shapes = []
    true_n = A.true_shape[0]
    for lvl in range(config.max_levels):
        info = {"rows": true_n}
        shapes.append(info)
        d_inv = _d_inv(A, dtype)
        lam_t = _pcsr_lambda_max(A, d_inv, config.lambda_power_iters,
                                 seed).to(dtype)
        lam = float(lam_t)
        clock.lap("smoother_setup")
        if true_n <= config.n_coarse_max or lvl == config.max_levels - 1:
            levels.append(Level(A, None, None, d_inv, lam, true_n=true_n))
            break
        Sd, So = pcsr_sa_strength(A, config.sa_theta)
        state = pcsr_mis_seed(A, Sd, So, seed=seed + lvl, stats=info)
        for attempt in range(2):
            cmap, mc_pad, nc_true = coarse_numbering(A, state)
            if nc_true == 0:
                break
            agg, leftover = pcsr_attach(A, Sd, So, cmap)
            if leftover == 0:
                break
            # promote unreached strongly-connected nodes (-1) to seeds and
            # renumber — cannot occur on symmetric strength graphs, so this
            # is a loud one-shot repair for asymmetric patterns
            if attempt != 0:
                raise ValueError(
                    f"pcsr_attach: {leftover} rows unreached after "
                    "promotion — asymmetric strength pattern the one-shot "
                    "seed promotion cannot close")
            state = state.map(lambda st, a: torch.where(a == -1, COARSE, st)
                              .to(torch.int32), agg)
        clock.lap("aggregation")
        if nc_true >= true_n or nc_true == 0:
            levels.append(Level(A, None, None, d_inv, lam, true_n=true_n))
            break

        # tentative T from (row, aggregate) triplets, then unit-norm columns
        m = A.row_partition.rows_per_shard
        n_coarse = S * mc_pad
        rows, cols, vals = [], [], []
        for p, a in zip(mesh.local, agg.parts):
            ok = a >= 0
            gr = p * m + torch.arange(m, device=a.device)
            rows.append(torch.where(ok, gr, -1))
            cols.append(torch.where(ok, a.long(), 0))
            vals.append(torch.where(ok, 1.0, 0.0).to(dtype))
        T = _assemble_grow(rows, cols, vals, (A.true_shape[0], n_coarse), mesh,
                           rows_per_shard=m, ell_width=1, off_width=1,
                           pad_identity=False,
                           ghost_capacity=max(4 * A.G, 256))
        R0 = pcsr_transpose(T, rows_per_shard=mc_pad)
        ones = PGrid([torch.ones(m, dtype=dtype, device=mesh.device(p))
                      for p in mesh.local], mesh)
        counts = R0.matvec(ones)
        inv_sqrt = counts.map(lambda c: torch.where(
            c > 0, 1.0 / torch.sqrt(torch.clamp(c, min=1.0)), 0.0))
        T_s = pcsr_scale_cols(T, inv_sqrt)

        # P = (I − (ω/λ) D⁻¹A) T_s, R = Pᵀ, Galerkin
        coef = config.sa_omega / torch.clamp(lam_t, min=1e-30)
        S_m = _prolongation_smoother(A, d_inv, coef)
        clock.lap("tentative")
        Pm = pcsr_spgemm(S_m, T_s, stats=info)
        R = pcsr_transpose(Pm, rows_per_shard=mc_pad)
        RA = pcsr_spgemm(R, A, stats=info)
        A_c = pcsr_spgemm(RA, Pm, pad_identity=True, stats=info)
        A_c = _ensure_diag(A_c)
        clock.lap("products")
        levels.append(Level(A, Pm, R, d_inv, lam, true_n=true_n))
        A = A_c
        true_n = nc_true
    h = Hierarchy(levels, coarse_inverse_from_triplets(levels[-1].A), config)
    clock.lap("coarse_inverse")
    h.setup_stats = {"levels": shapes, "seconds": clock.seconds}
    return h
