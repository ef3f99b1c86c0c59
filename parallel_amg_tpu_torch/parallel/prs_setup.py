"""Distributed classical (Ruge–Stüben) AMG setup over PCSR parts, on the
parts' devices.

Counterpart of ``parallel_amg_tpu/parallel/prs_setup.py``.  Every setup
stage runs part by part with ghost exchange over the PCSR halo plan
(``exchange.all_to_all``): strength, PMIS splitting, direct, smoothed or
extended+i interpolation, transpose and the Galerkin products.  No global
matrix exists anywhere in this call graph: the input is a PCSR (assemble one
with ``passembly_device.pcsr_from_coo_device``), intermediates are per-part
ELL planes with global column ids, and products are reassembled with the
device assembly.  Where the JAX package runs one ``shard_map`` program per
stage, the port runs the same body once per part this process holds, split
at each exchange; every host read that decides a shape or a loop is of a
value reduced over all parts (``exchange.psum``, ``pmax``, ``max_int``), so
every process takes the same branch.

Communication pattern per stage:
- strength: none (rowwise max over the local diag/off planes);
- PMIS: per Luby round, one ghost fetch of states, one reverse max-push of
  candidate weights and one ghost fetch of the updated states, then one host
  read of the undecided count;
- interpolation: one ghost fetch of (state, coarse-id) pairs; extended+i
  also exchanges each halo row's full global-column row table and its
  strong-C (fine-id, coarse-id) table — distance-two points are compared by
  id only, so ONE extra ghost-row exchange covers the extended stencil;
- SpGEMM C = A·B: one fetch of B's ghost ROWS through A's halo plan, then
  per part the rank-plane product of ``ops/gspgemm.py`` on kernels B3
  (expand), B5 (counts, for the width) and B4 (merge and compact), then the
  triplet reassembly.

Coarse-point numbering is part-padded: part s's k-th C point gets global id
``s·mc_pad + k`` (mc_pad = max per-part C count), so every coarse partition
stays uniform-contiguous.  Unused ids ("holes") carry an identity row, are
FINE at the next level, and are left out of ``Level.true_n``.  Diagonal-only
rows are FINE here (inert under the smoother), as in the JAX package.

No operator value is summed through float atomics: duplicate runs add left
to right (``segment.segment_sum``) or in B4's slot order, and every float32
row sum of the interpolation goes through ``ops/ordered_sum.row_sum``, in
the order of ``jnp.sum`` on the JAX package's CPU backend.  So a rerun on
the card is bit-equal, and the card and the CPU give the JAX package's
levels bit for bit.  The PMIS weights and the λ_max start vector are
``ops/prng.uniform``, the JAX package's draws.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg.device_rs import _Clock, _ext_i_row_chunk, topk_stable
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level, coarse_inverse_np
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import gspgemm, ordered_sum, prng, pspgemm
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.ordered_sum import row_sum
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.passembly_device import pcsr_from_coo_device
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid, ordered_norm
from parallel_amg_tpu_torch.parallel.segment import segment_max, segment_sum

UNDECIDED, FINE, COARSE = 0, 1, 2
_NEG = -1e30


# ---------------------------------------------------------------------------
# exchange helpers over the dense halo plan; arguments and results are lists
# with one tensor per local part
# ---------------------------------------------------------------------------

def _fetch(A: PCSR, xs, fill):
    """``consistent!``: ghost values of per-part (m, ...) tensors →
    per-part (G, ...)."""
    return A.fetch_ghosts(xs, fill)


def _push_max(A: PCSR, gvs, m: int):
    """``assemble!`` with max-reduce: per-ghost-slot candidates → per-part
    (m,) owner maxima (identity = _NEG)."""
    S, C = A.n_shards, A.C
    bufs = [segment_max(gv, rmap, S * C + 1, _NEG)[: S * C].reshape(S, C)
            for gv, rmap in zip(gvs, A.recv_map)]
    recv = exchange.all_to_all(bufs)
    return [segment_max(r.reshape(-1), sidx.reshape(-1), m, _NEG)
            for r, sidx in zip(recv, A.send_idx)]


def _fetch_rows(A: PCSR, rows_c, rows_v, fill_c):
    """Ghost ROW fetch: whole (W,)-wide rows of per-part (m, W) col/val
    tables through the halo plan → per-part (G, W) ghost rows."""
    return _fetch(A, rows_c, fill_c), _fetch(A, rows_v, 0.0)


def _dedup_rows(cand_cols, cand_vals, sentinel: int):
    """Per-row ESC compress: sort by column, sum duplicate runs left to
    right, compact to the front.  cand_cols: (m, K) with ``sentinel`` marking
    invalid.  Returns (cols, vals, row_nnz) at width K (zeros past nnz)."""
    m, K = cand_cols.shape
    dev = cand_cols.device
    cols_s, order = torch.sort(cand_cols, dim=1, stable=True)
    vals_s = cand_vals.gather(1, order)
    vals_s = torch.where(cols_s < sentinel, vals_s, 0.0)
    is_first = torch.ones_like(cols_s, dtype=torch.bool)
    is_first[:, 1:] = cols_s[:, 1:] != cols_s[:, :-1]
    is_first &= cols_s < sentinel
    pos = torch.cumsum(is_first.long(), 1) - 1
    row_nnz = torch.where(is_first.any(1), pos[:, -1] + 1, 0)
    flat = (torch.arange(m, device=dev)[:, None] * K + pos.clamp(0, K - 1)).reshape(-1)
    ovals = segment_sum(vals_s.reshape(-1), flat, m * K,
                        sorted_ids=True).reshape(m, K)
    ocols = segment_max(torch.where(is_first, cols_s, 0).reshape(-1), flat,
                        m * K, 0).reshape(m, K)
    pad = torch.arange(K, device=dev)[None, :] >= row_nnz[:, None]
    return (torch.where(pad, 0, ocols).to(torch.int32),
            torch.where(pad, 0.0, ovals), row_nnz.to(torch.int32))


def _topk_rescale(cols, vals, row_nnz, p_max: int, sentinel: int):
    """Keep the p_max largest-|v| entries per row (the lower slot first
    among equal values), rescaled to preserve row sums."""
    m, K = cols.shape
    k = min(p_max, K)
    live = torch.arange(K, device=cols.device)[None, :] < row_nnz[:, None]
    absv = torch.where(live, vals.abs(), 0.0)
    topv, topi = topk_stable(absv, k)
    pv = vals.gather(1, topi)
    pc = cols.gather(1, topi)
    kept = topv > 0
    total = row_sum(torch.where(live, vals, 0.0))
    keptsum = row_sum(torch.where(kept, pv, 0.0))
    scale = torch.where(keptsum != 0,
                        total / torch.where(keptsum == 0, 1.0, keptsum), 1.0)
    pv = torch.where(kept, pv * scale[:, None], 0.0)
    pc = torch.where(kept, pc, sentinel)
    return pc.to(torch.int32), pv, kept.sum(1).to(torch.int32)


def _r_iota(dc):
    return torch.arange(dc.shape[0], device=dc.device)[:, None]


# ---------------------------------------------------------------------------
# strength (local — no communication)
# ---------------------------------------------------------------------------

def pcsr_strength(A: PCSR, theta: float):
    """Classical strong-connection masks over the split-block planes:
    per-part (m, Wd) diag masks and (m, Wo) offdiag masks."""
    Sd, So = [], []
    for dc, dv, ov in zip(A.diag_cols, A.diag_vals, A.off_vals):
        dmask = (dv != 0) & (dc != _r_iota(dc))
        omask = ov != 0
        da = torch.where(dmask, dv.abs(), 0.0)
        oa = torch.where(omask, ov.abs(), 0.0)
        rowmax = torch.maximum(da.amax(1), oa.amax(1))[:, None]
        Sd.append(dmask & (da >= theta * rowmax) & (da > 0))
        So.append(omask & (oa >= theta * rowmax) & (oa > 0))
    return Sd, So


# ---------------------------------------------------------------------------
# PMIS splitting (Luby rounds with ghost exchanges per round)
# ---------------------------------------------------------------------------

def pcsr_pmis(A: PCSR, Sd, So, seed: int = 0, max_rounds: int = 64,
              stats: dict | None = None) -> PGrid:
    """Distributed PMIS C/F split.  Returns a PGrid of per-part (m,) int32
    states (FINE/COARSE; diagonal-only rows FINE).  One host read of the
    undecided count per round; ``stats``, where given, receives the number
    of rounds."""
    S, L = A.n_shards, A.mesh.n_local
    m = A.row_partition.rows_per_shard
    G, C = A.G, A.C
    n_true = A.true_shape[0]
    # random weights over the TRUE index space, so the stream is the
    # single-device path's, padded inert
    w_rand = torch.cat([prng.uniform((n_true,), seed, torch.float32),
                        torch.zeros(S * m - n_true)])

    # influence |S^T_i|: local in-edges + ghost-slot counts pushed back
    # (integer counts, so the float weights are exact)
    bufs, loc = [], []
    for dc, oc, sd, so, rmap in zip(A.diag_cols, A.off_cols, Sd, So, A.recv_map):
        loc.append(torch.bincount(dc[sd].long(), minlength=m))
        gsl = torch.bincount(oc[so].long(), minlength=G)
        buf = torch.zeros(S * C + 1, dtype=torch.long, device=dc.device)
        buf.index_add_(0, rmap.long(), gsl)
        bufs.append(buf[: S * C].reshape(S, C))
    recv = exchange.all_to_all(bufs)
    w, state = [], []
    for p, lc, r, sidx, sd, so in zip(A.mesh.local, loc, recv, A.send_idx, Sd, So):
        dev = r.device
        infl = lc.clone().index_add_(0, sidx.reshape(-1).long(), r.reshape(-1))
        w.append(infl.to(torch.float32) + w_rand[p * m:(p + 1) * m].to(dev))
        live = (p * m + torch.arange(m, device=dev)) < n_true
        has_out = sd.any(1) | so.any(1)
        state.append(torch.where(live & (has_out | (infl > 0)), UNDECIDED,
                                 FINE).to(torch.int32))
    w_g = _fetch(A, w, _NEG)  # ghost weights (static)

    def n_undecided(st):
        return int(exchange.psum([(s == UNDECIDED).sum() for s in st]))

    rounds = 0
    nund = n_undecided(state)
    while nund > 0 and rounds < max_rounds:
        st_g = _fetch(A, state, FINE)
        m1, gmax, und_l = [], [], []
        for i in range(L):
            dc, oc = A.diag_cols[i].long(), A.off_cols[i].long()
            sd, so = Sd[i], So[i]
            und = state[i] == UNDECIDED
            und_g = st_g[i] == UNDECIDED
            # m1: strongest undecided out-neighbor
            m1d = torch.where(sd & und[dc], w[i][dc], _NEG).amax(1)
            m1o = torch.where(so & und_g[oc], w_g[i][oc], _NEG).amax(1)
            # m2: strongest undecided in-neighbor (reverse direction)
            wrow = torch.where(und, w[i], _NEG)[:, None]
            m2d = segment_max(torch.where(sd, wrow, _NEG), dc, m, -float("inf"))
            gmax.append(segment_max(torch.where(so, wrow, _NEG), oc, G,
                                    -float("inf")))
            m1.append(torch.maximum(torch.maximum(m1d, m1o), m2d))
            und_l.append(und)
        m2o = _push_max(A, gmax, m)
        state = [torch.where(und_l[i] & (w[i] > torch.maximum(m1[i], m2o[i])),
                             COARSE, state[i]).to(torch.int32) for i in range(L)]
        # F-assignment against the UPDATED neighbor states
        st_g2 = _fetch(A, state, FINE)
        for i in range(L):
            dc, oc = A.diag_cols[i].long(), A.off_cols[i].long()
            dep_c = ((Sd[i] & (state[i][dc] == COARSE)).any(1)
                     | (So[i] & (st_g2[i][oc] == COARSE)).any(1))
            state[i] = torch.where((state[i] == UNDECIDED) & dep_c, FINE,
                                   state[i]).to(torch.int32)
        rounds += 1
        nund = n_undecided(state)
    if stats is not None:
        stats["pmis_rounds"] = rounds
    return PGrid([torch.where(s == UNDECIDED, COARSE, s).to(torch.int32)
                  for s in state], A.mesh)


def coarse_numbering(A: PCSR, state: PGrid):
    """Part-padded global coarse ids: part s's k-th C point → s·mc_pad+k.

    Returns (cmap PGrid of per-part (m,) int32 with -1 on non-C rows,
    mc_pad, nc_true) — one small host read of the per-part counts."""
    is_c = [s == COARSE for s in state.parts]
    counts = torch.stack(exchange.all_gather([c.sum() for c in is_c])).cpu().numpy()
    mc_pad = max(int(counts.max()), 1)
    cmap = [torch.where(c, p * mc_pad + torch.cumsum(c.long(), 0) - 1, -1)
            .to(torch.int32) for p, c in zip(A.mesh.local, is_c)]
    return PGrid(cmap, A.mesh), mc_pad, int(counts.sum())


# ---------------------------------------------------------------------------
# interpolation (direct + optional Jacobi smoothing), built as per-part
# global-column planes, then assembled once
# ---------------------------------------------------------------------------

def _interp_direct_part(i, A: PCSR, sd, so, st_g, cm_g, state, cmap, *, m,
                        k0, sentinel):
    """Direct interpolation of local part i's rows at width k0 (top-|w| and
    the row-sum rescale), C rows the identity onto their own coarse id."""
    dc, dv, oc, ov = A.diag_cols[i], A.diag_vals[i], A.off_cols[i], A.off_vals[i]
    dcl, ocl = dc.long(), oc.long()
    dmask = dv != 0
    omask = ov != 0
    offd_d = dmask & (dc != _r_iota(dc))
    a_d = torch.where(dmask, dv, 0.0)
    a_o = torch.where(omask, ov, 0.0)
    strong_c_d = sd & (state[dcl] == COARSE)
    strong_c_o = so & (st_g[ocl] == COARSE)

    neg_d, pos_d = offd_d & (a_d < 0), offd_d & (a_d > 0)
    neg_o, pos_o = omask & (a_o < 0), omask & (a_o > 0)

    def rsum(mask_d, mask_o):
        return (row_sum(torch.where(mask_d, a_d, 0.0))
                + row_sum(torch.where(mask_o, a_o, 0.0)))

    sum_n_neg = rsum(neg_d, neg_o)
    sum_n_pos = rsum(pos_d, pos_o)
    sum_c_neg = rsum(strong_c_d & neg_d, strong_c_o & neg_o)
    sum_c_pos = rsum(strong_c_d & pos_d, strong_c_o & pos_o)
    diag = row_sum(torch.where(dc == _r_iota(dc), a_d, 0.0))
    diag = diag + torch.where(sum_c_pos == 0.0, sum_n_pos, 0.0)
    alpha = torch.where(sum_c_neg != 0, sum_n_neg / torch.where(
        sum_c_neg == 0, 1.0, sum_c_neg), 0.0)
    beta = torch.where(sum_c_pos != 0, sum_n_pos / torch.where(
        sum_c_pos == 0, 1.0, sum_c_pos), 0.0)
    coef_d = torch.where(a_d < 0, alpha[:, None], beta[:, None])
    coef_o = torch.where(a_o < 0, alpha[:, None], beta[:, None])
    wts_d = torch.where(strong_c_d, -coef_d * a_d / diag[:, None], 0.0)
    wts_o = torch.where(strong_c_o, -coef_o * a_o / diag[:, None], 0.0)

    # candidate planes with GLOBAL coarse columns (sentinel = invalid)
    cand_c = torch.cat([torch.where(strong_c_d, cmap[dcl], sentinel),
                        torch.where(strong_c_o, cm_g[ocl], sentinel)], 1)
    cand_c = torch.where(cand_c < 0, sentinel, cand_c)
    cand_v = torch.cat([wts_d, wts_o], 1)
    ok = cand_c < sentinel
    kk = min(k0, cand_c.shape[1])
    topv, topi = topk_stable(torch.where(ok, cand_v, 0.0).abs(), kk)
    pv = cand_v.gather(1, topi)
    pc = cand_c.gather(1, topi)
    kept = topv > 0
    total = row_sum(torch.where(ok, cand_v, 0.0))
    keptsum = row_sum(torch.where(kept, pv, 0.0))
    scale = torch.where(keptsum != 0,
                        total / torch.where(keptsum == 0, 1.0, keptsum), 1.0)
    pv = torch.where(kept, pv * scale[:, None], 0.0)
    pc = torch.where(kept, pc, sentinel)

    # C rows: identity onto their own coarse id
    is_c = (state == COARSE)[:, None]
    first = torch.arange(kk, device=dc.device)[None, :] == 0
    pc = torch.where(is_c, torch.where(first, cmap[:, None].to(pc.dtype), sentinel), pc)
    pv = torch.where(is_c, first.to(pv.dtype), pv)
    return pc, pv


def _triplets(p, pc, pv, *, m, n_true, sentinel):
    """(rows, cols, vals) of global part p's interpolation rows (row −1
    drops)."""
    gr = p * m + torch.arange(m, device=pc.device)
    ok = (pc < sentinel) & (pv != 0) & (gr < n_true)[:, None]
    return (torch.where(ok, gr[:, None], -1).reshape(-1),
            torch.where(ok, pc.long(), 0).reshape(-1),
            torch.where(ok, pv, 0.0).reshape(-1))


def _xi_tables(A: PCSR, Sd, So, state: PGrid, cmap: PGrid, sent_f: int):
    """Stage A of distributed extended+i: per-local-row exchangeable tables,
    aligned to the [diag planes | off planes] position order:
    - rowc/rowv: full-row table with GLOBAL column ids (sent_f = invalid);
    - sfm: strong-F mask per position;
    - sc_fid/sc_cid: strong-C (global fine id, global coarse id) pairs
      compacted to the row front, plus per-row count;
    - sf_e/sf_a: strong-F (extended local index ∈ [0, m+G), coupling a_ik)
      pairs compacted to the row front, plus per-row count.
    Returns a list of per-part tuples."""
    m = A.row_partition.rows_per_shard
    G = A.G
    gids = A.ghost_gids()
    st_g = _fetch(A, state.parts, FINE)
    cm_g = _fetch(A, cmap.parts, -1)
    out = []
    for i, p in enumerate(A.mesh.local):
        dc, dv, oc, ov = A.diag_cols[i], A.diag_vals[i], A.off_cols[i], A.off_vals[i]
        dcl, ocl = dc.long(), oc.long()
        sd, so = Sd[i], So[i]
        st, cm = state.parts[i], cmap.parts[i]
        dmask = dv != 0
        omask = (ov != 0) & (gids[i][ocl] >= 0)
        rowc = torch.cat([torch.where(dmask, p * m + dcl, sent_f),
                          torch.where(omask, gids[i][ocl], sent_f)], 1).to(torch.int32)
        rowv = torch.cat([torch.where(dmask, dv, 0.0), torch.where(omask, ov, 0.0)], 1)
        scd = sd & (st[dcl] == COARSE)
        sco = so & (st_g[i][ocl] == COARSE)
        sfd = sd & (st[dcl] != COARSE)
        sfo = so & (st_g[i][ocl] != COARSE)
        sfm = torch.cat([sfd, sfo], 1)
        sc_m = torch.cat([scd, sco], 1)
        sc_fid = torch.where(sc_m, rowc, sent_f)
        sc_cid = torch.cat([torch.where(scd, cm[dcl], -1),
                            torch.where(sco, cm_g[i][ocl], -1)], 1).to(torch.int32)
        order = torch.sort(torch.where(sc_m, 0, 1), dim=1, stable=True).indices
        sc_fid = sc_fid.gather(1, order)
        sc_cid = sc_cid.gather(1, order)
        c_cnt = sc_m.sum(1)
        ext = m + G
        sf_e = torch.cat([torch.where(sfd, dcl, ext),
                          torch.where(sfo, m + ocl, ext)], 1)
        sf_a = torch.cat([torch.where(sfd, dv, 0.0), torch.where(sfo, ov, 0.0)], 1)
        order_f = torch.sort(torch.where(sfm, 0, 1), dim=1, stable=True).indices
        sf_e = sf_e.gather(1, order_f)
        sf_a = sf_a.gather(1, order_f)
        f_cnt = sfm.sum(1)
        out.append((rowc, rowv, sfm, sc_fid, sc_cid, sf_e, sf_a, c_cnt, f_cnt))
    return out


def _xi_chunk(rid, gid, rc, rv, sf_mask, oscf, osccid, osfe, osfa, st, cm, tabs,
              *, sent_f, sent_c, p_max, ext):
    """Stage B's per-row computation for a chunk of rows: the candidate-table
    algorithm of ``amg.device_rs.extended_i_interpolation_device``, with
    candidates in global COARSE-id space."""
    rowc_ext, rowv_ext, scf_ext, sccid_ext = tabs
    ch = rid.shape[0]
    osfe_l = osfe.long()
    # Ĉ_i table: own strong-C ∪ strong-C of each strong-F neighbor
    kscf = scf_ext[osfe_l]                       # (ch, f_max, c_max)
    kscc = sccid_ext[osfe_l]
    chat_f = torch.cat([oscf, kscf.reshape(ch, -1)], 1)
    chat_c = torch.cat([osccid, kscc.reshape(ch, -1)], 1)
    chat_valid = chat_f < sent_f

    # own-entry pass
    am = rc < sent_f
    isdiag = rc == gid[:, None]
    match2 = (rc[:, :, None] == chat_f[:, None, :]) & chat_valid[:, None, :]
    cid_own = torch.where(match2, chat_c[:, None, :], -1).amax(2)
    in_chat = cid_own >= 0
    own_num = torch.where(am & in_chat & ~isdiag, rv, 0.0)
    diag = row_sum(torch.where(isdiag, rv, 0.0))
    diag = diag + row_sum(torch.where(am & ~isdiag & ~in_chat & ~sf_mask, rv, 0.0))

    # strong-F distribution pass
    sfvm = osfe < ext
    kr_c = rowc_ext[osfe_l]                      # (ch, f_max, W)
    kr_v = rowv_ext[osfe_l]
    kr_m = kr_c < sent_f
    sign_ok = kr_v * osfa[..., None] > 0
    m_is_i = kr_c == gid[:, None, None]
    match4 = ((kr_c[..., None] == chat_f[:, None, None, :])
              & chat_valid[:, None, None, :])
    cid4 = torch.where(match4, chat_c[:, None, None, :], -1).amax(3)
    m_in_chat = cid4 >= 0
    dist_m = kr_m & sign_ok & (m_in_chat | m_is_i)
    denom = row_sum(torch.where(dist_m, kr_v, 0.0))
    has_d = denom != 0
    share = torch.where(
        dist_m & has_d[..., None],
        osfa[..., None] * kr_v / torch.where(denom == 0, 1.0, denom)[..., None],
        0.0)
    diag = diag + row_sum(torch.where(sfvm & ~has_d, osfa, 0.0))
    diag = diag + row_sum(torch.where(m_is_i, share, 0.0), 2)

    # candidates in global coarse-id space, dedup, w = -num/diag
    cand_c = torch.cat([
        torch.where(own_num != 0, cid_own, sent_c),
        torch.where((share != 0) & ~m_is_i, cid4, sent_c).reshape(ch, -1)], 1)
    cand_c = torch.where(cand_c < 0, sent_c, cand_c)
    cand_v = torch.cat([own_num,
                        torch.where(~m_is_i, share, 0.0).reshape(ch, -1)], 1)
    cand_v = torch.where(cand_c < sent_c, cand_v, 0.0)
    cols, vals, nnz = _dedup_rows(cand_c, cand_v, sent_c)
    safe_diag = torch.where(diag == 0, 1.0, diag)
    live = torch.arange(cols.shape[1], device=cols.device)[None, :] < nnz[:, None]
    wts = torch.where(live, -vals / safe_diag[:, None], 0.0)
    pc, pv, _ = _topk_rescale(cols, wts, nnz, p_max, sent_c)

    # C rows: identity onto own part-padded coarse id
    is_c = (st == COARSE)[:, None]
    first = torch.arange(pc.shape[1], device=pc.device)[None, :] == 0
    pc = torch.where(is_c, torch.where(first, cm[:, None], sent_c), pc).to(torch.int32)
    pv = torch.where(is_c, first.to(pv.dtype), pv)
    return pc, pv


def pcsr_extended_i(A: PCSR, Sd, So, state: PGrid, cmap: PGrid, mc_pad: int,
                    config: AMGConfig, stats: dict | None = None) -> PCSR:
    """Distributed TRUE distance-two extended+i interpolation → PCSR P.

    Same algorithm as the single-device
    ``amg.device_rs.extended_i_interpolation_device``; the distance-two
    reach is ONE extra ghost-row exchange of the stage-A tables.  Two small
    host reads (table widths, the widest over all parts)."""
    S = A.n_shards
    m = A.row_partition.rows_per_shard
    G = A.G
    n_true = A.true_shape[0]
    n_coarse = S * mc_pad
    sent_f = int(A.col_partition.n_padded)
    tabs = _xi_tables(A, Sd, So, state, cmap, sent_f)
    c_max, f_max = (max(int(v), 1) for v in exchange.pmax(  # host reads
        [torch.stack([t[7].amax(), t[8].amax()]) for t in tabs]).cpu())
    rowc = [t[0] for t in tabs]
    rowv = [t[1] for t in tabs]
    scf = [t[3][:, :c_max] for t in tabs]
    sccid = [t[4][:, :c_max] for t in tabs]
    sfe = [t[5][:, :f_max] for t in tabs]
    sfa = [t[6][:, :f_max] for t in tabs]

    # the distance-two exchange: ghost rows' tables through the halo plan
    growc = _fetch(A, rowc, sent_f)
    growv = _fetch(A, rowv, 0.0)
    gscf = _fetch(A, scf, sent_f)
    gsccid = _fetch(A, sccid, -1)

    W = rowc[0].shape[1]
    K = c_max * (1 + f_max)
    ext = m + G
    if stats is not None:  # the widths of the tables and of their row sums
        stats["ext_i"] = {"W": W, "f_max": f_max, "c_max": c_max,
                          "candidates": W * (1 + f_max)}
    R, Cc, V = [], [], []
    for i, p in enumerate(A.mesh.local):
        dev = rowc[i].device
        row_chunk = _ext_i_row_chunk(f_max, W, K, dev)

        def cap(t, fill):
            return torch.full((1,) + tuple(t.shape[1:]), fill, dtype=t.dtype,
                              device=dev)

        # extended tables indexed by e ∈ [0, m+G]; row m+G = inert sentinel
        ext_tabs = (torch.cat([rowc[i], growc[i], cap(rowc[i], sent_f)]),
                    torch.cat([rowv[i], growv[i], cap(rowv[i], 0.0)]),
                    torch.cat([scf[i], gscf[i], cap(scf[i], sent_f)]),
                    torch.cat([sccid[i], gsccid[i], cap(sccid[i], -1)]))
        pcs, pvs = [], []
        for r0 in range(0, m, row_chunk):
            r1 = min(r0 + row_chunk, m)
            rid = torch.arange(r0, r1, device=dev)
            pc, pv = _xi_chunk(
                rid, p * m + rid, rowc[i][r0:r1], rowv[i][r0:r1],
                tabs[i][2][r0:r1], scf[i][r0:r1], sccid[i][r0:r1],
                sfe[i][r0:r1], sfa[i][r0:r1], state.parts[i][r0:r1],
                cmap.parts[i][r0:r1], ext_tabs, sent_f=sent_f,
                sent_c=n_coarse, p_max=config.p_max, ext=ext)
            pcs.append(pc)
            pvs.append(pv)
        r, c, v = _triplets(p, torch.cat(pcs), torch.cat(pvs), m=m,
                            n_true=n_true, sentinel=n_coarse)
        R.append(r)
        Cc.append(c)
        V.append(v)
    return _assemble_grow(
        R, Cc, V, (n_true, n_coarse), A.mesh,
        rows_per_shard=m, ell_width=config.p_max, off_width=config.p_max,
        pad_identity=False, ghost_capacity=max(4 * G * config.p_max, 256))


def pcsr_interpolation(A: PCSR, Sd, So, state: PGrid, cmap: PGrid,
                       mc_pad: int, config: AMGConfig,
                       stats: dict | None = None) -> PCSR:
    """Classical interpolation → PCSR P, three tiers (config.interpolation):
    "extended_i" (TRUE distance-two, the default — ``pcsr_extended_i``),
    "smoothed_direct" (direct + one Jacobi pass), "direct".

    P: rows on A's fine partition, cols on the part-padded coarse numbering
    (n_cols = S·mc_pad).  ``stats``, where given, receives extended+i's
    table widths."""
    if config.interpolation == "extended_i":
        return pcsr_extended_i(A, Sd, So, state, cmap, mc_pad, config, stats)
    S = A.n_shards
    m = A.row_partition.rows_per_shard
    G = A.G
    n_true = A.true_shape[0]
    n_coarse = S * mc_pad
    smooth = config.interpolation != "direct"
    k0 = max(config.p_max * (2 if smooth else 1), 1)
    st_g = _fetch(A, state.parts, FINE)
    cm_g = _fetch(A, cmap.parts, -1)
    P0 = [_interp_direct_part(i, A, Sd[i], So[i], st_g[i], cm_g[i],
                              state.parts[i], cmap.parts[i], m=m, k0=k0,
                              sentinel=n_coarse) for i in range(A.mesh.n_local)]
    if smooth:
        # P ← (I − ω D⁻¹A) P over the halo'd P0 rows, then top-p_max
        d_inv = A.diagonal().map(lambda d: torch.where(d != 0, 1.0 / d, 0.0))
        gpc, gpv = _fetch_rows(A, [t[0] for t in P0], [t[1] for t in P0],
                               n_coarse)
        out = []
        for i, (pc, pv) in enumerate(P0):
            dc, dv, oc, ov = (A.diag_cols[i].long(), A.diag_vals[i],
                              A.off_cols[i].long(), A.off_vals[i])
            dmask, omask = dv != 0, ov != 0
            di = -config.jacobi_omega * d_inv.parts[i][:, None]
            da_d = di * torch.where(dmask, dv, 0.0)
            da_o = di * torch.where(omask, ov, 0.0)
            cd = torch.where(dmask[..., None], pc[dc], n_coarse)
            vd = torch.where(dmask[..., None], da_d[..., None] * pv[dc], 0.0)
            co = torch.where(omask[..., None], gpc[i][oc], n_coarse)
            vo = torch.where(omask[..., None], da_o[..., None] * gpv[i][oc], 0.0)
            cand_c2 = torch.cat([pc, cd.reshape(m, -1), co.reshape(m, -1)], 1)
            cand_v2 = torch.cat([pv, vd.reshape(m, -1), vo.reshape(m, -1)], 1)
            cand_v2 = torch.where(cand_c2 < n_coarse, cand_v2, 0.0)
            cols, vals, nnz = _dedup_rows(cand_c2, cand_v2, n_coarse)
            pc2, pv2, _ = _topk_rescale(cols, vals, nnz, config.p_max, n_coarse)
            out.append((pc2, pv2))
        P0 = out
    trip = [_triplets(p, pc, pv, m=m, n_true=n_true, sentinel=n_coarse)
            for p, (pc, pv) in zip(A.mesh.local, P0)]
    width = config.p_max if smooth else k0
    return _assemble_grow(
        [t[0] for t in trip], [t[1] for t in trip], [t[2] for t in trip],
        (n_true, n_coarse), A.mesh, rows_per_shard=m, ell_width=width,
        off_width=width, pad_identity=False,
        ghost_capacity=max(4 * G * config.p_max, 256))


def _assemble_grow(rows, cols, vals, shape, mesh, *, max_grow: int = 4,
                   **kwargs) -> PCSR:
    """pcsr_from_coo_device with loud-but-handled capacity growth: on a
    counted overflow, double the offending capacity and retry."""
    for _ in range(max_grow):
        try:
            return pcsr_from_coo_device(rows, cols, vals, shape, mesh, **kwargs)
        except ValueError as e:
            msg = str(e)
            if "ghost_capacity" in msg:
                kwargs["ghost_capacity"] = 2 * kwargs.get("ghost_capacity", 256)
                kwargs.pop("send_capacity", None)
            elif "ell/off_width" in msg:
                kwargs["ell_width"] = 2 * kwargs.get("ell_width", 8)
                kwargs["off_width"] = 2 * kwargs.get("off_width", 8)
            elif "send_capacity" in msg:
                kwargs["send_capacity"] = 2 * kwargs.get("send_capacity", 256)
            else:
                raise
    return pcsr_from_coo_device(rows, cols, vals, shape, mesh, **kwargs)


# ---------------------------------------------------------------------------
# distributed SpGEMM: C = A @ B via ghost-row fetch + per-part B3/B5/B4
# product + reassembly
# ---------------------------------------------------------------------------

def _pcsr_global_cols(B: PCSR, sentinel: int):
    """Per-part (m, Wd+Wo) col/val tables of a PCSR with GLOBAL column ids
    (sentinel = invalid) — the exchangeable row view of B."""
    mc = B.col_partition.rows_per_shard
    gids = B.ghost_gids()
    cols, vals = [], []
    for i, p in enumerate(B.mesh.local):
        dc, dv, oc, ov = B.diag_cols[i], B.diag_vals[i], B.off_cols[i], B.off_vals[i]
        go = gids[i][oc.long()]
        ok_o = (ov != 0) & (go >= 0)
        cols.append(torch.cat([torch.where(dv != 0, p * mc + dc.long(), sentinel),
                               torch.where(ok_o, go, sentinel)], 1).to(torch.int32))
        vals.append(torch.cat([torch.where(dv != 0, dv, 0.0),
                               torch.where(ov != 0, ov, 0.0)], 1))
    return cols, vals


def _compact_front(cols, vals, keep):
    """Each row's kept entries moved to its front in their order, the table
    cut to the widest row (one host read); cols, vals as given elsewhere."""
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    w = max(int(keep.sum(1).max()) if keep.numel() else 0, 1)
    order = order[:, :w]
    return (cols.gather(1, order).contiguous(), vals.gather(1, order).contiguous(),
            keep.gather(1, order))


def part_product_operands(A: PCSR, i: int, bc, bv, gbc, gbv, sentinel: int):
    """The ELL pair whose product is local part i's rows of A·B: A′ = [diag | off]
    with columns ``[diag_cols, off_cols + mB]`` over the row table
    cat(B's local rows, its fetched ghost rows), whose columns are B's global
    column ids.  Both keep only their stored entries (nonzero values, valid
    columns), moved to the row front, so the candidate table is no wider
    than the product needs."""
    dc, dv, oc, ov = A.diag_cols[i], A.diag_vals[i], A.off_cols[i], A.off_vals[i]
    mB = bc.shape[0]
    vals = torch.cat([dv, ov], 1)
    a_c, a_v, a_k = _compact_front(torch.cat([dc, oc + mB], 1), vals, vals != 0)
    Ap = ELL(a_c, a_v, a_k.sum(1, dtype=torch.int32), (dc.shape[0], mB + gbc.shape[0]))
    tab_c, tab_v = torch.cat([bc, gbc]), torch.cat([bv, gbv])
    b_c, b_v, b_k = _compact_front(tab_c, tab_v, tab_c < sentinel)
    Bp = ELL(torch.where(b_k, b_c, 0), torch.where(b_k, b_v, 0.0),
             b_k.sum(1, dtype=torch.int32), (tab_c.shape[0], sentinel))
    return Ap, Bp


def part_candidates(Ap: ELL, Bp: ELL, plain: bool = False):
    """B3's candidate table of ``part_product``, reordered from its slot
    order m·Wa + k to k·Wb + m (A's entry first, as the JAX package's
    ``_spgemm_kernel`` lays them out).  ``plain=True`` runs B3's plain
    version."""
    gather = gspgemm._gather_candidates_plain if plain else gspgemm.gather_candidates
    return gspgemm.k_major(*gather(Ap, Bp), Ap.width, Bp.width)


def part_product(Ap: ELL, Bp: ELL, plain: bool = False) -> ELL:
    """Part p's rows of A·B from ``part_product_operands``: the candidates
    of ``part_candidates`` (B3), then B5's counts for the width and B4's
    merge.  B4 sums each column's products in slot order, so in the order
    of A's entries, as the JAX package's stable sort does.  ``plain=True``
    runs the three steps' plain versions."""
    sent = Bp.n_cols
    cand_c, cand_v = part_candidates(Ap, Bp, plain)
    if plain:
        counts = pspgemm._dedup_plain(cand_c, cand_v, sent, counts_only=True)
    else:
        counts = pspgemm.dedup(cand_c, cand_v, sent, counts_only=True)
    width = max(int(counts.max()) if counts.numel() else 0, 1)  # host read
    compact = gspgemm._dedup_compact_plain if plain else gspgemm.dedup_compact
    cols, vals, counts = compact(cand_c, cand_v, sent, width)
    return ELL(cols, vals, counts, (Ap.n_rows, sent))


def pcsr_spgemm(A: PCSR, B: PCSR, *, out_true_rows: int | None = None,
                pad_identity: bool = False, stats: dict | None = None) -> PCSR:
    """Distributed C = A @ B (SURVEY.md §3.1 Galerkin ⟦COMM⟧ rows).

    A's column partition must equal B's row partition.  One ghost-row fetch
    brings B's rows through A's halo plan; per part, ``part_product`` (B3,
    then B5's counts for the width, then B4) forms the part's rows; the
    compacted triplets reassemble into a PCSR.  Host reads: one width per
    part, the widest over all parts and the assembly's overflow check.
    ``stats``, where given, receives the widest candidate width K and
    output width over the parts.
    """
    if A.col_partition.rows_per_shard != B.row_partition.rows_per_shard:
        raise ValueError("pcsr_spgemm: A's column partition must match B's "
                         "row partition")
    m = A.row_partition.rows_per_shard
    n_rows = out_true_rows or A.true_shape[0]
    n_cols = B.true_shape[1]
    sentinel = int(B.col_partition.n_padded)

    bc, bv = _pcsr_global_cols(B, sentinel)
    gbc, gbv = _fetch_rows(A, bc, bv, sentinel)
    prods, Ks = [], []
    for i in range(A.mesh.n_local):
        Ap, Bp = part_product_operands(A, i, bc[i], bv[i], gbc[i], gbv[i],
                                       sentinel)
        prods.append(part_product(Ap, Bp))
        Ks.append(Ap.width * Bp.width)
    dev = prods[0].cols.device
    K = exchange.max_int(Ks, dev)
    width = exchange.max_int([C.width for C in prods], dev)
    if stats is not None:
        stats.setdefault("products", []).append(
            {"K": K, "w": width})
    R, Cc, V = [], [], []
    for p, C in zip(A.mesh.local, prods):
        dev = C.cols.device
        gr = (p * m + torch.arange(m, device=dev))[:, None]
        ok = C.mask() & (gr < n_rows) & (C.vals != 0)
        R.append(torch.where(ok, gr, -1).reshape(-1))
        Cc.append(torch.where(ok, C.cols.long(), 0).reshape(-1))
        V.append(torch.where(ok, C.vals, 0.0).reshape(-1))
    mcB = B.col_partition.rows_per_shard
    return _assemble_grow(
        R, Cc, V, (n_rows, n_cols), A.mesh,
        rows_per_shard=m, ell_width=width, off_width=width,
        pad_identity=pad_identity,
        ghost_capacity=max(2 * mcB, 4 * B.G, 256))


def pcsr_transpose(P: PCSR, rows_per_shard: int) -> PCSR:
    """R = Pᵀ on the parts' devices: triplet recovery + owner-routed
    reassembly."""
    rows, cols, vals = P.to_triplets()
    n_rows, n_cols = P.true_shape
    n_pad = P.col_partition.n_padded
    valid = [r >= 0 for r in rows.parts]
    # column width of P = row width of R: integer counts, one host read
    counts = exchange.psum([torch.bincount(c[v], minlength=n_pad)
                            for c, v in zip(cols.parts, valid)])
    width = max(int(counts.max()), 1)
    rT = [torch.where(v, c, -1) for c, v in zip(cols.parts, valid)]
    cT = [torch.where(v, r, 0) for r, v in zip(rows.parts, valid)]
    return _assemble_grow(
        rT, cT, vals.parts, (n_cols, n_rows), P.mesh,
        rows_per_shard=rows_per_shard, ell_width=width, off_width=width,
        pad_identity=False, ghost_capacity=max(4 * P.G, 256))


def _ensure_diag(A: PCSR) -> PCSR:
    """Put a unit diagonal on structurally empty rows (coarse-numbering
    holes) so smoothers and Krylov stay well-defined there."""
    dcs, dvs = [], []
    for dc, dv, ov in zip(A.diag_cols, A.diag_vals, A.off_vals):
        empty = ((dv != 0).sum(1) + (ov != 0).sum(1)) == 0
        dc, dv = dc.clone(), dv.clone()
        dc[:, 0] = torch.where(empty, _r_iota(dc)[:, 0].to(dc.dtype), dc[:, 0])
        dv[:, 0] = torch.where(empty, torch.ones((), dtype=dv.dtype,
                                                 device=dv.device), dv[:, 0])
        dcs.append(dc)
        dvs.append(dv)
    return PCSR(dcs, dvs, A.off_cols, A.off_vals, A.send_idx, A.recv_map,
                A.mesh, A.row_partition, A.col_partition, A.true_shape)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _pcsr_lambda_max(A: PCSR, d_inv: PGrid, iters: int, seed: int = 0):
    """λ_max(D⁻¹A) estimate (1.1 safety factor) as a 0-d tensor on the first
    local part's device; the start vector is the JAX package's uniform draw
    over the padded columns, minus 0.5.  The matvec adds each part's own and
    ghost planes in the JAX package's CPU order (``ordered_sum.
    ell_dot_lanes``; own + ghost, as its ``PCSR.matvec``) and the norm is
    ``pgrid.ordered_norm``, so λ is its float32 value bit for bit; the
    solve path's ``PCSR.matvec`` (B1 on the card) keeps its own order."""
    n = A.col_partition.n_padded
    x = PGrid.from_global(prng.uniform((n,), seed, A.dtype) - 0.5, A.mesh)
    own = ordered_sum.ell_dot_lanes(A.diag_vals[0].shape[1], "own")
    ghost = ordered_sum.ell_dot_lanes(A.off_vals[0].shape[1], "ghost")
    dcs = [c.long() for c in A.diag_cols]
    ocs = [c.long() for c in A.off_cols]
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        g = A.ghosts(x)
        y = PGrid([di * (ordered_sum.row_dot(dv, xl[dc], own)
                         + ordered_sum.row_dot(ov, gl[oc], ghost))
                   for di, dv, dc, ov, oc, xl, gl in zip(
                       d_inv.parts, A.diag_vals, dcs, A.off_vals, ocs, x.parts, g)],
                  A.mesh)
        nrm = ordered_norm(y)
        lam = torch.where(nrm > 0, nrm, lam)
        x = y / torch.clamp(nrm, min=1e-30)
    return 1.1 * lam


def _d_inv(A: PCSR, dtype) -> PGrid:
    return A.diagonal().map(lambda d: torch.where(d != 0, 1.0 / d, 0.0).to(dtype))


def coarse_inverse_from_triplets(Ac: PCSR):
    """Replicated dense coarse pseudo-inverse from the gathered triplets of
    the coarsest operator: zeros, the triplets scattered, and a unit
    diagonal ONLY on structurally empty rows (coarse-numbering holes).
    Float32, on this process's parts' device, the same on every process."""
    rows, cols, vals = Ac.to_triplets()
    r = rows.to_global("cpu").numpy()
    c = cols.to_global("cpu").numpy()
    v = vals.to_global("cpu").double().numpy()
    n_pad = Ac.row_partition.n_padded
    dense = np.zeros((n_pad, n_pad))
    keep = r >= 0
    np.add.at(dense, (r[keep], c[keep]), v[keep])
    has_entry = np.zeros((n_pad,), bool)
    has_entry[r[keep]] = True
    dense[~has_entry, ~has_entry] = 1.0
    return torch.from_numpy(coarse_inverse_np(dense)).to(torch.float32).to(
        rows.device)


def distributed_rs_setup(A: PCSR, config: AMGConfig, dtype=torch.float32,
                         seed: int = 0) -> Hierarchy:
    """Fully distributed classical-AMG setup from a PCSR, on the parts'
    devices.

    Every level stays row-split over the mesh; the coarsest operator is
    gathered as triplets (it is ≤ n_coarse_max by construction) into a dense
    pseudo-inverse on every process.  No global sparse matrix exists at
    any point of this call graph.  ``setup_stats`` holds per-level rows,
    PMIS rounds and product widths, and seconds per phase.
    """
    if not isinstance(A, PCSR):
        raise TypeError("distributed_rs_setup takes a PCSR — assemble one with "
                        "pcsr_from_coo_device or PCSR.from_csr")
    clock = _Clock(*A.mesh.devices)
    levels: List[Level] = []
    shapes = []
    true_n = A.true_shape[0]
    for lvl in range(config.max_levels):
        info = {"rows": true_n}
        shapes.append(info)
        d_inv = _d_inv(A, dtype)
        lam = 0.0
        if config.smoother == "chebyshev":
            lam = float(_pcsr_lambda_max(A, d_inv, config.lambda_power_iters,
                                         seed).to(dtype))
        clock.lap("smoother_setup")
        if true_n <= config.n_coarse_max or lvl == config.max_levels - 1:
            levels.append(Level(A, None, None, d_inv, lam, true_n=true_n))
            break
        Sd, So = pcsr_strength(A, config.theta)
        state = pcsr_pmis(A, Sd, So, seed=seed + lvl, stats=info)
        cmap, mc_pad, nc_true = coarse_numbering(A, state)
        clock.lap("strength_pmis")
        if nc_true >= true_n or nc_true == 0:
            levels.append(Level(A, None, None, d_inv, lam, true_n=true_n))
            break
        Pm = pcsr_interpolation(A, Sd, So, state, cmap, mc_pad, config, info)
        clock.lap("interpolation")
        R = pcsr_transpose(Pm, rows_per_shard=mc_pad)
        clock.lap("transpose")
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
