"""Distributed COO→PCSR assembly on the parts' devices (SURVEY.md §3.4).

Counterpart of ``parallel_amg_tpu/parallel/passembly_device.py``, the
``psparse`` analog with no host-global matrix: each part contributes a
padded block of (row, col, val) triplets — duplicates and off-owner rows
legal (finite-element assembly semantics) — and the parts route,
deduplicate and freeze them into the PCSR own/ghost split-block layout:

    1. owner bucketing      — rank-in-bucket via stable sort + searchsorted
    2. triplet routing      — one ``exchange.all_to_all`` of (S, K) buckets
    3. local sort + dedup   — stable sort by (row, col), run sums in order
    4. diag/ghost split     — ELL scatter with per-row slot ranks
    5. ghost discovery      — sorted-unique ghost gids per part
    6. halo-plan build      — recv_map computed locally (the j-index an
       owner assigns to a request equals the rank the requester assigned),
       send_idx via one all_to_all of the request tables

Every shape is fixed by the capacities (K route, W ell, G ghost, C per-pair
send), and every overflow is counted and raised, never dropped in silence.
The sorts are stable and duplicate runs are summed left to right
(``segment.segment_sum``), so the planes and plans equal the JAX package's
array for array, and a rerun on the card is bit-equal.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.partition import Partition
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.segment import segment_max, segment_min, segment_sum

_BIG = 2**31 - 1
_OVERFLOW_NAMES = ("route_capacity", "ell/off_width", "ghost_capacity",
                   "send_capacity")


def _rank_in_group(sort_keys, n_groups: int):
    """Given group ids sorted ascending (invalid = n_groups), each
    position's rank within its group."""
    T = sort_keys.shape[0]
    starts = torch.searchsorted(sort_keys,
                                torch.arange(n_groups + 1, device=sort_keys.device))
    return torch.arange(T, device=sort_keys.device) - starts[sort_keys.clamp(0, n_groups)]


def _scatter(size: int, idx, src, fill):
    """(size,) tensor of ``fill`` with src written at idx (an index of size
    − 1 is the trash slot; the caller drops it)."""
    out = torch.full((size,), fill, dtype=src.dtype, device=src.device)
    out[idx] = src
    return out


def _route(r, c, v, *, S, m, K):
    """Steps 1–2 on one part: bucket triplets by owner into (S, K) send
    buffers.  Returns the buffers and the route overflow count."""
    valid = r >= 0
    owner = torch.where(valid, torch.clamp(torch.div(r, m, rounding_mode="floor"),
                                           max=S - 1), S)
    order = torch.sort(owner, stable=True).indices
    so, sr, sc, sv = owner[order], r[order], c[order], v[order]
    pos = _rank_in_group(so, S)
    in_cap = (so < S) & (pos < K)
    overflow = ((so < S) & (pos >= K)).sum()
    flat = torch.where(in_cap, so * K + pos, S * K)
    bufr = _scatter(S * K + 1, flat, sr, -1)[: S * K].reshape(S, K)
    bufc = _scatter(S * K + 1, flat, sc, 0)[: S * K].reshape(S, K)
    bufv = _scatter(S * K + 1, flat, sv, 0)[: S * K].reshape(S, K)
    return bufr, bufc, bufv, overflow


def _assemble_part(me, rr, cc, vv, *, S, m, mc, Wd, Wo, G, C):
    """Steps 3–5 and the local half of 6 on part ``me`` over its received
    triplets.  Returns (dc, dv, oc, ov, recv_map, request table, overflow
    counts)."""
    dev = rr.device
    N = rr.shape[0]
    # ---- 3. sort by (local row, col), sum duplicate runs -----------------
    ok = rr >= 0
    lr = torch.where(ok, rr - me * m, m)  # invalid rows sort last
    o1 = torch.sort(cc, stable=True).indices
    o2 = torch.sort(lr[o1], stable=True).indices
    ordl = o1[o2]
    lr, cc, vv, ok = lr[ordl], cc[ordl], vv[ordl], ok[ordl]
    prev_same = (lr == torch.roll(lr, 1)) & (cc == torch.roll(cc, 1))
    prev_same[0] = False
    newrun = ~prev_same | ~ok  # every invalid entry is a run of its own
    run_id = torch.cumsum(newrun.long(), 0) - 1
    run_val = segment_sum(torch.where(ok, vv, 0.0), run_id, N, sorted_ids=True)
    run_lr = segment_max(torch.where(ok, lr, -1), run_id, N, -_BIG - 1)
    run_cc = segment_max(torch.where(ok, cc, -1), run_id, N, -_BIG - 1)
    run_ok = run_lr >= 0

    # ---- 4. diag / offdiag split with per-row ELL slots ------------------
    run_idx = torch.arange(N, device=dev)
    cown = torch.clamp(torch.div(run_cc.clamp(min=0), mc, rounding_mode="floor"),
                       max=S - 1)
    isdiag = run_ok & (cown == me)
    isoff = run_ok & ~isdiag
    seg_rows = torch.where(run_ok, run_lr, m)
    first_of_row = segment_min(run_idx, seg_rows, m + 1, _BIG)[:m]
    fr = first_of_row[run_lr.clamp(0, m - 1)].clamp(max=N - 1)

    def row_slot(flag):
        cs = torch.cumsum(flag.long(), 0)
        base = cs[fr] - flag[fr].long()
        return cs - 1 - base

    slot_d = row_slot(isdiag)
    slot_o = row_slot(isoff)
    ell_overflow = ((isdiag & (slot_d >= Wd)).sum()
                    + (isoff & (slot_o >= Wo)).sum())
    dflat = torch.where(isdiag & (slot_d < Wd), run_lr * Wd + slot_d, m * Wd)
    dc = _scatter(m * Wd + 1, dflat, (run_cc - me * mc).clamp(min=0), 0)
    dv = _scatter(m * Wd + 1, dflat, run_val, 0)

    # ---- 5. ghost discovery (sorted unique off-part cols) ----------------
    gsort = torch.sort(torch.where(isoff, run_cc, _BIG)).values
    gnew = gsort != torch.roll(gsort, 1)
    gnew[0] = True
    gnew &= gsort < _BIG
    grank = torch.cumsum(gnew.long(), 0) - 1
    ghost_overflow = (gnew & (grank >= G)).sum()
    gflat = torch.where(gnew & (grank < G), grank, G)
    ghost_gids = _scatter(G + 1, gflat, gsort, _BIG)[:G]
    gslot = torch.searchsorted(ghost_gids, run_cc.clamp(min=0))
    oflat = torch.where(isoff & (slot_o < Wo), run_lr * Wo + slot_o, m * Wo)
    oc = _scatter(m * Wo + 1, oflat, gslot.clamp(0, G - 1), 0)
    ov = _scatter(m * Wo + 1, oflat, run_val, 0)

    # ---- 6. halo plan: recv_map locally, the request table to send -------
    gvalid = ghost_gids < _BIG
    gown = torch.clamp(torch.div(ghost_gids, mc, rounding_mode="floor"), max=S - 1)
    first_of_owner = torch.searchsorted(
        ghost_gids, torch.arange(S, device=dev) * mc)
    orank = torch.arange(G, device=dev) - first_of_owner[gown]
    send_overflow = (gvalid & (orank >= C)).sum()
    inplan = gvalid & (orank < C)
    recv_map = torch.where(inplan, gown * C + orank, S * C)
    req = _scatter(S * C + 1, recv_map, (ghost_gids - gown * mc).clamp(min=0),
                   0)[: S * C].reshape(S, C)
    overflow = torch.stack([ell_overflow, ghost_overflow, send_overflow])
    return (dc[: m * Wd].reshape(m, Wd), dv[: m * Wd].reshape(m, Wd),
            oc[: m * Wo].reshape(m, Wo), ov[: m * Wo].reshape(m, Wo),
            recv_map, req, overflow)


def _per_part(a, mesh, dtype):
    """This process's 1-D triplet blocks from a PGrid, a list of every
    part's or of the local parts' blocks, or an (S, T) array."""
    if isinstance(a, PGrid):
        parts = a.parts
    elif isinstance(a, (list, tuple)):
        parts = list(a)
    else:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        parts = list(t.unbind(0))
    if len(parts) == mesh.size:
        parts = [parts[p] for p in mesh.local]
    elif len(parts) != mesh.n_local:
        raise ValueError(f"need one triplet block per part: {len(parts)} blocks, "
                         f"{mesh.size} parts")
    return [b.reshape(-1).to(device=mesh.device(p), dtype=dtype)
            for b, p in zip(parts, mesh.local)]


def pcsr_from_coo_device(rows, cols, vals, shape, mesh, *,
                         rows_per_shard=None, ell_width=8, off_width=8,
                         route_capacity=None, ghost_capacity=None,
                         send_capacity=None, dtype=torch.float32,
                         pad_identity=True, check_overflow=True) -> PCSR:
    """Assemble a PCSR from per-part triplet blocks on the parts' devices.

    rows/cols/vals: one block per part (an (S, T) array or tensor, a list of
    per-part tensors or a PGrid, as ``PCSR.to_triplets`` returns), global
    ids; padding entries have ``rows == -1``.  Duplicates sum; off-owner rows
    go to their owners through one ``exchange.all_to_all``.

    Capacities fix every shape; every overflow is counted on the devices and
    raised here (one host read), never truncated in silence.
    """
    n_rows, n_cols = (int(s) for s in shape)
    S = mesh.size
    rows = _per_part(rows, mesh, torch.long)
    cols = _per_part(cols, mesh, torch.long)
    vals = _per_part(vals, mesh, dtype)
    T = exchange.max_int([r.numel() for r in rows], rows[0].device)
    m = rows_per_shard or -(-n_rows // S)
    mc = m if n_rows == n_cols else -(-n_cols // S)
    K = route_capacity or T
    G = ghost_capacity or max(2 * mc, 64)
    C = send_capacity or G
    row_part = Partition(n_rows, S, m)
    col_part = Partition(n_cols, S, mc)

    routed = [_route(r, c, v, S=S, m=m, K=K) for r, c, v in zip(rows, cols, vals)]
    rr = [x.reshape(-1) for x in exchange.all_to_all([t[0] for t in routed])]
    cc = [x.reshape(-1) for x in exchange.all_to_all([t[1] for t in routed])]
    vv = [x.reshape(-1) for x in exchange.all_to_all([t[2] for t in routed])]
    parts = [_assemble_part(p, rr[i], cc[i], vv[i], S=S, m=m, mc=mc,
                            Wd=ell_width, Wo=off_width, G=G, C=C)
             for i, p in enumerate(mesh.local)]
    send_idx = exchange.all_to_all([t[5] for t in parts])
    dc, dv, oc, ov = ([t[i] for t in parts] for i in range(4))
    rmap = [t[4] for t in parts]

    if pad_identity and n_rows == n_cols:
        for i, p in enumerate(mesh.local):
            r = torch.arange(m, device=dc[i].device)
            is_pad = (p * m + r) >= n_rows
            dc[i][:, 0] = torch.where(is_pad, r, dc[i][:, 0])
            dv[i][:, 0] = torch.where(is_pad, torch.ones((), dtype=dtype,
                                                         device=dv[i].device),
                                      dv[i][:, 0])

    # one host read: the overflow counts and the plan's true extents
    of = exchange.psum([torch.cat([t[3].reshape(1), x[6]]) for t, x in
                        zip(routed, parts)]).cpu().numpy()
    if check_overflow:
        for name, cnt in zip(_OVERFLOW_NAMES, of):
            if cnt:
                raise ValueError(
                    f"device assembly overflow: {name} too small "
                    f"({int(cnt)} entries dropped) — raise the capacity")

    # Compact the halo plan to the TRUE ghost/send counts: the capacities
    # are upper bounds, and keeping them as the plan size would make every
    # exchange pay for the allowance (and setups that size the next level's
    # capacity from this G would compound it).  Ghost slots are a per-part
    # prefix by construction, so slicing is exact.
    ext = []
    for t in rmap:
        valid = t < S * C
        ext.append(torch.stack([valid.sum(),
                                torch.where(valid, t % C + 1, 0).max().long()]))
    G_true, C_true = (max(int(e), 1) for e in exchange.pmax(ext).cpu())
    if G_true < G or C_true < C:
        rmap = [torch.where(t < S * C, torch.div(t, C, rounding_mode="floor") * C_true
                            + t % C, S * C_true)[:G_true] for t in rmap]
        send_idx = [s[:, :C_true] for s in send_idx]

    return PCSR([t.to(torch.int32) for t in dc], dv,
                [t.to(torch.int32) for t in oc], ov,
                [s.to(torch.int32).contiguous() for s in send_idx],
                [t.to(torch.int32) for t in rmap], mesh, row_part, col_part,
                (n_rows, n_cols))
