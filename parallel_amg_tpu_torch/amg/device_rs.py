"""On-device classical (Ruge–Stüben) AMG setup — the algebraic path.

Counterpart of ``parallel_amg_tpu/amg/device_rs.py``.  Every O(n) and
O(nnz) step runs on the tensors' device over ELL planes; the host decides
shapes (one width read per product, one read per PMIS round):

- classical strength: rowwise max and mask;
- PMIS splitting: Luby-style independent-set rounds over the symmetrized
  strength graph, with random weights from ``pmis_weights``;
- interpolation, three tiers (``config.interpolation``): "extended_i" (true
  distance-two extended+i, in row chunks), "smoothed_direct" (direct plus
  one Jacobi pass, truncated to p_max) and "direct";
- Galerkin: R = ell_transpose(P), RA = ell_spgemm(R, A),
  A_c = ell_prune(ell_spgemm(RA, P)), on kernels B3, B5 and B4 on the card.

Every float sum is taken in the JAX package's CPU order, so a second setup
on the card is bit-equal to the first and to the JAX package's: row sums go
through ``ops/ordered_sum.row_sum`` (XLA's order; LLVM's vectorised one for
extended+i's weak couplings, ``ordered_sum.weak_lanes``); ``ell_spgemm`` adds
each product's terms in the order of the JAX package's ESC product;
``index_add_`` on CUDA adds duplicates with atomics in no fixed order, so
duplicate merges add sorted runs left to right instead; ties in ``top_k`` go
to the lower index, as ``lax.top_k`` does; maxima scatter with ``amax``,
which is exact in any order.

The JAX package's fused driver, its shape-schedule replay and its dispatch
probe work around a remote TPU's dispatch latency and are not ported;
``device_rs_setup`` takes ``fused=`` and ignores it.  The hierarchy it
returns carries its per-level shapes and seconds per phase in
``setup_stats``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg import device_setup
from parallel_amg_tpu_torch.amg.hierarchy import (
    Hierarchy,
    Level,
    _host_csr,
    coarse_inverse_np,
)
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.device import resolve_device
from parallel_amg_tpu_torch.ops import ordered_sum, prng
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.ell_setup import (
    ell_prune,
    ell_spgemm,
    ell_transpose,
)
from parallel_amg_tpu_torch.ops.ordered_sum import row_sum

UNDECIDED, FINE, COARSE = 0, 1, 2

# Elements of extended+i's (chunk, f_max, W, K) membership table per chunk:
# the JAX package's 64 MB; the card takes 256 MB, and rows are independent.
_EXT_I_BUDGET = {"cpu": 1 << 26, "cuda": 1 << 28}
_EXT_I_MAX_ROWS = {"cpu": 4096, "cuda": 1 << 18}


def topk_stable(x, k: int):
    """(values, indices) of the k largest entries of each row of x, the
    lower index first among equal values (the order of ``lax.top_k``)."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _truncate(w, cols, p_max: int):
    """Each row's p_max largest-|w| entries (w is 0 off the pattern),
    rescaled so the row keeps its sum: (vals, cols, kept), 0 where not kept."""
    topv, topi = topk_stable(w.abs(), min(p_max, w.shape[1]))
    pv = w.gather(1, topi)
    kept = topv > 0
    keptsum = row_sum(torch.where(kept, pv, 0.0))
    scale = torch.where(keptsum != 0, row_sum(w) / torch.where(
        keptsum == 0, 1.0, keptsum), 1.0)
    return (torch.where(kept, pv * scale[:, None], 0.0),
            torch.where(kept, cols.gather(1, topi), 0), kept)


def pmis_weights(n: int, seed: int, device):
    """PMIS tie-break weights: the JAX package's ``uniform`` draw in
    [0, 1), made on the host and copied to ``device``."""
    return prng.uniform((n,), seed, torch.float32).to(device)


def classical_strength_mask(A: ELL, theta: float):
    """(R, W) bool strong-connection mask: |a_ij| ≥ θ·max_{k≠i}|a_ik|."""
    r_iota = torch.arange(A.n_rows, device=A.cols.device)[:, None]
    offd = A.mask() & (A.cols != r_iota)
    absa = torch.where(offd, A.vals.abs(), 0.0)
    rowmax = absa.amax(1)
    return offd & (absa >= theta * rowmax[:, None]) & (absa > 0)


def pmis_split_device(A: ELL, S, seed: int = 0, max_rounds: int = 64):
    """PMIS C/F splitting. Returns (n,) int32 of FINE/COARSE.

    The symmetrized local-max test needs, for each i, the max weight over
    undecided j with S[j, i]; it is a scatter-max of S's entries by column
    (exact in any order), so Sᵀ is never built.
    """
    n = A.n_rows
    dev = A.cols.device
    cols = A.cols.long()
    flat_c = cols.reshape(-1)
    strong_in = torch.bincount(flat_c[S.reshape(-1)], minlength=n)
    w = strong_in.to(torch.float32) + pmis_weights(n, seed, dev)

    # isolated points (no strong connections either way) → COARSE
    state = torch.where(S.any(1) | (strong_in > 0), UNDECIDED, COARSE)
    for _ in range(max_rounds):
        und = state == UNDECIDED
        if not bool(und.any()):
            break
        m1 = torch.where(S & und[cols], w[cols], -1.0).amax(1)
        contrib = torch.where(S & und[:, None], w[:, None], -1.0)
        m2 = torch.full((n,), -1.0, device=dev).scatter_reduce_(
            0, flat_c, contrib.reshape(-1), reduce="amax")
        state = torch.where(und & (w > torch.maximum(m1, m2)), COARSE, state)
        # undecided points that strongly depend on a COARSE point → FINE
        dep_c = (S & (state[cols] == COARSE)).any(1)
        state = torch.where((state == UNDECIDED) & dep_c, FINE, state)
    return torch.where(state == UNDECIDED, COARSE, state).to(torch.int32)


def _coarse_map(state):
    """(n,) int64 coarse index of each point (−1 before the first C point)
    and the coarse count (one host read)."""
    cmap = (state == COARSE).long().cumsum(0) - 1
    return cmap, int(cmap[-1]) + 1 if cmap.numel() else 0


def _identity_rows(is_c, own_cid, pv, pc):
    """Overwrite C rows with the identity onto their own coarse index."""
    first = torch.zeros(pv.shape[1], dtype=torch.bool, device=pv.device)
    first[0] = True
    pv = torch.where(is_c[:, None], first.to(pv.dtype), pv)
    pc = torch.where(is_c[:, None], torch.where(first, own_cid[:, None], 0), pc)
    return pv, pc


def direct_interpolation_device(A: ELL, S, state, p_max: int) -> ELL:
    """Classical direct interpolation (width p_max).  C rows carry the
    identity; F rows distribute over strong C neighbors with the
    positive/negative split (as oracle.direct_interpolation)."""
    n = A.n_rows
    r_iota = torch.arange(n, device=A.cols.device)[:, None]
    m = A.mask()
    offd = m & (A.cols != r_iota)
    a = torch.where(m, A.vals, 0.0)
    strong_c = S & (state[A.cols.long()] == COARSE)

    neg = offd & (a < 0)
    pos = offd & (a > 0)
    sum_n_neg = row_sum(torch.where(neg, a, 0.0))
    sum_n_pos = row_sum(torch.where(pos, a, 0.0))
    sum_c_neg = row_sum(torch.where(strong_c & neg, a, 0.0))
    sum_c_pos = row_sum(torch.where(strong_c & pos, a, 0.0))
    diag = row_sum(torch.where(A.cols == r_iota, a, 0.0))
    diag = diag + torch.where(sum_c_pos == 0.0, sum_n_pos, 0.0)
    alpha = torch.where(sum_c_neg != 0, sum_n_neg / torch.where(
        sum_c_neg == 0, 1.0, sum_c_neg), 0.0)
    beta = torch.where(sum_c_pos != 0, sum_n_pos / torch.where(
        sum_c_pos == 0, 1.0, sum_c_pos), 0.0)
    coef = torch.where(a < 0, alpha[:, None], beta[:, None])
    wts = torch.where(strong_c, -coef * a / diag[:, None], 0.0)

    cmap, nc = _coarse_map(state)
    pv, pc, kept = _truncate(wts, torch.where(strong_c, cmap[A.cols.long()], 0),
                             p_max)
    is_c = state == COARSE
    pv, pc = _identity_rows(is_c, cmap, pv, pc)
    row_nnz = torch.where(is_c, 1, kept.sum(1)).to(torch.int32)
    return ELL(pc.to(torch.int32), pv, row_nnz, (n, nc))


def _compact_masked(cols, vals, mask, w_max: int | None = None):
    """Per-row compaction of masked ELL entries to the front, order kept.

    Returns (cols', vals', mask') of width w_max (default: the widest row,
    one host read)."""
    order = torch.sort(torch.where(mask, 0, 1), dim=1, stable=True).indices
    if w_max is None:
        w_max = max(int(mask.sum(1).max()) if mask.numel() else 0, 1)
    order = order[:, :w_max]
    return cols.gather(1, order), vals.gather(1, order), mask.gather(1, order)


def _merge_sorted_runs(cols_s, vals_s, valid_s):
    """Leaders of runs of equal columns in rows sorted by column, and each
    leader's run sum added left to right (one host read per run step).

    Returns (leader, sums): sums[r, j] is the sum of leader j's run."""
    leader = valid_s.clone()
    leader[:, 1:] &= cols_s[:, 1:] != cols_s[:, :-1]
    sums = torch.where(leader, vals_s, 0.0)
    W = cols_s.shape[1]
    for t in range(1, W):
        same = leader[:, :-t] & valid_s[:, t:] & (cols_s[:, t:] == cols_s[:, :-t])
        if not bool(same.any()):
            break
        sums[:, :-t] = torch.where(same, sums[:, :-t] + vals_s[:, t:],
                                   sums[:, :-t])
    return leader, sums


def _ext_i_row_chunk(f_max: int, W: int, K: int, device) -> int:
    kind = "cuda" if device.type == "cuda" else "cpu"
    per_row = max(f_max * W * K, 1)
    return max(min(_EXT_I_MAX_ROWS[kind], _EXT_I_BUDGET[kind] // per_row), 16)


def extended_i_interpolation_device(A: ELL, S, state, p_max: int,
                                    row_chunk: int | None = None,
                                    stats: dict | None = None) -> ELL:
    """True distance-two extended+i interpolation (the hypre-style PMIS
    partner), in row chunks.

    For F-point i the interpolatory set Ĉ_i is its strong C-neighbors plus
    the strong C-neighbors of its strong F-neighbors; each strong-F coupling
    a_ik distributes over (Ĉ_i ∪ {i}) ∩ row(k) proportionally to same-sign
    couplings, the i-share and weak couplings lump onto the diagonal, and
    rows truncate to the p_max largest |w| with row-sum rescale.  Set
    membership is a (chunk, f_max, W, K) comparison table,
    K = c_max·(1 + f_max); ``row_chunk`` rows per chunk bound it.  ``stats``,
    where given, receives the chunk count.
    """
    n = A.n_rows
    W = A.width
    dev = A.cols.device
    Am = A.mask()
    colsl = A.cols.long()
    st_j = state[colsl]
    strong_c = S & (st_j == COARSE)
    strong_f = S & (st_j != COARSE)

    CC, _, CCm = _compact_masked(A.cols, A.vals, strong_c)
    FF, FFa, FFm = _compact_masked(A.cols, A.vals, strong_f)
    CC, FF = CC.long(), FF.long()
    c_max, f_max = CC.shape[1], FF.shape[1]
    K = c_max * (1 + f_max)
    cmap, nc = _coarse_map(state)
    if row_chunk is None:
        row_chunk = _ext_i_row_chunk(f_max, W, K, dev)
    weak_lanes = ordered_sum.weak_lanes(
        W, ordered_sum.jax_row_chunks(n, f_max, W, K) > 1)
    SENT = n
    pcs, pvs, rns = [], [], []
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        ch = r1 - r0
        rid = torch.arange(r0, r1, device=dev)
        ac, av, am = colsl[r0:r1], A.vals[r0:r1], Am[r0:r1]
        sf = strong_f[r0:r1]
        fF, fFa, fFm = FF[r0:r1], FFa[r0:r1], FFm[r0:r1]
        # Ĉ_i candidate table (global row ids; may hold duplicates)
        Ckm = CCm[fF] & fFm[..., None]                      # (ch, f_max, c_max)
        chat = torch.cat([torch.where(CCm[r0:r1], CC[r0:r1], SENT),
                          torch.where(Ckm, CC[fF], SENT).reshape(ch, -1)], 1)
        chat_ok = chat < SENT

        # own-entry pass
        isdiag = (ac == rid[:, None]) & am
        in_chat = ((ac[:, :, None] == chat[:, None, :])
                   & chat_ok[:, None, :]).any(2)
        own_num = torch.where(am & in_chat & ~isdiag, av, 0.0)
        diag = row_sum(torch.where(isdiag, av, 0.0))
        diag = diag + row_sum(torch.where(am & ~isdiag & ~in_chat & ~sf, av, 0.0),
                              lanes=weak_lanes)

        # strong-F distribution
        kr_c = colsl[fF]                                    # (ch, f_max, W)
        kr_v = A.vals[fF]
        kr_m = Am[fF] & fFm[..., None]
        sign_ok = kr_v * fFa[..., None] > 0
        m_is_i = kr_c == rid[:, None, None]
        m_in_chat = ((kr_c[..., None] == chat[:, None, None, :])
                     & chat_ok[:, None, None, :]).any(3)
        dist_m = kr_m & sign_ok & (m_in_chat | m_is_i)
        denom = row_sum(torch.where(dist_m, kr_v, 0.0))
        has_d = denom != 0
        share = torch.where(
            dist_m & has_d[..., None],
            fFa[..., None] * kr_v / torch.where(denom == 0, 1.0,
                                                denom)[..., None], 0.0)
        diag = diag + row_sum(torch.where(fFm & ~has_d, fFa, 0.0))
        diag = diag + row_sum(torch.where(m_is_i, share, 0.0), 2)

        cand_c = torch.cat([
            torch.where(own_num != 0, ac, SENT),
            torch.where((share != 0) & ~m_is_i, kr_c, SENT).reshape(ch, -1)], 1)
        cand_v = torch.cat([
            own_num, torch.where(~m_is_i, share, 0.0).reshape(ch, -1)], 1)
        cand_v = torch.where(cand_c < SENT, cand_v, 0.0)

        # merge by global C id (sorted runs, left to right), w = −num/diag
        cols_s, order = torch.sort(cand_c, dim=1, stable=True)
        vals_s = cand_v.gather(1, order)
        leader, sums = _merge_sorted_runs(cols_s, vals_s, cols_s < SENT)
        dcol, dsum, live = _compact_masked(cols_s, sums, leader,
                                           leader.shape[1])
        safe_diag = torch.where(diag == 0, 1.0, diag)
        wts = torch.where(live, -dsum / safe_diag[:, None], 0.0)

        # truncate to p_max (|w| top-k, row-sum rescale); kept columns are
        # live, so below SENT
        pv, pcg, kept = _truncate(wts, dcol, p_max)
        pc = torch.where(kept, cmap[pcg], 0)

        is_c = state[r0:r1] == COARSE
        pv, pc = _identity_rows(is_c, cmap[r0:r1], pv, pc)
        pcs.append(pc.to(torch.int32))
        pvs.append(pv)
        rns.append(torch.where(is_c, 1, kept.sum(1)).to(torch.int32))
    if stats is not None:
        stats["interp_chunks"] = len(pcs)
        stats["ext_i"] = {"W": W, "f_max": f_max, "c_max": c_max,
                          "candidates": W * (1 + f_max)}
    return ELL(torch.cat(pcs), torch.cat(pvs), torch.cat(rns), (n, nc))


def _ell_add(X: ELL, Y: ELL) -> ELL:
    """X + Y for ELLs of one shape: sort each row's entries by column,
    merge equal columns left to right (X before Y), compact."""
    n, nc = X.shape
    valid = torch.cat([X.mask(), Y.mask()], 1)
    key = torch.where(valid, torch.cat([X.cols, Y.cols], 1), nc)
    vals = torch.where(valid, torch.cat([X.vals, Y.vals], 1), 0.0)
    cols_s, order = torch.sort(key, dim=1, stable=True)
    vals_s = vals.gather(1, order)
    leader, sums = _merge_sorted_runs(cols_s, vals_s, cols_s < nc)
    ocols, ovals, live = _compact_masked(cols_s, sums, leader)
    return ELL(torch.where(live, ocols, 0).to(torch.int32),
               torch.where(live, ovals, 0.0), leader.sum(1).to(torch.int32),
               (n, nc))


def _ell_topk(P: ELL, p_max: int) -> ELL:
    """Keep the p_max largest-|v| entries per row, rescaled to preserve row
    sums (device analog of oracle.truncate_P)."""
    pv, pc, kept = _truncate(torch.where(P.mask(), P.vals, 0.0), P.cols, p_max)
    return ELL(pc.to(torch.int32), pv, kept.sum(1).to(torch.int32), P.shape)


def smooth_interpolation(A: ELL, P: ELL, omega: float, p_max: int) -> ELL:
    """P ← (I − ω D⁻¹A) P, truncated to p_max entries per row (row sums
    kept): the Jacobi improvement of direct interpolation."""
    d = A.diagonal()
    d_inv = torch.where(d != 0, 1.0 / d, 0.0)
    DA = ELL(A.cols, -omega * d_inv[:, None] * A.vals, A.row_nnz, A.shape)
    AP = ell_spgemm(DA, P)
    n = A.n_rows
    dev = A.cols.device
    eye = ELL(torch.arange(n, dtype=torch.int32, device=dev)[:, None],
              torch.ones((n, 1), dtype=P.vals.dtype, device=dev),
              torch.ones(n, dtype=torch.int32, device=dev), (n, n))
    P2 = ell_spgemm(eye, P)  # P re-compacted in the product's layout
    return _ell_topk(_ell_add(P2, AP), p_max)


def _ell_lambda_max(A: ELL, d_inv, iters: int, seed: int = 0):
    """λ_max(D⁻¹A) estimate (1.1 safety factor) as a 0-d tensor; the start
    vector is ``device_setup.start_vector``.  The matvec's row sums and the
    norm add in the JAX package's CPU order (``ordered_sum.ell_dot_lanes``,
    ``ordered_sum.sumsq``), so a float32 λ is its value bit for bit (other
    types take torch's order); the solve path's ``ELL.matvec`` keeps
    torch's order."""
    x = device_setup.start_vector((A.n_rows,), A.vals.dtype, A.vals.device,
                                  seed)
    ordered = A.vals.dtype == torch.float32
    lanes = ordered_sum.ell_dot_lanes(A.vals.shape[1])
    cols = A.cols.long()
    lam = torch.ones((), dtype=x.dtype, device=x.device)
    for _ in range(iters):
        if ordered:
            y = d_inv * ordered_sum.row_dot(A.vals, x[cols], lanes)
            nrm = ordered_sum.norm(y)
        else:
            y = d_inv * A.matvec(x)
            nrm = torch.linalg.norm(y)
        lam = torch.where(nrm > 0, nrm, lam)
        x = y / torch.clamp(nrm, min=1e-30)
    return 1.1 * lam


class _Clock:
    """Seconds per setup phase; each lap waits for the devices first."""

    def __init__(self, *devices):
        self.devices = {d for d in devices if d.type == "cuda"}
        self.seconds: dict = {}
        self._t = time.perf_counter()

    def lap(self, phase: str) -> None:
        for d in self.devices:
            torch.cuda.synchronize(d)
        now = time.perf_counter()
        self.seconds[phase] = self.seconds.get(phase, 0.0) + now - self._t
        self._t = now


def _input_ell(A, dtype, device) -> ELL:
    """A device ELL from an ELL, a host CSR, COO or a scipy matrix."""
    if isinstance(A, ELL):
        return A if device is None else A.to(device)
    return ELL.from_csr(_host_csr(A), dtype=dtype).to(resolve_device(device))


def device_rs_setup(A, config: AMGConfig, dtype=torch.float32, seed: int = 0,
                    fused=None, *, device=None) -> Hierarchy:
    """Classical-AMG setup on the device, from a device ELL or a host matrix
    (copied to ``device``, the CUDA card when None).

    Per level: strength, PMIS, interpolation, R = Pᵀ, RA = R·A,
    A_c = prune(RA·P).  ``fused`` is accepted for the JAX signature and
    ignored: the JAX package's fused driver batches work into few programs
    to hide a remote TPU's dispatch latency, which a local card does not
    have.
    """
    del fused
    A_ell = _input_ell(A, dtype, device)
    dev = A_ell.cols.device
    clock = _Clock(dev)
    shapes = []
    levels: List[Level] = []
    for lvl in range(config.max_levels):
        n = A_ell.n_rows
        info = {"rows": n, "nnz": A_ell.nnz, "width": A_ell.width}
        shapes.append(info)
        diag = A_ell.diagonal()
        d_inv = torch.where(diag != 0, 1.0 / diag, 0.0)
        lam = 0.0
        if config.smoother == "chebyshev":
            lam = float(_ell_lambda_max(A_ell, d_inv,
                                        config.lambda_power_iters, seed))
        clock.lap("smoother_setup")
        if n <= config.n_coarse_max or lvl == config.max_levels - 1:
            levels.append(Level(A_ell, None, None, d_inv, lam))
            break
        S = classical_strength_mask(A_ell, config.theta)
        state = pmis_split_device(A_ell, S, seed=seed + lvl)
        clock.lap("strength_pmis")
        if config.interpolation == "extended_i":
            P = extended_i_interpolation_device(A_ell, S, state, config.p_max,
                                                stats=info)
        else:
            P = direct_interpolation_device(A_ell, S, state, config.p_max * 2)
            if config.interpolation == "smoothed_direct":
                P = smooth_interpolation(A_ell, P, config.jacobi_omega,
                                         config.p_max)
        clock.lap("interpolation")
        info["P_width"] = P.width
        if P.n_cols >= n:
            levels.append(Level(A_ell, None, None, d_inv, lam))
            break
        R = ell_transpose(P)
        clock.lap("transpose")
        RA = ell_spgemm(R, A_ell)
        info["RA"] = {"K": R.width * A_ell.width, "w": RA.width}
        A_c = ell_spgemm(RA, P, sort=False)  # ell_prune sorts the rows
        info["RAP"] = {"K": RA.width * P.width, "w": A_c.width}
        A_c = ell_prune(A_c, tol=0.0)
        clock.lap("products")
        levels.append(Level(A_ell, P, R, d_inv, lam))
        A_ell = A_c
    h = _rs_finish(levels, config)
    clock.lap("coarse_inverse")
    h.setup_stats = {"levels": shapes, "seconds": clock.seconds}
    return h


def _rs_finish(levels: List[Level], config: AMGConfig) -> Hierarchy:
    """The hierarchy with the dense coarse inverse (float64 eigh on the
    host, stored float32 on the levels' device)."""
    last = levels[-1].A
    coarse_inv = torch.from_numpy(coarse_inverse_np(
        np.asarray(last.to_csr().to_dense(), np.float64))).to(torch.float32)
    return Hierarchy(levels, coarse_inv.to(last.cols.device), config)
