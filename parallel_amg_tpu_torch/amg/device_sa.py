"""On-device algebraic smoothed-aggregation setup (the Vanek-greedy path).

Counterpart of ``parallel_amg_tpu/amg/device_sa.py``: it aggregates any
sparsity on the tensors' device, where the structured block path
(``amg/device_setup.py``) covers regular grids only.  The oracle's greedy
sweep is serial, so the device takes the standard parallel substitute:

1. a distance-2 maximal independent set over the symmetrized strength
   graph, by Luby rounds on random weights (``ops/prng.uniform``, the JAX
   package's draw of ``PRNGKey(seed)``, so the seeds are the JAX package's);
2. every neighbor of a seed joins that seed's aggregate, then the leftovers
   join their strongest-connected (max |a_ij|) aggregated neighbor, then
   anything still alone becomes a singleton;
3. tentative T (width-1 ELL, unit-norm columns), smoothed
   P = (I − (ω/λ_max) D⁻¹A)·T, R = Pᵀ, the Galerkin product RAP and, with
   ``coarse_drop_tol``, a lumped drop of small coarse entries.  Its products
   are ``ell_spgemm``: kernels B3, B5 and B4 on the card.

Index algebra is exact, so the aggregates equal the JAX package's: the
transposes keep the JAX package's slot order (a stable sort by column) and
``torch.argmax`` takes the first maximum, as ``jnp.argmax`` does, so ties
between equal |a_ij| go to the same slot.  The MIS loop reads one flag back
to the host per round; the aggregate and singleton counts are one read each.
"""

from __future__ import annotations

from typing import List

import torch

from parallel_amg_tpu_torch.amg.device_rs import (
    _ell_add,
    _ell_lambda_max,
    _input_ell,
    _rs_finish,
)
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops import prng
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.ell_setup import ell_prune, ell_spgemm, ell_transpose

_NEG = -1e30  # below every score and weight; a float32 value, as in JAX


def _row_iota(A: ELL):
    return torch.arange(A.n_rows, device=A.cols.device)[:, None]


def sa_strength_mask(A: ELL, theta: float):
    """(R, W) bool symmetric SA strength: |a_ij| ≥ θ·sqrt(|a_ii·a_jj|),
    no diagonal."""
    offd = A.mask() & (A.cols != _row_iota(A))
    absa = torch.where(offd, A.vals.abs(), 0.0)
    d = A.diagonal().abs()
    thresh = theta * torch.sqrt(d[:, None] * d[A.cols.long()])
    return offd & (absa >= thresh - 1e-30) & (absa > 0)


def mis_aggregate(A: ELL, S, seed: int = 0, max_rounds: int = 64):
    """Parallel Vanek aggregation: distance-2 MIS seeds and two attach
    passes.  Returns (agg ids (n,) int32 ≥ 0, the aggregate count).

    Seeds are pairwise more than two hops apart, so phase-1 aggregates are
    the disjoint closed neighborhoods of the seeds; phase 2 attaches the
    leftovers to their strongest-connected aggregated neighbor; phase 3
    makes singletons of anything unreachable.
    """
    n = A.n_rows
    dev = A.cols.device
    cols = A.cols.long()
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    St = ell_transpose(ELL(A.cols, S.to(torch.float32), A.row_nnz, (n, n)))
    st_cols = St.cols.long()
    St_mask = St.mask() & (St.vals != 0)

    def nmax(v):
        """Per-node max of v over adjacent nodes (both edge directions)."""
        out = torch.where(S, v[cols], neg).amax(1)
        inn = torch.where(St_mask, v[st_cols], neg).amax(1)
        return torch.maximum(out, inn)

    def reach(f):
        """Any adjacent node in bool set f (both edge directions)."""
        return (S & f[cols]).any(1) | (St_mask & f[st_cols]).any(1)

    w = prng.uniform((n,), seed, torch.float32).to(dev)
    cand = torch.ones(n, dtype=torch.bool, device=dev)
    seeds = torch.zeros(n, dtype=torch.bool, device=dev)
    for _ in range(max_rounds):
        if not bool(cand.any()):  # one host read per round
            break
        wc = torch.where(cand, w, neg)
        # closed two-hop candidate max: M_i ≥ w_i via the back edge, so
        # M_i == w_i (unique floats) ⇔ i maximizes its 2-hop neighborhood
        m2hop = nmax(torch.maximum(wc, nmax(wc)))
        is_max = cand & (m2hop <= w)
        seeds = seeds | is_max
        # everything within two hops of a new seed loses seed-candidacy
        r1 = reach(is_max)
        cand = cand & ~is_max & ~r1 & ~reach(r1)
    seeds = seeds | cand  # leftovers past max_rounds seed themselves

    agg_of_seed = seeds.to(torch.int32).cumsum(0) - 1
    nc = int(agg_of_seed[-1]) + 1  # host read

    At = ell_transpose(ELL(A.cols, torch.where(S, A.vals, 0.0), A.row_nnz,
                           (n, n)))
    at_cols = At.cols.long()
    At_mask = At.mask() & (At.vals != 0)
    absa, abs_at = A.vals.abs(), At.vals.abs()
    rows = torch.arange(n, device=dev)

    def attach(member, agg_now):
        """The agg id of the strongest-|a_ij| neighbor inside ``member``
        and its score, over both edge directions (out-edges win ties)."""
        score_out = torch.where(S & member[cols], absa, neg)
        best_out, arg_out = score_out.max(1).values, score_out.argmax(1)
        agg_out = agg_now[cols[rows, arg_out]]
        score_in = torch.where(At_mask & member[at_cols], abs_at, neg)
        best_in, arg_in = score_in.max(1).values, score_in.argmax(1)
        agg_in = agg_now[at_cols[rows, arg_in]]
        return (torch.where(best_out >= best_in, agg_out, agg_in),
                torch.maximum(best_out, best_in))

    # phase 1: seed neighborhoods (disjoint by the distance-2 property)
    agg = torch.where(seeds, agg_of_seed, -1)
    a1, s1 = attach(seeds, agg)
    agg = torch.where((agg < 0) & (s1 > neg), a1, agg)
    # phase 2: strongest aggregated neighbor for the distance-2 leftovers
    a2, s2 = attach(agg >= 0, agg)
    agg = torch.where((agg < 0) & (s2 > neg), a2, agg)
    # phase 3: singletons for anything still unassigned
    rest = agg < 0
    extra = rest.to(torch.int32).cumsum(0) - 1
    n_extra = int(rest.sum())  # host read
    agg = torch.where(rest, nc + extra, agg)
    return agg.to(torch.int32), nc + n_extra


def device_sa_setup(A, config: AMGConfig, dtype=torch.float32, seed: int = 0,
                    *, device=None) -> Hierarchy:
    """Algebraic SA setup on the device, from a device ELL or a host matrix
    (CSR, COO or scipy; copied to ``device``, the CUDA card when None).

    Per level: λ_max, strength, MIS aggregation, T, P = (I − ω/λ·D⁻¹A)·T
    by one product and an aligned add, R = Pᵀ, A_c = (R·A)·P, sparsified
    and pruned.  Levels stay ELL until ``with_best_formats``.
    """
    assert config.coarsening == "sa", "device_sa_setup is the SA path"
    A_ell = _input_ell(A, dtype, device)
    dev = A_ell.cols.device
    levels: List[Level] = []
    for lvl in range(config.max_levels):
        n = A_ell.n_rows
        diag = A_ell.diagonal()
        d_inv = torch.where(diag != 0, 1.0 / diag, 0.0)
        lam = _ell_lambda_max(A_ell, d_inv, config.lambda_power_iters, seed)
        if n <= config.n_coarse_max or lvl == config.max_levels - 1:
            levels.append(Level(A_ell, None, None, d_inv, float(lam)))
            break
        S = sa_strength_mask(A_ell, config.sa_theta)
        agg, nc = mis_aggregate(A_ell, S, seed=seed + lvl)
        if nc >= n:
            levels.append(Level(A_ell, None, None, d_inv, float(lam)))
            break
        agg_l = agg.long()
        counts = torch.zeros(nc, dtype=A_ell.vals.dtype, device=dev).index_add_(
            0, agg_l, torch.ones(n, dtype=A_ell.vals.dtype, device=dev))
        # tentative T: width-1 ELL with unit-norm columns (the counts are
        # small integers, exact in any order of adds)
        T = ELL(agg[:, None], (1.0 / torch.sqrt(counts.clamp(min=1.0)))[agg_l][:, None],
                torch.ones(n, dtype=torch.int32, device=dev), (n, nc))
        # P = (I − (ω/λ) D⁻¹A) T: one product and an aligned add
        coef = torch.tensor(config.sa_omega, dtype=lam.dtype, device=dev) / \
            lam.clamp(min=1e-30)
        DA = ELL(A_ell.cols, -coef * d_inv[:, None] * A_ell.vals,
                 A_ell.row_nnz, A_ell.shape)
        P = _ell_add(ell_spgemm(DA, T), T)
        R = ell_transpose(P)
        RA = ell_spgemm(R, A_ell)
        # ell_prune sorts the rows; the lumped sparsify sums them first
        A_c = ell_spgemm(RA, P, sort=config.coarse_drop_tol > 0)
        if config.coarse_drop_tol > 0:
            A_c = _ell_sparsify_lumped(A_c, config.coarse_drop_tol)
        A_c = ell_prune(A_c, tol=0.0)
        levels.append(Level(A_ell, P, R, d_inv, float(lam)))
        A_ell = A_c
    return _rs_finish(levels, config)


def _ell_sparsify_lumped(A: ELL, tol: float) -> ELL:
    """Drop |a_ij| < tol·max_k≠i|a_ik|, lump the dropped mass onto the
    diagonal and symmetrize: the device analog of the oracle's
    ``sparsify_lumped``."""
    iota = _row_iota(A)
    offd = A.mask() & (A.cols != iota)
    absa = torch.where(offd, A.vals.abs(), 0.0)
    rowmax = absa.amax(1)
    drop = offd & (absa < tol * rowmax[:, None])
    lump = torch.where(drop, A.vals, 0.0).sum(1)
    vals = torch.where(drop, 0.0, A.vals)
    isdiag = A.mask() & (A.cols == iota)
    vals = vals + torch.where(isdiag, lump[:, None], 0.0)
    kept = ell_prune(ELL(A.cols, vals, A.row_nnz, A.shape), tol=0.0)
    # symmetrize: 0.5 (A + Aᵀ) keeps the coarse solve SPD-safe
    ktT = ell_transpose(kept)
    half = ELL(kept.cols, 0.5 * kept.vals, kept.row_nnz, kept.shape)
    halfT = ELL(ktT.cols, 0.5 * ktT.vals, ktT.row_nnz, ktT.shape)
    return _ell_add(half, halfT)
