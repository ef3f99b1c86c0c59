"""Candidate float32 orders of the sharded power iteration's last step, for
telling them apart on a given input (``tests/test_torch_p468_order.py`` and
``scripts/jax_p468_power.py --port``).

``run_port_power`` runs the port's ``pdevice_setup._sharded_power`` and keeps
every iterate it normalises.  ``candidate_lams`` then takes the last
iteration again in other orders and gives λ for each:

- ``norm_partials``: a part's Σ y² over its (p0, p1, p2) window partials in
  LLVM's lanes over the flattened partials ((8, 1, 0) and (4, 2, 0)), or in
  lanes across the middle axis padded to a power of two, instead of the
  port's chain (p1 not 2, 4 or 8);
- ``all_reduce``: the parts' sums right to left, or as a pairwise tree,
  instead of left to right;
- ``matvec``: the interior chain in plain offset order (no
  ``STENCIL_FIRST``), and, at 7 points, with the centre unfused.

A seed decides between the port's order and a candidate where their λ
differ.  Every candidate is computed from the port's own iterates, so a λ
equal to the port's means the input cannot tell that candidate apart.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.ops import ordered_stencil, ordered_sum
from parallel_amg_tpu_torch.parallel import pdevice_setup as pd


def run_port_power(A, iters: int, seed: int = 0):
    """(λ, [(y, ‖y‖)] of every iteration, D⁻¹) of the port's
    ``_sharded_power`` on the ShardedStencil A."""
    seen = []
    inner = pd.ordered_norm

    def recording(y):
        nrm = inner(y)
        seen.append((y, nrm))
        return nrm

    d_inv = pd._sharded_dinv(A)
    pd.ordered_norm = recording
    try:
        lam = pd._sharded_power(A, d_inv, iters, seed)
    finally:
        pd.ordered_norm = inner
    return lam, seen, d_inv


def _lam(total):
    return 1.1 * ordered_sum.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _chain(values):
    return ordered_sum.row_sum(torch.stack(list(values))[None], 1, ordered_sum.CHAIN)[0]


def part_sumsq(y, partials: str = "port"):
    """Σ y² of one part with its window partials in ``partials`` order."""
    if partials == "port" or max(y.shape) <= ordered_sum.WINDOW:
        return ordered_sum.sumsq(y)
    parts = ordered_sum._block_sums(y * y)
    if partials == "middle":
        p1 = parts.shape[1]
        vf = 1 << (p1 - 1).bit_length()
        pad = torch.zeros((parts.shape[0], vf - p1, parts.shape[2]))
        return ordered_sum._middle_lanes(torch.cat([parts, pad], 1), vf, square=False)
    lanes = {"lanes8": (8, 1, 0), "lanes4x2": (4, 2, 0)}[partials]
    flat = parts.reshape(1, -1)
    if flat.shape[1] > ordered_sum.WINDOW:
        raise ValueError(f"{flat.shape[1]} partials do not fit one lanes row")
    return ordered_sum.row_sum(flat, 1, lanes)[0]


def all_reduce(sums, how: str = "port"):
    """The parts' sums added left to right (the port), right to left, or as
    a pairwise tree."""
    if how == "port":
        return _chain(sums)
    if how == "reverse":
        return _chain(sums[::-1])
    level = list(sums)
    while len(level) > 1:
        level = [level[i] + level[i + 1] if i + 1 < len(level) else level[i]
                 for i in range(0, len(level), 2)]
    return level[0]


def candidate_lams(A, seen, d_inv):
    """λ of the port's last iteration (``port``) and of each candidate
    order of that iteration, as float32 bits (int)."""
    y, _ = seen[-1]
    out = {"port": _lam(all_reduce([part_sumsq(p) for p in y.parts]))}
    for partials in ("lanes8", "lanes4x2", "middle"):
        try:
            out[f"partials_{partials}"] = _lam(all_reduce(
                [part_sumsq(p, partials) for p in y.parts]))
        except ValueError:
            pass
    sums = [part_sumsq(p) for p in y.parts]
    for how in ("reverse", "tree"):
        out[f"all_reduce_{how}"] = _lam(all_reduce(sums, how))
    # the last matvec again, from the iterate before it
    y_prev, n_prev = seen[-2]
    x = y_prev / torch.clamp(n_prev, min=1e-30)
    halos = pd._halos(x.parts, A.halo, 0) if A.halo else None
    K = len(A.offsets)
    variants = {"matvec_offset_order": dict(order=list(range(K)))}
    if K == 7:
        centre = ordered_stencil.chain_order(K).index(A.offsets.index((0, 0, 0)))
        variants["matvec_unfused_centre"] = dict(split=centre)
    for name, change in variants.items():
        plan = ordered_stencil.Plan(A.weights, d_inv.parts, A.offsets, sharded=True)
        for k, v in change.items():
            setattr(plan, k, v)
        ys = ordered_stencil.matvec_plain(plan, x.parts, halos or [(None, None)] * len(x.parts))
        out[name] = _lam(all_reduce([part_sumsq(p) for p in ys]))
    return {k: int(np.float32(v).view(np.int32)) for k, v in out.items()}
