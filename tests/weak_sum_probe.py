"""Probe operators for the order in which the JAX package's one-device
extended+i adds its weak couplings (``parallel_amg_tpu/amg/device_rs.py``,
``jnp.sum(jnp.where(am & ~isdiag & ~in_chat & ~sf, av, 0.0))``), shared by
``tests/test_torch_ordered_sum.py`` and ``scripts/probe_xla_weak_sum.py``.

Each probe row of ``operator`` holds a small diagonal, one strong C
neighbour and W − 2 weak couplings of random size, with (S, state) given,
so that the JAX package's P of a probe row is exactly
−a_ic / (a_ii + Σ weak); a few extra rows set the tables' widths c_max = 4
and f_max = 12 as on config #2's level 1 (fewer where W is too narrow).
``orders_that_fit`` runs the JAX package's function in one chunk of rows
or in several and names every ``ops/ordered_sum.row_sum`` order (XLA's,
or ``lanes=(vf, ic, evf)``) that reproduces P bit for bit on every probe
row.  The module has no side effects on import; the caller chooses JAX's
platform.
"""

import jax.numpy as jnp
import numpy as np
import torch

from parallel_amg_tpu.amg import device_rs as jrs
from parallel_amg_tpu.ops.ell import ELL as JELL
from parallel_amg_tpu_torch.ops.ordered_sum import row_sum

ORDERS = [None] + [(vf, ic, evf) for vf in (2, 4, 8, 16) for ic in (1, 2, 3, 4)
                   for evf in (0, 4, 8) if vf * ic <= 32]
FINE, COARSE = jrs.FINE, jrs.COARSE
N_COARSE = 64


def operator(W: int, n_probe: int, rng):
    """(cols, vals, row_nnz, S, state, the probe rows' weak couplings in
    their W-wide rows, a_ii, a_ic)."""
    c_max = min(4, W - 1)
    f_max = max(min(12, W - 1 - c_max), 0)
    n = n_probe + N_COARSE + 1
    cols = np.zeros((n, W), np.int32)
    vals = np.zeros((n, W), np.float32)
    S = np.zeros((n, W), bool)
    state = np.full(n, FINE, np.int32)
    coarse = np.arange(n_probe, n_probe + N_COARSE)
    state[coarse] = COARSE
    p = np.arange(n_probe)
    # a diagonal far below the weak couplings, so that a_ii + Σ weak keeps
    # the bits of Σ weak, and weak couplings over six decades, so that
    # another order shows in them
    a_ii = (1e-6 * (1.0 + rng.random(n_probe))).astype(np.float32)
    a_ic = (-1.0 - rng.random(n_probe)).astype(np.float32)
    cols[p, 0], vals[p, 0] = p, a_ii
    cols[p, 1], vals[p, 1] = coarse[p % N_COARSE], a_ic
    S[p, 1] = True
    if W > 2:  # weak couplings to other fine rows (S is given)
        nb = (p[:, None] + 1 + np.arange(W - 2)[None, :]) % n_probe
        w = rng.normal(size=(n_probe, W - 2)) * 10.0 ** rng.integers(-3, 4, (n_probe, W - 2))
        cols[p, 2:], vals[p, 2:] = nb, w.astype(np.float32)
    for c in coarse:  # coarse rows: the diagonal only
        cols[c, 0], vals[c, 0] = c, 1.0
    d = n - 1  # the row that sets c_max and f_max
    k = 1 + c_max + f_max
    cols[d, 0], vals[d, 0] = d, 4.0
    cols[d, 1:1 + c_max], vals[d, 1:1 + c_max] = coarse[:c_max], -1.0
    cols[d, 1 + c_max:k], vals[d, 1 + c_max:k] = np.arange(f_max), -1.0
    S[d, 1:k] = True
    row_nnz = np.array([W] * n_probe + [1] * N_COARSE + [k], np.int32)
    weak = vals[p].copy()  # the summed row: zeros at the diagonal and at C
    weak[:, :2] = 0.0
    return cols, vals, row_nnz, S, state, weak, a_ii, a_ic


def orders_that_fit(W: int, chunks: int, rng, n_probe: int = 2048,
                    row_chunk: int | None = None):
    """The orders of ``ORDERS`` that give the JAX package's P on every
    probe row.  ``chunks`` > 1 maps over several chunks of rows: by the
    JAX package's default chunk, on 4096·chunks − 65 probe rows, unless
    ``row_chunk`` forces a smaller chunk on ``n_probe`` rows."""
    if chunks > 1 and row_chunk is None:
        n_probe = 4096 * chunks - N_COARSE - 1
    cols, vals, row_nnz, S, state, weak, a_ii, a_ic = operator(W, n_probe, rng)
    A = JELL(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(row_nnz),
             (cols.shape[0], cols.shape[0]))
    P = jrs.extended_i_interpolation_device(A, jnp.asarray(S), jnp.asarray(state),
                                            4, row_chunk=row_chunk)
    got = np.asarray(P.vals)[:n_probe, 0]
    x = torch.from_numpy(np.ascontiguousarray(weak))
    fit = []
    for order in ORDERS:
        try:
            s = row_sum(x, 1, order).numpy()
        except ValueError:
            continue
        diag = (a_ii + s).astype(np.float32)
        want = (-a_ic / diag).astype(np.float32)
        if np.array_equal(want.view(np.int32), got.view(np.int32)):
            fit.append(order)
    return fit
