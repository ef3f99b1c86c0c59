"""The port's distributed smoothed-aggregation stages
(parallel/psa_setup.py) against the JAX package's on its CPU mesh — the
cases of tests/test_psa_setup.py at 2D Poisson 16², in 8 parts and 3.

The distance-2 MIS draws ``ops/prng.permutation``, bit-equal to the JAX
package's ``jax.random.permutation``, so seeds and aggregates are held
EQUAL, not only by invariants.
Held: SA strength masks, MIS states, coarse numbering, aggregates and the
leftover count equal; the invariants of test_aggregation_invariants (seeds
pairwise more than two hops apart, every real row aggregated, padding rows
inert, aggregate ids are seeds' ids).  The whole setup at 24² sits in
test_torch_psa_setup_24.py and at 12³ in test_torch_psa_setup_3d.py, so
that their JAX compiling runs beside this file's.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import psa_setup as jpsa
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.problems import poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import psa_setup as psa
from parallel_amg_tpu_torch.parallel.pcsr import PCSR

torch.set_num_threads(2)


def _scipy(coo):
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


def _stack(parts):
    return np.stack([t.numpy() for t in parts])


@functools.cache
def _stages(S, theta):
    A = _scipy(poisson2d(16))
    jm, tm = j_make_row_mesh(S), ptt.make_row_mesh(S, device="cpu")
    Aj, At = JPCSR.from_csr(A, jm), PCSR.from_csr(A, tm)
    Sj, St = jpsa.pcsr_sa_strength(Aj, theta), psa.pcsr_sa_strength(At, theta)
    stj = jpsa.pcsr_mis_seed(Aj, *Sj, seed=0)
    stt = psa.pcsr_mis_seed(At, *St, seed=0)
    cj, ct = jpsa.coarse_numbering(Aj, stj), psa.coarse_numbering(At, stt)
    aj, at = jpsa.pcsr_attach(Aj, *Sj, cj[0]), psa.pcsr_attach(At, *St, ct[0])
    return A, At, dict(Sj=Sj, St=St, stj=stj, stt=stt, cj=cj, ct=ct, aj=aj, at=at)


@pytest.mark.parametrize("S,theta", [(8, 0.0), (8, 0.08), (3, 0.08)])
def test_seeds_and_aggregates_equal(S, theta):
    _, _, st = _stages(S, theta)
    for a, b in zip(st["Sj"], st["St"]):
        np.testing.assert_array_equal(np.asarray(a), _stack(b))
    np.testing.assert_array_equal(np.asarray(st["stj"]), st["stt"].to_global().numpy())
    (cmj, mcj, ncj), (cmt, mct, nct) = st["cj"], st["ct"]
    assert (mcj, ncj) == (mct, nct)
    np.testing.assert_array_equal(np.asarray(cmj), cmt.to_global().numpy())
    (aj, lj), (at, lt) = st["aj"], st["at"]
    assert lj == lt
    np.testing.assert_array_equal(np.asarray(aj), at.to_global().numpy())


def test_aggregation_invariants():
    """Seeds distance->2 apart; every strongly-connected row aggregated;
    aggregate ids point at real seeds (tests/test_psa_setup.py)."""
    A_sp, A_p, st = _stages(8, 0.0)
    (cmap, mc_pad, nc), (agg, leftover) = st["ct"], st["at"]
    assert leftover == 0
    agg_h = agg.to_global().numpy()
    state = st["stt"].to_global().numpy()
    n = A_sp.shape[0]
    assert np.all(agg_h[:n][state[:n] == psa.COARSE] >= 0)
    assert np.all(agg_h[:n] >= 0)
    assert np.all(agg_h[n:] == -2)
    seeds = np.flatnonzero(state[:n] == psa.COARSE)
    Adj = (abs(A_sp) > 0).astype(np.int8)
    Adj.setdiag(0)
    Adj.eliminate_zeros()
    sub = (Adj + Adj @ Adj).tocsr()[seeds][:, seeds].tolil()
    sub.setdiag(0)
    assert sub.count_nonzero() == 0, "two seeds within distance 2"
    assert set(agg_h[:n].tolist()) <= set(cmap.to_global().numpy()[seeds].tolist())
    assert nc == len(seeds) and mc_pad >= 1
