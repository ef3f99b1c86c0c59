"""The port's whole distributed Ruge–Stüben setup
(parallel/prs_setup.py::distributed_rs_setup) against the JAX package's on
its CPU mesh: 2D Poisson 24² in 8 parts, extended+i, Chebyshev,
n_coarse_max=40 (tests/test_prs_setup.py's
test_distributed_extended_i_pcg_parity).  The stages are held one by one in
test_torch_prs_setup.py.

Held: level rows and grid complexity equal; operator complexity to 1e-12
(the same stored entries); every level's λ_max bit for bit (the power
iteration adds in XLA's order on 8 shards); PCG iteration counts equal; residual histories
rtol 1e-4 over the first four entries (float32 sums in another order); a
second setup bit-equal to the first; no host-global matrix in the setup's
call graph.  The W-cycle counts sit in test_torch_prs_setup_wcycle.py, so
that its JAX compiling runs beside this file's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pvector as j_pvector
from parallel_amg_tpu.parallel import prs_setup as jprs
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.problems import poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.oracle import serial_amg
from parallel_amg_tpu_torch.parallel import prs_setup as prs
from parallel_amg_tpu_torch.parallel.pcsr import PCSR

torch.set_num_threads(2)

CFG = dict(coarsening="rs", smoother="chebyshev", n_coarse_max=40,
           on_device_setup=True, interpolation="extended_i")


@pytest.fixture(scope="module")
def prob():
    coo = poisson2d(24)
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


@pytest.fixture(scope="module")
def setups(prob):
    jm, tm = j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")
    hj = jprs.distributed_rs_setup(JPCSR.from_csr(prob, jm), pat.AMGConfig(**CFG))
    ht = prs.distributed_rs_setup(PCSR.from_csr(prob, tm), ptt.AMGConfig(**CFG))
    return hj, ht, jm, tm


def test_rows_and_complexities(setups):
    hj, ht, _, _ = setups
    assert [l.true_n for l in ht.levels] == [int(l.true_n) for l in hj.levels]
    assert [s["rows"] for s in ht.setup_stats["levels"]] == [l.true_n for l in ht.levels]
    gj, oj = hj.complexity()
    gt, ot = ht.complexity()
    assert gt == gj
    assert ot == pytest.approx(oj, rel=1e-12)


def test_lambda_max_bit_equal(setups):
    hj, ht, _, _ = setups
    assert len(ht.levels) == len(hj.levels)
    for lt, lj in zip(ht.levels, hj.levels):
        assert lt.lam_max == float(lj.lam_max)


def check_pcg_counts(hj, ht, jm, tm, prob):
    """PCG to 1e-6 over both hierarchies: equal counts, residual histories
    rtol 1e-4 over the first four entries, the true residual below
    5e-6·‖b‖.  Returns the two right-hand sides."""
    bh = np.random.default_rng(0).normal(size=prob.shape[0])
    bj = j_pvector(bh, hj.levels[0].A.row_partition, jm)
    bt = ptt.pvector(bh, ht.levels[0].A.row_partition, tm)
    rj = pat.amg_pcg(hj.levels[0].A, hj, bj, tol=1e-6, maxiter=60)
    rt = ptt.amg_pcg(None, ht, bt, tol=1e-6, maxiter=60)
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.residual_history[:4].numpy(),
                               np.asarray(rj.residual_history)[:4], rtol=1e-4)
    x = ptt.to_global(rt.x, ht.levels[0].A.row_partition).astype(np.float64)
    assert np.linalg.norm(bh - prob @ x) < 5e-6 * np.linalg.norm(bh)
    return bj, bt


def test_pcg_counts(setups, prob):
    check_pcg_counts(*setups, prob)


def test_rerun_bit_equal(setups, prob):
    _, ht, _, tm = setups
    h2 = prs.distributed_rs_setup(PCSR.from_csr(prob, tm), ptt.AMGConfig(**CFG))
    assert len(h2.levels) == len(ht.levels)
    for a, b in zip(ht.levels, h2.levels):
        assert a.lam_max == b.lam_max
        for name in ("A", "P", "R"):
            Ma, Mb = getattr(a, name), getattr(b, name)
            if Ma is None:
                assert Mb is None
                continue
            for f in ("diag_cols", "diag_vals", "off_cols", "off_vals",
                      "send_idx", "recv_map"):
                assert all(torch.equal(x, y) for x, y in
                           zip(getattr(Ma, f), getattr(Mb, f))), (name, f)
        assert torch.equal(a.d_inv.to_global(), b.d_inv.to_global())
    assert torch.equal(ht.coarse_inv, h2.coarse_inv)


def test_distributed_setup_on_device_no_host_matrix(prob, monkeypatch):
    """``distributed_setup`` with ``on_device_setup=True`` reaches neither the
    oracle nor a host CSR of any PCSR, and its W-cycle PCG converges."""
    def _boom(*a, **k):
        raise AssertionError("host-serial path reached during the on-device "
                             "distributed setup")

    monkeypatch.setattr(serial_amg, "oracle_setup", _boom)
    monkeypatch.setattr(PCSR, "to_csr", _boom)
    tm = ptt.make_row_mesh(8, device="cpu")
    h = ptt.distributed_setup(prob, ptt.AMGConfig(**CFG, cycle="W"), tm)
    monkeypatch.undo()
    assert all(isinstance(l.A, PCSR) and l.A.nb_send is not None for l in h.levels)
    bh = np.random.default_rng(2).normal(size=prob.shape[0])
    res = ptt.amg_pcg(None, h, ptt.pvector(bh, h.levels[0].A.row_partition, tm),
                      tol=1e-6, maxiter=60)
    assert res.converged
    x = ptt.to_global(res.x, h.levels[0].A.row_partition).astype(np.float64)
    assert np.linalg.norm(bh - prob @ x) <= 5e-5 * np.linalg.norm(bh)
