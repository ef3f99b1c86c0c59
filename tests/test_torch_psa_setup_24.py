"""The port's whole distributed smoothed-aggregation setup
(parallel/psa_setup.py::distributed_sa_setup) against the JAX package's on
its CPU mesh: 2D Poisson 24² in 8 parts, Chebyshev, n_coarse_max=40,
coarse_drop_tol=0 (tests/test_psa_setup.py's
test_distributed_sa_pcg_no_host_matrix).  The stages are held one by one in
test_torch_psa_setup.py.

Held: level rows and grid complexity equal, operator complexity to 1e-12,
PCG iteration counts equal, λ_max bit for bit where the level's operator
is the JAX package's bit for bit (rtol 1e-5 elsewhere), residual histories
rtol 1e-4 over the first four entries (float32 sums in another order), the
true residual below 5e-6·‖b‖; a second setup bit-equal.
"""

import numpy as np
import pytest
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pvector as j_pvector
from parallel_amg_tpu.parallel import psa_setup as jpsa
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.problems import poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import psa_setup as psa
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from test_torch_psa_setup import _scipy

torch.set_num_threads(2)


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", smoother="chebyshev", n_coarse_max=40,
                         on_device_setup=True, coarse_drop_tol=0.0)


@pytest.fixture(scope="module")
def setups24():
    A = _scipy(poisson2d(24))
    jm, tm = j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")
    hj = jpsa.distributed_sa_setup(JPCSR.from_csr(A, jm), _cfg(pat))
    ht = psa.distributed_sa_setup(PCSR.from_csr(A, tm), _cfg(ptt))
    return A, hj, ht, jm, tm


def test_sa_setup_24_rows_and_pcg(setups24):
    A, hj, ht, jm, tm = setups24
    assert [l.true_n for l in ht.levels] == [int(l.true_n) for l in hj.levels]
    assert ht.complexity()[0] == hj.complexity()[0]
    assert ht.complexity()[1] == pytest.approx(hj.complexity()[1], rel=1e-12)
    bh = np.random.default_rng(0).normal(size=A.shape[0])
    rj = pat.amg_pcg(hj.levels[0].A, hj,
                     j_pvector(bh, hj.levels[0].A.row_partition, jm), tol=1e-6,
                     maxiter=60)
    rt = ptt.amg_pcg(None, ht, ptt.pvector(bh, ht.levels[0].A.row_partition, tm),
                     tol=1e-6, maxiter=60)
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.residual_history[:4].numpy(),
                               np.asarray(rj.residual_history)[:4], rtol=1e-4)
    x = ptt.to_global(rt.x, ht.levels[0].A.row_partition).astype(np.float64)
    assert np.linalg.norm(bh - A @ x) < 5e-6 * np.linalg.norm(bh)


def test_sa_lambda_max(setups24):
    """λ_max bit for bit wherever the level's operator is the JAX package's
    bit for bit (its planes); the coarse SA operators add their products in
    another order, and their λ_max is held to rtol 1e-5."""
    _, hj, ht, _, _ = setups24
    assert len(ht.levels) == len(hj.levels)
    for lt, lj in zip(ht.levels, hj.levels):
        same = all(np.array_equal(np.stack([t.numpy() for t in getattr(lt.A, f)]).view(np.int32),
                                  np.asarray(getattr(lj.A, f)).view(np.int32))
                   for f in ("diag_cols", "diag_vals", "off_cols", "off_vals"))
        if same:
            assert lt.lam_max == float(lj.lam_max)
        else:
            np.testing.assert_allclose(lt.lam_max, float(lj.lam_max), rtol=1e-5)


def test_sa_setup_rerun_bit_equal(setups24):
    A, _, ht, _, tm = setups24
    h2 = psa.distributed_sa_setup(PCSR.from_csr(A, tm), _cfg(ptt))
    for a, b in zip(ht.levels, h2.levels, strict=True):
        assert a.lam_max == b.lam_max
        for name in ("A", "P", "R"):
            Ma, Mb = getattr(a, name), getattr(b, name)
            if Ma is None:
                assert Mb is None
                continue
            for f in ("diag_cols", "diag_vals", "off_cols", "off_vals"):
                assert all(torch.equal(x, y) for x, y in
                           zip(getattr(Ma, f), getattr(Mb, f))), (name, f)
    assert torch.equal(ht.coarse_inv, h2.coarse_inv)
