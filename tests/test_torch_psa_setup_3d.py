"""The port's distributed smoothed-aggregation setup on 3D Poisson 12³ in 8
parts against the JAX package's on its CPU mesh (tests/test_psa_setup.py's
test_distributed_sa_3d: Chebyshev, coarse_drop_tol=0), with
n_coarse_max=180 where that test has 64: one coarsening step (1,728 → 178
rows) instead of two, because the JAX side compiles every level's programs
anew (86 s alone at 64, 40 s at 180).  Three levels are held in 2D by
test_torch_psa_setup.py.

Held: level rows and grid complexity equal, operator complexity to 1e-12,
PCG iteration counts equal with residual histories rtol 1e-4 over the
first four entries (float32 sums in another order), the true residual
below 5e-6·‖b‖ and the JAX test's complexity bounds.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pvector as j_pvector
from parallel_amg_tpu.parallel import psa_setup as jpsa
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.problems import poisson3d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import psa_setup as psa
from parallel_amg_tpu_torch.parallel.pcsr import PCSR

torch.set_num_threads(2)

CFG = dict(coarsening="sa", smoother="chebyshev", n_coarse_max=180,
           on_device_setup=True, coarse_drop_tol=0.0)


def test_sa_setup_3d_rows_and_pcg():
    coo = poisson3d(12)
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    jm, tm = j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")
    hj = jpsa.distributed_sa_setup(JPCSR.from_csr(A, jm), pat.AMGConfig(**CFG))
    ht = psa.distributed_sa_setup(PCSR.from_csr(A, tm), ptt.AMGConfig(**CFG))
    assert [l.true_n for l in ht.levels] == [int(l.true_n) for l in hj.levels]
    assert len(ht.levels) == 2
    gj, oj = hj.complexity()
    gt, ot = ht.complexity()
    assert gt == gj and ot == pytest.approx(oj, rel=1e-12)
    assert gt < 2.5 and ot < 3.5
    bh = np.random.default_rng(1).normal(size=A.shape[0])
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
