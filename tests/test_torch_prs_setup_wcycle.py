"""W-cycle counts over the port's whole distributed Ruge–Stüben setup
against the JAX package's on its CPU mesh: 2D Poisson 24² in 8 parts,
extended+i, Chebyshev, n_coarse_max=40 (test_torch_prs_setup_pcg.py's
setup with cycle="W"; tests/test_distributed_solvers.py's
test_wcycle_on_device_rs_distributed).

Held: W-cycle PCG counts equal, residual histories rtol 1e-4 over the first
four entries, the true residual below 5e-6·‖b‖.  The standalone W-cycle
``solve`` is held to the JAX package's cycle count on the host setup's
hierarchies in test_torch_psetup.py (its JAX compile here would take this
file past 90 s).
"""

import pytest
import scipy.sparse as sp
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import prs_setup as jprs
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.problems import poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import prs_setup as prs
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from test_torch_prs_setup_pcg import CFG, check_pcg_counts

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prob():
    coo = poisson2d(24)
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


def test_wcycle_pcg_counts(prob):
    jm, tm = j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")
    hj = jprs.distributed_rs_setup(JPCSR.from_csr(prob, jm),
                                   pat.AMGConfig(**CFG, cycle="W"))
    ht = prs.distributed_rs_setup(PCSR.from_csr(prob, tm),
                                  ptt.AMGConfig(**CFG, cycle="W"))
    check_pcg_counts(hj, ht, jm, tm, prob)
