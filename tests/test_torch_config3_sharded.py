"""Config #3's distributed setup in 4 parts against the JAX package's on a
4-device CPU mesh: ``sharded_device_setup`` at 36 × 33 × 33, every level's
weights and λ bit for bit.  It is the smallest grid found where a part's
norm (block partials (1, 2, 2), added in lanes across their middle axis)
and the sharded power iteration's matvec (``pdevice_setup._ordered_matvec``)
change λ's bits.
"""

import numpy as np
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pdevice_setup as jpd

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil

from float_bits import assert_bits

torch.set_num_threads(2)


def _cfg(mod):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=64, agglomerate_n=256,
                         on_device_setup=True)


def test_sharded_setup_4_parts_bit_equal_to_jax():
    dims = (36, 33, 33)
    mesh = ptt.make_row_mesh(4, device="cpu")
    A, td = ptt.poisson_stencil_sharded(dims, mesh, _cfg(ptt))
    h = ptt.sharded_device_setup(A, _cfg(ptt), true_dims=td)
    jA, jtd = jpd.poisson_stencil_sharded(dims, j_make_row_mesh(4), _cfg(pat))
    jh = jpd.sharded_device_setup(jA, _cfg(pat), true_dims=jtd)
    assert h.setup_stats["sharded_levels"] >= 1
    assert len(h.levels) == len(jh.levels)
    for lv, jlv in zip(h.levels, jh.levels):
        W = lv.A.global_weights() if isinstance(lv.A, ShardedStencil) else lv.A.weights
        assert_bits(W, np.asarray(jlv.A.weights))
        assert_bits(np.float32(lv.lam_max), np.float32(jlv.lam_max))
