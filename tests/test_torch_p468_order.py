"""The sharded power iteration in 8 parts at the part shapes of 468³'s two
split levels, bit for bit against the JAX package's ``_jit_power`` on an
8-device CPU mesh.

468³ in 8 parts splits 504 × 468 × 468 (7 points, parts of 63 × 468 × 468,
whose norm has (2, 15, 15) window partials a part) and 168 × 156 × 156 (27
points, parts of 21 × 156 × 156, partials (1, 5, 5)).  The smallest grids
with those partials and the interior order of those parts: 16 × 468 × 16
(7 points, partials (1, 15, 1): a middle axis of 15) and 8 × 156 × 156 (27
points, partials (1, 5, 5)).  λ of ``pdevice_setup._sharded_power`` on
seeded operators (``problems.seeded_stencil``) == the JAX package's, and
each candidate order of the last iteration (``tests/p468_orders.py``: the
partials in LLVM's lanes, the 8-part all-reduce right to left or as a tree,
the centre unfused) gives another λ at these seeds, so the cases decide
between them.  ``tests/test_torch_p468_iterate.py`` holds the iterates.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel.mesh import ROW_AXIS
from parallel_amg_tpu.parallel.pstencil import ShardedStencil as JShardedStencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import seeded_stencil

from float_bits import bits
from p468_orders import candidate_lams, run_port_power

torch.set_num_threads(2)

DECIDED = ("partials_lanes8", "partials_lanes4x2", "partials_middle", "all_reduce_reverse",
           "all_reduce_tree")


@pytest.mark.parametrize("dims,points,seed,decided", [
    ((16, 468, 16), 7, 17, DECIDED + ("matvec_unfused_centre",)),
    ((8, 156, 156), 27, 5, DECIDED)])
def test_sharded_power_8_parts_bit_equal_to_jax(dims, points, seed, decided):
    w, offs = seeded_stencil(dims, points, seed)
    mesh = j_make_row_mesh(8)
    jA = JShardedStencil(jax.device_put(jnp.asarray(w), NamedSharding(mesh, P(None, ROW_AXIS))),
                         offs, dims, mesh)
    want = bits(np.float32(jds._jit_power(jA, jds._jit_dinv(jA), iters=15, seed=0))).item()
    A = ShardedStencil.from_global(torch.from_numpy(w), offs, dims,
                                   ptt.make_row_mesh(8, device="cpu"))
    assert A.m0 == dims[0] // 8 and A.dims == dims
    lam, seen, d_inv = run_port_power(A, 15, 0)
    assert bits(lam).item() == want
    lams = candidate_lams(A, seen, d_inv)
    assert lams["port"] == want
    assert [k for k in decided if lams[k] == want] == []
