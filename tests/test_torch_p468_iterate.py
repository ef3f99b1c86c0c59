"""The orders of one sharded power iteration in 8 parts, bit for bit
against the JAX package on an 8-device CPU mesh, at the part shapes of
468³'s split levels (see ``tests/test_torch_p468_order.py``).

- The matvec: the JAX package's power-iteration body, two trips of
  ``fori_loop`` (``d_inv * A.matvec(x)``, its norm, x over it), gives D⁻¹A·x
  of its second trip; the port's ``ordered_stencil.matvec`` from the same x
  gives the same floats, and the same matvec with the centre unfused or in
  plain offset order (no ``STENCIL_FIRST``) does not.  Its norm
  (``pgrid.ordered_norm``) is the JAX package's.
- The 8-part all-reduce of the norm: one nonzero a part (so each part's sum
  is exact), magnitudes over 2^48: the jitted ``jnp.linalg.norm`` of the
  sharded array inside a loop == ``ordered_norm`` (the parts' sums left to
  right) on every draw, and the sums right to left or as a pairwise tree
  differ on some.
- ROADMAP C7a: at a 7-point part with 5 ≤ n2 ≤ 8 LLVM vectorises the JAX
  package's interior across its middle axis and adds the centre's product
  rounded on the rows of its vector loop.  At 16 × 468 × 8 in 8 parts every
  row is taken so: the JAX package's D⁻¹A·x equals the port's matvec (its
  power iteration's plan, ``pdevice_setup.power_plan``, with the centre
  unfused on all 468 rows) and the plain plan with the centre unfused
  (``tests/test_torch_centre_rows.py`` holds the row bound at other shapes).
"""

import functools

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
from parallel_amg_tpu_torch.ops import ordered_stencil, ordered_sum
from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
from parallel_amg_tpu_torch.parallel.pgrid import PGrid, ordered_norm
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import seeded_stencil

from float_bits import assert_bits, bits
from p468_orders import all_reduce

torch.set_num_threads(2)


def _body_twice(A, d, x0):
    def body(i, c):
        x, _, _, lam = c
        y = d * A.matvec(x)
        nrm = jnp.linalg.norm(y)
        return y / jnp.maximum(nrm, 1e-30), x, y, jnp.where(nrm > 0, nrm, lam)

    return jax.lax.fori_loop(0, 2, body, (x0, x0, x0, jnp.asarray(1.0, x0.dtype)))


@functools.cache
def _jax_step(dims, points, seed):
    """(w, offs, the iterate the JAX package's second matvec took, its
    D⁻¹A·x and norm) on the seeded operator in 8 parts."""
    w, offs = seeded_stencil(dims, points, seed)
    jmesh = j_make_row_mesh(8)
    jA = JShardedStencil(jax.device_put(jnp.asarray(w), NamedSharding(jmesh, P(None, ROW_AXIS))),
                         offs, dims, jmesh)
    x0 = jax.device_put(jax.random.uniform(jax.random.PRNGKey(0), dims, jnp.float32) - 0.5,
                        NamedSharding(jmesh, P(ROW_AXIS)))
    _, x1, y2, nrm2 = jax.jit(_body_twice)(jA, jds._jit_dinv(jA), x0)
    return w, offs, np.array(x1), np.asarray(y2), np.float32(nrm2)


@pytest.mark.parametrize("dims,points,seed", [((16, 468, 16), 7, 17), ((16, 156, 156), 27, 5)])
def test_power_step_8_parts_bit_equal_to_jax(dims, points, seed):
    w, offs, x1, want, nrm2 = _jax_step(dims, points, seed)
    mesh = ptt.make_row_mesh(8, device="cpu")
    A = ShardedStencil.from_global(torch.from_numpy(w), offs, dims, mesh)
    d_inv = pd._sharded_dinv(A)
    x = PGrid.from_global(torch.from_numpy(x1), mesh)
    halos = pd._halos(x.parts, A.halo, 0)
    K = len(offs)
    variants = {"port": {}, "offset_order": {"order": list(range(K))},
                "unfused_centre": {"split": ordered_stencil.chain_order(K).index(
                    offs.index((0, 0, 0)))}}
    got = {}
    for name, change in variants.items():
        plan = ordered_stencil.Plan(A.weights, d_inv.parts, A.offsets, sharded=True)
        for k, v in change.items():
            setattr(plan, k, v)
        got[name] = PGrid(ordered_stencil.matvec(plan, x.parts, halos), mesh)
    assert_bits(got["port"].to_global(), want, "D⁻¹A·x")
    for name in ("offset_order", "unfused_centre"):
        assert not np.array_equal(bits(got[name].to_global()), bits(want)), name
    assert_bits(ordered_norm(got["port"]), nrm2, "‖D⁻¹A·x‖")


@pytest.mark.parametrize("variant", ["port", "unfused_centre"])
def test_power_step_8_parts_unfused_centre_rows(variant):
    dims = (16, 468, 8)
    w, offs, x1, want, _ = _jax_step(dims, 7, 1)
    mesh = ptt.make_row_mesh(8, device="cpu")
    A = ShardedStencil.from_global(torch.from_numpy(w), offs, dims, mesh)
    x = PGrid.from_global(torch.from_numpy(x1), mesh)
    plan = pd.power_plan(A, pd._sharded_dinv(A))
    assert plan.rows == 468
    if variant == "unfused_centre":
        plan = ordered_stencil.Plan(A.weights, pd._sharded_dinv(A).parts, A.offsets,
                                    sharded=True, split=plan.split)
    got = PGrid(ordered_stencil.matvec(plan, x.parts, pd._halos(x.parts, A.halo, 0)), mesh)
    assert_bits(got.to_global(), want, "D⁻¹A·x")


def test_norm_all_reduce_8_parts_bit_equal_to_jax():
    dims = (16, 468, 16)
    jmesh, mesh = j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")

    def twice(y):
        def body(i, c):
            v, _ = c
            return v * 1.0, jnp.linalg.norm(v)

        return jax.lax.fori_loop(0, 2, body, (y, jnp.float32(0)))[1]

    norm = jax.jit(twice)
    differ = {"reverse": 0, "tree": 0}
    for seed in range(10):
        rng = np.random.default_rng(seed)
        y = np.zeros(dims, np.float32)
        vals = (rng.uniform(1, 2, 8) * 2.0 ** rng.integers(0, 25, 8)).astype(np.float32)
        for p, v in enumerate(vals):
            y[2 * p + rng.integers(0, 2), rng.integers(0, 468), rng.integers(0, 16)] = v
        want = np.float32(norm(jax.device_put(jnp.asarray(y), NamedSharding(jmesh, P(ROW_AXIS)))))
        parts = PGrid.from_global(torch.from_numpy(y), mesh)
        assert_bits(ordered_norm(parts), want, f"seed {seed}")
        sums = [ordered_sum.sumsq(p) for p in parts.parts]
        for how in differ:
            differ[how] += bits(ordered_sum.sqrt(all_reduce(sums, how))).item() != bits(want).item()
    assert all(differ.values()), differ
