"""The power iteration's matvec on 7-point grids where LLVM vectorises the
JAX package's loop across the middle axis (ROADMAP C7a), bit for bit against
the JAX package on the CPU, on one device and in 8 parts.

Each case runs the JAX package's power-iteration body, two trips of
``fori_loop`` (``d_inv * A.matvec(x)``, its norm, x over it), on a seeded
operator and takes D⁻¹A·x of its second trip; the port's matvec from the
same iterate, with the plan its power iteration builds
(``device_setup.power_plan``, ``pdevice_setup.power_plan``: the centre's
product unfused on the rows i1 < R of ``ordered_stencil.unfused_centre``),
gives the same floats.  Where R is neither 0 nor n1, the matvec with the
centre fused on every row and the one with it unfused on every row both
differ, so the bits decide R.  Shapes: n2 of 5 to 8 with n1 of 4, 8, 9, 16,
17, 31 and 40, n2 = 4 and 9 as controls, and shapes on both sides of each
threshold of the rule (the cost model's width of 4 or 8; one device with n0
= 1).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from parallel_amg_tpu.ops.stencil import Stencil as JStencil
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel.mesh import ROW_AXIS
from parallel_amg_tpu.parallel.pstencil import ShardedStencil as JShardedStencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.ops import ordered_stencil
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import seeded_stencil

torch.set_num_threads(2)

SWEEP = [(n1, n2) for n2 in (5, 6, 7, 8) for n1 in (4, 8, 9, 16, 17, 31, 40)]
CONTROLS = [(16, 4), (16, 9)]
# (axis 0, n1, n2, R): vf 8 at and past the threshold q (one device 10 and
# 9, 8 parts 11 and 9), below it vf 4, and one device with n0 = 1 (8 and 7)
RULE = {1: [(4, 85, 5, 80), (4, 79, 5, 76), (4, 77, 6, 72), (4, 71, 6, 68), (1, 69, 5, 64),
            (1, 63, 5, 60), (1, 61, 6, 56)],
        8: [(16, 93, 5, 88), (16, 85, 5, 84), (16, 77, 6, 72), (16, 69, 6, 68)]}


def _body_twice(A, d, x0):
    def body(i, c):
        x, _, _, lam = c
        y = d * A.matvec(x)
        nrm = jnp.linalg.norm(y)
        return y / jnp.maximum(nrm, 1e-30), x, y, jnp.where(nrm > 0, nrm, lam)

    return jax.lax.fori_loop(0, 2, body, (x0, x0, x0, jnp.asarray(1.0, x0.dtype)))


_run = jax.jit(_body_twice)


@functools.cache
def _jax_mesh():
    return j_make_row_mesh(8)


def _case(dims, parts):
    """(the JAX package's D⁻¹A·x, the port's plan, and its matvec from the
    JAX package's iterate as a function of the plan)."""
    w, offs = seeded_stencil(dims, 7, sum(dims))
    rng = np.random.default_rng(sum(dims))
    x0 = (rng.uniform(0.0, 1.0, dims) - 0.5).astype(np.float32)
    d = (np.float32(1.0) / w[offs.index((0, 0, 0))]).astype(np.float32)
    if parts == 1:
        jA, jd, jx = JStencil(jnp.asarray(w), offs, dims), jnp.asarray(d), jnp.asarray(x0)
        A = Stencil(torch.from_numpy(w), offs, dims)
        plan = ds.power_plan(A, ds.diag_inverse(A))
    else:
        jmesh = _jax_mesh()
        rows = NamedSharding(jmesh, P(ROW_AXIS))
        jA = JShardedStencil(jax.device_put(w, NamedSharding(jmesh, P(None, ROW_AXIS))),
                             offs, dims, jmesh)
        jd, jx = jax.device_put(d, rows), jax.device_put(x0, rows)
        mesh = ptt.make_row_mesh(parts, device="cpu")
        A = ShardedStencil.from_global(torch.from_numpy(w), offs, dims, mesh)
        plan = pd.power_plan(A, pd._sharded_dinv(A))
    _, x1, y2, _ = _run(jA, jd, jx)
    x1 = torch.from_numpy(np.array(x1))

    def matvec(p):
        if parts == 1:
            return ordered_stencil.matvec(p, [x1])[0]
        xs = PGrid.from_global(x1, mesh)
        return PGrid(ordered_stencil.matvec(p, xs.parts, pd._halos(xs.parts, A.halo, 0)),
                     mesh).to_global()

    return np.asarray(y2).view(np.int32), plan, matvec


def _variant(plan, rows):
    """The plan with the centre unfused on rows i1 < ``rows`` (0: fused)."""
    split = ordered_stencil.chain_order(7).index(plan.offsets.index((0, 0, 0)))
    return ordered_stencil.Plan(plan.weights, plan.scales, plan.offsets, bool(plan.corr),
                                split=split if rows else None, rows=rows)


def _check(dims, parts, want_rows=None):
    want, plan, matvec = _case(dims, parts)
    n1 = dims[1]
    rows = plan.rows or 0
    if want_rows is not None:
        assert rows == want_rows
    assert np.array_equal(matvec(plan).numpy().view(np.int32), want)
    if 0 < rows < n1:  # the row bound decides these bits
        for other in (0, n1):
            got = matvec(_variant(plan, other)).numpy().view(np.int32)
            assert not np.array_equal(got, want), other


@pytest.mark.parametrize("parts", [1, 8])
@pytest.mark.parametrize("n1,n2", SWEEP + CONTROLS)
def test_matvec_rows_bit_equal_to_jax(parts, n1, n2):
    _check((2 * parts, n1, n2), parts)


@pytest.mark.parametrize("parts,shape", [(p, s) for p, shapes in RULE.items() for s in shapes])
def test_matvec_rule_cases_bit_equal_to_jax(parts, shape):
    *dims, rows = shape
    _check(tuple(dims), parts, rows)


def test_unread_shapes_warn():
    """A part of one plane and a one-device grid with n1 = 1 are not read:
    the rule says so and takes one chain."""
    offs = seeded_stencil((4, 16, 5), 7, 0)[1]
    with pytest.warns(UserWarning, match="not read"):
        assert ordered_stencil.unfused_centre(offs, (1, 16, 5), sharded=True) == (None, 0)
    with pytest.warns(UserWarning, match="not read"):
        assert ordered_stencil.unfused_centre(offs, (16, 1, 5), sharded=False) == (None, 0)
