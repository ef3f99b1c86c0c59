"""The structured setups' power iteration on 2-D grids in the JAX package's
float32 order.

λ_max(D⁻¹A) sets the Chebyshev interval, so the port's power iteration adds
in XLA's CPU order (``amg/device_setup.power_iteration_lambda_max``).  On a
2-D grid that order has three parts the port reads off the JAX package's
fusions (``scripts/probe_xla_galerkin_order.py --norms2d``):

- the norm's Σ y² (``ordered_sum._sumsq_2d``): the squares or the window
  partials in lanes across the first axis (``_middle_lanes_vf``; squares and
  adds take two tables), a window level without padding in lanes too, the
  last column of a window deferred where axis 1 is padded by one, one chain
  on the grids XLA compiles into one function (``ONE_CALL``);
- the matvec (``ordered_stencil.plan_2d``): the centre rounded on the rows
  i0 < R where n1 is 5 to 8, and the chain's first two planes the other way
  round on the last column of a 9-point grid with n1 = 9.

A 3-D grid whose last axis is padded by one float defers each window's last
column the same way (``ordered_sum._block_sums``).

Each case holds the port's λ against ``_jit_power`` on the same float32
weights, bit for bit, with no warning: 2-D Poisson at the grids where the
port departed before its 2-D order was read, and seeded 5- and 9-point
operators whose partials have 2, 4, 8 and other counts per axis, with a
window level and without.  ``test_matvec_bit_equal_to_jax`` holds the 2-D
matvec itself against the JAX package's jitted one, float for float.  The
shapes whose order is not read warn (``test_not_read_warns``).  On a card
(``-m cuda``) the lanes instances of the 2-D norms and the matvec kernel's
swapped columns are held against their plain versions.
"""

import warnings

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # a machine without JAX runs the cuda cases only
    jax = None

from float_bits import assert_bits

from parallel_amg_tpu_torch.amg import device_setup
from parallel_amg_tpu_torch.ops import ordered_stencil, ordered_sum
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.problems import seeded_stencil

torch.set_num_threads(2)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")

# 2-D Poisson grids where the port's λ departed without a warning
POISSON = [(34, 34), (40, 40), (64, 64), (114, 114), (120, 120), (128, 128),
           (243, 243), (250, 250), (243, 100), (1000, 40)]
# seeded operators: (dims, points), by what they hold
SEEDED = [
    ((128, 300), 5),   # partials (4, 10): one chain
    ((1000, 40), 9),   # partials (32, 2): 8 lanes over 4 blocks
    ((243, 100), 9),   # partials (8, 4): 8 lanes
    ((40, 40), 5),     # partials (2, 2): 2 lanes
    ((114, 114), 9),   # partials (4, 4): 4 lanes
    ((700, 50), 5),    # partials (22, 2): 4 lanes, 2 rows left over
    ((63, 63), 9),     # axis 1 padded by one: each window's last column last
    ((2048, 40), 9),   # a second window level of (32, 2) windows in 8 lanes
    ((1024, 7), 5),    # (32, 7) windows without padding in 4 lanes; matvec R
    ((8, 8), 5),       # squares in 8 lanes, rounded; matvec every row
    ((17, 8), 9),      # squares in 8 lanes and one row left over; matvec R 16
    ((20, 3), 5),      # squares in 4 lanes, fused
    ((69, 5), 5),      # matvec R with 4-row vectors (5 points)
    ((40, 6), 9),      # matvec R 32
    ((40, 9), 9),      # the last column's chain starts the other way round
    ((3, 4), 5),       # one function for the loop body: one chain
    ((2, 3), 9),       # one function for the loop body: one chain
    ((13, 13), 9),     # 1024²'s level 4
]


def _seeded(dims, points, seed):
    w, offs = seeded_stencil(dims, points, seed)
    return offs, w, (1.0 / w[offs.index((0,) * len(dims))]).astype(np.float32)


def _poisson(dims):
    from parallel_amg_tpu_torch.problems import poisson_stencil

    A = poisson_stencil(dims, device="cpu")
    w = A.weights.numpy()
    return A.offsets, w, (1.0 / w[A.offsets.index((0, 0))]).astype(np.float32)


def _lambdas(offs, w, d, dims, seed):
    from parallel_amg_tpu.amg import device_setup as jds
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil

    want = jds._jit_power(JStencil(jnp.asarray(w), offs, dims), jnp.asarray(d),
                          iters=15, seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = device_setup.power_iteration_lambda_max(
            Stencil(torch.from_numpy(w), offs, dims), torch.from_numpy(d), 15, seed=seed)
    return got, want


@needs_jax
@pytest.mark.parametrize("case", [("poisson", d, 5) for d in POISSON]
                         + [("seeded", d, p) for d, p in SEEDED],
                         ids=lambda c: f"{c[0]}-{c[1][0]}x{c[1][1]}-{c[2]}pt")
def test_lambda_bit_equal_to_jax(case):
    """λ_max of the port's power iteration == the JAX package's
    ``_jit_power`` on the same weights, float32 bits, and no warning."""
    kind, dims, points = case
    offs, w, d = _poisson(dims) if kind == "poisson" else _seeded(dims, points, sum(dims))
    got, want = _lambdas(offs, w, d, dims, seed=0)
    assert_bits(got, np.asarray(want), f"λ at {dims}")


@needs_jax
def test_3d_last_axis_padded_by_one_bit_equal_to_jax():
    """A 3-D grid whose last axis is padded by one float (63 = 2·32 − 1):
    each window's last column comes after its rows there too
    (``ordered_sum._block_sums``), λ equal to ``_jit_power``'s."""
    dims = (40, 40, 63)
    offs, w, d = _seeded(dims, 7, 4)
    got, want = _lambdas(offs, w, d, dims, seed=0)
    assert_bits(got, np.asarray(want), f"λ at {dims}")


@needs_jax
@pytest.mark.parametrize("dims,points", [((8, 8), 5), ((40, 6), 9), ((69, 5), 5),
                                         ((61, 6), 5), ((40, 9), 9), ((100, 9), 9),
                                         ((40, 9), 5), ((16, 7), 9)])
def test_matvec_bit_equal_to_jax(dims, points):
    """The 2-D power-iteration matvec on its (1, n0, n1) plan == the JAX
    package's jitted D⁻¹·A·x (the same fusion as inside its power
    iteration), every float: the rows R and the swapped last column."""
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil

    offs, w, d = _seeded(dims, points, 5)
    x = (np.random.default_rng(6).random(dims) - 0.5).astype(np.float32)
    want = jax.jit(lambda w, d, x: d * JStencil(w, offs, dims).matvec(x))(w, d, x)
    plan = device_setup.power_plan(Stencil(torch.from_numpy(w), offs, dims),
                                   torch.from_numpy(d))
    got = ordered_stencil.matvec(plan, [torch.from_numpy(x).reshape(plan.slab)])[0]
    assert_bits(got.reshape(dims), np.asarray(want), f"matvec at {dims}")


def test_not_read_warns():
    """A tiny 2-D grid of a stencil whose points were not read, and a
    matvec of such a stencil on 5 to 9 columns, warn once per shape; the
    read shapes do not."""
    y = torch.from_numpy(np.random.default_rng(1).random((6, 5)).astype(np.float32))
    with pytest.warns(UserWarning, match="C7b"):
        ordered_sum.sumsq(y, structured=True, points=7)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ordered_sum.sumsq(y, structured=True, points=7)  # once per shape
        for points in (5, 9):
            for shape in ((6, 5), (3, 4), (2, 3), (13, 13), (40, 40)):
                ordered_sum.sumsq(torch.ones(shape), structured=True, points=points)
                ordered_stencil.plan_2d(_seeded(shape, points, 0)[0], shape)
    offs7 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1), (-1, -1))
    with pytest.warns(UserWarning, match="C7b"):
        assert ordered_stencil.plan_2d(offs7, (20, 6)) == (None, 0, None)


def test_one_call_grids_take_one_chain():
    """The grids whose loop body XLA compiles into one function sum their
    squares in one fma chain, where the lanes table would take lanes."""
    y = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 4)).astype(np.float32))
    flat = y.reshape(1, -1)
    chain = ordered_sum.row_dot(flat, flat, ordered_sum.CHAIN)[0]
    assert ordered_sum._middle_lanes_vf((2, 4), square=True) == 2
    assert torch.equal(ordered_sum.sumsq(y, structured=True, points=9).view(torch.int32),
                       chain.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,square", [((17, 8), True), ((20, 3), True), ((8, 8), True),
                                          ((2, 5), True), ((22, 2), False), ((32, 7), False),
                                          ((4, 4), False)])
def test_rows_lanes_bit_equal_to_plain_cuda(shape, square):
    """``_rows_lanes`` on the card (the lanes kernel's (vf, 1, 0) instances,
    rows longer than 32, then the chain of the rows left over) against the
    plain version, batches of 3."""
    if not torch.cuda.is_available():
        pytest.skip("the ordered-sum kernel is CUDA C++ and needs a CUDA card")
    y = torch.from_numpy(np.random.default_rng(3).normal(size=(3,) + shape).astype(np.float32))
    vf = ordered_sum._middle_lanes_vf(shape, square=square)
    assert vf
    before = ordered_sum.LAUNCHES["ordered_sum_lanes"]
    got = ordered_sum._rows_lanes(y.cuda(), vf, square).cpu()
    assert ordered_sum.LAUNCHES["ordered_sum_lanes"] > before
    want = ordered_sum._rows_lanes(y, vf, square)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,points", [((40, 9), 9), ((40, 6), 9), ((69, 5), 5),
                                         ((114, 114), 9), ((1000, 40), 9), ((17, 8), 9)])
def test_power_iteration_on_the_card_equal_to_cpu_cuda(dims, points):
    """λ of the 2-D power iteration on the card (``ordered_stencil_matvec``
    on the (1, n0, n1) plan, its rows and swapped columns, and the 2-D
    norms' kernels) == the CPU's plain version, float32 bits."""
    if not torch.cuda.is_available():
        pytest.skip("ordered_stencil_matvec is CUDA C++ and needs a CUDA card")
    offs, w, d = _seeded(dims, points, 11)
    lam = [device_setup.power_iteration_lambda_max(
        Stencil(torch.from_numpy(w).to(dev), offs, dims), torch.from_numpy(d).to(dev), 15)
        for dev in ("cpu", "cuda")]
    assert torch.equal(lam[0].view(torch.int32), lam[1].cpu().view(torch.int32))
