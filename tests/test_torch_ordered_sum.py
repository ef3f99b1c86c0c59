"""The port's ordered row sum (ops/ordered_sum.py) against ``jnp.sum`` on
the JAX package's CPU backend, bit for bit.

``row_sum`` must add in the order XLA's CPU pipeline adds a float32
``jnp.sum`` over masked rows, the form every row sum of the RS setups takes
(``jnp.sum(jnp.where(mask, x, 0.0), axis=...)``).  The inputs are seeded
numpy draws spread over six decades, so that a different order shows in the
last bits of most rows.

- One axis: every width from 1 to 160 (one to five windows of 32, every
  padding) and three widths around each multiple of 32 up to 1,424, past
  the widest candidate row of the 1024² setups (extended+i's
  W·(1 + f_max)), as rows of 2-D and 3-D tensors, all in one jitted program.
- Two axes: the (f_max, W) tables of extended+i's i-share sum, among them
  those of config #2 at 1024² in 8 parts ((12, 42), (13, 64), (15, 72),
  (15, 78), (14, 72); f_max stays below 16 there).  XLA's CPU reductions
  carry ``reassoc``, and LLVM vectorises a bare two-axis ``jnp.sum`` across
  f_max where W ≤ 8 and f_max is 2, 4, 8 or ≥ 16, and the sum of the window
  partials where both axes pass 32; the setups' fused reductions are not
  vectorised at W ≤ 8 (level 0's (4, 6) is held through the whole P in
  test_torch_prs_setup.py) and no setup reaches both axes past 32, so those
  shapes are left out here.
- LLVM's vectorised order (``lanes``) at the one reduction of the setups
  where it reorders: extended+i's weak couplings in ``amg/device_rs.py``,
  held against the JAX package's own function at one width of each order
  it takes (``scripts/probe_xla_weak_sum.py`` measures every width).

The CUDA case holds the kernel (csrc/ordered_sum.cu) bit-equal to the plain
version on the card.
"""

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
except ImportError:  # a machine without JAX runs the cuda case only
    jax = None

from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.ops.ordered_sum import row_sum, row_sum_plain, windows

torch.set_num_threads(2)

WIDTHS = list(range(1, 161)) + [w for k in range(5, 45)
                                for w in (32 * k, 32 * k + 1, 32 * k + 17)]
TWO_AXIS = [(12, 42), (13, 64), (15, 72), (15, 78), (14, 72)] + [
    (f, w) for f in (1, 2, 3, 4, 5, 7, 12, 20, 33, 40)
    for w in (5, 7, 9, 12, 20, 31, 32, 33, 50, 64, 100)
    if (w > 8 or f not in (2, 4, 8) and f < 16) and (f <= 32 or w <= 32)]


def _draw(rng, shape):
    x = rng.normal(size=shape) * 10.0 ** rng.integers(-3, 4, size=shape)
    return x.astype(np.float32), rng.random(shape) < 0.8


def _bits(t):
    return np.ascontiguousarray(np.asarray(t)).view(np.int32)


def _masked_port(x, m, dims):
    return row_sum(torch.where(torch.from_numpy(m), torch.from_numpy(x), 0.0), dims)


needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX")


@needs_jax
@pytest.mark.parametrize("lead", [(24,), (6, 5)])
def test_one_axis_bit_equal_to_jnp_sum(lead):
    rng = np.random.default_rng(len(lead))
    xs, ms = zip(*(_draw(rng, lead + (w,)) for w in WIDTHS))
    sums = jax.jit(lambda xs, ms: [jnp.sum(jnp.where(m, x, 0.0), axis=-1)
                                   for x, m in zip(xs, ms)])(xs, ms)
    bad = [w for w, x, m, s in zip(WIDTHS, xs, ms, sums)
           if not np.array_equal(_bits(s), _bits(_masked_port(x, m, 1)))]
    assert not bad, f"widths whose sums differ: {bad}"


@needs_jax
def test_two_axis_bit_equal_to_jnp_sum():
    rng = np.random.default_rng(2)
    xs, ms = zip(*(_draw(rng, (24,) + s) for s in TWO_AXIS))
    sums = jax.jit(lambda xs, ms: [jnp.sum(jnp.where(m, x, 0.0), axis=(1, 2))
                                   for x, m in zip(xs, ms)])(xs, ms)
    bad = [s for s, x, m, t in zip(TWO_AXIS, xs, ms, sums)
           if not np.array_equal(_bits(t), _bits(_masked_port(x, m, 2)))]
    assert not bad, f"(f_max, W) whose sums differ: {bad}"


@needs_jax
@pytest.mark.parametrize("W,chunks", [(16, 1), (20, 1), (21, 3), (24, 1), (32, 3),
                                      (33, 1)])
def test_weak_coupling_lanes_bit_equal_to_jax(W, chunks):
    """``ordered_sum.weak_lanes`` against the JAX package's own extended+i
    on ``weak_sum_probe``'s operators (one width per order it takes, in one
    chunk of rows and in several: 2,048 probe rows in chunks of 704)."""
    from weak_sum_probe import orders_that_fit

    fit = orders_that_fit(W, chunks, np.random.default_rng(W), n_probe=2048,
                          row_chunk=704 if chunks > 1 else None)
    assert ordered_sum.weak_lanes(W, chunks > 1) in fit, fit


def test_lanes_order():
    """lanes=(4, 2, 0) on 10 elements: blocks of 8 into 2 × 4 lanes, lanes
    halved, then the last 2 one at a time."""
    x = torch.tensor([[1.0, 2.0 ** -24, 0, 0, 2.0 ** -24, 0, 0, 0, 3.0, 2.0 ** -23]])
    # lane 0: 1 + 2⁻²⁴ = 1 (ties to even); lane 1: 2⁻²⁴; halving adds them
    want = (np.float32(1.0) + np.float32(2.0 ** -24)) + np.float32(3.0)
    want = np.float32(want) + np.float32(2.0 ** -23)
    assert row_sum(x, 1, (4, 2, 0)).item() == float(np.float32(want))
    assert row_sum_plain(x, 1, (4, 2, 0)).item() == float(np.float32(want))
    with pytest.raises(ValueError):
        row_sum(torch.zeros((2, 33)), 1, (4, 2, 0))
    with pytest.raises(ValueError):
        row_sum(torch.zeros((2, 3)), 1, (3, 2, 0))


@needs_jax
def test_torch_sum_takes_another_order():
    """The reason for the module: torch's own CPU sum differs from XLA's."""
    x, _ = _draw(np.random.default_rng(3), (512, 17))
    ref = _bits(jax.jit(lambda x: jnp.sum(x, axis=1))(x))
    assert np.array_equal(ref, _bits(row_sum(torch.from_numpy(x))))
    assert not np.array_equal(ref, _bits(torch.from_numpy(x).sum(1)))


@pytest.mark.parametrize("d,expected", [
    (1, (1, 1, 0)), (32, (32, 1, 0)), (33, (32, 2, 15)), (64, (32, 2, 0)),
    (100, (32, 4, 14)), (1100, (32, 35, 10))])
def test_windows(d, expected):
    assert windows(d) == expected


def test_rules_and_edges():
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    assert row_sum(x).tolist() == [6.0, 22.0, 38.0]
    assert row_sum(x.reshape(3, 2, 2), 2).tolist() == [6.0, 22.0, 38.0]
    assert row_sum(torch.zeros((0, 40))).shape == (0,)
    assert row_sum(torch.zeros((5, 0))).tolist() == [0.0] * 5
    # the order is XLA's: window sums first, then the windows in order
    # width 33: elements 0–16 and 17–32; 1 + 2⁻²⁴ rounds back to 1, left to
    # right the sum would stay 1
    x = torch.tensor([[1.0, *([2.0 ** -24] * 32)]])
    assert row_sum(x).item() == 1.0 + 2.0 ** -20
    with pytest.raises(TypeError):
        row_sum(torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(ValueError):
        row_sum(torch.zeros((2, 3)), 3)
    with pytest.raises(ValueError):
        row_sum(torch.zeros((2, 3), device="meta"))


@pytest.mark.cuda
def test_kernel_bit_equal_to_plain_cuda():
    """csrc/ordered_sum.cu on the card against the plain version, at widths
    of one window and of several (staged and windowed kernels), one and two
    axes, in LLVM's order (lanes kernel), and the launch counts."""
    if not torch.cuda.is_available():
        pytest.skip("the ordered-sum kernel is CUDA C++ and needs a CUDA card")
    rng = np.random.default_rng(4)
    for shape, dims, lanes, kernels in [
            ((1000, 7), 1, None, {"staged"}), ((100, 8, 8), 2, None, {"staged"}),
            ((300, 64), 1, None, {"windows", "staged"}),
            ((77, 65), 1, None, {"windows", "staged"}),
            ((50, 1100), 1, None, {"windows", "staged"}),
            ((40, 12, 20), 1, None, {"staged"}), ((40, 12, 20), 2, None, {"windows"}),
            ((30, 40, 33), 2, None, {"windows", "staged"}),
            ((3, 0), 1, None, {"windows"}), ((500, 21), 1, (4, 4, 4), {"lanes"}),
            ((500, 30), 1, (4, 2, 0), {"lanes"}), ((500, 17), 1, (8, 1, 0), {"lanes"})]:
        x = torch.from_numpy(_draw(rng, shape)[0])
        before = dict(ordered_sum.LAUNCHES)
        got = row_sum(x.cuda(), dims, lanes).cpu()
        ran = {k.removeprefix("ordered_sum_") for k, v in ordered_sum.LAUNCHES.items()
               if v > before[k]}
        assert ran == kernels, (shape, ran)
        assert torch.equal(got.view(torch.int32),
                           row_sum_plain(x, dims, lanes).view(torch.int32)), shape
