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

- The power iterations' sums (``ordered_sum.ell_dot_lanes``, ``sumsq``,
  ``norm``): 1-D norms against ``jnp.linalg.norm`` across the window levels;
  the ELL product rows at every width to 34 and beyond against the JAX
  package's power-iteration loop (two iterations: a loop of one compiles
  otherwise), and its ``_ell_lambda_max``; the PCSR planes against its
  ``_pcsr_lambda_max`` on 8 shards; the emulated fused multiply-add and
  square root against exact arithmetic.

The CUDA cases hold the kernels (csrc/ordered_sum.cu) bit-equal to the plain
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

from fractions import Fraction
import math

from parallel_amg_tpu_torch.amg import device_rs, device_setup
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
            ((300, 64), 1, None, {"windows"}),
            ((77, 65), 1, None, {"windows"}),
            ((50, 1100), 1, None, {"windows"}),
            ((40, 12, 20), 1, None, {"staged"}), ((40, 12, 20), 2, None, {"windows"}),
            ((30, 40, 33), 2, None, {"windows"}),
            ((3, 0), 1, None, {"windows"}), ((500, 21), 1, (4, 4, 4), {"lanes"}),
            ((500, 30), 1, (4, 2, 0), {"lanes"}), ((500, 32), 1, (8, 2, 0), {"lanes"}),
            ((500, 17), 1, (1, 1, 0), {"lanes"})]:
        x = torch.from_numpy(_draw(rng, shape)[0])
        before = dict(ordered_sum.LAUNCHES)
        got = row_sum(x.cuda(), dims, lanes).cpu()
        ran = {k.removeprefix("ordered_sum_") for k, v in ordered_sum.LAUNCHES.items()
               if v > before[k]}
        assert ran == kernels, (shape, ran)
        assert torch.equal(got.view(torch.int32),
                           row_sum_plain(x, dims, lanes).view(torch.int32)), shape


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 47, 1023, 1024, 1025, 1248, 4097, 32767, 32768,
                               32769, 40000, 1 << 20, (1 << 20) + 1, 3_000_001])
def test_windows_kernel_lengths_cuda(d):
    """The redesigned windows kernel: one launch a call at any length (past
    32,768 floats a row the span kernel, whose last block finishes the
    tree), at odd lengths and paddings (windows of the first, second and
    third level each with padding split before and after), bit-equal to the
    plain version, also with several rows of one shape, twice in a row (the
    span kernel's counter resets itself)."""
    if not torch.cuda.is_available():
        pytest.skip("the ordered-sum kernel is CUDA C++ and needs a CUDA card")
    rows = 1 if d > 100_000 else 3
    x = torch.from_numpy(_draw(np.random.default_rng(d), (rows, d))[0])
    want = row_sum_plain(x).view(torch.int32)
    for _ in range(2):
        before = ordered_sum.LAUNCHES["ordered_sum_windows"]
        got = row_sum(x.cuda()).cpu()
        assert ordered_sum.LAUNCHES["ordered_sum_windows"] - before == 1
        assert torch.equal(got.view(torch.int32), want)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 5, 18, 22, 23, 24, 27, 28, 31, 32])
def test_lanes_kernel_fma_schedules_cuda(W):
    """The redesigned lanes kernel's fused multiply-add schedules (every
    ``ell_dot_lanes`` order, staged rows) and one chain over planes and over
    a long row, bit-equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("the ordered-sum kernel is CUDA C++ and needs a CUDA card")
    rng = np.random.default_rng(W)
    a = torch.from_numpy(_draw(rng, (777, W))[0])
    b = torch.from_numpy(_draw(rng, (777, W))[0])
    for plane in ("ell", "own", "ghost"):
        lanes = ordered_sum.ell_dot_lanes(W, plane)
        got = ordered_sum.row_dot(a.cuda(), b.cuda(), lanes).cpu()
        assert torch.equal(got.view(torch.int32),
                           ordered_sum.row_dot_plain(a, b, lanes).view(torch.int32))
    got = ordered_sum.planes_dot(a.T.contiguous().cuda(), b.T.contiguous().cuda()).cpu()
    want = ordered_sum.planes_dot(a.T.contiguous(), b.T.contiguous())
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    long_row = torch.from_numpy(_draw(rng, (2, 5000 + W))[0])
    got = ordered_sum.row_dot(long_row.cuda(), long_row.cuda(), ordered_sum.CHAIN).cpu()
    want = ordered_sum.row_dot_plain(long_row, long_row, ordered_sum.CHAIN)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):
        ordered_sum.row_dot(a.cuda(), b.cuda(), (4, 4, 4))


# -- the power iterations' sums ---------------------------------------------

def _ell_probe(n, W, rng):
    """A random ELL of n rows, W wide, rows of 1 to W entries (the rest
    padding), a dominant diagonal; (cols, vals, row_nnz, d_inv)."""
    cols = rng.integers(0, n, (n, W)).astype(np.int32)
    vals = (rng.normal(size=(n, W)) * 10.0 ** rng.integers(-2, 3, (n, W))).astype(np.float32)
    nnz = rng.integers(1, W + 1, n).astype(np.int32)
    live = np.arange(W)[None] < nnz[:, None]
    cols, vals = np.where(live, cols, 0).astype(np.int32), np.where(live, vals, 0).astype(np.float32)
    cols[:, 0] = np.arange(n)
    vals[:, 0] = np.abs(vals[:, 0]) + 1
    return cols, vals, nnz, (1.0 / vals[:, 0]).astype(np.float32)


def _port_power(x, step, iters):
    """``iters`` steps of the port's power iteration from x; step(x) = y."""
    for _ in range(iters):
        y = step(x)
        x = y / torch.clamp(ordered_sum.norm(y), min=1e-30)
    return x


@needs_jax
@pytest.mark.parametrize("n", [33, 1024, 1025, 32769, 1 << 18])
def test_norm_bit_equal_to_jnp_norm(n):
    y = _draw(np.random.default_rng(n), (n,))[0]
    want = jax.jit(jnp.linalg.norm)(y)
    assert np.array_equal(_bits(want), _bits(ordered_sum.norm(torch.from_numpy(y))))


ELL_WIDTHS = list(range(1, 35)) + [40, 48, 64, 80]


@needs_jax
@pytest.mark.parametrize("widths", [ELL_WIDTHS[i::3] for i in range(3)])
def test_ell_power_iteration_bit_equal_to_jax(widths):
    """The port's ELL power-iteration step (``ell_dot_lanes("ell")`` rows,
    ``norm``) against the body of the JAX package's ``_ell_lambda_max`` run
    eagerly in a loop of two iterations, iterate bit for bit, at every width
    of ``ELL_WIDTHS``."""
    from parallel_amg_tpu.ops.ell import ELL as JELL

    def body(A, d_inv):
        def f(i, carry):
            x, lam = carry
            y = d_inv * A.matvec(x)
            nrm = jnp.linalg.norm(y)
            return y / jnp.maximum(nrm, 1e-30), jnp.where(nrm > 0, nrm, lam)
        return f

    bad = []
    for W in widths:
        cols, vals, nnz, d_inv = _ell_probe(1500, W, np.random.default_rng(W))
        A = JELL(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(nnz), (1500, 1500))
        x0 = device_setup.start_vector((1500,), torch.float32, "cpu", W)
        xj, _ = jax.lax.fori_loop(0, 2, body(A, jnp.asarray(d_inv)),
                                  (jnp.asarray(x0.numpy()), jnp.float32(1.0)))
        c, v, d = torch.from_numpy(cols).long(), torch.from_numpy(vals), torch.from_numpy(d_inv)
        lanes = ordered_sum.ell_dot_lanes(W)
        x = _port_power(x0, lambda x: d * ordered_sum.row_dot(v, x[c], lanes), 2)
        if not np.array_equal(_bits(xj), _bits(x)):
            bad.append(W)
    assert not bad, f"widths whose iterates differ: {bad}"


@needs_jax
@pytest.mark.parametrize("W", [5, 23, 28, 40])
def test_ell_lambda_max_bit_equal_to_jax(W):
    """``device_rs._ell_lambda_max`` against the JAX package's, 15 iterations."""
    from parallel_amg_tpu.amg import device_rs as jrs
    from parallel_amg_tpu.ops.ell import ELL as JELL
    from parallel_amg_tpu_torch.ops.ell import ELL

    cols, vals, nnz, d_inv = _ell_probe(900, W, np.random.default_rng(100 + W))
    jA = JELL(jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(nnz), (900, 900))
    A = ELL(torch.from_numpy(cols), torch.from_numpy(vals), torch.from_numpy(nnz), (900, 900))
    want = jrs._ell_lambda_max(jA, jnp.asarray(d_inv), 15, seed=2)
    got = device_rs._ell_lambda_max(A, torch.from_numpy(d_inv), 15, seed=2)
    assert np.array_equal(_bits(want), _bits(got))


@needs_jax
@pytest.mark.parametrize("K", [10, 30])
def test_pcsr_lambda_max_bit_equal_to_jax(K):
    """``prs_setup._pcsr_lambda_max`` against the JAX package's on 8 shards
    of a random banded matrix (own and ghost planes of K = 10: widths 11 and
    9; K = 30: 30 and 21), after 2, 3 and 15 iterations."""
    import scipy.sparse as sp

    from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
    from parallel_amg_tpu.parallel import prs_setup as jprs
    from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
    from parallel_amg_tpu_torch.parallel import prs_setup as prs
    from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR

    rng = np.random.default_rng(K)
    n = 4096
    rows, cols = [], []
    for i in range(n):
        c = np.unique(np.concatenate([[i], np.clip(i + rng.integers(-300, 301, rng.integers(1, K + 1)), 0, n - 1)]))
        rows += [i] * len(c)
        cols += list(c)
    A = sp.csr_matrix((np.ones(len(rows)), (rows, cols)), shape=(n, n))
    A.data = (rng.normal(size=A.nnz) * 10.0 ** rng.integers(-2, 3, A.nnz)).astype(np.float32)
    A.setdiag(np.abs(A.diagonal()) + 5)
    A = A.tocsr()
    Aj, At = JPCSR.from_csr(A, j_make_row_mesh(8)), PCSR.from_csr(A, make_row_mesh(8, device="cpu"))
    d_inv = prs._d_inv(At, torch.float32)
    dj = jnp.asarray(d_inv.to_global().numpy())
    for iters in (2, 3, 15):
        want = jprs._pcsr_lambda_max(Aj, dj, iters, 0)
        got = prs._pcsr_lambda_max(At, d_inv, iters, 0)
        assert np.array_equal(_bits(want), _bits(got)), iters


def test_fma_and_sqrt_correctly_rounded():
    """``fma_plain`` (float64 with round-to-odd) and ``sqrt`` against exact
    rational arithmetic: each result is the float32 nearest the exact value."""
    rng = np.random.default_rng(7)
    a, b, c = (_draw(rng, (400,))[0] for _ in range(3))
    got = ordered_sum.fma_plain(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    roots = ordered_sum.sqrt(torch.from_numpy(np.abs(a))).numpy()

    def nearest(g, exact):
        d = abs(Fraction(float(g)) - exact)
        return all(abs(Fraction(float(h)) - exact) >= d for h in
                   (np.nextafter(g, np.float32(-np.inf)), np.nextafter(g, np.float32(np.inf))))

    for i in range(400):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        assert nearest(got[i], exact), (a[i], b[i], c[i])
        r = roots[i]
        lo, hi = np.nextafter(r, np.float32(0)), np.nextafter(r, np.float32(np.inf))
        x = Fraction(float(abs(a[i])))
        # r is the float32 nearest √x: x lies between the squares of the midpoints
        assert (Fraction(float(lo)) + Fraction(float(r))) ** 2 / 4 <= x <= (
            Fraction(float(hi)) + Fraction(float(r))) ** 2 / 4
    assert ordered_sum.sqrt(torch.tensor(6.092010498046875)).item() == float(np.float32(math.sqrt(6.092010498046875)))


def test_sumsq_rules():
    """``sumsq``: one fma chain where no axis passes 32 (a 1-D or 3-D grid),
    the windows rule on the rounded squares otherwise, block by block on
    three axes."""
    rng = np.random.default_rng(9)
    y = torch.from_numpy(_draw(rng, (20,))[0])
    s = torch.zeros(())
    for v in y:
        s = ordered_sum.fma_plain(v, v, s)
    assert ordered_sum.sumsq(y).item() == s.item()
    y3 = torch.from_numpy(_draw(rng, (5, 6, 7))[0])
    flat = y3.reshape(1, -1)
    assert ordered_sum.sumsq(y3).item() == ordered_sum.row_dot(flat, flat, ordered_sum.CHAIN)[0].item()
    y1 = torch.from_numpy(_draw(rng, (100,))[0])
    assert ordered_sum.sumsq(y1).item() == row_sum(y1 * y1).item()
    g = torch.from_numpy(_draw(rng, (40, 3, 33))[0])
    sq = g * g
    # blocks (windows of 32 with padding 12/12 on axis 0 and 15/16 on axis 2)
    want = torch.zeros(())
    for a0, a1 in ((0, 20), (20, 40)):
        for b0, b1 in ((0, 17), (17, 33)):
            blk = torch.zeros(())
            for v in sq[a0:a1, :, b0:b1].reshape(-1):
                blk = blk + v
            want = want + blk
    assert ordered_sum.sumsq(g).item() == want.item()


@needs_jax
@pytest.mark.parametrize("dims,points", [((4, 4, 4), 27), ((3, 4, 4), 27),
                                         ((5, 4, 4), 27), ((4, 4, 5), 27),
                                         ((4, 4, 4), 7), ((4, 4), 9), ((4, 4), 5),
                                         ((4, 3), 9), ((8, 3), 9), ((16, 4), 5),
                                         ((24, 3), 9), ((20, 4), 9), ((4, 2), 9),
                                         ((12, 4), 9), ((8, 8, 8), 27), ((5, 8, 8), 27),
                                         ((4, 16, 4), 27), ((6, 8, 7), 27),
                                         ((43, 43, 43), 27), ((33, 33, 33), 27)])
def test_stencil_power_iteration_middle_lanes_bit_equal_to_jax(dims, points):
    """Grids with non-constant weights where LLVM vectorises the power
    iteration's Σ y² across the axis before the last (``_middle_lanes_vf``;
    at 33³ and 43³ the (2, 2, 2) block partials): the
    port's loop (``planes_dot`` in ``STENCIL_FIRST`` order, ``norm``) against
    the JAX package's power-iteration body in a jitted loop of four
    iterations, iterate bit for bit."""
    import itertools

    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    rng = np.random.default_rng(sum(dims) + points)
    nd = len(dims)
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=nd)
                 if points == 3 ** nd or sum(map(abs, o)) <= 1)
    zero = offs.index((0,) * nd)
    w = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims).astype(np.float32)
    w[zero] = rng.uniform(4.0, 8.0, size=dims).astype(np.float32)
    d = (1.0 / w[zero]).astype(np.float32)
    x0 = (rng.random(dims) - 0.5).astype(np.float32)

    def loop(A, d_inv, x):
        def body(i, carry):
            x, lam = carry
            y = d_inv * A.matvec(x)
            nrm = jnp.linalg.norm(y)
            return y / jnp.maximum(nrm, 1e-30), jnp.where(nrm > 0, nrm, lam)
        return jax.lax.fori_loop(0, 4, body, (x, jnp.asarray(1.0, x.dtype)))

    want = jax.jit(loop)(JStencil(jnp.asarray(w), offs, dims), jnp.asarray(d),
                         jnp.asarray(x0))[0]
    A = Stencil(torch.from_numpy(w), offs, dims)
    order = list(ordered_sum.STENCIL_FIRST) + list(range(2, len(offs)))
    planes, dt = A.weights[order], torch.from_numpy(d)

    def step(x):
        sh = A.shifted(x)
        return dt * ordered_sum.planes_dot(planes, torch.stack([sh[k] for k in order]))

    x = torch.from_numpy(x0)
    for _ in range(4):
        y = step(x)
        x = y / torch.clamp(ordered_sum.norm(y, structured=True, points=points), min=1e-30)
    assert np.array_equal(_bits(want), _bits(x))


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [((1000,), (1000,), ()), ((), (7, 33), ()),
                                    ((5, 6), (3, 3, 5, 6), (3, 3, 5, 6)),
                                    ((1, 1, 5, 6), (2, 3, 5, 6), (2, 3, 5, 6)),
                                    ((4, 1, 6), (4, 5, 6), (4, 5, 6))])
def test_fma_and_planes_sum_bit_equal_to_plain_cuda(shapes):
    """``ordered_sum.fma`` (the ordered_fma kernel; scalar, trailing-grid and
    expanded operands; in place into c) and ``planes_sum`` (the lanes kernel's plane mode a
    window) on the card against their plain versions, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("the ordered_fma kernel is CUDA C++ and needs a CUDA card")
    rng = np.random.default_rng(len(shapes[1]))
    a, b, c = (torch.from_numpy(np.asarray(_draw(rng, s)[0], np.float32).reshape(s))
               for s in shapes)
    before = ordered_sum.LAUNCHES["ordered_fma"]
    got = ordered_sum.fma(a.cuda(), b.cuda(), c.cuda()).cpu()
    assert ordered_sum.LAUNCHES["ordered_fma"] == before + 1
    assert torch.equal(got.view(torch.int32),
                       ordered_sum.fma_plain(a, b, c).view(torch.int32))
    if c.shape == got.shape:  # in place into c, one launch
        c_card = c.cuda().contiguous()
        ordered_sum.fma(a.cuda(), b.cuda(), c_card, out=c_card)
        assert torch.equal(c_card.cpu().view(torch.int32), got.view(torch.int32))
    for D in (7, 32, 33, 125, 343):
        x = torch.from_numpy(_draw(rng, (D, 60))[0])
        assert torch.equal(ordered_sum.planes_sum(x.cuda()).cpu().view(torch.int32),
                           ordered_sum.planes_sum(x).view(torch.int32)), D


@needs_jax
@pytest.mark.parametrize("dims,points", [((8, 8, 8), 7), ((9, 8, 7), 7),
                                         ((33, 33, 33), 7)])
def test_setup_power_iteration_lambda_bit_equal_to_jax(dims, points):
    """The structured setups' λ_max(D⁻¹A) on grids where LLVM vectorises
    the power iteration (the matvec's centre unfused where n1 = 8; the
    (2, 2, 2) norm partials of 33³ to 64³ in two lanes) against the JAX
    package's ``_jit_power`` on the same non-constant weights, float32 for
    float32."""
    import itertools

    from parallel_amg_tpu.amg import device_setup as jds
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    rng = np.random.default_rng(sum(dims) + points)
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=3)
                 if points == 27 or sum(map(abs, o)) <= 1)
    zero = offs.index((0, 0, 0))
    w = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims).astype(np.float32)
    w[zero] = rng.uniform(4.0, 8.0, size=dims).astype(np.float32)
    d = (1.0 / w[zero]).astype(np.float32)
    want = jds._jit_power(JStencil(jnp.asarray(w), offs, dims), jnp.asarray(d),
                          iters=15, seed=1)
    got = device_setup.power_iteration_lambda_max(
        Stencil(torch.from_numpy(w), offs, dims), torch.from_numpy(d), 15, seed=1)
    assert np.array_equal(_bits(want), _bits(got))
