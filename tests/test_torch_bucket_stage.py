"""One bucketed Galerkin stage (``ops/bucket_stage.py``) bit for bit against
the sequence of torch operations the setup ran before its kernel
(``bucket_sequence.earlier_sequence``, a frozen copy that builds its own
updates and masks) and, at 3-D 7-point levels, against the JAX package's
jitted stage.

Each case draws float32 factor planes with numpy from a seed (with −0 among
them) and runs the three stages of the bucketed product (S·T from a box of
ones, A·, Sᵀ·) in 1-D, 2-D and 3-D, 7- and 27-point (5 and 9 in 2-D): the
first stage has no whole-box update, the others have.  Other types take
torch's order, as the earlier sequence does.  The kernel's table
(``kernel_table``: the terms, and each one's source box per output box) is
held by an emulation of the kernel's walk on the CPU.  On the card (``-m cuda``) the
kernel ``ordered_bucket_stage`` against the plain version and the earlier
``ordered_fma`` launches, ``==``, one launch a stage.
"""

import functools
import itertools

import numpy as np
import pytest
import torch

from bucket_sequence import earlier_sequence
from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.ops import bucket_stage, ordered_sum
from parallel_amg_tpu_torch.ops.stencil import shift_nd

torch.set_num_threads(2)

B = 3
CASES = [((7, 6, 5), "star"), ((12, 12, 12), "star"), ((8, 7, 6), "box"),
         ((11, 10), "star"), ((10, 9), "box"), ((20,), "star")]


def _offsets(nd, kind):
    box = itertools.product((-1, 0, 1), repeat=nd)
    return tuple(o for o in box if kind == "box" or sum(map(abs, o)) <= 1)


def _boxes(nd):
    """The four boxes of the bucketed product at b = 3 over a reach-1 level."""
    return [tuple((0, 0) for _ in range(nd))] + [
        ds._cum_box((r,) * nd, B) for r in (1, 2, 3)]


@functools.cache
def _stages(dims, kind):
    """Per stage (F, X, offsets, box_in, box_out): seeded factors, X the
    earlier stage's output from the earlier sequence."""
    nd = len(dims)
    offs = _offsets(nd, kind)
    rng = np.random.default_rng(sum(dims) + len(offs))
    boxes = _boxes(nd)
    X = torch.ones((1,) * nd + dims)
    out = []
    for s in range(3):
        f = rng.uniform(-1.0, 1.0, size=(len(offs),) + dims).astype(np.float32)
        f[rng.random(f.shape) < 0.1] = -0.0
        F = torch.from_numpy(f)
        out.append((F, X, offs, boxes[s], boxes[s + 1]))
        X = earlier_sequence(list(F), offs, X, boxes[s], boxes[s + 1], B, dims)
    return out


def _bits(t):
    return t.contiguous().view(torch.int32)


def _emulate_kernel(F, X, rows, src, box_out, dims, skip_masked=False, X_alt=None):
    """The kernel's walk on the CPU: every term in order, its mask from the
    residues (lo ≤ p mod b < lo + b on every axis) and its factor, applied
    to every output box whose source box ``src`` names, X (``X_alt`` where
    the term's alt is set) read at p + off (0 off the grid), as a rounded
    product (kind 0), a fused multiply-add (1) or a rounded product added
    (2), the tail kind on the last axis from the term's tail on; with
    ``skip_masked`` a masked-off term is skipped (the wrong design)."""
    nd = len(dims)
    out_shape = tuple(h - l + 1 for l, h in box_out)
    n_out = int(np.prod(out_shape))
    Xf = X.reshape((-1,) + tuple(dims))
    Xa = None if X_alt is None else X_alt.reshape((-1,) + tuple(dims))
    cols = torch.arange(dims[-1])
    y = [torch.zeros(dims) for _ in range(n_out)]
    for row, boxes in zip(rows.tolist(), src.tolist()):
        kind, tail_kind, tail, alt, k = row[:5]
        off, lo = row[5 + 3 - nd:8], row[8 + 3 - nd:11]
        assert all(v == 0 for v in row[5:5 + 3 - nd] + row[8:8 + 3 - nd]) and row[11] == 0
        assert len(boxes) % bucket_stage.BOX_GROUP == 0 and all(v == -1 for v in boxes[n_out:])
        mask = torch.ones(dims, dtype=torch.bool)
        for i, n in enumerate(dims):
            r = (torch.arange(n) % B).reshape([n if j == i else 1 for j in range(nd)])
            mask = mask & (r >= lo[i]) & (r < lo[i] + B)
        f = torch.where(mask, F[k], 0.0)
        for o in range(n_out):
            if boxes[o] < 0:
                continue
            x = shift_nd((Xa if alt else Xf)[boxes[o]], off, dims)
            ys = {0: f * x, 1: ordered_sum.fma_plain(f, x, y[o]), 2: y[o] + f * x}
            new = torch.where(cols >= tail, ys[tail_kind], ys[kind])
            if skip_masked:
                new = torch.where(mask, new, y[o])
            y[o] = new
    return torch.stack(y).reshape(out_shape + tuple(dims))


def _loop_kernel_table(table, box_in, box_out, b):
    """The kernel's table as it was built before (frozen): Python loops over
    the terms and their target boxes, per term (kind, k, off, lo) padded to
    three axes, and the source box of every output box."""
    nd = len(box_out)
    pad = (0,) * (3 - nd)
    in_shape = tuple(h - l + 1 for l, h in box_in)
    out_shape = tuple(h - l + 1 for l, h in box_out)
    n_cols = -(-int(np.prod(out_shape)) // bucket_stage.BOX_GROUP) * bucket_stage.BOX_GROUP

    def linear(idx, shape):
        out = 0
        for i, n in zip(idx, shape):
            out = out * n + i
        return out

    rows, src = [], []
    for t in table:
        lo = tuple(d * b - c for d, c in zip(t.delta, t.off))
        rows.append((t.kind, t.k) + pad + tuple(t.off) + pad + lo)
        cols = [-1] * n_cols
        for o in itertools.product(*[range(g.start, g.stop) for g in t.tgt]):
            s = tuple(c - g.start + r.start for c, g, r in zip(o, t.tgt, t.src))
            cols[linear(o, out_shape)] = linear(s, in_shape)
        src.append(cols)
    return rows, src


@pytest.mark.parametrize("dims,kind", CASES)
@pytest.mark.parametrize("s", [0, 1, 2])
def test_stage_bit_equal_to_earlier_sequence(dims, kind, s):
    """The plain version (``stage`` on CPU tensors) equals the earlier
    sequence; stage 0 has no whole-box update, stages 1 and 2 have."""
    F, X, offs, box_in, box_out = _stages(dims, kind)[s]
    table = bucket_stage.terms(offs, box_in, box_out, B)
    full, _ = bucket_stage.updates(offs, box_in, box_out, B)
    assert (len(full) > 0) == (s > 0)
    assert [t.kind for t in table] == [0] + [1] * (len(table) - 1)
    got = bucket_stage.stage(F, offs, X, box_in, box_out, B, dims)
    want = earlier_sequence(list(F), offs, X, box_in, box_out, B, dims)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dims,kind", CASES)
@pytest.mark.parametrize("s", [0, 2])
def test_kernel_table_walk_equals_plain(dims, kind, s):
    """The kernel's table, walked element by element as the kernel walks it,
    gives the plain version's bits."""
    F, X, offs, box_in, box_out = _stages(dims, kind)[s]
    table = bucket_stage.terms(offs, box_in, box_out, B)
    rows, src = bucket_stage.kernel_table(table, box_in, box_out, B)
    assert rows.shape == (len(table), bucket_stage.TERM_INTS) and len(src) == len(rows)
    plain = bucket_stage.stage_plain(F, offs, X, box_in, box_out, B, dims)
    got = _emulate_kernel(F, X, rows, src, box_out, dims)
    assert torch.equal(_bits(got), _bits(plain))


@pytest.mark.parametrize("dims,kind", CASES)
@pytest.mark.parametrize("s", [0, 1, 2])
def test_kernel_table_equals_loop_built(dims, kind, s):
    """``kernel_table`` (numpy index arithmetic over the output boxes) gives
    the loop-built table's kinds, planes, offsets, residue windows and
    source boxes, with no tail and no alt read in the stage order."""
    _, _, offs, box_in, box_out = _stages(dims, kind)[s]
    table = bucket_stage.terms(offs, box_in, box_out, B)
    rows, src = bucket_stage.kernel_table(table, box_in, box_out, B)
    old_rows, old_src = _loop_kernel_table(table, box_in, box_out, B)
    assert rows.dtype == np.int32 and src.dtype == np.int32
    assert rows[:, [0, 4, 5, 6, 7, 8, 9, 10]].tolist() == [list(r) for r in old_rows]
    assert (rows[:, 1] == 2).all() and (rows[:, 2] == bucket_stage.NO_TAIL).all()
    assert (rows[:, 3] == 0).all() and (rows[:, 11] == 0).all()
    assert src.tolist() == old_src


# Each kind of departure at a grid of CASES with its stencil: the stage
# orders of ``bucket_stage._DEPARTURES`` at 11 × 10 (the centre rounded; 9
# points: the first two rounded, a sliced update rounded from column 8) and
# 8 × 7 × 6 (27 points: a stored product, sliced updates rounded from
# columns 4 and 5), and an alt read and output on 7 × 6 × 5.
_ALT = bucket_stage.Order(alt=((0, 0, -1), (0, 0, 1)))
DEPARTURE_CASES = [((11, 10), "star", (2, 5, (11, 10))), ((10, 9), "box", (2, 9, (11, 10))),
                   ((8, 7, 6), "box", (3, 27, (8, 7, 6))), ((7, 6, 5), "star", None)]


def _orders(key):
    return (bucket_stage.Order(), bucket_stage.Order(), _ALT) if key is None else \
        bucket_stage._DEPARTURES[key]


@pytest.mark.parametrize("dims,kind,key", DEPARTURE_CASES)
@pytest.mark.parametrize("s", [0, 1, 2])
def test_kernel_table_walk_equals_plain_departures(dims, kind, key, s):
    """With a departing order (rounded products, tails on the last axis,
    stored products, alt reads), the kernel's table walked as the kernel
    walks it gives the plain version's bits, and the plain version's alt
    output is its Y with the last update's product added rounded."""
    F, X, offs, box_in, box_out = _stages(dims, kind)[s]
    order = _orders(key)[s]
    X_alt = X + 0.25 if order.alt else None
    table = bucket_stage.terms(offs, box_in, box_out, B, order)
    rows, src = bucket_stage.kernel_table(table, box_in, box_out, B)
    plain, plain_alt = bucket_stage.stage_plain(F, offs, X, box_in, box_out, B, dims, order,
                                                X_alt, alt_out=True)
    got = _emulate_kernel(F, X, rows, src, box_out, dims, X_alt=X_alt)
    assert torch.equal(_bits(got), _bits(plain))
    last = rows.copy()
    last[-1, 0] = last[-1, 1] = 2
    got_alt = _emulate_kernel(F, X, last, src, box_out, dims, X_alt=X_alt)
    assert torch.equal(_bits(got_alt), _bits(plain_alt))
    plain_table = bucket_stage.terms(offs, box_in, box_out, B)
    assert (table != plain_table) == (order != bucket_stage.Order())


@pytest.mark.parametrize("dims,kind", [((7, 6, 5), "star"), ((10, 9), "box")])
def test_masked_off_terms_are_computed(dims, kind):
    """A masked-off term is fma(+0, x, y), not skipped: where the whole-box
    sum starts from a −0 product (+0 times a negative x) and nothing nonzero
    is added, a later masked-off term turns it into +0, and the kernel's walk
    with the masked-off terms skipped would leave −0."""
    F, X, offs, box_in, box_out = _stages(dims, kind)[1]
    table = bucket_stage.terms(offs, box_in, box_out, B)
    rows, src = bucket_stage.kernel_table(table, box_in, box_out, B)
    plain = bucket_stage.stage_plain(F, offs, X, box_in, box_out, B, dims)
    skipped = _emulate_kernel(F, X, rows, src, box_out, dims, skip_masked=True)
    differ = _bits(skipped) != _bits(plain)
    assert differ.any()
    assert (_bits(skipped)[differ] == -2**31).all() and (_bits(plain)[differ] == 0).all()


@pytest.mark.parametrize("dims", [(7, 6, 5), (12, 12, 12)])
def test_stage_bit_equal_to_jax(dims):
    """At 3-D 7-point levels every stage equals the JAX package's jitted
    ``_bucket_stage`` on the same inputs."""
    import jax
    import jax.numpy as jnp

    from parallel_amg_tpu.amg import device_setup as jds

    for s, (F, X, offs, box_in, box_out) in enumerate(_stages(dims, "star")):
        got = bucket_stage.stage(F, offs, X, box_in, box_out, B, dims)
        run = jax.jit(lambda f, x: jds._bucket_stage(list(f), offs, x, box_in, box_out, B,
                                                     dims))
        want = np.asarray(run(jnp.asarray(F.numpy()), jnp.asarray(X.numpy())))
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), s


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("dims,kind", [((7, 6, 5), "star"), ((10, 9), "box")])
def test_other_types_take_torch_order(dims, kind, dtype):
    """Types other than float32 take torch's order (a rounded product and a
    rounded add), as the earlier sequence does, every stage."""
    for F, X, offs, box_in, box_out in _stages(dims, kind):
        F, X = F.to(dtype), X.to(dtype)
        got = bucket_stage.stage(F, offs, X, box_in, box_out, B, dims)
        want = earlier_sequence(list(F), offs, X, box_in, box_out, B, dims)
        assert got.dtype == dtype and torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


def test_stage_refuses_mixed_types_and_other_devices():
    F, X, offs, box_in, box_out = _stages((7, 6, 5), "star")[1]
    with pytest.raises(TypeError, match="factors of"):
        bucket_stage.stage(F.double(), offs, X, box_in, box_out, B, (7, 6, 5))
    with pytest.raises(ValueError, match="cpu or cuda"):
        bucket_stage.stage(F.to("meta"), offs, X.to("meta"), box_in, box_out, B, (7, 6, 5))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,kind", CASES)
def test_kernel_bit_equal_to_plain_cuda(dims, kind):
    """The kernel against the plain version and the earlier ``ordered_fma``
    sequence, every stage, one launch a stage."""
    if not torch.cuda.is_available():
        pytest.skip("ordered_bucket_stage is CUDA C++ and needs a CUDA card")
    for F, X, offs, box_in, box_out in _stages(dims, kind):
        plain = bucket_stage.stage(F, offs, X, box_in, box_out, B, dims)
        Fc, Xc = F.cuda(), X.cuda()
        before = ordered_sum.LAUNCHES["ordered_bucket_stage"]
        got = bucket_stage.stage(Fc, offs, Xc, box_in, box_out, B, dims)
        assert ordered_sum.LAUNCHES["ordered_bucket_stage"] == before + 1
        seq = earlier_sequence(list(Fc), offs, Xc, box_in, box_out, B, dims)
        assert torch.equal(_bits(got.cpu()), _bits(plain))
        assert torch.equal(_bits(seq.cpu()), _bits(plain))


@pytest.mark.cuda
@pytest.mark.parametrize("dims,kind,key", DEPARTURE_CASES)
def test_kernel_departures_bit_equal_to_plain_cuda(dims, kind, key):
    """The kernel with each kind of departure (and the alt read and output)
    against the plain version, every stage, one launch a stage."""
    if not torch.cuda.is_available():
        pytest.skip("ordered_bucket_stage is CUDA C++ and needs a CUDA card")
    for (F, X, offs, box_in, box_out), order in zip(_stages(dims, kind), _orders(key)):
        X_alt = X + 0.25 if order.alt else None
        plain = bucket_stage.stage(F, offs, X, box_in, box_out, B, dims, order, X_alt,
                                   alt_out=True)
        before = ordered_sum.LAUNCHES["ordered_bucket_stage"]
        got = bucket_stage.stage(F.cuda(), offs, X.cuda(), box_in, box_out, B, dims, order,
                                 None if X_alt is None else X_alt.cuda(), alt_out=True)
        assert ordered_sum.LAUNCHES["ordered_bucket_stage"] == before + 1
        for g, p in zip(got, plain):
            assert torch.equal(_bits(g.cpu()), _bits(p))


@pytest.mark.parametrize("dims,kind,warns", [((128, 128, 128), "star", False),
                                             ((52, 52, 52), "box", False),
                                             ((13, 12, 11), "star", False),
                                             ((9, 9, 9), "star", True),
                                             ((17, 5), "box", True)])
def test_product_orders_warn_where_not_read(dims, kind, warns):
    """``product_orders`` gives the read departures (or none) at the grids
    read, and warns and takes the stage order elsewhere."""
    import warnings

    offs = _offsets(len(dims), kind)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        orders = bucket_stage.product_orders(offs, dims, B)
    assert len(orders) == 3 and bool(caught) == warns
    if warns:
        assert "not read" in str(caught[0].message)
        assert orders == (bucket_stage.Order(),) * 3
    assert orders == bucket_stage._DEPARTURES.get((len(dims), len(offs), dims), orders)
