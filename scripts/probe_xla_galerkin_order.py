"""Read the float32 orders of the JAX package's structured Galerkin setup off
XLA's CPU backend, the ones ``parallel_amg_tpu_torch/amg/device_setup.py``
and ``ops/ordered_sum.py`` reproduce, and check the port against them.

A sum's order is revealed through the JAX function itself: with every term 1
except a pair at +2⁴⁰ and −2⁴⁰, the result counts the terms outside the
smallest subtree that holds the pair, so all pairs give the whole tree
("FPRev").  Run on the CPU (JAX_PLATFORMS=cpu), a few minutes:

    python3 scripts/probe_xla_galerkin_order.py [--dot] [--pool] [--rsqrt]
        [--bucketed] [--norms] [--norms2d]

- ``--dot``: the one-hot dot of ``galerkin_block`` (onehot (n_out, K) @
  piece (K, nc)) at every shape the setups meet: config #3 at 128³ on one
  device and in 4 parts and config #5 at 128³×3, each run here to collect
  its shapes (``device_setup._dot_order``'s arguments), and the shapes of 324³×3 and
  468³ in 8 parts that chip_smoke.py recorded on the card
  (artifacts/galerkin_dot_shapes.json, a copy of the
  build/galerkin_dot_shapes.json it writes), with the tests' shapes.  For each
  it reveals the tree along leaf 0 in every output column (the size of the
  subtree leaf 0 shares with leaf k, for every k: a chain gives k + 1, a
  k-block boundary a jump), prints the column ranges and their k-blocks,
  and the share of outputs ``device_setup._dot_order`` reproduces on
  random data with ``galerkin_block``'s one-hot pattern (it should be 1),
  with a warning where n_out is one ``_dot_order`` was not read for.
- ``--pool``: the tree of the padded ``reduce_window`` of the bucketed
  product for every padding of a 3-D block of 3 (``device_setup._window_sum``).
- ``--rsqrt``: XLA's 1/√c for c = 1 … 64 against ``device_setup.block_scale``.
- ``--bucketed``: the port's bucketed product against the JAX package's, bits
  differing per shape (``ops/bucket_stage.py``; ~30 s a 27-point shape).
- ``--bucketed-solve [DIMSxPOINTS ...]``: reads the departures of the JAX
  package's whole jitted product from the stage order (``bucket_stage.Order``)
  at each shape (default: those of ``bucket_stage._DEPARTURES``).  The
  jitted product is run again with one stage's output as an extra result
  (its coarse weights checked unchanged), and each stage of the port, fed the
  JAX package's input, is brought to that output one term at a time: at the
  differing points, the terms whose rounded (kind 2) or stored (kind 0)
  product gives the JAX package's float, tried over the whole stage, from
  each column R of the last axis that the points name (a tail) or
  everywhere; the change that leaves the fewest floats differing is kept.
  Prints each stage's changes beside ``product_orders``' for the shape.
  It cannot find an alt read (32³: a consumer fusion that rounds the
  previous stage's last update), which shows as a stage it leaves
  differing; read those off the pad fusions' ``*ir-with-opt.ll``
  (``XLA_FLAGS=--xla_dump_to=DIR``: an fadd fed by a phi of two fmuls).
- ``--norms``: the setups' λ_max(D⁻¹A), port against the JAX package's
  ``_jit_power``, per grid (``ordered_sum._middle_lanes_vf``,
  ``device_setup._unfused_centre``).
- ``--norms2d``: the 2-D power iteration's orders (~10 min).  (1) The two
  reductions of its norm, each compiled alone on a (p0, p1) input for p0,
  p1 ≤ 32 (the same LLVM code as inside ``_jit_power``: compared by
  ``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text``, the
  ``reduce_sqrt_fusion`` and ``add_multiply_fusion`` ``*ir-with-opt.ll`` and
  object files): Σ y² of a small grid (``jnp.sum(y * y)``) and Σ of window
  partials (``jnp.sum(p)``), on random data, against
  ``ordered_sum._middle_lanes_vf``'s lanes (``_rows_lanes``) or the chain;
  prints the shapes where the port differs.  (2) The window order of a grid
  whose axis 1 is padded by one (63², FPRev on ``jnp.sum``).  (3) The matvec
  alone (``d * A.matvec(x)`` jitted, the fusion of the power iteration) on
  5- and 9-point grids with n1 of 1 to 12 against
  ``ordered_stencil.plan_2d``.  (4) λ against ``_jit_power`` on 2-D Poisson
  and seeded 5- and 9-point grids, tiny ones (``ordered_sum.ONE_CALL``:
  which grids XLA compiles into one function shows in the dump as a
  ``call.N_computation`` module in place of ``reduce_sqrt_fusion``) and two
  window levels.
"""

from __future__ import annotations

import argparse
import itertools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from parallel_amg_tpu.amg import device_setup as jds  # noqa: E402
from parallel_amg_tpu.ops.stencil import Stencil as JStencil  # noqa: E402

from parallel_amg_tpu_torch.amg import device_setup as ds  # noqa: E402
from parallel_amg_tpu_torch.ops import ordered_sum  # noqa: E402
from parallel_amg_tpu_torch.ops.stencil import Stencil  # noqa: E402

BIG = np.float32(2.0 ** 40)
F32 = np.float32


def tree(S, idx):
    """The binary tree of a sum from its lowest-common-subtree sizes S."""
    idx = list(idx)
    if len(idx) == 1:
        return str(idx[0])
    x = idx[0]
    a = [x] + [y for y in idx[1:] if S[x, y] < len(idx)]
    b = [y for y in idx if y not in a]
    if not b:
        return "?"
    return f"({tree(S, a)}+{tree(S, b)})"


DOT_SHAPES_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "galerkin_dot_shapes.json")
# shapes the tests hold (tests/test_torch_config3_order.py)
TEST_DOT_SHAPES = [(27, 343, 3375), (27, 216, 3375), (27, 125, 3375),
                   (64, 343, 3375), (27, 343, 1800)]


def setup_dot_shapes():
    """{setup: [(n_out, K, nc), ...]} of config #3 at 128³ (one device and 4
    parts) and config #5 at 128³×3, run here on the CPU, and of the setups
    chip_smoke.py recorded on the card."""
    import json

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson_stencil
    from parallel_amg_tpu_torch.problems.elasticity import coupled_laplacian

    cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                        smoother="chebyshev", n_coarse_max=512, on_device_setup=True)
    def one_device():
        return ptt.setup(poisson_stencil((128,) * 3, device="cpu"), cfg, device="cpu")

    def four_parts():
        A, td = ptt.poisson_stencil_sharded((128,) * 3, ptt.make_row_mesh(4, device="cpu"),
                                            cfg)
        return ptt.sharded_device_setup(A, cfg, true_dims=td)

    def config5():
        L, C = coupled_laplacian((128,) * 3, 3, 0.3, device="cpu")
        return ptt.setup_vector_kron(L, C, cfg)

    runs = {"config3 128^3": one_device, "config3 128^3 in 4 parts": four_parts,
            "config5 128^3x3": config5}
    shapes, inner = {}, ds._dot_order
    for name, run in runs.items():
        seen = set()

        def recording(n_out, K, nc):
            seen.add((n_out, K, nc))
            return inner(n_out, K, nc)

        ds._dot_order = recording
        try:
            run()
        finally:
            ds._dot_order = inner
        shapes[name] = sorted(seen)
    if os.path.exists(DOT_SHAPES_FILE):
        with open(DOT_SHAPES_FILE) as f:
            for name, sh in json.load(f).items():
                shapes[f"{name} (card)"] = [tuple(x) for x in sh]
    return shapes


def reveal_leaf0(n_out, K, nc):
    """Per output column, the size of the smallest subtree holding leaves 0
    and k, for k = 1 … K−1 (row 0 of the output): ±2⁴⁰ at k = 0 and k among
    ones."""
    dot = jax.jit(lambda a, b: a @ b)
    oh = jnp.asarray(np.ones((n_out, K), F32))
    S0 = np.zeros((nc, K), np.int64)
    for k in range(1, K):
        T = np.ones((K, nc), F32)
        T[0], T[k] = BIG, -BIG
        S0[:, k] = K - np.rint(np.asarray(dot(oh, jnp.asarray(T)))[0]).astype(np.int64)
    return S0


def k_blocks(s0, K):
    """The k-block starts along leaf 0's path (a chain from each start, the
    block sums chained: leaf 0 meets a later block once that block is
    whole), or None where the tree is not of that form (lanes)."""
    starts, k = [0], 1
    while k < K and s0[k] == k + 1:
        k += 1
    while k < K:
        starts.append(k)
        j = k
        while j + 1 < K and s0[j + 1] == s0[k]:
            j += 1
        if s0[k] != j + 1:
            return None
        k = j + 1
    return starts


def _dot_equal(n_out, K, nc, seed=1):
    """Share of outputs where the port's ``_onehot_dot`` in ``_dot_order``'s
    order equals the jitted JAX ``a @ b`` on a random one-hot pattern."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_out, K)
    oh = (ids[None, :] == np.arange(n_out)[:, None]).astype(F32)
    T = (rng.standard_normal((K, nc)) * np.exp2(rng.integers(-8, 8, (K, nc)))).astype(F32)
    want = np.asarray(jax.jit(lambda a, b: a @ b)(oh, T))
    got = ds._onehot_dot(ids.tolist(), torch.from_numpy(T), n_out,
                         ds._dot_order(n_out, K, nc)).numpy()
    return float((want.view(np.int32) == got.view(np.int32)).mean())


def probe_dot():
    shapes = setup_dot_shapes()
    shapes["tests"] = TEST_DOT_SHAPES
    seen = set()
    for name, sh in shapes.items():
        print("setup", name, "shapes", sh, flush=True)
        for n_out, K, nc in sh:
            if (n_out, K, nc) in seen:
                continue
            seen.add((n_out, K, nc))
            if n_out not in ds._DOT_KC:
                print(f"  warning: n_out {n_out} is not one _dot_order's k-block "
                      f"table was read for ({sorted(ds._DOT_KC)}); its order "
                      f"{ds._dot_order(n_out, K, nc)} holds only where the "
                      f"share below is 1 (ROADMAP C7c)", flush=True)
            S0 = reveal_leaf0(n_out, K, nc)
            groups, prev = [], "none yet"
            for j in range(nc):
                b = k_blocks(S0[j], K) or "not blocks (lanes)"
                if b != prev:
                    groups.append([j, j, b])
                    prev = b
                else:
                    groups[-1][1] = j
            print(f"  ({n_out}, {K}, {nc}): XLA's k-blocks by column "
                  + "; ".join(f"{a}-{z}: {b}" for a, z, b in groups)
                  + f"; _dot_order {ds._dot_order(n_out, K, nc)}; share of outputs "
                  f"equal {_dot_equal(n_out, K, nc):.4f}", flush=True)


def probe_pool():
    b = 3
    for rem in itertools.product((0, 1, 2), repeat=3):
        dims = tuple(6 + r for r in rem)
        cdims = tuple(-(-d // b) for d in dims)

        def f(N):
            Np = jnp.pad(N, [(0, cdims[i] * b - dims[i]) for i in range(3)])
            return jax.lax.reduce_window(Np, jnp.zeros((), jnp.float32), jax.lax.add,
                                         (b,) * 3, (b,) * 3, "VALID")
        jf = jax.jit(f)
        K = b ** 3
        S = np.zeros((K, K), np.int32)
        for i in range(K):
            for j in range(i + 1, K):
                v = np.ones(K, F32)
                v[i], v[j] = BIG, -BIG
                x = np.tile(v.reshape((b,) * 3), cdims)[tuple(slice(0, d) for d in dims)]
                S[i, j] = S[j, i] = K - int(round(float(np.asarray(jf(x))[0, 0, 0])))
        print("dims", dims, "pad", tuple(c * b - d for c, d in zip(cdims, dims)),
              tree(S, range(K)), flush=True)


def probe_rsqrt():
    f = jax.jit(lambda c: 1.0 / jnp.sqrt(jnp.maximum(c, 1.0)))
    c = np.arange(1, 65, dtype=F32)
    xla = np.asarray(f(jnp.asarray(c))).view(np.int32)
    port = ds.block_scale(torch.from_numpy(c)).numpy().view(np.int32)
    rounded = (1.0 / np.sqrt(c.astype(np.float64))).astype(F32).view(np.int32)
    print("XLA's 1/sqrt(c) differs from the correctly rounded value at c =",
          [int(k) for k in c[xla != rounded]])
    print("block_scale equal to XLA's for c = 1..64:", bool((xla == port).all()))


def probe_bucketed():
    b = 3
    for dims, pts in [((7, 6, 5), 7), ((12, 12, 12), 7), ((14, 14, 14), 7),
                      ((20, 20, 20), 7), ((44, 44, 44), 7), ((32, 32, 32), 7),
                      ((13, 12, 11), 7), ((8, 7, 6), 27), ((16, 16, 16), 27),
                      ((52, 52, 52), 27), ((11, 10), 5), ((11, 10), 9)]:
        offs, W, d, coef, cdims, sc = _bucketed_inputs(dims, pts)
        j = np.asarray(jds._jit_bucketed(JStencil(jnp.asarray(W), offs, dims),
                                         jnp.asarray(d), jnp.asarray(coef), cdims, b,
                                         jnp.asarray(sc)).weights)
        t = ds.bucketed_coarse_operator(Stencil(torch.from_numpy(W), offs, dims),
                                        torch.from_numpy(d), torch.tensor(coef), cdims,
                                        b, torch.from_numpy(sc)).weights.numpy()
        print(dims, pts, "points: floats differing",
              int((t.view(np.int32) != j.view(np.int32)).sum()), "of", t.size,
              flush=True)


def _bucketed_inputs(dims, pts):
    """The probe's seeding: default_rng(3), standard-normal weights and D⁻¹,
    coef 0.37, the scale uniform in [0.5, 1.5)."""
    nd = len(dims)
    rng = np.random.default_rng(3)
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=nd)
                 if pts == 3 ** nd or sum(map(abs, o)) <= 1)
    W = rng.standard_normal((len(offs),) + dims).astype(F32)
    d = rng.standard_normal(dims).astype(F32)
    cdims = tuple(-(-x // 3) for x in dims)
    sc = (rng.random(cdims) + 0.5).astype(F32)
    return offs, W, d, F32(0.37), cdims, sc


def _jax_stage_outputs(dims, pts):
    """The JAX package's jitted bucketed product run three times, each with
    one stage's output as an extra result: those outputs, after checking
    that the coarse weights stay the product's own."""
    offs, W, d, coef, cdims, sc = _bucketed_inputs(dims, pts)
    nd, b = len(dims), 3
    whole = np.asarray(jds._jit_bucketed(JStencil(jnp.asarray(W), offs, dims), jnp.asarray(d),
                                         jnp.asarray(coef), cdims, b, jnp.asarray(sc)).weights)
    outs = []
    for want in range(3):
        def f(w, d_inv, c, scale, want=want):
            A = JStencil(w, offs, dims)
            rA = tuple(max(abs(o[i]) for o in offs) for i in range(nd))
            boxes = [tuple((0, 0) for _ in range(nd))] + [
                jds._cum_box(tuple(k * r for r in rA), b) for k in (1, 2, 3)]
            zero = offs.index((0,) * nd)
            s_pl = [-c * d_inv * A.weights[i] for i in range(len(offs))]
            s_pl[zero] = s_pl[zero] + 1.0
            st_pl = [-c * A.weights[i] * jds._shift_field(d_inv, offs[i], dims)
                     for i in range(len(offs))]
            st_pl[zero] = st_pl[zero] + 1.0
            X = jnp.ones((1,) * nd + tuple(dims), w.dtype)
            stages = []
            for fac, bi, bo in zip((s_pl, list(A.weights), st_pl), boxes, boxes[1:]):
                X = jds._bucket_stage(fac, offs, X, bi, bo, b, dims)
                stages.append(X)
            pool = jax.lax.reduce_window(
                jnp.pad(X, [(0, 0)] * nd + [(0, cdims[i] * b - dims[i]) for i in range(nd)]),
                jnp.zeros((), w.dtype), jax.lax.add, (1,) * nd + (b,) * nd,
                (1,) * nd + (b,) * nd, "VALID")
            out_offs = sorted(itertools.product(*[range(lo, hi + 1) for lo, hi in boxes[3]]))
            r = [max(abs(o[i]) for o in out_offs) for i in range(nd)]
            sp = jnp.pad(scale, [(r[i], r[i]) for i in range(nd)])
            col = jnp.stack([jax.lax.slice(sp, [r[i] + o[i] for i in range(nd)],
                                           [r[i] + o[i] + cdims[i] for i in range(nd)])
                             for o in out_offs])
            planes = pool.reshape((len(out_offs),) + tuple(cdims)) * scale[None] * col
            return planes, stages[want]
        planes, out = jax.jit(f)(jnp.asarray(W), jnp.asarray(d), jnp.asarray(coef),
                                 jnp.asarray(sc))
        same = np.array_equal(np.asarray(planes).view(np.int32), whole.view(np.int32))
        outs.append((np.asarray(out), same))
    return outs


def _solve_stage(dims, pts, s, X, want, max_changes=12):
    """Per-term kind changes that bring the port's stage ``s`` (fed X) to
    ``want``: list of ((off, δ), kind or (kind, R)), and the floats left."""
    from parallel_amg_tpu_torch.ops import bucket_stage
    from parallel_amg_tpu_torch.ops.stencil import shift_nd

    offs, W, d, coef, cdims, sc = _bucketed_inputs(dims, pts)
    A = Stencil(torch.from_numpy(W), offs, dims)
    factors, boxes = ds.bucket_stage_factors(A, torch.from_numpy(d), torch.tensor(coef), 3)
    F, nd = factors[s], len(dims)
    table = bucket_stage.terms(offs, boxes[s], boxes[s + 1], 3)
    out_shape = tuple(h - l + 1 for l, h in boxes[s + 1])
    Xt = torch.from_numpy(np.array(X))
    want = want.view(np.int32)
    ops = [(torch.where(bucket_stage.residue_mask(dims, t.off, t.delta, 3, "cpu"), F[t.k],
                        0.0).reshape((1,) * nd + dims), shift_nd(Xt, t.off, dims)[t.src])
           for t in table]
    cols = torch.arange(dims[-1])

    def one(k, fm, xs, y):
        return fm * xs if k == 0 else (
            ordered_sum.fma_plain(fm, xs, y) if k == 1 else y + fm * xs)

    def run(kinds):
        Y = torch.zeros(out_shape + dims)
        for t, (fm, xs), k in zip(table, ops, kinds):
            km, kt, R = (k, k, 0) if isinstance(k, int) else (t.kind, k[0], k[1])
            y = one(km, fm, xs, Y[t.tgt])
            if kt != km:
                y = torch.where(cols >= R, one(kt, fm, xs, Y[t.tgt]), y)
            Y[t.tgt] = y
        return Y.numpy().view(np.int32)

    def exact(kind, f, x, y):
        if kind == 0:
            return F32(f * x)
        if kind == 1:  # through fma_plain: Fraction would lose the sign of 0
            return ordered_sum.fma_plain(*(torch.tensor(v) for v in (f, x, y))).numpy()[()]
        return F32(y + F32(f * x))

    kinds = [t.kind for t in table]
    cur = int((run(kinds) != want).sum())
    changes = []
    for _ in range(max_changes):
        if not cur:
            break
        y = run(kinds)
        votes = {}
        for r in [tuple(map(int, v)) for v in np.argwhere(y != want)][:200]:
            box, p = r[:nd], r[nd:]
            seq = []
            for i, t in enumerate(table):
                if not all(g.start <= c < g.stop for g, c in zip(t.tgt, box)):
                    continue
                m = all((p[a] % 3 + t.off[a]) // 3 == t.delta[a] for a in range(nd))
                sb = tuple(c - g.start + q.start for c, g, q in zip(box, t.tgt, t.src))
                q = tuple(a + o for a, o in zip(p, t.off))
                x = X[sb + q] if all(0 <= v < n for v, n in zip(q, dims)) else F32(0)
                seq.append((i, F[t.k].numpy()[p] if m else F32(0), x))
            for i, _, _ in seq:
                for k in (0, 2):
                    acc = F32(0)
                    for j, f, x in seq:
                        kk = kinds[j] if isinstance(kinds[j], int) else (
                            kinds[j][0] if p[-1] >= kinds[j][1] else table[j].kind)
                        acc = exact(k if j == i else kk, f, x, acc)
                    if acc.view(np.int32) == want[r] and kinds[i] != k:
                        votes.setdefault((i, k), set()).add(p[-1])
        best = None
        for (i, k), cs in sorted(votes.items(), key=lambda kv: -len(kv[1]))[:15]:
            for opt in [k] + ([(k, R) for R in sorted(cs)] if k == 2 else []):
                trial = list(kinds)
                trial[i] = opt
                n_left = int((run(trial) != want).sum())
                if best is None or n_left < best[0]:
                    best = (n_left, i, opt)
        if best is None or best[0] >= cur:
            break
        cur, i, opt = best
        kinds[i] = opt
        changes.append(((table[i].off, table[i].delta), opt))
    return changes, cur


def probe_bucketed_solve(shapes=None):
    from parallel_amg_tpu_torch.ops import bucket_stage

    shapes = shapes or [(dims, pts) for (nd, pts, dims) in bucket_stage._DEPARTURES]
    for dims, pts in shapes:
        outs = _jax_stage_outputs(dims, pts)
        X = np.ones((1,) * len(dims) + dims, F32)
        orders = bucket_stage.product_orders(_bucketed_inputs(dims, pts)[0], dims, 3)
        for s, (want, same) in enumerate(outs):
            changes, left = _solve_stage(dims, pts, s, X, want)
            print(dims, pts, f"stage {s + 1}: product unchanged with the extra result {same}, "
                  f"changes {changes}, floats left {left}; product_orders {orders[s]}",
                  flush=True)
            X = want


def probe_norms():
    for dims, pts in [((4, 4, 4), 27), ((4, 4, 5), 27), ((8, 8, 8), 27),
                      ((5, 8, 8), 27), ((4, 4, 4), 7), ((8, 8, 8), 7),
                      ((9, 8, 7), 7), ((33, 33, 33), 7), ((43, 43, 43), 27),
                      ((7, 16, 5), 7), ((4, 4), 9), ((8, 8), 9)]:
        equal = []
        for seed in range(3):
            rng = np.random.default_rng(seed)
            nd = len(dims)
            offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=nd)
                         if pts == 3 ** nd or sum(map(abs, o)) <= 1)
            zero = offs.index((0,) * nd)
            W = rng.uniform(-1, 1, (len(offs),) + dims).astype(F32)
            W[zero] = rng.uniform(4, 8, dims).astype(F32)
            d = (1 / W[zero]).astype(F32)
            want = jds._jit_power(JStencil(jnp.asarray(W), offs, dims), jnp.asarray(d),
                                  iters=15, seed=seed)
            got = ds.power_iteration_lambda_max(Stencil(torch.from_numpy(W), offs, dims),
                                                torch.from_numpy(d), 15, seed=seed)
            equal.append(float(got) == float(want))
        print(dims, pts, "points: the setups' λ_max equal over 3 seeds", equal,
              "norm lanes", ordered_sum._middle_lanes_vf(dims), flush=True)


def _jax_sum(square: bool):
    return jax.jit((lambda p: jnp.sum(p * p)) if square else (lambda p: jnp.sum(p)))


def probe_norms2d():
    from parallel_amg_tpu.amg import device_setup as jds_
    from parallel_amg_tpu_torch.ops import ordered_stencil

    rng = np.random.default_rng(0)
    for square in (True, False):
        f, bad = _jax_sum(square), []
        for p0, p1 in itertools.product(range(1, 33), repeat=2):
            if p0 * p1 == 1:
                continue
            Y = rng.standard_normal((8, p0, p1)).astype(F32) * np.exp2(
                rng.integers(-8, 8, (8, p0, p1))).astype(F32)
            Y[:4] = rng.uniform(0.5, 1.0, (4, p0, p1)).astype(F32)
            want = np.stack([np.asarray(f(jnp.asarray(y))) for y in Y]).view(np.int32)
            vf = ordered_sum._middle_lanes_vf((p0, p1), square=square)
            T = torch.from_numpy(Y)
            if vf:
                got = ordered_sum._rows_lanes(T, vf, square)
            else:
                flat = T.reshape(8, -1)
                got = (ordered_sum.row_dot(flat, flat, ordered_sum.CHAIN) if square
                       else ordered_sum.row_sum(flat, 1, ordered_sum.CHAIN))
            if not np.array_equal(got.numpy().view(np.int32), want):
                bad.append((p0, p1, vf))
        print("norm", "squares" if square else "partials",
              "(p0, p1) ≤ 32 where the port differs:", bad, flush=True)
    # (2) a window with its last column checked apart: FPRev along leaf 0
    n, f = 63, _jax_sum(False)
    pos = {}
    for r, c in itertools.product(range(32), range(32)):
        if r == c == 0:
            continue
        P = np.ones((n, n), F32)
        P[0, 0], P[r, c] = BIG, -BIG
        pos[r, c] = float(np.asarray(f(jnp.asarray(P))))
    order = [(0, 0)] + sorted(pos, key=lambda k: -pos[k])
    rows_first = [(r, c) for r in range(32) for c in range(31)] + [(r, 31) for r in range(32)]
    print("63² window (0, 0): each row's columns 0-30, then column 31 down the rows:",
          order == rows_first, flush=True)
    # (3) the matvec alone against plan_2d
    bad = []
    for pts, n1, n0 in itertools.product((5, 9), range(1, 13), (1, 3, 4, 8, 16, 17, 20, 40,
                                                               61, 69, 100)):
        offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=2)
                     if pts == 9 or sum(map(abs, o)) <= 1)
        W = rng.uniform(-1, 1, (pts, n0, n1)).astype(F32)
        W[offs.index((0, 0))] = rng.uniform(4, 8, (n0, n1)).astype(F32)
        d = (1 / W[offs.index((0, 0))]).astype(F32)
        x = (rng.random((n0, n1)) - 0.5).astype(F32)
        want = np.asarray(jax.jit(lambda w, d, x: d * JStencil(w, offs, (n0, n1)).matvec(x))(
            W, d, x)).view(np.int32)
        plan = ds.power_plan(Stencil(torch.from_numpy(W), offs, (n0, n1)), torch.from_numpy(d))
        got = ordered_stencil.matvec(plan, [torch.from_numpy(x).reshape(plan.slab)])[0]
        if not np.array_equal(got.numpy().reshape(n0, n1).view(np.int32), want):
            bad.append((n0, n1, pts))
    print("matvec: (n0, n1, points) where plan_2d differs:", bad, flush=True)
    # (4) λ through the JAX package's power iteration
    from parallel_amg_tpu_torch.problems import poisson_stencil

    for dims, pts in [((128, 128), 5), ((243, 243), 5), ((243, 100), 5), ((1000, 40), 5),
                      ((63, 63), 9), ((2048, 40), 9), ((1100, 1100), 5), ((17, 8), 9),
                      ((40, 9), 9), ((69, 5), 5), ((2, 4), 9), ((3, 4), 5), ((1, 11), 9)]:
        equal = []
        for seed in range(2):
            if seed == 0 and pts == 5:
                A = poisson_stencil(dims, device="cpu")
                offs, W = A.offsets, A.weights.numpy()
            else:
                offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=2)
                             if pts == 9 or sum(map(abs, o)) <= 1)
                r = np.random.default_rng(seed)
                W = r.uniform(-1, 1, (pts,) + dims).astype(F32)
                W[offs.index((0, 0))] = r.uniform(4, 8, dims).astype(F32)
            d = (1 / W[offs.index((0, 0))]).astype(F32)
            want = jds_._jit_power(JStencil(jnp.asarray(W), offs, dims), jnp.asarray(d),
                                   iters=15, seed=seed)
            got = ds.power_iteration_lambda_max(Stencil(torch.from_numpy(W), offs, dims),
                                                torch.from_numpy(d), 15, seed=seed)
            equal.append(float(got) == float(want))
        print(dims, pts, "points: λ equal (Poisson or seeded, seeded)", equal, flush=True)


def main():
    ap = argparse.ArgumentParser()
    for name in ("dot", "pool", "rsqrt", "bucketed", "norms", "norms2d"):
        ap.add_argument(f"--{name}", action="store_true")
    ap.add_argument("--bucketed-solve", nargs="*", default=None, metavar="DIMSxPOINTS",
                    help="e.g. 8x7x6x27 (the last number the points)")
    args = ap.parse_args()
    torch.set_num_threads(2)
    if args.bucketed_solve is not None:
        shapes = [(tuple(int(v) for v in a.split("x")[:-1]), int(a.split("x")[-1]))
                  for a in args.bucketed_solve]
        probe_bucketed_solve(shapes or None)
        return
    names = ("dot", "pool", "rsqrt", "bucketed", "norms", "norms2d")
    chosen = [n for n in names if getattr(args, n)] or list(names)
    for name in chosen:
        print(f"== {name}", flush=True)
        globals()[f"probe_{name}"]()


if __name__ == "__main__":
    main()
