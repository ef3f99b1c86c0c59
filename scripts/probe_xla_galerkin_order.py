"""Read the float32 orders of the JAX package's structured Galerkin setup off
XLA's CPU backend, the ones ``parallel_amg_tpu_torch/amg/device_setup.py``
and ``ops/ordered_sum.py`` reproduce, and check the port against them.

A sum's order is revealed through the JAX function itself: with every term 1
except a pair at +2⁴⁰ and −2⁴⁰, the result counts the terms outside the
smallest subtree that holds the pair, so all pairs give the whole tree
("FPRev").  Run on the CPU (JAX_PLATFORMS=cpu), a few minutes:

    python3 scripts/probe_xla_galerkin_order.py [--dot] [--pool] [--rsqrt]
        [--bucketed] [--norms]

- ``--dot``: the one-hot dot of ``galerkin_block`` (onehot (n_out, K) @
  piece (K, nc)): for each shape, the share of outputs that one chain over
  k, or the four-lane order of ``device_setup._dot_lanes``, reproduces.
- ``--pool``: the tree of the padded ``reduce_window`` of the bucketed
  product for every padding of a 3-D block of 3 (``device_setup._window_sum``).
- ``--rsqrt``: XLA's 1/√c for c = 1 … 64 against ``device_setup.block_scale``.
- ``--bucketed``: the port's bucketed product against the JAX package's, bits
  differing per shape (``device_setup._bucket_stage``).
- ``--norms``: the setups' λ_max(D⁻¹A), port against the JAX package's
  ``_jit_power``, per grid (``ordered_sum._middle_lanes_vf``,
  ``device_setup._unfused_centre``).
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


def _chain(V):
    acc = np.zeros(V.shape[1:], F32)
    for k in range(V.shape[0]):
        acc = (acc + V[k]).astype(F32)
    return acc


def _lanes4(V):
    K = V.shape[0]
    main = K // 4 * 4
    L = [_chain(V[q:main:4]) for q in range(4)]
    out = ((L[0] + L[1]).astype(F32) + (L[2] + L[3]).astype(F32)).astype(F32)
    return (out + _chain(V[main:])).astype(F32) if main < K else out


def probe_dot():
    dot = jax.jit(lambda a, b: a @ b)
    rng = np.random.default_rng(1)
    print("n_out K nc: share of outputs in one chain / in four lanes")
    for n_out in (9, 27):
        for K in (25, 49, 93, 125, 343):
            row = []
            for nc in (4, 12, 16, 17, 64, 125, 1000, 3375):
                oh = np.ones((n_out, K), F32)
                T = (rng.standard_normal((K, nc))
                     * np.exp2(rng.integers(-8, 8, (K, nc)))).astype(F32)
                got = np.asarray(dot(oh, T))
                V = np.broadcast_to(T[:, None, :], (K, n_out, nc))
                row.append(f"{nc}:{(got == _chain(V)).mean():.2f}/"
                           f"{(got == _lanes4(V)).mean():.2f}")
            print(n_out, K, " ".join(row), flush=True)


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
                      ((13, 12, 11), 7), ((8, 7, 6), 27), ((11, 10), 5)]:
        nd = len(dims)
        rng = np.random.default_rng(3)
        offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=nd)
                     if pts == 3 ** nd or sum(map(abs, o)) <= 1)
        W = rng.standard_normal((len(offs),) + dims).astype(F32)
        d = rng.standard_normal(dims).astype(F32)
        coef = F32(0.37)
        cdims = tuple(-(-x // b) for x in dims)
        sc = (rng.random(cdims) + 0.5).astype(F32)
        j = np.asarray(jds._jit_bucketed(JStencil(jnp.asarray(W), offs, dims),
                                         jnp.asarray(d), jnp.asarray(coef), cdims, b,
                                         jnp.asarray(sc)).weights)
        t = ds.bucketed_coarse_operator(Stencil(torch.from_numpy(W), offs, dims),
                                        torch.from_numpy(d), torch.tensor(coef), cdims,
                                        b, torch.from_numpy(sc)).weights.numpy()
        print(dims, pts, "points: floats differing",
              int((t.view(np.int32) != j.view(np.int32)).sum()), "of", t.size,
              flush=True)


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


def main():
    ap = argparse.ArgumentParser()
    for name in ("dot", "pool", "rsqrt", "bucketed", "norms"):
        ap.add_argument(f"--{name}", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    chosen = [n for n in ("dot", "pool", "rsqrt", "bucketed", "norms")
              if getattr(args, n)] or ["dot", "pool", "rsqrt", "bucketed", "norms"]
    for name in chosen:
        print(f"== {name}", flush=True)
        globals()[f"probe_{name}"]()


if __name__ == "__main__":
    main()
