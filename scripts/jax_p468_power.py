#!/usr/bin/env python3
"""Record the JAX package's power iterations at the two split levels of 468³
in 8 parts on the CPU, so that the port can be held to them where JAX does
not run (the card's machine).

    JAX_PLATFORMS=cpu python3 scripts/jax_p468_power.py [--out artifacts/p468_jax_power.json]
    python3 scripts/jax_p468_power.py --port [--device cpu|cuda] [--level 0|1]
    JAX_PLATFORMS=cpu python3 scripts/jax_p468_power.py --interior 16x468x8 [...] [--points 7]

The 8-part setup of 468³ (``sharded_device_setup`` over
``poisson_stencil_sharded``, config #3's ``AMGConfig``) splits two levels,
504 × 468 × 468 (7 points, parts of 63 planes) and 168 × 156 × 156 (27
points, parts of 21); the whole setup does not fit a CPU run (about 4 KB a
point), its power iterations do.  Each level runs in its own process with 8
virtual CPU devices:

- level 0: the JAX package's λ_max(D⁻¹A) of
  ``poisson_stencil_sharded((468,)*3, make_row_mesh(8), cfg)``:
  ``_jit_dinv``, then ``_jit_power(iters=cfg.lambda_power_iters, seed=0)``,
  as its setup takes it (~7 s and ~5.5 GB on an 8-core x86-64 CPU);
- level 1: the same on a seeded 27-point operator of level 1's shape in 8
  parts (``problems.seeded_stencil((168, 156, 156), 27, LEVEL1_SEED)``, the
  weights' digest recorded), whose Galerkin weights would need the whole
  setup.  At LEVEL1_SEED the last iteration's λ differs under each
  candidate order of the norm's window partials ((1, 5, 5) a part; lanes
  instead of one chain, ``tests/p468_orders.py``).  At this size no seed of
  0–15 moves λ under the 8-part all-reduce's candidates (right to left, a
  tree), and only seed 1 moves it under the matvec's plain offset order;
  the tier-1 cases at smaller grids decide those orders.

The record holds λ and its float32 bits per level, the seconds and peak
resident memory of each run, the jax and jaxlib versions, the CPU model and
its core count (the orders are XLA's CPU backend's on that machine).

``--port`` imports no JAX: the port's ``pdevice_setup._sharded_power`` on
the same operators (on the CPU unless ``--device cuda``; the CPU run of
level 0 takes ~11 minutes and ~10 GB), held to the record's bits (and level
1's weights to its digest), one JSON line a level with its seconds, peak
memory and, at level 1 on the CPU, the candidate orders' λ bits; exit 1 on
a mismatch.  ``--interior`` reads the power iteration's matvec order at
the given grids in 8 parts (``--parts``; 1: one device): the JAX package's
power-iteration body (its
iterate after two iterations) against the port's plain matvec with the
centre fused (one fma chain) and unfused (its product rounded and added),
one JSON line a grid: "fused", "unfused", or the rows i1 of a part taken
each way (where a point's two orders give the same float, neither decides
it), beside the port's row bound (``ordered_stencil.unfused_centre``, the
plan its power iteration builds) and whether its matvec gives the JAX
package's bits.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from jax_config3_levels import cpu_model  # noqa: E402

PARTS = 8
N = 468
LEVEL1_DIMS = (168, 156, 156)
LEVEL1_SEED = 3
RECORD = os.path.join(ROOT, "artifacts", "p468_jax_power.json")


def _cfg(mod):
    """Config #3's AMGConfig in ``mod`` (the JAX package or the port)."""
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=512, on_device_setup=True)


def _peak_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def jax_level(level: int, seed: int) -> dict:
    """The JAX package's λ at one level, in this process (8 CPU devices)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    import parallel_amg_tpu as pat
    from parallel_amg_tpu.amg.device_setup import _jit_dinv, _jit_power
    from parallel_amg_tpu.parallel import make_row_mesh
    from parallel_amg_tpu.parallel import pdevice_setup as jpd
    from parallel_amg_tpu.parallel.mesh import ROW_AXIS
    from parallel_amg_tpu.parallel.pstencil import ShardedStencil
    from parallel_amg_tpu_torch.problems import seeded_stencil
    from parallel_amg_tpu_torch.utils.metrics import array_digest, f32_bits

    cfg = _cfg(pat)
    mesh = make_row_mesh(PARTS)
    t0 = time.time()
    out = {}
    if level == 0:
        A, _ = jpd.poisson_stencil_sharded((N,) * 3, mesh, cfg)
        out.update(grid=[N] * 3, points=7,
                   operator=f"poisson_stencil_sharded(({N},)*3, make_row_mesh({PARTS}), "
                            "config #3)")
    else:
        w, offs = seeded_stencil(LEVEL1_DIMS, 27, seed)
        A = ShardedStencil(jax.device_put(jnp.asarray(w), NamedSharding(mesh, P(None, ROW_AXIS))),
                           offs, LEVEL1_DIMS, mesh)
        out.update(points=27, weights_seed=seed, weights_digest=array_digest(w),
                   operator=f"problems.seeded_stencil({LEVEL1_DIMS}, 27, {seed})")
        del w
    lam = np.float32(_jit_power(A, _jit_dinv(A), iters=cfg.lambda_power_iters, seed=0))
    out.update(padded_dims=list(A.dims), lam_max=float(lam), lam_max_bits=f32_bits(lam),
               seconds=time.time() - t0, peak_rss_gb=_peak_gb())
    return out


def record(out_path: str, seed: int) -> None:
    import jax
    import jaxlib

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count="
                        f"{PARTS}").strip()
    rec = {"what": "the JAX package's sharded power iteration (_jit_power, 15 iterations, "
                   "seed 0) at the split levels of 468^3 in 8 parts, config #3",
           "parts": PARTS, "iters": 15, "power_seed": 0,
           "jax": jax.__version__, "jaxlib": jaxlib.__version__,
           "cpu": cpu_model(), "cores": os.cpu_count()}
    for level in (0, 1):
        cmd = [sys.executable, os.path.abspath(__file__), "--jax-level", str(level),
               "--seed", str(seed)]
        run = subprocess.run(cmd, env=env, check=True, capture_output=True, text=True)
        rec[f"level{level}"] = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"level{level}", json.dumps(rec[f"level{level}"]), file=sys.stderr)
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


def port_operator(level: int, device: str, rec: dict):
    """The port's ShardedStencil of one level on ``device``, and whether its
    weights are the record's (level 1's digest; True at level 0)."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
    from parallel_amg_tpu_torch.problems import seeded_stencil
    from parallel_amg_tpu_torch.utils.metrics import array_digest

    mesh = ptt.make_row_mesh(PARTS, device=None if device == "cuda" else device)
    if level == 0:
        return ptt.poisson_stencil_sharded((N,) * 3, mesh, _cfg(ptt))[0], True
    lv = rec["level1"]
    w, offs = seeded_stencil(lv["padded_dims"], lv["points"], lv["weights_seed"])
    same = array_digest(w) == lv["weights_digest"]
    A = ShardedStencil.from_global(torch.from_numpy(w), offs, lv["padded_dims"], mesh)
    return A, same


def port_level(level: int, device: str, rec: dict, candidates: bool) -> dict:
    """The port's λ at one level against the record."""
    import torch

    from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
    from parallel_amg_tpu_torch.utils.metrics import f32_bits

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    t0 = time.time()
    A, weights_equal = port_operator(level, device, rec)
    want = rec[f"level{level}"]["lam_max_bits"]
    out = {"level": level, "device": device, "dims": list(A.dims), "weights_equal": weights_equal}
    if candidates:
        from p468_orders import candidate_lams, run_port_power

        lam, seen, d_inv = run_port_power(A, rec["iters"], rec["power_seed"])
        want_int = int(want, 16) - (1 << 32 if int(want, 16) >> 31 else 0)
        out["candidates_equal_to_record"] = {
            k: v == want_int for k, v in candidate_lams(A, seen, d_inv).items()}
    else:
        lam = pd._sharded_power(A, pd._sharded_dinv(A), rec["iters"], rec["power_seed"])
    if device == "cuda":
        torch.cuda.synchronize()
    got = f32_bits(float(lam))
    out.update(lam_max=float(lam), lam_max_bits=got, record_bits=want,
               equal_to_jax=got == want and weights_equal, seconds=time.time() - t0,
               peak_rss_gb=_peak_gb())
    return out


def _ranges(values) -> str:
    """Sorted distinct integers as "a-b, c, ..." runs."""
    runs, out = [], sorted(set(int(v) for v in values))
    for v in out:
        if runs and v == runs[-1][1] + 1:
            runs[-1][1] = v
        else:
            runs.append([v, v])
    return ", ".join(f"{a}" if a == b else f"{a}-{b}" for a, b in runs)


def interior(grids, points: int, seed: int, parts: int) -> None:
    """The power iteration's matvec order at each grid, in ``parts`` parts
    (1: one device) (module docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch
    from jax.sharding import NamedSharding, PartitionSpec as P

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu.amg import device_setup as jds
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil
    from parallel_amg_tpu.parallel import make_row_mesh
    from parallel_amg_tpu.parallel.mesh import ROW_AXIS
    from parallel_amg_tpu.parallel.pstencil import ShardedStencil as JShardedStencil
    from parallel_amg_tpu_torch.amg import device_setup as ds
    from parallel_amg_tpu_torch.ops import ordered_stencil
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid
    from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
    from parallel_amg_tpu_torch.problems import seeded_stencil

    torch.set_num_threads(min(8, os.cpu_count() or 1))

    def body_twice(A, d, x0):
        """The body of the JAX package's power iteration, two trips; the
        iterate the second matvec took and its D⁻¹A·x."""
        def body(i, c):
            x, _, _, lam = c
            y = d * A.matvec(x)
            nrm = jnp.linalg.norm(y)
            return y / jnp.maximum(nrm, 1e-30), x, y, jnp.where(nrm > 0, nrm, lam)

        return jax.lax.fori_loop(0, 2, body, (x0, x0, x0, jnp.asarray(1.0, x0.dtype)))

    run = jax.jit(body_twice)
    if parts > 1:
        jmesh, mesh = make_row_mesh(parts), ptt.make_row_mesh(parts, device="cpu")
    for grid in grids:
        dims = tuple(int(a) for a in grid.split("x"))
        w, offs = seeded_stencil(dims, points, seed)
        x0 = jax.random.uniform(jax.random.PRNGKey(0), dims, jnp.float32) - 0.5
        if parts > 1:
            jA = JShardedStencil(jax.device_put(jnp.asarray(w), NamedSharding(
                jmesh, P(None, ROW_AXIS))), offs, dims, jmesh)
            x0 = jax.device_put(x0, NamedSharding(jmesh, P(ROW_AXIS)))
            A = ShardedStencil.from_global(torch.from_numpy(w), offs, dims, mesh)
        else:
            jA, A = JStencil(jnp.asarray(w), offs, dims), Stencil(torch.from_numpy(w), offs, dims)
        _, x1, y2, _ = run(jA, jds._jit_dinv(jA), x0)
        want = np.asarray(y2).view(np.int32)
        K = len(offs)
        centre = ordered_stencil.chain_order(K).index(offs.index((0, 0, 0)))
        d_inv = pd._sharded_dinv(A).parts if parts > 1 else [ds.diag_inverse(A)]
        weights = A.weights if parts > 1 else [A.weights]
        port = pd.power_plan(A, pd._sharded_dinv(A)) if parts > 1 else ds.power_plan(
            A, d_inv[0])
        match = {}
        for name, plan in (("fused", ordered_stencil.Plan(weights, d_inv, offs, parts > 1)),
                           ("unfused", ordered_stencil.Plan(weights, d_inv, offs, parts > 1,
                                                            split=centre)),
                           ("port", port)):
            if parts > 1:
                x = PGrid.from_global(torch.from_numpy(np.array(x1)), mesh)
                got = PGrid(ordered_stencil.matvec_plain(plan, x.parts, pd._halos(
                    x.parts, A.halo, 0)), mesh).to_global()
            else:
                got = ordered_stencil.matvec_plain(plan, [torch.from_numpy(np.array(x1))],
                                                   [(None, None)])[0]
            match[name] = got.numpy().view(np.int32) == want
        F, U = match["fused"], match["unfused"]
        if F.all() or U.all():
            order = "fused" if F.all() else "unfused"
        elif not (F | U).all():
            order = f"neither at {int((~(F | U)).sum())} points"
        else:
            order = {"unfused_rows_i1": _ranges(np.argwhere(U & ~F)[:, 1]),
                     "fused_rows_i1": _ranges(np.argwhere(F & ~U)[:, 1])}
        print(json.dumps({"grid": list(dims), "parts": parts,
                          "part": [dims[0] // parts] + list(dims[1:]), "points": points,
                          "seed": seed, "interior": order, "port_rows": port.rows or 0,
                          "port_equal": bool(match["port"].all())}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=RECORD)
    ap.add_argument("--seed", type=int, default=LEVEL1_SEED,
                    help="level 1's weights seed (--interior: the grids' seed)")
    ap.add_argument("--port", action="store_true",
                    help="run the port's power iterations and hold them against --out")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--level", type=int, choices=(0, 1), default=None)
    ap.add_argument("--candidates", action="store_true",
                    help="with --port on the CPU: the candidate orders' λ too")
    ap.add_argument("--interior", nargs="+", default=None, metavar="D0xD1xD2")
    ap.add_argument("--points", type=int, default=7, choices=(7, 27))
    ap.add_argument("--parts", type=int, default=PARTS, help="--interior: parts (1: one device)")
    ap.add_argument("--jax-level", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.jax_level is not None:
        print(json.dumps(jax_level(args.jax_level, args.seed)))
    elif args.interior:
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_"
                                   f"platform_device_count={max(args.parts, 1)}").strip()
        interior(args.interior, args.points, args.seed, args.parts)
    elif args.port:
        with open(args.out) as f:
            rec = json.load(f)
        ok = True
        for level in (0, 1) if args.level is None else (args.level,):
            line = port_level(level, args.device, rec, args.candidates)
            ok &= line["equal_to_jax"]
            print(json.dumps(line), flush=True)
        sys.exit(0 if ok else 1)
    else:
        record(args.out, args.seed)


if __name__ == "__main__":
    main()
