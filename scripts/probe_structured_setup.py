"""Time the port's structured setups on the card for this checkout and others,
in turns, and say where a setup's device time goes.

Each (tree, cell) runs in a child process that imports the port from that
tree only (no JAX), builds its CUDA libraries first, sets the cell up once
cold (the process's first setup, as in chip_smoke.py) and once more warm
with the peak memory reset, and prints one JSON line: both setups' seconds
(wall, synchronised), the warm one's peak device GB, level rows.  The cells are chip_smoke.py's:

- setup3d: config #3, poisson_stencil((128,)*3), one device;
- setup_vec: config #5, coupled_laplacian((128,)*3, 3, 0.3), "bsr";
- setup_vec_100m: the same at 324³×3 (the slab path);
- setup_dist3d: config #3 in 4 parts ("pallas_async"), one card;
- setup_dist_100m: 468³ in 8 parts, one card.

Run from the repository root on a machine with a card:

    python3 scripts/probe_structured_setup.py --tree parent=DIR \\
        [--rounds 2] [--cells setup3d,setup_vec] [--profile] [--stages]

Rounds run every tree in turn (change, parent, parent, change, ...).
``--profile`` adds, per tree, the setup3d cell's ten largest device
operations under torch.profiler.  ``--stages`` adds the warm setup's seconds
in each of ``STAGES`` (synchronised before and after each call, summed over
calls; a stage inside another counts in both: ``start_vector``, the power
iterations' host draws, inside both power iterations), where the tree has
it.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

CELLS = ("setup3d", "setup_vec", "setup_vec_100m", "setup_dist3d",
         "setup_dist_100m")
LIBRARIES = ("twell_spmv", "flatdia_spmv", "spgemm", "bsr_spmv",
             "flatdia_spmm", "halo_stencil", "ordered_sum")


# (module under parallel_amg_tpu_torch, function) timed by --stages
STAGES = (("amg.device_setup", "power_iteration_lambda_max"),
          ("amg.device_setup", "start_vector"),
          ("amg.device_setup", "coarse_operator"),
          ("amg.device_setup", "galerkin_block"),
          ("amg.device_setup", "_onehot_dot"),
          ("amg.device_setup", "_slab_coarse_operator"),
          ("parallel.pdevice_setup", "_sharded_power"),
          ("parallel.pdevice_setup", "sharded_coarse_operator"),
          ("parallel.pdevice_setup", "_sharded_sparsify_sym"))


def _time_stages(totals: dict) -> None:
    """Wrap each of ``STAGES`` that the imported tree has in a synchronised
    timer adding its seconds to ``totals``."""
    import importlib

    import torch

    for mod_name, name in STAGES:
        mod = importlib.import_module(f"parallel_amg_tpu_torch.{mod_name}")
        fn = getattr(mod, name, None)
        if fn is None:
            continue

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = _fn(*a, **k)
            torch.cuda.synchronize()
            totals[_name] = totals.get(_name, 0.0) + time.perf_counter() - t
            return r
        setattr(mod, name, timed)


def _child(tree: str, cell: str, profile: bool, stages: bool = False) -> None:
    sys.path.insert(0, tree)
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.ops import _build
    from parallel_amg_tpu_torch.problems import poisson_stencil
    from parallel_amg_tpu_torch.problems.elasticity import coupled_laplacian, coupling_matrix

    if not ptt.__file__.startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {ptt.__file__}, not the tree {tree}")
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as ex:
        list(ex.map(_build.build, LIBRARIES))
    cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                        smoother="chebyshev", n_coarse_max=512,
                        on_device_setup=True)
    cfg_async = dataclasses.replace(cfg, halo_mode="pallas_async")

    def run(name, n):
        if name == "setup3d":
            h = ptt.setup(poisson_stencil((n,) * 3), cfg)
        elif name in ("setup_vec", "setup_vec_100m"):
            L, _ = coupled_laplacian((n,) * 3, 3, 0.3)
            h = ptt.setup_vector_kron(L, coupling_matrix(3, 0.3), cfg,
                                      fine_format="bsr")
        else:
            mesh = ptt.make_row_mesh(4 if name == "setup_dist3d" else 8)
            A, td = ptt.poisson_stencil_sharded((n,) * 3, mesh, cfg_async)
            h = ptt.sharded_device_setup(A, cfg_async, true_dims=td)
        torch.cuda.synchronize()
        return h

    n = {"setup3d": 128, "setup_vec": 128, "setup_vec_100m": 324,
         "setup_dist3d": 128, "setup_dist_100m": 468}[cell]
    t0 = time.perf_counter()
    first = run(cell, n)  # cold: the process's first setup, as in chip_smoke.py
    cold = time.perf_counter() - t0
    del first
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = run(cell, n)
    secs = time.perf_counter() - t0
    out = {"tree": tree, "cell": cell, "seconds": secs, "cold_seconds": cold,
           "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
           "rows": [l.n for l in h.levels]}
    del h
    if stages:
        totals: dict = {}
        _time_stages(totals)
        t0 = time.perf_counter()
        run(cell, n)
        out["staged_seconds"] = time.perf_counter() - t0
        out["stage_seconds"] = totals
    if profile:
        from torch.profiler import ProfilerActivity, profile as tprofile

        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(cell, n)
        rows = sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:10]
        out["top_device_ops"] = [
            {"name": e.key[:80], "count": e.count,
             "device_ms": e.device_time_total / 1e3} for e in rows]
        host = sorted(prof.key_averages(), key=lambda e: -e.cpu_time_total)[:10]
        out["top_host_ops"] = [
            {"name": e.key[:80], "count": e.count,
             "host_ms": e.cpu_time_total / 1e3} for e in host]
    print(json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of another checkout (repeatable)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--child", nargs=2, metavar=("TREE", "CELL"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        _child(args.child[0], args.child[1], args.profile, args.stages)
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = [("change", here)] + [tuple(t.split("=", 1)) for t in args.tree]
    cells = [c for c in args.cells.split(",") if c]
    for r in range(args.rounds):
        order = trees if r % 2 == 0 else list(reversed(trees))
        for cell in cells:
            for name, tree in order:
                cmd = [sys.executable, os.path.abspath(__file__), "--child",
                       os.path.abspath(tree), cell]
                if args.profile and r == 0 and cell == "setup3d":
                    cmd.append("--profile")
                if args.stages:
                    cmd.append("--stages")
                p = subprocess.run(cmd, capture_output=True, text=True)
                line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
                if p.returncode != 0 or not line:
                    print(json.dumps({"tree": name, "cell": cell, "round": r,
                                      "error": p.stderr[-2000:]}), flush=True)
                    continue
                rec = json.loads(line)
                rec.update(tree=name, round=r)
                print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
