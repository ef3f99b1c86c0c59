#!/usr/bin/env python3
"""Config #2's Ruge–Stüben setups on one CUDA card, timed and counted, for
this checkout or another one in turns.

    python3 scripts/probe_rs_setup.py [--tree NAME=PATH ...] [--runs 2]

Acceptance config #2 (2D Poisson 1024², Ruge–Stüben PMIS + extended+i,
Chebyshev, n_coarse_max=256, on the device) through its entry points: in 8
parts on the card (``distributed_setup`` of a ``PCSR``) and on one device
(``setup``).  Per setup: host wall seconds (ending in a synchronize), the
level rows and complexities, then one more run under torch.profiler with its
device operations, device ms and the device ms of the ordered row sum's
kernels.

The package is this checkout's (variant "change"); each ``--tree NAME=PATH``
adds the package of another checkout (for example ``parent=`` a
``git archive`` of an earlier commit), run in a process of its own with that
tree first on the path, so that its own kernels are built and loaded.  The
variants run in turns, in order and then reversed ("parent, change, change,
parent" with one other tree).  Prints one JSON line per run, then the card's
name and power limit.  Needs a card and nvcc.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_one(runs: int):
    """This process's package: the two setups, ``runs`` timed runs each,
    then one profiled run."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson2d

    sys.path.insert(0, str(ROOT))
    from chip_smoke import profile_run

    A = poisson2d(1024).to_csr()
    cfg = ptt.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                        interpolation="extended_i", on_device_setup=True)
    mesh = ptt.make_row_mesh(8)
    Ap = ptt.PCSR.from_csr(A, mesh)
    setups = {"parts8": lambda: ptt.distributed_setup(Ap, cfg, mesh),
              "one_device": lambda: ptt.setup(A, cfg)}
    out = {"package": os.path.dirname(ptt.__file__)}
    for name, fn in setups.items():
        fn()  # builds the kernels the setup launches
        secs = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        h, prof = profile_run(fn)
        rows = [getattr(l, "n", None) or l.A.n_rows for l in h.levels]
        out[name] = {"seconds": secs, "rows": rows, "complexity": h.complexity(),
                     "device_operations": prof["device_kernels"],
                     "device_ms": prof["device_ms"],
                     "wall_ms_profiled": prof["wall_ms_profiled"],
                     "ordered_sum_device_ms": sum(
                         v for k, v in prof["port_kernel_device_ms"].items()
                         if k.startswith("ordered_sum"))}
        del h
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--inner", action="store_true")
    args = ap.parse_args()
    if args.inner:
        return run_one(args.runs)
    trees = [("change", ROOT)] + [(n, Path(p).resolve()) for n, p in
                                  (t.split("=", 1) for t in args.tree)]
    order = trees[::-1] + trees if len(trees) > 1 else trees
    for name, tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--inner", "--runs", str(args.runs)], env=env,
                              cwd=tree, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: {proc.stderr[-3000:]}")
        line = next(l for l in proc.stdout.splitlines() if l.startswith("RESULT "))
        print(json.dumps({"variant": name, **json.loads(line[7:])}), flush=True)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi

    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
