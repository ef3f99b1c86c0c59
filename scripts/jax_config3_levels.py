#!/usr/bin/env python3
"""Record the JAX package's config #3 levels on the CPU, so that the port can
be held to them where JAX does not run (the card's machine).

    JAX_PLATFORMS=cpu python3 scripts/jax_config3_levels.py [--n 128]
        [--out artifacts/config3_jax_levels.json]
    python3 scripts/jax_config3_levels.py --port [--device cpu|cuda]

Config #3: 3-D 7-point Poisson n³, block SA with b = 3, Chebyshev,
``n_coarse_max=512``, set up on the device (``device_structured_setup``),
once on one device and once in 4 parts (``sharded_device_setup`` over
``poisson_stencil_sharded`` on a 4-device CPU mesh, run in a subprocess
with ``--xla_force_host_platform_device_count=4``).  For each level it
records the rows, the offsets, the first 16 hex digits of the sha256 of the
float32 weights (D, *dims) and of D⁻¹ (*dims) in C order (a sharded level's
global padded arrays), and λ_max with its float32 bits.  It also records the
jax and jaxlib versions, the CPU model and its core count: the float32
orders are XLA's CPU backend's on that machine.  At 128³ the one-device
setup takes ~37 s on an 8-core x86-64 CPU and the 4-part one ~33 s.

``--port`` imports no JAX: it runs the port's same two setups (on the CPU
unless ``--device cuda``) and holds every level's digests and λ bits
against the record (``parallel_amg_tpu_torch.utils.metrics.level_digests``,
``compare_levels``), one JSON line per setup, exit 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor()


def run_levels(n: int, parts: int):
    import jax
    import numpy as np

    import parallel_amg_tpu as pat
    from parallel_amg_tpu_torch.utils.metrics import array_digest, f32_bits
    from parallel_amg_tpu.amg.device_setup import device_structured_setup
    from parallel_amg_tpu.problems.stencil_problems import poisson_stencil

    kw = dict(coarsening="sa", aggregate="block", block_size=3,
              smoother="chebyshev", n_coarse_max=512, on_device_setup=True)
    t0 = time.time()
    if parts:
        from parallel_amg_tpu.parallel import make_row_mesh
        from parallel_amg_tpu.parallel import pdevice_setup as jpd

        cfg = pat.AMGConfig(**kw)
        mesh = make_row_mesh(parts)
        A, td = jpd.poisson_stencil_sharded((n,) * 3, mesh, cfg)
        h = jpd.sharded_device_setup(A, cfg, true_dims=td)
    else:
        h = device_structured_setup(poisson_stencil((n,) * 3), pat.AMGConfig(**kw))
    jax.block_until_ready(h.coarse_inv)
    secs = time.time() - t0
    levels = []
    for lv in h.levels:
        W = np.asarray(lv.A.weights, np.float32)
        d = np.asarray(lv.d_inv, np.float32)
        lam = np.float32(lv.lam_max)
        levels.append({"rows": int(np.prod(W.shape[1:])), "dims": list(W.shape[1:]),
                       "points": int(W.shape[0]),
                       "offsets": [list(o) for o in lv.A.offsets],
                       "weights_digest": array_digest(W), "d_inv_digest": array_digest(d),
                       "lam_max": float(lam), "lam_max_bits": f32_bits(lam)})
    return {"setup_s": secs, "levels": levels}


def run_port(n: int, device: str):
    """The port's config #3 on one device and in 4 parts on ``device``."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson_stencil
    from parallel_amg_tpu_torch.utils.metrics import level_digests

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    kw = dict(coarsening="sa", aggregate="block", block_size=3,
              smoother="chebyshev", n_coarse_max=512, on_device_setup=True)
    cfg = ptt.AMGConfig(**kw)
    dev = None if device == "cuda" else device
    t0 = time.time()
    h1 = ptt.setup(poisson_stencil((n,) * 3, device=device), cfg, device=dev)
    t1 = time.time()
    mesh = ptt.make_row_mesh(4, device=dev)
    A, td = ptt.poisson_stencil_sharded((n,) * 3, mesh, cfg)
    h4 = ptt.sharded_device_setup(A, cfg, true_dims=td)
    t2 = time.time()
    return {"one_device": (level_digests(h1), t1 - t0),
            "parts4": (level_digests(h4), t2 - t1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--out", default=os.path.join(ROOT, "artifacts",
                                                  "config3_jax_levels.json"))
    ap.add_argument("--parts", type=int, default=None,
                    help="run only this many parts (0: one device) and print JSON")
    ap.add_argument("--port", action="store_true",
                    help="run the port's setups and hold them against --out")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    if args.port:
        from parallel_amg_tpu_torch.utils.metrics import compare_levels

        with open(args.out) as f:
            rec = json.load(f)
        ok = True
        for key, (levels, secs) in run_port(rec["n"], args.device).items():
            rows, same = compare_levels(rec[key]["levels"], levels)
            ok &= same
            print(json.dumps({"setup": key, "device": args.device, "seconds": secs,
                              "equal_to_jax": same, "levels": rows,
                              "port": [(lv["weights_digest"], lv["d_inv_digest"],
                                        lv["lam_max"]) for lv in levels]}))
        sys.exit(0 if ok else 1)
    if args.parts is not None:
        print(json.dumps(run_levels(args.n, args.parts)))
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    runs = {}
    for key, parts in (("one_device", 0), ("parts4", 4)):
        e = dict(env)
        if parts:
            e["XLA_FLAGS"] = (e.get("XLA_FLAGS", "") + " --xla_force_host_platform_"
                              f"device_count={parts}").strip()
        cmd = [sys.executable, os.path.abspath(__file__), "--n", str(args.n),
               "--parts", str(parts)]
        out = subprocess.run(cmd, env=e, check=True, capture_output=True, text=True)
        runs[key] = json.loads(out.stdout.strip().splitlines()[-1])
        print(key, json.dumps(runs[key]["levels"]), file=sys.stderr)
    import jax
    import jaxlib

    rec = {"config": "3-D 7-point Poisson n^3, SA block b=3, chebyshev, "
                     "n_coarse_max=512, on_device_setup=True",
           "n": args.n, "digest": "sha256 of the float32 array in C order, first 16 "
                                  "hex digits",
           "jax": jax.__version__, "jaxlib": jaxlib.__version__,
           "cpu": cpu_model(), "cores": os.cpu_count(), **runs}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({k: [(lv["weights_digest"], lv["lam_max"]) for lv in v["levels"]]
                      for k, v in runs.items()}))


if __name__ == "__main__":
    main()
