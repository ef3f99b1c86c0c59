#!/usr/bin/env python3
"""Record the JAX package's 2-D Poisson levels on the CPU, so that the port
can be held to them where JAX does not run (the card's machine).

    JAX_PLATFORMS=cpu python3 scripts/jax_poisson2d_levels.py [--n 1024]
        [--out artifacts/poisson2d_jax_levels.json]
    python3 scripts/jax_poisson2d_levels.py --port [--device cpu|cuda]

The setup: 2-D 5-point Poisson n², block SA with b = 3, Chebyshev,
``n_coarse_max=64``, set up on the device (``device_structured_setup``): at
1024² the levels 1024², 342², 114², 38², 13², 5², whose coarse operators
have 9 points.  For each level it records the rows, the offsets, the first
16 hex digits of the sha256 of the float32 weights (D, *dims) and of D⁻¹
(*dims) in C order, and λ_max with its float32 bits (as
``scripts/jax_config3_levels.py``); then the PCG iterations to a relative
residual of 1e-6 from x = 0 for b = ``np.random.default_rng(0).normal`` in
float32 (``pat.amg_pcg``), and the jax and jaxlib versions, the CPU model
and its core count: the float32 orders are XLA's CPU backend's on that
machine.  At 1024² the setup takes ~17 s on an 8-core x86-64 CPU and the
PCG ~5 s.

``--port`` imports no JAX: it runs the port's same setup and PCG (on the
CPU unless ``--device cuda``), holds every level's digests and λ bits
against the record (``parallel_amg_tpu_torch.utils.metrics.level_digests``,
``compare_levels``) and the PCG count against the recorded one, and prints
one JSON line; exit 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "artifacts", "poisson2d_jax_levels.json")
TOL = 1e-6
KW = dict(coarsening="sa", aggregate="block", block_size=3, smoother="chebyshev",
          n_coarse_max=64, on_device_setup=True)


def rhs(n: int):
    import numpy as np

    return np.random.default_rng(0).normal(size=n * n).astype(np.float32)


def run_jax(n: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import parallel_amg_tpu as pat
    from parallel_amg_tpu.amg.device_setup import device_structured_setup
    from parallel_amg_tpu.problems.stencil_problems import poisson_stencil
    from parallel_amg_tpu_torch.utils.metrics import array_digest, f32_bits

    t0 = time.time()
    h = device_structured_setup(poisson_stencil((n, n)), pat.AMGConfig(**KW))
    jax.block_until_ready(h.coarse_inv)
    setup_s = time.time() - t0
    levels = []
    for lv in h.levels:
        W = np.asarray(lv.A.weights, np.float32)
        lam = np.float32(lv.lam_max)
        levels.append({"rows": int(np.prod(W.shape[1:])), "dims": list(W.shape[1:]),
                       "points": int(W.shape[0]),
                       "offsets": [list(o) for o in lv.A.offsets],
                       "weights_digest": array_digest(W),
                       "d_inv_digest": array_digest(np.asarray(lv.d_inv, np.float32)),
                       "lam_max": float(lam), "lam_max_bits": f32_bits(lam)})
    t1 = time.time()
    res = pat.amg_pcg(h.levels[0].A, h, jnp.asarray(rhs(n).reshape(n, n)), tol=TOL)
    return {"setup_s": setup_s, "levels": levels, "pcg_iterations": int(res.iters),
            "pcg_s": time.time() - t1}


def run_port(n: int, device: str) -> dict:
    """The port's setup of the record's problem on ``device``, its levels
    and its PCG count, the true relative residual taken in float64."""
    import numpy as np
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson_stencil
    from parallel_amg_tpu_torch.utils.metrics import level_digests

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    dev = None if device == "cuda" else device
    A = poisson_stencil((n, n), device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    h = ptt.setup(A, ptt.AMGConfig(**KW), device=dev)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.time() - t0
    b = torch.from_numpy(rhs(n).reshape(n, n)).to(A.weights.device)
    res = ptt.amg_pcg(A, h, b, tol=TOL)
    r = b.double() - A._matmat_plain(res.x.double()[..., None])[..., 0]
    return {"setup_s": setup_s, "levels": level_digests(h),
            "pcg_iterations": int(res.iters),
            "true_residual": float(r.norm() / b.double().norm())}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--port", action="store_true",
                    help="run the port's setup and hold it against --out (no JAX)")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    args = ap.parse_args()
    if args.port:
        from parallel_amg_tpu_torch.utils.metrics import compare_levels

        with open(args.out) as f:
            rec = json.load(f)
        got = run_port(rec["n"], args.device)
        rows, same = compare_levels(rec["levels"], got["levels"])
        pcg_same = got["pcg_iterations"] == rec["pcg_iterations"]
        print(json.dumps({"setup": f"poisson2d {rec['n']}^2", "device": args.device,
                          "setup_s": got["setup_s"], "equal_to_jax": same, "levels": rows,
                          "pcg_iterations": got["pcg_iterations"],
                          "jax_pcg_iterations": rec["pcg_iterations"],
                          "true_residual": got["true_residual"]}))
        sys.exit(0 if same and pcg_same else 1)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jaxlib

    from scripts.jax_config3_levels import cpu_model

    run = run_jax(args.n)
    rec = {"config": "2-D 5-point Poisson n^2, SA block b=3, chebyshev, n_coarse_max=64, "
                     "on_device_setup=True",
           "n": args.n, "digest": "sha256 of the float32 array in C order, first 16 hex "
                                  "digits",
           "pcg": f"amg_pcg to {TOL} from x = 0, b = np.random.default_rng(0).normal "
                  "(n*n) in float32",
           "jax": jax.__version__, "jaxlib": jaxlib.__version__,
           "cpu": cpu_model(), "cores": os.cpu_count(), **run}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")
    print(json.dumps({"levels": [(lv["dims"], lv["weights_digest"], lv["lam_max"])
                                 for lv in run["levels"]],
                      "pcg_iterations": run["pcg_iterations"], "setup_s": run["setup_s"]}))


if __name__ == "__main__":
    main()
