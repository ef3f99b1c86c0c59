#!/usr/bin/env python3
"""Record the JAX package's bucketed Galerkin product (``_jit_bucketed``) on
the CPU at grids whose compile is too slow for the tier-1 tests or that the
card's machine (no JAX) holds, so that the port can be held to them.

    JAX_PLATFORMS=cpu python3 scripts/jax_bucketed_record.py [--out artifacts/bucketed_jax_record.json]
    python3 scripts/jax_bucketed_record.py --port [--device cpu|cuda] [--case NAME ...]

The cases (``CASES``):

- ``probe_*``: the seeding of ``scripts/probe_xla_galerkin_order.py
  --bucketed`` (``np.random.default_rng(3)``: standard-normal weights and
  D⁻¹, coef 0.37, b = 3, the scale uniform in [0.5, 1.5)) at 8 × 7 × 6 and
  16³ with 27 points and 32³ with 7, whose orders depart from the stage
  order (``ops/bucket_stage.py``'s ``_DEPARTURES``);
- ``p468_tail_52^3_27pt``: the 27-point 52³ level that the 468³ setup in 8
  parts gathers onto one device, as ``chip_smoke.py`` seeds it
  (``problems.seeded_stencil((52,)*3, 27, 3)``, D⁻¹ the centre's inverse,
  coef 0.55, the block scale of 52³ at b = 3).

Each JAX run takes 5–35 s to compile on an 8-core x86-64 CPU.  The record
holds per case the sha256 of the coarse weights' float32 bits, their shape,
a sample of them (the first 8 and 8 seeded positions, as hex bits), the
seconds, and the jax and jaxlib versions and the CPU model (the order is
XLA's CPU backend's on that machine).

``--port`` imports no JAX: the port's ``bucketed_coarse_operator`` on the
same inputs (on the CPU unless ``--device cuda``), one JSON line a case with
its seconds and whether its bits are the record's; exit 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT]

import numpy as np  # noqa: E402

RECORD = os.path.join(ROOT, "artifacts", "bucketed_jax_record.json")
B = 3
CASES = {
    "probe_8x7x6_27pt": ("probe", (8, 7, 6), 27),
    "probe_16^3_27pt": ("probe", (16, 16, 16), 27),
    "probe_32^3_7pt": ("probe", (32, 32, 32), 7),
    "p468_tail_52^3_27pt": ("tail", (52, 52, 52), 27),
}


def inputs(case: str):
    """(weights, offsets, dims, d_inv or None, coef, cdims, scale or None) of
    a case as numpy float32; None: the setup's own (D⁻¹ = 1 / centre, the
    block scale), made by each package."""
    kind, dims, pts = CASES[case]
    cdims = tuple(-(-n // B) for n in dims)
    if kind == "tail":
        from parallel_amg_tpu_torch.problems import seeded_stencil
        w, offs = seeded_stencil(dims, pts, 3)
        return w, offs, dims, None, np.float32(0.55), cdims, None
    rng = np.random.default_rng(3)
    offs = tuple(o for o in itertools.product((-1, 0, 1), repeat=len(dims))
                 if pts == 3 ** len(dims) or sum(map(abs, o)) <= 1)
    w = rng.standard_normal((len(offs),) + dims).astype(np.float32)
    d = rng.standard_normal(dims).astype(np.float32)
    scale = (rng.random(cdims) + 0.5).astype(np.float32)
    return w, offs, dims, d, np.float32(0.37), cdims, scale


def summary(planes: np.ndarray) -> dict:
    """sha256 of the float32 bits, the shape and a sample of the bits."""
    a = np.ascontiguousarray(planes, dtype=np.float32)
    flat = a.ravel().view(np.uint32)
    pick = np.random.default_rng(0).integers(0, flat.size, 8)
    idx = [int(i) for i in range(min(8, flat.size))] + [int(i) for i in pick]
    return {"shape": list(a.shape), "sha256": hashlib.sha256(a.tobytes()).hexdigest(),
            "sample": {str(i): f"0x{int(flat[i]):08x}" for i in idx}}


def jax_planes(case: str) -> np.ndarray:
    import jax.numpy as jnp

    from parallel_amg_tpu.amg import device_setup as jds
    from parallel_amg_tpu.ops.stencil import Stencil as JStencil

    w, offs, dims, d, coef, cdims, scale = inputs(case)
    A = JStencil(jnp.asarray(w), offs, dims)
    dj = jds._jit_dinv(A) if d is None else jnp.asarray(d)
    sj = (jds._jit_scale(jnp.ones(dims, jnp.float32), cdims, B) if scale is None
          else jnp.asarray(scale))
    return np.asarray(jds._jit_bucketed(A, dj, jnp.asarray(coef), cdims, B, sj).weights)


def port_planes(case: str, device: str) -> np.ndarray:
    import torch

    from parallel_amg_tpu_torch.amg import device_setup as ds
    from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    w, offs, dims, d, coef, cdims, scale = inputs(case)
    A = Stencil(torch.from_numpy(w).to(device), offs, dims)
    dt = ds.diag_inverse(A) if d is None else torch.from_numpy(d).to(device)
    st = (ds.block_scale(downsample_sum_nd(torch.ones(dims, device=device), cdims, B))
          if scale is None else torch.from_numpy(scale).to(device))
    out = ds.bucketed_coarse_operator(A, dt, torch.tensor(coef, device=device), cdims, B, st)
    return out.weights.cpu().numpy()


def held(case: str, planes: np.ndarray, record: dict) -> bool:
    """Whether ``planes`` has the recorded bits of ``case``."""
    return summary(planes) == {k: record["cases"][case][k]
                               for k in ("shape", "sha256", "sample")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=RECORD)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--case", nargs="*", default=list(CASES))
    args = ap.parse_args()
    if args.port:
        import torch
        torch.set_num_threads(4)
        with open(RECORD) as f:
            record = json.load(f)
        ok = True
        for case in args.case:
            t = time.time()
            equal = held(case, port_planes(case, args.device), record)
            ok &= equal
            print(json.dumps({"case": case, "device": args.device, "equal_record": equal,
                              "seconds": round(time.time() - t, 2)}), flush=True)
        return 0 if ok else 1
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jaxlib

    from jax_config3_levels import cpu_model

    out = {"what": "the JAX package's _jit_bucketed coarse weights (float32 bits) on the CPU",
           "jax": jax.__version__, "jaxlib": jaxlib.__version__, "cpu": cpu_model(),
           "cores": os.cpu_count(), "cases": {}}
    for case in args.case:
        t = time.time()
        planes = jax_planes(case)
        kind, dims, pts = CASES[case]
        out["cases"][case] = dict(grid=list(dims), points=pts, seeding=kind,
                                  seconds=round(time.time() - t, 2), **summary(planes))
        print(case, out["cases"][case]["sha256"], out["cases"][case]["seconds"], flush=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
