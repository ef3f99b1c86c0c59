"""Times kernel B8's two routes on the card at config #3's sharded levels in
4 parts, for this checkout and, in turns, for other checkouts, with the
card's name and power limit.

    python3 scripts/bench_halo_route.py [--tree NAME=DIR ...] [--rounds N]

Config #3 (128³ 7-point Poisson, block SA b=3) is split over
``make_row_mesh(4)`` with halo_mode "pallas_async" and set up on the card
(``sharded_device_setup``); its level-0 weights are scaled by seeded
factors in [0.5, 2), as ``chip_smoke.py``'s B8 phase does, and level 1 (the
27-point Galerkin operator) is taken as the setup gives it.  On each level,
for each checkout: the one-launch matvec (``halo_stencil_matvec``), the
exchange route run on one card (``phalo_async.matvec_copy_streams``, its
halos views of the neighbours' slabs) and its two entries over every part,
each as device ms from CUDA events (``chip_smoke.device_ms``, whose sleep
ahead of each window outlasts the host's enqueue of its calls) and host ms
to enqueue one call; the
B8 launches of one route call; and a digest of each result's bits, so that
equal digests across checkouts show equal results.  Then, where the route
runs in earnest, config #3 in 4 parts on 2 gloo ranks sharing the card
(``parallel/launch.py``): each rank's V-cycle and level-0 matvec wall ms
(20 and 50 calls, each ending in a synchronize) and its B8 launches per
V-cycle.  Each checkout runs in
its own process (``--worker``, the checkout first on ``PYTHONPATH``), in
the order the trees are given and then reversed, ``--rounds`` times
(parent, change, change, parent with one other tree).  A checkout whose
``stencil_interior`` takes one part (``(W, x, offsets, h)``) is timed as a
loop over the parts.  One JSON line per process.
"""

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(t) -> str:
    return hashlib.sha256(t.contiguous().view(-1).cpu().numpy().tobytes()).hexdigest()[:16]


def _cfg():
    import dataclasses

    import parallel_amg_tpu_torch as ptt

    return dataclasses.replace(
        ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                      smoother="chebyshev", n_coarse_max=512, on_device_setup=True),
        halo_mode="pallas_async")


def rank_cycle():
    """One rank of config #3 in 4 parts over 2 processes: its V-cycle and
    level-0 matvec wall ms, and its B8 launches per V-cycle."""
    import time

    import numpy as np
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.parallel import phalo_async

    dims, cfg = (128,) * 3, _cfg()
    mesh = ptt.make_row_mesh(4)
    A0, td = ptt.poisson_stencil_sharded(dims, mesh, cfg)
    h = ptt.sharded_device_setup(A0, cfg, true_dims=td)
    b = ptt.distribute_grid(np.random.default_rng(0).normal(size=128 ** 3).astype(
        np.float32), dims, h, mesh)
    z = b.zeros_like()

    def wall(fn, n):
        out = []
        for i in range(n + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i >= 3:
                out.append((time.perf_counter() - t0) * 1e3)
        return out

    vcycle = wall(lambda: ptt.vcycle(h, z, b), 20)
    matvec = wall(lambda: h.levels[0].A.matvec(b), 50)
    for k in phalo_async.LAUNCHES:
        phalo_async.LAUNCHES[k] = 0
    ptt.vcycle(h, z, b)
    torch.cuda.synchronize()
    return {"local_parts": list(mesh.local), "vcycle_ms": vcycle, "matvec_ms": matvec,
            "b8_launches_per_vcycle": dict(phalo_async.LAUNCHES)}


def worker(name: str) -> None:
    """Times the routes of the checkout that ``parallel_amg_tpu_torch``
    resolves to (the first entry of PYTHONPATH)."""
    import importlib.util
    import statistics

    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.parallel import exchange, launch, phalo_async
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid
    from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil

    # this checkout's timers (chip_smoke.py), whichever package is timed
    spec = importlib.util.spec_from_file_location(
        "smoke_timers", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    device_ms, host_ms, nvidia_smi = smoke.device_ms, smoke.host_ms, smoke.nvidia_smi
    dev = torch.device("cuda")
    cfg = _cfg()
    mesh = ptt.make_row_mesh(4)
    A0, td = ptt.poisson_stencil_sharded((128,) * 3, mesh, cfg)
    h = ptt.sharded_device_setup(A0, cfg, true_dims=td)
    g = torch.Generator(device=dev).manual_seed(0)
    L0 = h.levels[0].A
    cases = {
        "config3_level0_4parts": ShardedStencil(
            [W * (0.5 + 1.5 * torch.rand(W.shape, generator=g, device=dev))
             for W in L0.weights], L0.offsets, L0.dims, L0.mesh),
        "config3_level1_4parts": h.levels[1].A,
    }
    per_part = list(inspect.signature(phalo_async.stencil_interior).parameters)[0] == "W"

    for case, A in cases.items():
        x = PGrid.from_global(torch.randn(A.dims, generator=g, device=dev), A.mesh)
        A_k = A.with_halo_mode("pallas_async")
        hw, offs = A.halo, A.offsets
        lands = exchange.halos(x.parts, hw)
        if per_part:
            def interior():
                return [phalo_async.stencil_interior(W, xl, offs, hw)
                        for W, xl in zip(A.weights, x.parts)]

            ys = interior()

            def boundary():
                return [phalo_async.stencil_boundary(y, W, lf, rt, offs, hw)
                        for y, W, (lf, rt) in zip(ys, A.weights, lands)]
        else:
            def interior():
                return phalo_async.stencil_interior(A, x)

            ys = interior()

            def boundary():
                return phalo_async.stencil_boundary(A, ys, lands)

        def route():
            return phalo_async.matvec_copy_streams(A, x)

        one = A_k.matvec(x).to_global()
        rt = route().to_global()
        for k in phalo_async.LAUNCHES:
            phalo_async.LAUNCHES[k] = 0
        route()
        torch.cuda.synchronize()
        launches = dict(phalo_async.LAUNCHES)
        print(json.dumps({
            "tree": name, "case": case, "dims": list(A.dims), "points": A.n_points,
            "halo": hw, "route_launches": launches,
            "one_launch_ms": device_ms(lambda: A_k.matvec(x)),
            "route_ms": device_ms(route),
            "route_host_ms": host_ms(route),
            "interior_ms": device_ms(interior),
            "interior_host_ms": host_ms(interior),
            "boundary_ms": device_ms(boundary),
            "boundary_host_ms": host_ms(boundary),
            "one_launch_digest": _digest(one), "route_digest": _digest(rt),
            "nvidia_smi": nvidia_smi(), "device": torch.cuda.get_device_name(0),
        }), flush=True)
    del cases, h, A0, x, ys, lands
    torch.cuda.empty_cache()
    for r in launch.spawn(rank_cycle, 2, timeout_s=300, threads=4):
        print(json.dumps({
            "tree": name, "case": "config3_4parts_2_ranks", **{
                k: r[k] for k in ("local_parts", "b8_launches_per_vcycle")},
            **{f"{k}_quartiles": statistics.quantiles(r[k], n=4)
               for k in ("vcycle_ms", "matvec_ms")},
            "vcycle_ms": r["vcycle_ms"], "nvidia_smi": nvidia_smi()}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=DIR of another checkout to time in turns")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker)
    trees = [t.split("=", 1) for t in args.tree] + [["change", ROOT]]
    order = (trees + trees[::-1] if len(trees) > 1 else trees) * args.rounds
    for name, path in order:
        env = dict(os.environ, PYTHONPATH=os.path.abspath(path))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", name],
                       env=env, check=True)


if __name__ == "__main__":
    main()
