#!/usr/bin/env python3
"""Smoke test of parallel_amg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Device: torch, CUDA and nvcc versions, the card's name and power limit.
2. Build: compiles csrc/twell_spmv.cu and csrc/flatdia_spmv.cu with nvcc
   into build/, both at once, and prints each one's ptxas lines; then the
   card's copy bandwidth from a 1 GiB device-to-device copy.
3. Setup of acceptance config #2 at its full size (2D Poisson 1024²,
   Ruge–Stüben PMIS + extended+i, Chebyshev, n_coarse_max=256) on the card.
4. Kernel B1 (twell_spmv) against its plain torch version on a random
   rectangular matrix, a long-row matrix and config #2's level-1 A, P0 and
   R0, in float32 and bfloat16: kernel, plain, bound and library-CSR times.
5. setup3d: acceptance config #3 at its full size (3D Poisson 128³,
   block SA b=3, Chebyshev, n_coarse_max=512) set up on the card.
6. Kernel B2 (flatdia_spmv) against its plain version on a random 7-point
   128³ stencil, config #3's level-1 coarse stencil, config #2's widest DIA
   level and a tiny grid whose flattened planes alias, in float32 and
   bfloat16, with the same four times.
7. Slice (config #2): V-cycle time, then amg_pcg to 1e-6 with the launch
   counts of both kernels, the true residual in float64 (held to the
   float32 rounding floor, see below) and the float64 oracle's iterations.
8. slice3d (config #3): with_spmv_backend "mixed", V-cycle time, amg_pcg to
   1e-6 with B2's launch count and the true residual in float64; then the
   V-cycle and iterations again under "pallas" (every level on B2).
9. Profile: device kernels, device time and busy share per V-cycle of both
   configs (torch.profiler).
10. Config #1: 64², V(1,1) weighted Jacobi, standalone solve.

Every phase prints JSON lines.  Any failure raises, so the script exits
non-zero without its last line, which on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Before it come the kernels line and the card's `nvidia-smi` name and power
limit.  It needs no JAX and exits non-zero where torch finds no CUDA card.
"""

import concurrent.futures
import json
import statistics
import subprocess
import sys
import time

# |y_kernel − y_plain| ≤ ATOL + RTOL·(|A|·|x|): the two sum the same float32
# products per row in another order.
RTOL, ATOL = 1e-5, 1e-6
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels' products are float32 FMAs).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
KERNELS = {
    "twell_spmv": {"source": "parallel_amg_tpu_torch/csrc/twell_spmv.cu",
                   "replaces": "parallel_amg_tpu/ops/twell.py:234"},
    "flatdia_spmv": {"source": "parallel_amg_tpu_torch/csrc/flatdia_spmv.cu",
                     "replaces": "parallel_amg_tpu/ops/flatdia.py:193"},
}
CONFIG3_ROWS = [2_097_152, 79_507, 3_375, 125]
CONFIG3_ITERS = 12  # the JAX package's count (bench_details.json:40)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps=10, samples=25, warmup=5):
    """Median device time of one fn() call in ms, over `samples` CUDA-event
    windows of `reps` back-to-back calls.  A sleep kernel queued ahead of
    each window keeps the stream busy while the host enqueues it, so the
    window holds device time only."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def wall_ms(fn, n=20, warmup=3):
    """Host wall-clock ms of fn() ending in a synchronize, per call."""
    import torch

    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def bound_ms(n_bytes, flops):
    """Least time for the work: bytes over the HBM rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_ms(csr, x):
    """Time of one torch sparse CSR @ x call (cuSPARSE), the yardstick."""
    try:
        return device_ms(lambda: csr @ x), None
    except RuntimeError as e:  # the yardstick only; never on the path
        return None, f"{e}"[:200]


def profile_cycles(fn, n=5):
    """Device kernels, device ms and busy share per call of fn(), from
    torch.profiler over n calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels) / n
    return {"kernels_per_call": len(kernels) / n, "device_ms_per_call": dev_us / 1e3,
            "wall_ms_per_call_profiled": wall,
            "device_busy_share": (dev_us / 1e3) / wall if wall else None}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    import numpy as np
    import scipy.sparse as sp

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.amg import device_setup
    from parallel_amg_tpu_torch.ops import _build, flatdia, twell
    from parallel_amg_tpu_torch.ops.csr import CSR
    from parallel_amg_tpu_torch.ops.dia import DIA
    from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.ops.twell import TWELL, _matvec_plain
    from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
    from parallel_amg_tpu_torch.problems import poisson2d, poisson3d, poisson_stencil

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0], name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(),
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls would round through TF32")

    # -- build: one nvcc per source, all started together ----------------------
    def timed_build(name):
        was_built = _build.library_path(name).exists()
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, was_built, time.perf_counter() - t0, lib

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        built = list(pool.map(timed_build, KERNELS))
    wall_build = time.perf_counter() - t0
    for name, was_built, secs, lib in built:
        ptxas = [l.split(":", 1)[-1].strip()
                 for l in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in l or "stack frame" in l or "spill" in l]
        emit("build", kernel=name, seconds=secs, wall_seconds_all=wall_build,
             already_built=was_built, library=str(lib.name), ptxas=ptxas)

    src = torch.empty(2**30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src), reps=5, samples=9)
    copy_bytes_s = 2 * 2**30 / (copy_ms / 1e3)  # read + write
    emit("copy_bandwidth", bytes=2**30, ms=copy_ms, gb_s=copy_bytes_s / 1e9)
    del src, dst

    def copy_bound_ms(n_bytes):
        return 1e3 * n_bytes / copy_bytes_s

    def check_kernel(name, case, dtype, y, ref, bound, extra):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} {case} {dtype}: kernel output not finite")
        err = (y - ref).abs()
        abs_err = float(err.max()) if err.numel() else 0.0
        ok = bool((err <= bound).all())
        emit("kernel", name=name, case=case, dtype=str(dtype), max_abs_err=abs_err,
             max_rel_err=abs_err / max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30),
             tolerance=f"|dy| <= {ATOL} + {RTOL}*(|A||x|)", ok=ok, **extra)
        if not ok:
            raise AssertionError(f"{name} {case} {dtype}: kernel disagrees with "
                                 f"the plain version (max |dy| {abs_err})")
        return abs_err

    # -- setup of config #2 at 1024² ------------------------------------------
    nx = 1024
    A_csr = poisson2d(nx).to_csr()
    A_sp = A_csr.to_scipy()
    cfg = ptt.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                        interpolation="extended_i")
    t0 = time.perf_counter()
    h = ptt.setup(A_csr, cfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def fmt(M):
        return None if M is None else type(M).__name__

    levels = [{"rows": l.A.n_rows, "nnz": l.A.nnz, "A": fmt(l.A), "P": fmt(l.P),
               "R": fmt(l.R),
               "diags": l.A.n_diags if isinstance(l.A, DIA) else None}
              for l in h.levels]
    emit("setup", problem=f"poisson2d({nx})", seconds=setup_s,
         n_levels=h.n_levels, levels=levels, complexity=h.complexity())

    # -- kernel B1: twell_spmv -------------------------------------------------
    rng = np.random.default_rng(0)

    def random_rect(n_rows, n_cols, per_row):
        nnz = n_rows * per_row
        rows = np.repeat(np.arange(n_rows), per_row)
        cols = rng.integers(0, n_cols, size=nnz)
        vals = rng.normal(size=nnz).astype(np.float32)
        return CSR.from_scipy(sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n_rows, n_cols)))

    def long_rows(n_rows, n_cols):
        lengths = rng.integers(64, 513, size=n_rows)
        rows = np.repeat(np.arange(n_rows), lengths)
        cols = rng.integers(0, n_cols, size=rows.size)
        vals = rng.normal(size=rows.size).astype(np.float32)
        return CSR.from_scipy(sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n_rows, n_cols)))

    cases = {
        "random_rect_200000x150000": random_rect(200_000, 150_000, 9),
        "long_rows_65536": long_rows(65_536, 65_536),
        "level1_A": h.levels[1].A.to_csr(),
        "P0": h.levels[0].P.to_csr(),
        "R0": h.levels[0].R.to_csr(),
    }
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for name, csr in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            A = TWELL.from_csr(csr, dtype=dtype).to(dev)
            A_abs = TWELL(A.indptr, A.indices, A.vals.abs(), A.shape, A.group)
            x = torch.from_numpy(
                rng.normal(size=A.n_cols).astype(np.float32)).to(dev)
            y = A.matvec(x)
            ref = _matvec_plain(A, x)
            bound = ATOL + RTOL * _matvec_plain(A_abs, x.abs())
            n_bytes = ((A.n_rows + 1) * 4 + A.nnz * (4 + A.vals.element_size())
                       + A.n_cols * 4 + A.n_rows * 4)
            b_ms, b_by = bound_ms(n_bytes, 2 * A.nnz)
            lib_ms, lib_err = None, None
            if dtype == torch.float32:
                lib = torch.sparse_csr_tensor(A.indptr, A.indices, A.vals,
                                              size=A.shape)
                lib_ms, lib_err = library_ms(lib, x)
                del lib
            ms = device_ms(lambda: A.matvec(x))
            plain_ms = device_ms(lambda: _matvec_plain(A, x))
            err = check_kernel("twell_spmv", name, dtype, y, ref, bound, dict(
                shape=list(A.shape), nnz=A.nnz, group=A.group, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                copy_bound_ms=copy_bound_ms(n_bytes), library_csr_ms=lib_ms,
                library_error=lib_err, gnnz_s=A.nnz / ms / 1e6))
            r = results["twell_spmv"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "level1_A" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         main_case=f"{name} f32")
            del A, A_abs

    # -- setup3d: config #3 at 128³ on the card ---------------------------------
    n3 = 128
    cfg3 = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=512,
                         on_device_setup=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h3 = ptt.setup(poisson_stencil((n3,) * 3), cfg3)
    torch.cuda.synchronize()
    setup3_s = time.perf_counter() - t0
    levels3 = [{"rows": l.A.n_rows, "points": l.A.n_points, "format": fmt(l.A),
                "lam_max": l.lam_max,
                "product_path": (device_setup.select_product_path(l.A, cfg3)
                                 if l.P is not None else None)}
               for l in h3.levels]
    emit("setup3d", problem=f"poisson_stencil(({n3},)*3)", seconds=setup3_s,
         n_levels=h3.n_levels, levels=levels3,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    rows3 = [l.A.n_rows for l in h3.levels]
    if rows3 != CONFIG3_ROWS:
        raise AssertionError(f"config #3 levels {rows3}, want {CONFIG3_ROWS}")

    # -- kernel B2: flatdia_spmv ---------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    p7 = poisson_stencil((n3,) * 3)
    random7 = Stencil(p7.weights * (0.5 + 1.5 * torch.rand(
        p7.weights.shape, generator=g, device=dev)), p7.offsets, p7.dims)
    widest = max((l.A for l in h.levels if isinstance(l.A, DIA)),
                 key=lambda a: a.n_diags)
    alias_w = torch.rand((3, 4, 3), generator=g, device=dev) - 0.5
    alias_w[1, 3, :] = 0.0  # (1, 0) leaves the grid on the last row
    alias_w[2] = 0.0        # (0, 3) always leaves a 3-wide grid
    flat_cases = {
        "random_7pt_128^3": FlatDIA.from_stencil(random7),
        "config3_level1": FlatDIA.from_stencil(h3.levels[1].A),
        f"config2_dia_{widest.n_rows}x{widest.n_diags}diags": FlatDIA.from_dia(widest),
        "aliased_4x3": FlatDIA.from_stencil(
            Stencil(alias_w, ((0, 0), (1, 0), (0, 3)), (4, 3))),
    }
    if flat_cases["aliased_4x3"].nd_offsets is not None:
        raise AssertionError("the aliased case did not merge planes")
    del p7, random7

    def flat_csr(fd):
        r = torch.arange(fd.n, device=dev)
        rows, cols, vals = [], [], []
        for d, off in enumerate(fd.offsets):
            c = r + off
            keep = (fd.diags[d] != 0) & (c >= 0) & (c < fd.n)
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(fd.diags[d][keep].float())
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                      torch.cat(vals), (fd.n, fd.n))
        return coo.coalesce().to_sparse_csr()

    for name, fd in flat_cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            W = fd.diags.to(dtype).contiguous()
            x = torch.randn(fd.n, generator=g, device=dev)
            y = flatdia.dia_spmv(W, fd.offsets, x)
            ref = flatdia._matvec_plain(W, fd.offsets, x)
            bound = ATOL + RTOL * flatdia._matvec_plain(W.abs(), fd.offsets, x.abs())
            n_bytes = fd.n_points * fd.n * W.element_size() + 2 * fd.n * 4
            b_ms, b_by = bound_ms(n_bytes, 2 * fd.n_points * fd.n)
            lib_ms, lib_err = None, None
            if dtype == torch.float32:
                lib = flat_csr(FlatDIA(W, fd.offsets, fd.n))
                lib_ms, lib_err = library_ms(lib, x)
                del lib
            ms = device_ms(lambda: flatdia.dia_spmv(W, fd.offsets, x))
            plain_ms = device_ms(lambda: flatdia._matvec_plain(W, fd.offsets, x))
            err = check_kernel("flatdia_spmv", name, dtype, y, ref, bound, dict(
                rows=fd.n, diags=fd.n_points, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, copy_bound_ms=copy_bound_ms(n_bytes),
                library_csr_ms=lib_ms, library_error=lib_err,
                gb_s=n_bytes / ms / 1e6))
            r = results["flatdia_spmv"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "config3_level1" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         main_case=f"{name} f32")
            del W, x
    del flat_cases

    # -- slice: V-cycle and AMG-PCG at 1024² ------------------------------------
    n = A_csr.n_rows
    b_np = np.random.default_rng(0).normal(size=n).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    zero = torch.zeros_like(b)
    vtimes, v = wall_ms(lambda: ptt.vcycle(h, zero, b))
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("vcycle output not finite")

    twell.LAUNCHES = flatdia.LAUNCHES = 0
    t0 = time.perf_counter()
    res = ptt.amg_pcg(None, h, b, tol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches2 = {"twell_spmv": twell.LAUNCHES, "flatdia_spmv": flatdia.LAUNCHES}

    def true_rel_residual(A_host, b_host, x):
        x = np.asarray(x, np.float64).reshape(-1)
        return float(np.linalg.norm(b_host - A_host @ x) / np.linalg.norm(b_host))

    true_res = true_rel_residual(A_sp, b_np, res.x.cpu().numpy())
    t0 = time.perf_counter()
    oh = oracle_setup(A_sp, cfg)
    x_oracle, oracle_iters, _ = oracle_pcg(A_sp, b_np.astype(np.float64), oh,
                                           tol=1e-6)
    oracle_s = time.perf_counter() - t0
    # What float32 storage alone costs: the float64 oracle's own solution,
    # rounded to float32, leaves this true residual (≈ u·‖A‖·‖x‖/‖b‖; u the
    # float32 unit roundoff).  Each float32 CG step can widen the gap between
    # the recursive and the true residual by about as much (Greenbaum's
    # bound), so a float32 solve is held to tol + (iters + 1)·floor.
    f32_floor = true_rel_residual(A_sp, b_np, x_oracle.astype(np.float32))
    res_limit = 1e-6 + (res.iters + 1) * f32_floor
    hist = res.residual_history[:res.iters + 1].cpu().tolist()
    emit("slice", problem=f"poisson2d({nx})", vcycle_ms_median=statistics.median(vtimes),
         vcycle_ms=vtimes, pcg_iters=res.iters, converged=res.converged,
         solve_s=solve_s, residual_history=hist, true_rel_residual=true_res,
         f32_rounding_floor=f32_floor, true_rel_residual_limit=res_limit,
         launches=launches2, oracle_iters=int(oracle_iters),
         oracle_seconds=oracle_s)
    if not res.converged:
        raise AssertionError("amg_pcg did not converge to 1e-6")
    if not true_res <= res_limit:
        raise AssertionError(f"true relative residual {true_res} > {res_limit}")
    if abs(res.iters - int(oracle_iters)) > 1:
        raise AssertionError(f"PCG took {res.iters} iterations, the float64 "
                             f"oracle {oracle_iters}")
    if min(launches2.values()) <= 0:
        raise AssertionError(f"the config #2 solve skipped a kernel: {launches2}")
    del oh, x_oracle

    # -- slice3d: config #3 V-cycle and AMG-PCG at 128³ --------------------------
    A3_sp = poisson3d(n3).to_csr().to_scipy()
    b3_np = np.random.default_rng(0).normal(size=n3 ** 3).astype(np.float32)
    slice3 = {}
    for backend in ("mixed", "pallas"):
        hb = ptt.with_spmv_backend(h3, backend)
        b3 = torch.from_numpy(b3_np).to(dev).reshape(hb.grid_dims)
        zero3 = torch.zeros_like(b3)
        vt, v3 = wall_ms(lambda: ptt.vcycle(hb, zero3, b3))
        if not bool(torch.isfinite(v3).all()):
            raise AssertionError(f"{backend} vcycle output not finite")
        twell.LAUNCHES = flatdia.LAUNCHES = 0
        t0 = time.perf_counter()
        r3 = ptt.amg_pcg(hb.levels[0].A, hb, b3, tol=1e-6, maxiter=100)
        torch.cuda.synchronize()
        s3 = time.perf_counter() - t0
        launches3 = {"twell_spmv": twell.LAUNCHES, "flatdia_spmv": flatdia.LAUNCHES}
        true3 = true_rel_residual(A3_sp, b3_np, r3.x.cpu().numpy())
        slice3[backend] = dict(launches=launches3, iters=r3.iters)
        emit("slice3d", problem=f"poisson_stencil(({n3},)*3)", backend=backend,
             formats=[fmt(l.A) for l in hb.levels],
             vcycle_ms_median=statistics.median(vt), vcycle_ms=vt,
             pcg_iters=r3.iters, converged=r3.converged, solve_s=s3,
             residual_history=r3.residual_history[:r3.iters + 1].cpu().tolist(),
             true_rel_residual=true3, launches=launches3,
             jax_package_iters=CONFIG3_ITERS)
        if not r3.converged:
            raise AssertionError(f"config #3 ({backend}) did not converge to 1e-6")
        if abs(r3.iters - CONFIG3_ITERS) > 1:
            raise AssertionError(f"config #3 ({backend}) took {r3.iters} "
                                 f"iterations, the JAX package {CONFIG3_ITERS}")
        if not true3 <= 1e-5:
            raise AssertionError(f"config #3 true relative residual {true3} > 1e-5")
        if launches3["flatdia_spmv"] <= 0:
            raise AssertionError(f"the config #3 ({backend}) solve launched no B2")

    # -- profile: kernels and device time per V-cycle ------------------------------
    for label, hh, bb in (
            ("config2", h, b),
            ("config3_mixed", ptt.with_spmv_backend(h3, "mixed"),
             torch.from_numpy(b3_np).to(dev).reshape(h3.grid_dims)),
            ("config3_pallas", ptt.with_spmv_backend(h3, "pallas"),
             torch.from_numpy(b3_np).to(dev).reshape(h3.grid_dims))):
        zz = torch.zeros_like(bb)
        twell.LAUNCHES = flatdia.LAUNCHES = 0
        ptt.vcycle(hh, zz, bb)
        per_cycle = {"twell_spmv": twell.LAUNCHES, "flatdia_spmv": flatdia.LAUNCHES}
        emit("profile", cell=label, kernel_launches_per_vcycle=per_cycle,
             **profile_cycles(lambda: ptt.vcycle(hh, zz, bb)))

    # -- config #1: 64², V(1,1) weighted Jacobi, standalone solve ---------------
    A1 = poisson2d(64).to_csr()
    h1 = ptt.setup(A1, ptt.AMGConfig(coarsening="rs", smoother="jacobi"),
                   device=dev)
    b1 = torch.from_numpy(
        np.random.default_rng(0).normal(size=A1.n_rows).astype(np.float32)).to(dev)
    _, hist1, k1 = ptt.solve(h1, b1, tol=1e-8, maxiter=20)
    hist1 = hist1[:k1].cpu().tolist()
    cycles = min(6, k1)
    rate = (hist1[cycles - 1] / float(torch.linalg.norm(b1))) ** (1.0 / cycles)
    emit("config1", problem="poisson2d(64)", cycles=k1, residual_history=hist1,
         rate_first_cycles=rate)
    if not 0.05 <= rate <= 0.5:
        raise AssertionError(f"config #1 residual reduction {rate} per cycle")

    launches = {"twell_spmv": launches2["twell_spmv"],
                "flatdia_spmv": slice3["mixed"]["launches"]["flatdia_spmv"]}
    by_path = {"config2_pcg": launches2,
               "config3_mixed_pcg": slice3["mixed"]["launches"],
               "config3_pallas_pcg": slice3["pallas"]["launches"]}
    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        line.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "copy_bound_ms": r["copy_bound_ms"], "main_case": r["main_case"],
                     "launches_by_path": {k: v[name] for k, v in by_path.items()}})
    print(json.dumps({"kernels": line}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
