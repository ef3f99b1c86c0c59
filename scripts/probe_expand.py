#!/usr/bin/env python3
"""Kernel B3 (spgemm_expand) and the config #2 device setup, timed on one
CUDA card, beside other builds of ``spgemm.cu`` in turns.

    python3 scripts/probe_expand.py [--other NAME=PATH/TO/spgemm.cu ...]

1. The port's own build of ``parallel_amg_tpu_torch/csrc/spgemm.cu`` is the
   variant "port"; each ``--other NAME=PATH`` builds another source with the
   same C entries (e.g. ``parent=`` the ``spgemm.cu`` of an earlier commit)
   into ``build/probe_expand/``.
2. Sets up acceptance config #2 (2D Poisson 1024², Ruge–Stüben, extended+i)
   on the card and takes chip_smoke.py's SpGEMM cases: level-0 R·A and
   (R·A)·P, levels 1–3 R·A, a random rectangular product, explicit zeros
   and empty rows, and K 5,120.
3. Per case, every variant's ``gspgemm.gather_candidates`` is held
   ``torch.equal`` to the plain version, then timed with CUDA events
   (chip_smoke.device_ms) in turns: the variants in order, then reversed.
4. The config #2 device setup under torch.profiler, once per variant in
   turns: device ms of expand_kernel, merge_kernel and of all kernels;
   then once more with the port's own build, its twelve largest device
   operations by name.

Prints JSON lines, then the card's name and power limit.  Needs a card,
nvcc and no JAX.
"""

import argparse
import concurrent.futures
import ctypes
import functools
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import bound_ms, device_ms, nvidia_smi, profile_cycles  # noqa: E402


def build(name, source):
    """nvcc ``source`` with the port's flags into build/probe_expand/; the
    file name carries a hash of both."""
    from parallel_amg_tpu_torch.ops import _build

    flags = list(_build.NVCC_FLAGS)
    digest = hashlib.sha256(Path(source).read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "probe_expand" / f"{name}-{digest}.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *flags, "-o", str(out), str(source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}: {proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return name, out


def binder(path):
    """A stand-in for ``pspgemm.kernel`` that binds the C entries of the
    library at ``path``."""
    from parallel_amg_tpu_torch.ops import pspgemm

    lib = ctypes.CDLL(str(path))

    @functools.cache
    def kernel(symbol):
        fn = getattr(lib, symbol)
        fn.argtypes = pspgemm._ARGTYPES[symbol]
        fn.restype = pspgemm._RESTYPES.get(symbol, ctypes.c_int)
        return fn

    return kernel


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=PATH",
                    help="another spgemm.cu with the same C entries")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("probe_expand_store: torch finds no CUDA device")
    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.ops import gspgemm, pspgemm
    from parallel_amg_tpu_torch.ops.ell import ELL
    from parallel_amg_tpu_torch.ops.ell_setup import ell_spgemm
    from parallel_amg_tpu_torch.problems import poisson2d

    jobs = [(name, Path(path).resolve())
            for name, path in (o.split("=", 1) for o in args.other)]
    libs = {}
    if jobs:
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            libs = dict(pool.map(lambda j: build(*j), jobs))
    kernels = {name: binder(path) for name, path in libs.items()}
    kernels["port"] = pspgemm.kernel
    names = list(kernels)

    def use(name):
        pspgemm.kernel = kernels[name]

    def emit(phase, **fields):
        print(json.dumps({"phase": phase, **fields}), flush=True)

    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi(),
         torch=torch.__version__, cuda=torch.version.cuda, variants=names)

    dev = torch.device("cuda")
    A_csr = poisson2d(1024).to_csr()
    cfg = ptt.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                        interpolation="extended_i", on_device_setup=True)
    h = ptt.setup(A_csr, cfg, device=dev)
    rng = np.random.default_rng(0)

    def random_ell(n_rows, n_cols, width, zero_frac=0.0, empty_frac=0.0):
        nnz = rng.integers(0, width + 1, size=n_rows)
        nnz[rng.random(n_rows) < empty_frac] = 0
        cols = rng.integers(0, n_cols, size=(n_rows, width)).astype(np.int32)
        vals = rng.normal(size=(n_rows, width)).astype(np.float32)
        vals[rng.random((n_rows, width)) < zero_frac] = 0.0
        pad = np.arange(width)[None, :] >= nnz[:, None]
        cols[pad], vals[pad] = 0, 0.0
        return ELL(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(nnz.astype(np.int32)), (n_rows, n_cols)).to(dev)

    L = h.levels
    cases = {
        "config2_L0_RA": (L[0].R, L[0].A),
        "config2_L0_RAP": (ell_spgemm(L[0].R, L[0].A), L[0].P),
        "config2_L1_RA": (L[1].R, L[1].A),
        "config2_L2_RA": (L[2].R, L[2].A),
        "config2_L3_RA": (L[3].R, L[3].A),
        "random_rect_200000x150000": (random_ell(200_000, 150_000, 8),
                                      random_ell(150_000, 120_000, 6)),
        "zeros_empty_overflow": (random_ell(50_000, 3_000, 12, 0.2, 0.1),
                                 random_ell(3_000, 2_000, 9, 0.2, 0.1)),
        "wide_K5120": (random_ell(400, 3_000, 64), random_ell(3_000, 2_000, 80)),
    }
    order = names + names[::-1]
    for case, (A, B) in cases.items():
        R, Rb, K = A.n_rows, B.n_rows, A.width * B.width
        pc, pv = gspgemm._gather_candidates_plain(A, B)
        for name in names:
            use(name)
            cc, cv = gspgemm.gather_candidates(A, B)
            torch.cuda.synchronize()
            if not (torch.equal(cc, pc) and torch.equal(cv, pv)):
                raise AssertionError(f"{name} {case}: spgemm_expand disagrees "
                                     "with the plain version")
            del cc, cv
        del pc, pv
        samples = {name: [] for name in names}
        for name in order:
            use(name)
            samples[name].append(device_ms(lambda: gspgemm.gather_candidates(A, B)))
        use("port")
        # A's planes and B's rows read once (B stays in L2), candidates
        # written once
        b_ms, b_by = bound_ms(R * A.width * 8 + R * 4 + Rb * B.width * 8 + Rb * 4
                              + R * K * 8, R * K)
        emit("expand", case=case, rows=R, Wa=A.width, Wb=B.width, K=K,
             plan=gspgemm.expand_plan(A.width, B.width), bound_ms=b_ms,
             bound_by=b_by, torch_equal=True, ms_samples=samples,
             ms={n: sum(s) / len(s) for n, s in samples.items()})
    del cases, h

    # the config #2 device setup, profiled, per variant in turns
    for name in order:
        use(name)
        prof = profile_cycles(lambda: ptt.setup(A_csr, cfg, device=dev), n=1)
        ms = prof["port_kernel_device_ms_per_call"]
        emit("setup_profile", variant=name,
             expand_kernel_ms=ms.get("expand_kernel"),
             merge_kernel_ms=ms.get("merge_kernel"),
             device_ms=prof["device_ms_per_call"],
             kernels=prof["kernels_per_call"],
             wall_ms_profiled=prof["wall_ms_per_call_profiled"])
    # where the device time of that setup goes: its largest device
    # operations by name, with the port's own build
    use("port")
    from torch.profiler import ProfilerActivity, profile

    ptt.setup(A_csr, cfg, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ptt.setup(A_csr, cfg, device=dev)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.device_time_total / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit("setup_top_operations", device_ms=sum(v[0] for v in by_name.values()),
         operations=sum(v[1] for v in by_name.values()),
         top=[{"name": k[:120], "ms": v[0], "count": v[1]} for k, v in top])
    print(nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()
