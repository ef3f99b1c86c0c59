"""Native (C++) host builder behind ``PCSR.from_csr``, loaded through ctypes.

Counterpart of ``parallel_amg_tpu/native/__init__.py``: the O(nnz)
CSR-partition scans of ``PCSR.from_csr`` live in ``pcsr_builder.cpp``
(OpenMP over parts).  The library compiles with g++ on first use into the
repository's ``build/`` directory, beside the CUDA libraries, under a file
name that carries a hash of the source and the flags.

Unlike the JAX package's loader, a failed build raises with the compiler's
message: nothing falls back quietly to numpy.  The numpy partition path is
reached only by an explicit ``PCSR.from_csr(..., native=False)``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from parallel_amg_tpu_torch.ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "pcsr_builder.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"pcsr_builder-{digest}.so"


def build() -> Path:
    """Compile ``pcsr_builder.cpp`` unless its library is already built."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


@functools.cache
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.c_int64
    lib.pcsr_analyze.restype = ctypes.c_int
    lib.pcsr_analyze.argtypes = [i64p, i64p, i64, i64, i64, i64,
                                 i32p, i32p, i64p, i64p, i64]
    lib.pcsr_fill.restype = ctypes.c_int
    lib.pcsr_fill.argtypes = [i64p, i64p, f64p, i64, i64, i64, i64,
                              ctypes.c_int32, ctypes.c_int32, i64p, i64p,
                              i32p, f64p, i32p, f64p]
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pcsr_partition(indptr, indices, data, n_rows, S, m, mc):
    """Partition a CSR matrix into per-part own/ghost padded ELL blocks.

    Returns (diag_cols, diag_vals, off_cols, off_vals, ghost_sets), the
    (S, m, W) planes and the sorted ghost set of each part, with the
    semantics of the numpy path of ``PCSR.from_csr`` minus the identity
    padding rows, which the caller appends.
    """
    lib = _load()
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nnz = int(indices.shape[0])
    Wd = ctypes.c_int32(0)
    Wo = ctypes.c_int32(0)
    ghost_off = np.zeros(S + 1, dtype=np.int64)
    ghost_buf = np.empty(max(nnz, 1), dtype=np.int64)
    rc = lib.pcsr_analyze(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        n_rows, S, m, mc, ctypes.byref(Wd), ctypes.byref(Wo),
        _ptr(ghost_off, ctypes.c_int64), _ptr(ghost_buf, ctypes.c_int64),
        ghost_buf.shape[0])
    if rc != 0:
        raise RuntimeError(f"pcsr_analyze failed ({rc})")
    Wd = max(int(Wd.value), 1)
    Wo = max(int(Wo.value), 1)
    diag_cols = np.zeros((S, m, Wd), dtype=np.int32)
    diag_vals = np.zeros((S, m, Wd), dtype=np.float64)
    off_cols = np.zeros((S, m, Wo), dtype=np.int32)
    off_vals = np.zeros((S, m, Wo), dtype=np.float64)
    rc = lib.pcsr_fill(
        _ptr(indptr, ctypes.c_int64), _ptr(indices, ctypes.c_int64),
        _ptr(data, ctypes.c_double), n_rows, S, m, mc, Wd, Wo,
        _ptr(ghost_off, ctypes.c_int64), _ptr(ghost_buf, ctypes.c_int64),
        _ptr(diag_cols, ctypes.c_int32), _ptr(diag_vals, ctypes.c_double),
        _ptr(off_cols, ctypes.c_int32), _ptr(off_vals, ctypes.c_double))
    if rc != 0:
        raise RuntimeError(f"pcsr_fill failed ({rc})")
    ghost_sets = [ghost_buf[ghost_off[s]:ghost_off[s + 1]].copy()
                  for s in range(S)]
    return diag_cols, diag_vals, off_cols, off_vals, ghost_sets
