"""TWELL — the unstructured-SpMV format, in Hopper's layout.

Counterpart of ``parallel_amg_tpu/ops/twell.py``: the format that carries
every operator that is not banded (coarse A, every P and R), under the same
class name and module path.  The JAX TWELL is a tile-windowed ELL shaped for
Mosaic's in-tile gather (128-lane windows, sublane-replicated x, scalar
prefetched piece tables).  A Hopper thread can load any address, so here the
layout is plain CSR: int32 ``indptr``, int32 ``indices`` and f32 or bf16
``vals``, plus the kernel's row-block plan (``row_blocks``), built once per
matrix on its device and kept on the object.

``TWELL.matvec`` launches the hand-written CUDA kernel ``csrc/twell_spmv.cu``
on a CUDA tensor (or raises) and runs the plain torch version
``_matvec_plain`` on a CPU tensor.  ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from parallel_amg_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches made by TWELL.matvec; callers may reset it

_SYMBOLS = {torch.float32: "twell_spmv_f32", torch.bfloat16: "twell_spmv_bf16"}
_INT32_LIMIT = 2**31

# The row-block plan.  Rows whose first entries fall in one window of
# BLOCK_WINDOW entries share a block, at most BLOCK_ROWS of them, and a row
# of more than LONG_ROW entries is a block of its own.  A block of short rows
# then holds at most BLOCK_WINDOW − 1 + LONG_ROW ≤ STREAM_CAP entries, the
# products one thread block of csrc/twell_spmv.cu keeps in shared memory
# (kCap there); a longer single row takes the kernel's long-row path.
# BLOCK_WINDOW sits just below 2048, so that a typical block is one round of
# two 4-entry loads for each of the kernel's 256 threads; BLOCK_ROWS is high
# enough that on config #2's operators the windows, not the row cap, cut the
# blocks, so that few blocks are part-filled.
STREAM_CAP = 4096
BLOCK_WINDOW = 2016
LONG_ROW = 2048
BLOCK_ROWS = 4096


def row_blocks(indptr):
    """(n_blocks + 1,) int32 first row of each block of the kernel's plan,
    then the row count; torch ops on indptr's device and one host read (the
    block count, which ``nonzero`` syncs for)."""
    n_rows = indptr.numel() - 1
    ptr = indptr.long()
    start, length = ptr[:-1], ptr[1:] - ptr[:-1]
    window = torch.div(start, BLOCK_WINDOW, rounding_mode="floor")
    long_row = length > LONG_ROW
    first = (torch.arange(n_rows, device=ptr.device) % BLOCK_ROWS == 0) | long_row
    first[1:] |= (window[1:] != window[:-1]) | long_row[:-1]
    end = torch.full((1,), n_rows, dtype=torch.long, device=ptr.device)
    return torch.cat([first.nonzero().flatten(), end]).to(torch.int32)


@functools.cache
def _kernel(symbol: str):
    fn = getattr(_build.load("twell_spmv"), symbol)
    # every pointer and the stream as c_void_p: without argtypes ctypes
    # passes a Python int as a 32-bit C int and cuts the pointer
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class TWELL:
    """Sparse matrix of any rectangular sparsity, stored as int32 CSR.

    Attributes:
      indptr: (n_rows + 1,) int32 row pointers.
      indices: (nnz,) int32 column indices, sorted within each row.
      vals: (nnz,) float32 or bfloat16 values.
      shape: (n_rows, n_cols).
      blocks: (n_blocks + 1,) int32 row-block plan of the kernel
        (``row_blocks(indptr)``, built here unless given).
    """

    def __init__(self, indptr, indices, vals, shape, blocks=None):
        self.indptr = indptr
        self.indices = indices
        self.vals = vals
        self.shape = tuple(int(s) for s in shape)
        self.blocks = row_blocks(indptr) if blocks is None else blocks
        self._rows = None  # int64 row id per entry, built on first use

    def to(self, device) -> "TWELL":
        return TWELL(self.indptr.to(device), self.indices.to(device),
                     self.vals.to(device), self.shape, self.blocks.to(device))

    # -- properties -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.numel())

    @property
    def n_blocks(self) -> int:
        return self.blocks.numel() - 1

    # -- construction -----------------------------------------------------
    @classmethod
    def from_csr(cls, csr, dtype=None) -> "TWELL":
        """Build from a host CSR; index arrays narrow to int32 here, once."""
        dtype = dtype or torch.float32
        if dtype not in _SYMBOLS:
            raise TypeError(f"TWELL values must be float32 or bfloat16, got {dtype}")
        n_rows, n_cols = csr.shape
        if max(csr.nnz, n_rows, n_cols) >= _INT32_LIMIT:
            raise ValueError(f"TWELL indexes with int32: shape {csr.shape}, "
                             f"nnz {csr.nnz} must stay below 2^31")
        return cls(
            indptr=torch.from_numpy(csr.indptr.astype(np.int32)),
            indices=torch.from_numpy(csr.indices.astype(np.int32)),
            vals=torch.from_numpy(np.asarray(csr.data, np.float64)).to(dtype),
            shape=(n_rows, n_cols),
        )

    def to_csr(self):
        """Host round-trip (float32 values)."""
        from parallel_amg_tpu_torch.ops.csr import CSR

        return CSR.from_numpy(self.indptr.cpu().numpy(),
                              self.indices.cpu().numpy(),
                              self.vals.cpu().float().numpy(), self.shape)

    def row_ids(self):
        """(nnz,) int64 row of each stored entry."""
        if self._rows is None:
            counts = self.indptr.diff().long()
            self._rows = torch.repeat_interleave(
                torch.arange(self.n_rows, device=counts.device), counts)
        return self._rows

    # -- SpMV -------------------------------------------------------------
    def matvec(self, x):
        """y = A @ x for a float32 x of length n_cols; y is float32."""
        if x.dim() != 1 or x.shape[0] != self.n_cols:
            raise ValueError(f"x has shape {tuple(x.shape)}, "
                             f"TWELL {self.shape} needs ({self.n_cols},)")
        if x.dtype != torch.float32:
            raise TypeError(f"x must be float32, got {x.dtype}")
        if x.device != self.vals.device:
            raise ValueError(f"x is on {x.device}, the matrix on {self.vals.device}")
        if x.device.type == "cpu":
            return _matvec_plain(self, x)
        if x.device.type != "cuda":
            raise ValueError(f"TWELL.matvec runs on cpu or cuda, not {x.device}")
        return _matvec_cuda(self, x)

    def matmat(self, X):
        """Y = A @ X for dense (n_cols, k) X — k matvec passes."""
        return torch.stack([self.matvec(X[:, j].contiguous())
                            for j in range(X.shape[1])], dim=1)

    def diagonal(self):
        """Main diagonal (missing entries → 0), in the values' dtype."""
        rows = self.row_ids()
        hit = self.indices.long() == rows
        d = torch.zeros(self.n_rows, dtype=self.vals.dtype,
                        device=self.vals.device)
        return d.index_add_(0, rows[hit], self.vals[hit])

    def __matmul__(self, x):
        if x.ndim == 1:
            return self.matvec(x)
        return self.matmat(x)


def _matvec_plain(A: TWELL, x):
    """Plain torch y = A @ x: products in f32, summed per row by index_add_."""
    y = torch.zeros(A.n_rows, dtype=torch.float32, device=x.device)
    return y.index_add_(0, A.row_ids(), A.vals.float() * x[A.indices])


def _matvec_cuda(A: TWELL, x):
    """Launch ``csrc/twell_spmv.cu`` on the current stream of x's device."""
    global LAUNCHES
    if A.vals.dtype not in _SYMBOLS:
        raise TypeError(f"the kernel takes float32 or bfloat16 values, got {A.vals.dtype}")
    if A.indptr.dtype != torch.int32 or A.indices.dtype != torch.int32:
        raise TypeError("the kernel takes int32 indptr and indices")
    for name, t in (("indptr", A.indptr), ("indices", A.indices),
                    ("vals", A.vals), ("blocks", A.blocks), ("x", x)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if A.indptr.numel() != A.n_rows + 1 or A.vals.numel() != A.nnz:
        raise ValueError("indptr/indices/vals do not match the shape")
    if A.blocks.dtype != torch.int32:
        raise TypeError("the row-block plan must be int32")
    if A.nnz >= _INT32_LIMIT:
        raise ValueError(f"nnz {A.nnz} does not fit the kernel's int32 indices")
    y = torch.empty(A.n_rows, dtype=torch.float32, device=x.device)
    if A.n_rows == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(_SYMBOLS[A.vals.dtype])(
            A.indptr.data_ptr(), A.indices.data_ptr(), A.vals.data_ptr(),
            x.data_ptr(), y.data_ptr(), A.blocks.data_ptr(), A.n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"twell_spmv launch failed: cudaError {err}")
    LAUNCHES += 1
    return y
