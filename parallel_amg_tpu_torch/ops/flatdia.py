"""FlatDIA — flattened-diagonal storage with the hand-written CUDA SpMV.

Counterpart of ``parallel_amg_tpu/ops/flatdia.py``.  Any stencil or banded
operator flattens to ``y[r] = Σ_d W[d, r] · x[r + off_d]`` with 1-D offsets
``off = Σ_i o_i · stride_i`` and W zero wherever the N-D neighbor falls
outside the grid, so the flattened form is exact, boundaries included.

The planes are stored ``(D, n)``: the JAX package pads them to a multiple of
its 1024-lane tile, which buys nothing on Hopper.  ``dia_spmv`` launches
``csrc/flatdia_spmv.cu`` (kernel B2) on a CUDA tensor (or raises) and runs
the plain torch version ``_matvec_plain`` on a CPU tensor; ``DIA.matvec``
(ops/dia.py) goes through the same function.  ``dia_spmm``, the multi-RHS
product over (n, k) row-major right-hand sides, does the same with
``csrc/flatdia_spmm.cu`` (kernel B7) and ``_matmat_plain``; it carries
``Stencil.matmat`` and ``FlatDIA.matmat`` on the card.  ``LAUNCHES`` counts
each kernel's launches, keyed by kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from parallel_amg_tpu_torch.ops import _build
from parallel_amg_tpu_torch.ops.stencil import bucket_add

# kernel launches made by dia_spmv (B2) and dia_spmm (B7); callers may reset
LAUNCHES = {"flatdia_spmv": 0, "flatdia_spmm": 0}

MAX_DIAGS = 192  # offsets per launch (kMaxDiags of both sources)
MAX_COLS = 8     # right-hand sides per dia_spmm launch (kMaxCols)
_SYMBOLS = {torch.float32: "flatdia_spmv_f32", torch.bfloat16: "flatdia_spmv_bf16"}
_SPMM_SYMBOLS = {torch.float32: "flatdia_spmm_f32",
                 torch.bfloat16: "flatdia_spmm_bf16"}
_INT32_LIMIT = 2**31


class _Offsets(ctypes.Structure):
    """``struct DiaOffsets`` of csrc/flatdia_spmv.cu, passed by value."""
    _fields_ = [("count", ctypes.c_int), ("off", ctypes.c_int * MAX_DIAGS)]


@functools.lru_cache(maxsize=256)
def _offsets_struct(offsets) -> _Offsets:
    s = _Offsets()
    s.count = len(offsets)
    for i, o in enumerate(offsets):
        s.off[i] = o
    return s


@functools.cache
def _kernel(symbol: str):
    fn = getattr(_build.load("flatdia_spmv"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, _Offsets,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _spmm_kernel(symbol: str):
    fn = getattr(_build.load("flatdia_spmm"), symbol)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_longlong,
                                           ctypes.c_int, _Offsets, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def dia_spmv(diags, offsets, x):
    """y = A @ x for (D, n) flattened diagonals and a float32 x of shape (n,).

    diags[d, r] multiplies x[r + offsets[d]]; columns outside [0, n) read 0.
    y is float32.
    """
    offsets = tuple(int(o) for o in offsets)
    n = x.shape[0] if x.dim() == 1 else -1
    if x.dim() != 1 or diags.dim() != 2 or tuple(diags.shape) != (len(offsets), n):
        raise ValueError(f"diags {tuple(diags.shape)}, {len(offsets)} offsets "
                         f"and x {tuple(x.shape)} do not make (D, n) and (n,)")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.device != diags.device:
        raise ValueError(f"x is on {x.device}, the diagonals on {diags.device}")
    if x.device.type == "cpu":
        return _matvec_plain(diags, offsets, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv runs on cpu or cuda, not {x.device}")
    return _matvec_cuda(diags, offsets, x)


def _matvec_plain(diags, offsets, x):
    """Plain torch y = A @ x: one padded x, one shifted slice per diagonal,
    products and sums in float32 in offset order."""
    n = x.shape[0]
    y = torch.zeros(n, dtype=torch.float32, device=x.device)
    if not offsets:
        return y
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    xp = F.pad(x, (lo, hi))
    for d, off in enumerate(offsets):
        y = y + diags[d].float() * xp[lo + off:lo + off + n]
    return y


def _matvec_cuda(diags, offsets, x):
    """Launch ``csrc/flatdia_spmv.cu`` on the current stream of x's device,
    in chunks of MAX_DIAGS planes."""
    if diags.dtype not in _SYMBOLS:
        raise TypeError(f"the kernel takes float32 or bfloat16 diagonals, "
                        f"got {diags.dtype}")
    if not (diags.is_contiguous() and x.is_contiguous()):
        raise ValueError("diags and x must be contiguous")
    if offsets and max(abs(o) for o in offsets) >= _INT32_LIMIT:
        raise ValueError("offsets do not fit the kernel's int32")
    n = x.shape[0]
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    fn = _kernel(_SYMBOLS[diags.dtype])
    step = n * diags.element_size()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for start in range(0, max(len(offsets), 1), MAX_DIAGS):
            chunk = offsets[start:start + MAX_DIAGS]
            err = fn(diags.data_ptr() + start * step, x.data_ptr(),
                     y.data_ptr(), n, _offsets_struct(chunk), int(start > 0),
                     stream)
            if err != 0:
                raise RuntimeError(f"flatdia_spmv launch failed: cudaError {err}")
            LAUNCHES["flatdia_spmv"] += 1
    return y


def dia_spmm(diags, offsets, X):
    """Y = A @ X for (D, n) flattened diagonals and a float32 X of shape
    (n, k), k right-hand sides side by side in each row.

    diags[d, r] multiplies X[r + offsets[d], :]; rows outside [0, n) read 0.
    Y is float32 (n, k).
    """
    offsets = tuple(int(o) for o in offsets)
    n = X.shape[0] if X.dim() == 2 else -1
    if X.dim() != 2 or diags.dim() != 2 or tuple(diags.shape) != (len(offsets), n):
        raise ValueError(f"diags {tuple(diags.shape)}, {len(offsets)} offsets "
                         f"and X {tuple(X.shape)} do not make (D, n) and (n, k)")
    if X.dtype != torch.float32:
        raise TypeError(f"X must be float32, got {X.dtype}")
    if X.device != diags.device:
        raise ValueError(f"X is on {X.device}, the diagonals on {diags.device}")
    if X.device.type == "cpu":
        return _matmat_plain(diags, offsets, X)
    if X.device.type != "cuda":
        raise ValueError(f"dia_spmm runs on cpu or cuda, not {X.device}")
    return _matmat_cuda(diags, offsets, X)


def _matmat_plain(diags, offsets, X):
    """Plain torch Y = A @ X: one row-padded X, one shifted row slice per
    diagonal, products and sums in float32 in offset order."""
    n, k = X.shape
    Y = torch.zeros((n, k), dtype=torch.float32, device=X.device)
    if not offsets:
        return Y
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    Xp = F.pad(X, (0, 0, lo, hi))
    for d, off in enumerate(offsets):
        Y = Y + diags[d].float()[:, None] * Xp[lo + off:lo + off + n]
    return Y


def _matmat_cuda(diags, offsets, X):
    """Launch ``csrc/flatdia_spmm.cu`` on the current stream of X's device,
    in chunks of MAX_DIAGS planes and MAX_COLS columns."""
    if diags.dtype not in _SPMM_SYMBOLS:
        raise TypeError(f"the kernel takes float32 or bfloat16 diagonals, "
                        f"got {diags.dtype}")
    if not (diags.is_contiguous() and X.is_contiguous()):
        raise ValueError("diags and X must be contiguous")
    if offsets and max(abs(o) for o in offsets) >= _INT32_LIMIT:
        raise ValueError("offsets do not fit the kernel's int32")
    n, k = X.shape
    Y = torch.empty((n, k), dtype=torch.float32, device=X.device)
    if n == 0 or k == 0:
        return Y
    fn = _spmm_kernel(_SPMM_SYMBOLS[diags.dtype])
    step = n * diags.element_size()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, k, MAX_COLS):
            kc = min(MAX_COLS, k - c0)
            for start in range(0, max(len(offsets), 1), MAX_DIAGS):
                chunk = offsets[start:start + MAX_DIAGS]
                err = fn(diags.data_ptr() + start * step, X.data_ptr() + c0 * 4,
                         Y.data_ptr() + c0 * 4, n, k, kc,
                         _offsets_struct(chunk), int(start > 0), stream)
                if err != 0:
                    raise RuntimeError(
                        f"flatdia_spmm launch failed: cudaError {err}")
                LAUNCHES["flatdia_spmm"] += 1
    return Y


class FlatDIA:
    """Flattened-diagonal operator on the hand-written CUDA SpMV.

    Drop-in for Stencil on the structured path: takes and returns N-D grid
    vectors when ``dims`` is set (the reshape is free), 1-D otherwise.

    Attributes:
      diags: (D, n) — flattened diagonals.
      offsets: tuple of 1-D (flattened) integer offsets, sorted.
      n: size; dims: optional grid shape (prod == n).
      nd_offsets: the N-D offset of each plane (for the exact way back to a
        Stencil); None when unknown or when flattening merged aliased planes.
    """

    def __init__(self, diags, offsets, n, dims=None, nd_offsets=None):
        self.diags = diags
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        self.dims = tuple(int(d) for d in dims) if dims is not None else None
        self.nd_offsets = nd_offsets

    def to(self, device) -> "FlatDIA":
        return FlatDIA(self.diags.to(device), self.offsets, self.n, self.dims,
                       self.nd_offsets)

    # -- properties -------------------------------------------------------
    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def n_rows(self) -> int:
        return self.n

    @property
    def n_points(self) -> int:
        return len(self.offsets)

    @property
    def nnz(self) -> int:
        return int((self.diags != 0).sum())

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_stencil(cls, st, dtype=None) -> "FlatDIA":
        """Flatten an N-D Stencil: offsets o → Σ o_i·s_i, planes in sorted
        flat order.  Distinct N-D offsets may alias one 1-D offset on tiny
        grids; aliased planes sum (both feed the same flattened diagonal)."""
        dims = st.dims
        strides = np.cumprod((dims[1:] + (1,))[::-1])[::-1]
        off1d = np.asarray([int(np.dot(o, strides)) for o in st.offsets],
                           np.int64)
        uoff, inv = np.unique(off1d, return_inverse=True)
        W = st.weights.reshape(st.n_points, -1)
        if dtype is not None:
            W = W.to(dtype)
        if not np.array_equal(inv, np.arange(len(off1d))):
            W = bucket_add(torch.zeros((len(uoff), st.n), dtype=W.dtype,
                                       device=W.device), inv, W)
        nd_offsets = (tuple(st.offsets[i] for i in np.argsort(inv))
                      if len(uoff) == len(off1d) else None)
        return cls(W, tuple(int(o) for o in uoff), st.n, dims, nd_offsets)

    @classmethod
    def from_dia(cls, dia, dtype=None) -> "FlatDIA":
        """From a 1-D DIA (ops/dia.py): the same banded layout."""
        W = dia.diags if dtype is None else dia.diags.to(dtype)
        return cls(W, dia.offsets, dia.n_rows, None)

    def to_stencil(self):
        """The exact N-D Stencil, or None where the way back is unknown
        (no dims, or aliased planes merged)."""
        from parallel_amg_tpu_torch.ops.stencil import Stencil

        if self.dims is None or self.nd_offsets is None:
            return None
        return Stencil(self.diags.reshape((self.n_points,) + self.dims),
                       self.nd_offsets, self.dims)

    # -- tensor ops ---------------------------------------------------------
    def matvec(self, x):
        return dia_spmv(self.diags, self.offsets, x.reshape(-1)).reshape(x.shape)

    def matmat(self, X):
        """Y = A @ X for k right-hand sides, X of shape (n, k) or (*dims, k)."""
        k = X.shape[-1]
        return dia_spmm(self.diags, self.offsets,
                        X.reshape(self.n, k).contiguous()).reshape(X.shape)

    def diagonal(self):
        if 0 in self.offsets:
            d = self.diags[self.offsets.index(0)]
        else:
            d = torch.zeros(self.n, dtype=self.diags.dtype,
                            device=self.diags.device)
        return d.reshape(self.dims) if self.dims else d

    def scale_rows(self, s):
        return FlatDIA(self.diags * s.reshape(-1)[None], self.offsets, self.n,
                       self.dims, self.nd_offsets)

    def __matmul__(self, x):
        return self.matvec(x)
