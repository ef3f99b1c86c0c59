"""BSR (block sparse row) format — small dense blocks for multi-DOF nodes.

Counterpart of ``parallel_amg_tpu/ops/bsr.py``.  Layout: block-ELL with a
fixed (padded) number of slots per block row, stored slot-major so that
thread r of the kernel reads slot w of its row at ``w·RB + r`` and
neighbouring threads read neighbouring words:

- ``bcols`` (WB, RB) int32 block-column ids (0 in padding slots);
- ``vals`` (WB·bs², RB) value planes, plane ``(w·bs + i)·bs + j`` holding
  entry (i, j) of the slot-w blocks (zero in padding slots);
- ``brow_nnz`` (RB,) int32 live slots per block row.

The JAX package keeps the planes as a tuple of 1-D arrays to dodge an XLA
relayout; here they are one tensor.  ``bsr_spmv`` launches kernel B6
(``csrc/bsr_spmv.cu``) on a CUDA tensor (or raises) and runs the plain torch
version ``_matvec_plain`` on a CPU tensor; ``BSR.matvec``,
``BTWELL.matvec`` and ``BTWELL.matvec_planes`` all go through it.  x and y
are passed as (block, component) views with any strides, so flat node-major
vectors and component planes both reach the kernel without a copy.
``LAUNCHES`` counts kernel launches.  Every plane offset is 64-bit
(``plane_offsets``): at 324³×3 the planes hold 2,142,770,112 elements,
0.2 % below 2^31.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from parallel_amg_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches made by bsr_spmv; callers may reset it

MAX_BS = 8  # block sizes the kernel is instantiated for (csrc kMaxBs)
_SYMBOLS = {torch.float32: "bsr_spmv_f32", torch.bfloat16: "bsr_spmv_bf16"}


@functools.cache
def _kernel(symbol: str):
    fn = getattr(_build.load("bsr_spmv"), symbol)
    fn.argtypes = ([ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def plane_offsets(slots, q, rows, n_block_rows: int, bs: int):
    """Element offsets ((slot·bs² + q)·RB + row) into the flattened value
    planes, in int64, shape (len(q), len(rows)) for (len(rows),) slots."""
    slots = torch.as_tensor(slots, dtype=torch.int64)
    rows = torch.as_tensor(rows, dtype=torch.int64)
    q = torch.as_tensor(q, dtype=torch.int64, device=rows.device)
    return (slots[None, :] * (bs * bs) + q[:, None]) * n_block_rows + rows[None, :]


def launch_args(bcols, vals, brow_nnz, xb, yb, bs: int, n_block_cols: int):
    """The kernel's argument tuple after the stream: pointers, then RB, WB,
    bs, MB and the four element strides, every size and stride as a Python
    int (passed as 64-bit ``long long``)."""
    WB, RB = bcols.shape
    return (bcols.data_ptr(), vals.data_ptr(), brow_nnz.data_ptr(),
            xb.data_ptr(), yb.data_ptr(), int(RB), int(WB), int(bs),
            int(n_block_cols), int(xb.stride(0)), int(xb.stride(1)),
            int(yb.stride(0)), int(yb.stride(1)))


def bsr_spmv(bcols, vals, brow_nnz, bs: int, xb, out=None):
    """y = A @ x on block views: xb (MB, bs) float32, y (RB, bs) float32.

    xb and ``out`` may have any strides (component planes are the transposed
    view of a (bs, n) tensor).  Returns ``out`` when given.
    """
    WB, RB = bcols.shape
    if tuple(vals.shape) != (WB * bs * bs, RB) or tuple(brow_nnz.shape) != (RB,):
        raise ValueError(f"bcols {tuple(bcols.shape)}, vals {tuple(vals.shape)} "
                         f"and brow_nnz {tuple(brow_nnz.shape)} do not make a "
                         f"block-ELL of {bs}x{bs} blocks")
    if xb.dim() != 2 or xb.shape[1] != bs:
        raise ValueError(f"x must be (block columns, {bs}), got {tuple(xb.shape)}")
    if xb.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {xb.dtype}")
    if out is not None and (tuple(out.shape) != (RB, bs) or out.dtype != torch.float32):
        raise ValueError(f"out must be float32 ({RB}, {bs})")
    if xb.device != vals.device:
        raise ValueError(f"x is on {xb.device}, the blocks on {vals.device}")
    if xb.device.type == "cpu":
        y = _matvec_plain(bcols, vals, bs, xb)
        return y if out is None else out.copy_(y)
    if xb.device.type != "cuda":
        raise ValueError(f"bsr_spmv runs on cpu or cuda, not {xb.device}")
    return _matvec_cuda(bcols, vals, brow_nnz, bs, xb, out)


def _matvec_plain(bcols, vals, bs: int, xb):
    """Plain torch y = A @ x: per slot one gather of the bs components, then
    bs² products added in slot, row, column order (the JAX package's
    ``BSR.matvec``).  Padding slots hold zero blocks, so they add nothing."""
    WB, RB = bcols.shape
    acc = [torch.zeros(RB, dtype=torch.float32, device=xb.device)
           for _ in range(bs)]
    for w in range(WB):
        g = xb[bcols[w].long()]
        for i in range(bs):
            for j in range(bs):
                acc[i] = acc[i] + vals[(w * bs + i) * bs + j].float() * g[:, j]
    return torch.stack(acc, dim=1) if bs else torch.zeros((RB, 0))


def _matvec_cuda(bcols, vals, brow_nnz, bs: int, xb, out):
    """Launch ``csrc/bsr_spmv.cu`` on the current stream of x's device."""
    global LAUNCHES
    if vals.dtype not in _SYMBOLS:
        raise TypeError(f"the kernel takes float32 or bfloat16 blocks, got {vals.dtype}")
    if bcols.dtype != torch.int32 or brow_nnz.dtype != torch.int32:
        raise TypeError("bcols and brow_nnz must be int32")
    if not (bcols.is_contiguous() and vals.is_contiguous()
            and brow_nnz.is_contiguous()):
        raise ValueError("bcols, vals and brow_nnz must be contiguous")
    if not 1 <= bs <= MAX_BS:
        raise ValueError(f"the kernel takes 1 <= bs <= {MAX_BS}, got {bs}")
    RB = bcols.shape[1]
    y = out if out is not None else torch.empty((RB, bs), dtype=torch.float32,
                                                device=xb.device)
    if RB == 0:
        return y
    fn = _kernel(_SYMBOLS[vals.dtype])
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*launch_args(bcols, vals, brow_nnz, xb, y, bs, xb.shape[0]),
                 stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmv launch failed: cudaError {err}")
    LAUNCHES += 1
    return y


class BSR:
    """Block-ELL sparse matrix with square bs×bs blocks (module docstring)."""

    def __init__(self, bcols, vals, brow_nnz, shape, bs):
        self.bcols = bcols        # (WB, RB) int32
        self.vals = vals          # (WB·bs², RB)
        self.brow_nnz = brow_nnz  # (RB,) int32
        self.shape = tuple(int(s) for s in shape)  # element shape (n, m)
        self.bs = int(bs)

    def to(self, device):
        return type(self)(self.bcols.to(device), self.vals.to(device),
                          self.brow_nnz.to(device), self.shape, self.bs)

    # -- properties -------------------------------------------------------
    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_block_rows(self) -> int:
        return int(self.bcols.shape[1])

    @property
    def n_block_cols(self) -> int:
        return -(-self.shape[1] // self.bs)

    @property
    def width(self) -> int:
        return int(self.bcols.shape[0])

    @property
    def nnz(self) -> int:
        """Nonzero blocks × bs² (the JAX package's count)."""
        bs2 = self.bs * self.bs
        nz = (self.vals.reshape(self.width, bs2, -1) != 0).any(dim=1)
        return int(nz.sum()) * bs2

    @property
    def vals_nbytes(self) -> int:
        return self.vals.numel() * self.vals.element_size()

    # -- construction (host) ----------------------------------------------
    @classmethod
    def from_csr(cls, csr, bs: int, dtype=None) -> "BSR":
        """Build from host CSR (rows/cols padded up to bs multiples); the
        blocks of a row keep ascending block-column order."""
        dtype = dtype or torch.float32
        n, m = csr.shape
        RB, MB = -(-n // bs), -(-m // bs)
        rows = np.repeat(np.arange(n), csr.row_nnz)
        cols = np.asarray(csr.indices, np.int64)
        key = (rows // bs) * MB + cols // bs
        ukey, inv = np.unique(key, return_inverse=True)
        ubr, ubc = ukey // MB, ukey % MB
        blocks = np.zeros((len(ukey), bs, bs))
        np.add.at(blocks, (inv.reshape(-1), rows % bs, cols % bs), csr.data)
        counts = np.bincount(ubr, minlength=RB)
        WB = max(int(counts.max()), 1) if len(ukey) else 1
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot = np.arange(len(ukey)) - starts[ubr]  # ukey is sorted by row
        bcols = np.zeros((WB, RB), np.int32)
        vals = np.zeros((WB, bs, bs, RB))
        bcols[slot, ubr] = ubc
        vals[slot, :, :, ubr] = blocks
        return cls(torch.from_numpy(bcols),
                   torch.from_numpy(vals.reshape(WB * bs * bs, RB)).to(dtype),
                   torch.from_numpy(counts.astype(np.int32)), (n, m), bs)

    def to_csr(self):
        from parallel_amg_tpu_torch.ops.coo import COO

        bs = self.bs
        bcols = self.bcols.cpu().numpy().astype(np.int64)
        vals = self.vals.detach().cpu().float().numpy().astype(np.float64)
        vals = vals.reshape(self.width, bs, bs, -1)
        live = np.arange(self.width)[:, None] < self.brow_nnz.cpu().numpy()[None]
        w, r = np.nonzero(live)
        blocks = vals[w, :, :, r]                      # (nb, bs, bs)
        b, i, j = np.nonzero(blocks)
        rs = r[b] * bs + i
        cs = bcols[w[b], r[b]] * bs + j
        vs = blocks[b, i, j]
        keep = (rs < self.shape[0]) & (cs < self.shape[1])
        return COO(rs[keep], cs[keep], vs[keep], self.shape).to_csr()

    # -- tensor ops ---------------------------------------------------------
    def _x_blocks(self, x):
        """Flat node-major x as a (MB, bs) view (zero-padded to whole
        blocks where the column count is not a multiple of bs)."""
        need = self.n_block_cols * self.bs
        if x.shape[0] != need:
            x = torch.nn.functional.pad(x, (0, need - x.shape[0]))
        return x.reshape(self.n_block_cols, self.bs)

    def matvec(self, x):
        """y = A @ x for a flat node-major float32 x (kernel B6 on the card)."""
        y = bsr_spmv(self.bcols, self.vals, self.brow_nnz, self.bs,
                     self._x_blocks(x))
        return y.reshape(-1)[: self.shape[0]]

    def diagonal(self):
        """Main diagonal (block row == block column, component c)."""
        bs = self.bs
        RB = self.n_block_rows
        r = torch.arange(RB, dtype=self.bcols.dtype, device=self.bcols.device)
        cols = []
        for i in range(bs):
            d = torch.zeros(RB, dtype=self.vals.dtype, device=self.vals.device)
            for w in range(self.width):
                hit = (self.bcols[w] == r).to(d.dtype)
                d = d + hit * self.vals[(w * bs + i) * bs + i]
            cols.append(d)
        return torch.stack(cols, dim=1).reshape(-1)[: self.shape[0]]

    def __matmul__(self, x):
        return self.matvec(x)
