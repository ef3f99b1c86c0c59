"""SpGEMM duplicate merge (kernel B5) and the binding of ``csrc/spgemm.cu``.

Counterpart of the dedup phase of ``parallel_amg_tpu/ops/pspgemm.py``
(``_dedup_call``): per row of a candidate table, sum the values of equal
columns into the first slot that holds the column (the leader), turn every
other slot into (SENT, 0), and count the distinct columns.  ``dedup`` with
``counts_only=True`` returns the counts alone, which is how ``gather_spgemm``
sizes its output width.

``dedup`` launches ``spgemm_dedup`` from ``csrc/spgemm.cu`` on a CUDA tensor
(or raises) and runs the plain torch version ``_dedup_plain`` on a CPU tensor.
``launch`` calls the three C entries of ``csrc/spgemm.cu`` (B3, B5, B4) and
counts each one's launches in ``LAUNCHES``, keyed by symbol.

The JAX module's own product, ``pallas_spgemm`` (its TWELL-piece candidate
gather ``_gather_rows_call`` is kernel B9), is routed to the same three
kernels: B9 computes the candidate expand of C = A·B, which B3 computes on
the card.  The TWELL piece tables exist for Mosaic's in-tile gather, so
``PallasSpgemmPlan`` keeps A's ELL on its device instead.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from parallel_amg_tpu_torch.ops import _build
from parallel_amg_tpu_torch.parallel.segment import segment_sum

# kernel launches by C entry, counted in ``launch``; callers may reset them
LAUNCHES = {"spgemm_expand": 0, "spgemm_dedup": 0, "spgemm_dedup_compact": 0}

_INT32_LIMIT = 2**31
# Rows of one (rows, K, K) equality block in the plain versions.
_PLAIN_ELEMENTS = 1 << 24

_ARGTYPES = {
    "spgemm_expand": [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int,
                                              ctypes.c_int, ctypes.c_int,
                                              ctypes.c_void_p],
    "spgemm_dedup": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p],
    "spgemm_dedup_compact": [ctypes.c_void_p] * 5 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
    "spgemm_merge_scratch": [ctypes.c_int, ctypes.c_int],
    "spgemm_expand_plan": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
_RESTYPES = {"spgemm_merge_scratch": ctypes.c_longlong,
             "spgemm_expand_plan": None}

# The merge's output modes (csrc/spgemm.cu): B5 counting only, B5 in place,
# B4 compacted.
COUNT, IN_PLACE, COMPACT = 0, 1, 2
# The merge's global scratch, where a row's hash table outgrows shared memory
_SCRATCH_BYTES = 256 << 20


@functools.cache
def kernel(symbol: str):
    """The C entry ``symbol`` of ``csrc/spgemm.cu``, built on first use."""
    fn = getattr(_build.load("spgemm"), symbol)
    # pointers and the stream as c_void_p: without argtypes ctypes passes a
    # Python int as a 32-bit C int and cuts the pointer
    fn.argtypes = _ARGTYPES[symbol]
    fn.restype = _RESTYPES.get(symbol, ctypes.c_int)
    return fn


def launch(symbol: str, device, *args) -> None:
    """Call ``symbol`` on the current stream of ``device`` and count the
    launch; raise on a CUDA error code."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = kernel(symbol)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")
    LAUNCHES[symbol] += 1


def merge_scratch(R: int, K: int, mode: int, device):
    """(scratch, warps) for a merge of R rows of K slots in ``mode``:
    (None, 0) where the warps' tables fit in shared memory, else whole
    blocks of 8 warps of tables (at most one warp a row) in one buffer."""
    per_warp = kernel("spgemm_merge_scratch")(K, mode)
    if not per_warp:
        return None, 0
    warps = 8 * max(1, min(-(-R // 8), _SCRATCH_BYTES // (8 * per_warp)))
    return torch.empty(warps * per_warp, dtype=torch.uint8, device=device), warps


def check_candidates(cand_cols, cand_vals, sent: int) -> None:
    """Shapes and types the merge kernels take (and the plain versions)."""
    if cand_cols.dim() != 2 or cand_cols.shape != cand_vals.shape:
        raise ValueError(f"candidate planes {tuple(cand_cols.shape)} and "
                         f"{tuple(cand_vals.shape)} must be one (R, K) shape")
    if cand_cols.dtype != torch.int32 or cand_vals.dtype != torch.float32:
        raise TypeError("candidates must be int32 columns and float32 values")
    if cand_cols.device != cand_vals.device:
        raise ValueError("candidate planes lie on different devices")
    if not 0 <= sent < _INT32_LIMIT:
        raise ValueError(f"SENT {sent} does not fit int32")
    if cand_cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"SpGEMM runs on cpu or cuda, not {cand_cols.device}")


def merge_rows_plain(cc, cv, sent: int):
    """(leader, sums) of one block of candidate rows, plain torch.

    E[r, k, j] = (col k == col j) for valid slots; slot j leads when no
    earlier slot k < j has its column.  sums[r, j] at a leader j is the sum
    of its column's values added one after another in ascending slot order,
    as ``merge_kernel`` adds them, so the two agree bit for bit; at other
    slots it is 0.
    """
    R, K = cc.shape
    valid = cc != sent
    E = (cc[:, :, None] == cc[:, None, :]) & valid[:, :, None]
    earlier = torch.ones((K, K), dtype=torch.bool, device=cc.device).triu(1)
    leader = valid & ~(E & earlier).any(1)
    # each valid slot's leader: the first slot k with its column
    lead_of = E.to(torch.uint8).argmax(1)
    rows = torch.arange(R, device=cc.device)[:, None] * K
    ids = torch.where(valid, rows + lead_of, R * K)
    sums = segment_sum(cv, ids, R * K + 1)[: R * K].reshape(R, K)
    return leader, sums


def plain_row_blocks(R: int, K: int):
    """Row ranges whose (rows, K, K) equality blocks stay bounded."""
    step = max(_PLAIN_ELEMENTS // max(K * K, 1), 1)
    return [(r0, min(r0 + step, R)) for r0 in range(0, R, step)]


def _dedup_plain(cand_cols, cand_vals, sent: int, counts_only: bool = False):
    """Plain torch B5: an equality matrix per block of rows."""
    R, K = cand_cols.shape
    out_c = torch.empty_like(cand_cols)
    out_v = torch.empty_like(cand_vals)
    counts = torch.empty(R, dtype=torch.int32, device=cand_cols.device)
    for r0, r1 in plain_row_blocks(R, K):
        cc = cand_cols[r0:r1]
        leader, sums = merge_rows_plain(cc, cand_vals[r0:r1], sent)
        out_c[r0:r1] = torch.where(leader, cc, sent)
        out_v[r0:r1] = torch.where(leader, sums, 0.0)
        counts[r0:r1] = leader.sum(1)
    return counts if counts_only else (out_c, out_v, counts)


def _dedup_cuda(cand_cols, cand_vals, sent: int, counts_only: bool = False):
    """Launch ``spgemm_dedup`` (B5) on the current stream, with global
    scratch for the warps' tables where K needs it."""
    if not (cand_cols.is_contiguous() and cand_vals.is_contiguous()):
        raise ValueError("candidate planes must be contiguous")
    R, K = cand_cols.shape
    dev = cand_cols.device
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    out_c = out_v = None
    if not counts_only:
        out_c = torch.empty_like(cand_cols)
        out_v = torch.empty_like(cand_vals)
    scratch, warps = merge_scratch(R, K, COUNT if counts_only else IN_PLACE, dev)
    launch("spgemm_dedup", dev, cand_cols.data_ptr(), cand_vals.data_ptr(),
           None if counts_only else out_c.data_ptr(),
           None if counts_only else out_v.data_ptr(), counts.data_ptr(), R, K,
           sent, None if scratch is None else scratch.data_ptr(), warps)
    return counts if counts_only else (out_c, out_v, counts)


def dedup(cand_cols, cand_vals, sent: int, counts_only: bool = False):
    """Merge duplicate columns per row of (R, K) candidate planes.

    Returns (cols, vals, counts): leaders keep their slot and carry the sum
    of their column's values in ascending slot order; every other slot is
    (SENT, 0); counts (R,) int32 is the number of distinct columns.  With
    ``counts_only`` only the counts are computed and returned.
    """
    sent = int(sent)
    check_candidates(cand_cols, cand_vals, sent)
    if cand_cols.device.type == "cpu":
        return _dedup_plain(cand_cols, cand_vals, sent, counts_only)
    return _dedup_cuda(cand_cols, cand_vals, sent, counts_only)


class PallasSpgemmPlan:
    """The reusable left operand of ``pallas_spgemm``: A's ELL planes on
    their device (the JAX plan's TWELL piece tables have no counterpart)."""

    def __init__(self, A):
        self.A = A

    @classmethod
    def from_ell(cls, A) -> "PallasSpgemmPlan":
        return cls(A)


def pallas_spgemm(A, B, out_width: int | None = None,
                  plan: PallasSpgemmPlan | None = None):
    """C = A @ B in ELL (kernel B9's product, routed to B3 + B5 + B4).

    1. ``gspgemm.gather_candidates`` (B3) expands the candidates; products
       equal to 0 drop, as in the JAX package.
    2. Where ``out_width`` is None, B5 in count-only mode sizes it (one host
       read, the JAX package's host sync).
    3. ``gspgemm.dedup_compact`` (B4) merges and compacts; a row with more
       distinct columns than an explicit ``out_width`` keeps its first
       ``out_width`` (``row_nnz`` is clamped), as in the JAX package.

    ``plan`` (from ``PallasSpgemmPlan.from_ell(A)``) stands in for A.
    Columns come in candidate order, which may differ from the JAX package's
    piece order: compare (column, value) sets.
    """
    from parallel_amg_tpu_torch.ops.gspgemm import gather_spgemm

    left = A if plan is None else plan.A
    return gather_spgemm(left, B, out_width=out_width, strict=False)
