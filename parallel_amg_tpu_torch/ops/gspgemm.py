"""Rank-plane SpGEMM C = A·B for ELL operands: expand (B3), merge (B5),
merge-and-compact (B4).

Counterpart of ``parallel_amg_tpu/ops/gspgemm.py``.  The product runs in
three steps over a (R, K) candidate table, K = Wa·Wb:

1. ``gather_candidates`` (kernel B3): slot m·Wa + k of row r holds
   A[r, k]·B[A.cols[r, k], m] and its column, or (SENT, 0) where the slot
   is padding or the product is 0 (SENT = B's column count).
2. ``pspgemm.dedup`` in count-only mode (kernel B5): the distinct columns
   per row, whose maximum is the output width (one host read).
3. ``dedup_compact`` (kernel B4): duplicate columns summed into their first
   slot, leaders compacted to the front in slot order.

The JAX package's ``GatherSpgemmPlan`` and its piece tables re-bucket A by
128-column window for Mosaic's in-tile gather; a Hopper thread loads any
address, so the kernel reads A's ELL planes directly and there is no plan.
Its tiling (``expand_plan``) follows from Wa and Wb alone: a block stages
whole rows of the candidate planes in shared memory and stores them as one
contiguous run per plane.

Each wrapper launches its kernel from ``csrc/spgemm.cu`` on a CUDA tensor (or
raises) and runs its plain torch version on a CPU tensor;
``pspgemm.LAUNCHES`` counts the launches.  ``gather_spgemm`` leaves C's
columns in first-occurrence order; ``esc_spgemm`` (the setups' product,
``ell_setup.ell_spgemm``) reorders the candidates k-major first, so each
entry adds its products in the JAX package's ESC order, and sorts each
row.  Explicit zeros drop.
"""

from __future__ import annotations

import ctypes

import torch

from parallel_amg_tpu_torch.ops import pspgemm
from parallel_amg_tpu_torch.ops.ell import ELL


def _check_operands(A: ELL, B: ELL) -> None:
    if A.n_cols != B.n_rows:
        raise ValueError(f"A {A.shape} @ B {B.shape}: inner sizes differ")
    for name, M in (("A", A), ("B", B)):
        if M.cols.dtype != torch.int32 or M.row_nnz.dtype != torch.int32:
            raise TypeError(f"{name} needs int32 columns and row lengths")
        if M.vals.dtype != torch.float32:
            raise TypeError(f"{name} needs float32 values, got {M.vals.dtype}")
        for t in (M.cols, M.vals, M.row_nnz):
            if t.device != A.cols.device:
                raise ValueError("A and B must lie on one device")
    if max(B.n_cols, A.width * B.width) >= 2**31:
        raise ValueError("SENT and K must fit int32")


def _gather_candidates_plain(A: ELL, B: ELL):
    """Plain torch B3: a gather of B's rows and a permute to m-major order."""
    R, Wa = A.cols.shape
    K = Wa * B.width
    c = A.cols.long()
    v = A.vals[:, :, None] * B.vals[c]                       # (R, Wa, Wb)
    ok = A.mask()[:, :, None] & B.mask()[c] & (v != 0)
    cols = torch.where(ok, B.cols[c], B.n_cols)
    vals = torch.where(ok, v, 0.0)
    return (cols.transpose(1, 2).reshape(R, K).contiguous(),
            vals.transpose(1, 2).reshape(R, K).contiguous())


def _gather_candidates_cuda(A: ELL, B: ELL):
    """Launch ``spgemm_expand`` (B3) on the current stream."""
    planes = (A.cols, A.vals, A.row_nnz, B.cols, B.vals, B.row_nnz)
    if not all(t.is_contiguous() for t in planes):
        raise ValueError("ELL planes must be contiguous")
    R, Wa = A.cols.shape
    K = Wa * B.width
    dev = A.cols.device
    cols = torch.empty((R, K), dtype=torch.int32, device=dev)
    vals = torch.empty((R, K), dtype=torch.float32, device=dev)
    pspgemm.launch("spgemm_expand", dev, *(t.data_ptr() for t in planes),
                   cols.data_ptr(), vals.data_ptr(), R, Wa, B.width, B.n_cols)
    return cols, vals


_PLAN_KEYS = ("rows_per_tile", "m_per_tile", "k_per_tile", "m_per_item",
              "b_load_words", "stage_bytes")


def expand_plan(Wa: int, Wb: int) -> dict:
    """B3's tiling for A's width Wa and B's width Wb, as ``spgemm_expand``
    chooses it (``csrc/spgemm.cu::expand_plan``): rows, m and k a tile, m a
    work item, B's load width and the staging bytes of a buffer.  Builds the
    library with nvcc on first use."""
    out = (ctypes.c_longlong * len(_PLAN_KEYS))()
    pspgemm.kernel("spgemm_expand_plan")(int(Wa), int(Wb), out)
    return dict(zip(_PLAN_KEYS, out))


def gather_candidates(A: ELL, B: ELL):
    """(R, Wa·Wb) candidate (cols, vals) of A·B; cols == SENT = B.n_cols on
    empty slots."""
    _check_operands(A, B)
    if A.cols.device.type == "cpu":
        return _gather_candidates_plain(A, B)
    if A.cols.device.type != "cuda":
        raise ValueError(f"SpGEMM runs on cpu or cuda, not {A.cols.device}")
    return _gather_candidates_cuda(A, B)


def compact_merged(cols, vals, sent: int, out_width: int):
    """B5's in-place merge (leaders in their slots, (SENT, 0) elsewhere)
    compacted to B4's layout: leaders to slots 0.. in slot order up to
    ``out_width``, zeros after them, and the uncapped counts."""
    R = cols.shape[0]
    dev = cols.device
    leader = cols != sent
    pos = leader.int().cumsum(1) - 1
    slot = torch.where(leader & (pos < out_width), pos, out_width).long()
    buf_c = torch.zeros((R, out_width + 1), dtype=torch.int32, device=dev)
    buf_v = torch.zeros((R, out_width + 1), dtype=torch.float32, device=dev)
    buf_c.scatter_(1, slot, torch.where(leader, cols, 0))  # a trash column
    buf_v.scatter_(1, slot, torch.where(leader, vals, 0.0))  # takes the rest
    return (buf_c[:, :out_width].contiguous(), buf_v[:, :out_width].contiguous(),
            leader.sum(1, dtype=torch.int32))


def _dedup_compact_plain(cand_cols, cand_vals, sent: int, out_width: int):
    """Plain torch B4: the equality-matrix merge, then leaders scattered to
    their rank."""
    cols, vals, _ = pspgemm._dedup_plain(cand_cols, cand_vals, sent)
    return compact_merged(cols, vals, sent, out_width)


def _dedup_compact_cuda(cand_cols, cand_vals, sent: int, out_width: int):
    """Launch ``spgemm_dedup_compact`` (B4) on the current stream, with
    global scratch for the warps' tables where K needs it."""
    if not (cand_cols.is_contiguous() and cand_vals.is_contiguous()):
        raise ValueError("candidate planes must be contiguous")
    R, K = cand_cols.shape
    dev = cand_cols.device
    out_c = torch.empty((R, out_width), dtype=torch.int32, device=dev)
    out_v = torch.empty((R, out_width), dtype=torch.float32, device=dev)
    counts = torch.empty(R, dtype=torch.int32, device=dev)
    scratch, warps = pspgemm.merge_scratch(R, K, pspgemm.COMPACT, dev)
    pspgemm.launch("spgemm_dedup_compact", dev, cand_cols.data_ptr(),
                   cand_vals.data_ptr(), out_c.data_ptr(), out_v.data_ptr(),
                   counts.data_ptr(), R, K, out_width, sent,
                   None if scratch is None else scratch.data_ptr(), warps)
    return out_c, out_v, counts


def dedup_compact(cand_cols, cand_vals, sent: int, out_width: int):
    """Merge duplicate columns per row and compact the leaders to the front.

    Returns (cols, vals) of shape (R, out_width), leaders in slot order with
    zeros after them, and (R,) int32 counts of distinct columns, uncapped: a
    row whose count exceeds ``out_width`` keeps its first ``out_width``
    leaders.
    """
    sent, out_width = int(sent), int(out_width)
    pspgemm.check_candidates(cand_cols, cand_vals, sent)
    if not 1 <= out_width < 2**31:
        raise ValueError(f"out_width {out_width} must be a positive int32")
    if cand_cols.device.type == "cpu":
        return _dedup_compact_plain(cand_cols, cand_vals, sent, out_width)
    return _dedup_compact_cuda(cand_cols, cand_vals, sent, out_width)


def _product(A: ELL, B: ELL, out_width, strict, expand, count, compact,
             sort=False) -> ELL:
    """C = A @ B from its three steps: ``expand`` (B3), ``count`` (B5's
    counts, for the width unless ``out_width`` is given), ``compact`` (B4);
    with ``sort``, each row's entries then sorted by column."""
    sent = B.n_cols
    cand_c, cand_v = expand(A, B)
    explicit = out_width is not None
    if not explicit:
        counts = count(cand_c, cand_v, sent, counts_only=True)
        out_width = max(int(counts.max()) if counts.numel() else 0, 1)
    cols, vals, counts = compact(cand_c, cand_v, sent, out_width)
    if explicit and strict and counts.numel():
        worst = int(counts.max())
        if worst > out_width:
            raise ValueError(
                f"gather_spgemm: out_width={out_width} < max distinct columns "
                f"{worst}; entries would be dropped (pass strict=False to clamp)")
    nnz = torch.clamp(counts, max=out_width)
    if sort:
        cols, vals = sort_rows(cols, vals, nnz, sent)
    return ELL(cols, vals, nnz, (A.n_rows, B.n_cols))


def sort_rows(cols, vals, nnz, sent: int):
    """Each row's first ``nnz`` (distinct) columns sorted, values with
    them; the padding stays (0, 0)."""
    live = torch.arange(cols.shape[1], device=cols.device)[None, :] < nnz[:, None]
    key, order = torch.sort(torch.where(live, cols, sent), dim=1)
    return torch.where(live, key, 0), vals.gather(1, order)


def gather_spgemm(A: ELL, B: ELL, out_width: int | None = None,
                  strict: bool = True) -> ELL:
    """C = A @ B in ELL: B3, then B5's counts for the width (one host read)
    unless ``out_width`` is given, then B4.

    An explicit ``out_width`` below a row's count of distinct columns raises
    with ``strict=True`` (one host read); ``strict=False`` keeps each such
    row's first ``out_width`` columns.
    """
    return _product(A, B, out_width, strict, gather_candidates, pspgemm.dedup,
                    dedup_compact)


def k_major(cand_cols, cand_vals, Wa: int, Wb: int):
    """B3's candidate table reordered from its slot order m·Wa + k to
    k·Wb + m, A's entry first, as the JAX package's ESC products lay it
    out; B4 then sums each column's products in the order of A's entries."""
    perm = (torch.arange(Wb, device=cand_cols.device)[None, :] * Wa
            + torch.arange(Wa, device=cand_cols.device)[:, None]).reshape(-1)
    return cand_cols[:, perm].contiguous(), cand_vals[:, perm].contiguous()


def _k_major_candidates(A: ELL, B: ELL):
    return k_major(*gather_candidates(A, B), A.width, B.width)


def esc_spgemm(A: ELL, B: ELL, out_width: int | None = None,
               strict: bool = True, sort: bool = True) -> ELL:
    """C = A @ B with each entry's products added in the order of the JAX
    package's ESC ``ell_spgemm`` on its CPU backend, so bit-equal to it:
    B3's candidates reordered ``k_major``, then B5's counts and B4's merge
    as in ``gather_spgemm``; with ``sort`` each row is then sorted by
    column, that product's layout (a caller that re-sorts the rows itself,
    as ``ell_prune`` does, skips it).  ``out_width`` and ``strict`` as in
    ``gather_spgemm``: a clamped row keeps its first columns in k-major
    order."""
    return _product(A, B, out_width, strict, _k_major_candidates,
                    pspgemm.dedup, dedup_compact, sort)


def plain_spgemm(A: ELL, B: ELL, out_width: int | None = None,
                 strict: bool = True) -> ELL:
    """``gather_spgemm`` by the plain torch versions of its three steps, on
    any device."""
    _check_operands(A, B)
    if out_width is not None and not 1 <= int(out_width) < 2**31:
        raise ValueError(f"out_width {out_width} must be a positive int32")
    return _product(A, B, out_width, strict, _gather_candidates_plain,
                    pspgemm._dedup_plain, _dedup_compact_plain)
