"""Carry a hierarchy built elsewhere into the port.

The JAX package's checkpoints pickle a jax treedef and cannot be read without
jax, so a hierarchy crosses over as plain arrays: per level, A, P and R plus
``d_inv`` and ``lam_max`` as numpy arrays.  An operator is either a scipy
matrix (``to_csr().to_scipy()`` of an algebraic level; it goes through
``best_format``) or a mapping with a ``format`` key:

- ``{"format": "Stencil", "weights": (D, *dims), "offsets", "dims"}``;
- ``{"format": "FlatDIA", "diags": (D, ≥n), "offsets", "n", "dims",
  "nd_offsets"}`` (columns past n, the JAX package's tile padding, are
  dropped);
- ``{"format": "BlockProlongator" | "BlockRestrictor", "scale": (*cdims,),
  "coef", "dims", "cdims", "block"}``, a linked block transfer that borrows
  the level's A and d_inv;
- ``{"format": "ELL", "cols": (R, W), "vals": (R, W), "row_nnz": (R,),
  "shape"}``, carried over unconverted (the levels of an on-device
  Ruge–Stüben setup);
- ``{"format": "BSR", "bcols": (RB, WB), "vals": (WB·bs², RB),
  "brow_nnz": (RB,), "shape", "bs", "node_dims"}``: the JAX package's
  block-ELL (its tuple of value planes stacked), stored slot-major; with
  ``node_dims`` it is the grid-layout fine level of a vector hierarchy;
- ``{"format": "BlockStencil", "weights": (D, *node_dims), "offsets",
  "dims", "C": (bs, bs)}``;
- ``{"format": "VectorBlockProlongator" | "VectorBlockRestrictor", "L",
  "d_inv_L", "scale", "coef", "dims", "cdims", "block", "bs"}``, with ``L``
  a Stencil mapping and ``d_inv_L`` its diagonal inverse where the level is
  BSR, or both None for a transfer linked to a BlockStencil level;
- ``{"format": "ShardedStencil", "weights": (D, d0p, *rest), "offsets",
  "dims", "halo_mode"}``: one global array of weight planes over the padded
  dims, split into the parts of ``mesh``;
- ``{"format": "SBlockProlongator" | "SBlockRestrictor", "scale": (*cdims,),
  "coef", "dims", "cdims", "block", "true_d0"}``, a linked sharded block
  transfer over padded dims (``scale`` split over the mesh);
- ``{"format": "SBoundaryProlongator" | "SBoundaryRestrictor", "inner": an
  SBlock mapping, "true_cdims"}``, a transfer across the agglomeration
  boundary.

A level whose A is a ShardedStencil takes its ``d_inv`` over the padded
dims and splits it over the mesh, and may carry ``true_n``.  The levels
below a distributed hierarchy's agglomeration boundary, and the coarse
inverse, go to the mesh's ``home`` device.

``pcsr_from_numpy`` turns the arrays of a row-partitioned PCSR (the JAX
package's, as numpy) into the port's, so that one operator can feed both
packages and one setup stage be compared at a time.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.amg.transfers import BlockProlongator, BlockRestrictor
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.device import resolve_device
from parallel_amg_tpu_torch.ops.bsr import BSR
from parallel_amg_tpu_torch.ops.bstencil import (
    BlockStencil,
    BSRGridOperator,
    VectorBlockProlongator,
    VectorBlockRestrictor,
)
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
from parallel_amg_tpu_torch.ops.select import best_format
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.parallel.pdevice_setup import (
    SBoundaryProlongator,
    SBoundaryRestrictor,
)
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.parallel.pstructured import (
    SBlockProlongator,
    SBlockRestrictor,
)

_TRANSFERS = {"BlockProlongator": BlockProlongator,
              "BlockRestrictor": BlockRestrictor}
_VECTOR_TRANSFERS = {"VectorBlockProlongator": VectorBlockProlongator,
                     "VectorBlockRestrictor": VectorBlockRestrictor}
_SBLOCK = {"SBlockProlongator": SBlockProlongator,
           "SBlockRestrictor": SBlockRestrictor}
_SBOUNDARY = {"SBoundaryProlongator": SBoundaryProlongator,
              "SBoundaryRestrictor": SBoundaryRestrictor}
_SHARDED = {"ShardedStencil", *_SBLOCK, *_SBOUNDARY}


def _tensor(a, dtype):
    return torch.from_numpy(np.array(a, np.float64)).to(dtype)


def _coef(spec, dtype) -> float:
    return float(torch.tensor(float(np.asarray(spec["coef"])),
                              dtype=torch.float64).to(dtype))


def _operator(spec, dtype):
    if spec is None:
        return None
    if not isinstance(spec, Mapping):
        return best_format(CSR.from_scipy(spec), dtype=dtype)
    fmt = spec["format"]
    if fmt == "Stencil":
        return Stencil(_tensor(spec["weights"], dtype), spec["offsets"],
                       spec["dims"])
    if fmt == "FlatDIA":
        n = int(spec["n"])
        nd = spec.get("nd_offsets")
        return FlatDIA(_tensor(np.asarray(spec["diags"])[:, :n], dtype),
                       spec["offsets"], n, spec.get("dims"),
                       None if nd is None else tuple(tuple(o) for o in nd))
    if fmt == "ELL":
        return ELL(torch.from_numpy(np.array(spec["cols"], np.int32)),
                   _tensor(spec["vals"], dtype),
                   torch.from_numpy(np.array(spec["row_nnz"], np.int32)),
                   spec["shape"])
    if fmt in _TRANSFERS:
        return _TRANSFERS[fmt](None, None, _tensor(spec["scale"], dtype),
                               _coef(spec, dtype), spec["dims"], spec["cdims"],
                               spec["block"])
    if fmt == "BSR":
        bsr = BSR(torch.from_numpy(np.array(spec["bcols"], np.int32).T.copy()),
                  _tensor(spec["vals"], dtype),
                  torch.from_numpy(np.array(spec["brow_nnz"], np.int32)),
                  spec["shape"], spec["bs"])
        dims = spec.get("node_dims")
        return bsr if dims is None else BSRGridOperator(bsr, dims)
    if fmt == "BlockStencil":
        return BlockStencil(_tensor(spec["weights"], dtype), spec["offsets"],
                            spec["dims"], _tensor(spec["C"], dtype))
    if fmt in _VECTOR_TRANSFERS:
        d_inv_L = spec.get("d_inv_L")
        return _VECTOR_TRANSFERS[fmt](
            _operator(spec.get("L"), dtype),
            None if d_inv_L is None else _tensor(d_inv_L, dtype),
            _tensor(spec["scale"], dtype), _coef(spec, dtype), spec["dims"],
            spec["cdims"], spec["block"], spec["bs"])
    raise ValueError(f"unknown operator format {fmt!r}")


def _sharded(spec, dtype, mesh):
    """A ShardedStencil, SBlock or SBoundary transfer on ``mesh``."""
    fmt = spec["format"]
    if mesh is None:
        raise ValueError(f"a {fmt} level needs a mesh")
    if fmt == "ShardedStencil":
        return ShardedStencil.from_global(
            _tensor(spec["weights"], dtype), spec["offsets"], spec["dims"],
            mesh, spec.get("halo_mode", "xla"))
    if fmt in _SBLOCK:
        return _SBLOCK[fmt](None, None, PGrid.from_global(
            _tensor(spec["scale"], dtype), mesh), _coef(spec, dtype),
            spec["dims"], spec["cdims"], spec["block"], mesh,
            spec.get("true_d0"))
    return _SBOUNDARY[fmt](_sharded(spec["inner"], dtype, mesh),
                           spec["true_cdims"])


def _is_sharded(spec) -> bool:
    return isinstance(spec, Mapping) and spec["format"] in _SHARDED


def hierarchy_from_numpy(levels: Sequence[Mapping], coarse_inv,
                         config: AMGConfig, *, device=None,
                         dtype=torch.float32, mesh=None) -> Hierarchy:
    """Build a :class:`Hierarchy` on ``device`` (the CUDA card when None)
    from host arrays.

    Args:
      levels: one mapping per level with keys ``A``, ``P``, ``R`` (see the
        module docstring; ``P``/``R`` None on the coarsest level), ``d_inv``
        and ``lam_max`` (numpy; ``d_inv`` N-D on a grid level), and
        optionally ``true_n``.
      coarse_inv: (n_c, n_c) dense inverse of the coarsest operator.
      mesh: the row mesh of a distributed hierarchy's sharded levels; its
        ``home`` device then holds the rest, and ``device`` is not read.
    """
    dev = resolve_device(device) if mesh is None else mesh.home
    out = []
    for l in levels:
        lam = float(torch.as_tensor(np.asarray(l["lam_max"], np.float64)).to(dtype))
        if _is_sharded(l["A"]):
            ops = [None if l[k] is None else _sharded(l[k], dtype, mesh)
                   for k in ("A", "P", "R")]
            d_inv = PGrid.from_global(_tensor(l["d_inv"], dtype), mesh)
            out.append(Level(*ops, d_inv, lam, l.get("true_n")))
        else:
            out.append(Level(_operator(l["A"], dtype), _operator(l["P"], dtype),
                             _operator(l["R"], dtype), _tensor(l["d_inv"], dtype),
                             lam, l.get("true_n")).to(dev))
    inv = torch.from_numpy(np.array(coarse_inv)).to(torch.float32).to(dev)
    return Hierarchy(out, inv, config)


def _partition(p):
    """A Partition from an object with n_global/n_shards/rows_per_shard or
    a (n_global, n_shards, rows_per_shard) tuple."""
    from parallel_amg_tpu_torch.parallel.partition import Partition

    if isinstance(p, Sequence):
        return Partition(*(int(v) for v in p))
    return Partition(int(p.n_global), int(p.n_shards), int(p.rows_per_shard))


def pcsr_from_numpy(arrays: Mapping, mesh, dtype=torch.float32):
    """A :class:`~parallel_amg_tpu_torch.parallel.pcsr.PCSR` on ``mesh`` from
    host arrays.

    ``arrays`` maps ``diag_cols``/``diag_vals`` (S, m, Wd),
    ``off_cols``/``off_vals`` (S, m, Wo), ``send_idx`` (S, S, C),
    ``recv_map`` (S, G), ``row_partition`` and ``col_partition`` (objects
    with ``n_global``, ``n_shards`` and ``rows_per_shard``, or such tuples)
    and ``true_shape``.  A mapping that also has ``nb_offsets`` gets the ring
    plan of ``with_neighbor_plan``, which derives from the dense plan.
    """
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR

    A = PCSR.from_planes(
        np.asarray(arrays["diag_cols"]), np.asarray(arrays["diag_vals"]),
        np.asarray(arrays["off_cols"]), np.asarray(arrays["off_vals"]),
        np.asarray(arrays["send_idx"]), np.asarray(arrays["recv_map"]), mesh,
        _partition(arrays["row_partition"]), _partition(arrays["col_partition"]),
        tuple(arrays["true_shape"]), dtype=dtype)
    if arrays.get("nb_offsets") is not None:
        A = A.with_neighbor_plan()
    return A
