"""Distributed hierarchy setup: freeze a hierarchy into PCSR levels.

Counterpart of ``parallel_amg_tpu/parallel/psetup.py``.  The resulting
:class:`~parallel_amg_tpu_torch.amg.hierarchy.Hierarchy` holds PCSR
operators and PGrid vectors, and runs through the same cycle and Krylov code
as the single-device path (format polymorphism over ``.matvec``).

Levels at or below ``config.agglomerate_n`` rows are agglomerated: one
plain operator from ``ops/select.py::best_format`` (DIA on kernel B2 or
TWELL on kernel B1) replicated on every process, on its parts' device
(``mesh.home``), as the JAX package replicates it on every device; the
sub-hierarchy below the boundary then runs as a plain single-device program
on each process.  ``ReshardedTransfer`` moves vectors across the boundary,
as ``pdevice_setup.SBoundaryProlongator``/``SBoundaryRestrictor`` do on the
structured path.
"""

from __future__ import annotations

from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from parallel_amg_tpu_torch.amg.hierarchy import (
    Hierarchy,
    Level,
    _host_scipy,
    coarse_inverse_np,
)
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.select import best_format
from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.partition import uniform_row_partition
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pvector import pvector


class ReshardedTransfer:
    """Transfer operator across the split↔agglomerated boundary.

    Wraps a small plain operator T, replicated on every process's
    ``mesh.home``.  ``out="replicated"`` (restriction): the split fine
    residual is gathered there (``exchange.all_gather``), its padding cut,
    and T applied — a tensor.  ``out="rows"`` (prolongation): T, whose rows
    are padded to the fine partition, maps the coarse correction to a vector
    split back over the mesh — a PGrid of this process's parts.
    """

    def __init__(self, T, mesh, out: str):
        if out not in ("replicated", "rows"):
            raise ValueError(f"out must be replicated|rows, got {out!r}")
        self.T = T
        self.mesh = mesh
        self.out = out

    @property
    def shape(self):
        return self.T.shape

    def zeros_coarse(self, dtype):
        """The coarse iterate below the boundary: a tensor on
        ``mesh.home``."""
        return torch.zeros(self.T.shape[1], dtype=dtype, device=self.mesh.home)

    def matvec(self, v):
        if self.out == "replicated":
            x = v.to_global(self.mesh.home)[: self.T.shape[1]]
            return self.T.matvec(x.contiguous())
        return PGrid.from_global(self.T.matvec(v), self.mesh)

    def __matmul__(self, v):
        return self.matvec(v)


def with_neighbor_plans(h: Hierarchy) -> Hierarchy:
    """Switch every PCSR operator of the hierarchy to the ring exchange plan
    (``PCSR.with_neighbor_plan``)."""
    def conv(T):
        return T.with_neighbor_plan() if isinstance(T, PCSR) else T

    levels = [Level(conv(l.A), conv(l.P), conv(l.R), l.d_inv, l.lam_max,
                    true_n=l.true_n) for l in h.levels]
    out = Hierarchy(levels, h.coarse_inv, h.config)
    out.setup_stats = h.setup_stats
    return out


def oracle_arrays(oh):
    """Every array of an oracle hierarchy's levels (A, P, R, D⁻¹, λ_max)."""
    out = []
    for l in oh.levels:
        for M in (l.A, l.P, l.R):
            if M is not None:
                M = M.tocsr()
                out += [M.indptr, M.indices, M.data]
        out += [np.asarray(l.d_inv), np.float64(l.lam_max)]
    return out


def _plain(M, dtype, device):
    return best_format(CSR.from_scipy(M.tocsr()), dtype=dtype).to(device)


def distributed_setup(A, config: AMGConfig, mesh, dtype=torch.float32,
                      seed: int = 0) -> Hierarchy:
    """Setup → distributed PCSR hierarchy on ``mesh``.

    ``config.on_device_setup=True`` runs ``distributed_rs_setup`` or
    ``distributed_sa_setup`` on the parts' devices (from a PCSR, or a host
    matrix partitioned here with ``PCSR.from_csr``).  Otherwise the float64
    host oracle builds the levels and each is frozen: A as a square PCSR
    (identity padding), P/R as rectangular PCSRs between the fine and coarse
    row partitions, D⁻¹ as a PGrid; levels with ≤ ``config.agglomerate_n``
    rows (never the finest) become plain operators replicated on every
    process behind ``ReshardedTransfer`` boundary transfers.  Each process
    runs the oracle on the (replicated) host matrix and keeps its parts.  Every PCSR gets the
    ring exchange plan.
    """
    if config.on_device_setup:
        if config.coarsening == "rs":
            from parallel_amg_tpu_torch.parallel.prs_setup import (
                distributed_rs_setup as setup_fn,
            )
        else:
            from parallel_amg_tpu_torch.parallel.psa_setup import (
                distributed_sa_setup as setup_fn,
            )
        A_p = A if isinstance(A, PCSR) else PCSR.from_csr(
            sp.csr_matrix(_host_scipy(A)), mesh, dtype=dtype)
        return with_neighbor_plans(setup_fn(A_p, config, dtype=dtype, seed=seed))

    from parallel_amg_tpu_torch.oracle.serial_amg import oracle_setup

    oh = oracle_setup(_host_scipy(A), config, seed=seed)
    exchange.check_replicated(oracle_arrays(oh), mesh.home, "the host oracle")
    S = mesh.size
    dev0 = mesh.home

    # first agglomerated level (never the finest)
    n_levels = len(oh.levels)
    agg = n_levels
    if config.agglomerate_n:
        for i in range(1, n_levels):
            if oh.levels[i].A.shape[0] <= config.agglomerate_n:
                agg = i
                break

    levels: List[Level] = []
    parts = [uniform_row_partition(l.A.shape[0], S) for l in oh.levels]
    for i, ol in enumerate(oh.levels):
        part = parts[i]
        lam = float(torch.as_tensor(np.float64(ol.lam_max)).to(dtype))
        if i >= agg:
            # agglomerated level: plain operators on mesh.home
            P_r = R_r = None
            if ol.P is not None and i + 1 < n_levels:
                P_r = _plain(ol.P, dtype, dev0)
                R_r = _plain(ol.R, dtype, dev0)
            levels.append(Level(
                _plain(ol.A, dtype, dev0), P_r, R_r,
                torch.from_numpy(np.array(ol.d_inv, np.float64)).to(dtype).to(dev0),
                lam))
            continue
        A_p = PCSR.from_csr(ol.A.tocsr(), mesh, dtype=dtype, pad_identity=True)
        P_p = R_p = None
        if ol.P is not None:
            if i + 1 == agg:
                # boundary transfers: split fine ↔ agglomerated coarse.  P
                # gets zero rows appended up to the padded fine length so
                # its output splits over the parts.
                n_f, n_c = ol.P.shape
                P_pad = sp.vstack([ol.P.tocsr(),
                                   sp.csr_matrix((part.n_padded - n_f, n_c))])
                P_p = ReshardedTransfer(_plain(P_pad, dtype, dev0), mesh, "rows")
                R_p = ReshardedTransfer(_plain(ol.R, dtype, dev0), mesh,
                                        "replicated")
            else:
                P_p = PCSR.from_csr(ol.P.tocsr(), mesh,
                                    col_partition=parts[i + 1], dtype=dtype,
                                    pad_identity=False)
                R_p = PCSR.from_csr(ol.R.tocsr(), mesh, col_partition=part,
                                    dtype=dtype, pad_identity=False)
        # D⁻¹ with pad rows = 1 (identity pad rows keep smoothers inert)
        d_inv = np.ones((part.n_padded,), dtype=np.float64)
        d_inv[: part.n_global] = ol.d_inv
        levels.append(Level(A_p, P_p, R_p, pvector(d_inv, part, mesh, dtype=dtype),
                            lam, true_n=part.n_global))
    # dense coarse solve operator (over the padded space only when the
    # coarsest level is still split)
    if agg < n_levels:
        dense = oh.levels[-1].A.toarray()
    else:
        cpart = parts[-1]
        dense = np.eye(cpart.n_padded, dtype=np.float64)
        dense[: cpart.n_global, : cpart.n_global] = oh.levels[-1].A.toarray()
    coarse_inv = torch.from_numpy(coarse_inverse_np(dense)).to(torch.float32).to(dev0)
    return with_neighbor_plans(Hierarchy(levels, coarse_inv, config))
