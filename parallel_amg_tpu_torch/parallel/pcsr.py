"""PCSR — row-partitioned sparse matrix with own/ghost split-block storage.

Counterpart of ``parallel_amg_tpu/parallel/pcsr.py`` (the PSparseMatrix
analog, SURVEY.md §1 L3).  Each part of a row mesh stores its row block as
two padded ELL planes: the **diag block** (columns owned by the same part,
local indices) and the **offdiag block** (columns resolved through a ghost
buffer that a static halo plan fills).  Every field the JAX class carries
with a leading shard axis is here a list with one tensor per part this
process holds (``mesh.local``), on ``mesh.device(p)``; vectors are 1-D
PGrids (``parallel/pvector.py``).  Plans are built from the global part
count, so every process builds the same ones.

``matvec`` is: send-window gather → ``exchange.all_to_all`` (or the ring
shifts of ``with_neighbor_plan``) → ghost gather → y = diag·x_local +
off·ghosts.  On the card the last step is kernel B1: per part,
[diag | off] is one sparse matrix over cat(x_local, ghosts), kept as a
:class:`~parallel_amg_tpu_torch.ops.twell.TWELL` (columns ``diag_cols`` and
``off_cols + mc``, explicit zeros dropped) built on the part's device at the
first matvec; one B1 launch per part.  On a CPU tensor the plain two-plane
gather-sum of the JAX body runs instead.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.parallel import exchange
from parallel_amg_tpu_torch.parallel.partition import (
    Partition,
    build_halo_plan,
    uniform_row_partition,
)
from parallel_amg_tpu_torch.parallel.pgrid import PGrid


def _split(a, mesh, dtype=None):
    """This process's per-part tensors from an (S, ...) host array (copied:
    the array may be read-only)."""
    out = []
    for p in mesh.local:
        t = torch.from_numpy(np.array(a[p]))
        out.append((t if dtype is None else t.to(dtype)).to(mesh.device(p)))
    return out


def _host(parts):
    """(S, ...) numpy array of every part's tensor (``exchange.all_gather``)."""
    return np.stack([t.cpu().numpy() for t in exchange.all_gather(parts)])


def _partition_numpy(indptr, indices, data, n_rows, S, m, mc, col_part):
    """Vectorized numpy partition: the same planes and ghost sets as the
    native builder (entries keep their CSR order within a row)."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    data = np.asarray(data, np.float64)
    counts = np.diff(indptr[: n_rows + 1])
    row_of = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
    part = row_of // m
    own = col_part.owner_of(indices) == part

    def slots(flag):
        excl = np.concatenate([[0], np.cumsum(flag)[:-1]]).astype(np.int64)
        return excl - excl[indptr[row_of]] if len(flag) else excl

    slot_d, slot_o = slots(own), slots(~own)
    per_row_d = np.bincount(row_of[own], minlength=n_rows)
    per_row_o = np.bincount(row_of[~own], minlength=n_rows)
    Wd = max(int(per_row_d.max()) if n_rows else 0, 1)
    Wo = max(int(per_row_o.max()) if n_rows else 0, 1)
    local = row_of - part * m

    diag_cols = np.zeros((S, m, Wd), dtype=np.int32)
    diag_vals = np.zeros((S, m, Wd), dtype=np.float64)
    off_cols = np.zeros((S, m, Wo), dtype=np.int32)
    off_vals = np.zeros((S, m, Wo), dtype=np.float64)
    diag_cols[part[own], local[own], slot_d[own]] = indices[own] - part[own] * mc
    diag_vals[part[own], local[own], slot_d[own]] = data[own]

    off = ~own
    span = int(col_part.n_padded) + 1
    keys = np.unique(part[off] * span + indices[off])
    key_part = keys // span
    starts = np.searchsorted(key_part, np.arange(S + 1))
    ghost_sets = [keys[starts[s]:starts[s + 1]] - s * span for s in range(S)]
    gslot = (np.searchsorted(keys, part[off] * span + indices[off])
             - starts[part[off]])
    off_cols[part[off], local[off], slot_o[off]] = gslot
    off_vals[part[off], local[off], slot_o[off]] = data[off]
    return diag_cols, diag_vals, off_cols, off_vals, ghost_sets


class PCSR:
    """Distributed sparse matrix over a row mesh.

    Array fields are lists with one tensor per local part.  ``shape`` is the PADDED
    global shape (S·m_row, S·m_col), so vectors align without ragged
    handling; ``true_shape`` keeps the logical dimensions.
    """

    def __init__(self, diag_cols, diag_vals, off_cols, off_vals,
                 send_idx, recv_map, mesh, row_partition, col_partition,
                 true_shape, nb_offsets=None, nb_send=None,
                 nb_recv_map=None):
        self.diag_cols = list(diag_cols)  # (m, Wd) int32 per part, local cols
        self.diag_vals = list(diag_vals)  # (m, Wd)
        self.off_cols = list(off_cols)    # (m, Wo) int32 per part, ghost slots
        self.off_vals = list(off_vals)    # (m, Wo)
        self.send_idx = list(send_idx)    # (S, C) int32 per part
        self.recv_map = list(recv_map)    # (G,) int32 per part (trash = S·C)
        self.mesh = mesh
        self.row_partition = row_partition
        self.col_partition = col_partition
        self.true_shape = tuple(int(s) for s in true_shape)
        # the ring plan of with_neighbor_plan: per shard offset d a (C_d,)
        # send table per part, moved by one ring shift
        self.nb_offsets = tuple(nb_offsets) if nb_offsets else None
        self.nb_send = (tuple(list(t) for t in nb_send)
                        if nb_send is not None else None)
        self.nb_recv_map = (list(nb_recv_map) if nb_recv_map is not None
                            else None)
        self._twell = None  # per-part B1 operators, built at the first matvec

    def _with(self, **fields) -> "PCSR":
        """A copy with some fields replaced (the ring plan and, while the
        planes stay, B1's operators carry over)."""
        kw = dict(diag_cols=self.diag_cols, diag_vals=self.diag_vals,
                  off_cols=self.off_cols, off_vals=self.off_vals,
                  send_idx=self.send_idx, recv_map=self.recv_map,
                  mesh=self.mesh, row_partition=self.row_partition,
                  col_partition=self.col_partition,
                  true_shape=self.true_shape, nb_offsets=self.nb_offsets,
                  nb_send=self.nb_send, nb_recv_map=self.nb_recv_map)
        kw.update(fields)
        out = PCSR(**kw)
        planes = ("diag_cols", "diag_vals", "off_cols", "off_vals")
        if not any(k in fields for k in planes):
            out._twell = self._twell
        return out

    # -- properties -------------------------------------------------------
    @property
    def shape(self):
        return (self.row_partition.n_padded, self.col_partition.n_padded)

    @property
    def n_rows(self) -> int:
        """Padded row count (``Hierarchy.complexity`` subtracts the padding
        rows' identity entries from ``nnz``)."""
        return self.row_partition.n_padded

    @property
    def n_cols(self) -> int:
        return self.col_partition.n_padded

    @property
    def n_shards(self) -> int:
        return self.row_partition.n_shards

    @property
    def dtype(self):
        return self.diag_vals[0].dtype

    @property
    def C(self) -> int:
        return int(self.send_idx[0].shape[1])

    @property
    def G(self) -> int:
        return int(self.recv_map[0].shape[0])

    @property
    def nnz(self) -> int:
        """Stored nonzeros over all parts (one host read)."""
        return int(exchange.psum([(d != 0).sum() + (o != 0).sum()
                                  for d, o in zip(self.diag_vals, self.off_vals)]))

    # -- construction -----------------------------------------------------
    @classmethod
    def from_planes(cls, diag_cols, diag_vals, off_cols, off_vals, send_idx,
                    recv_map, mesh, row_partition, col_partition, true_shape,
                    dtype=torch.float32) -> "PCSR":
        """Split (S, ...) host arrays into a PCSR on ``mesh``."""
        return cls(_split(np.asarray(diag_cols, np.int32), mesh),
                   _split(np.asarray(diag_vals, np.float64), mesh, dtype),
                   _split(np.asarray(off_cols, np.int32), mesh),
                   _split(np.asarray(off_vals, np.float64), mesh, dtype),
                   _split(np.asarray(send_idx, np.int32), mesh),
                   _split(np.asarray(recv_map, np.int32), mesh),
                   mesh, row_partition, col_partition, true_shape)

    @classmethod
    def from_csr(cls, csr, mesh, col_partition: Partition | None = None,
                 dtype=torch.float32, pad_identity: bool = True,
                 native: bool = True) -> "PCSR":
        """Partition a host CSR (the port's CSR or scipy) across the mesh.

        pad_identity: give padding rows a unit diagonal (square operators —
        keeps smoothers well-defined); False → zero rows (P/R transfers).
        ``native=False`` takes the numpy partition instead of the C++
        builder (the two give the same arrays).
        """
        n_rows, n_cols = csr.shape
        S = mesh.size
        row_part = uniform_row_partition(n_rows, S)
        col_part = col_partition or uniform_row_partition(n_cols, S)
        m, mc = row_part.rows_per_shard, col_part.rows_per_shard
        if native:
            from parallel_amg_tpu_torch import native as native_builder

            built = native_builder.pcsr_partition(
                csr.indptr, csr.indices, csr.data, n_rows, S, m, mc)
        else:
            built = _partition_numpy(csr.indptr, csr.indices, csr.data,
                                     n_rows, S, m, mc, col_part)
        diag_cols, diag_vals, off_cols, off_vals, ghost_sets = built
        if pad_identity and n_rows == n_cols:
            for s in range(S):
                lo, hi = row_part.own_range(s)
                pad = np.arange(hi - lo, m)
                diag_cols[s, pad, 0] = pad
                diag_vals[s, pad, 0] = 1.0
        plan = build_halo_plan([np.asarray(g, np.int64) for g in ghost_sets],
                               col_part)
        return cls.from_planes(diag_cols, diag_vals, off_cols, off_vals,
                               plan.send_idx, plan.recv_map, mesh, row_part,
                               col_part, (n_rows, n_cols), dtype=dtype)

    # -- neighbor-wise exchange plan --------------------------------------
    def with_neighbor_plan(self) -> "PCSR":
        """Derive the ring exchange plan from the dense plan.

        The dense plan ships a C-sized buffer between EVERY part pair; real
        row-partitioned operators have O(1) neighbors, so this plan keeps
        one (C_d,) table per part for each shard offset d with traffic and
        moves it with one ``exchange.ring_shift``.  Runs once on the host
        over the plan arrays; ``matvec`` takes the ring path when it is
        present.
        """
        S = self.n_shards
        C = self.C
        rmap = _host(self.recv_map)  # (S, G)
        sidx = _host(self.send_idx)  # (S, S, C)
        valid = rmap < S * C
        owner = np.where(valid, rmap // C, 0)
        rank = np.where(valid, rmap % C, 0)
        s_col = np.arange(S)[:, None]
        d_all = np.where(valid, (s_col - owner) % S, -1)
        offsets = sorted({int(d) for d in np.unique(d_all) if d > 0})
        if not offsets:
            offsets = [1]  # no ghosts at all; keep shapes legal
        # the truncation relies on no self-owned ghosts: a plan with one
        # would read zeros from the trash slot, so fail here instead
        if np.any(valid & (d_all == 0)):
            raise ValueError("with_neighbor_plan: dense plan contains "
                             "self-owned ghosts")
        nb_send, bases, cds = [], {}, {}
        base = 0
        for d in offsets:
            # part o's send list for offset d is its dense-plan list for
            # destination (o+d)%S, truncated to the offset's max
            cd = 1
            for s in range(S):
                o = (s - d) % S
                cd = max(cd, int((valid[s] & (owner[s] == o)).sum()))
            dest = (np.arange(S) + d) % S
            nb_send.append(_split(sidx[np.arange(S), dest, :cd], self.mesh))
            bases[d] = base
            cds[d] = cd
            base += cd
        nb_rmap = np.full(rmap.shape, base, np.int32)  # trash = base
        for d in offsets:
            sel = valid & (d_all == d)
            # per-(owner, dest) ranks are contiguous from 0 within cd in
            # both plan builders; a plan that breaks it fails here
            if rank[sel].size and int(rank[sel].max()) >= cds[d]:
                raise ValueError(f"with_neighbor_plan: ghost rank ≥ send "
                                 f"width for offset {d}")
            nb_rmap[sel] = bases[d] + rank[sel]
        return self._with(nb_offsets=offsets, nb_send=nb_send,
                          nb_recv_map=_split(nb_rmap, self.mesh))

    # -- ghost exchange ----------------------------------------------------
    def fetch_ghosts(self, parts, fill=0):
        """Ghost values of per-part (mc, ...) tensors (vectors or row
        tables) through the dense plan → per-part (G, ...); trash slots get
        ``fill``."""
        bufs = [x[sidx] for x, sidx in zip(parts, self.send_idx)]
        recv = exchange.all_to_all(bufs)
        out = []
        for r, rmap in zip(recv, self.recv_map):
            flat = r.reshape((-1,) + tuple(r.shape[2:]))
            pad = torch.full((1,) + tuple(flat.shape[1:]), fill,
                             dtype=flat.dtype, device=flat.device)
            out.append(torch.cat([flat, pad])[rmap])
        return out

    def _fetch_ring(self, parts):
        """Ghost values through the ring plan → per-part (G,)."""
        recvs = []
        for d, tbl in zip(self.nb_offsets, self.nb_send):
            recvs.append(exchange.ring_shift(
                [x[t] for x, t in zip(parts, tbl)], d))
        out = []
        for j, rmap in enumerate(self.nb_recv_map):
            x = parts[j]
            flat = torch.cat([r[j] for r in recvs]
                             + [torch.zeros(1, dtype=x.dtype, device=x.device)])
            out.append(flat[rmap])
        return out

    def ghosts(self, x: PGrid):
        """Per-part ghost buffers of x for the matvec (ring plan when
        present, dense plan otherwise)."""
        if self.nb_send is not None:
            return self._fetch_ring(x.parts)
        return self.fetch_ghosts(x.parts)

    # -- distributed SpMV -------------------------------------------------
    def twell_parts(self):
        """Per-part B1 operators: [diag | off] as one TWELL over
        cat(x_local, ghosts), explicit zeros dropped (built once, on the
        parts' devices)."""
        if self._twell is None:
            from parallel_amg_tpu_torch.ops.twell import TWELL

            mc = self.col_partition.rows_per_shard
            out = []
            for dc, dv, oc, ov in zip(self.diag_cols, self.diag_vals,
                                      self.off_cols, self.off_vals):
                cols = torch.cat([dc, oc + mc], 1)
                vals = torch.cat([dv, ov], 1)
                keep = vals != 0
                counts = keep.sum(1, dtype=torch.int32)
                indptr = torch.zeros(dc.shape[0] + 1, dtype=torch.int32,
                                     device=dc.device)
                indptr[1:] = torch.cumsum(counts, 0)
                out.append(TWELL(indptr, cols[keep].to(torch.int32).contiguous(),
                                 vals[keep].contiguous(),
                                 (dc.shape[0], mc + self.G)))
            self._twell = out
        return self._twell

    def matvec(self, x: PGrid) -> PGrid:
        """y = A @ x for a PGrid x on the column partition; y is a PGrid on
        the row partition.  The ring plan when present, else the dense
        plan; B1 per part on the card, the plain gather-sum on the CPU."""
        g = self.ghosts(x)
        out = []
        for i, xl in enumerate(x.parts):
            if xl.device.type == "cpu":
                out.append((self.diag_vals[i] * xl[self.diag_cols[i].long()]).sum(1)
                           + (self.off_vals[i] * g[i][self.off_cols[i].long()]).sum(1))
            else:
                out.append(self.twell_parts()[i].matvec(torch.cat([xl, g[i]])))
        return PGrid(out, self.mesh)

    def __matmul__(self, x):
        return self.matvec(x)

    def zeros_coarse(self, dtype) -> PGrid:
        """Zero PGrid on the column partition (the cycle's coarse iterate
        when this operator is a prolongation)."""
        mc = self.col_partition.rows_per_shard
        return PGrid([torch.zeros(mc, dtype=dtype, device=self.mesh.device(p))
                      for p in self.mesh.local], self.mesh)

    # -- ghost exchange primitives (the consistent!/assemble! analogs) ----
    def consistent(self, x: PGrid) -> PGrid:
        """Fetch ghost values of x for every part — the reference stack's
        ``consistent!``.  Returns a PGrid of per-part (G,) ghost buffers."""
        return PGrid(self.fetch_ghosts(x.parts), self.mesh)

    def assemble(self, ghost_vals: PGrid, y: PGrid | None = None) -> PGrid:
        """Reverse exchange — the ``assemble!`` owner-reduce: each part's
        ghost-slot accumulations are routed back through the halo plan and
        added at their owners (in a fixed order).  Returns the owner-sum on
        the column partition (added onto y when given)."""
        from parallel_amg_tpu_torch.parallel.segment import segment_sum

        S, C = self.n_shards, self.C
        mc = self.col_partition.rows_per_shard
        bufs = []
        for gv, rmap in zip(ghost_vals.parts, self.recv_map):
            buf = segment_sum(gv, rmap, S * C + 1)[: S * C]
            bufs.append(buf.reshape(S, C))
        recv = exchange.all_to_all(bufs)
        out = []
        for i, (r, sidx) in enumerate(zip(recv, self.send_idx)):
            # recv[src, j] adds at local index send_idx[i][src, j]; padded
            # slots carry zeros, so the plain segment sum is safe
            add = segment_sum(r.reshape(-1), sidx.reshape(-1), mc)
            out.append(add if y is None else y.parts[i] + add)
        return PGrid(out, self.mesh)

    # -- host round-trip and repartitioning --------------------------------
    def ghost_gids(self):
        """Per-part (G,) int64 global column id of each ghost slot (−1 on
        trash slots), from one all_to_all of the send tables: what part p
        receives from owner o at position j is x_o[send_idx[o][p, j]]."""
        S = self.n_shards
        mc = self.col_partition.rows_per_shard
        recv = exchange.all_to_all([s.long() for s in self.send_idx])
        out = []
        for r, rmap in zip(recv, self.recv_map):
            base = torch.arange(S, device=r.device)[:, None] * mc + r
            flat = torch.cat([base.reshape(-1),
                              torch.full((1,), -1, dtype=torch.long,
                                         device=r.device)])
            out.append(flat[rmap.long()])
        return out

    def to_csr(self):
        """Reconstruct the global host CSR on every process (strips padding;
        entries whose value is exactly 0 drop)."""
        from parallel_amg_tpu_torch.ops.coo import COO

        rows, cols, vals = self.to_triplets()
        r = rows.to_global("cpu").numpy()
        c = cols.to_global("cpu").numpy()
        v = vals.to_global("cpu").double().numpy()
        keep = (r >= 0) & (c >= 0) & (c < self.true_shape[1])
        return COO(r[keep], c[keep], v[keep], self.true_shape).to_csr()

    def to_triplets(self):
        """Per-part (rows, cols, vals) triplet blocks with GLOBAL ids, on the
        parts' devices — three PGrids of per-part (m·(Wd+Wo),) tensors,
        padding entries row −1.

        PATTERN-LOSSY, as the JAX package's: validity is ``val != 0``, so
        explicitly stored zeros are dropped."""
        m = self.row_partition.rows_per_shard
        mc = self.col_partition.rows_per_shard
        n_rows = self.true_shape[0]
        gids = self.ghost_gids()
        R, Cc, V = [], [], []
        for i, p in enumerate(self.mesh.local):
            dc, dv = self.diag_cols[i], self.diag_vals[i]
            oc, ov = self.off_cols[i], self.off_vals[i]
            dev = dc.device
            gr = p * m + torch.arange(m, device=dev)
            live = (gr < n_rows)[:, None]
            c_d = p * mc + dc.long()
            ok_d = (dv != 0) & live
            c_o = gids[i][oc.long()]
            ok_o = (ov != 0) & live & (c_o >= 0)
            r_d = gr[:, None].expand(dc.shape)
            r_o = gr[:, None].expand(oc.shape)
            R.append(torch.cat([torch.where(ok_d, r_d, -1).reshape(-1),
                                torch.where(ok_o, r_o, -1).reshape(-1)]))
            Cc.append(torch.cat([torch.where(ok_d, c_d, 0).reshape(-1),
                                 torch.where(ok_o, c_o, 0).reshape(-1)]))
            V.append(torch.cat([torch.where(ok_d, dv, 0.0).reshape(-1),
                                torch.where(ok_o, ov, 0.0).reshape(-1)]))
        return (PGrid(R, self.mesh), PGrid(Cc, self.mesh),
                PGrid(V, self.mesh))

    def repartition(self, mesh, col_partition: Partition | None = None,
                    dtype=None, rows_per_shard: int | None = None,
                    **device_caps) -> "PCSR":
        """Redistribute rows — the coarse-level repartitioner of SURVEY.md
        §2.1, on the parts' devices for both cases:

        - same mesh (re-balance / re-align rows_per_shard): triplet recovery
          (``to_triplets``) + owner routing (``pcsr_from_coo_device``);
        - another mesh (e.g. shrink a coarse level to fewer parts): the
          per-part triplet blocks are gathered (``exchange.all_gather``),
          re-blocked for the target part count, and each process keeps its
          blocks, then assembled there.

        Only ``col_partition`` (a bespoke column split) still goes through
        the host rebuild, and that path rejects the device-only arguments.
        """
        if col_partition is not None:
            if rows_per_shard is not None or device_caps:
                raise ValueError(
                    "repartition: rows_per_shard/device capacities are not "
                    "honored by the col_partition host path — drop "
                    "col_partition or the device-only arguments")
            return PCSR.from_csr(self.to_csr(), mesh,
                                 col_partition=col_partition,
                                 dtype=dtype or self.dtype)

        from parallel_amg_tpu_torch.parallel.passembly_device import (
            pcsr_from_coo_device,
        )

        rows, cols, vals = self.to_triplets()
        if mesh is not self.mesh:
            S_new = mesh.size
            dev0 = rows.device
            total = rows.parts[0].numel() * self.mesh.size
            pad = (-total) % S_new

            def reblock(g, fill):
                flat = torch.cat(exchange.all_gather(g.parts))
                if pad:
                    flat = torch.cat([flat, torch.full((pad,), fill,
                                                       dtype=flat.dtype,
                                                       device=dev0)])
                return PGrid.from_global(flat, mesh)

            rows, cols, vals = reblock(rows, -1), reblock(cols, 0), reblock(vals, 0)
        # a re-aligned ownership boundary can flip any entry between diag
        # and offdiag, so both widths get the full row budget; overflow is
        # loud if these ever fall short
        W = int(self.diag_cols[0].shape[1] + self.off_cols[0].shape[1])
        caps = dict(ell_width=W, off_width=W,
                    ghost_capacity=max(4 * self.G, 64))
        caps.update(device_caps)
        return pcsr_from_coo_device(rows, cols, vals, self.true_shape, mesh,
                                    rows_per_shard=rows_per_shard,
                                    dtype=dtype or self.dtype, **caps)

    def diagonal(self) -> PGrid:
        """Main diagonal as a PGrid on the row partition (square
        matrices)."""
        out = []
        for dc, dv in zip(self.diag_cols, self.diag_vals):
            r = torch.arange(dc.shape[0], device=dc.device)[:, None]
            hit = (dc == r) & (dv != 0)
            out.append(torch.where(hit, dv, 0.0).sum(1))
        return PGrid(out, self.mesh)
