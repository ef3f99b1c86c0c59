"""Row partitions and halo exchange plans (the PRange analog).

A copy of ``parallel_amg_tpu/parallel/partition.py``, which is numpy only:
the port keeps its own, since importing anything of the JAX package runs
that package's ``__init__``.  A :class:`Partition` is host-built (numpy,
once per matrix): per-part own-row ranges, ghost global-id maps, and the
all-to-all send/receive plans that implement ``consistent``-style ghost
fetches (SURVEY.md §2.1 "Partition layer", "Halo exchange").

Static-shape discipline: every per-part quantity is padded to the maximum
over parts (rows per part m, ghost count G, per-pair send count C), so
every part's tensors have one shape.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Partition:
    """Uniform contiguous row partition of [0, n_global) over S shards.

    Shard s owns global rows [s*m, min((s+1)*m, n_global)); the global space
    is padded to S*m rows (pad rows are numerically inert identity rows).
    """

    n_global: int
    n_shards: int
    rows_per_shard: int  # m

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.rows_per_shard

    def owner_of(self, gids: np.ndarray) -> np.ndarray:
        return np.minimum(gids // self.rows_per_shard, self.n_shards - 1)

    def own_range(self, s: int) -> tuple:
        """Clamped [lo, hi): trailing shards can own zero real rows when
        n_global < (S-1)·m (tiny coarse levels)."""
        return (min(s * self.rows_per_shard, self.n_global),
                min((s + 1) * self.rows_per_shard, self.n_global))

    def local_to_global(self, s: int, lids: np.ndarray) -> np.ndarray:
        return s * self.rows_per_shard + lids

    def global_to_local(self, gids: np.ndarray) -> np.ndarray:
        return gids % self.rows_per_shard


def uniform_row_partition(n_global: int, n_shards: int) -> Partition:
    m = -(-n_global // n_shards)  # ceil
    return Partition(n_global=int(n_global), n_shards=int(n_shards),
                     rows_per_shard=int(m))


@dataclasses.dataclass
class HaloPlan:
    """Static all-to-all ghost-exchange plan between a row partition (the
    vector being gathered) and the shards that need its entries.

    Gather direction (``consistent``): shard s loads x_local[send_idx[s]]
    into an (S, C) buffer, all-to-all swaps blocks, and ghost slot g reads
    flattened position recv_map[s, g] (padded slots point at a trash slot).

    Reverse direction (``assemble``): ghost accumulations scatter back
    through the same plan and add at the owners — see pvector.assemble.
    """

    send_idx: np.ndarray  # (S, S, C) int32 — s sends x[send_idx[s, d]] to d
    send_count: np.ndarray  # (S, S) int32 — valid prefix length per (s, d)
    recv_map: np.ndarray  # (S, G) int32 — flat (S*C [+trash]) position per ghost
    ghost_gids: np.ndarray  # (S, G) int64 — global id of each ghost slot (-1 pad)
    n_ghost: np.ndarray  # (S,) int32
    C: int  # max per-pair send count
    G: int  # max ghost slots per shard


def build_halo_plan(col_gids_per_shard: list, col_partition: Partition) -> HaloPlan:
    """Build the exchange plan.

    Args:
      col_gids_per_shard: for each shard s, sorted unique np.ndarray of the
        *off-shard* global column ids shard s needs (its ghost set).
      col_partition: partition of the gathered vector's index space.
    """
    S = col_partition.n_shards
    G = max((len(g) for g in col_gids_per_shard), default=0)
    G = max(G, 1)
    # send lists: owner o → requester s
    send_lists = [[np.empty(0, dtype=np.int64) for _ in range(S)] for _ in range(S)]
    for s, gids in enumerate(col_gids_per_shard):
        owners = col_partition.owner_of(gids)
        for o in np.unique(owners):
            send_lists[o][s] = gids[owners == o]
    C = max((len(send_lists[o][s]) for o in range(S) for s in range(S)), default=0)
    C = max(C, 1)

    send_idx = np.zeros((S, S, C), dtype=np.int32)
    send_count = np.zeros((S, S), dtype=np.int32)
    for o in range(S):
        for s in range(S):
            lst = col_partition.global_to_local(send_lists[o][s])
            send_idx[o, s, : len(lst)] = lst
            send_count[o, s] = len(lst)

    trash = S * C
    recv_map = np.full((S, G), trash, dtype=np.int32)
    ghost_gids = np.full((S, G), -1, dtype=np.int64)
    n_ghost = np.zeros((S,), dtype=np.int32)
    for s, gids in enumerate(col_gids_per_shard):
        n_ghost[s] = len(gids)
        ghost_gids[s, : len(gids)] = gids
        # position of each ghost gid inside the flattened receive buffer:
        # row o of the recv buffer holds what owner o sent to s, in the order
        # of send_lists[o][s].
        pos_of_gid = {}
        for o in range(S):
            for j, gid in enumerate(send_lists[o][s]):
                pos_of_gid[int(gid)] = o * C + j
        for g, gid in enumerate(gids):
            recv_map[s, g] = pos_of_gid[int(gid)]
    return HaloPlan(
        send_idx=send_idx,
        send_count=send_count,
        recv_map=recv_map,
        ghost_gids=ghost_gids,
        n_ghost=n_ghost,
        C=C,
        G=G,
    )
