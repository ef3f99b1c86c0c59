"""Distributed containers and communication over a row mesh of parts.

Counterpart of ``parallel_amg_tpu/parallel``.  The structured path: a row
mesh of parts, grids split on axis 0 (PGrid), sharded stencils with halo
copies and kernel B8 (``pstencil``, ``phalo_async``), and the host-oracle
and on-device distributed setups (``pstructured``, ``pdevice_setup``).  The
algebraic path: row partitions and halo plans (``partition``), the
row-partitioned sparse matrix PCSR (``pcsr``, its matvec on kernel B1), 1-D
distributed vectors (``pvector``), host and on-device COO assembly
(``assembly``, ``passembly_device``), and the distributed setups
(``psetup``: the oracle frozen to PCSR levels; ``prs_setup``: Ruge–Stüben
on the parts' devices; ``psa_setup``: smoothed aggregation on the parts'
devices, their products on kernels B3, B5 and B4).  Every copy between
parts goes through ``exchange``.  One process may hold every part, or
``runtime_init`` joins several processes over ``torch.distributed`` and each
holds a contiguous block of the parts (``RowMesh.local``); ``launch.spawn``
runs a function on such a group of processes.
"""

from parallel_amg_tpu_torch.parallel.mesh import (
    ROW_AXIS,
    RowMesh,
    make_row_mesh,
    runtime_init,
)
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.partition import Partition, uniform_row_partition
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pvector import dot, norm, pvector, to_global

__all__ = ["ROW_AXIS", "RowMesh", "make_row_mesh", "runtime_init", "PGrid",
           "Partition", "uniform_row_partition", "PCSR", "pvector",
           "to_global", "dot", "norm"]
