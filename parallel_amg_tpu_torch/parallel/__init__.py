"""The distributed structured path: a row mesh of parts, grids split on
axis 0 (PGrid), sharded stencils with halo copies and kernel B8
(``pstencil``, ``phalo_async``), and the host-oracle and on-device
distributed setups (``pstructured``, ``pdevice_setup``).

Counterpart of ``parallel_amg_tpu/parallel`` for its structured path.  The
algebraic distributed path (PCSR, partitions, assembly and the distributed
setups of ``psetup``/``prs_setup``/``psa_setup``) is not ported.  The
package's top level exports the entry points; this module loads only the
mesh and PGrid, which the solve path imports.
"""

from parallel_amg_tpu_torch.parallel.mesh import (
    ROW_AXIS,
    RowMesh,
    make_row_mesh,
    runtime_init,
)
from parallel_amg_tpu_torch.parallel.pgrid import PGrid

__all__ = ["ROW_AXIS", "RowMesh", "make_row_mesh", "runtime_init", "PGrid"]
