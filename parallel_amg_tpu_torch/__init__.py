"""parallel_amg_tpu_torch — the AMG framework on PyTorch and CUDA.

The port of ``parallel_amg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
Hopper GPU.  Module paths and public names mirror the JAX package; the JAX
package stays the reference the port is tested against.  This package
imports torch, numpy and scipy, and never jax.

Ported: everything the JAX package does on one device, its structured
distributed path and its algebraic distributed path in one process.  The host setup (Ruge–Stüben, greedy or block smoothed
aggregation from the float64 oracle); the structured block-SA setup on the
device (``amg/device_setup.py``, from ``problems.poisson_stencil``, with the
dense, bucketed and slab Galerkin products); the Ruge–Stüben setup on the
device (``amg/device_rs.py``: strength, PMIS, three interpolations, ELL
transpose and SpGEMM) and the algebraic SA setup on the device
(``amg/device_sa.py``: distance-2 MIS aggregation, smoothed tentative P),
both with ``with_best_formats``; the vector (BSR) setup
``setup_vector_kron`` (``amg/vector.py``, from
``problems.coupled_laplacian``); the DIA, TWELL, ELL, Stencil, FlatDIA, BSR,
BTWELL and BlockStencil formats with ``with_spmv_backend``; block and vector
block transfers; Jacobi and Chebyshev smoothing, V/W-cycles, standalone
``solve``, ``amg_pcg``, the mixed-precision ``amg_pcg_mp`` (float64 CG over
a float32 or bfloat16 hierarchy, to a true 1e-8) and ``amg_fgmres`` (flexible
GMRES, ``krylov/gmres.py``, for the nonsymmetric
``problems.convection2d``); hierarchy checkpoints and casts, run records,
profiling and traffic models (``utils/``); the distributed structured path
(``parallel/``: a row mesh of parts, PGrid, ShardedStencil, the host-oracle
``structured_distributed_setup`` and the on-device
``sharded_device_setup``); the algebraic distributed path (``parallel/``:
the row-partitioned PCSR with its dense and ring halo plans, built by the
g++ builder of ``native/`` or assembled from triplets on the parts' devices
by ``pcsr_from_coo_device``, ``pvector``, the host-oracle
``distributed_setup`` and the on-device ``distributed_rs_setup`` and
``distributed_sa_setup``, with ``amg_pcg``, ``solve`` and ``amg_fgmres``
over its PGrid vectors).  Eight kernels are hand-written CUDA: TWELL's
SpMV (``csrc/twell_spmv.cu``), FlatDIA's SpMV, which DIA shares
(``csrc/flatdia_spmv.cu``), the setup SpGEMM's expand, merge and
merge-and-compact steps (``csrc/spgemm.cu``), the block SpMV of BSR and
BTWELL (``csrc/bsr_spmv.cu``) and the multi-RHS flattened-diagonal product
behind ``Stencil.matmat`` (``csrc/flatdia_spmm.cu``) and the overlapped halo
stencil matvec of ``ShardedStencil`` (``csrc/halo_stencil.cu``);
``pallas_spgemm`` runs on the SpGEMM's three, and so do the per-part
products of the distributed setups; ``PCSR.matvec`` runs on TWELL's.  Entry points that make
tensors run on the CUDA card unless the caller passes ``device="cpu"``
(``make_row_mesh(n, device="cpu")`` for the distributed path).
"""

__version__ = "0.1.0"

from parallel_amg_tpu_torch.config import AMGConfig, SolveConfig
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.coo import COO
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.amg import setup, vcycle, solve, Hierarchy
from parallel_amg_tpu_torch.amg.vector import setup_vector_kron
from parallel_amg_tpu_torch.amg.hierarchy import (
    with_best_formats,
    with_spmv_backend,
)
from parallel_amg_tpu_torch.solver import amg_fgmres, amg_pcg, amg_pcg_mp
from parallel_amg_tpu_torch.ops.pspgemm import PallasSpgemmPlan, pallas_spgemm
from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
from parallel_amg_tpu_torch.parallel.pgrid import PGrid
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.parallel.pstructured import (
    collect_grid,
    distribute_grid,
    structured_distributed_setup,
)
from parallel_amg_tpu_torch.parallel.pdevice_setup import (
    anisotropic_stencil_sharded,
    poisson_stencil_sharded,
    sharded_device_setup,
)
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pvector import dot, norm, pvector, to_global
from parallel_amg_tpu_torch.parallel.passembly_device import pcsr_from_coo_device
from parallel_amg_tpu_torch.parallel.psetup import distributed_setup
from parallel_amg_tpu_torch.parallel.prs_setup import distributed_rs_setup
from parallel_amg_tpu_torch.parallel.psa_setup import distributed_sa_setup

__all__ = [
    "AMGConfig",
    "SolveConfig",
    "CSR",
    "COO",
    "ELL",
    "Stencil",
    "setup",
    "vcycle",
    "solve",
    "Hierarchy",
    "amg_pcg",
    "amg_pcg_mp",
    "amg_fgmres",
    "setup_vector_kron",
    "with_best_formats",
    "with_spmv_backend",
    "PallasSpgemmPlan",
    "pallas_spgemm",
    "make_row_mesh",
    "PGrid",
    "ShardedStencil",
    "structured_distributed_setup",
    "distribute_grid",
    "collect_grid",
    "poisson_stencil_sharded",
    "anisotropic_stencil_sharded",
    "sharded_device_setup",
    "PCSR",
    "pvector",
    "to_global",
    "dot",
    "norm",
    "distributed_setup",
    "pcsr_from_coo_device",
    "distributed_rs_setup",
    "distributed_sa_setup",
]
