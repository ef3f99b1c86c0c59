"""Sparse storage formats and kernels of the port.

- :class:`~parallel_amg_tpu_torch.ops.coo.COO`,
  :class:`~parallel_amg_tpu_torch.ops.csr.CSR` — numpy host containers;
- :class:`~parallel_amg_tpu_torch.ops.ell.ELL` — padded rows over tensors;
- :class:`~parallel_amg_tpu_torch.ops.dia.DIA` — banded, on FlatDIA's kernel;
- :class:`~parallel_amg_tpu_torch.ops.stencil.Stencil` — N-D stencils on
  grids, shifted slices and the stencil algebra of the structured setup;
- :class:`~parallel_amg_tpu_torch.ops.flatdia.FlatDIA` — flattened
  diagonals with the hand-written CUDA SpMV kernel ``csrc/flatdia_spmv.cu``
  and multi-RHS kernel ``csrc/flatdia_spmm.cu`` (which also carries
  ``Stencil.matmat`` on the card);
- :class:`~parallel_amg_tpu_torch.ops.bsr.BSR` and
  :class:`~parallel_amg_tpu_torch.ops.btwell.BTWELL` — block-ELL with bs×bs
  blocks (BTWELL with zero blocks dropped) on the hand-written CUDA block
  SpMV ``csrc/bsr_spmv.cu``;
- :class:`~parallel_amg_tpu_torch.ops.bstencil.BlockStencil` — L ⊗ C on a
  grid, the coarse levels of the vector path;
- :class:`~parallel_amg_tpu_torch.ops.twell.TWELL` — any sparsity, int32 CSR
  with the hand-written CUDA SpMV kernel ``csrc/twell_spmv.cu``.
"""

from parallel_amg_tpu_torch.ops.bsr import BSR
from parallel_amg_tpu_torch.ops.bstencil import BlockStencil
from parallel_amg_tpu_torch.ops.btwell import BTWELL
from parallel_amg_tpu_torch.ops.coo import COO
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.ops.twell import TWELL

__all__ = ["BSR", "BTWELL", "BlockStencil", "COO", "CSR", "DIA", "ELL",
           "FlatDIA", "Stencil", "TWELL"]
