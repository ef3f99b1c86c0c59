"""Vector (multi-DOF / BSR) AMG setup — the Kronecker unknown-based hierarchy.

Counterpart of ``parallel_amg_tpu/amg/vector.py``.  For block operators
A = L ⊗ C (``problems/elasticity.py``) the transfers are P = P_s ⊗ I with
the scalar smoothed prolongator P_s = (I − coef·D_L⁻¹L)T_s, under which
every Galerkin coarse operator stays exactly L_c ⊗ C:

    (P_s ⊗ I)ᵀ (L ⊗ C) (P_s ⊗ I) = (P_sᵀ L P_s) ⊗ C.

So the vector setup is the scalar on-device setup (``amg/device_setup.py``)
plus a Kronecker wrap per level, and the eigensystem factors:
λ_max(D⁻¹A) = λ_max(D_L⁻¹L)·λ_max(D_C⁻¹C), (L_c ⊗ C)⁻¹ = L_c⁻¹ ⊗ C⁻¹.

The fine level is block-ELL BSR (``fine_format="bsr"``, kernel B6), or the
same with zero blocks dropped ("btwell", also B6), or structured like the
coarse levels ("bstencil": scalar planes and one C mix, kernel B7).  The
coarse levels are BlockStencils; every transfer applies the scalar stencil
to the bs components at once (``Stencil.matmat``, B7 on the card).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.amg.device_setup import device_structured_setup
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.ops.bstencil import (
    BlockStencil,
    BSRGridOperator,
    VectorBlockProlongator,
    VectorBlockRestrictor,
    bsr_from_kron_stencil,
)
from parallel_amg_tpu_torch.ops.stencil import Stencil

FINE_FORMATS = ("bsr", "btwell", "bstencil")


def setup_vector_kron(L: Stencil, C, config: AMGConfig, dtype=torch.float32,
                      seed: int = 0, fine_format: str = "bsr") -> Hierarchy:
    """Build the vector hierarchy of A = L ⊗ C on L's device.

    L: scalar fine-level Stencil (node grid); C: SPD (bs, bs) coupling.
    The rounding follows the JAX package step for step: λ_C and 1/diag(C)
    are rounded to float32 before their float32 products with the scalar
    level's λ_max and D_L⁻¹, and the coarse inverse is the float64 Kronecker
    product of the scalar one (float32) and C⁻¹, rounded to float32.
    """
    if fine_format not in FINE_FORMATS:
        raise ValueError(f"fine_format must be one of {FINE_FORMATS}, "
                         f"got {fine_format!r}")
    C = np.asarray(C, np.float64)
    bs = C.shape[0]
    dev = L.weights.device
    # λ_max(D_C⁻¹C) and C⁻¹: tiny host eigenproblems, exact
    dC = np.diagonal(C)
    lam_C = float(np.max(np.abs(np.linalg.eigvals(C / dC[:, None]))))
    C_inv = np.linalg.inv(C)
    inv_dC = torch.as_tensor(1.0 / dC, dtype=dtype, device=dev)
    lam_C32 = torch.tensor(lam_C, dtype=torch.float32)
    C_t = torch.as_tensor(C, dtype=dtype, device=dev)

    hs = device_structured_setup(L, config, dtype=dtype, seed=seed)

    levels: List[Level] = []
    for i, sl in enumerate(hs.levels):
        Li: Stencil = sl.A
        if i == 0 and fine_format in ("bsr", "btwell"):
            if fine_format == "btwell":
                from parallel_amg_tpu_torch.ops.btwell import (
                    btwell_from_kron_stencil,
                )

                fine = btwell_from_kron_stencil(Li, C, dtype)
            else:
                fine = bsr_from_kron_stencil(Li, C, dtype)
            A = BSRGridOperator(fine, Li.dims)
            # BSR cannot give its scalar factor back: the level-0 transfers
            # hold L's planes themselves (the same tensors, no copy)
            P_L, P_dinv = Li, sl.d_inv
        else:
            A = BlockStencil(Li.weights, Li.offsets, Li.dims, C_t)
            P_L = P_dinv = None  # linked: transfers borrow A.scalar()
        d_inv = sl.d_inv[..., None] * inv_dC
        lam = float(torch.tensor(sl.lam_max, dtype=torch.float32) * lam_C32)
        P = R = None
        if sl.P is not None:
            P = VectorBlockProlongator(P_L, P_dinv, sl.P.scale, sl.P.coef,
                                       sl.P.dims, sl.P.cdims, sl.P.block, bs)
            R = VectorBlockRestrictor(P_L, P_dinv, sl.R.scale, sl.R.coef,
                                      sl.R.dims, sl.R.cdims, sl.R.block, bs)
        levels.append(Level(A, P, R, d_inv, lam))

    coarse_inv = torch.from_numpy(np.kron(
        hs.coarse_inv.cpu().double().numpy(), C_inv)).to(torch.float32).to(dev)
    h = Hierarchy(levels, coarse_inv, config)
    h.setup_stats = hs.setup_stats
    return h
