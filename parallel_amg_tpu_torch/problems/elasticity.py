"""Multi-DOF (vector) model problems — the BSR workload.

Counterpart of ``parallel_amg_tpu/problems/elasticity.py``.
``coupled_laplacian``: the vector Laplacian A = L ⊗ C — a scalar N-D
Dirichlet Laplacian L on the node grid with an SPD inter-component coupling
C = (1−γ)I + γ·11ᵀ at every node.  Every stored matrix entry is a dense
bs×bs block; γ sets the coupling strength (γ=0 decouples into bs Poisson
problems).  It is the structured stand-in for linear elasticity (the block
pattern of the 3-DOF displacement formulation) and acceptance config #5's
matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from parallel_amg_tpu_torch.problems.stencil_problems import poisson_stencil


def coupling_matrix(bs: int = 3, gamma: float = 0.3) -> np.ndarray:
    """SPD coupling C = (1−γ)I + γ·11ᵀ (eigenvalues 1−γ and 1+(bs−1)γ)."""
    return (1.0 - gamma) * np.eye(bs) + gamma * np.ones((bs, bs))


def coupled_laplacian(dims, bs: int = 3, gamma: float = 0.3,
                      dtype=torch.float32, device=None):
    """(L: Stencil on dims, C: (bs, bs) float64 numpy array) of A = L ⊗ C.

    L's planes are born on ``device`` (the CUDA card when None), so the
    ≥100M-DOF instances never pass through the host.
    """
    L = poisson_stencil(tuple(int(d) for d in dims), dtype=dtype, device=device)
    return L, coupling_matrix(bs, gamma)


def coupled_laplacian_scipy(dims, bs: int = 3, gamma: float = 0.3):
    """Host float64 scipy CSR of A = L ⊗ C (parity checks at small dims)."""
    import scipy.sparse as sp

    from parallel_amg_tpu_torch.problems.poisson import poisson2d, poisson3d

    dims = tuple(int(d) for d in dims)
    if len(dims) == 2:
        L = poisson2d(*dims).to_csr().to_scipy()
    elif len(dims) == 3:
        L = poisson3d(*dims).to_csr().to_scipy()
    else:
        raise ValueError("2D/3D only")
    return sp.kron(L, coupling_matrix(bs, gamma), format="csr")
