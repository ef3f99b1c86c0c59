"""Model problem generators (numpy copies of ``parallel_amg_tpu.problems``).

2D 5-point and 3D 7-point Poisson, 2D anisotropic diffusion and 2D upwind
convection-diffusion (the nonsymmetric workload of ``amg_fgmres``) as host
COO, the matrices of the acceptance configs that the port runs, their Stencil
forms born on the device (``poisson_stencil``, ``anisotropic_stencil``), and
the coupled vector Laplacian L ⊗ C of config #5 (``coupled_laplacian``).
"""

from parallel_amg_tpu_torch.problems.anisotropic import anisotropic2d
from parallel_amg_tpu_torch.problems.convection import convection2d
from parallel_amg_tpu_torch.problems.elasticity import (
    coupled_laplacian,
    coupled_laplacian_scipy,
    coupling_matrix,
)
from parallel_amg_tpu_torch.problems.poisson import poisson2d, poisson3d
from parallel_amg_tpu_torch.problems.stencil_problems import (
    anisotropic_stencil,
    poisson_stencil,
    seeded_stencil,
)

__all__ = ["anisotropic2d", "convection2d", "poisson2d", "poisson3d",
           "poisson_stencil", "anisotropic_stencil", "seeded_stencil", "coupled_laplacian",
           "coupled_laplacian_scipy", "coupling_matrix"]
