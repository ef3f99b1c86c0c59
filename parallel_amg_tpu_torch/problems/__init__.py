"""Model problem generators (numpy copies of ``parallel_amg_tpu.problems``).

2D 5-point and 3D 7-point Poisson and 2D anisotropic diffusion as host COO,
the matrices of the acceptance configs that the port runs, and their Stencil
forms born on the device (``poisson_stencil``, ``anisotropic_stencil``).
"""

from parallel_amg_tpu_torch.problems.anisotropic import anisotropic2d
from parallel_amg_tpu_torch.problems.poisson import poisson2d, poisson3d
from parallel_amg_tpu_torch.problems.stencil_problems import (
    anisotropic_stencil,
    poisson_stencil,
)

__all__ = ["anisotropic2d", "poisson2d", "poisson3d", "poisson_stencil", "anisotropic_stencil"]
