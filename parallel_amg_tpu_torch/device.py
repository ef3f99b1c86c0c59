"""Where the port's entry points make their tensors.

Every entry point that makes tensors (``setup``, ``poisson_stencil``,
``hierarchy_from_numpy``) takes ``device=None`` to mean the CUDA card.  Where
torch finds no card the call raises: the port never falls back to the CPU
unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The caller's device, or the CUDA card when ``device`` is None."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("torch finds no CUDA card; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda")
