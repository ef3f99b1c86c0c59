"""The row mesh: S parts of a grid's axis 0, each placed on a device.

Counterpart of ``parallel_amg_tpu/parallel/mesh.py``.  The JAX package is
single-controller: one process drives every device of a host through a 1D
``Mesh`` over the axis "rows".  The port keeps that model: one process holds
a list of S parts.  On one card all parts live on ``cuda:0`` as separate
allocations, and halos move by device-to-device copies; on a host with
several cards the parts go round-robin over the cards and the same copies
go peer to peer.  Multi-process runs (one process per host) are not ported.
"""

from __future__ import annotations

import torch

ROW_AXIS = "rows"


class RowMesh:
    """S parts in a row; part p lives on ``device(p)``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one part")

    @property
    def size(self) -> int:
        """Number of parts (the JAX mesh's ``devices.size``)."""
        return len(self.devices)

    def device(self, p: int) -> torch.device:
        return self.devices[p]


def runtime_init(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None) -> None:
    """Multi-host bring-up: a no-op in a single-process run.

    One process per host, joined by ``torch.distributed``, is the
    multi-process half of ROADMAP A6 and is not ported; asking for more than
    one process raises.
    """
    if num_processes is not None and num_processes > 1:
        raise NotImplementedError(
            "multi-process runs (torch.distributed, one process per host) are "
            "the multi-process half of ROADMAP A6 and are not ported yet")


def make_row_mesh(n_parts: int | None = None, device=None) -> RowMesh:
    """A mesh of ``n_parts`` parts.

    ``device=None`` places the parts round-robin over the CUDA cards (one
    part per card when ``n_parts`` is None) and raises where torch finds no
    card; any other ``device`` (e.g. "cpu", for the tests) holds every part.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch finds no CUDA card; pass device='cpu' "
                               "to build a mesh on the CPU")
        n_cards = torch.cuda.device_count()
        n = n_cards if n_parts is None else int(n_parts)
        return RowMesh([torch.device("cuda", p % n_cards) for p in range(n)])
    n = 1 if n_parts is None else int(n_parts)
    return RowMesh([torch.device(device)] * n)
