"""The row mesh: S parts of a grid's axis 0, spread over the processes.

Counterpart of ``parallel_amg_tpu/parallel/mesh.py``.  The JAX package runs
a 1D ``Mesh`` over the axis "rows": one controller per host after
``jax.distributed.initialize``, each driving its own devices.  The port
keeps the S parts of that mesh and gives each process a contiguous block of
them: process ``rank`` of ``world`` holds the global parts
``mesh.local = [rank·S/world, (rank+1)·S/world)``.  Every plan is built
from the global S; a process's lists hold its own parts only, indexed by
their position in ``mesh.local``.

In one process (``world = 1``, no ``runtime_init``) the process holds every
part: on one card all parts live on ``cuda:0`` as separate allocations; on a
host with several cards they go round-robin over the cards.  Several
processes are joined by ``torch.distributed`` (``runtime_init``), and every
copy between parts goes through ``parallel/exchange.py``.
"""

from __future__ import annotations

import datetime
import os

import torch

ROW_AXIS = "rows"
BACKENDS = ("gloo", "nccl")


def process() -> tuple:
    """(rank, world) of this process: (0, 1) unless ``runtime_init`` joined
    several processes."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class RowMesh:
    """S parts in a row; part p lives on ``device(p)`` of the process that
    holds it, and this process holds the parts ``local``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one part")
        self.rank, self.world = process()
        if self.size % self.world:
            raise ValueError(f"{self.size} parts do not split evenly over "
                             f"{self.world} processes")

    @property
    def size(self) -> int:
        """Number of parts S (the JAX mesh's ``devices.size``)."""
        return len(self.devices)

    @property
    def n_local(self) -> int:
        """Parts a process holds."""
        return self.size // self.world

    @property
    def local(self) -> range:
        """Global ids of this process's parts."""
        return range(self.rank * self.n_local, (self.rank + 1) * self.n_local)

    @property
    def home(self) -> torch.device:
        """The device of this process's first part: where its replicated
        values live (an agglomerated tail, a coarse inverse, reductions)."""
        return self.devices[self.local[0]]

    def device(self, p: int) -> torch.device:
        return self.devices[p]


def _is_path(address: str) -> bool:
    """A coordinator given as a file path (a FileStore), not host:port."""
    return os.sep in address or ":" not in address


def runtime_init(coordinator_address: str | None = None,
                 num_processes: int | None = None,
                 process_id: int | None = None,
                 backend: str = "gloo",
                 timeout_s: float = 300.0) -> None:
    """Join the processes of a multi-process run: a no-op for one process.

    ``coordinator_address`` is "host:port" (a TCP store on rank 0) or the
    path of a file every process can reach (a ``FileStore``).  The caller
    picks the backend:

    - "gloo": the collectives run on host memory; CUDA tensors are staged
      through pinned host buffers (``parallel/exchange.py``), so several
      processes may share one card;
    - "nccl": the collectives run on the cards with no staging.  NCCL needs
      a card for each process of a host and raises here otherwise.  This
      route has not been run.

    A collective that fails raises; nothing switches backends.
    """
    if num_processes is None or int(num_processes) <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address and "
                         "process_id")
    world = int(num_processes)
    if backend == "nccl":
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < per_host:
            raise RuntimeError(
                f"backend 'nccl' needs a CUDA card for each of the {per_host} "
                f"processes of a host, and torch finds {cards}; ranks that "
                "share a card take backend 'gloo'")
    address = str(coordinator_address)
    init = (f"file://{os.path.abspath(address)}" if _is_path(address)
            else f"tcp://{address}")
    torch.distributed.init_process_group(
        backend, init_method=init, world_size=world, rank=int(process_id),
        timeout=datetime.timedelta(seconds=timeout_s))


def make_row_mesh(n_parts: int | None = None, device=None) -> RowMesh:
    """A mesh of ``n_parts`` parts over this run's processes.

    ``device=None`` places the parts on the CUDA cards and raises where
    torch finds none: in one process round-robin over the cards (one part
    per card when ``n_parts`` is None); in a multi-process run all of a
    process's parts on ``cuda:(local_rank % device_count)``.  Any other
    ``device`` (e.g. "cpu", for the tests) holds every part.
    """
    rank, world = process()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("torch finds no CUDA card; pass device='cpu' "
                               "to build a mesh on the CPU")
        n_cards = torch.cuda.device_count()
        if world > 1:
            n = world if n_parts is None else int(n_parts)
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
            return RowMesh([torch.device("cuda", local_rank % n_cards)] * n)
        n = n_cards if n_parts is None else int(n_parts)
        return RowMesh([torch.device("cuda", p % n_cards) for p in range(n)])
    n = world if n_parts is None else int(n_parts)
    return RowMesh([torch.device(device)] * n)
