"""The algebraic layer split over several processes, on the CPU.

Each case spawns gloo ranks (``parallel/launch.py``, a FileStore in a fresh
directory, a join timeout of its own) that hold a block of a CPU mesh's
parts each.  Every per-part result (planes, plans, matvecs on the dense and
the ring plans, ``consistent``, ``assemble``, ``repartition`` and
``pcsr_from_coo_device``) and every whole one (``to_csr``, ``nnz``) is held
bit-equal to the single-process port on the same mesh (``torch_ranks.same``).
No rank imports JAX.
"""

import pytest
import torch

from parallel_amg_tpu_torch.parallel import launch
from parallel_amg_tpu_torch.parallel import mesh as pmesh

import torch_ranks

torch.set_num_threads(2)


@pytest.mark.parametrize("world,S", [(2, 4), (2, 8), (4, 8)])
def test_pcsr_ops_equal_single_process(world, S):
    single = torch_ranks.pcsr_ops(240, S, 5)
    ranks = launch.spawn(torch_ranks.pcsr_ops, world, args=(240, S, 5),
                         timeout_s=60)
    torch_ranks.same(single, ranks)


def test_failing_rank_raises():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.spawn(torch_ranks.fail_on_rank, 2, args=(1,), timeout_s=60)


def test_hanging_rank_times_out():
    with pytest.raises(RuntimeError, match="outlasted their 15"):
        launch.spawn(torch_ranks.hang_on_rank, 2, args=(1,), timeout_s=15)


def test_nccl_needs_a_card_per_rank(tmp_path):
    """Two NCCL ranks on one card (or none) raise before any rendezvous;
    nothing falls back to gloo."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = max(cards + 1, 2)
    with pytest.raises(RuntimeError, match="needs a CUDA card for each"):
        pmesh.runtime_init(str(tmp_path / "store"), num_processes=n,
                           process_id=0, backend="nccl")
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="backend must be one of"):
        pmesh.runtime_init(str(tmp_path / "store"), num_processes=2,
                           process_id=0, backend="mpi")


@pytest.mark.cuda
def test_pcsr_ops_on_the_card_equal_single_process():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 is CUDA C++ and needs a CUDA card")
    single = torch_ranks.pcsr_ops(240, 8, 5, device=None)
    ranks = launch.spawn(torch_ranks.pcsr_ops, 2, args=(240, 8, 5, None),
                         timeout_s=300)
    torch_ranks.same(single, ranks)
