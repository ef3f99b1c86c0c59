"""The distributed setups and solvers split over two processes, on the CPU.

``distributed_setup`` of poisson2d(32) on 8 CPU parts, 4 per gloo rank: the
float64 host oracle frozen to PCSR levels (each rank runs the oracle and
keeps its parts), the Ruge–Stüben setup and the smoothed-aggregation setup
on the parts' devices.  Every level's planes and plans, its rows and λ_max,
the coarse inverse, PCG's iterate, count and residual history, and FGMRES's
over the host hierarchy are held bit-equal to the single-process port on
the same mesh (``torch_ranks.same``).  No rank imports JAX.
"""

import pytest
import torch

from parallel_amg_tpu_torch.parallel import launch

import torch_ranks

torch.set_num_threads(2)


@pytest.mark.parametrize("kind", ["host", "rs", "sa"])
def test_setup_and_solve_equal_single_process(kind):
    single = torch_ranks.algebraic_setup(32, 8, kind)
    ranks = launch.spawn(torch_ranks.algebraic_setup, 2, args=(32, 8, kind),
                         timeout_s=60)
    torch_ranks.same(single, ranks)
    assert single["rep"]["pcg.iters"] == 7


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["host", "rs"])
def test_setup_and_solve_on_the_card_equal_single_process(kind):
    """Two ranks sharing the card over gloo (CUDA tensors staged through
    pinned host memory): B1, and B3/B5/B4 in the RS setup, bit-equal to one
    process on the card."""
    if not torch.cuda.is_available():
        pytest.skip("kernels B1, B3, B4 and B5 are CUDA C++ and need a CUDA card")
    single = torch_ranks.algebraic_setup(64, 8, kind, device=None)
    ranks = launch.spawn(torch_ranks.algebraic_setup, 2,
                         args=(64, 8, kind, 0, None), timeout_s=300)
    torch_ranks.same(single, ranks)
