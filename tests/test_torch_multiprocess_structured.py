"""The structured distributed path split over several processes, on the CPU.

``sharded_device_setup`` of the 16³ Poisson stencil born split over 4 CPU
parts (config #3's block SA), 2 per gloo rank and 1 per rank on 4 ranks,
then PCG to 1e-6 under halo_mode "xla" and "pallas_async" (kernel B8's
exchange route: interior, halos through ``exchange``, boundary; its plain
version on the CPU).  The sharded levels' weight planes, λ_max, PCG's count,
residual history and solution are held bit-equal to the single-process port
(``torch_ranks.same``).  No rank imports JAX.
"""

import pytest
import torch

from parallel_amg_tpu_torch.parallel import launch

import torch_ranks

torch.set_num_threads(2)


@pytest.mark.parametrize("world", [2, 4])
def test_structured_setup_and_solve_equal_single_process(world):
    single = torch_ranks.structured_setup((16, 16, 16), 4)
    ranks = launch.spawn(torch_ranks.structured_setup, world,
                         args=((16, 16, 16), 4), timeout_s=60)
    torch_ranks.same(single, ranks)
    assert all(r["route"] == {"xla": False, "pallas_async": True}
               for r in [single] + ranks)
    rep = single["rep"]
    assert rep["xla.history"].tobytes() == rep["pallas_async.history"].tobytes()


@pytest.mark.cuda
def test_structured_on_the_card_equal_single_process():
    """Two ranks sharing the card (gloo, halos staged through pinned host
    memory): kernel B8's exchange route, one halo_stencil_interior launch
    (the parts whose neighbours are local come out whole) and one
    halo_stencil_boundary launch a rank a matvec, bit-equal to the
    one-launch route of a single process."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B8 is CUDA C++ and needs a CUDA card")
    single = torch_ranks.structured_setup((24, 24, 24), 4, device=None)
    ranks = launch.spawn(torch_ranks.structured_setup, 2,
                         args=((24, 24, 24), 4, 0, None), timeout_s=300)
    torch_ranks.same(single, ranks)
    one = single["launches"]["pallas_async"]
    assert one["halo_stencil_matvec"] > 0 and one["halo_stencil_interior"] == 0
    matvecs = one["halo_stencil_matvec"]
    for r in ranks:
        assert r["launches"]["pallas_async"] == {"halo_stencil_matvec": 0,
                                                 "halo_stencil_interior": matvecs,
                                                 "halo_stencil_boundary": matvecs}
    assert not single["route"]["pallas_async"]
    assert all(r["route"]["pallas_async"] for r in ranks)
