"""The port's on-device algebraic SA setup against the JAX package's on 3D
Poisson at 10³ (``tests/test_device_sa.py``'s 3D case): level rows,
operators as per-row (col, val) sets and PCG iterations as in
``test_torch_device_sa.py``, and at most 30 iterations to 1e-6.  A file of
its own, so that its JAX setup runs beside the 2D one.
"""

from test_torch_device_sa import check_setup_parity


def test_device_sa_setup_matches_jax_3d():
    _, res, _, _ = check_setup_parity("poisson3d_10", 1)
    assert res.iters <= 30
