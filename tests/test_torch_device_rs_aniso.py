"""The port's on-device Ruge–Stüben setup against the JAX package's on the
anisotropic operator of acceptance config #4 (ε = 1e-3), at 32².

The checks and tolerances are ``test_torch_device_rs.check_whole_setup``'s;
this case sits in a file of its own so that its minute of JAX compiling runs
beside the Poisson case rather than after it.
"""

import pytest

from test_torch_device_rs import check_whole_setup


@pytest.mark.parametrize("name", ["aniso"])
def test_whole_setup_matches_jax(name):
    check_whole_setup(name)
