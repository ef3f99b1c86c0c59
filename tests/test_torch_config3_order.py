"""Config #3's float32 orders at full size, bit for bit against the JAX
package's jitted functions on the CPU.

- The power iteration at 128³ (7-point Poisson, 4 and 15 iterations): λ of
  ``device_setup.power_iteration_lambda_max`` == the JAX package's
  ``_jit_power``.  Its norm (``ordered_sum.sumsq(structured=True)``) adds
  the 32³ windows' partials in lanes across their middle axis.
- ``ordered_sum.norm`` of seeded random grids with an axis over 64 ==
  the jitted ``jnp.linalg.norm``.
- The one-hot dot of ``galerkin_block`` (``device_setup._onehot_dot`` in
  ``_dot_order``'s order) == the jitted ``a @ b`` at the shapes the
  structured setups meet (config #3 on one device and in 4 parts, the
  324³×3 slabs, 468³ in 8 parts) and at others of the same kinds: XLA's CPU
  dot sums k in blocks whose width follows the column tile.
- The distributed setup's block scale (``device_setup.eager_block_scale``)
  == the JAX package's eager 1/√max(c, 1).

Inputs are drawn with numpy from a seed; every comparison is of float32
bits (``tests/float_bits.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parallel_amg_tpu.amg import device_setup as jds
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_poisson_stencil

from parallel_amg_tpu_torch.amg import device_setup as ds
from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.problems import poisson_stencil

from float_bits import assert_bits

torch.set_num_threads(2)


@pytest.mark.parametrize("iters", [4, 15])
def test_power_iteration_128_bit_equal_to_jax(iters):
    A = poisson_stencil((128,) * 3, device="cpu")
    d_inv = ds.diag_inverse(A)
    jA = j_poisson_stencil((128,) * 3)
    want = jds._jit_power(jA, jds._jit_dinv(jA), iters=iters, seed=0)
    got = ds.power_iteration_lambda_max(A, d_inv, iters, seed=0)
    assert_bits(got.numpy(), np.float32(want))


# seeds whose partials give another sum in one chain than in lanes
@pytest.mark.parametrize("shape,seed", [((128, 128, 128), 0), ((128, 128, 128), 5),
                                        ((64, 128, 128), 2), ((100, 100, 100), 2)])
def test_norm_bit_equal_to_jitted_norm(shape, seed):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal(shape)
         * np.exp2(rng.integers(-6, 6, shape))).astype(np.float32)
    want = jax.jit(jnp.linalg.norm)(y)
    got = ordered_sum.norm(torch.from_numpy(y), structured=True)
    assert_bits(got.numpy(), np.float32(want))


# (n_out, K, nc): shapes of each kind, then those the setups meet
# (artifacts/galerkin_dot_shapes.json, K after pruning) where XLA blocks k:
# config #3 on one device and in 4 parts, 324³×3 and 468³ in 8 parts
DOT_SHAPES = [(27, 343, 3375), (27, 216, 3375), (27, 125, 3375), (64, 343, 3375),
              (27, 343, 1800), (9, 63, 3375),
              (27, 251, 3375), (27, 311, 125), (27, 63, 22188), (27, 343, 900),
              (27, 63, 268272), (27, 335, 1728), (27, 63, 511056), (27, 311, 216),
              (27, 343, 18928)]


@pytest.mark.parametrize("n_out,K,nc", DOT_SHAPES)
def test_onehot_dot_bit_equal_to_jax(n_out, K, nc):
    rng = np.random.default_rng(K * 7 + nc)
    ids = rng.integers(0, n_out, K)
    onehot = (ids[None, :] == np.arange(n_out)[:, None]).astype(np.float32)
    piece = (rng.standard_normal((K, nc))
             * np.exp2(rng.integers(-8, 8, (K, nc)))).astype(np.float32)
    want = jax.jit(lambda a, b: a @ b)(onehot, piece)
    got = ds._onehot_dot(ids.tolist(), torch.from_numpy(piece), n_out,
                         ds._dot_order(n_out, K, nc))
    assert_bits(got.numpy(), np.asarray(want))


def test_eager_block_scale_bit_equal_to_jax():
    """The JAX package's distributed setup takes 1/√max(c, 1) eagerly
    (``parallel_amg_tpu/parallel/pdevice_setup.py``), not jitted."""
    c = np.arange(0, 100, dtype=np.float32).reshape(4, 5, 5)
    want = 1.0 / jnp.sqrt(jnp.maximum(jnp.asarray(c), 1.0))
    assert_bits(ds.eager_block_scale(torch.from_numpy(c)).numpy(), np.asarray(want))


def test_level_digests_match_the_jax_packages_levels():
    """``utils.metrics.level_digests`` of a port setup equals the digests of
    the JAX package's setup of the same problem (the form
    ``scripts/jax_config3_levels.py`` records), and ``compare_levels`` sees
    a changed weight."""
    import parallel_amg_tpu as pat
    from parallel_amg_tpu.amg.device_setup import device_structured_setup as j_setup

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.utils.metrics import (
        array_digest, compare_levels, f32_bits, level_digests)

    kw = dict(coarsening="sa", aggregate="block", block_size=3, smoother="chebyshev",
              n_coarse_max=64, on_device_setup=True)
    h = ptt.setup(poisson_stencil((12,) * 3, device="cpu"), ptt.AMGConfig(**kw),
                  device="cpu")
    jh = j_setup(j_poisson_stencil((12,) * 3), pat.AMGConfig(**kw))
    want = [{"weights_digest": array_digest(np.asarray(lv.A.weights)),
             "d_inv_digest": array_digest(np.asarray(lv.d_inv)),
             "lam_max_bits": f32_bits(lv.lam_max)} for lv in jh.levels]
    got = level_digests(h)
    rows, same = compare_levels(want, got)
    assert same and len(rows) == len(h.levels) >= 2, rows
    h.levels[1].A.weights[0, 0, 0, 0] += 1.0
    rows, same = compare_levels(want, level_digests(h))
    assert not same and not rows[1]["weights"] and rows[0]["weights"]
