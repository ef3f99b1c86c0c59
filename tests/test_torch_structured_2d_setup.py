"""Whole 2-D structured setups in the JAX package's bits.

Config: 2-D 5-point Poisson, block SA with b = 3, Chebyshev,
``n_coarse_max=64``, set up on the device.  Every level's weights, D⁻¹ and
λ_max are held float32 bit for bit (``utils.metrics.level_digests``):

- at 243² (levels 243², 81², 27², 9², 3²) against ``pat.setup`` run here;
- at 1024² (config #2's grid; levels 1024², 342², 114², 38², 13², 5²)
  against ``artifacts/poisson2d_jax_levels.json``, the record
  ``scripts/jax_poisson2d_levels.py`` writes (the JAX package's setup there
  takes ~20 s), with no JAX, as ``chip_smoke.py`` holds the card's run.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.problems import poisson_stencil
from parallel_amg_tpu_torch.utils.metrics import (
    array_digest,
    compare_levels,
    f32_bits,
    level_digests,
)

torch.set_num_threads(2)

RECORD = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts",
                      "poisson2d_jax_levels.json")
KW = dict(coarsening="sa", aggregate="block", block_size=3, smoother="chebyshev",
          n_coarse_max=64, on_device_setup=True)


def _port_levels(n):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        h = ptt.setup(poisson_stencil((n, n), device="cpu"), ptt.AMGConfig(**KW),
                      device="cpu")
    return level_digests(h)


def test_243_hierarchy_bit_equal_to_jax():
    """Every level of the port's 243² setup == ``pat.setup``'s: weights, D⁻¹
    and λ_max bits."""
    pytest.importorskip("jax")
    import parallel_amg_tpu as pat
    from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_pstencil

    jh = pat.setup(j_pstencil((243, 243)), pat.AMGConfig(**KW))
    want = [{"weights_digest": array_digest(np.asarray(lv.A.weights, np.float32)),
             "d_inv_digest": array_digest(np.asarray(lv.d_inv, np.float32)),
             "lam_max_bits": f32_bits(np.float32(lv.lam_max))} for lv in jh.levels]
    got = _port_levels(243)
    assert [lv["dims"] for lv in got] == [[243 // 3 ** k] * 2 for k in range(5)]
    rows, same = compare_levels(want, got)
    assert same, rows


def test_1024_hierarchy_equal_to_jax_record():
    """Every level of the port's 1024² setup on the CPU == the JAX record's
    digests and λ bits."""
    with open(RECORD) as f:
        rec = json.load(f)
    assert rec["n"] == 1024
    got = _port_levels(rec["n"])
    assert [lv["dims"] for lv in got] == [lv["dims"] for lv in rec["levels"]]
    rows, same = compare_levels(rec["levels"], got)
    assert same, rows
