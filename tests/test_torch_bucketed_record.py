"""The port's bucketed Galerkin product on the CPU against the JAX package's
bits recorded by ``scripts/jax_bucketed_record.py`` (``artifacts/
bucketed_jax_record.json``), at grids whose JAX compile is too slow for the
tier-1 tests (20–30 s at 27 points) and whose orders depart from the stage
order (``ops/bucket_stage.py``'s ``_DEPARTURES``): 8 × 7 × 6 and 16³ with 27
points, 32³ with 7.  The 52³ 27-point tail of the 468³ setup (~20 s on the
CPU) is held by the script's ``--port`` and by ``chip_smoke.py`` on the card.
"""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax_bucketed_record as rec  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("case", ["probe_8x7x6_27pt", "probe_16^3_27pt", "probe_32^3_7pt"])
def test_bucketed_product_equals_jax_record(case):
    with open(rec.RECORD) as f:
        record = json.load(f)
    assert rec.held(case, rec.port_planes(case, "cpu"), record)
