"""The order in which the JAX package's one-device extended+i adds its weak
couplings, measured through its own function on the CPU, per row width.

    JAX_PLATFORMS=cpu python3 scripts/probe_xla_weak_sum.py [--widths 2-40]

XLA marks its CPU reductions ``reassoc``, and LLVM may vectorise the fused
loop of ``jnp.sum(jnp.where(am & ~isdiag & ~in_chat & ~sf, av, 0.0))``
(``parallel_amg_tpu/amg/device_rs.py:265-266``) and so reorder it; what it
does depends on the row width W and on whether ``lax.map`` runs one chunk
or several.  For each W this script runs the probe operators of
``tests/weak_sum_probe.py`` through ``extended_i_interpolation_device``
with one chunk and with three (the JAX package's default chunk), and names
every ``ops/ordered_sum.row_sum`` order that reproduces P bit for bit on
every probe row, beside the order ``ops/ordered_sum.weak_lanes`` takes.
One JSON line per width.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import numpy as np  # noqa: E402

from parallel_amg_tpu_torch.ops.ordered_sum import weak_lanes  # noqa: E402
from weak_sum_probe import orders_that_fit  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--widths", default="2-40")
    lo, hi = (int(v) for v in ap.parse_args().widths.split("-"))
    jax.config.update("jax_platforms", "cpu")
    rng = np.random.default_rng(0)
    for W in range(lo, hi + 1):
        out = {"W": W}
        for chunks, key in ((1, "one_chunk"), (3, "several_chunks")):
            fit = orders_that_fit(W, chunks, rng)
            out[key] = fit[:6]
            out[key + "_port"] = weak_lanes(W, chunks > 1)
            out[key + "_port_fits"] = weak_lanes(W, chunks > 1) in fit
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
