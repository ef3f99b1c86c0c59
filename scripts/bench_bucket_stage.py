"""Times ``ordered_bucket_stage`` (``csrc/ordered_sum.cu``) on the card at the
stages of config #3's level-0 bucketed product (128³, 7 points) and of the
468³ setup's gathered tail (a seeded 27-point 52³ operator), beside its byte
and operation bounds, with the card's name and power limit.

    python3 scripts/bench_bucket_stage.py [--parent DIR]

Per stage: the kernel's launch alone (the entry point called with the table
already on the card), ``bucket_stage.stage`` as the setup calls it, and,
with ``--parent`` (a checkout whose kernel has the earlier interface: 5
pointers and 7 ints, the table's rows of 8 ints), the earlier kernel on the
same inputs: its launch alone and its ``stage`` as its setup called it (the
table built in Python loops and copied with one blocking copy on every
call), in turns with this checkout's (parent, change, change, parent), each
bit-equal to the plain version.  One JSON line per stage; device times from
CUDA events (``chip_smoke.device_ms``: a sleep kernel ahead of each window,
so host time shows only where it exceeds the device's).
"""

import argparse
import ctypes
import hashlib
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import torch  # noqa: E402

from chip_smoke import PEAK_BYTES_S, PEAK_F32_FLOP_S, device_ms, nvidia_smi  # noqa: E402
from parallel_amg_tpu_torch.amg import device_setup as ds  # noqa: E402
from parallel_amg_tpu_torch.ops import _build, bucket_stage, ordered_sum  # noqa: E402
from parallel_amg_tpu_torch.ops.stencil import Stencil  # noqa: E402
from parallel_amg_tpu_torch.problems import poisson_stencil, seeded_stencil  # noqa: E402

SMS = 132
CLOCK_HZ = 1.755e9


def parent_kernel(parent_dir):
    """The earlier ``ordered_bucket_stage`` entry, built from ``parent_dir``."""
    src = os.path.join(parent_dir, "parallel_amg_tpu_torch", "csrc", "ordered_sum.cu")
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", f"ordered_sum_parent-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(out).ordered_bucket_stage
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def parent_table(table, box_in, box_out, b):
    """The earlier table: rows (kind, k, off, lo) of 8 ints and the source
    boxes, in Python loops over the terms and their target boxes, as the
    earlier ``kernel_table`` built it on every call."""
    from test_torch_bucket_stage import _loop_kernel_table
    return _loop_kernel_table(table, box_in, box_out, b)


def bounds(F, X, Y, table, box_in, box_out, n):
    """(byte bound ms, operation bound ms, shared-load bound ms): F, X and Y
    once each over the HBM rate; two float32 operations a (term, box) pair
    a point over the float32 rate; one warp-wide shared-memory load a (term,
    box) pair a point, one an SM a clock."""
    _, src = bucket_stage.kernel_table(table, box_in, box_out, 3)
    pairs = int((src >= 0).sum())
    n_bytes = 4 * (F.numel() + X.numel() + Y.numel())
    return (1e3 * n_bytes / PEAK_BYTES_S, 1e3 * 2 * pairs * n / PEAK_F32_FLOP_S,
            1e3 * pairs * n / 32 / (SMS * CLOCK_HZ), pairs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(json.dumps({"card": nvidia_smi()}), flush=True)
    parent = parent_kernel(args.parent) if args.parent else None
    A3 = poisson_stencil((128,) * 3, device=dev)
    w52, offs52 = seeded_stencil((52,) * 3, 27, 3)
    A52 = Stencil(torch.from_numpy(w52).to(dev), offs52, (52,) * 3)
    coef = torch.tensor(0.55, device=dev)
    for label, A in (("config3_128^3_level0", A3), ("p468_tail_52^3_27pt", A52)):
        factors, boxes = ds.bucket_stage_factors(A, ds.diag_inverse(A), coef, 3)
        X = torch.ones((1, 1, 1) + A.dims, device=dev)
        for s, (F, box_in, box_out) in enumerate(zip(factors, boxes, boxes[1:])):
            offs = tuple(A.offsets)
            table = bucket_stage.terms(offs, box_in, box_out, 3)
            Y = bucket_stage.stage(F, offs, X, box_in, box_out, 3, A.dims)
            plain = bucket_stage.stage_plain(F, offs, X, box_in, box_out, 3, A.dims)
            equal = bool(torch.equal(Y.view(torch.int32), plain.view(torch.int32)))
            del plain
            flat, n_terms, n_cols, _, _ = bucket_stage._device_table(
                offs, box_in, box_out, 3, bucket_stage.Order(), dev)
            n_in, n_out = X.numel() // A.n, Y.numel() // A.n
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                ordered_sum._kernels()[3](
                    F.data_ptr(), X.data_ptr(), None, Y.data_ptr(), None, flat.data_ptr(),
                    flat[n_terms * bucket_stage.TERM_INTS:].data_ptr(), n_terms, n_in, n_out,
                    n_cols, F.shape[0], *A.dims, 3, 1, 1, 1, stream)

            def staged():
                return bucket_stage.stage(F, offs, X, box_in, box_out, 3, A.dims)

            row = {"case": f"{label}_stage{s + 1}", "bit_equal_plain": equal, "terms": n_terms,
                   "box_in": n_in, "box_out": n_out}
            b_bytes, b_ops, b_smem, pairs = bounds(F, X, Y, table, box_in, box_out, A.n)
            row.update(bound_bytes_ms=b_bytes, bound_ops_ms=b_ops, bound_smem_ms=b_smem,
                       pairs_per_point=pairs)
            runs = {"launch": [], "stage": [], "parent_launch": [], "parent_stage": []}
            if parent is not None:
                rows, src = parent_table(table, box_in, box_out, 3)
                pflat = torch.tensor([v for r in rows for v in r] + [v for c in src for v in c],
                                     dtype=torch.int32).to(dev)
                Yp = torch.empty_like(Y)

                def p_launch(pflat=pflat, rows=rows, src=src):
                    err = parent(F.data_ptr(), X.data_ptr(), Yp.data_ptr(), pflat.data_ptr(),
                                 pflat[len(rows) * 8:].data_ptr(), len(rows), n_out,
                                 len(src[0]), *A.dims, 3, stream)
                    assert err == 0

                def p_stage():
                    r_, s_ = parent_table(table, box_in, box_out, 3)
                    fl = torch.tensor([v for r in r_ for v in r] + [v for c in s_ for v in c],
                                      dtype=torch.int32).to(dev)
                    err = parent(F.data_ptr(), X.data_ptr(), Yp.data_ptr(), fl.data_ptr(),
                                 fl[len(r_) * 8:].data_ptr(), len(r_), n_out, len(s_[0]),
                                 *A.dims, 3, stream)
                    assert err == 0

                p_launch()
                torch.cuda.synchronize()
                row["parent_bit_equal"] = bool(torch.equal(Yp.view(torch.int32),
                                                           Y.view(torch.int32)))
                order = ["parent", "change", "change", "parent"]
            else:
                order = ["change", "change"]
            for who in order:
                if who == "parent":
                    runs["parent_launch"].append(device_ms(p_launch, reps=3, samples=7))
                    runs["parent_stage"].append(device_ms(p_stage, reps=2, samples=5))
                else:
                    runs["launch"].append(device_ms(launch, reps=3, samples=7))
                    runs["stage"].append(device_ms(staged, reps=3, samples=7))
            for k, v in runs.items():
                if v:
                    row[f"{k}_ms"] = statistics.median(v)
                    row[f"{k}_ms_in_turns"] = v
            row["share_of_bound"] = max(b_bytes, b_ops) / row["launch_ms"]
            print(json.dumps(row), flush=True)
            X = Y
        del X, factors


if __name__ == "__main__":
    main()
