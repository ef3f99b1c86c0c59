"""Times the kernels of ``csrc/ordered_sum.cu`` on the card at the shapes the
setups and power iterations give them, beside their plain version, one
PyTorch call on the same inputs (another order, a time only) and their
bound, with the card's name and power limit.

    python3 scripts/bench_ordered_sum.py [--parent DIR]

Each input is a seeded draw of the shape config #2 at 1024² gives the
kernel: the 8-part setup's widest windowed row (271 × 1,248), the power
iteration's level-0 norm (2^20 squares), the one-device weak couplings
(20,485 × 21, lanes (4, 2, 0)) and the same schedule over 2^20 rows, level
1's ELL rows of the power iteration (382,317 × 21, one fma chain), and
config #3's level-0 stencil planes (7 × 128³, one fma chain); first, the
device time of one tiny launch (``zero_`` on one float) as the floor under
every kernel.  With ``--parent`` (a checkout whose ``csrc/ordered_sum.cu``
has the earlier interface: one launch per level of windows, 11 ints) the
earlier kernels run on the same inputs in turns with this checkout's
(parent, change, change, parent), each bit-equal to the plain version.
One JSON line per case; device times from CUDA events
(``chip_smoke.device_ms``).
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import PEAK_BYTES_S, PEAK_F32_FLOP_S, device_ms, nvidia_smi  # noqa: E402
from parallel_amg_tpu_torch.ops import _build, ordered_sum  # noqa: E402


def parent_row_sum(parent_dir):
    """``row_sum`` with the earlier kernels (one launch per level of
    windows), built from ``parent_dir``'s csrc/ordered_sum.cu."""
    src = os.path.join(parent_dir, "parallel_amg_tpu_torch", "csrc", "ordered_sum.cu")
    digest = hashlib.sha256(open(src, "rb").read()).hexdigest()[:16]
    out = os.path.join(ROOT, "build", f"ordered_sum_parent-{digest}.so")
    if not os.path.exists(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                       check=True, capture_output=True)
    fn = ctypes.CDLL(out).ordered_sum
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [
        ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(x3, outp, w, n, lo, lanes):
        stream = torch.cuda.current_stream().cuda_stream
        R, d1, d2 = x3.shape
        err = fn(x3.data_ptr(), outp.data_ptr(), R, d1, d2, w[0], w[1], n[0], n[1],
                 lo[0], lo[1], *lanes, stream)
        if err:
            raise RuntimeError(f"parent ordered_sum: cudaError {err}")

    def row_sum(x, dims=1, lanes=None):
        x3, lead = ordered_sum._as_rows(x, dims)
        if lanes is not None:
            R, d1, d2 = x3.shape
            out = torch.empty((R, 1, 1), dtype=x.dtype, device=x.device)
            launch(x3, out, (d1, d2), (1, 1), (0, 0), tuple(lanes))
            return out.reshape(lead)
        while True:
            R, d1, d2 = x3.shape
            (w1, n1, lo1), (w2, n2, lo2) = ordered_sum.windows(d1), ordered_sum.windows(d2)
            out = torch.empty((R, n1, n2), dtype=x.dtype, device=x.device)
            launch(x3, out, (w1, w2), (n1, n2), (lo1, lo2), (0, 0, 0))
            if n1 == 1 and n2 == 1:
                return out.reshape(lead)
            x3 = out

    return row_sum


def bound_ms(n_bytes, flops):
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bench_ordered_sum: no CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    parent = parent_row_sum(args.parent) if args.parent else None
    cases = [
        ("ordered_sum_windows", "8-part widest row", "row_sum", (draw(271, 1248), 1, None)),
        ("ordered_sum_windows", "level-0 norm", "row_sum", (draw(1 << 20) ** 2, 1, None)),
        ("ordered_sum_lanes", "weak couplings", "row_sum", (draw(20485, 21), 1, (4, 2, 0))),
        ("ordered_sum_lanes", "weak couplings, 2^20 rows", "row_sum",
         (draw(1 << 20, 21), 1, (4, 2, 0))),
        ("ordered_sum_lanes", "ELL rows, fma chain", "row_dot",
         (draw(382317, 21), draw(382317, 21), ordered_sum.CHAIN)),
        ("ordered_sum_lanes", "stencil planes, fma chain", "planes_dot",
         (draw(7, 128 ** 3), draw(7, 128 ** 3))),
        ("ordered_sum_staged", "8-part level-0 rows", "row_sum", (draw(131072, 30), 1, None)),
    ]
    card = nvidia_smi()
    one = torch.empty(1, device=dev)
    print(json.dumps({"case": "launch floor: zero_() on one float",
                      "ms": device_ms(lambda: one.zero_()), "card": card}), flush=True)
    for kernel, label, name, a in cases:
        fn = getattr(ordered_sum, name)
        plain = getattr(ordered_sum, f"{name}_plain")
        x = a[0]
        before = dict(ordered_sum.LAUNCHES)
        got = fn(*a)
        launches = {k: v - before[k] for k, v in ordered_sum.LAUNCHES.items() if v > before[k]}
        equal = torch.equal(got.view(torch.int32), plain(*a).view(torch.int32))
        if name == "row_sum":
            n_out, flops = x.shape[:-1].numel(), x.numel()
            library = lambda: x.sum(-1)  # noqa: E731
        elif name == "row_dot":
            n_out, flops = x.shape[0], 2 * x.numel()
            library = lambda: torch.linalg.vecdot(x, a[1])  # noqa: E731
        else:
            n_out, flops = x.shape[1], 2 * x.numel()
            library = lambda: torch.linalg.vecdot(x, a[1], dim=0)  # noqa: E731
        n_bytes = 4 * (sum(t.numel() for t in a if torch.is_tensor(t)) + n_out)
        b_ms, b_by = bound_ms(n_bytes, flops)
        out = {"kernel": kernel, "case": label, "shape": list(x.shape), "launches": launches,
               "bit_equal_plain": equal, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": device_ms(library),
               "plain_ms": device_ms(lambda: plain(*a), reps=1, samples=3, warmup=1)}
        if parent is not None and name == "row_sum":
            p_ok = torch.equal(parent(*a).view(torch.int32), plain(*a).view(torch.int32))
            order = ("parent", "change", "change", "parent")
            times = [device_ms((lambda: parent(*a)) if w == "parent" else (lambda: fn(*a)))
                     for w in order]
            out.update(parent_bit_equal_plain=p_ok, turns=dict(zip(
                ("parent_1", "change_1", "change_2", "parent_2"), times)),
                ms=min(times[1:3]), parent_ms=min(times[0], times[3]))
        else:
            out["ms"] = device_ms(lambda: fn(*a))
        out["share_of_bound"] = b_ms / out["ms"]
        out["card"] = card
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
