"""Profiling and debug helpers.

Counterpart of ``parallel_amg_tpu/utils/profiling.py``:

- ``trace(log_dir)``: ``torch.profiler`` over a region (host and, where
  there is a card, CUDA activity), written as a Chrome trace
  ``log_dir/trace.json``;
- ``check_finite(tree, name)``: a NaN/Inf guard over every floating tensor
  of a hierarchy, a result or any graph of tensors (one host read each).

The JAX package's ``debug_mode`` has no counterpart.  It forces Pallas
interpret mode so that kernels run in the Python interpreter.  The port
reaches each kernel's plain version by putting the tensors on the CPU; a
switch that sent card tensors to the plain versions would be a fallback
that hides the kernel, which the port does not have.
"""

from __future__ import annotations

import contextlib
import os

import torch

from parallel_amg_tpu_torch.utils.tree import tensors


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region: ``with trace("prof"): amg_pcg(...)``; yields the
    ``torch.profiler.profile`` object and writes ``log_dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def check_finite(tree, name: str = "value") -> None:
    """Raise ``FloatingPointError`` at the first floating tensor of
    ``tree`` with a NaN or Inf."""
    for i, t in enumerate(tensors(tree)):
        if t.is_floating_point():
            bad = int((~torch.isfinite(t)).sum())
            if bad:
                raise FloatingPointError(
                    f"{name}: tensor {i} has {bad} non-finite entries")
