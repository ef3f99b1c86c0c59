"""Run metrics and logging.

Counterpart of ``parallel_amg_tpu/utils/metrics.py``:

- ``rank0_print``: only process 0 of a ``torch.distributed`` job speaks
  (every process speaks when none is initialized);
- ``RunRecord``: one run as a JSON line (iterations, residual history,
  seconds, per-level rows);
- ``residual_history``: a solver's inf-padded history as a numpy array
  without the padding;
- ``hierarchy_summary``: per-level {n, nnz, format}.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch


def rank0_print(*args, **kwargs):
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, **kwargs, flush=True)


def residual_history(hist) -> np.ndarray:
    """Strip the inf padding from a solver residual-history array."""
    h = np.asarray(hist.detach().cpu() if isinstance(hist, torch.Tensor)
                   else hist)
    return h[np.isfinite(h)]


@dataclasses.dataclass
class RunRecord:
    name: str
    n: int
    config: dict
    iters: Optional[int] = None
    converged: Optional[bool] = None
    residuals: Optional[list] = None
    setup_s: Optional[float] = None
    solve_s: Optional[float] = None
    per_level: Optional[list] = None  # [{n, nnz, format, spmv_s, gbps}, ...]
    extra: Optional[dict] = None
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d.get("residuals") is not None:
            d["residuals"] = [float(x) for x in d["residuals"]]
        return json.dumps(d)

    def save(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(self.to_json() + "\n")


def hierarchy_summary(h) -> list:
    """Per-level {n, nnz, format} table for a Hierarchy."""
    return [{"n": int(l.A.n_rows), "nnz": int(l.A.nnz),
             "format": type(l.A).__name__} for l in h.levels]
