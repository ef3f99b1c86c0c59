"""Run metrics and logging.

Counterpart of ``parallel_amg_tpu/utils/metrics.py``:

- ``rank0_print``: only process 0 of a ``torch.distributed`` job speaks
  (every process speaks when none is initialized);
- ``RunRecord``: one run as a JSON line (iterations, residual history,
  seconds, per-level rows);
- ``residual_history``: a solver's inf-padded history as a numpy array
  without the padding;
- ``hierarchy_summary``: per-level {n, nnz, format};
- ``level_digests``, ``compare_levels``: a structured hierarchy's levels as
  digests of their float32 weights and D⁻¹ and λ's bits, and their match
  against a record of another run (``scripts/jax_config3_levels.py`` writes
  the JAX package's; ``chip_smoke.py`` holds the card to it).
"""

from __future__ import annotations

import dataclasses
import hashlib
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


def array_digest(a) -> str:
    """First 16 hex digits of the sha256 of an array's float32 values in C
    order (a torch tensor on any device, or anything numpy takes)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(np.asarray(a, np.float32)).tobytes()
                          ).hexdigest()[:16]


def f32_bits(v) -> str:
    """A float's float32 bits as hex."""
    return f"0x{int(np.float32(v).view(np.uint32)):08x}"


def level_digests(h) -> list:
    """Per level of a structured hierarchy (a sharded level as its padded
    global arrays): rows, dims, points, the digests of the weights (D, *dims)
    and of D⁻¹, λ_max and its float32 bits."""
    out = []
    for lv in h.levels:
        A = lv.A
        W = A.global_weights() if hasattr(A, "global_weights") else A.weights
        d = lv.d_inv.to_global() if hasattr(lv.d_inv, "to_global") else lv.d_inv
        lam = np.float32(float(lv.lam_max))
        out.append({"rows": int(np.prod(W.shape[1:])), "dims": list(W.shape[1:]),
                    "points": int(W.shape[0]), "weights_digest": array_digest(W),
                    "d_inv_digest": array_digest(d), "lam_max": float(lam),
                    "lam_max_bits": f32_bits(lam)})
    return out


def compare_levels(want: list, got: list):
    """(per level whether weights, D⁻¹ and λ of ``got`` are ``want``'s bit
    for bit, whether every level matched), entries as ``level_digests``."""
    rows = []
    for i in range(max(len(want), len(got))):
        w = want[i] if i < len(want) else {}
        g = got[i] if i < len(got) else {}
        rows.append({"level": i, "dims": g.get("dims"),
                     "weights": w.get("weights_digest") == g.get("weights_digest"),
                     "d_inv": w.get("d_inv_digest") == g.get("d_inv_digest"),
                     "lam": w.get("lam_max_bits") == g.get("lam_max_bits")})
    return rows, all(r["weights"] and r["d_inv"] and r["lam"] for r in rows)
