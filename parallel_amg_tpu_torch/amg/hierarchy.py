"""AMG hierarchy: per-level operators over tensors, and the setup driver.

Counterpart of ``parallel_amg_tpu/amg/hierarchy.py``.  The host setup runs
the float64 numpy oracle (``oracle/serial_amg.py``) and freezes each level
with ``ops/select.py::best_format`` (DIA for banded operators, TWELL for the
rest), or as a Stencil with block transfers on the structured block-SA path,
then moves the hierarchy to the caller's device.  The on-device setups live
in ``amg/device_setup.py`` (structured block SA), ``amg/device_rs.py``
(Ruge–Stüben) and ``amg/device_sa.py`` (algebraic SA), the last two with ELL
levels; ``with_best_formats`` turns ELL levels into the solve formats and
``with_spmv_backend`` swaps level operators between Stencil and FlatDIA
after setup.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from parallel_amg_tpu_torch.config import AMGConfig
from parallel_amg_tpu_torch.device import resolve_device
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.parallel.pgrid import PGrid


class Level:
    """One multigrid level: A and the transfers to the next-coarser level.

    ``P``/``R`` are ``None`` on the coarsest level.  ``lam_max`` is the
    λ_max(D⁻¹A) estimate used by Chebyshev smoothing (0.0 when unused), a
    Python float holding the float32 value of the setup's estimate.
    ``true_n`` (optional) is the logical row count of a level whose operator
    is padded (the sharded grids pad axis 0), so that complexities count
    true rows.
    """

    def __init__(self, A, P, R, d_inv, lam_max: float, true_n=None):
        self.A = A
        self.P = P
        self.R = R
        self.d_inv = d_inv
        self.lam_max = float(lam_max)
        self.true_n = None if true_n is None else int(true_n)

    @classmethod
    def from_numpy(cls, A, P, R, d_inv, lam_max, dtype=torch.float32) -> "Level":
        """Freeze one host level: scipy/CSR operators (P, R may be None),
        numpy ``d_inv`` and ``lam_max``, all rounded to ``dtype``."""
        from parallel_amg_tpu_torch.ops.select import best_format

        def fmt(M):
            if M is None:
                return None
            return best_format(M if isinstance(M, CSR) else CSR.from_scipy(M),
                               dtype=dtype)

        lam = torch.as_tensor(np.asarray(lam_max, np.float64)).to(dtype)
        return cls(A=fmt(A), P=fmt(P), R=fmt(R),
                   d_inv=torch.from_numpy(np.array(d_inv, np.float64)).to(dtype),
                   lam_max=float(lam))

    def to(self, device) -> "Level":
        return Level(self.A.to(device),
                     None if self.P is None else self.P.to(device),
                     None if self.R is None else self.R.to(device),
                     self.d_inv.to(device), self.lam_max, self.true_n)

    @property
    def n(self) -> int:
        """Logical (unpadded) row count."""
        return self.A.n_rows if self.true_n is None else self.true_n


def coarse_inverse(dense, rel_tol: float = 1e-6):
    """Dense coarse-level solve operator M⁻¹ on the tensor's device: the
    eigh pseudo-inverse of the symmetric part in the input's type (float32
    for a float32 matrix), with the modes at or below rel_tol·max|w| zeroed,
    so a slightly indefinite coarsest operator does not NaN the coarse
    solve.  The device form of ``coarse_inverse_np``; the setups build the
    coarse inverse with the float64 host form, as the JAX package does."""
    S = 0.5 * (dense + dense.T)
    w, V = torch.linalg.eigh(S)
    wmax = w.abs().max() if w.numel() else torch.ones((), dtype=w.dtype,
                                                      device=w.device)
    good = w > rel_tol * wmax
    winv = torch.where(good, 1.0 / torch.where(good, w, 1.0), 0.0)
    return (V * winv[None, :]) @ V.T


def coarse_inverse_np(dense, rel_tol: float = 1e-6):
    """Dense coarse-level solve operator M⁻¹ (numpy, f64) via symmetric eigh.

    The eigendecomposition pseudo-inverse zeroes the non-positive modes, so a
    slightly indefinite coarsest operator does not NaN the coarse solve, and
    applying M⁻¹ is one dense matmul.
    """
    S = 0.5 * (dense + dense.T)
    w, V = np.linalg.eigh(S)
    wmax = np.max(np.abs(w)) if w.size else 1.0
    winv = np.where(w > rel_tol * wmax, 1.0 / np.where(w > rel_tol * wmax, w, 1.0), 0.0)
    return (V * winv[None, :]) @ V.T


class Hierarchy:
    """Full AMG hierarchy: levels, the dense coarse inverse and the config."""

    def __init__(self, levels: List[Level], coarse_inv, config: AMGConfig):
        self.levels = levels
        # Dense solve operator M⁻¹ for the coarsest-level matrix (eigh
        # pseudo-inverse — see coarse_inverse_np).
        self.coarse_inv = coarse_inv
        self.config = config
        # Per-level shapes and seconds per phase of the on-device
        # Ruge–Stüben setup that built this hierarchy (None otherwise).
        self.setup_stats = None

    def to(self, device) -> "Hierarchy":
        return Hierarchy([l.to(device) for l in self.levels],
                         self.coarse_inv.to(device), self.config)

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def complexity(self):
        """(grid_complexity, operator_complexity) — host-side diagnostics.

        Counts true rows and nnz: a padded level's padding rows carry one
        identity entry each, which the nnz count leaves out.
        """
        rows = [l.n for l in self.levels]
        nnz = [l.A.nnz - (0 if l.true_n is None else l.A.n_rows - l.true_n)
               for l in self.levels]
        return sum(rows) / rows[0], sum(nnz) / nnz[0]

    @property
    def grid_dims(self):
        """Level-0 grid dims when the hierarchy is stencil-structured."""
        return getattr(self.levels[0].A, "dims", None)

    def to_grid(self, v):
        """User-facing 1D vector → internal layout (identity unless the
        level-0 operator carries grid dims; a PGrid passes unchanged)."""
        dims = self.grid_dims
        if dims is not None and v.ndim == 1 and not isinstance(v, PGrid):
            return v.reshape(dims)
        return v

    def from_grid(self, v):
        """Internal layout → user-facing 1D vector (a PGrid passes
        unchanged: ``collect_grid`` strips its padding)."""
        return v.reshape(-1) if v.ndim > 1 and not isinstance(v, PGrid) else v


def with_spmv_backend(h: "Hierarchy", backend: str = "mixed") -> "Hierarchy":
    """Swap the level operators' SpMV engine after setup.

    backend="pallas" turns every Stencil level operator into FlatDIA, whose
    matvec is kernel B2 (``csrc/flatdia_spmv.cu``) on the card; "xla" turns
    FlatDIA levels back into N-D Stencils (plain torch shifted slices);
    "mixed" puts stencils of 9 points or more on the kernel and leaves the
    thin ones (the 7-point fine level) as Stencils.  The backend names are
    the JAX package's.  Unlike the JAX package, which keeps every level on
    XLA off the TPU, the port applies the point rule on every device, so the
    CPU walks the same format choices (with the kernel's plain version).
    FlatDIA levels whose flattening merged aliased planes stay FlatDIA.
    Transfers and smoother data are untouched.
    """
    from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    if backend not in ("mixed", "pallas", "xla"):
        raise ValueError(f"backend must be mixed|pallas|xla, got {backend!r}")

    def want_kernel(A) -> bool:
        if backend == "mixed":
            return A.n_points >= 9
        return backend == "pallas"

    def convert(A):
        if isinstance(A, Stencil) and want_kernel(A):
            return FlatDIA.from_stencil(A)
        if isinstance(A, FlatDIA) and not want_kernel(A):
            return A.to_stencil() or A
        return A

    levels = [Level(convert(l.A), l.P, l.R, l.d_inv, l.lam_max, l.true_n)
              for l in h.levels]
    return Hierarchy(levels, h.coarse_inv, h.config)


def with_best_formats(h: "Hierarchy", device: bool = False) -> "Hierarchy":
    """Convert ELL level operators (A, P, R) to the solve formats: DIA for
    banded square operators, TWELL for everything else, on every device.

    ``device=True`` builds them where the planes lie
    (``ops/format_device.py``; only sizes and offsets reach the host);
    ``device=False`` copies each operator to the host and goes through
    ``ops/select.py::best_format``.  Both give the same operators.  The JAX
    package's ``target_backend`` chose TWELL on TPUs only; the port takes
    TWELL everywhere, so the argument has no counterpart.
    """
    from parallel_amg_tpu_torch.ops.ell import ELL
    from parallel_amg_tpu_torch.ops.select import best_format

    if device:
        from parallel_amg_tpu_torch.ops.format_device import (
            best_format_from_ell as conv,
        )
    else:
        def conv(T):
            if not isinstance(T, ELL):
                return T
            return best_format(T.to_csr(), dtype=T.vals.dtype).to(
                T.vals.device)

    levels = [Level(conv(l.A), conv(l.P), conv(l.R), l.d_inv, l.lam_max,
                    l.true_n) for l in h.levels]
    return Hierarchy(levels, h.coarse_inv, h.config)


# ---------------------------------------------------------------------------
# Setup driver
# ---------------------------------------------------------------------------

def setup(A, config: AMGConfig = AMGConfig(), *, device=None,
          dtype=torch.float32, seed: int = 0, dims=None) -> Hierarchy:
    """Build an AMG hierarchy on ``device`` (the CUDA card when None).

    ``A`` is a host CSR, COO or scipy matrix, or a Stencil.  ``dims``, the
    grid shape of the row space, enables the structured aggregate="block"
    SA path (Stencil levels with block transfers).

    - ``config.on_device_setup=False``: the host setup (numpy oracle), frozen
      to tensors on ``device``.
    - ``config.on_device_setup=True``: the structured block-SA setup on
      ``device`` (``amg/device_setup.py``), from a Stencil or from a matrix
      with ``dims``; with ``coarsening="rs"`` the Ruge–Stüben setup on
      ``device`` (``amg/device_rs.py``); with ``coarsening="sa"`` and any
      other aggregation (or no ``dims``) the algebraic SA setup on
      ``device`` (``amg/device_sa.py``: MIS aggregation, smoothed tentative
      P).  Levels of the two algebraic setups stay ELL until
      ``with_best_formats``.
    """
    dev = resolve_device(device)
    if config.on_device_setup:
        from parallel_amg_tpu_torch.amg.device_setup import (
            device_structured_setup,
        )
        from parallel_amg_tpu_torch.ops.stencil import Stencil

        if isinstance(A, Stencil):
            return device_structured_setup(A.to(dev), config, dtype=dtype,
                                           seed=seed)
        if (dims is not None and config.coarsening == "sa"
                and config.aggregate == "block"):
            st = Stencil.from_csr(_host_csr(A), dims, dtype=dtype)
            if st is None:
                raise ValueError("matrix is not stencil-structured on dims")
            return device_structured_setup(st.to(dev), config, dtype=dtype,
                                           seed=seed)
        if config.coarsening == "rs":
            from parallel_amg_tpu_torch.amg.device_rs import device_rs_setup

            return device_rs_setup(A, config, dtype=dtype, seed=seed,
                                   device=dev)
        # algebraic SA: MIS aggregation and the smoothed tentative P
        from parallel_amg_tpu_torch.amg.device_sa import device_sa_setup

        return device_sa_setup(A, config, dtype=dtype, seed=seed, device=dev)
    return host_setup(A, config, device=dev, dtype=dtype, seed=seed,
                      dims=dims)


def _host_csr(A) -> CSR:
    if isinstance(A, CSR):
        return A
    if hasattr(A, "to_csr"):  # COO, Stencil
        return A.to_csr()
    return CSR.from_scipy(A)


def _host_scipy(A):
    if isinstance(A, CSR) or hasattr(A, "to_csr"):
        return _host_csr(A).to_scipy()
    return A  # scipy sparse or dense


def host_setup(A, config: AMGConfig, *, device=None, dtype=torch.float32,
               seed: int = 0, dims=None) -> Hierarchy:
    """Host (numpy, float64) setup → hierarchy of tensors on ``device``.

    Runs the oracle's algorithms, then freezes each level into its solve
    format (ops/select.py); structured block-SA levels become Stencils with
    reshape-based BlockProlongator/BlockRestrictor transfers instead of
    sparse P/R.
    """
    from parallel_amg_tpu_torch.amg.transfers import (
        BlockProlongator,
        BlockRestrictor,
    )
    from parallel_amg_tpu_torch.ops.select import best_format
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.oracle.serial_amg import oracle_setup

    dev = resolve_device(device)
    oh = oracle_setup(_host_scipy(A), config, seed=seed, dims=dims)

    # dims per level (structured path): level i's grid = previous cdims
    level_dims: List = []
    cur = tuple(dims) if dims is not None else None
    for ol in oh.levels:
        level_dims.append(ol.dims if ol.dims is not None else cur)
        cur = ol.cdims if ol.cdims is not None else None

    block_sa = config.coarsening == "sa" and config.aggregate == "block"
    levels: List[Level] = []
    n_levels = len(oh.levels)
    for i, ol in enumerate(oh.levels):
        A_i = None
        if block_sa and level_dims[i] is not None:
            A_i = Stencil.from_csr(CSR.from_scipy(ol.A), level_dims[i],
                                   dtype=dtype)
            if A_i is None:
                # stencil blow-up: this level becomes the coarsest
                n_levels = i + 1
        if A_i is None:
            levels.append(Level.from_numpy(
                ol.A, ol.P if i + 1 < n_levels else None,
                ol.R if i + 1 < n_levels else None, ol.d_inv, ol.lam_max,
                dtype=dtype))
        else:
            lam = float(torch.as_tensor(np.float64(ol.lam_max)).to(dtype))
            d_inv = torch.from_numpy(np.array(ol.d_inv, np.float64)).to(
                dtype).reshape(A_i.dims)
            P = R = None
            if ol.P is not None and i + 1 < n_levels:
                if ol.dims is not None:
                    coef = float(torch.tensor(
                        config.sa_omega / max(ol.lam_max, 1e-30),
                        dtype=torch.float64).to(dtype))
                    scale = torch.from_numpy(np.array(ol.agg_scale, np.float64)).to(
                        dtype).reshape(ol.cdims)
                    P = BlockProlongator(None, None, scale, coef, ol.dims,
                                         ol.cdims, config.block_size)
                    R = BlockRestrictor(None, None, scale, coef, ol.dims,
                                        ol.cdims, config.block_size)
                else:
                    P = best_format(CSR.from_scipy(ol.P), dtype=dtype)
                    R = best_format(CSR.from_scipy(ol.R), dtype=dtype)
            levels.append(Level(A_i, P, R, d_inv, lam))
        if i + 1 == n_levels:
            break
    # Solve operator in f32 even when the cycle runs in a lower precision
    # (the coarse level is tiny).
    coarse_inv = torch.from_numpy(
        coarse_inverse_np(oh.levels[n_levels - 1].A.toarray())).to(torch.float32)
    return Hierarchy(levels, coarse_inv, config).to(dev)
