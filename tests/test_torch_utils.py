"""The port's utilities (``utils/``) against the JAX package's.

- checkpoints: a saved and reloaded hierarchy gives a bit-equal V-cycle
  (``tests/test_checkpoint.py`` holds the JAX package to rtol 1e-6), solver
  state survives, and ``load_hierarchy(dtype=torch.bfloat16)`` is the cast of
  ``cast_hierarchy``;
- ``hierarchy_summary`` equals the JAX package's on one hierarchy carried
  across by ``interop.hierarchy_from_numpy``, and ``residual_history`` of the
  two PCG runs on it has the same length and values to rtol 1e-4 (float32
  cycles summed in another order);
- ``spmv_bytes`` against hand counts of the port's layouts (the bytes that
  ``chip_smoke.py`` charges the kernels);
- ``cycle_collective_volume`` equal to the JAX package's on the 27³ fixture
  of ``tests/test_roofline_model.py``, before and after a backend swap;
- ``cycle_latency_model``, ``scaling_projection`` and
  ``weak_scaling_projection`` equal to the JAX package's, number for number,
  on a 12³ structured hierarchy on one device and 24 × 12 × 12 in 4 parts, both given the
  JAX module's link rate and latency; the port's refuse to run without them;
- ``check_finite`` raises on a NaN; ``trace`` writes a Chrome trace.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.amg.hierarchy import with_spmv_backend as j_with_spmv_backend
from parallel_amg_tpu.problems import poisson2d as j_poisson2d
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_pstencil
from parallel_amg_tpu.utils.metrics import hierarchy_summary as j_summary
from parallel_amg_tpu.utils.metrics import residual_history as j_history
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pdevice_setup as jpd
from parallel_amg_tpu.utils import roofline as j_roofline
from parallel_amg_tpu.utils.roofline import (
    cycle_collective_volume as j_collective_volume,
)

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.ops.bsr import BSR
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
from parallel_amg_tpu_torch.ops.twell import TWELL
from parallel_amg_tpu_torch.problems import poisson2d, poisson_stencil
from parallel_amg_tpu_torch.utils import checkpoint, metrics, profiling, roofline

torch.set_num_threads(2)


def _block_sa_cfg(mod, n_coarse_max=64):
    return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=2,
                         smoother="chebyshev", n_coarse_max=n_coarse_max)


@functools.cache
def _h24():
    coo = poisson2d(24)
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    return ptt.setup(A, _block_sa_cfg(ptt), device="cpu", dims=(24, 24)), A


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("which", ["block_sa", "rs"])
def test_hierarchy_roundtrip(tmp_path, rng, which):
    if which == "block_sa":
        h, A = _h24()
    else:
        A = poisson2d(24).to_csr().to_scipy()
        h = ptt.setup(A, ptt.AMGConfig(coarsening="rs", smoother="chebyshev",
                                       n_coarse_max=32), device="cpu")
    path = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(path, h)
    h2 = checkpoint.load_hierarchy(path, device="cpu")
    assert len(h2.levels) == len(h.levels)
    assert h2.config == h.config
    assert [type(l.A) for l in h2.levels] == [type(l.A) for l in h.levels]
    assert [l.lam_max for l in h2.levels] == [l.lam_max for l in h.levels]
    b = torch.from_numpy(rng.normal(size=A.shape[0]).astype(np.float32))
    x1 = ptt.vcycle(h, torch.zeros_like(b), b)
    x2 = ptt.vcycle(h2, torch.zeros_like(b), b)
    assert _bits_equal(x1, x2)


def test_solver_state_roundtrip(tmp_path, rng):
    """Long-CG checkpointing: (x, r, k) state survives a save/load."""
    state = {"x": torch.from_numpy(rng.normal(size=64).astype(np.float32)),
             "r": torch.from_numpy(rng.normal(size=64).astype(np.float32)),
             "k": torch.tensor(17), "note": "cg", "hist": [1.0, 0.5]}
    path = str(tmp_path / "state.pt")
    checkpoint.save_pytree(path, state)
    state2 = checkpoint.load_pytree(path, device="cpu")
    assert torch.equal(state["x"], state2["x"]) and torch.equal(state["r"], state2["r"])
    assert int(state2["k"]) == 17 and state2["note"] == "cg"
    assert state2["hist"] == [1.0, 0.5]
    state16 = checkpoint.load_pytree(path, dtype=torch.bfloat16, device="cpu")
    assert state16["x"].dtype == torch.bfloat16 and state16["k"].dtype == torch.int64


def test_load_hierarchy_bf16(tmp_path, rng):
    """load_hierarchy(dtype=bfloat16) is cast_hierarchy of the saved one:
    bfloat16 levels, a float32 coarse inverse, the same V-cycle bits."""
    h, A = _h24()
    path = str(tmp_path / "h.pt")
    checkpoint.save_hierarchy(path, h)
    h16 = checkpoint.load_hierarchy(path, dtype=torch.bfloat16, device="cpu")
    hc = checkpoint.cast_hierarchy(h, torch.bfloat16)
    assert h16.coarse_inv.dtype == torch.float32
    for l16, lc in zip(h16.levels, hc.levels):
        assert l16.A.weights.dtype == torch.bfloat16
        assert l16.d_inv.dtype == torch.bfloat16
        assert torch.equal(l16.A.weights, lc.A.weights)
        assert l16.lam_max == lc.lam_max
    b = torch.from_numpy(rng.normal(size=A.shape[0]).astype(np.float32))
    y16 = ptt.vcycle(h16, torch.zeros_like(b), b)
    assert y16.dtype == torch.float32 and bool(torch.isfinite(y16).all())
    assert _bits_equal(y16, ptt.vcycle(hc, torch.zeros_like(b), b))
    res = ptt.amg_pcg(h.levels[0].A, h16, b, tol=1e-6, maxiter=60)
    assert res.converged


def test_checkpoint_refuses_distributed_levels(tmp_path):
    mesh = ptt.make_row_mesh(2, device="cpu")
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid

    g = PGrid.from_global(torch.zeros(8, 4), mesh)
    with pytest.raises(TypeError, match="mesh"):
        checkpoint.save_pytree(str(tmp_path / "g.pt"), g)


def _jax_level_arrays(jh):
    """The JAX block-SA hierarchy as the host arrays interop takes."""
    def op(o):
        if o is None:
            return None
        name = type(o).__name__
        if name == "Stencil":
            return {"format": "Stencil", "weights": np.asarray(o.weights),
                    "offsets": o.offsets, "dims": o.dims}
        return {"format": name, "scale": np.asarray(o.scale),
                "coef": np.asarray(o.coef), "dims": o.dims, "cdims": o.cdims,
                "block": o.block}

    return [{"A": op(l.A), "P": op(l.P), "R": op(l.R),
             "d_inv": np.asarray(l.d_inv), "lam_max": np.asarray(l.lam_max)}
            for l in jh.levels]


def test_summary_and_history_match_jax():
    coo = j_poisson2d(32)
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    jh = pat.setup(A, _block_sa_cfg(pat), dims=(32, 32))
    carried = interop.hierarchy_from_numpy(
        _jax_level_arrays(jh), np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), device="cpu")
    assert metrics.hierarchy_summary(carried) == j_summary(jh)
    b = np.random.default_rng(0).normal(size=A.shape[0]).astype(np.float32)
    res = ptt.amg_pcg(None, carried, torch.from_numpy(b), tol=1e-6, maxiter=60)
    jres = pat.amg_pcg(jh.levels[0].A, jh, jnp.asarray(b), tol=1e-6, maxiter=60)
    mine, theirs = metrics.residual_history(res.residual_history), j_history(
        jres.residual_history)
    assert len(mine) == len(theirs) == res.iters + 1
    np.testing.assert_allclose(mine, theirs, rtol=1e-4)
    rec = metrics.RunRecord(name="poisson2d(32)", n=A.shape[0], config={},
                            iters=res.iters, residuals=list(mine))
    assert json.loads(rec.to_json())["residuals"] == [float(v) for v in mine]


def test_spmv_bytes_hand_counts():
    """Each input read once, each output written once, in the port's
    layouts (n = 100 rows of a 10×10 5-point stencil, 460 nonzeros)."""
    st = poisson_stencil((10, 10), device="cpu")
    csr = st.to_csr()
    n, nnz = 100, 460
    assert roofline.spmv_bytes(st) == 5 * n * 4 + 2 * n * 4
    assert roofline.spmv_bytes(st, k=3) == 5 * n * 4 + 2 * n * 3 * 4
    fd = FlatDIA.from_stencil(st)
    assert roofline.spmv_bytes(fd) == 5 * n * 4 + 2 * n * 4
    fd16 = FlatDIA(fd.diags.bfloat16(), fd.offsets, fd.n)
    assert roofline.spmv_bytes(fd16) == 5 * n * 2 + 2 * n * 4
    assert roofline.spmv_bytes(DIA.from_csr(csr)) == 5 * n * 4 + 2 * n * 4
    assert roofline.spmv_bytes(ELL.from_csr(csr)) == n * 5 * 8 + 2 * n * 4
    # CSR stream: indptr, then an int32 column and a value per entry
    assert roofline.spmv_bytes(TWELL.from_csr(csr)) == (n + 1) * 4 + nnz * 8 + 2 * n * 4
    assert roofline.spmv_bytes(TWELL.from_csr(csr, dtype=torch.bfloat16)) == \
        (n + 1) * 4 + nnz * 6 + 2 * n * 4
    rect = CSR.from_scipy(sp.random(30, 50, density=0.2, random_state=1, format="csr"))
    assert roofline.spmv_bytes(TWELL.from_csr(rect)) == 31 * 4 + rect.nnz * 8 + 50 * 4 + 30 * 4
    # BSR, bs 2: one int32 column and bs² values per live block
    bsr = BSR.from_csr(csr, 2)
    live = int(bsr.brow_nnz.sum())
    assert roofline.spmv_bytes(bsr) == live * (4 + 4 * 4) + 50 * 4 + n * 4 + n * 4
    with pytest.raises(ValueError):
        roofline.spmv_bytes(TWELL.from_csr(csr), k=2)
    rep = roofline.report(st, 1e-6, 1000.0)
    assert rep.bytes_model == 2800 and rep.achieved_gbps == pytest.approx(2.8)
    assert rep.nnz == nnz and "of SoL" in rep.row()


@functools.cache
def _h27():
    def cfg(mod):
        return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                             smoother="chebyshev", n_coarse_max=64,
                             on_device_setup=True)

    return (ptt.setup(poisson_stencil((27,) * 3, device="cpu"), cfg(ptt), device="cpu"),
            pat.setup(j_pstencil((27, 27, 27)), cfg(pat)))


@pytest.mark.parametrize("backend", [None, "pallas", "mixed"])
def test_cycle_collective_volume_matches_jax(backend):
    h, jh = _h27()
    if backend is not None:
        h, jh = ptt.with_spmv_backend(h, backend), j_with_spmv_backend(jh, backend)
    for shards in (2, 8):
        mine = roofline.cycle_collective_volume(h, shards)
        assert mine == j_collective_volume(jh, shards)
        assert mine["per_shard_cycle_bytes"] == roofline.cycle_collective_volume(
            _h27()[0], shards)["per_shard_cycle_bytes"]


@functools.cache
def _h12(parts: int):
    """The port's and the JAX package's structured setups: 12³ on one device,
    24 × 12 × 12 in ``parts`` parts (two sharded levels)."""
    def cfg(mod):
        return mod.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                             smoother="chebyshev", n_coarse_max=64, agglomerate_n=256,
                             on_device_setup=True)

    if parts == 1:
        dims = (12, 12, 12)
        return (ptt.setup(poisson_stencil(dims, device="cpu"), cfg(ptt), device="cpu"),
                pat.setup(j_pstencil(dims), cfg(pat)))
    dims = (24, 12, 12)
    A, td = ptt.poisson_stencil_sharded(dims, ptt.make_row_mesh(parts, device="cpu"), cfg(ptt))
    jA, jtd = jpd.poisson_stencil_sharded(dims, j_make_row_mesh(parts), cfg(pat))
    return (ptt.sharded_device_setup(A, cfg(ptt), true_dims=td),
            jpd.sharded_device_setup(jA, cfg(pat), true_dims=jtd))


_PROJECTIONS = {
    "cycle_latency_model": lambda m, h, **k: m.cycle_latency_model(h, 4, 256, **k),
    "scaling_projection": lambda m, h, **k: m.scaling_projection(h, 2.5e-3, (1, 2, 4, 8), 256,
                                                                 **k),
    "weak_scaling_projection": lambda m, h, **k: (
        m.weak_scaling_projection(h, 2.5e-3, (1, 2, 4, 8), 256, **k)
        + m.weak_scaling_projection(h, 2.5e-3, (2, 8), 256, scale_rows_to=13_000_000, **k)),
}


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("name", sorted(_PROJECTIONS))
def test_projections_match_jax(name, parts):
    """The port's projection gives every number and key of the JAX
    package's when both take the JAX module's two constants."""
    h, jh = _h12(parts)
    if parts > 1:
        assert h.setup_stats["sharded_levels"] >= 1
    jk = dict(ici_gbps=j_roofline.ICI_LINK_GBPS, lat_s=j_roofline.COLLECTIVE_LATENCY_S)
    mine = _PROJECTIONS[name](roofline, h, link_gbps=j_roofline.ICI_LINK_GBPS,
                              latency_s=j_roofline.COLLECTIVE_LATENCY_S)
    assert mine == _PROJECTIONS[name](j_roofline, jh, **jk)


def test_projections_need_the_link_figures():
    """No link rate or latency of the port's own: each projection raises
    without them."""
    h, _ = _h12(1)
    assert not any(hasattr(roofline, k) for k in ("ICI_LINK_GBPS", "COLLECTIVE_LATENCY_S"))
    for name, call in _PROJECTIONS.items():
        with pytest.raises(TypeError):
            call(roofline, h)
        with pytest.raises(TypeError):
            call(roofline, h, link_gbps=100.0)


def test_check_finite_raises_on_nan():
    h, _ = _h24()
    profiling.check_finite(h, "h")
    bad = {"x": torch.tensor([1.0, float("nan"), 2.0]), "k": torch.tensor([3])}
    with pytest.raises(FloatingPointError, match="1 non-finite"):
        profiling.check_finite(bad, "state")
    profiling.check_finite({"k": torch.tensor([3])})


def test_trace_writes_a_chrome_trace(tmp_path):
    h, A = _h24()
    b = torch.ones(A.shape[0])
    with profiling.trace(str(tmp_path / "prof")) as prof:
        ptt.vcycle(h, torch.zeros_like(b), b)
    assert prof.key_averages()
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any("add" in str(e.get("name", "")) for e in events)


def test_rank0_print_speaks_without_a_process_group(capsys):
    metrics.rank0_print("hello", 3)
    assert capsys.readouterr().out == "hello 3\n"
