"""The port's slice (host setup → vcycle / solve → amg_pcg) against the JAX
package on the same matrices and right-hand sides.

Setup runs the same float64 oracle in both packages, so every level must be
equal exactly after the float32 cast.  Cycles and solves run in float32 with
sums in another order; tolerances are stated at each check.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.problems import poisson2d as j_poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch import interop
from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg2(mod):
    """Acceptance config #2's AMGConfig, coarsened to 64 rows at 48²."""
    return mod.AMGConfig(coarsening="rs", smoother="chebyshev",
                         n_coarse_max=64, interpolation="extended_i")


@functools.cache
def _pair(n, which):
    """(port hierarchy, JAX hierarchy, scipy A) for poisson2d(n)."""
    cfg = _cfg2 if which == 2 else (
        lambda mod: mod.AMGConfig(coarsening="rs", smoother="jacobi"))
    h = ptt.setup(poisson2d(n).to_csr(), cfg(ptt), device="cpu")
    jh = pat.setup(j_poisson2d(n).to_csr(), cfg(pat))
    return h, jh, poisson2d(n).to_csr().to_scipy()


def _rhs(n):
    return np.random.default_rng(0).normal(size=n).astype(np.float32)


def _jax_level_arrays(jh):
    """The JAX hierarchy as host arrays, the form interop takes."""
    levels = []
    for l in jh.levels:
        levels.append({
            "A": l.A.to_csr().to_scipy(),
            "P": None if l.P is None else l.P.to_csr().to_scipy(),
            "R": None if l.R is None else l.R.to_csr().to_scipy(),
            "d_inv": np.asarray(l.d_inv),
            "lam_max": np.asarray(l.lam_max),
        })
    return levels


def _assert_same_csr(mine, theirs):
    a, b = mine.to_csr(), theirs.to_csr()
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data.astype(np.float32),
                                  np.asarray(b.data, np.float32))


def test_setup_parity_level_by_level():
    h, jh, _ = _pair(48, 2)
    assert [l.A.n_rows for l in h.levels] == [l.A.n_rows for l in jh.levels]
    assert h.n_levels >= 3
    for l, jl in zip(h.levels, jh.levels):
        _assert_same_csr(l.A, jl.A)
        assert (l.P is None) == (jl.P is None) and (l.R is None) == (jl.R is None)
        if l.P is not None:
            _assert_same_csr(l.P, jl.P)
            _assert_same_csr(l.R, jl.R)
        np.testing.assert_array_equal(l.d_inv.numpy(), np.asarray(jl.d_inv))
        assert l.lam_max == float(np.asarray(jl.lam_max))
    np.testing.assert_array_equal(h.coarse_inv.numpy(), np.asarray(jh.coarse_inv))
    np.testing.assert_allclose(h.complexity(), jh.complexity(), rtol=1e-12)


def test_vcycle_parity():
    """One V-cycle from the same x and b: ‖Δ‖/‖x_jax‖ ≤ 1e-5."""
    h, jh, A = _pair(48, 2)
    rng = np.random.default_rng(1)
    x = rng.normal(size=A.shape[0]).astype(np.float32)
    b = _rhs(A.shape[0])
    mine = ptt.vcycle(h, torch.from_numpy(x), torch.from_numpy(b)).numpy()
    theirs = np.asarray(pat.vcycle(jh, jnp.asarray(x), jnp.asarray(b)))
    assert np.linalg.norm(mine - theirs) <= 1e-5 * np.linalg.norm(theirs)


def test_pcg_parity_with_jax_and_oracle():
    h, jh, A = _pair(48, 2)
    b = _rhs(A.shape[0])
    res = ptt.amg_pcg(None, h, torch.from_numpy(b), tol=1e-6, maxiter=50)
    jres = pat.amg_pcg(None, jh, jnp.asarray(b), tol=1e-6, maxiter=50)
    assert res.converged and bool(jres.converged)
    assert res.iters == int(jres.iters)
    k = res.iters
    np.testing.assert_allclose(res.residual_history[:k + 1].numpy(),
                               np.asarray(jres.residual_history)[:k + 1],
                               rtol=1e-3)
    assert np.isinf(res.residual_history[k + 1:].numpy()).all()
    oh = oracle_setup(A, _cfg2(ptt))
    _, oracle_iters, _ = oracle_pcg(A, b.astype(np.float64), oh, tol=1e-6)
    assert abs(k - oracle_iters) <= 1
    true_res = np.linalg.norm(b - A @ res.x.double().numpy()) / np.linalg.norm(b)
    assert true_res <= 1e-5


def test_config1_solve_history_parity():
    """Config #1: 64², RS, V(1,1) weighted Jacobi, standalone solve over 10
    cycles; the residual history matches JAX to rtol 1e-4 plus an atol of
    1e-7·‖b‖, float32 rounding of b itself.  The level operators apply
    bit-equal in both packages, but XLA fuses the smoother's updates (FMA)
    and sums the coarse matmul in its own order, so once the residual is
    1e-4 of its start the two histories part at that rounding level."""
    h, jh, A = _pair(64, 1)
    b = _rhs(A.shape[0])
    x, hist, k = ptt.solve(h, torch.from_numpy(b), tol=1e-12, maxiter=10)
    jx, jhist, jk = pat.solve(jh, jnp.asarray(b), tol=1e-12, maxiter=10)
    assert k == int(jk) == 10
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-4,
                               atol=1e-7 * float(np.linalg.norm(b)))
    assert hist[9] < 1e-3 * hist[0]


def test_interop_carries_jax_hierarchy():
    h, jh, A = _pair(48, 2)
    carried = interop.hierarchy_from_numpy(
        _jax_level_arrays(jh), np.asarray(jh.coarse_inv),
        ptt.AMGConfig(**dataclasses.asdict(jh.config)), device="cpu")
    assert [type(l.A) for l in carried.levels] == [type(l.A) for l in h.levels]
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=A.shape[0]).astype(np.float32))
    b = torch.from_numpy(_rhs(A.shape[0]))
    out = ptt.vcycle(carried, x, b)
    torch.testing.assert_close(out, ptt.vcycle(h, x, b), rtol=0, atol=0)
    theirs = np.asarray(pat.vcycle(jh, jnp.asarray(x.numpy()), jnp.asarray(b.numpy())))
    assert np.linalg.norm(out.numpy() - theirs) <= 1e-5 * np.linalg.norm(theirs)


def test_unported_setups_raise():
    A = poisson2d(8).to_csr()
    # Ruge–Stüben on the device is ported: ELL levels until with_best_formats
    h = ptt.setup(A, ptt.AMGConfig(on_device_setup=True, n_coarse_max=16),
                  device="cpu")
    assert h.n_levels >= 2 and type(h.levels[0].A).__name__ == "ELL"
    # so is algebraic SA on the device: ELL levels too
    ha = ptt.setup(A, ptt.AMGConfig(coarsening="sa", on_device_setup=True,
                                    n_coarse_max=16), device="cpu")
    assert ha.n_levels >= 2 and type(ha.levels[0].A).__name__ == "ELL"
    # block SA with grid dims: the structured path, on the host and on device
    for on_device in (False, True):
        hb = ptt.setup(A, ptt.AMGConfig(coarsening="sa", aggregate="block",
                                        n_coarse_max=16,
                                        on_device_setup=on_device),
                       device="cpu", dims=(8, 8))
        assert hb.n_levels >= 2 and hb.grid_dims == (8, 8)
        assert type(hb.levels[0].A).__name__ == "Stencil"
        assert hb.levels[0].P.linked
    # the slab Galerkin path (ROADMAP A9) is ported: the dense path's levels
    hs, hd = (ptt.setup(A, ptt.AMGConfig(coarsening="sa", aggregate="block",
                                         n_coarse_max=16, on_device_setup=True,
                                         setup_product_path=path),
                        device="cpu", dims=(8, 8)) for path in ("slab", "dense"))
    assert hs.setup_stats["product_paths"][0] == "slab"
    assert [l.A.offsets for l in hs.levels] == [l.A.offsets for l in hd.levels]
    for ls, ld in zip(hs.levels, hd.levels):
        np.testing.assert_allclose(ls.A.weights.numpy(), ld.A.weights.numpy(),
                                   rtol=1e-5, atol=1e-6)
    h = ptt.setup(A, ptt.AMGConfig(coarsening="sa", n_coarse_max=16), device="cpu")
    assert h.n_levels >= 2


def test_port_runs_without_jax():
    code = (
        "import sys, torch\n"
        "import parallel_amg_tpu_torch as p\n"
        "from parallel_amg_tpu_torch.problems import poisson2d\n"
        "cfg = p.AMGConfig(coarsening='rs', smoother='chebyshev', n_coarse_max=32)\n"
        "h = p.setup(poisson2d(24).to_csr(), cfg, device='cpu')\n"
        "res = p.amg_pcg(None, h, torch.ones(24 * 24), tol=1e-6, maxiter=30)\n"
        "assert res.converged, res\n"
        "from parallel_amg_tpu_torch.problems import poisson_stencil\n"
        "cfg3 = p.AMGConfig(coarsening='sa', aggregate='block', block_size=3,\n"
        "                   smoother='chebyshev', n_coarse_max=64,\n"
        "                   on_device_setup=True)\n"
        "h3 = p.with_spmv_backend(p.setup(poisson_stencil((9, 9, 9), device='cpu'),\n"
        "                                 cfg3, device='cpu'), 'mixed')\n"
        "res = p.amg_pcg(None, h3, torch.ones(9 ** 3), tol=1e-6, maxiter=30)\n"
        "assert res.converged and res.x.shape == (9 ** 3,), res\n"
        "cfg_rs = p.AMGConfig(coarsening='rs', smoother='chebyshev', n_coarse_max=32,\n"
        "                     on_device_setup=True, interpolation='extended_i')\n"
        "hr = p.with_best_formats(p.setup(poisson2d(24).to_csr(), cfg_rs, device='cpu'),\n"
        "                         device=True)\n"
        "res = p.amg_pcg(None, hr, torch.ones(24 * 24), tol=1e-6, maxiter=30)\n"
        "assert res.converged, res\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'parallel_amg_tpu' not in sys.modules, 'JAX package imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
