"""The port's host-oracle distributed setup (parallel/psetup.py) and the
solvers over its PCSR hierarchies, against the JAX package's on its CPU
mesh — the cases of tests/test_distributed_solvers.py.

Both packages set up 2D Poisson 24² (Ruge–Stüben, extended+i) from the same
float64 oracle, in 8 parts, with no agglomeration and with levels of ≤ 64
rows agglomerated (plain operators behind the boundary transfers).
Tolerances:
- PCSR level planes and halo plans: equal (the same oracle levels, the same
  partition); agglomerated levels: the same matrices;
- iteration counts of the V-cycle and W-cycle ``solve`` and of ``amg_pcg``:
  equal;
- residual histories: rtol 1e-4 over the first four entries, rtol 0.1 over
  the rest (float32 cycles whose sums run in another order drift apart
  slowly as the residual falls toward float32 rounding);
- FGMRES: converged, with the true residual below 5e-5·‖b‖ (the JAX test's
  bound), in the JAX package's number of restart cycles.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import parallel_amg_tpu as pat
from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel import pvector as j_pvector
from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
from parallel_amg_tpu.parallel.psetup import distributed_setup as j_distributed_setup
from parallel_amg_tpu.problems import poisson2d

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.psetup import ReshardedTransfer

torch.set_num_threads(2)

FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")


@pytest.fixture(scope="module")
def prob():
    coo = poisson2d(24)
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


@pytest.fixture(scope="module")
def meshes():
    return j_make_row_mesh(8), ptt.make_row_mesh(8, device="cpu")


def _cfgs(**kw):
    return pat.AMGConfig(**kw), ptt.AMGConfig(**kw)


@pytest.fixture(scope="module", params=[0, 64], ids=["split", "agglomerated"])
def setups(request, prob, meshes):
    jm, tm = meshes
    cj, ct = _cfgs(coarsening="rs", cycle="W", n_coarse_max=32,
                   agglomerate_n=request.param)
    return (j_distributed_setup(prob, cj, jm), ptt.distributed_setup(prob, ct, tm),
            request.param)


def _b(prob, seed):
    return np.random.default_rng(seed).normal(size=prob.shape[0])


def _vectors(hj, ht, meshes, bh):
    jm, tm = meshes
    return (j_pvector(bh, hj.levels[0].A.row_partition, jm),
            ptt.pvector(bh, ht.levels[0].A.row_partition, tm))


def test_distributed_setup_levels(setups, prob):
    hj, ht, agg = setups
    assert len(hj.levels) == len(ht.levels)
    for lj, lt in zip(hj.levels, ht.levels):
        assert float(np.float32(lj.lam_max)) == lt.lam_max
        for name in ("A", "P", "R"):
            a, b = getattr(lj, name), getattr(lt, name)
            assert (a is None) == (b is None)
            if a is None:
                continue
            if isinstance(a, JPCSR):
                assert isinstance(b, PCSR) and b.nb_send is not None
                for f in FIELDS + ("nb_recv_map",):
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a, f)),
                        np.stack([t.numpy() for t in getattr(b, f)]), err_msg=f)
                continue
            Tj = a.T if hasattr(a, "mesh") and hasattr(a, "T") else a
            Tt = b.T if isinstance(b, ReshardedTransfer) else b
            dj = Tj.to_csr().to_scipy().toarray()
            dt = Tt.to_csr().to_scipy().toarray()
            np.testing.assert_array_equal(dt, dj.astype(np.float32))
    kinds = [type(l.A).__name__ for l in ht.levels]
    if agg:
        assert kinds[0] == "PCSR" and kinds[-1] != "PCSR"
    else:
        assert set(kinds) == {"PCSR"}


@pytest.mark.parametrize("cycle", ["W", "V"])
def test_solve_counts_and_histories(cycle, setups, prob, meshes):
    hj, ht, _ = setups
    if cycle == "V":
        hj = pat.Hierarchy(hj.levels, hj.coarse_inv,
                           pat.AMGConfig(coarsening="rs", cycle="V", n_coarse_max=32))
        ht = ptt.Hierarchy(ht.levels, ht.coarse_inv,
                           ptt.AMGConfig(coarsening="rs", cycle="V", n_coarse_max=32))
    bh = _b(prob, 0)
    bj, bt = _vectors(hj, ht, meshes, bh)
    _, hist_j, k_j = pat.solve(hj, bj, tol=1e-6, maxiter=30)
    x_t, hist_t, k_t = ptt.solve(ht, bt, tol=1e-6, maxiter=30)
    assert k_t == int(k_j)
    hj_np, ht_np = np.asarray(hist_j)[:k_t], hist_t[:k_t].numpy()
    np.testing.assert_allclose(ht_np[:4], hj_np[:4], rtol=1e-4)
    np.testing.assert_allclose(ht_np, hj_np, rtol=0.1)
    x = ptt.to_global(x_t, ht.levels[0].A.row_partition).astype(np.float64)
    assert np.linalg.norm(bh - prob @ x) < 5e-6 * np.linalg.norm(bh)


def test_pcg_counts(setups, prob, meshes):
    hj, ht, _ = setups
    bh = _b(prob, 1)
    bj, bt = _vectors(hj, ht, meshes, bh)
    rj = pat.amg_pcg(hj.levels[0].A, hj, bj, tol=1e-6, maxiter=60)
    rt = ptt.amg_pcg(None, ht, bt, tol=1e-6, maxiter=60)
    assert rt.converged and rt.iters == int(rj.iters)
    np.testing.assert_allclose(rt.residual_history[:4].numpy(),
                               np.asarray(rj.residual_history)[:4], rtol=1e-4)


def test_fgmres_distributed(setups, prob, meshes):
    hj, ht, _ = setups
    bh = _b(prob, 2)
    bj, bt = _vectors(hj, ht, meshes, bh)
    rj = pat.amg_fgmres(hj.levels[0].A, hj, bj, tol=1e-6, restart=20,
                        max_restarts=10)
    rt = ptt.amg_fgmres(None, ht, bt, tol=1e-6, restart=20, max_restarts=10)
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters)
    x = ptt.to_global(rt.x, ht.levels[0].A.row_partition).astype(np.float64)
    assert np.linalg.norm(bh - prob @ x) <= 5e-5 * np.linalg.norm(bh)


def test_fgmres_pgrid_path_matches_tensor_path(prob):
    """On one part the PGrid path of ``fgmres`` computes what its tensor
    path computes (rtol 1e-5: the part sums of the Gram–Schmidt products
    against one product)."""
    from parallel_amg_tpu_torch.krylov.gmres import fgmres
    from parallel_amg_tpu_torch.ops.twell import TWELL

    op = TWELL.from_csr(ptt.CSR.from_scipy(prob))
    bh = torch.from_numpy(_b(prob, 3).astype(np.float32))
    mesh = ptt.make_row_mesh(1, device="cpu")
    r_t = fgmres(op.matvec, bh, tol=1e-6, restart=10, max_restarts=3)
    r_p = fgmres(lambda v: ptt.PGrid([op.matvec(v.parts[0])], mesh),
                 ptt.PGrid([bh], mesh), tol=1e-6, restart=10, max_restarts=3)
    assert r_t.iters == r_p.iters
    torch.testing.assert_close(r_p.x.parts[0], r_t.x, rtol=1e-5, atol=1e-6)
