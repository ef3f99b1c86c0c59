"""The port's mixed-precision solve and bfloat16 hierarchy against the JAX
package and the float64 oracle.

``amg_pcg_mp`` runs CG in float64 over the float32 (or bfloat16) V-cycle; it
must reach a true relative residual of 1e-8 (≤ 2e-8 in float64, against the
exact matrix) in the JAX package's iteration count, within 2 of the oracle's
(``tests/test_precision.py``).  The bfloat16 preconditioner under a float32
operator must stay within 2 iterations of float32 and take the JAX package's
bfloat16 count (``tests/test_mixed_precision.py``).  The float64 A·p is held
against scipy on the float32-rounded matrix to 1e-12 relative.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import parallel_amg_tpu as pat
from parallel_amg_tpu.problems import poisson2d as j_poisson2d
from parallel_amg_tpu.problems import poisson3d as j_poisson3d
from parallel_amg_tpu.problems.stencil_problems import poisson_stencil as j_pstencil

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.amg.cycle import _cycle
from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy, Level
from parallel_amg_tpu_torch.ops.bsr import BSR
from parallel_amg_tpu_torch.ops.csr import CSR
from parallel_amg_tpu_torch.ops.dia import DIA
from parallel_amg_tpu_torch.ops.ell import ELL
from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
from parallel_amg_tpu_torch.ops.stencil import Stencil
from parallel_amg_tpu_torch.ops.twell import TWELL
from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
from parallel_amg_tpu_torch.problems import poisson2d, poisson3d, poisson_stencil
from parallel_amg_tpu_torch.solver import f64_matvec
from parallel_amg_tpu_torch.utils.checkpoint import cast_hierarchy

torch.set_num_threads(2)


def _true_rel_res(A_sp, x, b):
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x,
                   np.float64).reshape(-1)
    return float(np.linalg.norm(b - A_sp @ x) / np.linalg.norm(b))


def _setups_2d(coarsening, n=64):
    csr = poisson2d(n).to_csr()
    if coarsening == "rs":
        def cfg(m):
            return m.AMGConfig(coarsening="rs", smoother="chebyshev")
        dims = None
    else:
        def cfg(m):
            return m.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                               smoother="chebyshev", n_coarse_max=128)
        dims = (n, n)
    h = ptt.setup(csr, cfg(ptt), device="cpu", dims=dims)
    jh = pat.setup(j_poisson2d(n).to_csr(), cfg(pat), dims=dims)
    return h, jh, csr.to_scipy(), cfg(ptt), dims


@pytest.mark.parametrize("coarsening", ["rs", "sa"])
def test_mp_pcg_matches_jax_and_oracle_1e8(coarsening, rng):
    h, jh, A_sp, cfg, dims = _setups_2d(coarsening)
    oh = oracle_setup(A_sp, cfg, dims=dims)
    b = rng.normal(size=A_sp.shape[0])
    _, oracle_iters, _ = oracle_pcg(A_sp, b, oh, tol=1e-8, maxiter=100)

    res = ptt.amg_pcg_mp(None, h, b, tol=1e-8, maxiter=100)
    jres = pat.amg_pcg_mp(None, jh, b, tol=1e-8, maxiter=100)
    assert res.converged and res.x.dtype == torch.float64
    assert res.residual_history.dtype == torch.float64
    assert _true_rel_res(A_sp, res.x, b) <= 2e-8
    assert res.iters == int(jres.iters)
    assert abs(res.iters - oracle_iters) <= 2, (res.iters, oracle_iters)
    gc, oc = h.complexity()
    assert gc < 2.5 and oc < 2.5


@pytest.mark.parametrize("backend", [None, "pallas"])
def test_mp_pcg_structured_3d(backend, rng):
    """18³ device block-SA: the Stencil fine level and, under "pallas", its
    FlatDIA form both apply A in float64; the V-cycle keeps its formats."""
    nx = 18

    def cfg(m):
        return m.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                           smoother="chebyshev", n_coarse_max=64,
                           on_device_setup=True)

    h = ptt.setup(poisson_stencil((nx,) * 3, device="cpu"), cfg(ptt), device="cpu")
    if backend is not None:
        h = ptt.with_spmv_backend(h, backend)
        assert isinstance(h.levels[0].A, FlatDIA)
    jh = pat.setup(j_pstencil((nx,) * 3), cfg(pat))
    A_sp = poisson3d(nx).to_csr().to_scipy()
    oh = oracle_setup(A_sp, cfg(ptt), dims=(nx,) * 3)
    b = rng.normal(size=nx ** 3)
    _, oracle_iters, _ = oracle_pcg(A_sp, b, oh, tol=1e-8, maxiter=100)

    res = ptt.amg_pcg_mp(None, h, b, tol=1e-8, maxiter=100)
    jres = pat.amg_pcg_mp(None, jh, b, tol=1e-8, maxiter=100)
    assert res.converged and res.x.shape == (nx ** 3,)
    assert _true_rel_res(A_sp, res.x, b) <= 2e-8
    assert res.iters == int(jres.iters)
    assert abs(res.iters - oracle_iters) <= 2
    gc, oc = h.complexity()
    assert gc < 2.5 and oc < 2.5


def test_f32_pcg_true_residual_stalls(rng):
    """Why the mixed-precision path exists: float32 CG 'converges' to 1e-8
    on its recursive residual while the true residual stalls far above."""
    h, _, A_sp, _, _ = _setups_2d("rs")
    b = rng.normal(size=A_sp.shape[0])
    res = ptt.amg_pcg(h.levels[0].A, h, torch.from_numpy(b.astype(np.float32)),
                      tol=1e-8, maxiter=100)
    assert _true_rel_res(A_sp, res.x, b) > 5e-8


def _rounded(A_sp):
    """The matrix with its values rounded to float32, in float64."""
    A = A_sp.astype(np.float32).astype(np.float64)
    A.sort_indices()
    return A


@pytest.mark.parametrize("fmt", ["stencil", "flatdia", "flatdia_no_dims", "dia", "ell"])
def test_f64_matvec_is_the_rounded_matrix_in_float64(fmt):
    """f64_matvec multiplies the operator's own float32 values in float64:
    scipy's float64 product on the float32-rounded matrix, to 1e-12."""
    rng = np.random.default_rng(3)
    dims = (9, 8, 7)
    st = poisson_stencil(dims, device="cpu")
    st = Stencil(st.weights * torch.from_numpy(
        rng.uniform(0.5, 2.0, st.weights.shape).astype(np.float32)),
        st.offsets, dims)
    csr = st.to_csr()
    ops = {"stencil": st, "flatdia": FlatDIA.from_stencil(st),
           "flatdia_no_dims": FlatDIA(FlatDIA.from_stencil(st).diags,
                                      FlatDIA.from_stencil(st).offsets, st.n),
           "dia": DIA.from_csr(csr), "ell": ELL.from_csr(csr)}
    A = ops[fmt]
    x = rng.normal(size=st.n)
    xt = torch.from_numpy(x)
    if fmt in ("stencil", "flatdia"):
        xt = xt.reshape(dims)
    y = f64_matvec(A)(xt)
    assert y.dtype == torch.float64
    ref = _rounded(csr.to_scipy()) @ x
    np.testing.assert_allclose(y.reshape(-1).numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("fmt", ["twell", "bsr"])
def test_mp_rejects_kernel_only_fine_operators(fmt, rng):
    """TWELL and BSR have only float32/bfloat16 kernels: amg_pcg_mp raises,
    as the JAX package requires an XLA-backend operator."""
    h, _, A_sp, _, _ = _setups_2d("rs", n=16)
    csr = CSR.from_scipy(A_sp)
    A = TWELL.from_csr(csr) if fmt == "twell" else BSR.from_csr(csr, 2)
    with pytest.raises(TypeError, match=type(A).__name__):
        ptt.amg_pcg_mp(A, h, rng.normal(size=A_sp.shape[0]))


# -- the bfloat16 hierarchy ---------------------------------------------------

def _bf16_pair():
    coo = poisson3d(12)
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)

    def cfg(m):
        return m.AMGConfig(coarsening="sa", aggregate="block", block_size=2,
                           smoother="chebyshev", n_coarse_max=64)

    h32 = ptt.setup(A, cfg(ptt), device="cpu", dims=(12, 12, 12))
    h16 = ptt.setup(A, cfg(ptt), device="cpu", dims=(12, 12, 12),
                    dtype=torch.bfloat16)
    jcoo = j_poisson3d(12)
    jA = sp.csr_matrix((jcoo.val, (jcoo.row, jcoo.col)), shape=jcoo.shape)
    jh32 = pat.setup(jA, cfg(pat), dims=(12, 12, 12), dtype=jnp.float32)
    jh16 = pat.setup(jA, cfg(pat), dims=(12, 12, 12), dtype=jnp.bfloat16)
    return A, h32, h16, jh32, jh16


class _Recorder:
    """Wraps a level operator and records the dtype of every x it gets."""

    def __init__(self, A, seen):
        self.A, self.seen = A, seen

    def matvec(self, x):
        self.seen.append(x.dtype)
        return self.A.matvec(x)

    def __getattr__(self, name):
        return getattr(self.A, name)


def test_bf16_preconditioner_f32_operator(rng):
    A, h32, h16, jh32, jh16 = _bf16_pair()
    assert h16.levels[0].A.weights.dtype == torch.bfloat16
    assert h16.coarse_inv.dtype == torch.float32
    b = rng.normal(size=A.shape[0])
    bt = torch.from_numpy(b.astype(np.float32))
    res16 = ptt.amg_pcg(h32.levels[0].A, h16, bt, tol=1e-6, maxiter=60)
    res32 = ptt.amg_pcg(h32.levels[0].A, h32, bt, tol=1e-6, maxiter=60)
    bj = jnp.asarray(b, jnp.float32)
    jres16 = pat.amg_pcg(jh32.levels[0].A, jh16, bj, tol=1e-6, maxiter=60)
    assert res16.converged and res16.x.dtype == torch.float32
    assert abs(res16.iters - res32.iters) <= 2
    assert res16.iters == int(jres16.iters)
    assert _true_rel_res(A, res16.x, b) <= 5e-6


def test_bf16_host_setup_rs(rng):
    """setup(..., dtype=bfloat16) on the Ruge–Stüben host path: DIA and
    TWELL levels in bfloat16 (their kernels' bfloat16 entries), and the
    preconditioner within 2 iterations of float32 and equal to the JAX
    package's bfloat16 count."""
    csr = poisson2d(48).to_csr()

    def cfg(m):
        return m.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=64,
                           interpolation="extended_i")

    h32 = ptt.setup(csr, cfg(ptt), device="cpu")
    h16 = ptt.setup(csr, cfg(ptt), device="cpu", dtype=torch.bfloat16)
    jcsr = j_poisson2d(48).to_csr()
    jh32 = pat.setup(jcsr, cfg(pat))
    jh16 = pat.setup(jcsr, cfg(pat), dtype=jnp.bfloat16)
    assert isinstance(h16.levels[0].A, DIA) and isinstance(h16.levels[1].A, TWELL)
    assert h16.levels[0].A.diags.dtype == torch.bfloat16
    assert h16.levels[0].P.vals.dtype == torch.bfloat16
    b = rng.normal(size=csr.n_rows)
    bt = torch.from_numpy(b.astype(np.float32))
    res16 = ptt.amg_pcg(h32.levels[0].A, h16, bt, tol=1e-6, maxiter=60)
    res32 = ptt.amg_pcg(h32.levels[0].A, h32, bt, tol=1e-6, maxiter=60)
    jres16 = pat.amg_pcg(jh32.levels[0].A, jh16, jnp.asarray(b, jnp.float32),
                         tol=1e-6, maxiter=60)
    assert res16.converged and abs(res16.iters - res32.iters) <= 2
    assert res16.iters == int(jres16.iters)


def test_bf16_cycle_vectors_stay_float32():
    """Every operator of a bfloat16 hierarchy sees float32 vectors, on every
    level, and the cycle returns float32 (the kernels' bfloat16 entries
    take bfloat16 values with float32 x and y)."""
    _, _, h16, _, _ = _bf16_pair()
    seen = []
    levels = [Level(_Recorder(l.A, seen), l.P, l.R, l.d_inv, l.lam_max)
              for l in h16.levels]
    hr = Hierarchy(levels, h16.coarse_inv, h16.config)
    r = torch.ones(h16.grid_dims, dtype=torch.float32)
    z = _cycle(hr, 0, torch.zeros_like(r), r, 1)
    assert z.dtype == torch.float32
    assert len(seen) > 0 and set(seen) == {torch.float32}
    assert all(l.A.weights.dtype == torch.bfloat16 for l in h16.levels)


def test_cast_hierarchy_keeps_coarse_inverse_f32(rng):
    """The cast of a finished hierarchy (the JAX bench's tree_map(cast16))
    makes every float32 tensor bfloat16, rounds λ_max and the transfers'
    ω/λ to bfloat16, keeps the coarse inverse float32, and preconditions
    as well as a hierarchy set up in bfloat16."""
    A, h32, h16, _, _ = _bf16_pair()
    hc = cast_hierarchy(h32, torch.bfloat16)
    assert hc.coarse_inv.dtype == torch.float32
    assert torch.equal(hc.coarse_inv, h32.coarse_inv)
    for lc, l32 in zip(hc.levels, h32.levels):
        assert lc.A.weights.dtype == torch.bfloat16
        assert lc.d_inv.dtype == torch.bfloat16
        assert lc.lam_max == float(torch.tensor(l32.lam_max).bfloat16())
        if lc.P is not None:
            assert lc.P.scale.dtype == torch.bfloat16
            assert lc.P.coef == float(torch.tensor(l32.P.coef).bfloat16())
    assert h32.levels[0].A.weights.dtype == torch.float32  # untouched
    b = rng.normal(size=A.shape[0])
    bt = torch.from_numpy(b.astype(np.float32))
    resc = ptt.amg_pcg(h32.levels[0].A, hc, bt, tol=1e-6, maxiter=60)
    res16 = ptt.amg_pcg(h32.levels[0].A, h16, bt, tol=1e-6, maxiter=60)
    assert resc.converged and abs(resc.iters - res16.iters) <= 1


def test_mp_over_bf16_hierarchy_reaches_1e8(rng):
    """float64 CG over a bfloat16 preconditioner still reaches a true 1e-8:
    the preconditioner's precision moves only the iteration count."""
    A, h32, h16, _, _ = _bf16_pair()
    b = rng.normal(size=A.shape[0])
    res = ptt.amg_pcg_mp(h32.levels[0].A, h16, b, tol=1e-8, maxiter=100)
    res32 = ptt.amg_pcg_mp(None, h32, b, tol=1e-8, maxiter=100)
    assert res.converged and _true_rel_res(A, res.x, b) <= 2e-8
    assert res.iters <= res32.iters + 4
