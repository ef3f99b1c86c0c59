"""The port's distributed Ruge–Stüben setup stages (parallel/prs_setup.py)
against the JAX package's on its CPU mesh — the stages of
tests/test_prs_setup.py at 2D Poisson 16²: strength, PMIS, coarse
numbering and interpolation here; the products in
test_torch_prs_setup_products.py, so that the two files' JAX compiling runs
side by side.

Both packages get the same PCSR (``PCSR.from_csr``, whose planes are held
equal in test_torch_pcsr.py); a stage's inputs are the port's own outputs
of the stage before, which the tests hold equal first.  PMIS weights are
``ops/prng.uniform``, the JAX package's draw.
Everything is held equal: strength masks, PMIS states, coarse numbering,
halo plans and the interpolation P (direct, smoothed direct, extended+i),
plane by plane and bit for bit: the port's float32 row sums add in the
order of the JAX package's ``jnp.sum`` on its CPU backend
(``ops/ordered_sum.py``).
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax

    import parallel_amg_tpu as pat
    from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
    from parallel_amg_tpu.parallel import prs_setup as jprs
    from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
except ImportError:  # a machine without JAX imports this file for the
    jax = None       # helpers of test_torch_prs_setup_products.py's cuda case

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import prs_setup as prs
from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")


@functools.cache
def _poisson16():
    coo = poisson2d(16)
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


@functools.cache
def _level(S, interp="extended_i", p_max=4):
    """Both packages' first-level stages on S parts (once per S, tier and
    width in this module)."""
    A = _poisson16()
    jm, tm = j_make_row_mesh(S), make_row_mesh(S, device="cpu")
    kw = dict(coarsening="rs", p_max=p_max, on_device_setup=True,
              interpolation=interp)
    cj, ct = pat.AMGConfig(**kw), ptt.AMGConfig(**kw)
    Aj, At = JPCSR.from_csr(A, jm), PCSR.from_csr(A, tm)
    Sdj, Soj = jprs.pcsr_strength(Aj, cj.theta)
    Sdt, Sot = prs.pcsr_strength(At, ct.theta)
    stj = jprs.pcsr_pmis(Aj, Sdj, Soj, seed=0)
    stt = prs.pcsr_pmis(At, Sdt, Sot, seed=0)
    cmj, mcj, ncj = jprs.coarse_numbering(Aj, stj)
    cmt, mct, nct = prs.coarse_numbering(At, stt)
    return dict(cj=cj, ct=ct, Aj=Aj, At=At, Sj=(Sdj, Soj), St=(Sdt, Sot),
                stj=stj, stt=stt, cmj=(cmj, mcj, ncj), cmt=(cmt, mct, nct))


def _stack(parts):
    return np.stack([t.numpy() for t in parts])


def assert_planes_equal(Mt, Mj):
    """A port PCSR's planes and plans equal to a JAX PCSR's, floats bit for
    bit."""
    for f in FIELDS:
        a, b = _stack(getattr(Mt, f)), np.asarray(getattr(Mj, f))
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("S", [8, 3])
def test_pmis_and_coarse_numbering_equal(S):
    lv = _level(S)
    for a, b in zip(lv["Sj"], lv["St"]):
        np.testing.assert_array_equal(np.asarray(a), _stack(b))
    np.testing.assert_array_equal(np.asarray(lv["stj"]), lv["stt"].to_global().numpy())
    cmj, mcj, ncj = lv["cmj"]
    cmt, mct, nct = lv["cmt"]
    assert (mcj, ncj) == (mct, nct)
    np.testing.assert_array_equal(np.asarray(cmj), cmt.to_global().numpy())


@pytest.mark.parametrize("interp,p_max,S", [
    ("direct", 4, 8), ("smoothed_direct", 4, 8), ("smoothed_direct", 8, 3),
    ("extended_i", 4, 8), ("extended_i", 16, 3)])
def test_interpolation_entrywise(interp, p_max, S):
    lv = _level(S, interp, p_max)
    cmj, mcj, _ = lv["cmj"]
    cmt, mct, _ = lv["cmt"]
    Pj = jprs.pcsr_interpolation(lv["Aj"], *lv["Sj"], lv["stj"], cmj, mcj, lv["cj"])
    Pt = prs.pcsr_interpolation(lv["At"], *lv["St"], lv["stt"], cmt, mct, lv["ct"])
    assert tuple(Pj.true_shape) == Pt.true_shape
    assert_planes_equal(Pt, Pj)
