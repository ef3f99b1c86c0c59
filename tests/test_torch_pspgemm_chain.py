"""The port's ``pallas_spgemm`` against the JAX package's on the Galerkin
chain of tests/test_pspgemm.py: R·A and (R·A)·P on a PMIS / smoothed-direct
level of poisson2d(12).  The checks and tolerances are
``test_torch_pspgemm``'s; this case sits in a file of its own so that its
JAX compiling runs beside the other cases.
"""

import numpy as np

import parallel_amg_tpu_torch as ptt
from test_torch_pspgemm import (
    _assert_same_product,
    _ell,
    _galerkin_operands,
    _jell,
    _to_sp,
    j_pallas_spgemm,
)


def test_pallas_spgemm_rect_galerkin_chain_matches_jax():
    """R·A and (R·A)·P on a PMIS / smoothed-direct level: rectangular
    operands, irregular widths."""
    A_sp, P_sp, R_sp = _galerkin_operands()
    RA = ptt.pallas_spgemm(_ell(R_sp), _ell(A_sp))
    jRA = j_pallas_spgemm(_jell(R_sp), _jell(A_sp))
    _assert_same_product(RA, jRA, (R_sp.shape[0], A_sp.shape[1]))
    RA_sp = (R_sp @ A_sp).tocsr()
    Ac = ptt.pallas_spgemm(_ell(RA_sp), _ell(P_sp))
    jAc = j_pallas_spgemm(_jell(RA_sp), _jell(P_sp))
    _assert_same_product(Ac, jAc, (R_sp.shape[0], P_sp.shape[1]))
    ref = (R_sp @ A_sp @ P_sp).astype(np.float32)
    d = abs(_to_sp(Ac, ref.shape) - ref)
    assert (d.max() if d.nnz else 0.0) < 1e-4
