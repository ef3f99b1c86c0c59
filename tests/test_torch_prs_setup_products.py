"""The port's distributed Galerkin products (parallel/prs_setup.py:
``part_product_operands``, ``part_product``, ``pcsr_transpose``,
``pcsr_spgemm``) against the JAX package's on its CPU mesh, on the first
level of test_torch_prs_setup.py (2D Poisson 16², extended+i).

Everything is held equal, floats bit for bit:
- R = Pᵀ: planes and plans;
- the per-part product (B3 + B5 + B4, their plain versions here) against the
  JAX package's ``_spgemm_kernel``, fed the JAX package's own R through
  ``interop.pcsr_from_numpy``: the same columns in every row and the same
  values (both sum each column's float32 products in candidate order);
- R·A and (R·A)·P after reassembly: planes, plans and partitions.
The CUDA case holds the kernels' per-part product against the plain
versions' on the card.
"""

import functools
from functools import partial

import numpy as np
import pytest
import scipy.sparse as sp
import torch

try:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as JP

    from parallel_amg_tpu.parallel import prs_setup as jprs
except ImportError:  # a machine without JAX runs the cuda cases only
    jax = None

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.ops import pspgemm
from parallel_amg_tpu_torch.parallel import prs_setup as prs
from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.problems import poisson2d
from test_torch_prs_setup import FIELDS, _level, assert_planes_equal

torch.set_num_threads(2)


def _jax_part_products(Aj, Bj):
    """(cols, vals, nnz) of the JAX package's per-shard ``_spgemm_kernel``."""
    sent = jnp.int32(Bj.col_partition.n_padded)
    bc, bv = jprs._pcsr_global_cols(Bj, sent)
    spec = JP("rows")
    out = jax.jit(jax.shard_map(
        partial(jprs._spgemm_kernel, sentinel=sent), mesh=Aj.mesh,
        in_specs=(spec,) * 8, out_specs=(spec,) * 3))(
        Aj.diag_cols, Aj.diag_vals, Aj.off_cols, Aj.off_vals, Aj.send_idx,
        Aj.recv_map, bc, bv)
    return (np.asarray(t) for t in out)


def _port_part_products(At, Bt, plain=False):
    sent = int(Bt.col_partition.n_padded)
    bc, bv = prs._pcsr_global_cols(Bt, sent)
    gbc, gbv = prs._fetch_rows(At, bc, bv, sent)
    return [prs.part_product(*prs.part_product_operands(
        At, p, bc[p], bv[p], gbc[p], gbv[p], sent), plain=plain)
        for p in range(At.n_shards)]


@functools.cache
def _rap_operands(S):
    lv = _level(S)
    cmj, mcj, _ = lv["cmj"]
    cmt, mct, _ = lv["cmt"]
    Pj = jprs.pcsr_interpolation(lv["Aj"], *lv["Sj"], lv["stj"], cmj, mcj, lv["cj"])
    Pt = prs.pcsr_interpolation(lv["At"], *lv["St"], lv["stt"], cmt, mct, lv["ct"])
    return lv, Pj, Pt, jprs.pcsr_transpose(Pj, mcj), prs.pcsr_transpose(Pt, mct)


def test_part_product_vs_spgemm_kernel():
    """The product stage alone: the JAX package's R, carried into the port by
    ``interop.pcsr_from_numpy``, times A; the port's own R = Pᵀ alongside."""
    from parallel_amg_tpu_torch.interop import pcsr_from_numpy

    lv, Pj, Pt, Rj, Rt = _rap_operands(8)
    assert_planes_equal(Rt, Rj)  # R = Pᵀ: exact copies of P's values
    arrays = {f: np.asarray(getattr(Rj, f)) for f in FIELDS}
    arrays.update(row_partition=Rj.row_partition, col_partition=Rj.col_partition,
                  true_shape=Rj.true_shape)
    R_from_jax = pcsr_from_numpy(arrays, lv["At"].mesh)
    cols, vals, nnz = _jax_part_products(Rj, lv["Aj"])
    ours = _port_part_products(R_from_jax, lv["At"])
    for p, C in enumerate(ours):
        cc, cv, cn = C.cols.numpy(), C.vals.numpy(), C.row_nnz.numpy()
        np.testing.assert_array_equal(cn, nnz[p])
        for r in range(cc.shape[0]):
            mine = dict(zip(cc[r, :cn[r]].tolist(), cv[r, :cn[r]].tolist()))
            ref = dict(zip(cols[p, r, :nnz[p, r]].tolist(),
                           vals[p, r, :nnz[p, r]].tolist()))
            assert set(mine) == set(ref), (p, r)
            np.testing.assert_array_equal(
                np.float32([mine[k] for k in ref]).view(np.int32),
                np.float32(list(ref.values())).view(np.int32))


@pytest.mark.parametrize("S", [8, 3])
def test_galerkin_products_vs_jax(S):
    lv, Pj, Pt, Rj, Rt = _rap_operands(S)
    RAj = jprs.pcsr_spgemm(Rj, lv["Aj"])
    RAt = prs.pcsr_spgemm(Rt, lv["At"])
    assert_planes_equal(RAt, RAj)
    Acj = jprs._ensure_diag(jprs.pcsr_spgemm(RAj, Pj, pad_identity=True))
    Act = prs._ensure_diag(prs.pcsr_spgemm(RAt, Pt, pad_identity=True))
    assert_planes_equal(Act, Acj)
    assert tuple(Acj.true_shape) == Act.true_shape
    for name in ("row_partition", "col_partition"):
        a, b = getattr(Acj, name), getattr(Act, name)
        assert (a.n_global, a.n_shards, a.rows_per_shard) == (
            b.n_global, b.n_shards, b.rows_per_shard)


@pytest.mark.cuda
def test_part_product_kernels_match_plain_cuda():
    """B3 + B5 + B4 on each part of R·A at 2D Poisson 64² in 8 parts
    against the plain versions of the three steps, on the card
    (``pytest -m cuda --noconftest``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    coo = poisson2d(64)
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    cfg = ptt.AMGConfig(coarsening="rs", on_device_setup=True)
    At = PCSR.from_csr(A, make_row_mesh(8))
    Sd, So = prs.pcsr_strength(At, cfg.theta)
    st = prs.pcsr_pmis(At, Sd, So, seed=0)
    cm, mc, _ = prs.coarse_numbering(At, st)
    Rt = prs.pcsr_transpose(prs.pcsr_interpolation(At, Sd, So, st, cm, mc, cfg), mc)
    before = dict(pspgemm.LAUNCHES)
    ours = _port_part_products(Rt, At)
    assert all(pspgemm.LAUNCHES[k] - before[k] == 8 for k in before)
    plain = _port_part_products(Rt, At, plain=True)
    for C, D in zip(ours, plain):
        assert torch.equal(C.row_nnz, D.row_nnz) and torch.equal(C.cols, D.cols)
        torch.testing.assert_close(C.vals, D.vals, rtol=1e-5, atol=1e-6)
