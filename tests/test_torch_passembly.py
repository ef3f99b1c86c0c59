"""The port's COO→PCSR assembly, on the host (parallel/assembly.py) and on
the parts' devices (parallel/passembly_device.py), against the JAX
package's on its CPU mesh.

Both packages get the same per-part triplet blocks of 2D Poisson 16²:
owner-local, scrambled over the parts (off-owner routing), and scrambled
with every entry split into two duplicates (0.25·v + 0.75·v), on 8 parts
and on 3, and an interpolation-shaped rectangular matrix.  The planes, the
halo plans and the partitions are held EQUAL, array for array: both sort
stably and sum each duplicate run left to right.  Every counted capacity
overflow raises ``ValueError`` naming the capacity.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from parallel_amg_tpu.parallel import make_row_mesh as j_make_row_mesh
from parallel_amg_tpu.parallel.assembly import pcsr_from_coo as j_pcsr_from_coo
from parallel_amg_tpu.parallel.passembly_device import (
    pcsr_from_coo_device as j_pcsr_from_coo_device,
)

from parallel_amg_tpu_torch.parallel.assembly import pcsr_from_coo
from parallel_amg_tpu_torch.parallel.mesh import make_row_mesh
from parallel_amg_tpu_torch.parallel.passembly_device import pcsr_from_coo_device
from parallel_amg_tpu_torch.parallel.pvector import pvector
from parallel_amg_tpu_torch.problems import poisson2d

torch.set_num_threads(2)

FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")


def _triplet_blocks(nx, S, scramble=False, duplicate=False, seed=0):
    """Per-part triplet blocks of 2D Poisson (tests/test_passembly_device.py's
    construction)."""
    coo = poisson2d(nx)
    n = coo.shape[0]
    r = np.asarray(coo.row, np.int64)
    c = np.asarray(coo.col, np.int64)
    v = np.asarray(coo.val, np.float64)
    if duplicate:
        r = np.concatenate([r, r])
        c = np.concatenate([c, c])
        v = np.concatenate([0.25 * v, 0.75 * v])
    rng = np.random.default_rng(seed)
    if scramble:
        which = rng.integers(0, S, size=len(r))
    else:
        which = np.minimum(r // -(-n // S), S - 1)
    T = int(np.max(np.bincount(which, minlength=S)))
    rows = np.full((S, T), -1, np.int64)
    cols = np.zeros((S, T), np.int64)
    vals = np.zeros((S, T), np.float64)
    for s in range(S):
        sel = which == s
        k = int(sel.sum())
        rows[s, :k], cols[s, :k], vals[s, :k] = r[sel], c[sel], v[sel]
    return rows, cols, vals, coo


def _assert_equal(J, P):
    for f in FIELDS:
        a = np.asarray(getattr(J, f))
        b = np.stack([t.numpy() for t in getattr(P, f)])
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for name in ("row_partition", "col_partition"):
        jp, tp = getattr(J, name), getattr(P, name)
        assert (jp.n_global, jp.n_shards, jp.rows_per_shard) == (
            tp.n_global, tp.n_shards, tp.rows_per_shard)
    assert tuple(J.true_shape) == P.true_shape


@pytest.mark.parametrize("S", [8, 3])
def test_pcsr_from_coo_host_equal(S):
    rows, cols, vals, coo = _triplet_blocks(16, S, scramble=True, duplicate=True)
    keep = rows.reshape(-1) >= 0
    r, c, v = (a.reshape(-1)[keep] for a in (rows, cols, vals))
    J = j_pcsr_from_coo(r, c, v, coo.shape, j_make_row_mesh(S))
    P = pcsr_from_coo(r, c, v, coo.shape, make_row_mesh(S, device="cpu"))
    _assert_equal(J, P)


@pytest.mark.parametrize("S", [8, 3])
@pytest.mark.parametrize("case", ["owner_local", "scrambled", "duplicates"])
def test_pcsr_from_coo_device_equal(S, case):
    rows, cols, vals, coo = _triplet_blocks(
        16, S, scramble=case != "owner_local", duplicate=case == "duplicates",
        seed=S)
    kw = dict(ell_width=7, off_width=4, ghost_capacity=256)
    J = j_pcsr_from_coo_device(rows, cols, vals, coo.shape, j_make_row_mesh(S), **kw)
    tm = make_row_mesh(S, device="cpu")
    P = pcsr_from_coo_device(rows, cols, vals, coo.shape, tm, **kw)
    _assert_equal(J, P)
    # the same operator as the host assembly, through matvec
    A = sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)
    x = np.random.default_rng(1).normal(size=coo.shape[0])
    y = P.matvec(pvector(x, P.col_partition, tm)).to_global().numpy()
    np.testing.assert_allclose(y[: coo.shape[0]], A @ x, rtol=1e-5, atol=1e-5)


def test_pcsr_from_coo_device_rectangular_equal():
    """An interpolation-shaped 256×90 matrix with duplicates, routed from
    scrambled blocks; no identity padding."""
    rng = np.random.default_rng(7)
    n, nc, S = 256, 90, 8
    r = np.repeat(np.arange(n), 3)
    c = np.clip(r * nc // n + rng.integers(-5, 6, size=r.size), 0, nc - 1)
    v = rng.uniform(0.1, 1.0, size=r.size)
    which = rng.integers(0, S, size=r.size)
    T = int(np.bincount(which, minlength=S).max())
    rows = np.full((S, T), -1, np.int64)
    cols = np.zeros((S, T), np.int64)
    vals = np.zeros((S, T))
    for s in range(S):
        sel = which == s
        k = int(sel.sum())
        rows[s, :k], cols[s, :k], vals[s, :k] = r[sel], c[sel], v[sel]
    kw = dict(ell_width=4, off_width=4, pad_identity=False, ghost_capacity=128)
    J = j_pcsr_from_coo_device(rows, cols, vals, (n, nc), j_make_row_mesh(S), **kw)
    P = pcsr_from_coo_device(rows, cols, vals, (n, nc),
                             make_row_mesh(S, device="cpu"), **kw)
    _assert_equal(J, P)


@pytest.mark.parametrize("cap,kw", [
    ("route_capacity", dict(route_capacity=4)),
    ("ell/off_width", dict(ell_width=2)),
    ("ghost_capacity", dict(ghost_capacity=2)),
    ("send_capacity", dict(send_capacity=1)),
])
def test_overflow_raises_by_name(cap, kw):
    rows, cols, vals, coo = _triplet_blocks(16, 8, scramble=True)
    args = dict(ell_width=7, off_width=4, ghost_capacity=256)
    args.update(kw)
    with pytest.raises(ValueError, match=f"overflow: {cap} too small"):
        pcsr_from_coo_device(rows, cols, vals, coo.shape,
                             make_row_mesh(8, device="cpu"), **args)
    with pytest.raises(ValueError, match=f"overflow: {cap} too small"):
        j_pcsr_from_coo_device(rows, cols, vals, coo.shape, j_make_row_mesh(8),
                               **args)
