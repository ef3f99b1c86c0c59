"""Bodies of the multi-process tests (``tests/test_torch_multiprocess_*.py``).

``parallel/launch.py`` imports this module in every rank, so it imports no
JAX.  Each body builds its inputs from a seed, runs one path of the port on
a mesh of this run's processes (on the CPU, or on the card where ``device``
is None), and returns ``{"parts": {...}, "rep":
{...}}``: numpy copies of the per-part results of the parts this process
holds, in part order, and the values every process holds whole (and, for
the structured path, kernel B8's launches and whether its interior entry
ran, by halo mode: these depend on where the parts lie, so ``same`` does
not compare them).  The tests
run the same body in one process and hold the ranks' parts, joined in rank
order, and each rank's whole values bit-equal to it (``same``).
"""

import numpy as np
import scipy.sparse as sp
import torch

import parallel_amg_tpu_torch as ptt
from parallel_amg_tpu_torch.parallel import mesh as pmesh
from parallel_amg_tpu_torch.parallel.passembly_device import pcsr_from_coo_device
from parallel_amg_tpu_torch.parallel.pcsr import PCSR
from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
from parallel_amg_tpu_torch.problems import poisson2d

PLANES = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")


def process_view(n_parts):
    """(rank, world, the parts this rank holds) of an n_parts CPU mesh."""
    rank, world = pmesh.process()
    mesh = ptt.make_row_mesh(n_parts, device="cpu")
    return rank, world, list(mesh.local)


def _np(parts):
    return [t.detach().cpu().numpy() for t in parts]


def _whole(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def _pcsr_parts(A, key, out):
    for f in PLANES:
        out[f"{key}.{f}"] = _np(getattr(A, f))


def same(single, ranks):
    """Assert the ranks' results bit-equal to the single-process one."""
    for k, want in single["parts"].items():
        got = [a for r in ranks for a in r["parts"][k]]
        assert len(got) == len(want), k
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert a.tobytes() == b.tobytes(), k
    for k, want in single["rep"].items():
        for r in ranks:
            got = r["rep"][k]
            if isinstance(want, np.ndarray):
                assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), k
            else:
                assert got == want, k


# -- the algebraic layer --------------------------------------------------------

def _random_matrix(n, seed):
    """A square sparse matrix with scattered off-diagonal columns (ghosts
    from every part) and a dominant diagonal."""
    rng = np.random.default_rng(seed)
    M = sp.random(n, n, density=6.0 / n, random_state=rng, format="csr")
    return (M + sp.diags(rng.uniform(4.0, 5.0, n))).tocsr()


def pcsr_ops(n, S, seed, device="cpu"):
    """PCSR.from_csr, matvec on the dense and the ring plans, consistent,
    assemble, to_csr, repartition re-aligned and shrunk to S/2 parts, and
    pcsr_from_coo_device from triplets scattered over the parts."""
    mesh = ptt.make_row_mesh(S, device=device)
    A_sp = _random_matrix(n, seed)
    A = PCSR.from_csr(A_sp, mesh)
    rng = np.random.default_rng(seed + 1)
    x = ptt.pvector(rng.normal(size=n), A.col_partition, mesh)
    parts, rep = {}, {}
    _pcsr_parts(A, "A", parts)
    parts["dense"] = _np(A.matvec(x).parts)
    Ar = A.with_neighbor_plan()
    parts["ring"] = _np(Ar.matvec(x).parts)
    rep["nb_offsets"] = Ar.nb_offsets
    g = A.consistent(x)
    parts["consistent"] = _np(g.parts)
    parts["assemble"] = _np(A.assemble(g, x).parts)
    csr = A.to_csr()
    for f in ("indptr", "indices", "data"):
        rep[f"to_csr.{f}"] = np.asarray(getattr(csr, f))
    rep["nnz"] = A.nnz
    m = A.row_partition.rows_per_shard
    B = A.repartition(mesh, rows_per_shard=m + 3)
    _pcsr_parts(B, "realigned", parts)
    small = ptt.make_row_mesh(S // 2, device=device)
    C = A.repartition(small)
    _pcsr_parts(C, "shrunk", parts)
    xs = ptt.pvector(rng.normal(size=n), C.col_partition, small)
    parts["shrunk_matvec"] = _np(C.matvec(xs).parts)
    # triplets of A scattered over the parts, with duplicates split off
    coo = A_sp.tocoo()
    r, c, v = coo.row, coo.col, coo.data.astype(np.float32)
    half = v / 2
    r, c, v = (np.concatenate([r, r]), np.concatenate([c, c]),
               np.concatenate([half, v - half]))
    order = rng.permutation(len(r))
    T = -(-len(r) // S)
    pad = S * T - len(r)
    blocks = [np.concatenate([a[order], np.full(pad, f, a.dtype)]).reshape(S, T)
              for a, f in ((r, -1), (c, 0), (v, 0))]
    D = pcsr_from_coo_device(*blocks, A_sp.shape, mesh, ell_width=16,
                             off_width=16, ghost_capacity=n)
    _pcsr_parts(D, "device_assembly", parts)
    return {"parts": parts, "rep": rep}


def _levels(h, parts, rep):
    """Each level's operators' planes (parts), rows and λ_max (whole)."""
    for i, l in enumerate(h.levels):
        rep[f"L{i}.true_n"] = l.true_n
        rep[f"L{i}.lam"] = l.lam_max
        for k in ("A", "P", "R"):
            T = getattr(l, k)
            if isinstance(T, PCSR):
                _pcsr_parts(T, f"L{i}.{k}", parts)
    rep["coarse_inv"] = _whole(h.coarse_inv)


def _pcg(h, b_host, parts, rep, key):
    b = ptt.pvector(b_host, h.levels[0].A.row_partition, h.levels[0].A.mesh)
    res = ptt.amg_pcg(None, h, b, tol=1e-6, maxiter=60)
    parts[f"{key}.x"] = _np(res.x.parts)
    rep[f"{key}.iters"] = res.iters
    rep[f"{key}.history"] = _whole(res.residual_history)


def algebraic_setup(n, S, kind, seed=0, device="cpu"):
    """distributed_setup of poisson2d(n) on S parts ("host": the oracle
    frozen to PCSR levels, with FGMRES beside PCG; "rs" / "sa": on the
    parts' devices), then PCG to 1e-6."""
    mesh = ptt.make_row_mesh(S, device=device)
    A = poisson2d(n).to_csr().to_scipy()
    cfg = dict(coarsening="rs" if kind != "sa" else "sa", smoother="chebyshev",
               n_coarse_max=32, on_device_setup=kind != "host")
    if kind == "host":
        cfg["agglomerate_n"] = 64
    h = ptt.distributed_setup(A, ptt.AMGConfig(**cfg), mesh)
    parts, rep = {}, {}
    _levels(h, parts, rep)
    b = np.random.default_rng(seed).normal(size=A.shape[0])
    _pcg(h, b, parts, rep, "pcg")
    if kind == "host":
        bp = ptt.pvector(b, h.levels[0].A.row_partition, mesh)
        res = ptt.amg_fgmres(None, h, bp, tol=1e-6, restart=10)
        parts["fgmres.x"] = _np(res.x.parts)
        rep["fgmres.iters"] = res.iters
        rep["fgmres.residual"] = _whole(res.residual_norm)
    return {"parts": parts, "rep": rep}


# -- the structured layer -------------------------------------------------------

def structured_setup(dims, S, seed=0, device="cpu"):
    """sharded_device_setup of the Poisson stencil born split over S parts
    (config #3's block SA), then PCG to 1e-6 under halo_mode "xla" and
    "pallas_async" (kernel B8's route, its plain version on the CPU)."""
    import dataclasses

    from parallel_amg_tpu_torch.parallel import phalo_async

    mesh = ptt.make_row_mesh(S, device=device)
    cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                        smoother="chebyshev", n_coarse_max=64,
                        agglomerate_n=256, on_device_setup=True)
    parts, rep, launches, route = {}, {}, {}, {}
    b_host = np.random.default_rng(seed).normal(size=int(np.prod(dims)))
    for mode in ("xla", "pallas_async"):
        c = dataclasses.replace(cfg, halo_mode=mode)
        A, td = ptt.poisson_stencil_sharded(dims, mesh, c)
        h = ptt.sharded_device_setup(A, c, true_dims=td)
        for i, l in enumerate(h.levels):
            rep[f"{mode}.L{i}.lam"] = l.lam_max
            if isinstance(l.A, ShardedStencil):
                parts[f"{mode}.L{i}.W"] = _np(l.A.weights)
        calls = []
        real = phalo_async.stencil_interior
        phalo_async.stencil_interior = lambda *a: calls.append(1) or real(*a)
        before = dict(phalo_async.LAUNCHES)
        try:
            b = ptt.distribute_grid(b_host, td, h, mesh)
            res = ptt.amg_pcg(None, h, b, tol=1e-6, maxiter=60)
        finally:
            phalo_async.stencil_interior = real
        rep[f"{mode}.iters"] = res.iters
        rep[f"{mode}.history"] = _whole(res.residual_history)
        rep[f"{mode}.x"] = ptt.collect_grid(res.x, td)
        route[mode] = bool(calls)
        launches[mode] = {k: phalo_async.LAUNCHES[k] - before[k] for k in before}
    return {"parts": parts, "rep": rep, "launches": launches, "route": route}


# -- failures -------------------------------------------------------------------

def fail_on_rank(bad):
    """Rank ``bad`` raises; the others wait on a collective it never joins."""
    rank, _ = pmesh.process()
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    torch.distributed.barrier()


def hang_on_rank(bad):
    """Rank ``bad`` never returns; the others finish."""
    import time

    rank, _ = pmesh.process()
    while rank == bad:
        time.sleep(1)
    return rank
