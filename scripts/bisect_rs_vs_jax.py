#!/usr/bin/env python3
"""Where the port's Ruge–Stüben setup first departs from the JAX package's,
both on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/bisect_rs_vs_jax.py --mode parts \\
        [--nx 1024] [--parts 8] [--levels 7] [--setup]
    JAX_PLATFORMS=cpu python3 scripts/bisect_rs_vs_jax.py --mode device \\
        [--nx 1024] [--levels 7] [--setup]

Config #2 (2D Poisson nx², Ruge–Stüben PMIS + extended+i, Chebyshev,
n_coarse_max=256).  ``--mode parts`` runs the stages of
``parallel/prs_setup.py`` in both packages on ``--parts`` parts (the JAX
package's virtual CPU mesh of as many devices); ``--mode device`` runs those
of ``amg/device_rs.py``.  At each level ℓ the JAX package's A_ℓ is copied
into the port as numpy arrays, and every stage of the port is fed the JAX
package's output of the stage before: strength, PMIS, coarse numbering,
interpolation, transpose, R·A and the Galerkin product.  Each stage's
output is compared bit for bit (int32 views of the floats), so a departure
is charged to the stage that makes it.  One JSON line per level: the count
of differing entries per stage (-1 where the shapes differ) and the first
stage that differs; the JAX package's A_{ℓ+1} feeds level ℓ+1.

``--setup`` then runs the port's whole setup on the CPU from A_0 through its
entry point (``distributed_setup`` or ``setup``) and PCG to 1e-6 with the b
of ``scripts/bench_distributed.py`` (normal, seed 0), and prints its level
rows, complexities, iterations and extended+i's table widths per level.
``--jax-setup`` does the same with the JAX package's entry point, as
``scripts/bench_distributed.py`` does before its single-device reference
(which the JAX package cannot set up above 2^19 rows: its chunked
``ell_transpose`` is undefined); ``--no-stages`` skips the bisect.
In ``--mode device`` the JAX package's transpose is called with
``row_chunk`` = its row count for the same reason: its single-shot path,
which its chunked path equals by construction.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _args():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("parts", "device"), default="parts")
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--setup", action="store_true")
    ap.add_argument("--jax-setup", action="store_true")
    ap.add_argument("--no-stages", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    return ap.parse_args()


args = _args()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={args.parts}")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import parallel_amg_tpu as pat  # noqa: E402
import parallel_amg_tpu_torch as ptt  # noqa: E402

FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
          "recv_map")
STAGES = ("strength", "pmis", "coarse_numbering", "interpolation",
          "transpose", "R·A", "galerkin")


def bits(x):
    """A numpy view that compares floats bit for bit."""
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.int32) if a.dtype == np.float32 else a


def differ(a, b) -> int:
    """Entries of a that differ from b (lists compared pairwise); -1 when
    the shapes differ."""
    if isinstance(a, (list, tuple)):
        ds = [differ(x, y) for x, y in zip(a, b)]
        return -1 if len(a) != len(b) or -1 in ds else sum(ds)
    a, b = bits(a), bits(b)
    if a.shape != b.shape:
        return -1
    return int((a != b).sum())


def cfg_kw():
    return dict(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                interpolation="extended_i", on_device_setup=True)


def problem(nx):
    from parallel_amg_tpu.problems import poisson2d

    coo = poisson2d(nx)
    return sp.csr_matrix((coo.val, (coo.row, coo.col)), shape=coo.shape)


# ---------------------------------------------------------------------------
# the distributed stages (parallel/prs_setup.py)
# ---------------------------------------------------------------------------

def parts_bisect(A_sp, levels):
    from parallel_amg_tpu.parallel import make_row_mesh as j_mesh
    from parallel_amg_tpu.parallel import prs_setup as jprs
    from parallel_amg_tpu.parallel.pcsr import PCSR as JPCSR
    from parallel_amg_tpu_torch.interop import pcsr_from_numpy
    from parallel_amg_tpu_torch.parallel import prs_setup as prs
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid

    cj, ct = pat.AMGConfig(**cfg_kw()), ptt.AMGConfig(**cfg_kw())
    jm, tm = j_mesh(args.parts), ptt.make_row_mesh(args.parts, device="cpu")

    def port_pcsr(M):
        arrays = {f: np.asarray(getattr(M, f)) for f in FIELDS}
        arrays.update(row_partition=M.row_partition,
                      col_partition=M.col_partition, true_shape=M.true_shape)
        return pcsr_from_numpy(arrays, tm)

    def port_parts(x, S):
        x = np.asarray(x)
        return [torch.from_numpy(np.array(p)) for p in x.reshape(S, -1, *x.shape[2:])]

    def planes(M):
        """A PCSR's planes as (S, ...) arrays, from either package."""
        if isinstance(M, JPCSR):
            return [np.asarray(getattr(M, f)) for f in FIELDS]
        return [np.stack([t.numpy() for t in getattr(M, f)]) for f in FIELDS]

    Aj = JPCSR.from_csr(A_sp, jm)
    n = Aj.true_shape[0]  # true rows; a coarse PCSR's shape is part-padded
    rows = []
    for lvl in range(levels):
        rows.append(n)
        if n <= cj.n_coarse_max:
            break
        S = Aj.n_shards
        t0 = time.perf_counter()
        At = port_pcsr(Aj)
        d = {}
        Sdj, Soj = jprs.pcsr_strength(Aj, cj.theta)
        Sdt, Sot = prs.pcsr_strength(At, ct.theta)
        d["strength"] = differ([np.asarray(Sdj), np.asarray(Soj)],
                               [np.stack(Sdt), np.stack(Sot)])
        Sd_in, So_in = port_parts(Sdj, S), port_parts(Soj, S)
        stj = jprs.pcsr_pmis(Aj, Sdj, Soj, seed=lvl)
        stt = prs.pcsr_pmis(At, Sd_in, So_in, seed=lvl)
        d["pmis"] = differ(np.asarray(stj), stt.to_global().numpy())
        st_in = PGrid(port_parts(stj, S), tm)
        cmj, mcj, ncj = jprs.coarse_numbering(Aj, stj)
        cmt, mct, nct = prs.coarse_numbering(At, st_in)
        d["coarse_numbering"] = (differ(np.asarray(cmj), cmt.to_global().numpy())
                                 + abs(mcj - mct) + abs(ncj - nct))
        if ncj >= n or ncj == 0:
            break
        cm_in = PGrid(port_parts(cmj, S), tm)
        Pj = jprs.pcsr_interpolation(Aj, Sdj, Soj, stj, cmj, mcj, cj)
        Pt = prs.pcsr_interpolation(At, Sd_in, So_in, st_in, cm_in, mcj, ct)
        d["interpolation"] = differ(planes(Pt), planes(Pj))
        Rj = jprs.pcsr_transpose(Pj, rows_per_shard=mcj)
        Rt = prs.pcsr_transpose(port_pcsr(Pj), rows_per_shard=mcj)
        d["transpose"] = differ(planes(Rt), planes(Rj))
        RAj = jprs.pcsr_spgemm(Rj, Aj)
        RAt = prs.pcsr_spgemm(port_pcsr(Rj), At)
        d["R·A"] = differ(planes(RAt), planes(RAj))
        Acj = jprs._ensure_diag(jprs.pcsr_spgemm(RAj, Pj, pad_identity=True))
        Act = prs._ensure_diag(prs.pcsr_spgemm(port_pcsr(RAj), port_pcsr(Pj),
                                               pad_identity=True))
        d["galerkin"] = differ(planes(Act), planes(Acj))
        report(lvl, n, ncj, d, time.perf_counter() - t0)
        Aj, n = Acj, ncj
    return rows


# ---------------------------------------------------------------------------
# the one-device stages (amg/device_rs.py)
# ---------------------------------------------------------------------------

def device_bisect(A_sp, levels):
    import jax.numpy as jnp
    from parallel_amg_tpu.amg import device_rs as jrs
    from parallel_amg_tpu.ops import ell_setup as jell
    from parallel_amg_tpu.ops.csr import CSR as JCSR
    from parallel_amg_tpu.ops.ell import ELL as JELL
    from parallel_amg_tpu_torch.amg import device_rs as trs
    from parallel_amg_tpu_torch.ops import ell_setup as tell
    from parallel_amg_tpu_torch.ops.ell import ELL as TELL

    cj, ct = pat.AMGConfig(**cfg_kw()), ptt.AMGConfig(**cfg_kw())

    def port_ell(M):
        return TELL(*(torch.from_numpy(np.array(getattr(M, f)))
                      for f in ("cols", "vals", "row_nnz")), tuple(M.shape))

    def planes(M):
        return [np.asarray(getattr(M, f)) if isinstance(M, JELL)
                else getattr(M, f).numpy() for f in ("cols", "vals", "row_nnz")]

    Aj = JELL.from_csr(JCSR.from_scipy(A_sp), dtype=jnp.float32)
    rows = []
    for lvl in range(levels):
        n = Aj.n_rows
        rows.append(n)
        if n <= cj.n_coarse_max:
            break
        t0 = time.perf_counter()
        At = port_ell(Aj)
        d = {}
        Sj = jrs.classical_strength_mask(Aj, cj.theta)
        St = trs.classical_strength_mask(At, ct.theta)
        d["strength"] = differ(np.asarray(Sj), St.numpy())
        S_in = torch.from_numpy(np.array(Sj))
        stj = jrs.pmis_split_device(Aj, Sj, seed=lvl)
        stt = trs.pmis_split_device(At, S_in, seed=lvl)
        d["pmis"] = differ(np.asarray(stj), stt.numpy())
        st_in = torch.from_numpy(np.array(stj))
        nc = int((np.asarray(stj) == jrs.COARSE).sum())
        d["coarse_numbering"] = 0  # a cumsum inside the interpolation
        Pj = jrs.extended_i_interpolation_device(Aj, Sj, stj, cj.p_max)
        Pt = trs.extended_i_interpolation_device(At, S_in, st_in, ct.p_max)
        d["interpolation"] = differ(planes(Pt), planes(Pj))
        if Pj.shape[1] >= n or nc == 0:
            break
        Rj = jell.ell_transpose(Pj, row_chunk=Pj.n_rows)
        Rt = tell.ell_transpose(port_ell(Pj))
        d["transpose"] = differ(planes(Rt), planes(Rj))
        RAj = jell.ell_spgemm(Rj, Aj)
        RAt = tell.ell_spgemm(port_ell(Rj), At)
        d["R·A"] = differ(planes(RAt), planes(RAj))
        Acj = jell.ell_prune(jell.ell_spgemm(RAj, Pj), tol=0.0)
        Act = tell.ell_prune(tell.ell_spgemm(port_ell(RAj), port_ell(Pj), sort=False),
                             tol=0.0)
        d["galerkin"] = differ(planes(Act), planes(Acj))
        report(lvl, n, nc, d, time.perf_counter() - t0)
        Aj = Acj
    return rows


def report(lvl, n, nc, d, secs):
    first = next((k for k in STAGES if d.get(k)), None)
    print(json.dumps({"level": lvl, "rows": n, "coarse_rows": nc,
                      "first_stage_that_differs": first,
                      "differing_entries": d, "seconds": round(secs, 1)}),
          flush=True)


def jax_setup(A_sp):
    """The JAX package's whole setup and PCG on the CPU, through its entry
    points."""
    import jax.numpy as jnp
    from parallel_amg_tpu.ops import ell_setup as jell
    from parallel_amg_tpu.parallel import make_row_mesh, pvector
    from parallel_amg_tpu.parallel.psetup import distributed_setup

    b_np = np.random.default_rng(0).normal(size=A_sp.shape[0])
    cfg = pat.AMGConfig(**cfg_kw())
    t0 = time.perf_counter()
    if args.mode == "parts":
        mesh = make_row_mesh(args.parts)
        h = distributed_setup(A_sp, cfg, mesh)
        setup_s = time.perf_counter() - t0
        b = pvector(b_np, h.levels[0].A.row_partition, mesh)
        res = pat.amg_pcg(h.levels[0].A, h, b, tol=1e-6, maxiter=100)
        rows = [l.n for l in h.levels]
    else:
        jell._TRANSPOSE_CHUNK_ROWS = 1 << 62  # the single-shot transpose
        h = pat.setup(A_sp, cfg)
        setup_s = time.perf_counter() - t0
        res = pat.amg_pcg(None, h, jnp.asarray(b_np, jnp.float32), tol=1e-6,
                          maxiter=100)
        rows = [l.A.n_rows for l in h.levels]
    gc, oc = h.complexity()
    print(json.dumps({"jax_setup": args.mode, "rows": rows,
                      "grid_complexity": float(gc), "operator_complexity": float(oc),
                      "pcg_iters": int(res.iters), "converged": bool(res.converged),
                      "setup_s": round(setup_s, 1)}), flush=True)


def port_setup(A_sp):
    """The port's whole setup and PCG on the CPU, through its entry points."""
    b_np = np.random.default_rng(0).normal(size=A_sp.shape[0])
    cfg = ptt.AMGConfig(**cfg_kw())
    t0 = time.perf_counter()
    if args.mode == "parts":
        mesh = ptt.make_row_mesh(args.parts, device="cpu")
        h = ptt.distributed_setup(ptt.PCSR.from_csr(A_sp, mesh), cfg, mesh)
        setup_s = time.perf_counter() - t0
        part = h.levels[0].A.row_partition
        res = ptt.amg_pcg(None, h, ptt.pvector(b_np, part, mesh), tol=1e-6,
                          maxiter=100)
        rows = [l.n for l in h.levels]
    else:
        h = ptt.setup(A_sp, cfg, device="cpu")
        setup_s = time.perf_counter() - t0
        res = ptt.amg_pcg(None, h, torch.from_numpy(b_np).float(), tol=1e-6,
                          maxiter=100)
        rows = [l.A.n_rows for l in h.levels]
    gc, oc = h.complexity()
    print(json.dumps({"port_setup": args.mode, "rows": rows,
                      "grid_complexity": gc, "operator_complexity": oc,
                      "pcg_iters": res.iters, "converged": bool(res.converged),
                      "setup_s": round(setup_s, 1),
                      "ext_i": [l.get("ext_i") for l in h.setup_stats["levels"]]}),
          flush=True)


def main():
    torch.set_num_threads(args.threads)
    jax.config.update("jax_platforms", "cpu")
    A_sp = problem(args.nx)
    if not args.no_stages:
        fn = parts_bisect if args.mode == "parts" else device_bisect
        rows = fn(A_sp, args.levels)
        print(json.dumps({"mode": args.mode, "nx": args.nx, "jax_rows": rows}),
              flush=True)
    if args.setup:
        port_setup(A_sp)
    if args.jax_setup:
        jax_setup(A_sp)


if __name__ == "__main__":
    main()
