#!/usr/bin/env python3
"""Where the distributed Ruge–Stüben setup on the card first departs from the
same code on the CPU.

    python3 scripts/bisect_rs_stages.py [--nx 1024] [--parts 8] [--levels 5]

Config #2 (2D Poisson nx², Ruge–Stüben PMIS + extended+i, Chebyshev,
n_coarse_max=256) in ``--parts`` parts on the CUDA card.  For each level ℓ,
the card's operator A_ℓ is copied bit for bit to a CPU mesh of as many parts,
and the level's stages run on both devices from that same input: strength,
PMIS, coarse numbering, interpolation, transpose, R·A and the Galerkin
product (the CPU runs the kernels' plain versions).  Each stage's output is
compared bit for bit; the first stage that differs is printed per level with
the count of differing entries, then the card's A_{ℓ+1} feeds level ℓ+1.  Beside it the whole setup runs on the
CPU alone from A_0 (its own A_{ℓ+1} feeding level ℓ+1), and its level rows
are printed: the CPU path equals the JAX package's 8-shard setup bit for bit
at every level of config #2 (scripts/bisect_rs_vs_jax.py), so a stage that
departs here is a departure of the card's from the JAX package's.  JSON
lines on stdout.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--levels", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bisect_rs_stages: torch finds no CUDA card")
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 1))
    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.parallel import prs_setup as prs
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR
    from parallel_amg_tpu_torch.problems import poisson2d

    cfg = ptt.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                        interpolation="extended_i", on_device_setup=True)
    gpu, cpu = ptt.make_row_mesh(args.parts), ptt.make_row_mesh(args.parts,
                                                                device="cpu")

    def to_cpu(A):
        f = {k: [t.cpu() for t in getattr(A, k)] for k in (
            "diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx", "recv_map")}
        return PCSR(mesh=cpu, row_partition=A.row_partition,
                    col_partition=A.col_partition, true_shape=A.true_shape, **f)

    def tensors(x):
        if isinstance(x, PCSR):
            return [t for k in ("diag_cols", "diag_vals", "off_cols", "off_vals",
                                "send_idx", "recv_map") for t in getattr(x, k)]
        if hasattr(x, "parts"):
            return list(x.parts)
        if isinstance(x, (list, tuple)):
            return [t for y in x for t in tensors(y)]
        if isinstance(x, torch.Tensor):
            return [x]
        return [torch.tensor(x)]

    def differ(a, b):
        """Entries that differ (shapes first), 0 when bit-equal."""
        ta, tb = tensors(a), tensors(b)
        if len(ta) != len(tb) or any(x.shape != y.shape for x, y in zip(ta, tb)):
            return -1
        return int(sum(int((x.cpu() != y).sum()) for x, y in zip(ta, tb)))

    def stages(A, lvl):
        out = {}
        Sd, So = prs.pcsr_strength(A, cfg.theta)
        out["strength"] = (Sd, So)
        state = prs.pcsr_pmis(A, Sd, So, seed=lvl)
        out["pmis"] = state
        cmap, mc_pad, nc = prs.coarse_numbering(A, state)
        out["coarse_numbering"] = (cmap, mc_pad, nc)
        P = prs.pcsr_interpolation(A, Sd, So, state, cmap, mc_pad, cfg)
        out["interpolation"] = P
        R = prs.pcsr_transpose(P, rows_per_shard=mc_pad)
        out["transpose"] = R
        RA = prs.pcsr_spgemm(R, A)
        out["R·A"] = RA
        out["galerkin"] = prs._ensure_diag(prs.pcsr_spgemm(RA, P, pad_identity=True))
        return out, nc

    A = PCSR.from_csr(poisson2d(args.nx).to_csr(), gpu)
    rows = A.true_shape[0]
    A_cpu, cpu_rows = to_cpu(A), [rows]
    for lvl in range(args.levels):
        if rows <= cfg.n_coarse_max:
            break
        card, nc_card = stages(A, lvl)
        host, nc_host = stages(to_cpu(A), lvl)
        if lvl == 0:
            chain, nc_chain = host, nc_host
        else:
            chain, nc_chain = stages(A_cpu, lvl)
        A_cpu = chain["galerkin"]
        cpu_rows.append(nc_chain)
        diffs = {k: differ(card[k], host[k]) for k in card}
        first = next((k for k, d in diffs.items() if d), None)
        print(json.dumps({"level": lvl, "rows": rows,
                          "coarse_rows_card": nc_card, "coarse_rows_cpu": nc_host,
                          "first_stage_that_differs": first,
                          "differing_entries": diffs}), flush=True)
        A, rows = card["galerkin"], nc_card
    print(json.dumps({"cpu_chain_rows": cpu_rows,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()
