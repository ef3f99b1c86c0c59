#!/usr/bin/env python3
"""Smoke test of parallel_amg_tpu_torch on one CUDA card.

    python3 chip_smoke.py

1. Device: torch, CUDA and nvcc versions, the card's name and power limit.
2. Build: compiles csrc/twell_spmv.cu, csrc/flatdia_spmv.cu,
   csrc/spgemm.cu, csrc/bsr_spmv.cu and csrc/flatdia_spmm.cu with nvcc into
   build/, all at once, and prints each one's ptxas lines; then the card's
   copy bandwidth from a 1 GiB device-to-device copy.
3. Setup of acceptance config #2 at its full size (2D Poisson 1024²,
   Ruge–Stüben PMIS + extended+i, Chebyshev, n_coarse_max=256) on the card.
4. Kernel B1 (twell_spmv) against its plain torch version on a random
   rectangular matrix, a long-row matrix, a matrix with rows past the
   kernel's shared-memory capacity (its long-row path), config #2's
   level-1 A, P0 and R0 and its coarse levels 2–4, in float32 and bfloat16:
   kernel, plain, bound and library-CSR times, and y bit-equal over 20
   calls.
5. setup3d: acceptance config #3 at its full size (3D Poisson 128³,
   block SA b=3, Chebyshev, n_coarse_max=512) set up on the card, with its
   ``ordered_fma`` launches; every level's λ_max held equal to the same
   power iteration on the CPU.  Then galerkin_order: the dense, bucketed
   and slab (4 slabs) Galerkin products of random 3-D stencils and the
   whole sharded setup in 4 parts, on the card, each held bit-equal to the
   port's CPU run of the same function on the same inputs; config #3 at
   128³, the card's setup against a CPU run of the same setup level by
   level, weights, D⁻¹ and λ, and against the JAX package's CPU record of
   the same levels (artifacts/config3_jax_levels.json, line
   ``config3_vs_jax_record``); ``ordered_fma`` at config #3's level-1 smoother centre
   against its plain version (kernel, plain and bound times); and the
   device coarse inverse (A8) of config #3's coarsest operator against the
   float64 host form.  Then ``ordered_stencil_matvec`` (the power
   iterations' D⁻¹·A·x, one launch a card) on config #3's level 0, on a
   grid whose centre is added unfused, and on three whose centre is
   unfused on the rows LLVM's vector loop covers (64 × 45 × 8, rows 0–43;
   16 × 468 × 8 in 8 parts, every row; 16 × 45 × 6 in 8 parts, rows 0–43),
   bit-equal to its plain version and
   to the ordered-sum launches the power iterations took before it, with
   its device ms and that sequence's in turns, the plain version's, one
   cuSPARSE CSR product of D⁻¹A's and the bound (again on config #3's two
   split levels in 4 parts after phase 19
   and on 468³'s in 8 parts in phase 23).  setup3d holds one
   ``ordered_stencil_matvec`` an iteration of every level's power
   iteration, one ``ordered_bucket_stage`` a bucketed stage and fewer
   ``ordered_fma`` than the 82 of the earlier stages.  Then
   ``ordered_bucket_stage`` on the three stages of config #3's level-0
   bucketed product and of a seeded 27-point 52³ operator (468³'s gathered
   tail), bit-equal to its plain version and to the earlier ``ordered_fma``
   sequence (``tests/bucket_sequence.py``), with both times in turns, the
   plain version's and the bound.  The CPU references of config #3 (its
   levels' λ and its 128³ levels) start in host processes after these
   timings; a line ``host_reference`` for each reference says when it ran.
   Then poisson2d: 2-D 5-point Poisson 1024² on the structured setup
   (block SA b=3, Chebyshev, n_coarse_max=64) on the card, its launches (one
   ``ordered_stencil_matvec`` an iteration of every level's power
   iteration, the 2-D norms through ``ordered_sum_lanes``), every level
   held against the JAX package's CPU record
   (artifacts/poisson2d_jax_levels.json, line ``poisson2d_vs_jax_record``)
   and against the port's CPU run of the same setup in a host process (line
   ``poisson2d_vs_cpu``, with its PCG count); amg_pcg to 1e-6 with the
   record's iteration count and the float64 true residual held to 1e-6 +
   (iters + 1)·floor; the setup's ordered sums on the card against their
   plain version, the largest 2-D norm in (vf, 1, 0) lanes timed
   (``ordered_sum_lanes`` case ``poisson2d_norm``); and
   ``ordered_stencil_matvec`` on three 2-D plans (1000 × 6 with 9 points,
   the centre rounded on rows 0–991; 1000 × 9 with 9 points, the last
   column's chain swapped; 1024 × 8 with 5 points, every row).
6. Kernel B2 (flatdia_spmv) against its plain version on a random 7-point
   128³ stencil, config #3's level-1 coarse stencil, config #2's widest DIA
   level and a tiny grid whose flattened planes alias, in float32 and
   bfloat16, with the same four times.
7. Slice (config #2): V-cycle time, then amg_pcg to 1e-6 with the launch
   counts of both kernels, the true residual in float64 (held to the
   float32 rounding floor, see below) and the float64 oracle's iterations.
8. slice3d (config #3): with_spmv_backend "mixed", V-cycle time, amg_pcg to
   1e-6 with B2's launch count and the true residual in float64; then the
   V-cycle and iterations again under "pallas" (every level on B2).
9. Profile: device kernels, device time and busy share per V-cycle of
   config #2 (host and device setup), config #3 and config #5, and each
   kernel's own device time per V-cycle by name (B1's on config #2)
   (torch.profiler); it runs after phase 16.
10. setup_rs: config #2 set up on the card (``on_device_setup=True``, the
    Ruge–Stüben setup of amg/device_rs.py), twice: seconds, levels, the K and
    w of every product, rows and complexities held equal to the JAX
    package's CPU run, the launches of B3, B4, B5 and the three ordered-sum
    kernels, peak memory, and bit-equality of the two runs; every level's
    λ_max held equal to the same power iteration on the CPU; then a third
    setup with one input of every ordered-sum shape captured (the row sums
    and the power iterations' rows and norms), each held bit-equal to the
    plain version through the ordered-sum kernels; ``ordered_sum_lanes``
    timed on the weak couplings, on 2^20 rows and on the power iteration's
    rows, ``ordered_sum_windows`` on level 0's norm.
11. Kernels B3 (spgemm_expand), B5 (spgemm_dedup) and B4
    (spgemm_dedup_compact) against their plain versions on config #2's
    level-0 R·A and (R·A)·P and level-1 to level-3 R·A (B5 and B4 on the
    k-major candidates ``ell_spgemm`` gives them, with the k-major copy's
    and the row sort's times), a random
    rectangular product, a case with explicit zeros, empty rows and rows
    over out_width, and a product with K 5120 (the in-place and compact
    tables in global scratch; B3 splits its rows into m ranges): B3's
    tiling per case (rows, m and k a tile, staging bytes, store path), B3
    torch.equal to its plain version, B5 and B4 bit-equal to theirs (both
    sum each column in slot order), kernel, plain and bound times of B5
    in both modes and of B3 and B4 (the merges' bound: bytes against one table
    insert per live candidate, with an all-pairs merge's compares beside
    it), cuSPARSE's time for the product, and B4 held bit-equal to B5's
    in-place merge compacted in slot order.
12. convert and slice_rs: with_best_formats(h, device=True), then the
    V-cycle and amg_pcg to 1e-6 on the device-built hierarchy, held to the
    float64 oracle's iterations and the slice's residual limit.
13. aniso: config #4 (anisotropic ε=1e-3 at 512²) set up on the card and
    solved to 1e-6, against the float64 oracle on the same matrix.
14. setup_vec: acceptance config #5 at 128³×3 (the coupled vector Laplacian
    L ⊗ C, γ=0.3, config #3's block-SA config) set up on the card with the
    BSR fine level: seconds, node rows, product paths, complexities against
    the JAX package's, peak memory.
15. Kernel B6 (bsr_spmv) against its plain version on config #5's 128³×3
    BSR (float32 and bfloat16), its BTWELL form through matvec_planes and a
    random block matrix with empty rows; kernel B7 (flatdia_spmm) on the
    128³ scalar L with k = 3 (float32 and bfloat16), 1 and 8, config #3's
    level 1 with k = 3 and a stencil with nonzero off-grid weights: kernel,
    plain, bound and library (torch sparse BSR or CSR) times.
16. slice_vec: config #5's V-cycle (with B6 and B7 launches per cycle) and
    amg_pcg to 1e-6 with the float64 true residual, then the same solve
    with fine_format "btwell" and "bstencil", held to the same count.
17. slice_vec_100m: config #5 at 324³×3 = 102,036,672 DOF set up on the
    card (level 0 on the slab product path; the scalar setup first alone,
    for its seconds and the peak of the slab temporaries), one B6 time at
    that size, and
    amg_pcg to 1e-6 within 60 iterations with the float64 true residual.
    It runs last, after config #1, with the earlier hierarchies of config #5
    freed.
18. Config #1: 64², V(1,1) weighted Jacobi, standalone solve (before 17).
19. setup_dist3d: config #3 split into 4 parts on the card
    (``poisson_stencil_sharded`` over ``make_row_mesh(4)``, then
    ``sharded_device_setup`` with halo_mode "pallas_async"): seconds, peak
    memory, true level rows (levels 0 and 1 sharded, the rest gathered),
    and every level (the split levels' padded global arrays) held to the
    JAX package's 4-part CPU record (weights, D⁻¹, λ).  Each sharded setup
    prints its ordered-sum launches and those of its sharded power
    iterations apart, held to one ``ordered_stencil_matvec`` an iteration
    and no ``ordered_fma``.  Each structured
    setup prints its one-hot dot shapes (line ``dot_shapes``, also written
    to build/galerkin_dot_shapes.json).
20. Kernel B8 against its plain version (the "xla" formulation), bit for
    bit: config #3's level 0 (144×128×128 padded, random weights) and level
    1 (48×43×43, 27 points) in 4 parts, a reach-2 128³ stencil, and a case
    with m0 ≤ h that must not launch.  The one-launch path
    (halo_stencil_matvec, parts on one card: one launch per matvec) with
    kernel, plain, bound and library-CSR times and bit-equality over 20
    calls; the exchange route of parts on several cards or processes (one
    halo_stencil_interior launch, the halos through parallel/exchange.py,
    one halo_stencil_boundary launch; run on one card) bit-equal to the
    plain path and to the one-launch entry and over 20 calls, with its
    whole-matvec time beside cuSPARSE's, and each entry's own time over
    every part in one call, its share of its bound, its plain version's
    time and, for the interior, cuSPARSE CSR of the zero-halo operator;
    launches and device busy share per matvec of both paths
    (torch.profiler).
21. slice_dist3d: the 4-part V-cycle (18 B8 launches per cycle: 9 matvecs
    on each of the 2 sharded levels) and amg_pcg to 1e-6 with the float64
    true residual, held within 2 iterations of slice3d's single-device
    count; the same solve under "xla" with the same residual history.
22. Kernel B9's route: pallas_spgemm (B3 + B5 + B4) against its plain
    version at config #2's level-0 A·A (K = 25), a random rectangular
    product and a product with explicit zeros; the product's time beside
    its bound, the plain version's and cuSPARSE's (after phase 11).
23. slice_dist_100m: 468³ = 102,503,232 DOF in 8 parts on the card: setup
    seconds, peak memory, level rows, level 0's λ and the power iteration on
    the seeded operator of level 1's shape against the JAX package's CPU
    record (artifacts/p468_jax_power.json, line ``p468_vs_jax_record``),
    ``ordered_stencil_matvec`` on both split levels, B8 at level 0 (one launch, bit-equal,
    and the copy-stream path's time beside it), amg_pcg to 1e-6 within 60
    iterations with the float64 true residual.  It runs last, with the
    earlier hierarchies freed.
24. c1: each configuration's PCG iterations, level rows and complexities
    beside the JAX package's, one line each (the random draws are the JAX
    package's threefry uniform, ops/prng.py).
25. mp_rs (after slice): config #2 to a true 1e-8 with amg_pcg_mp (float64
    CG over the float32 V-cycle, which stays on B1 and B2): iterations
    against the JAX package's and the float64 oracle's 10, the float64 true
    residual (≤ 2e-8), solve seconds, B1 and B2 launches, peak memory.
26. mp_sa3d (after slice3d): config #3 ("mixed") to a true 1e-8, against the
    JAX package's 16 iterations; its V-cycle launches B2.
27. bf16 (after mp_sa3d): config #3's and config #2's hierarchies cast to
    bfloat16 (utils/checkpoint.cast_hierarchy, coarse inverse float32)
    preconditioning amg_pcg on the float32 fine operator to 1e-6: iterations
    (config #3 against the JAX package's 13, config #2 within 2 of its
    float32 count), V-cycle ms in bfloat16 and float32, the bfloat16
    kernels' launches per cycle, the true residual.
28. mp_aniso (inside aniso): config #4 to a true 1e-8 against the oracle's
    iterations (JAX package 9), with the true residual against the exact
    matrix and against its float32 rounding, which the solve applies.
29. device_sa (after aniso): torch.argmax takes the first maximum on the
    card; then algebraic SA set up on the card (``coarsening="sa",
    aggregate="greedy", on_device_setup=True``) on 2D Poisson 1024² and 512²
    and 3D Poisson 128³, twice each (bit-equal, the second under
    torch.profiler for the device ms of B3, B5 and B4): seconds, rows,
    complexities, the setup's B3/B5/B4 launches; then with_best_formats and
    amg_pcg to 1e-6: 512² held within 1 of the JAX package's count, 3D to
    30 iterations, the 2D runs beside the oracle's greedy SA on the same
    matrix (reported: the reference's aggregation misses that band above
    32²).
30. fgmres: convection-diffusion 1024², Péclet 5 and 2.5, host RS setup
    (Jacobi, extended+i): amg_pcg must not reach 1e-6 in 80 iterations,
    amg_fgmres(30) must, within 2 restart cycles of scipy's GMRES(30) over
    the oracle V-cycle, with the true residual below 5e-6.
31. checkpoint: config #2's hierarchy saved, loaded onto the card and held
    to a bit-equal V-cycle; file size and seconds.
32. pcsr (after checkpoint): config #2's matrix as a PCSR in 8 parts on the
    card (``make_row_mesh(8)``): ``PCSR.from_csr`` by the g++ builder and
    by numpy (equal), the ring plan's matvec bit-equal to the dense plan's
    and held against the one-device B1 matvec, B1 on every part against the
    plain two-plane sum, ``to_csr`` equal to the input; ms per matvec
    against the one-device B1's, launches and busy share per matvec, the
    ghosts and send width per part.
33. passembly: ``pcsr_from_coo_device`` from the matrix's triplets scattered
    over the 8 parts: planes and plan equal to ``from_csr``'s;
    ``repartition`` re-aligned (m + 8 rows a part) and shrunk to 4 parts,
    each matvec held against the one-device B1's; seconds, peak memory.
34. psetup_host: ``distributed_setup`` from the oracle (config #2, levels of
    ≤ 2,048 rows on part 0's device): levels equal to the oracle's, PCG
    within 1 of the one-device count and the true residual to the slice's
    limit, B1/B2 launches, V-cycle ms and busy share, ``amg_fgmres`` over
    the same hierarchy at 1e-6 (2 restart cycles), its true residual held to
    PCG's limit.
35. prs_setup: ``distributed_setup`` with ``on_device_setup=True`` (the
    Ruge–Stüben setup on the card), twice (the second under torch.profiler):
    bit-equal, rows equal and complexities to three digits equal to the JAX
    package's 8-shard run, PMIS rounds, B3/B5/B4 and ordered-sum launches,
    their per-part product at level 0 held bit-equal to the plain versions
    (values too), every level's λ_max held equal to the CPU's (the CPU's
    power iterations in a host process while the later phases run, held
    before the kernels line, as are config #3's λ and 128³ levels and the
    level-0 P below), PCG the JAX package's 7, V-cycle ms and launches; a
    third
    setup with one input of every ordered-sum shape captured, each held
    bit-equal to the plain version through the ordered-sum kernels,
    ``ordered_sum_staged`` and ``ordered_sum_windows`` timed on their
    largest, and level 0's P on the card held bit-equal to the CPU's; 6
    W-cycles on these levels and on the one-device RS hierarchy, float64 true
    residuals a cycle (reported), and a W-cycle ``solve`` of 12 cycles on
    the same setup with λ_max from 100 power iterations, its true residual
    held to 1e-6 + 13·floor as PCG's is.
36. psa_setup: ``distributed_setup`` with algebraic SA on the card at 256²
    (twice, bit-equal; rows and PCG held to the JAX package's) and 1024²
    (converged; rows, complexities and the oracle's count reported).
37. multiprocess (after psa_setup): 2 ranks on the card
    (``parallel/launch.py``: ``runtime_init`` with the gloo route and a
    FileStore under build/multiprocess, the kernel libraries already built
    by the parent, a 600 s join timeout), each holding half of the parts:
    config #2 in 8 parts (the host oracle's setup and PCG, iterate and count
    bit-equal to phase 34's; the Ruge–Stüben setup on the card, its levels'
    planes and plans bit-equal to phase 35's, PCG count equal), config #3 in
    4 parts ("pallas_async", residual history bit-equal to phase 21's, B8's
    interior and boundary kernels launched on the exchange route, one of
    each a rank a level-0 matvec) and SA at
    256² in 8 parts (rows and PCG held as in phase 36).  Per rank: setup and
    solve seconds, V-cycle wall and CUDA-event ms, the exchange's host ms per
    V-cycle and per matvec and its share, peak memory, and the launches of
    each path; a rank that fails or outlasts the timeout fails the script.

Every phase prints JSON lines.  Any failure raises, so the script exits
non-zero without its last line, which on success is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Before it come the kernels line and the card's `nvidia-smi` name and power
limit.  It needs no JAX and exits non-zero where torch finds no CUDA card.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

# |y_kernel − y_plain| ≤ ATOL + RTOL·(|A|·|x|): the two sum the same float32
# products per row in another order.
RTOL, ATOL = 1e-5, 1e-6
# A merged SpGEMM value against the plain version's: the same float32
# products summed in another order, |dv| ≤ ATOL + RTOL·Σ|merged candidates|.
SPGEMM_RTOL, SPGEMM_ATOL = 1e-5, 1e-6
# the standalone W-cycle solve's cap: the cycles a 0.30 rate a cycle needs
# to reach 1e-6 (0.30**12 = 5.3e-7)
W_CYCLES = 12
# FGMRES(30)'s restart cycles on config #2 in 8 parts
FGMRES_RESTARTS = 2
# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the tensor
# cores (the kernels' products are float32 FMAs).
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12
SPGEMM_SOURCE = "parallel_amg_tpu_torch/csrc/spgemm.cu"
HALO_SOURCE = "parallel_amg_tpu_torch/csrc/halo_stencil.cu"
HALO_REPLACES = "parallel_amg_tpu/parallel/phalo_async.py:173"
ORDERED_SUM_SOURCE = "parallel_amg_tpu_torch/csrc/ordered_sum.cu"
ORDERED_SUM_REPLACES = ("none (jnp.sum's CPU order in "
                        "parallel_amg_tpu/parallel/prs_setup.py:525-549)")
KERNELS = {
    "twell_spmv": {"source": "parallel_amg_tpu_torch/csrc/twell_spmv.cu",
                   "replaces": "parallel_amg_tpu/ops/twell.py:234",
                   "design": "nnz-blocked CSR stream over a row-block plan"},
    "flatdia_spmv": {"source": "parallel_amg_tpu_torch/csrc/flatdia_spmv.cu",
                     "replaces": "parallel_amg_tpu/ops/flatdia.py:193"},
    "spgemm_expand": {"source": SPGEMM_SOURCE,
                      "replaces": "parallel_amg_tpu/ops/gspgemm.py:305",
                      "design": "row tiles staged in shared memory in slot "
                                "order, one contiguous run of 16-byte streaming "
                                "stores per tile and plane"},
    "spgemm_dedup": {"source": SPGEMM_SOURCE,
                     "replaces": "parallel_amg_tpu/ops/pspgemm.py:150",
                     "design": "B4's per-warp hash merge; keys only when counting"},
    "spgemm_dedup_compact": {"source": SPGEMM_SOURCE,
                             "replaces": "parallel_amg_tpu/ops/gspgemm.py:414"},
    "bsr_spmv": {"source": "parallel_amg_tpu_torch/csrc/bsr_spmv.cu",
                 "replaces": "parallel_amg_tpu/ops/btwell.py:288"},
    "flatdia_spmm": {"source": "parallel_amg_tpu_torch/csrc/flatdia_spmm.cu",
                     "replaces": "parallel_amg_tpu/ops/flatdia.py:212"},
    # B8: one launch for the parts on one card; the interior and boundary
    # pair of the several-card copy-stream path
    "halo_stencil_matvec": {"source": HALO_SOURCE, "replaces": HALO_REPLACES},
    "halo_stencil_interior": {"source": HALO_SOURCE, "replaces": HALO_REPLACES},
    "halo_stencil_boundary": {"source": HALO_SOURCE, "replaces": HALO_REPLACES},
    # kernel B9's product, routed to spgemm_expand + spgemm_dedup +
    # spgemm_dedup_compact
    "pallas_spgemm": {"source": SPGEMM_SOURCE,
                      "replaces": "parallel_amg_tpu/ops/pspgemm.py:72"},
    # not TPU kernels: float32 row sums in the order of jnp.sum on the JAX
    # package's CPU backend, for the RS setups' interpolation; the three
    # kernels of csrc/ordered_sum.cu, each counted on its own
    "ordered_sum_staged": {
        "source": ORDERED_SUM_SOURCE, "replaces": ORDERED_SUM_REPLACES,
        "design": "one thread per output row of up to 64 floats, staged in "
                  "shared memory, __fadd_rn left to right"},
    "ordered_sum_windows": {
        "source": ORDERED_SUM_SOURCE, "replaces": ORDERED_SUM_REPLACES,
        "design": "the whole tree of XLA's windows of a row in one block: a span "
                  "of 32-float windows staged in shared memory with coalesced "
                  "loads (skewed a float every 32), a thread a window, each "
                  "further level in shared memory, __fadd_rn; a one-axis row of "
                  "more than 32,768 floats first takes a warp per second-level "
                  "window (ordered_sum_windows_span): two launches"},
    "ordered_sum_lanes": {
        "source": ORDERED_SUM_SOURCE,
        "replaces": "none (jnp.sum's LLVM-vectorised CPU order in "
                    "parallel_amg_tpu/amg/device_rs.py:265-266, and the fused "
                    "multiply-add rows of its power iterations, :1002-1015)",
        "design": "LLVM's vectorised schedule (vf lanes × ic accumulators, "
                  "halving, epilogue) as template arguments, so the "
                  "accumulators stay in registers; rows of up to 32 staged in "
                  "shared memory, planes read coalesced; __fadd_rn or "
                  "__fmaf_rn"},
    # not a TPU kernel: the power iterations' stencil matvec D⁻¹·A·x in the
    # JAX package's CPU order, every part of a card in one launch, on B8's
    # part table (ops/ordered_stencil.py)
    "ordered_stencil_matvec": {
        "source": HALO_SOURCE,
        "replaces": "none (the JAX package's CPU order of its power iterations' "
                    "matvec, parallel_amg_tpu/amg/device_setup.py:51-65 and the "
                    "sharded xla matvec, parallel_amg_tpu/parallel/pstencil.py:157-221); "
                    "it replaces the ordered_sum_lanes and ordered_fma launches and "
                    "the stack copies of the port's earlier power iterations",
        "design": "a thread a group of 4 points of a part, every part of a card in one "
                  "launch (B8's HaloParts table, halos read in place): the fma chain "
                  "in the JAX package's plane order with the zero terms kept (the "
                  "centre rounded and added on the rows below LLVM's row bound), the "
                  "halo terms' fmas on the planes they reach, D^-1 in the epilogue"},
    # not a TPU kernel: the fused multiply-add XLA's CPU backend contracts in
    # the structured setups' smoothers (amg/device_setup.py)
    "ordered_fma": {
        "source": ORDERED_SUM_SOURCE,
        "replaces": "none (XLA's contracted 1 + m·w in "
                    "parallel_amg_tpu/amg/device_setup.py:68-84)",
        "design": "elementwise __fmaf_rn, a grid-stride loop; an operand "
                  "shorter than the result (a scalar, a grid under a box of "
                  "planes) repeats"},
    # not a TPU kernel: one stage of the bucketed Galerkin product in the JAX
    # package's CPU order (ops/bucket_stage.py), in one launch
    "ordered_bucket_stage": {
        "source": ORDERED_SUM_SOURCE,
        "replaces": "none (XLA's CPU order of the JAX package's bucketed stage, "
                    "parallel_amg_tpu/amg/device_setup.py:357-386); it replaces the "
                    "ordered_fma launches, shifted copies of X and masks of the port's "
                    "earlier stage",
        "design": "2.5-D blocking: a block of 8 x 32 threads owns a tile of (n1, n2) "
                  "points and marches along axis 0 over a chunk of planes; a ring of "
                  "the 2 r0 + 2 planes of every input box over the tile and its halo "
                  "and two planes of the factors in shared memory, the next plane "
                  "prefetched with cp.async while the current one is computed; the "
                  "term table and the block's source boxes in shared memory; a thread "
                  "a point and up to 27 output boxes, their sums in registers; per "
                  "term its kind (__fmul_rn, __fmaf_rn or __fadd_rn of __fmul_rn, "
                  "another from its tail column on), masked-off terms computed"},
}
# the __global__ functions of csrc/, as the profiler names them
PORT_KERNEL_NAMES = ("twell_stream_kernel", "flatdia_spmv_kernel",
                     "flatdia_spmm_kernel", "bsr_spmv_kernel", "expand_kernel",
                     "merge_kernel", "matvec_kernel", "boundary_kernel", "ordered_sum_staged",
                     "ordered_sum_windows", "ordered_sum_windows_span",
                     "ordered_sum_lanes", "ordered_fma_kernel", "ordered_kernel",
                     "ordered_bucket_stage_kernel")
LIBRARIES = ("twell_spmv", "flatdia_spmv", "spgemm", "bsr_spmv",
             "flatdia_spmm", "halo_stencil", "ordered_sum")  # csrc/<name>.cu
CONFIG3_ROWS = [2_097_152, 79_507, 3_375, 125]
# the JAX package's count on the CPU ("xla" backend) at 128³
# (scripts/config3_cpu_counts.py); its TPU run took 12 (bench_details.json:40)
CONFIG3_ITERS = 11
# The JAX package's device-RS numbers: config #2 at 1024² (BENCH_r04.json,
# stage amg_rs2d) and config #4 at 512² (BENCH_r05.json, stage anisotropic).
CONFIG2_JAX = {"grid_complexity": 1.455, "operator_complexity": 2.397,
               "pcg_iters": 7,
               "rows": [1_048_576, 382_317, 79_114, 13_827, 2_019, 294, 42]}
# The JAX package's device-RS setup of config #2 at 1024² on its CPU backend,
# the reference the port matches bit for bit (scripts/bisect_rs_vs_jax.py
# --mode device --jax-setup): level rows, and the complexities to the digits
# artifacts/distributed_rs_cpu8.json prints for its single-device run.
CONFIG2_JAX_CPU = {"rows": [1_048_576, 382_317, 79_114, 13_825, 2_025, 289, 43],
                   "complexity": (1.455, 2.397)}
# The JAX package's config #5 numbers: 128³×3 complexities with the BSR fine
# level (bench_details.json:251-254), its PCG count on the CPU
# (scripts/config3_cpu_counts.py 128 jax5: 11; its TPU run took 12) and the
# 324³×3 level rows (artifacts/probe_100m_bsr.log:28).
CONFIG5_JAX = {"complexity": (1.0396, 1.1459), "pcg_iters": 11}
CONFIG5_100M_ROWS = [102_036_672, 3_779_136, 139_968, 5_184, 192]
# 468³ in 8 parts: levels 0 and 1 sharded (d0p = 504), then the gathered
# tail (plan_sharded_levels; tests/test_pdevice_setup.py:156-160).
DIST_100M_ROWS = [102_503_232, 3_796_416, 140_608, 5_832, 216]
CONFIG4_JAX = {"rows": [262_144, 113_363, 49_202, 21_369, 9_301, 2_604, 590,
                        126],
               "grid_complexity": 1.75, "operator_complexity": 2.383,
               "pcg_iters": 7}
# Iterations to a true 1e-8 (amg_pcg_mp) and with a bfloat16 preconditioner
# in the JAX package's runs: config #2 (BENCH_r04.json, stage amg_rs2d, equal
# to the oracle), config #3 to 1e-8 and with bf16 to 1e-6
# (bench_details.json:43-44), config #4 (bench_details.json:266-268, equal to
# the oracle).
MP_ITERS = {"config2": 10, "config3": 16, "config4": 9}
BF16_ITERS_CONFIG3 = 13
# The JAX package's on-device algebraic SA at 2D Poisson 512² on the CPU,
# chip_smoke.py's configuration and b
# (JAX_PLATFORMS=cpu python3 tests/test_torch_device_sa.py 512).
DEVICE_SA_512_JAX = {"rows": [262_144, 36_783, 2_217, 154, 11], "pcg_iters": 14,
                     "oracle_greedy_iters": 8}


T0 = time.perf_counter()
T0_WALL = time.time()
# the CPU references that run in host processes while the card's phases go
# on: (future, hold) pairs that main() holds before the kernels line
CPU_CHECKS = []
_HOST_POOL = []


def emit(phase, **fields):
    """One JSON line, with the seconds since the script started (``t_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T0, 3)}), flush=True)


def on_host(fn, args, hold):
    """Run the CPU reference ``fn(*args)`` in a host process of its own,
    beside the card's phases (arrays cross as numpy, pickled through the
    pipe, not torch's shared memory); main() calls ``hold(result)`` before
    the kernels line, which raises on a mismatch.  Each reference took
    30–90 s of host time in the main process."""
    if not _HOST_POOL:
        import multiprocessing

        _HOST_POOL.append(concurrent.futures.ProcessPoolExecutor(
            max_workers=2, mp_context=multiprocessing.get_context("spawn")))
    CPU_CHECKS.append((fn.__name__, time.time(), _HOST_POOL[0].submit(_timed, fn, args),
                       hold))


def _timed(fn, args):
    """(wall-clock start, end, fn(*args)) in a host process."""
    t0 = time.time()
    out = fn(*args)
    return t0, time.time(), out


def hold_host_checks():
    """Hold every ``on_host`` reference, then stop the host processes.  A
    line ``host_reference`` for each says when it was submitted and when it
    ran (seconds since the script started): the card's phases in that window
    shared the host's cores with it."""
    for name, submitted, future, hold in CPU_CHECKS:
        t0, t1, out = future.result()
        emit("host_reference", name=name, submitted_s=round(submitted - T0_WALL, 3),
             start_s=round(t0 - T0_WALL, 3), end_s=round(t1 - T0_WALL, 3))
        hold(out)
    for pool in _HOST_POOL:
        pool.shutdown()


def _cpu_pcsr(n_shards, fields, row_partition, col_partition, true_shape):
    """A PCSR on a CPU mesh of ``n_shards`` parts from its numpy fields."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR

    return PCSR(mesh=ptt.make_row_mesh(n_shards, device="cpu"), row_partition=row_partition,
                col_partition=col_partition, true_shape=true_shape,
                **{f: [torch.from_numpy(a) for a in v] for f, v in fields.items()})


def pcsr_args(A):
    """``_cpu_pcsr``'s arguments for a PCSR A, its tensors as numpy arrays."""
    return (A.n_shards, {f: [t.cpu().numpy() for t in getattr(A, f)] for f in PCSR_FIELDS},
            A.row_partition, A.col_partition, A.true_shape)


def cpu_pcsr_lambdas(levels, iters):
    """(λ_max of each level's PCSR power iteration on the CPU, seconds):
    ``levels`` as (``pcsr_args``, D⁻¹'s parts as numpy)."""
    import torch

    from parallel_amg_tpu_torch.parallel import prs_setup as prs
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    lams = []
    for args, d_parts in levels:
        A = _cpu_pcsr(*args)
        d_inv = PGrid([torch.from_numpy(d) for d in d_parts], A.mesh)
        lams.append(float(prs._pcsr_lambda_max(A, d_inv, iters, 0)))
    return lams, time.perf_counter() - t0


def cpu_stencil_lambdas(levels, iters):
    """(λ_max of each level's one-device power iteration on the CPU, seconds):
    ``levels`` as (weights, offsets, dims, D⁻¹), arrays as numpy."""
    import torch

    from parallel_amg_tpu_torch.amg import device_setup
    from parallel_amg_tpu_torch.ops.stencil import Stencil

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    lams = [float(device_setup.power_iteration_lambda_max(
        Stencil(torch.from_numpy(w), offs, dims), torch.from_numpy(d), iters, seed=0))
        for w, offs, dims, d in levels]
    return lams, time.perf_counter() - t0


def cpu_level0_P(args, cfg):
    """(level 0's P of config #2's RS setup in parts on the CPU, its PCSR
    fields as numpy; seconds) from A_0's ``pcsr_args``."""
    import torch

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    P = level0_P(_cpu_pcsr(*args), cfg)
    return ({f: [t.numpy() for t in getattr(P, f)] for f in PCSR_FIELDS},
            time.perf_counter() - t0)


def level0_P(A, cfg):
    """Level 0's P of the RS setup in parts: strength, PMIS, extended+i."""
    from parallel_amg_tpu_torch.parallel import prs_setup as prs

    Sd, So = prs.pcsr_strength(A, cfg.theta)
    state = prs.pcsr_pmis(A, Sd, So, seed=0)
    cmap, mc_pad, _ = prs.coarse_numbering(A, state)
    return prs.pcsr_interpolation(A, Sd, So, state, cmap, mc_pad, cfg)


def cpu_structured_levels(dims, config):
    """(each level's weights and D⁻¹ as numpy and λ_max, the product paths,
    seconds) of the structured setup of poisson_stencil(dims) on the CPU."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson_stencil

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    h = ptt.setup(poisson_stencil(dims, device="cpu"), config, device="cpu")
    return ([(l.A.weights.numpy(), l.d_inv.numpy(), float(l.lam_max)) for l in h.levels],
            h.setup_stats["product_paths"], time.perf_counter() - t0)


HERE = os.path.dirname(os.path.abspath(__file__))
DOT_SHAPES_BY_SETUP = {}


@contextlib.contextmanager
def record_dot_shapes(label):
    """Keep the one-hot dot shapes (n_out, K, nc) that ``galerkin_block``
    meets in the setup run inside the block (``device_setup._dot_order``
    wrapped while it runs), print them and write every setup's to
    build/galerkin_dot_shapes.json (``scripts/probe_xla_galerkin_order.py
    --dot`` holds the port's dot order against XLA's at each)."""
    from parallel_amg_tpu_torch.amg import device_setup

    seen, inner = set(), device_setup._dot_order

    def recording(n_out, K, nc):
        seen.add((n_out, K, nc))
        return inner(n_out, K, nc)

    device_setup._dot_order = recording
    try:
        yield
    finally:
        device_setup._dot_order = inner
    DOT_SHAPES_BY_SETUP[label] = sorted(seen)
    emit("dot_shapes", setup=label, shapes=DOT_SHAPES_BY_SETUP[label])
    out = os.path.join(HERE, "build")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "galerkin_dot_shapes.json"), "w") as f:
        json.dump(DOT_SHAPES_BY_SETUP, f, indent=1)


def hold_jax_record(h, dims, key, label):
    """Config #3's levels of hierarchy ``h``, set up on the grid ``dims``,
    against the JAX package's CPU record (artifacts/config3_jax_levels.json,
    ``key`` "one_device" or "parts4", written by
    scripts/jax_config3_levels.py): each level's weights and D⁻¹ digests and
    λ's float32 bits.  Prints the match per level; a mismatch, or a grid
    other than the record's, raises."""
    from parallel_amg_tpu_torch.utils.metrics import compare_levels, level_digests

    with open(os.path.join(HERE, "artifacts", "config3_jax_levels.json")) as f:
        rec = json.load(f)
    if tuple(dims) != (rec["n"],) * 3:
        raise AssertionError(f"{label}: grid {tuple(dims)}, the JAX record's is "
                             f"{rec['n']}³")
    rows, same = compare_levels(rec[key]["levels"], level_digests(h))
    emit("config3_vs_jax_record", setup=label, record=key, equal=same, levels=rows,
         jax=rec["jax"], jaxlib=rec["jaxlib"], record_cpu=rec["cpu"])
    if not same:
        raise AssertionError(f"{label}: a level differs from the JAX package's "
                             f"record ({key}): {rows}")


POISSON2D_N = 1024  # the 2-D record's grid (artifacts/poisson2d_jax_levels.json)


def poisson2d_rhs(n):
    """b of the 2-D Poisson solve: ``np.random.default_rng(0).normal``,
    float32, on the n² grid (scripts/jax_poisson2d_levels.py's)."""
    import numpy as np

    return np.random.default_rng(0).normal(size=n * n).astype(np.float32).reshape(n, n)


def cpu_poisson2d(n, config):
    """(the levels' ``level_digests``, PCG iterations to 1e-6, setup seconds)
    of the 2-D Poisson n² structured setup and its solve on the CPU."""
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.problems import poisson_stencil
    from parallel_amg_tpu_torch.utils.metrics import level_digests

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    A = poisson_stencil((n, n), device="cpu")
    h = ptt.setup(A, config, device="cpu")
    secs = time.perf_counter() - t0
    res = ptt.amg_pcg(A, h, torch.from_numpy(poisson2d_rhs(n)), tol=1e-6)
    return level_digests(h), int(res.iters), secs


def hold_poisson2d_record(h, n, label):
    """The 2-D Poisson levels of hierarchy ``h`` on the n² grid against the
    JAX package's CPU record (artifacts/poisson2d_jax_levels.json, written by
    scripts/jax_poisson2d_levels.py), line ``poisson2d_vs_jax_record``;
    returns the record.  A mismatch, or a grid other than the record's,
    raises."""
    from parallel_amg_tpu_torch.utils.metrics import compare_levels, level_digests

    with open(os.path.join(HERE, "artifacts", "poisson2d_jax_levels.json")) as f:
        rec = json.load(f)
    if n != rec["n"]:
        raise AssertionError(f"{label}: grid {n}², the JAX record's is {rec['n']}²")
    rows, same = compare_levels(rec["levels"], level_digests(h))
    emit("poisson2d_vs_jax_record", setup=label, equal=same, levels=rows,
         jax=rec["jax"], jaxlib=rec["jaxlib"], record_cpu=rec["cpu"],
         jax_pcg_iterations=rec["pcg_iterations"])
    if not same:
        raise AssertionError(f"{label}: a level differs from the JAX package's record: "
                             f"{rows}")
    return rec


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, reps=10, samples=25, warmup=5):
    """Median device time of one fn() call in ms, over `samples` CUDA-event
    windows of `reps` back-to-back calls.  A sleep kernel queued ahead of
    each window keeps the stream busy while the host enqueues it, so the
    window holds device time only: ~1 ms, or twice the host time of the
    window's calls as the last warm-up call took it, up to ~10 ms."""
    import torch

    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
    # ~2e9 cycles a second on the H100
    sleep_cycles = int(min(max(2_000_000, 2 * reps * host_s * 2e9), 20_000_000))
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(fn, n=50):
    """Host ms to enqueue one fn() call, with no synchronize between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return t


def wall_ms(fn, n=20, warmup=3):
    """Host wall-clock ms of fn() ending in a synchronize, per call."""
    import torch

    times = []
    for i in range(warmup + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if i >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def bound_ms(n_bytes, flops):
    """Least time for the work: bytes over the HBM rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, flops / PEAK_F32_FLOP_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_ms(csr, x):
    """Time of one torch sparse CSR @ x call (cuSPARSE), the yardstick."""
    try:
        return device_ms(lambda: csr @ x), None
    except RuntimeError as e:  # the yardstick only; never on the path
        return None, f"{e}"[:200]


def profile_cycles(fn, n=5):
    """Device kernels, device ms and busy share per call of fn(), from
    torch.profiler over n calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.device_time_total for e in kernels) / n
    # B8's halo copies against its interior launches (the matvec kernel's
    # body): how much of the copies' device time ran while one ran
    copies = [e.time_range for e in kernels if "memcpy" in e.name.lower()]
    interior = [e.time_range for e in kernels if "matvec_kernel" in e.name]
    overlap = sum(max(0.0, min(c.end, k.end) - max(c.start, k.start))
                  for c in copies for k in interior)
    # each of the port's kernels' device time per call, by its CUDA name
    by_kernel = {}
    for e in kernels:
        for name in PORT_KERNEL_NAMES:
            if name in e.name:
                by_kernel[name] = by_kernel.get(name, 0.0) + e.device_time_total / 1e3 / n
    # a window in which the profiler recorded no kernel has no device numbers
    return {"kernels_per_call": len(kernels) / n,
            "port_kernel_device_ms_per_call": by_kernel,
            "device_ms_per_call": dev_us / 1e3 if kernels else None,
            "wall_ms_per_call_profiled": wall,
            "device_busy_share": (dev_us / 1e3) / wall if kernels and wall else None,
            "copies_per_call": len(copies) / n,
            "copy_us_per_call": sum(c.end - c.start for c in copies) / n,
            "copy_overlap_with_b8_interior_us_per_call": overlap / n}


# The JAX package's distributed setups in 8 shards on its CPU mesh, run by
# scripts/bench_distributed.py: config #2 with on_device_setup=True
# (artifacts/distributed_rs_cpu8.json, nx 1024; rerun on the package as it
# stands by scripts/bisect_rs_vs_jax.py --no-stages --jax-setup: the same
# rows, complexities 1.45563 / 2.39730 and PCG 7) and algebraic SA at 256²
# (`--sizes=256 --sa` on the package as it stands; the artifact's 9,248 /
# 563 / 29 predate its MIS weights becoming a permutation, and its PCG 12
# stays).  Level rows, complexities and PCG counts only.
DIST_RS_JAX8 = {"rows": [1_048_576, 382_317, 79_171, 13_883, 2_065, 287, 42],
                "complexity": (1.456, 2.397), "pcg_iters": 7}
DIST_SA256_JAX8 = {"rows": [65_536, 9_211, 568, 25], "pcg_iters": 12}
PCSR_FIELDS = ("diag_cols", "diag_vals", "off_cols", "off_vals", "send_idx",
               "recv_map")
# The multiprocess phase: ranks sharing the card, and their join timeout
MP_WORLD = 2
MP_TIMEOUT_S = 600


def profile_run(fn):
    """(fn(), device kernels, device ms, wall ms and busy share of one call,
    and the device ms of the port's kernels by CUDA name), from
    torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.device_time_total for e in kernels) / 1e3
    by_kernel = {}
    for e in kernels:
        for name in PORT_KERNEL_NAMES:
            if name in e.name:
                by_kernel[name] = by_kernel.get(name, 0.0) + e.device_time_total / 1e3
    return out, {"device_kernels": len(kernels), "device_ms": dev_ms if kernels else None,
                 "wall_ms_profiled": wall,
                 "device_busy_share": dev_ms / wall if kernels and wall else None,
                 "port_kernel_device_ms": by_kernel}


def part_digests(parts):
    """sha256 of each part's bytes, in part order."""
    import hashlib

    return [hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()).hexdigest()
            for t in parts]


def plane_digests(h):
    """Per PCSR level operator, the digest of each local part's planes and
    plans (``PCSR_FIELDS``), keyed "L<level>.<A|P|R>"."""
    import hashlib

    out = {}
    for i, l in enumerate(h.levels):
        for k in ("A", "P", "R"):
            T = getattr(l, k)
            if hasattr(T, "diag_cols"):
                out[f"L{i}.{k}"] = [
                    hashlib.sha256(b"".join(getattr(T, f)[j].cpu().numpy().tobytes()
                                            for f in PCSR_FIELDS)).hexdigest()
                    for j in range(len(T.diag_cols))]
    return out


def multiprocess_rank(cfg2, cfg3, cfg_sa):
    """One rank of the multiprocess phase, run by ``parallel/launch.py`` on
    the card with the gloo route: config #2 in 8 parts (the host oracle's
    setup and PCG, then the Ruge–Stüben setup on the card and PCG), config
    #3 in 4 parts ("pallas_async", kernel B8's exchange route) and SA at
    256² in 8 parts.  Each path runs with the launch counts set to 0 just
    before it and read just after.  Returns this rank's digests, counts,
    times and peak memory."""
    import numpy as np
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.ops import flatdia, ordered_sum, pspgemm, twell
    from parallel_amg_tpu_torch.parallel import exchange, phalo_async
    from parallel_amg_tpu_torch.parallel.mesh import process
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR
    from parallel_amg_tpu_torch.problems import poisson2d

    rank, world = process()

    def reset():
        twell.LAUNCHES = 0
        for d in (flatdia.LAUNCHES, pspgemm.LAUNCHES, phalo_async.LAUNCHES,
                  ordered_sum.LAUNCHES):
            for k in d:
                d[k] = 0

    def counts():
        torch.cuda.synchronize()
        return {"twell_spmv": twell.LAUNCHES,
                "flatdia_spmv": flatdia.LAUNCHES["flatdia_spmv"],
                **pspgemm.LAUNCHES, **phalo_async.LAUNCHES, **ordered_sum.LAUNCHES}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def cycle_times(fn, n=10):
        """Per call: wall ms, this rank's CUDA-event window ms, and the
        exchange's host ms (``exchange.STATS``), medians over n calls."""
        fn()
        wall, event, exch = [], [], []
        for _ in range(n):
            exchange.STATS.update(calls=0, seconds=0.0)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            end.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            event.append(start.elapsed_time(end))
            exch.append(exchange.STATS["seconds"] * 1e3)
        return {"wall_ms": statistics.median(wall), "event_ms": statistics.median(event),
                "exchange_ms": statistics.median(exch),
                "exchange_calls": exchange.STATS["calls"]}

    out = {"rank": rank, "world": world,
           "device": str(torch.cuda.current_device())}
    torch.cuda.reset_peak_memory_stats()

    # config #2 in 8 parts: the host oracle, then PCG to 1e-6
    mesh8 = ptt.make_row_mesh(8)
    out["local_parts"] = list(mesh8.local)
    A_csr = poisson2d(1024).to_csr()
    A_sp = A_csr.to_scipy()
    b_np = np.random.default_rng(0).normal(size=A_csr.n_rows).astype(np.float32)
    hd, s = timed(lambda: ptt.distributed_setup(A_sp, cfg2, mesh8))
    b = ptt.pvector(b_np, hd.levels[0].A.row_partition, mesh8)
    reset()
    r, solve_s = timed(lambda: ptt.amg_pcg(None, hd, b, tol=1e-6, maxiter=100))
    out["host"] = dict(setup_s=s, solve_s=solve_s, iters=r.iters,
                       converged=r.converged, x=part_digests(r.x.parts),
                       launches=counts(), rows=[l.n for l in hd.levels],
                       vcycle=cycle_times(lambda: ptt.vcycle(hd, b.zeros_like(), b)),
                       matvec=cycle_times(lambda: hd.levels[0].A.matvec(b), n=20))
    del hd, r

    # config #2 in 8 parts: the Ruge–Stüben setup on the card, then PCG
    Ap = PCSR.from_csr(A_csr, mesh8)
    reset()
    h1, s = timed(lambda: ptt.distributed_setup(
        Ap, dataclasses.replace(cfg2, on_device_setup=True), mesh8))
    setup_counts = counts()
    b = ptt.pvector(b_np, h1.levels[0].A.row_partition, mesh8)
    reset()
    r, solve_s = timed(lambda: ptt.amg_pcg(None, h1, b, tol=1e-6, maxiter=100))
    out["rs"] = dict(setup_s=s, solve_s=solve_s, iters=r.iters, converged=r.converged,
                     levels=plane_digests(h1), rows=[l.n for l in h1.levels],
                     setup_launches=setup_counts, pcg_launches=counts(),
                     vcycle=cycle_times(lambda: ptt.vcycle(h1, b.zeros_like(), b)))
    del h1, r, Ap

    # config #3 in 4 parts, "pallas_async"
    mesh4 = ptt.make_row_mesh(4)
    dims3 = (128,) * 3
    b3_np = np.random.default_rng(0).normal(size=128 ** 3).astype(np.float32)

    def setup3():
        A_d, td = ptt.poisson_stencil_sharded(dims3, mesh4, cfg3)
        return ptt.sharded_device_setup(A_d, cfg3, true_dims=td)

    h3, s = timed(setup3)
    b3 = ptt.distribute_grid(b3_np, dims3, h3, mesh4)
    # kernel B8's launches for one level-0 matvec on this rank's route
    h3.levels[0].A.matvec(b3)
    reset()
    h3.levels[0].A.matvec(b3)
    b8_per_matvec = {k: v for k, v in counts().items() if k in phalo_async.LAUNCHES}
    reset()
    r, solve_s = timed(lambda: ptt.amg_pcg(None, h3, b3, tol=1e-6, maxiter=100))
    out["config3"] = dict(
        setup_s=s, solve_s=solve_s, iters=r.iters, converged=r.converged,
        history=r.residual_history[:r.iters + 1].cpu().tolist(), launches=counts(),
        b8_per_matvec=b8_per_matvec,
        rows=[l.n for l in h3.levels], local_parts=list(mesh4.local),
        vcycle=cycle_times(lambda: ptt.vcycle(h3, b3.zeros_like(), b3)),
        matvec=cycle_times(lambda: h3.levels[0].A.matvec(b3), n=20))
    del h3, r, b3

    # SA at 256² in 8 parts
    A_h = poisson2d(256).to_csr()
    bs_np = np.random.default_rng(0).normal(size=A_h.n_rows)
    reset()
    hs, s = timed(lambda: ptt.distributed_setup(A_h, cfg_sa, mesh8))
    setup_counts = counts()
    bs = ptt.pvector(bs_np, hs.levels[0].A.row_partition, mesh8)
    reset()
    r, solve_s = timed(lambda: ptt.amg_pcg(None, hs, bs, tol=1e-6, maxiter=60))
    out["sa256"] = dict(setup_s=s, solve_s=solve_s, iters=r.iters, converged=r.converged,
                        rows=[l.n for l in hs.levels], setup_launches=setup_counts,
                        pcg_launches=counts())
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["peak_reserved_gb"] = torch.cuda.max_memory_reserved() / 1e9
    return out


def pcsr_equal(X, Y, fields=PCSR_FIELDS):
    import torch

    return all(len(getattr(X, f)) == len(getattr(Y, f)) and all(
        a.shape == b.shape and torch.equal(a, b)
        for a, b in zip(getattr(X, f), getattr(Y, f))) for f in fields)


def hierarchies_equal(h1, h2):
    """Bit-equality of two PCSR hierarchies: every level's planes, plans,
    d⁻¹ and λ, and the coarse inverse."""
    import torch

    if h1.n_levels != h2.n_levels:
        return False
    for a, b in zip(h1.levels, h2.levels):
        if a.lam_max != b.lam_max or not torch.equal(
                a.d_inv.to_global().view(torch.int32), b.d_inv.to_global().view(torch.int32)):
            return False
        for name in ("A", "P", "R"):
            X, Y = getattr(a, name), getattr(b, name)
            if (X is None) != (Y is None) or (X is not None and not pcsr_equal(X, Y)):
                return False
    return torch.equal(h1.coarse_inv, h2.coarse_inv)


def bits_equal(a, b):
    """Same shape and the same bits (floats compared as int32)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a.cpu(), b.cpu())


ORDERED_SUM_KERNELS = ("ordered_sum_staged", "ordered_sum_windows",
                       "ordered_sum_lanes")


ORDERED_PLAIN = {"row_sum": "row_sum_plain", "row_dot": "row_dot_plain",
                 "planes_dot": "planes_dot_plain"}


def capture_row_sums(fn):
    """fn() with every ordered sum wrapped: the RS setups' ``row_sum``
    (parallel/prs_setup.py and amg/device_rs.py) and the power iterations'
    ``row_sum``, ``row_dot`` and ``planes_dot`` (ops/ordered_sum.py, which
    ``norm`` and ``sumsq`` call).  Of the inputs of each distinct (function,
    reduced shape, dims or lanes) it keeps a copy of the one with the most
    elements.  Returns (fn's result, the list of kept (function, args))."""
    import torch

    from parallel_amg_tpu_torch.amg import device_rs
    from parallel_amg_tpu_torch.ops import ordered_sum
    from parallel_amg_tpu_torch.parallel import prs_setup

    kept = {}
    orig = {name: getattr(ordered_sum, name) for name in ORDERED_PLAIN}

    def keep(name, key, args):
        size = args[0].numel()
        if key not in kept or size > kept[key][2]:
            kept[key] = (name, tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args), size)

    def row_sum(x, dims=1, lanes=None):
        keep("row_sum", ("row_sum", tuple(x.shape[x.dim() - dims:]), dims, lanes),
             (x, dims, lanes))
        return orig["row_sum"](x, dims, lanes)

    def row_dot(a, b, lanes=None):
        if lanes is not None:  # without lanes: row_sum of the products
            keep("row_dot", ("row_dot", a.shape[-1], tuple(lanes)), (a, b, lanes))
        return orig["row_dot"](a, b, lanes)

    def planes_dot(a, b):
        keep("planes_dot", ("planes_dot", a.shape[0]), (a, b))
        return orig["planes_dot"](a, b)

    wrapped = {"row_sum": row_sum, "row_dot": row_dot, "planes_dot": planes_dot}
    setups = (prs_setup, device_rs)
    for name, f in wrapped.items():
        setattr(ordered_sum, name, f)
    for m in setups:
        m.row_sum = row_sum
    try:
        out = fn()
    finally:
        for name, f in orig.items():
            setattr(ordered_sum, name, f)
        for m in setups:
            m.row_sum = orig["row_sum"]
    return out, [(name, args) for name, args, _ in kept.values()]


def _describe(name, args):
    x = args[0]
    if name == "row_sum":
        return {"fn": name, "shape": list(x.shape), "dims": args[1], "lanes": args[2]}
    if name == "row_dot":
        return {"fn": name, "shape": list(x.shape), "lanes": list(args[2])}
    return {"fn": name, "shape": list(x.shape)}


def ordered_sum_check(c, captured, label):
    """Each captured ordered-sum input through the kernels
    (csrc/ordered_sum.cu) and the plain version on the card, bit for bit.
    Returns the inputs by the kernel that reads them first ({kernel:
    [(function, args), ...]}) and whether all were equal."""
    from parallel_amg_tpu_torch.ops import ordered_sum

    by_kernel = {k: [] for k in ORDERED_SUM_KERNELS}
    equal, shapes = True, []
    for name, args in captured:
        before = dict(ordered_sum.LAUNCHES)
        got = getattr(ordered_sum, name)(*args)
        ran = [k for k in ORDERED_SUM_KERNELS if ordered_sum.LAUNCHES[k] > before[k]]
        ok = bits_equal(got, getattr(ordered_sum, ORDERED_PLAIN[name])(*args))
        equal &= ok
        first = next((k for k in ("ordered_sum_lanes", "ordered_sum_windows")
                      if k in ran), "ordered_sum_staged")
        by_kernel[first].append((name, args))
        shapes.append({**_describe(name, args), "kernels": ran, "bit_equal": ok})
    c.emit("ordered_sum_inputs", path=label, inputs=len(captured), shapes=shapes,
           inputs_by_kernel={k: len(v) for k, v in by_kernel.items()},
           kernel_bit_equal_plain=equal)
    return by_kernel, equal


def time_ordered_sum(c, kernel, name, args, main_case, key=None):
    """The ordered sum ``name`` on args against its plain version and one
    torch call (``torch.sum``, or ``linalg.vecdot`` for a product; another
    order, a time only), into c.results[kernel]; with ``key`` as that
    kernel's extra case ms_<key>, bound_ms_<key>, ...  An add is one float32
    operation, a fused multiply-add two."""
    import torch

    from parallel_amg_tpu_torch.ops import ordered_sum

    x = args[0]
    if name == "row_sum":
        dims = args[1]
        red = tuple(range(x.dim() - dims, x.dim()))
        n_out, flops = x.shape[: x.dim() - dims].numel(), x.numel()
        library = lambda: x.sum(red)  # noqa: E731
    else:
        n_out, flops = x.numel() // x.shape[-1 if name == "row_dot" else 0], 2 * x.numel()
        library = (lambda: torch.linalg.vecdot(x, args[1])) if name == "row_dot" else (
            lambda: torch.linalg.vecdot(x, args[1], dim=0))
    n_bytes = 4 * (sum(a.numel() for a in args if torch.is_tensor(a)) + n_out)
    b_ms, b_by = c.bound_ms(n_bytes, flops)
    fn, plain = getattr(ordered_sum, name), getattr(ordered_sum, ORDERED_PLAIN[name])
    ms = c.device_ms(lambda: fn(*args))
    plain_ms = c.device_ms(lambda: plain(*args), reps=1, samples=3, warmup=1)
    lib_ms = c.device_ms(library)
    r = c.results.setdefault(kernel, {"max_abs_err": 0.0})
    if key is None:
        r.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, copy_bound_ms=c.copy_bound_ms(n_bytes),
                 main_case=main_case)
    else:
        r.update({f"ms_{key}": ms, f"plain_ms_{key}": plain_ms,
                  f"library_ms_{key}": lib_ms, f"bound_ms_{key}": b_ms,
                  f"case_{key}": main_case})
    c.emit("kernel", name=kernel, case=main_case, ms=ms, plain_ms=plain_ms,
           library_ms_torch=lib_ms, bound_ms=b_ms, bound_by=b_by,
           share_of_bound=b_ms / ms, bytes=n_bytes)


def lambda_cpu_check(c, label, lams_card, lam_cpu_fns):
    """Each level's λ_max from the card against the same power iteration on
    the CPU (the same operator copied over, the kernels' plain versions),
    bit for bit.  Returns whether all were equal."""
    t0 = time.perf_counter()
    lams_cpu = [float(f()) for f in lam_cpu_fns]
    return lambda_vs_cpu(c, label, lams_card, lams_cpu, time.perf_counter() - t0)


def lambda_vs_cpu(c, label, lams_card, lams_cpu, cpu_seconds):
    """``lambda_cpu_check``'s comparison and line, for λs already taken."""
    import torch

    equal = [torch.tensor(a, dtype=torch.float32).item() == b
             for a, b in zip(lams_card, lams_cpu)]
    c.emit("lambda_max_vs_cpu", path=label, lam_card=lams_card, lam_cpu=lams_cpu,
           bit_equal=equal, cpu_seconds=cpu_seconds)
    return all(equal) and len(lams_card) == len(lams_cpu)


@contextlib.contextmanager
def power_launches(counts):
    """Count the ordered-sum launches of the sharded power iterations
    (``pdevice_setup._sharded_power``) run inside the block apart from the
    rest: ``counts`` gets "sharded_power" (per kernel) and "calls"."""
    from parallel_amg_tpu_torch.ops import ordered_sum
    from parallel_amg_tpu_torch.parallel import pdevice_setup

    inner = pdevice_setup._sharded_power
    counts.update(calls=0, sharded_power={k: 0 for k in ordered_sum.LAUNCHES})

    def counting(*args, **kw):
        before = dict(ordered_sum.LAUNCHES)
        lam = inner(*args, **kw)
        counts["calls"] += 1
        for k, v in ordered_sum.LAUNCHES.items():
            counts["sharded_power"][k] += v - before[k]
        return lam

    pdevice_setup._sharded_power = counting
    try:
        yield counts
    finally:
        pdevice_setup._sharded_power = inner


def scaled_stencil_csr(W, offsets, dims, row_scale):
    """diag(row_scale)·A of the stencil (W, offsets, dims) as one sparse CSR
    on W's card (int32 indices): each row's nonzero couplings inside the
    grid, columns ascending.  Built straight from the planes (no sort), so
    it fits beside 468³'s hierarchy."""
    import math

    import torch

    dev, n = W.device, math.prod(dims)
    strides = [math.prod(dims[a + 1:]) for a in range(len(dims))]
    flat = [sum(o * st for o, st in zip(off, strides)) for off in offsets]
    rows = torch.arange(n, dtype=torch.int32, device=dev)
    vals, cols, keep = [], [], []
    for d in sorted(range(len(offsets)), key=flat.__getitem__):
        inside = torch.ones(dims, dtype=torch.bool, device=dev)
        for a, o in enumerate(offsets[d]):  # the neighbour lies off the grid
            edge = [slice(None)] * len(dims)
            edge[a] = slice(0, -o) if o < 0 else slice(dims[a] - o, dims[a])
            if o:
                inside[tuple(edge)] = False
        v = (row_scale * W[d]).reshape(-1)
        keep.append(inside.reshape(-1) & (v != 0))
        vals.append(v)
        cols.append(rows + flat[d])
    keep, vals, cols = (torch.stack(t, 1) for t in (keep, vals, cols))
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = keep.sum(1, dtype=torch.int32).cumsum(0, dtype=torch.int32)
    return torch.sparse_csr_tensor(crow, cols[keep], vals[keep], (n, n))


def ordered_stencil_case(c, label, A, d_inv, gen, main=False, want_rows=None,
                         want_swap=None):
    """``ordered_stencil_matvec`` on the power iterations' matvec of A (a
    Stencil with its D⁻¹, or a ShardedStencil with its D⁻¹ PGrid) at a
    random x, against its plain version and against the ordered-sum
    launches the power iterations took before it (``matvec_plain`` with
    ``launch``), bit for bit: one launch a card; the kernel's and that
    sequence's device ms in turns, the plain version's, the bound, and one
    cuSPARSE CSR product by the rows of D⁻¹A (``library_ms``: the same
    function, its products in another order).  ``want_rows``: the rows of
    the centre unfused that the plan must carry; ``want_swap``: the first
    column whose chain starts the other way round (a 2-D plan)."""
    import torch

    from parallel_amg_tpu_torch.amg import device_setup
    from parallel_amg_tpu_torch.ops import ordered_stencil, ordered_sum
    from parallel_amg_tpu_torch.parallel import exchange, pdevice_setup

    sharded = hasattr(A, "mesh")
    if sharded:
        plan = pdevice_setup.power_plan(A, d_inv)
        weights = A.weights
    else:
        plan = device_setup.power_plan(A, d_inv)
        weights = plan.weights  # a 2-D grid's on its (1, n0, n1) view
    xs = [torch.rand(W.shape[1:], generator=gen, device=W.device) - 0.5 for W in weights]
    halos = (exchange.halos(xs, plan.h, 0) if plan.h else [(None, None)] * len(xs))
    before = ordered_sum.LAUNCHES["ordered_stencil_matvec"]
    got = ordered_stencil.matvec(plan, xs, halos)
    launched = ordered_sum.LAUNCHES["ordered_stencil_matvec"] - before
    n_cards = len({W.device for W in weights})
    plain = ordered_stencil.matvec_plain(plan, xs, halos)
    seq = ordered_stencil.matvec_plain(plan, xs, halos, launch=True)
    equal_plain = all(bits_equal(g, p) for g, p in zip(got, plain))
    equal_seq = all(bits_equal(g, s) for g, s in zip(got, seq))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    del plain, seq
    K = len(A.offsets)
    n = sum(W[0].numel() for W in weights)
    # W, x, D⁻¹ read once and y written once; K fma and one multiply a point
    n_bytes = 4 * n * (K + 3)
    b_ms, b_by = c.bound_ms(n_bytes, 2 * K * n + n)
    kernel_ms, seq_ms = [], []
    for _ in range(2):  # in turns: kernel, earlier sequence, kernel, sequence
        kernel_ms.append(c.device_ms(lambda: ordered_stencil.matvec(plan, xs, halos),
                                     reps=3, samples=9))
        seq_ms.append(c.device_ms(lambda: ordered_stencil.matvec_plain(
            plan, xs, halos, launch=True), reps=1, samples=5, warmup=2))
    plain_ms = c.device_ms(lambda: ordered_stencil.matvec_plain(plan, xs, halos), reps=1,
                           samples=3, warmup=1)
    if n_cards == 1:  # the yardstick: one torch.sparse CSR product of D⁻¹A
        csr = scaled_stencil_csr(*((A.global_weights(), A.offsets, A.dims, torch.cat(
            d_inv.parts)) if sharded else (A.weights, A.offsets, A.dims, d_inv)))
        lib_ms, lib_err = c.library_ms(csr, torch.cat(xs).reshape(-1))
        del csr
    else:
        lib_ms, lib_err = None, "parts on more than one card"
    ms = statistics.median(kernel_ms)
    fields = dict(points=K, parts=len(weights), slab=list(plan.slab), split=plan.split,
                  unfused_rows=plan.rows, swap_from=plan.swap_from,
                  halo_terms=len(plan.corr), launches=launched,
                  cards=n_cards,
                  bit_equal_plain=equal_plain, bit_equal_earlier_sequence=equal_seq,
                  ms=ms, ms_in_turns=kernel_ms, earlier_sequence_ms=seq_ms, plain_ms=plain_ms,
                  library_ms=lib_ms, library_error=lib_err,
                  bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
                  copy_bound_ms=c.copy_bound_ms(n_bytes))
    c.emit("kernel", name="ordered_stencil_matvec", case=label, **fields)
    if not (equal_plain and equal_seq and finite and launched == n_cards
            and (want_rows is None or plan.rows == want_rows)
            and (want_swap is None or plan.swap_from == want_swap)):
        raise AssertionError(f"ordered_stencil_matvec {label}: bit-equal to plain "
                             f"{equal_plain}, to the earlier sequence {equal_seq}, finite "
                             f"{finite}, {launched} launches for {n_cards} card(s), "
                             f"unfused rows {plan.rows} (want {want_rows}), swapped from "
                             f"column {plan.swap_from} (want {want_swap})")
    r = c.results["ordered_stencil_matvec"]
    r.setdefault("cases", {})[label] = {k: fields[k] for k in (
        "ms", "earlier_sequence_ms", "plain_ms", "library_ms", "bound_ms", "launches")}
    if main:
        r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                 copy_bound_ms=c.copy_bound_ms(n_bytes), main_case=label,
                 earlier_sequence_ms=seq_ms, share_of_bound=b_ms / ms,
                 library_kind="cuSPARSE CSR of D⁻¹A (one torch sparse CSR @ x; the "
                              "rows' products in another order than the JAX "
                              "package's, D⁻¹ applied before the sum)")
    del got


def hold_p468_record(c, h468, mesh):
    """468³ in 8 parts against the JAX package's CPU record of its power
    iterations (artifacts/p468_jax_power.json, scripts/jax_p468_power.py):
    level 0's λ of the setup ``h468``, and the port's ``_sharded_power`` on
    the record's seeded operator of level 1's shape, rebuilt with numpy (its
    weights' digest and λ's float32 bits).  Prints ``p468_vs_jax_record``;
    a mismatch raises."""
    import torch

    from parallel_amg_tpu_torch.parallel import pdevice_setup as pd
    from parallel_amg_tpu_torch.parallel.pstencil import ShardedStencil
    from parallel_amg_tpu_torch.problems import seeded_stencil
    from parallel_amg_tpu_torch.utils.metrics import array_digest, f32_bits

    with open(os.path.join(HERE, "artifacts", "p468_jax_power.json")) as f:
        rec = json.load(f)
    l0, l1 = rec["level0"], rec["level1"]
    A0 = h468.levels[0].A
    got0 = f32_bits(h468.levels[0].lam_max)
    t0 = time.perf_counter()
    w, offs = seeded_stencil(l1["padded_dims"], l1["points"], l1["weights_seed"])
    digest = array_digest(w)
    A1 = ShardedStencil.from_global(torch.from_numpy(w), offs, l1["padded_dims"], mesh)
    del w
    lam1 = pd._sharded_power(A1, pd._sharded_dinv(A1), rec["iters"], rec["power_seed"])
    got1 = f32_bits(float(lam1))
    levels = [{"level": 0, "dims": list(A0.dims), "lam_max": h468.levels[0].lam_max,
               "lam_max_bits": got0, "record_bits": l0["lam_max_bits"],
               "equal": got0 == l0["lam_max_bits"] and list(A0.dims) == l0["padded_dims"]},
              {"level": 1, "dims": list(A1.dims), "operator": l1["operator"],
               "weights_equal": digest == l1["weights_digest"], "lam_max": float(lam1),
               "lam_max_bits": got1, "record_bits": l1["lam_max_bits"],
               "equal": got1 == l1["lam_max_bits"] and digest == l1["weights_digest"]}]
    c.emit("p468_vs_jax_record", equal=all(lv["equal"] for lv in levels), levels=levels,
           jax=rec["jax"], jaxlib=rec["jaxlib"], record_cpu=rec["cpu"],
           level1_seconds=time.perf_counter() - t0)
    if not all(lv["equal"] for lv in levels):
        raise AssertionError(f"468³: a level differs from the JAX package's record: {levels}")


def ordered_sum_phase(c, A0, cfg, mesh):
    """csrc/ordered_sum.cu on config #2 in 8 parts: a whole setup on the
    card with one input of each row-sum shape captured, every level; each
    held bit-equal to the plain version on the card; the widest staged and
    the widest windowed input timed against their plain version and
    torch.sum; and level 0's P on the card (strength, PMIS and extended+i)
    held bit-equal to the CPU's from the same A_0 (kernels' plain versions
    there, in a host process beside the card's next phases: line
    ``ordered_sum_level0_P_vs_cpu``)."""
    import torch

    import parallel_amg_tpu_torch as ptt

    _, captured = capture_row_sums(lambda: ptt.distributed_setup(A0, cfg, mesh))
    c.sync()
    by_kernel, kernel_equal = ordered_sum_check(c, captured, "dist_config2_8parts_rs_setup")
    P_card = level0_P(A0, cfg)
    c.sync()
    P_card = {f: [t.cpu() for t in getattr(P_card, f)] for f in PCSR_FIELDS}

    def hold_P(result):
        P_cpu, cpu_s = result
        p_equal = all(len(P_card[f]) == len(P_cpu[f]) and all(
            bits_equal(a, torch.from_numpy(b)) for a, b in zip(P_card[f], P_cpu[f]))
            for f in PCSR_FIELDS)
        c.emit("ordered_sum_level0_P_vs_cpu", path="dist_config2_8parts_rs_setup",
               bit_equal=p_equal, cpu_seconds=cpu_s)
        if not p_equal:
            raise AssertionError("ordered_sum: the card's level-0 P differs from the CPU's")

    on_host(cpu_level0_P, (pcsr_args(A0), cfg), hold_P)
    staged = [t for t in by_kernel["ordered_sum_staged"] if t[0] == "row_sum"]
    windowed = [t for t in by_kernel["ordered_sum_windows"]
                if t[0] == "row_sum" and t[1][0].dim() > t[1][1]]
    if staged and windowed:
        name, args = max(staged, key=lambda t: t[1][0].numel())
        time_ordered_sum(c, "ordered_sum_staged", name, args,
                         f"config #2 1024² in 8 parts, the largest row-sum input "
                         f"of at most 64 floats a row, {list(args[0].shape)} over "
                         f"{args[1]} axes")
        # the widest row of the setup's rows (a norm's vector is one row)
        name, args = max(windowed, key=lambda t: (
            t[1][0].shape[t[1][0].dim() - t[1][1]:].numel(), t[1][0].numel()))
        time_ordered_sum(c, "ordered_sum_windows", name, args,
                         f"config #2 1024² in 8 parts, the widest windowed row-sum "
                         f"input {list(args[0].shape)} over {args[1]} axes (the "
                         f"whole tree of windows in one launch)")
    c.emit("ordered_sum", path="dist_config2_8parts_rs_setup",
           kernel_bit_equal_plain=kernel_equal,
           inputs_by_kernel={k: len(v) for k, v in by_kernel.items()})
    if not (kernel_equal and staged and windowed):
        raise AssertionError(
            f"ordered_sum: kernels bit-equal to their plain version {kernel_equal}; "
            f"staged and windowed inputs {len(staged)}, {len(windowed)}")
    del captured, by_kernel, staged, windowed


def galerkin_order_phase(c, h3):
    """The structured setups' Galerkin products on the card against the
    port's own CPU run of the same function on the same inputs, bit for bit:
    the dense, bucketed and slab (at least 2 slabs) products on random 3-D
    stencils, the whole sharded setup in 4 parts, and config #3 at 128³ (the
    card's setup ``h3`` against a CPU run of the same setup in a host
    process, timed; line ``galerkin_order_config3_vs_cpu``) level by level
    (weights, D⁻¹, λ), and ``h3`` against the JAX package's record of the
    same levels (``hold_jax_record``).
    Times the ordered_fma kernel at config #3's level-1 smoother and checks
    the device coarse inverse (A8) against the float64 host form."""
    import numpy as np
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.amg import device_setup as ds
    from parallel_amg_tpu_torch.amg.hierarchy import coarse_inverse, coarse_inverse_np
    from parallel_amg_tpu_torch.amg.transfers import downsample_sum_nd
    from parallel_amg_tpu_torch.ops import ordered_sum
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.problems import poisson_stencil

    dev = torch.device("cuda", 0)
    gen = np.random.default_rng(16)
    checks = {}
    # config #3 at its own size: the card's setup against a CPU run of the
    # same setup, level by level, in a host process beside the card's phases
    dims3 = h3.levels[0].A.dims
    size3 = "x".join(map(str, dims3))
    card3 = [(l.A.weights.cpu(), l.d_inv.cpu(), float(l.lam_max)) for l in h3.levels]

    def hold_levels(result):
        cpu3, paths, cpu_s = result
        levels_equal = [bits_equal(a[0], torch.from_numpy(b[0]))
                        and bits_equal(a[1], torch.from_numpy(b[1])) and a[2] == b[2]
                        for a, b in zip(card3, cpu3)]
        ok = len(card3) == len(cpu3) and all(levels_equal)
        c.emit("galerkin_order_config3_vs_cpu", config3_size=size3,
               config3_rows=[l.A.n_rows for l in h3.levels], config3_paths=paths,
               config3_levels_equal=levels_equal, bit_equal=ok, config3_cpu_setup_s=cpu_s)
        if not ok:
            raise AssertionError(f"config #3 at {size3}: a level differs between card "
                                 f"and CPU: {levels_equal}")

    on_host(cpu_structured_levels, (dims3, h3.config), hold_levels)

    def random_level(dims, kind):
        st = poisson_stencil(dims, device="cpu")
        if kind == 27:
            offs = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
                         for c in (-1, 0, 1))
            w = -gen.uniform(0.5, 1.5, size=(27,) + dims)
            w[13] = 30.0
            st = Stencil(torch.from_numpy(w.astype(np.float32)), offs, dims)
        w = st.weights.numpy() * gen.uniform(0.7, 1.3, size=st.weights.shape)
        return Stencil(torch.from_numpy(w.astype(np.float32)), st.offsets, dims)

    def both(fn, A, *extra):
        """fn on the card and on the CPU from the same inputs."""
        b = 3
        cdims = tuple(-(-n // b) for n in A.dims)
        d_inv = ds.diag_inverse(A)
        scale = ds.block_scale(downsample_sum_nd(torch.ones(A.dims), cdims, b))
        coef = torch.tensor(0.55, dtype=torch.float32)
        args = (d_inv, coef, cdims, b, scale)
        cpu = fn(A, *args, *extra)
        card = fn(A.to(dev), *(x.to(dev) if torch.is_tensor(x) else x
                                 for x in args), *extra)
        torch.cuda.synchronize()
        return card, cpu

    cfg_dense = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                              setup_product_path="dense")
    dense = lambda A, d, c, cd, b, s: ds.coarse_operator(A, d, c, cd, cfg_dense, s)  # noqa: E731
    budget = 30 * 28 * 28 * 4 * 63
    slab = lambda A, d, c, cd, b, s: ds.chunked_coarse_operator(  # noqa: E731
        A, d, c, cd, b, s, 5e-3, budget)
    cases = {"dense_7pt_30^3": (dense, random_level((30, 29, 28), 7)),
             "dense_27pt_21^3": (dense, random_level((21, 21, 20), 27)),
             "bucketed_7pt_48^3": (ds.bucketed_coarse_operator,
                                   random_level((48, 47, 46), 7)),
             "slab_7pt_60x28x28": (slab, random_level((60, 28, 28), 7))}
    n_slabs = ds.slab_plan(cases["slab_7pt_60x28x28"][1].offsets, (60, 28, 28),
                           (20, 10, 10), 3, budget)["n_slabs"]
    t0 = time.perf_counter()
    for name, (fn, A) in cases.items():
        card, cpu = both(fn, A)
        checks[name] = card.offsets == cpu.offsets and bits_equal(card.weights, cpu.weights)
    # the whole sharded setup in 4 parts (one card), every level
    cfg_s = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                          smoother="chebyshev", n_coarse_max=64, agglomerate_n=256,
                          on_device_setup=True, halo_mode="pallas_async")
    hs = {}
    for where in ("cuda", "cpu"):
        mesh = ptt.make_row_mesh(4, device=None if where == "cuda" else "cpu")
        A_s, td = ptt.poisson_stencil_sharded((36, 24, 20), mesh, cfg_s)
        hs[where] = ptt.sharded_device_setup(A_s, cfg_s, true_dims=td)
    sharded_equal = []
    for lc, lp in zip(hs["cuda"].levels, hs["cpu"].levels):
        wc, wp = (l.A.global_weights() if hasattr(l.A, "global_weights")
                  else l.A.weights for l in (lc, lp))
        sharded_equal.append(bits_equal(wc, wp) and lc.lam_max == lp.lam_max)
    checks["sharded_4parts_36x24x20"] = (
        len(hs["cuda"].levels) == len(hs["cpu"].levels) and all(sharded_equal))
    c.emit("galerkin_order", cases=list(cases), slab_n_slabs=n_slabs,
           bit_equal_card_vs_cpu=checks, sharded_levels_equal=sharded_equal,
           seconds=time.perf_counter() - t0)
    if not all(checks.values()):
        raise AssertionError(f"a Galerkin product differs between card and CPU: {checks}")
    # and against the JAX package's own levels (its CPU record)
    hold_jax_record(h3, dims3, "one_device", "setup3d")
    if n_slabs < 2:
        raise AssertionError(f"the slab case ran {n_slabs} slab(s)")
    # ordered_fma at config #3's level-1 smoother centre plane (43³)
    l1 = h3.levels[1]
    m = -torch.tensor(0.55, device=dev) * l1.d_inv
    w0 = l1.A.weights[l1.A.offsets.index((0, 0, 0))]
    one = torch.ones((), device=dev)
    got = ordered_sum.fma(m, w0, one)
    plain = ordered_sum.fma_plain(m, w0, one)
    fma_equal = bits_equal(got, plain)
    n = m.numel()
    n_bytes = 4 * (3 * n)  # m and w0 read, the result written (1.0 a scalar)
    b_ms, b_by = c.bound_ms(n_bytes, 2 * n)
    ms = c.device_ms(lambda: ordered_sum.fma(m, w0, one))
    plain_ms = c.device_ms(lambda: ordered_sum.fma_plain(m, w0, one), reps=1,
                           samples=5, warmup=1)
    c.results["ordered_fma"].update(
        ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        copy_bound_ms=c.copy_bound_ms(n_bytes), max_abs_err=0.0,
        main_case=f"config #3 level-1 smoother centre, {tuple(w0.shape)}",
        library_kind="none (torch has no single-rounding fma)")
    c.emit("kernel", name="ordered_fma", case=f"{tuple(w0.shape)}", ms=ms,
           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, share_of_bound=b_ms / ms,
           bit_equal_plain=fma_equal)
    if not fma_equal:
        raise AssertionError("ordered_fma differs from its plain version")
    # A8: the device coarse inverse of config #3's coarsest operator
    dense_c = torch.from_numpy(h3.levels[-1].A.to_csr().to_dense()).float()
    inv_card = coarse_inverse(dense_c.to(dev)).cpu()
    inv_host = torch.from_numpy(coarse_inverse_np(dense_c.double().numpy())).float()
    err = float((inv_card - inv_host).abs().max() / inv_host.abs().max())
    c.emit("coarse_inverse_device", n=dense_c.shape[0], max_rel_err_vs_float64=err,
           tolerance=1e-3)
    if not err <= 1e-3:
        raise AssertionError(f"coarse_inverse on the card: relative error {err}")


def bucket_stage_phase(c, A3, d_inv3, gen):
    """``ordered_bucket_stage`` on the three stages of config #3's level-0
    bucketed product (A3 and its D⁻¹, 128³, 7 points) and of the 468³ setup's
    gathered tail (a seeded 27-point operator of its 52³ level), in the JAX
    package's order for each grid (``bucket_stage.product_orders``), each
    against its plain version (``bucket_stage.stage_plain`` on the card) and
    the earlier ``ordered_fma`` sequence (``tests/bucket_sequence.py``, the
    setup's route before the kernel), bit for bit, one launch a stage; the
    kernel's device ms launched alone (its table already on the card) and
    ``bucket_stage.stage`` as the setup calls it, the plain version's, the
    byte and operation bounds (X, the factor planes and Y each once; 2
    operations a (term, output box) pair a point).  Then the kernel with each
    kind of departure (``tests/test_torch_bucket_stage.py``'s
    ``DEPARTURE_CASES``: rounded products, tails, a stored product, alt reads
    and outputs) against its plain version, and the 52³ tail's whole
    bucketed product against the JAX package's record
    (``scripts/jax_bucketed_record.py``, line ``p468_tail_vs_jax_record``).
    The earlier kernel is timed in turns with this one by
    ``scripts/bench_bucket_stage.py --parent DIR``."""
    import json

    import torch

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import jax_bucketed_record
    from bucket_sequence import earlier_sequence
    from test_torch_bucket_stage import DEPARTURE_CASES, _orders, _stages

    from parallel_amg_tpu_torch.amg import device_setup as ds
    from parallel_amg_tpu_torch.ops import bucket_stage, ordered_sum
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.problems import seeded_stencil

    dev = A3.weights.device
    w52, offs52 = seeded_stencil((52, 52, 52), 27, 3)
    A52 = Stencil(torch.from_numpy(w52).to(dev), offs52, (52, 52, 52))
    operators = {"config3_128^3_level0": (A3, d_inv3),
                 "p468_tail_52^3_27pt": (A52, ds.diag_inverse(A52))}
    coef = torch.tensor(0.55, device=dev)
    r = c.results["ordered_bucket_stage"]
    cases = r.setdefault("cases", {})
    ok = True
    for op_label, (A, d_inv) in operators.items():
        factors, boxes = ds.bucket_stage_factors(A, d_inv, coef, 3)
        orders = bucket_stage.product_orders(A.offsets, A.dims, 3)
        offs = tuple(A.offsets)
        X = torch.ones((1, 1, 1) + A.dims, device=dev)
        for s, (F, box_in, box_out) in enumerate(zip(factors, boxes, boxes[1:])):
            label = f"{op_label}_stage{s + 1}"
            order = orders[s]
            table = bucket_stage.terms(offs, box_in, box_out, 3, order)
            before = ordered_sum.LAUNCHES["ordered_bucket_stage"]
            fma_before = ordered_sum.LAUNCHES["ordered_fma"]
            got = bucket_stage.stage(F, offs, X, box_in, box_out, 3, A.dims, order)
            launched = ordered_sum.LAUNCHES["ordered_bucket_stage"] - before
            fma_launched = ordered_sum.LAUNCHES["ordered_fma"] - fma_before
            plain = bucket_stage.stage_plain(F, offs, X, box_in, box_out, 3, A.dims, order)
            equal_plain = bits_equal(got, plain)
            del plain
            equal_seq = None
            if order == bucket_stage.Order():  # the earlier sequence has the stage order
                seq = earlier_sequence(list(F), offs, X, box_in, box_out, 3, A.dims)
                equal_seq = bits_equal(got, seq)
                del seq
            finite = bool(torch.isfinite(got).all())
            n = A.n
            _, src = bucket_stage.kernel_table(table, box_in, box_out, 3)
            applied = int((src >= 0).sum())  # (term, box) pairs a point
            n_bytes = 4 * n * (F.shape[0] + X.numel() // n + got.numel() // n)
            b_ms, b_by = c.bound_ms(n_bytes, 2 * applied * n)
            bytes_ms = 1e3 * n_bytes / PEAK_BYTES_S
            ops_ms = 1e3 * 2 * applied * n / PEAK_F32_FLOP_S
            flat, n_terms, n_cols, _, _ = bucket_stage._device_table(
                offs, box_in, box_out, 3, order, dev)
            n_in, n_out = X.numel() // n, got.numel() // n
            Yl = torch.empty_like(got)

            def launch_alone():
                err = ordered_sum._kernels()[3](
                    F.data_ptr(), X.data_ptr(), None, Yl.data_ptr(), None, flat.data_ptr(),
                    flat[n_terms * bucket_stage.TERM_INTS:].data_ptr(), n_terms, n_in,
                    n_out, n_cols, F.shape[0], *A.dims, 3, 1, 1, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"ordered_bucket_stage launch failed: {err}")

            launch_ms, stage_ms = [], []
            for _ in range(2):  # in turns: launch alone, stage, launch alone, stage
                launch_ms.append(c.device_ms(launch_alone, reps=3, samples=7))
                stage_ms.append(c.device_ms(lambda: bucket_stage.stage(
                    F, offs, X, box_in, box_out, 3, A.dims, order), reps=3, samples=7))
            stage_host_ms = c.host_ms(lambda: bucket_stage.stage(
                F, offs, X, box_in, box_out, 3, A.dims, order), n=10)
            plain_ms = c.device_ms(lambda: bucket_stage.stage_plain(
                F, offs, X, box_in, box_out, 3, A.dims, order), reps=1, samples=3, warmup=1)
            ms = statistics.median(launch_ms)
            fields = dict(grid=list(A.dims), points=A.n_points, box_in=n_in, box_out=n_out,
                          terms=len(table), element_terms=applied, launches=launched,
                          ordered_fma_launches=fma_launched,
                          bit_equal_plain=equal_plain, bit_equal_earlier_sequence=equal_seq,
                          ms=ms, ms_in_turns=launch_ms, stage_ms=statistics.median(stage_ms),
                          stage_ms_in_turns=stage_ms, stage_host_ms=stage_host_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                          bound_bytes_ms=bytes_ms, bound_ops_ms=ops_ms,
                          share_of_bound=b_ms / ms, copy_bound_ms=c.copy_bound_ms(n_bytes))
            c.emit("kernel", name="ordered_bucket_stage", case=label, **fields)
            cases[label] = {k: fields[k] for k in (
                "ms", "stage_ms", "plain_ms", "bound_ms", "bound_bytes_ms", "bound_ops_ms",
                "launches")}
            ok &= (equal_plain and equal_seq is not False and finite and launched == 1
                   and fma_launched == 0)
            if label == "config3_128^3_level0_stage3":
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, copy_bound_ms=c.copy_bound_ms(n_bytes),
                         main_case=label, stage_ms=statistics.median(stage_ms),
                         share_of_bound=b_ms / ms, max_abs_err=0.0,
                         library_kind="none (no single PyTorch call computes the stage)")
            X = got
            del Yl
        del X, factors
    # each kind of departure from the stage order, on the card
    for dims, kind, key in DEPARTURE_CASES:
        for s, ((F, X, offs, box_in, box_out), order) in enumerate(zip(_stages(dims, kind),
                                                                         _orders(key))):
            X_alt = X + 0.25 if order.alt else None
            plain = bucket_stage.stage(F, offs, X, box_in, box_out, 3, dims, order, X_alt,
                                       alt_out=True)
            before = ordered_sum.LAUNCHES["ordered_bucket_stage"]
            got = bucket_stage.stage(F.to(dev), offs, X.to(dev), box_in, box_out, 3, dims,
                                     order, None if X_alt is None else X_alt.to(dev),
                                     alt_out=True)
            launched = ordered_sum.LAUNCHES["ordered_bucket_stage"] - before
            equal = all(bits_equal(g.cpu(), p) for g, p in zip(got, plain))
            label = f"departures_{'x'.join(map(str, dims))}_{kind}_stage{s + 1}"
            c.emit("kernel", name="ordered_bucket_stage", case=label, order=str(order),
                   launches=launched, bit_equal_plain=equal)
            ok &= equal and launched == 1
    # the 468³ tail's whole bucketed product against the JAX package's record
    with open(jax_bucketed_record.RECORD) as f:
        record = json.load(f)
    tail = "p468_tail_52^3_27pt"
    held = jax_bucketed_record.held(tail, jax_bucketed_record.port_planes(tail, "cuda"),
                                    record)
    c.emit("p468_tail_vs_jax_record", case=tail, equal=held,
           sha256=record["cases"][tail]["sha256"], jax=record["jax"], cpu=record["cpu"])
    if not held:
        raise AssertionError("the 52³ tail's bucketed product on the card differs from the "
                             "JAX package's record")
    if not ok:
        raise AssertionError(f"ordered_bucket_stage: a case differs from its plain version "
                             f"or the earlier sequence, or took other launches: {cases}")


def dist_algebraic_phases(c):
    """The algebraic distributed path, 8 parts on the card: phases pcsr,
    passembly, psetup_host, prs_setup and psa_setup.  ``c`` carries the
    script's helpers and config #2 (its matrix, b, config, float32 rounding
    floor and one-device PCG count).  Returns the launch counts by path."""
    import dataclasses

    import numpy as np
    import torch

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch import native
    from parallel_amg_tpu_torch.ops import gspgemm, ordered_sum, pspgemm, twell
    from parallel_amg_tpu_torch.ops.twell import TWELL
    from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
    from parallel_amg_tpu_torch.parallel import prs_setup as prs
    from parallel_amg_tpu_torch.parallel.pcsr import PCSR
    from parallel_amg_tpu_torch.problems import poisson2d
    from parallel_amg_tpu_torch.utils import roofline

    S = 8
    mesh = c.make_mesh(S)
    A_csr, A_sp, b_np = c.A_csr, c.A_sp, c.b_np
    n = A_csr.n_rows
    label = c.label
    paths = {}

    def counts():
        return {**c.spmv_counts(), **dict(pspgemm.LAUNCHES), **ordered_sum.LAUNCHES}

    def true_rel(x_parts, part):
        x = ptt.to_global(x_parts, part).astype(np.float64)
        return float(np.linalg.norm(b_np - A_sp @ x) / np.linalg.norm(b_np))

    def hold(ok, msg):
        if not ok:
            raise AssertionError(msg)

    def w_history(h, b):
        """‖b − Ax‖/‖b‖ in float64 after each of W_CYCLES W-cycles from 0, on
        h's own levels (a PGrid b on a PCSR hierarchy, or a tensor)."""
        hw = ptt.Hierarchy(h.levels, h.coarse_inv, dataclasses.replace(h.config, cycle="W"))
        x, out = b.zeros_like() if hasattr(b, "parts") else torch.zeros_like(b), []
        for _ in range(W_CYCLES):
            x = ptt.vcycle(hw, x, b)
            out.append(true_rel(x, h.levels[0].A.row_partition) if hasattr(x, "parts")
                       else float(np.linalg.norm(b_np - A_sp @ x.double().cpu().numpy())
                                  / np.linalg.norm(b_np)))
        return out

    # -- pcsr: PCSR.from_csr (native and numpy), dense and ring plans, B1 ------
    t0 = time.perf_counter()
    native.build()
    gxx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    Ap = PCSR.from_csr(A_csr, mesh)
    c.sync()
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    An = PCSR.from_csr(A_csr, mesh, native=False)
    c.sync()
    numpy_s = time.perf_counter() - t0
    native_equal_numpy = pcsr_equal(Ap, An)
    del An
    Ar = Ap.with_neighbor_plan()
    x_np = np.random.default_rng(5).normal(size=n).astype(np.float32)
    x = ptt.pvector(x_np, Ap.col_partition, mesh)
    y_dense = Ap.matvec(x).to_global()
    c.reset_counts()
    y_ring = Ar.matvec(x)
    c.sync()
    b1_per_matvec = twell.LAUNCHES
    ring_bit_equal = torch.equal(y_ring.to_global(), y_dense)
    tw = TWELL.from_csr(A_csr).to(c.dev)
    xg = torch.from_numpy(x_np).to(c.dev)
    y_one = tw.matvec(xg)
    one_bound = c.ATOL + c.RTOL * TWELL(tw.indptr, tw.indices, tw.vals.abs(), tw.shape,
                                        tw.blocks).matvec(xg.abs())
    one_err = float((y_ring.to_global()[:n] - y_one).abs().max())
    one_ok = bool(((y_ring.to_global()[:n] - y_one).abs() <= one_bound).all())
    # B1 on every part against the plain two-plane gather-sum
    g = Ar.ghosts(x)
    ref = torch.cat([(Ar.diag_vals[p] * x.parts[p][Ar.diag_cols[p].long()]).sum(1)
                     + (Ar.off_vals[p] * g[p][Ar.off_cols[p].long()]).sum(1)
                     for p in range(S)])
    bnd = c.ATOL + c.RTOL * torch.cat(
        [(Ar.diag_vals[p].abs() * x.parts[p].abs()[Ar.diag_cols[p].long()]).sum(1)
         + (Ar.off_vals[p].abs() * g[p].abs()[Ar.off_cols[p].long()]).sum(1)
         for p in range(S)])
    tws = Ar.twell_parts()
    n_bytes = sum(roofline.spmv_bytes(t) for t in tws)
    nnz = sum(t.nnz for t in tws)
    b_ms, b_by = c.bound_ms(n_bytes, 2 * nnz)
    ms = c.device_ms(lambda: Ar.matvec(x))
    ms_dense = c.device_ms(lambda: Ap.matvec(x))
    ms_one = c.device_ms(lambda: tw.matvec(xg))
    prof = c.profile(lambda: Ar.matvec(x), 20)
    err = c.check_kernel("twell_spmv", f"pcsr_{label}_{S}parts", torch.float32,
                         y_ring.to_global(), ref, bnd, dict(
                             parts=S, nnz=nnz, launches_per_matvec=b1_per_matvec,
                             ms_per_matvec=ms, bound_ms=b_ms, bound_by=b_by))
    c.results["twell_spmv"]["max_abs_err"] = max(c.results["twell_spmv"]["max_abs_err"], err)
    B = Ap.to_csr()
    to_csr_equal = (np.array_equal(B.indptr, A_csr.indptr)
                    and np.array_equal(B.indices, A_csr.indices)
                    and np.array_equal(B.data, A_csr.data.astype(np.float32)))
    C = Ap.C
    ghosts = [int((r < S * C).sum()) for r in Ap.recv_map]
    c.emit("pcsr", problem=label, parts=S, rows_per_part=Ap.row_partition.rows_per_shard,
           gxx_build_s=gxx_s, build_s_native=native_s, build_s_numpy=numpy_s,
           native_equal_numpy=native_equal_numpy, G=Ap.G, C=C, ghosts_per_part=ghosts,
           ring_offsets=list(Ar.nb_offsets), ring_bit_equal_dense=ring_bit_equal,
           vs_one_device_b1_max_abs_err=one_err, vs_one_device_ok=one_ok,
           to_csr_equal=to_csr_equal, b1_launches_per_matvec=b1_per_matvec,
           ms_per_matvec_ring=ms, ms_per_matvec_dense=ms_dense,
           one_device_b1_ms=ms_one, bound_ms=b_ms, bound_by=b_by, **prof)
    hold(native_equal_numpy and ring_bit_equal and one_ok and to_csr_equal
         and b1_per_matvec == S,
         "pcsr: a hold failed (see the pcsr line)")

    # -- passembly: pcsr_from_coo_device from scrambled triplets, repartition --
    coo = A_sp.tocoo()
    which = np.random.default_rng(1).integers(0, S, size=coo.nnz)
    order = np.argsort(which, kind="stable")
    per = np.bincount(which, minlength=S)
    T = int(per.max())
    starts = np.concatenate([[0], np.cumsum(per)])
    rows = np.full((S, T), -1, np.int64)
    cols = np.zeros((S, T), np.int64)
    vals = np.zeros((S, T), np.float64)
    for s in range(S):
        sel = order[starts[s]:starts[s + 1]]
        rows[s, :per[s]], cols[s, :per[s]], vals[s, :per[s]] = (
            coo.row[sel], coo.col[sel], coo.data[sel])
    c.sync()
    c.reset_peak()
    t0 = time.perf_counter()
    Ad = ptt.pcsr_from_coo_device(rows, cols, vals, A_sp.shape, mesh,
                                  ell_width=Ap.diag_cols[0].shape[1],
                                  off_width=Ap.off_cols[0].shape[1],
                                  ghost_capacity=4 * Ap.G)
    c.sync()
    asm_s = time.perf_counter() - t0
    asm_peak = c.peak_gb()
    asm_equal = pcsr_equal(Ad, Ap)
    m = Ad.row_partition.rows_per_shard
    t0 = time.perf_counter()
    Are = Ad.repartition(mesh, rows_per_shard=m + 8)
    c.sync()
    realign_s = time.perf_counter() - t0
    mesh4 = c.make_mesh(4)
    t0 = time.perf_counter()
    As4 = Ad.repartition(mesh4)
    c.sync()
    shrink_s = time.perf_counter() - t0
    errs = {}
    for name, M in (("assembled", Ad), ("realigned", Are), ("shrunk_4parts", As4)):
        y = M.matvec(ptt.pvector(x_np, M.col_partition, M.mesh)).to_global()[:n]
        d = (y - y_one).abs()
        errs[name] = (float(d.max()), bool((d <= one_bound).all()))
    c.emit("passembly", problem=label, parts=S, triplets_per_part=per.tolist(),
           seconds=asm_s, peak_device_gb=asm_peak, planes_and_plan_equal_from_csr=asm_equal,
           realign_rows_per_part=m + 8, realign_s=realign_s, shrink_to=4,
           shrink_s=shrink_s, matvec_max_abs_err_vs_one_device={k: v[0] for k, v in errs.items()})
    hold(asm_equal and all(v[1] for v in errs.values()),
         "passembly: a hold failed (see the passembly line)")
    del Ad, Are, As4, rows, cols, vals

    # -- psetup_host: distributed_setup from the oracle, PCG, FGMRES -----------
    t0 = time.perf_counter()
    hd = ptt.distributed_setup(A_sp, c.cfg, mesh)
    c.sync()
    host_s = time.perf_counter() - t0
    part = hd.levels[0].A.row_partition
    b = ptt.pvector(b_np, part, mesh)
    rows_host = [l.n for l in hd.levels]
    vt, _ = c.wall_ms(lambda: ptt.vcycle(hd, b.zeros_like(), b))
    c.reset_counts()
    t0 = time.perf_counter()
    r = ptt.amg_pcg(None, hd, b, tol=1e-6, maxiter=100)
    c.sync()
    solve_s = time.perf_counter() - t0
    paths["dist_config2_8parts_host_pcg"] = launches = counts()
    c.mp_ref["host"] = dict(iters=r.iters, x=part_digests(r.x.parts))
    tr = true_rel(r.x, part)
    limit = 1e-6 + (r.iters + 1) * c.f32_floor
    prof = c.profile(lambda: ptt.vcycle(hd, b.zeros_like(), b), 5)
    # FGMRES is held as PCG is: tol 1e-6, and the true residual within the
    # limit above.  Its own stopping test reads the float32 residual b − Ax
    # at each restart, which cannot fall below x's float32 rounding floor
    # (above 1e-6 at 1024²), so there it runs all its restart cycles
    t0 = time.perf_counter()
    rf = ptt.amg_fgmres(None, hd, b, tol=1e-6, restart=30, max_restarts=FGMRES_RESTARTS)
    c.sync()
    fg_s = time.perf_counter() - t0
    fg_tr = true_rel(rf.x, part)
    c.emit("psetup_host", problem=label, parts=S, setup_s=host_s, rows=rows_host,
           oracle_rows=c.oracle_rows,
           formats=[type(l.A).__name__ for l in hd.levels],
           vcycle_ms_median=statistics.median(vt), vcycle_ms=vt, pcg_iters=r.iters,
           one_device_iters=c.one_device_iters, converged=r.converged, solve_s=solve_s,
           true_rel_residual=tr, true_rel_residual_limit=limit, launches=launches,
           fgmres_tol=1e-6, fgmres_restart_cycles=rf.iters,
           fgmres_converged_float32=rf.converged,
           fgmres_float32_rel_residual=float(rf.residual_norm / b.norm()),
           fgmres_true_rel_residual=fg_tr, fgmres_s=fg_s, **prof)
    hold(rows_host == c.oracle_rows and r.converged
         and abs(r.iters - c.one_device_iters) <= 1 and tr <= limit
         and launches["twell_spmv"] > 0 and fg_tr <= limit,
         "psetup_host: a hold failed (see the psetup_host line)")
    del hd, r, rf

    # -- prs_setup: distributed_rs_setup on the card, twice --------------------
    cfg_rs = dataclasses.replace(c.cfg, on_device_setup=True)
    c.sync()
    c.reset_peak()
    c.reset_counts()
    t0 = time.perf_counter()
    h1 = ptt.distributed_setup(Ap, cfg_rs, mesh)
    c.sync()
    rs_s = time.perf_counter() - t0
    paths["dist_config2_8parts_rs_setup"] = setup_launches = counts()
    rs_peak = c.peak_gb()
    h2, prof_setup = c.profile_run(lambda: ptt.distributed_setup(Ap, cfg_rs, mesh))
    bit_equal = hierarchies_equal(h1, h2)
    del h2
    rows_rs = [l.n for l in h1.levels]
    cx = h1.complexity()
    stats = h1.setup_stats
    # B3, B5 and B4 on level 0's per-part R·A against their plain versions:
    # B3's candidates bit-equal, B5's counts equal, and B4's merged columns,
    # counts and values bit-equal (both sum each column in slot order); the
    # error against SPGEMM_ATOL + SPGEMM_RTOL·Σ|the candidates it merges| is
    # reported beside it
    R0 = h1.levels[0].R
    sent = int(Ap.col_partition.n_padded)
    bc, bv = prs._pcsr_global_cols(Ap, sent)
    gbc, gbv = prs._fetch_rows(R0, bc, bv, sent)
    prod_err, prod_err_over_bound, prod_same_cols = 0.0, 0.0, True
    prod_bit_equal = True
    for p in range(S):
        Ao, Bo = prs.part_product_operands(R0, p, bc[p], bv[p], gbc[p], gbv[p], sent)
        cc, cv = prs.part_candidates(Ao, Bo)
        pc, pv = prs.part_candidates(Ao, Bo, plain=True)
        merged = pspgemm._dedup_plain(pc, pv, sent, counts_only=True)
        w = max(int(merged.max()), 1)
        got = prs.part_product(Ao, Bo)
        want = gspgemm._dedup_compact_plain(pc, pv, sent, w)
        bound = SPGEMM_ATOL + SPGEMM_RTOL * gspgemm._dedup_compact_plain(
            pc, pv.abs(), sent, w)[1]
        d = (got.vals - want[1]).abs()
        prod_same_cols &= (torch.equal(cc, pc) and torch.equal(cv, pv)
                           and torch.equal(pspgemm.dedup(cc, cv, sent, counts_only=True),
                                           merged)
                           and got.width == w and torch.equal(got.cols, want[0])
                           and torch.equal(got.row_nnz, want[2]))
        prod_bit_equal &= torch.equal(got.vals, want[1])
        prod_err = max(prod_err, float(d.max()))
        prod_err_over_bound = max(prod_err_over_bound, float((d / bound).max()))
        del cc, cv, pc, pv, got, want, bound, d
    for k in ("spgemm_expand", "spgemm_dedup", "spgemm_dedup_compact"):
        c.results[k]["max_abs_err"] = max(c.results[k]["max_abs_err"], prod_err)
    hold(prod_same_cols and prod_bit_equal and prod_err_over_bound <= 1.0,
         f"prs_setup: level 0's per-part R·A disagrees with the plain B3 + B5 + B4 "
         f"(columns and counts equal {prod_same_cols}, values bit-equal "
         f"{prod_bit_equal}, |dv| {prod_err}, {prod_err_over_bound} of its bound)")
    b = ptt.pvector(b_np, h1.levels[0].A.row_partition, mesh)
    vt, _ = c.wall_ms(lambda: ptt.vcycle(h1, b.zeros_like(), b))
    c.reset_counts()
    ptt.vcycle(h1, b.zeros_like(), b)
    c.sync()
    cycle_launches = counts()
    c.reset_counts()
    t0 = time.perf_counter()
    r = ptt.amg_pcg(None, h1, b, tol=1e-6, maxiter=100)
    c.sync()
    solve_s = time.perf_counter() - t0
    paths["dist_config2_8parts_rs_pcg"] = pcg_launches = counts()
    c.mp_ref["rs"] = dict(iters=r.iters, levels=plane_digests(h1), rows=rows_rs)
    tr = true_rel(r.x, h1.levels[0].A.row_partition)
    limit = 1e-6 + (r.iters + 1) * c.f32_floor
    # The standalone W-cycle.  On these levels it slows from 0.30 a cycle to
    # 0.7–0.85 from about 6e-4 on, as the one-device hierarchy's does and
    # the float64 oracle's: 15 power iterations put level 1's λ_max(D⁻¹A)
    # below its true value even with the 1.1 factor, so Chebyshev amplifies
    # that level's top modes, and a W-cycle visits the level twice.  Both
    # are reported, cycle by cycle, as float64 true residuals; the held
    # solve is the same setup with λ_max from 100 power iterations, capped
    # at the cycles a 0.30 rate needs to 1e-6 and held as PCG is
    t0 = time.perf_counter()
    w_main = w_history(h1, b)
    w_one = w_history(c.one_device_rs, torch.from_numpy(b_np).float().to(c.dev))
    w_history_s = time.perf_counter() - t0
    lam_main = [l.lam_max for l in h1.levels]

    def hold_lams(result):
        if not lambda_vs_cpu(c, "dist_config2_8parts_rs_setup", lam_main, *result):
            raise AssertionError("prs_setup: a level's λ_max differs from the CPU's")

    # the same power iterations on the CPU (60-150 s of host time) run in a
    # host process beside the card's next phases
    on_host(cpu_pcsr_lambdas, ([(pcsr_args(l.A), [p.cpu().numpy() for p in l.d_inv.parts])
                                for l in h1.levels], cfg_rs.lambda_power_iters), hold_lams)
    del h1
    cfg_w = dataclasses.replace(cfg_rs, cycle="W", lambda_power_iters=100)
    hw = ptt.distributed_setup(Ap, cfg_w, mesh)
    bw = ptt.pvector(b_np, hw.levels[0].A.row_partition, mesh)
    t0 = time.perf_counter()
    x_w, hist_w, k_w = ptt.solve(hw, bw, tol=1e-6, maxiter=W_CYCLES)
    c.sync()
    w_s = time.perf_counter() - t0
    w_tr = true_rel(x_w, hw.levels[0].A.row_partition)
    w_limit = 1e-6 + (k_w + 1) * c.f32_floor
    c.emit("prs_setup", problem=label, parts=S, setup_s=rs_s,
           second_setup_profiled=prof_setup, bit_equal=bit_equal, rows=rows_rs,
           jax_package_8_shards=DIST_RS_JAX8, grid_complexity=cx[0],
           operator_complexity=cx[1], pmis_rounds=[l.get("pmis_rounds") for l in stats["levels"]],
           products=[l.get("products") for l in stats["levels"]],
           ext_i_widths=[l.get("ext_i") for l in stats["levels"]],
           phase_seconds=stats["seconds"], launches=setup_launches,
           peak_device_gb=rs_peak, part_products_level0_RA_same_cols=prod_same_cols,
           part_products_level0_RA_max_abs_err=prod_err,
           part_products_level0_RA_max_err_over_bound=prod_err_over_bound,
           part_products_level0_RA_bit_equal=prod_bit_equal,
           part_products_level0_RA_tolerance=(
               "B3 bit-equal, B5 counts equal, B4 columns, counts and values "
               f"bit-equal (and |dv| <= {SPGEMM_ATOL} + {SPGEMM_RTOL}*sum|merged|)"),
           vcycle_ms_median=statistics.median(vt), vcycle_ms=vt,
           vcycle_launches=cycle_launches, pcg_iters=r.iters, converged=r.converged,
           solve_s=solve_s, true_rel_residual=tr, true_rel_residual_limit=limit,
           pcg_launches=pcg_launches,
           wcycle_true_rel_residual_by_cycle=w_main, lam_max=lam_main,
           wcycle_one_device_rs_true_rel_residual_by_cycle=w_one,
           wcycle_histories_s=w_history_s,
           wcycle_lam_max=[l.lam_max for l in hw.levels],
           wcycle_lambda_power_iters=cfg_w.lambda_power_iters,
           wcycle_solve_cycles=k_w,
           wcycle_float32_rel_residual_by_cycle=(hist_w[:k_w] / bw.norm()).cpu().tolist(),
           wcycle_true_rel_residual=w_tr, wcycle_true_rel_residual_limit=w_limit,
           wcycle_solve_s=w_s)
    # the JAX package's hierarchy: the same rows at every level, the
    # complexities to the digits its run printed, the same PCG count
    hold(rows_rs == DIST_RS_JAX8["rows"],
         f"prs_setup rows {rows_rs}, the JAX package's {DIST_RS_JAX8['rows']}")
    hold(tuple(round(v, 3) for v in cx) == DIST_RS_JAX8["complexity"],
         f"prs_setup complexities {cx}, the JAX package's {DIST_RS_JAX8['complexity']}")
    hold(r.iters == DIST_RS_JAX8["pcg_iters"],
         f"prs_setup PCG {r.iters}, the JAX package's {DIST_RS_JAX8['pcg_iters']}")
    # the setup's row sums take the staged and windows kernels, its power
    # iterations the lanes kernel (the PCSR planes' fused multiply-adds);
    # the solve takes B1
    launched = (min(setup_launches[k] for k in (*pspgemm.LAUNCHES,
                                                 *ORDERED_SUM_KERNELS)) > 0
                and pcg_launches["twell_spmv"] > 0)
    hold(bit_equal and r.converged and tr <= limit and w_tr <= w_limit
         and launched,
         "prs_setup: a hold failed (see the prs_setup line)")
    del hw, r, R0, bc, bv, gbc, gbv, x_w
    ordered_sum_phase(c, Ap, cfg_rs, mesh)

    # -- psa_setup: distributed_sa_setup at 256² and 1024² ---------------------
    cfg_sa = ptt.AMGConfig(coarsening="sa", smoother="chebyshev", n_coarse_max=256,
                           on_device_setup=True, coarse_drop_tol=0.0)
    out = {}
    for nx_sa in c.sa_sizes:
        A_h = poisson2d(nx_sa).to_csr()
        A_s = A_h.to_scipy()
        bs_np = np.random.default_rng(0).normal(size=A_h.n_rows)
        c.sync()
        c.reset_peak()
        c.reset_counts()
        t0 = time.perf_counter()
        hs = ptt.distributed_setup(A_h, cfg_sa, mesh)
        c.sync()
        secs = time.perf_counter() - t0
        s_launch = counts()
        peak = c.peak_gb()
        first = nx_sa == c.sa_sizes[0]
        equal = None
        if first:
            equal = hierarchies_equal(hs, ptt.distributed_setup(A_h, cfg_sa, mesh))
        bs = ptt.pvector(bs_np, hs.levels[0].A.row_partition, mesh)
        c.reset_counts()
        t0 = time.perf_counter()
        r = ptt.amg_pcg(None, hs, bs, tol=1e-6, maxiter=60)
        c.sync()
        solve_s = time.perf_counter() - t0
        p_launch = counts()
        x = ptt.to_global(r.x, hs.levels[0].A.row_partition).astype(np.float64)
        tr = float(np.linalg.norm(bs_np - A_s @ x) / np.linalg.norm(bs_np))
        oracle_iters = None
        if not first:
            oh = oracle_setup(A_s, cfg_sa)
            _, oracle_iters, _ = oracle_pcg(A_s, bs_np, oh, tol=1e-6, maxiter=100)
            oracle_iters = int(oracle_iters)
        rows_sa = [l.n for l in hs.levels]
        out[nx_sa] = dict(setup_s=secs, rows=rows_sa, complexity=hs.complexity(),
                          mis_rounds=[l.get("mis_rounds") for l in hs.setup_stats["levels"]],
                          products=[l.get("products") for l in hs.setup_stats["levels"]],
                          phase_seconds=hs.setup_stats["seconds"], bit_equal=equal,
                          launches=s_launch, peak_device_gb=peak, pcg_iters=r.iters,
                          converged=r.converged, solve_s=solve_s, true_rel_residual=tr,
                          pcg_launches=p_launch, oracle_iters=oracle_iters)
        if first:
            paths[f"dist_sa_{nx_sa}_8parts_setup"] = s_launch
            paths[f"dist_sa_{nx_sa}_8parts_pcg"] = p_launch
        launched = (min(s_launch[k] for k in ("twell_spmv", *pspgemm.LAUNCHES)) > 0
                    and p_launch["twell_spmv"] > 0)
        hold(r.converged and launched and equal in (None, True),
             f"psa_setup {nx_sa}²: a hold failed: {out[nx_sa]}")
        del hs, r
    c.emit("psa_setup", parts=S, config="sa chebyshev n_coarse_max=256 coarse_drop_tol=0",
           jax_package_8_shards_256=DIST_SA256_JAX8, **{f"poisson2d_{k}": v for k, v in out.items()})
    o = out[c.sa_sizes[0]]
    c.mp_ref["sa256"] = dict(rows=o["rows"], iters=o["pcg_iters"], config=cfg_sa)
    hold(o["rows"] == DIST_SA256_JAX8["rows"]
         and abs(o["pcg_iters"] - DIST_SA256_JAX8["pcg_iters"]) <= 1,
         f"psa_setup 256²: rows {o['rows']}, PCG {o['pcg_iters']}")
    del Ap, Ar, tw
    return paths


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch finds no CUDA device")
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import parallel_amg_tpu_torch as ptt
    from parallel_amg_tpu_torch.amg import device_rs, device_setup
    from parallel_amg_tpu_torch.amg.hierarchy import Hierarchy
    from parallel_amg_tpu_torch.ops import (
        _build,
        bsr,
        flatdia,
        gspgemm,
        ordered_sum,
        pspgemm,
        twell,
    )
    from parallel_amg_tpu_torch.parallel import (
        exchange,
        launch,
        pdevice_setup,
        phalo_async,
    )
    from parallel_amg_tpu_torch.parallel.pgrid import PGrid
    from parallel_amg_tpu_torch.parallel.pstencil import (
        ShardedStencil,
        apply_halo_mode,
        boundary_plain,
        interior_plain,
    )
    from parallel_amg_tpu_torch.ops.csr import CSR
    from parallel_amg_tpu_torch.ops.dia import DIA
    from parallel_amg_tpu_torch.ops.ell import ELL
    from parallel_amg_tpu_torch.ops.ell_setup import ell_spgemm
    from parallel_amg_tpu_torch.ops.flatdia import FlatDIA
    from parallel_amg_tpu_torch.ops.stencil import Stencil
    from parallel_amg_tpu_torch.ops.bsr import BSR
    from parallel_amg_tpu_torch.ops.btwell import btwell_from_kron_stencil
    from parallel_amg_tpu_torch.ops.twell import TWELL, _matvec_plain
    from parallel_amg_tpu_torch.oracle import oracle_pcg, oracle_setup
    from parallel_amg_tpu_torch.problems import (
        anisotropic2d,
        convection2d,
        coupled_laplacian,
        coupling_matrix,
        poisson2d,
        poisson3d,
        poisson_stencil,
        seeded_stencil,
    )
    from parallel_amg_tpu_torch.oracle import oracle_vcycle
    from parallel_amg_tpu_torch.utils import roofline
    from parallel_amg_tpu_torch.utils.checkpoint import (
        cast_hierarchy,
        load_hierarchy,
        save_hierarchy,
    )
    from parallel_amg_tpu_torch.utils.metrics import level_digests
    from parallel_amg_tpu_torch.utils.tree import tensors

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         python=sys.version.split()[0], name=kind, nvidia_smi=smi,
         count=torch.cuda.device_count(),
         matmul_tf32=torch.backends.cuda.matmul.allow_tf32)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("float32 matmuls would round through TF32")

    # -- build: one nvcc per source, all started together ----------------------
    def timed_build(name):
        was_built = _build.library_path(name).exists()
        t0 = time.perf_counter()
        lib = _build.build(name)
        return name, was_built, time.perf_counter() - t0, lib

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBRARIES)) as pool:
        built = list(pool.map(timed_build, LIBRARIES))
    wall_build = time.perf_counter() - t0
    for name, was_built, secs, lib in built:
        ptxas = [l.split(":", 1)[-1].strip()
                 for l in lib.with_suffix(".log").read_text().splitlines()
                 if "registers" in l or "stack frame" in l or "spill" in l]
        emit("build", library=name, seconds=secs, wall_seconds_all=wall_build,
             already_built=was_built, file=str(lib.name), ptxas=ptxas)

    src = torch.empty(2**30, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    copy_ms = device_ms(lambda: dst.copy_(src), reps=5, samples=9)
    copy_bytes_s = 2 * 2**30 / (copy_ms / 1e3)  # read + write
    emit("copy_bandwidth", bytes=2**30, ms=copy_ms, gb_s=copy_bytes_s / 1e9)
    del src, dst

    def copy_bound_ms(n_bytes):
        return 1e3 * n_bytes / copy_bytes_s

    def reset_counts():
        """Every kernel's launch count to 0."""
        twell.LAUNCHES = bsr.LAUNCHES = 0
        for counts in (flatdia.LAUNCHES, pspgemm.LAUNCHES, phalo_async.LAUNCHES,
                       ordered_sum.LAUNCHES):
            for k in counts:
                counts[k] = 0

    def spmv_counts():
        return {"twell_spmv": twell.LAUNCHES,
                "flatdia_spmv": flatdia.LAUNCHES["flatdia_spmv"]}

    def vector_counts():
        return {"bsr_spmv": bsr.LAUNCHES,
                "flatdia_spmm": flatdia.LAUNCHES["flatdia_spmm"]}

    def halo_counts():
        """B8's launches: each part's interior and boundary entry."""
        return dict(phalo_async.LAUNCHES)

    def check_kernel(name, case, dtype, y, ref, bound, extra):
        torch.cuda.synchronize()
        if not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name} {case} {dtype}: kernel output not finite")
        err = (y - ref).abs()
        abs_err = float(err.max()) if err.numel() else 0.0
        ok = bool((err <= bound).all())
        emit("kernel", name=name, case=case, dtype=str(dtype), max_abs_err=abs_err,
             max_rel_err=abs_err / max(float(ref.abs().max()) if ref.numel() else 0.0, 1e-30),
             tolerance=f"|dy| <= {ATOL} + {RTOL}*(|A||x|)", ok=ok, **extra)
        if not ok:
            raise AssertionError(f"{name} {case} {dtype}: kernel disagrees with "
                                 f"the plain version (max |dy| {abs_err})")
        return abs_err

    # -- setup of config #2 at 1024² ------------------------------------------
    nx = 1024
    A_csr = poisson2d(nx).to_csr()
    A_sp = A_csr.to_scipy()
    cfg = ptt.AMGConfig(coarsening="rs", smoother="chebyshev", n_coarse_max=256,
                        interpolation="extended_i")
    t0 = time.perf_counter()
    h = ptt.setup(A_csr, cfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def fmt(M):
        return None if M is None else type(M).__name__

    levels = [{"rows": l.A.n_rows, "nnz": l.A.nnz, "A": fmt(l.A), "P": fmt(l.P),
               "R": fmt(l.R),
               "diags": l.A.n_diags if isinstance(l.A, DIA) else None}
              for l in h.levels]
    emit("setup", problem=f"poisson2d({nx})", seconds=setup_s,
         n_levels=h.n_levels, levels=levels, complexity=h.complexity())

    # -- kernel B1: twell_spmv -------------------------------------------------
    rng = np.random.default_rng(0)

    def random_rect(n_rows, n_cols, per_row):
        nnz = n_rows * per_row
        rows = np.repeat(np.arange(n_rows), per_row)
        cols = rng.integers(0, n_cols, size=nnz)
        vals = rng.normal(size=nnz).astype(np.float32)
        return CSR.from_scipy(sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n_rows, n_cols)))

    def long_rows(n_rows, n_cols, lengths=(64, 513), n_over=0):
        """Rows of lengths[0] to lengths[1] − 1 entries; with n_over, that
        many rows of 5,000–20,000 entries (past the kernel's shared-memory
        capacity: its long-row path) at random places."""
        lengths = rng.integers(*lengths, size=n_rows)
        lengths[rng.choice(n_rows, size=n_over, replace=False)] = rng.integers(
            5_000, 20_001, size=n_over)
        rows = np.repeat(np.arange(n_rows), lengths)
        cols = rng.integers(0, n_cols, size=rows.size)
        vals = rng.normal(size=rows.size).astype(np.float32)
        return CSR.from_scipy(sp.csr_matrix((vals, (rows, cols)),
                                            shape=(n_rows, n_cols)))

    cases = {
        "random_rect_200000x150000": random_rect(200_000, 150_000, 9),
        "long_rows_65536": long_rows(65_536, 65_536),
        "rows_over_cap_100000": long_rows(100_000, 200_000, (5, 21), 2_000),
        "level1_A": h.levels[1].A.to_csr(),
        "P0": h.levels[0].P.to_csr(),
        "R0": h.levels[0].R.to_csr(),
        # the coarse levels, where launch latency rules
        **{f"level{i}_A": h.levels[i].A.to_csr() for i in (2, 3, 4)},
    }
    results = {k: {"max_abs_err": 0.0} for k in KERNELS}
    for name, csr in cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            A = TWELL.from_csr(csr, dtype=dtype).to(dev)
            A_abs = TWELL(A.indptr, A.indices, A.vals.abs(), A.shape, A.blocks)
            x = torch.from_numpy(
                rng.normal(size=A.n_cols).astype(np.float32)).to(dev)
            y = A.matvec(x)
            ref = _matvec_plain(A, x)
            bound = ATOL + RTOL * _matvec_plain(A_abs, x.abs())
            n_bytes = roofline.spmv_bytes(A)
            b_ms, b_by = bound_ms(n_bytes, 2 * A.nnz)
            lib_ms, lib_err = None, None
            if dtype == torch.float32:
                lib = torch.sparse_csr_tensor(A.indptr, A.indices, A.vals,
                                              size=A.shape)
                lib_ms, lib_err = library_ms(lib, x)
                del lib
            ms = device_ms(lambda: A.matvec(x))
            plain_ms = device_ms(lambda: _matvec_plain(A, x))
            # bit-equal from call to call: no atomics, a fixed order
            repeat_equal = all(torch.equal(A.matvec(x).view(torch.int32),
                                           y.view(torch.int32)) for _ in range(20))
            err = check_kernel("twell_spmv", name, dtype, y, ref, bound, dict(
                shape=list(A.shape), nnz=A.nnz, row_blocks=A.n_blocks,
                long_rows=int((A.indptr.diff() > twell.LONG_ROW).sum()), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                share_of_bound=b_ms / ms, copy_bound_ms=copy_bound_ms(n_bytes),
                library_csr_ms=lib_ms, library_error=lib_err,
                vs_library=None if lib_ms is None else ms / lib_ms,
                bit_equal_20_calls=repeat_equal, gnnz_s=A.nnz / ms / 1e6))
            if not repeat_equal:
                raise AssertionError(f"twell_spmv {name} {dtype}: y changed between calls")
            r = results["twell_spmv"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "level1_A" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         main_case=f"{name} f32", bit_equal_20_calls=repeat_equal)
            del A, A_abs

    # -- setup3d: config #3 at 128³ on the card ---------------------------------
    n3 = 128
    cfg3 = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                         smoother="chebyshev", n_coarse_max=512,
                         on_device_setup=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with record_dot_shapes("setup3d"):
        t0 = time.perf_counter()
        h3 = ptt.setup(poisson_stencil((n3,) * 3), cfg3)
        torch.cuda.synchronize()
        setup3_s = time.perf_counter() - t0
    launches_setup3 = {k: ordered_sum.LAUNCHES[k] for k in (
        "ordered_stencil_matvec", "ordered_fma", "ordered_bucket_stage",
        "ordered_sum_lanes")}
    levels3 = [{"rows": l.A.n_rows, "points": l.A.n_points, "format": fmt(l.A),
                "lam_max": l.lam_max,
                "product_path": (device_setup.select_product_path(l.A, cfg3)
                                 if l.P is not None else None)}
               for l in h3.levels]
    emit("setup3d", problem=f"poisson_stencil(({n3},)*3)", seconds=setup3_s,
         n_levels=h3.n_levels, levels=levels3, launches=launches_setup3,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    # the smoothers' centre planes stay ordered_fma (82 when each contiguous
    # block of a bucketed update was one); every bucketed stage is one
    # ordered_bucket_stage launch
    n_bucketed3 = [lv["product_path"] for lv in levels3].count("bucketed")
    if not (0 < launches_setup3["ordered_fma"] < 82
            and launches_setup3["ordered_bucket_stage"] == 3 * n_bucketed3 > 0):
        raise AssertionError(f"config #3's setup: {launches_setup3} for {n_bucketed3} "
                             "bucketed product(s)")
    # one ordered_stencil_matvec an iteration of every level's power iteration
    if launches_setup3["ordered_stencil_matvec"] != cfg3.lambda_power_iters * h3.n_levels:
        raise AssertionError(f"config #3's setup: {launches_setup3}, want "
                             f"{cfg3.lambda_power_iters} ordered_stencil_matvec a level")
    rows3 = [l.A.n_rows for l in h3.levels]
    if rows3 != CONFIG3_ROWS:
        raise AssertionError(f"config #3 levels {rows3}, want {CONFIG3_ROWS}")
    # λ_max(D⁻¹A) of every level: the same power iteration on the CPU, from
    # the level's operator copied over, gives the card's bits
    lams3 = [l.lam_max for l in h3.levels]

    def hold_lams3(result):
        if not lambda_vs_cpu(types.SimpleNamespace(emit=emit), "config3_128^3", lams3,
                             *result):
            raise AssertionError("config #3: a level's λ_max differs from the CPU's")

    kctx = types.SimpleNamespace(emit=emit, device_ms=device_ms, bound_ms=bound_ms,
                                 copy_bound_ms=copy_bound_ms, library_ms=library_ms,
                                 host_ms=host_ms, results=results)
    # the power iterations' matvec on one device: config #3's level 0, and a
    # grid whose centre the JAX package adds unfused (n1 = 8, 5 ≤ n2 ≤ 8)
    g_os = torch.Generator(device=dev).manual_seed(18)
    ordered_stencil_case(kctx, "config3_128^3_level0", h3.levels[0].A, h3.levels[0].d_inv,
                         g_os)
    p_unf = poisson_stencil((96, 8, 6))
    A_unf = Stencil(p_unf.weights * (0.5 + torch.rand(p_unf.weights.shape, generator=g_os,
                                                      device=dev)), p_unf.offsets, p_unf.dims)
    ordered_stencil_case(kctx, "unfused_centre_96x8x6", A_unf,
                         device_setup.diag_inverse(A_unf), g_os, want_rows=8)
    del p_unf, A_unf
    # the centre unfused on the rows LLVM's vector loop covers (ROADMAP C7a):
    # one device, rows 0-43 of 45; 8 parts of 2 × 468 × 8, every row (four
    # points a thread); 8 parts of 2 × 45 × 6, rows 0-43 (one point a thread)
    w_rows, offs_rows = seeded_stencil((64, 45, 8), 7, 19)
    A_rows = Stencil(torch.from_numpy(w_rows).to(dev), offs_rows, (64, 45, 8))
    ordered_stencil_case(kctx, "unfused_rows_64x45x8", A_rows,
                         device_setup.diag_inverse(A_rows), g_os, want_rows=44)
    w_rows, offs_rows = seeded_stencil((16, 468, 8), 7, 1)
    A_rows = ShardedStencil.from_global(torch.from_numpy(w_rows).to(dev), offs_rows,
                                        (16, 468, 8), ptt.make_row_mesh(8))
    ordered_stencil_case(kctx, "unfused_rows_16x468x8_8parts", A_rows,
                         pdevice_setup._sharded_dinv(A_rows), g_os, want_rows=468)
    w_rows, offs_rows = seeded_stencil((16, 45, 6), 7, 2)
    A_rows = ShardedStencil.from_global(torch.from_numpy(w_rows).to(dev), offs_rows,
                                        (16, 45, 6), ptt.make_row_mesh(8))
    ordered_stencil_case(kctx, "unfused_rows_16x45x6_8parts", A_rows,
                         pdevice_setup._sharded_dinv(A_rows), g_os, want_rows=44)
    del w_rows, A_rows
    bucket_stage_phase(kctx, h3.levels[0].A, h3.levels[0].d_inv, g_os)
    # the host references start after the timings above, which wait on the
    # host (the earlier sequences' launches)
    on_host(cpu_stencil_lambdas, ([(l.A.weights.cpu().numpy(), l.A.offsets, l.A.dims,
                                    l.d_inv.cpu().numpy()) for l in h3.levels],
                                  cfg3.lambda_power_iters), hold_lams3)
    galerkin_order_phase(kctx, h3)

    # -- poisson2d: 2-D Poisson 1024² on the structured setup ------------------
    # the JAX package's levels (artifacts/poisson2d_jax_levels.json) and the
    # port's CPU run of the same setup; its PCG; the 2-D norms' lanes kernels
    # and the 2-D matvec's rows and swapped last column
    n2d = POISSON2D_N
    cfg2d = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                          smoother="chebyshev", n_coarse_max=64, on_device_setup=True)
    A2d = poisson_stencil((n2d, n2d))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    h2d = ptt.setup(A2d, cfg2d)
    torch.cuda.synchronize()
    setup2d_s = time.perf_counter() - t0
    launches_setup2d = {k: v for k, v in ordered_sum.LAUNCHES.items() if v}
    levels2d = [{"dims": list(l.A.dims), "points": l.A.n_points, "lam_max": l.lam_max,
                 "product_path": (device_setup.select_product_path(l.A, cfg2d)
                                  if l.P is not None else None)} for l in h2d.levels]
    emit("poisson2d_setup", problem=f"poisson_stencil(({n2d}, {n2d}))", seconds=setup2d_s,
         levels=levels2d, launches=launches_setup2d,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    if launches_setup2d.get("ordered_stencil_matvec") != (cfg2d.lambda_power_iters
                                                           * h2d.n_levels):
        raise AssertionError(f"poisson2d: {launches_setup2d}, want "
                             f"{cfg2d.lambda_power_iters} ordered_stencil_matvec a level")
    if not launches_setup2d.get("ordered_sum_lanes"):
        raise AssertionError(f"poisson2d: no 2-D norm through the lanes kernel: "
                             f"{launches_setup2d}")
    rec2d = hold_poisson2d_record(h2d, n2d, "poisson2d_1024^2")
    digests2d = level_digests(h2d)

    def hold_2d_cpu(result):
        cpu_levels, cpu_iters, cpu_s = result
        from parallel_amg_tpu_torch.utils.metrics import compare_levels

        rows, same = compare_levels(cpu_levels, digests2d)
        emit("poisson2d_vs_cpu", equal=same, levels=rows, cpu_pcg_iterations=cpu_iters,
             cpu_setup_s=cpu_s)
        if not same or cpu_iters != pcg2d_iters:
            raise AssertionError(f"poisson2d: the card's levels or PCG count ({pcg2d_iters}) "
                                 f"differ from the CPU's ({cpu_iters}): {rows}")

    on_host(cpu_poisson2d, (n2d, cfg2d), hold_2d_cpu)
    b2d = torch.from_numpy(poisson2d_rhs(n2d)).to(dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res2d = ptt.amg_pcg(A2d, h2d, b2d, tol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    solve2d_s = time.perf_counter() - t0
    launches_pcg2d = {**spmv_counts(), **{k: v for k, v in ordered_sum.LAUNCHES.items()
                                          if v}}
    pcg2d_iters = int(res2d.iters)
    b64 = b2d.double()

    def true_rel_2d(x):
        r = b64 - A2d._matmat_plain(x.double()[..., None])[..., 0]
        return float(torch.linalg.norm(r) / torch.linalg.norm(b64))

    true2d = true_rel_2d(res2d.x)
    # float32 storage alone: a float64 solve to 1e-8 rounded to float32
    x_mp = ptt.amg_pcg_mp(None, h2d, b2d, tol=1e-8).x
    floor2d = true_rel_2d(x_mp.reshape(n2d, n2d).float())
    limit2d = 1e-6 + (pcg2d_iters + 1) * floor2d
    emit("poisson2d_pcg", pcg_iters=pcg2d_iters, jax_pcg_iters=rec2d["pcg_iterations"],
         converged=res2d.converged, solve_s=solve2d_s, true_rel_residual=true2d,
         f32_rounding_floor=floor2d, true_rel_residual_limit=limit2d,
         launches=launches_pcg2d,
         residual_history=res2d.residual_history[:pcg2d_iters + 1].cpu().tolist())
    if not (res2d.converged and pcg2d_iters == rec2d["pcg_iterations"]
            and true2d <= limit2d):
        raise AssertionError(f"poisson2d PCG: {pcg2d_iters} iterations (the JAX package's "
                             f"{rec2d['pcg_iterations']}), true residual {true2d} "
                             f"(limit {limit2d})")
    del b64, x_mp
    # the 2-D norms' sums on the card against their plain version, one input
    # of each shape; the longest new lanes schedule timed
    _, captured2d = capture_row_sums(lambda: ptt.setup(A2d, cfg2d))
    by_kernel2d, equal2d = ordered_sum_check(kctx, captured2d, "poisson2d_1024^2_setup")
    if not equal2d:
        raise AssertionError("poisson2d: an ordered sum differs from its plain version")
    rows_lanes2d = [(name, args) for name, args in captured2d
                    if name in ("row_sum", "row_dot")
                    and tuple(args[-1] or ()) in ((2, 1, 0), (4, 1, 0), (8, 1, 0))]
    if not rows_lanes2d:
        raise AssertionError("poisson2d: no 2-D norm took a (vf, 1, 0) lanes schedule")
    name, args = max(rows_lanes2d, key=lambda t: t[1][0].numel())
    time_ordered_sum(kctx, "ordered_sum_lanes", name, args,
                     f"poisson2d 1024², the 2-D norm's rows in {args[-1][0]} lanes, "
                     f"{list(args[0].shape)}", key="poisson2d_norm")
    del captured2d, by_kernel2d, rows_lanes2d
    # the 2-D matvec's rounded centre rows and swapped last column
    g2d = torch.Generator(device=dev).manual_seed(21)
    for dims_c, pts_c, rows_c, swap_c in (((1000, 6), 9, 992, None), ((1000, 9), 9, 0, 8),
                                          ((1024, 8), 5, 1024, None)):
        w_c, offs_c = seeded_stencil(dims_c, pts_c, 3)
        A_c = Stencil(torch.from_numpy(w_c).to(dev), offs_c, dims_c)
        ordered_stencil_case(kctx, f"plan2d_{dims_c[0]}x{dims_c[1]}_{pts_c}pt", A_c,
                             device_setup.diag_inverse(A_c), g2d, want_rows=rows_c,
                             want_swap=swap_c)
    del w_c, A_c, h2d, A2d, b2d, res2d

    # -- kernel B2: flatdia_spmv ---------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    p7 = poisson_stencil((n3,) * 3)
    random7 = Stencil(p7.weights * (0.5 + 1.5 * torch.rand(
        p7.weights.shape, generator=g, device=dev)), p7.offsets, p7.dims)
    widest = max((l.A for l in h.levels if isinstance(l.A, DIA)),
                 key=lambda a: a.n_diags)
    alias_w = torch.rand((3, 4, 3), generator=g, device=dev) - 0.5
    alias_w[1, 3, :] = 0.0  # (1, 0) leaves the grid on the last row
    alias_w[2] = 0.0        # (0, 3) always leaves a 3-wide grid
    flat_cases = {
        "random_7pt_128^3": FlatDIA.from_stencil(random7),
        "config3_level1": FlatDIA.from_stencil(h3.levels[1].A),
        f"config2_dia_{widest.n_rows}x{widest.n_diags}diags": FlatDIA.from_dia(widest),
        "aliased_4x3": FlatDIA.from_stencil(
            Stencil(alias_w, ((0, 0), (1, 0), (0, 3)), (4, 3))),
    }
    if flat_cases["aliased_4x3"].nd_offsets is not None:
        raise AssertionError("the aliased case did not merge planes")
    del p7, random7

    def flat_csr(fd):
        r = torch.arange(fd.n, device=dev)
        rows, cols, vals = [], [], []
        for d, off in enumerate(fd.offsets):
            c = r + off
            keep = (fd.diags[d] != 0) & (c >= 0) & (c < fd.n)
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(fd.diags[d][keep].float())
        coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                      torch.cat(vals), (fd.n, fd.n))
        return coo.coalesce().to_sparse_csr()

    for name, fd in flat_cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            W = fd.diags.to(dtype).contiguous()
            x = torch.randn(fd.n, generator=g, device=dev)
            y = flatdia.dia_spmv(W, fd.offsets, x)
            ref = flatdia._matvec_plain(W, fd.offsets, x)
            bound = ATOL + RTOL * flatdia._matvec_plain(W.abs(), fd.offsets, x.abs())
            n_bytes = roofline.spmv_bytes(FlatDIA(W, fd.offsets, fd.n))
            b_ms, b_by = bound_ms(n_bytes, 2 * fd.n_points * fd.n)
            lib_ms, lib_err = None, None
            if dtype == torch.float32:
                lib = flat_csr(FlatDIA(W, fd.offsets, fd.n))
                lib_ms, lib_err = library_ms(lib, x)
                del lib
            ms = device_ms(lambda: flatdia.dia_spmv(W, fd.offsets, x))
            plain_ms = device_ms(lambda: flatdia._matvec_plain(W, fd.offsets, x))
            err = check_kernel("flatdia_spmv", name, dtype, y, ref, bound, dict(
                rows=fd.n, diags=fd.n_points, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, copy_bound_ms=copy_bound_ms(n_bytes),
                library_csr_ms=lib_ms, library_error=lib_err,
                gb_s=n_bytes / ms / 1e6))
            r = results["flatdia_spmv"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "config3_level1" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         main_case=f"{name} f32")
            del W, x
    del flat_cases

    # -- slice: V-cycle and AMG-PCG at 1024² ------------------------------------
    n = A_csr.n_rows
    b_np = np.random.default_rng(0).normal(size=n).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    zero = torch.zeros_like(b)
    vtimes, v = wall_ms(lambda: ptt.vcycle(h, zero, b))
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("vcycle output not finite")

    reset_counts()
    t0 = time.perf_counter()
    res = ptt.amg_pcg(None, h, b, tol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches2 = spmv_counts()

    def true_rel_residual(A_host, b_host, x):
        x = np.asarray(x, np.float64).reshape(-1)
        return float(np.linalg.norm(b_host - A_host @ x) / np.linalg.norm(b_host))

    true_res = true_rel_residual(A_sp, b_np, res.x.cpu().numpy())
    t0 = time.perf_counter()
    oh = oracle_setup(A_sp, cfg)
    x_oracle, oracle_iters, _ = oracle_pcg(A_sp, b_np.astype(np.float64), oh,
                                           tol=1e-6)
    oracle_s = time.perf_counter() - t0
    # What float32 storage alone costs: the float64 oracle's own solution,
    # rounded to float32, leaves this true residual (≈ u·‖A‖·‖x‖/‖b‖; u the
    # float32 unit roundoff).  Each float32 CG step can widen the gap between
    # the recursive and the true residual by about as much (Greenbaum's
    # bound), so a float32 solve is held to tol + (iters + 1)·floor.
    f32_floor = true_rel_residual(A_sp, b_np, x_oracle.astype(np.float32))
    res_limit = 1e-6 + (res.iters + 1) * f32_floor
    hist = res.residual_history[:res.iters + 1].cpu().tolist()
    emit("slice", problem=f"poisson2d({nx})", vcycle_ms_median=statistics.median(vtimes),
         vcycle_ms=vtimes, pcg_iters=res.iters, converged=res.converged,
         solve_s=solve_s, residual_history=hist, true_rel_residual=true_res,
         f32_rounding_floor=f32_floor, true_rel_residual_limit=res_limit,
         launches=launches2, oracle_iters=int(oracle_iters),
         oracle_seconds=oracle_s)
    if not res.converged:
        raise AssertionError("amg_pcg did not converge to 1e-6")
    if not true_res <= res_limit:
        raise AssertionError(f"true relative residual {true_res} > {res_limit}")
    if abs(res.iters - int(oracle_iters)) > 1:
        raise AssertionError(f"PCG took {res.iters} iterations, the float64 "
                             f"oracle {oracle_iters}")
    if min(launches2.values()) <= 0:
        raise AssertionError(f"the config #2 solve skipped a kernel: {launches2}")

    # -- mp_rs: config #2 to a true 1e-8, float64 CG over the float32 cycle -----
    def mp_solve(hh, b_host, A_exact, label, target, need, oracle=None,
                 A_applied=None, **extra):
        """amg_pcg_mp to 1e-8 with its preconditioner's kernel launches; held
        to the target within 2 (and the oracle within 2), and to a float64
        true residual ≤ 2e-8 against the matrix the solve applies (A_exact
        unless A_applied, its float32 rounding, is given)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        reset_counts()
        t0 = time.perf_counter()
        r = ptt.amg_pcg_mp(None, hh, b_host, tol=1e-8, maxiter=100)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = spmv_counts()
        x = r.x.cpu().numpy()
        true = true_rel_residual(A_exact, b_host, x)
        applied = true if A_applied is None else true_rel_residual(A_applied, b_host, x)
        emit(label, pcg_iters=r.iters, converged=r.converged, target_iters=target,
             oracle_iters=oracle, solve_s=secs, x_dtype=str(r.x.dtype),
             residual_history=r.residual_history[:r.iters + 1].cpu().tolist(),
             true_rel_residual=true, true_rel_residual_applied_matrix=applied,
             launches=counts, fine_format=fmt(hh.levels[0].A),
             held_before_gb=held_gb,
             peak_device_gb_solve=torch.cuda.max_memory_allocated() / 1e9, **extra)
        if not r.converged:
            raise AssertionError(f"{label}: amg_pcg_mp did not reach 1e-8")
        if abs(r.iters - target) > 2 or (oracle is not None and abs(r.iters - oracle) > 2):
            raise AssertionError(f"{label}: {r.iters} iterations, target {target}, "
                                 f"oracle {oracle}")
        if not applied <= 2e-8:
            raise AssertionError(f"{label}: true relative residual {applied} > 2e-8")
        if min(counts[k] for k in need) <= 0:
            raise AssertionError(f"{label}: the preconditioner skipped a kernel: {counts}")
        return r, counts

    _, oracle8_iters, _ = oracle_pcg(A_sp, b_np.astype(np.float64), oh, tol=1e-8)
    _, launches_mp2 = mp_solve(h, b_np, A_sp, "mp_rs", MP_ITERS["config2"],
                               ("twell_spmv", "flatdia_spmv"), oracle=int(oracle8_iters),
                               problem=f"poisson2d({nx})")
    oracle_rows = [int(l.A.shape[0]) for l in oh.levels]
    del oh, x_oracle

    # C1: each configuration's counts beside the JAX package's, printed last
    c1 = {}

    def bf16_coarse_iters(hh, A0, b_):
        """PCG iterations with the coarse solve's M⁻¹ @ b in bfloat16.  The
        JAX package's counts were taken on a TPU, where an f32 matmul runs
        one bfloat16 pass by default, and its coarse solve is one M⁻¹ @ b."""
        hb = Hierarchy(hh.levels, hh.coarse_inv.bfloat16(), hh.config)
        return ptt.amg_pcg(A0, hb, b_, tol=1e-6, maxiter=100).iters

    # -- slice3d: config #3 V-cycle and AMG-PCG at 128³ --------------------------
    A3_sp = poisson3d(n3).to_csr().to_scipy()
    b3_np = np.random.default_rng(0).normal(size=n3 ** 3).astype(np.float32)
    slice3 = {}
    for backend in ("mixed", "pallas"):
        hb = ptt.with_spmv_backend(h3, backend)
        b3 = torch.from_numpy(b3_np).to(dev).reshape(hb.grid_dims)
        zero3 = torch.zeros_like(b3)
        vt, v3 = wall_ms(lambda: ptt.vcycle(hb, zero3, b3))
        if not bool(torch.isfinite(v3).all()):
            raise AssertionError(f"{backend} vcycle output not finite")
        reset_counts()
        t0 = time.perf_counter()
        r3 = ptt.amg_pcg(hb.levels[0].A, hb, b3, tol=1e-6, maxiter=100)
        torch.cuda.synchronize()
        s3 = time.perf_counter() - t0
        launches3 = spmv_counts()
        true3 = true_rel_residual(A3_sp, b3_np, r3.x.cpu().numpy())
        slice3[backend] = dict(launches=launches3, iters=r3.iters)
        emit("slice3d", problem=f"poisson_stencil(({n3},)*3)", backend=backend,
             formats=[fmt(l.A) for l in hb.levels],
             vcycle_ms_median=statistics.median(vt), vcycle_ms=vt,
             pcg_iters=r3.iters, converged=r3.converged, solve_s=s3,
             residual_history=r3.residual_history[:r3.iters + 1].cpu().tolist(),
             true_rel_residual=true3, launches=launches3,
             jax_package_iters=CONFIG3_ITERS)
        if not r3.converged:
            raise AssertionError(f"config #3 ({backend}) did not converge to 1e-6")
        if abs(r3.iters - CONFIG3_ITERS) > 1:
            raise AssertionError(f"config #3 ({backend}) took {r3.iters} "
                                 f"iterations, the JAX package {CONFIG3_ITERS}")
        if not true3 <= 1e-5:
            raise AssertionError(f"config #3 true relative residual {true3} > 1e-5")
        if launches3["flatdia_spmv"] <= 0:
            raise AssertionError(f"the config #3 ({backend}) solve launched no B2")
    hm3 = ptt.with_spmv_backend(h3, "mixed")
    c1["config3_128^3"] = dict(
        pcg_iters=slice3["mixed"]["iters"], jax_package_iters=CONFIG3_ITERS,
        rows=rows3, complexity=h3.complexity(),
        pcg_iters_bf16_coarse_solve=bf16_coarse_iters(
            hm3, hm3.levels[0].A,
            torch.from_numpy(b3_np).to(dev).reshape(hm3.grid_dims)))
    del hm3

    # -- mp_sa3d: config #3 to a true 1e-8 ("mixed") -------------------------------
    hm3 = ptt.with_spmv_backend(h3, "mixed")
    _, launches_mp3 = mp_solve(hm3, b3_np, A3_sp, "mp_sa3d", MP_ITERS["config3"],
                               ("flatdia_spmv",), problem=f"poisson_stencil(({n3},)*3)",
                               backend="mixed")

    # -- bf16: the float32 fine operator with a bfloat16 hierarchy ---------------
    def bf16_solve(h32, b_dev, b_host, A_exact, label, target, limit):
        """amg_pcg to 1e-6 on h32's float32 fine operator, preconditioned by
        h32 cast to bfloat16; the V-cycle in both precisions."""
        h16 = cast_hierarchy(h32, torch.bfloat16)
        value_dtypes = sorted({str(t.dtype) for l in h16.levels
                               for t in tensors([l.A, l.P, l.R, l.d_inv])
                               if t.is_floating_point()})
        zero_ = torch.zeros_like(b_dev)
        vt16, v16 = wall_ms(lambda: ptt.vcycle(h16, zero_, b_dev))
        vt32, _ = wall_ms(lambda: ptt.vcycle(h32, zero_, b_dev))
        reset_counts()
        ptt.vcycle(h16, zero_, b_dev)
        torch.cuda.synchronize()
        per_cycle = spmv_counts()
        reset_counts()
        t0 = time.perf_counter()
        r = ptt.amg_pcg(h32.levels[0].A, h16, b_dev, tol=1e-6, maxiter=100)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = spmv_counts()
        true = true_rel_residual(A_exact, b_host, r.x.cpu().numpy())
        emit("bf16", problem=label, pcg_iters=r.iters, converged=r.converged,
             target_iters=target, solve_s=secs, true_rel_residual=true,
             true_rel_residual_limit=limit, vcycle_ms_bf16_median=statistics.median(vt16),
             vcycle_ms_f32_median=statistics.median(vt32), vcycle_ms_bf16=vt16,
             vcycle_ms_f32=vt32, bf16_launches_per_vcycle=per_cycle,
             launches=counts, level_value_dtypes=value_dtypes,
             vcycle_dtype=str(v16.dtype), coarse_inv_dtype=str(h16.coarse_inv.dtype))
        if not r.converged or abs(r.iters - target) > 2:
            raise AssertionError(f"bf16 {label}: {r.iters} iterations (converged "
                                 f"{r.converged}), target {target}")
        if not true <= limit:
            raise AssertionError(f"bf16 {label}: true residual {true} > {limit}")
        if (value_dtypes != ["torch.bfloat16"] or v16.dtype != torch.float32
                or h16.coarse_inv.dtype != torch.float32):
            raise AssertionError(f"bf16 {label}: level dtypes {value_dtypes}, cycle "
                                 f"{v16.dtype}, coarse {h16.coarse_inv.dtype}")
        if sum(per_cycle.values()) <= 0:
            raise AssertionError(f"bf16 {label}: the bfloat16 V-cycle launched no "
                                 f"kernel: {per_cycle}")
        del h16
        return per_cycle

    b3g = torch.from_numpy(b3_np).to(dev).reshape(hm3.grid_dims)
    bf16_cycle3 = bf16_solve(hm3, b3g, b3_np, A3_sp, f"poisson_stencil(({n3},)*3) mixed",
                             BF16_ITERS_CONFIG3, 5e-6)
    bf16_cycle2 = bf16_solve(h, b, b_np, A_sp, f"poisson2d({nx})", res.iters,
                             1e-6 + (res.iters + 1) * f32_floor)
    if bf16_cycle2["twell_spmv"] <= 0 or bf16_cycle2["flatdia_spmv"] <= 0:
        raise AssertionError(f"config #2 bf16 V-cycle skipped a kernel: {bf16_cycle2}")
    del hm3, b3g

    # -- setup_dist3d: config #3 split into 4 parts on the card -----------------
    cfg3_async = dataclasses.replace(cfg3, halo_mode="pallas_async")
    dims3 = (n3,) * 3
    mesh4 = ptt.make_row_mesh(4)

    def dist_setup(dims, mesh, label):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = dict(ordered_sum.LAUNCHES)
        power = {}
        with record_dot_shapes(label), power_launches(power):
            t0 = time.perf_counter()
            A_d, true_dims = ptt.poisson_stencil_sharded(dims, mesh, cfg3_async)
            hd = ptt.sharded_device_setup(A_d, cfg3_async, true_dims=true_dims)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        ordered_launches = {k: v - before[k] for k, v in ordered_sum.LAUNCHES.items()}
        # the sharded power iterations: one ordered_stencil_matvec a card an
        # iteration (all parts on one card), no ordered_fma
        want_power = power["calls"] * cfg3_async.lambda_power_iters
        if (power["sharded_power"]["ordered_stencil_matvec"] != want_power
                or power["sharded_power"]["ordered_fma"] != 0):
            raise AssertionError(f"{label}: sharded power iterations launched "
                                 f"{power['sharded_power']}, want {want_power} "
                                 "ordered_stencil_matvec")
        levels = [{"rows": l.n, "padded_rows": l.A.n_rows, "format": fmt(l.A),
                   "points": l.A.n_points, "parts": getattr(getattr(l.A, "mesh", None),
                                                             "size", None),
                   "m0": getattr(l.A, "m0", None), "halo": getattr(l.A, "halo", None),
                   "lam_max": l.lam_max} for l in hd.levels]
        info = dict(problem=f"poisson_stencil_sharded({dims}, make_row_mesh({mesh.size}))",
                    seconds=secs, n_levels=hd.n_levels, levels=levels,
                    padded_dims=list(A_d.dims), setup_stats=hd.setup_stats,
                    ordered_sum_launches=ordered_launches,
                    sharded_power_launches=power["sharded_power"],
                    sharded_power_calls=power["calls"], complexity=hd.complexity(),
                    peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        emit(label, **info)
        return hd, info

    hd3, info_d3 = dist_setup(dims3, mesh4, "setup_dist3d")
    hold_jax_record(hd3, dims3, "parts4", "setup_dist3d")
    rows_d3 = [lv["rows"] for lv in info_d3["levels"]]
    if rows_d3 != CONFIG3_ROWS:
        raise AssertionError(f"config #3 in 4 parts: levels {rows_d3}, want {CONFIG3_ROWS}")
    if hd3.setup_stats["sharded_levels"] != 2:
        raise AssertionError(f"config #3 in 4 parts sharded {hd3.setup_stats} levels, want 2")
    for lv in (0, 1):
        ordered_stencil_case(kctx, f"config3_4parts_level{lv}", hd3.levels[lv].A,
                             hd3.levels[lv].d_inv, g_os)

    # -- kernel B8: halo_stencil -----------------------------------------------------
    def random_parts(A_s, gen):
        """A_s with every weight scaled by a factor in [0.5, 2)."""
        return ShardedStencil([W * (0.5 + 1.5 * torch.rand(W.shape, generator=gen,
                                                           device=dev))
                               for W in A_s.weights], A_s.offsets, A_s.dims, A_s.mesh)

    def halo_bytes(A_s):
        """W, x and y of every part, each read or written once (the halo
        planes are planes of x)."""
        return 4 * (A_s.n_points + 2) * A_s.n

    def entry_bytes(A_s):
        """(interior, boundary) entries' bytes over every part of the route
        on one card, counted in (n1, n2) planes: the interior reads the
        weights of its in-slab terms and x and writes y; the boundary, on
        each side of a part that has a neighbour, reads the planes of its
        landing buffer and of W that the halo terms read, and reads and
        writes the planes of y they land on (phalo_async.boundary_planes)."""
        plane = int(np.prod(A_s.dims[1:]))
        S, m0, h = A_s.mesh.size, A_s.m0, A_s.halo
        o0s = [o[0] for o in A_s.offsets]
        reach = (max([-o for o in o0s if o < 0], default=0),
                 max([o for o in o0s if o > 0], default=0))
        interior = S * (sum(max(m0 - abs(o), 0) for o in o0s) + 2 * m0)
        boundary = 0
        for p in range(S):
            sides = (p > 0, p < S - 1)
            lo, hi = phalo_async.boundary_planes(*(1 if s else None for s in sides),
                                                 reach, m0)
            boundary += 2 * (lo + hi)
            for o in o0s:
                if o and sides[o > 0]:
                    boundary += min(abs(o), m0)   # W planes of this term
            if sides[0]:   # left landing planes h + o + i0 for i0 < -o
                boundary += len({h + o + i for o in o0s if o < 0
                                 for i in range(min(-o, m0))})
            if sides[1]:   # right landing planes i0 + o - m0 for i0 >= m0 - o
                boundary += len({i + o - m0 for o in o0s if o > 0
                                 for i in range(max(m0 - o, 0), m0)})
        return 4 * plane * interior, 4 * plane * boundary

    def global_csr(A_s):
        return flat_csr(FlatDIA.from_stencil(
            Stencil(A_s.global_weights(), A_s.offsets, A_s.dims)))

    def zero_halo_csr(A_s):
        """The parts' zero-halo operator as one CSR: the global operator with
        the couplings across parts dropped (the interior entry's function)."""
        Wg = A_s.global_weights()
        i0 = torch.arange(A_s.dims[0], device=dev) % A_s.m0
        for d, off in enumerate(A_s.offsets):
            if off[0]:
                Wg[d, (i0 + off[0] < 0) | (i0 + off[0] >= A_s.m0)] = 0
        return flat_csr(FlatDIA.from_stencil(Stencil(Wg, A_s.offsets, A_s.dims)))

    def bits_equal(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    def b8_launches(fn):
        """B8's launches by entry during one fn() call."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return halo_counts(), out

    ONE_CARD = {"halo_stencil_matvec": 1, "halo_stencil_interior": 0,
                "halo_stencil_boundary": 0}
    NO_B8 = dict.fromkeys(ONE_CARD, 0)
    # the exchange route on one card: one interior and one boundary launch
    ROUTE = {"halo_stencil_matvec": 0, "halo_stencil_interior": 1,
             "halo_stencil_boundary": 1}

    reach2 = poisson_stencil(dims3)
    reach2 = reach2.matmul(reach2)
    b8_cases = {
        "config3_level0_4parts": random_parts(hd3.levels[0].A, g),
        "config3_level1_4parts": hd3.levels[1].A,
        "reach2_128^3_4parts": ShardedStencil.from_stencil(reach2, mesh4),
        "m0_le_h_4parts": ShardedStencil.from_stencil(
            poisson_stencil((8, 24)).matmul(poisson_stencil((8, 24))), mesh4),
    }
    del reach2
    for name in ONE_CARD:
        results[name] = {"max_abs_err": 0.0}
    for name, A_s in b8_cases.items():
        A_k = A_s.with_halo_mode("pallas_async")
        A_p = A_s.with_halo_mode("xla")
        A_abs = ShardedStencil([W.abs() for W in A_s.weights], A_s.offsets, A_s.dims,
                               A_s.mesh)
        x = PGrid.from_global(torch.randn(A_s.dims, generator=g, device=dev), A_s.mesh)
        S, hw = A_s.mesh.size, A_s.halo
        launched, y = b8_launches(lambda: A_k.matvec(x))
        ref = A_p.matvec(x)
        bound = ATOL + RTOL * A_abs.matvec(PGrid([p.abs() for p in x.parts], x.mesh))
        want_launch = A_s.m0 > hw
        if launched != (ONE_CARD if want_launch else NO_B8):
            raise AssertionError(f"halo_stencil {name}: launches {launched} with "
                                 f"m0 {A_s.m0}, h {hw}")
        y_g, ref_g = y.to_global(), ref.to_global()
        bit_equal = bits_equal(y_g, ref_g)
        n_bytes = halo_bytes(A_s)
        b_ms, b_by = bound_ms(n_bytes, 2 * A_s.n_points * A_s.n)
        csr = global_csr(A_s)
        lib_ms, lib_err = library_ms(csr, x.to_global().reshape(-1))
        del csr
        ms = device_ms(lambda: A_k.matvec(x))
        plain_ms = device_ms(lambda: A_p.matvec(x), reps=2, samples=5)
        bit_equal_20 = all(bits_equal(A_k.matvec(x).to_global(), y_g) for _ in range(20))
        copy_extra = {}
        if want_launch:
            # the exchange route, run on one card (the halos are views of the
            # neighbours' slabs): the same sums in one interior and one
            # boundary launch
            def route_fn():
                return phalo_async.matvec_copy_streams(A_s, x)

            copy_launched, yc = b8_launches(route_fn)
            yc_g = yc.to_global()
            copy_equal = bits_equal(yc_g, ref_g)
            copy_equal_one = bits_equal(yc_g, y_g)
            copy_equal_20 = all(bits_equal(route_fn().to_global(), yc_g)
                                for _ in range(20))
            copy_ms = device_ms(route_fn)
            copy_extra = dict(copy_path_launches=copy_launched,
                              copy_path_bit_equal=copy_equal,
                              copy_path_bit_equal_to_one_launch=copy_equal_one,
                              copy_path_bit_equal_20_calls=copy_equal_20,
                              copy_path_ms=copy_ms,
                              copy_path_host_ms=host_ms(route_fn),
                              copy_path_below_library_csr=(
                                  lib_ms is not None and copy_ms < lib_ms),
                              copy_path_max_abs_err=float((yc_g - ref_g).abs().max()))
            if copy_launched != ROUTE or not (copy_equal and copy_equal_one
                                              and copy_equal_20):
                raise AssertionError(f"halo_stencil {name}: the exchange route "
                                     f"launched {copy_launched}, bit-equal to the "
                                     f"plain path {copy_equal}, to the one-launch "
                                     f"entry {copy_equal_one}, over 20 calls "
                                     f"{copy_equal_20}")
            del yc, yc_g
        err = check_kernel("halo_stencil_matvec", name, torch.float32, y_g, ref_g,
                           bound.to_global(), dict(
                               padded_dims=list(A_s.dims), parts=S, m0=A_s.m0,
                               halo=hw, points=A_s.n_points, launches=launched,
                               bit_equal_to_plain=bit_equal,
                               bit_equal_20_calls=bit_equal_20, ms=ms,
                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                               share_of_bound=b_ms / ms,
                               copy_bound_ms=copy_bound_ms(n_bytes),
                               library_csr_ms=lib_ms, library_error=lib_err,
                               gb_s=n_bytes / ms / 1e6, **copy_extra))
        if not (bit_equal and bit_equal_20):
            raise AssertionError(f"halo_stencil {name}: not bit-equal to the plain "
                                 f"version ({bit_equal}) or over 20 calls "
                                 f"({bit_equal_20})")
        r = results["halo_stencil_matvec"]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if want_launch:
            r[f"ms_{name}"] = ms
        if name == "config3_level0_4parts":
            # launches and the device's share of one matvec on each path
            prof_b8 = profile_cycles(lambda: A_k.matvec(x), n=20)
            emit("kernel_b8_profile", case=name, path="one_launch",
                 b8_launches_per_matvec=launched, event_window_ms=ms, **prof_b8)
            prof_copy = profile_cycles(lambda: phalo_async.matvec_copy_streams(A_s, x),
                                       n=20)
            emit("kernel_b8_profile", case=name, path="copy_streams",
                 b8_launches_per_matvec=copy_extra["copy_path_launches"],
                 event_window_ms=copy_extra["copy_path_ms"], **prof_copy)
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     share_of_bound=b_ms / ms,
                     copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                     main_case=f"{name} f32",
                     device_ms_per_matvec=prof_b8["device_ms_per_call"],
                     copy_path_ms=copy_extra["copy_path_ms"],
                     copy_path_host_ms=copy_extra["copy_path_host_ms"])
            # the exchange route's two entries, each one call over every part,
            # each held bit-equal to its plain version over the parts
            offs = A_s.offsets
            lands = exchange.halos(x.parts, hw)
            ys0 = phalo_async.stencil_interior(A_s, x)
            ys_p = [interior_plain(W, xl, offs, hw) for W, xl in zip(A_s.weights, x.parts)]
            int_err = max(float((a - b).abs().max()) for a, b in zip(ys0, ys_p))
            int_equal = all(bits_equal(a, b) for a, b in zip(ys0, ys_p))
            phalo_async.stencil_boundary(A_s, ys0, lands)
            for yy, W, (lf, rt) in zip(ys_p, A_s.weights, lands):
                boundary_plain(yy, W, lf, rt, offs, hw)
            bnd_err = max(float((a - b).abs().max()) for a, b in zip(ys0, ys_p))
            bnd_equal = all(bits_equal(a, b) for a, b in zip(ys0, ys_p))
            # the interior's yardstick: cuSPARSE CSR of the zero-halo operator
            zh = zero_halo_csr(A_s)
            xg = x.to_global().reshape(-1)
            zh_ms, zh_err = library_ms(zh, xg)
            zh_diff = float(((zh @ xg).reshape(A_s.dims)
                             - PGrid(phalo_async.stencil_interior(A_s, x),
                                     A_s.mesh).to_global()).abs().max())
            del zh, xg
            entries = {
                "halo_stencil_interior": (
                    lambda: phalo_async.stencil_interior(A_s, x),
                    lambda: [interior_plain(W, xl, offs, hw)
                             for W, xl in zip(A_s.weights, x.parts)],
                    int_err, int_equal, zh_ms, zh_err),
                "halo_stencil_boundary": (
                    # in place on ys0, a scratch copy: each call adds the
                    # halo terms again
                    lambda: phalo_async.stencil_boundary(A_s, ys0, lands),
                    lambda: [boundary_plain(yy, W, lf, rt, offs, hw)
                             for yy, W, (lf, rt) in zip(ys_p, A_s.weights, lands)],
                    bnd_err, bnd_equal, None, None),
            }
            for entry, nb in zip(entries, entry_bytes(A_s)):
                fn, plain_fn, e_err, e_equal, e_lib, e_lib_err = entries[entry]
                e_launched, _ = b8_launches(fn)
                e_ms = device_ms(fn)
                e_host = host_ms(fn)
                e_plain = device_ms(plain_fn, reps=2, samples=5)
                eb_ms, eb_by = bound_ms(nb, 0)
                results[entry].update(
                    ms=e_ms, plain_ms=e_plain, bound_ms=eb_ms, bound_by=eb_by,
                    share_of_bound=eb_ms / e_ms, host_ms=e_host,
                    copy_bound_ms=copy_bound_ms(nb), library_ms=e_lib,
                    main_case=f"{name} f32, every part in one call",
                    max_abs_err=e_err)
                emit("kernel", name=entry, case=name, ms=e_ms, plain_ms=e_plain,
                     bound_ms=eb_ms, bound_by=eb_by, share_of_bound=eb_ms / e_ms,
                     host_ms=e_host, library_ms=e_lib, library_error=e_lib_err,
                     library_kind=("cuSPARSE CSR of the zero-halo operator"
                                   if e_lib is not None else None),
                     library_max_abs_diff=(zh_diff if e_lib is not None else None),
                     launches=e_launched, bytes=nb, max_abs_err=e_err,
                     bit_equal_to_plain=e_equal,
                     bit_equal_via_copy_path=copy_extra["copy_path_bit_equal"])
                if e_launched != {**NO_B8, entry: 1} or not e_equal:
                    raise AssertionError(f"{entry} {name}: launches {e_launched}, "
                                         f"bit-equal to its plain version {e_equal}")
            del lands, ys0, ys_p, entries
        del A_k, A_p, A_abs, x, y, ref, bound
    del b8_cases

    # -- slice_dist3d: config #3 in 4 parts, V-cycle and AMG-PCG ----------------------
    b3d = ptt.distribute_grid(b3_np, dims3, hd3, mesh4)
    zero3d = b3d.zeros_like()
    vt_d3, v_d3 = wall_ms(lambda: ptt.vcycle(hd3, zero3d, b3d))
    if not all(bool(torch.isfinite(p).all()) for p in v_d3.parts):
        raise AssertionError("config #3 4-part vcycle output not finite")
    per_cycle_d3, _ = b8_launches(lambda: ptt.vcycle(hd3, zero3d, b3d))
    # 9 matvecs on each of the 2 sharded levels, one launch each
    if per_cycle_d3 != {**NO_B8, "halo_stencil_matvec": 18}:
        raise AssertionError(f"the 4-part V-cycle's B8 launches {per_cycle_d3}, "
                             "want 18 one-card launches")
    dist3 = {}
    for mode in ("pallas_async", "xla"):
        hm = Hierarchy(apply_halo_mode(hd3.levels, mode), hd3.coarse_inv, hd3.config)
        vt_m, _ = wall_ms(lambda: ptt.vcycle(hm, zero3d, b3d))
        reset_counts()
        t0 = time.perf_counter()
        rd = ptt.amg_pcg(None, hm, b3d, tol=1e-6, maxiter=100)
        torch.cuda.synchronize()
        s_d = time.perf_counter() - t0
        counts_d = halo_counts()
        true_d = true_rel_residual(A3_sp, b3_np, ptt.collect_grid(rd.x, dims3))
        dist3[mode] = dict(iters=rd.iters, launches=counts_d,
                           history=rd.residual_history[:rd.iters + 1].cpu().tolist())
        emit("slice_dist3d", problem=info_d3["problem"], halo_mode=mode,
             vcycle_ms_median=statistics.median(vt_m), vcycle_ms=vt_m,
             b8_launches_per_vcycle=per_cycle_d3 if mode == "pallas_async" else None,
             pcg_iters=rd.iters, converged=rd.converged, solve_s=s_d,
             residual_history=rd.residual_history[:rd.iters + 1].cpu().tolist(),
             true_rel_residual=true_d, launches=counts_d,
             single_device_iters=slice3["mixed"]["iters"],
             jax_package_iters=CONFIG3_ITERS)
        if not rd.converged:
            raise AssertionError(f"config #3 in 4 parts ({mode}) did not converge")
        if abs(rd.iters - slice3["mixed"]["iters"]) > 2:
            raise AssertionError(f"config #3 in 4 parts ({mode}) took {rd.iters} "
                                 f"iterations, one device {slice3['mixed']['iters']}")
        if not true_d <= 1e-5:
            raise AssertionError(f"config #3 in 4 parts true residual {true_d} > 1e-5")
        if (counts_d["halo_stencil_matvec"] > 0) != (mode == "pallas_async"):
            raise AssertionError(f"config #3 in 4 parts ({mode}): B8 launches {counts_d}")
        del hm
    c1["config3_128^3_4parts"] = dict(pcg_iters=dist3["pallas_async"]["iters"],
                                      jax_package_iters=CONFIG3_ITERS, rows=rows_d3,
                                      complexity=info_d3["complexity"])
    # the same sums in both modes: the same residual history to the last digit
    if dist3["xla"]["history"] != dist3["pallas_async"]["history"]:
        raise AssertionError(f"halo modes disagree: {dist3}")

    # -- setup_rs: config #2 set up on the card (Ruge–Stüben, device) ----------
    cfg_rs = dataclasses.replace(cfg, on_device_setup=True)

    def spgemm_counts():
        return dict(pspgemm.LAUNCHES)

    def rs_setup(A_host, label, need=ORDERED_SUM_KERNELS):
        """One device RS setup with its launch counts, held to have launched
        B3, B5, B4 and the ordered-sum kernels in ``need``."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        hh = ptt.setup(A_host, cfg_rs)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {**spgemm_counts(), **ordered_sum.LAUNCHES}
        stats = hh.setup_stats
        gc, oc = hh.complexity()
        emit(label, seconds=secs, levels=stats["levels"],
             phase_seconds=stats["seconds"], grid_complexity=gc,
             operator_complexity=oc, launches=counts,
             peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        if min(counts[k] for k in (*spgemm_counts(), *need)) <= 0:
            raise AssertionError(f"{label}: the setup skipped a kernel: {counts}")
        return hh, secs, counts, (gc, oc)

    h_rs, _, launches_rs, cx_rs = rs_setup(A_csr, "setup_rs")
    # the level-0 host draws of that setup (ops/prng.py): the PMIS weights
    # and the power iteration's start vector, copied to the card
    t0 = time.perf_counter()
    device_rs.pmis_weights(A_csr.n_rows, 0, dev)
    device_setup.start_vector((A_csr.n_rows,), torch.float32, dev)
    torch.cuda.synchronize()
    emit("setup_rs_draws", rows=A_csr.n_rows, seconds=time.perf_counter() - t0)
    rows_rs = [l.A.n_rows for l in h_rs.levels]
    emit("setup_rs_vs_jax", rows=rows_rs, grid_complexity=cx_rs[0],
         operator_complexity=cx_rs[1], jax_package_cpu=CONFIG2_JAX_CPU,
         jax_package_tpu=CONFIG2_JAX)
    # the JAX package's hierarchy on its CPU backend: the same rows at every
    # level, the complexities to the digits its run printed
    if (rows_rs != CONFIG2_JAX_CPU["rows"]
            or tuple(round(v, 3) for v in cx_rs) != CONFIG2_JAX_CPU["complexity"]):
        raise AssertionError(f"config #2 device setup rows {rows_rs}, complexities "
                             f"{cx_rs}; the JAX package's {CONFIG2_JAX_CPU}")
    h_rs2, secs2, _, _ = rs_setup(A_csr, "setup_rs_second_run")
    for i, (l1, l2) in enumerate(zip(h_rs.levels, h_rs2.levels)):
        for part in ("cols", "vals", "row_nnz"):
            a, c = getattr(l1.A, part), getattr(l2.A, part)
            if not (a.shape == c.shape and torch.equal(
                    a.view(torch.int32), c.view(torch.int32))):
                raise AssertionError(f"second setup differs at level {i} A.{part}")
    if h_rs.n_levels != h_rs2.n_levels:
        raise AssertionError("second setup has another depth")
    emit("setup_rs_repeat", bit_equal=True, n_levels=h_rs.n_levels,
         second_run_seconds=secs2)
    del h_rs2
    # every row-sum shape of the setup through the ordered-sum kernels and
    # the plain version, bit for bit; LLVM's vectorised order (level 1's
    # weak couplings) timed
    ctx = types.SimpleNamespace(results=results, device_ms=device_ms,
                                bound_ms=bound_ms, copy_bound_ms=copy_bound_ms,
                                emit=emit)
    if not lambda_cpu_check(
            ctx, "config2_device_rs_setup", [l.lam_max for l in h_rs.levels],
            [functools.partial(device_rs._ell_lambda_max, l.A.to("cpu"), l.d_inv.cpu(),
                               cfg_rs.lambda_power_iters, 0) for l in h_rs.levels]):
        raise AssertionError("config #2 device setup: a level's λ_max differs from "
                             "the CPU's")
    _, captured = capture_row_sums(lambda: ptt.setup(A_csr, cfg_rs))
    by_kernel, sums_equal = ordered_sum_check(ctx, captured, "config2_device_rs_setup")
    if not (sums_equal and all(by_kernel.values())):
        raise AssertionError(f"config #2 device setup: ordered-sum kernels bit-equal "
                             f"to their plain version {sums_equal}, inputs by kernel "
                             f"{ {k: len(v) for k, v in by_kernel.items()} }")
    weak = [t for t in by_kernel["ordered_sum_lanes"] if t[0] == "row_sum"]
    name, args = max(weak, key=lambda t: t[1][0].numel())
    time_ordered_sum(ctx, "ordered_sum_lanes", name, args,
                     f"config #2 1024² one-device setup, extended+i's weak couplings "
                     f"{list(args[0].shape)} in LLVM's order lanes={args[2]}")
    # the same schedule over 1,048,576 rows (its bound above one launch)
    big = torch.randn((1 << 20, args[0].shape[1]), generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    time_ordered_sum(ctx, "ordered_sum_lanes", "row_sum", (big, 1, args[2]),
                     f"synthetic {list(big.shape)}, lanes={args[2]}", key="1m_rows")
    # the power iteration's level-0 ELL rows (fused multiply-adds, one chain)
    name, args = max((t for t in by_kernel["ordered_sum_lanes"] if t[0] == "row_dot"),
                     key=lambda t: t[1][0].numel())
    time_ordered_sum(ctx, "ordered_sum_lanes", name, args,
                     f"config #2 1024² power iteration, the largest ELL rows "
                     f"{list(args[0].shape)}, fma lanes={list(args[2])}",
                     key="ell_fma")
    # the power iteration's norm at level 0: 1,048,576 squares, two launches
    name, args = max((t for t in by_kernel["ordered_sum_windows"] if t[0] == "row_sum"),
                     key=lambda t: t[1][0].shape[-1])
    time_ordered_sum(ctx, "ordered_sum_windows", name, args,
                     f"config #2 1024² power iteration, level 0's norm over "
                     f"{list(args[0].shape)} (one span launch)", key="norm_1m")
    del captured, by_kernel, big, args

    # -- kernels B3, B5, B4: spgemm against the plain versions -----------------
    def random_ell(n_rows, n_cols, width, zero_frac=0.0, empty_frac=0.0):
        nnz = rng.integers(0, width + 1, size=n_rows)
        nnz[rng.random(n_rows) < empty_frac] = 0
        cols = rng.integers(0, n_cols, size=(n_rows, width)).astype(np.int32)
        vals = rng.normal(size=(n_rows, width)).astype(np.float32)
        vals[rng.random((n_rows, width)) < zero_frac] = 0.0
        pad = np.arange(width)[None, :] >= nnz[:, None]
        cols[pad], vals[pad] = 0, 0.0
        return ELL(torch.from_numpy(cols), torch.from_numpy(vals),
                   torch.from_numpy(nnz.astype(np.int32)), (n_rows, n_cols)).to(dev)

    def ell_csr(M):
        m = M.mask()
        rows = torch.arange(M.n_rows, device=dev)[:, None].expand_as(M.cols)
        coo = torch.sparse_coo_tensor(
            torch.stack([rows[m], M.cols[m].long()]), M.vals[m], M.shape)
        return coo.coalesce().to_sparse_csr()

    # the config #2 cases as the one-device setup runs them (ell_spgemm):
    # B3, its candidates reordered k-major, B5 and B4 on that order, each
    # row then sorted (R·A; A_c = R·A·P is sorted by ell_prune)
    R0, A0, P0 = h_rs.levels[0].R, h_rs.levels[0].A, h_rs.levels[0].P
    RA0 = ell_spgemm(R0, A0)
    spgemm_cases = {
        "config2_L0_RA": (R0, A0, None),
        "config2_L0_RAP": (RA0, P0, None),
        "config2_L1_RA": (h_rs.levels[1].R, h_rs.levels[1].A, None),
        "config2_L2_RA": (h_rs.levels[2].R, h_rs.levels[2].A, None),
        "config2_L3_RA": (h_rs.levels[3].R, h_rs.levels[3].A, None),
        "random_rect_200000x150000": (random_ell(200_000, 150_000, 8),
                                      random_ell(150_000, 120_000, 6), None),
        "zeros_empty_overflow": (random_ell(50_000, 3_000, 12, 0.2, 0.1),
                                 random_ell(3_000, 2_000, 9, 0.2, 0.1), 40),
        # K 5120: B4's and B5's in-place tables in global scratch, B5's
        # count-only table in shared memory
        "wide_K5120": (random_ell(400, 3_000, 64), random_ell(3_000, 2_000, 80), None),
    }
    slow = dict(reps=1, samples=3, warmup=1)  # the plain versions
    for name in ("spgemm_expand", "spgemm_dedup", "spgemm_dedup_compact"):
        results[name] = {"max_abs_err": 0.0}
    for case, (A, B, cap) in spgemm_cases.items():
        sent = B.n_cols
        R_, K_, Rb = A.n_rows, A.width * B.width, B.n_rows
        # B3's tile: rows, m and k a tile, m a work item, B's load width,
        # staging bytes a buffer, and its one store path
        plan3 = {**gspgemm.expand_plan(A.width, B.width), "store": "st.global.cs"}
        cc, cv = gspgemm.gather_candidates(A, B)
        pc, pv = gspgemm._gather_candidates_plain(A, B)
        torch.cuda.synchronize()
        if not (torch.equal(cc, pc) and torch.equal(cv, pv)):
            raise AssertionError(f"spgemm_expand {case}: kernel disagrees with "
                                 "the plain version")
        setup_case = case.startswith("config2_")
        esc = {}
        if setup_case:
            esc["k_major_ms"] = device_ms(
                lambda: gspgemm.k_major(cc, cv, A.width, B.width))
            cc, cv = gspgemm.k_major(cc, cv, A.width, B.width)
        n_valid = (cc != sent).sum(1).double()
        live = float(n_valid.sum())
        # the all-pairs merge's work, beside the hashed merge's yardstick of
        # one insert per live candidate
        compares = float((n_valid * (n_valid - 1) / 2).sum())
        counts = pspgemm.dedup(cc, cv, sent, counts_only=True)
        full = pspgemm.dedup(cc, cv, sent)
        ref5 = pspgemm._dedup_plain(cc, cv, sent)
        bound5 = SPGEMM_ATOL + SPGEMM_RTOL * pspgemm._dedup_plain(cc, cv.abs(), sent)[1]
        w = cap or max(int(ref5[2].max()), 1)
        comp = gspgemm.dedup_compact(cc, cv, sent, w)
        # B4 against B5's in-place merge compacted in slot order: bit for bit
        b5c = gspgemm.compact_merged(full[0], full[1], sent, w)
        b4_is_b5 = (torch.equal(comp[0], b5c[0]) and torch.equal(comp[2], b5c[2])
                    and torch.equal(comp[1].view(torch.int32), b5c[1].view(torch.int32)))
        ref4 = gspgemm._dedup_compact_plain(cc, cv, sent, w)
        bound4 = SPGEMM_ATOL + SPGEMM_RTOL * gspgemm._dedup_compact_plain(
            cc, cv.abs(), sent, w)[1]
        torch.cuda.synchronize()
        err5 = float((full[1] - ref5[1]).abs().max())
        err4 = float((comp[1] - ref4[1]).abs().max())
        # the merges sum each column in slot order, as the plain versions
        # do: values bit-equal, and within the bound too
        ok = (torch.equal(counts, ref5[2]) and torch.equal(full[0], ref5[0])
              and torch.equal(full[2], ref5[2]) and torch.equal(full[1], ref5[1])
              and bool(((full[1] - ref5[1]).abs() <= bound5).all())
              and torch.equal(comp[0], ref4[0]) and torch.equal(comp[2], ref4[2])
              and torch.equal(comp[1], ref4[1])
              and bool(((comp[1] - ref4[1]).abs() <= bound4).all()) and b4_is_b5)
        over = int((ref5[2] > w).sum())
        timing = {
            "spgemm_expand": (
                device_ms(lambda: gspgemm.gather_candidates(A, B)),
                device_ms(lambda: gspgemm._gather_candidates_plain(A, B), **slow),
                # A's planes read once, B's rows once (they stay in the
                # 50 MB L2 however often A's entries point at them), the
                # candidates written once
                bound_ms(R_ * A.width * 8 + R_ * 4 + Rb * B.width * 8 + Rb * 4
                         + R_ * K_ * 8, R_ * K_), 0.0),
            "spgemm_dedup": (
                device_ms(lambda: pspgemm.dedup(cc, cv, sent, counts_only=True)),
                device_ms(lambda: pspgemm._dedup_plain(cc, cv, sent, True), **slow),
                # count-only: reads the columns, writes the counts, one
                # insert per live candidate
                bound_ms(R_ * K_ * 4 + R_ * 4, live), err5),
            "spgemm_dedup_compact": (
                device_ms(lambda: gspgemm.dedup_compact(cc, cv, sent, w)),
                device_ms(lambda: gspgemm._dedup_compact_plain(cc, cv, sent, w),
                          **slow),
                # one hash insert or add per live candidate
                bound_ms(R_ * K_ * 8 + R_ * w * 8 + R_ * 4, live), err4),
        }
        full_ms = device_ms(lambda: pspgemm.dedup(cc, cv, sent))
        full_bound_ms = bound_ms(2 * R_ * K_ * 8 + R_ * 4, live)[0]
        if setup_case:
            sort = case != "config2_L0_RAP"
            if sort:
                esc["sort_ms"] = device_ms(
                    lambda: gspgemm.sort_rows(comp[0], comp[1], comp[2], sent))
            product_ms = device_ms(lambda: ell_spgemm(A, B, out_width=w, sort=sort))
        else:
            product_ms = device_ms(lambda: gspgemm.gather_spgemm(A, B, out_width=w,
                                                                 strict=False))
        lib_ms, lib_err = None, None
        if cap is None:
            a_csr, b_csr = ell_csr(A), ell_csr(B)
            try:
                lib_ms = device_ms(lambda: a_csr @ b_csr, **slow)
            except RuntimeError as e:  # the yardstick only; never on the path
                lib_err = f"{e}"[:200]
            del a_csr, b_csr
        for name, (ms, p_ms, (b_ms, b_by), err) in timing.items():
            emit("kernel", name=name, case=case, rows=R_, K=K_, out_width=w,
                 rows_over_width=over, ms=ms, plain_ms=p_ms, bound_ms=b_ms,
                 bound_by=b_by, share_of_bound=b_ms / ms, live_candidates=live,
                 compares=compares, max_abs_err=err, ok=ok,
                 tolerance=f"cols, counts and values bit-equal (and |dv| <= "
                           f"{SPGEMM_ATOL} + {SPGEMM_RTOL}*sum|merged|)",
                 **({"full_mode_ms": full_ms, "full_mode_bound_ms": full_bound_ms}
                    if name == "spgemm_dedup" else {}),
                 **({"bit_equal_to_b5_compacted": b4_is_b5}
                    if name == "spgemm_dedup_compact" else {}),
                 **({"plan": plan3} if name == "spgemm_expand" else {}))
            r = results[name]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if case == "config2_L0_RAP":
                r.update(ms=ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=None, library_ms=None,
                         product_ms=product_ms, product_library_ms=lib_ms,
                         main_case=case + (" (B3's m-major output)"
                                           if name == "spgemm_expand" else
                                           " (k-major candidates, as ell_spgemm "
                                           "gives them)"),
                         **esc,
                         **({"full_mode_ms": full_ms} if name == "spgemm_dedup" else {}))
        emit("spgemm_product", case=case, rows=R_, K=K_, out_width=w,
             product=("ell_spgemm (k-major, B5, B4, sorted rows)" if setup_case
                      else "gather_spgemm (m-major, B5, B4)"),
             product_ms=product_ms, library_csr_spgemm_ms=lib_ms,
             library_error=lib_err, candidate_order="k-major" if setup_case
             else "m-major", **esc)
        if not ok:
            raise AssertionError(f"spgemm kernels {case}: a kernel disagrees "
                                 f"with its plain version (|dv| {err5}, {err4}) or "
                                 f"B4 with B5 compacted ({b4_is_b5})")
        del cc, cv, pc, pv, full, ref5, comp, ref4, bound4, bound5, b5c
    del spgemm_cases, RA0

    # -- kernel B9's route: pallas_spgemm on B3 + B5 + B4 -----------------------------
    def row_sets(C):
        """Per row, the (column, value) pairs in column order: columns past
        row_nnz become SENT and sort last."""
        live = torch.arange(C.width, device=dev)[None, :] < C.row_nnz[:, None]
        cols = torch.where(live, C.cols, 2**31 - 1)
        order = torch.argsort(cols, dim=1, stable=True)
        return (torch.gather(cols, 1, order),
                torch.gather(torch.where(live, C.vals, 0.0), 1, order))

    A_l0 = h_rs.levels[0].A
    b9_cases = {
        "config2_L0_AA": (A_l0, A_l0),
        "random_rect_200000x150000": (random_ell(200_000, 150_000, 8),
                                      random_ell(150_000, 120_000, 6)),
        "explicit_zeros": (random_ell(50_000, 3_000, 12, 0.3, 0.1),
                           random_ell(3_000, 2_000, 9, 0.3, 0.1)),
    }
    results["pallas_spgemm"] = {"max_abs_err": 0.0}
    for case, (A, B) in b9_cases.items():
        plan = ptt.PallasSpgemmPlan.from_ell(A)
        reset_counts()
        C = ptt.pallas_spgemm(A, B, plan=plan)
        torch.cuda.synchronize()
        route_launches = spgemm_counts()
        Cp = gspgemm.plain_spgemm(A, B)
        A_abs = ELL(A.cols, A.vals.abs(), A.row_nnz, A.shape)
        bound9 = gspgemm.plain_spgemm(A_abs, ELL(B.cols, B.vals.abs(), B.row_nnz,
                                                 B.shape), out_width=C.width)
        kc, kv = row_sets(C)
        pc_, pv_ = row_sets(Cp)
        _, bv_ = row_sets(bound9)
        same_sets = (C.width == Cp.width and torch.equal(C.row_nnz, Cp.row_nnz)
                     and torch.equal(kc, pc_))
        err9 = float((kv - pv_).abs().max()) if kv.numel() else 0.0
        ok9 = same_sets and bool(((kv - pv_).abs()
                                  <= SPGEMM_ATOL + SPGEMM_RTOL * bv_).all())
        w9 = C.width
        R_, K_ = A.n_rows, A.width * B.width
        ms9 = device_ms(lambda: ptt.pallas_spgemm(A, B, out_width=w9, plan=plan))
        auto_ms9 = device_ms(lambda: ptt.pallas_spgemm(A, B, plan=plan), reps=3,
                             samples=9)
        plain_ms9 = device_ms(lambda: gspgemm.plain_spgemm(A, B, out_width=w9,
                                                           strict=False), **slow)
        n_live = float(A.row_nnz.sum())
        b_ms9, b_by9 = bound_ms(
            A.n_rows * (A.width * 8 + 4) + B.n_rows * (B.width * 8 + 4)
            + C.n_rows * (w9 * 8 + 4),
            float((B.row_nnz[A.cols.long()] * (torch.arange(A.width, device=dev)[None, :]
                                              < A.row_nnz[:, None])).sum()))
        a_csr, b_csr = ell_csr(A), ell_csr(B)
        lib_ms9, lib_err9 = None, None
        try:
            lib_ms9 = device_ms(lambda: a_csr @ b_csr, **slow)
        except RuntimeError as e:  # the yardstick only; never on the path
            lib_err9 = f"{e}"[:200]
        del a_csr, b_csr
        emit("kernel", name="pallas_spgemm", case=case, rows=R_, K=K_,
             a_live=n_live, out_width=w9, route_launches=route_launches,
             ms=ms9, auto_width_ms=auto_ms9, plain_ms=plain_ms9, bound_ms=b_ms9,
             bound_by=b_by9, library_csr_spgemm_ms=lib_ms9, library_error=lib_err9,
             max_abs_err=err9, same_col_sets=same_sets, ok=ok9,
             tolerance=f"(col) sets and row_nnz equal, |dv| <= {SPGEMM_ATOL} + "
                       f"{SPGEMM_RTOL}*(|A||B|)")
        if not ok9:
            raise AssertionError(f"pallas_spgemm {case}: disagrees with its plain "
                                 f"version (sets {same_sets}, |dv| {err9})")
        if min(route_launches.values()) != 1 or max(route_launches.values()) != 1:
            raise AssertionError(f"pallas_spgemm {case}: route launches {route_launches}")
        r = results["pallas_spgemm"]
        r["max_abs_err"] = max(r["max_abs_err"], err9)
        if case == "config2_L0_AA":
            r.update(ms=ms9, plain_ms=plain_ms9, bound_ms=b_ms9, bound_by=b_by9,
                     copy_bound_ms=None, library_ms=lib_ms9, main_case=case,
                     auto_width_ms=auto_ms9, route_launches=route_launches)
        del C, Cp, bound9, kc, kv, pc_, pv_, bv_, plan
    del b9_cases

    # -- convert and slice_rs: the device-built hierarchy solves config #2 ------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_fast = ptt.with_best_formats(h_rs, device=True)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t0
    emit("convert", seconds=convert_s,
         formats=[{"A": fmt(l.A), "P": fmt(l.P), "R": fmt(l.R)}
                  for l in h_fast.levels])
    vtimes_rs, v = wall_ms(lambda: ptt.vcycle(h_fast, zero, b))
    if not bool(torch.isfinite(v).all()):
        raise AssertionError("device-RS vcycle output not finite")
    reset_counts()
    t0 = time.perf_counter()
    res_rs = ptt.amg_pcg(None, h_fast, b, tol=1e-6, maxiter=100)
    torch.cuda.synchronize()
    solve_rs_s = time.perf_counter() - t0
    launches_rs_pcg = spmv_counts()
    true_rs = true_rel_residual(A_sp, b_np, res_rs.x.cpu().numpy())
    limit_rs = 1e-6 + (res_rs.iters + 1) * f32_floor
    emit("slice_rs", problem=f"poisson2d({nx})",
         vcycle_ms_median=statistics.median(vtimes_rs), vcycle_ms=vtimes_rs,
         pcg_iters=res_rs.iters, converged=res_rs.converged, solve_s=solve_rs_s,
         residual_history=res_rs.residual_history[:res_rs.iters + 1].cpu().tolist(),
         true_rel_residual=true_rs, true_rel_residual_limit=limit_rs,
         launches=launches_rs_pcg, oracle_iters=int(oracle_iters),
         jax_package_iters=CONFIG2_JAX["pcg_iters"])
    if not res_rs.converged:
        raise AssertionError("device-RS amg_pcg did not converge to 1e-6")
    if abs(res_rs.iters - int(oracle_iters)) > 1:
        raise AssertionError(f"device-RS PCG took {res_rs.iters} iterations, "
                             f"the float64 oracle {oracle_iters}")
    if not true_rs <= limit_rs:
        raise AssertionError(f"device-RS true residual {true_rs} > {limit_rs}")
    if min(launches_rs_pcg.values()) <= 0:
        raise AssertionError(f"the device-RS solve skipped a kernel: {launches_rs_pcg}")
    c1["config2_device_1024^2"] = dict(
        pcg_iters=res_rs.iters, jax_package_iters=CONFIG2_JAX["pcg_iters"],
        oracle_iters=int(oracle_iters), rows=[l.A.n_rows for l in h_rs.levels],
        jax_package_rows=CONFIG2_JAX_CPU["rows"], jax_package_tpu_rows=CONFIG2_JAX["rows"],
        complexity=cx_rs, jax_package_complexity=list(CONFIG2_JAX_CPU["complexity"]))

    # -- aniso: config #4, anisotropic ε=1e-3 at 512² ---------------------------
    na = 512
    A4 = anisotropic2d(na, epsilon=1e-3).to_csr()
    A4_sp = A4.to_scipy()
    h4, _, _, cx4 = rs_setup(A4, "aniso_setup", need=("ordered_sum_staged",))
    rows4 = [l.A.n_rows for l in h4.levels]
    h4_fast = ptt.with_best_formats(h4, device=True)
    b4_np = np.random.default_rng(0).normal(size=A4.n_rows).astype(np.float32)
    b4 = torch.from_numpy(b4_np).to(dev)
    res4 = ptt.amg_pcg(None, h4_fast, b4, tol=1e-6, maxiter=100)
    true4 = true_rel_residual(A4_sp, b4_np, res4.x.cpu().numpy())
    oh4 = oracle_setup(A4_sp, cfg)
    x4_oracle, oracle4_iters, _ = oracle_pcg(A4_sp, b4_np.astype(np.float64), oh4,
                                             tol=1e-6)
    floor4 = true_rel_residual(A4_sp, b4_np, x4_oracle.astype(np.float32))
    limit4 = 1e-6 + (res4.iters + 1) * floor4
    emit("aniso", problem=f"anisotropic2d({na}, epsilon=1e-3)", rows=rows4,
         jax_package_rows=CONFIG4_JAX["rows"], grid_complexity=cx4[0],
         operator_complexity=cx4[1],
         jax_package_complexity=[CONFIG4_JAX["grid_complexity"],
                                 CONFIG4_JAX["operator_complexity"]],
         formats=[fmt(l.A) for l in h4_fast.levels], pcg_iters=res4.iters,
         converged=res4.converged, oracle_iters=int(oracle4_iters),
         oracle_rows=[l.A.shape[0] for l in oh4.levels],
         jax_package_iters=CONFIG4_JAX["pcg_iters"], true_rel_residual=true4,
         f32_rounding_floor=floor4, true_rel_residual_limit=limit4)
    if not res4.converged or abs(res4.iters - int(oracle4_iters)) > 1:
        raise AssertionError(f"config #4 PCG took {res4.iters} iterations "
                             f"(converged {res4.converged}), the oracle "
                             f"{oracle4_iters}")
    if not true4 <= limit4:
        raise AssertionError(f"config #4 true residual {true4} > {limit4}")
    c1["config4_512^2"] = dict(pcg_iters=res4.iters,
                               jax_package_iters=CONFIG4_JAX["pcg_iters"],
                               oracle_iters=int(oracle4_iters), rows=rows4,
                               jax_package_rows=CONFIG4_JAX["rows"], complexity=cx4,
                               jax_package_complexity=[CONFIG4_JAX["grid_complexity"],
                                                       CONFIG4_JAX["operator_complexity"]])

    # -- mp_aniso: config #4 to a true 1e-8 ----------------------------------------
    _, oracle4_8, _ = oracle_pcg(A4_sp, b4_np.astype(np.float64), oh4, tol=1e-8)
    # ε = 1e-3 is not a float32 number: the solve applies the rounded matrix
    A4_rounded = A4_sp.astype(np.float32).astype(np.float64)
    _, launches_mp4 = mp_solve(h4_fast, b4_np, A4_sp, "mp_aniso", MP_ITERS["config4"],
                               ("twell_spmv", "flatdia_spmv"), oracle=int(oracle4_8),
                               A_applied=A4_rounded,
                               problem=f"anisotropic2d({na}, epsilon=1e-3)")
    del h4, h4_fast, oh4, x4_oracle, A4_rounded

    # -- device_sa: algebraic SA set up on the card -----------------------------------
    cfg_sa = ptt.AMGConfig(coarsening="sa", aggregate="greedy", smoother="chebyshev",
                           n_coarse_max=64, on_device_setup=True)

    def levels_bit_equal(h1, h2):
        if h1.n_levels != h2.n_levels:
            return False
        for l1, l2 in zip(h1.levels, h2.levels):
            for M1, M2 in ((l1.A, l2.A), (l1.P, l2.P), (l1.R, l2.R)):
                if (M1 is None) != (M2 is None):
                    return False
                if not all(bits_equal(t1, t2)
                           for t1, t2 in zip(tensors(M1), tensors(M2))):
                    return False
        return True

    def sa_device(A_host, label):
        """Two setups (the second under torch.profiler), bit-equal; then the
        solve formats and amg_pcg to 1e-6."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        hs = ptt.setup(A_host, cfg_sa)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = spgemm_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hs2 = ptt.setup(A_host, cfg_sa)
            torch.cuda.synchronize()
            secs2 = time.perf_counter() - t0
        dev_events = [e for e in prof.events()
                      if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        by_kernel = {}
        for e in dev_events:
            for name in ("expand_kernel", "merge_kernel"):
                if name in e.name:
                    by_kernel[name] = by_kernel.get(name, 0.0) + e.device_time_total / 1e3
        equal = levels_bit_equal(hs, hs2)
        del hs2
        gc, oc = hs.complexity()
        t0 = time.perf_counter()
        hf = ptt.with_best_formats(hs, device=True)
        torch.cuda.synchronize()
        convert = time.perf_counter() - t0
        A_sp_ = A_host.to_scipy()
        b_host = np.random.default_rng(0).normal(size=A_sp_.shape[0]).astype(np.float32)
        reset_counts()
        t0 = time.perf_counter()
        r = ptt.amg_pcg(None, hf, torch.from_numpy(b_host).to(dev), tol=1e-6, maxiter=60)
        torch.cuda.synchronize()
        solve = time.perf_counter() - t0
        pcg_counts = spmv_counts()
        info = dict(problem=label, seconds=secs, second_run_seconds_profiled=secs2,
                    bit_equal=equal, rows=[l.A.n_rows for l in hs.levels],
                    grid_complexity=gc, operator_complexity=oc, launches=counts,
                    spgemm_device_ms=by_kernel,
                    device_ms_setup=sum(e.device_time_total for e in dev_events) / 1e3,
                    device_ops_setup=len(dev_events), peak_device_gb=peak,
                    convert_s=convert, formats=[fmt(l.A) for l in hf.levels],
                    pcg_iters=r.iters, converged=r.converged, solve_s=solve,
                    true_rel_residual=true_rel_residual(A_sp_, b_host, r.x.cpu().numpy()),
                    pcg_launches=pcg_counts)
        if not equal:
            raise AssertionError(f"device_sa {label}: the second setup differs")
        if min(counts.values()) <= 0:
            raise AssertionError(f"device_sa {label}: the setup skipped a kernel: {counts}")
        if not r.converged:
            raise AssertionError(f"device_sa {label}: PCG did not reach 1e-6")
        if min(pcg_counts.values()) <= 0:
            raise AssertionError(f"device_sa {label}: the solve skipped a kernel: "
                                 f"{pcg_counts}")
        del hs, hf
        return info, b_host, A_sp_

    # mis_aggregate's attach passes break ties between equal |a_ij| by slot,
    # as jnp.argmax does: torch.argmax must take the first maximum here too
    ties = torch.randint(0, 3, (1 << 20, 9), generator=g, device=dev).float()
    slot = torch.arange(ties.shape[1], device=dev)
    first = torch.where(ties == ties.amax(1, keepdim=True), slot, ties.shape[1]).amin(1)
    argmax_first = (torch.equal(ties.argmax(1), first)
                    and int(torch.zeros((4096, 33), device=dev).argmax(1).max()) == 0)
    emit("device_sa_argmax", rows=ties.shape[0], first_maximum=argmax_first)
    if not argmax_first:
        raise AssertionError("torch.argmax on the card does not take the first maximum")
    del ties, slot, first

    def sa_band(n_2d):
        """The 2D device SA at n_2d² beside the oracle's greedy SA on the
        same matrix and b (``tests/test_device_sa.py``'s band, reported)."""
        info, b_host, A_host = sa_device(poisson2d(n_2d).to_csr(), f"poisson2d({n_2d})")
        t0 = time.perf_counter()
        oh_sa = oracle_setup(A_host, dataclasses.replace(cfg_sa, on_device_setup=False))
        _, oit, _ = oracle_pcg(A_host, b_host.astype(np.float64), oh_sa, tol=1e-6,
                               maxiter=60)
        info.update(oracle_greedy_iters=int(oit),
                    oracle_rows=[l.A.shape[0] for l in oh_sa.levels],
                    oracle_seconds=time.perf_counter() - t0,
                    oracle_band_held=info["pcg_iters"] <= int(oit) + 4)
        if not (info["grid_complexity"] < 2.0 and info["operator_complexity"] < 3.0):
            raise AssertionError(f"device_sa {info['problem']} complexities "
                                 f"{info['grid_complexity']}, {info['operator_complexity']}")
        return info

    # 1024²: the full size (the JAX package's transpose stops at 2^19 rows, so
    # it has no count here); the float32 x is held as the slice's solve is
    info_sa2 = sa_band(nx)
    limit_sa2 = 1e-6 + (info_sa2["pcg_iters"] + 1) * f32_floor
    info_sa2["true_rel_residual_limit"] = limit_sa2
    emit("device_sa", **info_sa2)
    if not info_sa2["true_rel_residual"] <= limit_sa2:
        raise AssertionError(f"device_sa 2D true residual {info_sa2['true_rel_residual']}")
    # 512²: the largest 2D size the JAX package sets up; held to its count
    info_sa512 = sa_band(512)
    info_sa512.update(jax_package=DEVICE_SA_512_JAX,
                      rows_equal_jax_package=info_sa512["rows"] == DEVICE_SA_512_JAX["rows"])
    emit("device_sa", **info_sa512)
    if abs(info_sa512["pcg_iters"] - DEVICE_SA_512_JAX["pcg_iters"]) > 1:
        raise AssertionError(f"device_sa 512² took {info_sa512['pcg_iters']} iterations, "
                             f"the JAX package {DEVICE_SA_512_JAX['pcg_iters']}")
    info_sa3, _, _ = sa_device(poisson3d(n3).to_csr(), f"poisson3d({n3})")
    emit("device_sa", **info_sa3)
    if info_sa3["pcg_iters"] > 30 or not info_sa3["true_rel_residual"] <= 1e-5:
        raise AssertionError(f"device_sa 3D took {info_sa3['pcg_iters']} iterations, "
                             f"true residual {info_sa3['true_rel_residual']}")

    # -- fgmres: nonsymmetric convection-diffusion at 1024² -----------------------------
    cfg_c = ptt.AMGConfig(coarsening="rs", smoother="jacobi", n_coarse_max=128,
                          interpolation="extended_i")
    Ac = convection2d(nx, pe_x=5.0, pe_y=2.5).to_csr()
    Ac_sp = Ac.to_scipy()
    t0 = time.perf_counter()
    hc = ptt.setup(Ac, cfg_c, device=dev)
    torch.cuda.synchronize()
    setup_c = time.perf_counter() - t0
    bc_np = np.random.default_rng(0).normal(size=Ac.n_rows).astype(np.float32)
    bc = torch.from_numpy(bc_np).to(dev)
    rcg = ptt.amg_pcg(None, hc, bc, tol=1e-6, maxiter=80)
    reset_counts()
    t0 = time.perf_counter()
    rg = ptt.amg_fgmres(None, hc, bc, tol=1e-6, restart=30, max_restarts=20)
    torch.cuda.synchronize()
    solve_c = time.perf_counter() - t0
    launches_fg = spmv_counts()
    true_c = true_rel_residual(Ac_sp, bc_np, rg.x.cpu().numpy())
    # the oracle band: scipy GMRES(30) over the float64 oracle V-cycle
    t0 = time.perf_counter()
    oh_c = oracle_setup(Ac_sp, cfg_c)
    M_c = spla.LinearOperator(
        Ac_sp.shape, matvec=lambda r_: oracle_vcycle(oh_c, np.zeros_like(r_), r_))
    inner = {"n": 0}

    def count_inner(_):
        inner["n"] += 1

    _, info_c = spla.gmres(
        Ac_sp, bc_np.astype(np.float64), M=M_c, restart=30, maxiter=20, rtol=1e-6,
        callback=count_inner, callback_type="pr_norm")
    oracle_cycles = max(inner["n"] // 30 + 1, 1)
    emit("fgmres", problem=f"convection2d({nx}, pe_x=5.0, pe_y=2.5)",
         levels=[l.A.n_rows for l in hc.levels], setup_s=setup_c,
         pcg_iters=rcg.iters, pcg_converged=rcg.converged,
         restart_cycles=rg.iters, converged=rg.converged, solve_s=solve_c,
         residual_norm=float(rg.residual_norm), true_rel_residual=true_c,
         launches=launches_fg, oracle_gmres_info=int(info_c),
         oracle_inner_iterations=inner["n"], oracle_restart_cycles=oracle_cycles,
         oracle_seconds=time.perf_counter() - t0)
    if rcg.converged:
        raise AssertionError("CG converged on the Péclet-5 nonsymmetric operator")
    if not rg.converged or not true_c < 5e-6:
        raise AssertionError(f"amg_fgmres: converged {rg.converged}, true residual {true_c}")
    if info_c != 0 or rg.iters > oracle_cycles + 2:
        raise AssertionError(f"amg_fgmres took {rg.iters} cycles, scipy over the oracle "
                             f"{oracle_cycles} (info {info_c})")
    if min(launches_fg.values()) <= 0:
        raise AssertionError(f"the FGMRES solve skipped a kernel: {launches_fg}")
    del hc, oh_c, M_c, Ac, Ac_sp, rg, rcg

    # -- checkpoint: config #2's hierarchy saved and loaded onto the card ------------
    build_dir = _build.library_path("twell_spmv").parent
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = os.path.join(tmp, "config2.pt")
        t0 = time.perf_counter()
        save_hierarchy(path, h)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h_loaded = load_hierarchy(path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    y_orig = ptt.vcycle(h, zero, b)
    y_loaded = ptt.vcycle(h_loaded, zero, b)
    ckpt_equal = torch.equal(y_orig.view(torch.int32), y_loaded.view(torch.int32))
    emit("checkpoint", problem=f"poisson2d({nx})", file_bytes=size, save_s=save_s,
         load_s=load_s, formats=[fmt(l.A) for l in h_loaded.levels],
         device=str(h_loaded.coarse_inv.device), vcycle_bit_equal=ckpt_equal)
    if not ckpt_equal or h_loaded.coarse_inv.device.type != "cuda":
        raise AssertionError("the loaded hierarchy's V-cycle differs from the original's")
    del h_loaded, y_orig, y_loaded

    # -- pcsr, passembly, psetup_host, prs_setup, psa_setup: the algebraic
    # distributed path, config #2 in 8 parts on the card ------------------------
    mp_ref = {}
    dist_paths = dist_algebraic_phases(types.SimpleNamespace(mp_ref=mp_ref,
        make_mesh=ptt.make_row_mesh, dev=dev, label=f"poisson2d({nx})",
        A_csr=A_csr, A_sp=A_sp, b_np=b_np, cfg=cfg, f32_floor=f32_floor,
        one_device_iters=res.iters, oracle_rows=oracle_rows, one_device_rs=h_fast,
        sa_sizes=(256, 1024), emit=emit, sync=torch.cuda.synchronize,
        reset_peak=torch.cuda.reset_peak_memory_stats,
        peak_gb=lambda: torch.cuda.max_memory_allocated() / 1e9,
        reset_counts=reset_counts, spmv_counts=spmv_counts, device_ms=device_ms,
        copy_bound_ms=copy_bound_ms,
        wall_ms=wall_ms, bound_ms=bound_ms, profile=profile_cycles,
        profile_run=profile_run, check_kernel=check_kernel, results=results,
        ATOL=ATOL, RTOL=RTOL))

    # -- multiprocess: 2 ranks on the card, joined by torch.distributed -------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mp_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                          "multiprocess")
    t0 = time.perf_counter()
    ranks = launch.spawn(multiprocess_rank, MP_WORLD,
                         args=(cfg, cfg3_async, mp_ref["sa256"]["config"]),
                         timeout_s=MP_TIMEOUT_S, threads=4, store_dir=mp_dir)
    mp_s = time.perf_counter() - t0
    mp_paths = {}
    for key, sub in (("mp_config2_8parts_host_pcg", ("host", "launches")),
                     ("mp_config2_8parts_rs_setup", ("rs", "setup_launches")),
                     ("mp_config2_8parts_rs_pcg", ("rs", "pcg_launches")),
                     ("mp_config3_4parts_pcg", ("config3", "launches")),
                     ("mp_sa256_8parts_setup", ("sa256", "setup_launches")),
                     ("mp_sa256_8parts_pcg", ("sa256", "pcg_launches"))):
        mp_paths[key] = {k: sum(r[sub[0]][sub[1]][k] for r in ranks)
                         for k in ranks[0][sub[0]][sub[1]]}
    for r in ranks:
        emit("multiprocess_rank", rank=r["rank"], world=r["world"], backend="gloo",
             device=r["device"], nvidia_smi=smi, local_parts_8=r["local_parts"],
             local_parts_4=r["config3"]["local_parts"],
             peak_allocated_gb=r["peak_allocated_gb"],
             peak_reserved_gb=r["peak_reserved_gb"],
             **{f"{k}_{f}": r[k][f] for k in ("host", "rs", "config3", "sa256")
                for f in ("setup_s", "solve_s", "iters", "rows")},
             host_vcycle=r["host"]["vcycle"], host_matvec=r["host"]["matvec"],
             host_exchange_share_of_vcycle=(r["host"]["vcycle"]["exchange_ms"]
                                            / r["host"]["vcycle"]["wall_ms"]),
             rs_vcycle=r["rs"]["vcycle"],
             config3_vcycle=r["config3"]["vcycle"], config3_matvec=r["config3"]["matvec"],
             config3_b8_launches_per_matvec=r["config3"]["b8_per_matvec"],
             config3_exchange_share_of_vcycle=(r["config3"]["vcycle"]["exchange_ms"]
                                               / r["config3"]["vcycle"]["wall_ms"]))
    mp_holds = {
        "config2_host_pcg_iters_equal": all(
            r["host"]["iters"] == mp_ref["host"]["iters"] for r in ranks),
        "config2_host_x_bit_equal": [d for r in ranks for d in r["host"]["x"]]
        == mp_ref["host"]["x"],
        "config2_rs_planes_bit_equal": all(
            [d for r in ranks for d in r["rs"]["levels"].get(k, [])] == v
            for k, v in mp_ref["rs"]["levels"].items())
        and all(set(r["rs"]["levels"]) == set(mp_ref["rs"]["levels"]) for r in ranks),
        "config2_rs_pcg_iters_equal": all(
            r["rs"]["iters"] == mp_ref["rs"]["iters"] for r in ranks),
        "config3_history_bit_equal": all(
            r["config3"]["history"] == dist3["pallas_async"]["history"] for r in ranks),
        "config3_b8_interior_and_boundary_launched": min(
            mp_paths["mp_config3_4parts_pcg"]["halo_stencil_interior"],
            mp_paths["mp_config3_4parts_pcg"]["halo_stencil_boundary"]) > 0,
        # the route: one interior and one boundary launch a rank a matvec
        "config3_b8_two_launches_a_rank_a_matvec": all(
            r["config3"]["b8_per_matvec"] == {"halo_stencil_matvec": 0,
                                              "halo_stencil_interior": 1,
                                              "halo_stencil_boundary": 1}
            for r in ranks),
        "sa256_rows": all(r["sa256"]["rows"] == DIST_SA256_JAX8["rows"] for r in ranks),
        "sa256_pcg_iters": all(abs(r["sa256"]["iters"] - DIST_SA256_JAX8["pcg_iters"]) <= 1
                               for r in ranks),
        "converged": all(r[k]["converged"] for r in ranks
                         for k in ("host", "rs", "config3", "sa256")),
    }
    emit("multiprocess", world=MP_WORLD, backend="gloo", seconds=mp_s,
         nvidia_smi=smi, store=mp_dir, single_process_iters={
             "host": mp_ref["host"]["iters"], "rs": mp_ref["rs"]["iters"],
             "config3": dist3["pallas_async"]["iters"]},
         rs_rows=ranks[0]["rs"]["rows"], launches=mp_paths, holds=mp_holds)
    if not all(mp_holds.values()):
        raise AssertionError(f"multiprocess: a hold failed: {mp_holds}")

    # -- setup_vec: config #5 at 128³×3 on the card (BSR fine level) ------------
    n5 = 128
    C5 = coupling_matrix(3, 0.3)
    C5_64 = torch.tensor(C5, dtype=torch.float64, device=dev)

    def vector_setup(dims, fine_format, label):
        L, _ = coupled_laplacian(dims, 3, 0.3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with record_dot_shapes(f"{label} {fine_format}"):
            t0 = time.perf_counter()
            hv = ptt.setup_vector_kron(L, C5, cfg3, fine_format=fine_format)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        gc, oc = hv.complexity()
        levels = [{"node_rows": l.n // 3, "rows": l.n, "format": fmt(l.A),
                   "points": getattr(l.A, "n_points", None),
                   "width": getattr(getattr(l.A, "bsr", None), "width", None),
                   "nnz": l.A.nnz, "lam_max": l.lam_max} for l in hv.levels]
        info = dict(problem=f"coupled_laplacian({dims}, bs=3, gamma=0.3)",
                    fine_format=fine_format, seconds=secs, n_levels=hv.n_levels,
                    levels=levels, product_paths=hv.setup_stats["product_paths"],
                    grid_complexity=gc, operator_complexity=oc,
                    jax_package_complexity=CONFIG5_JAX["complexity"],
                    peak_device_gb_setup=torch.cuda.max_memory_allocated() / 1e9)
        emit(label, **info)
        return L, hv, info

    L5, h5, info5 = vector_setup((n5,) * 3, "bsr", "setup_vec")
    rows5 = [lv["node_rows"] for lv in info5["levels"]]
    if rows5 != CONFIG3_ROWS:
        raise AssertionError(f"config #5 node rows {rows5}, want {CONFIG3_ROWS}")
    for got, want in zip((info5["grid_complexity"], info5["operator_complexity"]),
                         CONFIG5_JAX["complexity"]):
        if abs(got / want - 1) > 0.01:
            raise AssertionError(f"config #5 complexity {got}, the JAX package {want}")

    # -- kernel B6: bsr_spmv -------------------------------------------------------
    def random_bsr(n_rows, n_cols, width, bs_, empty_frac):
        g6 = torch.Generator(device=dev).manual_seed(6)
        nnz = torch.randint(0, width + 1, (n_rows,), generator=g6, device=dev)
        nnz[torch.rand(n_rows, generator=g6, device=dev) < empty_frac] = 0
        live = torch.arange(width, device=dev)[:, None] < nnz[None]
        cols = torch.randint(0, n_cols, (width, n_rows), generator=g6, device=dev)
        vals = torch.randn((width, bs_ * bs_, n_rows), generator=g6, device=dev)
        return BSR(torch.where(live, cols, 0).to(torch.int32),
                   (vals * live[:, None]).reshape(width * bs_ * bs_, n_rows),
                   nnz.to(torch.int32), (n_rows * bs_, n_cols * bs_), bs_)

    def bsr_library(A, x):
        """One torch sparse product on A's live blocks: a BSR tensor where
        torch runs one on CUDA, else the expanded CSR.  (ms, kind, error)."""
        bs_, RB = A.bs, A.n_block_rows
        live = torch.arange(A.width, device=dev)[None, :] < A.brow_nnz[:, None].long()
        r_idx, w_idx = torch.nonzero(live, as_tuple=True)  # row-major
        cols = A.bcols[w_idx, r_idx].long()
        blocks = A.vals.reshape(A.width, bs_ * bs_, RB)[w_idx, :, r_idx].float()
        crow = torch.zeros(RB + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(A.brow_nnz.long(), 0)
        size = (RB * bs_, A.n_block_cols * bs_)
        xs = x if x.shape[0] == size[1] else torch.nn.functional.pad(x, (0, size[1] - x.shape[0]))
        errors = []
        try:
            t = torch.sparse_bsr_tensor(crow, cols, blocks.reshape(-1, bs_, bs_), size=size)
            return device_ms(lambda: t @ xs), "bsr", None
        except RuntimeError as e:  # the yardstick only; never on the path
            errors.append(f"{e}"[:200])
        ii = torch.arange(bs_, device=dev)
        rows = (r_idx[:, None, None] * bs_ + ii[None, :, None]).expand(-1, bs_, bs_)
        ccols = (cols[:, None, None] * bs_ + ii[None, None, :]).expand(-1, bs_, bs_)
        vv = blocks.reshape(-1, bs_, bs_)
        keep = vv != 0
        coo = torch.sparse_coo_tensor(torch.stack([rows[keep], ccols[keep]]), vv[keep], size)
        del rows, ccols, vv, keep, blocks
        lib = coo.coalesce().to_sparse_csr()
        del coo
        ms_, err = library_ms(lib, xs)
        return ms_, "csr", "; ".join(errors + ([err] if err else [])) or None

    def bsr_bytes(A):
        return roofline.spmv_bytes(A), int(A.brow_nnz.long().sum())

    A5 = h5.levels[0].A.bsr
    bsr_cases = {
        "config5_128^3x3": (A5, "matvec"),
        "config5_128^3x3_btwell_planes": (btwell_from_kron_stencil(L5, C5), "planes"),
        "random_500000x400000_w12_empty": (random_bsr(500_000, 400_000, 12, 3, 0.1),
                                           "matvec"),
    }
    results["bsr_spmv"] = {"max_abs_err": 0.0}
    for name, (A, how) in bsr_cases.items():
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and name != "config5_128^3x3":
                continue
            Ad = type(A)(A.bcols, A.vals.to(dtype), A.brow_nnz, A.shape, A.bs)
            x = torch.randn(Ad.n_block_cols * Ad.bs, generator=g, device=dev)
            xb = x.reshape(-1, Ad.bs)
            if how == "planes":
                xp = xb.T.contiguous()
                run = lambda: Ad.matvec_planes(xp)  # noqa: E731
                y = run().T
            else:
                run = lambda: Ad.matvec(x)  # noqa: E731
                y = run().reshape(-1, Ad.bs)
            ref = bsr._matvec_plain(Ad.bcols, Ad.vals, Ad.bs, xb)
            bound = ATOL + RTOL * bsr._matvec_plain(Ad.bcols, Ad.vals.abs(), Ad.bs, xb.abs())
            n_bytes, n_live = bsr_bytes(Ad)
            b_ms, b_by = bound_ms(n_bytes, 2 * n_live * Ad.bs ** 2)
            lib_ms, lib_kind, lib_err = None, None, None
            if dtype == torch.float32:
                lib_ms, lib_kind, lib_err = bsr_library(Ad, x)
            ms = device_ms(run)
            plain_ms = device_ms(lambda: bsr._matvec_plain(Ad.bcols, Ad.vals, Ad.bs, xb),
                                 reps=2, samples=5)
            err = check_kernel("bsr_spmv", name, dtype, y, ref, bound, dict(
                block_rows=Ad.n_block_rows, width=Ad.width, live_blocks=n_live,
                vals_gb=Ad.vals_nbytes / 1e9, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, copy_bound_ms=copy_bound_ms(n_bytes),
                library_ms=lib_ms, library_kind=lib_kind, library_error=lib_err,
                gb_s=n_bytes / ms / 1e6))
            r = results["bsr_spmv"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "config5_128^3x3" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         library_kind=lib_kind, main_case=f"{name} f32")
            del Ad, x, xb, y, ref, bound
    del bsr_cases

    # -- kernel B7: flatdia_spmm -----------------------------------------------------
    def offgrid_stencil(dims):
        st = poisson_stencil(dims)
        w = 0.5 + torch.rand(st.weights.shape, generator=g, device=dev)
        return Stencil(w * torch.where(st.weights < 0, -1.0, 1.0), st.offsets, dims)

    spmm_cases = {
        "poisson_128^3_k3": (L5, 3),
        "config3_level1_k3": (h3.levels[1].A, 3),
        "poisson_128^3_k1": (L5, 1),
        "poisson_128^3_k8": (L5, 8),
        "offgrid_weights_64^3_k3": (offgrid_stencil((64,) * 3), 3),
    }
    results["flatdia_spmm"] = {"max_abs_err": 0.0}
    for name, (st, k) in spmm_cases.items():
        planes, offs = st.flat_planes()
        for dtype in (torch.float32, torch.bfloat16):
            if dtype == torch.bfloat16 and name != "poisson_128^3_k3":
                continue
            W = planes.to(dtype).contiguous()
            X = torch.randn((st.n, k), generator=g, device=dev)
            Y = flatdia.dia_spmm(W, offs, X)
            ref = flatdia._matmat_plain(W, offs, X)
            bound = ATOL + RTOL * flatdia._matmat_plain(W.abs(), offs, X.abs())
            extra_ok = True
            if name.startswith("offgrid"):  # the stencil's two routes agree too
                Xg = X.reshape(st.dims + (k,))
                padded = st._matmat_plain(Xg).reshape(st.n, k)
                extra_ok = bool(((st.matmat(Xg).reshape(st.n, k) - padded).abs()
                                 <= bound).all())
            n_bytes = roofline.spmv_bytes(FlatDIA(W, offs, st.n), k=k)
            b_ms, b_by = bound_ms(n_bytes, 2 * len(offs) * st.n * k)
            lib_ms, lib_err = None, None
            if dtype == torch.float32:
                lib = flat_csr(FlatDIA(W, offs, st.n))
                lib_ms, lib_err = library_ms(lib, X)
                del lib
            ms = device_ms(lambda: flatdia.dia_spmm(W, offs, X))
            plain_ms = device_ms(lambda: flatdia._matmat_plain(W, offs, X),
                                 reps=2, samples=5)
            err = check_kernel("flatdia_spmm", name, dtype, Y, ref, bound, dict(
                rows=st.n, diags=len(offs), k=k, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, copy_bound_ms=copy_bound_ms(n_bytes),
                library_csr_ms=lib_ms, library_error=lib_err,
                stencil_routes_agree=extra_ok, gb_s=n_bytes / ms / 1e6))
            if not extra_ok:
                raise AssertionError(f"flatdia_spmm {name}: Stencil.matmat on the "
                                     "card disagrees with the padded plain version")
            r = results["flatdia_spmm"]
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if name == "poisson_128^3_k3" and dtype == torch.float32:
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         copy_bound_ms=copy_bound_ms(n_bytes), library_ms=lib_ms,
                         main_case=f"{name} f32")
            del W, X, Y, ref, bound
    del spmm_cases

    # -- slice_vec: config #5 V-cycle and AMG-PCG at 128³×3 ---------------------------
    def true_rel_residual_vec(L, b_host, x):
        """‖b − (L ⊗ C)x‖/‖b‖ in float64 on the card: the plain
        Stencil.matmat on float64 planes, then the C mix."""
        L64 = Stencil(L.weights.double(), L.offsets, L.dims)
        x64 = x.double().reshape(L.dims + (3,))
        ax = L64._matmat_plain(x64) @ C5_64.T
        b64 = torch.from_numpy(b_host).to(dev).double().reshape(ax.shape)
        return float(torch.linalg.norm(b64 - ax) / torch.linalg.norm(b64))

    def vector_solve(L, hv, b_host, label, maxiter, **extra):
        b_dev = torch.from_numpy(b_host).to(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        rv = ptt.amg_pcg(None, hv, b_dev, tol=1e-6, maxiter=maxiter)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = vector_counts()
        true_v = true_rel_residual_vec(L, b_host, rv.x)
        emit(label, pcg_iters=rv.iters, converged=rv.converged, solve_s=secs,
             residual_history=rv.residual_history[:rv.iters + 1].cpu().tolist(),
             true_rel_residual=true_v, launches=counts,
             peak_device_gb_solve=torch.cuda.max_memory_allocated() / 1e9, **extra)
        if not rv.converged:
            raise AssertionError(f"{label} did not converge to 1e-6")
        if not true_v <= 1e-5:
            raise AssertionError(f"{label} true relative residual {true_v} > 1e-5")
        if counts["flatdia_spmm"] <= 0:
            raise AssertionError(f"{label}: the solve launched no B7: {counts}")
        return rv, counts

    b5_np = np.random.default_rng(0).normal(size=h5.levels[0].n).astype(np.float32)
    b5 = torch.from_numpy(b5_np).to(dev).reshape(h5.grid_dims)
    zero5 = torch.zeros_like(b5)
    vt5, v5 = wall_ms(lambda: ptt.vcycle(h5, zero5, b5))
    if not bool(torch.isfinite(v5).all()):
        raise AssertionError("config #5 vcycle output not finite")
    reset_counts()
    ptt.vcycle(h5, zero5, b5)
    per_cycle5 = vector_counts()
    res5, launches_vec = vector_solve(
        L5, h5, b5_np, "slice_vec", 100, problem=info5["problem"],
        fine_format="bsr", vcycle_ms_median=statistics.median(vt5), vcycle_ms=vt5,
        launches_per_vcycle=per_cycle5, jax_package_iters=CONFIG5_JAX["pcg_iters"])
    if abs(res5.iters - CONFIG5_JAX["pcg_iters"]) > 1:
        raise AssertionError(f"config #5 took {res5.iters} iterations, the JAX "
                             f"package {CONFIG5_JAX['pcg_iters']}")
    if launches_vec["bsr_spmv"] <= 0:
        raise AssertionError(f"the config #5 solve launched no B6: {launches_vec}")
    c1["config5_128^3x3"] = dict(pcg_iters=res5.iters,
                                 jax_package_iters=CONFIG5_JAX["pcg_iters"],
                                 node_rows=rows5,
                                 complexity=[info5["grid_complexity"],
                                             info5["operator_complexity"]],
                                 jax_package_complexity=CONFIG5_JAX["complexity"],
                                 pcg_iters_bf16_coarse_solve=bf16_coarse_iters(
                                     h5, None, b5))
    launches_by_format = {"bsr": launches_vec}
    for fine_format in ("btwell", "bstencil"):
        Lf, hf, infof = vector_setup((n5,) * 3, fine_format, "setup_vec")
        rf, cf = vector_solve(Lf, hf, b5_np, "slice_vec", 100,
                              problem=infof["problem"], fine_format=fine_format,
                              bsr_iters=res5.iters)
        launches_by_format[fine_format] = cf
        if rf.iters != res5.iters:
            raise AssertionError(f"config #5 {fine_format} took {rf.iters} "
                                 f"iterations, bsr {res5.iters}")
        if (cf["bsr_spmv"] > 0) != (fine_format == "btwell"):
            raise AssertionError(f"config #5 {fine_format}: B6 launches {cf}")
        del Lf, hf

    # -- profile: kernels and device time per V-cycle ------------------------------
    for label, hh, bb in (
            ("config2", h, b),
            ("config2_device", h_fast, b),
            ("config3_mixed", ptt.with_spmv_backend(h3, "mixed"),
             torch.from_numpy(b3_np).to(dev).reshape(h3.grid_dims)),
            ("config3_pallas", ptt.with_spmv_backend(h3, "pallas"),
             torch.from_numpy(b3_np).to(dev).reshape(h3.grid_dims)),
            ("config5_bsr", h5, b5),
            ("config3_dist_4parts", hd3, b3d)):
        zz = bb.zeros_like() if isinstance(bb, PGrid) else torch.zeros_like(bb)
        reset_counts()
        ptt.vcycle(hh, zz, bb)
        per_cycle = {**spmv_counts(), **vector_counts(), **halo_counts()}
        prof = profile_cycles(lambda: ptt.vcycle(hh, zz, bb))
        emit("profile", cell=label, kernel_launches_per_vcycle=per_cycle, **prof)
        if label == "config2":
            results["twell_spmv"]["device_ms_per_vcycle_config2"] = \
                prof["port_kernel_device_ms_per_call"].get("twell_stream_kernel")

    # -- config #1: 64², V(1,1) weighted Jacobi, standalone solve ---------------
    A1 = poisson2d(64).to_csr()
    h1 = ptt.setup(A1, ptt.AMGConfig(coarsening="rs", smoother="jacobi"),
                   device=dev)
    b1 = torch.from_numpy(
        np.random.default_rng(0).normal(size=A1.n_rows).astype(np.float32)).to(dev)
    _, hist1, k1 = ptt.solve(h1, b1, tol=1e-8, maxiter=20)
    hist1 = hist1[:k1].cpu().tolist()
    cycles = min(6, k1)
    rate = (hist1[cycles - 1] / float(torch.linalg.norm(b1))) ** (1.0 / cycles)
    emit("config1", problem="poisson2d(64)", cycles=k1, residual_history=hist1,
         rate_first_cycles=rate)
    if not 0.05 <= rate <= 0.5:
        raise AssertionError(f"config #1 residual reduction {rate} per cycle")

    # -- slice_vec_100m: config #5 at 324³×3 = 102,036,672 DOF --------------------
    del h5, A5, L5, b5, zero5, v5
    torch.cuda.empty_cache()
    n100 = 324
    plan = device_setup.slab_plan(poisson_stencil((4,) * 3).offsets, (n100,) * 3,
                                  (n100 // 3,) * 3, cfg3.block_size,
                                  cfg3.setup_chunk_budget_mb * 2**20)
    # the scalar setup alone: its peak holds the slab product's temporaries
    L_s, _ = coupled_laplacian((n100,) * 3, 3, 0.3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    hs100 = device_setup.device_structured_setup(L_s, cfg3)
    torch.cuda.synchronize()
    emit("setup_vec_100m_scalar", seconds=time.perf_counter() - t0,
         product_paths=hs100.setup_stats["product_paths"], slab_plan=plan,
         held_before_gb=held_gb,
         peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    del hs100, L_s
    L100, h100, info100 = vector_setup((n100,) * 3, "bsr", "setup_vec_100m")
    rows100 = [lv["rows"] for lv in info100["levels"]]
    emit("setup_vec_100m_plan", slab_plan=plan, rows=rows100,
         jax_package_rows=CONFIG5_100M_ROWS,
         bsr_gb=h100.levels[0].A.bsr.vals_nbytes / 1e9,
         memory_allocated_gb=torch.cuda.memory_allocated() / 1e9)
    if rows100 != CONFIG5_100M_ROWS:
        raise AssertionError(f"324³×3 levels {rows100}, want {CONFIG5_100M_ROWS}")
    if info100["product_paths"][0] != "slab":
        raise AssertionError(f"324³ level 0 took the {info100['product_paths'][0]} "
                             "product path, not slab")
    A100 = h100.levels[0].A.bsr
    x100 = torch.randn(A100.n_block_cols * 3, generator=g, device=dev)
    xb100 = x100.reshape(-1, 3)
    y100 = A100.matvec(x100).reshape(-1, 3)
    ref100 = bsr._matvec_plain(A100.bcols, A100.vals, 3, xb100)
    bound100 = ATOL + RTOL * bsr._matvec_plain(A100.bcols, A100.vals.abs(), 3,
                                               xb100.abs())
    n_bytes100, n_live100 = bsr_bytes(A100)
    b_ms100, b_by100 = bound_ms(n_bytes100, 2 * n_live100 * 9)
    ms100 = device_ms(lambda: A100.matvec(x100), reps=3, samples=9)
    err100 = check_kernel("bsr_spmv", "config5_324^3x3", torch.float32, y100, ref100,
                          bound100, dict(block_rows=A100.n_block_rows, width=A100.width,
                                         live_blocks=n_live100,
                                         vals_gb=A100.vals_nbytes / 1e9, ms=ms100,
                                         bound_ms=b_ms100, bound_by=b_by100,
                                         gb_s=n_bytes100 / ms100 / 1e6))
    results["bsr_spmv"]["max_abs_err"] = max(results["bsr_spmv"]["max_abs_err"], err100)
    results["bsr_spmv"].update(ms_324=ms100, bound_ms_324=b_ms100)
    del x100, xb100, y100, ref100, bound100
    b100_np = np.random.default_rng(0).normal(size=h100.levels[0].n).astype(np.float32)
    res100, launches_100m = vector_solve(
        L100, h100, b100_np, "slice_vec_100m", 60, problem=info100["problem"],
        fine_format="bsr", dof=h100.levels[0].n, setup_s=info100["seconds"],
        peak_device_gb_setup=info100["peak_device_gb_setup"])
    if launches_100m["bsr_spmv"] <= 0:
        raise AssertionError(f"the 324³×3 solve launched no B6: {launches_100m}")
    c1["config5_324^3x3"] = dict(pcg_iters=res100.iters, jax_package_iters=None,
                                 rows=rows100, jax_package_rows=CONFIG5_100M_ROWS,
                                 complexity=[info100["grid_complexity"],
                                             info100["operator_complexity"]])
    del L100, h100, A100

    # -- slice_dist_100m: 468³ = 102,503,232 DOF in 8 parts ---------------------------
    del hd3, b3d, zero3d, v_d3
    torch.cuda.empty_cache()
    n468 = 468
    dims468 = (n468,) * 3
    mesh8 = ptt.make_row_mesh(8)
    hd468, info468 = dist_setup(dims468, mesh8, "setup_dist_100m")
    # that setup's host draw (ops/prng.py): the start vector over the padded
    # grid, copied to the card
    t0 = time.perf_counter()
    device_setup.start_vector(hd468.levels[0].A.dims, torch.float32, dev)
    torch.cuda.synchronize()
    emit("setup_dist_100m_draw", values=hd468.levels[0].A.n,
         seconds=time.perf_counter() - t0)
    rows468 = [lv["rows"] for lv in info468["levels"]]
    if rows468 != DIST_100M_ROWS:
        raise AssertionError(f"468³ in 8 parts: levels {rows468}, want {DIST_100M_ROWS}")
    # the gathered tail's bucketed products: one ordered_bucket_stage a stage;
    # the centres alone stay ordered_fma (1,080 when the stages' updates
    # were ordered_fma launches)
    launches468 = info468["ordered_sum_launches"]
    n_bucketed468 = hd468.setup_stats["tail_product_paths"].count("bucketed")
    if not (launches468["ordered_fma"] < 1080
            and launches468["ordered_bucket_stage"] == 3 * n_bucketed468 > 0):
        raise AssertionError(f"468³ setup: {launches468} for {n_bucketed468} bucketed "
                             "product(s) in its tail")
    hold_p468_record(kctx, hd468, mesh8)
    for lv in (0, 1):
        ordered_stencil_case(kctx, f"dist_468^3_8parts_level{lv}", hd468.levels[lv].A,
                             hd468.levels[lv].d_inv, g_os, main=lv == 0)
    A468 = hd468.levels[0].A
    x468 = PGrid.from_global(torch.randn(A468.dims, generator=g, device=dev), mesh8)
    A468_k = A468.with_halo_mode("pallas_async")
    A468_p = A468.with_halo_mode("xla")
    launched468, y468 = b8_launches(lambda: A468_k.matvec(x468))
    y468 = y468.to_global()
    ref468 = A468_p.matvec(x468).to_global()
    bit_equal468 = bits_equal(y468, ref468)
    bound468 = (ATOL + RTOL * ShardedStencil([W.abs() for W in A468.weights], A468.offsets,
                                             A468.dims, mesh8).matvec(
        PGrid([p.abs() for p in x468.parts], mesh8))).to_global()
    n_bytes468 = halo_bytes(A468)
    b_ms468, b_by468 = bound_ms(n_bytes468, 2 * A468.n_points * A468.n)
    ms468 = device_ms(lambda: A468_k.matvec(x468), reps=3, samples=9)
    copy_ms468 = device_ms(lambda: phalo_async.matvec_copy_streams(A468, x468), reps=3,
                           samples=9)
    prof468 = profile_cycles(lambda: A468_k.matvec(x468), n=5)
    emit("kernel_b8_profile", case="dist_468^3_level0_8parts", path="one_launch",
         b8_launches_per_matvec=launched468, event_window_ms=ms468, **prof468)
    plain_ms468 = device_ms(lambda: A468_p.matvec(x468), reps=1, samples=3)
    err468 = check_kernel("halo_stencil_matvec", "dist_468^3_level0_8parts", torch.float32,
                          y468, ref468, bound468, dict(
                              padded_dims=list(A468.dims), parts=8, m0=A468.m0,
                              halo=A468.halo, points=A468.n_points, launches=launched468,
                              bit_equal_to_plain=bit_equal468, ms=ms468,
                              copy_path_ms=copy_ms468,
                              plain_ms=plain_ms468, bound_ms=b_ms468,
                              bound_by=b_by468, share_of_bound=b_ms468 / ms468,
                              copy_bound_ms=copy_bound_ms(n_bytes468),
                              gb_s=n_bytes468 / ms468 / 1e6))
    if launched468 != ONE_CARD or not bit_equal468:
        raise AssertionError(f"halo_stencil 468³: launches {launched468}, bit-equal "
                             f"{bit_equal468}")
    r = results["halo_stencil_matvec"]
    r["max_abs_err"] = max(r["max_abs_err"], err468)
    r.update(ms_468=ms468, bound_ms_468=b_ms468, plain_ms_468=plain_ms468,
             copy_path_ms_468=copy_ms468)
    del x468, y468, ref468, bound468, A468_k, A468_p
    b468_np = np.random.default_rng(0).normal(size=int(np.prod(dims468))).astype(np.float32)
    b468 = ptt.distribute_grid(b468_np, dims468, hd468, mesh8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    r468 = ptt.amg_pcg(None, hd468, b468, tol=1e-6, maxiter=60)
    torch.cuda.synchronize()
    s468 = time.perf_counter() - t0
    launches_468 = halo_counts()
    peak_solve468 = torch.cuda.max_memory_allocated() / 1e9
    # float64 true residual on the card: the 7-point operator's plain
    # Stencil.matvec on float64 planes over the true grid
    x468_true = r468.x.to_global()[:n468].double()
    r468 = r468._replace(x=None)
    del b468
    A64 = poisson_stencil(dims468, dtype=torch.float64)
    b64 = torch.from_numpy(b468_np).to(dev).double().reshape(dims468)
    true468 = float(torch.linalg.norm(b64 - A64.matvec(x468_true)) / torch.linalg.norm(b64))
    del A64, b64, x468_true
    emit("slice_dist_100m", problem=info468["problem"], dof=int(np.prod(dims468)),
         setup_s=info468["seconds"], peak_device_gb_setup=info468["peak_device_gb"],
         rows=rows468, pcg_iters=r468.iters, converged=r468.converged, solve_s=s468,
         residual_history=r468.residual_history[:r468.iters + 1].cpu().tolist(),
         true_rel_residual=true468, launches=launches_468,
         peak_device_gb_solve=peak_solve468, b8_ms_level0=ms468,
         b8_bound_ms_level0=b_ms468)
    if not r468.converged:
        raise AssertionError("468³ in 8 parts did not converge to 1e-6 in 60 iterations")
    if not true468 <= 1e-5:
        raise AssertionError(f"468³ in 8 parts true residual {true468} > 1e-5")
    if launches_468["halo_stencil_matvec"] <= 0:
        raise AssertionError(f"the 468³ solve launched no B8: {launches_468}")
    c1["config3_468^3_8parts"] = dict(pcg_iters=r468.iters, jax_package_iters=None,
                                      rows=rows468, complexity=info468["complexity"])
    del hd468, A468
    for config, counts in c1.items():
        emit("c1", config=config, **counts)

    launches = {"twell_spmv": launches2["twell_spmv"],
                "flatdia_spmv": slice3["mixed"]["launches"]["flatdia_spmv"],
                **dist3["pallas_async"]["launches"],
                # B8's exchange route runs on the multiprocess path
                **{k: mp_paths["mp_config3_4parts_pcg"][k]
                   for k in ("halo_stencil_interior", "halo_stencil_boundary")},
                "pallas_spgemm": results["pallas_spgemm"]["route_launches"]["spgemm_expand"],
                **launches_rs, **launches_vec,
                # the 8-part RS setup; LLVM's order runs on the one-device
                # setup alone (launches_rs)
                **{k: dist_paths["dist_config2_8parts_rs_setup"][k]
                   for k in ("ordered_sum_staged", "ordered_sum_windows")},
                # config #3's one-device setup: its smoothers' fmas and its
                # bucketed stages
                "ordered_fma": launches_setup3["ordered_fma"],
                "ordered_bucket_stage": launches_setup3["ordered_bucket_stage"],
                # the 468³ setup in 8 parts, the main case's path: its power
                # iterations on every level
                "ordered_stencil_matvec":
                    info468["ordered_sum_launches"]["ordered_stencil_matvec"]}
    by_path = {"config3_setup": launches_setup3,
               "poisson2d_1024^2_setup": launches_setup2d,
               "poisson2d_1024^2_pcg": launches_pcg2d,
               "config3_dist_4parts_setup": info_d3["ordered_sum_launches"],
               "config3_dist_4parts_sharded_power": info_d3["sharded_power_launches"],
               "dist_468^3_8parts_setup": info468["ordered_sum_launches"],
               "dist_468^3_8parts_sharded_power": info468["sharded_power_launches"],
               "config2_pcg": launches2,
               "config3_mixed_pcg": slice3["mixed"]["launches"],
               "config3_pallas_pcg": slice3["pallas"]["launches"],
               "config2_device_rs_setup": launches_rs,
               "config2_device_rs_pcg": launches_rs_pcg,
               **{f"config5_{k}_pcg": v for k, v in launches_by_format.items()},
               "config5_324^3_bsr_pcg": launches_100m,
               "config3_dist_4parts_pcg": dist3["pallas_async"]["launches"],
               "dist_468^3_8parts_pcg": launches_468,
               "config2_mp_1e-8_pcg": launches_mp2,
               "config3_mp_1e-8_pcg": launches_mp3,
               "config4_mp_1e-8_pcg": launches_mp4,
               "config3_bf16_vcycle": bf16_cycle3,
               "config2_bf16_vcycle": bf16_cycle2,
               "device_sa_2d_setup": info_sa2["launches"],
               "device_sa_3d_setup": info_sa3["launches"],
               "device_sa_2d_pcg": info_sa2["pcg_launches"],
               "device_sa_3d_pcg": info_sa3["pcg_launches"],
               "convection_fgmres": launches_fg,
               **dist_paths, **mp_paths}

    hold_host_checks()
    line = []
    for name, meta in KERNELS.items():
        r = results[name]
        extra = {k: v for k, v in r.items()
                 if k.startswith(("ms_", "bound_ms_", "plain_ms_", "library_ms_",
                                  "case_", "copy_path_"))
                 or k in ("product_ms", "product_library_ms", "library_kind",
                          "auto_width_ms", "device_ms_per_matvec",
                          "device_ms_per_vcycle_config2", "bit_equal_20_calls",
                          "full_mode_ms", "k_major_ms", "sort_ms",
                          "share_of_bound", "host_ms", "earlier_sequence_ms", "cases")}
        if "design" in meta:
            extra["design"] = meta["design"]
        if name in ("halo_stencil_interior", "halo_stencil_boundary"):
            extra["path"] = ("the exchange route: config #3 in 4 parts on 2 processes "
                             "sharing this card (multiprocess phase), where a part's "
                             "halo comes from the other process; held bit-equal on "
                             "this card in the B8 kernel phase")
        if name == "pallas_spgemm":
            extra["routed_to"] = ["spgemm_expand", "spgemm_dedup", "spgemm_dedup_compact"]
            extra["launches_by_path"] = {"pallas_spgemm_config2_L0_AA": r["route_launches"]}
        line.append({"name": name, "route": "cuda", "source": meta["source"],
                     "replaces": meta["replaces"], "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "copy_bound_ms": r["copy_bound_ms"], "main_case": r["main_case"],
                     "launches_by_path": {k: v.get(name, 0)
                                          for k, v in by_path.items()},
                     **extra})
    print(json.dumps({"kernels": line}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
