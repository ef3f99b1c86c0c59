#!/usr/bin/env python3
"""Config #3's PCG count on the CPU through the JAX package and through the port.

    JAX_PLATFORMS=cpu python3 scripts/config3_cpu_counts.py [n] [jax|port|jax5]

3D 7-point Poisson n³ (default 128), block SA b=3, Chebyshev,
n_coarse_max=512, set up on the device (``on_device_setup=True``), then
AMG-PCG to 1e-6 on b = rng(0).normal(n³) in float32, the b of chip_smoke.py.
"jax" runs the JAX package with its "xla" SpMV backend (Pallas interpret mode
is too slow at this size); "port" runs the port's plain CPU path.  "jax5" is
config #5 through the JAX package: the coupled vector Laplacian n³×3
(``coupled_laplacian(dims, 3, 0.3)``, ``setup_vector_kron`` with config #3's
settings, its "bstencil" fine format, which needs no Pallas kernel), PCG to
1e-6 on b = rng(0).normal(3·n³), chip_smoke.py's b.  Prints one JSON line:
iterations, level rows, seconds and the residual history.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    which = sys.argv[2] if len(sys.argv) > 2 else "port"
    b_np = np.random.default_rng(0).normal(size=n ** 3).astype(np.float32)
    t0 = time.time()
    if which == "jax5":
        import jax.numpy as jnp

        import parallel_amg_tpu as pat
        from parallel_amg_tpu.amg.vector import setup_vector_kron
        from parallel_amg_tpu.problems.elasticity import coupled_laplacian

        cfg = pat.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                            smoother="chebyshev", n_coarse_max=512,
                            on_device_setup=True)
        L, C = coupled_laplacian((n,) * 3, 3, 0.3)
        h = setup_vector_kron(L, C, cfg, fine_format="bstencil")
        b5 = np.random.default_rng(0).normal(size=h.levels[0].n).astype(np.float32)
        r = pat.amg_pcg(None, h, jnp.asarray(b5).reshape(h.grid_dims), tol=1e-6,
                        maxiter=100)
        iters = int(r.iters)
        hist = np.asarray(r.residual_history)[:iters + 1].tolist()
        rows = [int(l.n) for l in h.levels]
    elif which == "jax":
        import jax.numpy as jnp

        import parallel_amg_tpu as pat
        from parallel_amg_tpu.amg.hierarchy import with_spmv_backend
        from parallel_amg_tpu.problems.stencil_problems import poisson_stencil

        cfg = pat.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                            smoother="chebyshev", n_coarse_max=512,
                            on_device_setup=True)
        h = with_spmv_backend(pat.setup(poisson_stencil((n,) * 3), cfg), "xla")
        r = pat.amg_pcg(h.levels[0].A, h, jnp.asarray(b_np).reshape((n,) * 3),
                        tol=1e-6, maxiter=100)
        iters = int(r.iters)
        hist = np.asarray(r.residual_history)[:iters + 1].tolist()
        rows = [int(l.A.n_rows) for l in h.levels]
    else:
        import torch

        import parallel_amg_tpu_torch as ptt
        from parallel_amg_tpu_torch.problems import poisson_stencil

        torch.set_num_threads(4)
        cfg = ptt.AMGConfig(coarsening="sa", aggregate="block", block_size=3,
                            smoother="chebyshev", n_coarse_max=512,
                            on_device_setup=True)
        h = ptt.setup(poisson_stencil((n,) * 3, device="cpu"), cfg, device="cpu")
        r = ptt.amg_pcg(h.levels[0].A, h, torch.from_numpy(b_np).reshape((n,) * 3),
                        tol=1e-6, maxiter=100)
        iters = r.iters
        hist = r.residual_history[:iters + 1].tolist()
        rows = [l.A.n_rows for l in h.levels]
    print(json.dumps({"which": which, "n": n, "iters": iters, "rows": rows,
                      "seconds": time.time() - t0, "history": hist}))


if __name__ == "__main__":
    main()
