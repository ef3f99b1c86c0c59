"""Run one function on several processes joined by ``runtime_init``.

    results = launch.spawn(fn, world, args=(...), timeout_s=120)

``fn`` is a function defined at the top level of a module (a script run as
``__main__`` counts as the module of its file name).  Each rank is a fresh
``python -m parallel_amg_tpu_torch.parallel.launch`` process: it sets its
torch thread count, joins the others through ``mesh.runtime_init`` (the
gloo route) with a ``FileStore`` in a new directory, imports the module, calls
``fn(*args)`` and pickles the return value.  The parent waits for every rank
up to ``timeout_s``.  A rank that fails, or a run that outlasts the timeout,
kills every rank and raises with the tail of each rank's stderr, so a hang
costs one timeout and never the caller's whole budget.  A rank that imports
JAX fails: the port never does.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def _target(fn):
    """(directory, module name, function name) a fresh process imports."""
    mod = sys.modules[fn.__module__]
    path = Path(mod.__file__).resolve()
    name = path.stem if fn.__module__ == "__main__" else fn.__module__
    depth = name.count(".")
    return str(path.parents[depth]), name, fn.__qualname__


def _tail(path: Path, n: int = 3000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except FileNotFoundError:
        return ""


def spawn(fn, world: int, args=(), *, timeout_s: float = 120.0,
          threads: int = 1, store_dir=None) -> list:
    """``fn(*args)`` on ``world`` ranks joined over gloo; returns the ranks'
    results in rank order.  ``store_dir`` (a new temporary directory when
    None) holds the FileStore, the arguments, the results and each rank's
    output."""
    own = store_dir is None
    tmp = tempfile.TemporaryDirectory(prefix="ptt_ranks_") if own else None
    root = Path(tmp.name if own else store_dir)
    root.mkdir(parents=True, exist_ok=True)
    try:
        directory, module, name = _target(fn)
        (root / "args.pkl").write_bytes(pickle.dumps(
            (directory, module, name, tuple(args))))
        store = root / "store"
        if store.exists():
            store.unlink()
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = os.pathsep.join(
            [str(_PACKAGE_ROOT), directory]
            + [p for p in [os.environ.get("PYTHONPATH")] if p])
        procs = []
        for rank in range(world):
            with open(root / f"rank{rank}.out", "wb") as out, \
                    open(root / f"rank{rank}.err", "wb") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", __name__, str(root), str(rank),
                     str(world), str(threads), str(timeout_s)],
                    stdout=out, stderr=err, env=child_env,
                    cwd=str(_PACKAGE_ROOT)))
        deadline = time.monotonic() + timeout_s
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"the ranks outlasted their {timeout_s} s timeout"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if failed is None and any(p.returncode for p in procs):
            bad = [r for r, p in enumerate(procs) if p.returncode]
            failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
        if failed is not None:
            tails = "\n".join(f"--- rank {r} stderr ---\n{_tail(root / f'rank{r}.err')}"
                              for r in range(world))
            raise RuntimeError(f"multi-process run of {module}.{name}: "
                               f"{failed}\n{tails}")
        return [pickle.loads((root / f"rank{r}.pkl").read_bytes())
                for r in range(world)]
    finally:
        if own:
            tmp.cleanup()


def _rank_main(root: str, rank: str, world: str, threads: str,
               timeout_s: str) -> None:
    import importlib

    import torch

    torch.set_num_threads(int(threads))
    root_path = Path(root)
    directory, module, name, args = pickle.loads(
        (root_path / "args.pkl").read_bytes())
    if directory not in sys.path:
        sys.path.insert(0, directory)
    from parallel_amg_tpu_torch.parallel.mesh import runtime_init

    runtime_init(str(root_path / "store"), int(world), int(rank),
                 backend="gloo", timeout_s=float(timeout_s))
    fn = getattr(importlib.import_module(module), name)
    result = fn(*args)
    if "jax" in sys.modules:
        raise RuntimeError(f"rank {rank} imported JAX")
    (root_path / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:])
