"""The exchange between the parts of a row mesh, in one place.

Every copy of data from one part to another goes through this module: the
collectives of the JAX package's distributed layer (``lax.all_to_all``, the
``ppermute`` shifts and ``psum``) and the whole-vector gathers of its
replicated values.  Arguments and results are lists with one tensor per part
this process holds (``RowMesh.local``, in order); every part's tensor has one
shape and dtype, the static-shape discipline of the plans.

- ``all_to_all``: row d of part s's buffer goes to part d;
- ``ring_shift``: part j receives part (j − d) mod S's buffer;
- ``halos``: each part's neighbours' boundary planes, None past the grid's
  two ends; ``start_halos`` returns a handle whose ``wait`` delivers them,
  so compute can run between;
- ``psum``: Σ over all parts, summed in global part order, the same float on
  every process;
- ``all_gather``: every part's tensor, in global part order, on every
  process.

In one process (``mesh.process()`` gives world 1) each function is one stack,
one gather or one slice on the parts' device, and parts on several cards move
by ``.to(device)`` copies.  With several processes (``mesh.runtime_init``)
they are ``torch.distributed`` calls: ``all_to_all_single`` over the
process-level blocks, ``batch_isend_irecv`` between the ranks that hold
neighbours, and ``all_gather``.  Under the "gloo" backend a CUDA tensor is
staged through pinned host memory (the route that lets several processes
share one card); under "nccl" the tensors stay on the cards with no staging,
which needs a card per process and has not been run.  A failed collective
raises.

``STATS`` counts the multi-process calls and the host seconds they take,
staging included; callers may reset it.
"""

from __future__ import annotations

import functools
import hashlib
import time

import numpy as np
import torch

from parallel_amg_tpu_torch.parallel.mesh import process

STATS = {"calls": 0, "seconds": 0.0}


def _one_device(tensors) -> bool:
    dev = tensors[0].device
    return all(t.device == dev for t in tensors)


# -- the wire: what the backend's collectives take ------------------------------

def _staged(t) -> bool:
    return t.is_cuda and torch.distributed.get_backend() == "gloo"


@functools.cache
def _side_stream(index: int):
    return torch.cuda.Stream(device=index)


def _to_wire(tensors, *, side: bool = False):
    """The tensors as the backend sends them: contiguous, bool as uint8, and
    under gloo a CUDA tensor copied to pinned host memory.  ``side=True``
    makes the copies on a side stream after the work queued so far and
    returns (wires, event) without waiting; else the copies are waited
    for."""
    wires, event = [], None
    stream = None
    for t in tensors:
        if t.dtype == torch.bool:
            t = t.view(torch.uint8)
        if not _staged(t):
            wires.append(t.contiguous())
            continue
        if stream is None:
            stream = (_side_stream(t.device.index) if side
                      else torch.cuda.current_stream(t.device))
            if side:
                stream.wait_stream(torch.cuda.current_stream(t.device))
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            h.copy_(t, non_blocking=True)
            t.record_stream(stream)
        wires.append(h)
    if stream is not None:
        event = stream.record_event()
        if not side:
            event.synchronize()
    return (wires, event) if side else wires


def _from_wire(w, like):
    """A received wire tensor as ``like``'s device and dtype."""
    out = w.to(like.device, non_blocking=True)
    return out.view(torch.bool) if like.dtype == torch.bool else out


def _empty_wire(like):
    """A landing buffer for a tensor shaped like ``like``."""
    dtype = torch.uint8 if like.dtype == torch.bool else like.dtype
    if _staged(like):
        return torch.empty(like.shape, dtype=dtype, pin_memory=True)
    return torch.empty(like.shape, dtype=dtype, device=like.device)


def _timed(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            STATS["calls"] += 1
            STATS["seconds"] += time.perf_counter() - t0
    return run


def _stack(parts):
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts])


# -- the collectives ----------------------------------------------------------

def all_to_all(bufs):
    """``lax.all_to_all(..., 0, 0, tiled=True)`` over the parts.

    ``bufs[i]`` is local part s's (S, ...) send buffer, row d going to part
    d.  Returns ``recv`` with ``recv[i][s] = bufs_of_part_s[d]`` for local
    part d = ``local[i]``, on part d's device.
    """
    world = process()[1]
    if world == 1:
        S = len(bufs)
        if _one_device(bufs):
            return list(torch.stack(bufs, 1).unbind(0))
        return [torch.stack([bufs[s][d].to(bufs[d].device) for s in range(S)])
                for d in range(S)]
    return _all_to_all(bufs, world)


@_timed
def _all_to_all(bufs, world):
    L = len(bufs)
    x = _stack(bufs)                                   # (L_s, S, ...)
    rest = tuple(x.shape[2:])
    x = x.reshape((L, world, L) + rest).transpose(0, 1)  # (rank_d, L_s, L_d, ...)
    (w,) = _to_wire([x])
    out = torch.empty_like(w)
    torch.distributed.all_to_all_single(out, w)
    out = _from_wire(out, x)                           # (rank_s, L_s, L_d, ...)
    dims = (2, 0, 1) + tuple(range(3, out.dim()))
    return list(out.permute(dims).reshape((L, L * world) + rest).unbind(0))


def _copy_to(t, dev):
    """t on device ``dev``: itself where it is there already; across CUDA
    cards a copy on ``dev``'s side stream, returned with the event that
    marks its end; else a plain copy."""
    if t.device == dev:
        return t, None
    if not (t.is_cuda and dev.type == "cuda"):
        return t.to(dev), None
    land = torch.empty(t.shape, dtype=t.dtype, device=dev)
    stream = _side_stream(dev.index)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        land.copy_(t, non_blocking=True)
        land.record_stream(stream)
        t.record_stream(stream)
    return land, stream.record_event()


class _Shift:
    """A started shift: ``wait()`` returns the per-part results."""

    def __init__(self, out, copies=(), recvs=(), sends=(), wires=(),
                 event=None):
        self.out, self.copies, self.recvs, self.sends = out, copies, recvs, sends
        self.wires, self.event = wires, event

    def wait(self):
        for dev, ev in self.copies:
            torch.cuda.current_stream(dev).wait_event(ev)
        if not self.recvs and not self.sends:
            return self.out
        return self._finish()

    @_timed
    def _finish(self):
        dist = torch.distributed
        if self.event is not None:
            self.event.synchronize()
        ops = [dist.P2POp(dist.isend, w, peer, tag=tag)
               for w, (peer, tag) in zip(self.wires, self.sends)]
        lands = [_empty_wire(like) for _, like, _, _ in self.recvs]
        ops += [dist.P2POp(dist.irecv, buf, peer, tag=tag)
                for buf, (_, _, peer, tag) in zip(lands, self.recvs)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for buf, (i, like, _, _) in zip(lands, self.recvs):
            self.out[i] = _from_wire(buf, like)
        return self.out


def start_shift(bufs, d: int, wrap: bool):
    """Start a shift by d: local part j = ``local[i]`` receives part j − d's
    buffer (mod S when ``wrap``; else None where j − d is off the grid), on
    its own device.  Returns a handle; its ``wait()`` gives the list.  A
    buffer already on the receiver's device is passed as it is (a view);
    one on another card is copied on a side stream, and ``wait`` makes the
    receiver's stream wait for it; under gloo the outgoing CUDA buffers are
    copied to the host on a side stream.  Work queued between the two calls
    overlaps the exchange."""
    rank, world = process()
    L = len(bufs)
    S, base = L * world, rank * L
    out, copies, recvs, sends = [None] * L, [], [], []
    for i in range(L):
        j = base + i
        src, dst = j - d, j + d
        if wrap:
            src, dst = src % S, dst % S
        if 0 <= src < S:
            if base <= src < base + L:
                out[i], ev = _copy_to(bufs[src - base], bufs[i].device)
                if ev is not None:
                    copies.append((bufs[i].device, ev))
            else:
                recvs.append((i, bufs[i], src // L, j))
        if 0 <= dst < S and not base <= dst < base + L:
            sends.append((i, dst // L, dst))
    if not recvs and not sends:
        return _Shift(out, copies)
    wires, event = _to_wire([bufs[i] for i, _, _ in sends], side=True)
    return _Shift(out, copies, recvs, [(peer, tag) for _, peer, tag in sends],
                  wires, event)


def ring_shift(bufs, d: int):
    """``ppermute`` with the ring shift (i → (i + d) mod S): part j receives
    the buffer of part (j − d) mod S, on part j's device."""
    return start_shift(bufs, d, wrap=True).wait()


class _Halos:
    def __init__(self, left, right):
        self.left, self.right = left, right

    def wait(self):
        return list(zip(self.left.wait(), self.right.wait()))


def start_halos(parts, h: int, axis: int = 0):
    """Start the exchange of each part's neighbour halos along ``axis``:
    ``wait()`` gives per local part (left, right), the last h planes of
    part p − 1 and the first h planes of part p + 1, None at the grid's two
    ends."""
    def planes(t, sl):
        return t[(slice(None),) * axis + (sl,)]

    return _Halos(start_shift([planes(t, slice(-h, None)) for t in parts], 1,
                              wrap=False),
                  start_shift([planes(t, slice(0, h)) for t in parts], -1,
                              wrap=False))


def halos(parts, h: int, axis: int = 0):
    """Per local part the (left, right) halos of ``start_halos``, now."""
    return start_halos(parts, h, axis).wait()


def all_gather(parts):
    """Every part's tensor in global part order, on the device of this
    process's first part (the JAX package's replicated value)."""
    world = process()[1]
    dev = parts[0].device
    if world == 1:
        return [p.to(dev) for p in parts]
    return _all_gather(parts, world)


@_timed
def _all_gather(parts, world):
    x = _stack(parts)
    (w,) = _to_wire([x])
    outs = [torch.empty_like(w) for _ in range(world)]
    torch.distributed.all_gather(outs, w)
    return list(_from_wire(torch.cat(outs), x).unbind(0))


def psum(parts):
    """Σ over all parts, on this process's first part's device: the gathered
    stack summed in global part order, so the float sum is the same on
    every call and every process."""
    return torch.stack(all_gather(parts)).sum(0)


def pmax(parts):
    """Max over all parts (exact in any order), on every process."""
    return torch.stack(all_gather(parts)).amax(0)


def max_int(values, device) -> int:
    """The largest of every part's host integer (``values`` holds the local
    parts'), the same on every process."""
    if process()[1] == 1:
        return max(values)
    return int(pmax([torch.tensor(v, device=device) for v in values]))


def check_replicated(arrays, device, what: str) -> None:
    """Raise unless every process holds the same host ``arrays`` (values a
    multi-process run computes on each process, such as the host oracle's
    levels): a digest of their bytes is gathered and compared."""
    if process()[1] == 1:
        return
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    mine = int.from_bytes(h.digest()[:7], "little")
    got = all_gather([torch.tensor(mine, device=device)])
    if any(int(g) != mine for g in got):
        raise RuntimeError(f"{what} differs between the processes")
