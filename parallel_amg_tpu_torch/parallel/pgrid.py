"""PGrid: a grid array split on axis 0 over the parts of a row mesh.

What ``NamedSharding(mesh, P(ROW_AXIS))`` gives a grid array in the JAX
package (``parallel/pstructured.py``): part p holds axis-0 planes
[p·m0, (p+1)·m0) of the padded global grid, on ``mesh.device(p)``, and a
process holds the parts ``mesh.local`` only.  Elementwise arithmetic runs
part by part; ``dot`` and ``norm`` reduce the per-part partials through
``exchange``, the same value on every process.

The cycle, the smoothers and PCG take a PGrid wherever they take a tensor,
through the helpers at the end of this module (``vdot``, ``norm``,
``zeros_like``, ``reshape``), which leave a tensor's path unchanged.
"""

from __future__ import annotations

import numbers

import torch

from parallel_amg_tpu_torch.ops import ordered_sum
from parallel_amg_tpu_torch.parallel import exchange


class PGrid:
    """Per-part axis-0 slabs of one padded global grid: ``parts[i]`` is
    global part ``mesh.local[i]``."""

    def __init__(self, parts, mesh):
        self.parts = list(parts)
        self.mesh = mesh
        if len(self.parts) != mesh.n_local:
            raise ValueError(f"{len(self.parts)} parts where this process holds "
                             f"{mesh.n_local} of a mesh of {mesh.size}")

    # -- layout ------------------------------------------------------------
    @property
    def shape(self):
        """The padded global dims."""
        return (self.parts[0].shape[0] * self.mesh.size,) + tuple(
            self.parts[0].shape[1:])

    @property
    def ndim(self) -> int:
        return self.parts[0].dim()

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The first local part's device, where reductions land."""
        return self.parts[0].device

    @classmethod
    def from_global(cls, v, mesh) -> "PGrid":
        """Split a global grid tensor (the same on every process) into equal
        axis-0 parts and keep this process's."""
        S = mesh.size
        if v.shape[0] % S:
            raise ValueError(f"axis 0 of {tuple(v.shape)} does not split into "
                             f"{S} equal parts")
        m0 = v.shape[0] // S
        return cls([v[p * m0:(p + 1) * m0].to(mesh.device(p)).contiguous()
                    for p in mesh.local], mesh)

    def to_global(self, device=None):
        """The whole grid as one tensor on ``device`` (the first local
        part's when None), on every process (``exchange.all_gather``)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([p.to(dev) for p in exchange.all_gather(self.parts)],
                         dim=0)

    def zeros_like(self) -> "PGrid":
        return PGrid([torch.zeros_like(p) for p in self.parts], self.mesh)

    def map(self, fn, *others) -> "PGrid":
        """PGrid of fn(part, other parts...) for PGrids ``others``."""
        return PGrid([fn(p, *(o.parts[i] for o in others))
                      for i, p in enumerate(self.parts)], self.mesh)

    # -- arithmetic --------------------------------------------------------
    def _operand(self, other, i):
        """Part i's view of ``other``: a number, a 0-d tensor (moved to the
        part's device), a PGrid's part i or a per-part sequence's item i."""
        if isinstance(other, PGrid):
            return other.parts[i]
        if isinstance(other, (list, tuple)):
            return other[i]
        if isinstance(other, torch.Tensor):
            if other.dim() != 0:
                raise TypeError("a PGrid combines with 0-d tensors, PGrids and "
                                f"per-part sequences, not a {tuple(other.shape)} tensor")
            return other.to(self.parts[i].device)
        if isinstance(other, numbers.Number):
            return other
        return NotImplemented

    def _binary(self, other, op):
        out = []
        for i, p in enumerate(self.parts):
            o = self._operand(other, i)
            if o is NotImplemented:
                return NotImplemented
            out.append(op(p, o))
        return PGrid(out, self.mesh)

    def __add__(self, other):
        return self._binary(other, lambda a, b: a + b)

    def __radd__(self, other):
        return self._binary(other, lambda a, b: b + a)

    def __sub__(self, other):
        return self._binary(other, lambda a, b: a - b)

    def __rsub__(self, other):
        return self._binary(other, lambda a, b: b - a)

    def __mul__(self, other):
        return self._binary(other, lambda a, b: a * b)

    def __rmul__(self, other):
        return self._binary(other, lambda a, b: b * a)

    def __truediv__(self, other):
        return self._binary(other, lambda a, b: a / b)

    def __neg__(self):
        return PGrid([-p for p in self.parts], self.mesh)

    # -- reductions (the psum) ---------------------------------------------
    def dot(self, other: "PGrid"):
        """Σ_p vdot(part p, other's part p), summed in part order
        (``exchange.psum``)."""
        return exchange.psum([torch.vdot(a.reshape(-1), b.reshape(-1))
                              for a, b in zip(self.parts, other.parts)])

    def norm(self):
        """2-norm: the norm of the per-part norms, gathered in part order."""
        return torch.linalg.norm(torch.stack(exchange.all_gather(
            [torch.linalg.norm(p) for p in self.parts])))


def ordered_norm(v: PGrid):
    """2-norm in the order of ``jnp.linalg.norm`` of a sharded array on the
    JAX package's CPU backend (its power iterations): each part's Σ y² by
    ``ordered_sum.sumsq``, the parts' sums gathered and added left to right
    in part order, one square root.  ``PGrid.norm`` (the Krylov solvers')
    keeps torch's order."""
    sums = exchange.all_gather([ordered_sum.sumsq(p) for p in v.parts])
    return ordered_sum.sqrt(ordered_sum.row_sum(torch.stack(sums), 1, ordered_sum.CHAIN))


# -- helpers the solve path calls on tensors and PGrids alike -----------------

def vdot(a, b):
    """Inner product of two grids (flattened, as ``jnp.vdot``)."""
    if isinstance(a, PGrid):
        return a.dot(b)
    return torch.vdot(a.reshape(-1), b.reshape(-1))


def norm(v):
    return v.norm() if isinstance(v, PGrid) else torch.linalg.norm(v)


def zeros_like(v):
    return v.zeros_like() if isinstance(v, PGrid) else torch.zeros_like(v)


def reshape(v, shape):
    """``v.reshape(shape)`` for a tensor; a PGrid stays as it is."""
    return v if isinstance(v, PGrid) else v.reshape(shape)
