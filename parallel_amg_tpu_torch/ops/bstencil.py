"""Block (vector-PDE) operators: Kronecker stencils and grid-layout BSR.

Counterpart of ``parallel_amg_tpu/ops/bstencil.py``.  The vector workload is
A = L ⊗ C: a scalar stencil L on the node grid and an SPD bs×bs coupling C,
so every stored matrix entry is a dense bs×bs block.  Transfers are P_s ⊗ I
with the scalar smoothed prolongator, so every Galerkin coarse operator
stays exactly L_c ⊗ C.  The fine level is stored as block-ELL
(:class:`~parallel_amg_tpu_torch.ops.bsr.BSR`, kernel B6), the coarse levels
as :class:`BlockStencil` (scalar planes and one C mix).

Vectors are (*node_dims, bs) grids throughout (node-major, component-minor,
the Kronecker row order), which is the (n, k) row-major layout that
``Stencil.matmat`` (kernel B7 on the card) reads and writes in place.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from parallel_amg_tpu_torch.amg.transfers import upsample_nd
from parallel_amg_tpu_torch.ops.bsr import BSR
from parallel_amg_tpu_torch.ops.stencil import Stencil


def _scalar_d_inv(L: Stencil):
    dL = L.diagonal()
    return torch.where(dL != 0, 1.0 / dL, 0.0)


class BlockStencil:
    """A = L ⊗ C: scalar stencil planes plus a constant bs×bs coupling.

    weights: (D, *dims) scalar planes (the Stencil convention); C: (bs, bs)
    tensor.  ``matvec`` on (*dims, bs) grids is one multi-RHS scalar pass
    (``Stencil.matmat`` over the component axis) followed by the C mix.
    """

    def __init__(self, weights, offsets, dims, C):
        self.L = Stencil(weights, offsets, dims)  # kept: its flat planes cache
        self.C = C

    def to(self, device) -> "BlockStencil":
        return BlockStencil(self.weights.to(device), self.offsets,
                            self.node_dims, self.C.to(device))

    # -- properties ---------------------------------------------------------
    @property
    def weights(self):
        return self.L.weights

    @property
    def offsets(self):
        return self.L.offsets

    @property
    def node_dims(self):
        return self.L.dims

    @property
    def bs(self) -> int:
        return int(self.C.shape[0])

    @property
    def dims(self):
        """Grid layout of the vectors this operator takes and gives."""
        return self.node_dims + (self.bs,)

    @property
    def n_nodes(self) -> int:
        return self.L.n

    @property
    def n_rows(self) -> int:
        return self.n_nodes * self.bs

    @property
    def shape(self):
        return (self.n_rows, self.n_rows)

    @property
    def n_points(self) -> int:
        return self.L.n_points

    @property
    def nnz(self) -> int:
        return int((self.weights != 0).sum()) * int((self.C != 0).sum())

    def scalar(self) -> Stencil:
        """The scalar factor L (shares the weight planes)."""
        return self.L

    # -- tensor ops -----------------------------------------------------------
    def matvec(self, x):
        """y = (L ⊗ C) x for x of shape (*node_dims, bs)."""
        z = self.L.matmat(x)   # L per component
        return z @ self.C.T    # y_i = Σ_j C_ij z_j

    def diagonal(self):
        """(*node_dims, bs) grid of diag(L)_p · diag(C)_i."""
        return self.L.diagonal()[..., None] * torch.diagonal(self.C)

    def to_csr(self):
        import scipy.sparse as sp

        from parallel_amg_tpu_torch.ops.csr import CSR

        L = self.L.to_csr().to_scipy()
        C = self.C.detach().cpu().double().numpy()
        return CSR.from_scipy(sp.kron(L, C).tocsr())

    def __matmul__(self, x):
        return self.matvec(x)


class BSRGridOperator:
    """Grid-layout adapter over a block-ELL BSR (or BTWELL) matrix: the
    fine level stored as BSR while speaking the (*node_dims, bs) grid
    protocol (the node-major component-minor grid IS the BSR element order,
    so the reshape is free)."""

    def __init__(self, bsr, node_dims):
        self.bsr = bsr
        self.node_dims = tuple(int(d) for d in node_dims)

    def to(self, device) -> "BSRGridOperator":
        return BSRGridOperator(self.bsr.to(device), self.node_dims)

    @property
    def bs(self) -> int:
        return self.bsr.bs

    @property
    def dims(self):
        return self.node_dims + (self.bs,)

    @property
    def n_rows(self) -> int:
        return self.bsr.shape[0]

    @property
    def shape(self):
        return self.bsr.shape

    @property
    def nnz(self) -> int:
        return self.bsr.nnz

    def matvec(self, x):
        return self.bsr.matvec(x.reshape(-1)).reshape(x.shape)

    def diagonal(self):
        return self.bsr.diagonal().reshape(self.dims)

    def to_csr(self):
        return self.bsr.to_csr()

    def __matmul__(self, x):
        return self.matvec(x)


def bsr_from_kron_stencil(L: Stencil, C, dtype=torch.float32) -> BSR:
    """Block-ELL BSR of A = L ⊗ C, built on L's device from its planes.

    Block row p (flat node id) has one slot per stencil offset:
    bcols[d, p] = flat(p + off_d) (0 where the neighbor leaves the grid; its
    block is zero there), vals[(d·bs + i)·bs + j, p] = W_d(p)·C_ij.  The
    planes are written one at a time into one allocation, so no second copy
    of the operator (8.6 GB at 324³×3) ever exists.
    """
    bs = int(np.asarray(C).shape[0])
    n, D = L.n, L.n_points
    dev = L.weights.device
    Ct = torch.as_tensor(np.asarray(C), dtype=dtype, device=dev)
    cols, oks = kron_columns(L)
    bcols = torch.stack([c.to(torch.int32) for c in cols])
    del cols
    vals = torch.empty((D * bs * bs, n), dtype=dtype, device=dev)
    W = L.weights.reshape(D, n)
    for d in range(D):
        ws = torch.where(oks[d], W[d], 0.0)
        for i in range(bs):
            for j in range(bs):
                vals[(d * bs + i) * bs + j] = (ws * Ct[i, j]).to(dtype)
    brow_nnz = torch.full((n,), D, dtype=torch.int32, device=dev)
    return BSR(bcols, vals, brow_nnz, (n * bs, n * bs), bs)


def kron_columns(L):
    """Per offset d: the flat neighbor id of every node (0 off the grid),
    int64, and the bool mask of nodes whose neighbor is on the grid."""
    dims = L.dims
    dev = L.weights.device
    coords = torch.meshgrid(*[torch.arange(n, device=dev) for n in dims],
                            indexing="ij")
    cols, oks = [], []
    for off in L.offsets:
        ok = torch.ones(dims, dtype=torch.bool, device=dev)
        flat = torch.zeros(dims, dtype=torch.int64, device=dev)
        stride = 1
        for i in reversed(range(len(dims))):
            nb = coords[i] + off[i]
            ok = ok & (nb >= 0) & (nb < dims[i])
            flat = flat + nb * stride
            stride *= dims[i]
        cols.append(torch.where(ok, flat, 0).reshape(-1))
        oks.append(ok.reshape(-1))
    return cols, oks


# ---------------------------------------------------------------------------
# vector (⊗ I) transfers: the scalar block transfers applied per component,
# so P = P_s ⊗ I and the Galerkin hierarchy stays Kronecker
# ---------------------------------------------------------------------------


class _VectorTransfer:
    """Shared state of the vector block transfers.

    ``L``/``d_inv_L`` are the level's scalar stencil and its diagonal
    inverse when the level operator is BSR (which cannot give its scalar
    factor back); pass None for both to LINK the transfer to a BlockStencil
    level, whose scalar factor it borrows at apply time.  ``coef`` is ω/λ_max
    of the scalar level, a Python float holding a float32 value.
    """

    def __init__(self, L, d_inv_L, scale, coef, dims, cdims, block, bs):
        self.L = L
        self.d_inv_L = d_inv_L
        self.scale = scale      # (*cdims,)
        self.coef = float(coef)
        self.node_dims = tuple(int(d) for d in dims)
        self.cdims = tuple(int(d) for d in cdims)
        self.block = int(block)
        self.bs = int(bs)

    def to(self, device):
        return type(self)(None if self.L is None else self.L.to(device),
                          None if self.d_inv_L is None else self.d_inv_L.to(device),
                          self.scale.to(device), self.coef, self.node_dims,
                          self.cdims, self.block, self.bs)

    @property
    def linked(self) -> bool:
        return self.L is None

    def _scalar(self, A):
        if self.L is not None:
            return self.L, self.d_inv_L
        L = A.scalar()
        return L, _scalar_d_inv(L)

    def matvec(self, v):
        return self.matvec_linked(None, None, v)


class VectorBlockProlongator(_VectorTransfer):
    """(P_s ⊗ I) @ xc with P_s = (I − coef·D_L⁻¹L) T_s on the node grid."""

    @property
    def shape(self):
        return (int(np.prod(self.node_dims)) * self.bs,
                int(np.prod(self.cdims)) * self.bs)

    def zeros_coarse(self, dtype):
        return torch.zeros(self.cdims + (self.bs,), dtype=dtype,
                           device=self.scale.device)

    def matvec_linked(self, A, d_inv, xc):
        L, dL = self._scalar(A)
        t = upsample_nd(xc * self.scale[..., None], self.node_dims, self.block)
        return t - self.coef * (dL[..., None] * L.matmat(t))


class VectorBlockRestrictor(_VectorTransfer):
    """(R_s ⊗ I) @ r = scale · pool(r − coef·L(D_L⁻¹ r)) per component."""

    @property
    def shape(self):
        return (int(np.prod(self.cdims)) * self.bs,
                int(np.prod(self.node_dims)) * self.bs)

    def matvec_linked(self, A, d_inv, r):
        L, dL = self._scalar(A)
        s = r - self.coef * L.matmat(dL[..., None] * r)
        return self.scale[..., None] * _pool_nodes(s, self.cdims, self.block)


def _pool_nodes(y, cdims, block):
    """Sum-pool the node axes of a (*node_dims, bs) grid (components kept):
    zero-pad to whole blocks, reshape each node axis c·b to (c, b), sum the
    b axes."""
    nd = len(cdims)
    flat = [0, 0]
    for i in reversed(range(nd)):
        flat += [0, cdims[i] * block - y.shape[i]]
    yp = F.pad(y, flat)
    shape = []
    for c in cdims:
        shape += [c, block]
    yp = yp.reshape(shape + [y.shape[-1]])
    return yp.sum(dim=tuple(2 * i + 1 for i in range(nd)))
