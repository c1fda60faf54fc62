"""Blocked-ELL sparse matrix: dense b x b blocks, and the block smoothers.

Counterpart of ``raptor_tpu/core/bell.py``.  Layout: block-entry-major
``data (K, nb_pad, b, b)`` / ``cols (K, nb_pad)``, the block-row axis the
long one.  The two block applies launch the hand-written kernel K8
(``ops/cuda/bell_kernel.py``) for blocks on the card, which reads each
block once; for blocks elsewhere they are the reference's (nb_pad, b, b) x
(nb_pad, b) contractions (``torch.einsum``).  The two differ only in the
order of a row's sum.

Vectors may carry a leading batch dimension (B, n), as the scalar
smoothers' do (``solve/cycle.materialize_tail``).  The leaves are NumPy
arrays while a hierarchy is built on the host; ``BlockEllMatrix.to``
moves them to a device.

The two block applies are the launch sites: ``bell_spmv`` is a span
``bell.spmv[nb_pad,K,b,dtype]`` and ``_block_prec`` a span
``bell.prec[nb_pad,b,dtype]`` (``utils/profiling.py``), and ``launches``
counts their calls on any device, as ``ops/cuda/launch.py`` counts the
kernels' launches.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.ell import _np, pad_rows, to_tensor
from raptor_tpu_torch.ops.cuda import bell_kernel as k8
from raptor_tpu_torch.utils.profiling import phase

# keys "bell_spmv", "bell_prec"
launches: collections.Counter = collections.Counter()

__all__ = ["BlockEllMatrix", "bell_from_bsr", "bell_to_bsr", "bell_spmv",
           "block_diag_inv", "block_jacobi", "ell_to_bell",
           "block_chebyshev4", "estimate_lmax_bell", "launches"]


@dataclasses.dataclass(frozen=True)
class BlockEllMatrix:
    data: Any  # (K, nb_pad, b, b)
    cols: Any  # (K, nb_pad) int32 block-column indices
    row_nnz: Any  # (nb_pad,) int32
    shape: Tuple[int, int]  # logical scalar shape
    bs: int
    nb_pad: int

    @property
    def K(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def slot_mask(self):
        k = torch.arange(self.K, device=self.data.device)[:, None]
        return k < self.row_nnz[None, :]

    def to(self, device) -> "BlockEllMatrix":
        return dataclasses.replace(
            self, data=to_tensor(self.data, device),
            cols=to_tensor(self.cols, device),
            row_nnz=to_tensor(self.row_nnz, device))

    def cast(self, dtype) -> "BlockEllMatrix":
        """The same matrix with its block values cast to ``dtype``."""
        return dataclasses.replace(self, data=self.data.to(dtype))


def bell_from_bsr(a, bs: int = 3, dtype=np.float32,
                  row_pad_multiple: int = 8) -> BlockEllMatrix:
    """scipy sparse (any format) -> BlockEllMatrix with b x b blocks and
    NumPy leaves.  Identity blocks pad the block rows beyond the logical
    size."""
    import scipy.sparse as sp

    a = sp.bsr_matrix(a, blocksize=(bs, bs))
    nb = a.shape[0] // bs
    nb_pad = pad_rows(nb, row_pad_multiple)
    nnz = np.diff(a.indptr).astype(np.int32)
    K = max(int(nnz.max(initial=0)), 1)
    data = np.zeros((K, nb_pad, bs, bs), dtype=dtype)
    cols = np.zeros((K, nb_pad), dtype=np.int32)
    nnz_pad = np.zeros(nb_pad, dtype=np.int32)
    nnz_pad[:nb] = nnz
    if a.nnz:
        r = np.repeat(np.arange(nb), nnz)
        slot = np.arange(len(a.indices)) - np.repeat(a.indptr[:-1], nnz)
        data[slot, r] = a.data.astype(dtype)
        cols[slot, r] = a.indices.astype(np.int32)
    if nb_pad > nb:
        data[0, nb:] = np.eye(bs, dtype=dtype)
        cols[0, nb:] = np.arange(nb, nb_pad)
        nnz_pad[nb:] = 1
    return BlockEllMatrix(data=data, cols=cols, row_nnz=nnz_pad,
                          shape=a.shape, bs=bs, nb_pad=nb_pad)


def bell_to_bsr(A: BlockEllMatrix):
    """BlockEllMatrix -> scipy bsr_matrix of the logical shape."""
    import scipy.sparse as sp

    nb = A.shape[0] // A.bs
    data, cols, nnz = _np(A.data), _np(A.cols), _np(A.row_nnz)
    blocks, rows_l, cols_l = [], [], []
    for k in range(A.K):
        idx = np.nonzero((np.arange(A.nb_pad) < nb) & (k < nnz))[0]
        keep = cols[k, idx] < nb
        blocks.append(data[k, idx[keep]])
        rows_l.append(idx[keep])
        cols_l.append(cols[k, idx[keep]])
    rows, colv, blks = (np.concatenate(rows_l), np.concatenate(cols_l),
                        np.concatenate(blocks))
    order = np.lexsort((colv, rows))
    indptr = np.searchsorted(rows[order], np.arange(nb + 1))
    return sp.bsr_matrix((blks[order], colv[order], indptr), shape=A.shape)


def _spmv_einsum(data, cols, x: torch.Tensor) -> torch.Tensor:
    """The reference's y = A @ x: a gather of x, then one contraction."""
    _, nb, b, _ = data.shape
    # (..., K, nb, b)
    xg = x.reshape(*x.shape[:-1], nb, b)[..., cols.long(), :]
    return torch.einsum("knij,...knj->...ni", data, xg).reshape(x.shape)


def _prec_einsum(binv, r: torch.Tensor) -> torch.Tensor:
    """The reference's Dblk^{-1} r: one contraction."""
    nb, b, _ = binv.shape
    return torch.einsum("nij,...nj->...ni", binv,
                        r.reshape(*r.shape[:-1], nb, b)).reshape(r.shape)


def bell_spmv(A: BlockEllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x, x of length nb_pad * bs (a padded vector, or a batch of
    them)."""
    launches["bell_spmv"] += 1
    with phase("bell.spmv", (A.nb_pad, A.K, A.bs, A.data.dtype)):
        if A.data.is_cuda:
            return k8.bell_spmv(A.data, A.cols, A.row_nnz, x.contiguous())
        return _spmv_einsum(A.data, A.cols, x)


def _block_prec(binv, A: BlockEllMatrix, r: torch.Tensor) -> torch.Tensor:
    """Dblk^{-1} r, block row by block row."""
    launches["bell_prec"] += 1
    with phase("bell.prec", (A.nb_pad, A.bs, binv.dtype)):
        if binv.is_cuda:
            return k8.bell_diag(binv, r.contiguous())
        return _prec_einsum(binv, r)


def block_diag_inv(A: BlockEllMatrix) -> torch.Tensor:
    """(nb_pad, b, b) inverses of the diagonal blocks (setup)."""
    rows = torch.arange(A.nb_pad, device=A.data.device)[None, :]
    hit = (A.cols == rows) & A.slot_mask()
    diag = torch.einsum("kn,knij->nij", hit.to(A.dtype), A.data)
    return torch.linalg.inv(diag)


def block_jacobi(A: BlockEllMatrix, dinv_blocks, b, x,
                 omega: float = 2.0 / 3.0, sweeps: int = 1,
                 x0_zero: bool = False) -> torch.Tensor:
    """Block Jacobi: x += omega * Dblk^{-1} (b - A x), ``sweeps`` times;
    with ``x0_zero`` the first residual is b."""
    if x0_zero and sweeps:
        x = omega * _block_prec(dinv_blocks, A, b)
        sweeps -= 1
    for _ in range(sweeps):
        x = x + omega * _block_prec(dinv_blocks, A, b - bell_spmv(A, x))
    return x


def ell_to_bell(E, bs: int) -> BlockEllMatrix:
    """Scalar EllMatrix -> BlockEllMatrix with ``bs x bs`` blocks on E's
    device (NumPy leaves give NumPy leaves), padded to exactly
    n_rows_pad / bs block rows so block vectors are the scalar path's
    padded vectors; identity blocks pad the block rows beyond the logical
    size.  A block row's blocks come in the order of their first entry,
    scalar row by scalar row and by column within a row: SciPy's CSR ->
    BSR order (``bell_from_bsr(ell_to_csr(E))``), so the two give the same
    arrays.  One host read, for the width."""
    n, m = E.shape
    assert n % bs == 0, (E.shape, bs)
    assert E.n_rows_pad % bs == 0, (E.n_rows_pad, bs)
    host = not isinstance(E.data, torch.Tensor)
    data, cols, row_nnz = (torch.from_numpy(np.asarray(t)) if host else t
                           for t in (E.data, E.cols, E.row_nnz))
    dev = data.device
    K, n_pad = data.shape
    nb, nb_pad, nbc = n // bs, E.n_rows_pad // bs, -(-m // bs)
    rows = torch.arange(n_pad, device=dev).expand(K, -1)
    keep = ((torch.arange(K, device=dev)[:, None] < row_nnz[None, :])
            & (rows < n) & (cols < m))
    r, c, v = rows[keep], cols[keep].long(), data[keep]
    bi, bj = torch.div(r, bs, rounding_mode="floor"), torch.div(
        c, bs, rounding_mode="floor")
    # the distinct blocks, and the scalar row of each one's first entry
    blk, which = torch.unique(bi * nbc + bj, return_inverse=True)
    first = torch.full_like(blk, bs).scatter_reduce_(0, which, r - bi * bs,
                                                     "amin")
    ub, uj = torch.div(blk, nbc, rounding_mode="floor"), blk % nbc
    order = torch.sort((ub * bs + first) * nbc + uj).indices
    per_row = torch.bincount(ub, minlength=nb)
    start = torch.cumsum(per_row, 0) - per_row
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=dev) - start[ub[order]]
    Kb = max(int(per_row.max()) if nb else 0, 1)
    out = torch.zeros(Kb, nb_pad, bs, bs, dtype=data.dtype, device=dev)
    out_cols = torch.zeros(Kb, nb_pad, dtype=torch.int32, device=dev)
    out_nnz = torch.ones(nb_pad, dtype=torch.int32, device=dev)
    out[slot[which], bi, r - bi * bs, c - bj * bs] = v
    out_cols[slot, ub] = uj.to(torch.int32)
    out_nnz[:nb] = per_row.to(torch.int32)
    if nb_pad > nb:
        out[0, nb:] = torch.eye(bs, dtype=data.dtype, device=dev)
        out_cols[0, nb:] = torch.arange(nb, nb_pad, dtype=torch.int32,
                                        device=dev)
    if host:
        out, out_cols, out_nnz = out.numpy(), out_cols.numpy(), out_nnz.numpy()
    return BlockEllMatrix(data=out, cols=out_cols, row_nnz=out_nnz,
                          shape=(n, m), bs=bs, nb_pad=nb_pad)


def block_chebyshev4(A: BlockEllMatrix, binv, b, x, lmax, degree: int = 3,
                     x0_zero: bool = False) -> torch.Tensor:
    """Fourth-kind Chebyshev smoothing preconditioned by the block
    diagonal (``solve/smoothers.chebyshev4`` with Dblk^{-1} for D^{-1})."""
    r = b if x0_zero else b - bell_spmv(A, x)
    d = (4.0 / 3.0) / lmax * _block_prec(binv, A, r)
    x = x + d
    for k in range(2, degree + 1):
        r = r - bell_spmv(A, d)
        d = ((2 * k - 3) / (2 * k + 1)) * d + (
            (8 * k - 4) / (2 * k + 1) / lmax
        ) * _block_prec(binv, A, r)
        x = x + d
    return x


def estimate_lmax_bell(A: BlockEllMatrix, binv, iters: int = 40,
                       safety: float = 1.1) -> torch.Tensor:
    """lambda_max(Dblk^{-1} A) by power iteration from the scalar
    estimate's start vector (setup; 0-d tensor, no host read)."""
    n = A.nb_pad * A.bs
    i = torch.arange(n, dtype=A.dtype, device=A.data.device)
    v = torch.sin(i * 0.7511) + 0.01
    v = v / torch.linalg.norm(v)

    def app(v):
        return _block_prec(binv, A, bell_spmv(A, v))

    for _ in range(iters):
        w = app(v)
        v = w / torch.linalg.norm(w)
    w = app(v)
    return safety * torch.dot(v, w) / torch.dot(v, v)
