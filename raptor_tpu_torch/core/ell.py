"""Padded-ELL sparse matrix, the algebraic engine's workhorse format.

Counterpart of ``raptor_tpu/core/ell.py``.

* **Entry-major layout**: ``data``/``cols`` have shape ``(K, n_pad)`` where
  ``K`` is the padded max-nnz-per-row and ``n_pad`` the padded row count,
  so every per-slot operation is a full-width vector op over the long axis.
* **Static shapes**: ``K`` and ``n_pad`` are Python ints.  Row padding uses
  identity rows (diag=1, nnz=1) so padded systems stay SPD.
* **Padding convention**: within a row, the first ``row_nnz[i]`` slots are
  real entries sorted by column; the remaining slots have ``val=0`` and a
  valid gather index, so SpMV needs no mask.

The leaves are NumPy arrays while a hierarchy is built on the host (the
reference's ``device=False``); ``EllMatrix.to(device)`` turns them into
tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["EllMatrix", "ell_from_csr", "ell_to_csr", "pad_rows",
           "pad_vector", "to_tensor"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_tensor(a, device) -> torch.Tensor:
    """Copy of array or tensor ``a`` on ``device`` with the same dtype;
    ``ml_dtypes`` bfloat16 arrays (which ``torch.from_numpy`` rejects) go
    through float32, which is exact."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _np(a) -> np.ndarray:
    """Host NumPy view of an array or tensor (bf16 widened to fp32)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.detach().cpu().numpy()
    return np.asarray(a)


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """Padded ELLPACK matrix in entry-major ``(K, n_pad)`` layout.

    data:    (K, n_rows_pad) values; slot k of row i is ``data[k, i]``.
    cols:    (K, n_rows_pad) int32 column indices into ``[0, n_cols_pad)``.
    row_nnz: (n_rows_pad,) int32 true entry count per row.
    shape:   logical (n_rows, n_cols).
    n_rows_pad / n_cols_pad: padded extents.
    """

    data: Any
    cols: Any
    row_nnz: Any
    shape: Tuple[int, int]
    n_rows_pad: int
    n_cols_pad: int

    @property
    def K(self) -> int:
        return int(self.data.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz(self) -> int:
        return int(self.row_nnz.sum())

    def _xp_iota(self, axis: int):
        shape = (self.K, self.n_rows_pad)
        if isinstance(self.data, torch.Tensor):
            dev = self.data.device
            if axis == 0:
                return torch.arange(self.K, device=dev)[:, None].expand(shape)
            return torch.arange(self.n_rows_pad, device=dev)[None, :].expand(shape)
        if axis == 0:
            return np.broadcast_to(np.arange(self.K)[:, None], shape)
        return np.broadcast_to(np.arange(self.n_rows_pad)[None, :], shape)

    def slot_mask(self):
        """(K, n_pad) bool: True where a slot holds a real entry."""
        return self._xp_iota(0) < self.row_nnz[None, :]

    def row_index(self):
        """(K, n_pad): broadcasted row index of each slot."""
        return self._xp_iota(1)

    def diagonal(self):
        """(n_rows_pad,) diagonal entries (1.0 on identity padding rows)."""
        hit = (self.cols == self.row_index()) & self.slot_mask()
        if isinstance(self.data, torch.Tensor):
            return torch.where(hit, self.data, 0).sum(0)
        return np.where(hit, self.data, 0).sum(axis=0)

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(
            self, data=to_tensor(self.data, device),
            cols=to_tensor(self.cols, device),
            row_nnz=to_tensor(self.row_nnz, device))

    def __repr__(self):
        return (f"EllMatrix(shape={self.shape}, K={self.K}, "
                f"pad=({self.n_rows_pad},{self.n_cols_pad}), dtype={self.dtype})")


def pad_rows(n: int, multiple: int = 8) -> int:
    """Padded row count: the next multiple of ``multiple``."""
    return _round_up(max(n, 1), multiple)


def ell_from_csr(
    a,
    dtype=np.float32,
    row_pad_multiple: int = 8,
    n_cols_pad: int | None = None,
    identity_pad_rows: bool = True,
) -> EllMatrix:
    """Host-side conversion scipy.sparse -> EllMatrix with NumPy leaves.

    Square inputs get identity padding rows (keeps padded systems SPD); set
    ``identity_pad_rows=False`` for rectangular operators (interpolation P),
    whose padding rows are all-zero."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    a.sort_indices()
    n, m = a.shape
    n_pad = pad_rows(n, row_pad_multiple)
    if n_cols_pad is None:
        n_cols_pad = pad_rows(m, row_pad_multiple) if n != m else n_pad
    row_nnz = np.diff(a.indptr).astype(np.int32)
    square = n == m
    K = max(int(row_nnz.max(initial=0)), 1)

    data = np.zeros((K, n_pad), dtype=dtype)
    # padding gather target: column 0 (value 0 annihilates the gathered entry)
    cols = np.zeros((K, n_pad), dtype=np.int32)
    nnz_pad = np.zeros(n_pad, dtype=np.int32)
    nnz_pad[:n] = row_nnz

    if a.nnz:
        r = np.repeat(np.arange(n), row_nnz)
        slot = np.arange(a.nnz) - np.repeat(a.indptr[:-1], row_nnz)
        data[slot, r] = a.data.astype(dtype)
        cols[slot, r] = a.indices.astype(np.int32)

    if identity_pad_rows and square and n_pad > n:
        data[0, n:] = 1.0
        cols[0, n:] = np.arange(n, n_pad)
        nnz_pad[n:] = 1

    return EllMatrix(data=data, cols=cols, row_nnz=nnz_pad, shape=(n, m),
                     n_rows_pad=n_pad, n_cols_pad=int(n_cols_pad))


def ell_to_csr(A: EllMatrix):
    """Host-side conversion back to scipy.sparse.csr_matrix (logical shape)."""
    import scipy.sparse as sp

    data, cols, nnz = _np(A.data), _np(A.cols), _np(A.row_nnz)
    n, m = A.shape
    real = ((np.arange(A.K)[:, None] < nnz[None, :])
            & (np.arange(A.n_rows_pad)[None, :] < n))
    rows = np.broadcast_to(np.arange(A.n_rows_pad)[None, :], cols.shape)
    keep = real & (cols < m)  # identity padding rows live in padded col space
    out = sp.coo_matrix((data[keep], (rows[keep], cols[keep])), shape=(n, m))
    return out.tocsr()


def pad_vector(b: np.ndarray, n_pad: int, dtype=None, *, device) -> torch.Tensor:
    """Zero-pad a host vector to the padded length, as a tensor on ``device``."""
    b = np.asarray(b)
    out = np.zeros(n_pad, dtype=dtype or b.dtype)
    out[: b.shape[0]] = b
    return torch.from_numpy(out).to(device)
