"""Matrix and vector file I/O.

Counterpart of ``raptor_tpu/utils/io.py`` (a copy: the port imports
nothing of the JAX package).  Three matrix formats behind one pair of
functions, all producing and consuming ``scipy.sparse`` CSR, the host-side
currency every entry point accepts:

* ``.mtx`` / ``.mtx.gz`` — Matrix Market exchange format (SuiteSparse and
  most test collections).
* ``.npz`` — ``scipy.sparse.save_npz`` container (fast, compressed).
* ``.rbm`` — "raw binary matrix": a little-endian header + CSR triplet dump
  for cheap exchange with non-Python tooling; layout:

      magic     8 bytes  b"RAPTBIN1"
      nrows     int64    number of rows
      ncols     int64    number of columns
      nnz       int64    stored entries
      dtype     int64    0 = float32, 1 = float64
      indptr    (nrows+1) int64
      indices   nnz int64
      data      nnz float32|float64

Vectors ride ``.npy`` (NumPy) or whitespace text.  No pickle anywhere, so
every format here is safe to read from untrusted files.  One addition to
the reference: ``write_matrix`` also writes ``.mtx.gz``, which both
packages read.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np
import scipy.io
import scipy.sparse as sp

__all__ = ["read_matrix", "write_matrix", "read_vector", "write_vector"]

_MAGIC = b"RAPTBIN1"
_DTYPES = {0: np.float32, 1: np.float64}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


def _suffix(path: Path) -> str:
    """Final format-bearing suffix: 'a.mtx.gz' -> '.mtx.gz'."""
    s = path.suffixes
    if len(s) >= 2 and s[-1] == ".gz":
        return "".join(s[-2:]).lower()
    return (s[-1] if s else "").lower()


def read_matrix(path: str | Path) -> sp.csr_matrix:
    """Read a sparse matrix from ``.mtx``/``.mtx.gz``, ``.npz`` or ``.rbm``.

    Always returns CSR with sorted indices and no duplicates/explicit zeros —
    the canonical form ``api.setup`` / ``structured.dia_from_scipy`` expect.
    """
    path = Path(path)
    suf = _suffix(path)
    if suf in (".mtx", ".mtx.gz"):
        if suf.endswith(".gz"):
            with gzip.open(path, "rb") as f:
                A = scipy.io.mmread(f)
        else:
            A = scipy.io.mmread(path)
        A = sp.csr_matrix(A)
    elif suf == ".npz":
        A = sp.load_npz(path).tocsr()
    elif suf == ".rbm":
        A = _read_rbm(path)
    else:
        raise ValueError(
            f"unsupported matrix format {suf!r} for {path} "
            "(one of .mtx, .mtx.gz, .npz, .rbm)")
    A.sum_duplicates()
    A.eliminate_zeros()
    A.sort_indices()
    return A


def write_matrix(path: str | Path, A) -> None:
    """Write a sparse matrix; format picked from the extension (see module
    docstring)."""
    path = Path(path)
    A = sp.csr_matrix(A)
    suf = _suffix(path)
    if suf == ".mtx":
        scipy.io.mmwrite(str(path), A)
    elif suf == ".mtx.gz":
        with gzip.open(path, "wb") as f:
            scipy.io.mmwrite(f, A)
    elif suf == ".npz":
        sp.save_npz(path, A)
    elif suf == ".rbm":
        _write_rbm(path, A)
    else:
        raise ValueError(
            f"unsupported matrix format {suf!r} for {path} "
            "(one of .mtx, .mtx.gz, .npz, .rbm)")


def _write_rbm(path: Path, A: sp.csr_matrix) -> None:
    dt = np.dtype(np.float64 if A.dtype == np.float64 else np.float32)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqqq", A.shape[0], A.shape[1], A.nnz,
                            _DTYPE_CODES[dt]))
        f.write(np.asarray(A.indptr, dtype="<i8").tobytes())
        f.write(np.asarray(A.indices, dtype="<i8").tobytes())
        f.write(np.asarray(A.data, dtype=dt.newbyteorder("<")).tobytes())


def _read_rbm(path: Path) -> sp.csr_matrix:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not a raptor_tpu .rbm file "
                             f"(magic {magic!r})")
        nrows, ncols, nnz, code = struct.unpack("<qqqq", f.read(32))
        if code not in _DTYPES:
            raise ValueError(f"{path}: unknown dtype code {code}")
        if nrows < 0 or ncols < 0 or nnz < 0:
            raise ValueError(f"{path}: negative header field")
        dt = np.dtype(_DTYPES[code])
        indptr = np.frombuffer(f.read(8 * (nrows + 1)), dtype="<i8")
        indices = np.frombuffer(f.read(8 * nnz), dtype="<i8")
        data = np.frombuffer(f.read(dt.itemsize * nnz),
                             dtype=dt.newbyteorder("<"))
        if len(indptr) != nrows + 1 or len(indices) != nnz or len(data) != nnz:
            raise ValueError(f"{path}: truncated file")
    # frombuffer arrays are read-only; scipy wants writable
    return sp.csr_matrix(
        (data.astype(dt), indices.astype(np.int64), indptr.astype(np.int64)),
        shape=(nrows, ncols))


def read_vector(path: str | Path) -> np.ndarray:
    """Read a dense vector from ``.npy`` or whitespace/newline text."""
    path = Path(path)
    if _suffix(path) == ".npy":
        v = np.load(path, allow_pickle=False)
    else:
        v = np.loadtxt(path)
    v = np.asarray(v)
    if v.ndim != 1:
        v = v.reshape(-1)
    return v


def write_vector(path: str | Path, v) -> None:
    path = Path(path)
    v = np.asarray(v)
    if _suffix(path) == ".npy":
        np.save(path, v, allow_pickle=False)
    else:
        np.savetxt(path, v)
