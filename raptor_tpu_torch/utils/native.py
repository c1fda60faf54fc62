"""ctypes loader for the repository's native host kernels
(``native/host_kernels.cpp``: RS splitting, PMIS rounds, greedy coloring).

Counterpart of ``raptor_tpu/utils/native.py``.  g++ builds the unchanged
source on first use into ``build/raptor_tpu_torch/`` at the root of the
checkout, under a name keyed by the source's hash.  Where no compiler is
available, ``load()`` returns None and every caller runs its NumPy or
Python version instead, which gives the same results bit for bit (integer
weights, no ties).  All of this is host code: it hides no device.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["load", "status", "rs_splitting_native", "pmis_splitting_native",
           "greedy_coloring_native"]

_ROOT = Path(__file__).resolve().parents[2]
SRC = _ROOT / "native" / "host_kernels.cpp"
BUILD_DIR = _ROOT / "build" / "raptor_tpu_torch"
GXX_FLAGS = ("-O2", "-shared", "-fPIC")


def _build() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
    so = BUILD_DIR / f"libhostkernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SRC)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL | None:
    """The native library (built if needed), or None where it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(str(_build()))
    except (OSError, subprocess.SubprocessError):
        return None
    i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.rs_splitting.argtypes = [i64p, i32p, i64p, i32p, ctypes.c_int64, i32p]
    lib.rs_splitting.restype = None
    lib.pmis_splitting.argtypes = [i64p, i64p, ctypes.c_int64, i64p,
                                   ctypes.c_int64, i32p]
    lib.pmis_splitting.restype = None
    lib.greedy_coloring.argtypes = [i64p, i32p, ctypes.c_int64, i32p]
    lib.greedy_coloring.restype = ctypes.c_int32
    return lib


def status() -> str:
    """'native' when the C++ kernels run, else 'numpy' (the fallback)."""
    return "native" if load() is not None else "numpy"


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def rs_splitting_native(S_csr) -> np.ndarray | None:
    """Native serial RS splitting; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    import scipy.sparse as sp

    S = sp.csr_matrix(S_csr)
    St = S.T.tocsr()
    n = S.shape[0]
    sp_ = np.ascontiguousarray(S.indptr, dtype=np.int64)
    si = np.ascontiguousarray(S.indices, dtype=np.int32)
    tp = np.ascontiguousarray(St.indptr, dtype=np.int64)
    ti = np.ascontiguousarray(St.indices, dtype=np.int32)
    cf = np.zeros(n, dtype=np.int32)
    lib.rs_splitting(_ptr(sp_, ctypes.c_int64), _ptr(si, ctypes.c_int32),
                     _ptr(tp, ctypes.c_int64), _ptr(ti, ctypes.c_int32),
                     ctypes.c_int64(n), _ptr(cf, ctypes.c_int32))
    return cf


def pmis_splitting_native(srows, scols, w, cf0) -> np.ndarray | None:
    """Native synchronous-round PMIS over a fixed strong-edge list;
    bit-identical to ``host_setup.np_pmis_splitting``.  ``cf0``: initial cf
    (0 undecided / 2 F for isolated rows), not modified.  None if the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    es = np.ascontiguousarray(srows, dtype=np.int64)
    ed = np.ascontiguousarray(scols, dtype=np.int64)
    ww = np.ascontiguousarray(w, dtype=np.int64)
    cf = np.ascontiguousarray(cf0, dtype=np.int32).copy()
    lib.pmis_splitting(_ptr(es, ctypes.c_int64), _ptr(ed, ctypes.c_int64),
                       ctypes.c_int64(es.shape[0]), _ptr(ww, ctypes.c_int64),
                       ctypes.c_int64(cf.shape[0]), _ptr(cf, ctypes.c_int32))
    return cf


def greedy_coloring_native(indptr, indices, n) -> tuple | None:
    """Native natural-order greedy colouring; the same colours as
    ``solve/smoothers._greedy_coloring_py``.  Returns (colour array,
    ncolors), or None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    ip = np.ascontiguousarray(indptr, dtype=np.int64)
    ix = np.ascontiguousarray(indices, dtype=np.int32)
    color = np.zeros(n, dtype=np.int32)
    nc = lib.greedy_coloring(_ptr(ip, ctypes.c_int64), _ptr(ix, ctypes.c_int32),
                             ctypes.c_int64(n), _ptr(color, ctypes.c_int32))
    return color, int(nc)
