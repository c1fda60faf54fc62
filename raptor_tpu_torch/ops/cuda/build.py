"""Build and load the hand-written CUDA kernels of ``raptor_tpu_torch/csrc``.

The sources have a plain C interface: nvcc compiles them into one shared
library for ``sm_90a`` (Hopper), and ``ctypes`` loads it.  The build runs on
first use, never at import, and lands in ``build/raptor_tpu_torch/`` at the
root of the checkout under a name keyed by the sources' and flags' hash, so
a stale library is never loaded.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "raptor_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> tuple[Path, float]:
    """Compile ``csrc/*.cu`` if no library for these sources exists yet.

    Returns (library path, build seconds; 0.0 when it was already built).
    nvcc's output, with the ``-Xptxas -v`` register report, is kept beside
    the library as ``<name>.log``."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {SRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libraptor_tpu_torch_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call, with argtypes bound."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in ("raptor_dia_planes_f32", "raptor_dia_planes_bf16"):
        fn = getattr(lib, name)
        # data, x, y, n, batch, lins, n_off, stream
        fn.argtypes = [p, p, p, i64, i32, p, i32, p]
        fn.restype = i32
    # x, y, n, batch, dims, nd, offs, lins, consts, n_off, stream
    lib.raptor_dia_const_f32.argtypes = [p, p, i64, i32, p, i32, p, p, p, i32,
                                         p]
    lib.raptor_dia_const_f32.restype = i32
    return lib
