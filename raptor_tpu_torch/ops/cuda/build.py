"""Build and load the hand-written CUDA kernels of ``raptor_tpu_torch/csrc``.

The sources have a plain C interface: nvcc compiles each of them into an
object for ``sm_90a`` (Hopper), all at once in parallel, and links the
objects into one shared library, which ``ctypes`` loads.  The build runs on
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

__all__ = ["NVCC_FLAGS", "LINK_FLAGS", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "raptor_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared", "-gencode", "arch=compute_90a,code=sm_90a")


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    # the headers the sources include count too
    for s in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libraptor_tpu_torch_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{s.stem}.o" for s in sources]
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    logs, failed = [], []
    for s, p in zip(sources, procs):
        out, _ = p.communicate(timeout=600)
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(f"{s.name} ({p.returncode})")
    tmp = lib.with_name(f"{tag}.tmp.so")
    if not failed:
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True, timeout=600)
        logs.append(f"== link\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append(f"link ({link.returncode})")
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    log = "".join(logs)
    lib.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
    os.replace(tmp, lib)
    return lib, seconds


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call, with argtypes bound."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # the tiled kernel's plan: lins, n_off, tile, n_band, band_lo,
    # band_win, band_of, vec
    plan = [p, i32, i32, i32, p, p, p, i32]
    for name in ("raptor_dia_planes_f32", "raptor_dia_planes_bf16"):
        fn = getattr(lib, name)
        # data, x, y, n, batch, plan..., stream
        fn.argtypes = [p, p, p, i64, i32, *plan, p]
        fn.restype = i32
    for name in ("raptor_dia_halo_f32", "raptor_dia_halo_bf16"):
        fn = getattr(lib, name)
        # data, x, halo_left, halo_right, y, nl, len_l, len_r, plan...,
        # stream
        fn.argtypes = [p, p, p, p, p, i64, i64, i64, *plan, p]
        fn.restype = i32
    # x, y, n, batch, dims, nd, offs, lins, consts, n_off, rows, tile,
    # n_band, band_lo, band_win, band_of, stream
    lib.raptor_dia_const_f32.argtypes = [p, p, i64, i32, p, i32, p, p, p, i32,
                                         i32, i32, i32, p, p, p, p]
    lib.raptor_dia_const_f32.restype = i32
    for name in ("raptor_banded_f32", "raptor_banded_bf16"):
        fn = getattr(lib, name)
        # vals, pidx, x, y, n, K, tile, Wp, x_off, x_len, live mask, n_live,
        # staged, threads, page0, pages, stream
        fn.argtypes = [p, p, p, p, i64, i32, i32, i32, i64, i64, p, i32, i32,
                       i32, i32, i32, p]
        fn.restype = i32
    for name in ("raptor_banded_rect_f32", "raptor_banded_rect_bf16"):
        fn = getattr(lib, name)
        # vals, pidx, x, y, n, K, tile, x_len, map_cols, WpP, npage, live
        # mask, n_live, staged, layout, threads, page0, pages, stream
        fn.argtypes = [p, p, p, p, i64, i32, i32, i64, i64, i32, i32, p, i32,
                       i32, i32, i32, i32, i32, p]
        fn.restype = i32
    # vals, vals_lo, pidx, xh, bh, bl, v, rh, rl, n, K, tile, Wp, live mask,
    # n_live, staged, threads, page0, pages, stream
    lib.raptor_banded_df64_f32.argtypes = [p, p, p, p, p, p, p, p, p, i64, i32,
                                           i32, i32, p, i32, i32, i32, i32,
                                           i32, p]
    lib.raptor_banded_df64_f32.restype = i32
    return lib
