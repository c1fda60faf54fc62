#!/usr/bin/env python3
"""Old against new: the DIA plane-streaming kernels K1, K1v1 and K3 of
``raptor_tpu_torch/csrc/dia_kernel.cu`` against an earlier version of that
source, in turns, on one NVIDIA GPU.

    python3 scripts/bench_dia_tiles_ab.py --old OLD_dia_kernel.cu [--out FILE]

``--old`` is a copy of the earlier ``dia_kernel.cu`` with the C interface
that takes no plan (``raptor_dia_planes_*(data, x, y, n, batch, lins,
n_off, stream)``, ``raptor_dia_halo_*(data, x, hl, hr, y, nl, len_l, len_r,
lins, n_off, stream)``); it is built by nvcc into a library of its own
under ``build/``.  At each shape the script checks old and new against the
plain PyTorch version (bit for bit, ``torch.equal``) and times them by
CUDA-graph replay (``chip_smoke.cuda_ms``) in the order old, new, new, old,
L2-warm and then L2-cold (256 MB written between replays).  L2-warm, one
graph holds ``inner`` calls back to back (up to 50, fewer as the call's
bytes grow past 1 MB), so that a short kernel is not timed as the graph's
launch; the time is per call.  Shapes:

* the listed ones: K3 at the 256^3 fine level (7 fp32 planes, halos 65536)
  and the 256^3 L1/L2 shapes, K1 at 128^3 level 1 (15 bf16 planes), level 2
  (27), the fine-level Pt (3 offsets, 2,097,152 rows) and the small batched
  shape, K1v1 at 128^3;
* with ``--paths``, every distinct (n, n_off, plane dtype) of the 128^3
  structured main path's hierarchy (fp32 and its bf16 cast: K1) and of the
  256^3 config-5 plan's sharded levels on one rank (K3, halos of the
  offsets' reach), for the per-shape launches x (time - bound) ranking.

Each shape prints one JSON line (also written to ``--out``): times in ms,
the bound (bytes over 3.35 TB/s), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import HBM_BYTES_PER_S, cuda_ms  # noqa: E402

CUBE = list(itertools.product((-1, 0, 1), repeat=3))
OFF7 = [o for o in CUBE if sum(map(abs, o)) <= 1]
OFF15 = [o for o in CUBE if abs(o[1]) + abs(o[2]) <= 1]
PT = [(-1, 0, 0), (0, 0, 0), (1, 0, 0)]


def _library(src: Path, prefix: str) -> ctypes.CDLL:
    """nvcc builds ``src`` alone into a library of its own under build/
    (the package's headers, csrc/*.cuh, are on its include path)."""
    from raptor_tpu_torch.ops.cuda.build import (BUILD_DIR, NVCC_FLAGS,
                                                 SRC_DIR, _nvcc)

    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libdia_{prefix}_{tag}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(SRC_DIR), "-shared",
                        "-o", str(lib), str(src)], check=True,
                       capture_output=True, text=True)
    return ctypes.CDLL(str(lib))


def build_old(src: Path) -> ctypes.CDLL:
    old = _library(src, "old")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name in ("raptor_dia_planes_f32", "raptor_dia_planes_bf16"):
        getattr(old, name).argtypes = [p, p, p, i64, i32, p, i32, p]
    for name in ("raptor_dia_halo_f32", "raptor_dia_halo_bf16"):
        getattr(old, name).argtypes = [p, p, p, p, p, i64, i64, i64, p, i32, p]
    return old


def old_call(old, kernel, data, lins, x, hl=None, hr=None):
    """The earlier kernel on the same tensors (y allocated per call, as the
    wrappers do)."""
    bf = data.dtype == torch.bfloat16
    arr = (ctypes.c_int * len(lins))(*lins)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    n_off, n = data.shape
    if kernel == "K3":
        fn = old.raptor_dia_halo_bf16 if bf else old.raptor_dia_halo_f32
        rc = fn(data.data_ptr(), x.data_ptr(), hl.data_ptr(), hr.data_ptr(),
                y.data_ptr(), n, hl.shape[0], hr.shape[0], arr, n_off, stream)
    else:
        fn = old.raptor_dia_planes_bf16 if bf else old.raptor_dia_planes_f32
        batch = 1 if x.dim() == 1 else x.shape[0]
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch, arr,
                n_off, stream)
    if rc:
        raise RuntimeError(f"old {kernel} launch failed: cudaError {rc}")
    return y


def build_variant(src: Path) -> ctypes.CDLL:
    """Another version of the tiled kernel, with this package's C
    interface (the plan arguments)."""
    var = _library(src, "variant")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    plan = [p, i32, i32, i32, p, p, p, i32]
    for name in ("raptor_dia_planes_f32", "raptor_dia_planes_bf16"):
        getattr(var, name).argtypes = [p, p, p, i64, i32, *plan, p]
    for name in ("raptor_dia_halo_f32", "raptor_dia_halo_bf16"):
        getattr(var, name).argtypes = [p, p, p, p, p, i64, i64, i64, *plan, p]
    return var


def variant_call(var, kernel, data, lins, x, hl=None, hr=None):
    """A variant's kernel on the same tensors, with the package's plan."""
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    bf = data.dtype == torch.bfloat16
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream().cuda_stream
    n = data.shape[1]
    if kernel == "K3":
        LP, RP = tk.halo_reach(lins)
        hl, hr = hl[max(hl.shape[0] - LP, 0):], hr[:RP]
        fn = var.raptor_dia_halo_bf16 if bf else var.raptor_dia_halo_f32
        rc = fn(data.data_ptr(), x.data_ptr(), hl.data_ptr(), hr.data_ptr(),
                y.data_ptr(), n, hl.shape[0], hr.shape[0],
                *tk._tiled_args(data, lins, x, 1), stream)
    else:
        batch = 1 if x.dim() == 1 else x.shape[0]
        fn = var.raptor_dia_planes_bf16 if bf else var.raptor_dia_planes_f32
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch,
                *tk._tiled_args(data, lins, x, batch), stream)
    if rc:
        raise RuntimeError(f"variant {kernel} launch failed: cudaError {rc}")
    return y


def new_call(kernel, data, lins, x, hl=None, hr=None):
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    if kernel == "K3":
        return tk.dia_spmv_halo(data, lins, x, hl, hr)
    return (tk.dia_spmv_v1 if kernel == "K1v1" else tk.dia_spmv_v2)(data, lins, x)


def plain_call(kernel, data, lins, x, hl=None, hr=None):
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    if kernel == "K3":
        return tk.dia_spmv_halo_ref(data, lins, x, hl, hr)
    return (tk.dia_spmv_v1_ref if kernel == "K1v1" else tk.dia_spmv_v2_ref)(
        data, lins, x)


def measure(old, kernel, label, data, lins, x, hl=None, hr=None, reps=20,
            variants=()):
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    args = (data, lins, x) + ((hl, hr) if kernel == "K3" else ())
    ref = plain_call(kernel, *args)
    y_new, y_old = new_call(kernel, *args), old_call(old, kernel, *args)
    torch.cuda.synchronize()
    equal = bool(torch.equal(y_new, ref) and torch.equal(y_old, ref))
    fo = lambda: old_call(old, kernel, *args)  # noqa: E731
    fn = lambda: new_call(kernel, *args)  # noqa: E731
    n_off, n = data.shape
    batch = 1 if x.dim() == 1 else x.shape[0]
    halo = 0 if hl is None else hl.shape[0] + hr.shape[0]
    nbytes = data.numel() * data.element_size() + 4 * (n * batch + halo) \
        + 4 * n * batch
    inner = max(1, min(50, (1 << 20) * 50 // nbytes))
    warm = [cuda_ms(lambda: [f() for _ in range(inner)], reps) / inner
            for f in (fo, fn, fn, fo)]
    cold = [cuda_ms(f, reps, flush_l2=True) for f in (fo, fn, fn, fo)]
    var_ms = {}
    for name, var in variants:
        fv = lambda: variant_call(var, kernel, *args)  # noqa: E731
        if not torch.equal(fv(), ref):
            equal = False
        var_ms[name] = [cuda_ms(lambda: [f() for _ in range(inner)], reps) / inner
                        for f in (fn, fv, fv, fn)] + [
            cuda_ms(f, reps, flush_l2=True) for f in (fn, fv, fv, fn)]
    plan = tk.tile_plan(lins, n, data.element_size(),
                        data.data_ptr() % 16 == 0, batch,
                        torch.cuda.get_device_properties(x.device)
                        .multi_processor_count)
    rec = {"kernel": kernel, "shape": label, "n": n, "n_off": n_off,
           "dtype": str(data.dtype).removeprefix("torch."), "batch": batch,
           "halo": halo, "inner": inner, "tile": plan.tile, "bands": len(plan.bands),
           "vec": plan.vec, "equal": equal,
           "old_ms": warm[0::3], "new_ms": warm[1:3],
           "old_cold_ms": cold[0::3], "new_cold_ms": cold[1:3],
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
           "variants": var_ms}
    ow, nw = np.mean(rec["old_ms"]), np.mean(rec["new_ms"])
    oc, nc = np.mean(rec["old_cold_ms"]), np.mean(rec["new_cold_ms"])
    print(f"{kernel} {label} n={n} n_off={n_off} {rec['dtype']} batch {batch}: "
          f"warm old {ow * 1e3:.1f} new {nw * 1e3:.1f} us, cold old "
          f"{oc * 1e3:.1f} new {nc * 1e3:.1f} us, bound "
          f"{rec['bound_ms'] * 1e3:.1f} us, tile {plan.tile}, "
          f"{len(plan.bands)} bands, equal {equal}" + "".join(
              f"; {name}: warm {np.mean(v[1:3]) * 1e3:.1f} (new "
              f"{np.mean(v[0:4:3]) * 1e3:.1f}), cold {np.mean(v[5:7]) * 1e3:.1f} "
              f"(new {np.mean(v[4:8:3]) * 1e3:.1f})" for name, v in var_ms.items()),
          flush=True)
    return rec


def randn(shape, gen, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def listed_shapes(gen):
    """(kernel, label, data, lins, x, hl, hr) at the listed shapes (module
    docstring): random planes, boundary-zeroed except for K1v1."""
    from raptor_tpu_torch.ops.cuda.dia_kernel import halo_reach, in_grid_mask
    from raptor_tpu_torch.structured.dia import _linear

    def planes(dims, offs, dtype, zeroed=True):
        n = int(np.prod(dims))
        data = torch.randn((len(offs), n), generator=gen, device="cuda")
        if zeroed:
            for k, o in enumerate(offs):
                data[k] *= in_grid_mask(dims, o, "cuda")
        return data.to(dtype), [_linear(o, dims) for o in offs]

    for label, dims, offs, dtype in (
            ("256^3 fine", (256,) * 3, OFF7, torch.float32),
            ("256^3 L1", (128, 256, 256), OFF15, torch.float32),
            ("256^3 L1", (128, 256, 256), OFF15, torch.bfloat16),
            ("256^3 L2", (128, 128, 256), CUBE, torch.float32)):
        data, lins = planes(dims, offs, dtype)
        LP, RP = halo_reach(lins)
        yield ("K3", label, data, lins, randn(data.shape[1], gen),
               randn(LP, gen), randn(RP, gen))
    for label, dims, offs, dtype, batch in (
            ("128^3 L1", (64, 128, 128), OFF15, torch.bfloat16, None),
            ("128^3 L2", (64, 64, 128), CUBE, torch.bfloat16, None),
            ("128^3 Pt", (128,) * 3, PT, torch.bfloat16, None),
            ("small batched", (16, 16, 32), CUBE, torch.float32, 4)):
        data, lins = planes(dims, offs, dtype)
        n = data.shape[1]
        yield ("K1", label, data, lins,
               randn((n,) if batch is None else (batch, n), gen), None, None)
    data, lins = planes((128,) * 3, OFF7, torch.float32, zeroed=False)
    yield ("K1v1", "128^3", data, lins, randn(data.shape[1], gen), None, None)


def path_shapes(gen):
    """Every distinct K1 shape of the 128^3 main path's hierarchy (fp32 and
    bf16) and K3 shape of the 256^3 config-5 plan's sharded levels."""
    from chip_smoke import CFG, stencil_7pt
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil)
    from raptor_tpu_torch.ops.cuda.dia_kernel import halo_reach
    from raptor_tpu_torch.structured import dist as sd
    from raptor_tpu_torch.structured.solver import _build_hierarchy_planned

    A = dia_from_stencil(stencil_7pt(), (128,) * 3, device="cuda")
    h = build_structured_hierarchy(A, AmgConfig(**CFG), dim_policy="size")
    seen = set()
    for hier in (h, cast_hierarchy(h, torch.bfloat16)):
        for i, lv in enumerate(hier.levels):
            for name in ("A", "Pt", "Rt"):
                m = getattr(lv, name)
                if m is None or m.const_planes is not None:
                    continue
                key = (m.n, m.n_off, m.data.dtype)
                if key in seen:
                    continue
                seen.add(key)
                yield ("K1", f"128^3 path L{i} {name}", m.data,
                       m.linear_offsets(), randn(m.n, gen), None, None)
    del h
    A, _ = sd.config5_problem(256, "cuda")
    plan, t = sd.plan_coarsening_dist(A, sd.CONFIG5, 1, "size")
    h = _build_hierarchy_planned(A, sd.CONFIG5, plan)
    seen = set()
    for i, lv in enumerate(h.levels[:t]):
        for name in ("A", "Pt", "Rt"):
            m = getattr(lv, name)
            if m is None:
                continue
            key = (m.n, m.n_off, m.data.dtype)
            if key in seen:
                continue
            seen.add(key)
            lins = m.linear_offsets()
            LP, RP = halo_reach(lins)
            yield ("K3", f"256^3 sharded L{i} {name}", m.data, lins,
                   randn(m.n, gen), randn(LP, gen), randn(RP, gen))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another version of the tiled kernel's source, "
                         "timed in turns with this package's (new, variant, "
                         "variant, new)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    from raptor_tpu_torch.ops.cuda.build import load_library

    load_library()
    old = build_old(args.old)
    variants = [(v.stem, build_variant(v)) for v in args.variant]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    shapes = listed_shapes(gen)
    if args.paths:
        shapes = itertools.chain(shapes, path_shapes(gen))
    out = open(args.out, "w") if args.out else None
    failed = []
    for kernel, label, data, lins, x, hl, hr in shapes:
        rec = measure(old, kernel, label, data, lins, x, hl, hr, args.reps,
                      variants)
        rec["card"] = card
        if not rec["equal"]:
            failed.append(f"{kernel} {label}")
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
    if failed:
        raise SystemExit(f"not bit-equal to the plain version: {failed}")


if __name__ == "__main__":
    main()
