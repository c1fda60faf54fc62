#!/usr/bin/env python3
"""Smoke run of raptor_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU path):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so the dense coarse solve stays full fp32;
2. build: nvcc compiles raptor_tpu_torch/csrc/*.cu into build/raptor_tpu_torch;
3. kernel equality: K1 and K2 against their plain PyTorch versions on the
   same CUDA tensors, at the shapes the main path gives them, and one small
   V-cycle on the card against the same cycle on the CPU;
4. main path: 3D 7-point Poisson at 128^3 -> build_structured_hierarchy
   (cheb4 degree 2, coarse_size 2048) -> cast_hierarchy(bf16) -> V-cycles
   -> structured_solve_refined, checked by a host fp64 residual;
5. proof: every CUDA dia_spmv call of phase 4 launched K1 or K2.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import time

import numpy as np
import torch

SIZE = 128
CFG = dict(smoother="cheb4", cheb_degree=2, coarse_size=2048, max_levels=40)
TOL_KERNEL = 1e-6  # max|y - y_ref| <= TOL_KERNEL * max|y_ref|
MAX_RELRES = 1e-8
MAX_ITERS = 8  # the JAX reference takes 7
N_CYCLES = 20


def stencil_7pt() -> np.ndarray:
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    return st


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()``: captured once in a CUDA graph and
    replayed ``reps`` times between two CUDA events, so the host cost of
    the Python wrapper (tens of µs, more than a kernel here) is not timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "this smoke runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build() -> None:
    from raptor_tpu_torch.ops.cuda.build import build, load_library

    path, seconds = build()
    print(f"[build] {path.name}: {seconds:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill")):
            print(f"[build] {line.strip()}")
    load_library()


def _random_planes(dims, offsets, dtype, rng, device):
    from raptor_tpu_torch.structured.dia import boundary_mask

    n = int(np.prod(dims))
    data = rng.standard_normal((len(offsets), n)).astype(np.float32)
    for k, o in enumerate(offsets):
        data[k] *= boundary_mask(dims, o)
    return torch.from_numpy(data).to(device=device, dtype=dtype)


def _lins(dims, offsets):
    from raptor_tpu_torch.structured.dia import _linear

    return [_linear(o, dims) for o in offsets]


def _check(name, y, y_ref) -> float:
    torch.cuda.synchronize()
    if y.shape != y_ref.shape or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: bad output {tuple(y.shape)}")
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    print(f"[kernel] {name}: max_abs_err {err:.3e} (max|y_ref| {scale:.3e})")
    if not err <= TOL_KERNEL * scale:
        raise AssertionError(f"{name}: {err} > {TOL_KERNEL} * {scale}")
    return err


def phase_kernels(dev) -> dict:
    from raptor_tpu_torch.ops.cuda.dia_kernel import (
        dia_spmv_const, dia_spmv_const_ref, dia_spmv_v2, dia_spmv_v2_ref)

    rng = np.random.default_rng(0)
    st = stencil_7pt()
    fine = (SIZE,) * 3
    lev1, lev2 = (SIZE // 2, SIZE, SIZE), (SIZE // 2, SIZE // 2, SIZE)
    cube = list(itertools.product((-1, 0, 1), repeat=3))
    off7 = [o for o in cube if sum(map(abs, o)) <= 1]
    off15 = [o for o in cube if abs(o[1]) + abs(o[2]) <= 1]
    pt_off = [(-1, 0, 0), (0, 0, 0), (1, 0, 0)]
    consts = [float(st[tuple(np.add(o, 1))]) for o in off7]
    rec = {"K1": {"err": 0.0}, "K2": {"err": 0.0}}

    def vec(n, batch=None):
        shape = (n,) if batch is None else (batch, n)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    # K2: the const fine level, and a batched small grid
    for dims, batch in ((fine, None), ((16, 16, 16), 4)):
        x = vec(int(np.prod(dims)), batch)
        y = dia_spmv_const(consts, off7, dims, x)
        y_ref = dia_spmv_const_ref(consts, off7, dims, x)
        name = f"K2 {dims} 7 offsets" + (f" batch {batch}" if batch else "")
        rec["K2"]["err"] = max(rec["K2"]["err"], _check(name, y, y_ref))
        if batch is None:
            rec["K2"]["ms"] = cuda_ms(lambda: dia_spmv_const(consts, off7, dims, x))
            rec["K2"]["plain_ms"] = cuda_ms(
                lambda: dia_spmv_const_ref(consts, off7, dims, x))

    # K1: level 1 (bf16, fp32), level 2 (bf16), a fine-level Pt, a batch
    cases = [("level 1", lev1, off15, torch.bfloat16, None),
             ("level 1", lev1, off15, torch.float32, None),
             ("level 2", lev2, cube, torch.bfloat16, None),
             ("Pt", fine, pt_off, torch.bfloat16, None),
             ("level 2 small", (16, 16, 32), cube, torch.float32, 4)]
    for label, dims, offs, dtype, batch in cases:
        data = _random_planes(dims, offs, dtype, rng, dev)
        lins = _lins(dims, offs)
        x = vec(int(np.prod(dims)), batch)
        y = dia_spmv_v2(data, lins, x)
        name = (f"K1 {label} {dims} {len(offs)} offsets {dtype}"
                + (f" batch {batch}" if batch else ""))
        rec["K1"]["err"] = max(rec["K1"]["err"],
                               _check(name, y, dia_spmv_v2_ref(data, lins, x)))
        if label == "level 1" and dtype == torch.bfloat16:
            rec["K1"]["ms"] = cuda_ms(lambda: dia_spmv_v2(data, lins, x))
            rec["K1"]["plain_ms"] = cuda_ms(lambda: dia_spmv_v2_ref(data, lins, x))
    # bytes the call must move: planes (bf16) + x + y for K1 on level 1,
    # x + y for K2 on the fine level
    moved = {"K1": len(off15) * int(np.prod(lev1)) * 2 + 8 * int(np.prod(lev1)),
             "K2": 8 * int(np.prod(fine))}
    for k in ("K1", "K2"):
        print(f"[kernel] {k}: {rec[k]['ms'] * 1e3:.1f} us kernel "
              f"({moved[k] / rec[k]['ms'] / 1e9:.3f} TB/s), "
              f"{rec[k]['plain_ms'] * 1e3:.1f} us plain (device time, graph replay)")
    return rec


def phase_small_cycle(dev) -> None:
    """One bf16 V-cycle at 16^3 on the card against the same hierarchy's
    cycle on the CPU (plain versions)."""
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle)

    dims = (16, 16, 16)
    A = dia_from_stencil(stencil_7pt(), dims, device=dev)
    h = cast_hierarchy(build_structured_hierarchy(
        A, AmgConfig(**{**CFG, "coarse_size": 64}), dim_policy="size"),
        torch.bfloat16)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(A.n)
                         .astype(np.float32))
    y = scycle(h, b.to(dev)).cpu()
    y_ref = scycle(h.to("cpu"), b)
    err = float((y - y_ref).abs().max())
    print(f"[cycle] 16^3 bf16 V-cycle, card vs CPU: max_abs_err {err:.3e}")
    if not err <= 1e-5 * float(y_ref.abs().max()):
        raise AssertionError(f"small V-cycle disagrees: {err}")


def phase_main(dev) -> dict:
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle,
                                  structured_solve_refined)
    from raptor_tpu_torch.gallery import default_rhs, stencil_grid

    st = stencil_7pt()
    dims = (SIZE,) * 3
    n = SIZE ** 3
    cfg = AmgConfig(**CFG)
    A = dia_from_stencil(st, dims, device=dev)
    torch.cuda.synchronize()

    def setup():
        t0 = time.perf_counter()
        h = build_structured_hierarchy(A, cfg, dim_policy="size")
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    h, cold = setup()
    h, warm = setup()
    print(f"[main] setup {warm:.3f} s warm, {cold:.3f} s cold, "
          f"{len(h.levels)} levels")
    for lv in h.levels:
        print(f"[main]   dims {lv.dims} n_off {lv.A.n_off} cdim {lv.cdim}")
    plan = tuple(lv.cdim for lv in h.levels[:-1])
    if plan != (0, 1, 2, 0, 1, 2, 0, 1, 2, 0) or h.coarse_inv.shape != (2048, 2048):
        raise AssertionError(f"unexpected hierarchy: plan {plan}, "
                             f"coarse_inv {tuple(h.coarse_inv.shape)}")
    hM = cast_hierarchy(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(n, dtype=np.float32)).to(dev)

    def vcycle_ms(hier):
        y = scycle(hier, b)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CYCLES):
            y = scycle(hier, b)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise AssertionError("V-cycle output not finite")
        return (time.perf_counter() - t0) / N_CYCLES * 1e3

    vc_bf16 = vcycle_ms(hM)
    vc_fp32 = vcycle_ms(h)
    print(f"[main] V-cycle bf16 {vc_bf16:.3f} ms ({n / vc_bf16 * 1e3:.4g} DOF/s), "
          f"fp32 {vc_fp32:.3f} ms ({n / vc_fp32 * 1e3:.4g} DOF/s), "
          f"{N_CYCLES} cycles between syncs")

    def solve():
        t0 = time.perf_counter()
        out = structured_solve_refined(h, b, tol=MAX_RELRES, M_hier=hM)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    solve()  # warm
    ((xh, xl), rel, iters), sol = solve()
    x64 = xh.double().cpu().numpy() + xl.double().cpu().numpy()
    b64 = b.double().cpu().numpy()
    relres = float(np.linalg.norm(b64 - stencil_grid(st, dims) @ x64)
                   / np.linalg.norm(b64))
    print(f"[main] refined solve {sol:.3f} s, {int(iters)} PCG iterations, "
          f"certified {float(rel):.3e}, true fp64 relres {relres:.3e}")
    if x64.shape != (n,) or not np.isfinite(x64).all():
        raise AssertionError("solution not finite or misshapen")
    if not relres <= MAX_RELRES or not int(iters) <= MAX_ITERS:
        raise AssertionError(f"relres {relres} (max {MAX_RELRES}), "
                             f"iterations {int(iters)} (max {MAX_ITERS})")
    return {"setup_warm_s": warm, "setup_cold_s": cold, "vcycle_bf16_ms": vc_bf16,
            "vcycle_fp32_ms": vc_fp32, "solve_s": sol, "iters": int(iters),
            "relres": relres}


def main() -> None:
    dev = phase_device()
    phase_build()
    rec = phase_kernels(dev)
    phase_small_cycle(dev)

    from raptor_tpu_torch.ops.cuda.dia_kernel import launches
    from raptor_tpu_torch.structured.dia import cuda_calls

    launches.clear()
    cuda_calls.clear()
    main_rec = phase_main(dev)
    k1, k2, calls = launches["K1"], launches["K2"], cuda_calls["dia_spmv"]
    print(f"[proof] main path: {calls} CUDA dia_spmv calls, "
          f"{k1} K1 launches, {k2} K2 launches")
    if k1 + k2 != calls or k1 == 0 or k2 == 0:
        raise AssertionError("the main path did not run through the kernels")

    print(json.dumps({"main": main_rec}))
    src = "raptor_tpu_torch/csrc/dia_kernel.cu"
    replaces = {"K1": "raptor_tpu/ops/pallas/dia_kernel.py:186",
                "K2": "raptor_tpu/ops/pallas/dia_kernel.py:278"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src, "replaces": replaces[k],
         "launches": {"K1": k1, "K2": k2}[k], "max_abs_err": rec[k]["err"],
         "ms": rec[k]["ms"], "plain_ms": rec[k]["plain_ms"]}
        for k in ("K1", "K2")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
