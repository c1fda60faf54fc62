"""What ``chip_smoke.py`` and ``bench_torch.py`` share: the reference
bench's problems, settings and pinned results, the host fp64 checks, and
the card-side timers (CUDA-graph replay, torch.profiler over cycles).

It imports torch, NumPy and SciPy, never JAX; the functions import what
they use of raptor_tpu_torch when called.
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

TOL = 1e-8  # the refined solves' tolerance and their true-relres limit
TOL_KERNEL = 1e-6  # max|y - y_ref| <= TOL_KERNEL * max|y_ref|
N_PROFILED = 10
# the algebraic engine: the reference bench row's configuration, the level
# sizes of the JAX reference's hierarchies for its inputs, and its PCG
# iterations + 1 (it takes 12 at 48^3 and has no count at 96^3)
ALG_CFG = dict(splitting="pmis", interp="direct", fine_layout="banded",
               smoother="cheb4", cheb_degree=2)
ALG_SIZES = {48: [110592, 55296, 6462, 881, 147, 46],
             96: [884736, 442368, 50059, 6323, 939, 189, 56]}
ALG_MAX_ITERS = {48: 13}
# the plane mode (bench.py:228-320, the alg128 row)
ALG128_CFG = dict(splitting="pmis", interp="extended", fine_layout="banded",
                  smoother="cheb4", cheb_degree=3,
                  operator_store_dtype="bfloat16")
# a threshold above every level's size: the host route, which the device
# route is compared with
HOST_ROUTE_THRESHOLD = 2**22
# the acceptance rows (bench.py:394-470) at the reference bench's sizes;
# BENCH_r05.json "cfg": the reference's refined-solve iterations there
# (config 3 is held to its own fence)
CONFIG_SIZES = {"config1": 64, "config2": 32, "config3": 96, "config4": 48,
                "config5": 64, "nonsym_gmres": 128}
CONFIG_ITERS = {"config1": 10, "config2": 11, "config3": 30, "config4": 23,
                "config5": 14, "nonsym_gmres": 45}
CONFIG3_FENCE = 32
# a regression pin, not a reference: the level sizes config 4's device SA
# route gave on an H100 80GB HBM3
CONFIG4_DEVICE_SIZES_PIN = [324864, 17646, 960, 66, 6]


def stencil_7pt() -> np.ndarray:
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    return st


def shuffled_poisson(nx: int, scale: float = 1.0) -> sp.csr_matrix:
    """3D 7-point Poisson on nx^3, symmetrically permuted by
    default_rng(0) (the reference bench's shuffled input), times ``scale``."""
    from raptor_tpu_torch.gallery import poisson_3d

    A = sp.csr_matrix(poisson_3d(nx)) * scale
    p = np.random.default_rng(0).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def poisson7_residual(x64: np.ndarray, b64: np.ndarray, n: int) -> np.ndarray:
    """b - A x in fp64 on the host for the 7-point Poisson operator on n^3
    (Dirichlet truncation, as gallery.stencil_grid builds it), without
    assembling the matrix."""
    X = x64.reshape(n, n, n)
    Y = 6.0 * X
    for ax in range(3):
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax], hi[ax] = slice(1, None), slice(None, -1)
        Y[tuple(lo)] -= X[tuple(hi)]
        Y[tuple(hi)] -= X[tuple(lo)]
    return b64 - Y.ravel()


def true_relres(A, x, b) -> float:
    """||b - A x|| / ||b|| with A in fp64 on the host."""
    a64 = sp.csr_matrix(A).astype(np.float64)
    return float(np.linalg.norm(b - a64 @ x) / np.linalg.norm(b))


def config_problem(name: str, size: int):
    """(A, B) of an acceptance row at ``size`` (bench.py:409-419; B the
    near-nullspace where the row has one)."""
    from raptor_tpu_torch.gallery import (anisotropic_2d, convection_diffusion_2d,
                                          elasticity_3d, poisson_2d, poisson_3d)

    gens = {"config1": lambda: (poisson_2d(size), None),
            "config2": lambda: (poisson_3d(size), None),
            "config3": lambda: (anisotropic_2d(size), None),
            "config4": lambda: elasticity_3d(size)[:2],
            "config5": lambda: (poisson_3d(size), None),
            "nonsym_gmres": lambda: (convection_diffusion_2d(size), None)}
    return gens[name]()


def config_settings(name: str):
    """(AmgConfig, SolveConfig) of an acceptance row (bench.py:420-433):
    config 4 with the bench's host_setup_threshold (its host SA route),
    nonsym_gmres PMIS + Jacobi under refined GMRES, the rest their
    presets."""
    from raptor_tpu_torch import PRESETS, AmgConfig, SolveConfig

    cfgs = {"config4": dataclasses.replace(PRESETS["config4"],
                                           host_setup_threshold=400000),
            "nonsym_gmres": AmgConfig(splitting="pmis", smoother="jacobi")}
    krylov = "gmres" if name == "nonsym_gmres" else "cg"
    return (cfgs.get(name) or PRESETS[name],
            SolveConfig(tol=TOL, refine=True, krylov=krylov))


def graph_ms(fn, reps: int = 20, flush_l2: bool = False) -> float:
    """Mean device time of ``fn()``: captured once in a CUDA graph and
    replayed ``reps`` times between two CUDA events, so the host cost of
    the Python wrapper (tens of µs, more than a kernel here) is not timed.

    By default the replays follow each other, so data that fits the 50 MB
    L2 stays there (L2-warm).  ``flush_l2`` writes 256 MB between replays
    and times each replay between its own events (L2-cold)."""
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
    if flush_l2:
        junk = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        total = 0.0
        for _ in range(reps):
            junk.zero_()
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            total += start.elapsed_time(stop)
        return total / reps
    start.record()
    for _ in range(reps):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def profile_cycles(cycle, reps: int = N_PROFILED, top: int = 0) -> dict:
    """torch.profiler over ``reps`` calls of ``cycle()`` on the card, per
    call: wall (host clock ending in a synchronize), device busy (the union
    of the device events' intervals), device events, busy share, and each
    hand-written kernel's launches.  ``top`` > 0 adds the ``top`` device
    event names with the most time, as [name, us per call, events per
    call]."""
    from torch.profiler import ProfilerActivity, profile

    from raptor_tpu_torch.ops.cuda import launch

    before = collections.Counter(launch.launches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            cycle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = launch.launches - before
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    if not spans:
        raise RuntimeError("the profiler recorded no device events")
    busy, end = 0.0, -np.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    out = {"cycles": reps, "wall_ms": wall * 1e3 / reps,
           "busy_ms": busy * 1e-3 / reps, "device_events": len(spans) / reps,
           "launches": {k: c / reps for k, c in sorted(launches.items())}}
    out["busy_share"] = out["busy_ms"] / out["wall_ms"]
    if top:
        by_name = collections.defaultdict(lambda: [0.0, 0])
        for e in events:
            t = by_name[e.name[:100]]
            t[0] += e.time_range.end - e.time_range.start
            t[1] += 1
        out["top"] = [[k, us / reps, c / reps] for k, (us, c) in
                      sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]]
    return out
