#!/usr/bin/env python3
"""Bench of raptor_tpu_torch on an NVIDIA GPU: the rows of the reference's
``bench.py``, each through the port's own entry points, each printing one
JSON line with its times beside its correctness fields; the last line
gathers them.

    python3 bench_torch.py                       # every row, one card
    python3 bench_torch.py --rows kernels,structured128
    python3 bench_torch.py --rows sdist256,adist96 --ranks 4   # 4 cards
    python3 bench_torch.py --device cpu --small  # CPU smoke at CI sizes

Rows, in order (``bench.py`` lines in parentheses):

* ``kernels`` (83-140): every hand-written kernel (K1, K1v1, K2, K3, K4,
  K4-halo, K5, K6, K6-map_cols, K7) against its plain version at the
  bench's shapes (K7's plain version timed too); a failure ends the run
  with a non-zero exit;
* ``structured128``, ``structured256`` (571-658, 890-920): 7-point Poisson
  through ``dia_from_stencil`` -> ``build_structured_hierarchy``
  (semicoarsening, cheb4 degree 2, ``coarse_size`` 2048) -> bf16 planes ->
  the df64-refined PCG, the fp64 relres computed outside the solver; the
  SciPy V-cycle yardstick (51-80) on the 128^3 hierarchy;
* ``alg48``, ``alg96`` (142-227): shuffled Poisson through ``api.setup`` and
  ``api.solve`` (PMIS + direct; the banded layout with cheb4), the V-cycle
  with fp32 and bf16 preconditioner operators, and the SciPy yardstick;
* ``alg128`` (230-320): natural-ordered 128^3 as CSR in plane mode;
* ``devsetup`` (322-360): shuffled 96^3, PMIS + extended on ELL, the device
  route against the host route, cold and warm, and each one's iterations;
* ``configs`` (394-466): configs 1-5 and nonsym_gmres at the bench's sizes;
  config 4 by the host SA route (the bench's threshold) and the device SA
  route (the preset's);
* ``sdist256``: config 5 at 256^3 (``sdist_config5``), and ``adist96``: the
  algebraic sharded solve of shuffled 96^3, flat and TAPS; one rank by
  default, one NCCL rank a card with ``--ranks N`` (``parallel/comm.py``'s
  ``spawn``).

Every row checks what ``PERF.md`` section 2 pins at the bench's sizes
(iterations, true relres, level sizes) and records the check beside its
numbers; a row that fails prints an error line and the script exits 1.
Every time is a host clock ending in a device synchronize (kernel times:
CUDA-graph replays between CUDA events) and each line names the card and
its power limit.  ``--profile`` adds, to every cycle row, the launches per
cycle of each hand-written kernel and the device-busy share from
torch.profiler over 10 cycles.  It runs on ``cuda`` unless given
``--device cpu`` and never falls back to the CPU: without a card it exits
with an error.  It imports torch and raptor_tpu_torch, never JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from port_common import (ALG128_CFG, ALG_CFG, ALG_MAX_ITERS, ALG_SIZES,
                         CONFIG3_FENCE, CONFIG4_DEVICE_SIZES_PIN, CONFIG_ITERS,
                         CONFIG_SIZES, HOST_ROUTE_THRESHOLD, N_PROFILED, TOL,
                         TOL_KERNEL, config_problem, config_settings, graph_ms,
                         poisson7_residual, profile_cycles, shuffled_poisson,
                         stencil_7pt, true_relres)

ROWS = ("kernels", "structured128", "structured256", "alg48", "alg96",
        "alg128", "devsetup", "configs", "sdist256", "adist96")
SHARDED_ROWS = ("sdist256", "adist96")

# each row's sizes at the bench's scale, and at the CI sizes of --small
# (<= 20^3 in 3D, <= 64^2 in 2D; the banded layouts take levels of 2048
# rows and more); thresholds lowered there so that the device routes still
# build a level
FULL = {
    "kernels": dict(n=128, alg_n=48),
    "structured128": dict(n=128, coarse_size=2048, yardstick=True),
    "structured256": dict(n=256, coarse_size=2048, yardstick=False),
    "alg48": dict(n=48),
    "alg96": dict(n=96),
    "alg128": dict(n=128),
    "devsetup": dict(n=96, threshold=None),
    "configs": dict(sizes=CONFIG_SIZES, device_sa_threshold=None),
    "sdist256": dict(n=256),
    "adist96": dict(n=96, tail=4096),
}
SMALL = {
    "kernels": dict(n=16, alg_n=16),
    "structured128": dict(n=16, coarse_size=64, yardstick=True),
    "structured256": dict(n=12, coarse_size=64, yardstick=False),
    "alg48": dict(n=14),
    "alg96": dict(n=16),
    "alg128": dict(n=16),
    "devsetup": dict(n=12, threshold=800),
    "configs": dict(sizes={"config1": 16, "config2": 8, "config3": 24,
                           "config4": 4, "config5": 10, "nonsym_gmres": 24},
                    device_sa_threshold=0),
    "sdist256": dict(n=16),
    "adist96": dict(n=16, tail=1024),
}

CYCLES, REPS, SOLVE_REPS = 20, 3, 3
# PERF.md section 2, at the bench's sizes: PCG iteration limits (the
# reference's count + 1), the reference's level sizes
STRUCTURED_MAX_ITERS = {128: 8, 256: 8}
ALG128_SIZES = {128: [2**k for k in range(21, 5, -1)]}
ALG128_MAX_ITERS = {128: 10}
CONFIG4_FENCE = 3  # device SA against host SA iterations
# the sharded solves: fp32 PCG to 1e-6, no df64 refinement
SHARD_TOL, SHARD_MAX_TRUE = 1e-6, 1e-5


class RowFailed(Exception):
    """A row's check failed; ``row`` holds what it measured."""

    def __init__(self, message: str, row: dict):
        super().__init__(message)
        self.row = row


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def _sig(x, digits: int = 4):
    """Round floats (recursively) to a few significant digits, so the last
    line stays compact; the row lines keep every digit."""
    if isinstance(x, float):
        if x == 0 or not math.isfinite(x):
            return x
        return round(x, max(0, digits - 1 - math.floor(math.log10(abs(x)))))
    if isinstance(x, dict):
        return {k: _sig(v, digits) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_sig(v, digits) for v in x]
    return x


def _finite(x):
    """``x`` with every non-finite float as None, so each line is strict
    JSON."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def _json(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, (np.ndarray, torch.Tensor)):
        return x.tolist()
    return str(x)


def card_info(dev: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi gives them; a CPU
    run names no card."""
    if dev.type != "cuda":
        return {"device": "cpu", "name": None, "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = (s.strip() for s in line.strip().splitlines()[0].split(","))
    return {"device": str(dev), "name": name, "power_limit": limit}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev) -> tuple:
    """(fn(), seconds): host clock ending in a device synchronize."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def timed_reps(fn, dev, reps: int) -> tuple:
    """(last result, median seconds, every run's seconds) over ``reps``
    runs, each ending in a device synchronize."""
    times = []
    out = None
    for _ in range(reps):
        out, s = timed(fn, dev)
        times.append(s)
    return out, float(np.median(times)), times


def cycle_ms(cycle, dev, cycles: int = CYCLES, reps: int = REPS) -> tuple:
    """(median ms a cycle, every rep's): one warm cycle, then ``reps`` runs
    of ``cycles`` cycles between two synchronizes; the output must stay
    finite."""
    y = cycle()
    sync(dev)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(cycles):
            y = cycle()
        sync(dev)
        out.append((time.perf_counter() - t0) / cycles * 1e3)
    if not torch.isfinite(y).all():
        raise RuntimeError("V-cycle output not finite")
    return float(np.median(out)), out


class Checks:
    """A row's correctness checks: each is recorded, and ``close`` raises
    ``RowFailed`` if any failed."""

    def __init__(self, row: dict):
        self.row = row
        row["checks"] = []

    def __call__(self, name: str, ok: bool, got, limit) -> None:
        self.row["checks"].append({"check": name, "got": got, "limit": limit,
                                   "ok": bool(ok)})

    def at_most(self, name: str, got, limit) -> None:
        if limit is not None:
            self(name, got <= limit, got, limit)

    def equal(self, name: str, got, want) -> None:
        if want is not None:
            self(name, got == want, got, want)

    def close(self) -> dict:
        bad = [c["check"] for c in self.row["checks"] if not c["ok"]]
        if bad:
            raise RowFailed(f"checks failed: {bad}", self.row)
        return self.row


def scipy_vcycle_time(levels_csr, b, nu=2, reps=5):
    """fp64 SciPy V-cycle on the exported hierarchy: the CPU-core baseline
    (the reference bench's yardstick, bench.py:51-80)."""
    import scipy.sparse.linalg as spla

    mats = [lv["A"] for lv in levels_csr]
    Ps = [lv["P"] for lv in levels_csr[:-1]]
    Rs = [lv["R"] for lv in levels_csr[:-1]]
    dinvs = [1.0 / lv["A"].diagonal() for lv in levels_csr]

    def vcycle(k, bb):
        A = mats[k]
        if k == len(mats) - 1:
            return spla.spsolve(A.tocsc(), bb)
        x = np.zeros_like(bb)
        for _ in range(nu // 2 or 1):
            x = x + (2.0 / 3.0) * dinvs[k] * (bb - A @ x)
        r = bb - A @ x
        ec = vcycle(k + 1, Rs[k] @ r)
        x = x + Ps[k] @ ec
        for _ in range(nu // 2 or 1):
            x = x + (2.0 / 3.0) * dinvs[k] * (bb - A @ x)
        return x

    vcycle(0, b)  # warm
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        vcycle(0, b)
        best = min(best, time.perf_counter() - t0)
    return best  # fastest CPU run = the strongest baseline


def structured_csr(h) -> list:
    """The structured hierarchy's levels as fp64 SciPy CSR: A, and P and R
    from the embedded Pt (the coarse grid's points are those with an even
    coordinate along the level's cdim)."""
    from raptor_tpu_torch.structured import dia_to_scipy

    out = []
    for lv in h.levels:
        entry = {"A": dia_to_scipy(lv.A).astype(np.float64)}
        if lv.Pt is not None:
            m = np.zeros(lv.dims, dtype=bool)
            m[tuple(slice(None, None, 2) if ax == lv.cdim else slice(None)
                    for ax in range(len(lv.dims)))] = True
            entry["P"] = dia_to_scipy(lv.Pt).astype(np.float64)[:, m.ravel()]
            entry["R"] = entry["P"].T.tocsr()
        out.append(entry)
    return out


def algebraic_csr(h) -> list:
    """The algebraic hierarchy's levels as fp64 SciPy CSR (its own
    ordering, padding dropped)."""
    from raptor_tpu_torch.core.ell import ell_to_csr

    out = []
    for k, lv in enumerate(h.levels):
        entry = {"A": ell_to_csr(lv.A).astype(np.float64)[:lv.n, :lv.n]}
        if k + 1 < len(h.levels):
            nc = h.levels[k + 1].n
            entry["P"] = ell_to_csr(lv.P).astype(np.float64)[:lv.n, :nc].tocsr()
            entry["R"] = ell_to_csr(lv.R).astype(np.float64)[:nc, :lv.n].tocsr()
        out.append(entry)
    return out


def cpu_yardstick(levels_csr) -> dict:
    n = levels_csr[0]["A"].shape[0]
    s = scipy_vcycle_time(levels_csr, np.ones(n))
    return {"cpu_vcycle_ms": s * 1e3, "cpu_core_dof_per_s": n / s}


# ---------------------------------------------------------------------------
# row: the kernel-equality check (bench.py:83-140)
# ---------------------------------------------------------------------------

def kernel_wrappers(dev) -> dict:
    """Each kernel's wrapper on the card; on another device, where the
    wrappers take no tensor, the plain version that its caller routes to
    there (the wrapper's name with ``_ref``)."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk
    from raptor_tpu_torch.ops.cuda import dia_kernel as dk
    from raptor_tpu_torch.structured import dia as sd

    wrappers = {"K1": dk.dia_spmv_v2, "K1v1": dk.dia_spmv_v1,
                "K2": dk.dia_spmv_const, "K3": dk.dia_spmv_halo,
                "K4": bk.banded_spmv, "K4-halo": bk.banded_spmv_halo,
                "K5": bk.banded_df64_residual, "K6": bk.banded_spmv_rect,
                "K6-map_cols": bk.banded_spmv_rect, "K7": sd.dia_df64_residual}
    if torch.device(dev).type == "cuda":
        return wrappers
    return {k: getattr(sys.modules[f.__module__], f.__name__ + "_ref")
            for k, f in wrappers.items()}


def plain_versions() -> dict:
    """Each kernel's plain PyTorch version, which the check holds it to."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk
    from raptor_tpu_torch.ops.cuda import dia_kernel as dk
    from raptor_tpu_torch.structured import dia as sd

    return {"K1": dk.dia_spmv_v2_ref, "K1v1": dk.dia_spmv_v1_ref,
            "K2": dk.dia_spmv_const_ref, "K3": dk.dia_spmv_halo_ref,
            "K4": bk.banded_spmv_ref, "K4-halo": bk.banded_spmv_halo_ref,
            "K5": bk.banded_df64_residual_ref, "K6": bk.banded_spmv_rect_ref,
            "K6-map_cols": bk.banded_spmv_rect_ref,
            "K7": sd.dia_df64_residual_ref}


def _planes(dims, offsets, dtype, gen, dev, zeroed=True):
    from raptor_tpu_torch.ops.cuda.dia_kernel import in_grid_mask
    from raptor_tpu_torch.structured.dia import _linear

    data = torch.randn((len(offsets), int(np.prod(dims))), generator=gen,
                       device=dev)
    if zeroed:
        for k, o in enumerate(offsets):
            data[k] *= in_grid_mask(dims, o, dev)
    return data.to(dtype), [_linear(o, dims) for o in offsets]


def _dia_cases(dev, n: int, gen) -> list:
    """(kernel, label, args) of the DIA kernels at the structured rows'
    shapes: K2 on the n^3 and (2n)^3 fine levels, K1 on level 1 (bf16 and
    fp32), level 2 and a fine-level Pt, K1v1 on n^3 planes that are not
    boundary-zeroed, K3 on a 4-rank (2n)^3 block and its halos, K7 on the
    n^3 fine level (const form) and on random n^3 planes (planes form)."""
    import itertools

    from raptor_tpu_torch.ops.cuda.dia_kernel import halo_reach
    from raptor_tpu_torch.structured.dia import DiaMatrix, dia_from_stencil

    cube = list(itertools.product((-1, 0, 1), repeat=3))
    off7 = [o for o in cube if sum(map(abs, o)) <= 1]
    off15 = [o for o in cube if abs(o[1]) + abs(o[2]) <= 1]
    st = stencil_7pt()
    consts = [float(st[tuple(np.add(o, 1))]) for o in off7]

    def vec(m):
        return torch.randn(m, generator=gen, device=dev)

    cases = [("K2", f"{dims}", (consts, off7, dims, vec(int(np.prod(dims)))))
             for dims in ((n,) * 3, (2 * n,) * 3)]
    for label, dims, offs, dtype in (
            ("level 1", (n // 2, n, n), off15, torch.bfloat16),
            ("level 1", (n // 2, n, n), off15, torch.float32),
            ("level 2", (n // 2, n // 2, n), cube, torch.bfloat16),
            ("Pt", (n,) * 3, [(-1, 0, 0), (0, 0, 0), (1, 0, 0)], torch.bfloat16)):
        data, lins = _planes(dims, offs, dtype, gen, dev)
        cases.append(("K1", f"{label} {dims} {len(offs)} offsets {dtype}",
                      (data, lins, vec(data.shape[1]))))
    data, lins = _planes((n,) * 3, off7, torch.float32, gen, dev, zeroed=False)
    cases.append(("K1v1", f"{(n,) * 3} 7 offsets, not boundary-zeroed",
                  (data, lins, vec(data.shape[1]))))
    dims = (n // 2, 2 * n, 2 * n)
    data, lins = _planes(dims, off7, torch.float32, gen, dev)
    LP, RP = halo_reach(lins)
    cases.append(("K3", f"4-rank {2 * n}^3 block {dims}, halos {LP}/{RP}",
                  (data, lins, vec(data.shape[1]), vec(LP), vec(RP))))
    data, _ = _planes((n,) * 3, off7, torch.float32, gen, dev)
    for label, A in (
            ("const", dia_from_stencil(st, (n,) * 3, device=dev)),
            ("planes", DiaMatrix(data=data, offsets=tuple(off7),
                                 dims=(n,) * 3))):
        # (xh, xl, bh, bl): df64 pairs whose tails lie under half an ulp
        xh, bh = vec(A.n), 30 * vec(A.n)
        tails = [v * 2.0**-25 * torch.rand(A.n, generator=gen, device=dev)
                 for v in (xh, bh)]
        cases.append(("K7", f"{label} {(n,) * 3} 7 offsets",
                      (A, xh, tails[0], bh, tails[1])))
    return cases


def _banded_cases(dev, alg_n: int, gen, ranks: int = 4) -> list:
    """(kernel, label, args) of the banded kernels on the shuffled alg_n^3
    hierarchy of the alg rows, padded for ``ranks`` ranks: K4 on level 0's
    A (fp32 and bf16), K6 on its P and R, K5 with the fp32 remainder of
    level 0, and the sharded forms on the first and last rank's tiles of
    level 0 (K4-halo on A, K6-map_cols on R and P)."""
    from raptor_tpu_torch import AmgConfig, setup
    from raptor_tpu_torch.parallel.dist import _shardable_band, _shardable_rect
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic

    # no folded tail: the check reads level 0 alone
    h = setup(shuffled_poisson(alg_n),
              AmgConfig(**ALG_CFG, host_setup_threshold=HOST_ROUTE_THRESHOLD,
                        pad_multiple=1024 * ranks, tail_max_n=0), device=dev)
    lv, lv1 = h.levels[0], h.levels[1]
    hb = cast_hierarchy_algebraic(h, torch.bfloat16)

    def vec(m):
        return torch.randn(m, generator=gen, device=dev)

    A, R, P = lv.Aband.plan(), lv.Rband.plan(), lv.Pband.plan()
    cases = [("K4", f"L0 A {A['n']} rows K {A['K']} float32", (A, vec(A["n"]))),
             ("K4", "L0 A bfloat16", (hb.levels[0].Aband.plan(), vec(A["n"]))),
             ("K6", f"L0 R {R['n']} x {R['n_cols']}", (R, vec(R["n_cols"]))),
             ("K6", f"L0 P {P['n']} x {P['n_cols']}", (P, vec(P["n_cols"])))]
    n = A["n"]
    b64 = torch.randn(n, generator=gen, device=dev, dtype=torch.float64)
    bh = b64.float()
    cases.append(("K5", f"L0 {n} rows, vals_lo {h.a0_lo_band is not None}",
                  (A, h.a0_lo_band, vec(n), bh, (b64 - bh.double()).float(),
                   vec(n) * 1e-6)))
    B = _shardable_band(lv.Aband, ranks)
    if B is None:
        raise RuntimeError(f"level 0's banded A does not shard over {ranks}")
    K, nn, tile, kh, npage, Wp = B.meta
    nl, hw = nn // ranks, kh * tile
    for rank in (0, ranks - 1):
        tiles = slice(rank * nl // tile, (rank + 1) * nl // tile)
        plan = dict(B.plan(), n=nl, vals=B.vals[tiles].contiguous(),
                    pidx=B.pidx[tiles].contiguous())
        cases.append(("K4-halo", f"L0 A rank {rank} of {ranks}",
                      (plan, vec(nl + 2 * hw))))
    nf, nc = lv.A.n_rows_pad, lv1.A.n_rows_pad
    for name, band, rows, cols in (("R", lv.Rband, nc, nf),
                                   ("P", lv.Pband, nf, nc)):
        B = _shardable_rect(band, ranks, rows, cols)
        if B is None:
            raise RuntimeError(f"level 0's banded {name} does not shard")
        K, nn, n_cols, tile, WpP, npage = B.meta
        nl, cl = nn // ranks, n_cols // ranks
        for rank in (0, ranks - 1):
            tiles = slice(rank * nl // tile, (rank + 1) * nl // tile)
            length = cl + npage * 1024
            plan = dict(B.plan(), n=nl, n_cols=length, WpP=0,
                        vals=B.vals[tiles].contiguous(),
                        pidx=B.pidx[tiles].contiguous())
            cases.append(("K6-map_cols", f"L0 {name} rank {rank} of {ranks}",
                          (plan, vec(length), cl)))
    return cases


def row_kernels(dev, n: int, alg_n: int, profile: bool = False) -> dict:
    """Every hand-written kernel against its plain version on the same
    tensors, at the shapes of the structured and algebraic rows; times each
    case on the card (graph replay, L2-warm).  Any case off by more than
    TOL_KERNEL * max|y_ref| fails the row."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    kern, plain = kernel_wrappers(dev), plain_versions()
    cases = _dia_cases(dev, n, gen) + _banded_cases(dev, alg_n, gen)
    row = {"row": "kernels", "n": n, "alg_n": alg_n, "tol": TOL_KERNEL,
           "cases": []}
    check = Checks(row)
    for name, label, args in cases:
        y, y_ref = kern[name](*args), plain[name](*args)
        ys, refs = ((y, y_ref) if isinstance(y, tuple) else ((y,), (y_ref,)))
        sync(dev)
        ok_shape = all(a.shape == b.shape and bool(torch.isfinite(a).all())
                       for a, b in zip(ys, refs))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(ys, refs)) if ok_shape else math.inf
        scale = float(refs[0].double().abs().max())
        case = {"kernel": name, "shape": label, "max_abs_err": err,
                "max_ref": scale,
                "bit_equal": ok_shape and all(torch.equal(a, b)
                                              for a, b in zip(ys, refs)),
                "ms": (graph_ms(lambda: kern[name](*args))
                       if dev.type == "cuda" else None)}
        if name == "K7" and dev.type == "cuda":
            # the op-by-op route the CPU takes, timed on the card beside K7
            case["plain_ms"] = graph_ms(lambda: plain[name](*args))
        case["pass"] = bool(err <= TOL_KERNEL * scale)
        row["cases"].append(case)
        log(f"[kernels] {name} {label}: max_abs_err {err:.3e} (max|y_ref| "
            f"{scale:.3e}), bit-equal {case['bit_equal']}"
            + ("" if case["ms"] is None else f", {case['ms'] * 1e3:.1f} us")
            + (f" (plain {case['plain_ms'] * 1e3:.1f} us)"
               if "plain_ms" in case else ""))
    row["kernels"] = {}
    for name in kern:
        mine = [c for c in row["cases"] if c["kernel"] == name]
        row["kernels"][name] = {
            "pass": bool(mine) and all(c["pass"] for c in mine),
            "cases": len(mine), "bit_equal": all(c["bit_equal"] for c in mine),
            "max_rel_err": max((c["max_abs_err"] / (c["max_ref"] or 1.0)
                                for c in mine), default=None)}
        check(f"{name} equals its plain version", row["kernels"][name]["pass"],
              row["kernels"][name]["max_rel_err"], TOL_KERNEL)
    return check.close()


# ---------------------------------------------------------------------------
# rows: the structured engine (bench.py:571-658, 890-920)
# ---------------------------------------------------------------------------

def row_structured(dev, n: int, coarse_size: int, yardstick: bool,
                   profile: bool = False) -> dict:
    """The reference bench's ``measure`` at n^3: setup cold and warm, the
    V-cycle with bf16 and fp32 planes, the refined solve, the fp64 relres
    outside the solver."""
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle,
                                  structured_solve_refined)
    from raptor_tpu_torch.gallery import default_rhs

    cfg = AmgConfig(smoother="cheb4", cheb_degree=2, coarse_size=coarse_size,
                    max_levels=40)
    A = dia_from_stencil(stencil_7pt(), (n,) * 3, device=dev)
    N = n ** 3

    def build():
        return build_structured_hierarchy(A, cfg, dim_policy="size")

    h, cold = timed(build, dev)
    h, warm = timed(build, dev)
    hM = cast_hierarchy(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(N, dtype=np.float32)).to(dev)
    vc, vc_reps = cycle_ms(lambda: scycle(hM, b), dev)
    vc32, vc32_reps = cycle_ms(lambda: scycle(h, b), dev)

    def solve():
        return structured_solve_refined(h, b, tol=TOL, M_hier=hM)

    timed(solve, dev)  # warm
    ((xh, xl), rel, iters), sol, sol_reps = timed_reps(solve, dev, SOLVE_REPS)
    x64 = xh.double().cpu().numpy() + xl.double().cpu().numpy()
    b64 = b.double().cpu().numpy()
    relres = float(np.linalg.norm(poisson7_residual(x64, b64, n))
                   / np.linalg.norm(b64))
    row = {"row": f"structured{n}", "n": N, "dims": [n] * 3,
           "problem": f"3D Poisson {n}^3 AMG-PCG, structured engine, bf16 "
                      "ops/fp32 vectors",
           "levels": len(h.levels), "plan": [lv.cdim for lv in h.levels[:-1]],
           "coarse_size": coarse_size,
           "vcycle_s": vc * 1e-3, "vcycle_ms_reps": vc_reps,
           "vcycle_fp32_s": vc32 * 1e-3, "vcycle_fp32_ms_reps": vc32_reps,
           "dof_per_s": N / (vc * 1e-3), "dof_per_s_fp32": N / (vc32 * 1e-3),
           "setup_s": warm, "setup_cold_s": cold,
           "solve_s": sol, "solve_s_reps": sol_reps,
           "iters": int(iters), "certified": float(rel), "relres": relres}
    if yardstick:
        y = cpu_yardstick(structured_csr(h))
        row.update(y, vs_baseline=row["dof_per_s"] / (10.0 * y["cpu_core_dof_per_s"]))
    if profile:
        row["profile"] = profile_cycles(lambda: scycle(hM, b))
    log(f"[structured {n}^3] setup {warm:.3f} s warm ({cold:.3f} s cold), "
        f"{len(h.levels)} levels; V-cycle bf16 {vc:.3f} ms, fp32 {vc32:.3f} "
        f"ms; solve {sol:.3f} s, {int(iters)} iterations, true relres "
        f"{relres:.3e}")
    check = Checks(row)
    check("solution finite", bool(np.isfinite(x64).all()), None, None)
    check.at_most("true relres", relres, TOL)
    check.at_most("iterations", row["iters"], STRUCTURED_MAX_ITERS.get(n))
    return check.close()


# ---------------------------------------------------------------------------
# rows: the algebraic engine (bench.py:142-360)
# ---------------------------------------------------------------------------

def _build(A, cfg, dev, B=None):
    """(api.setup of a copy of A, seconds): setup may sort the column
    indices of the CSR it is given in place (``ell_from_csr``), and the
    banded layout's RCM ordering depends on that order, so each build
    takes the caller's matrix as it was made."""
    from raptor_tpu_torch import setup

    A = A.copy()
    return timed(lambda: setup(A, cfg, B=B, device=dev), dev)


def _device_solve(h, b, dev, M_hier=None) -> tuple:
    """solve_hier_refined on the device alone (no host permutation or
    transfer in the timed runs): (iterations, median seconds, runs)."""
    from raptor_tpu_torch import SolveConfig
    from raptor_tpu_torch.api import solve_hier_refined
    from raptor_tpu_torch.core.ell import pad_vector

    n = b.shape[0]
    bp = b if h.perm is None else b[h.perm[:n].cpu().numpy()]
    n_pad = h.levels[0].A.n_rows_pad
    bd = pad_vector(bp.astype(np.float32), n_pad, device=dev)
    bdl = pad_vector((bp - bp.astype(np.float32).astype(np.float64))
                     .astype(np.float32), n_pad, device=dev)
    mi = SolveConfig().maxiter

    def run():
        return solve_hier_refined(h, bd, tol=TOL, maxiter=mi, b_lo=bdl,
                                  M_hier=M_hier)

    timed(run, dev)  # warm
    out, s, reps = timed_reps(run, dev, SOLVE_REPS)
    return int(out[2]), s, reps


def _precision_pair(h, dev, b_np, profile: bool) -> dict:
    """The V-cycle and the device solve with the hierarchy's own operators
    and with bf16 preconditioner operators (cast_hierarchy_algebraic)."""
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic
    from raptor_tpu_torch.solve.cycle import cycle

    hb = cast_hierarchy_algebraic(h, torch.bfloat16)
    bd = pad_vector(np.ones(h.levels[0].n, np.float32),
                    h.levels[0].A.n_rows_pad, device=dev)
    out = {}
    for tag, hh, M in (("fp32", h, None), ("bf16", hb, hb)):
        out[f"vcycle_{tag}_ms"], out[f"vcycle_{tag}_ms_reps"] = cycle_ms(
            lambda: cycle(hh, bd), dev)
        it, s, reps = _device_solve(h, b_np, dev, M_hier=M)
        out[f"solve_{tag}_device_s"], out[f"solve_{tag}_device_s_reps"] = s, reps
        out[f"iterations_{tag}"] = it
        if profile:
            out[f"profile_{tag}"] = profile_cycles(lambda: cycle(hh, bd))
    return out


def row_algebraic(dev, n: int, profile: bool = False) -> dict:
    """The reference bench's algebraic_setup_detail at shuffled n^3: the
    ELL setup cold and warm, then the banded cheb4 setup and refined solve
    (cold, warm, and on the device alone), the V-cycle with fp32 and bf16
    preconditioner operators, and the SciPy yardstick."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve

    A = shuffled_poisson(n)
    N = A.shape[0]
    cfg = AmgConfig(splitting="pmis", interp="direct")
    _, cold = _build(A, cfg, dev)
    _, warm = _build(A, cfg, dev)
    b = np.ones(N)
    cfg_b = AmgConfig(**ALG_CFG)
    sc = SolveConfig(tol=TOL, refine=True)
    sync(dev)
    t0 = time.perf_counter()
    hb, _ = _build(A, cfg_b, dev)
    x, info = solve(A, b, cfg_b, sc, hier=hb)
    total = time.perf_counter() - t0
    (x, info), solve_warm, solve_reps = timed_reps(
        lambda: solve(A, b, cfg_b, sc, hier=hb), dev, SOLVE_REPS)
    pair = _precision_pair(hb, dev, b, profile)
    sizes = [lv.n for lv in hb.levels]
    row = {"row": f"alg{n}",
           "problem": f"shuffled 3D Poisson {n}^3 (n={N}), algebraic engine",
           "n": N, "setup_cold_s": cold, "setup_warm_s": warm,
           "banded_setup_and_solve_cold_s": total,
           "banded_solve_warm_s": solve_warm,
           "banded_solve_warm_s_reps": solve_reps,
           "banded_solve_warm_device_s": pair["solve_fp32_device_s"],
           "iterations": int(info["iterations"]), "relres": float(info["relres"]),
           "true_relres": true_relres(A, x, b), "sizes": sizes,
           "device_fused_levels": sum(s > cfg_b.host_setup_threshold
                                      for s in sizes),
           **pair, **cpu_yardstick(algebraic_csr(hb))}
    log(f"[alg{n}] setup cold={cold:.3f}s warm={warm:.3f}s; banded setup+solve "
        f"cold {total:.3f}s, warm solve {solve_warm * 1e3:.1f} ms "
        f"({row['banded_solve_warm_device_s'] * 1e3:.1f} ms device), "
        f"iters={row['iterations']} "
        f"true relres={row['true_relres']:.2e}; V-cycle fp32 "
        f"{row['vcycle_fp32_ms']:.3f} ms, bf16 {row['vcycle_bf16_ms']:.3f} ms")
    check = Checks(row)
    check.at_most("true relres", row["true_relres"], TOL)
    check.at_most("iterations", row["iterations"], ALG_MAX_ITERS.get(n))
    check.equal("device solve iterations", pair["iterations_fp32"],
                row["iterations"])
    check.equal("level sizes", sizes, ALG_SIZES.get(n))
    return check.close()


def row_alg128(dev, n: int, profile: bool = False) -> dict:
    """The reference bench's algebraic_128_detail: natural-ordered n^3
    Poisson as CSR through the general engine in plane mode (cheb4 degree
    3, bf16 preconditioner operators); setup cold and warm, the V-cycle,
    the refined solve cold and warm, and on the device alone with bf16 and
    fp32 preconditioner operators."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.gallery import poisson_3d

    A = sp.csr_matrix(poisson_3d(n))
    N = A.shape[0]
    cfg = AmgConfig(**ALG128_CFG)
    _, cold = _build(A, cfg, dev)
    h, warm = _build(A, cfg, dev)
    sizes = [lv.n for lv in h.levels]
    layouts = ["hyb" if lv.Ahyb is not None else "band" if lv.Aband is not None
               else "ell" for lv in h.levels]
    b = np.ones(N)
    sc = SolveConfig(tol=TOL, refine=True)
    (x, info), solve_cold = timed(lambda: solve(A, b, cfg, sc, hier=h), dev)
    (x, info), solve_warm, solve_reps = timed_reps(
        lambda: solve(A, b, cfg, sc, hier=h), dev, SOLVE_REPS)
    pair = _precision_pair(h, dev, b, profile)
    row = {"row": "alg128",
           "problem": f"natural-ordered 3D Poisson {n}^3 via general CSR API",
           "n": N, "setup_cold_s": cold, "setup_warm_s": warm,
           "setup_rows_per_s": N / warm,
           "device_fused_levels": sum(s > cfg.host_setup_threshold for s in sizes),
           "levels": len(sizes), "sizes": sizes, "layouts": layouts,
           "vcycle_ms": pair["vcycle_bf16_ms"],
           "dof_per_s": N / (pair["vcycle_bf16_ms"] * 1e-3),
           "solve_cold_s": solve_cold, "solve_warm_s": solve_warm,
           "solve_warm_s_reps": solve_reps,
           "iterations": int(info["iterations"]), "relres": float(info["relres"]),
           "true_relres": true_relres(A, x, b), **pair}
    log(f"[alg128] setup {warm:.3f}s warm ({cold:.3f}s cold), {len(sizes)} "
        f"levels, layouts {layouts}; V-cycle bf16 {row['vcycle_ms']:.3f} ms, "
        f"fp32 {pair['vcycle_fp32_ms']:.3f} ms; solve {solve_warm:.3f}s warm, "
        f"{row['iterations']} iters, true relres {row['true_relres']:.2e}")
    check = Checks(row)
    check.at_most("true relres", row["true_relres"], TOL)
    check.at_most("iterations", row["iterations"], ALG128_MAX_ITERS.get(n))
    check.equal("device solve iterations (bf16)", pair["iterations_bf16"],
                row["iterations"])
    check.equal("level sizes", sizes, ALG128_SIZES.get(n))
    return check.close()


def row_devsetup(dev, n: int, threshold=None, profile: bool = False) -> dict:
    """The reference bench's device_setup_detail: shuffled n^3, PMIS +
    extended on the ELL layout, built by the device route (levels above
    ``host_setup_threshold``) and by the host route, each cold and warm,
    and each hierarchy's refined-solve iterations (the reference's quality
    comparison)."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve

    A = shuffled_poisson(n)
    N = A.shape[0]
    cfg = AmgConfig(splitting="pmis", interp="extended",
                    **({} if threshold is None else
                       {"host_setup_threshold": threshold}))
    hcfg = dataclasses.replace(cfg, host_setup_threshold=HOST_ROUTE_THRESHOLD)
    b = np.ones(N)
    sc = SolveConfig(tol=TOL, refine=True)
    row = {"row": "devsetup",
           "problem": f"shuffled 3D Poisson {n}^3 (n={N}), device-fused setup",
           "n": N, "host_setup_threshold": cfg.host_setup_threshold}
    # the device route's fields carry the reference's names, the host
    # route's the same names after "host_"
    for pre, it, c in (("", "iterations_dev", cfg),
                       ("host_", "iterations_host", hcfg)):
        _, cold = _build(A, c, dev)
        h, warm = _build(A, c, dev)
        x, info = solve(A, b, c, sc, hier=h)
        row.update({f"{pre}setup_cold_s": cold, f"{pre}setup_warm_s": warm,
                    f"{pre}setup_rows_per_s": N / warm,
                    it: int(info["iterations"]),
                    f"{pre}true_relres": true_relres(A, x, b),
                    f"{pre}sizes": [lv.n for lv in h.levels]})
        del h
    row["device_fused_levels"] = sum(s > cfg.host_setup_threshold
                                     for s in row["sizes"])
    row["levels"] = len(row["sizes"])
    log(f"[devsetup] n={N}: device route {row['setup_warm_s']:.3f}s warm "
        f"({row['setup_cold_s']:.3f}s cold), host route "
        f"{row['host_setup_warm_s']:.3f}s warm ({row['host_setup_cold_s']:.3f}s "
        f"cold); {row['device_fused_levels']}/{row['levels']} device-fused "
        f"levels; iterations device-built {row['iterations_dev']}, host-built "
        f"{row['iterations_host']}")
    check = Checks(row)
    check.at_most("true relres", row["true_relres"], TOL)
    check.at_most("host route true relres", row["host_true_relres"], TOL)
    check.equal("iterations, device route against host route",
                row["iterations_dev"], row["iterations_host"])
    check.equal("levels, device route against host route", row["levels"],
                len(row["host_sizes"]))
    check("levels built on the device", row["device_fused_levels"] > 0,
          row["device_fused_levels"], "> 0")
    return check.close()


def _config_run(A, B, cfg, sc, dev) -> dict:
    from raptor_tpu_torch import solve

    b = np.ones(A.shape[0])
    h, setup_s = _build(A, cfg, dev, B=B)
    (x, info), solve_s = timed(lambda: solve(A, b, cfg, sc, hier=h), dev)
    return {"n": int(A.shape[0]), "iterations": int(info["iterations"]),
            "relres": float(info["relres"]), "true_relres": true_relres(A, x, b),
            "total_s": setup_s + solve_s, "setup_s": setup_s, "solve_s": solve_s,
            "levels": info["stats"]["levels"], "sizes": info["stats"]["sizes"]}


def row_configs(dev, sizes: dict, device_sa_threshold=None,
                profile: bool = False) -> dict:
    """The reference bench's acceptance_configs_detail: each config's
    problem at ``sizes``, api.setup and the refined api.solve with b = ones;
    config 4 also by the device SA route (the preset's threshold, or
    ``device_sa_threshold``)."""
    row = {"row": "configs", "configs": {}}
    check = Checks(row)
    full = sizes == FULL["configs"]["sizes"]
    for name, size in sizes.items():
        A, B = config_problem(name, size)
        cfg, sc = config_settings(name)
        r = _config_run(A, B, cfg, sc, dev)
        r["size"] = size
        row["configs"][name] = r
        log(f"[{name}] n={r['n']} iters={r['iterations']} relres="
            f"{r['relres']:.2e} true={r['true_relres']:.2e} setup "
            f"{r['setup_s']:.2f}s solve {r['solve_s']:.2f}s")
        check.at_most(f"{name} true relres", r["true_relres"], TOL)
        if full:
            check.at_most(f"{name} iterations", r["iterations"],
                          CONFIG3_FENCE if name == "config3"
                          else CONFIG_ITERS[name] + 1)
        if name == "config4":
            from raptor_tpu_torch import PRESETS

            dcfg = PRESETS["config4"]
            if device_sa_threshold is not None:
                dcfg = dataclasses.replace(
                    dcfg, host_setup_threshold=device_sa_threshold)
            d = _config_run(A, B, dcfg, sc, dev)
            d["host_setup_threshold"] = dcfg.host_setup_threshold
            row["configs"]["config4_device_sa"] = d
            log(f"[config4 device SA] sizes {d['sizes']} iters "
                f"{d['iterations']} true={d['true_relres']:.2e} setup "
                f"{d['setup_s']:.2f}s (host SA {r['setup_s']:.2f}s)")
            check.at_most("config4 device SA true relres", d["true_relres"], TOL)
            check.at_most("config4 device SA iterations against host SA",
                          abs(d["iterations"] - r["iterations"]), CONFIG4_FENCE)
            check.equal("config4 device SA levels 0-1 against host SA",
                        d["sizes"][:2], r["sizes"][:2])
            if full:
                check.equal("config4 device SA sizes", d["sizes"],
                            CONFIG4_DEVICE_SIZES_PIN)
    return check.close()


# ---------------------------------------------------------------------------
# rows: the sharded engines, one rank in this process or --ranks N spawned
# ---------------------------------------------------------------------------

def taps_grid(ranks: int) -> tuple:
    """(nodes, chips) of the TAPS mesh over ``ranks`` ranks."""
    return (2, ranks // 2) if ranks % 2 == 0 else (1, ranks)


def _sdist_body(ring, dev, profile: bool, n: int) -> dict:
    """Config 5 on this rank: sdist_config5 cold then warm, V-cycles;
    rank 0 also the fp64 relres of the gathered x and the single-device
    solve on the same plan."""
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.ops.cuda import launch
    from raptor_tpu_torch.structured import dist as sd
    from raptor_tpu_torch.structured.solver import (_build_hierarchy_planned,
                                                    structured_solve)

    before = collections.Counter(launch.launches)
    cold = sd.sdist_config5(ring, dev, n=n)
    warm = sd.sdist_config5(ring, dev, n=n)
    launches = launch.launches - before
    dh, info = warm["hier"], warm["info"]
    b = torch.from_numpy(default_rhs(n ** 3, dtype=np.float32)).to(dev)
    b_loc = sd._block(b, ring, int(np.prod(dh.levels[0].dims_local)))
    vc, vc_reps = cycle_ms(lambda: sd.sdist_cycle(dh, ring, b_loc), dev)
    out = {"setup_s": warm["setup_s"], "setup_cold_s": cold["setup_s"],
           "solve_s": warm["solve_s"], "solve_cold_s": cold["solve_s"],
           "vcycle_ms": vc, "vcycle_ms_reps": vc_reps,
           "iters": int(info.iterations), "iters_cold": int(cold["info"].iterations),
           "certified": float(info.relres),
           "launches": dict(sorted(launches.items())),
           "dims_local": [list(lv.dims_local) for lv in dh.levels]}
    if profile:
        out["profile"] = ring_profile(lambda: sd.sdist_cycle(dh, ring, b_loc),
                                      dev, ring)
    x = sd.gather(warm["x"], ring)
    if ring.axis_index == 0:
        b64 = b.double().cpu().numpy()
        x64 = x.double().cpu().numpy()
        out["relres"] = float(np.linalg.norm(poisson7_residual(x64, b64, n))
                              / np.linalg.norm(b64))
        A, _ = sd.config5_problem(n, dev)
        plan, _ = sd.plan_coarsening_dist(A, sd.CONFIG5, ring.axis_size, "size")
        _, info1 = structured_solve(_build_hierarchy_planned(A, sd.CONFIG5, plan),
                                    b, tol=sd.CONFIG5_TOL,
                                    maxiter=sd.CONFIG5_MAXITER)
        out["single_device_iters"] = int(info1.iterations)
    return out


def _adist_body(ring, dev, profile: bool, n: int, tail: int) -> dict:
    """The algebraic sharded solve of shuffled n^3 on this rank: the
    host-built banded hierarchy padded for the ring (a banded layout is the
    route to K4's halo form and K6's map_cols form), distribute_hierarchy
    and dist_solve cold then warm, V-cycles, then TAPS; rank 0 also the
    fp64 relres of the gathered x and the single-device solve_hier."""
    from raptor_tpu_torch import AmgConfig, setup
    from raptor_tpu_torch.api import solve_hier
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.ops.cuda import launch
    from raptor_tpu_torch.parallel import (dist_solve, dist_solve_taps,
                                           distribute_hierarchy,
                                           distribute_hierarchy_taps,
                                           make_taps_mesh)
    from raptor_tpu_torch.parallel import dist as pdist

    ranks = ring.axis_size
    A = shuffled_poisson(n)
    N = A.shape[0]
    h, setup_s = timed(lambda: setup(
        A, AmgConfig(**ALG_CFG, host_setup_threshold=HOST_ROUTE_THRESHOLD,
                     pad_multiple=1024 * ranks), device=dev), dev)
    pm = h.perm[:N].cpu().numpy()
    b = default_rhs(N)
    bd = pad_vector(b[pm].astype(np.float32), h.levels[0].A.n_rows_pad, device=dev)
    out = {"setup_s": setup_s, "sizes": [lv.n for lv in h.levels],
           "tail": tail}
    if ring.axis_index == 0:
        _, info1 = solve_hier(h, bd, tol=SHARD_TOL, maxiter=200)
        out["single_device_iters"] = int(info1.iterations)
    before = collections.Counter(launch.launches)
    runs = []
    for _ in ("cold", "warm"):
        dh, dist_s = timed(lambda: distribute_hierarchy(h, ring, tail), dev)
        (x, info), sol = timed(lambda: dist_solve(dh, bd, ring, tol=SHARD_TOL,
                                                  maxiter=200), dev)
        runs.append((dist_s, sol, int(info.iterations), float(info.relres)))
    launches = launch.launches - before
    ctx = pdist.CommCtx.flat(ring)
    b_loc = pdist._rows(bd, ring, dh.levels[0].n_local)
    vc, vc_reps = cycle_ms(lambda: pdist.dist_cycle(dh, b_loc, ctx), dev)
    mesh = make_taps_mesh(*taps_grid(ranks))
    th, taps_dist_s = timed(lambda: distribute_hierarchy_taps(h, mesh, tail), dev)
    (xt, it_t), taps_s = timed(lambda: dist_solve_taps(th, bd, mesh, tol=SHARD_TOL,
                                                       maxiter=200), dev)
    (dist_cold, sol_cold, it_cold, _), (dist_s, sol, iters, certified) = runs
    out.update({"distribute_s": dist_s, "distribute_cold_s": dist_cold,
                "solve_s": sol, "solve_cold_s": sol_cold, "iters": iters,
                "iters_cold": it_cold, "certified": certified,
                "taps_grid": list(taps_grid(ranks)),
                "taps_distribute_s": taps_dist_s, "taps_solve_s": taps_s,
                "taps_iters": int(it_t.iterations),
                "taps_certified": float(it_t.relres),
                "vcycle_ms": vc, "vcycle_ms_reps": vc_reps,
                "launches": dict(sorted(launches.items()))})
    if profile:
        out["profile"] = ring_profile(lambda: pdist.dist_cycle(dh, b_loc, ctx),
                                      dev, ring)
    xs = [ring.all_gather(v) for v in (x, xt)]
    if ring.axis_index == 0:
        for key, v in zip(("true_relres", "taps_true_relres"), xs):
            xc = np.empty(N)
            xc[pm] = v.double().cpu().numpy()[:N]
            out[key] = float(np.linalg.norm(b - A @ xc) / np.linalg.norm(b))
    return out


def ring_profile(cycle, dev, ring) -> dict | None:
    """Rank 0's profile of ``cycle`` (``profile_cycles``); every other rank
    runs the same cycles unprofiled, so that their collectives meet."""
    if ring.axis_index == 0:
        return profile_cycles(cycle)
    for _ in range(N_PROFILED):
        cycle()
    sync(dev)
    return None


def sharded_rank(ring, dev, rows: list, sizes: dict, profile: bool) -> dict:
    """One rank of the sharded rows (a spawned process under --ranks, or
    this one): each row's body in turn; the records by row."""
    bodies = {"sdist256": _sdist_body, "adist96": _adist_body}
    out = {}
    for name in rows:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = bodies[name](ring, dev, profile, **sizes[name])
    return out


@contextlib.contextmanager
def one_rank_group(dev):
    """A process group of this process alone (NCCL on a card, gloo on the
    CPU), for the sharded rows without --ranks."""
    import torch.distributed as dist

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if dev.type == "cuda":
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1, device_id=dev)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_sharded(dev, rows: list, sizes: dict, ranks: int, profile: bool) -> dict:
    """The sharded rows on ``ranks`` ranks: in this process for one rank,
    else one spawned process a rank (NCCL: one card a rank; on the CPU,
    gloo); rank 0's records, each with every rank's times."""
    from raptor_tpu_torch.parallel import Ring, spawn

    backend = "nccl" if dev.type == "cuda" else "gloo"
    if ranks == 1:
        with one_rank_group(dev):
            per_rank = [sharded_rank(Ring(), dev, rows, sizes, profile)]
    else:
        per_rank = spawn(sharded_rank, ranks, backend,
                         "cuda" if dev.type == "cuda" else "cpu",
                         rows, sizes, profile, timeout=1800.0)
    out = {}
    for name in rows:
        rec = dict(per_rank[0][name])
        rec.update(row=name, n=sizes[name]["n"], ranks=ranks, backend=backend,
                   per_rank={k: [r[name][k] for r in per_rank]
                             for k in ("setup_s", "solve_s", "vcycle_ms")})
        out[name] = rec
    return out


def check_sharded(row: dict) -> dict:
    """The sharded solves' limits (PERF.md section 2): certified <= 1e-6,
    true fp64 <= 1e-5, iterations within 1 of the single-device solve on
    the same plan; TAPS within 1 of the flat solve."""
    check = Checks(row)
    check.at_most("certified relres", row["certified"], SHARD_TOL)
    check.at_most("true relres", row["relres" if "relres" in row
                                     else "true_relres"], SHARD_MAX_TRUE)
    check.at_most("iterations against the single-device solve",
                  abs(row["iters"] - row["single_device_iters"]), 1)
    check.equal("iterations, cold and warm", row["iters_cold"], row["iters"])
    if "taps_iters" in row:
        check.at_most("TAPS true relres", row["taps_true_relres"], SHARD_MAX_TRUE)
        check.at_most("TAPS iterations against flat",
                      abs(row["taps_iters"] - row["iters"]), 1)
    if "sizes" in row and row["n"] in ALG_SIZES:
        check.equal("level sizes", row["sizes"], ALG_SIZES[row["n"]])
    return check.close()


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

ROW_FUNCS = {"kernels": row_kernels, "structured128": row_structured,
             "structured256": row_structured, "alg48": row_algebraic,
             "alg96": row_algebraic, "alg128": row_alg128,
             "devsetup": row_devsetup, "configs": row_configs}


def compact(rows: dict, card: dict, failed: list, detail_file=None) -> dict:
    """The last line: the reference bench's compact headline
    (bench.py:774-815) over the rows that ran, with the card beside it."""
    def pick(name, keys):
        r = rows.get(name)
        if r is None:
            return "skip"
        if "error" in r:
            return "ERR"
        return {k: r.get(k) for k in keys}

    def alg(name):
        r = pick(name, ("setup_warm_s", "vcycle_fp32_ms", "vcycle_bf16_ms"))
        if isinstance(r, dict):
            r.update(solve_dev_ms=rows[name]["banded_solve_warm_device_s"] * 1e3,
                     iters=rows[name]["iterations"])
        return r

    s = rows.get("structured128", {})
    c256 = rows.get("structured256", {})
    detail = {
        "problem": s.get("problem"),
        "vcycle_ms": s.get("vcycle_s", math.nan) * 1e3,
        "fp32_vcycle_ms": s.get("vcycle_fp32_s", math.nan) * 1e3,
        "setup_s": s.get("setup_s"), "setup_cold_s": s.get("setup_cold_s"),
        "solve_s": s.get("solve_s"), "iters": s.get("iters"),
        "relres": s.get("relres"),
        "cpu_mdof_s": s.get("cpu_core_dof_per_s", math.nan) / 1e6,
        "kcheck": ({k: v["pass"] for k, v in rows["kernels"]["kernels"].items()}
                   if "kernels" in rows.get("kernels", {}) else
                   pick("kernels", ())),
        "c256": (pick("structured256", ()) if "dof_per_s" not in c256 else {
            "vcycle_ms": c256["vcycle_s"] * 1e3,
            "vcycle_fp32_ms": c256["vcycle_fp32_s"] * 1e3,
            "dof_per_s": c256["dof_per_s"], "solve_to_tol_s": c256["solve_s"],
            "pcg_iterations": c256["iters"], "final_relres": c256["relres"],
            "per_dof_vs_headline": ((c256["vcycle_s"] / c256["n"])
                                    / (s["vcycle_s"] / s["n"])
                                    if "vcycle_s" in s else None)}),
        "alg128": pick("alg128", ("vcycle_ms", "setup_warm_s", "setup_cold_s",
                                  "solve_warm_s", "iterations")),
        "dev_setup": pick("devsetup", ("n", "setup_warm_s", "setup_rows_per_s",
                                       "iterations_dev", "iterations_host")),
        "alg48": alg("alg48"), "alg96": alg("alg96"),
        "cfg": ({k: [v["n"], v["iterations"], v["true_relres"]]
                 for k, v in rows["configs"]["configs"].items()}
                if "configs" in rows.get("configs", {})
                else pick("configs", ())),
        "sdist": pick("sdist256", ("ranks", "vcycle_ms", "setup_s", "solve_s",
                                   "iters")),
        "adist": pick("adist96", ("ranks", "vcycle_ms", "solve_s", "iters",
                                  "taps_iters")),
        "detail_file": detail_file,
    }
    dofs = s.get("dof_per_s")
    return {"metric": "vcycle_dof_per_s_per_card", "value": dofs,
            "unit": "DOF/s", "vs_baseline": s.get("vs_baseline"),
            "card": card, "ok": not failed, "failed": failed,
            "detail": _sig(detail)}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    ap.add_argument("--rows", default=",".join(ROWS),
                    help=f"comma-separated rows, from {', '.join(ROWS)}")
    ap.add_argument("--ranks", type=int, default=1,
                    help="ranks of the sharded rows: one NCCL rank a card on "
                         "cuda (gloo ranks on the CPU); 1 runs them in this "
                         "process")
    ap.add_argument("--small", action="store_true",
                    help="every row at its CI size (<= 20^3, <= 64^2)")
    ap.add_argument("--profile", action="store_true",
                    help="add launches and the device-busy share of 10 "
                         "profiled cycles to every cycle row (cuda only)")
    ap.add_argument("--detail", default=None,
                    help="write every row's record to this JSON file")
    args = ap.parse_args(argv)
    args.rows = [r for r in args.rows.split(",") if r]
    unknown = sorted(set(args.rows) - set(ROWS))
    if unknown:
        ap.error(f"unknown rows {unknown}; rows are {', '.join(ROWS)}")
    if args.ranks < 1:
        ap.error("--ranks takes a positive count")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            log(f"--device {args.device}: no CUDA device is available "
                "(torch.cuda.is_available() is false); pass --device cpu to "
                "run on the CPU")
            return 2
        dev = torch.device("cuda", dev.index or 0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        log(f"--device {args.device}: cuda or cpu")
        return 2
    if args.profile and dev.type != "cuda":
        log("--profile measures the card's busy share: it needs --device cuda")
        return 2
    card = card_info(dev)
    log(f"card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    sizes = SMALL if args.small else FULL
    rows, failed = {}, []
    if dev.type == "cuda":
        from raptor_tpu_torch.ops.cuda.build import build, load_library

        path, build_s = build()
        load_library()
        log(f"[build] {path.name}: {build_s:.2f} s")

    def emit(name, rec):
        rec = {"row": name, **{k: v for k, v in rec.items() if k != "row"},
               "card": card}
        rows[name] = rec
        print(json.dumps(_finite(rec), default=_json), flush=True)

    t_start = time.perf_counter()
    plain = [r for r in args.rows if r not in SHARDED_ROWS]
    sharded = [r for r in args.rows if r in SHARDED_ROWS]
    for name in plain + (["sharded"] if sharded else []):
        t0 = time.perf_counter()
        try:
            if name == "sharded":
                recs = run_sharded(dev, sharded, sizes, args.ranks, args.profile)
                for key in sharded:
                    try:
                        emit(key, check_sharded(recs[key]))
                    except RowFailed as e:
                        failed.append(key)
                        emit(key, {**e.row, "error": str(e)})
                continue
            rec = ROW_FUNCS[name](dev, profile=args.profile, **sizes[name])
            rec["row_s"] = time.perf_counter() - t0
            emit(name, rec)
        except RowFailed as e:
            failed.append(name)
            emit(name, {**e.row, "error": str(e),
                        "row_s": time.perf_counter() - t0})
        except Exception as e:  # a row's fault: its error line, then go on
            import traceback

            traceback.print_exc()
            for key in (sharded if name == "sharded" else [name]):
                failed.append(key)
                emit(key, {"error": f"{type(e).__name__}: {e}"})
        if name == "kernels" and failed:
            log("kernel check FAILED: no row runs on kernels that disagree "
                "with their plain versions")
            break
    total_s = time.perf_counter() - t_start
    if args.detail:
        Path(args.detail).parent.mkdir(parents=True, exist_ok=True)
        Path(args.detail).write_text(json.dumps(_finite(
            {"card": card, "total_s": total_s, "rows": rows}), indent=1,
            default=_json))
    out = compact(rows, card, failed, args.detail)
    out["total_s"] = total_s
    print(json.dumps(_finite(out), default=_json), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
