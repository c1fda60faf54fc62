#!/usr/bin/env python3
"""The two forms of the run sum in ``ops/sparse_ops.py::_merge_sorted_rows``
timed against each other on one NVIDIA GPU, and the launch cost that
``_merge_by_passes`` chooses between them by, fitted from those times.

    python3 scripts/bench_merge.py [--reps N] [--out FILE]

``_sum_runs_by_slots`` makes W launches of a row each;
``_sum_runs_by_passes`` makes 8 launches over (W, n) set-up arrays and 6 over
(k_out + 1, n) a pass, max_run passes (``_merge_costs`` counts both).  Each
is timed as the setup calls it, eagerly: wall time of one call between two
synchronizations (so the host's launch cost counts), the median of
``--reps`` calls after one warm-up call.

The shapes are (W, k_out, max_run) triples that the device routes of the
SA, PMIS + ext+i and aggressive setups hand the merge (SpGEMM expands, the
ext+i candidates, ell_add, filters), each at row counts n from 2^8 to 2^20
within the expand's element budget (W * n <= 2^26).  The model

    time = L * launches + E * elements

is fitted to every form and shape at once (least squares on the relative
error), and the script prints L, E, their ratio L / E in elements (the
constant ``_MERGE_LAUNCH_ELEMS``), and how often the choice under the
committed constant, under the fitted one and under the former rule
(passes when 3 * max_run < W) takes the faster form, with what the wrong
choices cost.  One JSON object with every point goes to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from raptor_tpu_torch.ops import sparse_ops as so

# (W, k_out, max_run) as the setups give them (their run bounds)
TRIPLES = [(27, 27, 1), (30, 30, 2), (60, 60, 2), (243, 27, 9), (486, 54, 81),
           (729, 111, 27), (1656, 24, 276), (1656, 46, 36), (2116, 37, 46),
           (4860, 108, 81), (6768, 24, 282), (8280, 24, 276),
           (67068, 276, 621), (28, 16, 7), (56, 56, 8), (96, 24, 24),
           (128, 32, 8), (156, 156, 13), (256, 16, 64), (288, 40, 72),
           (1024, 200, 64), (1152, 80, 48), (2880, 224, 72)]
ROWS = [1 << 8, 1 << 11, 1 << 14, 1 << 17, 1 << 20]
BUDGET = 1 << 26


def inputs(W: int, n: int, k_out: int, max_run: int, dev):
    """Run positions as _merge_sorted_rows hands them to either form:
    runs of max_run slots (each row's first one shorter, by a random
    offset), slots past k_out runs in the dump slot k_out; their values,
    run starts and kept slots."""
    rng = np.random.default_rng(W + n + k_out)
    offset = rng.integers(0, max_run, size=n)
    pos = np.minimum((np.arange(W)[:, None] + offset[None, :]) // max_run, k_out)
    pos = torch.from_numpy(pos).to(dev)
    vals = torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32)).to(dev)
    first = torch.ones_like(pos, dtype=torch.bool)
    first[1:] = pos[1:] != pos[:-1]
    keep = pos < k_out
    return vals, pos, first, keep


def wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def choice_report(points: list, passes_win) -> dict:
    """How often ``passes_win(point)`` picks the faster form, and the
    time lost where it does not (ms, and the chosen over the best)."""
    right, lost, worst = 0, 0.0, 1.0
    for p in points:
        chosen = p["passes_ms"] if passes_win(p) else p["slots_ms"]
        best = min(p["passes_ms"], p["slots_ms"])
        right += chosen == best
        lost += chosen - best
        worst = max(worst, chosen / best)
    return {"right": right, "of": len(points), "lost_ms": lost,
            "worst_ratio": worst}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    points = []
    for W, k_out, max_run in TRIPLES:
        for n in ROWS:
            if W * n > BUDGET or (k_out + 1) * n > BUDGET:
                continue
            vals, pos, first, keep = inputs(W, n, k_out, max_run, dev)
            slots = lambda: so._sum_runs_by_slots(vals, pos, k_out)  # noqa: E731
            passes = lambda: so._sum_runs_by_passes(  # noqa: E731
                vals, pos, first, keep, k_out, max_run)
            if not torch.equal(slots()[:k_out], passes()[:k_out]):
                raise AssertionError(f"forms differ at {(W, n, k_out, max_run)}")
            p = {"W": W, "n": n, "k_out": k_out, "max_run": max_run,
                 "slots_ms": wall_ms(slots, args.reps),
                 "passes_ms": wall_ms(passes, args.reps)}
            points.append(p)
            print(f"W {W:6d} n {n:8d} k_out {k_out:4d} max_run {max_run:4d}: "
                  f"slots {p['slots_ms']:9.3f} ms, passes {p['passes_ms']:9.3f} ms",
                  flush=True)
            del vals, pos, first, keep
    # time = L * launches + E * elements, relative least squares
    rows, rhs = [], []
    for p in points:
        c = so._merge_costs(p["W"], p["n"], p["k_out"], p["max_run"])
        for form in ("slots", "passes"):
            t = p[f"{form}_ms"]
            rows.append([c[form][0] / t, c[form][1] / t])
            rhs.append(1.0)
    (L, E), *_ = np.linalg.lstsq(np.array(rows), np.array(rhs), rcond=None)
    fitted = L / E
    print(f"fit: {L * 1e3:.3f} us a launch, {E * 1e9:.4f} ps an element; "
          f"a launch costs {fitted:.4g} elements")

    def rule(launch_elems):
        def win(p):
            c = so._merge_costs(p["W"], p["n"], p["k_out"], p["max_run"])
            return (c["passes"][0] * launch_elems + c["passes"][1]
                    < c["slots"][0] * launch_elems + c["slots"][1])
        return win

    committed = so._MERGE_LAUNCH_ELEMS
    reports = {"committed": choice_report(points, rule(committed)),
               "fitted": choice_report(points, rule(fitted)),
               "former": choice_report(points, lambda p: 3 * p["max_run"] < p["W"])}
    for name, r in reports.items():
        print(f"choice, {name} rule: the faster form at {r['right']} of {r['of']} "
              f"points; {r['lost_ms']:.3f} ms lost over all, worst "
              f"{r['worst_ratio']:.2f}x the faster form")
    print(f"committed _MERGE_LAUNCH_ELEMS {committed}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "launch_us": L * 1e3, "element_ps": E * 1e9,
                       "launch_elems": fitted, "committed": committed,
                       "reports": reports, "points": points}, f)


if __name__ == "__main__":
    main()
