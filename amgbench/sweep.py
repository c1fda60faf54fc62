"""The sizing sweep: each candidate size of a cell's configuration in a
process of its own, one set-up, a short window of solves, then traced
steps and V-cycles; one JSON line a candidate with set-up seconds, solve
seconds, iterations, the device's idle share, the peak memory and the
reference's verdict (or the fault that stopped it).

    python -m amgbench.sweep --cell structured-solve --sizes 512,384,256 \\
        --out build/sweep.jsonl
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from amgbench import spec
from amgbench.run import T_PROC, card_kind, measure, prepare_device


def one(cell_name: str, n: int, seed: int, seconds: float) -> dict:
    import torch

    from amgbench.generator import Stream

    cell, config, mix = spec.resolve(cell_name, {"n": n})
    engine_mod = spec.load_engine(config["engine"])
    dev = torch.device("cuda", 0)
    build_s = prepare_device(dev)
    engine = engine_mod.Engine(config, Stream(mix, seed), dev, ())
    m = measure(engine, dev, cell, seed, seconds, True)
    busy_mean = m["run"]["trace"]["busy_s"]
    run = m["run"]
    steps = run["steps"]
    t = run["trace"]
    out = {"cell": cell_name, "n": n, "kind": card_kind(torch.device("cuda", 0)),
           "build_s": build_s, "setup_s": m["window_epoch"] - T_PROC - build_s,
           "solve_s": run["window_s"] / len(steps),
           "steps": len(steps), "iters": [s["iters"] for s in steps],
           "build_step_s": [s["build_s"] for s in steps if s["build_s"]],
           "idle_share": 1.0 - busy_mean / t["window_s"],
           "peak_gib": m["memory_peak_bytes"] / 2**30,
           "relres": [r for _, r in m["verdicts"]],
           "limit": config["limit"]["relres"], "vcycle": run["vcycle"],
           "counts": run["counts"],
           "device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["pass"] = bool(out["relres"]) and all(r <= out["limit"] for r in out["relres"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True)
    ap.add_argument("--sizes", required=True)
    ap.add_argument("--seed", type=int, default=20260)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one is not None:
        print(json.dumps(one(args.cell, args.one, args.seed, args.seconds)),
              flush=True)
        return 0
    for n in [int(s) for s in args.sizes.split(",")]:
        t0 = time.perf_counter()
        cmd = [sys.executable, "-m", "amgbench.sweep", "--cell", args.cell,
               "--sizes", str(n), "--one", str(n), "--seed", str(args.seed),
               "--seconds", str(args.seconds)]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=args.timeout)
            lines = p.stdout.strip().splitlines()
            rec = (json.loads(lines[-1]) if p.returncode == 0 and lines else
                   {"cell": args.cell, "n": n, "pass": False,
                    "fault": f"exit {p.returncode}: {p.stderr[-1500:]}"})
        except subprocess.TimeoutExpired:
            rec = {"cell": args.cell, "n": n, "pass": False,
                   "fault": f"over {args.timeout} s"}
        rec["process_s"] = time.perf_counter() - t0
        line = json.dumps(rec)
        print(line, flush=True)
        print(f"[sweep] {args.cell} n={n}: pass={rec['pass']} "
              f"setup={rec.get('setup_s')} solve={rec.get('solve_s')} "
              f"idle={rec.get('idle_share')} peak={rec.get('peak_gib')} "
              f"{rec.get('fault', '')[:300]}", file=sys.stderr, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
