"""Run the benchmark's command for one cell several times in turn, one
process a run, and summarise: each run's result line goes to ``--out``;
the summary gives, for each metric and each set of runs, the median and
the spread (the distance between the first and third quartiles as
``statistics.quantiles(values, n=4)`` gives them, over the median).

    python -m amgbench.repeat --workload structured-solve --seconds 50 \\
        --seeds 11,12,13,14,15,16 --sets 2 --out build/sets.jsonl
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    sets = []
    for s in range(args.sets):
        runs = []
        for seed in seeds:
            cmd = [sys.executable, "-m", "amgbench.run", "--workload",
                   args.workload, "--seed", str(seed), "--seconds",
                   str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True, timeout=1300)
            wall = time.perf_counter() - t0
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if p.returncode == 0 else None
            except (IndexError, json.JSONDecodeError):
                res = None
            rec = {"workload": args.workload, "set": s, "seed": seed,
                   "trace": args.trace, "rc": p.returncode, "wall_s": wall,
                   "result": res, "stderr_tail": p.stderr[-3000:]}
            runs.append(rec)
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
            brief = None if res is None else {
                "correct": res["correct"], "attempted": res["attempted"],
                **{k: v["value"] for k, v in res["metrics"].items()},
                "peak_gib": res["device"]["memory_peak_bytes"] / 2**30,
                "max_relres": max((c["value"] for n, c in res["compared"].items()
                                   if n.startswith("relres")),
                                  default=None)}
            print(f"[run] set {s} seed {seed} rc {p.returncode} wall "
                  f"{wall:.1f} s {json.dumps(brief)}", flush=True)
            if res is None:
                print(p.stderr[-3000:], flush=True)
        sets.append(runs)
    summary = {"workload": args.workload, "seconds": args.seconds, "sets": []}
    for runs in sets:
        ok = [r["result"] for r in runs if r["result"]]
        per = {}
        for name in (ok[0]["metrics"] if ok else {}):
            vals = [r["metrics"][name]["value"] for r in ok]
            per[name] = {"median": statistics.median(vals), "spread": spread(vals),
                         "values": vals}
        summary["sets"].append({"runs": len(runs), "ok": len(ok),
                                "correct": sum(r["correct"] for r in ok),
                                "metrics": per})
    print(json.dumps(summary), flush=True)
    with open(args.out, "a") as f:
        f.write(json.dumps({"summary": summary}) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
