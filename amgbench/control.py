"""The readings that the correctness limits are set from, at a cell's own
size: for each seed, the program's answers of a few steps of the cell's
stream (the lower reading) and the control's answers of the same steps
(the upper reading), each judged by the cell's fp64 reference.  The
control is the configuration's ``control``: the program's path one
precision below the one the configuration states.  One set-up serves
every seed; the benchmark's own runs never run this.

    python -m amgbench.control --workload structured-solve \\
        --seeds 11,12,13 --steps 2 --out build/control.jsonl
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from amgbench import spec
from amgbench.generator import Stream
from amgbench.run import card_kind, prepare_device


def readings(engine, mix, seeds, steps: int) -> list:
    """[{seed, step, program, control}] relative residuals."""
    out = []
    for seed in seeds:
        engine.stream = Stream(mix, seed)
        for k in range(steps):
            prog = engine.judge(engine.step(k)["sample"])
            ctrl = engine.judge(engine.control(k))
            out.append({"seed": seed, "step": k, "program": prog,
                        "control": ctrl})
    return out


def run(workload: str, seeds, steps: int, device: str = "cuda",
        overrides: dict | None = None) -> list:
    cell, config, mix = spec.resolve(workload, overrides)
    mod = spec.load_engine(config["engine"])
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    prepare_device(dev)
    engine = mod.Engine(config, Stream(mix, seeds[0]), dev, ())
    engine.setup()
    return readings(engine, mix, seeds, steps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = run(args.workload, seeds, args.steps)
    kind = card_kind(torch.device("cuda", 0))
    prog = [r["program"] for r in rows]
    ctrl = [r["control"] for r in rows]
    summary = {"workload": args.workload, "kind": kind, "seeds": seeds,
               "program_max": max(prog), "control_min": min(ctrl),
               "limit": spec.resolve(args.workload)[1]["limit"]["relres"]}
    for r in rows:
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps({"workload": args.workload, **r}) + "\n")
            f.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
