"""Run one cell of the benchmark once and print its result as the last
line of standard output:

    python -m amgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (process start to the window's start: interpreter, torch, the
kernel library, the operator, the hierarchy, one warm step) is
``setup_s``.  The window runs the cell's closed loop for ``--seconds``;
its rate metric is the window's seconds over the steps completed.  With
``--trace 1`` the per-layer metrics are read after the window instead
(traced steps, timed and profiled V-cycles).  Then the
device's peak memory is read, the program's state freed, and a sample of
the window's answers, drawn from the seed, is judged by the plain fp64
reference; every number compared is printed beside its limit.  Without a
CUDA card (or with fewer than the cell asks for) it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "raptor_tpu")


def process_start_epoch() -> float:
    """This process's start on the epoch clock (from /proc, 10 ms
    resolution); the time of the call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_PROC = process_start_epoch()

import torch  # noqa: E402

from amgbench import counts, faults as fault_mod, loop, spec, trace as tr  # noqa: E402
from amgbench.generator import Stream  # noqa: E402


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_kind(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def prepare_device(dev) -> float:
    """TF32 off; on a card, build (first run of a checkout) and load the
    program's kernel library.  Returns the build's seconds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type != "cuda":
        return 0.0
    from raptor_tpu_torch.ops.cuda.build import build, load_library

    _, build_s = build()
    load_library()
    return build_s


def measure(engine, dev, cell: dict, seed: int, seconds: float,
            trace: bool) -> dict:
    """Set-up, warm step, window, the traced phases, peak memory, then the
    reference's verdict on the sampled answers."""
    engine.setup()
    loop.warm(engine, dev)
    window_epoch = time.time()
    w = loop.window(engine, dev, seconds, int(cell["samples"]), seed)
    run = {"steps": w["steps"], "window_s": w["window_s"], "trace": None,
           "vcycle": None, "counts": None,
           "peak_bytes_per_s": counts.peak_bytes_per_s(card_kind(dev))}
    busy = None
    if trace:
        t = loop.traced_steps(engine, dev, len(w["steps"]), int(cell["trace_steps"]))
        busy = (t.busy_s, t.wall_s)
        run["trace"] = {"busy_s": t.busy_s, "window_s": t.wall_s,
                        "device_ops": t.device_ops(), "idle_gaps": t.idle_gaps()}
        if cell.get("vcycles"):
            cyc = engine.vcycle()
            ms = loop.vcycle_time(cyc, dev, int(cell["vcycles"]))
            n_prof = int(cell["vcycles_profiled"])

            def cycles():
                for _ in range(n_prof):
                    cyc()

            p = tr.profile(cycles, dev, calls=n_prof)
            run["vcycle"] = {"ms": ms, "busy_ms": p.busy_s * 1e3 / n_prof,
                             "events": p.events_per_call}
        run["counts"] = engine.counts()
    mem = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    samples = w["samples"]
    engine.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    verdicts = [(s["k"], engine.judge(s)) for s in samples]
    return {"run": run, "window_epoch": window_epoch, "memory_peak_bytes": mem,
            "busy": busy, "verdicts": verdicts}


def result(cell: dict, config: dict, m: dict, seconds_setup: float, dev,
           trace: bool) -> dict:
    """The run's result line; ``compared`` comes last."""
    run = m["run"]
    steps = run["steps"]
    limit = float(config["limit"]["relres"])
    failed = sum(not s["ok"] for s in steps)
    # every step's own certified residual met tol, and the reference
    # agrees on the sampled answers
    compared = {"uncertified_steps": {"value": failed, "limit": 0}}
    for k, r in m["verdicts"]:
        compared[f"relres.step{k}"] = {"value": r, "limit": limit}
    correct = len(compared) > 1 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in compared.values())
    if trace:
        metrics = {}
        for name in cell["per_layer"]:
            mod = spec.load_metric(name)
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
    else:
        metrics = {"setup_s": {"value": seconds_setup, "unit": "s"},
                   cell["rate_metric"]: {"value": run["window_s"] / len(steps),
                                         "unit": "s"}}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": card_kind(dev), "count": 1,
              "memory_peak_bytes": int(m["memory_peak_bytes"])}
    out = {"correct": correct, "attempted": len(steps),
           "failed": failed, "metrics": metrics,
           "device": device}
    if trace and run["trace"] is not None:
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    out["steps"] = {"count": len(steps),
                    "seconds": [s["seconds"] for s in steps],
                    "iters": [s["iters"] for s in steps]}
    out["compared"] = compared
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             faults=()) -> dict:
    """One run of a cell; ``device='cpu'`` and ``overrides`` (the
    problem's size) serve the tests, ``faults`` plants a fault."""
    cell, config, mix = spec.resolve(workload, overrides)
    fault_mod.check(faults)
    engine_mod = spec.load_engine(config["engine"])
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    prepare_device(dev)
    engine = engine_mod.Engine(config, Stream(mix, seed), dev, tuple(faults))
    m = measure(engine, dev, cell, seed, seconds, trace)
    return result(cell, config, m, m["window_epoch"] - T_PROC, dev, trace)


def _finite(x):
    """JSON-safe: a NaN or infinity becomes its name as a string."""
    if isinstance(x, float) and not math.isfinite(x):
        return repr(x)
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device (torch.cuda.is_available() is false): the "
            "benchmark measures the card and never runs on the CPU")
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        log(f"cell {args.workload} needs {cell['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded in the measuring process: {bad}")
        return 3
    for name, c in out["compared"].items():
        log(f"{name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(_finite(out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
