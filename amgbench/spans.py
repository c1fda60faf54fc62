"""Where the program's own spans put the device's time: one cell run with
the program's span recording on (``raptor_tpu_torch/utils/profiling.py``),
one JSON line on standard output.

    python -m amgbench.spans --workload <cell> --seed <n> [--reads <steps>]

A run of ``amgbench.run`` keeps recording off; this runs the same engine
and the same stream with it on, in phases:

1. the set-up (``engine.setup()``) under ``recording()``, no profiler:
   host-clock spans, the program's fenced roots (``setup.structured``,
   ``setup.cast``, ``setup.algebraic``) summed as ``hierarchy_setup_s``;
2. the warm step, then ``--reads`` steps with recording off: the host's
   reads of device values a step (``krylov.host_reads``), the iterations
   and each step's build seconds;
3. the cell's ``trace_steps`` steps under the profiler, recording off (the
   unrecorded traced phase), then as many steps again under the profiler
   and ``recording()`` (the span phase), and, in the solve cells, the
   cell's ``vcycles_profiled`` V-cycles under both.

Each device event is put on the program spans that enclose its launch: the
runtime call with its correlation id, or where the profiler has none, the
host event its launch is linked to (``launch_chains``).  Each idle gap
between device events goes to the spans the host was in at its middle
(``gap_chains``).  The result names the seven per-layer quantities the
spans feed (``METRICS``), the consistency checks between them, and the
``spans`` table of the span phase.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from amgbench import loop, spec
from amgbench.generator import Stream
from amgbench.run import T_PROC, _finite, card_kind, prepare_device
from amgbench.trace import sync, union_seconds

TOP = 20
NO_SPAN = "(no span)"
LAUNCH_PREFIX = "cu"  # CUDA API calls: cudaLaunchKernel, cuLaunchKernel
METRICS = ("host_reads.solve", "smooth_ms.solve", "krylov_ms.solve",
           "refine_ms.solve", "rap_s.rebuild", "setup_idle_s.rebuild",
           "hierarchy_setup_s")


def base(name: str) -> str:
    """A span's name without its ``[index]``."""
    return name.split("[", 1)[0]


# ---------------------------------------------------------------------------
# attribution (pure functions of event lists; times in ns)
# ---------------------------------------------------------------------------

def enclosing(points, spans) -> list:
    """For each time in ``points``, the names of the spans (name, start,
    end) that hold it, outermost first.  Spans nest (one host thread)."""
    order = sorted(spans, key=lambda s: (s[1], -s[2]))
    idx = sorted(range(len(points)), key=lambda i: points[i])
    out = [()] * len(points)
    stack, j = [], 0
    for i in idx:
        t = points[i]
        while j < len(order) and order[j][1] <= t:
            s = order[j]
            while stack and stack[-1][2] < s[1]:
                stack.pop()
            stack.append(s)
            j += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out[i] = tuple(s[0] for s in stack)
    return out


def launch_chains(device, launches, spans) -> list:
    """[(seconds, chain)] for each device event (corr, start, end): the
    spans that enclose the host time of its launch, ``launches[corr]``;
    chain None where the launch is unknown."""
    known = [e for e in device if e[0] in launches]
    chains = enclosing([launches[e[0]] for e in known], spans)
    out = [((e[2] - e[1]) * 1e-9, c) for e, c in zip(known, chains)]
    out += [((e[2] - e[1]) * 1e-9, None) for e in device
            if e[0] not in launches]
    return out


def idle_gaps(device) -> list:
    """(start, end) of each gap between the device events' intervals."""
    iv = sorted((a, b) for _, a, b in device)
    gaps, end = [], iv[0][1] if iv else 0
    for a, b in iv[1:]:
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    return gaps


def gap_chains(device, spans) -> list:
    """[(seconds, chain)] for each idle gap: the spans the host was in at
    the gap's middle."""
    gaps = idle_gaps(device)
    chains = enclosing([(a + b) / 2 for a, b in gaps], spans)
    return [((b - a) * 1e-9, c) for (a, b), c in zip(gaps, chains)]


def seconds_in(chains, inside, outside=()) -> float:
    """Seconds of the entries whose chain holds a span named (without its
    index) in ``inside`` and none in ``outside``; a name ending in '.'
    matches every name it starts."""
    def hit(chain, names):
        return any(base(c) in names or any(
            n.endswith(".") and c.startswith(n) for n in names) for c in chain)

    return sum(s for s, c in chains
               if c and hit(c, inside) and not hit(c, outside))


def span_table(launched, gapped, host, top: int = TOP) -> list:
    """The spans with most device time launched inside them: name, calls
    and host seconds (from ``host``: (name, start, end)), inclusive device
    seconds (counted once an event however deep), self device seconds
    (innermost span only) and idle seconds (gaps whose middle the span
    held innermost)."""
    rows: dict = {}

    def row(name):
        return rows.setdefault(name, {"name": name, "calls": 0, "host_s": 0.0,
                                      "device_s": 0.0, "self_s": 0.0,
                                      "idle_s": 0.0})

    for name, a, b in host:
        r = row(name)
        r["calls"] += 1
        r["host_s"] += (b - a) * 1e-9
    for s, chain in launched:
        if chain:
            for name in set(chain):
                row(name)["device_s"] += s
            row(chain[-1])["self_s"] += s
    for s, chain in gapped:
        row(chain[-1] if chain else NO_SPAN)["idle_s"] += s
    return sorted(rows.values(),
                  key=lambda r: (-r["device_s"], -r["host_s"]))[:top]


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

class Profiled:
    """One profiled block: wall seconds, device events (corr, start, end),
    launch times by correlation id, program spans (name, start, end)."""

    def __init__(self, wall_s, device, launches, spans, unlinked, names):
        self.wall_s, self.device, self.launches = wall_s, device, launches
        self.spans, self.unlinked, self.names = spans, unlinked, names

    @property
    def busy_s(self) -> float:
        return union_seconds((a, b) for _, a, b in self.device) * 1e-9

    def late(self) -> dict:
        """{name: device seconds} of the events that start before the host
        time of their launch (a correlation read wrong), most first."""
        out: dict = {}
        for c, a, b in self.device:
            if self.launches.get(c, a) > a:
                out[self.names[c]] = out.get(self.names[c], 0.0) + (b - a) * 1e-9
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:5])

    def launched(self) -> list:
        return launch_chains(self.device, self.launches, self.spans)

    def gapped(self) -> list:
        return gap_chains(self.device, self.spans)


def profile(fn, dev) -> Profiled:
    """Run ``fn`` under torch.profiler; the wall ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    from raptor_tpu_torch.utils.profiling import PREFIX

    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    device, launches, spans, host_start, names = [], {}, [], {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        if name.startswith(PREFIX):
            # a span's host range; on the device's timeline, its copy
            if e.device_type() != cuda:
                spans.append((name[len(PREFIX):], a, b))
                host_start[e.correlation_id()] = a
        elif e.device_type() == cuda:
            device.append((e.correlation_id(), a, b, e.linked_correlation_id()))
            names[e.correlation_id()] = name[:64]
        elif name.startswith(LAUNCH_PREFIX):
            launches[e.correlation_id()] = a
        else:
            host_start[e.correlation_id()] = a
    # where the runtime call is missing, the host op the launch is linked to
    unlinked = 0
    for corr, _, _, linked in device:
        if corr not in launches:
            if linked in host_start:
                launches[corr] = host_start[linked]
            else:
                unlinked += 1
    return Profiled(wall, [d[:3] for d in device], launches, spans, unlinked,
                    names)


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------

def measure(engine, dev, cell: dict, reads: int) -> dict:
    from raptor_tpu_torch.solve import krylov
    from raptor_tpu_torch.utils import profiling

    with profiling.recording() as rec:
        engine.setup()
    roots = [s for s in rec.roots() if s.fenced]
    loop.warm(engine, dev)
    setup_s = time.time() - T_PROC
    krylov.host_reads.clear()
    steps = [engine.step(k) for k in range(reads)]
    sync(dev)
    reads_by_site = dict(krylov.host_reads)
    n = int(cell["trace_steps"])

    def run_steps(first):
        out = []

        def fn():
            for k in range(first, first + n):
                out.append(engine.step(k))
        return fn, out

    fn, off_steps = run_steps(reads)
    off = profile(fn, dev)
    fn, on_steps = run_steps(reads + n)
    with profiling.recording():
        on = profile(fn, dev)
    cyc_on = cyc_off = None
    n_cyc = int(cell.get("vcycles_profiled") or 0)
    if n_cyc:
        cyc = engine.vcycle()

        def cycles():
            for _ in range(n_cyc):
                cyc()

        cycles()
        cyc_off = profile(cycles, dev)
        with profiling.recording():
            cyc_on = profile(cycles, dev)
    for s in steps + off_steps + on_steps:
        s.pop("sample", None)
    engine.free()
    gc.collect()
    return {"rec": rec, "roots": roots, "setup_s": setup_s, "steps": steps,
            "reads": reads_by_site, "off": off, "on": on,
            "off_steps": off_steps, "on_steps": on_steps, "cyc_off": cyc_off,
            "cyc_on": cyc_on, "n_cyc": n_cyc}


def metrics(m: dict) -> dict:
    """The seven quantities; None where the run holds nothing to read."""
    steps, on, cyc = m["steps"], m["on"], m["cyc_on"]
    n_on = len(m["on_steps"])
    solve_cell = m["n_cyc"] > 0
    launched = on.launched() if on.device else None
    out = dict.fromkeys(METRICS)
    out["hierarchy_setup_s"] = sum(s.seconds for s in m["roots"]) or None
    if solve_cell:
        out["host_reads.solve"] = (sum(m["reads"].values()) / len(steps)
                                   if steps else None)
        if launched:
            out["krylov_ms.solve"] = 1e3 * seconds_in(
                launched, {"pcg"}, {"vcycle"}) / n_on
            out["refine_ms.solve"] = 1e3 * seconds_in(
                launched, {"solve"}, {"pcg"}) / n_on
        if cyc is not None and cyc.device:
            out["smooth_ms.solve"] = 1e3 * seconds_in(
                cyc.launched(), {"vcycle.smooth"}) / m["n_cyc"]
    elif launched:
        out["rap_s.rebuild"] = seconds_in(launched, {"setup.rap"}) / n_on
        out["setup_idle_s.rebuild"] = seconds_in(on.gapped(),
                                                 {"setup."}) / n_on
    return out


def checks(m: dict, vals: dict) -> dict:
    """The consistency checks between the spans and the harness's own
    readings, each with the numbers it compares."""
    on, cyc = m["on"], m["cyc_on"]
    out = {}
    if on.device:
        launched = on.launched()
        total = sum(s for s, _ in launched)
        inside = sum(s for s, c in launched if c)
        out["spanned_share"] = {"value": inside / total, "limit": 0.9,
                                "ok": inside / total >= 0.9,
                                "unlinked_events": on.unlinked,
                                "launched_after_start": on.late()}
    if cyc is not None and cyc.device and vals["smooth_ms.solve"] is not None:
        busy = cyc.busy_s * 1e3 / m["n_cyc"]
        out["smooth_within_vcycle"] = {
            "smooth_ms": vals["smooth_ms.solve"], "vcycle_busy_ms": busy,
            "ok": vals["smooth_ms.solve"] <= busy}
        if vals["krylov_ms.solve"] is not None:
            n = len(m["on_steps"])
            iters = sum(s["iters"] for s in m["on_steps"]) / n
            parts = (vals["krylov_ms.solve"] + vals["refine_ms.solve"]
                     + iters * busy)
            solve_busy = on.busy_s * 1e3 / n
            out["solve_parts"] = {
                "krylov_ms": vals["krylov_ms.solve"],
                "refine_ms": vals["refine_ms.solve"], "iters": iters,
                "vcycle_busy_ms": busy, "sum_ms": parts,
                "solve_busy_ms": solve_busy,
                "ratio": parts / solve_busy,
                "ok": abs(parts / solve_busy - 1) <= 0.1}
    if m["n_cyc"]:
        # one read a PCG iteration, two a refinement round and one more
        iters = sum(s["iters"] for s in m["steps"])
        r = m["reads"]
        rounds = (r.get("refine", 0) - len(m["steps"])) / 2
        out["host_reads"] = {"by_site": r, "iters": iters, "rounds": rounds,
                             "ok": r.get("pcg", 0) == iters
                             and rounds == int(rounds) and rounds >= 1}
    if vals["hierarchy_setup_s"] is not None:
        out["setup_within_setup_s"] = {
            "hierarchy_setup_s": vals["hierarchy_setup_s"],
            "setup_s": m["setup_s"],
            "ok": vals["hierarchy_setup_s"] < m["setup_s"]}
    builds = [s["build_s"] for s in m["steps"] if s.get("build_s") is not None]
    if builds and vals["rap_s.rebuild"] is not None:
        b = sum(builds) / len(builds)
        out["rap_within_build"] = {"rap_s": vals["rap_s.rebuild"],
                                   "build_s": b,
                                   "ok": vals["rap_s.rebuild"] <= b}
    return out


def result(m: dict) -> dict:
    vals = metrics(m)
    on, off = m["on"], m["off"]
    it_on = sum(s["iters"] for s in m["on_steps"])
    it_off = sum(s["iters"] for s in m["off_steps"])
    out = {"metrics": vals, "checks": checks(m, vals),
           "setup_s": m["setup_s"],
           "cost": {"wall_off_s": off.wall_s, "wall_on_s": on.wall_s,
                    "iters_off": it_off, "iters_on": it_on,
                    "ratio": on.wall_s / off.wall_s,
                    "busy_off_s": off.busy_s, "busy_on_s": on.busy_s},
           "stages": sorted(
               ({"name": k, "calls": c, "host_s": t}
                for k, (c, t) in m["rec"].totals().items()),
               key=lambda r: -r["host_s"])[:TOP]}
    if m["cyc_on"] is not None:
        out["cost"]["vcycle_wall_off_s"] = m["cyc_off"].wall_s
        out["cost"]["vcycle_wall_on_s"] = m["cyc_on"].wall_s
    out["spans"] = span_table(on.launched(), on.gapped(), on.spans)
    if m["cyc_on"] is not None:
        c = m["cyc_on"]
        out["vcycle_spans"] = span_table(c.launched(), c.gapped(), c.spans)
    out["steps"] = {"iters": [s["iters"] for s in m["steps"]],
                    "build_s": [s.get("build_s") for s in m["steps"]]}
    return out


def run_cell(workload: str, seed: int, reads: int = 3, *,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    """One span run of a cell; ``device='cpu'`` and ``overrides`` serve
    the tests."""
    cell, config, mix = spec.resolve(workload, overrides)
    engine_mod = spec.load_engine(config["engine"])
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    prepare_device(dev)
    engine = engine_mod.Engine(config, Stream(mix, seed), dev)
    out = result(measure(engine, dev, cell, reads))
    out["workload"], out["seed"] = workload, seed
    out["device"] = card_kind(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--reads", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(_finite(run_cell(args.workload, args.seed, args.reads))),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
