"""The closed loop that every cell runs, and the phases after it that give
the per-layer metrics: one step in flight, the next drawn only when the
last has finished."""

from __future__ import annotations

import time

import torch

from amgbench import trace as tr
from amgbench.trace import sync
from amgbench.generator import WARM, Reservoir


def warm(engine, dev) -> None:
    """One step outside the window's stream: every shape of the window is
    run (and, on a card, every kernel loaded) before it opens."""
    engine.step(WARM)
    sync(dev)


def window(engine, dev, seconds: float, samples: int, seed: int) -> dict:
    """Steps 0, 1, ... until ``seconds`` have passed; the window's length
    runs from its start to the end of its last step.  Returns the per-step records, the window's seconds and a sample of
    the answers drawn from the seed."""
    res = Reservoir(samples, seed)
    steps = []
    sync(dev)
    t0 = time.perf_counter()
    k, go = 0, True
    while go:
        ts = time.perf_counter()
        out = engine.step(k)
        now = time.perf_counter()
        res.offer(out.pop("sample"))
        steps.append({**out, "k": k, "seconds": now - ts})
        k += 1
        go = now - t0 < seconds
    return {"steps": steps, "window_s": time.perf_counter() - t0,
            "t0": t0, "samples": res.items}


def traced_steps(engine, dev, first: int, count: int) -> tr.Trace:
    """``count`` more steps of the stream, under the profiler."""
    def run():
        for k in range(first, first + count):
            engine.step(k)

    return tr.profile(run, dev, calls=count)


def vcycle_time(cycle, dev, cycles: int) -> float:
    """ms a V-cycle: ``cycles`` cycles after one warm one, the host span
    ending in a synchronize, over the count."""
    y = cycle()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(cycles):
        y = cycle()
    sync(dev)
    ms = (time.perf_counter() - t0) * 1e3 / cycles
    if not bool(torch.isfinite(y).all()):
        raise RuntimeError("V-cycle output not finite")
    return ms
