"""Tracing and profiling hooks.

Counterpart of ``raptor_tpu/utils/profiling.py``.  ``trace`` records a
``torch.profiler`` trace (CPU and, where there is a card, CUDA activity)
around a block and writes it to ``logdir`` as a Chrome trace (view it in
Perfetto or chrome://tracing); ``phase`` names a setup or solve phase in
that trace; ``timed`` wall-times a block with a device fence.  The cycle
itself carries no scopes: a scope costs host time on every call, and the
cycle is host-bound already.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

__all__ = ["trace", "phase", "timed"]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block and write ``logdir/trace_<pid>_<n>.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))


def phase(name: str):
    """Named range for a setup or solve phase (shows up in traces)."""
    return torch.profiler.record_function(name)


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None) -> Iterator[None]:
    """Wall-time a block, fenced on the card before each clock read, and
    add the seconds to ``sink[label]``."""
    _fence()
    t0 = time.perf_counter()
    yield
    _fence()
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
