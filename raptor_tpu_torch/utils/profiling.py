"""Spans, and the Chrome-trace exporter: the port's one tracing mechanism.

Counterpart of ``raptor_tpu/utils/profiling.py``.  ``phase(name)`` marks
a span of set-up or solve work; ``spanned(name)`` marks a whole function.
With recording off (the default) a span is one read of the module flag
``ON`` and the shared no-op context: no ``record_function`` is entered and
no name is built, so the cycle and the kernels' launch sites carry their
spans at the cost of a flag read.

``recording()`` turns recording on for a block.  Each span then keeps a
``Span`` record (name, parent, start and end on ``time.perf_counter_ns``)
in the recording, and while a ``torch.profiler`` is active it also enters
``torch.profiler.record_function(PREFIX + name)``, so the span shows in
the profiler's trace on the profiler's clock, around the device work it
launched.  ``PREFIX`` sets the program's spans apart from ATen's events.

``fence=True`` synchronizes the card at the span's edges while recording
is on and no profiler is active: host-clock timing of long set-up stages.
Under a profiler no span fences, so the device's idle gaps stay as they
are.  ``trace(logdir)`` profiles a block with recording on and writes a
Chrome trace (Perfetto, chrome://tracing) that holds the program's spans.

Spans nest per process, on the thread that runs the solver.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Callable, Iterator, Union

import torch

__all__ = ["ON", "PREFIX", "Recording", "Span", "phase", "recording",
           "spanned", "trace"]

PREFIX = "raptor::"

ON = False  # recording on: read by every span
_NOOP = contextlib.nullcontext()
_rec: "Recording | None" = None
_stack: list = []  # indices of the open spans in _rec.spans


@dataclasses.dataclass
class Span:
    name: str
    parent: int  # index of the enclosing span in the recording, -1 at a root
    start_ns: int
    end_ns: int = -1
    fenced: bool = False  # timed between device fences

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


@dataclasses.dataclass
class Recording:
    spans: list = dataclasses.field(default_factory=list)

    def roots(self) -> list:
        return [s for s in self.spans if s.parent < 0]

    def totals(self) -> dict:
        """{name: (calls, host seconds)} over the recorded spans."""
        out: dict = {}
        for s in self.spans:
            c, t = out.get(s.name, (0, 0.0))
            out[s.name] = (c + 1, t + s.seconds)
        return out


def _fence() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _label(name, index) -> str:
    name = name() if callable(name) else name
    if index is None:
        return name
    if isinstance(index, tuple):
        index = ",".join(str(v).removeprefix("torch.") for v in index)
    return f"{name}[{index}]"


class _Open:
    __slots__ = ("name", "fence", "span", "rf")

    def __init__(self, name: str, fence: bool):
        self.name, self.fence, self.rf = name, fence, None

    def __enter__(self):
        profiled = torch.autograd._profiler_enabled()
        self.fence = self.fence and not profiled
        if self.fence:
            _fence()
        spans = _rec.spans
        self.span = Span(self.name, _stack[-1] if _stack else -1,
                         time.perf_counter_ns(), fenced=self.fence)
        _stack.append(len(spans))
        spans.append(self.span)
        if profiled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        return self.span

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        elif self.fence:
            _fence()
        self.span.end_ns = time.perf_counter_ns()
        _stack.pop()
        return False


def phase(name: Union[str, Callable[[], str]], index=None, *,
          fence: bool = False):
    """A span named ``name`` (a string, or a function that returns one),
    or ``name[index]`` (a tuple index joins with commas): the shared no-op
    while recording is off, when neither ``name`` is called nor the label
    built."""
    if not ON:
        return _NOOP
    return _Open(_label(name, index), fence)


def spanned(name: str, *, fence: bool = False):
    """Decorator: every call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not ON:
                return fn(*args, **kwargs)
            with _Open(name, fence):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Record the spans of a block; restores the enclosing state after."""
    global ON, _rec
    saved = (ON, _rec, _stack[:])
    rec = Recording()
    ON, _rec = True, rec
    _stack.clear()
    try:
        yield rec
    finally:
        ON, _rec = saved[0], saved[1]
        _stack[:] = saved[2]


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Profile a block with recording on and write
    ``logdir/trace_<pid>_<n>.json``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof, recording():
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))
