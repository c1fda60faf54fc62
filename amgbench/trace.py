"""What the benchmark reads from torch.profiler: the union of the device
events' intervals (device busy), the events per call, the device
operations that took most time, and the longest idle gaps by what the
host was doing."""

from __future__ import annotations

import bisect
import collections
import math
import time

import torch

TOP = 10


def union_seconds(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    busy, end = 0.0, -math.inf
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def sync(dev) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


class Trace:
    """One profiled span of work: host wall seconds, device events
    (name, start_us, end_us) and host events (name, start_us, end_us)."""

    def __init__(self, wall_s: float, device: list, host: list, calls: int):
        self.wall_s, self.device, self.host, self.calls = wall_s, device, host, calls

    @property
    def busy_s(self) -> float:
        return union_seconds((a, b) for _, a, b in self.device) * 1e-6

    @property
    def events_per_call(self) -> float:
        return len(self.device) / self.calls

    def device_ops(self) -> list:
        """[[name, seconds]] of the device operations with most time."""
        tot = collections.Counter()
        for name, a, b in self.device:
            tot[name] += (b - a) * 1e-6
        return [[k, v] for k, v in tot.most_common(TOP)]

    def idle_gaps(self) -> list:
        """[[host op, seconds]]: the device's idle gaps inside the traced
        span, each named by the innermost host operation running at its
        middle, summed by name; the ten largest sums."""
        if not self.device:
            return []
        spans = sorted((a, b) for _, a, b in self.device)
        gaps, end = [], spans[0][1]
        for a, b in spans[1:]:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        host = sorted(self.host, key=lambda e: e[1])
        starts = [e[1] for e in host]
        tot = collections.Counter()
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            name = "(no host op)"
            # the latest-starting host event that covers the middle is the
            # innermost of nested ones
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - 200, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            tot[name] += (g1 - g0) * 1e-6
        return [[k, v] for k, v in tot.most_common(TOP)]


def profile(fn, dev, calls: int = 1) -> Trace:
    """Run ``fn`` under torch.profiler (host and device activities);
    the host wall ends in a synchronize."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CPU]
    if torch.device(dev).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(dev)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall = time.perf_counter() - t0
    device, host = [], []
    for e in prof.events():
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            device.append(rec)
        else:
            host.append(rec)
    return Trace(wall, device, host, calls)
