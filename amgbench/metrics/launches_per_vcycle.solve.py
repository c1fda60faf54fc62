"""Device events a V-cycle, from torch.profiler over the profiled cycles
(kernels, copies and sets: every launch the host made)."""

UNIT = "launches"


def read(run):
    v = run["vcycle"]
    if v is None or not v["events"]:
        return None
    return v["events"]
