"""Mean PCG iterations a solve over the window (the solves' own count)."""

UNIT = "iters"


def read(run):
    steps = run["steps"]
    return sum(s["iters"] for s in steps) / len(steps) if steps else None
