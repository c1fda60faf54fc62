"""Seconds of the program's fenced set-up root (``setup.algebraic``: the
smoothed-aggregation hierarchy, its upload, tail fold and fp32
remainder) in the run's own set-up, on the host clock between device
syncs."""

UNIT = "s"


def read(run):
    c = run["counts"]
    return None if c is None else c.get("setup_root_s")
