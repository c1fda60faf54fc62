"""Share of the traced window in which no operation ran on the device:
1 - (union of the device events' intervals / the traced span)."""

UNIT = "%"


def read(run):
    t = run["trace"]
    if t is None or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
