"""The least time of one V-cycle's operator traffic at the card's peak
bandwidth (amgbench/counts.py, from level sizes and non-zeros) over the
V-cycle's device-busy time, in percent."""

UNIT = "%"


def read(run):
    v, c, peak = run["vcycle"], run["counts"], run["peak_bytes_per_s"]
    if v is None or c is None or not peak or not v["busy_ms"]:
        return None
    return 100.0 * (c["vcycle_bytes"] / peak) / (v["busy_ms"] * 1e-3)
