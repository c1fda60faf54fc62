"""The level-0 block applies' least bytes (block values at the value
precision, x in, y out; ``engines/elasticity.py``) at the card's peak
bandwidth over the device self time of their ``bell.spmv`` spans in the
profiled cycles, in percent."""

UNIT = "%"


def read(run):
    c, peak = run["counts"], run["peak_bytes_per_s"]
    b = None if c is None else c.get("bell0")
    if not b or not peak or not b["self_s"] or not b["calls"]:
        return None
    return 100.0 * (b["bytes"] / peak) / b["self_s"]
