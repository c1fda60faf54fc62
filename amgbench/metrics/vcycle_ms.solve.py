"""ms a V-cycle of the cell's preconditioner: many cycles timed on the
host, ending in a synchronize, over the count."""

UNIT = "ms"


def read(run):
    return None if run["vcycle"] is None else run["vcycle"]["ms"]
