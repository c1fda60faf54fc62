"""Mean seconds a hierarchy build (operator, build, cast) over the
window's steps: host clock around the calls, ending in a synchronize."""

UNIT = "s"


def read(run):
    b = [s["build_s"] for s in run["steps"] if s.get("build_s") is not None]
    return sum(b) / len(b) if b else None
