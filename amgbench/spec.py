"""Find the benchmark's data files and metric readers by name."""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG  # where the data files and metric readers are found
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}\Z")


def _path(kind: str, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a {kind} name: {name!r}")
    p = ROOT / kind / f"{name}{suffix}"
    if not p.is_file():
        have = sorted(q.name[:-len(suffix)] for q in (ROOT / kind).glob(f"*{suffix}"))
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({p}); there are: "
                                f"{', '.join(have)}")
    return p


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` as a dict with its ``name`` set."""
    return {**json.loads(_path(kind, name, ".json").read_text()), "name": name}


def load_cell(name: str) -> dict:
    return load_json("cells", name)


def load_config(name: str) -> dict:
    return load_json("configs", name)


def load_mix(name: str) -> dict:
    return load_json("traffic", name)


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``: ``UNIT`` and ``read(run)``,
    which returns a number or None when the run holds nothing to read."""
    p = _path("metrics", name, ".py")
    spec = importlib.util.spec_from_file_location(
        "amgbench.metrics._" + re.sub(r"\W", "_", name), p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not isinstance(getattr(mod, "UNIT", None), str) or not callable(
            getattr(mod, "read", None)):
        raise TypeError(f"metric reader {p} needs UNIT and read(run)")
    return mod


def load_engine(name: str):
    """The engine module ``engines/<name>.py`` that drives the program."""
    if not NAME.match(name) or "." in name:
        raise ValueError(f"not an engine name: {name!r}")
    if not (PKG / "engines" / f"{name}.py").is_file():
        raise FileNotFoundError(f"no engine {name!r}")
    return importlib.import_module(f"amgbench.engines.{name}")


def resolve(cell_name: str, overrides: dict | None = None) -> tuple:
    """(cell, config, mix) for a cell; ``overrides`` replaces keys of the
    configuration's ``problem`` (tests run a cell at a CPU size)."""
    cell = load_cell(cell_name)
    config = load_config(cell["config"])
    if overrides:
        config = {**config, "problem": {**config["problem"], **overrides}}
    return cell, config, load_mix(cell["traffic"])
