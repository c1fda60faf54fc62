"""The harness finds cells, configurations, mixes and metric readers by
name; a cell is added by adding files; BENCHMARK.json agrees with them."""

import json
import shutil
from pathlib import Path

import pytest

from amgbench import spec
from amgbench.run import run_cell

BENCH = json.loads((Path(spec.ROOT).parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_workload_resolves(w):
    cell, config, mix = spec.resolve(w["name"])
    assert cell["config"] == w["config"] and cell["traffic"] == w["traffic"]
    assert cell["chips"] == w["chips"]
    assert config["engine"] and spec.load_engine(config["engine"])
    assert set(config["reduced"]) == set(
        next(c for c in BENCH["configs"] if c["name"] == w["config"])["reduced"])
    listed = [m["name"] for m in BENCH["per_layer"] if w["name"] in m["workloads"]]
    assert sorted(listed) == sorted(cell["per_layer"])
    rate = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
    assert sorted(m["name"] for m in rate) == sorted(["setup_s", cell["rate_metric"]])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_metric_has_its_reader(m):
    assert spec.load_metric(m["name"]).UNIT == m["unit"]


def test_config_files_are_the_benchmarks():
    for c in BENCH["configs"]:
        assert c["file"] == f"amgbench/configs/{c['name']}.json"
        assert spec.load_config(c["name"])["source"] == c["source"]


@pytest.mark.parametrize("kind,name", [("cell", "no-such-cell"),
                                       ("config", "no-such-config"),
                                       ("mix", "no-such-mix"),
                                       ("metric", "no_such.metric")])
def test_a_missing_file_raises(kind, name):
    with pytest.raises(FileNotFoundError):
        getattr(spec, f"load_{kind}")(name)


def test_a_bad_name_raises():
    with pytest.raises(ValueError):
        spec.load_cell("../BENCHMARK")


def test_a_cell_is_added_by_files_alone(tmp_path, monkeypatch):
    """A new cell, mix and metric in new files run without an edit."""
    for d in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(Path(spec.ROOT) / d, tmp_path / d)
    (tmp_path / "traffic" / "dummy-mix.json").write_text(
        json.dumps({"rhs": {"low": 0.0, "high": 2.0}, "diag_shift": None}))
    (tmp_path / "metrics" / "dummy_steps.solve.py").write_text(
        'UNIT = "steps"\n\n\ndef read(run):\n    return len(run["steps"])\n')
    (tmp_path / "cells" / "dummy-solve.json").write_text(json.dumps({
        "config": "poisson7-structured", "traffic": "dummy-mix", "chips": 1,
        "rate_metric": "solve_s", "samples": 1, "trace_steps": 1,
        "per_layer": ["dummy_steps.solve", "pcg_iters.solve"]}))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    out = run_cell("dummy-solve", 3, 0.2, True, device="cpu",
                   overrides={"n": 16})
    assert out["correct"]
    assert out["metrics"]["dummy_steps.solve"] == {
        "value": float(out["attempted"]), "unit": "steps"}
    assert out["metrics"]["pcg_iters.solve"]["unit"] == "iters"
