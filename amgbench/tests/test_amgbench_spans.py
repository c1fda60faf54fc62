"""The span attribution (``amgbench/spans.py``) on synthetic event lists,
and a span run of each cell on the CPU at a small size."""

import pytest

from amgbench import spans as sp

# program spans (name, start, end), ns: a solve holding a pcg holding two
# V-cycles, each with a smoother; a residual after the pcg
SPANS = [("solve", 0, 1000), ("pcg", 100, 700), ("vcycle", 200, 300),
         ("vcycle.smooth[0]", 210, 250), ("vcycle", 400, 500),
         ("vcycle.smooth[0]", 410, 450), ("refine.residual", 750, 900)]


def test_enclosing_gives_every_span_outermost_first():
    got = sp.enclosing([220, 5, 350, 420, 800, 1500, 700], SPANS)
    assert got == [("solve", "pcg", "vcycle", "vcycle.smooth[0]"),
                   ("solve",), ("solve", "pcg"),
                   ("solve", "pcg", "vcycle", "vcycle.smooth[0]"),
                   ("solve", "refine.residual"), (), ("solve", "pcg")]


def test_a_kernel_goes_to_the_spans_around_its_launch_not_its_run():
    # (corr, start, end): kernel 1 launched in the smoother runs after the
    # host has left it; kernel 3's launch is unknown
    device = [(1, 260, 360), (2, 760, 800), (3, 900, 950), (4, 1100, 1200)]
    launches = {1: 230, 2: 755, 4: 1050}
    got = sp.launch_chains(device, launches, SPANS)
    assert [c for _, c in got] == [
        ("solve", "pcg", "vcycle", "vcycle.smooth[0]"),
        ("solve", "refine.residual"), (), None]
    assert [s for s, _ in got] == pytest.approx([1e-7, 4e-8, 1e-7, 5e-8])
    assert sp.seconds_in(got, {"vcycle.smooth"}) == pytest.approx(100e-9)
    assert sp.seconds_in(got, {"solve"}, {"pcg"}) == pytest.approx(40e-9)
    assert sp.seconds_in(got, {"pcg"}, {"vcycle"}) == 0
    assert sp.seconds_in(got, {"refine."}) == pytest.approx(40e-9)


def test_an_idle_gap_goes_to_the_innermost_span_at_its_middle():
    device = [(1, 0, 200), (2, 150, 220), (3, 420, 700), (4, 900, 950)]
    assert sp.idle_gaps(device) == [(220, 420), (700, 900)]
    got = sp.gap_chains(device, SPANS)
    assert [c for _, c in got] == [("solve", "pcg"),
                                   ("solve", "refine.residual")]
    assert [s for s, _ in got] == pytest.approx([200e-9, 200e-9])
    assert sp.gap_chains([], SPANS) == []


def test_the_span_table_counts_an_event_once_per_span():
    launched = [(3.0, ("solve", "pcg", "vcycle")), (1.0, ("solve",)),
                (2.0, ("solve", "pcg")), (5.0, ()), (7.0, None)]
    gapped = [(0.5, ("solve", "pcg")), (0.25, ())]
    host = [("solve", 0, 10), ("pcg", 1, 5), ("pcg", 6, 8),
            ("vcycle", 2, 3)]
    rows = {r["name"]: r for r in sp.span_table(launched, gapped, host)}
    assert rows["solve"]["device_s"] == 6.0 and rows["solve"]["self_s"] == 1.0
    assert rows["pcg"]["device_s"] == 5.0 and rows["pcg"]["self_s"] == 2.0
    assert rows["pcg"]["calls"] == 2 and rows["pcg"]["idle_s"] == 0.5
    assert rows["pcg"]["host_s"] == pytest.approx(6e-9)
    assert rows[sp.NO_SPAN]["idle_s"] == 0.25
    assert [r["name"] for r in sp.span_table(launched, gapped, host)][:3] == [
        "solve", "pcg", "vcycle"]


@pytest.mark.parametrize("cell", ["structured-solve", "shuffled-solve",
                                  "structured-rebuild"])
def test_a_span_run_on_the_cpu(cell):
    out = sp.run_cell(cell, 2**33 + 7, device="cpu", overrides={"n": 16})
    m = out["metrics"]
    assert set(m) == set(sp.METRICS)
    assert m["hierarchy_setup_s"] > 0
    assert out["checks"]["setup_within_setup_s"]["ok"]
    assert "spans" in out and out["stages"]
    if cell == "structured-rebuild":
        assert m["host_reads.solve"] is None
        assert out["spans"][0]["calls"] >= 1
    else:
        assert m["host_reads.solve"] >= 3
        assert out["checks"]["host_reads"]["ok"]
        assert {r["name"] for r in out["vcycle_spans"]} >= {
            "vcycle", "vcycle.smooth[0]"}
    # the CPU has no device trace
    assert m["smooth_ms.solve"] is None and m["rap_s.rebuild"] is None
