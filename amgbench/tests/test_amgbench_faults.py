"""A run with its timed path broken underneath comes out not correct, and
so does the control (the program one precision below the configuration),
at CPU sizes; sound runs come out correct."""

import pytest

from amgbench import control
from amgbench.run import run_cell

SIZES = {"structured-solve": {"n": 16}, "shuffled-solve": {"n": 16},
         "structured-rebuild": {"n": 16}}
# the faults each cell can have: a solve that returns its starting state
# and an answer altered where it is produced (the cells solve one
# right-hand side a step on one card: there is no batch to halve and no
# exchange between cards)
FAULTS = [(c, f) for c in SIZES for f in ("state_unchanged", "answer_altered")]


@pytest.mark.parametrize("cell", list(SIZES))
def test_sound_run_is_correct(cell):
    out = run_cell(cell, 2**31 + 99, 0.3, False, device="cpu",
                   overrides=SIZES[cell])
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run_cell(cell, 17, 0.3, False, device="cpu", overrides=SIZES[cell],
                   faults=(fault,))
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", list(SIZES))
def test_the_control_fails_the_limit(cell):
    from amgbench import spec

    limit = spec.load_config(spec.load_cell(cell)["config"])["limit"]["relres"]
    rows = control.run(cell, [5, 6, 7], 1, device="cpu", overrides=SIZES[cell])
    assert len(rows) == 3
    assert max(r["program"] for r in rows) <= limit
    assert min(r["control"] for r in rows) > 3 * limit


def test_an_uncertified_step_is_not_correct():
    """A step whose own certified residual missed tol fails the run even
    where every sampled answer meets the reference's limit."""
    import torch

    from amgbench import spec
    from amgbench.run import result

    cell, config, _ = spec.resolve("structured-solve")
    steps = [{"k": k, "ok": ok, "seconds": 0.5, "iters": 7}
             for k, ok in enumerate((True, False, True))]
    m = {"run": {"steps": steps, "window_s": 1.5, "trace": None},
         "verdicts": [(0, 1e-9), (2, 2e-9)], "memory_peak_bytes": 0}
    out = result(cell, config, m, 1.0, torch.device("cpu"), False)
    assert out["failed"] == 1
    assert out["compared"]["uncertified_steps"] == {"value": 1, "limit": 0}
    assert not out["correct"]
    steps[1]["ok"] = True
    assert result(cell, config, m, 1.0, torch.device("cpu"), False)["correct"]
