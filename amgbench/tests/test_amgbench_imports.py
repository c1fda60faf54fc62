"""Neither the harness nor its reference loads JAX or the JAX package
(top-level names compared whole: the port's name starts with the JAX
package's), and the reference loads nothing of the program."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from amgbench.run import FORBIDDEN, forbidden_modules

REPO = Path(__file__).resolve().parents[2]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = _loaded("from amgbench.run import run_cell\n"
                  "run_cell('structured-solve', 1, 0.1, True, device='cpu', "
                  "overrides={'n': 16})\n"
                  "run_cell('shuffled-solve', 1, 0.1, False, device='cpu', "
                  "overrides={'n': 16})")
    assert "raptor_tpu_torch" in top
    assert not top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded("import amgbench.reference.stencil, amgbench.reference.shuffled")
    assert not top & (set(FORBIDDEN) | {"raptor_tpu_torch"})


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "raptor_tpu_torch_extra", sys)
    assert "raptor_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "raptor_tpu.sub", sys)
    assert "raptor_tpu" in forbidden_modules()


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "amgbench.run", "--workload",
                        "structured-solve", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_control_fails_on_the_card_at_128():
    """On a card: the structured cell at 128^3, program within the limit,
    control above three times it, on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from amgbench import control

    rows = control.run("structured-solve", [1, 2, 3], 1, overrides={"n": 128})
    assert max(r["program"] for r in rows) <= 1e-8
    assert min(r["control"] for r in rows) > 3e-8
