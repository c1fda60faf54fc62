"""bench_torch.py, the port's bench, on the CPU at its CI sizes (``--small``
``--device cpu``): the kernel check, the structured rows, devsetup, the
acceptance rows and config 5 sharded, and the script's own contract.

Every row prints strict JSON (no NaN) with its checks, all passed, and
takes the iterations of the JAX package's same computation at the same size:
the configuration of the reference bench's row (``bench.py``) run here
through ``raptor_tpu`` on the CPU.  The script exits non-zero when a kernel
disagrees with its plain version (one plain version monkeypatched), without
a card unless asked for the CPU, and imports neither JAX nor ``raptor_tpu``.
The algebraic rows are in tests/test_torch_bench_alg.py.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
import raptor_tpu.api as japi
import raptor_tpu.structured.dia as jdia
import raptor_tpu.structured.dist as jdist
import raptor_tpu.structured.solver as js
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.gallery import default_rhs
from tests._torch_ref import bench_rows, stencil_7pt, strict_json

REPO = Path(__file__).resolve().parents[1]
ROWS = ["kernels", "structured128", "structured256", "devsetup", "configs",
        "sdist256"]
KERNELS = ["K1", "K1v1", "K2", "K3", "K4", "K4-halo", "K5", "K6", "K6-map_cols",
           "K7"]
RUN_TIMEOUT = 120


def run_script(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=RUN_TIMEOUT)


@pytest.fixture(scope="module")
def bench():
    return bench_rows(ROWS)


def test_rows_print_json_with_their_checks(bench):
    rc, rows, last = bench
    assert rc == 0
    assert list(rows) == ROWS
    for name, row in rows.items():
        assert "error" not in row, name
        assert row["card"]["device"] == "cpu"
        assert row["checks"] and all(c["ok"] for c in row["checks"]), name
    assert last["ok"] and last["failed"] == []
    assert last["metric"] == "vcycle_dof_per_s_per_card"
    assert last["value"] == rows["structured128"]["dof_per_s"]
    assert last["detail"]["kcheck"] == dict.fromkeys(KERNELS, True)
    assert last["detail"]["iters"] == rows["structured128"]["iters"]
    assert last["detail"]["c256"]["pcg_iterations"] == rows["structured256"]["iters"]


def test_kernel_row_holds_every_kernel_to_its_plain_version(bench):
    row = bench[1]["kernels"]
    assert list(row["kernels"]) == KERNELS
    for name, k in row["kernels"].items():
        assert k["pass"] and k["bit_equal"] and k["cases"] >= 1, name
    # on the CPU every wrapper is its plain version: nothing is timed
    assert all(c["ms"] is None for c in row["cases"])


def _jax_structured_iters(n: int, coarse_size: int) -> int:
    """bench.py:571-658 at n^3: the reference's refined solve."""
    cfg = JCfg(smoother="cheb4", cheb_degree=2, coarse_size=coarse_size,
               max_levels=40)
    A = jdia.dia_from_stencil(stencil_7pt(), (n,) * 3, dtype=jnp.float32)
    h = js.build_structured_hierarchy(A, cfg, dim_policy="size")
    b = jnp.asarray(default_rhs(n ** 3, dtype=np.float32))
    _, rel, it = js.structured_solve_refined(
        h, b, tol=1e-8, M_hier=js.cast_hierarchy(h, jnp.bfloat16))
    assert float(rel) <= 1e-8
    return int(it)


@pytest.mark.parametrize("name", ["structured128", "structured256"])
def test_structured_row_takes_the_reference_iterations(bench, name):
    row = bench[1][name]
    size = bt.SMALL[name]
    assert row["dims"] == [size["n"]] * 3
    assert row["relres"] <= 1e-8 and row["certified"] <= 1e-8
    assert row["setup_s"] > 0 and row["vcycle_s"] > 0 and row["solve_s"] > 0
    assert row["iters"] == _jax_structured_iters(size["n"], size["coarse_size"])
    if size["yardstick"]:
        assert row["cpu_core_dof_per_s"] > 0 and row["vs_baseline"] > 0


def test_devsetup_routes_take_the_reference_iterations(bench):
    """bench.py:322-360: the host route against the reference's host-route
    build (the device route compacts strength first, so its coarse sizes
    may differ; tests/test_torch_devsetup_builds.py holds it to the
    reference's device route)."""
    row = bench[1]["devsetup"]
    n = bt.SMALL["devsetup"]["n"]
    A = bt.shuffled_poisson(n)
    cfg = JCfg(splitting="pmis", interp="extended")
    h = japi.setup(A, cfg)
    _, info = japi.solve(A, np.ones(A.shape[0]), cfg,
                         JSolve(tol=1e-8, refine=True), hier=h)
    assert row["device_fused_levels"] > 0
    assert row["host_sizes"] == [lv.n for lv in h.levels]
    assert len(row["sizes"]) == len(row["host_sizes"])
    assert row["iterations_dev"] == row["iterations_host"] == info["iterations"]


def _jax_config(name: str, size: int, device_sa: bool) -> tuple:
    """bench.py:394-466 for one config: (iterations, sizes)."""
    A, B = bt.config_problem(name, size)
    cfg = {"config4": dataclasses.replace(JPRESETS["config4"],
                                          host_setup_threshold=400000),
           "nonsym_gmres": JCfg(splitting="pmis", smoother="jacobi")}.get(
        name) or JPRESETS[name]
    if device_sa:
        cfg = dataclasses.replace(
            JPRESETS["config4"],
            host_setup_threshold=bt.SMALL["configs"]["device_sa_threshold"])
    sc = JSolve(tol=1e-8, refine=True,
                krylov="gmres" if name == "nonsym_gmres" else "cg")
    h = japi.setup(A, cfg, B=B) if B is not None else None
    _, info = japi.solve(A, np.ones(A.shape[0]), cfg, sc, hier=h)
    return info["iterations"], info["stats"]["sizes"]


@pytest.mark.parametrize("name", list(bt.SMALL["configs"]["sizes"])
                         + ["config4_device_sa"])
def test_config_row_takes_the_reference_iterations(bench, name):
    row = bench[1]["configs"]["configs"][name]
    base = name.removesuffix("_device_sa")
    it, sizes = _jax_config(base, bt.SMALL["configs"]["sizes"][base],
                            name != base)
    assert row["true_relres"] <= 1e-8
    assert (row["iterations"], row["sizes"]) == (it, sizes)


def test_sdist_row_takes_the_reference_iterations(bench):
    """Config 5 (raptor_tpu/cli.py:194-241) on one rank against the
    reference's single-device solve on the one-rank plan."""
    row = bench[1]["sdist256"]
    n = bt.SMALL["sdist256"]["n"]
    cfg = JCfg(smoother="mcgs", coarse_size=512, max_levels=40)
    A = jdia.dia_from_stencil(stencil_7pt(), (n,) * 3, dtype=jnp.float32)
    plan, _ = jdist.plan_coarsening_dist(A, cfg, 1, "size")
    _, info = js.structured_solve(
        js._build_hierarchy_planned(A, cfg, plan),
        jnp.asarray(default_rhs(n ** 3, dtype=np.float32)), tol=1e-6,
        maxiter=200)
    assert row["ranks"] == 1 and row["backend"] == "gloo"
    assert row["iters"] == row["single_device_iters"] == int(info.iterations)
    assert row["certified"] <= 1e-6 and row["relres"] <= 1e-5


def test_sharded_row_on_two_ranks_takes_one_ranks_iterations(bench):
    rc, rows, last = bench_rows(["sdist256"], "--ranks", "2")
    row = rows["sdist256"]
    assert rc == 0 and last["ok"]
    assert row["ranks"] == 2 and len(row["per_rank"]["solve_s"]) == 2
    assert row["iters"] == bench[1]["sdist256"]["iters"]
    assert last["detail"]["sdist"]["ranks"] == 2


def test_a_kernel_that_disagrees_fails_the_run():
    code = (
        "import sys, bench_torch as bt\n"
        "plain = bt.plain_versions\n"
        "def broken():\n"
        "    out = dict(plain())\n"
        "    k2 = out['K2']\n"
        "    out['K2'] = lambda *a: k2(*a) + 1.0\n"
        "    return out\n"
        "bt.plain_versions = broken\n"
        "sys.exit(bt.main(['--device', 'cpu', '--small', '--rows',\n"
        "                  'kernels,structured256']))\n")
    p = run_script(code)
    assert p.returncode == 1, p.stderr[-2000:]
    lines = [strict_json(ln) for ln in p.stdout.splitlines()]
    assert [ln.get("row") for ln in lines[:-1]] == ["kernels"]  # nothing after
    row, last = lines[0], lines[-1]
    assert "error" in row and not row["kernels"]["K2"]["pass"]
    assert all(k["pass"] for name, k in row["kernels"].items() if name != "K2")
    assert not last["ok"] and last["failed"] == ["kernels"]
    assert last["detail"]["kcheck"]["K2"] is False


def test_bench_imports_neither_jax_nor_the_reference():
    code = (
        "import sys, contextlib, io, bench_torch as bt\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    rc = bt.main(['--device', 'cpu', '--small', '--rows',\n"
        "                  'structured256,sdist256'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                                                      'raptor_tpu')]\n"
        "print(rc, sorted(bad))\n")
    p = run_script(code)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split() == ["0", "[]"]


def test_without_a_card_the_bench_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    p = subprocess.run([sys.executable, "bench_torch.py", "--rows", "kernels"],
                       cwd=REPO, capture_output=True, text=True,
                       timeout=RUN_TIMEOUT)
    assert p.returncode != 0 and p.stdout == ""
    assert "--device cpu" in p.stderr


def test_profile_needs_a_card():
    assert bt.main(["--device", "cpu", "--small", "--profile", "--rows",
                    "structured256"]) == 2
