"""bench_torch.py's algebraic rows on the CPU at their CI sizes (``--small``
``--device cpu``): alg48 and alg96 (shuffled Poisson, PMIS + direct on the
banded layout with cheb4), alg128 (natural-ordered Poisson in plane mode)
and adist96 (the algebraic sharded solve, flat and TAPS, one gloo rank).

Every row prints strict JSON with its checks, all passed, and takes the
level sizes and iterations of the JAX package's same computation at the
same size (the configuration of the reference bench's row, ``bench.py``,
run here through ``raptor_tpu`` on the CPU): the refined solve with the
hierarchy's own operators and with bf16 preconditioner operators, and for
adist96 the reference's single-device solve on the hierarchy the ranks
shard.  The other rows and the script's own contract are in
tests/test_torch_bench.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import bench_torch as bt
import raptor_tpu.api as japi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import pad_vector
from raptor_tpu.setup.hierarchy import cast_hierarchy_algebraic
from raptor_tpu_torch.gallery import default_rhs, poisson_3d
from tests._torch_ref import bench_rows

ROWS = ["alg48", "alg96", "alg128", "adist96"]


@pytest.fixture(scope="module")
def bench():
    return bench_rows(ROWS)


def test_rows_print_json_with_their_checks(bench):
    rc, rows, last = bench
    assert rc == 0 and last["ok"] and last["failed"] == []
    assert list(rows) == ROWS
    for name, row in rows.items():
        assert "error" not in row, name
        assert row["checks"] and all(c["ok"] for c in row["checks"]), name
    for name in ("alg48", "alg96"):
        assert last["detail"][name]["iters"] == rows[name]["iterations"]
    assert last["detail"]["alg128"]["iterations"] == rows["alg128"]["iterations"]
    assert last["detail"]["adist"]["taps_iters"] == rows["adist96"]["taps_iters"]


def _jax_refined(A, cfg) -> dict:
    """The reference's api.setup and refined api.solve with b = ones, and
    its device solve with the hierarchy's own and with bf16 preconditioner
    operators."""
    n = A.shape[0]
    h = japi.setup(A, cfg)
    b = np.ones(n)
    _, info = japi.solve(A, b, cfg, JSolve(tol=1e-8, refine=True), hier=h)
    out = {"iterations": info["iterations"], "sizes": [lv.n for lv in h.levels]}
    bp = b if h.perm is None else b[np.asarray(h.perm)[:n]]
    n_pad = h.levels[0].A.n_rows_pad
    hi = bp.astype(np.float32)
    lo = (bp - hi.astype(np.float64)).astype(np.float32)
    for tag, M in (("fp32", None), ("bf16", cast_hierarchy_algebraic(
            h, jnp.bfloat16))):
        _, rel, it = japi.solve_hier_refined(
            h, pad_vector(hi, n_pad), tol=1e-8, maxiter=JSolve().maxiter,
            b_lo=pad_vector(lo, n_pad), M_hier=M)
        assert float(rel) <= 1e-8
        out[f"iterations_{tag}"] = int(it)
    return out


@pytest.mark.parametrize("name", ["alg48", "alg96"])
def test_algebraic_row_takes_the_reference_iterations(bench, name):
    """bench.py:142-227 at shuffled n^3."""
    row = bench[1][name]
    n = bt.SMALL[name]["n"]
    ref = _jax_refined(bt.shuffled_poisson(n), JCfg(**bt.ALG_CFG))
    assert row["n"] == n ** 3 and row["true_relres"] <= 1e-8
    assert row["sizes"] == ref["sizes"]
    assert row["iterations"] == ref["iterations"] == ref["iterations_fp32"]
    assert (row["iterations_fp32"], row["iterations_bf16"]) == (
        ref["iterations_fp32"], ref["iterations_bf16"])
    assert row["cpu_core_dof_per_s"] > 0


def test_alg128_row_takes_the_reference_iterations(bench):
    """bench.py:230-320 at natural-ordered n^3, in plane mode."""
    row = bench[1]["alg128"]
    n = bt.SMALL["alg128"]["n"]
    ref = _jax_refined(sp.csr_matrix(poisson_3d(n)), JCfg(**bt.ALG128_CFG))
    assert row["layouts"][0] == "hyb" and row["true_relres"] <= 1e-8
    assert row["sizes"] == ref["sizes"]
    assert row["iterations"] == ref["iterations"] == ref["iterations_bf16"]
    assert (row["iterations_fp32"], row["iterations_bf16"]) == (
        ref["iterations_fp32"], ref["iterations_bf16"])


def test_adist_row_takes_the_reference_iterations(bench):
    """The algebraic sharded solve on one rank, flat and TAPS, against the
    reference's single-device solve (fp32 PCG to 1e-6) on the hierarchy
    the ranks shard."""
    row = bench[1]["adist96"]
    n = bt.SMALL["adist96"]["n"]
    A = bt.shuffled_poisson(n)
    h = japi.setup(A, JCfg(**bt.ALG_CFG, host_setup_threshold=bt.HOST_ROUTE_THRESHOLD,
                           pad_multiple=1024))
    pm = np.asarray(h.perm)[:n ** 3]
    bd = pad_vector(default_rhs(n ** 3)[pm].astype(np.float32),
                    h.levels[0].A.n_rows_pad)
    _, info = japi.solve_hier(h, bd, tol=1e-6, maxiter=200)
    assert row["ranks"] == 1 and row["taps_grid"] == [1, 1]
    assert row["sizes"] == [lv.n for lv in h.levels]
    assert row["iters"] == row["taps_iters"] == row["single_device_iters"] \
        == int(info.iterations)
    assert row["true_relres"] <= 1e-5 and row["taps_true_relres"] <= 1e-5
