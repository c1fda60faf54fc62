"""The port's algebraic engine (``raptor_tpu_torch.api``: host setup,
RCM-banded layouts, PCG and the df64-refined solve) against the JAX package
on the CPU, on the shuffled 16^3 and 20^3 hierarchies both packages build
once per module:

* setup through ``api.setup`` with the reference bench's banded
  configuration (tests/_torch_alg_check.py's comparisons), the bf16 cast
  and the hierarchy carried over from JAX as numpy;
* solves: the refined solve takes JAX's iteration counts (7 at 16^3, 8 at
  20^3) to a true fp64 relres <= 1e-8; the bf16 preconditioner, host
  refinement and the plain PCG route; the ELL and banded layouts give the
  same sizes and iterations; the stationary iteration; (F)GMRES with the
  reference's restart.

The single-build setups, the cycles and the configurations ported after
the first slices are in tests/test_torch_algebraic_cycles.py, so that the
two files' reference builds run on two workers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.api as japi
import raptor_tpu_torch.api as tapi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from tests._torch_alg_check import ALG, _same_hierarchy
from tests._torch_ref import algebraic_tree_from_jax, np32, shuffled_poisson

REFINED = dict(tol=1e-8, refine=True)
JAX_ITERS = {16: 7, 20: 8}  # the reference's refined-solve iterations


@pytest.fixture(scope="module")
def mats():
    return {nx: shuffled_poisson(nx) for nx in (16, 20)}


@pytest.fixture(scope="module")
def jhiers(mats):
    return {nx: japi.setup(A, JCfg(**ALG)) for nx, A in mats.items()}


@pytest.fixture(scope="module")
def thiers(mats):
    return {nx: tapi.setup(A, TCfg(**ALG), device="cpu")
            for nx, A in mats.items()}


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", [16, 20])
def test_banded_setup_matches_reference(jhiers, thiers, nx):
    th, jh = thiers[nx], jhiers[nx]
    assert th.levels[0].Aband is not None and th.levels[0].Rband is not None
    _same_hierarchy(th, jh)


def test_bf16_cast_matches_reference(jhiers, thiers):
    from raptor_tpu.setup.hierarchy import cast_hierarchy_algebraic as jcast
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic as tcast

    th, jh = tcast(thiers[16], torch.bfloat16), jcast(jhiers[16], jnp.bfloat16)
    for tl, jl in zip(th.levels, jh.levels):
        for name in ("Aband", "Pband", "Rband"):
            tb, jb = getattr(tl, name), getattr(jl, name)
            if tb is not None:
                assert tb.vals.dtype == torch.bfloat16
                assert np.array_equal(np32(tb.vals), np32(jb.vals)), name
        assert tl.A.data.dtype == torch.bfloat16
        assert tl.dinv.dtype == torch.float32
    assert th.tail_op.dtype == torch.bfloat16


def test_carried_hierarchy_equals_port_setup(jhiers, thiers):
    """algebraic_hierarchy_from_numpy rebuilds the port's own hierarchy."""
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(jhiers[16]), "cpu")
    _same_hierarchy(th, jhiers[16])
    _same_hierarchy(thiers[16], jhiers[16])


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _true_relres(A, x, b):
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


@pytest.mark.parametrize("nx", [16, 20])
def test_refined_solve_takes_reference_iterations(mats, jhiers, thiers, nx):
    A = mats[nx]
    b = np.ones(A.shape[0])
    _, info_j = japi.solve(A, b, JCfg(**ALG), JSolve(**REFINED), hier=jhiers[nx])
    x, info = tapi.solve(A, b, TCfg(**ALG), TSolve(**REFINED), hier=thiers[nx])
    assert info["iterations"] == info_j["iterations"] == JAX_ITERS[nx]
    assert info["stats"]["sizes"] == [lv.n for lv in jhiers[nx].levels]
    assert x.shape == (A.shape[0],)
    assert _true_relres(A, x, b) <= 1e-8
    assert abs(info["relres"] - _true_relres(A, x, b)) <= 1e-10


def test_refined_solve_with_bf16_preconditioner(mats, thiers):
    A = mats[16]
    b = default_rhs(A.shape[0])
    x, info = tapi.solve(A, b, TCfg(**ALG, operator_store_dtype="bfloat16"),
                         TSolve(**REFINED), hier=thiers[16])
    assert _true_relres(A, x, b) <= 1e-8
    assert info["iterations"] <= JAX_ITERS[16] + 2


def test_host_refinement_and_plain_pcg_routes(mats, jhiers, thiers):
    A = mats[16]
    b = default_rhs(A.shape[0])
    x, info = tapi.solve(A, b, TCfg(**ALG),
                         TSolve(tol=1e-8, refine=True, refine_device=False),
                         hier=thiers[16])
    assert _true_relres(A, x, b) <= 1e-8
    assert info["relres"] <= 1e-8
    sc = dict(tol=1e-6)
    x, info = tapi.solve(A, b, TCfg(**ALG), TSolve(**sc), hier=thiers[16])
    _, info_j = japi.solve(A, b, JCfg(**ALG), JSolve(**sc), hier=jhiers[16])
    assert info["status"] == 0 and info["iterations"] == info_j["iterations"]
    assert _true_relres(A, x, b) <= 2e-6
    assert np.isnan(info["res_hist"][info["iterations"] + 1:]).all()


def test_ell_and_banded_layouts_agree(mats, thiers):
    """Mirror of the reference's layout parity test: the RCM ordering of the
    banded layout changes neither the C/F sets nor the iteration count."""
    A = mats[16]
    b = np.ones(A.shape[0])
    _, i_ell = tapi.solve(A, b, TCfg(splitting="pmis", interp="direct",
                                     smoother="cheb4", cheb_degree=2),
                          TSolve(**REFINED), device="cpu")
    _, i_band = tapi.solve(A, b, TCfg(**ALG), TSolve(**REFINED),
                           hier=thiers[16])
    assert i_ell["stats"]["sizes"] == i_band["stats"]["sizes"]
    assert i_ell["iterations"] == i_band["iterations"]


def test_stationary_iteration_converges(thiers):
    h = thiers[16]
    b = torch.from_numpy(default_rhs(h.levels[0].A.n_rows_pad, dtype=np.float32))
    x, info = tapi.solve_hier(h, b, tol=1e-5, krylov="none", maxiter=60)
    assert int(info.status) == 0 and float(info.relres) <= 1e-5


@pytest.mark.parametrize("krylov", ["gmres", "fgmres"])
@pytest.mark.parametrize("refine", [True, False])
def test_gmres_restart_reaches_the_solve(mats, jhiers, thiers, krylov, refine):
    """``SolveConfig.gmres_restart`` reaches (F)GMRES in both the df64-refined
    and the plain solve: with a restart of 1 the port takes the reference's
    iterations (the refined solve takes one more than with a restart of 30),
    and the plain solve's residual history follows the reference's within
    1e-2 relative at every step (fp32 rounding moves the last steps by up to
    3e-3; with a restart of 30 the second step is 40% lower)."""
    A = mats[16]
    b = default_rhs(A.shape[0])
    sc = dict(krylov=krylov, gmres_restart=1, tol=1e-8 if refine else 1e-6,
              refine=refine)
    x, info = tapi.solve(A, b, TCfg(**ALG), TSolve(**sc), hier=thiers[16])
    _, info_j = japi.solve(A, b, JCfg(**ALG), JSolve(**sc), hier=jhiers[16])
    assert info["iterations"] == info_j["iterations"]
    assert _true_relres(A, x, b) <= sc["tol"] * 2
    if not refine:
        k = info["iterations"] + 1
        h, hj = (np.asarray(v[:k], np.float64) for v in (info["res_hist"],
                                                           info_j["res_hist"]))
        assert np.abs(h / hj - 1).max() <= 1e-2
