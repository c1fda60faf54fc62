"""The port's algebraic engine (``raptor_tpu_torch.api``: host setup,
RCM-banded layouts, cycles, PCG and the df64-refined solve) against the JAX
package on the CPU.

* setup of shuffled 16^3 and 20^3 Poisson through ``api.setup`` with the
  reference bench's banded configuration: level sizes, RCM permutation, ELL
  structure and banded plans equal; values, dinv and cheb_lmax within 1e-6
  relative (the same NumPy code, another fp32 evaluation order at most);
  the dense coarse inverse and the folded tail within 1e-5 (a dense fp32
  inverse amplifies differences by the coarse operator's condition number);
  also extended and classical interpolation on the ELL layout, and RS
  splitting on the 2D 5-point 64^2 problem of preset config1;
* one cycle on the hierarchy carried over from JAX as numpy, for jacobi,
  chebyshev and cheb4, V and W, without and with the folded tail: within
  1e-5 * max|y|;
* solves: the refined solve takes JAX's iteration counts (7 at 16^3, 8 at
  20^3) to a true fp64 relres <= 1e-8; host refinement and the plain PCG
  route; the ELL and banded layouts give the same sizes and iterations;
* the configurations that are not ported yet raise.

The JAX hierarchies are built once per module; the JAX cycles run op by op
(``jax.disable_jit``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
import raptor_tpu_torch.api as tapi
from raptor_tpu.solve.cycle import cycle as jcycle
from raptor_tpu.solve.cycle import materialize_tail as jtail
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.config import PRESETS, AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.gallery import default_rhs, poisson_2d, poisson_3d
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from raptor_tpu_torch.solve.cycle import cycle as tcycle
from raptor_tpu_torch.solve.cycle import materialize_tail as ttail
from tests._torch_ref import (algebraic_tree_from_jax, np32, rel_err,
                              shuffled_poisson)

ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)
VAL_TOL = 1e-6
DENSE_TOL = 1e-5
CYCLE_TOL = 1e-5
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


@pytest.fixture(scope="module")
def jh16_notail(mats):
    """16^3 without the folded tail: level 1 (2048 rows) keeps its banded
    layout in the cycle."""
    return japi.setup(mats[16], JCfg(**ALG, tail_max_n=0))


def _ell_same(te, je, what):
    assert (te is None) == (je is None), what
    if te is None:
        return
    assert (te.shape, te.n_rows_pad, te.n_cols_pad) == (
        je.shape, je.n_rows_pad, je.n_cols_pad), what
    assert np.array_equal(te.cols.numpy(), np.asarray(je.cols)), what
    assert np.array_equal(te.row_nnz.numpy(), np.asarray(je.row_nnz)), what
    assert rel_err(np32(te.data), np32(je.data)) <= VAL_TOL, what


def _band_same(tb, jb, what):
    assert (tb is None) == (jb is None), what
    if tb is None:
        return
    assert (tb.meta, tb.shape, tb.slot_ranges) == (
        jb.meta, jb.shape, jb.slot_ranges), what
    assert (tb.far is None) == (jb.far is None), what
    assert np.array_equal(tb.pidx.numpy(), np.asarray(jb.pidx)), what
    assert rel_err(np32(tb.vals), np32(jb.vals)) <= VAL_TOL, what
    if hasattr(jb, "perm"):
        assert tb.reordered == jb.reordered, what
        assert np.array_equal(tb.perm.numpy(), np.asarray(jb.perm)), what


def _same_hierarchy(th, jh):
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for name in ("perm", "iperm"):
        t, j = getattr(th, name), getattr(jh, name)
        assert (t is None) == (j is None)
        if t is not None:
            assert np.array_equal(t.numpy(), np.asarray(j)), name
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        for name in ("A", "P", "R"):
            _ell_same(getattr(tl, name), getattr(jl, name), f"L{i} {name}")
        for name in ("Aband", "Pband", "Rband"):
            _band_same(getattr(tl, name), getattr(jl, name), f"L{i} {name}")
        assert rel_err(np32(tl.dinv), np32(jl.dinv)) <= VAL_TOL, f"L{i} dinv"
        assert (tl.cheb_lmax is None) == (jl.cheb_lmax is None)
        if tl.cheb_lmax is not None:
            assert rel_err(np32(tl.cheb_lmax), np32(jl.cheb_lmax)) <= VAL_TOL
    assert rel_err(np32(th.coarse_inv), np32(jh.coarse_inv)) <= DENSE_TOL
    assert th.tail_start == jh.tail_start
    assert (th.tail_op is None) == (jh.tail_op is None)
    if th.tail_op is not None:
        assert rel_err(np32(th.tail_op), np32(jh.tail_op)) <= DENSE_TOL
    for name in ("a0_lo", "a0_lo_band"):
        t, j = getattr(th, name), getattr(jh, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert np.array_equal(t.numpy(), np.asarray(j)), name


# ---------------------------------------------------------------------------
# ELL format and layout routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["square", "square_1024", "rect"])
def test_ell_matches_reference(kind):
    import raptor_tpu.core.ell as jell
    import raptor_tpu_torch.core.ell as tell

    A = shuffled_poisson(10)
    kw = dict(row_pad_multiple=1024) if kind == "square_1024" else {}
    if kind == "rect":
        A = A[:, ::3]
        kw = dict(identity_pad_rows=False)
    te, je = tell.ell_from_csr(A, **kw), jell.ell_from_csr(A, **kw)
    _ell_same(te.to("cpu"), je, kind)
    assert te.data.dtype == np.float32 and te.cols.dtype == np.int32
    for E in (te, te.to("cpu")):  # NumPy leaves and tensor leaves
        assert E.nnz == int(je.nnz)  # identity padding rows included
        assert np.array_equal(np.asarray(E.slot_mask()), np.asarray(je.slot_mask()))
        assert np.array_equal(np.asarray(E.row_index()), np.asarray(je.row_index()))
        if kind != "rect":
            assert np.array_equal(np.asarray(E.diagonal()), np.asarray(je.diagonal()))
        assert (tell.ell_to_csr(E) != A).nnz == 0


@pytest.mark.parametrize("shuffled", [False, True])
def test_plane_stats_match_reference(shuffled):
    """The statistics that route a banded setup to plane mode (natural
    grid ordering) or to RCM (shuffled)."""
    import raptor_tpu.core.ell as jell
    import raptor_tpu_torch.core.ell as tell

    A = shuffled_poisson(12) if shuffled else sp.csr_matrix(poisson_3d(12))
    coo = A.tocoo()
    deltas = coo.col.astype(np.int64) - coo.row
    got = tapi._plane_stats(deltas, A.shape[0])
    assert got == japi._plane_stats(deltas, A.shape[0])
    assert (got[0] >= 0.9 and got[1] >= 0.5) == (not shuffled)
    assert (tapi._plane_stats_ell(tell.ell_from_csr(A))
            == japi._plane_stats_ell(jell.ell_from_csr(A, device=False)))


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", [16, 20])
def test_banded_setup_matches_reference(jhiers, thiers, nx):
    th, jh = thiers[nx], jhiers[nx]
    assert th.levels[0].Aband is not None and th.levels[0].Rband is not None
    _same_hierarchy(th, jh)


@pytest.mark.parametrize("interp", ["extended", "classical"])
def test_ell_setup_distance_two_interp_matches_reference(mats, interp):
    cfg = dict(splitting="pmis", interp=interp, smoother="cheb4")
    _same_hierarchy(tapi.setup(mats[16], TCfg(**cfg), device="cpu"),
                    japi.setup(mats[16], JCfg(**cfg)))


def test_rs_setup_matches_reference():
    """Preset config1: RS splitting, Jacobi, 2D 5-point 64^2."""
    A = poisson_2d(64)
    th = tapi.setup(A, PRESETS["config1"], device="cpu")
    _same_hierarchy(th, japi.setup(A, JCfg(splitting="rs", smoother="jacobi")))
    assert len(th.levels) > 2


def test_fp32_remainder_matches_reference():
    """pi-scaled 16^3: attach_residual_lo's a0_lo and its banded layout."""
    A = shuffled_poisson(16, scale=np.pi)
    th = tapi.setup(A, TCfg(**ALG), device="cpu")
    jh = japi.setup(A, JCfg(**ALG))
    assert th.a0_lo is not None and th.a0_lo_band is not None
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
# cycles
# ---------------------------------------------------------------------------

SMOOTHERS = ["jacobi", "chebyshev", "cheb4"]


@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("cyc", ["V", "W"])
@pytest.mark.parametrize("smoother", SMOOTHERS)
def test_cycle_matches_reference(jh16_notail, smoother, cyc, tail):
    jh = jh16_notail
    assert jh.tail_op is None and jh.levels[1].Aband is not None
    jcfg = dataclasses.replace(jh.config, smoother=smoother, cycle=cyc)
    tcfg = TCfg(**dataclasses.asdict(jcfg))
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(jh), "cpu")
    th = dataclasses.replace(th, config=tcfg)
    jh = dataclasses.replace(jh, config=jcfg)
    if tail:
        jh = jtail(jh, 4096)
        th = ttail(th, 4096)
        assert th.tail_start == jh.tail_start == 1
        assert rel_err(np32(th.tail_op), np32(jh.tail_op)) <= DENSE_TOL
    b = default_rhs(jh.levels[0].A.n_rows_pad, dtype=np.float32)
    with jax.disable_jit():
        y_j = np.asarray(jcycle(jh, jnp.asarray(b)))
    y_t = tcycle(th, torch.from_numpy(b)).numpy()
    assert rel_err(y_t, y_j) <= CYCLE_TOL


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


# ---------------------------------------------------------------------------
# what is not ported yet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cljp"])
def test_not_yet_ported_raises(case):
    A = shuffled_poisson(8)
    cfg = dict(splitting="cljp", smoother="cheb4")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tapi.setup(A, TCfg(**cfg), device="cpu")


@pytest.mark.parametrize("case", [
    "device_levels", "aggregation", "mcgs", "aggressive"])
def test_formerly_unported_configurations_solve(case):
    """The configurations that raised before their modules were ported
    (fat-level refinement on a device level, smoothed aggregation, mcgs,
    aggressive coarsening) build and reach a true 1e-8 through the refined
    solve, with the reference's level sizes and iteration count."""
    A = shuffled_poisson(8)
    cfg = dict(splitting="pmis", smoother="cheb4")
    if case == "device_levels":
        # level 1 is wider than EXT_DEVICE_MAX_K
        cfg = dict(cfg, host_setup_threshold=100, interp="extended",
                   fat_interp_refine=1)
    elif case == "aggregation":
        cfg = dict(cfg, splitting="aggregation", interp="smoothed")
    elif case == "mcgs":
        cfg = dict(cfg, smoother="mcgs")
    elif case == "aggressive":
        cfg = dict(cfg, aggressive=True)
    b = default_rhs(A.shape[0])
    sc = dict(tol=1e-8, refine=True)
    jh = japi.setup(A, JCfg(**cfg))
    _, ji = japi.solve(A, b, JCfg(**cfg), JSolve(**sc), hier=jh)
    th = tapi.setup(A, TCfg(**cfg), device="cpu")
    x, ti = tapi.solve(A, b, TCfg(**cfg), TSolve(**sc), hier=th)
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    assert ti["iterations"] == ji["iterations"]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8


@pytest.mark.parametrize("krylov", ["bicgstab", "gmres", "fgmres"])
def test_refined_solve_with_other_krylov(krylov):
    """BiCGStab and (F)GMRES inside the df64-refined solve (they raised
    before they were ported): the true fp64 relres reaches 1e-8."""
    A = shuffled_poisson(8)
    b = np.ones(A.shape[0])
    cfg = TCfg(splitting="pmis", smoother="cheb4", cheb_degree=2)
    x, info = tapi.solve(A, b, cfg, TSolve(krylov=krylov, refine=True),
                         device="cpu")
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    assert 0 < info["iterations"] <= 40


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
