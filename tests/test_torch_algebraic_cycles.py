"""The port's algebraic engine against the JAX package on the CPU, the
cases that build their own inputs (split from tests/test_torch_algebraic.py
by the module fixtures they use, so the two files run on two workers):

* the ELL format and the plane-mode routing statistics;
* setups built once each: extended and classical interpolation on the ELL
  layout, RS splitting on preset config1's 2D 5-point 64^2, the pi-scaled
  fp32 remainder (tests/_torch_alg_check.py's comparisons);
* one cycle on the shuffled 16^3 hierarchy carried over from JAX as numpy
  (without the folded tail), for jacobi, chebyshev and cheb4, V and W,
  without and with the folded tail: within 1e-5 * max|y| (the JAX cycles
  run op by op, ``jax.disable_jit``);
* the configurations ported after the first slices (fat-level refinement,
  smoothed aggregation, mcgs, aggressive, CLJP) and BiCGStab and (F)GMRES
  inside the refined solve.
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
from tests._torch_alg_check import ALG, DENSE_TOL, _ell_same, _same_hierarchy
from tests._torch_ref import (algebraic_tree_from_jax, np32, rel_err,
                              shuffled_poisson)

CYCLE_TOL = 1e-5


@pytest.fixture(scope="module")
def jh16_notail():
    """Shuffled 16^3 without the folded tail: level 1 (2048 rows) keeps its
    banded layout in the cycle."""
    return japi.setup(shuffled_poisson(16), JCfg(**ALG, tail_max_n=0))


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
# setups built once each
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("interp", ["extended", "classical"])
def test_ell_setup_distance_two_interp_matches_reference(interp):
    A = shuffled_poisson(16)
    cfg = dict(splitting="pmis", interp=interp, smoother="cheb4")
    _same_hierarchy(tapi.setup(A, TCfg(**cfg), device="cpu"),
                    japi.setup(A, JCfg(**cfg)))


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
# configurations whose modules were ported after the first slices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    "device_levels", "aggregation", "mcgs", "aggressive", "cljp"])
def test_formerly_unported_configurations_solve(case):
    """The configurations that raised before their modules were ported
    (fat-level refinement on a device level, smoothed aggregation, mcgs,
    aggressive coarsening, CLJP) build and reach a true 1e-8 through the
    refined solve, with the reference's level sizes and iteration count."""
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
    elif case == "cljp":
        cfg = dict(cfg, splitting="cljp")
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
