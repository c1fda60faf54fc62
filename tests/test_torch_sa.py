"""Smoothed aggregation of raptor_tpu_torch (core/bell.py, setup/
aggregation.py, setup/host_aggregation.py, the block smoothers of
solve/cycle.py) against the JAX package on the CPU.

Tolerances: aggregates, strength masks, structures and level sizes exact;
values within 1e-6 relative (fp32) or 1e-12 (fp64); the block smoothers
within 1e-6; the power-iteration estimates within 1e-5 (40 rounds carry
the packages' last-bit differences); refined-solve iterations equal.

The tentative prolongator comes from a batched QR, whose free columns on
a rank-deficient aggregate (fewer dofs than candidates) differ between
LAPACK builds: P and Bc are compared entry by entry only on aggregates
whose |R_jj| all exceed QR_FLOOR; on every aggregate P @ Bc reproduces B.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
from raptor_tpu.core import bell as jbell
from raptor_tpu.core.ell import ell_from_csr as j_ell_from_csr
from raptor_tpu.setup import aggregation as jagg
from raptor_tpu.setup.host_aggregation import host_build_sa_hierarchy as j_host_sa
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.core import bell as tbell
from raptor_tpu_torch.core.ell import EllMatrix as TEll
from raptor_tpu_torch.core.ell import _np, ell_from_csr, ell_to_csr
from raptor_tpu_torch.setup import aggregation as tagg
from raptor_tpu_torch.setup.host_aggregation import host_build_sa_hierarchy as t_host_sa
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.config import PRESETS, AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.gallery import default_rhs, elasticity_3d, poisson_2d
from tests._torch_ref import rel_err

TOL = {np.float32: 1e-6, np.float64: 1e-12}
LMAX_TOL = 1e-5
QR_FLOOR = 1e-3  # |R_jj| relative to the aggregate's largest
REFINED = dict(tol=1e-8, refine=True)
SA = dict(splitting="aggregation", interp="smoothed", smoother="block_cheb",
          num_candidates=6, theta=0.08, coarse_size=16)


def _np_ell(E):
    """A JAX EllMatrix as the port's, NumPy leaves."""
    return TEll(data=np.asarray(E.data), cols=np.asarray(E.cols),
                row_nnz=np.asarray(E.row_nnz), shape=E.shape,
                n_rows_pad=E.n_rows_pad, n_cols_pad=E.n_cols_pad)


def _same_ell(te, je, tol, what=""):
    je = _np_ell(je)
    assert (te.shape, te.n_rows_pad, te.n_cols_pad) == (
        je.shape, je.n_rows_pad, je.n_cols_pad), what
    assert np.array_equal(_np(te.row_nnz), je.row_nnz), what
    m = np.arange(te.K)[:, None] < _np(te.row_nnz)[None, :]
    assert np.array_equal(np.where(m, _np(te.cols), 0),
                          np.where(m, je.cols[:te.K], 0)), what
    assert rel_err(np.where(m, _np(te.data), 0),
                   np.where(m, je.data[:te.K], 0)) <= tol, what


# ---------------------------------------------------------------------------
# BlockELL and the block smoothers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def blk():
    A, B, _ = elasticity_3d(4)
    jE = jbell.bell_from_bsr(A, bs=3, dtype=np.float64)
    tE = tbell.bell_from_bsr(A, bs=3, dtype=np.float64).to("cpu")
    rng = np.random.default_rng(2)
    n = tE.nb_pad * 3
    return dict(A=A, jE=jE, tE=tE, x=rng.standard_normal(n),
                b=rng.standard_normal(n), jinv=jbell.block_diag_inv(jE),
                tinv=tbell.block_diag_inv(tE))


def test_bell_roundtrip_and_spmv(blk):
    A, tE, jE = blk["A"], blk["tE"], blk["jE"]
    for name in ("data", "cols", "row_nnz"):
        assert np.array_equal(_np(getattr(tE, name)), np.asarray(getattr(jE, name)))
    assert (tE.shape, tE.bs, tE.nb_pad) == (jE.shape, jE.bs, jE.nb_pad)
    assert abs(tbell.bell_to_bsr(tE) - A).max() == 0
    x = blk["x"]
    y = tbell.bell_spmv(tE, torch.from_numpy(x)).numpy()
    assert rel_err(y[: A.shape[0]], A @ x[: A.shape[1]]) <= 1e-12
    assert rel_err(y, np.asarray(jbell.bell_spmv(jE, jnp.asarray(x)))) <= 1e-12
    # a (2, n) batch: each row's own product
    xs = torch.from_numpy(np.stack([x, -2 * x]))
    ys = tbell.bell_spmv(tE, xs).numpy()
    assert rel_err(ys[1], -2 * y) <= 1e-12


def test_block_diag_inv_matches_reference(blk):
    got, ref = blk["tinv"].numpy(), np.asarray(blk["jinv"])
    assert rel_err(got, ref) <= 1e-12
    nb = blk["A"].shape[0] // 3
    assert np.allclose(got[nb:], np.eye(3))  # identity padding blocks


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("kind", ["jacobi", "cheb4"])
def test_block_smoothers_match_reference(blk, kind, x0_zero):
    x = np.zeros_like(blk["x"]) if x0_zero else blk["x"]
    jE, tE = blk["jE"], blk["tE"]
    if kind == "jacobi":
        ref = jbell.block_jacobi(jE, blk["jinv"], jnp.asarray(blk["b"]),
                                 jnp.asarray(x), sweeps=2, x0_zero=x0_zero)
        got = tbell.block_jacobi(tE, blk["tinv"], torch.from_numpy(blk["b"]),
                                 torch.from_numpy(x), sweeps=2, x0_zero=x0_zero)
    else:
        ref = jbell.block_chebyshev4(jE, blk["jinv"], jnp.asarray(blk["b"]),
                                     jnp.asarray(x), 1.7, degree=3,
                                     x0_zero=x0_zero)
        got = tbell.block_chebyshev4(tE, blk["tinv"], torch.from_numpy(blk["b"]),
                                     torch.from_numpy(x), 1.7, degree=3,
                                     x0_zero=x0_zero)
    assert rel_err(got.numpy(), np.asarray(ref)) <= TOL[np.float32]


def test_estimate_lmax_bell_matches_reference(blk):
    got = float(tbell.estimate_lmax_bell(blk["tE"], blk["tinv"]))
    ref = float(jbell.estimate_lmax_bell(blk["jE"], blk["jinv"]))
    assert abs(got - ref) <= LMAX_TOL * abs(ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ell_to_bell_matches_reference(dtype):
    A, _, _ = elasticity_3d(4)
    jb = jbell.ell_to_bell(j_ell_from_csr(A, dtype=dtype, row_pad_multiple=24), 3)
    tb = tbell.ell_to_bell(ell_from_csr(A, dtype=dtype, row_pad_multiple=24), 3)
    assert tb.data.dtype == dtype and tb.nb_pad == jb.nb_pad
    for name in ("data", "cols", "row_nnz"):
        assert np.array_equal(getattr(tb, name), np.asarray(getattr(jb, name)))


# ---------------------------------------------------------------------------
# condensation, strength, aggregation, the tentative prolongator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nodal():
    """Elasticity 5^3 in fp32: both packages' ELL and nodal matrices."""
    A, B, _ = elasticity_3d(5)
    jE = j_ell_from_csr(A, dtype=np.float32, row_pad_multiple=24)
    tE = ell_from_csr(A, dtype=np.float32, row_pad_multiple=24).to("cpu")
    return dict(A=A, B=B, jE=jE, tE=tE, jC=jagg.nodal_condense(jE, 3),
                tC=tagg.nodal_condense(tE, 3))


def test_nodal_condense_matches_reference(nodal):
    tC, jC, A = nodal["tC"], nodal["jC"], nodal["A"]
    _same_ell(tC, jC, TOL[np.float32])
    nn = A.shape[0] // 3
    absA = abs(sp.csr_matrix(A))
    S = sp.csr_matrix((np.ones(A.shape[0]), (np.arange(A.shape[0]),
                                             np.arange(A.shape[0]) // 3)))
    want = (S.T @ absA @ S).toarray()
    assert rel_err(ell_to_csr(tC).toarray()[:nn, :nn], want) <= TOL[np.float32]


@pytest.mark.parametrize("theta", [0.08, 0.16])
def test_sa_strength_and_pattern_match_reference(nodal, theta):
    ts = tagg.sa_strength_mask(nodal["tC"], theta)
    js = jagg.sa_strength_mask(nodal["jC"], theta)
    assert np.array_equal(ts.numpy(), np.asarray(js))
    tG = tagg._strength_ell(nodal["tC"], ts, with_diag=True)
    jG = jagg._strength_ell(nodal["jC"], js, with_diag=True)
    _same_ell(tG, jG, 0.0)


def _agg_inputs(case, nodal):
    if case == "elasticity":
        return nodal["tC"], nodal["jC"], 0.08
    A = poisson_2d(16)
    return (ell_from_csr(A, row_pad_multiple=64).to("cpu"),
            j_ell_from_csr(A, row_pad_multiple=64), 0.25)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("case", ["elasticity", "poisson"])
def test_aggregate_matches_reference(nodal, case, seed):
    tC, jC, theta = _agg_inputs(case, nodal)
    tagg_, tn = tagg.aggregate(tC, tagg.sa_strength_mask(tC, theta), seed)
    jagg_, jn = jagg.aggregate(jC, jagg.sa_strength_mask(jC, theta), seed)
    assert tn == jn
    assert np.array_equal(tagg_.numpy(), np.asarray(jagg_))
    n = tC.shape[0]
    got = tagg_.numpy()
    assert (got[:n] >= 0).all() and got[:n].max() == tn - 1
    assert (got[n:] == -1).all()


def _tentative_pair(nodal, dtype):
    A, B = nodal["A"], nodal["B"]
    tC, jC = nodal["tC"], nodal["jC"]
    tagg_, n_agg = tagg.aggregate(tC, tagg.sa_strength_mask(tC, 0.08), 0)
    jagg_, _ = jagg.aggregate(jC, jagg.sa_strength_mask(jC, 0.08), 0)
    n_pad = nodal["tE"].n_rows_pad
    Bd = np.zeros((n_pad, 6), dtype)
    Bd[: A.shape[0]] = B
    tP, tBc, nct = tagg.tentative_prolongator(tagg_, n_agg, torch.from_numpy(Bd),
                                              3, A.shape[0])
    jP, jBc, ncj = jagg.tentative_prolongator(jagg_, n_agg, jnp.asarray(Bd), 3,
                                              A.shape[0])
    return tP, tBc.numpy(), jP, np.asarray(jBc), nct, ncj, n_agg, Bd


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tentative_prolongator_matches_reference(nodal, dtype):
    tP, tBc, jP, jBc, nct, ncj, n_agg, Bd = _tentative_pair(nodal, dtype)
    assert nct == ncj == 6 * n_agg
    assert (tP.shape, tP.n_rows_pad, tP.n_cols_pad) == (
        jP.shape, jP.n_rows_pad, jP.n_cols_pad)
    assert np.array_equal(tP.row_nnz.numpy(), np.asarray(jP.row_nnz))
    assert np.array_equal(tP.cols.numpy(), np.asarray(jP.cols))
    # P_t @ Bc == B on every aggregate (the defining SA identity)
    n = nodal["A"].shape[0]
    Pc = ell_to_csr(tP)
    assert rel_err((Pc @ tBc)[:n], Bd[:n]) <= 10 * TOL[dtype]
    # entry by entry where the QR is unique (full-rank aggregates);
    # R's diagonal is >= 0 on both sides
    R = tBc.reshape(n_agg, 6, 6)
    d = np.abs(np.diagonal(R, axis1=1, axis2=2))
    full = (d > QR_FLOOR * d.max(1, keepdims=True)).all(1)
    assert full.mean() > 0.5
    assert (np.diagonal(R, axis1=1, axis2=2) >= 0).all()
    rows = np.repeat(full, 6)
    assert rel_err(tBc[rows], jBc[rows]) <= 10 * TOL[dtype]
    col_agg = tP.cols.numpy() // 6
    ok = full[col_agg] & (np.arange(6)[:, None] < tP.row_nnz.numpy()[None, :])
    assert rel_err(np.where(ok, tP.data.numpy(), 0),
                   np.where(ok, np.asarray(jP.data), 0)) <= 10 * TOL[dtype]


@pytest.mark.parametrize("bs", [1, 3])
def test_lumped_filter_matches_reference(nodal, bs):
    got = tagg._lumped_filter(nodal["tE"], 0.1, bs)
    ref = jagg._lumped_filter(nodal["jE"], 0.1, bs)
    assert np.array_equal(got.cols.numpy(), np.asarray(ref.cols))
    assert rel_err(got.data.numpy(), np.asarray(ref.data)) <= TOL[np.float32]


# ---------------------------------------------------------------------------
# hierarchies and solves
# ---------------------------------------------------------------------------

def _levels_match(th, jh, tol):
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        a = ell_to_csr(tl.A).toarray()
        assert rel_err(a, ell_to_csr(_np_ell(jl.A)).toarray()) <= tol, i
        assert (tl.Abell is None) == (jl.Abell is None)
        if tl.Abell is not None:
            assert tl.Abell.bs == jl.Abell.bs
            assert rel_err(tl.binv.numpy(), np.asarray(jl.binv)) <= tol, i
        if tl.P is not None:
            p = ell_to_csr(tl.P).toarray()
            assert rel_err(p, ell_to_csr(_np_ell(jl.P)).toarray()) <= tol, i


@pytest.mark.parametrize("case", ["elasticity", "poisson"])
def test_host_sa_matches_reference(case):
    """The host route against the reference's host route: the same NumPy
    pipeline, so the same levels (values at fp32 rounding)."""
    if case == "elasticity":
        A, B, _ = elasticity_3d(5)
        cfg = SA
    else:
        A, B = poisson_2d(24), None
        cfg = dict(SA, smoother="chebyshev", num_candidates=1)
    th = t_host_sa(A, TCfg(**cfg), B=B).to("cpu")
    jh = j_host_sa(A, JCfg(**cfg), B=B)
    _levels_match(th, jh, TOL[np.float32])
    assert (th.levels[0].Abell is not None) == (case == "elasticity")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_sa_matches_reference(dtype):
    """The device route (threshold 0) against the reference's: level sizes
    exact, A and P within the tolerance (the QR is unique on this input's
    aggregates to well above it)."""
    A, B, _ = elasticity_3d(5)
    cfg = dict(SA, host_setup_threshold=0)
    th = tapi.setup(A, TCfg(**cfg), dtype=dtype, B=B, device="cpu")
    jh = japi.setup(A, JCfg(**cfg), dtype=dtype, B=B)
    assert isinstance(th.levels[1].A.data, torch.Tensor)
    _levels_match(th, jh, 10 * TOL[dtype])


@pytest.mark.parametrize("threshold", [0, 262144], ids=["device", "host"])
def test_config4_preset_takes_reference_iterations(threshold):
    """Config 4's preset (W-cycle, block_cheb, the folded dense tail) on
    elasticity 5^3, refined solve, both routes against the reference's."""
    A, B, _ = elasticity_3d(5)
    b = default_rhs(A.shape[0])
    cfg = dict(dataclasses.asdict(JPRESETS["config4"]),
               host_setup_threshold=threshold)
    jh = japi.setup(A, JCfg(**cfg), B=B)
    _, ji = japi.solve(A, b, JCfg(**cfg), JSolve(**REFINED), hier=jh)
    th = tapi.setup(A, TCfg(**cfg), B=B, device="cpu")
    x, ti = tapi.solve(A, b, TCfg(**cfg), TSolve(**REFINED), hier=th)
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    assert ti["iterations"] == ji["iterations"]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    assert th.a0_lo is not None  # elasticity entries are not fp32-exact
    assert PRESETS["config4"].smoother == "block_cheb"


def test_device_and_host_routes_agree():
    """The reference's own fence (tests/unit/test_aggregation.py::
    test_sa_host_matches_device): the same level sizes, iterations within
    3, on a block and a scalar problem."""
    for A, B, cfg in ((*elasticity_3d(4)[:2], SA),
                      (poisson_2d(24), None,
                       dict(SA, smoother="chebyshev", num_candidates=1))):
        b = default_rhs(A.shape[0])
        its, sizes = [], []
        for thr in (262144, 0):
            c = TCfg(**dict(cfg, host_setup_threshold=thr))
            h = tapi.setup(A, c, B=B, device="cpu")
            x, info = tapi.solve(A, b, c, TSolve(**REFINED), hier=h)
            assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-7
            its.append(info["iterations"])
            sizes.append([lv.n for lv in h.levels])
        assert sizes[0] == sizes[1]
        assert abs(its[0] - its[1]) <= 3, its


def test_block_layout_moves_and_casts():
    """Level.Abell and binv move with Hierarchy.to; the bf16 cast of the
    preconditioner hierarchy casts the block values and keeps binv."""
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic

    A, B, _ = elasticity_3d(4)
    h = t_host_sa(A, TCfg(**SA), B=B)
    assert isinstance(h.levels[0].Abell.data, np.ndarray)
    h = h.to("cpu")
    lev = h.levels[0]
    assert isinstance(lev.Abell.data, torch.Tensor) and isinstance(lev.binv, torch.Tensor)
    c = cast_hierarchy_algebraic(h, torch.bfloat16)
    assert c.levels[0].Abell.data.dtype == torch.bfloat16
    assert c.levels[0].binv.dtype == lev.binv.dtype
    x = torch.from_numpy(default_rhs(lev.A.n_rows_pad, dtype=np.float32))
    from raptor_tpu_torch.solve.cycle import apply_op
    from raptor_tpu_torch.ops.sparse_ops import spmv

    assert rel_err(apply_op(lev, x).numpy(), spmv(lev.A, x).numpy()) <= 1e-6
