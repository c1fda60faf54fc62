"""The multicolor and two-stage Gauss-Seidel smoothers of raptor_tpu_torch
(solve/smoothers.py, the colouring of setup/hierarchy.py and
setup/host_setup.py, the mcgs/tsgs branches of solve/cycle.py) against the
JAX package on the CPU.

Tolerances: colours exact (the native kernel and the Python loop give the
reference's array); smoother outputs within 1e-6 relative in fp32; one
V-cycle within 1e-5 (tests/test_torch_algebraic.py's CYCLE_TOL), on the ELL
layout and on the banded one (the reference's K4 in interpret mode); level
sizes exact and refined-solve iterations equal for the config-2 preset at
16^3 and the config-5 preset at 12^3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
from raptor_tpu.solve import smoothers as jsm
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.solve import smoothers as tsm
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import ell_from_csr as j_ell_from_csr
from raptor_tpu.solve.cycle import cycle as jcycle
from raptor_tpu_torch.config import PRESETS, AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.gallery import (anisotropic_2d, default_rhs, poisson_2d,
                                      poisson_3d)
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from raptor_tpu_torch.solve.cycle import cycle as tcycle
from raptor_tpu_torch.utils.native import greedy_coloring_native
from tests._torch_ref import algebraic_tree_from_jax, rel_err, shuffled_poisson

SMOOTH_TOL = 1e-6
CYCLE_TOL = 1e-5
REFINED = dict(tol=1e-8, refine=True)


def _graph(name):
    """The symmetric graph the setup colours: (a + a.T) != 0, diagonal
    included."""
    if name == "poisson3d":
        a = poisson_3d(6)
    elif name == "shuffled":
        a = shuffled_poisson(6)
    elif name == "aniso":
        a = anisotropic_2d(12, epsilon=1e-3, theta=np.pi / 6)
    else:  # random nonsymmetric pattern
        a = sp.random(300, 300, density=0.03, random_state=1, format="csr")
        a = a + sp.eye(300)
    a = sp.csr_matrix(a)
    return ((a + a.T) != 0).tocsr()


@pytest.mark.parametrize("form", ["native", "python"])
@pytest.mark.parametrize("name", ["poisson3d", "shuffled", "aniso", "random"])
def test_coloring_matches_reference(name, form):
    g = _graph(name)
    n = g.shape[0]
    if form == "native":
        got = greedy_coloring_native(g.indptr, g.indices, n)
        assert got is not None, "the native library did not build"
    else:
        got = tsm._greedy_coloring_py(g.indptr, g.indices, n)
    ref = jsm.greedy_coloring_host(g.indptr, g.indices, n)
    assert got[1] == ref[1]
    assert np.array_equal(got[0], np.asarray(ref[0]))
    # a proper colouring
    rows = np.repeat(np.arange(n), np.diff(g.indptr))
    off = rows != g.indices
    assert not (got[0][rows[off]] == got[0][g.indices[off]]).any()
    if name == "poisson3d":
        assert got[1] == 2  # red-black on a bipartite stencil graph


@pytest.mark.parametrize("route", ["device", "host"])
def test_level_colours_match_reference(route):
    """A level's colours as both setup routes give them: the padding rows
    colour 0, the rest the reference's."""
    from raptor_tpu.setup.hierarchy import _mcgs_color as j_color
    from raptor_tpu_torch.setup.hierarchy import _mcgs_color as t_color
    from raptor_tpu_torch.setup.host_setup import _host_level_aux

    A = shuffled_poisson(7)
    cfg = dict(smoother="mcgs")
    jE = j_ell_from_csr(A, row_pad_multiple=64)
    tE = ell_from_csr(A, row_pad_multiple=64)
    ref, nref = j_color(jE, JCfg(**cfg))
    if route == "device":
        got, ncol = t_color(tE.to("cpu"), TCfg(**cfg))
        got = got.numpy()
    else:
        _, got, ncol, _ = _host_level_aux(tE, tE.data, tE.cols, tE.row_nnz,
                                          TCfg(**cfg))
    assert ncol == nref
    assert np.array_equal(got, np.asarray(ref))
    assert (got[A.shape[0]:] == 0).all() and tE.n_rows_pad > A.shape[0]


# ---------------------------------------------------------------------------
# the smoothers on identical inputs (fp32)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def op():
    """Shuffled 8^3 with 64-row padding, its colours, a rhs and a start."""
    A = shuffled_poisson(8)
    jE = j_ell_from_csr(A, row_pad_multiple=64)
    tE = ell_from_csr(A, row_pad_multiple=64).to("cpu")
    g = ((A + A.T) != 0).tocsr()
    col, ncol = tsm.greedy_coloring_host(g.indptr, g.indices, A.shape[0])
    color = np.zeros(tE.n_rows_pad, np.int32)
    color[: A.shape[0]] = col
    rng = np.random.default_rng(4)
    b = rng.standard_normal(tE.n_rows_pad).astype(np.float32)
    x = rng.standard_normal(tE.n_rows_pad).astype(np.float32)
    dinv = (1.0 / np.asarray(jE.diagonal())).astype(np.float32)
    return dict(jE=jE, tE=tE, color=color, ncol=ncol, b=b, x=x, dinv=dinv)


def _args(op, jax_side: bool):
    if jax_side:
        return op["jE"], jnp.asarray(op["dinv"]), jnp.asarray(op["b"])
    return op["tE"], torch.from_numpy(op["dinv"]), torch.from_numpy(op["b"])


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sweeps", [1, 2])
def test_multicolor_gs_matches_reference(op, sweeps, backward, x0_zero):
    x = np.zeros_like(op["x"]) if x0_zero else op["x"]
    jE, jd, jb = _args(op, True)
    tE, td, tb = _args(op, False)
    kw = dict(ncolors=op["ncol"], sweeps=sweeps, backward=backward,
              x0_zero=x0_zero)
    ref = jsm.multicolor_gs(jE, jd, jb, jnp.asarray(x), jnp.asarray(op["color"]),
                            **kw)
    got = tsm.multicolor_gs(tE, td, tb, torch.from_numpy(x),
                            torch.from_numpy(op["color"]), **kw)
    assert rel_err(got.numpy(), np.asarray(ref)) <= SMOOTH_TOL
    if x0_zero:  # the elided first apply: the same as from an explicit zero
        full = tsm.multicolor_gs(tE, td, tb, torch.from_numpy(x),
                                 torch.from_numpy(op["color"]),
                                 **dict(kw, x0_zero=False))
        assert rel_err(got.numpy(), full.numpy()) <= SMOOTH_TOL


@pytest.mark.parametrize("col_bound", [None, 300])
@pytest.mark.parametrize("upper", [False, True])
def test_triangular_apply_matches_reference(op, upper, col_bound):
    ref = jsm.triangular_apply(op["jE"], jnp.asarray(op["x"]), upper=upper,
                               col_bound=col_bound)
    got = tsm.triangular_apply(op["tE"], torch.from_numpy(op["x"]),
                               upper=upper, col_bound=col_bound)
    assert rel_err(got.numpy(), np.asarray(ref)) <= SMOOTH_TOL
    # against the strict triangle of the matrix itself
    A = shuffled_poisson(8)
    T = (sp.triu(A, 1) if upper else sp.tril(A, -1)).tocsr()
    if col_bound is not None:
        T = T[:, :col_bound]
    xv = op["x"][: T.shape[1]].astype(np.float64)
    assert rel_err(got.numpy()[:512], T @ xv) <= SMOOTH_TOL


@pytest.mark.parametrize("x0_zero", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("inner", [0, 2])
def test_two_stage_gs_matches_reference(op, inner, backward, x0_zero):
    x = np.zeros_like(op["x"]) if x0_zero else op["x"]
    jE, jd, jb = _args(op, True)
    tE, td, tb = _args(op, False)
    kw = dict(sweeps=2, inner=inner, backward=backward, x0_zero=x0_zero)
    ref = jsm.two_stage_gs(jE, jd, jb, jnp.asarray(x), **kw)
    got = tsm.two_stage_gs(tE, td, tb, torch.from_numpy(x), **kw)
    assert rel_err(got.numpy(), np.asarray(ref)) <= SMOOTH_TOL


def test_smoothers_take_a_batch(op):
    """A (B, n) batch (the folded tail's identity columns) gives each
    row's own result."""
    tE, td, tb = _args(op, False)
    xs = torch.stack([torch.from_numpy(op["x"]), 2 * torch.from_numpy(op["x"])])
    bs = torch.stack([tb, -tb])
    color = torch.from_numpy(op["color"])
    for fn, kw in ((tsm.multicolor_gs, dict(color=color, ncolors=op["ncol"])),
                   (tsm.two_stage_gs, dict(inner=2))):
        batch = fn(tE, td, bs, xs, **kw, sweeps=2, backward=True)
        for i in range(2):
            one = fn(tE, td, bs[i], xs[i], **kw, sweeps=2, backward=True)
            assert torch.allclose(batch[i], one, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one V-cycle, ELL and banded layouts
# ---------------------------------------------------------------------------

def _jax_hier(smoother, layout):
    cfg = dict(splitting="pmis", interp="direct", smoother=smoother,
               tail_max_n=0, fine_layout=layout)
    return japi.setup(shuffled_poisson(16), JCfg(**cfg))


@pytest.mark.parametrize("layout", ["ell", "banded"])
@pytest.mark.parametrize("smoother", ["mcgs", "tsgs"])
def test_cycle_matches_reference(smoother, layout):
    jh = _jax_hier(smoother, layout)
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(jh), "cpu")
    lev0 = th.levels[0]
    assert (lev0.Aband is not None) == (layout == "banded")
    if smoother == "mcgs":
        assert lev0.color is not None and lev0.ncolors == jh.levels[0].ncolors
    b = default_rhs(jh.levels[0].A.n_rows_pad, dtype=np.float32)
    with jax.disable_jit():
        y_j = np.asarray(jcycle(jh, jnp.asarray(b)))
    y_t = tcycle(th, torch.from_numpy(b)).numpy()
    assert rel_err(y_t, y_j) <= CYCLE_TOL


@pytest.mark.parametrize("smoother", ["mcgs", "tsgs"])
def test_port_setup_matches_carried(smoother):
    """The port's own mcgs/tsgs setup on the banded path: colours follow
    the RCM ordering of each level (colouring runs after the reorder), and
    equal the carried reference hierarchy's."""
    jh = _jax_hier(smoother, "banded")
    cfg = dict(splitting="pmis", interp="direct", smoother=smoother,
               tail_max_n=0, fine_layout="banded")
    th = tapi.setup(shuffled_poisson(16), TCfg(**cfg), device="cpu")
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for tl, jl in zip(th.levels, jh.levels):
        assert tl.ncolors == jl.ncolors
        assert (tl.color is None) == (jl.color is None)
        if tl.color is not None:
            assert np.array_equal(tl.color.numpy(), np.asarray(jl.color))


# ---------------------------------------------------------------------------
# solves: the presets
# ---------------------------------------------------------------------------

def _solve_both(A, cfg_t, cfg_j, sc=REFINED):
    b = default_rhs(A.shape[0])
    jh = japi.setup(A, cfg_j)
    _, ji = japi.solve(A, b, cfg_j, JSolve(**sc), hier=jh)
    th = tapi.setup(A, cfg_t, device="cpu")
    x, ti = tapi.solve(A, b, cfg_t, TSolve(**sc), hier=th)
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    assert ti["iterations"] == ji["iterations"]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    return ti


@pytest.mark.parametrize("preset,nx", [("config2", 16), ("config5", 12)])
def test_preset_takes_reference_iterations(preset, nx):
    """The mcgs presets (PMIS, extended interpolation) in the refined
    solve."""
    info = _solve_both(poisson_3d(nx), PRESETS[preset], JPRESETS[preset])
    assert info["iterations"] <= 15


def test_config2_ci_case_fp64():
    """The reference's CI case of config 2 (tests/integration/
    test_configs.py::test_config2_pmis_mcgs_pcg): 16^3, PMIS + mcgs, fp64
    PCG."""
    cfg = dict(splitting="pmis", smoother="mcgs")
    info = _solve_both(poisson_3d(16), TCfg(**cfg), JCfg(**cfg),
                       sc=dict(dtype="float64"))
    assert info["iterations"] <= 15


@pytest.mark.parametrize("threshold", [262144, 1000])
def test_tsgs_solve_takes_reference_iterations(threshold):
    """tsgs on the host route and with level 0 on the device route."""
    cfg = dict(dataclasses.asdict(JPRESETS["config2"]), smoother="tsgs",
               host_setup_threshold=threshold)
    _solve_both(poisson_3d(12), TCfg(**cfg), JCfg(**cfg))


def test_mcgs_device_route_takes_reference_iterations():
    """config 2 with levels 0-1 on the device route (coloured on the
    host)."""
    cfg = dict(dataclasses.asdict(JPRESETS["config2"]), host_setup_threshold=200)
    _solve_both(poisson_2d(32), TCfg(**cfg), JCfg(**cfg))
