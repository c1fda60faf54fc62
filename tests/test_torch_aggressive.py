"""Aggressive coarsening of raptor_tpu_torch (setup/aggressive.py, the
aggressive branches of setup/host_setup.py and setup/hierarchy.py,
``ell_add``) against the JAX package on the CPU.

Tolerances: C/F sets, P's structure and level sizes exact; P's values
within 1e-6 relative (fp32); the Galerkin operators within 1e-5 (the
SpGEMM sums in another order); refined-solve iterations equal.  Inputs:
the rotated anisotropic 2D operator of config 3 at 32^2 and 24^2, the
fp32 ELL as both packages build it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.api as japi
from raptor_tpu.setup import aggressive as jagg
from raptor_tpu.setup import host_setup as jhost
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.setup import aggressive as tagg
from raptor_tpu_torch.setup import host_setup as thost
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import PRESETS as JPRESETS
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import EllMatrix as JEll
from raptor_tpu.core.ell import ell_from_csr as j_ell_from_csr
from raptor_tpu.ops.sparse_ops import ell_add as j_ell_add
from raptor_tpu.setup.strength import strength_mask as j_strength
from raptor_tpu_torch.config import PRESETS, AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import EllMatrix as TEll
from raptor_tpu_torch.core.ell import _np, ell_from_csr, ell_to_csr
from raptor_tpu_torch.gallery import anisotropic_2d, default_rhs
from raptor_tpu_torch.ops.sparse_ops import ell_add as t_ell_add
from raptor_tpu_torch.setup.hierarchy import build_hierarchy
from raptor_tpu_torch.setup.strength import strength_mask as t_strength
from tests._torch_ref import rel_err

VAL_TOL = 1e-6
RAP_TOL = 1e-5
THETA = 0.35  # config 3's
REFINED = dict(tol=1e-8, refine=True)


def _aniso(nx):
    return anisotropic_2d(nx, epsilon=1e-3, theta=np.pi / 6)


@pytest.fixture(scope="module")
def lev():
    """Config 3's fine level at 32^2: both packages' ELL, strength masks,
    and the aggressive C/F set of each."""
    A = _aniso(32)
    jA = j_ell_from_csr(A, row_pad_multiple=64)
    tA = ell_from_csr(A, row_pad_multiple=64).to("cpu")
    js, ts = j_strength(jA, THETA), t_strength(tA, THETA)
    return dict(A=A, jA=jA, tA=tA, js=js, ts=ts,
                jcf=jagg.aggressive_splitting(jA, js, 3),
                tcf=tagg.aggressive_splitting(tA, ts, 3))


def _same_p(tP, jP, tol=VAL_TOL):
    assert (tP.shape, tP.n_rows_pad, tP.n_cols_pad) == (
        jP.shape, jP.n_rows_pad, jP.n_cols_pad)
    assert np.array_equal(_np(tP.row_nnz), np.asarray(jP.row_nnz))
    m = np.arange(tP.K)[:, None] < _np(tP.row_nnz)[None, :]
    assert np.array_equal(np.where(m, _np(tP.cols), 0),
                          np.where(m, np.asarray(jP.cols)[:tP.K], 0))
    assert rel_err(np.where(m, _np(tP.data), 0),
                   np.where(m, np.asarray(jP.data)[:tP.K], 0)) <= tol


def test_aggressive_splitting_matches_reference(lev):
    assert np.array_equal(lev["tcf"].numpy(), np.asarray(lev["jcf"]))
    n = lev["A"].shape[0]
    nc = int((lev["tcf"][:n] == 1).sum())
    assert 0 < nc < n // 4  # distance-2: far coarser than PMIS's ~n/2


def test_host_splitting_is_the_device_one(lev):
    """_np_aggressive_cf (the host route) gives the device C/F set, and the
    reference's host function the same."""
    tA = lev["tA"]
    n, n_pad = tA.shape[0], tA.n_rows_pad
    sm = lev["ts"].numpy()
    cols = tA.cols.numpy()
    got = thost._np_aggressive_cf(cols, sm, n, n_pad, 3)
    assert np.array_equal(got, lev["tcf"].numpy())
    assert np.array_equal(got, jhost._np_aggressive_cf(cols, sm, n, n_pad, 3))


def test_multipass_matches_reference(lev):
    tP, tnc = tagg.multipass_interpolation(lev["tA"], lev["ts"], lev["tcf"])
    jP, jnc = jagg.multipass_interpolation(lev["jA"], lev["js"], lev["jcf"])
    assert tnc == jnc
    _same_p(tP, jP)
    # every real F row interpolates from something after the passes
    n = lev["A"].shape[0]
    assert (tP.row_nnz[:n] > 0).float().mean() > 0.99


def test_host_multipass_matches_device(lev):
    """_np_multipass against the device multipass: the same P."""
    tA = lev["tA"]
    n = tA.shape[0]
    args = (tA.data.numpy(), tA.cols.numpy(), tA.row_nnz.numpy(),
            lev["ts"].numpy(), lev["tcf"].numpy(), n)
    Ph, nch = thost._np_multipass(*args)
    Pr, ncr = jhost._np_multipass(*args)
    tP, tnc = tagg.multipass_interpolation(lev["tA"], lev["ts"], lev["tcf"])
    assert nch == ncr == tnc
    assert abs(Ph - Pr).max() == 0  # the same NumPy code
    dev = ell_to_csr(dataclasses.replace(tP, shape=(tP.n_rows_pad, tnc)))
    assert rel_err(dev[:n].toarray(), Ph[:n].toarray()) <= VAL_TOL


@pytest.mark.parametrize("p_max", [2, 4, 6])
def test_ell_truncate_p_matches_reference(p_max):
    """Random interpolation rows of distinct magnitudes, with padding
    slots and explicit zeros."""
    rng = np.random.default_rng(p_max)
    K, n = 9, 256
    data = rng.standard_normal((K, n)).astype(np.float32)
    data[2, ::7] = 0.0
    cols = np.sort(rng.choice(64, size=(n, K), replace=True), axis=1).T
    cols = np.ascontiguousarray(cols).astype(np.int32)
    nnz = rng.integers(0, K + 1, n).astype(np.int32)
    meta = dict(shape=(n, 64), n_rows_pad=n, n_cols_pad=64)
    jP = JEll(data=jnp.asarray(data), cols=jnp.asarray(cols),
              row_nnz=jnp.asarray(nnz), **meta)
    tP = TEll(data=torch.from_numpy(data), cols=torch.from_numpy(cols),
              row_nnz=torch.from_numpy(nnz), **meta)
    got, ref = tagg.ell_truncate_p(tP, p_max), jagg.ell_truncate_p(jP, p_max)
    assert got.K == ref.K == min(p_max, K)
    _same_p(got, ref)


@pytest.mark.parametrize("passes", [1, 2])
def test_jacobi_refine_p_matches_reference(lev, passes):
    tP, _ = tagg.multipass_interpolation(lev["tA"], lev["ts"], lev["tcf"])
    jP, _ = jagg.multipass_interpolation(lev["jA"], lev["js"], lev["jcf"])
    got = tagg.jacobi_refine_p(lev["tA"], tP, lev["tcf"], 2 / 3, passes, 6)
    ref = jagg.jacobi_refine_p(lev["jA"], jP, lev["jcf"], 2 / 3, passes, 6)
    _same_p(got, ref)
    # and the host mirror (SciPy products, the same truncation rule)
    tA = lev["tA"]
    n = tA.shape[0]
    Ph, _ = thost._np_multipass(tA.data.numpy(), tA.cols.numpy(),
                                tA.row_nnz.numpy(), lev["ts"].numpy(),
                                lev["tcf"].numpy(), n)
    Ph = thost._np_jacobi_refine_p(tA.data.numpy(), tA.cols.numpy(),
                                   tA.row_nnz.numpy(), lev["tcf"].numpy(), Ph,
                                   n, 2 / 3, passes, 6)
    dev = ell_to_csr(dataclasses.replace(got, shape=(got.n_rows_pad, Ph.shape[1])))
    assert rel_err(dev[:n].toarray(), Ph[:n].toarray()) <= VAL_TOL


@pytest.mark.parametrize("scale", [(1.0, 1.0), (1.0, -1.0), (0.5, 2.0)])
def test_ell_add_matches_reference(lev, scale):
    tP, _ = tagg.multipass_interpolation(lev["tA"], lev["ts"], lev["tcf"])
    jP, _ = jagg.multipass_interpolation(lev["jA"], lev["js"], lev["jcf"])
    tQ = dataclasses.replace(tP, data=tP.data * 3.0, cols=torch.where(
        tP.slot_mask(), (tP.cols + 1) % tP.shape[1], 0).to(torch.int32))
    jQ = dataclasses.replace(jP, data=jP.data * 3.0, cols=jnp.where(
        jP.slot_mask(), (jP.cols + 1) % jP.shape[1], 0).astype(jnp.int32))
    a, b = scale
    # Q's rows may fall out of column order: the union sorts them
    got = t_ell_add(tP, tQ, alpha=a, beta=b)
    ref = j_ell_add(jP, jQ, alpha=a, beta=b)
    assert got.K == ref.K
    _same_p(got, ref)
    want = a * ell_to_csr(tP) + b * ell_to_csr(tQ)
    assert rel_err(ell_to_csr(got).toarray(), want.toarray()) <= VAL_TOL


# ---------------------------------------------------------------------------
# whole builds and solves
# ---------------------------------------------------------------------------

def _cfg(**kw):
    return dict(dataclasses.asdict(JPRESETS["config3"]), **kw)


@pytest.mark.parametrize("threshold", [0, 262144], ids=["device", "host"])
def test_config3_hierarchy_matches_reference(threshold):
    """Both routes at 24^2 against the reference's same route: level
    sizes, C/F-driven P structure, values."""
    A = _aniso(24)
    cfg = _cfg(host_setup_threshold=threshold)
    jh = japi.setup(A, JCfg(**cfg))
    th = build_hierarchy(A, TCfg(**cfg), device="cpu").to("cpu")
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for tl, jl in zip(th.levels[:-1], jh.levels[:-1]):
        a, b = ell_to_csr(tl.P), ell_to_csr(JEllView(jl.P))
        assert (a != 0).sum() == (b != 0).sum()
        assert rel_err(a.toarray(), b.toarray()) <= VAL_TOL
        assert rel_err(ell_to_csr(tl.A).toarray(),
                       ell_to_csr(JEllView(jl.A)).toarray()) <= RAP_TOL


def JEllView(E):
    """A JAX EllMatrix read as the port's (NumPy leaves)."""
    return TEll(data=np.asarray(E.data), cols=np.asarray(E.cols),
                row_nnz=np.asarray(E.row_nnz), shape=E.shape,
                n_rows_pad=E.n_rows_pad, n_cols_pad=E.n_cols_pad)


def test_device_route_is_the_host_route():
    """Config 3 at 24^2 built by the device route (threshold 0) and by the
    host route: the same level sizes and refined-solve iterations."""
    A = _aniso(24)
    b = default_rhs(A.shape[0])
    its = []
    sizes = []
    for thr in (0, 262144):
        cfg = TCfg(**_cfg(host_setup_threshold=thr))
        h = tapi.setup(A, cfg, device="cpu")
        _, info = tapi.solve(A, b, cfg, TSolve(**REFINED), hier=h)
        sizes.append([lv.n for lv in h.levels])
        its.append(info["iterations"])
    assert sizes[0] == sizes[1]
    assert its[0] == its[1]


@pytest.mark.parametrize("threshold", [0, 262144], ids=["device", "host"])
def test_config3_preset_takes_reference_iterations(threshold):
    """Config 3's preset at 32^2 (the reference CI size), refined solve."""
    A = _aniso(32)
    b = default_rhs(A.shape[0])
    cfg = _cfg(host_setup_threshold=threshold)
    jh = japi.setup(A, JCfg(**cfg))
    _, ji = japi.solve(A, b, JCfg(**cfg), JSolve(**REFINED), hier=jh)
    th = tapi.setup(A, TCfg(**cfg), device="cpu")
    x, ti = tapi.solve(A, b, TCfg(**cfg), TSolve(**REFINED), hier=th)
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    assert ti["iterations"] == ji["iterations"]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    if threshold:
        assert PRESETS["config3"] == TCfg(**dataclasses.asdict(JPRESETS["config3"]))


def test_config3_ci_case_fp64():
    """The reference's CI case (tests/integration/test_configs.py::
    test_config3_aggressive_coarsening): aggressive + Jacobi, fp64 PCG."""
    A = _aniso(32)
    b = default_rhs(A.shape[0])
    cfg = dict(splitting="pmis", theta=THETA, aggressive=True, smoother="jacobi")
    sc = dict(dtype="float64", maxiter=300)
    _, ji = japi.solve(A, b, JCfg(**cfg), JSolve(**sc))
    x, ti = tapi.solve(A, b, TCfg(**cfg), TSolve(**sc), device="cpu")
    assert ti["iterations"] == ji["iterations"] <= 50
    assert ti["stats"]["operator_complexity"] <= 1.4
    assert ti["relres"] <= 1e-8


def test_banded_aggressive_device_level_is_repaired():
    """A difference from the reference, a repair: with the banded layout
    (row identities passed as ``row_ids``) and an aggressive level on the
    device route, the reference leaves the identities unfiltered and its
    host tail fails to index them; the port filters them by the level's C
    points and builds and solves."""
    from tests._torch_ref import shuffled_poisson

    A = shuffled_poisson(12)
    cfg = dict(splitting="pmis", aggressive=True, smoother="cheb4",
               fine_layout="banded", host_setup_threshold=1000)
    with pytest.raises(IndexError):
        japi.setup(A, JCfg(**cfg))
    b = default_rhs(A.shape[0])
    x, info = tapi.solve(A, b, TCfg(**cfg), TSolve(**REFINED), device="cpu")
    assert info["stats"]["sizes"][0] == A.shape[0] > info["stats"]["sizes"][1]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
