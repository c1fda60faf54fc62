"""The port's device geo chain (``_geo_plans``, ``_geo_chain`` and the geo
branch of ``build_hierarchy``'s device route) against the JAX package's,
on the CPU.

Inputs are natural-ordered grid operators given as scipy CSR (the alg128
row's configuration: PMIS, extended, ``fine_layout='banded'``, cheb4
degree 3; the tail folded from 1024 rows to keep the CPU time down).
``_geo_plans`` exact; ``_geo_chain`` on natural 16^3 with every level on
the device: P, R, Ac, dinv, wm, wp, the planes and their masses within
1e-6 relative in fp32, structure exact, the Gershgorin lmax within the
same; the whole device-built geo hierarchy against JAX's
(16^3 and 12x10x8, both parities of the coarsened extents) with the same
tolerances and the reference's level sizes [4096 ... 64]; the port's
device-built against its host-built geo hierarchy (A within 1e-5, P within
1e-6: the reference's ``tests/unit/test_geo_split.py:79-95``); the
refined solve's iterations equal to JAX's.

Two differences from the reference, by design: a non-zero RAP width
overflow (``leftover``) raises, and the coarsest level keeps the chain's
planes when the loop ends right after a chain.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
import raptor_tpu_torch.api as tapi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import EllMatrix as JEll
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import _np, ell_from_csr, ell_to_csr
from raptor_tpu_torch.core.hybrid import hybrid_spmv
from raptor_tpu_torch.gallery import poisson_3d
from raptor_tpu_torch.ops.sparse_ops import spmv
from tests._torch_ref import rel_err
from tests.test_torch_devsetup import _same_ell

# the packages' ``setup`` functions shadow their ``setup`` subpackages
jhier = importlib.import_module("raptor_tpu.setup.hierarchy")
thier = importlib.import_module("raptor_tpu_torch.setup.hierarchy")

GEO = dict(splitting="pmis", interp="extended", fine_layout="banded",
           smoother="cheb4", cheb_degree=3, tail_max_n=1024)
TOL = {np.float32: 1e-6}
MATS = {"3d16": (16, 16, 16), "3d12x10x8": (12, 10, 8)}
SIZES16 = [4096, 2048, 1024, 512, 256, 128, 64]  # the reference's
REFINED = dict(tol=1e-8, refine=True)


def _csr(name):
    return sp.csr_matrix(poisson_3d(*MATS[name]))


@pytest.fixture(scope="module")
def builds():
    """builds(name, side, threshold): api.setup of a natural-ordered grid
    by the JAX package ("jax") or the port on the CPU ("torch")."""
    cache = {}

    def get(name, side, threshold=0):
        key = (name, side, threshold)
        if key not in cache:
            cfg = dict(GEO, host_setup_threshold=threshold)
            cache[key] = (japi.setup(_csr(name), JCfg(**cfg)) if side == "jax"
                          else tapi.setup(_csr(name), TCfg(**cfg), device="cpu"))
        return cache[key]

    return get


@pytest.mark.parametrize("exts,nlev,pad", [
    ((16, 16, 16), 6, 1024), ((12, 10, 8), 5, 8), ((64, 64, 1), 8, 1024)])
def test_geo_plans_match_reference(exts, nlev, pad):
    n = int(np.prod(exts))
    n_pad = -(-n // pad) * pad
    tp, te = thier._geo_plans(n, n_pad, 7, list(exts), nlev, pad)
    jp, je = jhier._geo_plans(n, n_pad, 7, list(exts), nlev, pad)
    assert tp == jp and te == je


def _chain_input(dtype):
    """Natural 16^3 as the banded path gives it to the chain: rows padded
    to 1024 (none here: 4096 rows), its plans and plane offsets."""
    E = ell_from_csr(_csr("3d16"), dtype=dtype, row_pad_multiple=1024)
    plans, _ = thier._geo_plans(4096, E.n_rows_pad, E.K, [16, 16, 16], 6, 1024)
    offsets0 = (-256, -16, -1, 0, 1, 16, 256)
    jA = JEll(data=jnp.asarray(E.data), cols=jnp.asarray(E.cols),
              row_nnz=jnp.asarray(E.row_nnz), shape=E.shape,
              n_rows_pad=E.n_rows_pad, n_cols_pad=E.n_cols_pad)
    return E.to("cpu"), jA, plans, offsets0


def test_geo_chain_matches_reference():
    dtype = np.float32
    tA, jA, plans, offsets0 = _chain_input(dtype)
    kw = dict(theta=0.25, strength_kind="classical", want_lmax=True,
              filter_tol=0.0, offsets0=offsets0)
    t_outs, t_last, t_planes, t_nw = thier._geo_chain(tA, plans=plans, **kw)
    j_outs, j_last, j_planes, j_nw = jhier._geo_chain(
        jA, plans=tuple(tuple(sorted(p.items())) for p in plans), **kw)
    tol = TOL[dtype]
    assert np.array_equal(t_nw.numpy(), np.asarray(j_nw))
    assert len(t_outs) == len(j_outs) == 6
    for li, (to, jo) in enumerate(zip(t_outs, j_outs)):
        for name in ("P", "R", "Ac"):
            _same_ell(to[name], jo[name], tol, f"L{li} {name}")
        for name in ("dinv", "lmax", "wm", "wp", "planes", "pmass"):
            assert rel_err(_np(to[name]), np.asarray(jo[name])) <= tol, (li, name)
        assert to["P"].data.dtype == tA.data.dtype
        assert int(to["leftover"]) == 0
    _same_ell(t_last, j_last, tol, "last Ac")
    assert rel_err(t_planes.numpy(), np.asarray(j_planes)) <= tol


@pytest.mark.parametrize("name", list(MATS))
def test_geo_device_build_matches_reference(builds, name):
    th, jh = builds(name, "torch"), builds(name, "jax")
    sizes = [lv.n for lv in th.levels]
    assert sizes == [lv.n for lv in jh.levels]
    if name == "3d16":
        assert sizes == SIZES16
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        for f in ("A", "P", "R"):
            _same_ell(getattr(tl, f), getattr(jl, f), TOL[np.float32], f"L{i} {f}")
        assert rel_err(_np(tl.dinv), np.asarray(jl.dinv)) <= TOL[np.float32]
        assert (tl.Tgeo is None) == (jl.Tgeo is None), i
        if tl.Tgeo is not None:
            assert tl.Tgeo.meta == jl.Tgeo.meta
            for w in ("wm", "wp"):
                assert rel_err(_np(getattr(tl.Tgeo, w)),
                               np.asarray(getattr(jl.Tgeo, w))) <= TOL[np.float32]
        if i + 1 < len(th.levels):  # the coarsest level differs by design
            th_, jh_ = tl.Ahyb, jl.Ahyb
            assert (th_.offsets, th_.shape, th_.n_pad) == (
                jh_.offsets, jh_.shape, jh_.n_pad), i
            assert rel_err(_np(th_.planes), np.asarray(jh_.planes)) <= TOL[np.float32]
    # the Gershgorin lmax of the geo levels, the power iteration's of the
    # coarsest one (which the two packages' sin and sum orders perturb)
    for tl, jl in zip(th.levels[:-1], jh.levels[:-1]):
        assert rel_err(_np(tl.cheb_lmax), np.asarray(jl.cheb_lmax)) <= TOL[np.float32]
    assert rel_err(_np(th.levels[-1].cheb_lmax),
                   np.asarray(jh.levels[-1].cheb_lmax)) <= 1e-5


def test_coarsest_level_keeps_the_chain_planes(builds):
    """The loop ends right after the chain at 64 rows: the port hands the
    chain's planes to the coarsest level (the reference drops them), and
    they apply the level's operator."""
    th, jh = builds("3d16", "torch"), builds("3d16", "jax")
    assert jh.levels[-1].Ahyb is None
    lv = th.levels[-1]
    H = lv.Ahyb
    assert H is not None and H.n_pad == lv.A.n_rows_pad and len(H.offsets) == 27
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        lv.A.n_rows_pad).astype(np.float32))
    y, y_ref = hybrid_spmv(H, x), spmv(lv.A, x)
    assert (y - y_ref).abs().max() <= 1e-6 * y_ref.abs().max()


def test_chain_hands_its_planes_to_the_host_tail(builds):
    """Threshold 1500: levels 0-1 from the chain, the rest on the host; the
    first host level takes the chain's last planes (``ahyb0``), as in the
    reference."""
    th, jh = builds("3d16", "torch", 1500), builds("3d16", "jax", 1500)
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels] == SIZES16
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        for f in ("A", "P", "R"):
            _same_ell(getattr(tl, f), getattr(jl, f), TOL[np.float32], f"L{i} {f}")
        assert (tl.Ahyb is None) == (jl.Ahyb is None), i
        if tl.Ahyb is not None:
            assert tl.Ahyb.offsets == jl.Ahyb.offsets, i
            assert rel_err(_np(tl.Ahyb.planes),
                           np.asarray(jl.Ahyb.planes)) <= TOL[np.float32]
    assert len(th.levels[2].Ahyb.offsets) == 27  # unpruned, from the chain


def test_geo_device_matches_host(builds):
    """The device route and the host route build the same geo hierarchy
    (the reference's tests/unit/test_geo_split.py:79-95)."""
    hd, hh = builds("3d16", "torch"), builds("3d16", "torch", 1 << 60)
    assert [lv.n for lv in hd.levels] == [lv.n for lv in hh.levels]
    for d, h in zip(hd.levels, hh.levels):
        assert abs(ell_to_csr(d.A) - ell_to_csr(h.A)).max() <= 1e-5
        if d.P is not None:
            assert abs(ell_to_csr(d.P) - ell_to_csr(h.P)).max() <= 1e-6


def test_geo_device_refined_solve_takes_reference_iterations(builds):
    A = _csr("3d16")
    b = np.ones(A.shape[0])
    cfg = dict(GEO, host_setup_threshold=0)
    x, info = tapi.solve(A, b, TCfg(**cfg), TSolve(**REFINED),
                         hier=builds("3d16", "torch"))
    _, info_j = japi.solve(A, b, JCfg(**cfg), JSolve(**REFINED),
                           hier=builds("3d16", "jax"))
    assert info["iterations"] == info_j["iterations"]
    assert float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)) <= 1e-8


def test_geo_chain_width_overflow_raises(monkeypatch):
    """A Galerkin product wider than its plan's k_Ac raises (the reference
    truncates it silently)."""
    plans_of = thier._geo_plans

    def narrow(*a, **k):
        plans, exts = plans_of(*a, **k)
        plans[0] = dict(plans[0], k_Ac=8)
        return plans, exts

    monkeypatch.setattr(thier, "_geo_plans", narrow)
    with pytest.raises(RuntimeError, match="outgrew its structural width"):
        tapi.setup(_csr("3d16"), TCfg(**GEO, host_setup_threshold=0),
                   device="cpu")
