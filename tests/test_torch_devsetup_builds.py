"""Whole builds of the port's device route (``api.setup`` with levels
above ``host_setup_threshold``) against the JAX package's, on the CPU.

Level sizes are pinned to the JAX package's: shuffled 20^3 at threshold
2000 (levels 0-1 on the device, the rest on the host) and 16^3 at
threshold 0 (every level on the device; the extended one in fp64), with
the direct and extended interpolations.  ELL structure exact at every
level; values within 1e-4 in fp32 and 1e-12 in fp64 (the same builds
agree within 1e-13 in fp64, so an fp32 difference is rounding that the
coarse levels' interpolation denominators amplify a few hundred times);
refined-solve iterations equal to JAX's.  Builds that are not solved fold
no dense tail (``tail_max_n=0``), which changes no level.  The extended route's sizes differ from the host route's, as in
the reference, which shows the device route ran.  RS on the device route:
the host splitting of the device strength graph, then device
interpolation and exact-width SpGEMMs.  The JAX builds are made once per
module.
"""

import numpy as np
import pytest

import raptor_tpu.api as japi
import raptor_tpu_torch.api as tapi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import _np
from raptor_tpu_torch.gallery import poisson_2d
from tests._torch_ref import rel_err, shuffled_poisson
from tests.test_torch_devsetup import _same_ell

WHOLE_TOL = {np.float32: 1e-4, np.float64: 1e-12}
DENSE_TOL = 1e-5
REFINED = dict(tol=1e-8, refine=True)
# the reference's whole builds: nx of the shuffled nx^3 Poisson input,
# configuration, level sizes, refined-solve iterations (None: not solved),
# value dtype
ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)
BUILDS = {
    "direct20": (20, dict(ALG, host_setup_threshold=2000),
                 [8000, 4000, 509, 89, 16], 8, np.float32),
    "extended20": (20, dict(splitting="pmis", interp="extended",
                            host_setup_threshold=2000),
                   [8000, 4000, 509, 72, 15], 11, np.float32),
    "direct16": (16, dict(splitting="pmis", interp="direct",
                          host_setup_threshold=0, tail_max_n=0),
                 [4096, 2048, 270, 49], None, np.float32),
    "extended16": (16, dict(splitting="pmis", interp="extended",
                            host_setup_threshold=0, tail_max_n=0),
                   [4096, 2048, 270, 35], None, np.float64),
}
# the host route of extended20 (every level in NumPy)
EXT20_HOST_SIZES = [8000, 4000, 509, 74, 17]


@pytest.fixture(scope="module")
def builds():
    """builds(name, side): the api.setup of BUILDS[name] by the JAX package
    ("jax") or the port on the CPU ("torch"), each from its own copy of
    the input, built once."""
    cache = {}

    def get(name, side):
        key = (name, side)
        if key not in cache:
            nx, cfg, _, _, dtype = BUILDS[name]
            A = shuffled_poisson(nx)
            cache[key] = (japi.setup(A, JCfg(**cfg), dtype=dtype)
                          if side == "jax" else
                          tapi.setup(A, TCfg(**cfg), dtype=dtype, device="cpu"))
        return cache[key]

    return get


def _same_levels(th, jh, tol):
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        for name in ("A", "P", "R"):
            _same_ell(getattr(tl, name), getattr(jl, name), tol, f"L{i} {name}")
        assert rel_err(_np(tl.dinv), np.asarray(jl.dinv)) <= tol, f"L{i} dinv"
        assert (tl.cheb_lmax is None) == (jl.cheb_lmax is None)
        if tl.cheb_lmax is not None:
            assert rel_err(_np(tl.cheb_lmax),
                           np.asarray(jl.cheb_lmax)) <= max(tol, 1e-5)
    assert rel_err(_np(th.coarse_inv), np.asarray(jh.coarse_inv)) <= DENSE_TOL


@pytest.mark.parametrize("name", list(BUILDS))
def test_device_route_build_matches_reference(builds, name):
    _, _, sizes, _, dtype = BUILDS[name]
    th, jh = builds(name, "torch"), builds(name, "jax")
    assert [lv.n for lv in jh.levels] == sizes
    assert th.levels[0].A.data.numpy().dtype == dtype
    _same_levels(th, jh, WHOLE_TOL[dtype])


@pytest.mark.parametrize("name", ["direct20", "extended20"])
def test_refined_solve_takes_reference_iterations(builds, name):
    nx, cfg, _, iters, _ = BUILDS[name]
    A = shuffled_poisson(nx)
    b = np.ones(A.shape[0])
    x, info = tapi.solve(A, b, TCfg(**cfg), TSolve(**REFINED),
                         hier=builds(name, "torch"))
    _, info_j = japi.solve(A, b, JCfg(**cfg), JSolve(**REFINED),
                           hier=builds(name, "jax"))
    assert info["iterations"] == info_j["iterations"] == iters
    assert float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)) <= 1e-8


def test_extended_device_route_differs_from_host_route(builds):
    """The device route's strength-compacted ext+i gives other coarse
    levels than the host route's distance-two ext+i, as in the reference:
    the sizes prove the device route ran."""
    cfg = dict(BUILDS["extended20"][1], host_setup_threshold=2**20,
               tail_max_n=0)
    h = tapi.setup(shuffled_poisson(20), TCfg(**cfg), device="cpu")
    assert [lv.n for lv in h.levels] == EXT20_HOST_SIZES
    assert [lv.n for lv in builds("extended20", "torch").levels] != EXT20_HOST_SIZES


def test_rs_device_route_matches_reference():
    """RS on device levels: the host splitting of the device strength
    graph, then device interpolation and exact-width SpGEMMs."""
    cfg = dict(splitting="rs", smoother="jacobi", host_setup_threshold=100)
    jh = japi.setup(poisson_2d(32), JCfg(**cfg), dtype=np.float64)
    th = tapi.setup(poisson_2d(32), TCfg(**cfg), dtype=np.float64,
                    device="cpu")
    assert [lv.n for lv in th.levels] == [1024, 512, 132, 34]
    _same_levels(th, jh, WHOLE_TOL[np.float64])


def test_direct_device_route_is_the_host_route_bit_for_bit():
    """The device route sums every slot-axis term in NumPy's and SciPy's
    order, so with direct interpolation its levels carry the host route's
    bits: the same A, P and R values and the same sizes (at 96^3 on the
    card this is what keeps the reference's host-route level sizes)."""
    from raptor_tpu_torch.core.ell import ell_to_csr

    cfg = dict(BUILDS["direct20"][1], tail_max_n=0)
    hd = tapi.setup(shuffled_poisson(20), TCfg(**cfg), device="cpu")
    cfg["host_setup_threshold"] = 2**20
    hh = tapi.setup(shuffled_poisson(20), TCfg(**cfg), device="cpu")
    assert [lv.n for lv in hd.levels] == [lv.n for lv in hh.levels]
    for i, (d, h) in enumerate(zip(hd.levels, hh.levels)):
        for name in ("A", "P", "R"):
            ed, eh = getattr(d, name), getattr(h, name)
            if ed is not None:
                assert (ell_to_csr(ed) != ell_to_csr(eh)).nnz == 0, (i, name)
        assert np.array_equal(_np(d.dinv), _np(h.dinv)), i
