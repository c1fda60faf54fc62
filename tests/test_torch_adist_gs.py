"""The sharded smoothers of raptor_tpu_torch (parallel/dist.py: the mcgs,
tsgs, block_jacobi and block_cheb branches of ``_dist_smooth``, and the
colours and block inverses ``distribute_hierarchy`` shards with the rows)
on four gloo ranks against the JAX package on the CPU.

The ranks are spawned processes (bodies in tests/_torch_adist_spmd.py,
hierarchies carried over from the reference as plain-numpy trees, fp64).
The references:

* mcgs colours are global, so the sharded sweep is the single-device one:
  the reference's single-device ``solve_hier`` on the same hierarchy,
  iterations exactly and x within 1e-9 (test_dist.py's tolerance);
* tsgs's inner triangular series is processor-local, and the block
  smoothers apply A through the sharded SpMV: the reference's own sharded
  ``dist_solve`` (``shard_map`` over four of the eight virtual CPU
  devices) on the same hierarchy, iterations exactly and x within 1e-9;
* mcgs on the banded layout (K4's halo form and K6's map_cols form, plain
  versions on the CPU): the reference's single-device solve on the same
  hierarchy with its banded layouts stripped (the same matrices on the
  ELL route; the reference's Pallas kernels in interpret mode under jit
  take minutes to compile for one apply per colour).
"""

import dataclasses

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import raptor_tpu.api as japi
import raptor_tpu.parallel.dist as jdist
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.setup.aggregation import build_sa_hierarchy as j_build_sa
from raptor_tpu_torch.gallery import default_rhs, elasticity_3d, poisson_3d
from raptor_tpu_torch.parallel import spawn
from tests import _torch_adist_spmd
from tests._torch_ref import algebraic_tree_from_jax, shuffled_poisson

X_TOL = 1e-9
RANKS = 4
RUN_TIMEOUT = 300.0
ELL_TAIL, BAND_TAIL, SA_TAIL = 200, 500, 200
ELL_CFG = dict(splitting="pmis", pad_multiple=64, coarse_size=64)
BAND_CFG = dict(splitting="pmis", interp="direct", smoother="mcgs",
                fine_layout="banded", pad_multiple=8 * 1024, coarse_size=64)
SA_CFG = dict(splitting="aggregation", interp="smoothed", num_candidates=6,
              theta=0.08, pad_multiple=64, coarse_size=64, tail_max_n=0)
# (smoother, cycle, krylov) on the ELL hierarchy of poisson_3d(12)
GS_CASES = [("mcgs", "V", "cg"), ("mcgs", "W", "cg"), ("mcgs", "V", "gmres"),
            ("tsgs", "V", "cg"), ("tsgs", "W", "cg"), ("tsgs", "V", "gmres")]
SA_SMOOTHERS = ["block_cheb", "block_jacobi"]


def _id(c):
    return "-".join(c)


def _rhs(n, n_pad):
    b = np.zeros(n_pad)
    b[:n] = default_rhs(n)
    return b


@pytest.fixture(scope="module")
def jhiers():
    """The reference's hierarchies: the ELL ones by (smoother, cycle), the
    SA ones by smoother, the banded mcgs one."""
    out = {}
    for sm, cyc in {(c[0], c[1]) for c in GS_CASES}:
        out[(sm, cyc)] = japi.setup(poisson_3d(12), JCfg(**ELL_CFG, smoother=sm,
                                                         cycle=cyc),
                                    dtype=np.float64)
    A, B, _ = elasticity_3d(8)
    for sm in SA_SMOOTHERS:
        out[sm] = j_build_sa(A, JCfg(**SA_CFG, smoother=sm), B=B,
                             dtype=np.float64)
    out["band"] = japi.setup(shuffled_poisson(20), JCfg(**BAND_CFG),
                             dtype=np.float64)
    return out


def _case(jh, tail, krylov="cg"):
    lev0 = jh.levels[0]
    return dict(kind="solve", tree=algebraic_tree_from_jax(jh), tail_size=tail,
                maxiter=200, krylov=krylov, b=_rhs(lev0.n, lev0.A.n_rows_pad))


@pytest.fixture(scope="module")
def spmd(jhiers):
    """The four-rank run on a background thread, overlapping the
    reference's solves in the tests."""
    cases = {_id(c): _case(jhiers[c[:2]], ELL_TAIL, c[2]) for c in GS_CASES}
    cases.update({sm: _case(jhiers[sm], SA_TAIL) for sm in SA_SMOOTHERS})
    cases["band"] = _case(jhiers["band"], BAND_TAIL)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _torch_adist_spmd.run_cases, RANKS, "gloo",
                          "cpu", list(cases.values()), timeout=RUN_TIMEOUT)
        yield pool.submit(lambda: [dict(zip(cases, r)) for r in fut.result()])


def _single(jh, krylov):
    lev0 = jh.levels[0]
    b = _rhs(lev0.n, lev0.A.n_rows_pad)
    x, info = japi.solve_hier(jh, b, tol=1e-8, maxiter=200, krylov=krylov)
    return np.asarray(x), int(info.iterations)


def _sharded(jh, tail, krylov):
    lev0 = jh.levels[0]
    b = _rhs(lev0.n, lev0.A.n_rows_pad)
    dh = jdist.distribute_hierarchy(jh, RANKS, tail_size=tail)
    x, info = jdist.dist_solve(dh, b, jdist.make_solve_mesh(RANKS), tol=1e-8,
                               maxiter=200, krylov=krylov)
    return np.asarray(x), int(info.iterations)


def _check(ranks, x_ref, it_ref, A=None):
    for out in ranks:
        assert out["status"] == 0 and out["relres"] <= 1e-8
        assert out["iterations"] == it_ref
    x = np.asarray(ranks[0]["x"])
    assert np.abs(x - x_ref).max() <= X_TOL
    if A is not None:
        b = default_rhs(A.shape[0])
        assert np.linalg.norm(b - A @ x[: A.shape[0]]) / np.linalg.norm(b) <= 1e-7


@pytest.mark.parametrize("case", GS_CASES, ids=_id)
def test_sharded_gauss_seidel_matches_reference(spmd, jhiers, case):
    sm, cyc, kr = case
    jh = jhiers[(sm, cyc)]
    ref = _single(jh, kr) if sm == "mcgs" else _sharded(jh, ELL_TAIL, kr)
    ranks = [r[_id(case)] for r in spmd.result()]
    assert ranks[0]["n_sharded"] == 2
    _check(ranks, *ref, A=poisson_3d(12))


def test_sharded_tsgs_is_processor_local(spmd, jhiers):
    """The hybrid tsgs differs from the single-device one (the halo
    couplings leave the inner triangle) but stays within the reference's
    own bound, +2 iterations (test_dist.py::test_dist_solve_tsgs)."""
    _, it1 = _single(jhiers[("tsgs", "V")], "cg")
    it4 = spmd.result()[0][_id(("tsgs", "V", "cg"))]["iterations"]
    assert it4 <= it1 + 2


@pytest.mark.parametrize("smoother", SA_SMOOTHERS)
def test_sharded_block_smoothers_match_reference(spmd, jhiers, smoother):
    """Config 4's smoothers on an SA elasticity 8^3 hierarchy: the block
    inverses shard with the rows."""
    jh = jhiers[smoother]
    assert jh.levels[0].binv is not None
    dh = jdist.distribute_hierarchy(jh, RANKS, tail_size=SA_TAIL)
    assert dh.levels[0].binv is not None
    ranks = [r[smoother] for r in spmd.result()]
    _check(ranks, *_sharded(jh, SA_TAIL, "cg"), A=elasticity_3d(8)[0])
    # and within the reference's fence of the single-device solve
    assert abs(ranks[0]["iterations"] - _single(jh, "cg")[1]) <= 2


def test_sharded_mcgs_banded_matches_reference(spmd, jhiers):
    """mcgs on the banded route: K4's halo form on every sharded banded A
    and K6's map_cols form on the sharded transfers (plain versions)."""
    ranks = [r["band"] for r in spmd.result()]
    assert ranks[0]["banded"][:2] == [True, True] and ranks[0]["banded_txf"][0]
    jh = jhiers["band"]
    ell = dataclasses.replace(jh, levels=tuple(
        dataclasses.replace(lv, Aband=None, Pband=None, Rband=None)
        for lv in jh.levels))
    _check(ranks, *_single(ell, "cg"))
