"""The plane-sharded structured engine of raptor_tpu_torch (structured/dist.py,
dist_setup.py, parallel/comm.py) against the JAX package on the CPU.

The port's ranks are spawned processes joined over gloo (``spawn``: a
FileStore in a temporary directory, a time limit per run); their bodies are
in tests/_torch_spmd.py, which imports no JAX.  All work in float64:

* ``plan_coarsening_dist`` equals the reference's exactly;
* the sharded levels of ``distribute_structured`` and
  ``sdist_build_hierarchy`` on 4 ranks equal the reference's global
  arrays, sliced to each rank's plane block, within 1e-13; the replicated
  tail within 1e-12 (the reference's own test_dist_setup.py tolerances);
* ``sdist_solve`` on 4 and 8 ranks takes the reference single-device
  solve's iteration count on the same plan exactly, with x within 1e-9
  (test_structured_dist.py's tolerance), and a true relres <= 1e-7.

No JAX ``shard_map`` solve runs here (its XLA:CPU compile made the
reference's sharded solve tests slow): the JAX side is the reference's
``distribute_structured``, its single-device build and solve on the
sharded plan, and for the 2D anisotropic setup its own
``sdist_build_hierarchy`` on a 4-device mesh.  The spawned runs go on a
background thread while the reference computes.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import raptor_tpu.structured.dia as jdia
import raptor_tpu.structured.dist as jdist
import raptor_tpu.structured.solver as js
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.structured.dist_setup import sdist_build_hierarchy as j_sdist_build
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.gallery import default_rhs, diffusion_stencil_2d, stencil_grid
from raptor_tpu_torch.parallel import spawn
from raptor_tpu_torch.structured.dia import dia_from_stencil
from raptor_tpu_torch.structured.dist import plan_coarsening_dist
from tests import _torch_spmd
from tests._torch_ref import stencil_5pt, stencil_7pt

LEVEL_TOL = 1e-13
TAIL_TOL = 1e-12
X_TOL = 1e-9
RUN_TIMEOUT = 240.0

MCGS = dict(smoother="mcgs", coarse_size=32, max_levels=30)
ST3, ST2 = stencil_7pt(), stencil_5pt()
ST_ANISO = diffusion_stencil_2d(1e-2, 0.3)


def _case(kind, stencil, dims, cfg, tail_size=256, **kw):
    return dict(kind=kind, stencil=np.asarray(stencil).tolist(), dims=dims,
                cfg=cfg, tail_size=tail_size, **kw)


SOLVES = {
    "mcgs_16cube": _case("solve", ST3, (16, 16, 16), MCGS, maxiter=100),
    "jacobi_2d": _case("solve", ST2, (32, 64), dict(MCGS, smoother="jacobi"),
                       maxiter=150),
    "w_chebyshev": _case("solve", ST3, (32, 8, 4),
                         dict(MCGS, smoother="chebyshev", cycle="W"),
                         tail_size=200, maxiter=100),
    "gmres": _case("solve", ST2, (32, 64), dict(MCGS, smoother="jacobi"),
                   maxiter=150, krylov="gmres"),
}
CASES4 = {
    "distribute": _case("distribute", ST3, (16, 16, 16), MCGS, policy="size"),
    "setup_cheb4": _case("setup", ST3, (16, 16, 16),
                         dict(MCGS, smoother="cheb4", cheb_degree=2),
                         policy="size"),
    "setup_mcgs": _case("setup", ST3, (16, 16, 16), MCGS, policy="size"),
    "setup_aniso": _case("setup", ST_ANISO, (16, 32),
                         dict(MCGS, smoother="jacobi"), tail_size=128,
                         policy="operator"),
    **SOLVES,
    "one_rank": dict(SOLVES["mcgs_16cube"], solo=True),
}
CASES8 = {"mcgs_16cube": SOLVES["mcgs_16cube"]}


def _spawn(world, cases):
    out = spawn(_torch_spmd.run_cases, world, "gloo", "cpu", list(cases.values()),
                timeout=RUN_TIMEOUT)
    return [dict(zip(cases, per_rank)) for per_rank in out]


@pytest.fixture(scope="module")
def spmd():
    """The 4- and 8-rank runs, one after the other on a background thread,
    so that they overlap the reference computations of the tests."""
    with ThreadPoolExecutor(1) as pool:
        yield {4: pool.submit(_spawn, 4, CASES4), 8: pool.submit(_spawn, 8, CASES8)}


@pytest.fixture(scope="module")
def jax_mcgs():
    """The reference's distribute_structured of the 16^3 mcgs case; its
    sharded and tail operators are also those of the cheb4 case (the plan
    and the operators do not depend on the smoother)."""
    return _jax_distribute(CASES4["distribute"])


def _jax_operator(case):
    return jdia.dia_from_stencil(np.asarray(case["stencil"]), case["dims"],
                                 dtype=jnp.float64)


def _rank_block(a, rank, nl):
    return np.asarray(a)[..., rank * nl:(rank + 1) * nl]


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max(initial=0.0) <= tol


def _same_sharded_levels(ranks, jlevels, ndev):
    """Every rank's blocks against the reference's global level arrays."""
    for rank, out in enumerate(ranks):
        assert len(out["levels"]) == len(jlevels)
        for k, (tl, jl) in enumerate(zip(out["levels"], jlevels)):
            assert tl["cdim"] == jl.cdim
            assert tl["dims_local"] == jl.dims_local
            nl = int(np.prod(tl["dims_local"]))
            for name in ("A", "Pt", "Rt"):
                tm, jm = tl[name], getattr(jl, name)
                assert tm["offsets"] == jm.offsets, (rank, k, name)
                _close(tm["data"], _rank_block(jm.data, rank, nl), LEVEL_TOL)
            _close(tl["dinv"], _rank_block(jl.dinv, rank, nl), LEVEL_TOL)
            assert np.array_equal(tl["red"], _rank_block(jl.red, rank, nl))


def _same_tail_levels(ranks, jtail):
    for out in ranks:
        assert len(out["tail"]) == len(jtail.levels)
        for tm, jl in zip(out["tail"], jtail.levels):
            assert tm["offsets"] == jl.A.offsets and tm["dims"] == jl.A.dims
            _close(tm["data"], jl.A.data, TAIL_TOL)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(16, 16, 16), (32, 16, 16), (32, 8, 4),
                                  (32, 64)])
def test_plan_coarsening_dist_matches_jax(dims):
    st = ST3 if len(dims) == 3 else ST2
    J = jdia.dia_from_stencil(st, dims, dtype=jnp.float64)
    T = dia_from_stencil(st, dims, device="cpu")
    for ndev in (2, 4, 8):
        for policy, tail in (("size", 256), ("operator", 4096), ("size", 200)):
            assert plan_coarsening_dist(T, TCfg(**MCGS), ndev, policy, tail) \
                == jdist.plan_coarsening_dist(J, JCfg(**MCGS), ndev, policy, tail)


# ---------------------------------------------------------------------------
# sharded levels
# ---------------------------------------------------------------------------

def _jax_distribute(case):
    return jdist.distribute_structured(_jax_operator(case), JCfg(**case["cfg"]),
                                       4, "size", case["tail_size"])


def _reference_lmax_dist(jl, ndev):
    """The reference's ``_lmax_dist`` (dist_setup.py:167-187) on the global
    vectors: the start vector is every block's sin((i + 7 rank) 0.7511) +
    0.01, and the ring-summed dots are global dots."""
    A, dinv = jl.A, jnp.asarray(jl.dinv)
    nl = int(np.prod(jl.dims_local))
    i = np.concatenate([np.arange(nl) + 7.0 * r for r in range(ndev)])
    v = jnp.sin(jnp.asarray(i) * 0.7511) + 0.01
    v = v / jnp.sqrt(jnp.vdot(v, v))
    for _ in range(40):
        w = dinv * jdia.dia_spmv(A, v)
        v = w / jnp.sqrt(jnp.vdot(w, w))
    w = dinv * jdia.dia_spmv(A, v)
    return float(1.1 * jnp.vdot(v, w) / jnp.vdot(v, v))


def test_distribute_structured_matches_jax(spmd, jax_mcgs):
    jh = jax_mcgs
    ranks = [r["distribute"] for r in spmd[4].result()]
    assert len(jh.levels) >= 2
    _same_sharded_levels(ranks, jh.levels, 4)
    _same_tail_levels(ranks, jh.tail)
    for out in ranks:
        assert out["tail_start"] == jh.tail.tail_start
        _close(out["tail_op"], jh.tail.tail_op, TAIL_TOL)


@pytest.mark.parametrize("name", ["setup_cheb4", "setup_mcgs"])
def test_sdist_build_hierarchy_matches_jax(spmd, jax_mcgs, name):
    """The block-by-block setup against the reference's build-then-shard
    one (test_dist_setup.py:31-44).  cheb_lmax comes from the sharded power
    iteration, whose start vector depends on the rank: it is held equal on
    every rank and against that iteration run on the global vectors, within
    1e-12 relative (the dots sum in another order)."""
    jh = jax_mcgs
    ranks = [r[name] for r in spmd[4].result()]
    _same_sharded_levels(ranks, jh.levels, 4)
    _same_tail_levels(ranks, jh.tail)
    for k, jl in enumerate(jh.levels):
        lm = [out["levels"][k]["cheb_lmax"] for out in ranks]
        if name == "setup_mcgs":
            assert all(v is None for v in lm)
        else:
            assert all(v == lm[0] for v in lm)
            ref = _reference_lmax_dist(jl, 4)
            assert abs(float(lm[0]) / ref - 1.0) <= 1e-12


def test_sdist_build_hierarchy_2d_anisotropic_matches_jax(spmd):
    """The reference's own sharded setup on a 4-device mesh
    (test_dist_setup.py:55-66)."""
    case = CASES4["setup_aniso"]
    mesh = jax.make_mesh((4,), ("x",), devices=jax.devices()[:4])
    jh = j_sdist_build(_jax_operator(case), JCfg(**case["cfg"]), mesh,
                       dim_policy="operator", tail_size=case["tail_size"])
    ranks = [r["setup_aniso"] for r in spmd[4].result()]
    assert len(jh.levels) >= 1
    _same_sharded_levels(ranks, jh.levels, 4)
    _same_tail_levels(ranks, jh.tail)


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _jax_single_device(case, ndev):
    """The reference's single-device solve on the sharded plan.  The W-cycle
    solve runs op by op: compiling its doubled coarse visits as one XLA:CPU
    program takes minutes."""
    A = _jax_operator(case)
    cfg = JCfg(**case["cfg"])
    plan, _ = jdist.plan_coarsening_dist(A, cfg, ndev, "size", case["tail_size"])
    b = default_rhs(A.n, dtype=np.float64)
    hier = js._build_hierarchy_planned(A, cfg, plan)
    with jax.disable_jit(cfg.cycle == "W"):
        x, info = js.structured_solve(hier, jnp.asarray(b), tol=1e-8,
                                      maxiter=case["maxiter"],
                                      krylov=case.get("krylov", "cg"))
    return np.asarray(x), int(info.iterations), b


def _check_solve(ranks, case, ndev):
    x_ref, it_ref, b = _jax_single_device(case, ndev)
    for out in ranks:
        assert out["status"] == 0 and out["relres"] <= 1e-8
        assert out["iterations"] == it_ref
    x = ranks[0]["x"]
    _close(x, x_ref, X_TOL)
    A = stencil_grid(np.asarray(case["stencil"]), case["dims"])
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-7
    assert ranks[0]["n_sharded"] >= 1


@pytest.mark.parametrize("name", list(SOLVES))
def test_sdist_solve_4_ranks_matches_jax(spmd, name):
    _check_solve([r[name] for r in spmd[4].result()], SOLVES[name], 4)


def test_sdist_solve_8_ranks_matches_jax(spmd):
    _check_solve([r["mcgs_16cube"] for r in spmd[8].result()],
                 SOLVES["mcgs_16cube"], 8)


def test_sdist_solve_one_rank_matches_four(spmd):
    """A ring of one (every halo is the rank's own edge slice) takes the
    same iterations as four ranks, with x within 1e-9."""
    runs4 = spmd[4].result()
    four = runs4[0]["mcgs_16cube"]
    for r in runs4:
        one = r["one_rank"]
        assert one["iterations"] == four["iterations"]
        assert one["n_sharded"] >= 1
        _close(one["x"], four["x"], X_TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_spawn_hung_rank_fails_within_its_timeout():
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] did not finish the run"):
        spawn(_torch_spmd.hang_right_neighbour, 2, "gloo", "cpu", timeout=2.0)
    # start (two fresh interpreters importing torch) + the 2 s run limit
    assert time.monotonic() - t0 < 60


def test_spawn_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        spawn(_torch_spmd.fail_on_rank_one, 2, "gloo", "cpu", timeout=60.0)
