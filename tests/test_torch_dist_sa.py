"""The sharded smoothed-aggregation setup of raptor_tpu_torch
(parallel/dist_sa.py: the host decision pass, the batched tentative QR,
prolongator smoothing with the lumped filter, the block smoother data and
the RAP) against the JAX package's and against the port's single-device
SA build, on the CPU.

The port's ranks are four spawned processes joined over gloo; their bodies
are in tests/_torch_dist_sa_spmd.py, which imports no JAX.  The reference
runs ``raptor_tpu.parallel.dist_sa`` under ``shard_map`` on a four-device
mesh (four of the eight virtual CPU devices of tests/conftest.py), in fp64
with its own test settings (``pad_multiple=8*ndev``,
tests/distributed/test_dist_algebraic_setup.py:462-516), two builds:

* ``scalar``: poisson_2d(32), one candidate, cheb4, tail 100
  (``test_dist_sa_scalar``): one sharded level;
* ``elastic``: elasticity_3d(10), 2,700 rows, its six rigid-body modes,
  block_cheb, theta 0.08, ``sa_filter`` 0.1, tail 100: two sharded levels,
  [2700, 174], the second on the block-padded coarse lanes the decision
  pass compacts (the reference's slow ``test_dist_sa_multilevel`` path,
  with ``test_dist_sa_filter_matches_single``'s filter).

Against the reference, on every rank and every sharded level: the
decision pass's aggregate vector and ``max_agg`` exactly; the A structure,
halo plans, P and R structure exactly, and A, dinv, P, R and binv within
1e-12 of the array's largest entry; ``cheb_lmax`` within 1e-10; the tail's
sizes and first operator and the bridge; ``dist_solve`` on the
reference's hierarchy carried across takes the iterations of the port's
own, x within 1e-9.  Against the port's single-device build (the device
route, ``host_setup_threshold`` 0): the fine level's aggregates, the level
0 and first coarse sizes, and the first coarse operator's fp64 entry-sum
fingerprint within rtol 1e-9 (the reference's own check).  A ring of one
against four: equal sizes, iterations within one.  The reference's
ValueError.

The spawned run goes on a background thread while the reference builds;
the ranks wait for the reference's trees only for the carried solves.
"""

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.parallel import dist_sa as jdsa
from raptor_tpu.parallel.dist import make_solve_mesh
from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.gallery import default_rhs, elasticity_3d, poisson_2d
from raptor_tpu_torch.parallel import dist_build_hierarchy, spawn
from tests import _torch_dist_sa_spmd
from tests._torch_dist_sa_spmd import fingerprint
from tests._torch_dist_setup_check import _close, _real_ids, check_build
from tests._torch_ref import dist_tree_from_jax

NDEV = 4
X_TOL = 1e-9  # tests/test_torch_adist.py's
RUN_TIMEOUT = 300.0
TAIL = 100
PARTS = ("A", "P", "R", "smoother", "tail")
CFGS = {
    "scalar": dict(splitting="aggregation", interp="smoothed",
                   smoother="cheb4", num_candidates=1,
                   pad_multiple=8 * NDEV, coarse_size=32, tail_max_n=0),
    "elastic": dict(splitting="aggregation", interp="smoothed",
                    smoother="block_cheb", num_candidates=6, theta=0.08,
                    sa_filter=0.1, pad_multiple=8 * NDEV, coarse_size=64,
                    tail_max_n=0),
}
BUILDS = tuple(CFGS)
LEVELS = {"scalar": 1, "elastic": 2}  # sharded levels of each build
BLOCK = {"scalar": 1, "elastic": 3}  # dofs a node on the fine level


def _problem(name):
    """(A, B) of a build."""
    if name == "scalar":
        return poisson_2d(32), None
    A, B, _ = elasticity_3d(10)
    return A, B


def _cases(path: str) -> dict:
    cases = {}
    for name in BUILDS:
        A, B = _problem(name)
        cases[name] = dict(kind="build", matrix=A, B=B, cfg=CFGS[name],
                           tail_size=TAIL)
    A, B = _problem("elastic")
    cases["error_small"] = dict(kind="error", matrix=A, B=B,
                                cfg=CFGS["elastic"], tail_size=A.shape[0])
    # each on one rank, at the same time
    cases["one_rank"] = dict(kind="one_rank", on=0, matrix=A, B=B,
                             cfg=CFGS["elastic"], tail_size=TAIL)
    for on, name in enumerate(BUILDS, start=1):
        M, Bm = _problem(name)
        cases[f"single_{name}"] = dict(kind="single", on=on, matrix=M, B=Bm,
                                       cfg=CFGS[name])
    cases["carried"] = dict(kind="carried", path=path)
    return cases


@pytest.fixture(scope="module")
def mesh():
    return make_solve_mesh(NDEV)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The four-rank run, started on a background thread."""
    path = str(tmp_path_factory.mktemp("dist_sa") / "carried.pkl")
    cases = _cases(path)
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _torch_dist_sa_spmd.run_cases, NDEV, "gloo",
                          "cpu", list(cases.values()), timeout=RUN_TIMEOUT)
        yield path, cases, fut


def _jax_build(name, mesh):
    """The reference's build, with its decision pass's aggregate vectors."""
    A, B = _problem(name)
    seen = []
    orig = jdsa._host_aggregate

    def recording(*args):
        out = orig(*args)
        seen.append(np.asarray(out[0][0]))
        return out

    jdsa._host_aggregate = recording
    try:
        dh = jdsa.dist_build_sa_hierarchy(A, JCfg(**CFGS[name]), B=B, mesh=mesh,
                                          tail_size=TAIL, dtype=np.float64)
    finally:
        jdsa._host_aggregate = orig
    return dh, seen[:len(dh.levels)]


@pytest.fixture(scope="module")
def jax_builds(run, mesh):
    """The reference's two builds; their per-rank trees go to the ranks
    (an empty file if a build fails, so the ranks stop waiting)."""
    path = run[0]
    trees = {}
    try:
        builds = {name: _jax_build(name, mesh) for name in BUILDS}
        trees = {name: ([dist_tree_from_jax(dh, r) for r in range(NDEV)],
                        _problem(name)[0].shape[0])
                 for name, (dh, _) in builds.items()}
    finally:
        with open(path + ".part", "wb") as f:
            pickle.dump(trees, f)
        os.replace(path + ".part", path)
    return builds


@pytest.fixture(scope="module")
def ranks(run, jax_builds):
    _, cases, fut = run
    return [dict(zip(cases, r)) for r in fut.result()]


# first in the file: the reference builds while the ranks work
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", BUILDS)
def test_build_matches_jax(ranks, jax_builds, name, part):
    dh, _ = jax_builds[name]
    assert len(dh.levels) == LEVELS[name]
    check_build([r[name]["dh"] for r in ranks], dh, part)


@pytest.mark.parametrize("name", BUILDS)
def test_aggregates_match_jax(ranks, jax_builds, name):
    """Every rank's decision pass gives each sharded level the reference's
    aggregate vector, and the block-padded numbering its max_agg (the next
    level's rows a rank, or the bridge's coarse columns)."""
    jdh, jaggs = jax_builds[name]
    nc = CFGS[name]["num_candidates"]
    for rank, out in enumerate(ranks):
        got = out[name]
        assert len(got["aggs"]) == len(jaggs) == LEVELS[name]
        for k, (a, b) in enumerate(zip(got["aggs"], jaggs)):
            assert np.array_equal(a, b), (rank, k)
        levels = got["dh"]["levels"]
        for k in range(1, len(levels)):
            assert levels[k]["n_local"] == jdh.levels[k].n_local, (rank, k)
        bp = got["dh"]["bridge_P"]
        assert bp["n_cols_pad"] == jdh.bridge_P.n_cols_pad, rank
        assert bp["n_cols_pad"] % (NDEV * nc) == 0


@pytest.mark.parametrize("name", BUILDS)
def test_solve_matches_carried(ranks, name):
    """dist_solve takes the same iterations on the port's own dist-built
    hierarchy as on the reference's carried across (binv and the SA tail
    with it), with x within 1e-9."""
    for out in ranks:
        own, carried = out[name]["solve"], out["carried"][name]
        assert own["iterations"] == carried["iterations"]
        _close(own["x"], carried["x"], X_TOL, "x")


@pytest.mark.parametrize("name", BUILDS)
def test_dist_built_solves(ranks, name):
    """Each dist-built hierarchy solves to 1e-8 (fp64 recurrence), the
    ranks agree, and the true fp64 residual is within 1e-7."""
    outs = [r[name]["solve"] for r in ranks]
    assert all(o["iterations"] == outs[0]["iterations"] for o in outs)
    assert outs[0]["relres"] <= 1e-8
    A, _ = _problem(name)
    b = default_rhs(A.shape[0])
    x = outs[0]["x"][:A.shape[0]]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-7


@pytest.mark.parametrize("name", BUILDS)
def test_matches_single_device(ranks, name):
    """The four-rank build against the port's single-device device-route
    build: the fine level's aggregates, the fine and first coarse sizes,
    and the first coarse operator's fp64 entry-sum fingerprint within rtol
    1e-9 (block-padded on the sharded side: its padding rows are identity
    rows, taken off as the single-device build's are)."""
    single = ranks[1 + BUILDS.index(name)][f"single_{name}"]
    got = ranks[0][name]
    nodes = got["dh"]["levels"][0]["n"] // BLOCK[name]
    assert np.array_equal(got["aggs"][0][:nodes], single["agg0"][:nodes])
    levels = [r[name]["dh"]["levels"] for r in ranks]
    coarse = _real_ids(got["dh"]["bridge_P"]["cols"],
                       got["dh"]["bridge_P"]["row_nnz"]).size
    sizes = [lv["n"] for lv in levels[0]] + [coarse]
    assert sizes[:2] == single["sizes"][:2], (sizes, single["sizes"])
    if len(levels[0]) > 1:  # the first coarse operator is sharded
        A1 = [lv[1]["A"] for lv in levels]
        fp = fingerprint(np.concatenate([a["data"] for a in A1], -1),
                         np.concatenate([a["row_nnz"] for a in A1]), sizes[1])
    else:  # the tail's first level
        At = got["dh"]["tail_A"][0]
        fp = fingerprint(At["data"], At["row_nnz"], sizes[1])
    assert np.isclose(fp, single["fingerprint1"], rtol=1e-9), (fp, single)


def test_one_rank_against_four(ranks):
    """A ring of one (rank 0 alone) gives the four-rank build's sharded
    sizes and coarse size, and its solve the same iterations within one."""
    one, four = ranks[0]["one_rank"], ranks[0]["elastic"]
    assert ([lv["n"] for lv in one["dh"]["levels"]]
            == [lv["n"] for lv in four["dh"]["levels"]])
    assert (_real_ids(one["dh"]["bridge_P"]["cols"],
                      one["dh"]["bridge_P"]["row_nnz"]).size
            == _real_ids(four["dh"]["bridge_P"]["cols"],
                         four["dh"]["bridge_P"]["row_nnz"]).size)
    assert abs(one["solve"]["iterations"] - four["solve"]["iterations"]) <= 1


def test_nothing_to_shard(ranks):
    """The reference's ValueError for an input at or below tail_size."""
    for out in ranks:
        assert out["error_small"] is not None
        assert "nothing to shard" in out["error_small"], out["error_small"]


def test_dist_build_hierarchy_names_dist_build_sa_hierarchy():
    """dist_build_hierarchy refuses smoothed aggregation, naming the
    function that builds it."""
    A, B = _problem("elastic")
    with pytest.raises(ValueError, match="dist_build_sa_hierarchy"):
        dist_build_hierarchy(A, AmgConfig(**CFGS["elastic"]), None,
                             device="cpu")
