"""Aggressive coarsening in the sharded algebraic setup of
raptor_tpu_torch (parallel/dist_setup.py: PMIS on G^2, multipass
interpolation, Jacobi refinement, the symmetric coarse filter; config 3's
pipeline) against the JAX package's and the port's single-device build, on
the CPU.

Four spawned gloo ranks (bodies in tests/_torch_dist_setup_spmd.py)
against the reference's ``shard_map`` programs on a four-device mesh, in
fp64 with the reference's test settings
(tests/distributed/test_dist_algebraic_setup.py:27-36, :283-301; the tail
on the host route, as in tests/test_torch_dist_setup.py) on the rotated
anisotropic problem anisotropic_2d(32), theta 0.35:

* ``_run_split_aggressive`` gives every rank the slice of the reference's
  C/F vector, bit for bit;
* the build with ``filter_tol`` 0.05 and two passes of ``interp_refine``
  (``p_max_elements`` 6), config 3's whole pipeline, sharded over level 0,
  gives every rank the reference's A structure, halo plans (the narrow
  one of A and the P^T-widened one of R), P and R structure exactly and
  their values within 1e-12 of the array's largest entry, its dinv, and
  its tail's sizes and first operator and its bridge (one reference build
  over one sharded level: its programs compile for seconds each);
* the builds with and without refinement over two sharded levels each
  equal the port's single-device build up to the block-padded coarse
  renumbering, bit for bit, down to the tail's first operator, and solve
  to 1e-8; a ring of one gives the sizes of four.

On a coarse level the reference takes a row for real when its global index
is below the level's size (raptor_tpu/parallel/dist_setup.py:545-546,
:687-689), but the block-padded numbering puts each rank's padding at the
end of its block, so the last ranks' real F rows beyond that index get no
multipass pass and no refinement and stay empty.  The port counts each
rank's real rows; its coarse levels are therefore held against its
single-device build, whose rows are all interpolated.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.core.ell import ell_from_csr as j_ell_from_csr
from raptor_tpu.parallel import dist_setup as jds
from raptor_tpu.parallel.dist import make_solve_mesh
from raptor_tpu.parallel.partition import distribute_matrix as j_distribute
from raptor_tpu.setup.splitting import make_perm as j_make_perm
from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.gallery import anisotropic_2d, default_rhs
from raptor_tpu_torch.parallel import spawn
from raptor_tpu_torch.setup.hierarchy import build_hierarchy
from tests import _torch_dist_setup_spmd
from tests._torch_dist_setup_check import _real_ids, check_build, check_single

NDEV = 4
RUN_TIMEOUT = 300.0
AGGR_N = 32
TAIL = 64  # anisotropic_2d(32): two sharded levels
TAIL_ONE = 128  # level 0 sharded only: the reference build
PARTS = ("A", "P", "R", "smoother", "tail")
BASE = dict(splitting="pmis", interp="direct", smoother="jacobi",
            pad_multiple=8 * NDEV, coarse_size=64, host_setup_threshold=TAIL,
            theta=0.35, aggressive=True)
CFGS = {"filter": dict(BASE, filter_tol=0.05),
        "refine": dict(BASE, filter_tol=0.05, interp_refine=2,
                       p_max_elements=6)}


def _cases() -> dict:
    A = anisotropic_2d(AGGR_N)
    cases = {"split": dict(kind="split", split="aggressive", matrix=A,
                           cfg=CFGS["filter"])}
    cases.update({name: dict(kind="build", matrix=A, cfg=cfg, tail_size=TAIL,
                             solve=True, maxiter=300)
                  for name, cfg in CFGS.items()})
    cases["refine_one"] = dict(
        kind="build", matrix=A,
        cfg=dict(CFGS["refine"], host_setup_threshold=TAIL_ONE),
        tail_size=TAIL_ONE)
    cases["solo"] = dict(kind="build", matrix=A, cfg=CFGS["filter"],
                         tail_size=TAIL, solve=True, maxiter=300, solo=True)
    return cases


@pytest.fixture(scope="module")
def mesh():
    return make_solve_mesh(NDEV)


@pytest.fixture(scope="module")
def spmd():
    """The four-rank run on a background thread."""
    cases = _cases()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _torch_dist_setup_spmd.run_cases, NDEV,
                          "gloo", "cpu", list(cases.values()),
                          timeout=RUN_TIMEOUT)
        yield lambda: [dict(zip(cases, r)) for r in fut.result()]


@pytest.fixture(scope="module")
def jax_refine(mesh):
    cfg = JCfg(**dict(CFGS["refine"], host_setup_threshold=TAIL_ONE))
    return jds.dist_build_hierarchy(anisotropic_2d(AGGR_N), cfg, mesh=mesh,
                                    tail_size=TAIL_ONE, dtype=np.float64)


# first in the file: the reference's build runs while the ranks work
@pytest.mark.parametrize("part", PARTS)
def test_build_matches_jax(spmd, jax_refine, part):
    check_build([r["refine_one"]["dh"] for r in spmd()], jax_refine, part)


def test_aggressive_split_matches_jax(spmd, mesh):
    """Every rank's C/F shard of the distance-two PMIS (G^2 from the
    gathered values) is the slice of the reference's, bit for bit."""
    cfg = JCfg(**CFGS["filter"])
    E = j_ell_from_csr(anisotropic_2d(AGGR_N), dtype=np.float64,
                       row_pad_multiple=8 * NDEV)
    perm = j_make_perm(E.shape[0], E.n_rows_pad, cfg.seed)
    cf, cc = jds._run_split_aggressive(
        mesh, j_distribute(E, NDEV), np.asarray(E.data), np.asarray(E.cols),
        np.asarray(E.row_nnz), perm, cfg, E.n_rows_pad, NDEV, E.shape[0])
    cf, cc = np.asarray(cf), np.asarray(cc)
    nl = E.n_rows_pad // NDEV
    for rank, out in enumerate(spmd()):
        assert np.array_equal(out["split"]["cf"], cf[rank * nl:(rank + 1) * nl])
        assert np.array_equal(out["split"]["cc"], cc)


@pytest.mark.parametrize("name", list(CFGS))
def test_build_matches_single_device(spmd, name):
    """The four-rank build equals the port's single-device aggressive
    build up to the coarse renumbering, bit for bit."""
    h = build_hierarchy(ell_from_csr(anisotropic_2d(AGGR_N), dtype=np.float64,
                                     row_pad_multiple=8 * NDEV),
                        AmgConfig(**CFGS[name]), device="cpu")
    check_single([r[name]["dh"] for r in spmd()], h, name)


@pytest.mark.parametrize("name", list(CFGS))
def test_dist_built_solves(spmd, name):
    """The dist-built hierarchy solves to 1e-8, the ranks agree, and the
    true fp64 residual is within 1e-7."""
    outs = [r[name]["solve"] for r in spmd()]
    assert all(o["iterations"] == outs[0]["iterations"] for o in outs)
    assert outs[0]["relres"] <= 1e-8
    A = anisotropic_2d(AGGR_N)
    b = default_rhs(A.shape[0])
    x = outs[0]["x"][:A.shape[0]]
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-7


def test_one_rank_against_four(spmd):
    """A ring of one (rank 0 alone) gives the four-rank build's sizes, and
    its solve the same iterations within one."""
    out = spmd()[0]
    one, four = out["solo"]["dh"], out["filter"]["dh"]
    assert [lv["n"] for lv in one["levels"]] == [lv["n"] for lv in four["levels"]]
    assert (_real_ids(one["bridge_P"]["cols"], one["bridge_P"]["row_nnz"]).size
            == _real_ids(four["bridge_P"]["cols"],
                         four["bridge_P"]["row_nnz"]).size)
    assert abs(out["solo"]["solve"]["iterations"]
               - out["filter"]["solve"]["iterations"]) <= 1
