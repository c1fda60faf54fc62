"""The sharded algebraic setup of raptor_tpu_torch
(parallel/dist_setup.py: PMIS, CLJP, direct, classical and extended+i
interpolation, multicolour colours, the RAP) against the JAX package's and
against the port's single-device build, on the CPU.

The port's ranks are four spawned processes joined over gloo; their bodies
are in tests/_torch_dist_setup_spmd.py, which imports no JAX.  The
reference runs ``raptor_tpu.parallel.dist_setup`` under ``shard_map`` on a
four-device mesh (four of the eight virtual CPU devices of
tests/conftest.py).  Everything is fp64 with the reference's own test
settings (tests/distributed/test_dist_algebraic_setup.py:27-36:
``pad_multiple=8*ndev``), except that ``host_setup_threshold`` is the tail
size, not 0: the sharded levels are the same, and the tails, built whole
on every rank, take the host route in both packages instead of compiling
the reference's device-route programs (seconds of XLA compile each, which
tier-1's time budget cannot spare):

* ``_run_split`` (PMIS) and ``_run_split_cljp`` give every rank the slice
  of the reference's C/F vector on poisson_3d(12), bit for bit;
* whole builds (direct + cheb4 over two sharded levels; classical and
  extended+i over one; direct + mcgs, held against the reference's direct
  + cheb4 build, which has the same operators, and the reference's
  ``_host_colors``) give every rank, on every sharded level, the
  reference's A structure, halo plan, P and R structure and mcgs colours
  exactly, and A, dinv, P and R values within 1e-12 of the array's
  largest entry; ``cheb_lmax`` within 1e-10 (the order of the ring sums);
  the tail's level sizes and first operator and the bridge P and R the
  same.  These run on poisson_3d(12) diagonally scaled by seeded draws
  (``tests/_torch_ref.diag_scaled``): the gallery stencil's coarse
  Galerkin values meet the strength threshold exactly (11/18 = 0.25 *
  22/9), a tie the last bit of a sum decides, and the two packages sum in
  different orders (at 12³ the port's level-1 C/F set and the reference's
  part there, and with them the tails);
* on the gallery Poisson itself, ties included, each build (and CLJP's,
  whose reference compiles one program a level, minutes on the CPU)
  equals the port's single-device build up to the block-padded coarse
  renumbering, bit for bit: every sharded level's A, dinv and P, and the
  coarse size below;
* ``dist_solve`` on the port's dist-built hierarchy takes the iterations
  of ``dist_solve`` on the reference's carried across
  (``tests/_torch_ref.dist_tree_from_jax``), with x within 1e-9; every
  dist-built hierarchy solves to 1e-8;
* one rank against four: equal sizes, iterations within one;
* the reference's ValueErrors.

The spawned run goes on a background thread while the reference builds.
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
from raptor_tpu_torch.gallery import default_rhs, poisson_3d
from raptor_tpu_torch.parallel import spawn
from raptor_tpu_torch.setup.hierarchy import build_hierarchy
from tests import _torch_dist_setup_spmd
from tests._torch_dist_setup_check import (VAL_TOL, _close, _real_ids,
                                           check_build, check_single,
                                           dist_levels)
from tests._torch_ref import diag_scaled, dist_tree_from_jax

NDEV = 4
X_TOL = 1e-9  # tests/test_torch_adist.py's
RUN_TIMEOUT = 300.0

SPLIT_N = 12  # the reference's split tests' poisson_3d(12)
BUILD_N = 12
CLJP_N = 10  # the reference's own CLJP build size
TAIL = 256  # at 12^3: two sharded levels, a tail of two
# the classical and extended builds held against the reference shard level
# 0 only (their distance-two passes are level-local; the coarse levels'
# block-padded numbering is held by the cheb4 build): half the reference's
# programs to compile
TAIL_ONE = 600
TAILS = {"cheb4": TAIL, "classical": TAIL_ONE, "extended": TAIL_ONE,
         "mcgs": TAIL}
# the port's builds on the scaled input, each with the reference build it
# is held against (the reference builds three: each costs seconds of XLA
# compile a program)
REF = {"cheb4": "cheb4", "classical": "classical", "extended": "extended",
       "mcgs": "cheb4"}
BUILDS = tuple(REF)
PARTS = ("A", "P", "R", "smoother", "tail")
SINGLE = ("direct", "classical", "extended", "cljp")


def _cfg(tail: int = TAIL, **kw) -> dict:
    base = dict(splitting="pmis", interp="direct", smoother="jacobi",
                pad_multiple=8 * NDEV, coarse_size=64,
                host_setup_threshold=tail)
    base.update(kw)
    return base


CFGS = {"direct": _cfg(), "cheb4": _cfg(smoother="cheb4"),
        "classical": _cfg(interp="classical"),
        "extended": _cfg(interp="extended"), "mcgs": _cfg(smoother="mcgs"),
        "cljp": _cfg(splitting="cljp")}


def _scaled():
    return diag_scaled(poisson_3d(BUILD_N))


def _gallery(name):
    return poisson_3d(CLJP_N if name == "cljp" else BUILD_N)


def _cases() -> dict:
    A = _scaled()
    cases = {f"split_{s}": dict(kind="split", split=s,
                                matrix=poisson_3d(SPLIT_N),
                                cfg=_cfg(splitting=s))
             for s in ("pmis", "cljp")}
    cases.update({name: dict(kind="build", matrix=A,
                             cfg=dict(CFGS[name], host_setup_threshold=TAILS[name]),
                             tail_size=TAILS[name], solve=True)
                  for name in BUILDS})
    cases.update({f"gallery_{name}": dict(kind="build", matrix=_gallery(name),
                                          cfg=CFGS[name], tail_size=TAIL,
                                          solve=True)
                  for name in SINGLE})
    cases["solo"] = dict(kind="build", matrix=poisson_3d(BUILD_N),
                         cfg=CFGS["direct"], tail_size=TAIL, solve=True,
                         solo=True)
    cases["error_rs"] = dict(kind="error", matrix=A, cfg=_cfg(splitting="rs"),
                             tail_size=TAIL)
    cases["error_smoothed"] = dict(kind="error", matrix=A,
                                   cfg=_cfg(interp="smoothed"), tail_size=TAIL)
    cases["error_aggressive_cljp"] = dict(
        kind="error", matrix=A, cfg=_cfg(splitting="cljp", aggressive=True),
        tail_size=TAIL)
    cases["error_small"] = dict(kind="error", matrix=A, cfg=_cfg(),
                                tail_size=A.shape[0])
    return cases


@pytest.fixture(scope="module")
def mesh():
    return make_solve_mesh(NDEV)


def _jax_build(name, mesh):
    cfg = JCfg(**dict(CFGS[name], host_setup_threshold=TAILS[name]))
    return jds.dist_build_hierarchy(_scaled(), cfg, mesh=mesh,
                                    tail_size=TAILS[name], dtype=np.float64)


@pytest.fixture(scope="module")
def jax_cheb4(mesh):
    return _jax_build("cheb4", mesh)


@pytest.fixture(scope="module")
def spmd(jax_cheb4):
    """The four-rank run on a background thread: every case, with the
    reference's direct + cheb4 hierarchy carried across for its solve."""
    cases = _cases()
    cases["cheb4"]["carried"] = [dist_tree_from_jax(jax_cheb4, r)
                                 for r in range(NDEV)]
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _torch_dist_setup_spmd.run_cases, NDEV,
                          "gloo", "cpu", list(cases.values()),
                          timeout=RUN_TIMEOUT)
        yield lambda: [dict(zip(cases, r)) for r in fut.result()]


@pytest.fixture(scope="module")
def jax_builds(mesh, jax_cheb4):
    return {"cheb4": jax_cheb4, "classical": _jax_build("classical", mesh),
            "extended": _jax_build("extended", mesh)}


def check_colors(ranks, jdh):
    """mcgs: every rank's dinv is the reference's, and its colours and
    colour count are those the reference's ``_host_colors`` gives the
    level's global structure (the port's, which the A part holds equal to
    the reference's)."""
    levels = dist_levels(ranks)
    for k, (lv, jl) in enumerate(zip(levels, jdh.levels)):
        n_pad = lv["A_gcols"].shape[1]
        col, ncolors = jds._host_colors(lv["A_gcols"], lv["A_row_nnz"], n_pad)
        col = np.asarray(col)
        for rank, got in enumerate(ranks):
            g = got["levels"][k]
            own = slice(rank * jl.n_local, (rank + 1) * jl.n_local)
            _close(g["dinv"], np.asarray(jl.dinv)[own], VAL_TOL, (rank, k))
            assert np.array_equal(g["color"], col[own]), (rank, k)
            assert g["ncolors"] == ncolors, (rank, k)


def _true_relres(A, x) -> float:
    b = default_rhs(A.shape[0])
    return float(np.linalg.norm(A @ x[:A.shape[0]] - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# whole builds
# ---------------------------------------------------------------------------

# first in the file: the reference's builds run while the ranks work
@pytest.mark.parametrize("part", PARTS)
@pytest.mark.parametrize("name", BUILDS)
def test_build_matches_jax(spmd, jax_builds, name, part):
    ranks = [r[name]["dh"] for r in spmd()]
    if name == "mcgs" and part == "smoother":
        check_colors(ranks, jax_builds[REF[name]])
    else:
        check_build(ranks, jax_builds[REF[name]], part)


# ---------------------------------------------------------------------------
# splittings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("split", ["pmis", "cljp"])
def test_split_matches_jax(spmd, mesh, split):
    """Every rank's C/F shard is the slice of the reference's distributed
    PMIS / CLJP on poisson_3d(12), bit for bit; the C counts are its."""
    cfg = JCfg(**_cfg(splitting=split))
    E = j_ell_from_csr(poisson_3d(SPLIT_N), dtype=np.float64,
                       row_pad_multiple=8 * NDEV)
    perm = j_make_perm(E.shape[0], E.n_rows_pad, cfg.seed)
    A_dist = j_distribute(E, NDEV)
    if split == "cljp":
        import jax.numpy as jnp

        gidx = jnp.arange(E.n_rows_pad, dtype=np.int32)
        cf, cc = jds._run_split_cljp(mesh, A_dist, perm, gidx, cfg, E.n_rows_pad)
    else:
        cf, cc = jds._run_split(mesh, A_dist, perm, cfg, E.n_rows_pad)
    cf, cc = np.asarray(cf), np.asarray(cc)
    nl = E.n_rows_pad // NDEV
    for rank, out in enumerate(spmd()):
        got = out[f"split_{split}"]
        assert np.array_equal(got["cf"], cf[rank * nl:(rank + 1) * nl]), rank
        assert np.array_equal(got["cc"], cc), rank


@pytest.mark.parametrize("name", SINGLE)
def test_build_matches_single_device(spmd, name):
    """On the gallery Poisson, the four-rank build equals the port's
    single-device build up to the coarse renumbering, bit for bit."""
    h = build_hierarchy(ell_from_csr(_gallery(name), dtype=np.float64,
                                     row_pad_multiple=8 * NDEV),
                        AmgConfig(**CFGS[name]), device="cpu")
    check_single([r[f"gallery_{name}"]["dh"] for r in spmd()], h, name)


@pytest.mark.parametrize("name", BUILDS + tuple(f"gallery_{s}" for s in SINGLE))
def test_dist_built_solves(spmd, name):
    """Each dist-built hierarchy solves to 1e-8 (fp64 recurrence), the
    ranks agree, and the true fp64 residual is within 1e-7."""
    outs = [r[name]["solve"] for r in spmd()]
    assert all(o["iterations"] == outs[0]["iterations"] for o in outs)
    assert outs[0]["relres"] <= 1e-8
    A = (_gallery(name[len("gallery_"):]) if name.startswith("gallery_")
         else _scaled())
    assert _true_relres(A, outs[0]["x"]) <= 1e-7


def test_solve_matches_carried(spmd):
    """dist_solve takes the same iterations on the port's own dist-built
    hierarchy as on the reference's carried across, with x within 1e-9:
    a fault would show on the setup side or the solve side, not both."""
    for out in spmd():
        own, carried = out["cheb4"]["solve"], out["cheb4"]["carried_solve"]
        assert own["iterations"] == carried["iterations"]
        _close(own["x"], carried["x"], X_TOL, "x")


def test_one_rank_against_four(spmd):
    """A build on a ring of one (rank 0 alone) has the four-rank build's
    level sizes (the sharded levels, the coarse size below) and its solve
    takes the same iterations within one."""
    out = spmd()[0]
    one, four = out["solo"]["dh"], out["gallery_direct"]["dh"]
    assert [lv["n"] for lv in one["levels"]] == [lv["n"] for lv in four["levels"]]
    assert (_real_ids(one["bridge_P"]["cols"], one["bridge_P"]["row_nnz"]).size
            == _real_ids(four["bridge_P"]["cols"],
                         four["bridge_P"]["row_nnz"]).size)
    assert abs(out["solo"]["solve"]["iterations"]
               - out["gallery_direct"]["solve"]["iterations"]) <= 1


@pytest.mark.parametrize("case,words", [
    ("error_rs", "splitting='pmis' or 'cljp'"),
    ("error_smoothed", "interp='direct'"),
    ("error_aggressive_cljp", "runs on the PMIS engine"),
    ("error_small", "nothing to shard"),
])
def test_errors(spmd, case, words):
    """The reference's ValueErrors: RS splitting, smoothed interpolation,
    aggressive coarsening without PMIS and an input at or below
    tail_size."""
    for out in spmd():
        assert out[case] is not None and words in out[case], out[case]
