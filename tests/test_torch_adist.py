"""The algebraic sharded solve of raptor_tpu_torch (parallel/partition.py,
halo.py, dist.py, taps.py, dist_taps.py) against the JAX package on the CPU.

The port's ranks are spawned processes joined over gloo (``spawn``: a
FileStore in a temporary directory, a time limit per run); their bodies are
in tests/_torch_adist_spmd.py, which imports no JAX.  All work in float64:

* the host plans (``plan_and_remap``, ``distribute_matrix``,
  ``build_taps_plan``) and every rank's rows of them equal the reference's
  global arrays exactly, for square A, rectangular P/R and extra ghosts;
* ``halo_exchange`` fills every referenced halo slot with the right value,
  and ``halo_reduce`` (add, max) folds each halo slot back onto its owner;
* ``dist_spmv``, ``dist_banded_spmv`` (K4's halo form, plain version) and
  ``dist_rect_banded_spmv`` (K6's map_cols form) on 8 ranks are within
  1e-13 of the reference's single-device plain versions on the same plans
  (test_dist_banded.py's tolerance), and the two forms' plain versions
  equal the reference's kernel (``_banded_call`` in interpret mode) and
  ``banded_rect_ref_buf`` on one buffer;
* ``distribute_hierarchy`` on 4 ranks gives each rank the slices of the
  reference's arrays, on a hierarchy carried over from the reference and
  on the port's own;
* ``dist_solve`` on 4 and 8 ranks takes exactly the iterations of the
  reference's single-device ``solve_hier`` on the same hierarchy, with x
  within 1e-9 (test_dist.py's tolerance); ``dist_solve_taps`` takes the
  flat solve's iterations with x within 1e-12 (test_taps.py's).

No JAX ``shard_map`` solve runs here (its XLA:CPU compile makes the
reference's sharded tests slow): the JAX side is its host plans, its
``distribute_hierarchy``, its single-device solves and its plain and
interpreted kernels.  The spawned runs go on a background thread while the
reference computes.
"""

from concurrent.futures import ThreadPoolExecutor

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.api as japi
import raptor_tpu.core.ell as jell
import raptor_tpu.parallel.dist as jdist
import raptor_tpu.parallel.partition as jpart
import raptor_tpu.parallel.taps as jtaps
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.core.hybrid import banded_from_csr as j_banded_from_csr
from raptor_tpu.ops.pallas import banded_kernel as jbk
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.core.hybrid import banded_from_csr
from raptor_tpu_torch.gallery import default_rhs, poisson_2d, poisson_3d
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.parallel import dist as pdist
from raptor_tpu_torch.parallel import spawn
from raptor_tpu_torch.parallel.partition import plan_and_remap
from raptor_tpu_torch.parallel.taps import build_taps_plan
from tests import _torch_adist_spmd
from tests._torch_ref import algebraic_tree_from_jax, shuffled_poisson

SPMV_TOL = 1e-13
X_TOL = 1e-9
TAPS_TOL = 1e-12
VAL_TOL = 1e-12  # the port's own fp64 setup against the reference's
RUN_TIMEOUT = 300.0

ELL_TAIL = 200  # poisson_3d(12): two sharded levels, a tail of two
BAND_TAIL = 500  # shuffled 20^3: three sharded levels, banded A on two
CONFIGS = [(sm, cyc, kr) for sm in ("jacobi", "cheb4") for cyc in ("V", "W")
           for kr in ("cg", "gmres")]
ELL_CFG = dict(splitting="pmis", pad_multiple=64, coarse_size=64)
BAND_CFG = dict(splitting="pmis", interp="direct", smoother="jacobi",
                fine_layout="banded", pad_multiple=8 * 1024, coarse_size=64)


def _cfg_id(c):
    return "-".join(c)


def _sorted20():
    """Shuffled 20^3 with sorted column indices: the banded layouts take
    slots in CSR order, and ell_from_csr sorts a matrix it is given in
    place."""
    A = shuffled_poisson(20)
    A.sort_indices()
    return A


# ---------------------------------------------------------------------------
# the reference's hierarchies and the inputs of the spawned runs
# ---------------------------------------------------------------------------

def _jax_ell(smoother, cycle):
    return japi.setup(poisson_3d(12), JCfg(**ELL_CFG, smoother=smoother,
                                           cycle=cycle), dtype=np.float64)


@pytest.fixture(scope="module")
def jell_hiers():
    """The poisson_3d(12) ELL hierarchy, one per (smoother, cycle): the
    folded coarse tail depends on both."""
    return {(sm, cyc): _jax_ell(sm, cyc) for sm in ("jacobi", "cheb4")
            for cyc in ("V", "W")}


def _jax_band():
    return japi.setup(shuffled_poisson(20), JCfg(**BAND_CFG), dtype=np.float64)


@pytest.fixture(scope="module")
def jband():
    """The reference's banded hierarchy of shuffled 20^3 at pad 8 * 1024."""
    return _jax_band()


def _rhs(n, n_pad):
    b = np.zeros(n_pad)
    b[:n] = default_rhs(n)
    return b


def _band_tree(B):
    return {"vals": np.asarray(B.vals), "pidx": np.asarray(B.pidx),
            "meta": B.meta, "shape": B.shape, "slot_ranges": B.slot_ranges,
            "far": None}


def _inputs(jell_hiers, jb):
    """Everything the spawned runs need, built with the JAX package (the
    hierarchies go over as plain-numpy trees) or from scipy matrices."""
    ell = {c: algebraic_tree_from_jax(h) for c, h in jell_hiers.items()}
    lev0 = jb.levels[0]
    rng = np.random.default_rng(7)
    # a carried banded hierarchy at the banded path's own 1024 padding:
    # level 0 shards over 4 ranks, the coarser ones and the transfers stay
    # on the ELL route
    jb16 = japi.setup(shuffled_poisson(16), JCfg(**dict(BAND_CFG, pad_multiple=8)),
                      dtype=np.float64)
    return {
        "ell": ell, "band16": algebraic_tree_from_jax(jb16),
        "rect": {"Rband": _band_tree(lev0.Rband), "Pband": _band_tree(lev0.Pband),
                 "nf": lev0.A.n_rows_pad, "nc": jb.levels[1].A.n_rows_pad},
        "xf": rng.standard_normal(lev0.A.n_rows_pad),
        "xc": rng.standard_normal(jb.levels[1].A.n_rows_pad),
        "x20": rng.standard_normal(8192),
    }


@pytest.fixture(scope="module")
def inputs(jell_hiers, jband):
    return _inputs(jell_hiers, jband)


def _ell_solve(inputs, sm, cyc, kr, **kw):
    tree = inputs["ell"][(sm, cyc)]
    return dict(kind="solve", tree=tree, tail_size=ELL_TAIL, maxiter=100,
                krylov=kr, b=_rhs(1728, tree["levels"][0]["A"]["n_rows_pad"]),
                **kw)


def _band_solve(**kw):
    return dict(kind="solve", matrix=shuffled_poisson(20), setup_cfg=BAND_CFG,
                key="band20", tail_size=BAND_TAIL, maxiter=100,
                b=_rhs(8000, 8192), **kw)


def _cases4(inputs):
    x20 = inputs["x20"]
    return {
        "matrix": dict(kind="matrix", matrix=poisson_3d(8), pad=32,
                       tree=inputs["ell"][("jacobi", "V")]),
        "halo": dict(kind="halo", matrix=poisson_2d(16), pad=32),
        "distribute_carried": dict(kind="distribute", tree=inputs["band16"],
                                   tail_size=BAND_TAIL),
        "distribute_port": dict(kind="distribute", matrix=shuffled_poisson(20),
                                setup_cfg=BAND_CFG, key="band20",
                                tail_size=BAND_TAIL),
        "reordered": dict(kind="reordered", matrix=shuffled_poisson(20),
                          setup_cfg=dict(BAND_CFG, fine_layout="ell"),
                          level=0, tail_size=BAND_TAIL, x=x20),
        "band_solve": _band_solve(),
        "band_one": _band_solve(solo=True),
        "taps": _ell_solve(inputs, "jacobi", "V", "cg", taps=(2, 2)),
        **{_cfg_id(c): _ell_solve(inputs, *c) for c in CONFIGS},
    }


def _cases8(inputs):
    return {
        "matrix": dict(kind="matrix", matrix=poisson_3d(8), pad=64,
                       tree=inputs["ell"][("jacobi", "V")]),
        "halo": dict(kind="halo", matrix=poisson_2d(16), pad=64),
        "spmv": dict(kind="spmv", matrix=_sorted20(), pad=64,
                     x=inputs["x20"]),
        "rect": dict(kind="rect", **inputs["rect"], xf=inputs["xf"],
                     xc=inputs["xc"]),
        **{_cfg_id(c): _ell_solve(inputs, *c) for c in CONFIGS},
    }


def _spawn(world, cases):
    out = spawn(_torch_adist_spmd.run_cases, world, "gloo", "cpu",
                list(cases.values()), timeout=RUN_TIMEOUT)
    return [dict(zip(cases, per_rank)) for per_rank in out]


@pytest.fixture(scope="module")
def spmd(inputs):
    """The 4- and 8-rank runs, one after the other on a background thread,
    so that they overlap the reference computations of the tests."""
    cases = {4: _cases4(inputs), 8: _cases8(inputs)}
    with ThreadPoolExecutor(1) as pool:
        yield {w: pool.submit(_spawn, w, cases[w]) for w in (4, 8)}


def _close(got, ref, tol, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    assert np.abs(got - ref).max(initial=0.0) <= tol, what


def _rank_block(a, rank, ndev):
    a = np.asarray(a)
    nl = a.shape[-1] // ndev
    return a[..., rank * nl:(rank + 1) * nl]


# ---------------------------------------------------------------------------
# host plans
# ---------------------------------------------------------------------------

def _same_dm(got, jm, rank, ndev, what, tol=0.0):
    """A rank's DistMatrix against the reference's global one."""
    assert got["n_ext"] == jm.halo.n_ext and got["n_local"] == jm.halo.n_local, what
    assert tuple(got["offsets"]) == jm.halo.offsets, what
    for a, b in zip(got["send_idx"], jm.halo.send_idx):
        assert np.array_equal(a, np.asarray(b)[rank]), what
    for a, b in zip(got["recv_tgt"], jm.halo.recv_tgt):
        assert np.array_equal(a, np.asarray(b)[rank]), what
    assert np.array_equal(got["cols"], _rank_block(jm.cols, rank, ndev)), what
    assert np.array_equal(got["row_nnz"], _rank_block(jm.row_nnz, rank, ndev)), what
    _close(got["data"], _rank_block(jm.data, rank, ndev), tol, what)


@pytest.mark.parametrize("op", ["A", "R", "P"])
@pytest.mark.parametrize("world", [4, 8])
def test_distribute_matrix_matches_jax(spmd, jell_hiers, world, op):
    """Every rank's send_idx/recv_tgt rows, offsets, n_ext and remapped
    columns, exact: square A and the rectangular R and P (n_col_owned)."""
    ranks = [r["matrix"] for r in spmd[world].result()]
    if op == "A":
        jm = jpart.distribute_matrix(
            jell.ell_from_csr(poisson_3d(8), dtype=np.float64,
                              row_pad_multiple=8 * world), world)
    else:
        jh = jell_hiers[("jacobi", "V")]
        nf, nc = jh.levels[0].A.n_rows_pad, jh.levels[1].A.n_rows_pad
        E, owned = ((jh.levels[0].R, nf) if op == "R" else (jh.levels[0].P, nc))
        jm = jpart.distribute_matrix(E, world, n_col_owned=owned // world)
    assert len(jm.halo.offsets) >= 1
    for rank, out in enumerate(ranks):
        _same_dm(out[op], jm, rank, world, (rank, op))


def test_plan_and_remap_extra_ghosts_matches_jax():
    E = ell_from_csr(poisson_3d(8), dtype=np.float64, row_pad_multiple=32)
    rng = np.random.default_rng(2)
    extra = [rng.integers(0, E.n_rows_pad, 9) for _ in range(4)]
    plan, cols = plan_and_remap(E.cols, E.row_nnz, 4, 128, extra_ghosts=extra)
    jplan, jcols = jpart.plan_and_remap(E.cols, E.row_nnz, 4, 128,
                                        extra_ghosts=extra)
    assert np.array_equal(cols, jcols)
    assert (plan.offsets, plan.n_local, plan.n_ext) == (
        jplan.offsets, jplan.n_local, jplan.n_ext)
    bare, _ = plan_and_remap(E.cols, E.row_nnz, 4, 128)
    assert plan.n_ext > bare.n_ext  # the extra ghosts widen the halo
    for rank in range(4):
        mine = plan.shard(rank, "cpu")
        for a, b in zip(mine.send_idx + mine.recv_tgt,
                        jplan.send_idx + jplan.recv_tgt):
            assert np.array_equal(a.numpy(), np.asarray(b)[rank])


# ---------------------------------------------------------------------------
# halo exchange
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [4, 8])
def test_halo_exchange_roundtrip(spmd, world):
    """With x = the global index, every real entry's extended-vector slot
    holds its global column (test_dist.py:54, checked entry by entry)."""
    E = ell_from_csr(poisson_2d(16), dtype=np.float64, row_pad_multiple=8 * world)
    nl = E.n_rows_pad // world
    mask = np.arange(E.K)[:, None] < E.row_nnz[None, :]
    for rank, r in enumerate(spmd[world].result()):
        out = r["halo"]
        rows = slice(rank * nl, (rank + 1) * nl)
        m = mask[:, rows]
        assert np.array_equal(out["ext"][out["cols"][m]], E.cols[:, rows][m])
        assert np.array_equal(out["ext"][:nl], np.arange(rank * nl, (rank + 1) * nl))


def _ghost_slots(out, n_ext):
    t = np.concatenate([r for r in out["recv_tgt"]] or [np.zeros(0, int)])
    return t[t < n_ext]


@pytest.mark.parametrize("world", [4, 8])
def test_halo_reduce_is_the_exchange_adjoint(spmd, world):
    """halo_reduce folds every halo slot's value onto the slot's owner: add
    (the exchange's adjoint, <exchange x, y> = <x, reduce y>) and max, on
    floats and integers."""
    ranks = [r["halo"] for r in spmd[world].result()]
    n_ext = ranks[0]["y_ext"].shape[0]
    nl = ranks[0]["add"].shape[0]
    n = nl * world
    want = {"add": np.zeros(n), "max": np.full(n, -np.inf),
            "max_int": np.full(n, np.iinfo(np.int64).min)}
    for rank, out in enumerate(ranks):
        own = slice(rank * nl, (rank + 1) * nl)
        want["add"][own] += out["y_ext"][:nl]
        want["max"][own] = np.maximum(want["max"][own], out["y_ext"][:nl])
        want["max_int"][own] = np.maximum(want["max_int"][own], out["k_ext"][:nl])
    for out in ranks:
        s = _ghost_slots(out, n_ext)
        g = out["ext"][s].astype(np.int64)  # the ghost's global index
        np.add.at(want["add"], g, out["y_ext"][s])
        np.maximum.at(want["max"], g, out["y_ext"][s])
        np.maximum.at(want["max_int"], g, out["k_ext"][s])
    for rank, out in enumerate(ranks):
        own = slice(rank * nl, (rank + 1) * nl)
        _close(out["add"], want["add"][own], 1e-14)
        assert np.array_equal(out["max"], want["max"][own])
        assert np.array_equal(out["max_int"], want["max_int"][own])
    lhs = sum(float(out["ext"] @ out["y_ext"]) for out in ranks)
    rhs = sum(float(np.arange(r * nl, (r + 1) * nl) @ out["add"])
              for r, out in enumerate(ranks))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


# ---------------------------------------------------------------------------
# sharded SpMVs and the two kernel forms' plain versions
# ---------------------------------------------------------------------------

def test_dist_spmv_matches_jax(spmd, inputs):
    A = _sorted20()
    x = inputs["x20"]
    E = jell.ell_from_csr(A, dtype=np.float64, row_pad_multiple=64)
    from raptor_tpu.ops import spmv as jspmv

    y_ref = np.asarray(jspmv(E, jnp.asarray(x[:E.n_rows_pad])))
    y = np.concatenate([r["spmv"]["ell"] for r in spmd[8].result()])
    _close(y, y_ref, SPMV_TOL)


def test_dist_banded_spmv_matches_jax(spmd, inputs):
    """K4's halo form (plain version) on 8 ranks, one tile each, against
    the reference's single-device ``banded_spmv_ref`` on the same plan."""
    jB = j_banded_from_csr(_sorted20(), dtype=np.float64)
    x = inputs["x20"]
    y_ref = np.asarray(jbk.banded_spmv_ref(jB.plan(), jnp.asarray(x)))
    ranks = [r["spmv"] for r in spmd[8].result()]
    for out in ranks:
        assert out["shardable"] and out["plan"]["meta"] == jB.meta
        assert np.array_equal(out["plan"]["pidx"], np.asarray(jB.pidx))
        assert np.array_equal(out["plan"]["vals"], np.asarray(jB.vals))
    _close(np.concatenate([out["banded"] for out in ranks]), y_ref, SPMV_TOL)


def test_unshardable_band_filtered():
    """A tile grid that does not split over the ranks stays on the ELL
    route (test_dist_banded.py:87-93)."""
    A = shuffled_poisson(17)  # n = 4913 -> 5120 = 5 tiles
    B, jB = banded_from_csr(A, dtype=np.float64), j_banded_from_csr(A, dtype=np.float64)
    assert B is not None and pdist._shardable_band(B, 8) is None
    assert jdist._shardable_band(jB, 8) is None
    assert pdist._shardable_band(B, 5) is B  # one tile a rank, kh = 1


@pytest.mark.parametrize("op", ["R", "P"])
def test_dist_rect_banded_spmv_matches_jax(spmd, inputs, op):
    """K6's map_cols form (plain version) on 8 ranks for level 0's R and P
    of a pad_multiple = 8 * 1024 banded hierarchy, against the reference's
    single-device ``banded_spmv_rect_ref``."""
    band = inputs["rect"][f"{op}band"]
    x = inputs["xf"] if op == "R" else inputs["xc"]
    y_ref = np.asarray(jbk.banded_spmv_rect_ref(
        dict(vals=jnp.asarray(band["vals"]), pidx=jnp.asarray(band["pidx"]),
             **dict(zip(("K", "n", "n_cols", "tile", "WpP", "npage"), band["meta"]))),
        jnp.asarray(x)))
    parts = [r["rect"][op] for r in spmd[8].result()]
    assert all(p is not None for p in parts)  # the transfer shards
    _close(np.concatenate(parts), y_ref, SPMV_TOL)


def _local_rect(band, rank, ndev):
    """Rank ``rank``'s plan of a RectBanded tree, as dist_rect_banded_spmv
    builds it (WpP folded into the buffer) and as the reference's
    ``banded_rect_ref_buf`` reads it."""
    K, n, n_cols, tile, WpP, npage = band["meta"]
    t_loc = n // tile // ndev
    tiles = slice(rank * t_loc, (rank + 1) * t_loc)
    return dict(K=K, n=t_loc * tile, tile=tile, WpP=0, npage=npage,
                vals=band["vals"][tiles], pidx=band["pidx"][tiles],
                ranges=band["slot_ranges"])


def _t(plan):
    return dict(plan, vals=torch.from_numpy(np.array(plan["vals"])),
                pidx=torch.from_numpy(np.array(plan["pidx"])))


@pytest.mark.parametrize("rank", [0, 7])
def test_map_cols_form_matches_banded_rect_ref_buf(inputs, rank):
    """The plain map_cols form on rank 0's and rank 7's plans of level 0's
    R over 8 ranks, on one halo-extended buffer of random values, against
    the reference's ``banded_rect_ref_buf``."""
    band = inputs["rect"]["Rband"]
    K, n, n_cols, tile, WpP, npage = band["meta"]
    cols_loc = n_cols // 8
    plan = _local_rect(band, rank, 8)
    buf = np.random.default_rng(rank).standard_normal(cols_loc + npage * 1024)
    y_ref = np.asarray(jbk.banded_rect_ref_buf(
        dict(plan, vals=jnp.asarray(plan["vals"]), pidx=jnp.asarray(plan["pidx"])),
        jnp.asarray(buf), map_cols=cols_loc))
    y = bk.banded_spmv_rect_ref(_t(plan), torch.from_numpy(buf), map_cols=cols_loc)
    _close(y.numpy(), y_ref, SPMV_TOL)


def test_map_cols_form_clamps_like_the_tpu_kernel(inputs):
    """A window that runs off both ends of the buffer (WpP > 0 reaches
    below page 0, a buffer short of the last windows' pages): the plain
    map_cols form against ``_banded_call_rect`` in interpret mode."""
    band = inputs["rect"]["Pband"]
    K, n, n_cols, tile, WpP, npage = band["meta"]
    plan = dict(_local_rect(band, 0, 4), WpP=2)
    pages = 3  # fewer than the last tile's window needs
    buf = np.random.default_rng(5).standard_normal(pages * 1024)
    map_cols = n_cols // 2
    T = plan["n"] // tile
    assert (T - 1) * map_cols // (T * 1024) - 2 + npage > pages
    y_ref = np.asarray(jbk._banded_call_rect(
        jnp.asarray(plan["vals"]), jnp.asarray(plan["pidx"]), jnp.asarray(buf),
        K=K, n=plan["n"], n_cols=buf.size, tile=tile, WpP=2, npage=npage,
        interpret=True, map_cols=map_cols, ranges=plan["ranges"]))
    y = bk.banded_spmv_rect_ref(_t(plan), torch.from_numpy(buf), map_cols=map_cols)
    _close(y.numpy(), y_ref, SPMV_TOL)


@pytest.fixture(scope="module")
def halo_case():
    """Two tiles of rank 1 of the shuffled 20^3 banded plan on 4 ranks, and
    an x_pad with non-zero halos."""
    jB = j_banded_from_csr(shuffled_poisson(20), dtype=np.float64)
    K, n, tile, kh, npage, Wp = jB.meta
    plan = dict(jB.plan(), n=2 * tile, vals=np.asarray(jB.vals)[2:4],
                pidx=np.asarray(jB.pidx)[2:4])
    x_pad = np.random.default_rng(9).standard_normal(2 * tile + 2 * kh * tile)
    y_ref = np.asarray(jbk._banded_call(
        jnp.asarray(plan["vals"]), jnp.asarray(plan["pidx"]), jnp.asarray(x_pad),
        K=K, n=plan["n"], tile=tile, kh=kh, npage=npage, interpret=True,
        ranges=plan["ranges"]))
    return _t(plan), torch.from_numpy(x_pad), y_ref


@pytest.mark.parametrize("form", ["plain", "staged", "direct"])
def test_k4_halo_form_matches_banded_call(halo_case, form):
    """K4's halo form against the TPU kernel ``_banded_call`` in interpret
    mode on the same x_pad: the plain version, and the block-by-block
    emulation of the staged and the direct kernel (x views at 16-byte
    remainders 0 and 3)."""
    plan, x_pad, y_ref = halo_case
    if form == "plain":
        _close(bk.banded_spmv_halo_ref(plan, x_pad).numpy(), y_ref, SPMV_TOL)
        return
    lp = bk.banded_launch_plan(plan, staged=form == "staged")
    for mis in (0, 3):
        y = bk.banded_spmv_tiled_ref(plan, x_pad, lp, mis, halo=True)
        _close(y.numpy(), y_ref, SPMV_TOL)
        assert torch.equal(y, bk.banded_spmv_halo_ref(plan, x_pad))


# ---------------------------------------------------------------------------
# distribution of a hierarchy
# ---------------------------------------------------------------------------

def _same_band(got, jB, rank, ndev, what, tol):
    assert (got is None) == (jB is None), what
    if got is None:
        return
    assert tuple(got["meta"]) == jB.meta, what
    t = np.asarray(jB.pidx).shape[0] // ndev
    assert np.array_equal(got["pidx"], np.asarray(jB.pidx)[rank * t:(rank + 1) * t]), what
    _close(got["vals"], np.asarray(jB.vals)[rank * t:(rank + 1) * t], tol, what)


@pytest.mark.parametrize("which", ["carried", "port"])
def test_distribute_hierarchy_matches_jax(spmd, jband, which):
    """Each rank's blocks are the slices of the reference's
    distribute_hierarchy arrays; the same levels carry Aband/Pband/Rband;
    the replicated tail is the same.  ``carried``: the reference's own
    shuffled 16^3 hierarchy (banded A on level 0 only), converted;
    ``port``: the port's own setup of shuffled 20^3 at pad 8 * 1024 (A, P
    and R banded), against the reference's setup of it."""
    if which == "carried":
        jh = japi.setup(shuffled_poisson(16), JCfg(**dict(BAND_CFG, pad_multiple=8)),
                        dtype=np.float64)
        tol, tail_tol = 0.0, TAPS_TOL
    else:
        jh, tol, tail_tol = jband, VAL_TOL, VAL_TOL
    jd = jdist.distribute_hierarchy(jh, 4, tail_size=BAND_TAIL)
    ranks = [r[f"distribute_{which}"] for r in spmd[4].result()]
    has = lambda lv, nm: getattr(lv, nm) is not None  # noqa: E731
    if which == "port":
        assert all(has(jd.levels[0], nm) for nm in ("Aband", "Pband", "Rband"))
    else:
        assert has(jd.levels[0], "Aband") and not has(jd.levels[0], "Rband")
    for rank, out in enumerate(ranks):
        assert len(out["levels"]) == len(jd.levels)
        for k, (tl, jl) in enumerate(zip(out["levels"], jd.levels)):
            what = (rank, k)
            assert (tl["n"], tl["n_local"]) == (jl.n, jl.n_local), what
            _same_dm(tl["A"], jl.A, rank, 4, what, tol)
            for nm, jm in (("P", jl.Pmat), ("R", jl.Rmat)):
                assert (tl[nm] is None) == (jm is None), what
                if jm is not None:
                    _same_dm(tl[nm], jm, rank, 4, (what, nm), tol)
            _close(tl["dinv"], _rank_block(jl.dinv, rank, 4), tol, what)
            for nm in ("Aband", "Pband", "Rband"):
                _same_band(tl[nm], getattr(jl, nm), rank, 4, (what, nm), tol)
        _close(out["bridge_P"], jd.bridge_P.data, tol)
        _close(out["bridge_R"], jd.bridge_R.data, tol)
        assert out["tail_n"] == [lv.n for lv in jd.tail.levels]
        for a, lv in zip(out["tail_A"], jd.tail.levels):
            _close(a, lv.A.data, tol)
        assert out["tail_start"] == jd.tail.tail_start
        assert (out["tail_op"] is None) == (jd.tail.tail_op is None)
        if out["tail_op"] is not None:
            _close(out["tail_op"], jd.tail.tail_op, tail_tol)


def test_shardable_band_refuses_a_reordered_layout():
    """A coarse level that RCM re-banded lives in another ordering than its
    vectors: the port refuses to shard it (the reference's guard lets it
    through)."""
    from raptor_tpu_torch.core.hybrid import banded_from_ell

    E = ell_from_csr(shuffled_poisson(20), dtype=np.float64,
                     row_pad_multiple=8192)
    B = banded_from_ell(E, reorder=True)
    assert B is not None and B.reordered and B.far is None
    assert pdist._shardable_band(B, 4) is None
    assert pdist._shardable_band(dataclasses.replace(B, reordered=False), 4) is not None


def test_reordered_level_takes_the_ell_route(spmd):
    """Sharded over 4 ranks, the reordered level's operator apply is the
    ELL halo SpMV, equal to the single-device apply through the layout's
    permutation within 1e-13; the banded route without the permutation
    (the reference's) would be wrong."""
    for out in (r["reordered"] for r in spmd[4].result()):
        assert out["reordered"] and not out["sharded_band"]
        assert np.array_equal(out["y"], out["y_ell"])
        _close(out["y"], out["y_single"], SPMV_TOL)
        err = np.abs(out["y_unguarded"] - out["y_single"]).max()
        assert err > 1e-3 * np.abs(out["y_single"]).max()


# ---------------------------------------------------------------------------
# sharded solves
# ---------------------------------------------------------------------------

def _jax_solve(jh, krylov):
    bd = jnp.asarray(_rhs(jh.levels[0].n, jh.levels[0].A.n_rows_pad))
    x, info = japi.solve_hier(jh, bd, tol=1e-8, maxiter=100, krylov=krylov)
    return np.asarray(x), int(info.iterations)


def _check_solve(ranks, x_ref, it_ref):
    for out in ranks:
        assert out["status"] == 0 and out["relres"] <= 1e-8
        assert out["iterations"] == it_ref
    _close(ranks[0]["x"], x_ref, X_TOL)


@pytest.mark.parametrize("config", CONFIGS, ids=_cfg_id)
@pytest.mark.parametrize("world", [4, 8])
def test_dist_solve_matches_jax(spmd, jell_hiers, world, config):
    """poisson_3d(12), two sharded levels and the folded tail: the
    reference's single-device solve's iterations exactly, x within 1e-9
    (test_dist.py:91, :184, :237, :264)."""
    sm, cyc, kr = config
    x_ref, it_ref = _jax_solve(jell_hiers[(sm, cyc)], kr)
    ranks = [r[_cfg_id(config)] for r in spmd[world].result()]
    assert ranks[0]["n_sharded"] == 2
    _check_solve(ranks, x_ref, it_ref)
    A = poisson_3d(12)
    b = default_rhs(A.shape[0])
    x = ranks[0]["x"][: A.shape[0]]
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-7


@pytest.fixture(scope="module")
def jax_band_solve(jband):
    return _jax_solve(jband, "cg")


def test_dist_banded_solve_matches_jax(spmd, jax_band_solve):
    """Banded operators and banded transfers on the sharded levels (K4's
    halo form, K6's map_cols form; test_dist_banded.py:96-180) against the
    reference's single-device banded solve."""
    ranks = [r["band_solve"] for r in spmd[4].result()]
    assert ranks[0]["banded"][:2] == [True, True]
    assert ranks[0]["banded_txf"][0]
    _check_solve(ranks, *jax_band_solve)


def test_dist_banded_solve_one_rank_equals_four(spmd, jax_band_solve):
    """A ring of one (every halo is the rank's own edge slice, and no
    transfer shards) takes the four ranks' iterations, x within 1e-9."""
    runs = spmd[4].result()
    four = runs[0]["band_solve"]
    for r in runs:
        one = r["band_one"]
        assert one["iterations"] == four["iterations"]
        assert not any(one["banded_txf"])
        _close(one["x"], four["x"], X_TOL)
    _check_solve([r["band_one"] for r in runs], *jax_band_solve)


@pytest.mark.parametrize("which", ["ell", "banded"])
def test_comm_report_matches_jax(spmd, jell_hiers, jband, which):
    if which == "ell":
        jh, name, tail = jell_hiers[("jacobi", "V")], "taps", ELL_TAIL
    else:
        jh, name, tail = jband, "band_solve", BAND_TAIL
    ref = jdist.comm_report(jdist.distribute_hierarchy(jh, 4, tail_size=tail))
    for r in spmd[4].result():
        assert r[name]["comm"] == ref


# ---------------------------------------------------------------------------
# TAPS
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", ["A", "R", "P"])
@pytest.mark.parametrize("grid", [(2, 2), (2, 4), (4, 2)])
def test_build_taps_plan_matches_jax(jell_hiers, grid, op):
    jh = jell_hiers[("jacobi", "V")]
    ndev = grid[0] * grid[1]
    owned = {"A": None, "R": jh.levels[0].A.n_rows_pad // ndev,
             "P": jh.levels[1].A.n_rows_pad // ndev}[op]
    E = {"A": jh.levels[0].A, "R": jh.levels[0].R, "P": jh.levels[0].P}[op]
    plan, cols = build_taps_plan(E, *grid, n_col_owned=owned)
    jplan, jcols = jtaps.build_taps_plan(E, *grid, n_col_owned=owned)
    assert np.array_equal(cols, np.asarray(jcols))
    assert (plan.offsets, plan.n_local, plan.n_ext) == (
        jplan.offsets, jplan.n_local, jplan.n_ext)
    names = ("send_idx", "recv_tgt")
    for nm in names:
        for a, b in zip(getattr(plan, nm), getattr(jplan, nm)):
            assert np.array_equal(a, np.asarray(b))
    for nm in ("local_src", "local_tgt"):
        assert np.array_equal(getattr(plan, nm), np.asarray(getattr(jplan, nm)))
    mine = plan.shard(ndev - 1, "cpu")  # the last rank's rows
    for a, b in zip(mine.recv_tgt, jplan.recv_tgt):
        assert np.array_equal(a.numpy(), np.asarray(b)[-1, -1])


def test_dist_solve_taps_matches_flat(spmd):
    """2 nodes x 2 chips: the TAPS exchange fills the flat one's extended
    vector exactly, and the solve takes the flat solve's iterations with x
    within 1e-12 (test_taps.py:23-124)."""
    for r in spmd[4].result():
        out = r["taps"]
        assert all(out["taps_ext_equal"]) and len(out["taps_ext_equal"]) == 4
        assert out["taps_iterations"] == out["iterations"]
        _close(out["taps_x"], out["x"], TAPS_TOL)
