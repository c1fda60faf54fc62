"""Comparisons of the port's dist-built hierarchies (the per-rank
summaries of ``tests/_torch_dist_setup_spmd.summary``) with the JAX
package's ``DistHierarchy`` and with the port's single-device
``Hierarchy``, shared by tests/test_torch_dist_setup.py and
tests/test_torch_dist_setup_aggr.py.  Imports no JAX: the reference's
objects are read through their attributes."""

import numpy as np

from raptor_tpu_torch.core.ell import _np

VAL_TOL = 1e-12
LMAX_TOL = 1e-10


def _rank_block(a, rank, nl):
    return np.asarray(a)[..., rank * nl:(rank + 1) * nl]


def _close(got, ref, tol, what):
    """|got - ref| <= tol * max(1, max|ref|): the array's largest entry sets
    the scale (classical weights and their Galerkin values reach 1e5 on the
    scaled input)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(1.0, np.abs(ref).max(initial=0.0))
    assert np.abs(got - ref).max(initial=0.0) <= tol * scale, what


def _by_column(cols, data, nnz):
    """Each row's entries sorted by column (padding slots last)."""
    cols, data, nnz = np.asarray(cols), np.asarray(data), np.asarray(nnz)
    key = np.where(np.arange(cols.shape[0])[:, None] < nnz[None, :], cols,
                   np.iinfo(np.int64).max)
    order = np.argsort(key, axis=0, kind="stable")
    return (np.take_along_axis(cols, order, 0),
            np.take_along_axis(data, order, 0))


def _same_dm(got, jm, rank, what, sets=False):
    """A rank's DistMatrix against the reference's global one: plan and
    structure exact, values within VAL_TOL.  ``sets``: each row's entries
    compared as a set (R lists a coarse row's fine rows in global order,
    the reference in the order of its extended vector)."""
    assert (got is None) == (jm is None), what
    if jm is None:
        return
    nl = jm.n_rows_local
    assert got["n_rows_local"] == nl and got["K"] == jm.K, what
    assert tuple(got["shape"]) == tuple(jm.shape), what
    assert got["n_ext"] == jm.halo.n_ext and got["n_local"] == jm.halo.n_local, what
    assert tuple(got["offsets"]) == tuple(jm.halo.offsets), what
    for a, b in zip(got["send_idx"], jm.halo.send_idx):
        assert np.array_equal(a, np.asarray(b)[rank]), what
    for a, b in zip(got["recv_tgt"], jm.halo.recv_tgt):
        assert np.array_equal(a, np.asarray(b)[rank]), what
    cols, data = got["cols"], got["data"]
    jcols, jdata = _rank_block(jm.cols, rank, nl), _rank_block(jm.data, rank, nl)
    assert np.array_equal(got["row_nnz"], _rank_block(jm.row_nnz, rank, nl)), what
    if sets:
        cols, data = _by_column(cols, data, got["row_nnz"])
        jcols, jdata = _by_column(jcols, jdata, got["row_nnz"])
    assert np.array_equal(cols, jcols), what
    _close(data, jdata, VAL_TOL, what)


def _same_ell(got, E, what):
    assert tuple(got["shape"]) == tuple(E.shape), what
    assert np.array_equal(got["cols"], np.asarray(E.cols)), what
    assert np.array_equal(got["row_nnz"], np.asarray(E.row_nnz)), what
    _close(got["data"], np.asarray(E.data), VAL_TOL, what)


def check_build(ranks, jdh, part):
    """Every rank's summary of the port's build against the reference's
    DistHierarchy, one part at a time."""
    assert len(ranks) == jdh.ndev
    for rank, got in enumerate(ranks):
        levels = got["levels"]
        assert [lv["n"] for lv in levels] == [lv.n for lv in jdh.levels]
        for k, (g, lv) in enumerate(zip(levels, jdh.levels)):
            what = (rank, k, part)
            own = slice(rank * lv.n_local, (rank + 1) * lv.n_local)
            if part == "A":
                _same_dm(g["A"], lv.A, rank, what)
            elif part == "P":
                _same_dm(g["P"], lv.Pmat, rank, what)
            elif part == "R":
                _same_dm(g["R"], lv.Rmat, rank, what, sets=True)
            elif part == "smoother":
                _close(g["dinv"], np.asarray(lv.dinv)[own], VAL_TOL, what)
                assert (g["cheb_lmax"] is None) == (lv.cheb_lmax is None), what
                if lv.cheb_lmax is not None:
                    assert abs(g["cheb_lmax"] - float(lv.cheb_lmax)) <= LMAX_TOL
                assert (g["color"] is None) == (lv.color is None), what
                if lv.color is not None:
                    assert np.array_equal(g["color"], np.asarray(lv.color)[own])
                    assert g["ncolors"] == lv.ncolors, what
                assert (g["binv"] is None) == (lv.binv is None), what
                if lv.binv is not None:  # one (b, b) block per b rows
                    nb = g["binv"].shape[0]
                    _close(g["binv"], np.asarray(lv.binv)[rank * nb:(rank + 1) * nb],
                           VAL_TOL, what + ("binv",))
        if part == "tail":
            # the tail's sizes, and its first operator (the last sharded
            # level's Galerkin product); its coarser levels are the host
            # route's, held against the reference's by its own tests
            assert got["tail_n"] == [lv.n for lv in jdh.tail.levels]
            _same_ell(got["tail_A"][0], jdh.tail.levels[0].A, (rank, "tail A"))
            _same_ell(got["bridge_P"], jdh.bridge_P, (rank, "bridge_P"))
            _same_ell(got["bridge_R"], jdh.bridge_R, (rank, "bridge_R"))


# ---------------------------------------------------------------------------
# the dist-built hierarchy against the single-device one
# ---------------------------------------------------------------------------

def _real_ids(cols, nnz) -> np.ndarray:
    """The sorted distinct columns of an ELL's real entries."""
    m = np.arange(cols.shape[0])[:, None] < nnz[None, :]
    return np.unique(cols[m])


def dist_levels(ranks) -> list:
    """The sharded levels gathered over the ranks, each with the level's
    real rows (ids in the block-padded numbering) and its A and P rows
    over global columns."""
    out = []
    n0 = ranks[0]["levels"][0]["n"]
    for k, lv0 in enumerate(ranks[0]["levels"]):
        lv = {key: np.concatenate([r["levels"][k][key] for r in ranks], -1)
              for key in ("A_gcols", "dinv")}
        for key in ("data", "row_nnz"):
            lv["A_" + key] = np.concatenate([r["levels"][k]["A"][key]
                                             for r in ranks], -1)
        if lv0["P"] is not None:
            lv["P_gcols"] = np.concatenate([r["levels"][k]["P_gcols"]
                                            for r in ranks], -1)
            for key in ("data", "row_nnz"):
                lv["P_" + key] = np.concatenate([r["levels"][k]["P"][key]
                                                 for r in ranks], -1)
        else:  # the bridge: the whole P on every rank
            bp = ranks[0]["bridge_P"]
            lv.update(P_gcols=bp["cols"], P_data=bp["data"],
                      P_row_nnz=bp["row_nnz"])
        lv["rows"] = (np.arange(n0) if k == 0 else
                      _real_ids(out[-1]["P_gcols"], out[-1]["P_row_nnz"]))
        out.append(lv)
    return out


def _rows_equal(data, cols, nnz, E, cmap, what):
    """Rows of a gathered ELL (columns renumbered by ``cmap``) bit-equal to
    the real rows of a single-device EllMatrix."""
    ed, ec, en = _np(E.data), _np(E.cols), _np(E.row_nnz)
    n = data.shape[1]
    assert np.array_equal(nnz, en[:n]), what
    k = min(data.shape[0], ed.shape[0])
    assert nnz.max(initial=0) <= k, what
    m = np.arange(k)[:, None] < nnz[None, :]
    assert np.array_equal(np.where(m, cmap[cols[:k]], -1),
                          np.where(m, ec[:k, :n], -1)), what
    assert np.array_equal(np.where(m, data[:k], 0), np.where(m, ed[:k, :n], 0)), what


def check_single(ranks, h, what):
    """The dist-built sharded levels against the single-device hierarchy
    ``h``: per level, A, dinv and P on the real rows, renumbered, bit for
    bit; the coarse size below the last sharded level and its operator
    (the tail's first level)."""
    levels = dist_levels(ranks)
    sizes = [lv.n for lv in h.levels]
    assert [len(lv["rows"]) for lv in levels] == sizes[:len(levels)], what
    coarse = _real_ids(levels[-1]["P_gcols"], levels[-1]["P_row_nnz"])
    assert len(coarse) == sizes[len(levels)], what
    for k, lv in enumerate(levels):
        rows = lv["rows"]
        nxt = levels[k + 1]["rows"] if k + 1 < len(levels) else coarse
        cmap_a = np.zeros(rows.max() + 1, np.int64)
        cmap_a[rows] = np.arange(rows.size)
        cmap_p = np.zeros(nxt.max() + 1, np.int64)
        cmap_p[nxt] = np.arange(nxt.size)
        ref = h.levels[k]
        _rows_equal(lv["A_data"][:, rows], lv["A_gcols"][:, rows],
                    lv["A_row_nnz"][rows], ref.A, cmap_a, (what, k, "A"))
        assert np.array_equal(lv["dinv"][rows], _np(ref.dinv)[:rows.size])
        _rows_equal(lv["P_data"][:, rows], lv["P_gcols"][:, rows],
                    lv["P_row_nnz"][rows], ref.P, cmap_p, (what, k, "P"))
    At = ranks[0]["tail_A"][0]
    _rows_equal(At["data"][:, coarse], At["cols"][:, coarse],
                At["row_nnz"][coarse], h.levels[len(levels)].A, cmap_p,
                (what, "tail"))
