"""Vectorized host-NumPy level loop of the algebraic setup.

Counterpart of ``raptor_tpu/setup/host_setup.py``: the same algorithms as
the reference's device levels (strength, PMIS, interpolation, Galerkin RAP),
in vectorized NumPy over the identical entry-major ELL layout, with the same
integer PMIS weights, so C/F splittings are bit-identical and interpolation
and RAP values agree to fp32 rounding.  ``build_hierarchy`` hands every
level with ``n <= AmgConfig.host_setup_threshold`` to ``host_build_tail``,
geo-split and aggressive levels included; the levels above it come from
the device route.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, _np, ell_from_csr, pad_rows
from raptor_tpu_torch.setup.splitting import (
    C_PT,
    F_PT,
    UNDECIDED,
    make_perm_ids_np,
    make_perm_np,
    rs_splitting_host,
)

__all__ = ["host_build_tail", "np_strength_mask", "np_pmis_splitting",
           "np_direct_interpolation", "np_distance_two_interpolation"]


# ---------------------------------------------------------------------------
# ELL (numpy) <-> scipy
# ---------------------------------------------------------------------------

def _ell_np(A: EllMatrix):
    """An EllMatrix's arrays as host numpy (tensors are copied once)."""
    return _np(A.data), _np(A.cols), _np(A.row_nnz)


def _pad_K(E: EllMatrix, k: int) -> EllMatrix:
    """Append zero slots so E's width matches the bucketed width
    (hierarchy._bucket8) the reference gives every level."""
    if E.K >= k:
        return E
    zd = np.zeros((k - E.K, E.n_rows_pad), np.asarray(E.data).dtype)
    zc = np.zeros((k - E.K, E.n_rows_pad), np.int32)
    return dataclasses.replace(
        E,
        data=np.concatenate([np.asarray(E.data), zd], axis=0),
        cols=np.concatenate([np.asarray(E.cols), zc], axis=0),
    )


def _ell_np_to_coo(data, cols, nnz, n_logical, m_logical):
    """ELL arrays -> scipy coo of the logical shape (drops padding rows,
    padding slots and identity-padding columns)."""
    import scipy.sparse as sp

    K, n_pad = data.shape
    k = np.arange(K)[:, None]
    rows = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    mask = (k < nnz[None, :]) & (rows < n_logical) & (cols < m_logical)
    return sp.coo_matrix(
        (data[mask], (rows[mask], cols[mask])),
        shape=(n_logical, m_logical),
    )


# ---------------------------------------------------------------------------
# Strength + PMIS
# ---------------------------------------------------------------------------

def np_strength_mask(data, cols, nnz, theta: float, kind: str = "classical"):
    """Strength-of-connection mask on (K, n_pad) arrays."""
    K, n_pad = data.shape
    k = np.arange(K)[:, None]
    rows = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    slot = k < nnz[None, :]
    off = (cols != rows) & slot
    with np.errstate(invalid="ignore"):
        if kind == "classical":
            v = np.where(off, -data, -np.inf)
            row_max = v.max(axis=0)
            return off & (v >= theta * row_max) & (row_max > 0) & (v > 0)
        if kind == "abs":
            v = np.where(off, np.abs(data), 0)
            row_max = v.max(axis=0)
            return off & (v >= theta * row_max) & (v > 0)
    raise ValueError(f"unknown strength kind: {kind}")


def _segment_max_plan(tgt: np.ndarray):
    """Sort-once plan for repeated segment maxima: (order, starts, touched)
    so that ``out[touched] = maximum.reduceat(v[order], starts)``."""
    order = np.argsort(tgt, kind="stable")
    sorted_tgt = tgt[order]
    starts = np.flatnonzero(
        np.r_[True, sorted_tgt[1:] != sorted_tgt[:-1]])
    touched = sorted_tgt[starts]
    return order, starts, touched


def np_pmis_splitting(cols, smask, perm, n_pad: int):
    """PMIS: synchronous rounds with exact integer weights
    ``min(lambda, 63) * n_pad + perm``, hence a tie-free, reproducible C/F
    splitting."""
    rows = np.broadcast_to(
        np.arange(n_pad, dtype=np.int64)[None, :], cols.shape)
    lam = np.zeros(n_pad, np.int64)
    np.add.at(lam, cols[smask], 1)
    w = np.minimum(lam, 63) * n_pad + np.asarray(perm, np.int64)

    has_out = smask.any(axis=0)
    iso = ~has_out & (lam == 0)
    cf = np.where(iso, F_PT, UNDECIDED).astype(np.int32)

    scols = cols[smask]
    srows = rows[smask]

    from raptor_tpu_torch.utils.native import pmis_splitting_native

    out = pmis_splitting_native(srows, scols, w, cf)
    if out is not None:
        return out

    # fixed edge list across rounds: sort once per direction, reduceat per round
    r_order, r_starts, r_touched = _segment_max_plan(srows)
    c_order, c_starts, c_touched = _segment_max_plan(scols)
    sc_r = scols[r_order]
    sr_c = srows[c_order]
    while (cf == UNDECIDED).any():
        und = cf == UNDECIDED
        w_und = np.where(und, w, -1)
        row_part = np.full(n_pad, -1, np.int64)
        row_part[r_touched] = np.maximum.reduceat(w_und[sc_r], r_starts)
        col_part = np.full(n_pad, -1, np.int64)
        col_part[c_touched] = np.maximum.reduceat(w_und[sr_c], c_starts)
        nmax = np.maximum(row_part, col_part)
        cf = np.where(und & (w > nmax), C_PT, cf).astype(np.int32)
        c = cf == C_PT
        c_row = np.zeros(n_pad, bool)
        c_row[r_touched] = np.maximum.reduceat(
            c[sc_r].astype(np.int8), r_starts) > 0
        c_col = np.zeros(n_pad, bool)
        c_col[c_touched] = np.maximum.reduceat(
            c[sr_c].astype(np.int8), c_starts) > 0
        cf = np.where((cf == UNDECIDED) & (c_row | c_col), F_PT, cf).astype(
            np.int32)
    return cf


# ---------------------------------------------------------------------------
# Interpolation
# ---------------------------------------------------------------------------

def np_direct_interpolation(data, cols, nnz, smask, cf):
    """Direct interpolation: returns (P_data, P_cols, P_nnz, nc) in the same
    (K, n_pad) ELL layout."""
    K, n_pad = data.shape
    k = np.arange(K)[:, None]
    rows = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    slot = k < nnz[None, :]
    off = (cols != rows) & slot
    a = data
    is_c = cf == C_PT
    cmap = (np.cumsum(is_c) - 1).astype(np.int32)
    diag = np.where((cols == rows) & slot, a, 0).sum(axis=0)

    strong_c = smask & is_c[cols]
    neg = off & (a < 0)
    pos = off & (a > 0)
    num_neg = np.where(neg, a, 0).sum(axis=0)
    num_pos = np.where(pos, a, 0).sum(axis=0)
    den_neg = np.where(strong_c & (a < 0), a, 0).sum(axis=0)
    den_pos = np.where(strong_c & (a > 0), a, 0).sum(axis=0)
    alpha = np.where(den_neg != 0, num_neg / np.where(den_neg != 0, den_neg, 1), 0)
    beta = np.where(den_pos != 0, num_pos / np.where(den_pos != 0, den_pos, 1), 0)
    dii = diag + np.where(den_pos == 0, num_pos, 0)

    coef = np.where(a < 0, alpha[None, :], beta[None, :])
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -(coef * a) / dii[None, :]
    pvals = np.where(strong_c, w, 0).astype(data.dtype)
    pcols = cmap[cols]

    # compact strong-C slots to the front of each row (unique targets)
    slotpos = np.cumsum(strong_c, axis=0) - 1
    lane = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    P_data = np.zeros((K, n_pad), data.dtype)
    P_cols = np.zeros((K, n_pad), np.int32)
    m = strong_c
    P_data[slotpos[m], lane[m]] = pvals[m]
    P_cols[slotpos[m], lane[m]] = pcols[m]
    P_nnz = strong_c.sum(axis=0).astype(np.int32)

    # C rows: identity
    P_data[:, is_c] = 0.0
    P_cols[:, is_c] = 0
    P_data[0, is_c] = 1.0
    P_cols[0, is_c] = cmap[is_c]
    P_nnz[is_c] = 1
    nc = int(is_c.sum())
    return P_data, P_cols, P_nnz, nc


def _np_aggressive_cf(colsA, smask, n: int, n_pad: int, seed: int):
    """NumPy mirror of setup.aggressive.aggressive_splitting: distance-2
    PMIS — the MIS runs on offdiag(G @ G), G = strength + I, with the same
    exact integer weights (host_aggregation._np_pmis_edges), so the C/F
    sets are bit-identical to the device path."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.host_aggregation import _np_pmis_edges

    rows = np.broadcast_to(np.arange(n_pad)[None, :], colsA.shape)
    G = sp.csr_matrix(
        (np.ones(int(smask.sum()) + n_pad, np.float32),
         (np.r_[rows[smask], np.arange(n_pad)],
          np.r_[colsA[smask], np.arange(n_pad)])),
        shape=(n_pad, n_pad))
    G2 = (G @ G).tocoo()
    off = G2.row != G2.col
    perm = make_perm_np(n, n_pad, seed)
    return _np_pmis_edges(G2.row[off], G2.col[off], n_pad, perm)


def _np_multipass(data, colsA, nnz, smask, cf, n: int, max_passes: int = 4):
    """NumPy mirror of setup.aggressive.multipass_interpolation: pass 0 is
    direct interpolation on rows with a strong C neighbor; each later pass
    interpolates still-empty F rows through already-interpolated strong
    neighbors.  Returns (P csr over the PADDED rows, nc)."""
    import scipy.sparse as sp

    K, n_pad = data.shape
    Pd, Pc, Pn, nc = np_direct_interpolation(data, colsA, nnz, smask, cf)
    if nc == 0:
        return None, 0
    P = _ell_np_to_coo(Pd, Pc, Pn, n_pad, nc).tocsr()

    lane = np.arange(n_pad)
    k = np.arange(K)[:, None]
    slot = k < nnz[None, :]
    off = (colsA != lane[None, :]) & slot
    diag = np.where((colsA == lane[None, :]) & slot, data, 0).sum(axis=0)
    row_sum = np.where(off, data, 0).sum(axis=0)
    is_real_f = (cf == F_PT) & (lane < n)
    for _ in range(max_passes):
        done = np.diff(P.indptr) > 0
        todo = is_real_f & ~done
        if not todo.any():
            break
        usable = smask & done[colsA]
        active = todo & usable.any(axis=0)
        if not active.any():
            break
        wmask = usable & active[None, :]
        used_sum = np.where(wmask, data, 0).sum(axis=0)
        dtil = diag + (row_sum - used_sum)
        dtil = np.where(dtil != 0, dtil, 1.0)
        rows_w = np.broadcast_to(lane[None, :], colsA.shape)
        W = sp.csr_matrix(
            (data[wmask], (rows_w[wmask], colsA[wmask])),
            shape=(n_pad, n_pad))
        U = sp.diags(np.where(active, -1.0 / dtil, 0.0)) @ (W @ P)
        P = (P + U).tocsr()  # active rows were empty: addition = set
    return P, nc


def _np_jacobi_refine_p(data, colsA, nnz, cf, P, n: int, omega: float,
                        passes: int, p_max: int):
    """NumPy mirror of setup.aggressive.jacobi_refine_p (hypre's
    jacobi_interp): ``passes`` sweeps of
    P <- trunc_{p_max}(P - omega * D_FF^{-1} A P) on F rows, refining the
    multipass interpolation of an aggressive splitting."""
    import scipy.sparse as sp

    K, n_pad = data.shape
    lane = np.arange(n_pad)
    slot = np.arange(K)[:, None] < nnz[None, :]
    rows = np.broadcast_to(lane[None, :], colsA.shape)
    Acsr = sp.csr_matrix((data[slot], (rows[slot], colsA[slot])),
                         shape=(n_pad, n_pad))
    d = Acsr.diagonal()
    dinv = np.where(d != 0, 1.0 / np.where(d != 0, d, 1.0), 0.0)
    fmask = (np.asarray(cf) == F_PT) & (lane < n)
    Df = sp.diags(np.where(fmask, omega * dinv, 0.0))
    for _ in range(passes):
        P = (P - Df @ (Acsr @ P)).tocsr()
        P.eliminate_zeros()
        P = _np_truncate_p(P, p_max)
    return P.tocsr()


def _np_truncate_p(P, max_elems: int):
    """Interpolation truncation (hypre's P_max_elmts): keep the
    ``max_elems`` largest-|w| entries per row and rescale the kept positive
    and negative parts separately so both partial row sums are preserved."""
    import scipy.sparse as sp

    if max_elems <= 0:
        return P
    P = sp.csr_matrix(P)
    counts = np.diff(P.indptr)
    if counts.max(initial=0) <= max_elems:
        return P
    nnz = len(P.data)
    rows = np.repeat(np.arange(P.shape[0]), counts)
    order = np.lexsort((-np.abs(P.data), rows))
    rank = np.arange(nnz) - np.repeat(P.indptr[:-1], counts)
    keep = np.zeros(nnz, bool)
    keep[order] = rank < max_elems
    pos = P.data > 0
    full_p = np.zeros(P.shape[0])
    full_n = np.zeros(P.shape[0])
    kept_p = np.zeros(P.shape[0])
    kept_n = np.zeros(P.shape[0])
    np.add.at(full_p, rows, np.where(pos, P.data, 0))
    np.add.at(full_n, rows, np.where(~pos, P.data, 0))
    np.add.at(kept_p, rows, np.where(keep & pos, P.data, 0))
    np.add.at(kept_n, rows, np.where(keep & ~pos, P.data, 0))
    sp_ = np.where(kept_p != 0, full_p / np.where(kept_p != 0, kept_p, 1), 1)
    sn_ = np.where(kept_n != 0, full_n / np.where(kept_n != 0, kept_n, 1), 1)
    data = np.where(keep, P.data * np.where(pos, sp_[rows], sn_[rows]), 0.0)
    out = sp.csr_matrix((data, P.indices, P.indptr), shape=P.shape)
    out.eliminate_zeros()
    return out


def np_distance_two_interpolation(data, colsA, nnz, smask, cf,
                                  variant: str = "extended",
                                  p_max: int = 4):
    """SciPy-product distance-two interpolation over the padded rows.

    ``variant='extended'``: extended+i interpolation (hypre's ext+i), the
    standard PMIS companion: the target set of F row i is the distance-two
    coarse set T_i = C_i ∪ (∪_{k∈F^s_i} C_k), and strong F couplings a_ik
    are distributed over row k restricted to T_i ∪ {i}.
    ``variant='classical'``: modified classical (T_i = C_i, no +i term).

    Returns (P csr over the PADDED rows, nc)."""
    import scipy.sparse as sp

    K, n_pad = data.shape
    lane = np.arange(n_pad)
    k = np.arange(K)[:, None]
    slot = k < nnz[None, :]
    rows = np.broadcast_to(lane[None, :], colsA.shape)
    off = (colsA != rows) & slot
    is_c = cf == C_PT
    nc = int(is_c.sum())
    if nc == 0:
        return None, 0
    is_f = ~is_c
    diag = np.where(slot & ~off, data, 0).sum(axis=0)

    strong_c = smask & is_c[colsA]
    strong_f = smask & ~is_c[colsA]

    A = sp.csr_matrix((data[slot], (rows[slot], colsA[slot])),
                      shape=(n_pad, n_pad))
    ones = np.ones(int(strong_c.sum()), np.float64)
    T0 = sp.csr_matrix((ones, (rows[strong_c], colsA[strong_c])),
                       shape=(n_pad, n_pad))
    Sff = sp.csr_matrix((data[strong_f], (rows[strong_f], colsA[strong_f])),
                        shape=(n_pad, n_pad))
    if variant == "extended":
        SffP = sp.csr_matrix(
            (np.ones(Sff.nnz), Sff.indices, Sff.indptr), shape=Sff.shape)
        T = ((T0 + SffP @ T0) > 0).astype(np.float64).tocsr()
        Tden = T + sp.diags(is_f.astype(np.float64))
    else:  # classical: distance-1 common-C distribution, no +i
        T = (T0 > 0).astype(np.float64).tocsr()
        Tden = T

    D_full = (Tden @ A.T).tocsr()
    Sc = Sff.tocoo()
    Dik = np.asarray(D_full[Sc.row, Sc.col]).ravel()
    ok = Dik != 0
    coef = np.where(ok, Sc.data / np.where(ok, Dik, 1), 0.0)
    M = sp.csr_matrix((coef, (Sc.row, Sc.col)), shape=(n_pad, n_pad))
    Contrib = (M @ A).tocsr()

    W = T.multiply(A + Contrib).tocsr()

    # diagonal: weak couplings outside T_i collapse; zero-denominator
    # strong-F couplings fall back to collapsing too; +i cross term for ext
    memb = np.zeros_like(off)
    memb[off] = np.asarray(T[rows[off], colsA[off]]).ravel() > 0
    collapse = np.where(off & ~smask & ~memb, data, 0).sum(axis=0)
    fb = np.zeros(n_pad)
    np.add.at(fb, Sc.row, np.where(ok, 0.0, Sc.data))
    dii = diag.astype(np.float64) + collapse + fb
    if variant == "extended":
        dii = dii + Contrib.diagonal()
    dii = np.where(dii != 0, dii, 1.0)

    Pf = sp.diags(np.where(is_f, -1.0 / dii, 0.0)) @ W
    Pid = sp.csr_matrix(
        (np.ones(nc), (lane[is_c], lane[is_c])), shape=(n_pad, n_pad))
    P = (Pf + Pid).tocsr()[:, is_c].tocsr()
    P = _np_truncate_p(P, p_max)
    return P.astype(data.dtype), nc


def _np_filter_csr(Ac, tol: float):
    """Drop off-diagonal entries with |a_ij| < tol * sqrt(|a_ii a_jj|) and
    lump them into the diagonal."""
    import scipy.sparse as sp

    A = sp.csr_matrix(Ac)
    A.sort_indices()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    offd = A.indices != rows
    mag = np.where(offd, np.abs(A.data), 0)
    dabs = np.abs(A.diagonal())
    drop = offd & (mag < tol * np.sqrt(dabs[rows] * dabs[A.indices]))
    lump = np.zeros(n, A.data.dtype)
    np.add.at(lump, rows, np.where(drop, A.data, 0))
    data = np.where(drop, 0, A.data)
    data = np.where(~offd, data + lump[rows], data)
    out = sp.csr_matrix((data, A.indices, A.indptr), shape=A.shape)
    out.eliminate_zeros()
    return out


# padded rows from which the host routes bound lambda_max(D^-1 A) by
# Gershgorin in place of the power iteration (the reference's switch; its
# device routes always power-iterate)
GERSHGORIN_ROWS = 65536


def _np_estimate_lmax(data, cols, dinv, iters: int = 40, safety: float = 1.1,
                      gershgorin_rows: float = GERSHGORIN_ROWS):
    """Largest eigenvalue of D^-1 A for the Chebyshev smoothers: power
    iteration from the reference's start vector, or, on levels of
    ``gershgorin_rows`` padded rows and more, the Gershgorin bound
    max_i dinv_i * sum_j |a_ij| (a strict upper bound, which is all the
    fourth-kind smoother needs)."""
    n_pad = data.shape[1]
    if n_pad >= gershgorin_rows:
        s = np.abs(data).sum(axis=0) * np.abs(dinv)
        return data.dtype.type(s.max())
    i = np.arange(n_pad, dtype=data.dtype)
    v = np.sin(i * data.dtype.type(0.7511)) + data.dtype.type(0.01)
    v = v / np.linalg.norm(v)
    for _ in range(iters):
        w = dinv * (data * v[cols]).sum(axis=0)
        v = w / np.linalg.norm(w)
    w = dinv * (data * v[cols]).sum(axis=0)
    return data.dtype.type(safety) * (v @ w) / (v @ v)


# ---------------------------------------------------------------------------
# The host level loop
# ---------------------------------------------------------------------------

def _host_level_aux(A: EllMatrix, data, cols, nnz, config: AmgConfig):
    """dinv, colouring and Chebyshev lmax for one host level (numpy).  The
    multicolor smoother's colours come from the graph of (a + a.T) != 0;
    padding rows get colour 0."""
    from raptor_tpu_torch.solve.smoothers import greedy_coloring_host

    K, n_pad = data.shape
    rows = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    k = np.arange(K)[:, None]
    d = np.where((cols == rows) & (k < nnz[None, :]), data, 0).sum(axis=0)
    dinv = (1.0 / np.where(d != 0, d, 1)).astype(data.dtype)
    color, ncolors, lmax = None, 1, None
    if config.smoother == "mcgs":
        a = _ell_np_to_coo(data, cols, nnz, A.shape[0], A.shape[1]).tocsr()
        g = ((a + a.T) != 0).tocsr()
        col_np, ncolors = greedy_coloring_host(g.indptr, g.indices, a.shape[0])
        color = np.zeros(n_pad, dtype=np.int32)
        color[: a.shape[0]] = col_np
    elif config.smoother in ("chebyshev", "cheb4", "block_cheb"):
        lmax = _np_estimate_lmax(data, cols, dinv)
    return dinv, color, ncolors, lmax


def _geo_level(data, colsA, nnz, smask, geo: list, n: int, n_pad: int):
    """One geo-split level: C/F from semicoarsening the longest grid
    dimension, direct interpolation restricted to that dimension's
    couplings, and the GeoTransfer weights.  Returns (Pd, Pc, Pn, nc, cf,
    wm, wp, meta, n_weak): ``n_weak`` counts the F rows with no strong
    coupling along that dimension (the caller bails to PMIS when they are
    many); ``meta`` lacks the coarse padding."""
    from raptor_tpu_torch.setup.hierarchy import _geo_cf

    d = int(np.argmax(geo))
    cf, stride = _geo_cf(n, n_pad, geo, d)
    rows_b = np.broadcast_to(np.arange(n_pad)[None, :], colsA.shape)
    k_b = np.arange(data.shape[0])[:, None]
    m1d = ((k_b < nnz[None, :]) & (colsA != rows_b)
           & (np.abs(colsA - rows_b) == stride))
    Pd, Pc, Pn, nc = np_direct_interpolation(data, colsA, nnz, m1d, cf)
    n_weak = int(((cf[:n] == F_PT) & ~(m1d & smask)[:, :n].any(axis=0)).sum())
    # the two interpolation weights of each F row: toward the coarse point
    # one stride below (wm) and one above (wp)
    cmap = np.cumsum(cf == C_PT) - 1
    is_f = cf == F_PT
    idx = np.arange(n_pad)
    tgt_m = cmap[np.maximum(idx - stride, 0)]
    tgt_p = cmap[np.minimum(idx + stride, n_pad - 1)]
    slot = np.arange(Pd.shape[0])[:, None] < Pn[None, :]
    wm = np.where((Pc == tgt_m[None, :]) & slot & is_f[None, :], Pd, 0).sum(axis=0)
    wp = np.where((Pc == tgt_p[None, :]) & slot & is_f[None, :], Pd, 0).sum(axis=0)
    meta = (n // (geo[d] * stride), geo[d], (geo[d] + 1) // 2, stride, n, n_pad)
    return Pd, Pc, Pn, nc, cf, wm, wp, meta, n_weak


def host_build_tail(A: EllMatrix, levels: list, config: AmgConfig, dtype,
                    row_ids=None, geo: list | None = None, ahyb0=None):
    """Finish a hierarchy on the host: called by ``build_hierarchy`` once
    the level size drops to ``config.host_setup_threshold``.  ``levels``
    holds the already-built levels; returns the complete Hierarchy with
    NumPy leaves.  ``row_ids``: original row identities for permutation-
    invariant PMIS weights (see ``build_hierarchy``).  ``geo``: grid
    extents for geo-split levels; once they are exhausted, or a level among
    the first three has more than n/10 weakly coupled F rows along the
    coarsened dimension, the remaining levels take the PMIS route.
    ``ahyb0``: the DIA planes (``HybridMatrix``) of ``A`` from the device
    geo chain; the first level built here takes them as its ``Ahyb``."""
    from raptor_tpu_torch.core.hybrid import GeoTransfer
    from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level, _bucket8

    ids = None if row_ids is None else np.asarray(row_ids)
    geo = None if geo is None else list(geo)  # the live extents, per level

    out = []  # host-level tuples
    n = A.shape[0]
    while len(levels) + len(out) + 1 < config.max_levels and n > config.coarse_size:
        if (config.interp not in ("direct", "classical", "extended")
                and not config.aggressive):
            raise ValueError(
                f"host setup tail: unsupported interp {config.interp!r}")
        data, colsA, nnz = _ell_np(A)
        A = dataclasses.replace(A, data=data, cols=colsA, row_nnz=nnz)
        n_pad = A.n_rows_pad
        smask = np_strength_mask(data, colsA, nnz, config.theta, config.strength)
        P_pad_csr = None
        geo_w = None  # (wm, wp, meta) of a geo-split level
        if geo is not None and n == int(np.prod(geo)) and max(geo) > 2:
            Pd, Pc, Pn, nc, cf, wm, wp, meta, n_weak = _geo_level(
                data, colsA, nnz, smask, geo, n, n_pad)
            if n_weak > n // 10 and len(levels) + len(out) < 3:
                geo = None  # weak-dimension bail: PMIS from this level on
            else:
                geo_w = (wm, wp, meta)
                d = int(np.argmax(geo))
                geo[d] = (geo[d] + 1) // 2
        if geo_w is None and config.aggressive:
            seed = config.seed + len(levels) + len(out)
            cf = _np_aggressive_cf(colsA, smask, n, n_pad, seed)
            P_pad_csr, nc = _np_multipass(data, colsA, nnz, smask, cf, n)
            if config.interp_refine > 0 and P_pad_csr is not None:
                P_pad_csr = _np_jacobi_refine_p(
                    data, colsA, nnz, cf, P_pad_csr, n,
                    config.interp_refine_omega, config.interp_refine,
                    config.p_max_elements)
        elif geo_w is None:  # the classical route: splitting, then P
            if config.splitting == "rs":
                import scipy.sparse as sp

                rows = np.broadcast_to(np.arange(n_pad)[None, :], smask.shape)
                S = sp.coo_matrix(
                    (np.ones(int(smask.sum())), (rows[smask], colsA[smask])),
                    shape=(n_pad, n_pad)).tocsr()
                cf = rs_splitting_host(S).astype(np.int32)
            else:  # pmis (guarded by build_hierarchy)
                seed = config.seed + len(levels) + len(out)
                perm = (make_perm_ids_np(ids, n_pad, seed) if ids is not None
                        else make_perm_np(n, n_pad, seed))
                cf = np_pmis_splitting(colsA, smask, perm, n_pad)
            if config.interp in ("classical", "extended"):
                P_pad_csr, nc = np_distance_two_interpolation(
                    data, colsA, nnz, smask, cf, variant=config.interp,
                    p_max=config.p_max_elements)
            else:
                Pd, Pc, Pn, nc = np_direct_interpolation(
                    data, colsA, nnz, smask, cf)
        if nc == 0 or nc >= n:
            break
        if ids is not None:
            ids = ids[cf[:n] == C_PT]
        P_csr = (P_pad_csr[:n].tocsr() if P_pad_csr is not None
                 else _ell_np_to_coo(Pd, Pc, Pn, n, nc).tocsr())
        A_csr = _ell_np_to_coo(data, colsA, nnz, n, n).tocsr()
        R_csr = P_csr.T.tocsr()
        Ac_csr = (R_csr @ (A_csr @ P_csr)).tocsr()
        if config.filter_tol > 0:
            Ac_csr = _np_filter_csr(Ac_csr, config.filter_tol)
        # dead coarse rows: identity them
        dead = np.where(Ac_csr.diagonal() == 0)[0]
        if dead.size:
            import scipy.sparse as sp

            keep = ~np.isin(
                np.repeat(np.arange(nc), np.diff(Ac_csr.indptr)), dead)
            coo = Ac_csr.tocoo()
            Ac_csr = (sp.coo_matrix(
                (np.concatenate([coo.data[keep.ravel()],
                                 np.ones(dead.size, coo.data.dtype)]),
                 (np.concatenate([coo.row[keep.ravel()], dead]),
                  np.concatenate([coo.col[keep.ravel()], dead]))),
                shape=Ac_csr.shape)).tocsr()

        dinv, color, ncolors, lmax = _host_level_aux(A, data, colsA, nnz, config)
        nc_pad = pad_rows(nc, config.pad_multiple)
        if P_pad_csr is not None:
            P = dataclasses.replace(
                ell_from_csr(P_csr, dtype=dtype, row_pad_multiple=n_pad,
                             n_cols_pad=nc_pad, identity_pad_rows=False),
                shape=(n, nc))
        else:
            P = EllMatrix(
                data=Pd, cols=Pc,
                row_nnz=np.where(np.arange(n_pad) < n, Pn, 0),
                shape=(n, nc), n_rows_pad=n_pad, n_cols_pad=nc_pad)
        R = _pad_K(ell_from_csr(R_csr, dtype=dtype,
                                row_pad_multiple=config.pad_multiple,
                                n_cols_pad=n_pad, identity_pad_rows=False),
                   _bucket8(int(np.diff(R_csr.indptr).max(initial=1))))
        tg = None if geo_w is None else GeoTransfer(
            wm=geo_w[0].astype(dtype), wp=geo_w[1].astype(dtype),
            meta=(*geo_w[2], nc_pad))
        hyb, ahyb0 = ahyb0, None  # the chain's planes go to the first level
        out.append((A, dinv, P, R, color, lmax, n, ncolors, tg, hyb))
        A = _pad_K(ell_from_csr(Ac_csr, dtype=dtype,
                                row_pad_multiple=config.pad_multiple),
                   _bucket8(int(np.diff(Ac_csr.indptr).max(initial=1))))
        n = nc

    # coarsest level: dense inverse + smoother aux
    data, colsA, nnz = _ell_np(A)
    A = dataclasses.replace(A, data=data, cols=colsA, row_nnz=nnz)
    dinv, color, ncolors, lmax = _host_level_aux(A, data, colsA, nnz, config)
    dense = np.zeros((A.n_rows_pad, A.n_rows_pad), data.dtype)
    k = np.arange(A.K)[:, None]
    rows = np.broadcast_to(np.arange(A.n_rows_pad)[None, :], data.shape)
    m = k < nnz[None, :]
    np.add.at(dense, (rows[m], colsA[m]), data[m])
    # rows >= n are decoupled unit diagonals: invert only the logical block
    mtrue = min(pad_rows(n, 8), A.n_rows_pad)
    inv = np.eye(A.n_rows_pad, dtype=data.dtype)
    inv[:mtrue, :mtrue] = np.linalg.inv(dense[:mtrue, :mtrue])
    out.append((A, dinv, None, None, color, lmax, n, ncolors, None, ahyb0))

    for (Ah, dinv_h, Ph, Rh, color_h, lmax_h, n_h, ncol_h, tg_h, hyb_h) in out:
        levels.append(Level(A=Ah, dinv=dinv_h, P=Ph, R=Rh, color=color_h,
                            cheb_lmax=lmax_h, n=n_h, ncolors=ncol_h,
                            Tgeo=tg_h, Ahyb=hyb_h))
    return Hierarchy(levels=tuple(levels), coarse_inv=inv, config=config)
