"""Vectorized host-NumPy smoothed-aggregation setup.

Counterpart of ``raptor_tpu/setup/host_aggregation.py``: the pipeline of
``setup/aggregation.py`` (nodal condensation, SA strength, distance-2 MIS
roots on G^2 with the same integer PMIS weights, capped assignment
rounds, the straggler pass, the batched-QR tentative P, Jacobi
prolongator smoothing, the Galerkin product) in NumPy and SciPy.
``build_sa_hierarchy`` runs it for inputs of at most
``host_setup_threshold`` rows; the hierarchy comes back with NumPy leaves
and ``Hierarchy.to`` moves it.  Aggregation decisions use exact integer
weights, so they are the device route's wherever the fp32 strength test
agrees (the condensation sums in another order, at most a rounding apart).
``_np_pmis_edges`` is also the aggressive splitting's MIS
(``setup/host_setup._np_aggressive_cf``).
"""

from __future__ import annotations

import numpy as np

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, ell_from_csr, pad_rows
from raptor_tpu_torch.setup.host_setup import (
    GERSHGORIN_ROWS,
    _ell_np,
    _np_estimate_lmax,
    _pad_K,
)
from raptor_tpu_torch.setup.splitting import C_PT, F_PT, UNDECIDED, make_perm_np

__all__ = ["host_build_sa_hierarchy"]


# ---------------------------------------------------------------------------
# segment maxima over a fixed edge list (sort once, reduceat per query)
# ---------------------------------------------------------------------------

class _RowMax:
    """Per-row maxima over a fixed (rows, ·) edge list via one stable sort +
    ``np.maximum.reduceat`` per query (the host_setup PMIS plan, reused for
    the aggregation assignment rounds)."""

    def __init__(self, rows: np.ndarray, n: int):
        self.n = n
        self.order = np.argsort(rows, kind="stable")
        srows = rows[self.order]
        if srows.size == 0:
            self.starts = self.touched = srows
            return
        self.starts = np.flatnonzero(np.r_[True, srows[1:] != srows[:-1]])
        self.touched = srows[self.starts]

    def max(self, edge_vals: np.ndarray, fill) -> np.ndarray:
        out = np.full(self.n, fill, edge_vals.dtype)
        if self.touched.size:
            out[self.touched] = np.maximum.reduceat(
                edge_vals[self.order], self.starts)
        return out


def _np_pmis_edges(srows, scols, n_pad: int, perm: np.ndarray) -> np.ndarray:
    """PMIS on an explicit directed strong-edge list (i -> j means j is a
    strong dependency of i): the np_pmis_splitting rounds with the identical
    ``min(lam,63)*n_pad + perm`` exact integer weights, so the MIS is
    bit-identical to the device pmis_splitting on the same graph."""
    lam = np.bincount(scols, minlength=n_pad).astype(np.int64)
    w = np.minimum(lam, 63) * n_pad + np.asarray(perm, np.int64)
    has_out = np.zeros(n_pad, bool)
    has_out[srows] = True
    iso = ~has_out & (lam == 0)
    cf = np.where(iso, F_PT, UNDECIDED).astype(np.int32)

    rplan = _RowMax(srows, n_pad)   # max over S_i (dependencies)
    cplan = _RowMax(scols, n_pad)   # max over S^T_i (dependents)
    while (cf == UNDECIDED).any():
        und = cf == UNDECIDED
        w_und = np.where(und, w, -1)
        nmax = np.maximum(rplan.max(w_und[scols], -1),
                          cplan.max(w_und[srows], -1))
        cf = np.where(und & (w > nmax), C_PT, cf).astype(np.int32)
        c = cf == C_PT
        c_nbr = (rplan.max(c[scols].astype(np.int8), 0)
                 | cplan.max(c[srows].astype(np.int8), 0)) > 0
        cf = np.where((cf == UNDECIDED) & c_nbr, F_PT, cf).astype(np.int32)
    return cf


# ---------------------------------------------------------------------------
# aggregation (nodal graph in SciPy CSR)
# ---------------------------------------------------------------------------

def _np_aggregate(C, n_nodal: int, nn_pad: int, theta: float, seed: int,
                  size_cap: int):
    """Node -> aggregate map; mirrors setup.aggregation.aggregate on a
    (nn_pad, nn_pad) nodal |·|-condensed CSR with identity padding rows.
    Returns (agg (nn_pad,) int32, n_agg)."""
    import scipy.sparse as sp

    C = sp.csr_matrix(C)
    diag = C.diagonal()
    coo = C.tocoo()
    off = coo.row != coo.col
    # SA symmetric strength |c_ij| >= theta sqrt(c_ii c_jj)
    v = np.abs(coo.data)
    thr = theta * np.sqrt(np.abs(diag[coo.row]) * np.abs(diag[coo.col]))
    strong = off & (v >= thr) & (v > 0)
    srows, scols = coo.row[strong], coo.col[strong]

    # distance-2 MIS roots: PMIS on offdiag(G @ G), G = strength + I
    G = sp.csr_matrix(
        (np.ones(srows.size + nn_pad, np.float32),
         (np.r_[srows, np.arange(nn_pad)], np.r_[scols, np.arange(nn_pad)])),
        shape=(nn_pad, nn_pad))
    G2 = (G @ G).tocoo()
    g2_off = G2.row != G2.col
    perm = make_perm_np(n_nodal, nn_pad, seed)
    cf = _np_pmis_edges(G2.row[g2_off], G2.col[g2_off], nn_pad, perm)

    is_real = np.arange(nn_pad) < n_nodal
    is_root = (cf == C_PT) & is_real
    deg = np.bincount(srows, minlength=nn_pad)
    singleton = is_real & (deg == 0) & ~is_root
    root_like = is_root | singleton
    agg = np.where(root_like, np.cumsum(root_like) - 1, -1).astype(np.int32)

    # two capped assignment rounds over strong edges: join the neighbor
    # aggregate of largest weight (ties -> largest aggregate id)
    w = np.minimum(deg, 63).astype(np.int64) * nn_pad + perm
    splan = _RowMax(srows, nn_pad)
    for _ in range(2):
        sizes = np.bincount(agg[agg >= 0], minlength=n_nodal + 1)
        nbr_agg = agg[scols]
        cand = (nbr_agg >= 0) & (sizes[np.clip(nbr_agg, 0, None)] < size_cap)
        wn = np.where(cand, w[scols], -1)
        m = splan.max(wn, -1)
        pick = splan.max(
            np.where(cand & (wn == m[srows]), nbr_agg, -1).astype(np.int64),
            -1)
        agg = np.where((agg < 0) & (m >= 0), pick, agg).astype(np.int32)

    # straggler pass: join the SMALLEST adjacent aggregate over the full
    # nodal pattern (weak edges included)
    frows, fcols = coo.row[off], coo.col[off]
    sizes = np.bincount(agg[agg >= 0], minlength=n_nodal + 1)
    nbr_agg = agg[fcols]
    cand = nbr_agg >= 0
    wn = np.where(cand, -sizes[np.clip(nbr_agg, 0, None)].astype(np.int64),
                  -np.int64(2) ** 30)
    fplan = _RowMax(frows, nn_pad)
    m = fplan.max(wn, -np.int64(2) ** 30)
    pick = fplan.max(
        np.where(cand & (wn == m[frows]), nbr_agg, -1).astype(np.int64), -1)
    agg = np.where(is_real & (agg < 0) & (pick >= 0), pick, agg).astype(
        np.int32)

    # truly isolated leftovers: their own aggregates
    n_so_far = int(root_like.sum())
    strag = is_real & (agg < 0)
    agg = np.where(strag, n_so_far + np.cumsum(strag) - 1, agg).astype(
        np.int32)
    return agg, n_so_far + int(strag.sum())


def _np_tentative(agg, n_agg: int, B, bs: int, n_dof: int, dtype):
    """Batched-QR tentative prolongator: (P_tent scipy csr (n_pad x
    n_agg*nc), Bc (n_agg*nc, nc)); mirrors aggregation._tentative_jit."""
    import scipy.sparse as sp

    nn = agg.shape[0]
    n_pad, nc = B.shape
    key = np.where(agg >= 0, agg, n_agg)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    counts = np.bincount(skey, minlength=n_agg + 1)
    max_nodes = max(int(counts[:n_agg].max(initial=1)), 1)
    starts = np.r_[0, np.cumsum(counts[:-1])]
    slot = np.arange(nn) - starts[skey]
    ok = (skey < n_agg) & (slot < max_nodes)
    tbl = np.full((n_agg, max_nodes), -1, np.int64)
    tbl[skey[ok], slot[ok]] = order[ok]

    dof = tbl[:, :, None] * bs + np.arange(bs)[None, None, :]
    dof = np.where(tbl[:, :, None] >= 0, dof, -1).reshape(n_agg, -1)
    rows = np.where(dof[:, :, None] >= 0,
                    B[np.clip(dof, 0, None)], 0).astype(dtype)
    Q, R = np.linalg.qr(rows)  # reduced: (n_agg, mn*bs, nc), (n_agg, nc, nc)
    sgn = np.where(np.diagonal(R, axis1=1, axis2=2) < 0, -1, 1).astype(dtype)
    Q = Q * sgn[:, None, :]
    R = R * sgn[:, :, None]

    live = dof >= 0  # (n_agg, mn*bs)
    a_idx = np.broadcast_to(np.arange(n_agg)[:, None], dof.shape)
    prow = np.repeat(dof[live], nc)
    pcol = (a_idx[live][:, None] * nc + np.arange(nc)[None, :]).ravel()
    pval = Q[live].ravel()
    P = sp.csr_matrix((pval, (prow, pcol)), shape=(n_pad, n_agg * nc))
    return P, R.reshape(n_agg * nc, nc).astype(np.float64)


# ---------------------------------------------------------------------------
# block layout + aux (NumPy mirrors of core/bell.py setup-time helpers)
# ---------------------------------------------------------------------------

def _np_block_layout(A_csr_pad, n_logical: int, bs: int, dtype,
                     config: AmgConfig):
    """(Abell, binv, lmax_block): BlockEllMatrix with NumPy leaves (moved
    with the whole hierarchy) mirroring core.bell.ell_to_bell /
    block_diag_inv / estimate_lmax_bell."""
    if config.smoother not in ("block_jacobi", "block_cheb") or bs <= 1:
        return None, None, None
    n_pad = A_csr_pad.shape[0]
    if n_pad % bs or n_logical % bs:
        return None, None, None
    import scipy.sparse as sp

    from raptor_tpu_torch.core.bell import BlockEllMatrix

    a = sp.bsr_matrix(A_csr_pad.astype(dtype), blocksize=(bs, bs))
    nb_pad = n_pad // bs
    nnz = np.diff(a.indptr).astype(np.int32)
    K = max(int(nnz.max(initial=0)), 1)
    data = np.zeros((K, nb_pad, bs, bs), dtype=dtype)
    cols = np.zeros((K, nb_pad), dtype=np.int32)
    if a.nnz:
        r = np.repeat(np.arange(nb_pad), nnz)
        slot = np.arange(len(a.indices)) - np.repeat(a.indptr[:-1], nnz)
        data[slot, r] = a.data.astype(dtype)
        cols[slot, r] = a.indices.astype(np.int32)
    Abell = BlockEllMatrix(
        data=data, cols=cols, row_nnz=nnz,
        shape=(n_logical, n_logical), bs=bs, nb_pad=nb_pad)

    hit = cols == np.arange(nb_pad)[None, :]
    hit &= np.arange(K)[:, None] < nnz[None, :]
    dblk = np.einsum("kn,knij->nij", hit.astype(dtype), data)
    binv = np.linalg.inv(dblk).astype(dtype)

    # lambda_max(Dblk^{-1} A) power iteration (estimate_lmax_bell mirror)
    n = nb_pad * bs
    v = (np.sin(np.arange(n, dtype=dtype) * dtype(0.7511)) + dtype(0.01))
    v = v / np.linalg.norm(v)

    def app(v):
        xg = v.reshape(nb_pad, bs)[cols]          # (K, nb_pad, b)
        y = np.einsum("knij,knj->ni", data, xg)
        return np.einsum("nij,nj->ni", binv, y).reshape(-1)

    for _ in range(40):
        w = app(v)
        v = w / np.linalg.norm(w)
    w = app(v)
    lmax = dtype(1.1) * (v @ w) / (v @ v)
    return Abell, binv, np.asarray(lmax, dtype)


def _np_level_aux(A_ell: EllMatrix, config: AmgConfig,
                  gershgorin_rows: float = GERSHGORIN_ROWS):
    """(dinv, color, ncolors, lmax) for one level — host_setup._host_level_aux
    with the SA smoother set (block smoothers fall back to the scalar
    estimate here; _np_block_layout overrides when a block layout exists)."""
    data, cols, nnz = (np.asarray(A_ell.data), np.asarray(A_ell.cols),
                       np.asarray(A_ell.row_nnz))
    K, n_pad = data.shape
    rows = np.broadcast_to(np.arange(n_pad)[None, :], (K, n_pad))
    k = np.arange(K)[:, None]
    d = np.where((cols == rows) & (k < nnz[None, :]), data, 0).sum(axis=0)
    dinv = (1.0 / np.where(d != 0, d, 1)).astype(data.dtype)
    lmax = None
    if config.smoother in ("chebyshev", "cheb4", "block_cheb"):
        lmax = _np_estimate_lmax(data, cols, dinv,
                                 gershgorin_rows=gershgorin_rows)
    color, ncolors = None, 1
    if config.smoother == "mcgs":
        from raptor_tpu_torch.setup.host_setup import _ell_np_to_coo
        from raptor_tpu_torch.solve.smoothers import greedy_coloring_host

        a = _ell_np_to_coo(data, cols, nnz, A_ell.shape[0],
                           A_ell.shape[1]).tocsr()
        g = ((a + a.T) != 0).tocsr()
        col_np, ncolors = greedy_coloring_host(g.indptr, g.indices,
                                               a.shape[0])
        color = np.zeros(n_pad, dtype=np.int32)
        color[: a.shape[0]] = col_np
    return dinv, color, ncolors, lmax


def _np_lumped_filter(A_csr, tol, bs: int, dtype):
    """NumPy mirror of setup.aggregation._lumped_filter (filtered SA):
    drop off-node entries failing |a_ij| >= tol*sqrt(|a_ii a_jj|), lump
    them into the diagonal.  Same ascending-column accumulation order as
    the device ELL slot sum, so results match the device path."""
    import scipy.sparse as sp

    coo = A_csr.tocoo()
    d = np.abs(A_csr.diagonal())
    thr = dtype(tol) * np.sqrt(d[coo.row] * d[coo.col])  # fp32 chain, as device
    samenode = (coo.row // bs) == (coo.col // bs)
    drop = ~samenode & (np.abs(coo.data) < thr)
    lump = np.zeros(A_csr.shape[0], dtype)
    np.add.at(lump, coo.row[drop], coo.data[drop])
    keep = ~drop
    Af = sp.csr_matrix((coo.data[keep], (coo.row[keep], coo.col[keep])),
                       shape=A_csr.shape, dtype=dtype)
    return (Af + sp.diags(lump, dtype=dtype)).tocsr()


# ---------------------------------------------------------------------------
# the host SA level loop
# ---------------------------------------------------------------------------

def host_build_sa_hierarchy(A, config: AmgConfig, dtype=np.float32, B=None,
                            block_size: int | None = None,
                            gershgorin_rows: float = GERSHGORIN_ROWS):
    """build_sa_hierarchy in NumPy and SciPy: scipy input -> Hierarchy with
    NumPy leaves.  Run by setup.aggregation.build_sa_hierarchy for n <=
    host_setup_threshold.  ``gershgorin_rows``: the padded rows from which
    lambda_max(D^-1 A) is bounded by Gershgorin (the reference's host rule);
    math.inf power-iterates on every level, as the device route does."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.aggregation import AGG_SIZE_CAP
    from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level, _bucket8

    dtype = np.dtype(dtype).type
    n = A.shape[0]
    if B is None:
        B = np.ones((n, 1), dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)[:, : config.num_candidates]
    nc = B.shape[1]
    bs = block_size or (3 if (nc >= 3 and n % 3 == 0) else 1)
    mult = config.pad_multiple * bs // np.gcd(config.pad_multiple, bs)

    A_ell = ell_from_csr(sp.csr_matrix(A), dtype=dtype,
                         row_pad_multiple=mult)
    n_pad = A_ell.n_rows_pad
    # padded operator with identity rows, in the solve dtype (value-parity
    # with the device path, which computes on the fp32 ELL data)
    A_csr = sp.csr_matrix(A).astype(dtype)
    A_csr = sp.block_diag(
        [A_csr, sp.identity(n_pad - n, dtype=dtype, format="csr")],
        format="csr") if n_pad > n else A_csr

    Bd = np.zeros((n_pad, nc), np.float64)
    Bd[:n] = B

    levels = []
    while len(levels) + 1 < config.max_levels and n > config.coarse_size:
        # 1. nodal condensation
        if bs > 1:
            nn_pad = n_pad // bs
            S = sp.csr_matrix(
                (np.ones(n_pad, dtype),
                 (np.arange(n_pad), np.arange(n_pad) // bs)),
                shape=(n_pad, nn_pad))
            absA = A_csr.copy()
            absA.data = np.abs(absA.data)
            C = (S.T @ absA @ S).tocsr()
            n_nodal = n // bs
        else:
            C, nn_pad, n_nodal = A_csr, n_pad, n

        # 2-4. strength + distance-2 MIS + assignment
        agg, n_agg = _np_aggregate(C, n_nodal, nn_pad, config.theta,
                                   config.seed + len(levels), AGG_SIZE_CAP)
        if n_agg == 0 or n_agg * nc >= 0.7 * n:
            break

        # 5. tentative prolongator (batched QR of the candidates)
        P_t, Bc = _np_tentative(agg, n_agg, Bd, bs, n, dtype)
        ncoarse = n_agg * nc

        # 6. smoothing P = (I - omega D^{-1} A) P_t, Galerkin RAP
        dA = A_csr.diagonal()
        dinv_v = (1.0 / np.where(dA != 0, dA, 1)).astype(dtype)
        d0, c0, z0 = _ell_np(A_ell)
        lmax = _np_estimate_lmax(d0, c0, dinv_v, gershgorin_rows=gershgorin_rows)
        omega = dtype(config.sa_omega) / dtype(lmax)
        A_sm = (_np_lumped_filter(A_csr, config.sa_filter, bs, dtype)
                if config.sa_filter > 0 else A_csr)
        P = (P_t - sp.diags(dinv_v * omega) @ (A_sm @ P_t)).tocsr()
        P.eliminate_zeros()
        Ac = (P.T @ (A_csr @ P)).tocsr()

        # coarse padding + dead rows -> unit diagonal (add_identity_padding)
        mult_c = config.pad_multiple * nc // np.gcd(config.pad_multiple, nc)
        nc_pad = pad_rows(ncoarse, mult_c)
        Ac.resize((nc_pad, nc_pad))
        dead = np.flatnonzero(Ac.diagonal() == 0)
        if dead.size:
            keep = ~np.isin(
                np.repeat(np.arange(nc_pad), np.diff(Ac.indptr)), dead)
            coo = Ac.tocoo()
            Ac = sp.csr_matrix(
                (np.r_[coo.data[keep], np.ones(dead.size, dtype)],
                 (np.r_[coo.row[keep], dead], np.r_[coo.col[keep], dead])),
                shape=(nc_pad, nc_pad))

        # level record (ELL numpy leaves; widths bucketed for program reuse)
        dinv_s, color, ncolors, lmax_s = _np_level_aux(A_ell, config, gershgorin_rows)
        Abell, binv, lmax_b = _np_block_layout(A_csr, n, bs, dtype, config)
        if lmax_b is not None:
            lmax_s = lmax_b
        P_ell = _pad_K(
            ell_from_csr(P[:, :ncoarse], dtype=dtype, row_pad_multiple=n_pad,
                         n_cols_pad=nc_pad, identity_pad_rows=False),
            _bucket8(int(np.diff(P.indptr).max(initial=1))))
        R_csr = P.T.tocsr()[:ncoarse]
        R_ell = _pad_K(
            ell_from_csr(R_csr, dtype=dtype, row_pad_multiple=nc_pad,
                         n_cols_pad=n_pad, identity_pad_rows=False),
            _bucket8(int(np.diff(R_csr.indptr).max(initial=1))))
        levels.append(Level(
            A=A_ell, dinv=dinv_s, P=P_ell, R=R_ell, color=color,
            cheb_lmax=lmax_s, n=n, ncolors=ncolors, Abell=Abell, binv=binv))

        # next level: block size nc, candidates Bc
        A_csr, n, bs, n_pad = Ac, ncoarse, nc, nc_pad
        A_ell = _pad_K(
            ell_from_csr(Ac[:ncoarse, :ncoarse], dtype=dtype,
                         row_pad_multiple=mult_c),
            _bucket8(int(np.diff(Ac[:ncoarse].indptr).max(initial=1))))
        Bd = np.zeros((n_pad, nc), np.float64)
        Bd[:ncoarse] = Bc

    # coarsest level
    dinv_s, color, ncolors, lmax_s = _np_level_aux(A_ell, config, gershgorin_rows)
    Abell, binv, lmax_b = _np_block_layout(A_csr, n, bs, dtype, config)
    if lmax_b is not None:
        lmax_s = lmax_b
    levels.append(Level(
        A=A_ell, dinv=dinv_s, P=None, R=None, color=color, cheb_lmax=lmax_s,
        n=n, ncolors=ncolors, Abell=Abell, binv=binv))
    inv = np.linalg.inv(A_csr.toarray().astype(dtype))
    return Hierarchy(levels=tuple(levels), coarse_inv=inv, config=config)
