"""Interpolation operators of the device-level setup.

Counterpart of ``raptor_tpu/setup/interp.py``: direct, modified classical
and the strength-compacted extended+i interpolation, as eager PyTorch on
the operator's device.  Each builds P in the entry-major ELL layout of A;
its column space is the fine padded size (an upper bound) until the host
reads the coarse count and ``tighten_coarse_space`` shrinks it.

Direct interpolation with the ±-splitting: for F point i with strong C
neighbours C_i,

    alpha = sum_{k in N_i} a_ik^-  /  sum_{j in C_i} a_ij^-
    beta  = sum_{k in N_i} a_ik^+  /  sum_{j in C_i} a_ij^+
    w_ij  = -(alpha * a_ij^-  +  beta * a_ij^+) / a~_ii

with positive couplings absorbed into the diagonal when C_i has none.

Every compaction scatters into one extra dump slot (the reference's
dropped updates), and each kept entry has a position of its own.  Float
sums over the slot axis run in slot order (``ops/sparse_ops.py``), so the
weights have the same bits on every device.
"""

from __future__ import annotations

import dataclasses

import torch

from raptor_tpu_torch.core.ell import EllMatrix, pad_rows
from raptor_tpu_torch.ops.sparse_ops import _merge_sorted_rows, _slot_sum
from raptor_tpu_torch.setup.splitting import C_PT

__all__ = ["direct_interpolation", "direct_interpolation_core",
           "classical_interpolation", "classical_interpolation_core",
           "strength_compact", "ext_mm_core", "extended_interpolation_strong",
           "tighten_coarse_space", "add_identity_padding",
           "EXT_DEVICE_MAX_K", "EXT_STRONG_MAX_K"]


def _slot_iota(K: int, n: int, device) -> torch.Tensor:
    return torch.arange(K, device=device)[:, None].expand(K, n)


def _compact(sel, vals, cols, k_out: int):
    """Front-pack the slots ``sel`` of (K, n) ``vals``/``cols`` into width
    ``k_out``; slots past k_out go to the dump row."""
    K, n = sel.shape
    slotpos = torch.cumsum(sel, 0, dtype=torch.int32) - 1
    posk = torch.where(sel & (slotpos < k_out), slotpos, k_out).long()
    data = torch.zeros(k_out + 1, n, dtype=vals.dtype, device=vals.device)
    data.scatter_(0, posk, torch.where(sel, vals, 0))
    out_cols = torch.zeros(k_out + 1, n, dtype=torch.int32, device=vals.device)
    out_cols.scatter_(0, posk, torch.where(sel, cols, 0).to(torch.int32))
    return data[:k_out], out_cols[:k_out]


def _identity_c_rows(P_data, P_cols, p_nnz, is_c_row, cmap_row):
    """C rows of P: one entry 1.0 at the row's own coarse index."""
    Kp, n = P_data.shape
    k0 = _slot_iota(Kp, n, P_data.device) == 0
    one = torch.where(k0, 1.0, 0.0).to(P_data.dtype)
    own = torch.where(k0, cmap_row[None, :], 0)
    return (torch.where(is_c_row[None, :], one, P_data),
            torch.where(is_c_row[None, :], own, P_cols).to(torch.int32),
            torch.where(is_c_row, 1, p_nnz).to(torch.int32))


def _assemble_p_views(A: EllMatrix, strong_c, pvals, is_c_row, cmap_row,
                      cmap_col) -> EllMatrix:
    """Compact slot-aligned P values into an ELL (shared by direct and
    classical interpolation).  ``cmap_col`` is indexed by A's column space,
    ``is_c_row``/``cmap_row`` by its row space."""
    K, n = A.data.shape
    pcols = cmap_col[A.cols.long()]
    P_data, P_cols = _compact(strong_c, pvals, pcols, K)
    p_nnz = strong_c.sum(0, dtype=torch.int32)
    P_data, P_cols, p_nnz = _identity_c_rows(P_data, P_cols, p_nnz, is_c_row,
                                             cmap_row)
    return EllMatrix(data=P_data, cols=P_cols, row_nnz=p_nnz,
                     shape=(A.shape[0], A.n_rows_pad),
                     n_rows_pad=A.n_rows_pad, n_cols_pad=A.n_rows_pad)


def _coarse_map(cf):
    is_c = cf == C_PT
    cmap = (torch.cumsum(is_c, 0, dtype=torch.int32) - 1).to(torch.int32)
    return is_c, cmap


def direct_interpolation_core(A: EllMatrix, smask, is_c_row, is_c_col,
                              cmap_row, cmap_col) -> EllMatrix:
    """Direct interpolation with caller-supplied C/coarse-index views:
    ``is_c_row``/``cmap_row`` over A's row space, ``is_c_col``/``cmap_col``
    over its column space (the same vectors on one device)."""
    off = (A.cols != A.row_index()) & A.slot_mask()
    a = A.data
    strong_c = smask & is_c_col[A.cols.long()]
    neg = off & (a < 0)
    pos = off & (a > 0)
    num_neg = _slot_sum(torch.where(neg, a, 0))
    num_pos = _slot_sum(torch.where(pos, a, 0))
    den_neg = _slot_sum(torch.where(strong_c & (a < 0), a, 0))
    den_pos = _slot_sum(torch.where(strong_c & (a > 0), a, 0))
    alpha = torch.where(den_neg != 0,
                        num_neg / torch.where(den_neg != 0, den_neg, 1), 0)
    beta = torch.where(den_pos != 0,
                       num_pos / torch.where(den_pos != 0, den_pos, 1), 0)
    dii = A.diagonal() + torch.where(den_pos == 0, num_pos, 0)
    coef = torch.where(a < 0, alpha[None, :], beta[None, :])
    w = -(coef * a) / dii[None, :]
    pvals = torch.where(strong_c, w, 0)
    return _assemble_p_views(A, strong_c, pvals, is_c_row, cmap_row, cmap_col)


def direct_interpolation(A: EllMatrix, smask, cf):
    """P from the C/F splitting: identity rows for C points, direct weights
    on the strong C neighbours for F points, empty rows for isolated F
    points.  Returns (P, n_coarse as a 0-d tensor)."""
    is_c, cmap = _coarse_map(cf)
    P = direct_interpolation_core(A, smask, is_c, is_c, cmap, cmap)
    return P, is_c.sum()


def classical_interpolation_core(A: EllMatrix, ext_data, ext_cols_glob,
                                 ext_nnz, smask, is_c_row, is_c_col,
                                 cmap_row, cmap_col, gcol) -> EllMatrix:
    """Modified-classical interpolation with caller-supplied views.  The
    distance-2 pass gathers the neighbour rows ``ext_*`` (on one device,
    A's own arrays) whose columns are in the global id space ``gcol``
    maps A's columns to."""
    K, n = A.data.shape
    K2 = ext_data.shape[0]
    dev = A.data.device
    off = (A.cols != A.row_index()) & A.slot_mask()
    a = A.data
    cl = A.cols.long()
    isc = is_c_col[cl]
    strong_c = smask & isc
    strong_f = smask & ~isc & off
    weak = off & ~smask

    w = torch.where(strong_c, a, 0.0)  # direct a_ij part, slot-aligned
    dii = A.diagonal() + _slot_sum(torch.where(weak, a, 0))
    # row i's strong-C global column set (-1 elsewhere)
    sC_cols = torch.where(strong_c, gcol[cl], -1)
    k2 = torch.arange(K2, device=dev)[:, None]
    for k1 in range(K):
        kk = cl[k1]
        a_ik = a[k1]
        active = strong_f[k1]
        rowk_cols = ext_cols_glob[:, kk]  # (K2, n) global ids
        rowk_vals = ext_data[:, kk]
        rowk_mask = k2 < ext_nnz[kk][None, :]
        eq = rowk_cols[:, None, :] == sC_cols[None, :, :]  # (K2, K, n)
        memb = eq.any(1) & rowk_mask
        den = _slot_sum(torch.where(memb, rowk_vals, 0))
        has = memb.any(0) & (den != 0)
        coef = torch.where(active & has,
                           a_ik / torch.where(den != 0, den, 1), 0.0)
        # per strong-C slot: the sum of the a_kj that land there
        add = _slot_sum(torch.where(eq & rowk_mask[:, None, :],
                                    rowk_vals[:, None, :], 0))  # (K, n)
        w = w + coef[None, :] * add
        dii = dii + torch.where(active & ~has, a_ik, 0)

    pvals = torch.where(strong_c, -w / dii[None, :], 0)
    return _assemble_p_views(A, strong_c, pvals, is_c_row, cmap_row, cmap_col)


def classical_interpolation(A: EllMatrix, smask, cf):
    """Modified classical (Ruge-Stüben) interpolation:

      w_ij = -( a_ij + Σ_{k∈Fs_i} a_ik a_kj / Σ_{m∈Cs_i} a_km ) / ã_ii

    with weak couplings (and F-F pairs lacking a common C) collapsed into
    the diagonal.  Returns (P, n_coarse)."""
    is_c, cmap = _coarse_map(cf)
    gcol = torch.arange(A.n_rows_pad, dtype=torch.int32, device=A.data.device)
    P = classical_interpolation_core(A, A.data, A.cols, A.row_nnz, smask,
                                     is_c, is_c, cmap, cmap, gcol)
    return P, is_c.sum()


# device levels wider than this run ext+i on the strength-compacted
# operator (the reference's full ext+i core grows quadratically in the
# operator width)
EXT_DEVICE_MAX_K = 16

# static strong width of the compacted ext+i: KT = 12*13 = 156 target slots
EXT_STRONG_MAX_K = 12


def _top_abs(absw, p: int):
    """(K, n) bool: each row's ``p`` largest positive entries of ``absw``
    (first index on ties), by ``p`` rounds of argmax."""
    K, n = absw.shape
    lane = torch.arange(K, device=absw.device)[:, None]
    keep = torch.zeros(K, n, dtype=torch.bool, device=absw.device)
    cur = absw
    for _ in range(p):
        oh = lane == cur.argmax(0)[None, :]
        keep |= oh & (cur > 0)
        cur = torch.where(oh, -1.0, cur)
    return keep


def strength_compact(A: EllMatrix, smask, k_out: int):
    """Top-|a| strength compaction: S keeps each row's ``k_out`` largest-
    |a_ij| strong off-diagonal entries, front-packed at width k_out (empty
    slots point at the row itself, value 0); every dropped off-diagonal
    entry is lumped into the returned diagonal ``dii0 = a_ii + sum(dropped
    a_il)``.  Returns (S, dii0)."""
    K, n = A.data.shape
    row = A.row_index()
    off = (A.cols != row) & A.slot_mask()
    a = A.data
    kw = min(k_out, K)
    keep = _top_abs(torch.where(smask & off, a.abs(), -1.0), kw)
    S_data, S_cols = _compact(keep, a, A.cols, kw)
    s_nnz = keep.sum(0, dtype=torch.int32)
    ks = _slot_iota(kw, n, a.device)
    S_cols = torch.where(ks < s_nnz[None, :], S_cols, row[:kw]).to(torch.int32)
    dii0 = A.diagonal() + _slot_sum(torch.where(off & ~keep, a, 0))
    S = EllMatrix(data=S_data, cols=S_cols, row_nnz=s_nnz, shape=A.shape,
                  n_rows_pad=A.n_rows_pad, n_cols_pad=A.n_cols_pad)
    return S, dii0


def _truncate(pvals, t_mask, p_max: int):
    """hypre P_max_elmts: keep each row's p_max largest |w| and rescale the
    kept positive and negative parts so both partial sums are kept."""
    keep = _top_abs(torch.where(t_mask, pvals.abs(), -1.0), p_max)
    pos = pvals > 0
    full_p = _slot_sum(torch.where(pos, pvals, 0))
    full_n = _slot_sum(torch.where(t_mask & ~pos, pvals, 0))
    kept_p = _slot_sum(torch.where(keep & pos, pvals, 0))
    kept_n = _slot_sum(torch.where(keep & ~pos, pvals, 0))
    sc_p = torch.where(kept_p != 0,
                       full_p / torch.where(kept_p != 0, kept_p, 1), 1)
    sc_n = torch.where(kept_n != 0,
                       full_n / torch.where(kept_n != 0, kept_n, 1), 1)
    return torch.where(
        keep, pvals * torch.where(pos, sc_p[None, :], sc_n[None, :]), 0)


def ext_mm_core(S: EllMatrix, ext_data, ext_cols_glob, ext_nnz, ext_ccols,
                ext_rowsum_c, is_c_row, is_c_col, cmap_row, cmap_col,
                gid_row, dii0, p_max: int = 4) -> EllMatrix:
    """Ext+i on a strength-compacted operator S (dropped entries already
    folded into ``dii0``).  Every strong-C entry of a strong-F neighbour k
    lies in the target set by construction, so

        D_ik = ext_rowsum_c[k] + s_ki
        w_ij = -( s_ij + sum_k s_ik s_kj / D_ik ) / d_ii
        d_ii = dii0 + sum_k s_ik s_ki / D_ik + sum_{k: D_ik=0} s_ik

    The contributions (distance-1 strong-C entries and each k's scaled
    strong-C row) key on global coarse ids; one stable sort and a run
    merge sum the duplicates, and P_max truncation finishes the row.

    ``ext_*`` are the (K2, n_ext) rows addressable by ``S.cols`` (on one
    device S's own arrays), ``ext_ccols`` the coarse id of each entry (-1
    for F), ``ext_rowsum_c`` each row's sum of strong-C values, ``gid_row``
    the global id of each local row."""
    K2, n = S.data.shape
    dev = S.data.device
    BIGC = 2**30
    off = S.slot_mask()
    cl = S.cols.long()
    isc_own = is_c_col[cl]
    strong_c = off & isc_own
    strong_f = off & ~isc_own

    cands = [torch.where(strong_c, cmap_col[cl], BIGC)]
    cvals = [torch.where(strong_c, S.data, 0)]
    dii = dii0
    kb = torch.arange(K2, device=dev)[:, None]
    for k1 in range(K2):
        kk = cl[k1]
        rc = ext_cols_glob[:, kk]  # (K2, n)
        rv = ext_data[:, kk]
        rcc = ext_ccols[:, kk]
        vrow = kb < ext_nnz[kk][None, :]
        act = strong_f[k1]
        ski = _slot_sum(torch.where(vrow & (rc == gid_row[None, :]), rv, 0))
        D = ext_rowsum_c[kk] + ski
        ok = D != 0
        coef = torch.where(act & ok, S.data[k1] / torch.where(ok, D, 1), 0)
        dii = dii + coef * ski  # the +i cross term s_ik s_ki / D_ik
        dii = dii + torch.where(act & ~ok, S.data[k1], 0)  # zero-D fallback
        keep = act[None, :] & vrow & (rcc >= 0)
        cands.append(torch.where(keep, rcc, BIGC))
        cvals.append(torch.where(keep, coef[None, :] * rv, 0))
    cand = torch.cat(cands, 0).to(torch.int32)  # (K2*(K2+1), n) coarse ids
    cval = torch.cat(cvals, 0)
    KV = cand.shape[0]
    cand, order = torch.sort(cand, dim=0, stable=True)
    # each of the K2 + 1 candidate groups (the strong-C entries, a strong-F
    # neighbour's row) holds a coarse id once
    oc, ov, p_nnz = _merge_sorted_rows(cand, cval.gather(0, order), BIGC, KV,
                                       max_run=K2 + 1)
    del cand, cval, order

    dii = torch.where(dii != 0, dii, 1)
    t_mask = _slot_iota(KV, n, dev) < p_nnz[None, :]
    pvals = torch.where(t_mask, -ov / dii[None, :], 0)
    if p_max > 0 and KV > p_max:
        pvals = _truncate(pvals, t_mask, p_max)
        Kp = p_max
    else:
        Kp = KV
    sel = pvals != 0
    P_data, P_cols = _compact(sel, pvals, oc, Kp)
    P_data, P_cols, p_nnz = _identity_c_rows(
        P_data, P_cols, sel.sum(0, dtype=torch.int32), is_c_row, cmap_row)
    return EllMatrix(data=P_data, cols=P_cols, row_nnz=p_nnz,
                     shape=(S.shape[0], S.n_rows_pad),
                     n_rows_pad=S.n_rows_pad, n_cols_pad=S.n_rows_pad)


def extended_interpolation_strong(A: EllMatrix, smask, cf, p_max: int = 4,
                                  k_s: int = EXT_STRONG_MAX_K):
    """Ext+i on the strength-compacted operator (``strength_compact`` +
    ``ext_mm_core``), the device levels' extended interpolation.  Returns
    (P, n_coarse)."""
    is_c, cmap = _coarse_map(cf)
    S, dii0 = strength_compact(A, smask, k_s)
    Sl = S.cols.long()
    sc = (S.cols != S.row_index()) & S.slot_mask() & is_c[Sl]
    ccols = torch.where(sc, cmap[Sl], -1)
    rowsum_c = _slot_sum(torch.where(sc, S.data, 0))
    gcol = torch.arange(A.n_rows_pad, dtype=torch.int32, device=A.data.device)
    P = ext_mm_core(S, S.data, S.cols, S.row_nnz, ccols, rowsum_c, is_c, is_c,
                    cmap, cmap, gcol, dii0, p_max=p_max)
    return P, is_c.sum()


def tighten_coarse_space(P: EllMatrix, nc: int,
                         pad_multiple: int = 8) -> EllMatrix:
    """Shrink P's column space to the measured coarse size (metadata only:
    every stored column index is already < nc)."""
    return dataclasses.replace(P, shape=(P.shape[0], nc),
                               n_cols_pad=pad_rows(nc, pad_multiple))


def add_identity_padding(A: EllMatrix, n: int) -> EllMatrix:
    """Give rows >= n (coarse padding from RAP) and dead rows (zero
    diagonal) a unit diagonal, so the padded operator stays SPD."""
    K, npad = A.data.shape
    row = A.row_index()
    k0 = _slot_iota(K, npad, A.data.device) == 0
    dead = A.diagonal() == 0
    padrow = (row >= n) | dead[None, :]
    data = torch.where(padrow & k0, 1.0,
                       torch.where(padrow, 0.0, A.data)).to(A.dtype)
    cols = torch.where(padrow & k0, row,
                       torch.where(padrow, 0, A.cols)).to(torch.int32)
    padded = (torch.arange(npad, device=A.data.device) >= n) | dead
    row_nnz = torch.where(padded, 1, A.row_nnz).to(torch.int32)
    return dataclasses.replace(A, data=data, cols=cols, row_nnz=row_nnz)
