"""Fast layouts for general (unstructured) matrices: DIA planes, RCM-banded
paged gathers, and the geo-split transfers.

Counterpart of ``raptor_tpu/core/hybrid.py``.

``HybridMatrix`` lays a matrix whose entries sit on a few constant
diagonals in its given ordering (a grid operator in natural ordering) as
dense DIA planes plus a gather-ELL spill for the rest; its plane part runs
through K1 (``ops/cuda/dia_kernel.py::dia_spmv_v2``).  ``GeoTransfer`` is
the P and R of one geo-split level: static reshapes and weight products,
no gathers and no kernel.

Reverse
Cuthill-McKee gathers a general matrix's entries into a band; the plans of
``ops/banded_plan.py`` tile that band so each tile's x reads fall in a
window of a few 1024-element pages, and the kernels K4/K5/K6
(``ops/cuda/banded_kernel.py``) apply it.  Entries outside the window cap
(rare: distance-2 couplings of natural-ordered coarse operators) go to a
compacted ``FarBlock`` applied with a gather and an ``index_add``.

``BandedMatrix`` is a square operator, ``RectBanded`` a transfer operator
(P or R).  Their leaves are NumPy arrays while a hierarchy is built on the
host and tensors after ``.to(device)``.  Each layout's apply launches its
kernel where the layout lives on the card and runs the kernel's plain
version where it lives elsewhere.

"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.ell import EllMatrix, _np, pad_rows, to_tensor
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.cuda import dia_kernel as dk
from raptor_tpu_torch.ops.sparse_ops import spmv

__all__ = ["HybridMatrix", "hybrid_from_ell", "hybrid_spmv_ro",
           "hybrid_spmv", "hybrid_df64_residual", "GeoTransfer", "geo_prolong", "geo_restrict",
           "FarBlock", "far_spmv_add", "BandedMatrix", "banded_from_csr",
           "banded_from_ell", "banded_spmv_ro", "banded_spmv",
           "banded_df64_residual", "RectBanded", "rect_banded_from_ell",
           "rect_banded_spmv"]


def _opt_to(x, device):
    return None if x is None else x.to(device)


@dataclasses.dataclass(frozen=True)
class HybridMatrix:
    """A matrix as DIA planes in its own ordering plus a gather-ELL spill."""

    planes: Any  # (n_off, n_pad) diagonal planes
    spill: Optional[EllMatrix]  # the entries off the planes, or None
    perm: Any  # (n_pad,) original index of slot i
    iperm: Any  # (n_pad,) slot of original index i
    offsets: Tuple[int, ...]  # linear offsets of the planes
    shape: Tuple[int, int]
    n_pad: int

    def to(self, device) -> "HybridMatrix":
        return dataclasses.replace(
            self, planes=to_tensor(self.planes, device),
            spill=_opt_to(self.spill, device),
            perm=to_tensor(self.perm, device),
            iperm=to_tensor(self.iperm, device))


def hybrid_from_ell(E: EllMatrix, min_fill: float = 0.02,
                    max_offsets: int = 512, reorder: bool = True,
                    pad_multiple: int = 128) -> HybridMatrix:
    """Host structure pass: (optionally) RCM-reorder, then bucket the
    entries by their diagonal offset ``col - row``.  An offset gets a dense
    plane when at least ``min_fill`` of the rows have an entry there (the
    most frequent ones, at most ``max_offsets``); the rest goes to the
    spill.  Leaves are NumPy arrays (``.to(device)`` moves them).

    ``reorder=False`` reads the ELL slots directly (the identity-ordered
    attach of plane mode); ``reorder=True`` RCM-orders the matrix first."""
    import scipy.sparse as sp

    from raptor_tpu_torch.core.ell import ell_from_csr, ell_to_csr

    data = _np(E.data)
    n = E.shape[0]
    n_pad = pad_rows(max(n, 1), pad_multiple)
    perm = np.arange(n_pad, dtype=np.int32)
    iperm = perm.copy()
    if reorder:
        a = ell_to_csr(E).tocsr()
        p = _rcm(a)
        perm[:n] = p
        iperm[p] = np.arange(n)
        ar = a[p][:, p].tocoo()
        rows, cols, vals = ar.row.astype(np.int64), ar.col.astype(np.int64), ar.data
    else:
        cols_e, nnz = _np(E.cols), _np(E.row_nnz)
        rows_b = np.broadcast_to(
            np.arange(E.n_rows_pad, dtype=np.int64)[None, :], cols_e.shape)
        m = ((np.arange(E.K)[:, None] < nnz[None, :]) & (rows_b < n)
             & (cols_e < n))
        rows, cols, vals = rows_b[m], cols_e[m].astype(np.int64), data[m]
    deltas = cols - rows
    uniq, counts = np.unique(deltas, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    keep = np.sort(np.asarray(
        [uniq[i] for i in order[:max_offsets]
         if counts[i] >= max(1, min_fill * n)], dtype=np.int64))
    planes = np.zeros((max(len(keep), 1), n_pad), data.dtype)
    hit = np.zeros(deltas.shape[0], bool)
    if len(keep):
        kidx = np.minimum(np.searchsorted(keep, deltas), len(keep) - 1)
        hit = keep[kidx] == deltas
        planes[kidx[hit], rows[hit]] = vals[hit]
    spill = None
    if not hit.all():
        rem = ~hit
        s = sp.coo_matrix((vals[rem], (rows[rem], cols[rem])),
                          shape=(n, n)).tocsr()
        spill = ell_from_csr(s, dtype=data.dtype, row_pad_multiple=n_pad,
                             identity_pad_rows=False)
        if spill.n_cols_pad < n_pad:
            spill = dataclasses.replace(spill, n_cols_pad=n_pad)
    return HybridMatrix(
        planes=planes, spill=spill, perm=perm, iperm=iperm,
        offsets=tuple(int(d) for d in keep) if len(keep) else (0,),
        shape=tuple(E.shape), n_pad=n_pad)


def _planes_spmv(planes, offsets: Tuple[int, ...],
                 x: torch.Tensor) -> torch.Tensor:
    """``sum_k planes[k] * roll(x, -offsets[k])``: K1 for planes on the card
    (it launches or raises), its plain version for planes elsewhere.  The
    planes are zero wherever ``i + offsets[k]`` leaves the matrix, so the
    rolls' wrap-around adds nothing."""
    apply = dk.dia_spmv_v2 if planes.is_cuda else dk.dia_spmv_v2_ref
    return apply(planes, offsets, x)


def hybrid_spmv_ro(H: HybridMatrix, xr: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the layout's own ordering (the solve-loop form)."""
    yr = _planes_spmv(H.planes, H.offsets, xr)
    if H.spill is not None:
        yr = yr + spmv(H.spill, xr)
    return yr


def hybrid_spmv(H: HybridMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the caller's ordering (permutation applied inside)."""
    return hybrid_spmv_ro(H, x[H.perm])[H.iperm]


def hybrid_df64_residual(H: HybridMatrix, xh, bh, bl, v):
    """(rh, rl) = df64[(bh, bl) - v - A @ xh] over the planes (no spill):
    each plane's product with the shifted xh split exactly by ``two_prod``
    and accumulated by ``df_add``, every product and sum rounded apart (the
    structured engine's compensated residual).  Plain tensor operations on
    any device."""
    from raptor_tpu_torch.utils.df64 import df_add, two_prod

    if H.spill is not None:
        raise ValueError("the DIA-plane residual needs a layout without spill")
    rh, rl = df_add(bh, bl, -v, torch.zeros_like(v))
    for k, o in enumerate(H.offsets):
        sh = xh if o == 0 else torch.roll(xh, -o)
        ph, pe = two_prod(H.planes[k], sh)
        rh, rl = df_add(rh, rl, -ph, -pe)
    return rh, rl


@dataclasses.dataclass(frozen=True)
class FarBlock:
    """Compacted row-subset remainder of a near/far-split banded layout
    (``ops/banded_plan._compact_far``): the entries outside the window cap,
    stored only for the rows that have them.
    Apply: ``y[rows] += sum_k vals[k] * x[cols[k]]``."""

    rows: Any  # (m_pad,) int32 target rows; padding -> pad_row, 0 vals
    cols: Any  # (K_far, m_pad) int32 into the x space
    vals: Any  # (K_far, m_pad)
    meta: Tuple[int, ...]  # (K_far, m)

    def to(self, device) -> "FarBlock":
        return dataclasses.replace(self, rows=to_tensor(self.rows, device),
                                   cols=to_tensor(self.cols, device),
                                   vals=to_tensor(self.vals, device))


def far_spmv_add(y: torch.Tensor, far: Optional[FarBlock],
                 x: torch.Tensor) -> torch.Tensor:
    """y + far @ x (y unchanged when far is None)."""
    if far is None:
        return y
    part = (far.vals.to(y.dtype) * x[far.cols].to(y.dtype)).sum(0)
    return y.index_add(0, far.rows, part)


def _far_from_dict(d) -> Optional[FarBlock]:
    if d is None:
        return None
    return FarBlock(rows=d["rows"], cols=d["cols"], vals=d["vals"],
                    meta=(int(d["cols"].shape[0]), int(d["m"])))


@dataclasses.dataclass(frozen=True)
class BandedMatrix:
    """General square matrix in the RCM-banded paged-gather layout."""

    vals: Any  # (T, K, tile // 128, 128)
    pidx: Any  # (T, K, tile // 128, 128) int32 packed page*1024 + idx
    perm: Any  # (n_pad,) original index of RCM slot
    iperm: Any  # (n_pad,) RCM slot of original index
    meta: Tuple[int, ...]  # (K, n, tile, kh, npage, Wp)
    shape: Tuple[int, int]
    # True when the layout's internal ordering differs from the caller's
    # vector ordering (a coarse level re-banded by RCM): apply through
    # ``banded_spmv`` (gather in / scatter out), not ``banded_spmv_ro``
    reordered: bool = False
    # near/far split: out-of-window remainder, in the ordering of vals/pidx
    far: Optional[FarBlock] = None
    # static per-slot page ranges; slots with lo > hi hold only padding
    slot_ranges: Optional[Tuple] = None

    @property
    def n_pad(self) -> int:
        return self.meta[1]

    def plan(self) -> dict:
        K, n, tile, kh, npage, Wp = self.meta
        return dict(vals=self.vals, pidx=self.pidx, K=K, n=n, tile=tile,
                    kh=kh, npage=npage, Wp=Wp, ranges=self.slot_ranges)

    def to(self, device) -> "BandedMatrix":
        return dataclasses.replace(
            self, vals=to_tensor(self.vals, device),
            pidx=to_tensor(self.pidx, device),
            perm=to_tensor(self.perm, device),
            iperm=to_tensor(self.iperm, device),
            far=_opt_to(self.far, device))


def _banded(plan: dict, perm, iperm, shape, far=None,
            reordered=False) -> BandedMatrix:
    return BandedMatrix(
        vals=plan["vals"], pidx=plan["pidx"], perm=perm, iperm=iperm,
        meta=(plan["K"], plan["n"], plan["tile"], plan["kh"], plan["npage"],
              plan["Wp"]),
        shape=tuple(shape), reordered=reordered, far=_far_from_dict(far),
        slot_ranges=plan.get("ranges"))


def _rcm(a) -> np.ndarray:
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(
        reverse_cuthill_mckee((a + a.T).tocsr(), symmetric_mode=True)
    ).astype(np.int64)


def banded_from_csr(a, dtype=np.float32, tile: int = 1024,
                    reorder: bool = True) -> Optional[BandedMatrix]:
    """scipy.sparse -> BandedMatrix (host structure pass: RCM + plan).
    Returns None when the bandwidth exceeds the plan bounds."""
    import scipy.sparse as sp

    from raptor_tpu_torch.ops.banded_plan import BandedPlanError, banded_plan

    a = sp.csr_matrix(a)
    n = a.shape[0]
    p = _rcm(a) if reorder else np.arange(n, dtype=np.int64)
    ip = np.empty(n, dtype=np.int64)
    ip[p] = np.arange(n)
    ar = a[p][:, p].tocsr()

    n_pad = pad_rows(n, tile)
    nnz = np.zeros(n_pad, np.int32)
    nnz[:n] = np.diff(ar.indptr)
    nnz[n:] = 1
    K = max(int(nnz.max()), 1)
    cols = np.zeros((K, n_pad), np.int64)
    vals = np.zeros((K, n_pad), np.dtype(dtype))
    if ar.nnz:
        r = np.repeat(np.arange(n), np.diff(ar.indptr))
        slot = np.arange(len(ar.indices)) - np.repeat(ar.indptr[:-1],
                                                      np.diff(ar.indptr))
        cols[slot, r] = ar.indices
        vals[slot, r] = ar.data.astype(dtype)
    cols[0, n:] = np.arange(n, n_pad)  # identity pad rows
    vals[0, n:] = 1

    try:
        plan = banded_plan(cols, nnz, vals, tile=tile)
    except BandedPlanError:
        return None
    perm_pad = np.arange(n_pad, dtype=np.int32)
    perm_pad[:n] = p
    iperm_pad = np.arange(n_pad, dtype=np.int32)
    iperm_pad[:n] = ip
    # as in the reference, this layout keeps no slot ranges: every slot is
    # visited (an empty slot only adds zeros)
    return _banded(dict(plan, ranges=None), perm_pad, iperm_pad, a.shape)


def _range_cost(ranges) -> int:
    """Total page-select work of a plan: the sum of per-slot page-range
    lengths."""
    return sum(hi - lo + 1 for lo, hi in ranges if lo <= hi)


def _ranges_coherent(plan: dict, pages_per_slot: int = 4) -> bool:
    """True when a reorder could not meaningfully shrink the plan: either
    the slots are page-coherent or the whole window is already narrow."""
    if plan["npage"] <= 16:
        return True
    r = plan.get("ranges")
    return r is not None and _range_cost(r) <= pages_per_slot * plan["K"]


def banded_from_ell(E: EllMatrix, tile: int = 1024,
                    reorder: bool = False) -> Optional[BandedMatrix]:
    """EllMatrix (already band-ordered, e.g. a level of an RCM-built
    hierarchy) -> BandedMatrix with identity perms.

    ``reorder=True``: when the given ordering exceeds the plan bounds, or
    its plan is page-incoherent, RCM the matrix and keep the re-banded
    layout if it is cheaper; that layout is ``reordered`` (its apply
    permutes in and out).  Either ordering may fall back to a near/far
    split plan."""
    from raptor_tpu_torch.ops.banded_plan import (
        BandedPlanError,
        banded_plan,
        banded_plan_split,
        slots_fit,
    )

    if E.n_rows_pad % tile != 0:
        return None
    vals, cols, nnz = _np(E.data), _np(E.cols), _np(E.row_nnz)
    if not slots_fit(E.K, tile, vals.dtype.itemsize):
        return None  # every plan, in any ordering, would raise
    try:
        plan, far = banded_plan(cols, nnz, vals, tile=tile), None
    except BandedPlanError:
        try:
            plan, far = banded_plan_split(cols, nnz, vals, tile=tile)
        except BandedPlanError:
            plan = None
    if (reorder and plan is not None and far is None
            and not _ranges_coherent(plan)):
        B = _banded_from_ell_rcm(E, tile)
        if (B is not None and B.far is None and B.slot_ranges is not None
                and _range_cost(B.slot_ranges) < _range_cost(plan["ranges"])):
            return B
    if plan is None:
        if not reorder:
            return None
        return _banded_from_ell_rcm(E, tile)
    eye = np.arange(E.n_rows_pad, dtype=np.int32)
    return _banded(plan, eye, eye.copy(), E.shape, far=far)


def _banded_from_ell_rcm(E: EllMatrix, tile: int) -> Optional[BandedMatrix]:
    """RCM-retry half of ``banded_from_ell(reorder=True)``: symmetric-
    permute the logical block (identity-padded tail rows stay in place),
    re-plan, and mark the layout ``reordered``."""
    from raptor_tpu_torch.core.ell import ell_to_csr
    from raptor_tpu_torch.ops.banded_plan import (
        BandedPlanError,
        banded_plan,
        banded_plan_split,
    )

    n = E.shape[0]
    n_pad = E.n_rows_pad
    p = _rcm(ell_to_csr(E).tocsr()[:n, :n])
    perm_pad = np.arange(n_pad, dtype=np.int64)
    perm_pad[:n] = p
    iperm_pad = np.arange(n_pad, dtype=np.int64)
    iperm_pad[p] = np.arange(n)
    vals = _np(E.data)[:, perm_pad]
    nnz = _np(E.row_nnz)[perm_pad]
    # cols: remap ids to the new ordering, then reorder rows
    cols = iperm_pad[_np(E.cols)][:, perm_pad]
    try:
        plan, far = banded_plan(cols, nnz, vals, tile=tile), None
    except BandedPlanError:
        try:
            plan, far = banded_plan_split(cols, nnz, vals, tile=tile)
        except BandedPlanError:
            return None
    return _banded(plan, perm_pad.astype(np.int32),
                   iperm_pad.astype(np.int32), E.shape, far=far,
                   reordered=True)


def banded_spmv_ro(B: BandedMatrix, xr: torch.Tensor) -> torch.Tensor:
    """y = A_rcm @ x in the layout's own ordering: K4 for a layout on the
    card, its plain version for one elsewhere."""
    apply = bk.banded_spmv if B.vals.is_cuda else bk.banded_spmv_ref
    y = apply(B.plan(), xr)
    return far_spmv_add(y, B.far, xr)


def banded_spmv(B: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the caller's ordering (permutation applied inside)."""
    return banded_spmv_ro(B, x[B.perm])[B.iperm]


def banded_df64_residual(B: BandedMatrix, lo_blk, xh, bh, bl, v):
    """(rh, rl) = df64[(bh, bl) - v - A @ xh] in the layout's ordering
    through K5 (its plain version for a layout off the card); ``lo_blk``
    is the optional blocked fp32 truncation remainder of the operator data
    (``setup/hierarchy.attach_residual_lo``)."""
    apply = (bk.banded_df64_residual if B.vals.is_cuda
             else bk.banded_df64_residual_ref)
    return apply(B.plan(), lo_blk, xh, bh, bl, v)


@dataclasses.dataclass(frozen=True)
class RectBanded:
    """Rectangular banded operator (transfer P or R in an RCM hierarchy)."""

    vals: Any
    pidx: Any  # packed page*1024 + idx, int32
    meta: Tuple[int, ...]  # (K, n, n_cols, tile, WpP, npage)
    shape: Tuple[int, int]
    far: Optional[FarBlock] = None
    slot_ranges: Optional[Tuple] = None

    def plan(self) -> dict:
        K, n, n_cols, tile, WpP, npage = self.meta
        return dict(vals=self.vals, pidx=self.pidx, K=K, n=n, n_cols=n_cols,
                    tile=tile, WpP=WpP, npage=npage, ranges=self.slot_ranges)

    def to(self, device) -> "RectBanded":
        return dataclasses.replace(
            self, vals=to_tensor(self.vals, device),
            pidx=to_tensor(self.pidx, device), far=_opt_to(self.far, device))


def rect_banded_from_ell(E: EllMatrix, n_cols_pad: int,
                         tile: int = 1024) -> Optional[RectBanded]:
    """Rectangular banded layout of a transfer operator whose columns follow
    the grid-proportional band of an RCM hierarchy.  None when the shapes do
    not tile or no window fits."""
    from raptor_tpu_torch.ops.banded_plan import (
        BandedPlanError,
        banded_plan_rect_split,
    )

    if E.n_rows_pad % tile or n_cols_pad % 1024:
        return None
    try:
        plan, far = banded_plan_rect_split(
            _np(E.cols), _np(E.row_nnz), _np(E.data),
            n_cols_pad=n_cols_pad, tile=tile)
    except BandedPlanError:
        return None
    return RectBanded(
        vals=plan["vals"], pidx=plan["pidx"],
        meta=(plan["K"], plan["n"], plan["n_cols"], plan["tile"],
              plan["WpP"], plan["npage"]),
        shape=tuple(E.shape), far=_far_from_dict(far),
        slot_ranges=plan.get("ranges"))


def rect_banded_spmv(B: RectBanded, x: torch.Tensor) -> torch.Tensor:
    """y = B @ x; x padded to meta n_cols.  K6 for a layout on the card,
    its plain version for one elsewhere."""
    apply = bk.banded_spmv_rect if B.vals.is_cuda else bk.banded_spmv_rect_ref
    y = apply(B.plan(), x)
    return far_spmv_add(y, B.far, x)


# ---------------------------------------------------------------------------
# Geo-split transfers: alternating semicoarsening of a lexicographic grid
# makes P and R static reshapes and elementwise weight products.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GeoTransfer:
    """P (and its exact transpose R) of one geo-split level.

    Fine index i = hi*(m*s) + j*s + lo (j the coordinate along the
    coarsened dimension, extent m, stride s); coarse point t sits at fine
    j = 2t.  F rows (odd j) interpolate ``wm[i] * xc(t) + wp[i] * xc(t+1)``,
    with wp = 0 at the right boundary; C rows copy.  ``wm`` and ``wp`` are
    (n_pad_f,) in fine ordering (only odd-j entries are read)."""

    wm: Any
    wp: Any
    meta: tuple  # (H, m, mc, s, n_f, n_pad_f, nc_pad)

    def to(self, device) -> "GeoTransfer":
        return dataclasses.replace(self, wm=to_tensor(self.wm, device),
                                   wp=to_tensor(self.wp, device))


def _geo_weights(T: GeoTransfer, dt):
    H, m, _, s, n_f = T.meta[:5]
    return (T.wm[:n_f].reshape(H, m, s)[:, 1::2, :].to(dt),
            T.wp[:n_f].reshape(H, m, s)[:, 1::2, :].to(dt))


def geo_prolong(T: GeoTransfer, xc: torch.Tensor) -> torch.Tensor:
    """P @ xc: C rows copy their coarse point, F rows weigh their two."""
    import torch.nn.functional as F

    H, m, mc, s, n_f, n_pad_f, _ = T.meta
    mo = m // 2
    Xc = xc[: H * mc * s].reshape(H, mc, s)
    Wm, Wp = _geo_weights(T, xc.dtype)
    L = Xc[:, :mo, :]
    R_ = F.pad(Xc, (0, 0, 0, 1))[:, 1:mo + 1, :]
    O = Wm * L + Wp * R_
    if mo < mc:  # odd extent: pad the odd plane stack to mc, trim after
        O = F.pad(O, (0, 0, 0, mc - mo))
    Y = torch.stack([Xc, O], dim=2).reshape(H, 2 * mc, s)[:, :m, :]
    return torch.cat([Y.reshape(-1), xc.new_zeros(n_pad_f - n_f)])


def geo_restrict(T: GeoTransfer, xf: torch.Tensor) -> torch.Tensor:
    """R @ xf = P^T @ xf."""
    import torch.nn.functional as F

    H, m, mc, s, n_f, _, nc_pad = T.meta
    mo = m // 2
    Xf = xf[:n_f].reshape(H, m, s)
    Od = Xf[:, 1::2, :]  # (H, mo, s)
    Wm, Wp = _geo_weights(T, xf.dtype)
    yc = Xf[:, 0::2, :] + F.pad(Wm * Od, (0, 0, 0, mc - mo))
    # odd j = 2t-1 gives wp to coarse t >= 1; the last odd plane's wp is 0
    # for even m (right grid boundary), so trimming to mc-1 planes before
    # the top pad is exact for both parities
    yc = yc + F.pad((Wp * Od)[:, : mc - 1, :], (0, 0, 1, 0))
    return torch.cat([yc.reshape(-1), xf.new_zeros(nc_pad - H * mc * s)])
