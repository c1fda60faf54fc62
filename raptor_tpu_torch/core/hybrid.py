"""RCM-banded paged-gather layouts for general (unstructured) matrices.

Counterpart of the banded half of ``raptor_tpu/core/hybrid.py``.  Reverse
Cuthill-McKee gathers a general matrix's entries into a band; the plans of
``ops/banded_plan.py`` tile that band so each tile's x reads fall in a
window of a few 1024-element pages, and the kernels K4/K5/K6
(``ops/cuda/banded_kernel.py``) apply it.  Entries outside the window cap
(rare: distance-2 couplings of natural-ordered coarse operators) go to a
compacted ``FarBlock`` applied with a gather and an ``index_add``.

``BandedMatrix`` is a square operator, ``RectBanded`` a transfer operator
(P or R).  Their leaves are NumPy arrays while a hierarchy is built on the
host and tensors after ``.to(device)``.  ``cuda_calls`` counts the layout
applies made on CUDA tensors, so a run can show that each went through its
kernel.

``HybridMatrix`` (DIA planes + spill) and the geo-split ``GeoTransfer`` are
not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.ell import EllMatrix, _np, pad_rows, to_tensor
from raptor_tpu_torch.ops.cuda import banded_kernel as bk

__all__ = ["FarBlock", "far_spmv_add", "BandedMatrix", "banded_from_csr",
           "banded_from_ell", "banded_spmv_ro", "banded_spmv",
           "banded_df64_residual", "RectBanded", "rect_banded_from_ell",
           "rect_banded_spmv", "cuda_calls"]

# applies on CUDA tensors, by function ("banded_spmv_ro" launches K4,
# "rect_banded_spmv" K6, "banded_df64_residual" K5)
cuda_calls: collections.Counter = collections.Counter()


def _opt_to(x, device):
    return None if x is None else x.to(device)


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
    )

    if E.n_rows_pad % tile != 0:
        return None
    vals, cols, nnz = _np(E.data), _np(E.cols), _np(E.row_nnz)
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
    """y = A_rcm @ x in the layout's own ordering: K4 on a CUDA tensor,
    its plain version on a CPU tensor."""
    if xr.is_cuda:
        cuda_calls["banded_spmv_ro"] += 1
    y = bk.banded_spmv(B.plan(), xr)
    return far_spmv_add(y, B.far, xr)


def banded_spmv(B: BandedMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x in the caller's ordering (permutation applied inside)."""
    return banded_spmv_ro(B, x[B.perm])[B.iperm]


def banded_df64_residual(B: BandedMatrix, lo_blk, xh, bh, bl, v):
    """(rh, rl) = df64[(bh, bl) - v - A @ xh] in the layout's ordering
    through K5 (its plain version on CPU tensors); ``lo_blk`` is the
    optional blocked fp32 truncation remainder of the operator data
    (``setup/hierarchy.attach_residual_lo``)."""
    if xh.is_cuda:
        cuda_calls["banded_df64_residual"] += 1
    return bk.banded_df64_residual(B.plan(), lo_blk, xh, bh, bl, v)


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
    """y = B @ x; x padded to meta n_cols.  K6 on a CUDA tensor, its plain
    version on a CPU tensor."""
    if x.is_cuda:
        cuda_calls["rect_banded_spmv"] += 1
    y = bk.banded_spmv_rect(B.plan(), x)
    return far_spmv_add(y, B.far, x)
