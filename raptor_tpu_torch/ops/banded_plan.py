"""Host plan builders of the RCM-banded paged-gather layout.

Counterpart of the NumPy half of ``raptor_tpu/ops/pallas/banded_kernel.py``
(``banded_plan``, ``banded_plan_split``, ``banded_plan_rect``,
``banded_plan_rect_split``, ``_compact_far``).  A plan stores an ELL
matrix whose entries lie in a band around the diagonal as tiles of
``tile`` output rows:

* ``vals`` and ``pidx`` have shape ``(T, K, tile // 128, 128)``; entry
  ``(t, k, r, l)`` belongs to row ``t * tile + r * 128 + l``;
* ``pidx`` is the entry's offset into the tile's x window, packed as
  ``page * 1024 + idx`` (one int32 per entry);
* ``ranges[k]`` is slot k's static page interval (``(1, 0)`` when the
  slot holds only padding), so a kernel can skip empty slots.

The square window of tile t starts at ``t * tile - Wp`` in x's coordinates;
the rectangular one (transfer operators) at page
``(t * n_cols) // (T * 1024) - WpP``.  The plans are NumPy arrays; the
layouts in ``core/hybrid.py`` move them to a device.

The caps ``MAX_NPAGE``, ``MAX_KH`` and ``VMEM_BUDGET`` are the TPU kernel's
limits (its VMEM window and its unrolled page-select chain).  They are kept
as they are for parity: every level takes the same layout (or the same
fallback) as in the reference.  Retuning them for the GPU kernels is
later, measured work.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BandedPlanError", "banded_plan", "banded_plan_split",
           "banded_plan_rect", "banded_plan_rect_split", "LANE", "PAGE"]

LANE = 128
SUB = 8
PAGE = SUB * LANE  # 1024 elements: one window page

MAX_NPAGE = 48
MAX_KH = 24
VMEM_BUDGET = 13 * 2**20


class BandedPlanError(ValueError):
    """Matrix bandwidth too large for the paged-gather layout."""


def _round_up(x, m):
    return (x + m - 1) // m * m


def _check_plan_bounds(kh: int, npage: int, K: int, tile: int,
                       itemsize: int, what: str):
    # the TPU kernel's VMEM estimate: double-buffered window + 2 meta blocks
    # (vals + packed pidx) + output
    vmem = 2 * ((2 * kh + 1 + 1) * tile * itemsize
                + 2 * K * tile * max(itemsize, 4))
    if npage > MAX_NPAGE or kh > MAX_KH or vmem > VMEM_BUDGET:
        raise BandedPlanError(
            f"{what}: bandwidth too large for the paged-gather kernel "
            f"(kh={kh}, npage={npage}, est VMEM={vmem >> 20}MiB)")


def _blk(a, K, T, tile, dtype):
    """(K, n) slot-major -> (T, K, tile // 128, 128), one contiguous copy."""
    return a.reshape(K, T, tile // LANE, LANE).transpose(1, 0, 2, 3).astype(
        dtype, order="C")


def _slot_ranges(f, mask):
    """Per-slot page ranges of packed offsets ``f`` and the offsets with
    each masked slot pointed at its slot's lo page (an in-range dummy)."""
    pg = f >> 10
    BIG = np.int32(1 << 20)
    lo_k = np.where(mask, pg, BIG).min(axis=1)
    hi_k = np.where(mask, pg, -1).max(axis=1)
    empty = hi_k < 0
    lo_k = np.where(empty, 1, lo_k)
    hi_k = np.where(empty, 0, hi_k)  # (1, 0): statically skipped slot
    f = np.where(mask, f, (np.where(empty, 0, lo_k) << 10)[:, None])
    return f, tuple((int(a), int(b)) for a, b in zip(lo_k, hi_k))


def banded_plan(cols: np.ndarray, nnz: np.ndarray, vals: np.ndarray,
                tile: int = 1024) -> dict:
    """Square plan of an entry-major ELL matrix (K, n_pad) whose entries all
    lie within |col - row| <= W.  Returns dict(vals, pidx, K, n, tile, kh,
    npage, Wp, ranges)."""
    K, n = cols.shape
    assert tile % PAGE == 0, tile
    assert n % tile == 0, (n, tile)
    rows = np.arange(n, dtype=np.int32)
    cols = cols.astype(np.int32, copy=False)
    mask = np.arange(K, dtype=np.int32)[:, None] < nnz[None, :]
    delta = np.where(mask, cols - rows[None, :], 0)
    W = int(np.abs(delta).max()) if mask.any() else 1
    Wp = _round_up(max(W, 1), PAGE)  # page-aligned halo
    kh = Wp // tile + (1 if Wp % tile else 0)
    npage = (tile + 2 * Wp) // PAGE
    _check_plan_bounds(kh, npage, K, tile, np.dtype(vals.dtype).itemsize,
                       "banded_plan")

    tbase = (rows // tile) * tile
    f = np.where(mask, cols + np.int32(Wp) - tbase[None, :], 0)
    v = np.where(mask, vals, 0)
    f, ranges = _slot_ranges(f, mask)
    T = n // tile
    return dict(
        pidx=_blk(f, K, T, tile, np.int32),
        vals=_blk(v, K, T, tile, vals.dtype),
        K=K, n=n, tile=tile, kh=kh, npage=npage, Wp=Wp, ranges=ranges,
    )


def _compact_far(cols: np.ndarray, vals: np.ndarray, far_mask: np.ndarray,
                 pad_row: int, max_far_frac: float, max_far_k: int,
                 what: str, nnz_total: int = 0):
    """Compact the out-of-window entries of an ELL matrix into a row-subset
    block: only rows that have far entries are stored, front-packed along a
    small K_far slot axis.  Returns dict(rows (m_pad,), cols (K_far, m_pad),
    vals, m), None when there is nothing to compact, or raises
    BandedPlanError when the far part is too heavy."""
    far_cnt = far_mask.sum(axis=0)
    rows_f = np.nonzero(far_cnt)[0].astype(np.int32)
    m = rows_f.size
    if m == 0:
        return None
    K_far = int(far_cnt.max())
    frac = float(far_mask.sum()) / float(max(nnz_total, 1))
    if K_far > max_far_k or frac > max_far_frac:
        raise BandedPlanError(
            f"{what}: far remainder too heavy for a split plan "
            f"(K_far={K_far}, frac={frac:.3f})")
    m_pad = _round_up(m, LANE)
    sel = far_mask[:, rows_f]
    order = np.argsort(~sel, axis=0, kind="stable")  # far slots first
    cc = np.take_along_axis(cols[:, rows_f], order, axis=0)[:K_far]
    vv = np.take_along_axis(vals[:, rows_f], order, axis=0)[:K_far]
    ss = np.take_along_axis(sel, order, axis=0)[:K_far]
    fc = np.zeros((K_far, m_pad), np.int32)
    fv = np.zeros((K_far, m_pad), vals.dtype)
    fc[:, :m] = np.where(ss, cc, 0)
    fv[:, :m] = np.where(ss, vv, 0)
    rows_pad = np.full(m_pad, pad_row, np.int32)
    rows_pad[:m] = rows_f
    return dict(rows=rows_pad, cols=fc, vals=fv, m=m)


def banded_plan_split(cols: np.ndarray, nnz: np.ndarray, vals: np.ndarray,
                      tile: int = 1024, max_far_frac: float = 0.15,
                      max_far_k: int = 16):
    """``banded_plan`` with a near/far split: entries within the largest
    cap-admissible window take the paged layout, the few outside become a
    compacted row-subset block.  Returns (plan, far_or_None); raises
    BandedPlanError when even the split cannot fit."""
    K, n = cols.shape
    rows = np.arange(n, dtype=np.int32)
    cols = cols.astype(np.int32, copy=False)
    mask = np.arange(K, dtype=np.int32)[:, None] < nnz[None, :]
    delta = np.where(mask, cols - rows[None, :], 0)
    W = int(np.abs(delta).max()) if mask.any() else 1
    # largest page-aligned half-window the caps admit
    w_cap = ((MAX_NPAGE * PAGE - tile) // 2 // PAGE) * PAGE
    w_cap = min(w_cap, MAX_KH * tile)
    if W <= w_cap:
        return banded_plan(cols, nnz, vals, tile=tile), None
    far_mask = mask & (np.abs(delta) > w_cap)
    far = _compact_far(cols, vals, far_mask, n - 1, max_far_frac,
                       max_far_k, "banded_plan_split",
                       nnz_total=int(mask.sum()))
    near_cols = np.where(far_mask, rows[None, :], cols)
    near_vals = np.where(far_mask, 0, vals)
    return banded_plan(near_cols, nnz, near_vals, tile=tile), far


def _rect_window(delta, mask):
    lo_d = int(delta.min()) if mask.any() else 0
    hi_d = int(delta.max()) if mask.any() else 1
    WpP = max(-(-(-lo_d) // PAGE), 0) if lo_d < 0 else 0
    return WpP, max(WpP + -(-(hi_d + 1) // PAGE), 1)


def _rect_center(n: int, n_cols_pad: int, tile: int) -> np.ndarray:
    """Per-row window center (whole pages, monotone in the tile), with the
    integer floor arithmetic of the kernels' index map."""
    T = n // tile
    t = np.arange(n, dtype=np.int64) // tile
    return ((t * n_cols_pad) // (T * PAGE)) * PAGE


def banded_plan_rect_split(cols: np.ndarray, nnz: np.ndarray,
                           vals: np.ndarray, n_cols_pad: int,
                           tile: int = 1024, max_far_frac: float = 0.15,
                           max_far_k: int = 16):
    """``banded_plan_rect`` with a near/far split (see banded_plan_split)."""
    K, n = cols.shape
    cols64 = cols.astype(np.int64, copy=False)
    mask = np.arange(K, dtype=np.int32)[:, None] < nnz[None, :]
    center = _rect_center(n, n_cols_pad, tile)
    delta = np.where(mask, cols64 - center[None, :], 0)
    WpP, npage = _rect_window(delta, mask)
    if npage <= MAX_NPAGE:
        return banded_plan_rect(cols, nnz, vals, n_cols_pad, tile=tile), None
    d = delta[mask]
    for q in (0.999, 0.995, 0.99, 0.98, 0.95, 0.9, 0.8):
        lo_q = int(np.quantile(d, 1.0 - q))
        hi_q = int(np.quantile(d, q))
        WpP = max(-(-(-lo_q) // PAGE), 0) if lo_q < 0 else 0
        npage = max(WpP + -(-(hi_q + 1) // PAGE), 1)
        if npage <= MAX_NPAGE:
            break
    else:
        raise BandedPlanError(
            f"banded_plan_rect_split: no admissible window (npage={npage})")
    lo_e, hi_e = -WpP * PAGE, (npage - WpP) * PAGE - 1
    far_mask = mask & ((delta < lo_e) | (delta > hi_e))
    far = _compact_far(cols.astype(np.int32), vals, far_mask, n - 1,
                       max_far_frac, max_far_k, "banded_plan_rect_split",
                       nnz_total=int(mask.sum()))
    # in-window dummy target for the far slots: the tile's own center
    near_cols = np.where(far_mask, center[None, :], cols64).astype(np.int32)
    near_vals = np.where(far_mask, 0, vals)
    return banded_plan_rect(near_cols, nnz, near_vals, n_cols_pad,
                            tile=tile), far


def banded_plan_rect(cols: np.ndarray, nnz: np.ndarray, vals: np.ndarray,
                     n_cols_pad: int, tile: int = 1024) -> dict:
    """Rectangular plan (transfer operators P, R): ``cols`` (K, n_rows_pad)
    index x in [0, n_cols_pad), within a band around row * n_cols/n_rows.
    Returns dict(vals, pidx, K, n, n_cols, tile, WpP, npage, ranges)."""
    K, n = cols.shape
    assert tile % PAGE == 0 and n % tile == 0, (n, tile)
    assert n_cols_pad % PAGE == 0, n_cols_pad
    T = n // tile
    cols = cols.astype(np.int64, copy=False)
    mask = np.arange(K, dtype=np.int32)[:, None] < nnz[None, :]
    center = _rect_center(n, n_cols_pad, tile)
    delta = np.where(mask, cols - center[None, :], 0)
    WpP, npage = _rect_window(delta, mask)
    _check_plan_bounds(0, npage, K, tile, np.dtype(vals.dtype).itemsize,
                       "banded_plan_rect")

    f = np.where(mask, delta + np.int64(WpP * PAGE), 0).astype(np.int32)
    assert (f[mask] >= 0).all() and (f[mask] < npage * PAGE).all()
    v = np.where(mask, vals, 0)
    f, ranges = _slot_ranges(f, mask)
    return dict(
        pidx=_blk(f, K, T, tile, np.int32),
        vals=_blk(v, K, T, tile, vals.dtype),
        K=K, n=n, n_cols=n_cols_pad, tile=tile, WpP=WpP, npage=npage,
        ranges=ranges,
    )
