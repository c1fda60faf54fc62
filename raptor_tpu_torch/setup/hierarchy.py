"""AMG hierarchy of the algebraic engine.

Counterpart of ``raptor_tpu/setup/hierarchy.py``.  ``build_hierarchy``
runs the classical level loop (RS or PMIS splitting, direct, classical or
extended interpolation, Galerkin RAP) on the host for levels with
``n <= AmgConfig.host_setup_threshold`` (``setup/host_setup.py``): the
reference's own host route, with bit-identical splittings.  Given grid
extents (``geo``), the host route builds geo-split levels (alternating
semicoarsening, ``_geo_cf``) until the grid is exhausted or a level's
coarsened dimension is weakly coupled.  The leaves stay NumPy while the
hierarchy is built; ``Hierarchy.to(device)`` moves it to a device in one
pass.

Not ported yet (they raise ``NotImplementedError``): levels built on the
device (n above ``host_setup_threshold``, the reference's device geo chain
included), CLJP, aggressive coarsening and smoothed aggregation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, _np, ell_from_csr, to_tensor
from raptor_tpu_torch.solve.smoothers import NOT_PORTED

__all__ = ["Level", "Hierarchy", "build_hierarchy", "hierarchy_stats",
           "cast_hierarchy_algebraic", "attach_residual_lo", "check_ported"]

def _to(x, device):
    if x is None:
        return None
    if isinstance(x, (np.ndarray, np.generic, torch.Tensor)):
        return to_tensor(x, device)
    return x.to(device)


@dataclasses.dataclass(frozen=True)
class Level:
    """One level of the hierarchy."""

    A: EllMatrix
    dinv: Any
    P: Optional[EllMatrix]  # None on the coarsest level
    R: Optional[EllMatrix]
    color: Any  # multicolor GS colors (not ported: always None)
    cheb_lmax: Any  # scalar for the Chebyshev smoothers
    n: int  # logical (unpadded) dof count
    ncolors: int
    # layouts of the reference that are not ported yet: always None here
    Abell: Optional[Any] = None
    binv: Optional[Any] = None
    # banded layouts (fine_layout='banded'; core/hybrid.py)
    Aband: Optional[Any] = None  # BandedMatrix
    Pband: Optional[Any] = None  # RectBanded
    Rband: Optional[Any] = None
    # DIA planes of A (fine_layout='banded' on a plane-structured matrix):
    # the operator applies run through K1 (core/hybrid.py)
    Ahyb: Optional[Any] = None  # HybridMatrix
    # P and R of a geo-split level as reshapes and weight products; the
    # cycle takes it before Pband/Rband and the ELL P/R
    Tgeo: Optional[Any] = None  # GeoTransfer

    def to(self, device) -> "Level":
        return dataclasses.replace(
            self, **{f.name: _to(getattr(self, f.name), device)
                     for f in dataclasses.fields(self)
                     if f.name not in ("n", "ncolors")})


@dataclasses.dataclass(frozen=True)
class Hierarchy:
    levels: Tuple[Level, ...]
    coarse_inv: Any  # dense inverse of the coarsest operator
    config: AmgConfig
    # fine_layout='banded': the hierarchy lives in the RCM ordering of the
    # input; perm maps RCM slot -> original index.  None for identity.
    perm: Optional[Any] = None
    iperm: Optional[Any] = None
    # dense coarse tail: the whole sub-cycle at level tail_start as one
    # dense matvec (solve/cycle.materialize_tail)
    tail_op: Optional[Any] = None
    tail_start: int = -1
    # fp32 truncation remainder of the level-0 operator data in the ELL
    # slot layout of levels[0].A, and re-laid in levels[0].Aband's blocked
    # layout for K5 (attach_residual_lo)
    a0_lo: Optional[Any] = None
    a0_lo_band: Optional[Any] = None

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def device(self) -> torch.device:
        return self.levels[0].A.data.device

    def to(self, device) -> "Hierarchy":
        return dataclasses.replace(
            self, levels=tuple(lv.to(device) for lv in self.levels),
            **{name: _to(getattr(self, name), device)
               for name in ("coarse_inv", "perm", "iperm", "tail_op",
                            "a0_lo", "a0_lo_band")})


def _bucket8(w: int) -> int:
    """Round a data-dependent width up to a multiple of 8 (the reference's
    static-width buckets; level shapes match it)."""
    return max(8, ((int(w) + 7) // 8) * 8)


def _geo_cf(n: int, n_pad: int, exts: list, d: int) -> tuple:
    """(C/F split, stride) for semicoarsening dimension ``d``: C where that
    coordinate is even.  Rows are lexicographic with stride(d) =
    prod(exts[:d])."""
    from raptor_tpu_torch.setup.splitting import C_PT, F_PT

    stride = int(np.prod(exts[:d])) if d > 0 else 1
    idx = np.arange(n_pad)
    coord = (idx // stride) % exts[d]
    return np.where((coord % 2 == 0) & (idx < n), C_PT, F_PT).astype(
        np.int32), stride


def check_ported(config: AmgConfig) -> None:
    """Raise for the configurations whose setup or cycle is not ported."""
    if config.splitting == "aggregation" or config.interp == "smoothed":
        raise NotImplementedError("smoothed aggregation is not yet ported")
    if config.splitting == "cljp":
        raise NotImplementedError("CLJP splitting is not yet ported")
    if config.aggressive:
        raise NotImplementedError("aggressive coarsening is not yet ported")
    if config.smoother in NOT_PORTED:
        raise NotImplementedError(
            f"smoother {config.smoother!r} is not yet ported")


def attach_residual_lo(hier: Hierarchy, A_sp) -> Hierarchy:
    """Attach Hierarchy.a0_lo: the fp32 truncation remainder of the level-0
    operator, laid out in exactly levels[0].A's ELL slots (and in
    levels[0].Aband's blocked layout when there is one), so the refined
    solve certifies against the unrounded operator.  Unchanged for
    fp32-exact operators (every grid stencil)."""
    import scipy.sparse as sp

    if hier.a0_lo is not None:
        return hier
    E = hier.levels[0].A
    if E.dtype not in (np.float32, torch.float32):
        return hier
    a = sp.csr_matrix(A_sp).astype(np.float64)
    if np.array_equal(a.data.astype(np.float32).astype(np.float64), a.data):
        return hier
    if hier.perm is not None:
        p = _np(hier.perm)[: a.shape[0]]
        a = a[p][:, p].tocsr()
    E64 = ell_from_csr(a, dtype=np.float64, row_pad_multiple=E.n_rows_pad,
                       n_cols_pad=E.n_cols_pad)
    hi = E64.data.astype(np.float32)
    lo = (E64.data - hi.astype(np.float64)).astype(np.float32)
    if not lo.any():
        return hier
    if not np.array_equal(hi, _np(E.data)):
        # layout mismatch: certifying against the rounded operator is still
        # correct, just weaker
        return hier
    lo_band = None
    band = hier.levels[0].Aband
    if band is not None:
        K_, n_, tile_ = band.meta[:3]
        lo_band = np.ascontiguousarray(
            lo.reshape(K_, n_ // tile_, tile_ // 128, 128).transpose(1, 0, 2, 3))
    if isinstance(E.data, torch.Tensor):  # a hierarchy already on a device
        lo, lo_band = to_tensor(lo, E.data.device), _to(lo_band, E.data.device)
    return dataclasses.replace(hier, a0_lo=lo, a0_lo_band=lo_band)


def cast_hierarchy_algebraic(hier: Hierarchy, dtype) -> Hierarchy:
    """Copy of the hierarchy with every operator value array cast to
    ``dtype`` (a torch dtype; bfloat16 in practice) for use as the
    preconditioner hierarchy: the cycle reads half the operator bytes while
    the Krylov operator, residuals and the df64 certification stay on the
    full-precision hierarchy.  ``dinv`` and ``cheb_lmax`` keep their
    precision."""

    def cast_ell(E):
        return None if E is None else dataclasses.replace(E, data=E.data.to(dtype))

    def cast_band(B):
        if B is None:
            return None
        far = (None if B.far is None else
               dataclasses.replace(B.far, vals=B.far.vals.to(dtype)))
        return dataclasses.replace(B, vals=B.vals.to(dtype), far=far)

    def cast_hyb(H):
        return None if H is None else dataclasses.replace(
            H, planes=H.planes.to(dtype), spill=cast_ell(H.spill))

    # Tgeo's weights are O(n) vectors, as dinv: they keep their precision
    levels = tuple(
        dataclasses.replace(
            lev, A=cast_ell(lev.A), P=cast_ell(lev.P), R=cast_ell(lev.R),
            Aband=cast_band(lev.Aband), Pband=cast_band(lev.Pband),
            Rband=cast_band(lev.Rband), Ahyb=cast_hyb(lev.Ahyb))
        for lev in hier.levels)
    return dataclasses.replace(
        hier, levels=levels, coarse_inv=hier.coarse_inv.to(dtype),
        tail_op=None if hier.tail_op is None else hier.tail_op.to(dtype))


def build_hierarchy(A, config: AmgConfig = AmgConfig(), dtype=np.float32,
                    row_ids: "np.ndarray | None" = None,
                    geo: "list | None" = None) -> Hierarchy:
    """Build an AMG hierarchy with NumPy leaves from a scipy.sparse matrix
    or an EllMatrix.

    Every level goes through the host route (``host_setup.host_build_tail``)
    when the fine level has ``n <= config.host_setup_threshold``; larger
    levels would be built on the device, which is not ported yet.

    ``row_ids`` (optional (n,) array): PMIS tie-break weights key on these
    original identities instead of row positions, so the C/F sets do not
    depend on the ordering the hierarchy is built in (the banded path
    passes its RCM permutation here).

    ``geo`` (optional grid extents [e0, e1, e2] in stride order, from
    ``api._detect_grid``): build geo-split levels while the grid lasts."""
    from raptor_tpu_torch.setup.host_setup import host_build_tail

    check_ported(config)
    if config.splitting not in ("rs", "pmis"):
        raise ValueError(f"unknown splitting: {config.splitting}")
    A_in = None
    if not isinstance(A, EllMatrix):
        A_in = A
        A = ell_from_csr(A, dtype=dtype, row_pad_multiple=config.pad_multiple)
    n = A.shape[0]
    if (n > config.host_setup_threshold and config.max_levels > 1
            and n > config.coarse_size):
        raise NotImplementedError(
            f"n={n} > host_setup_threshold={config.host_setup_threshold}: "
            "device-level setup is not yet ported (raise the threshold to "
            "build every level on the host)")
    hier = host_build_tail(A, [], config, dtype,
                           row_ids=None if row_ids is None else np.asarray(row_ids),
                           geo=geo)
    if A_in is not None:
        hier = attach_residual_lo(hier, A_in)
    return hier


def hierarchy_stats(hier: Hierarchy) -> dict[str, Any]:
    """Grid/operator complexity report."""
    sizes = [lev.n for lev in hier.levels]
    nnzs = [lev.A.nnz for lev in hier.levels]
    return {
        "levels": len(sizes),
        "sizes": sizes,
        "nnz": nnzs,
        "grid_complexity": float(sum(sizes) / sizes[0]),
        "operator_complexity": float(sum(nnzs) / nnzs[0]),
    }
