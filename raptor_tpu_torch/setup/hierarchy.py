"""AMG hierarchy of the algebraic engine.

Counterpart of ``raptor_tpu/setup/hierarchy.py``.  ``build_hierarchy``
runs the classical level loop (RS or PMIS splitting, or the aggressive
distance-2 splitting with multipass interpolation; direct, classical or
extended interpolation; Galerkin RAP).  Smoothed aggregation has its own
loop (``setup/aggregation.py``).  Levels with ``n >
AmgConfig.host_setup_threshold`` are built with tensors on the caller's
device (the device route: ``_fused_level`` for PMIS and CLJP,
``_unfused_level`` for RS, ``_geo_chain`` for geo-split levels); smaller
ones on the host in NumPy (``setup/host_setup.py``), with bit-identical
splittings.  Given grid
extents (``geo``), both routes build geo-split levels (alternating
semicoarsening) until the grid is exhausted or a level's coarsened
dimension is weakly coupled.  ``Hierarchy.to(device)`` moves the finished
hierarchy to one device.

Two differences from the reference's device route, by design: the geo
chain's RAP width overflow (``leftover``) is read with the chain's one host
read and raises, and the chain's last planes go to the coarsest level when
the loop ends right after a chain.

CLJP levels (``setup/cljp.py``) are built on the device at every size, as
in the reference, whose host tail takes RS and PMIS only: the level loop
goes on below ``host_setup_threshold`` down to ``coarse_size``, and the
coarsest level is inverted on the device.

Two differences from the reference's device route, repairs: a CLJP
hierarchy on a detected grid leaves the geo chain at the threshold and
goes on with CLJP levels, where the reference plans an empty chain there
and fails; and the aggressive device level filters the row identities
(``row_ids``) by its C points as the other levels do, where the reference
leaves them stale and its host tail then fails to index them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, _np, ell_from_csr, pad_rows, to_tensor
from raptor_tpu_torch.utils.profiling import phase, spanned

__all__ = ["Level", "Hierarchy", "build_hierarchy", "hierarchy_stats",
           "cast_hierarchy_algebraic", "attach_residual_lo"]

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
    color: Any  # (n_pad,) int32 multicolor GS colours, or None
    cheb_lmax: Any  # scalar for the Chebyshev smoothers
    n: int  # logical (unpadded) dof count
    ncolors: int
    # block layout (SA with a block smoother): A as b x b BlockELL and the
    # inverses of its diagonal blocks, (nb_pad, b, b)
    Abell: Optional[Any] = None  # core/bell.py BlockEllMatrix
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


def _host_tail_takes(config: AmgConfig) -> bool:
    """Whether the host route builds the levels below the threshold: it
    takes RS and PMIS only, so CLJP levels stay on the device."""
    return config.splitting in ("rs", "pmis")


@spanned("setup.residual_lo")
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

    # Tgeo's weights are O(n) vectors, as dinv: they keep their precision,
    # and so do the block inverses binv
    levels = tuple(
        dataclasses.replace(
            lev, A=cast_ell(lev.A), P=cast_ell(lev.P), R=cast_ell(lev.R),
            Abell=None if lev.Abell is None else lev.Abell.cast(dtype),
            Aband=cast_band(lev.Aband), Pband=cast_band(lev.Pband),
            Rband=cast_band(lev.Rband), Ahyb=cast_hyb(lev.Ahyb))
        for lev in hier.levels)
    return dataclasses.replace(
        hier, levels=levels, coarse_inv=hier.coarse_inv.to(dtype),
        tail_op=None if hier.tail_op is None else hier.tail_op.to(dtype))


# ---------------------------------------------------------------------------
# The device route: levels with n > config.host_setup_threshold
# ---------------------------------------------------------------------------

_CHEB_SMOOTHERS = ("chebyshev", "cheb4", "block_cheb")


@spanned("setup.coarse_inverse")
def _dense_inverse(A: EllMatrix, n_true: int | None = None) -> torch.Tensor:
    """Explicit dense inverse of the (identity-padded, SPD) coarsest
    operator on A's device.  Rows >= ``n_true`` are decoupled unit
    diagonals, so only the logical block (``n_true`` padded to 8) is
    inverted."""
    n = A.n_rows_pad
    dev = A.data.device
    vals = torch.where(A.slot_mask(), A.data, 0)
    dense = torch.zeros(n, n, dtype=A.dtype, device=dev)
    # duplicates are padding slots of value 0, so the accumulation order
    # cannot change a sum
    dense.index_put_((A.row_index().reshape(-1), A.cols.long().reshape(-1)),
                     vals.reshape(-1), accumulate=True)
    m = n if n_true is None else min(pad_rows(n_true, 8), n)
    if m == n:
        return torch.linalg.inv(dense)
    inv = torch.eye(n, dtype=A.dtype, device=dev)
    inv[:m, :m] = torch.linalg.inv(dense[:m, :m])
    return inv


def _dinv(A: EllMatrix) -> torch.Tensor:
    d = A.diagonal()
    return 1.0 / torch.where(d != 0, d, 1.0)


def _mcgs_color(A: EllMatrix, cfg: AmgConfig):
    """Multicolor GS colours of A on the host (the graph of
    (a + a.T) != 0), as an int32 tensor on A's device with padding rows
    colour 0; (None, 1) for the other smoothers."""
    if cfg.smoother != "mcgs":
        return None, 1
    from raptor_tpu_torch.core.ell import ell_to_csr
    from raptor_tpu_torch.solve.smoothers import greedy_coloring_host

    a = ell_to_csr(A)
    g = ((a + a.T) != 0).tocsr()
    col_np, ncolors = greedy_coloring_host(g.indptr, g.indices, a.shape[0])
    pad = np.zeros(A.n_rows_pad, dtype=np.int32)
    pad[: a.shape[0]] = col_np
    return torch.from_numpy(pad).to(A.data.device), ncolors


def _smoother_data(A: EllMatrix, cfg: AmgConfig, smask):
    """Per-level smoother data on the device: (dinv, color, ncolors,
    lmax); lmax by power iteration for the Chebyshev smoothers (a
    block_cheb level with a block layout overrides it)."""
    from raptor_tpu_torch.solve.smoothers import estimate_lmax

    dinv = _dinv(A)
    color, ncolors = _mcgs_color(A, cfg)
    lmax = estimate_lmax(A, dinv) if cfg.smoother in _CHEB_SMOOTHERS else None
    return dinv, color, ncolors, lmax


def _interpolate(A: EllMatrix, smask, cf, interp: str, p_max: int):
    """(P, n_coarse) by a device level's interpolation; ``extended`` is
    ext+i on the strength-compacted operator on every device level."""
    from raptor_tpu_torch.setup.interp import (classical_interpolation,
                                               direct_interpolation,
                                               extended_interpolation_strong)

    if interp == "classical":
        return classical_interpolation(A, smask, cf)
    if interp == "extended":
        return extended_interpolation_strong(A, smask, cf, p_max=p_max)
    return direct_interpolation(A, smask, cf)


def _level_phase1(A: EllMatrix, perm, *, theta, strength_kind, splitting,
                  interp, want_lmax, p_max=4):
    """First half of one device level: strength -> PMIS or CLJP ->
    interpolation -> width measurements -> smoother scalars.  Returns (P
    at the fine column space, dinv, lmax or None, cf, (nc, w_T, w_P) as one
    int64 tensor)."""
    from raptor_tpu_torch.ops.sparse_ops import _transpose_col_counts
    from raptor_tpu_torch.setup.splitting import pmis_splitting
    from raptor_tpu_torch.setup.strength import strength_mask
    from raptor_tpu_torch.solve.smoothers import estimate_lmax

    with phase("setup.strength"):
        smask = strength_mask(A, theta, strength_kind)
    with phase("setup.splitting"):
        if splitting == "pmis":
            cf = pmis_splitting(A, smask, perm)
        elif splitting == "cljp":
            from raptor_tpu_torch.setup.cljp import cljp_splitting

            cf = cljp_splitting(A, smask, perm)
        else:
            raise ValueError(f"unfusable splitting: {splitting}")
    with phase("setup.interp"):
        P, nc = _interpolate(A, smask, cf, interp, p_max)
        # w_P: the true max row width of P; the host slices P's slot axis
        # to bucket8(w_P) before the SpGEMMs (the interpolation routines
        # emit a static bound)
        w_T = _transpose_col_counts(P).max()
        w_P = P.row_nnz.max()
    with phase("setup.smoother"):
        dinv = _dinv(A)
        lmax = estimate_lmax(A, dinv) if want_lmax else None
    return P, dinv, lmax, cf, torch.stack([v.long() for v in (nc, w_T, w_P)])


@spanned("setup.rap")
def _level_phase2(A: EllMatrix, P: EllMatrix, *, k_T, k_AP, k_Ac, nc,
                  filter_tol):
    """Second half of one device level: R = P^T, AP, the Galerkin R(AP),
    identity padding, and optional filtering.  ``k_Ac`` is a guess;
    ``leftover`` > 0 reports truncation.  Returns (R, Ac at width k_Ac,
    (true max width of Ac, leftover) as one tensor)."""
    from raptor_tpu_torch.ops.sparse_ops import (_spgemm_fixed_full,
                                                 ell_filter_fixed,
                                                 ell_transpose_fixed,
                                                 spgemm_fixed)
    from raptor_tpu_torch.setup.interp import add_identity_padding

    R = ell_transpose_fixed(P, k_T)
    AP = spgemm_fixed(A, P, k_AP)
    Ac, leftover = _spgemm_fixed_full(R, AP, k_Ac)
    Ac = add_identity_padding(Ac, nc)
    if filter_tol > 0:
        Ac = ell_filter_fixed(Ac, filter_tol, k_Ac)
    return R, Ac, torch.stack([Ac.row_nnz.max().long(), leftover.long()])


def _fused_level(A: EllMatrix, n: int, config: AmgConfig, seed: int,
                 perm=None):
    """One PMIS or CLJP level on the device through the two level programs,
    with three host reads: the coarse size and widths (with cf), the A·P
    width, and Ac's width and leftover.  Returns (P, R, Ac, nc, dinv,
    lmax_or_None, cf as host int32) with Ac compacted to its (bucketed)
    true width; P, R and Ac are None when the level does not coarsen."""
    from raptor_tpu_torch.ops.sparse_ops import _spgemm_width, _transpose_col_counts
    from raptor_tpu_torch.setup.interp import (EXT_DEVICE_MAX_K,
                                               tighten_coarse_space)
    from raptor_tpu_torch.setup.splitting import make_perm

    if perm is None:
        perm = make_perm(n, A.n_rows_pad, seed, device=A.data.device)
    want_lmax = config.smoother in _CHEB_SMOOTHERS
    P_wide, dinv, lmax, cf, scal = _level_phase1(
        A, perm, theta=config.theta, strength_kind=config.strength,
        splitting=config.splitting, interp=config.interp,
        want_lmax=want_lmax, p_max=config.p_max_elements)
    host = torch.cat([scal, cf.long()]).cpu()  # host read 1, cf with it
    nc, w_T, w_P = (int(v) for v in host[:3])
    cf = host[3:].numpy().astype(np.int32)
    if nc == 0 or nc >= n:
        return None, None, None, nc, dinv, lmax, cf
    P = tighten_coarse_space(P_wide, nc, config.pad_multiple)
    # the ELL invariant front-packs real entries, so slicing P's slot axis
    # to its true width is exact and shrinks every product below
    k_P = min(_bucket8(w_P), P.K)
    if k_P < P.K:
        P = dataclasses.replace(P, data=P.data[:k_P], cols=P.cols[:k_P])
    if (config.interp == "extended" and config.fat_interp_refine > 0
            and A.K > EXT_DEVICE_MAX_K):
        # optional Jacobi sweeps on a fat level's strength-compacted ext+i
        from raptor_tpu_torch.setup.aggressive import jacobi_refine_p

        P = jacobi_refine_p(A, P, torch.from_numpy(cf).to(A.data.device),
                            config.interp_refine_omega,
                            config.fat_interp_refine, config.p_max_elements)
        w_T = int(_transpose_col_counts(P).max())  # the pattern changed
    w_AP = max(int(_spgemm_width(A, P)), 1)  # host read 2
    k_T, k_AP = _bucket8(w_T), _bucket8(w_AP)
    k_Ac = _bucket8(3 * A.K + 8)
    while True:
        R, Ac, scal2 = _level_phase2(A, P, k_T=k_T, k_AP=k_AP, k_Ac=k_Ac,
                                     nc=nc, filter_tol=config.filter_tol)
        w_true, leftover = (int(v) for v in scal2.cpu())  # host read 3
        if leftover == 0:
            break
        k_Ac = _bucket8(k_Ac + leftover)  # the guess was too small
    w_cut = min(_bucket8(w_true), k_Ac)
    if w_cut < k_Ac:
        Ac = dataclasses.replace(Ac, data=Ac.data[:w_cut], cols=Ac.cols[:w_cut])
    return P, R, Ac, nc, dinv, lmax, cf


def _geo_plans(n0: int, n_pad0: int, K0: int, exts0: list, nlev: int,
               pad_multiple: int):
    """Static per-level plan for ``_geo_chain``: extents, strides, widths
    and coarse-pattern offsets, all structural.  Returns (plans, the
    extents after the last level)."""
    plans = []
    exts = list(exts0)
    n, n_pad, K = n0, n_pad0, K0
    for _ in range(nlev):
        d = int(np.argmax(exts))
        m = exts[d]
        stride = int(np.prod(exts[:d])) if d > 0 else 1
        mc = (m + 1) // 2
        exts2 = [mc if i == d else e for i, e in enumerate(exts)]
        nc = int(np.prod(exts2))
        nc_pad = pad_rows(nc, pad_multiple)
        strides2 = [int(np.prod(exts2[:i])) if i else 1
                    for i in range(len(exts2))]
        offsets_c = tuple(sorted({
            i * strides2[0] + j * strides2[1] + k * strides2[2]
            for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)}))
        k_Ac = _bucket8(15 if K <= 8 else 27)
        plans.append(dict(
            n=n, n_pad=n_pad, K=K, d=d, m=m, stride=stride, mc=mc, nc=nc,
            nc_pad=nc_pad, H=n // (m * stride), offsets_c=offsets_c,
            # an A row touches <= 3 coarse coordinates per dimension, so a
            # merged A·P row has at most 27 entries
            k_P=8, k_T=8, k_AP=_bucket8(min(2 * K, 27)), k_Ac=k_Ac))
        exts, n, n_pad, K = exts2, nc, nc_pad, k_Ac
    return plans, exts


def _extract_planes(E: EllMatrix, offsets) -> torch.Tensor:
    """(len(offsets), n_pad) DIA planes of E at the linear ``offsets``."""
    delta = E.cols - E.row_index()
    sm = E.slot_mask()
    return torch.stack([torch.where(sm & (delta == off), E.data, 0).sum(0)
                        for off in offsets])


def _geo_chain(A0: EllMatrix, *, plans: list, theta, strength_kind,
               want_lmax, filter_tol, offsets0: tuple):
    """Every device geo level in one pass with no host read: geometric C/F
    (even coordinate along the coarsened dimension) with a closed-form
    coarse index, direct interpolation restricted to that dimension's
    couplings packed as a two-entry P, the ``GeoTransfer`` weights, the
    Gershgorin lmax, the Galerkin product and the next level's DIA planes.

    Returns (per-level dicts, the last coarse operator, its planes at the
    last plan's ``offsets_c``, the weak-dimension counts of the first three
    levels).  Each level's dict carries ``leftover``, the RAP width overflow
    (0 when the structural widths sufficed), and ``pmass``, the per-plane
    mass of its operator's planes (dead planes are pruned from it)."""
    from raptor_tpu_torch.ops.sparse_ops import _slot_sum
    from raptor_tpu_torch.setup.strength import strength_mask

    def fdiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    A = A0
    outs = []
    n_weaks = []
    planes_prev = _extract_planes(A0, offsets0)
    for li, pl in enumerate(plans):
        n, n_pad, stride, m = pl["n"], pl["n_pad"], pl["stride"], pl["m"]
        mc = pl["mc"]
        dev = A.data.device

        def isc_of(c):
            return (torch.remainder(fdiv(c, stride), m) % 2 == 0) & (c < n)

        def cmap_of(c):
            # the coarse lexicographic id of a C point, in closed form
            hi = fdiv(c, m * stride)
            rem = c - hi * (m * stride)
            coord = fdiv(rem, stride)
            return (hi * (mc * stride) + fdiv(coord, 2) * stride
                    + (rem - coord * stride))

        idx = torch.arange(n_pad, dtype=torch.int64, device=dev)
        is_c = isc_of(idx)
        is_f = ~is_c
        row = A.row_index()
        cols = A.cols.long()
        sm = A.slot_mask()
        m1d = sm & ((cols - row).abs() == stride) & (cols != row)
        if li < 3:  # anisotropy signal; the host checks it once at the end
            smask = strength_mask(A, theta, strength_kind)
            n_weaks.append((is_f & (idx < n) & ~(m1d & smask).any(0)).sum())
        dinv = _dinv(A)
        # Gershgorin upper bound (all the fourth-kind smoother needs)
        lmax = ((_slot_sum(torch.where(sm, A.data.abs(), 0)) * dinv.abs()).max()
                if want_lmax else None)
        # direct interpolation on the geometric mask
        a = A.data
        off = sm & (cols != row)
        strong_c = m1d & isc_of(cols)
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
        dii = torch.where(dii != 0, dii, 1)
        coef = torch.where(a < 0, alpha[None, :], beta[None, :])
        pv = torch.where(strong_c, -(coef * a) / dii[None, :], 0)
        pc = cmap_of(cols)
        cum = torch.cumsum(strong_c, 0, dtype=torch.int32)
        first = strong_c & (cum == 1)
        second = strong_c & (cum == 2)
        d0 = torch.where(first, pv, 0).sum(0)
        c0 = torch.where(first, pc, 0).sum(0)
        d1 = torch.where(second, pv, 0).sum(0)
        c1 = torch.where(second, pc, 0).sum(0)
        p_nnz = torch.where(is_c, 1, strong_c.sum(0)).to(torch.int32)
        P = EllMatrix(
            data=torch.stack([torch.where(is_c, 1.0, d0),
                              torch.where(is_c, 0.0, d1)]).to(A.dtype),
            cols=torch.stack([torch.where(is_c, cmap_of(idx), c0),
                              torch.where(is_c, 0, c1)]).to(torch.int32),
            row_nnz=p_nnz, shape=(n, pl["nc"]), n_rows_pad=n_pad,
            n_cols_pad=pl["nc_pad"])
        tgt_m = cmap_of((idx - stride).clamp(min=0))
        tgt_p = cmap_of((idx + stride).clamp(max=n_pad - 1))
        sel_f = is_f & (p_nnz > 0)
        wm = (torch.where(sel_f & (c0 == tgt_m), d0, 0)
              + torch.where(sel_f & (c1 == tgt_m) & (p_nnz > 1), d1, 0))
        wp = (torch.where(sel_f & (c0 == tgt_p), d0, 0)
              + torch.where(sel_f & (c1 == tgt_p) & (p_nnz > 1), d1, 0))
        R, Ac, scal = _level_phase2(
            A, P, k_T=pl["k_T"], k_AP=pl["k_AP"], k_Ac=pl["k_Ac"],
            nc=pl["nc"], filter_tol=filter_tol)
        # the {0,±1}^3-span offsets are a superset of the true coarse
        # pattern on early levels: pmass lets the host prune dead planes
        outs.append(dict(P=P, R=R, Ac=Ac, dinv=dinv, lmax=lmax, wm=wm, wp=wp,
                         planes=planes_prev, pmass=planes_prev.abs().sum(1),
                         leftover=scal[1]))
        planes_prev = _extract_planes(Ac, pl["offsets_c"])
        A = Ac
    return outs, A, planes_prev, torch.stack(n_weaks)


def _geo_levels(A: EllMatrix, n: int, geo: list, levels: list, config,
                ids, device):
    """Run ``_geo_chain`` over every geo level that stays above the host
    threshold, with one host read.  Returns None when a level among the
    first three has more than n/10 weakly coupled F rows along its
    coarsened dimension (the caller rebuilds through PMIS); else (the new
    levels, the next operator, its size, its planes as a HybridMatrix, the
    grid extents after the chain, the filtered ids).  Raises when a RAP
    outgrew its structural width."""
    from raptor_tpu_torch.core.hybrid import GeoTransfer, HybridMatrix

    nlev = 0
    sim_exts, sim_n = list(geo), n
    while (sim_n > config.host_setup_threshold and max(sim_exts) > 2
           and sim_n > config.coarse_size
           and len(levels) + nlev + 1 < config.max_levels):
        dd = int(np.argmax(sim_exts))
        sim_exts[dd] = (sim_exts[dd] + 1) // 2
        sim_n = int(np.prod(sim_exts))
        nlev += 1
    plans, exts_after = _geo_plans(n, A.n_rows_pad, A.K, geo, nlev,
                                   config.pad_multiple)
    # the input's exact plane offsets, for level 0's planes
    cols_h, nnz_h = _np(A.cols), _np(A.row_nnz)
    rows_h = np.broadcast_to(
        np.arange(A.n_rows_pad, dtype=np.int64)[None, :], cols_h.shape)
    mask_h = ((np.arange(A.K)[:, None] < nnz_h[None, :]) & (rows_h < n)
              & (cols_h < n))
    offsets0 = tuple(int(v) for v in np.unique((cols_h - rows_h)[mask_h]))
    A = A.to(device)
    want_lmax = config.smoother in _CHEB_SMOOTHERS
    outs, Ac_last, planes_last, n_weaks = _geo_chain(
        A, plans=plans, theta=config.theta, strength_kind=config.strength,
        want_lmax=want_lmax, filter_tol=config.filter_tol, offsets0=offsets0)
    # the chain's one host read: the anisotropy counts, the RAP width
    # overflows and which planes are live
    host = torch.cat([n_weaks, torch.stack([o["leftover"] for o in outs]),
                      *[(o["pmass"] > 0).long() for o in outs]]).cpu().numpy()
    nw, host = host[:len(n_weaks)], host[len(n_weaks):]
    if any(int(w) > plans[li]["n"] // 10 for li, w in enumerate(nw)):
        return None
    leftover, host = host[:nlev], host[nlev:]
    if leftover.any():
        raise RuntimeError(
            f"geo chain: a Galerkin product outgrew its structural width "
            f"k_Ac (leftover {leftover.tolist()} by level)")
    new_levels = []
    A_cur = A
    for li, (o, pl) in enumerate(zip(outs, plans)):
        offs = offsets0 if li == 0 else plans[li - 1]["offsets_c"]
        live, host = host[:len(offs)] > 0, host[len(offs):]
        planes = o["planes"]
        if not live.all():
            planes = planes[torch.from_numpy(np.flatnonzero(live)).to(device)]
            offs = tuple(v for v, lv_ in zip(offs, live) if lv_)
        eye = np.arange(pl["n_pad"], dtype=np.int32)
        hyb = HybridMatrix(planes=planes, spill=None, perm=eye, iperm=eye,
                           offsets=offs, shape=(pl["n"], pl["n"]),
                           n_pad=pl["n_pad"])
        tg = GeoTransfer(wm=o["wm"], wp=o["wp"],
                         meta=(pl["H"], pl["m"], pl["mc"], pl["stride"],
                               pl["n"], pl["n_pad"], pl["nc_pad"]))
        new_levels.append(Level(A=A_cur, dinv=o["dinv"], P=o["P"], R=o["R"],
                                color=None, cheb_lmax=o["lmax"], n=pl["n"],
                                ncolors=1, Tgeo=tg, Ahyb=hyb))
        if ids is not None:
            keep_c = ((np.arange(pl["n"]) // pl["stride"]) % pl["m"]) % 2 == 0
            ids = ids[keep_c]
        A_cur = o["Ac"]
    last = plans[-1]
    eye = np.arange(last["nc_pad"], dtype=np.int32)
    next_hyb = HybridMatrix(planes=planes_last, spill=None, perm=eye,
                            iperm=eye, offsets=last["offsets_c"],
                            shape=(last["nc"], last["nc"]),
                            n_pad=last["nc_pad"])
    return new_levels, Ac_last, last["nc"], next_hyb, exts_after, ids


def _rs_split_device(A: EllMatrix, smask) -> torch.Tensor:
    """Serial RS splitting of a device level: the strength graph goes to
    the host, the splitting comes back to A's device."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.splitting import rs_splitting_host

    sm = _np(smask)
    cols = _np(A.cols)
    rows = np.broadcast_to(np.arange(A.n_rows_pad), (A.K, A.n_rows_pad))
    S = sp.coo_matrix((np.ones(int(sm.sum())), (rows[sm], cols[sm])),
                      shape=(A.n_rows_pad, A.n_rows_pad)).tocsr()
    cf = rs_splitting_host(S).astype(np.int32)
    return torch.from_numpy(cf).to(A.data.device)


def _unfused_level(A: EllMatrix, config: AmgConfig):
    """One RS level on the device: host splitting, device interpolation,
    exact-width transpose and Galerkin SpGEMMs.  Returns (the level, Ac,
    nc), or None when the level does not coarsen."""
    from raptor_tpu_torch.ops.sparse_ops import ell_filter, ell_transpose, spgemm
    from raptor_tpu_torch.setup.interp import (add_identity_padding,
                                               tighten_coarse_space)
    from raptor_tpu_torch.setup.strength import strength_mask

    n = A.shape[0]
    smask = strength_mask(A, config.theta, config.strength)
    cf = _rs_split_device(A, smask)
    P, nc = _interpolate(A, smask, cf, config.interp, config.p_max_elements)
    nc = int(nc)
    if nc == 0 or nc >= n:
        return None
    P = tighten_coarse_space(P, nc, config.pad_multiple)
    R = ell_transpose(P)
    Ac = add_identity_padding(spgemm(R, spgemm(A, P)), nc)
    if config.filter_tol > 0:
        Ac = ell_filter(Ac, config.filter_tol)
    dinv, color, ncolors, lmax = _smoother_data(A, config, smask)
    lev = Level(A=A, dinv=dinv, P=P, R=R, color=color, cheb_lmax=lmax, n=n,
                ncolors=ncolors)
    return lev, Ac, nc


def _aggressive_level(A: EllMatrix, config: AmgConfig, seed: int):
    """One aggressive level on the device: distance-2 PMIS, multipass
    interpolation, optional Jacobi refinement, exact-width Galerkin
    SpGEMMs and, with ``filter_tol``, the coarse operator's filter.
    Returns (the level, Ac, nc, cf), or None when the level does not
    coarsen."""
    from raptor_tpu_torch.ops.sparse_ops import ell_filter, ell_transpose, spgemm
    from raptor_tpu_torch.setup.aggressive import (aggressive_splitting,
                                                   jacobi_refine_p,
                                                   multipass_interpolation)
    from raptor_tpu_torch.setup.interp import add_identity_padding
    from raptor_tpu_torch.setup.strength import strength_mask

    n = A.shape[0]
    smask = strength_mask(A, config.theta, config.strength)
    cf = aggressive_splitting(A, smask, seed)
    P, nc = multipass_interpolation(A, smask, cf)
    if nc == 0 or nc >= n:
        return None
    if config.interp_refine > 0:
        P = jacobi_refine_p(A, P, cf, config.interp_refine_omega,
                            config.interp_refine, config.p_max_elements)
    R = ell_transpose(P)
    Ac = add_identity_padding(spgemm(R, spgemm(A, P)), nc)
    if config.filter_tol > 0:
        # sparsifies the long-range multipass Galerkin products (config 3)
        Ac = ell_filter(Ac, config.filter_tol)
    dinv, color, ncolors, lmax = _smoother_data(A, config, smask)
    lev = Level(A=A, dinv=dinv, P=P, R=R, color=color, cheb_lmax=lmax, n=n,
                ncolors=ncolors)
    return lev, Ac, nc, cf


def build_hierarchy(A, config: AmgConfig = AmgConfig(), dtype=np.float32,
                    row_ids: "np.ndarray | None" = None,
                    geo: "list | None" = None, *, device) -> Hierarchy:
    """Build an AMG hierarchy from a scipy.sparse matrix or an EllMatrix.

    Levels with ``n > config.host_setup_threshold`` (CLJP levels at every
    size) are built with tensors on ``device`` (the device route): the geo
    chain while the grid lasts, PMIS and CLJP levels through
    ``_fused_level``, aggressive levels through ``_aggressive_level``, RS
    levels through ``_unfused_level``, and the coarsest level with
    ``_dense_inverse`` when the loop ends above the threshold.  Smaller levels go to the host route
    (``host_setup.host_build_tail``, NumPy), with the same integer PMIS
    weights.  The result mixes tensor and NumPy leaves; ``Hierarchy.to``
    moves it to one device.

    ``row_ids`` (optional (n,) array): PMIS tie-break weights key on these
    original identities instead of row positions, so the C/F sets do not
    depend on the ordering the hierarchy is built in (the banded path
    passes its RCM permutation here).

    ``geo`` (optional grid extents [e0, e1, e2] in stride order, from
    ``api._detect_grid``): build geo-split levels while the grid lasts."""
    from raptor_tpu_torch.setup.host_setup import host_build_tail
    from raptor_tpu_torch.setup.splitting import C_PT, make_perm_ids

    if config.splitting not in ("rs", "pmis", "cljp"):
        raise ValueError(f"unknown splitting: {config.splitting}")
    A_in = None
    if not isinstance(A, EllMatrix):
        A_in = A
        with phase("setup.ell"):
            A = ell_from_csr(A, dtype=dtype,
                             row_pad_multiple=config.pad_multiple)
    ids = None if row_ids is None else np.asarray(row_ids)
    geo = None if geo is None else list(geo)  # the live extents
    levels = []
    # DIA planes of the next level's operator, from the geo chain
    pending_hyb = None
    n = A.shape[0]
    host_tail = _host_tail_takes(config)
    while (len(levels) + 1 < config.max_levels and n > config.coarse_size
           and (n > config.host_setup_threshold or not host_tail)):
        if (geo is not None and n == int(np.prod(geo)) and max(geo) > 2
                and n > config.host_setup_threshold):
            with phase("setup.level", len(levels)):
                out = _geo_levels(A, n, geo, levels, config, ids, device)
            if out is None:
                geo = None  # a weak dimension: rebuild through PMIS
                continue
            new_levels, A, n, pending_hyb, geo, ids = out
            levels.extend(new_levels)
            continue
        with phase("setup.to_device"):
            A = A.to(device)
        if config.splitting in ("pmis", "cljp") and not config.aggressive:
            seed = config.seed + len(levels)
            with phase("setup.level", len(levels)):
                perm = (None if ids is None else
                        make_perm_ids(ids, A.n_rows_pad, seed, device=device))
                P, R, Ac, nc, dinv, lmax, cf = _fused_level(
                    A, n, config, seed, perm=perm)
            if nc == 0 or nc >= n:
                break
            if ids is not None:
                ids = ids[cf[:n] == C_PT]
            color, ncolors = _mcgs_color(A, config)
            levels.append(Level(A=A, dinv=dinv, P=P, R=R, color=color,
                                cheb_lmax=lmax, n=n, ncolors=ncolors,
                                Ahyb=pending_hyb))
            pending_hyb = None
            A, n = Ac, nc
            continue
        if config.aggressive:
            with phase("setup.level", len(levels)):
                out = _aggressive_level(A, config, config.seed + len(levels))
            if out is None:
                break
            lev, A, n, cf = out
            if ids is not None:
                ids = ids[_np(cf)[:lev.n] == C_PT]
            levels.append(lev)
            continue
        with phase("setup.level", len(levels)):
            out = _unfused_level(A, config)
        if out is None:
            break
        lev, A, n = out
        levels.append(lev)

    if n <= config.host_setup_threshold and host_tail:
        with phase("setup.host_tail"):
            hier = host_build_tail(A, levels, config, dtype, row_ids=ids,
                                   geo=geo, ahyb0=pending_hyb)
    else:  # the coarsest level, built on the device
        A = A.to(device)
        dinv, color, ncolors, lmax = _smoother_data(A, config, None)
        # it keeps the chain's planes when the loop ends right after one
        levels.append(Level(A=A, dinv=dinv, P=None, R=None, color=color,
                            cheb_lmax=lmax, n=n, ncolors=ncolors,
                            Ahyb=pending_hyb))
        hier = Hierarchy(levels=tuple(levels),
                         coarse_inv=_dense_inverse(A, n_true=n), config=config)
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
