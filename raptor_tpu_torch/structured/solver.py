"""Structured multigrid engine: semicoarsening + operator-collapsed
interpolation on DIA operators.

Counterpart of ``raptor_tpu/structured/solver.py``.  Coarsening every second
plane along one dimension per level keeps every grid regular, so
restriction/prolongation compact/expand via strided views, every level
operator stays DIA, and the Galerkin RAP is the static-offset DIA product.

Interpolation is operator-dependent 1D collapsing: an F-plane point splits
its row between its two in-line C neighbors,
  w_∓ = -(Σ_{o_d = ∓1} a_o) / (Σ_{o_d = 0} a_o),
which reproduces linear interpolation on Poisson and adapts to coefficient
jumps/anisotropy.

With ``AmgConfig.full_coarsening`` a level whose live couplings are
balanced coarsens every dimension at once (plan marker ``FULL_STEP``) with
BoxMG-style staged operator-induced interpolation (``_build_transfer_full``).

Vectors may carry a leading batch dimension (B, n) through the smoothers,
the transfers and ``dia_spmv``: ``materialize_tail`` applies a level's cycle
body to every identity column at once.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.solve.krylov import host_read, krylov_dispatch, pcg
from raptor_tpu_torch.structured.dia import (
    DiaMatrix,
    _linear,
    boundary_mask_traced,
    dia_df64_residual,
    dia_filter_offsets,
    dia_mult,
    dia_spmv,
    dia_transpose,
    dia_tri_spmv,
)
from raptor_tpu_torch.utils.df64 import df_add, df_from
from raptor_tpu_torch.utils.profiling import phase, spanned

__all__ = ["SLevel", "SHierarchy", "plan_coarsening",
           "build_structured_hierarchy", "structured_solve",
           "structured_solve_refined", "scycle", "cast_hierarchy",
           "materialize_tail"]

Vec = Tuple[int, ...]

FULL_STEP = -2  # plan marker: coarsen every dimension at once


def _to(t, device):
    return None if t is None else t.to(device)


@dataclasses.dataclass(frozen=True)
class SLevel:
    A: DiaMatrix  # operator on this level's grid
    Pt: Optional[DiaMatrix]  # embedded prolongation (this grid), None at coarsest
    Rt: Optional[DiaMatrix]
    dinv: torch.Tensor
    red: torch.Tensor  # bool red-black mask
    cheb_lmax: Optional[torch.Tensor]
    dims: Vec
    cdim: int  # dimension coarsened to reach the next level (-1 at coarsest)

    def to(self, device) -> "SLevel":
        return dataclasses.replace(
            self, A=self.A.to(device), Pt=_to(self.Pt, device),
            Rt=_to(self.Rt, device), dinv=self.dinv.to(device),
            red=self.red.to(device), cheb_lmax=_to(self.cheb_lmax, device))


@dataclasses.dataclass(frozen=True)
class SHierarchy:
    levels: Tuple[SLevel, ...]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    config: AmgConfig
    # dense coarse tail: the whole sub-cycle at level tail_start as ONE dense
    # matrix, so the cycle below tail_start is a single matvec
    tail_op: Optional[torch.Tensor] = None
    tail_start: int = -1

    def to(self, device) -> "SHierarchy":
        return dataclasses.replace(
            self, levels=tuple(lv.to(device) for lv in self.levels),
            coarse_inv=self.coarse_inv.to(device),
            tail_op=_to(self.tail_op, device))


# ---------------------------------------------------------------------------
# grid helpers
# ---------------------------------------------------------------------------

def _coarse_dims(dims: Vec, d: int) -> Vec:
    out = list(dims)
    out[d] = (dims[d] + 1) // 2
    return tuple(out)


def _every_other(dims: Vec, d: int):
    return (Ellipsis,) + tuple(slice(None, None, 2) if ax == d else slice(None)
                               for ax in range(len(dims)))


def _compact(v: torch.Tensor, dims: Vec, d: int) -> torch.Tensor:
    lead = v.shape[:-1]
    return v.reshape(*lead, *dims)[_every_other(dims, d)].reshape(*lead, -1)


def _expand(vc: torch.Tensor, dims: Vec, d: int) -> torch.Tensor:
    lead = vc.shape[:-1]
    out = vc.new_zeros(*lead, *dims)
    out[_every_other(dims, d)] = vc.reshape(*lead, *_coarse_dims(dims, d))
    return out.reshape(*lead, -1)


def _every_other_full(dims: Vec):
    return (Ellipsis,) + tuple(slice(None, None, 2) for _ in dims)


def _compact_full(v: torch.Tensor, dims: Vec) -> torch.Tensor:
    lead = v.shape[:-1]
    return v.reshape(*lead, *dims)[_every_other_full(dims)].reshape(*lead, -1)


def _expand_full(vc: torch.Tensor, dims: Vec) -> torch.Tensor:
    lead = vc.shape[:-1]
    cd = tuple((d + 1) // 2 for d in dims)
    out = vc.new_zeros(*lead, *dims)
    out[_every_other_full(dims)] = vc.reshape(*lead, *cd)
    return out.reshape(*lead, -1)


def _restrict(rr: torch.Tensor, lev: "SLevel") -> torch.Tensor:
    """Compact an embedded residual to the next level's grid."""
    if lev.cdim == FULL_STEP:
        return _compact_full(rr, lev.dims)
    return _compact(rr, lev.dims, lev.cdim)


def _prolong(ec: torch.Tensor, lev: "SLevel") -> torch.Tensor:
    """Embed a coarse correction into this level's grid."""
    if lev.cdim == FULL_STEP:
        return _expand_full(ec, lev.dims)
    return _expand(ec, lev.dims, lev.cdim)


def _coord(dims: Vec, ax: int, device) -> torch.Tensor:
    """(n,) int64: each row's coordinate along ``ax``."""
    stride = int(np.prod(dims[ax + 1:]))
    return (torch.arange(int(np.prod(dims)), device=device) // stride) % dims[ax]


def _parity(dims: Vec, device) -> torch.Tensor:
    """(n,) red-black coloring of the grid."""
    return sum(_coord(dims, ax, device) for ax in range(len(dims))) % 2


def _c_mask_traced(dims: Vec, d: int, device) -> torch.Tensor:
    """(n,) bool: coord_d even."""
    return _coord(dims, d, device) % 2 == 0


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def _nonzero_or_one(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v.abs() > 0, v, torch.ones_like(v))


def _collapse_weights(A: DiaMatrix, d: int):
    """Operator-collapsed line weights: w∓ = -(Σ_{o_d=∓1} a)/(Σ_{o_d=0} a)."""

    def ssum(ks):
        if not ks:
            return torch.zeros(A.n, dtype=A.dtype, device=A.device)
        acc = A.data[ks[0]]
        for k in ks[1:]:
            acc = acc + A.data[k]
        return acc

    def along(v):
        return ssum([k for k, o in enumerate(A.offsets) if o[d] == v])

    denom = _nonzero_or_one(along(0))
    return -along(-1) / denom, -along(1) / denom


def _build_transfer(A: DiaMatrix, d: int) -> DiaMatrix:
    """Embedded prolongation Pt on A's grid: identity at C planes (coord_d
    even), line interpolation from the two in-line C neighbors at F planes."""
    dims, dev = A.dims, A.device
    cm = _c_mask_traced(dims, d, dev)
    fm = ~cm
    w_m, w_p = _collapse_weights(A, d)
    e = tuple(1 if ax == d else 0 for ax in range(len(dims)))
    ne = tuple(-1 if ax == d else 0 for ax in range(len(dims)))
    bm_p = boundary_mask_traced(dims, e, dev)
    bm_m = boundary_mask_traced(dims, ne, dev)
    zero_off = tuple([0] * len(dims))
    data = torch.stack([
        torch.where(fm & bm_m, w_m, 0.0).to(A.dtype),
        cm.to(A.dtype),
        torch.where(fm & bm_p, w_p, 0.0).to(A.dtype),
    ])
    return DiaMatrix(data=data, offsets=(ne, zero_off, e), dims=dims)


def _build_transfer_full(A: DiaMatrix) -> DiaMatrix:
    """Embedded prolongation for full coarsening (C = all-even points):
    BoxMG-style staged operator-induced interpolation.

    Stage s defines the F-points that are odd in exactly s dimensions from
    already-defined neighbors (fewer odd dims), with weights from the
    stencil collapsed over the even dims:

        w_sigma = - (Σ_{o: o|T = sigma} a_o) / (Σ_{o: o|T = 0} a_o)

    for each odd-dim subset T and sigma in {-1,0,1}^T minus 0.  The total
    prolongator is the composition P_nd ∘ ... ∘ P_1; parity bounds its true
    support to inf-norm <= 1 offsets, so the structurally dead planes of
    the composition are filtered exactly."""
    dims, dev = A.dims, A.device
    nd = len(dims)
    odd = [_coord(dims, d, dev) % 2 == 1 for d in range(nd)]

    def embed(T, sigma):
        o = [0] * nd
        for d, v in zip(T, sigma):
            o[d] = v
        return tuple(o)

    stages = []
    for s_ in range(1, nd + 1):
        planes: dict = {}
        class_any = None
        for T in itertools.combinations(range(nd), s_):
            mask = None
            for d in range(nd):
                m = odd[d] if d in T else ~odd[d]
                mask = m if mask is None else mask & m
            class_any = mask if class_any is None else class_any | mask
            # collapsed couplings over the non-T dims
            denom = None
            for k, o in enumerate(A.offsets):
                if all(o[d] == 0 for d in T):
                    denom = A.data[k] if denom is None else denom + A.data[k]
            denom = _nonzero_or_one(denom)
            for sigma in itertools.product((-1, 0, 1), repeat=s_):
                if all(v == 0 for v in sigma):
                    continue
                num = None
                for k, o in enumerate(A.offsets):
                    if all(o[d] == v for d, v in zip(T, sigma)):
                        num = A.data[k] if num is None else num + A.data[k]
                if num is None:
                    continue
                w = torch.where(mask, -num / denom, 0.0).to(A.dtype)
                off = embed(T, sigma)
                planes[off] = planes[off] + w if off in planes else w
        # identity on everything not in this stage's classes
        zero = tuple([0] * nd)
        ident = torch.where(class_any, 0.0, 1.0).to(A.dtype)
        planes[zero] = planes[zero] + ident if zero in planes else ident
        offs = sorted(planes)
        stages.append(DiaMatrix(data=torch.stack([planes[o] for o in offs]),
                                offsets=tuple(offs), dims=dims))

    Pt = stages[0]
    for Ps in stages[1:]:
        Pt = dia_filter_offsets(dia_mult(Ps, Pt, keep=_inf_norm_le1),
                                _inf_norm_le1)
    return Pt


def _inf_norm_le1(o) -> bool:
    return max(abs(v) for v in o) <= 1


def _all_even(o) -> bool:
    return all(v % 2 == 0 for v in o)


def _compact_dia_full(Ae: DiaMatrix) -> DiaMatrix:
    """Restrict an all-even-supported embedded operator to the full-coarse
    grid (compact every dimension)."""
    out = Ae
    for d in range(len(Ae.dims)):
        out = _compact_dia(out, d)
    return out


def _compact_dia(Ae: DiaMatrix, d: int) -> DiaMatrix:
    """Restrict an embedded C-row/C-col operator to the coarse grid."""
    dims = Ae.dims
    cd = _coarse_dims(dims, d)
    planes, offs = [], []
    for k, o in enumerate(Ae.offsets):
        if o[d] % 2 != 0:
            continue  # identically zero between C points
        oc = tuple(v // 2 if ax == d else v for ax, v in enumerate(o))
        plane = _compact(Ae.data[k], dims, d)
        # re-truncate for the coarse grid box
        plane = plane * boundary_mask_traced(cd, oc, Ae.device).to(Ae.dtype)
        planes.append(plane)
        offs.append(oc)
    return DiaMatrix(data=torch.stack(planes), offsets=tuple(offs), dims=cd)


LMAX_ITERS = 40  # power iterations for the Chebyshev smoothers' lmax
LMAX_SAFETY = 1.1


def _estimate_lmax_dia(A: DiaMatrix, dinv):
    """Power iteration on D^-1 A from the reference's start vector."""
    i = torch.arange(A.n, dtype=A.dtype, device=A.device)
    v = torch.sin(i * 0.7511) + 0.01
    v = v / torch.linalg.vector_norm(v)
    for _ in range(LMAX_ITERS):
        w = dinv * dia_spmv(A, v)
        v = w / torch.linalg.vector_norm(w)
    w = dinv * dia_spmv(A, v)
    return LMAX_SAFETY * torch.dot(v, w) / torch.dot(v, v)


@spanned("setup.plan")
def plan_coarsening(
    A: DiaMatrix, config: AmgConfig, dim_policy: str = "operator",
    allow_full: bool | None = None,
) -> Tuple[int, ...]:
    """Coarsening plan (sequence of dims, ``FULL_STEP`` for a step that
    coarsens every dimension).

    'size' policy is fully static; 'operator' reads the per-offset plane
    means once, then evolves the couplings with the standard semicoarsening
    model (coarsening dim d scales its coupling by 1/4 — h_d doubles).
    ``allow_full`` (default ``config.full_coarsening``) takes a full step
    while every dimension is live and the couplings are within 4x."""
    if allow_full is None:
        allow_full = config.full_coarsening
    dims = list(A.dims)
    nd = len(dims)
    if dim_policy == "operator":
        # stencil second moments: s_d = -(1/2) Σ_o mean(a_o) o_d^2 recovers
        # the continuum diffusion coefficient D_dd for constant coefficients
        means = A.data.float().mean(dim=1).cpu().numpy()
        s = []
        for ax in range(nd):
            s.append(float(-0.5 * sum(
                means[k] * (o[ax] ** 2) for k, o in enumerate(A.offsets)
            )))
        s = [max(v, 0.0) for v in s]
        if max(s) <= 0:
            s = [float(d) for d in dims]
    else:
        s = [float(d) for d in dims]

    plan = []
    n = int(np.prod(dims))
    while (
        len(plan) + 1 < config.max_levels
        and n > config.coarse_size
        and max(dims) > 3
    ):
        live = [ax for ax in range(nd) if dims[ax] > 3]
        s_live = [s[ax] for ax in live]
        balanced = (allow_full and len(live) == nd
                    and max(s_live) <= 4.0 * max(min(s_live), 1e-30))
        if balanced:
            plan.append(FULL_STEP)
            for ax in range(nd):
                dims[ax] = (dims[ax] + 1) // 2
                s[ax] /= 4.0
        else:
            cand = [s[ax] if dims[ax] > 3 else -1.0 for ax in range(nd)]
            d = int(np.argmax(cand))
            plan.append(d)
            dims[d] = (dims[d] + 1) // 2
            s[d] /= 4.0
        n = int(np.prod(dims))
    return tuple(plan)


def _smoother_data(A: DiaMatrix, config: AmgConfig):
    dinv = 1.0 / _nonzero_or_one(A.diagonal())
    lmax = (_estimate_lmax_dia(A, dinv)
            if config.smoother in ("chebyshev", "cheb4") else None)
    return dinv, _parity(A.dims, A.device) == 0, lmax


def _build_hierarchy_planned(
    A: DiaMatrix, config: AmgConfig, plan: Tuple[int, ...]
) -> SHierarchy:
    """The numeric setup for a fixed plan: transfers, Galerkin RAP and
    smoother data for every level."""
    levels = []
    for k, d in enumerate(plan):
        with phase("setup.transfer", k):
            Pt = (_build_transfer_full(A) if d == FULL_STEP
                  else _build_transfer(A, d))
            Rt = dia_transpose(Pt)
        with phase("setup.rap", k):
            if d == FULL_STEP:
                Ac = _compact_dia_full(
                    dia_mult(Rt, dia_mult(A, Pt), keep=_all_even))
            else:
                Ac = _compact_dia(dia_mult(Rt, dia_mult(A, Pt)), d)
        with phase("setup.smoother", k):
            dinv, red, lmax = _smoother_data(A, config)
        levels.append(SLevel(A=A, Pt=Pt, Rt=Rt, dinv=dinv, red=red,
                             cheb_lmax=lmax, dims=A.dims, cdim=d))
        A = Ac
    with phase("setup.smoother", len(plan)):
        dinv, red, lmax = _smoother_data(A, config)
    levels.append(SLevel(A=A, Pt=None, Rt=None, dinv=dinv, red=red,
                         cheb_lmax=lmax, dims=A.dims, cdim=-1))
    return SHierarchy(levels=tuple(levels), coarse_inv=_dia_dense_inverse(A),
                      config=config)


@spanned("setup.structured", fence=True)
def build_structured_hierarchy(
    A: DiaMatrix,
    config: AmgConfig = AmgConfig(smoother="mcgs"),
    dim_policy: str = "operator",
) -> SHierarchy:
    """Semicoarsening hierarchy on A's device: plan the coarsening
    sequence, then run the numeric setup."""
    plan = plan_coarsening(A, config, dim_policy)
    hier = _build_hierarchy_planned(A, config, plan)
    if config.operator_store_dtype != "same":
        hier = cast_hierarchy(hier, getattr(torch, config.operator_store_dtype))
    if config.tail_max_n > 0:
        # capped as in the reference: folding levels above 2048 rows costs a
        # larger dense matvec than the DIA levels it replaces
        hier = materialize_tail(hier, min(config.tail_max_n, 2048))
    return hier


def _slevel_dense(lev: SLevel, cfg: AmgConfig, Meff: torch.Tensor) -> torch.Tensor:
    """Dense matrix of ONE level's cycle body with the recursion replaced
    by the (already dense) coarse map ``Meff``: the body is applied to all
    identity columns at once as a (n, n) batch."""
    c = torch.eye(lev.A.n, dtype=lev.dinv.dtype, device=lev.dinv.device)
    x = _smooth(lev, cfg, c, torch.zeros_like(c), backward=False)
    r = c - dia_spmv(lev.A, x)
    rc = _restrict(dia_spmv(lev.Rt, r), lev)
    # row-wise Meff @ rc (an fp32 Meff promotes to a float64 level's dtype)
    e = _prolong(rc @ Meff.T.to(rc.dtype), lev)
    x = x + dia_spmv(lev.Pt, e)
    return _smooth(lev, cfg, c, x, backward=True).T


def _dense_op(A: DiaMatrix) -> torch.Tensor:
    """Dense matrix of a DIA operator (for the W-cycle coarse revisit)."""
    eye = torch.eye(A.n, dtype=torch.float32, device=A.device)
    return dia_spmv(A, eye).T


@spanned("setup.tail")
def materialize_tail(hier: SHierarchy, max_n: int,
                     min_start: int = 1) -> SHierarchy:
    """Fold the coarse tail of the cycle into one dense operator: the first
    level at or after ``min_start`` with n <= max_n and everything below it
    (smoothers, transfers, recursion, coarse solve) collapse into
    ``tail_op``.  ``min_start=1`` never folds the fine level; the sharded
    engine's replicated tail, coarse already at its level 0, passes 0.

    The coarse inverse enters in fp32, as in the reference; a float64
    hierarchy (the CPU tests) promotes it back to float64 where the
    reference's mixed products promote."""
    ts = next((i for i in range(min_start, len(hier.levels))
               if hier.levels[i].A.n <= max_n), None)
    if ts is None or ts >= len(hier.levels) - 1:
        return hier  # nothing to fold (coarsest is already one dense matvec)
    cfg = hier.config
    M = hier.coarse_inv.float()
    for k in range(len(hier.levels) - 2, ts - 1, -1):
        if cfg.cycle == "W" and k + 1 < len(hier.levels) - 1:
            # the coarse visit happens twice on an updated residual:
            # ec = M rc + M (rc - A' M rc)  ->  Meff = 2M - M A' M
            Ad = _dense_op(hier.levels[k + 1].A)
            dt = torch.promote_types(M.dtype, Ad.dtype)
            M, Ad = M.to(dt), Ad.to(dt)
            Meff = 2.0 * M - M @ Ad @ M
        else:
            Meff = M
        M = _slevel_dense(hier.levels[k], cfg, Meff)
    tail_op = M
    if hier.levels[0].A.dtype == torch.bfloat16:
        tail_op = tail_op.to(torch.bfloat16)  # same storage rule as A/Pt/Rt
    return dataclasses.replace(hier, tail_op=tail_op, tail_start=ts)


@spanned("setup.cast", fence=True)
def cast_hierarchy(hier: SHierarchy, dtype: torch.dtype) -> SHierarchy:
    """Store the level operators (A/Pt/Rt diagonals) in a narrower dtype;
    vectors and reductions stay in the solve dtype (the kernels widen each
    plane value before the multiply)."""

    def cd(m):
        return None if m is None else dataclasses.replace(m, data=m.data.to(dtype))

    levels = tuple(
        dataclasses.replace(lv, A=cd(lv.A), Pt=cd(lv.Pt), Rt=cd(lv.Rt))
        for lv in hier.levels
    )
    tail = None if hier.tail_op is None else hier.tail_op.to(dtype)
    return SHierarchy(levels=levels, coarse_inv=hier.coarse_inv,
                      config=hier.config, tail_op=tail,
                      tail_start=hier.tail_start)


@spanned("setup.coarse_inverse")
def _dia_dense_inverse(A: DiaMatrix) -> torch.Tensor:
    """Explicit inverse of the coarsest operator, so the coarse solve is a
    single dense matvec.  Setup-only; accuracy is ample for a
    preconditioner component."""
    n = A.n
    dense = torch.zeros((n, n), dtype=A.dtype, device=A.device)
    rows = torch.arange(n, device=A.device)
    for k, off in enumerate(A.offsets):
        cols = torch.clamp(rows + _linear(off, A.dims), 0, n - 1)
        valid = boundary_mask_traced(A.dims, off, A.device)
        dense.index_put_((rows, cols), torch.where(valid, A.data[k], 0.0),
                         accumulate=True)
    # regularize empty rows (possible on tiny padded boxes)
    diag_fix = torch.where(dense.diagonal().abs() > 0, 0.0, 1.0).to(A.dtype)
    return torch.linalg.inv(dense + torch.diag(diag_fix))


# ---------------------------------------------------------------------------
# cycle + solve
# ---------------------------------------------------------------------------

def _smooth(lev: SLevel, cfg: AmgConfig, b, x, backward: bool,
            x0_zero: bool = False):
    """``x0_zero`` asserts x == 0 on entry: the first residual is exactly
    ``b``, which saves one A-SpMV (b - A@0 == b up to zero signs)."""
    sweeps = cfg.nu2 if backward else cfg.nu1
    if sweeps == 0:
        return x
    first = [x0_zero]  # consumed by the FIRST residual below

    def res(x):
        if first[0]:
            first[0] = False
            return b
        return b - dia_spmv(lev.A, x)

    if cfg.smoother == "jacobi":
        for _ in range(sweeps):
            x = x + cfg.omega * lev.dinv * res(x)
        return x
    if cfg.smoother == "mcgs":  # exact red-black on the grid
        order = (False, True) if backward else (True, False)
        for _ in range(sweeps):
            for red_turn in order:
                r = res(x)
                upd = lev.red if red_turn else ~lev.red
                x = x + torch.where(upd, lev.dinv * r, 0.0)
        return x
    if cfg.smoother == "tsgs":
        # two-stage Gauss-Seidel: inner Jacobi series on the strict triangle
        for _ in range(sweeps):
            r = res(x)
            z = lev.dinv * r
            for _j in range(cfg.gs_inner):
                z = lev.dinv * (r - dia_tri_spmv(lev.A, z, upper=backward))
            x = x + z
        return x
    if cfg.smoother == "cheb4":
        r = res(x)
        d = (4.0 / 3.0) / lev.cheb_lmax * (lev.dinv * r)
        x = x + d
        for k in range(2, cfg.cheb_degree + 1):
            r = r - dia_spmv(lev.A, d)
            d = ((2 * k - 3) / (2 * k + 1)) * d + (
                (8 * k - 4) / (2 * k + 1) / lev.cheb_lmax
            ) * (lev.dinv * r)
            x = x + d
        return x
    if cfg.smoother == "chebyshev":
        lmax = lev.cheb_lmax
        lmin = lmax / 30.0
        dd = (lmax + lmin) / 2
        cc = (lmax - lmin) / 2
        p = torch.zeros_like(x)
        alpha = torch.zeros_like(dd)
        for i in range(cfg.cheb_degree):
            z = lev.dinv * res(x)
            if i == 0:
                p, alpha = z, 1.0 / dd
            else:
                beta = (cc * alpha / 2) ** 2
                alpha = 1.0 / (dd - beta / alpha)
                p = z + beta * p
            x = x + alpha * p
        return x
    raise ValueError(cfg.smoother)


def _slevel(hier: SHierarchy, cfg: AmgConfig, k: int, b):
    lev = hier.levels[k]
    if k == hier.tail_start and hier.tail_op is not None:
        # dense coarse tail: the materialized sub-cycle in one matvec
        with phase("vcycle.coarse"):
            return hier.tail_op.to(b.dtype) @ b
    if k == len(hier.levels) - 1:
        with phase("vcycle.coarse"):
            return hier.coarse_inv @ b
    with phase("vcycle.smooth", k):
        x = _smooth(lev, cfg, b, torch.zeros_like(b), backward=False,
                    x0_zero=True)
    with phase("vcycle.residual", k):
        r = b - dia_spmv(lev.A, x) if cfg.nu1 else b
    with phase("vcycle.restrict", k):
        rc = _restrict(dia_spmv(lev.Rt, r), lev)
    ec = _slevel(hier, cfg, k + 1, rc)
    if cfg.cycle == "W" and k + 1 < len(hier.levels) - 1:
        Ac = hier.levels[k + 1].A
        ec = ec + _slevel(hier, cfg, k + 1, rc - dia_spmv(Ac, ec))
    with phase("vcycle.prolong", k):
        x = x + dia_spmv(lev.Pt, _prolong(ec, lev))
    with phase("vcycle.smooth", k):
        return _smooth(lev, cfg, b, x, backward=True)


@spanned("vcycle")
def scycle(hier: SHierarchy, b, cfg: AmgConfig | None = None):
    """One structured V-/W-cycle (the preconditioner application)."""
    return _slevel(hier, cfg or hier.config, 0, b)


def structured_solve(
    hier: SHierarchy,
    b: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 200,
    krylov: str = "cg",
    precondition: bool = True,
    M_hier: SHierarchy | None = None,
):
    """Structured AMG-PCG solve.  ``M_hier``: optional separate hierarchy
    for the preconditioner (a bf16 ``cast_hierarchy`` copy halves the
    cycle's plane traffic while the Krylov operator stays in ``hier``'s
    precision)."""
    A = hier.levels[0].A
    Mh = hier if M_hier is None else M_hier

    def apply_A(x):
        return dia_spmv(A, x)

    if precondition:
        def apply_M(r):
            return scycle(Mh, r).to(b.dtype)
    else:
        def apply_M(r):
            return r

    return krylov_dispatch(krylov)(apply_A, b, apply_M, tol=tol, maxiter=maxiter)


# ---------------------------------------------------------------------------
# mixed-precision refinement (df64 residuals)
# ---------------------------------------------------------------------------

@spanned("refine.residual")
def _df64_residual(A: DiaMatrix, xh, xl, bh, bl):
    """r = b - A x with compensated (double-float32) accumulation: exact to
    ~1e-14 relative, so it certifies 1e-8 without fp64.  K7 in one pass on
    the card, op by op on the CPU (``dia_df64_residual``)."""
    return dia_df64_residual(A, xh, xl, bh, bl)


@spanned("solve")
def structured_solve_refined(
    hier: SHierarchy,
    b: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 100,
    outer: int = 3,
    M_hier: SHierarchy | None = None,
):
    """Solve to a TRUE <= tol relative residual: fp32 AMG-PCG inner solves
    inside an iterative-refinement loop whose residuals are computed in
    compensated double-float32.  The outer loop reads the residual norm on
    the host once per round, and the round's iterations after it
    (``host_reads["refine"]``).

    Returns ((x_hi, x_lo), true_relres, total_inner_iterations): the
    solution is a double-float32 pair — collapse with
    ``x_hi.double() + x_lo.double()`` (exact) when one array is needed.
    """
    A = hier.levels[0].A
    Mh = hier if M_hier is None else M_hier

    def apply_A(v):
        return dia_spmv(A, v)

    def apply_M(r):
        return scycle(Mh, r).to(b.dtype)

    bh, bl = df_from(b)
    bnorm = torch.sqrt(torch.dot(b, b))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    xh = torch.zeros_like(b)
    xl = torch.zeros_like(b)
    rh, rl = _df64_residual(A, xh, xl, bh, bl)
    relres = torch.sqrt(torch.dot(rh, rh)) / bnorm
    total_it, k = 0, 0
    # residual-gated: stop as soon as a round certifies tol
    while k < outer and host_read("refine", relres > tol):
        # inner tolerance: enough progress that `outer` rounds certify tol,
        # floored at what fp32 recurrences can deliver
        inner_tol = torch.clamp(tol / torch.clamp(relres, min=1e-30), 1e-5, 0.9)
        e, info = pcg(apply_A, rh, apply_M, tol=inner_tol, maxiter=maxiter)
        xh, xl = df_add(xh, xl, e, torch.zeros_like(e))
        rh, rl = _df64_residual(A, xh, xl, bh, bl)
        relres = torch.sqrt(torch.dot(rh, rh)) / bnorm
        total_it += host_read("refine", info.iterations)
        k += 1
    iters = torch.tensor(total_it, dtype=torch.int32, device=b.device)
    return (xh, xl), relres, iters
