"""Multigrid cycles of the algebraic engine.

Counterpart of ``raptor_tpu/solve/cycle.py``.  The V-/W-cycle recursion is
plain Python over the levels; the coarsest level is a dense inverse (one
matvec) and the coarse tail below ``tail_start`` can be folded into one
dense operator (``materialize_tail``).  A level's operator runs through
its BlockELL layout (``Abell``, K8 on the card), K1 on its DIA planes
(``Ahyb``) or K4 on its banded layout, and its transfers through the
geo-split reshapes (``Tgeo``) or K6 (``core/hybrid.py``); the others use
the gather ELL SpMV.  On a fast layout the smoothers take their operator
applies from it, the two-stage GS's inner triangular series excepted
(scalar ELL, the same matrix in the same ordering).

The reference folds the tail by ``vmap`` over identity columns; here the
columns are a batch dimension (B, n) on the ELL path.  As in the
reference, the fast layouts are stripped for that, so the kernels only
ever see 1-D vectors; the BlockELL layout is kept, and K8 takes the batch.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.ops.sparse_ops import spmv
from raptor_tpu_torch.solve.smoothers import (chebyshev, chebyshev4, jacobi,
                                              multicolor_gs, triangular_apply,
                                              two_stage_gs)
from raptor_tpu_torch.utils.profiling import phase, spanned

if TYPE_CHECKING:
    from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level

__all__ = ["apply_op", "apply_transfer", "cycle", "make_preconditioner",
           "materialize_tail"]

def apply_op(lev: "Level", x):
    """A @ x through the level's BlockELL layout, DIA planes (K1) or banded
    layout (K4) when present, else the gather ELL SpMV.  All share the
    level's vector ordering."""
    if lev.Abell is not None:
        from raptor_tpu_torch.core.bell import bell_spmv

        return bell_spmv(lev.Abell, x)
    if lev.Ahyb is not None:
        from raptor_tpu_torch.core.hybrid import hybrid_spmv_ro

        return hybrid_spmv_ro(lev.Ahyb, x)
    if lev.Aband is not None:
        from raptor_tpu_torch.core.hybrid import banded_spmv, banded_spmv_ro

        if lev.Aband.reordered:
            # RCM'd coarse level: two O(n) takes bracket the kernel
            return banded_spmv(lev.Aband, x)
        return banded_spmv_ro(lev.Aband, x)
    return spmv(lev.A, x)


def _smooth_sp(lev: "Level", cfg: AmgConfig, b, x, backward: bool, sp,
               x0_zero: bool = False):
    """The scalar smoothers against an operator-apply closure ``sp``, used
    when the level's operator runs through a fast layout."""
    sweeps = cfg.nu2 if backward else cfg.nu1
    if sweeps == 0:
        return x
    first = [x0_zero]  # consumed by the first residual below

    def res(x):
        if first[0]:
            first[0] = False
            return b
        return b - sp(x)

    if cfg.smoother == "jacobi":
        for _ in range(sweeps):
            x = x + cfg.omega * lev.dinv * res(x)
        return x
    if cfg.smoother == "mcgs":
        order = list(range(lev.ncolors))
        if backward:
            order.reverse()
        for _ in range(sweeps):
            for c in order:
                x = x + torch.where(lev.color == c, lev.dinv * res(x), 0)
        return x
    if cfg.smoother == "tsgs":
        # the outer residual through the fast layout, the inner triangular
        # Jacobi series on the scalar ELL
        for _ in range(sweeps):
            r = res(x)
            z = lev.dinv * r
            for _j in range(cfg.gs_inner):
                z = lev.dinv * (r - triangular_apply(lev.A, z, upper=backward))
            x = x + z
        return x
    if cfg.smoother == "chebyshev":
        lmax = lev.cheb_lmax
        lmin = lmax / 30.0
        d = (lmax + lmin) / 2
        c = (lmax - lmin) / 2
        p = torch.zeros_like(x)
        alpha = torch.zeros_like(d)
        for i in range(cfg.cheb_degree):
            z = lev.dinv * res(x)
            if i == 0:
                p, alpha = z, 1.0 / d
            else:
                beta = (c * alpha / 2) ** 2
                alpha = 1.0 / (d - beta / alpha)
                p = z + beta * p
            x = x + alpha * p
        return x
    if cfg.smoother == "cheb4":
        r = res(x)
        d = (4.0 / 3.0) / lev.cheb_lmax * (lev.dinv * r)
        x = x + d
        for k in range(2, cfg.cheb_degree + 1):
            r = r - sp(d)
            d = ((2 * k - 3) / (2 * k + 1)) * d + (
                (8 * k - 4) / (2 * k + 1) / lev.cheb_lmax
            ) * (lev.dinv * r)
            x = x + d
        return x
    raise ValueError(f"unknown smoother for banded layout: {cfg.smoother}")


def apply_transfer(band, E, v):
    """Transfer (P or R) through the rectangular banded layout when the
    level carries one (K6), else the gather ELL path.  The banded plan's
    padded column space can exceed E.n_cols_pad by one page tail."""
    if band is None:
        return spmv(E, v)
    from raptor_tpu_torch.core.hybrid import rect_banded_spmv

    n_cols = band.meta[2]
    if v.shape[0] < n_cols:
        v = torch.cat([v, v.new_zeros(n_cols - v.shape[0])])
    return rect_banded_spmv(band, v)


def _smooth(lev: "Level", cfg: AmgConfig, b, x, backward: bool,
            x0_zero: bool = False):
    sweeps = cfg.nu2 if backward else cfg.nu1
    if sweeps == 0:
        return x
    if lev.Aband is not None or lev.Ahyb is not None:
        return _smooth_sp(lev, cfg, b, x, backward,
                          sp=lambda v: apply_op(lev, v), x0_zero=x0_zero)
    if cfg.smoother == "block_jacobi":
        if lev.Abell is None:  # no block alignment: scalar Jacobi
            return jacobi(lev.A, lev.dinv, b, x, omega=cfg.omega,
                          sweeps=sweeps, x0_zero=x0_zero)
        from raptor_tpu_torch.core.bell import block_jacobi

        return block_jacobi(lev.Abell, lev.binv, b, x, omega=cfg.omega,
                            sweeps=sweeps, x0_zero=x0_zero)
    if cfg.smoother == "block_cheb":
        if lev.Abell is None:  # scalar-diagonal fourth-kind Chebyshev
            return chebyshev4(lev.A, lev.dinv, b, x, lev.cheb_lmax,
                              degree=cfg.cheb_degree, x0_zero=x0_zero)
        from raptor_tpu_torch.core.bell import block_chebyshev4

        return block_chebyshev4(lev.Abell, lev.binv, b, x, lev.cheb_lmax,
                                degree=cfg.cheb_degree, x0_zero=x0_zero)
    if cfg.smoother == "jacobi":
        return jacobi(lev.A, lev.dinv, b, x, omega=cfg.omega, sweeps=sweeps,
                      x0_zero=x0_zero)
    if cfg.smoother == "mcgs":
        return multicolor_gs(lev.A, lev.dinv, b, x, lev.color,
                             ncolors=lev.ncolors, sweeps=sweeps,
                             backward=backward, x0_zero=x0_zero)
    if cfg.smoother == "tsgs":
        return two_stage_gs(lev.A, lev.dinv, b, x, sweeps=sweeps,
                            inner=cfg.gs_inner, backward=backward,
                            x0_zero=x0_zero)
    if cfg.smoother == "chebyshev":
        lmax = lev.cheb_lmax
        return chebyshev(lev.A, lev.dinv, b, x, lmax / 30.0, lmax,
                         degree=cfg.cheb_degree, x0_zero=x0_zero)
    if cfg.smoother == "cheb4":
        return chebyshev4(lev.A, lev.dinv, b, x, lev.cheb_lmax,
                          degree=cfg.cheb_degree, x0_zero=x0_zero)
    raise ValueError(f"unknown smoother: {cfg.smoother}")


def _level(hier: "Hierarchy", cfg: AmgConfig, k: int, b):
    """One cycle at level k with zero initial guess; returns x ~ A_k^{-1} b."""
    lev = hier.levels[k]
    if k == hier.tail_start and hier.tail_op is not None:
        # dense coarse tail: the materialized sub-cycle in one matvec (a
        # bf16 operator widens to b's dtype, as the reference promotes)
        with phase("vcycle.coarse"):
            return hier.tail_op.to(b.dtype) @ b
    if k == len(hier.levels) - 1:
        with phase("vcycle.coarse"):
            return hier.coarse_inv.to(b.dtype) @ b
    with phase("vcycle.smooth", k):
        x = _smooth(lev, cfg, b, torch.zeros_like(b), backward=False,
                    x0_zero=True)
    with phase("vcycle.residual", k):
        r = b - apply_op(lev, x) if cfg.nu1 else b
    with phase("vcycle.restrict", k):
        if lev.Tgeo is not None:
            from raptor_tpu_torch.core.hybrid import geo_restrict

            rc = geo_restrict(lev.Tgeo, r)
        else:
            rc = apply_transfer(lev.Rband, lev.R, r)
    ec = _level(hier, cfg, k + 1, rc)
    if cfg.cycle == "W" and k + 1 < len(hier.levels) - 1:
        # second coarse visit on the updated coarse residual (gamma = 2)
        rc2 = rc - apply_op(hier.levels[k + 1], ec)
        ec = ec + _level(hier, cfg, k + 1, rc2)
    with phase("vcycle.prolong", k):
        if lev.Tgeo is not None:
            from raptor_tpu_torch.core.hybrid import geo_prolong

            x = x + geo_prolong(lev.Tgeo, ec)
        else:
            x = x + apply_transfer(lev.Pband, lev.P, ec)
    with phase("vcycle.smooth", k):
        return _smooth(lev, cfg, b, x, backward=True)


@spanned("vcycle")
def cycle(hier: "Hierarchy", b, cfg: AmgConfig | None = None):
    """One V- or W-cycle applied to b (zero initial guess): the AMG
    preconditioner application M^{-1} b."""
    return _level(hier, cfg or hier.config, 0, b)


def make_preconditioner(hier: "Hierarchy"):
    """Closure form used by the Krylov wrappers."""
    cfg = hier.config

    def M(r):
        return cycle(hier, r, cfg)

    return M


def _level_dense(lev: "Level", cfg: AmgConfig, Meff: torch.Tensor) -> torch.Tensor:
    """Dense matrix of one level's cycle body with the recursion replaced by
    the (already dense) coarse map ``Meff``: the body runs on the identity
    columns as (B, n) batches, B chosen so that a batch's (B, K, n) gather
    stays under the SpGEMM expand's element budget.  The caller strips the
    fast layouts first (the ELL path applies the same matrix to a
    batch)."""
    from raptor_tpu_torch.ops.sparse_ops import _EXPAND_ELEM_BUDGET

    n = lev.A.n_rows_pad
    width = max(E.K * max(E.n_rows_pad, E.n_cols_pad)
                for E in (lev.A, lev.P, lev.R))
    batch = max(1, _EXPAND_ELEM_BUDGET // width)
    eye = torch.eye(n, dtype=lev.dinv.dtype, device=lev.dinv.device)
    rows = []
    for lo in range(0, n, batch):
        c = eye[lo:lo + batch]
        x = _smooth(lev, cfg, c, torch.zeros_like(c), backward=False)
        r = c - apply_op(lev, x)
        rc = spmv(lev.R, r)
        ec = rc @ Meff.T  # row-wise Meff @ rc
        x = x + spmv(lev.P, ec)
        rows.append(_smooth(lev, cfg, c, x, backward=True))
    return torch.cat(rows).T


def _dense_ell(A) -> torch.Tensor:
    """Dense matrix of an ELL operator (for the W-cycle coarse revisit)."""
    eye = torch.eye(A.n_rows_pad, dtype=torch.float32, device=A.data.device)
    return spmv(A, eye).T


@spanned("setup.tail")
def materialize_tail(hier: "Hierarchy", max_n: int,
                     min_start: int = 1) -> "Hierarchy":
    """Fold the coarse tail of the cycle into one dense operator: every
    level below the first one (never the fine level) with padded size
    <= max_n (smoothers, transfers, recursion, coarse solve) collapses into
    ``tail_op``."""
    ts = next((i for i in range(min_start, len(hier.levels))
               if hier.levels[i].A.n_rows_pad <= max_n), None)
    if ts is None or ts >= len(hier.levels) - 1:
        return hier  # nothing to fold (coarsest is already one dense matvec)
    cfg = hier.config
    M = hier.coarse_inv.to(hier.levels[ts].dinv.dtype)
    for k in range(len(hier.levels) - 2, ts - 1, -1):
        if cfg.cycle == "W" and k + 1 < len(hier.levels) - 1:
            # ec = M rc + M (rc - A' M rc)  ->  Meff = 2M - M A' M
            Ad = _dense_ell(hier.levels[k + 1].A)
            Meff = 2.0 * M - M @ Ad @ M
        else:
            Meff = M
        lev = dataclasses.replace(hier.levels[k], Aband=None, Pband=None,
                                  Rband=None, Ahyb=None)
        M = _level_dense(lev, cfg, Meff)
    return dataclasses.replace(hier, tail_op=M, tail_start=ts)
