"""Aggressive (distance-2) coarsening and multipass interpolation (config 3).

Counterpart of ``raptor_tpu/setup/aggressive.py``.  The C points are a
maximal independent set of the squared strength graph (C points at graph
distance >= 3), from the PMIS engine on G^2 (SpGEMM).  Interpolation is
Stüben's multipass: F points next to a C point interpolate directly; the
rest interpolate through already-interpolated strong neighbours,

    w_i. = -( sum_{k usable} a_ik P_k. ) / ( a_ii + sum_{unusable} a_ik ),

one SpGEMM a pass, host-driven.  ``jacobi_refine_p`` refines the result
(hypre's jacobi_interp) and ``ell_truncate_p`` truncates it.  All eager
torch on the level's device.
"""

from __future__ import annotations

import dataclasses

import torch

from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.ops.sparse_ops import _slot_sum, ell_add, spgemm
from raptor_tpu_torch.setup.aggregation import _strength_ell
from raptor_tpu_torch.setup.splitting import F_PT, make_perm, pmis_splitting

__all__ = ["aggressive_splitting", "multipass_interpolation",
           "jacobi_refine_p", "ell_truncate_p"]


def _scale_rows(E: EllMatrix, s: torch.Tensor) -> EllMatrix:
    """diag(s) @ E; s has length n_rows_pad."""
    return dataclasses.replace(E, data=E.data * s[None, :])


def aggressive_splitting(A: EllMatrix, smask, seed: int) -> torch.Tensor:
    """Distance-2 PMIS: the MIS of G^2, G the strength pattern plus the
    diagonal."""
    G = _strength_ell(A, smask, with_diag=True)
    G2 = spgemm(G, G)
    g2_off = (G2.cols != G2.row_index()) & G2.slot_mask()
    perm = make_perm(A.shape[0], A.n_rows_pad, seed, device=A.data.device)
    return pmis_splitting(G2, g2_off, perm)


def multipass_interpolation(A: EllMatrix, smask, cf,
                            max_passes: int = 4) -> tuple[EllMatrix, int]:
    """P for a splitting where some F points have no strong C neighbour.
    Returns (P, nc).  Two host reads a pass (the rows left, the rows
    active)."""
    from raptor_tpu_torch.setup.interp import (direct_interpolation,
                                               tighten_coarse_space)

    P, nc_t = direct_interpolation(A, smask, cf)
    nc = int(nc_t)
    P = tighten_coarse_space(P, nc)
    dev = A.data.device
    is_real_f = (cf == F_PT) & (torch.arange(A.n_rows_pad, device=dev) < A.shape[0])
    off = (A.cols != A.row_index()) & A.slot_mask()
    row_sum = _slot_sum(torch.where(off, A.data, 0))
    diag = A.diagonal()
    for _ in range(max_passes):
        done = P.row_nnz > 0
        todo = is_real_f & ~done
        if not bool(todo.any()):
            break
        usable = smask & done[A.cols.long()]
        active = todo & usable.any(0)
        if not bool(active.any()):
            break
        # W: the usable couplings of the active rows; everything else goes
        # into the diagonal normalization
        wvals = torch.where(usable & active[None, :], A.data, 0)
        W = dataclasses.replace(A, data=wvals, row_nnz=torch.where(
            active, A.row_nnz, 0).to(torch.int32))
        dtil = diag + (row_sum - _slot_sum(wvals))
        dtil = torch.where(dtil != 0, dtil, 1.0)
        WP = spgemm(W, P)  # rows only at the active points
        scale = torch.where(active, -1.0 / dtil, 0.0).to(WP.dtype)
        P = ell_add(P, _scale_rows(WP, scale))
    return P, nc


def ell_truncate_p(P: EllMatrix, p_max: int) -> EllMatrix:
    """Interpolation truncation (hypre's P_max_elmts) on an ELL P: keep the
    ``p_max`` largest-|w| entries of each row (ties to the lower slot) and
    rescale the kept positive and negative parts separately, so both
    partial row sums are kept.  Drops explicit zeros and compacts the kept
    slots to the front: the returned width is min(p_max, K)."""
    K, n_pad = P.data.shape
    dev = P.data.device
    mask = P.slot_mask()
    pvals = torch.where(mask, P.data, 0)
    kp = min(p_max, K)
    absw = torch.where(mask, pvals.abs(), -1.0)
    keep = torch.zeros(K, n_pad, dtype=torch.bool, device=dev)
    slots = torch.arange(K, device=dev)[:, None]
    cur = absw
    for _ in range(kp):
        # the first slot of the row maximum, as jnp.argmax picks it
        m = cur.amax(0)
        arg = torch.where(cur == m[None, :], slots, K).amin(0)
        oh = slots == arg[None, :]
        keep = keep | (oh & (cur > 0))
        cur = torch.where(oh, -1.0, cur)
    pos = pvals > 0
    neg = mask & (pvals < 0)
    full_p = _slot_sum(torch.where(pos, pvals, 0))
    full_n = _slot_sum(torch.where(neg, pvals, 0))
    kept_p = _slot_sum(torch.where(keep & pos, pvals, 0))
    kept_n = _slot_sum(torch.where(keep & ~pos, pvals, 0))
    sc_p = torch.where(kept_p != 0, full_p / torch.where(kept_p != 0, kept_p, 1), 1)
    sc_n = torch.where(kept_n != 0, full_n / torch.where(kept_n != 0, kept_n, 1), 1)
    pvals = torch.where(keep, pvals * torch.where(pos, sc_p[None, :],
                                                  sc_n[None, :]), 0)
    sel = keep & (pvals != 0)
    slotpos = torch.cumsum(sel, 0) - 1
    posk = torch.where(sel, slotpos, kp)  # kp = the dump slot
    data = torch.zeros(kp + 1, n_pad, dtype=P.dtype, device=dev).scatter_(
        0, posk, pvals.to(P.dtype))[:kp]
    cols = torch.zeros(kp + 1, n_pad, dtype=torch.int32, device=dev).scatter_(
        0, posk, torch.where(sel, P.cols, 0).to(torch.int32))[:kp]
    return dataclasses.replace(P, data=data, cols=cols,
                               row_nnz=sel.sum(0, dtype=torch.int32))


def jacobi_refine_p(A: EllMatrix, P: EllMatrix, cf, omega: float,
                    passes: int, p_max: int) -> EllMatrix:
    """Jacobi interpolation refinement (hypre's jacobi_interp): ``passes``
    sweeps of

        P  <-  trunc_{p_max}( P - omega * D_FF^{-1} (A @ P) ).

    C rows have scale 0, so their identity rows pass through; the
    truncation drops the zero-valued union slots."""
    d = A.diagonal()
    dinv = 1.0 / torch.where(d != 0, d, 1.0)
    row_real = torch.arange(A.n_rows_pad, device=A.data.device) < A.shape[0]
    scale = torch.where((cf == F_PT) & row_real, -omega * dinv, 0.0)
    for _ in range(passes):
        U = _scale_rows(spgemm(A, P), scale.to(P.dtype))
        P = ell_truncate_p(ell_add(P, U), p_max)
    return P
