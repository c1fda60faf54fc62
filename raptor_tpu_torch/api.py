"""User-facing API of the algebraic engine: ``setup`` + ``solve``.

Counterpart of ``raptor_tpu/api.py``.  ``setup`` builds the hierarchy on
``device``: the levels above ``AmgConfig.host_setup_threshold`` with
tensors there, the smaller ones on the host in NumPy, the whole moved to
``device`` once at the end; ``solve`` runs PCG (or the df64-refined PCG)
on that device.  The reference runs a whole solve as
one jitted program with ``lax.while_loop``s; here the loops are Python,
with one host read per PCG iteration and one per refinement round.

With ``fine_layout='banded'`` the setup picks the ordering and the layouts
of ``core/hybrid.py`` from the input's structure.  A general matrix is
RCM-reordered once and every large level gets the banded layouts: its
operator applies run through K4, its transfers through K6, and the refined
solve's certified residual through K5.  A matrix whose entries already sit
on a few dense diagonals (plane mode: a grid operator in its natural
ordering, given with no grid information) keeps its ordering; when its
grid is detected the levels are geo-split (alternating semicoarsening,
transfers as ``GeoTransfer`` reshapes), the operator applies of plane-
structured levels run through K1 on DIA planes, and the certified residual
is the DIA-plane compensated residual.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig, SolveConfig
from raptor_tpu_torch.core.ell import EllMatrix, _np, ell_from_csr, pad_rows, pad_vector
from raptor_tpu_torch.setup.hierarchy import (
    Hierarchy,
    attach_residual_lo,
    build_hierarchy,
    cast_hierarchy_algebraic,
    hierarchy_stats,
)
from raptor_tpu_torch.solve.cycle import (apply_op, cycle, make_preconditioner,
                                          materialize_tail)
from raptor_tpu_torch.solve.krylov import (KrylovInfo, host_read,
                                           krylov_dispatch, pcg)
from raptor_tpu_torch.utils.df64 import df_add, df_from, two_prod
from raptor_tpu_torch.utils.profiling import phase, spanned

__all__ = ["setup", "solve", "solve_hier", "solve_hier_refined",
           "BANDED_MIN_N"]

_DTYPES = {"float32": np.float32, "float64": np.float64}

# levels below this stay on the scalar ELL path: with 1024-aligned level
# padding every level down to two kernel tiles takes the banded layout
BANDED_MIN_N = 2048
# the gather-chain df64 residual's slot groups: at most this many elements
# (256 MiB of fp32) in each of a group's temporaries
RESIDUAL_GROUP_ELEMS = 1 << 26


@spanned("setup.algebraic", fence=True)
def setup(A, config: AmgConfig = AmgConfig(), dtype=np.float32, B=None, *,
          device) -> Hierarchy:
    """Build the AMG hierarchy on ``device``: levels with n above
    ``config.host_setup_threshold`` on the device, the rest on the host,
    then the whole hierarchy moved to ``device``.

    ``B``: optional (n, nc) near-nullspace candidates for smoothed
    aggregation (rigid body modes for elasticity); the classical paths
    ignore it."""
    if config.splitting == "aggregation" or config.interp == "smoothed":
        from raptor_tpu_torch.setup.aggregation import build_sa_hierarchy

        hier = build_sa_hierarchy(A, config, dtype=dtype, B=B, device=device)
    elif config.fine_layout == "banded":
        hier = _setup_banded(A, config, dtype, device)
    else:
        hier = build_hierarchy(A, config, dtype=dtype, device=device)
    with phase("setup.to_device"):
        hier = hier.to(device)
    if config.tail_max_n > 0:
        hier = materialize_tail(hier, config.tail_max_n)
    if not isinstance(A, EllMatrix) and np.dtype(dtype) == np.float32:
        hier = attach_residual_lo(hier, A)
    return hier


def _plane_stats(deltas: np.ndarray, n: int, max_offsets: int = 32):
    """(coverage, efficiency) of laying entries with column-row offsets
    ``deltas`` as <= max_offsets dense diagonal planes: high on structured
    matrices in their given ordering, low after RCM or shuffling."""
    if deltas.size == 0:
        return 0.0, 0.0
    _, counts = np.unique(deltas, return_counts=True)
    top = np.sort(counts)[::-1][:max_offsets]
    return float(top.sum() / deltas.size), float(top.sum() / (len(top) * n))


def _plane_stats_ell(E, max_rows: int = 65536) -> tuple:
    """_plane_stats over an EllMatrix's real slots, rows strided down to
    <= max_rows."""
    n = E.shape[0]
    step = max(1, -(-n // max_rows))
    rows = np.arange(0, n, step)
    cols = _np(E.cols)[:, rows]
    nnz = _np(E.row_nnz)[rows]
    slot = np.arange(E.K)[:, None] < nnz[None, :]
    return _plane_stats((cols - rows[None, :])[slot], rows.size)


def _detect_grid(coo, n: int, iso_ratio: float = 8.0) -> "list | None":
    """Lexicographic grid extents [e0, e1, e2] (stride order) inferred from
    a matrix's nonzero offsets, or None.

    Accepts stencil patterns whose offsets lie in the {-1, 0, 1}-span of
    strides {1, a, b} (7/27-point 3D; {1, a} for 2D with e2 = 1), and whose
    mean |a_ij| over the candidate strides are within ``iso_ratio`` of each
    other: strongly anisotropic problems keep strength-driven PMIS."""
    deltas = coo.col.astype(np.int64) - coo.row
    pos = np.unique(deltas[deltas > 0])
    # a shuffled or unstructured matrix has up to n distinct offsets
    if pos.size == 0 or pos.size > 32 or pos[0] != 1:
        return None
    cands = [int(d) for d in pos if d > 1 and n % int(d) == 0]

    def mean_mag(s):
        m = np.abs(deltas) == s
        return float(np.abs(coo.data[m]).mean()) if m.any() else 0.0

    def iso_ok(strides):
        mags = [mean_mag(s) for s in strides]
        return min(mags) > 0 and max(mags) / min(mags) <= iso_ratio

    for a in cands:
        for b in [c for c in cands if c > a and c % a == 0]:
            span = {i + j * a + k * b
                    for i in (-1, 0, 1) for j in (-1, 0, 1)
                    for k in (-1, 0, 1)}
            if all(int(d) in span for d in pos) and iso_ok((1, a, b)):
                return [a, b // a, n // b]
    for a in cands:  # 2D
        span = {i + j * a for i in (-1, 0, 1) for j in (-1, 0, 1)}
        if all(int(d) in span for d in pos) and iso_ok((1, a)):
            return [a, n // a, 1]
    return None


def _setup_banded(A, config: AmgConfig, dtype, device) -> Hierarchy:
    """fine_layout='banded': choose the ordering and each level's layout
    from the input's structure, build the hierarchy in that one ordering
    with 1024-aligned padding, and attach the layouts to every large level.
    P/R and all vectors share the ordering; only the operator and transfer
    applies change per level.

    Plane mode (the entries sit on a few dense diagonals): keep the given
    ordering, geo-split when the grid is detected, and lay every
    plane-structured level as DIA planes (``HybridMatrix``).  Otherwise RCM
    the input once and attach the banded layouts.  Levels above the host
    threshold are built on ``device``; the layouts are planned on the
    host from every level's arrays (``_np``), and a device geo level
    arrives with its planes and ``GeoTransfer`` from the chain."""
    import scipy.sparse as sp

    if isinstance(A, EllMatrix):
        raise ValueError("fine_layout='banded' takes scipy input")
    with phase("setup.order"):
        a = sp.csr_matrix(A)
        n = a.shape[0]
        coo = a.tocoo()
        cov0, eff0 = _plane_stats(coo.col.astype(np.int64) - coo.row, n)
        plane_mode = cov0 >= 0.9 and eff0 >= 0.5
        if plane_mode:
            # RCM would destroy the constant offsets
            p = np.arange(n, dtype=np.int64)
        else:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            p = np.asarray(reverse_cuthill_mckee(
                a + a.T, symmetric_mode=True)).astype(np.int64)
        ar = a[p][:, p].tocsr()

    pm_mult = int(np.lcm(config.pad_multiple, 1024))
    with phase("setup.ell"):
        E = ell_from_csr(ar, dtype=dtype, row_pad_multiple=pm_mult)
    cfg = dataclasses.replace(config, pad_multiple=pm_mult)
    # geo levels carry no coloring (mcgs), and aggressive coarsening keeps
    # its own pipeline
    geo = (_detect_grid(coo, n)
           if (plane_mode and config.geo_split and not config.aggressive
               and config.smoother != "mcgs") else None)
    # row_ids=p: PMIS weights key on original row ids, so the C/F sets (and
    # the Krylov iteration counts) equal those of the unpermuted build
    hier = build_hierarchy(E, cfg, dtype=dtype, row_ids=p, geo=geo,
                           device=device)

    with phase("setup.layout"):
        levels = [_attach_layouts(lev, lev is hier.levels[0], plane_mode)
                  for lev in hier.levels]

    n_pad = hier.levels[0].A.n_rows_pad
    perm = np.arange(n_pad, dtype=np.int32)
    perm[:n] = p
    iperm = np.arange(n_pad, dtype=np.int32)
    iperm[:n][p] = np.arange(n)
    return dataclasses.replace(hier, levels=tuple(levels), perm=perm,
                               iperm=iperm)


def _attach_layouts(lev, fine: bool, plane_mode: bool):
    """A level of ``_setup_banded`` with its fast layouts attached: DIA
    planes in plane mode where they cover the operator, else the banded
    layout, and the transfers' rectangular banded layouts beside either."""
    from raptor_tpu_torch.core.hybrid import (banded_from_ell, hybrid_from_ell,
                                              rect_banded_from_ell)

    if lev.n < BANDED_MIN_N or lev.A.n_rows_pad % 1024 != 0:
        return lev
    attached = lev.Ahyb is not None
    if not attached and plane_mode:
        # Galerkin products of plane-structured operators stay
        # plane-structured (offsets at doubled spacings)
        cov, eff = _plane_stats_ell(lev.A)
        if cov >= 0.9 and eff >= 0.5:
            H = hybrid_from_ell(lev.A, reorder=False, max_offsets=32,
                                pad_multiple=lev.A.n_rows_pad)
            if H.n_pad == lev.A.n_rows_pad:
                lev = dataclasses.replace(lev, Ahyb=H)
                attached = True
    if not attached:
        # reorder=True below level 0: coarse levels inherit the fine
        # ordering compressed through the irregular PMIS C-set; an RCM
        # re-banding of just that level can re-enter the plan bounds
        B = banded_from_ell(lev.A, reorder=not fine)
        if B is not None and B.n_pad == lev.A.n_rows_pad:
            lev = dataclasses.replace(lev, Aband=B)
            attached = True
    if attached and lev.P is not None and lev.Tgeo is None:
        # transfers follow the same grid-proportional band; a geo level's
        # GeoTransfer needs no plan
        Pb = rect_banded_from_ell(lev.P, pad_rows(lev.P.n_cols_pad, 1024))
        Rb = rect_banded_from_ell(lev.R, pad_rows(lev.R.n_cols_pad, 1024))
        lev = dataclasses.replace(lev, Pband=Pb, Rband=Rb)
    return lev


@spanned("solve")
def solve_hier_refined(
    hier: Hierarchy,
    b: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 100,
    outer: int = 8,
    b_lo: torch.Tensor | None = None,
    krylov: str = "cg",
    M_hier: Hierarchy | None = None,
    restart: int = 30,
):
    """Solve to a true <= tol relative residual on the hierarchy's device:
    fp32 AMG-PCG inner solves inside compensated double-float32 iterative
    refinement (utils/df64.py), no fp64.  Returns ((x_hi, x_lo),
    true_relres, iters).

    ``M_hier``: optional separate preconditioner hierarchy (a bf16
    ``cast_hierarchy_algebraic`` copy); the Krylov operator, residuals and
    the df64 certification stay on ``hier``.  ``restart`` is the GMRES
    restart length.  The outer loop reads the residual norm on the host once
    per round, and the round's iterations after it
    (``host_reads["refine"]``)."""
    A = hier.levels[0].A
    lev0 = hier.levels[0]
    Mh = hier if M_hier is None else M_hier

    def apply_A(v):
        return apply_op(lev0, v)

    def apply_M(r):
        return cycle(Mh, r).to(r.dtype)

    lo = hier.a0_lo
    band = lev0.Aband
    # K5 when the band has no far block (it would drop the out-of-window
    # entries from the certified residual); else the exact gather chain
    use_band_resid = band is not None and band.far is None and (
        lo is None or hier.a0_lo_band is not None)
    # DIA-plane compensated residual: no gathers.  lo must be None (the
    # fp32 remainder lives in the ELL slot layout), as it is for every
    # fp32-exact grid stencil
    hyb = lev0.Ahyb
    use_hyb_resid = (not use_band_resid and hyb is not None
                     and hyb.spill is None and lo is None)

    @spanned("refine.residual")
    def residual(xh, xl, bh, bl):
        # A @ x_lo needs only fp32 accuracy (x_lo ~ 2^-24 x_hi): one
        # fast-layout apply
        v = apply_A(xl)
        if use_band_resid:
            from raptor_tpu_torch.core.hybrid import banded_df64_residual

            return banded_df64_residual(band, hier.a0_lo_band, xh, bh, bl, v)
        if use_hyb_resid:
            from raptor_tpu_torch.core.hybrid import hybrid_df64_residual

            return hybrid_df64_residual(hyb, xh, bh, bl, v)
        return _gather_df64_residual(A, lo, xh, bh, bl, v)

    bh, bl = (b, b_lo) if b_lo is not None else df_from(b)
    bnorm = torch.sqrt(torch.dot(b, b))
    bnorm = torch.where(bnorm > 0, bnorm, torch.ones_like(bnorm))
    xh = torch.zeros_like(b)
    xl = torch.zeros_like(b)
    inner = krylov_dispatch(krylov, restart)

    # x0 == 0: the initial residual is b exactly
    rh, rl = bh, bl
    relres = torch.sqrt(torch.dot(rh, rh)) / bnorm
    total_it, k = 0, 0
    # residual-gated: stop as soon as a round certifies tol
    while k < outer and host_read("refine", relres > tol):
        inner_tol = torch.clamp(tol / torch.clamp(relres, min=1e-30), 1e-5, 0.9)
        e, info = inner(apply_A, rh, apply_M, tol=inner_tol, maxiter=maxiter)
        xh, xl = df_add(xh, xl, e, torch.zeros_like(e))
        rh, rl = residual(xh, xl, bh, bl)
        relres = torch.sqrt(torch.dot(rh, rh)) / bnorm
        total_it += host_read("refine", info.iterations)
        k += 1
    iters = torch.tensor(total_it, dtype=torch.int32, device=b.device)
    return (xh, xl), relres, iters


def _gather_df64_residual(A: EllMatrix, lo, xh, bh, bl, v):
    """(bh, bl) - A (xh + x_lo) as a df64 pair by ELL gathers, given v =
    A @ x_lo in fp32: each slot's exact product a_k * xh (plus lo_k * xh,
    the fp32 remainder of the operator, when ``lo`` is given) is added in
    compensated arithmetic, slot by slot in slot order.  The slots'
    products are independent, so a group of slots is gathered and
    multiplied at once (elementwise: bit for bit the slot-by-slot ops)."""
    rh, rl = df_add(bh, bl, -v, torch.zeros_like(v))
    group = max(1, RESIDUAL_GROUP_ELEMS // A.n_rows_pad)
    for k0 in range(0, A.K, group):
        gh = xh[A.cols[k0:k0 + group]]
        ph, pe = two_prod(A.data[k0:k0 + group], gh)
        if lo is not None:
            # a0_lo * x_hi: certify against the unrounded operator
            pe = pe + lo[k0:k0 + group] * gh
        ph, pe = -ph, -pe
        for k in range(ph.shape[0]):
            rh, rl = df_add(rh, rl, ph[k], pe[k])
    return rh, rl


def solve_hier(
    hier: Hierarchy,
    b: torch.Tensor,
    tol: float = 1e-8,
    maxiter: int = 200,
    krylov: str = "cg",
    precondition: bool = True,
    x0: torch.Tensor | None = None,
    restart: int = 30,
):
    """Solve given a built hierarchy and a padded rhs on its device:
    'cg' (PCG), 'bicgstab', 'gmres', 'fgmres' (restarted every ``restart``
    steps), or 'none' (the stationary AMG iteration)."""
    lev0 = hier.levels[0]

    def apply_A(x):
        return apply_op(lev0, x)

    apply_M = make_preconditioner(hier) if precondition else (lambda r: r)
    if krylov != "none":
        return krylov_dispatch(krylov, restart)(apply_A, b, apply_M, tol=tol,
                                                maxiter=maxiter, x0=x0)
    # stationary AMG iteration, one host read per iteration
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x)
    floor = 1e-300 if b.dtype == torch.float64 else 1e-30
    bnorm2 = torch.clamp(torch.dot(b, b), min=floor)
    tol2 = tol * tol * bnorm2
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[0] = torch.sqrt(torch.dot(r, r) / bnorm2)
    it, status = 0, 1
    while it < maxiter:
        x = x + apply_M(r)
        r = b - apply_A(x)
        rr = torch.dot(r, r)
        it += 1
        hist[it] = torch.sqrt(rr / bnorm2)
        if host_read("stationary", rr <= tol2):
            status = 0
            break
    return x, KrylovInfo(
        iterations=torch.tensor(it, dtype=torch.int32, device=b.device),
        status=torch.tensor(status, dtype=torch.int32, device=b.device),
        relres=torch.sqrt(torch.dot(r, r) / bnorm2), res_hist=hist)


def solve(
    A,
    b,
    config: AmgConfig = AmgConfig(),
    solve_config: SolveConfig = SolveConfig(),
    hier: Hierarchy | None = None,
    *,
    device=None,
):
    """One-call AMG-preconditioned solve from host data.

    Returns (x host array of logical length, info dict).  With
    ``hier`` the solve runs on its device; without, ``setup`` builds one on
    ``device``.  ``solve_config.refine`` wraps the solve in iterative
    refinement: on the device with df64 residuals (``refine_device``) or
    on the host in fp64."""
    import scipy.sparse as sp

    dtype = _DTYPES[solve_config.dtype]
    A_sp = sp.csr_matrix(A) if not isinstance(A, EllMatrix) else None
    if hier is None:
        if device is None:
            raise ValueError("solve without a hierarchy needs a device")
        hier = setup(A_sp if A_sp is not None else A, config, dtype=dtype,
                     device=device)
    dev = hier.device
    A0 = hier.levels[0].A
    n = A0.shape[0]
    b = np.asarray(b, dtype=np.float64)
    pm = None
    if hier.perm is not None:
        # the hierarchy lives in the RCM ordering: permute the rhs in, the
        # solution back out (and the host residual matrix too)
        pm = _np(hier.perm)[:n]
        b = b[pm]
        if A_sp is not None:
            A_sp = A_sp[pm][:, pm].tocsr()

    if not solve_config.refine:
        bd = pad_vector(b.astype(dtype), A0.n_rows_pad, device=dev)
        x, info = solve_hier(hier, bd, tol=solve_config.tol,
                             maxiter=solve_config.maxiter,
                             krylov=solve_config.krylov,
                             restart=solve_config.gmres_restart)
        return _finish(x, info, n, hier, pm)

    if solve_config.refine_device and solve_config.krylov in (
            "cg", "bicgstab", "gmres", "fgmres"):
        # b enters as an exact df64 pair, so fp64 inputs are certified
        # against the unrounded right-hand side
        b_hi = b.astype(np.float32)
        b_lo = (b - b_hi.astype(np.float64)).astype(np.float32)
        bd = pad_vector(b_hi, A0.n_rows_pad, device=dev)
        bdl = pad_vector(b_lo, A0.n_rows_pad, device=dev)
        M_hier = None
        if config.operator_store_dtype != "same":
            M_hier = cast_hierarchy_algebraic(
                hier, getattr(torch, config.operator_store_dtype))
        (xh, xl), relres, iters = solve_hier_refined(
            hier, bd, tol=solve_config.tol, maxiter=solve_config.maxiter,
            b_lo=bdl, krylov=solve_config.krylov, M_hier=M_hier,
            restart=solve_config.gmres_restart)
        x64 = (xh[:n].double().cpu().numpy() + xl[:n].double().cpu().numpy())
        return _deperm(x64, pm), {
            "iterations": int(iters),
            "relres": float(relres),
            "status": 0,
            "stats": hierarchy_stats(hier),
        }

    # fp64-outer iterative refinement around the fp32 device solve (host)
    if A_sp is None:
        raise ValueError("host refinement needs the scipy matrix for fp64 "
                         "residuals")
    x64 = np.zeros(n, dtype=np.float64)
    bnorm = np.linalg.norm(b)
    total_it = 0
    info = None
    for _ in range(max(1, solve_config.refine_steps)):
        r = b - A_sp @ x64
        relres = np.linalg.norm(r) / bnorm
        if relres < solve_config.tol:
            break
        rd = pad_vector(r.astype(dtype), A0.n_rows_pad, device=dev)
        # inner solve to a tolerance fp32 can actually certify
        inner_tol = max(solve_config.tol / max(relres, 1e-300), 1e-5)
        e, info = solve_hier(hier, rd, tol=inner_tol,
                             maxiter=solve_config.maxiter,
                             krylov=solve_config.krylov,
                             restart=solve_config.gmres_restart)
        total_it += int(info.iterations)
        x64 = x64 + e[:n].double().cpu().numpy()
    r = b - A_sp @ x64
    out_info = {
        "iterations": total_it,
        "relres": float(np.linalg.norm(r) / bnorm),
        "status": int(info.status) if info is not None else 0,
        "stats": hierarchy_stats(hier),
    }
    return _deperm(x64, pm), out_info


def _deperm(x, pm):
    """Map a solution from the hierarchy's (RCM) ordering back to the
    caller's ordering; identity when pm is None."""
    if pm is None:
        return x
    out = np.empty_like(x)
    out[pm] = x
    return out


def _finish(x, info, n, hier, pm=None):
    out_info = {
        "iterations": int(info.iterations),
        "relres": float(info.relres),
        "status": int(info.status),
        "res_hist": info.res_hist.cpu().numpy(),
        "stats": hierarchy_stats(hier),
    }
    return _deperm(x[:n].cpu().numpy(), pm), out_info
