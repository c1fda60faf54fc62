"""The algebraic sharded solve: a host-built hierarchy sharded over a
``Ring``, and the sharded AMG-Krylov solve.

Counterpart of ``raptor_tpu/parallel/dist.py`` (RAPtor's MPI-distributed
solve).  One process per rank holds its own blocks:

* the fine levels are row-sharded; every SpMV (operator, restriction,
  prolongation) is a halo exchange and a local ELL SpMV
  (``parallel/halo.py``), or, on a level whose banded layout shards by
  whole kernel tiles, the banded kernel on the rank's tile block: K4 in its
  halo form for A (``dist_banded_spmv``), K6 in its map_cols form for P
  and R (``dist_rect_banded_spmv``);
* the coarse levels below ``tail_size`` are agglomerated: every rank holds
  them whole and runs the single-device cycle.  The bridge is one
  all-gather of the last sharded residual and a slice of the correction;
* the Krylov loop's only global reductions are its dot products, each one
  sum over the ring.

A banded apply of a block on the card launches its kernel (K4's halo
form, K6's map_cols form) or raises; of a block elsewhere it runs the
kernel's plain version.  A level takes the ELL route only where
``_shardable_band`` or ``_shardable_rect`` refuse its layout, as in the
reference, and one more case: a ``reordered`` banded layout (a coarse
level that RCM re-banded) lives in another ordering than the level's
vectors, which the reference's sharded apply does not undo; here such a
level stays on the ELL route.

``distribute_hierarchy`` takes the whole hierarchy on every rank and keeps
the rank's blocks on the hierarchy's device; a level's multicolor colours
and block-diagonal inverses shard with its rows.  The sharded smoothers
are the single-device ones on the rank's block, with two differences of
the reference's design: the two-stage Gauss-Seidel's inner triangular
series is processor-local (halo columns are masked out of the triangle
and couple only through the outer residual), and the block smoothers
apply A through the level's sharded SpMV (the block layout does not
shard).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.ops.banded_plan import PAGE
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.sparse_ops import spmv
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.parallel.halo import dist_spmv, psum_dot
from raptor_tpu_torch.parallel.partition import DistMatrix, HaloPlan, distribute_matrix
from raptor_tpu_torch.setup.hierarchy import Hierarchy
from raptor_tpu_torch.solve.cycle import _level as _tail_cycle
from raptor_tpu_torch.solve.cycle import materialize_tail
from raptor_tpu_torch.solve.krylov import krylov_dispatch
from raptor_tpu_torch.solve.smoothers import triangular_apply

__all__ = [
    "DistLevel",
    "DistHierarchy",
    "CommCtx",
    "comm_report",
    "dist_banded_spmv",
    "dist_rect_banded_spmv",
    "distribute_hierarchy",
    "dist_solve",
    "make_solve_mesh",
]

@dataclasses.dataclass(frozen=True)
class DistLevel:
    """One sharded level: this rank's blocks."""

    A: DistMatrix
    dinv: Any  # (n_local,)
    Pmat: Optional[DistMatrix]  # None on the bridge level
    Rmat: Optional[DistMatrix]
    cheb_lmax: Any  # the same scalar on every rank
    n_local: int
    n: int  # the global level's logical size
    # banded layouts (core/hybrid.py) whose tile grid shards: vals and pidx
    # hold this rank's tiles, meta stays the global plan's (page and index
    # metadata are tile-relative); None where the level takes the ELL route
    Aband: Optional[Any] = None
    Pband: Optional[Any] = None
    Rband: Optional[Any] = None
    # multicolor GS colours of the rank's rows, and the number of colours
    color: Optional[Any] = None
    ncolors: int = 1
    # the inverses of the rank's diagonal blocks (n_local // b, b, b), where
    # the block rows shard with the dof rows
    binv: Optional[Any] = None


@dataclasses.dataclass(frozen=True)
class DistHierarchy:
    levels: Tuple[DistLevel, ...]  # sharded levels, finest first
    bridge_P: EllMatrix  # every rank: the last sharded level's transfers
    bridge_R: EllMatrix
    tail: Hierarchy  # every rank: the agglomerated coarse hierarchy
    config: AmgConfig
    ndev: int


def make_solve_mesh(ndev: Optional[int] = None) -> Ring:
    """The ring over every rank of the default process group (the
    reference's one-axis mesh); ``ndev``, when given, must be its size."""
    ring = Ring()
    if ndev is not None and ndev != ring.axis_size:
        raise ValueError(f"{ndev} ranks asked, the process group has "
                         f"{ring.axis_size}")
    return ring


# ---------------------------------------------------------------------------
# Distribution of a hierarchy
# ---------------------------------------------------------------------------

def _rows(v, ring: Ring, nl: int):
    me = ring.axis_index
    return v[..., me * nl:(me + 1) * nl].contiguous()


def _tile_block(B, ring: Ring):
    """A banded layout's tiles of this rank (the leading T axis of vals and
    pidx, and the matching rows of a square layout's perms)."""
    if B is None:
        return None
    t_loc = B.vals.shape[0] // ring.axis_size
    me = ring.axis_index
    tiles = slice(me * t_loc, (me + 1) * t_loc)
    out = dataclasses.replace(B, vals=B.vals[tiles].contiguous(),
                              pidx=B.pidx[tiles].contiguous())
    if hasattr(B, "perm"):
        nl = t_loc * B.vals.shape[2] * B.vals.shape[3]
        out = dataclasses.replace(out, perm=_rows(B.perm, ring, nl),
                                  iperm=_rows(B.iperm, ring, nl))
    return out


def distribute_hierarchy(hier: Hierarchy, ring: Ring,
                         tail_size: int = 4096) -> DistHierarchy:
    """This rank's share of a hierarchy built with
    ``AmgConfig(pad_multiple=8 * ring.axis_size)`` (or a multiple): the
    blocks of the levels above ``tail_size`` rows, the whole of the levels
    below (at least one level is sharded and at least one stays in the
    tail).  The result lies on the hierarchy's device."""
    ndev = ring.axis_size
    nlev = len(hier.levels)
    t = 1
    while t < nlev - 1 and hier.levels[t].n > tail_size:
        t += 1
    # levels [0, t) sharded; [t, nlev) replicated tail
    dlevels = []
    for k in range(t):
        lev = hier.levels[k]
        nl = lev.A.n_rows_pad // ndev
        A_d = distribute_matrix(lev.A, ring)
        Pb = Rb = None
        if k + 1 < t:
            nc_pad = hier.levels[k + 1].A.n_rows_pad
            nf_pad = lev.A.n_rows_pad
            R_d = distribute_matrix(lev.R, ring, n_col_owned=nf_pad // ndev)
            P_d = distribute_matrix(lev.P, ring, n_col_owned=nc_pad // ndev)
            # rect-banded transfers when both level vectors shard evenly
            Rb = _shardable_rect(lev.Rband, ndev, nc_pad, nf_pad)
            Pb = _shardable_rect(lev.Pband, ndev, nf_pad, nc_pad)
        else:
            R_d = P_d = None
        binv = None
        if (lev.binv is not None and lev.binv.shape[0] % ndev == 0
                and nl % lev.binv.shape[-1] == 0):
            nb = lev.binv.shape[0] // ndev  # block rows shard with the rows
            me = ring.axis_index
            binv = lev.binv[me * nb:(me + 1) * nb].contiguous()
        dlevels.append(DistLevel(
            A=A_d, dinv=_rows(lev.dinv, ring, nl), Pmat=P_d, Rmat=R_d,
            cheb_lmax=lev.cheb_lmax, n_local=nl, n=lev.n,
            Aband=_tile_block(_shardable_band(lev.Aband, ndev), ring),
            Pband=_tile_block(Pb, ring), Rband=_tile_block(Rb, ring),
            color=None if lev.color is None else _rows(lev.color, ring, nl),
            ncolors=lev.ncolors, binv=binv))
    bridge = hier.levels[t - 1]
    tail = Hierarchy(levels=hier.levels[t:], coarse_inv=hier.coarse_inv,
                     config=hier.config)
    if hier.config.tail_max_n > 0:
        # the whole replicated tail cycle as one dense matvec (min_start=0:
        # the tail is already coarse at its level 0)
        tail = materialize_tail(tail, hier.config.tail_max_n, min_start=0)
    return DistHierarchy(levels=tuple(dlevels), bridge_P=bridge.P,
                         bridge_R=bridge.R, tail=tail, config=hier.config,
                         ndev=ndev)


def _shardable_band(B, ndev: int):
    """The level's BandedMatrix, if its tile grid splits evenly over the
    ranks: each rank must own whole (T // ndev) kernel tiles and the
    kh-tile halo must fit inside one neighbour's block.  Page/idx metadata
    are tile-relative, so a rank's slice of the leading T axis IS its plan.
    A near/far split layout is refused (the far block's rows and columns
    cross rank boundaries), and so is a ``reordered`` one: its ordering is
    not the level's, and the sharded apply has no permutation."""
    if B is None or B.far is not None or B.reordered:
        return None
    K, n, tile, kh, npage, Wp = B.meta
    T = n // tile
    if T % ndev == 0 and T // ndev >= kh:
        return B
    return None


def _shardable_rect(B, ndev: int, n_rows_pad: int, n_cols_pad: int):
    """The level's RectBanded transfer, if both its row tiles and its
    column space split evenly over the ranks and the proportional window's
    page halos stay short of the whole ring.  Requires the plan's spaces to
    coincide exactly with the sharded vectors' padded sizes."""
    if B is None or B.far is not None:
        return None  # see _shardable_band: split layouts stay unsharded
    K, n, n_cols, tile, WpP, npage = B.meta
    T = n // tile
    if n != n_rows_pad or n_cols != n_cols_pad:
        return None
    if T % ndev or n_cols % (ndev * PAGE):
        return None
    p_loc = n_cols // ndev // PAGE
    # ring halos may span several neighbours (_ring_halo) but not the whole
    # ring (beyond that the window wraps into this rank's own block)
    if max(WpP, npage - WpP) > (ndev - 1) * p_loc:
        return None
    return B


# ---------------------------------------------------------------------------
# Sharded banded SpMVs.  The global plan's page/idx are relative to each
# output tile's own x window, so the sharded call is the single-device
# kernel on the rank's tiles with the zero pad replaced by ring halos.
# Wrap-around halos at the global edges are read only by zero-value slots:
# no real entry references x outside [0, n).
#
# The halos and the rank's block go to the kernel as one buffer
# (torch.cat, as the reference concatenates): the copy moves 8 bytes a row
# against the plan's 8 bytes a slot and row, and the kernels keep one x
# pointer and the bounds they already test.
# ---------------------------------------------------------------------------

def dist_banded_spmv(B, x_own: torch.Tensor, ring: Ring) -> torch.Tensor:
    """y_own = (A @ x)_own through K4's halo form on this rank's tiles."""
    K, _, tile, kh, npage, Wp = B.meta
    halo = kh * tile
    # left halo = the left neighbour's tail (every rank sends to its right);
    # right halo = the right neighbour's head
    left = ring.shift_right(x_own[-halo:])
    right = ring.shift_left(x_own[:halo])
    x_pad = torch.cat([left, x_own, right])
    apply = bk.banded_spmv_halo if B.vals.is_cuda else bk.banded_spmv_halo_ref
    return apply(dict(B.plan(), n=B.vals.shape[0] * tile), x_pad)


def _ring_halo(x_own: torch.Tensor, h: int, ring: Ring, left: bool) -> torch.Tensor:
    """The h elements of the global vector adjacent to this rank's block
    (on its left or right), assembled from as many ring neighbours as the
    span covers: hop j shifts a slice of every rank's block j positions
    around the ring; blocks wrap at the global edges (wrapped values are
    only ever read by zero-value plan slots, like the clamp they
    replace)."""
    block = x_own.shape[0]
    q = -(-h // block)  # neighbours touched
    parts = []
    for j in range(q, 0, -1):
        take = min(h - (j - 1) * block, block)  # partial for the farthest hop
        src = x_own[-take:] if left else x_own[:take]
        parts.append(ring.shift(src, j if left else -j))
    if not left:
        parts.reverse()  # the farthest hop goes last on the right side
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def dist_rect_banded_spmv(B, x_own: torch.Tensor, ring: Ring) -> torch.Tensor:
    """Sharded transfer apply (P or R) through K6's map_cols form on this
    rank's tiles.  The window base is proportional (tile t of T reads
    around t * n_cols / T), so with the column space sharded in equal
    page-aligned blocks each rank needs WpP pages from its left and
    npage - WpP from its right; WpP folds into the buffer's offset, so the
    local call takes WpP = 0 with the local ratio as the index map."""
    K, _, _, tile, WpP, npage = B.meta
    cols_loc = x_own.shape[0]
    lh = WpP * PAGE
    rh = (npage - WpP) * PAGE
    parts = [x_own]
    if lh:
        parts.insert(0, _ring_halo(x_own, lh, ring, left=True))
    if rh:
        parts.append(_ring_halo(x_own, rh, ring, left=False))
    x_buf = torch.cat(parts) if len(parts) > 1 else x_own
    plan = dict(B.plan(), n=B.vals.shape[0] * tile, n_cols=x_buf.shape[0],
                WpP=0)
    apply = bk.banded_spmv_rect if B.vals.is_cuda else bk.banded_spmv_rect_ref
    return apply(plan, x_buf, map_cols=cols_loc)


# ---------------------------------------------------------------------------
# Sharded smoothers, cycle and solve
# ---------------------------------------------------------------------------

class CommCtx:
    """The communication of the sharded cycle: the flat ring exchange and
    the TAPS two-level exchange (``parallel/dist_taps.py``) share the
    cycle and smoother code through this seam.

    ``sp(slot, DistMatrix, x_own) -> y_own`` applies an operator through
    the exchange, slot ("A" | "P" | "R", level); ``ring`` holds every rank
    in order (the sums and the bridge's all-gather); ``banded``: the
    sharded banded kernels apply (the flat ring only; the TAPS exchange
    stays on its own plans)."""

    def __init__(self, sp: Callable, ring: Ring, banded: bool):
        self.sp = sp
        self.ring = ring
        self.banded = banded

    @staticmethod
    def flat(ring: Ring) -> "CommCtx":
        return CommCtx(sp=lambda slot, dm, x: dist_spmv(dm, x, ring),
                       ring=ring, banded=True)


def _dist_smooth(lev: DistLevel, cfg: AmgConfig, b, x, backward: bool, sp,
                 x0_zero: bool = False):
    """``x0_zero`` asserts x == 0 on entry: the first residual is exactly
    ``b``, which saves one sharded SpMV, its halo exchange included, per
    level and cycle."""
    sweeps = cfg.nu2 if backward else cfg.nu1
    smoother = cfg.smoother
    if sweeps == 0:
        return x
    first = [x0_zero]  # consumed by the FIRST residual below

    def res(x):
        if first[0]:
            first[0] = False
            return b
        return b - sp(x)

    if smoother == "jacobi":
        for _ in range(sweeps):
            x = x + cfg.omega * lev.dinv * res(x)
        return x
    if smoother == "mcgs":
        order = list(range(lev.ncolors))
        if backward:
            order.reverse()
        for _ in range(sweeps):
            for c in order:
                x = x + torch.where(lev.color == c, lev.dinv * res(x), 0)
        return x
    if smoother == "tsgs":
        # hybrid two-stage GS: the inner Jacobi series runs on the
        # processor-local strict triangle (halo columns masked out), so the
        # inner iterations exchange nothing
        Aloc = lev.A.local_ell()
        nloc = Aloc.n_rows_pad

        def tri(z):
            z_ext = torch.cat([z, z.new_zeros(Aloc.n_cols_pad - nloc)])
            return triangular_apply(Aloc, z_ext, upper=backward,
                                    col_bound=nloc)

        for _ in range(sweeps):
            r = res(x)
            z = lev.dinv * r
            for _j in range(cfg.gs_inner):
                z = lev.dinv * (r - tri(z))
            x = x + z
        return x
    if smoother == "chebyshev":
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
    if smoother in ("cheb4", "block_cheb", "block_jacobi"):
        # the block-diagonal preconditioner is row-local (binv shards with
        # the rows); a level without a block layout takes the scalar
        # diagonal, as solve/cycle._smooth does
        if lev.binv is not None:
            bs = lev.binv.shape[-1]

            def prec(r):
                rb = r.reshape(-1, bs)
                return torch.einsum("nij,nj->ni", lev.binv, rb).reshape(-1)
        else:
            def prec(r):
                return lev.dinv * r

        if smoother == "block_jacobi":
            for _ in range(sweeps):
                x = x + cfg.omega * prec(res(x))
            return x
        # 4th-kind Chebyshev on the (block-)normalized spectrum
        r = res(x)
        d = (4.0 / 3.0) / lev.cheb_lmax * prec(r)
        x = x + d
        for k in range(2, cfg.cheb_degree + 1):
            r = r - sp(d)
            d = ((2 * k - 3) / (2 * k + 1)) * d + (
                (8 * k - 4) / (2 * k + 1) / lev.cheb_lmax
            ) * prec(r)
            x = x + d
        return x
    raise ValueError(f"unknown smoother: {smoother}")


def _apply_dist_A(dh: DistHierarchy, k: int, v, ctx: CommCtx):
    """Sharded operator apply at level k: K4's halo form when the level
    carries a shardable banded layout (flat ring only), else the gather ELL
    halo SpMV through the CommCtx seam."""
    lev = dh.levels[k]
    if lev.Aband is not None and ctx.banded:
        return dist_banded_spmv(lev.Aband, v, ctx.ring)
    return ctx.sp(("A", k), lev.A, v)


def _dist_level_solve(dh: DistHierarchy, k: int, b, ctx: CommCtx):
    """Sharded V- or W-cycle at sharded level k (b is the owned block)."""
    cfg = dh.config
    lev = dh.levels[k]
    spA = lambda v: _apply_dist_A(dh, k, v, ctx)  # noqa: E731
    x = _dist_smooth(lev, cfg, b, torch.zeros_like(b), backward=False, sp=spA,
                     x0_zero=True)
    r = b - spA(x) if cfg.nu1 else b
    if k + 1 < len(dh.levels):
        banded_txf = lev.Rband is not None and ctx.banded
        rc = (dist_rect_banded_spmv(lev.Rband, r, ctx.ring) if banded_txf
              else ctx.sp(("R", k), lev.Rmat, r))
        ec = _dist_level_solve(dh, k + 1, rc, ctx)
        if cfg.cycle == "W":
            # second coarse visit (gamma = 2); a sharded level always has
            # the tail below it, so the single-device k+1 < nlev-1 guard
            # holds
            rc2 = rc - _apply_dist_A(dh, k + 1, ec, ctx)
            ec = ec + _dist_level_solve(dh, k + 1, rc2, ctx)
        x = x + (dist_rect_banded_spmv(lev.Pband, ec, ctx.ring)
                 if banded_txf and lev.Pband is not None
                 else ctx.sp(("P", k), lev.Pmat, ec))
    else:
        # bridge to the replicated (agglomerated) tail
        r_glob = ctx.ring.all_gather(r)
        rc = spmv(dh.bridge_R, r_glob[: dh.bridge_R.n_cols_pad])
        ec = _tail_cycle(dh.tail, cfg, 0, rc)
        if cfg.cycle == "W" and len(dh.tail.levels) > 1:
            rc2 = rc - spmv(dh.tail.levels[0].A, ec)
            ec = ec + _tail_cycle(dh.tail, cfg, 0, rc2)
        corr = spmv(dh.bridge_P, ec)
        me = ctx.ring.axis_index
        x = x + corr[me * lev.n_local:(me + 1) * lev.n_local]
    return _dist_smooth(lev, cfg, b, x, backward=True, sp=spA)


def dist_cycle(dh: DistHierarchy, b, ctx: CommCtx) -> torch.Tensor:
    """One sharded V- or W-cycle on this rank's block of ``b``."""
    return _dist_level_solve(dh, 0, b, ctx)


def dist_solve(
    dh: DistHierarchy,
    b,
    ring: Ring,
    tol: float = 1e-8,
    maxiter: int = 200,
    krylov: str = "cg",
):
    """Sharded AMG-Krylov solve.  ``b`` is the global padded right-hand side
    (a tensor, or anything ``torch.as_tensor`` takes); it is moved to the
    hierarchy's device and this rank's block is solved for.  Returns (this
    rank's block of x, KrylovInfo); ``ring.all_gather(x)`` assembles the
    global x."""
    lev0 = dh.levels[0]
    b = torch.as_tensor(b, device=lev0.dinv.device)
    b_loc = _rows(b, ring, lev0.n_local)
    ctx = CommCtx.flat(ring)

    def apply_A(x):
        return _apply_dist_A(dh, 0, x, ctx)

    def apply_M(r):
        return dist_cycle(dh, r, ctx)

    return krylov_dispatch(krylov)(apply_A, b_loc, apply_M, tol=tol,
                                   maxiter=maxiter, dot_fn=psum_dot(ring))


def comm_report(dh: DistHierarchy, dtype_bytes: int = 4) -> dict:
    """Per-level halo-communication inventory from the host plans: for each
    sharded level, the ring rounds and per-rank halo bytes of one exchange
    on A / P / R, and the exchanges per V-cycle from the configured
    smoother (the x0 == 0 fold makes the first pre-smooth sweep
    exchange-free).  The same dict as the reference's."""
    cfg = dh.config

    def plan_row(plan: HaloPlan) -> dict:
        widths = [int(s.shape[-1]) for s in plan.send_idx]
        return {
            "ppermute_rounds": len(plan.offsets),
            "ring_offsets": list(plan.offsets),
            "halo_words_per_round": widths,
            "bytes_per_exchange_per_dev": int(sum(widths)) * dtype_bytes,
        }

    # SpMV-equivalent sweeps per smoother application (each sweep = one
    # A-halo exchange); Chebyshev applies its degree in SpMVs per sweep
    per_sweep = cfg.cheb_degree if cfg.smoother in (
        "chebyshev", "cheb4", "block_cheb") else 1
    levels = []
    total = 0
    for lv in dh.levels:
        row = {"n": lv.n, "n_local": lv.n_local,
               "layout": "banded" if lv.Aband is not None else "ell",
               "A": plan_row(lv.A.halo)}
        # per V-cycle on this level: pre-smooth nu1 sweeps (first is
        # exchange-free via the x0-zero fold) + 1 residual + nu2 post-smooth
        a_ex = max(cfg.nu1 * per_sweep - 1, 0) + 1 + cfg.nu2 * per_sweep
        if lv.Pmat is not None:
            row["P"] = plan_row(lv.Pmat.halo)
            row["R"] = plan_row(lv.Rmat.halo)
            p_bytes = row["P"]["bytes_per_exchange_per_dev"]
            r_bytes = row["R"]["bytes_per_exchange_per_dev"]
        else:
            p_bytes = r_bytes = 0
        row["exchanges_per_vcycle"] = a_ex + (2 if lv.Pmat is not None else 0)
        row["halo_bytes_per_vcycle_per_dev"] = (
            a_ex * row["A"]["bytes_per_exchange_per_dev"] + p_bytes + r_bytes)
        total += row["halo_bytes_per_vcycle_per_dev"]
        levels.append(row)
    return {"ndev": dh.ndev, "levels": levels,
            "halo_bytes_per_vcycle_per_dev": total,
            "note": "tail below the sharded levels is replicated "
                    "(all_gather bridge once per cycle, no per-level halos)"}
