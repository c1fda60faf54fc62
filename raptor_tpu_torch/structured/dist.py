"""Plane-sharded structured multigrid over ``torch.distributed``.

Counterpart of ``raptor_tpu/structured/dist.py`` (config 5: "3D Poisson
256^3 sharded: distributed hierarchy, ppermute halo exchange").  The
slowest grid dimension is cut into contiguous plane blocks, one per rank of
a ``Ring`` (``raptor_tpu_torch/parallel/comm.py``); every process holds
only its own block.  So:

* every level operator reaches across a block edge by its extremal linear
  offsets (dim0 offsets are in {-1, 0, 1}), so a SpMV needs one halo shift
  in each direction;
* dim0 linear offsets are the same locally and globally, so a block IS a
  ``DiaMatrix`` on the local box ``dims_local``;
* dim0 is coarsened only while the per-block plane count stays even (local
  parity equals global parity); then the plan moves to the other dims, and
  below ``tail_size`` rows the coarse levels are gathered onto every rank
  (agglomerated) and run replicated.

Every halo SpMV (``_halo_spmv``) on CUDA tensors launches K3
(``ops/cuda/dia_kernel.py::dia_spmv_halo``) and is counted in
``cuda_calls["halo_spmv"]``; on CPU tensors it runs K3's plain version.
``distribute_structured`` builds the hierarchy whole on every rank and
keeps the rank's block; ``structured/dist_setup.py::sdist_build_hierarchy``
builds it block by block with halo exchanges only.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.ops.cuda.dia_kernel import dia_spmv_halo, halo_reach
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.solve.krylov import krylov_dispatch, vdot
from raptor_tpu_torch.structured.dia import DiaMatrix, dia_from_stencil, dia_spmv
from raptor_tpu_torch.structured.solver import (
    SHierarchy,
    _build_hierarchy_planned,
    _compact,
    _expand,
    _slevel,
    materialize_tail,
    plan_coarsening,
)

__all__ = ["SDistLevel", "SDistHierarchy", "plan_coarsening_dist",
           "distribute_structured", "sdist_cycle", "sdist_solve", "gather",
           "CONFIG5", "CONFIG5_TOL", "CONFIG5_MAXITER", "config5_problem",
           "sdist_config5", "cuda_calls"]

Vec = Tuple[int, ...]

# _halo_spmv calls on CUDA tensors (key "halo_spmv"); each one launches K3
cuda_calls: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class SDistLevel:
    """One sharded level: this rank's plane block of every array.  The
    operators are ``DiaMatrix``es on the local box ``dims_local`` (the same
    linear offsets as globally)."""

    A: DiaMatrix
    Pt: Optional[DiaMatrix]
    Rt: Optional[DiaMatrix]
    dinv: torch.Tensor
    red: torch.Tensor
    cheb_lmax: Optional[torch.Tensor]  # the same scalar on every rank
    dims_local: Vec
    cdim: int


@dataclasses.dataclass(frozen=True)
class SDistHierarchy:
    levels: Tuple[SDistLevel, ...]
    tail: SHierarchy  # the agglomerated coarse hierarchy, on every rank
    config: AmgConfig
    ndev: int


def plan_coarsening_dist(
    A: DiaMatrix, config: AmgConfig, ndev: int, dim_policy: str = "operator",
    tail_size: int = 4096,
) -> tuple[Tuple[int, ...], int]:
    """(plan, n_sharded_levels): like plan_coarsening, but while a level is
    sharded dim0 is only coarsened if the per-shard plane count stays even
    (balanced shards, parity-aligned compaction); sharding stops
    (agglomeration onto replicas) once the grid drops below tail_size."""
    # the sharded levels semicoarsen only: plan without full coarsening
    full = plan_coarsening(A, config, dim_policy, allow_full=False)
    dims = list(A.dims)
    plan = []
    t = 0
    counting = True
    for d in full:
        bad0 = (dims[0] // ndev) % 2 != 0 or (dims[0] // 2) // ndev < 2
        if counting and d == 0 and bad0:
            # coarsening dim0 would unbalance or de-shard the next level:
            # replan this step onto the largest other dim if possible
            alts = [ax for ax in range(1, len(dims)) if dims[ax] > 3]
            if not alts:
                counting = False
            else:
                d = max(alts, key=lambda ax: dims[ax])
        plan.append(d)
        dims[d] = (dims[d] + 1) // 2
        if counting and int(np.prod(dims)) > tail_size \
                and dims[0] % ndev == 0 and (dims[0] // ndev) >= 2:
            t += 1
        else:
            counting = False
    return tuple(plan), max(t, 1)


def _strip(m: Optional[DiaMatrix]) -> Optional[DiaMatrix]:
    return None if m is None else dataclasses.replace(m, const_planes=None)


def _block(v: torch.Tensor, ring: Ring, nl: int) -> torch.Tensor:
    """This rank's block of the last dimension."""
    me = ring.axis_index
    return v[..., me * nl:(me + 1) * nl].contiguous()


def distribute_structured(
    A: DiaMatrix, config: AmgConfig, ring: Ring,
    dim_policy: str = "operator", tail_size: int = 4096,
) -> SDistHierarchy:
    """Build the whole hierarchy on every rank (on A's device), then keep
    this rank's plane block of the sharded levels."""
    ndev = ring.axis_size
    if A.dims[0] % ndev:
        raise ValueError(f"dim0 {A.dims[0]} does not divide over {ndev} ranks")
    plan, t = plan_coarsening_dist(A, config, ndev, dim_policy, tail_size)
    hier = _build_hierarchy_planned(A, config, plan)

    def local(m, dims_local, nl):
        m = _strip(m)
        return None if m is None else DiaMatrix(
            data=_block(m.data, ring, nl), offsets=m.offsets, dims=dims_local)

    dlevels = []
    for lev in hier.levels[:t]:
        dims_local = (lev.dims[0] // ndev,) + lev.dims[1:]
        nl = int(np.prod(dims_local))
        dlevels.append(SDistLevel(
            A=local(lev.A, dims_local, nl), Pt=local(lev.Pt, dims_local, nl),
            Rt=local(lev.Rt, dims_local, nl), dinv=_block(lev.dinv, ring, nl),
            red=_block(lev.red, ring, nl), cheb_lmax=lev.cheb_lmax,
            dims_local=dims_local, cdim=lev.cdim))
    tail_levels = tuple(
        dataclasses.replace(lv, A=_strip(lv.A), Pt=_strip(lv.Pt), Rt=_strip(lv.Rt))
        for lv in hier.levels[t:])
    tail = SHierarchy(levels=tail_levels, coarse_inv=hier.coarse_inv,
                      config=config)
    if config.tail_max_n > 0:
        # the whole replicated coarse cycle as one dense matvec (min_start=0:
        # the tail is already coarse at its level 0)
        tail = materialize_tail(tail, config.tail_max_n, min_start=0)
    return SDistHierarchy(levels=tuple(dlevels), tail=tail, config=config,
                          ndev=ndev)


# ---------------------------------------------------------------------------
# sharded cycle
# ---------------------------------------------------------------------------

def _halo_spmv(A: DiaMatrix, ring: Ring, x_own: torch.Tensor) -> torch.Tensor:
    """y = A @ x on this rank's block, with one halo shift per direction.

    The halo widths are the exact extremal linear offsets: a mixed offset
    such as (+1, +1, 0) reaches one plane plus one line beyond the block,
    more than a plane but less than two (the plan keeps >= 2 local planes).
    Reads wrapped around the global boundary meet boundary-zeroed planes."""
    lins = A.linear_offsets()
    LP, RP = halo_reach(lins)
    nl = x_own.shape[0]
    empty = x_own[:0]
    # my tail -> the right neighbour's left halo; my head -> the left one's
    # right halo
    recv_l = ring.shift_right(x_own[nl - LP:]) if LP else empty
    recv_r = ring.shift_left(x_own[:RP]) if RP else empty
    if x_own.is_cuda:
        cuda_calls["halo_spmv"] += 1
    return dia_spmv_halo(A.data, lins, x_own, recv_l, recv_r)


def _sdist_smooth(lev: SDistLevel, ring: Ring, cfg: AmgConfig, b, x,
                  backward: bool, x0_zero: bool = False):
    """``x0_zero`` asserts x == 0 on entry: the first residual is exactly
    ``b``, which saves one halo SpMV per level and cycle."""
    sweeps = cfg.nu2 if backward else cfg.nu1
    if sweeps == 0:
        return x
    first = [x0_zero]  # consumed by the FIRST residual below

    def spmv(v):
        return _halo_spmv(lev.A, ring, v)

    def res(x):
        if first[0]:
            first[0] = False
            return b
        return b - spmv(x)

    if cfg.smoother == "jacobi":
        for _ in range(sweeps):
            x = x + cfg.omega * lev.dinv * res(x)
        return x
    if cfg.smoother == "mcgs":
        order = (False, True) if backward else (True, False)
        for _ in range(sweeps):
            for red_turn in order:
                r = res(x)
                upd = lev.red if red_turn else ~lev.red
                x = x + torch.where(upd, lev.dinv * r, 0.0)
        return x
    if cfg.smoother == "cheb4":
        r = res(x)
        d = (4.0 / 3.0) / lev.cheb_lmax * (lev.dinv * r)
        x = x + d
        for k in range(2, cfg.cheb_degree + 1):
            r = r - spmv(d)
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
    raise ValueError(f"distributed structured smoother: {cfg.smoother}")


def _sdist_level(dh: SDistHierarchy, ring: Ring, k: int, b):
    cfg = dh.config
    lev = dh.levels[k]
    x = _sdist_smooth(lev, ring, cfg, b, torch.zeros_like(b), backward=False,
                      x0_zero=True)
    r = b - _halo_spmv(lev.A, ring, x) if cfg.nu1 else b
    rr = _halo_spmv(lev.Rt, ring, r)
    if k + 1 < len(dh.levels):
        rc = _compact(rr, lev.dims_local, lev.cdim)
        ec = _sdist_level(dh, ring, k + 1, rc)
        if cfg.cycle == "W":
            # second coarse visit; sharded levels always have the tail below
            lev1 = dh.levels[k + 1]
            rc2 = rc - _halo_spmv(lev1.A, ring, ec)
            ec = ec + _sdist_level(dh, ring, k + 1, rc2)
        e = _expand(ec, lev.dims_local, lev.cdim)
    else:
        # agglomerate: gather the (small) coarse residual, run the
        # replicated tail cycle, keep this rank's block
        rc_loc = _compact(rr, lev.dims_local, lev.cdim)
        rc = ring.all_gather(rc_loc)
        ec = _slevel(dh.tail, cfg, 0, rc)
        if cfg.cycle == "W" and len(dh.tail.levels) > 1:
            rc2 = rc - dia_spmv(dh.tail.levels[0].A, ec)
            ec = ec + _slevel(dh.tail, cfg, 0, rc2)
        e = _expand(_block(ec, ring, rc_loc.shape[0]), lev.dims_local, lev.cdim)
    x = x + _halo_spmv(lev.Pt, ring, e)
    return _sdist_smooth(lev, ring, cfg, b, x, backward=True)


def sdist_cycle(dh: SDistHierarchy, ring: Ring, b):
    """One sharded V-/W-cycle on this rank's block of ``b``."""
    return _sdist_level(dh, ring, 0, b)


def sdist_solve(
    dh: SDistHierarchy,
    b,
    ring: Ring,
    tol: float = 1e-8,
    maxiter: int = 200,
    krylov: str = "cg",
):
    """Sharded AMG-preconditioned Krylov solve.  ``b`` is the global
    right-hand side (a tensor, or anything ``torch.as_tensor`` takes); it is
    moved to the hierarchy's device and this rank's block is solved for.
    The inner products sum over the ring (``psum`` of the local dots), the
    only global reduction per iteration.  Returns (this rank's block of x,
    KrylovInfo); ``gather`` assembles the global x."""
    lev0 = dh.levels[0]
    b = torch.as_tensor(b, device=lev0.A.device)
    b_loc = _block(b, ring, int(np.prod(lev0.dims_local)))

    def apply_A(x):
        return _halo_spmv(lev0.A, ring, x)

    def apply_M(r):
        return sdist_cycle(dh, ring, r)

    def dot(a, c):
        return ring.psum(vdot(a, c))

    return krylov_dispatch(krylov)(apply_A, b_loc, apply_M, tol=tol,
                                   maxiter=maxiter, dot_fn=dot)


def gather(x_loc: torch.Tensor, ring: Ring) -> torch.Tensor:
    """The global vector from every rank's block (on every rank)."""
    return ring.all_gather(x_loc)


# ---------------------------------------------------------------------------
# config 5 (raptor_tpu/cli.py:194-241): 3D 7-point Poisson, sharded
# ---------------------------------------------------------------------------

CONFIG5 = AmgConfig(smoother="mcgs", coarse_size=512, max_levels=40)
CONFIG5_TOL = 1e-6  # the preset's solve tolerance
CONFIG5_MAXITER = 200  # the CLI's --maxiter default


def config5_problem(n: int, device):
    """The config-5 operator on n^3 in fp32 (7-point Poisson, every rank
    holds it whole) and the default right-hand side."""
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    A = dia_from_stencil(st, (n, n, n), dtype=torch.float32, device=device)
    b = torch.from_numpy(default_rhs(n ** 3, dtype=np.float32)).to(device)
    return A, b


def sdist_config5(ring: Ring, device, n: int = 256) -> dict:
    """The config-5 bench preset on the ring: ``sdist_build_hierarchy``
    (mcgs, coarse_size 512, dim_policy 'size') then ``sdist_solve`` to
    ``CONFIG5_TOL`` within ``CONFIG5_MAXITER`` iterations.
    Returns the hierarchy, this rank's block of x, the KrylovInfo, and the
    setup and solve seconds (host clock; each ends in a device sync)."""
    from raptor_tpu_torch.structured.dist_setup import sdist_build_hierarchy

    device = torch.device(device)
    A, b = config5_problem(n, device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    sync()
    t0 = time.perf_counter()
    dh = sdist_build_hierarchy(A, CONFIG5, ring, dim_policy="size")
    sync()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = sdist_solve(dh, b, ring, tol=CONFIG5_TOL, maxiter=CONFIG5_MAXITER)
    sync()
    return {"hier": dh, "x": x, "info": info, "setup_s": setup_s,
            "solve_s": time.perf_counter() - t0}
