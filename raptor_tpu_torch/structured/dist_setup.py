"""Plane-sharded structured setup: every sharded level built block by block.

Counterpart of ``raptor_tpu/structured/dist_setup.py`` (config 5's
"weak-scaling setup").  Sharding is the plane decomposition of
``structured/dist.py``: dim0 in contiguous blocks, one per rank of a
``Ring``.  The only communication of the sharded levels is plane halos: a
DIA x DIA Galerkin product's shifted reads reach at most about two planes
past a block edge, exchanged once per product by one shift each way, and
the power iteration of the Chebyshev smoothers runs through the halo SpMV
(K3 on CUDA) with ring-summed dots.  Collapse weights, compaction and
boundary masks are local.

Below ``tail_size`` rows the coarsest sharded operator is gathered onto
every rank and the tail hierarchy is built there with the single-device
setup.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.solve.krylov import vdot
from raptor_tpu_torch.structured.dia import DiaMatrix, _linear, boundary_mask_traced
from raptor_tpu_torch.structured.dist import (
    SDistHierarchy,
    SDistLevel,
    _block,
    _halo_spmv,
    plan_coarsening_dist,
)
from raptor_tpu_torch.structured.solver import (
    LMAX_ITERS,
    LMAX_SAFETY,
    _build_hierarchy_planned,
    _c_mask_traced,
    _coarse_dims,
    _collapse_weights,
    _compact,
    _coord,
    _nonzero_or_one,
    _parity,
)

__all__ = ["sdist_build_hierarchy"]

Vec = Tuple[int, ...]


def _halo_extend(data: torch.Tensor, ring: Ring, LP: int, RP: int) -> torch.Tensor:
    """Extend (n_off, nl) plane-sharded diagonals with LP / RP halo columns
    from the ring neighbours (one shift per direction for all diagonals)."""
    nl = data.shape[1]
    parts = []
    if LP:
        parts.append(ring.shift_right(data[:, nl - LP:]))
    parts.append(data)
    if RP:
        parts.append(ring.shift_left(data[:, :RP]))
    return torch.cat(parts, dim=1) if len(parts) > 1 else data


def _sdist_mult(A: DiaMatrix, B: DiaMatrix, ring: Ring, dims_local: Vec) -> DiaMatrix:
    """C = A @ B on plane blocks; the terms of each output offset are summed
    in the reference's order (A's offsets outer, B's inner)."""
    nl = int(np.prod(dims_local))
    linsA = [_linear(o, dims_local) for o in A.offsets]
    LP = max([0] + [-v for v in linsA])
    RP = max([0] + linsA)
    B_ext = _halo_extend(B.data, ring, LP, RP)
    out: dict = {}
    for i, (o1, lin1) in enumerate(zip(A.offsets, linsA)):
        a = A.data[i]
        for j, o2 in enumerate(B.offsets):
            key = tuple(x + y for x, y in zip(o1, o2))
            seg = B_ext[j, LP + lin1:LP + lin1 + nl] if (LP or RP) else B.data[j]
            term = a * seg
            out[key] = term if key not in out else out[key] + term
    offs = sorted(out)
    return DiaMatrix(data=torch.stack([out[o] for o in offs]),
                     offsets=tuple(offs), dims=dims_local)


def _sdist_transpose(A: DiaMatrix, ring: Ring, dims_local: Vec) -> DiaMatrix:
    """A.T on plane blocks: dataT_{-o}(i) = data_o(i - lin(o))."""
    nl = int(np.prod(dims_local))
    lins = [_linear(o, dims_local) for o in A.offsets]
    LP = max([0] + lins)  # shifting by +lin reads i - lin
    RP = max([0] + [-v for v in lins])
    ext = _halo_extend(A.data, ring, LP, RP)
    items = []
    for k, (o, lin) in enumerate(zip(A.offsets, lins)):
        plane = ext[k, LP - lin:LP - lin + nl] if (LP or RP) else A.data[k]
        items.append((tuple(-v for v in o), plane))
    items.sort(key=lambda t: t[0])
    return DiaMatrix(data=torch.stack([p for _, p in items]),
                     offsets=tuple(o for o, _ in items), dims=dims_local)


def _bmask_dist(dims_local: Vec, D0: int, off: Vec, ring: Ring,
                device) -> torch.Tensor:
    """Boundary-validity mask on the local box, with dim0 judged against
    the global extent D0 from this rank's plane offset."""
    m = boundary_mask_traced(dims_local, (0,) + tuple(off[1:]), device)
    if off[0] == 0:
        return m
    gp = ring.axis_index * dims_local[0] + _coord(dims_local, 0, device)
    return m & (gp + off[0] >= 0) & (gp + off[0] < D0)


def _build_transfer_dist(A: DiaMatrix, ring: Ring, dims_local: Vec, D0: int,
                         d: int) -> DiaMatrix:
    """The embedded prolongation on this block.  For d == 0 the local C
    mask is the global one because the block's plane count is even."""
    dev = A.device
    cm = _c_mask_traced(dims_local, d, dev)
    fm = ~cm
    w_m, w_p = _collapse_weights(A, d)
    nd = len(dims_local)
    e = tuple(1 if ax == d else 0 for ax in range(nd))
    ne = tuple(-1 if ax == d else 0 for ax in range(nd))
    bm_p = _bmask_dist(dims_local, D0, e, ring, dev)
    bm_m = _bmask_dist(dims_local, D0, ne, ring, dev)
    data = torch.stack([
        torch.where(fm & bm_m, w_m, 0.0).to(A.dtype),
        cm.to(A.dtype),
        torch.where(fm & bm_p, w_p, 0.0).to(A.dtype),
    ])
    return DiaMatrix(data=data, offsets=(ne, tuple([0] * nd), e), dims=dims_local)


def _compact_dia_dist(Ae: DiaMatrix, ring: Ring, dims_local: Vec, D0: int,
                      d: int) -> DiaMatrix:
    cd_local = _coarse_dims(dims_local, d)
    D0c = (D0 + 1) // 2 if d == 0 else D0
    planes, offs = [], []
    for k, o in enumerate(Ae.offsets):
        if o[d] % 2 != 0:
            continue  # identically zero between C points
        oc = tuple(v // 2 if ax == d else v for ax, v in enumerate(o))
        plane = _compact(Ae.data[k], dims_local, d)
        plane = plane * _bmask_dist(cd_local, D0c, oc, ring, Ae.device).to(Ae.dtype)
        planes.append(plane)
        offs.append(oc)
    return DiaMatrix(data=torch.stack(planes), offsets=tuple(offs), dims=cd_local)


def _lmax_dist(A: DiaMatrix, ring: Ring, dinv: torch.Tensor) -> torch.Tensor:
    """Power iteration on D^-1 A over the ring, from the rank-dependent
    start vector sin((i + 7 rank) 0.7511) + 0.01."""
    i = torch.arange(A.n, dtype=A.dtype, device=A.device) + 7.0 * ring.axis_index
    v = torch.sin(i * 0.7511) + 0.01

    def norm(w):
        return torch.sqrt(ring.psum(vdot(w, w)))

    v = v / norm(v)
    for _ in range(LMAX_ITERS):
        w = dinv * _halo_spmv(A, ring, v)
        v = w / norm(w)
    w = dinv * _halo_spmv(A, ring, v)
    return LMAX_SAFETY * ring.psum(vdot(v, w)) / ring.psum(vdot(v, v))


def sdist_build_hierarchy(
    A: DiaMatrix,
    config: AmgConfig,
    ring: Ring,
    dim_policy: str = "operator",
    tail_size: int = 4096,
) -> SDistHierarchy:
    """Sharded structured setup on A's device.

    ``A`` is the global operator; each rank keeps its plane block of the
    diagonals and builds every sharded level with plane-halo communication
    only.  The agglomerated tail is built on every rank from the gathered
    coarsest sharded operator.  Returns the ``SDistHierarchy`` that
    ``sdist_solve`` takes."""
    ndev = ring.axis_size
    if A.dims[0] % ndev:
        raise ValueError(f"dim0 {A.dims[0]} does not divide over {ndev} ranks")
    plan, t = plan_coarsening_dist(A, config, ndev, dim_policy, tail_size)
    dims_local = (A.dims[0] // ndev,) + A.dims[1:]
    Ak = DiaMatrix(data=_block(A.data, ring, int(np.prod(dims_local))),
                   offsets=A.offsets, dims=dims_local)
    dims_global = A.dims
    levels = []
    for d in plan[:t]:
        dl = Ak.dims
        Pt = _build_transfer_dist(Ak, ring, dl, dims_global[0], d)
        Rt = _sdist_transpose(Pt, ring, dl)
        Ae = _sdist_mult(Rt, _sdist_mult(Ak, Pt, ring, dl), ring, dl)
        Ac = _compact_dia_dist(Ae, ring, dl, dims_global[0], d)
        dinv = 1.0 / _nonzero_or_one(Ak.diagonal())
        lmax = (_lmax_dist(Ak, ring, dinv)
                if config.smoother in ("chebyshev", "cheb4") else None)
        # the block's plane count is even, so local parity == global parity
        levels.append(SDistLevel(A=Ak, Pt=Pt, Rt=Rt, dinv=dinv,
                                 red=_parity(dl, Ak.device) == 0,
                                 cheb_lmax=lmax, dims_local=dl, cdim=d))
        Ak = Ac
        dims_global = _coarse_dims(dims_global, d)

    # agglomerate: gather the coarsest sharded operator onto every rank and
    # build the tail there with the single-device setup
    A_tail = DiaMatrix(data=ring.all_gather(Ak.data), offsets=Ak.offsets,
                       dims=dims_global)
    tail = _build_hierarchy_planned(A_tail, config, plan[t:])
    return SDistHierarchy(levels=tuple(levels), tail=tail, config=config,
                          ndev=ndev)
