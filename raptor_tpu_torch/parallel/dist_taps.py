"""The algebraic sharded solve with the TAPS two-level halo exchange.

Counterpart of ``raptor_tpu/parallel/dist_taps.py``: the (node, chip)
variant of ``parallel/dist.py::dist_solve``, with the same hierarchy data
and cycle arithmetic (the TAPS extended vector is laid out as the flat
one's), and every halo exchange run as the two-level gather, one
inter-node transfer and scatter of ``parallel/taps.py::taps_exchange``.
As in the reference, every operator here takes the ELL route: the TAPS
exchange runs on its own plans, so no banded kernel is launched.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from raptor_tpu_torch.ops.sparse_ops import spmv
from raptor_tpu_torch.parallel.dist import (
    CommCtx,
    DistHierarchy,
    _rows,
    dist_cycle,
    distribute_hierarchy,
)
from raptor_tpu_torch.parallel.halo import psum_dot
from raptor_tpu_torch.parallel.taps import (TapsMesh, TapsPlan, build_taps_plan,
                                            make_taps_mesh, taps_exchange)
from raptor_tpu_torch.setup.hierarchy import Hierarchy
from raptor_tpu_torch.solve.krylov import krylov_dispatch

__all__ = [
    "TapsDistHierarchy",
    "distribute_hierarchy_taps",
    "dist_solve_taps",
    "make_taps_mesh",
]


@dataclasses.dataclass(frozen=True)
class TapsDistHierarchy:
    """Flat DistHierarchy + this rank's TapsPlan for each (operator, level)
    slot: ``keys`` holds the slot names ("A", k) / ("R", k) / ("P", k)
    aligned with ``plans``."""

    base: DistHierarchy
    plans: Tuple[TapsPlan, ...]
    keys: Tuple[Tuple[str, int], ...]
    n_nodes: int
    n_chips: int

    def plan(self, slot) -> TapsPlan:
        return self.plans[self.keys.index(slot)]


def distribute_hierarchy_taps(hier: Hierarchy, mesh: TapsMesh,
                              tail_size: int = 4096) -> TapsDistHierarchy:
    """Shard like ``distribute_hierarchy`` over ``mesh.ring`` and attach
    this rank's TAPS plan for every sharded operator (the flat column remap
    is kept: the layouts coincide)."""
    ring = mesh.ring
    n_nodes, n_chips = mesh.node.axis_size, mesh.chip.axis_size
    ndev, me = ring.axis_size, ring.axis_index
    base = distribute_hierarchy(hier, ring, tail_size=tail_size)
    dev = hier.device
    plans, keys = [], []
    for k in range(len(base.levels)):
        lev = hier.levels[k]
        ops = [("A", lev.A, None)]
        if k + 1 < len(base.levels):
            ops += [("R", lev.R, lev.A.n_rows_pad // ndev),
                    ("P", lev.P, hier.levels[k + 1].A.n_rows_pad // ndev)]
        for name, E, owned in ops:
            plan, _ = build_taps_plan(E, n_nodes, n_chips, n_col_owned=owned)
            plans.append(plan.shard(me, dev))
            keys.append((name, k))
    return TapsDistHierarchy(base=base, plans=tuple(plans), keys=tuple(keys),
                             n_nodes=n_nodes, n_chips=n_chips)


def _taps_ctx(th: TapsDistHierarchy, mesh: TapsMesh) -> CommCtx:
    def sp(slot, dm, x_own):
        return spmv(dm.local_ell(), taps_exchange(x_own, th.plan(slot), mesh))

    return CommCtx(sp=sp, ring=mesh.ring, banded=False)


def dist_solve_taps(
    th: TapsDistHierarchy,
    b,
    mesh: TapsMesh,
    tol: float = 1e-8,
    maxiter: int = 200,
    krylov: str = "cg",
):
    """Sharded AMG-Krylov solve with the TAPS halo exchange.  ``b`` is the
    global padded right-hand side; returns (this rank's block of x,
    KrylovInfo)."""
    ctx = _taps_ctx(th, mesh)
    lev0 = th.base.levels[0]
    b = torch.as_tensor(b, device=lev0.dinv.device)
    b_loc = _rows(b, mesh.ring, lev0.n_local)

    def apply_A(x):
        return ctx.sp(("A", 0), lev0.A, x)

    def apply_M(r):
        return dist_cycle(th.base, r, ctx)

    return krylov_dispatch(krylov)(apply_A, b_loc, apply_M, tol=tol,
                                   maxiter=maxiter, dot_fn=psum_dot(mesh.ring))
