"""Bodies of the spawned ranks of tests/test_torch_adist.py.

Each function runs on every rank of a ``raptor_tpu_torch.parallel.spawn``
run and returns plain numpy data.  This module imports no JAX: a spawned
child imports it fresh, without the test conftest's JAX platform settings.
Hierarchies arrive as the plain-numpy trees of
``setup/convert.algebraic_hierarchy_from_numpy`` (one carried over from the
JAX package) or are built by the port itself from a scipy matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.api import setup
from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.core.hybrid import banded_from_csr
from raptor_tpu_torch.parallel import (Ring, dist_solve, dist_solve_taps,
                                       distribute_hierarchy,
                                       distribute_hierarchy_taps,
                                       distribute_matrix, make_taps_mesh)
from raptor_tpu_torch.parallel import dist as pdist
from raptor_tpu_torch.parallel.halo import (dist_spmv, halo_exchange,
                                            halo_reduce)
from raptor_tpu_torch.parallel.taps import taps_exchange
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _block(v, ring: Ring):
    nl = v.shape[-1] // ring.axis_size
    return v[..., ring.axis_index * nl:(ring.axis_index + 1) * nl]


# the port's own hierarchies, by the case's "key": built once per process
_BUILT: dict = {}


def _hierarchy(case: dict):
    """The case's hierarchy on the CPU: the carried tree with its config
    replaced by ``cfg`` entries, or the port's own setup of ``matrix``."""
    if "tree" in case:
        h = algebraic_hierarchy_from_numpy(case["tree"], "cpu")
    else:
        key = case.get("key")
        h = _BUILT.get(key) if key else None
        if h is None:
            h = setup(case["matrix"], AmgConfig(**case["setup_cfg"]),
                      dtype=np.float64, device="cpu")
            if key:
                _BUILT[key] = h
    if case.get("cfg"):
        h = dataclasses.replace(
            h, config=dataclasses.replace(h.config, **case["cfg"]))
    return h


def _dm(m):
    return None if m is None else {
        "data": _np(m.data), "cols": _np(m.cols), "row_nnz": _np(m.row_nnz),
        "send_idx": [_np(s) for s in m.halo.send_idx],
        "recv_tgt": [_np(r) for r in m.halo.recv_tgt],
        "offsets": m.halo.offsets, "n_ext": m.halo.n_ext,
        "n_local": m.halo.n_local}


def _band(B):
    return None if B is None else {"vals": _np(B.vals), "pidx": _np(B.pidx),
                                   "meta": B.meta}


def _case_matrix(ring: Ring, case: dict):
    """distribute_matrix of a square ELL matrix and of the rectangular
    transfers of a hierarchy's level 0."""
    out = {"A": _dm(distribute_matrix(ell_from_csr(case["matrix"],
                                                   dtype=np.float64,
                                                   row_pad_multiple=case["pad"]),
                                      ring))}
    h = _hierarchy(case)
    ndev = ring.axis_size
    nf, nc = h.levels[0].A.n_rows_pad, h.levels[1].A.n_rows_pad
    out["R"] = _dm(distribute_matrix(h.levels[0].R, ring, n_col_owned=nf // ndev))
    out["P"] = _dm(distribute_matrix(h.levels[0].P, ring, n_col_owned=nc // ndev))
    return out


def _case_halo(ring: Ring, case: dict):
    """halo_exchange of the global index and halo_reduce (add, max) of
    seeded values on the plan of a square ELL matrix."""
    E = ell_from_csr(case["matrix"], dtype=np.float64,
                     row_pad_multiple=case["pad"])
    dm = distribute_matrix(E, ring)
    nl, n_ext = dm.n_rows_local, dm.halo.n_ext
    me = ring.axis_index
    x_own = torch.arange(me * nl, (me + 1) * nl, dtype=torch.float64)
    rng = np.random.default_rng(10 + me)
    y_ext = torch.from_numpy(rng.standard_normal(n_ext))
    k_ext = torch.from_numpy(rng.integers(-50, 50, n_ext))
    return {"ext": _np(halo_exchange(x_own, dm.halo, ring)),
            "cols": _np(dm.cols), "row_nnz": _np(dm.row_nnz),
            "y_ext": _np(y_ext), "k_ext": _np(k_ext),
            "add": _np(halo_reduce(y_ext, dm.halo, ring)),
            "max": _np(halo_reduce(y_ext, dm.halo, ring, op="max")),
            "max_int": _np(halo_reduce(k_ext, dm.halo, ring, op="max")),
            "recv_tgt": [_np(r) for r in dm.halo.recv_tgt]}


def _case_spmv(ring: Ring, case: dict):
    """dist_spmv of the ELL matrix and dist_banded_spmv of the port's own
    banded layout of it, on this rank's block of x."""
    A = case["matrix"]
    x = torch.from_numpy(case["x"])
    E = ell_from_csr(A, dtype=np.float64, row_pad_multiple=case["pad"])
    out = {"ell": _np(dist_spmv(distribute_matrix(E, ring),
                                _block(x[:E.n_rows_pad], ring), ring))}
    B = banded_from_csr(A, dtype=np.float64)
    out["plan"] = {"vals": B.vals, "pidx": B.pidx, "meta": B.meta}
    Bs = pdist._shardable_band(B, ring.axis_size)
    out["shardable"] = Bs is not None
    if Bs is not None:
        B_t = dataclasses.replace(B, vals=torch.from_numpy(B.vals),
                                  pidx=torch.from_numpy(B.pidx),
                                  perm=torch.from_numpy(B.perm),
                                  iperm=torch.from_numpy(B.iperm))
        out["banded"] = _np(pdist.dist_banded_spmv(
            pdist._tile_block(B_t, ring), _block(x, ring), ring))
    return out


def _case_rect(ring: Ring, case: dict):
    """dist_rect_banded_spmv of a level's R and P (``Rband``/``Pband``
    trees of fine size ``nf`` and coarse size ``nc``) on this rank's
    tiles."""
    from raptor_tpu_torch.setup.convert import _band

    nf, nc, ndev = case["nf"], case["nc"], ring.axis_size
    out = {}
    for name, m, rows, cols in (("R", "xf", nc, nf), ("P", "xc", nf, nc)):
        B = _band(case[f"{name}band"]).to("cpu")
        Bs = pdist._shardable_rect(B, ndev, rows, cols)
        out[name] = None if Bs is None else _np(pdist.dist_rect_banded_spmv(
            pdist._tile_block(Bs, ring), _block(torch.from_numpy(case[m]), ring),
            ring))
    return out


def _case_distribute(ring: Ring, case: dict):
    """This rank's share of distribute_hierarchy."""
    dh = distribute_hierarchy(_hierarchy(case), ring, case["tail_size"])
    tail = dh.tail
    return {
        "levels": [{"A": _dm(lv.A), "P": _dm(lv.Pmat), "R": _dm(lv.Rmat),
                    "dinv": _np(lv.dinv), "n_local": lv.n_local, "n": lv.n,
                    "Aband": _band(lv.Aband), "Pband": _band(lv.Pband),
                    "Rband": _band(lv.Rband)} for lv in dh.levels],
        "bridge_P": _np(dh.bridge_P.data), "bridge_R": _np(dh.bridge_R.data),
        "tail_n": [lv.n for lv in tail.levels],
        "tail_A": [_np(lv.A.data) for lv in tail.levels],
        "tail_start": tail.tail_start, "tail_op": _np(tail.tail_op),
    }


def _case_solve(ring: Ring, case: dict):
    h = _hierarchy(case)
    dh = distribute_hierarchy(h, ring, case["tail_size"])
    b = torch.from_numpy(case["b"])
    x, info = dist_solve(dh, b, ring, tol=1e-8, maxiter=case["maxiter"],
                         krylov=case.get("krylov", "cg"))
    out = {"x": _np(ring.all_gather(x)), "iterations": int(info.iterations),
           "relres": float(info.relres), "status": int(info.status),
           "n_sharded": len(dh.levels),
           "banded": [lv.Aband is not None for lv in dh.levels],
           "banded_txf": [lv.Rband is not None for lv in dh.levels],
           "comm": pdist.comm_report(dh)}
    if case.get("taps"):
        mesh = make_taps_mesh(*case["taps"])
        th = distribute_hierarchy_taps(h, mesh, case["tail_size"])
        xt, it = dist_solve_taps(th, b, mesh, tol=1e-8, maxiter=case["maxiter"],
                                 krylov=case.get("krylov", "cg"))
        out.update(taps_x=_np(ring.all_gather(xt)),
                   taps_iterations=int(it.iterations))
        # the two-level exchange fills the flat one's extended vector
        rng = np.random.default_rng(ring.axis_index)
        same = []
        for slot, plan in zip(th.keys, th.plans):
            kind, k = slot
            lv = th.base.levels[k]
            dm = {"A": lv.A, "R": lv.Rmat, "P": lv.Pmat}[kind]
            v = torch.from_numpy(rng.standard_normal(plan.n_local))
            same.append(torch.equal(taps_exchange(v, plan, mesh),
                                    halo_exchange(v, dm.halo, ring)))
        out["taps_ext_equal"] = same
    return out


def _case_reordered(ring: Ring, case: dict):
    """A level whose banded layout is ``reordered``: distribute_hierarchy
    keeps it off the banded route; its sharded apply against the
    single-device one, and what the banded route without the permutation
    (the reference's sharded apply) would give."""
    h = _hierarchy(case)
    from raptor_tpu_torch.core.hybrid import banded_from_ell

    k = case["level"]
    B = banded_from_ell(h.levels[k].A, reorder=True)
    h = dataclasses.replace(h, levels=tuple(
        dataclasses.replace(lv, Aband=B.to("cpu")) if i == k else lv
        for i, lv in enumerate(h.levels)))
    dh = distribute_hierarchy(h, ring, case["tail_size"])
    lev = dh.levels[k]
    x = torch.from_numpy(case["x"][: lev.n_local * ring.axis_size])
    ctx = pdist.CommCtx.flat(ring)
    y = pdist._apply_dist_A(dh, k, _block(x, ring), ctx)
    unguarded = pdist.dist_banded_spmv(pdist._tile_block(h.levels[k].Aband, ring),
                                       _block(x, ring), ring)
    from raptor_tpu_torch.solve.cycle import apply_op

    return {"reordered": B.reordered, "sharded_band": lev.Aband is not None,
            "y": _np(ring.all_gather(y)),
            "y_ell": _np(ring.all_gather(dist_spmv(lev.A, _block(x, ring), ring))),
            "y_single": _np(apply_op(h.levels[k], x)),
            "y_unguarded": _np(ring.all_gather(unguarded))}


CASES = {"matrix": _case_matrix, "halo": _case_halo, "spmv": _case_spmv,
         "rect": _case_rect, "distribute": _case_distribute,
         "solve": _case_solve, "reordered": _case_reordered}


def run_cases(ring: Ring, device, cases: list) -> list:
    """Every case on the whole ring; a case with ``"solo": True`` runs on
    each rank alone (a ring of one, from a group of one rank)."""
    solos = [dist.new_group([r]) for r in range(ring.axis_size)]
    solo = Ring(solos[ring.axis_index])
    return [CASES[case["kind"]](solo if case.get("solo") else ring, case)
            for case in cases]
