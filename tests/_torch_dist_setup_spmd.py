"""Bodies of the spawned ranks of tests/test_torch_dist_setup.py and
tests/test_torch_dist_setup_aggr.py, and the summaries and carried
hierarchies tests/_torch_dist_sa_spmd.py shares.

Each case runs on every rank of a ``raptor_tpu_torch.parallel.spawn`` run
and returns plain numpy data.  This module imports no JAX: a spawned child
imports it fresh, without the test conftest's JAX platform settings.  The
reference's hierarchies arrive as the per-rank plain-numpy trees of
``tests/_torch_ref.dist_tree_from_jax``.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, ell_from_csr
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.parallel import (DistHierarchy, DistLevel, DistMatrix,
                                       HaloPlan, Ring, dist_build_hierarchy,
                                       dist_solve, distribute_matrix)
from raptor_tpu_torch.parallel import dist_setup as ds
from raptor_tpu_torch.parallel.halo import halo_exchange
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from raptor_tpu_torch.setup.splitting import make_perm_np


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def _block(a, ring: Ring):
    nl = a.shape[-1] // ring.axis_size
    return a[..., ring.axis_index * nl:(ring.axis_index + 1) * nl]


def _dm(m):
    return None if m is None else {
        "data": _np(m.data), "cols": _np(m.cols), "row_nnz": _np(m.row_nnz),
        "send_idx": [_np(s) for s in m.halo.send_idx],
        "recv_tgt": [_np(r) for r in m.halo.recv_tgt],
        "offsets": m.halo.offsets, "n_ext": m.halo.n_ext,
        "n_local": m.halo.n_local, "n_rows_local": m.n_rows_local,
        "K": m.K, "shape": m.shape}


def _ell(E):
    return {"data": _np(E.data), "cols": _np(E.cols),
            "row_nnz": _np(E.row_nnz), "shape": E.shape,
            "n_rows_pad": E.n_rows_pad, "n_cols_pad": E.n_cols_pad}


def _scalar(v):
    return None if v is None else float(v)


def _global_cols(m, ring: Ring):
    """A DistMatrix's columns as global indices (None for None)."""
    if m is None:
        return None
    nl = m.halo.n_local
    own = torch.arange(nl) + ring.axis_index * nl
    return _np(halo_exchange(own, m.halo, ring)[m.cols.long()])


def summary(dh: DistHierarchy, ring: Ring) -> dict:
    """A rank's DistHierarchy as plain numpy, with the global columns of
    each level's A and P."""
    return {
        "levels": [{"A": _dm(lv.A), "P": _dm(lv.Pmat), "R": _dm(lv.Rmat),
                    "A_gcols": _global_cols(lv.A, ring),
                    "P_gcols": _global_cols(lv.Pmat, ring),
                    "dinv": _np(lv.dinv), "cheb_lmax": _scalar(lv.cheb_lmax),
                    "color": _np(lv.color), "ncolors": lv.ncolors,
                    "binv": _np(lv.binv), "n": lv.n,
                    "n_local": lv.n_local} for lv in dh.levels],
        "bridge_P": _ell(dh.bridge_P), "bridge_R": _ell(dh.bridge_R),
        "tail_n": [lv.n for lv in dh.tail.levels],
        "tail_A": [_ell(lv.A) for lv in dh.tail.levels]}


def _dm_from(d, device) -> DistMatrix:
    if d is None:
        return None

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    plan = HaloPlan(send_idx=tuple(t(s) for s in d["send_idx"]),
                    recv_tgt=tuple(t(r) for r in d["recv_tgt"]),
                    offsets=tuple(d["offsets"]), n_local=d["n_local"],
                    n_ext=d["n_ext"])
    return DistMatrix(data=t(d["data"]), cols=t(d["cols"]),
                      row_nnz=t(d["row_nnz"]), halo=plan,
                      n_rows_local=d["n_rows_local"], K=d["K"],
                      shape=tuple(d["shape"]))


def _ell_from(d, device) -> EllMatrix:
    return EllMatrix(data=torch.from_numpy(d["data"]).to(device),
                     cols=torch.from_numpy(d["cols"]).to(device),
                     row_nnz=torch.from_numpy(d["row_nnz"]).to(device),
                     shape=tuple(d["shape"]), n_rows_pad=d["n_rows_pad"],
                     n_cols_pad=d["n_cols_pad"])


def hierarchy_from_tree(tree: dict, device) -> DistHierarchy:
    """The port's DistHierarchy from one rank's tree of
    ``dist_tree_from_jax``."""
    def opt(a):
        return None if a is None else torch.as_tensor(np.asarray(a), device=device)

    levels = tuple(DistLevel(
        A=_dm_from(lv["A"], device), dinv=opt(lv["dinv"]),
        Pmat=_dm_from(lv["P"], device), Rmat=_dm_from(lv["R"], device),
        cheb_lmax=opt(lv["cheb_lmax"]), n_local=lv["n_local"], n=lv["n"],
        color=opt(lv["color"]), ncolors=lv["ncolors"], binv=opt(lv.get("binv")))
        for lv in tree["levels"])
    return DistHierarchy(
        levels=levels, bridge_P=_ell_from(tree["bridge_P"], device),
        bridge_R=_ell_from(tree["bridge_R"], device),
        tail=algebraic_hierarchy_from_numpy(tree["tail"], device),
        config=AmgConfig(**tree["config"]), ndev=tree["ndev"])


def _case_split(ring: Ring, case: dict):
    """One splitting program on the rank's shard of the fine level."""
    cfg = AmgConfig(**case["cfg"])
    E = ell_from_csr(case["matrix"], dtype=np.float64,
                     row_pad_multiple=8 * ring.axis_size)
    n_pad = E.n_rows_pad
    perm = torch.from_numpy(_block(make_perm_np(E.shape[0], n_pad, cfg.seed),
                                   ring).copy())
    if case["split"] == "aggressive":
        cf, cc = ds._run_split_aggressive(ring, E.data, E.cols, E.row_nnz,
                                          perm, cfg, n_pad, E.shape[0], "cpu")
    else:
        dm = distribute_matrix(E, ring)
        if case["split"] == "cljp":
            gidx = torch.from_numpy(_block(np.arange(n_pad, dtype=np.int32),
                                           ring).copy())
            cf, cc = ds._run_split_cljp(ring, dm, perm, gidx, cfg, n_pad)
        else:
            cf, cc = ds._run_split(ring, dm, perm, cfg, n_pad)
    return {"cf": _np(cf), "cc": cc}


def _rhs(n_pad: int, n: int) -> torch.Tensor:
    b = torch.zeros(n_pad, dtype=torch.float64)
    b[:n] = torch.from_numpy(np.asarray(default_rhs(n), np.float64))
    return b


def _solve(dh: DistHierarchy, ring: Ring, n: int, maxiter: int) -> dict:
    b = _rhs(dh.levels[0].n_local * ring.axis_size, n)
    x, info = dist_solve(dh, b, ring, tol=1e-8, maxiter=maxiter)
    return {"x": _np(ring.all_gather(x)), "iterations": int(info.iterations),
            "relres": float(info.relres)}


def _case_build(ring: Ring, case: dict):
    """dist_build_hierarchy in fp64, optionally its solve and the solve of
    the reference's hierarchy carried across."""
    cfg = AmgConfig(**case["cfg"])
    t0 = time.perf_counter()
    dh = dist_build_hierarchy(case["matrix"], cfg, ring, case["tail_size"],
                              torch.float64, device="cpu")
    out = {"seconds": time.perf_counter() - t0, "dh": summary(dh, ring)}
    n = case["matrix"].shape[0]
    if case.get("solve"):
        out["solve"] = _solve(dh, ring, n, case.get("maxiter", 100))
    if case.get("carried"):
        carried = hierarchy_from_tree(case["carried"][ring.axis_index], "cpu")
        out["carried_solve"] = _solve(carried, ring, n, case.get("maxiter", 100))
    return out


def _case_error(ring: Ring, case: dict):
    """The ValueError a build raises, or None."""
    try:
        dist_build_hierarchy(case["matrix"], AmgConfig(**case["cfg"]), ring,
                             case["tail_size"], torch.float64, device="cpu")
    except ValueError as e:
        return str(e)
    return None


CASES = {"split": _case_split, "build": _case_build, "error": _case_error}


def run_cases(ring: Ring, device, cases: list) -> list:
    """Every case on the whole ring; a case with ``"solo": True`` runs on
    rank 0 alone (a ring of one, from a group of one rank), the other
    ranks return None for it."""
    solo = dist.new_group([0])
    out = []
    for case in cases:
        if not case.get("solo"):
            out.append(CASES[case["kind"]](ring, case))
        elif ring.axis_index == 0:
            out.append(CASES[case["kind"]](Ring(solo), case))
        else:
            out.append(None)
    return out
