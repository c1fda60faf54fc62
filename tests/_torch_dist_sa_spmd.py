"""Bodies of the spawned ranks of tests/test_torch_dist_sa.py.

Each case runs on the ranks of one ``raptor_tpu_torch.parallel.spawn`` run
and returns plain numpy data.  This module imports no JAX: a spawned child
imports it fresh, without the test conftest's JAX platform settings.

Case kinds:

* ``build``: ``dist_build_sa_hierarchy`` in fp64 on every rank, its
  summary (``tests/_torch_dist_setup_spmd.summary``), the aggregate vector
  the decision pass gave each sharded level, and its solve;
* ``error``: the ValueError a build raises;
* ``one_rank``: a build and its solve on a ring of one (rank ``on`` alone);
* ``single``: the port's single-device SA build (``setup/aggregation.py``)
  on rank ``on``, with no ring: its level sizes, the device route's
  aggregates of its fine level and the fp64 entry-sum fingerprint of its
  first coarse operator;
* ``carried``: ``dist_solve`` on the reference's hierarchies, whose
  per-rank trees (``tests/_torch_ref.dist_tree_from_jax``) the test
  process writes to ``path`` once its reference builds are done: the
  ranks build the port's side meanwhile and wait for the file here.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import _np, ell_from_csr
from raptor_tpu_torch.parallel import Ring, dist_build_sa_hierarchy
from raptor_tpu_torch.parallel import dist_sa
from raptor_tpu_torch.setup.aggregation import (aggregate, build_sa_hierarchy,
                                                nodal_condense,
                                                sa_strength_mask)
from tests._torch_dist_setup_spmd import _solve, hierarchy_from_tree, summary

CARRIED_WAIT = 240.0  # seconds the ranks wait for the reference's trees


def fingerprint(data, nnz, n: int) -> float:
    """The fp64 sum of an operator's real entries, its identity padding
    rows' ones taken off (the reference's own check,
    tests/distributed/test_dist_algebraic_setup.py:404-417)."""
    data, nnz = np.asarray(data, np.float64), np.asarray(nnz)
    m = np.arange(data.shape[0])[:, None] < nnz[None, :]
    return float(np.sum(np.where(m, data, 0.0)) - (data.shape[1] - n))


def _build(ring: Ring, case: dict):
    """The build with the decision pass's aggregate vectors recorded."""
    seen = []
    orig = dist_sa._host_aggregate

    def recording(*args):
        out = orig(*args)
        seen.append(out[0])
        return out

    dist_sa._host_aggregate = recording
    try:
        dh = dist_build_sa_hierarchy(
            case["matrix"], AmgConfig(**case["cfg"]), ring, B=case.get("B"),
            tail_size=case["tail_size"], dtype=torch.float64, device="cpu")
    finally:
        dist_sa._host_aggregate = orig
    return dh, seen[:len(dh.levels)]


def _case_build(ring: Ring, case: dict):
    t0 = time.perf_counter()
    dh, aggs = _build(ring, case)
    return {"seconds": time.perf_counter() - t0, "dh": summary(dh, ring),
            "aggs": aggs,
            "solve": _solve(dh, ring, case["matrix"].shape[0], 300)}


def _case_error(ring: Ring, case: dict):
    try:
        _build(ring, case)
    except ValueError as e:
        return str(e)
    return None


def _case_single(case: dict):
    cfg = dataclasses.replace(AmgConfig(**case["cfg"]), host_setup_threshold=0)
    A, B = case["matrix"], case.get("B")
    h = build_sa_hierarchy(A, cfg, dtype=np.float64, B=B, device="cpu")
    # the device route's aggregates of the fine level, on its own input
    nc = 1 if B is None else min(B.shape[1], cfg.num_candidates)
    bs = 3 if (nc >= 3 and A.shape[0] % 3 == 0) else 1
    mult = cfg.pad_multiple * bs // int(np.gcd(cfg.pad_multiple, bs))
    E = ell_from_csr(A, dtype=np.float64, row_pad_multiple=mult).to("cpu")
    C = nodal_condense(E, bs) if bs > 1 else E
    agg, _ = aggregate(C, sa_strength_mask(C, cfg.theta), cfg.seed)
    A1 = h.levels[1].A
    return {"sizes": [lv.n for lv in h.levels], "agg0": _np(agg),
            "fingerprint1": fingerprint(_np(A1.data), _np(A1.row_nnz),
                                        h.levels[1].n)}


def _case_carried(ring: Ring, case: dict):
    deadline = time.monotonic() + CARRIED_WAIT
    while not os.path.exists(case["path"]):
        if time.monotonic() > deadline:
            return None
        time.sleep(0.2)
    with open(case["path"], "rb") as f:
        trees = pickle.load(f)
    out = {}
    for name, (per_rank, n) in trees.items():
        dh = hierarchy_from_tree(per_rank[ring.axis_index], "cpu")
        out[name] = _solve(dh, ring, n, 300)
    return out


def run_cases(ring: Ring, device, cases: list) -> list:
    """Every case in order.  ``one_rank`` and ``single`` cases run on rank
    ``on`` alone (the other ranks return None and go on), so cases on
    different ranks run at the same time."""
    groups = {r: dist.new_group([r]) for r in range(ring.axis_size)}
    out = []
    for case in cases:
        kind, on = case["kind"], case.get("on")
        if on is not None and on != ring.axis_index:
            out.append(None)
        elif kind == "one_rank":
            out.append(_case_build(Ring(groups[on]), case))
        elif kind == "single":
            out.append(_case_single(case))
        elif kind == "carried":
            out.append(_case_carried(ring, case))
        else:
            out.append({"build": _case_build, "error": _case_error}[kind](ring, case))
    return out
