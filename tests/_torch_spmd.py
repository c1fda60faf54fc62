"""Bodies of the spawned ranks of tests/test_torch_sdist.py.

Each function runs on every rank of a ``raptor_tpu_torch.parallel.spawn``
run and returns plain numpy data.  This module imports no JAX: a spawned
child imports it fresh, without the test conftest's JAX platform settings.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.parallel import Ring
from raptor_tpu_torch.structured.dia import dia_from_stencil
from raptor_tpu_torch.structured.dist import (
    distribute_structured,
    gather,
    sdist_solve,
)
from raptor_tpu_torch.structured.dist_setup import sdist_build_hierarchy


def _tree(m):
    return None if m is None else {"data": m.data.numpy(), "offsets": m.offsets,
                                   "dims": m.dims}


def _levels(dh) -> dict:
    """The rank's blocks of every sharded level and the whole tail."""
    opt = lambda t: None if t is None else t.numpy()  # noqa: E731
    return {
        "levels": [{"A": _tree(lv.A), "Pt": _tree(lv.Pt), "Rt": _tree(lv.Rt),
                    "dinv": lv.dinv.numpy(), "red": lv.red.numpy(),
                    "cheb_lmax": opt(lv.cheb_lmax), "dims_local": lv.dims_local,
                    "cdim": lv.cdim} for lv in dh.levels],
        "tail": [_tree(lv.A) for lv in dh.tail.levels],
        "tail_op": opt(dh.tail.tail_op),
        "tail_start": dh.tail.tail_start,
    }


def _operator(case: dict):
    return dia_from_stencil(np.asarray(case["stencil"]), case["dims"],
                            dtype=torch.float64, device="cpu")


def _run_case(ring: Ring, case: dict):
    A = _operator(case)
    cfg = AmgConfig(**case["cfg"])
    kind = case["kind"]
    if kind == "distribute":
        return _levels(distribute_structured(A, cfg, ring, case["policy"],
                                             case["tail_size"]))
    if kind == "setup":
        return _levels(sdist_build_hierarchy(A, cfg, ring, case["policy"],
                                             case["tail_size"]))
    dh = distribute_structured(A, cfg, ring, "size", case["tail_size"])
    b = default_rhs(A.n, dtype=np.float64)
    x, info = sdist_solve(dh, b, ring, tol=1e-8, maxiter=case["maxiter"],
                          krylov=case.get("krylov", "cg"))
    return {"x": gather(x, ring).numpy(), "iterations": int(info.iterations),
            "relres": float(info.relres), "status": int(info.status),
            "n_sharded": len(dh.levels)}


def run_cases(ring: Ring, device, cases: list) -> list:
    """Every case on the whole ring; a case with ``"solo": True`` runs on
    each rank alone (a ring of one, from a group of one rank)."""
    solos = [dist.new_group([r]) for r in range(ring.axis_size)]
    solo = Ring(solos[ring.axis_index])
    out = []
    for case in cases:
        out.append(_run_case(solo if case.get("solo") else ring, case))
    return out


def hang_right_neighbour(ring: Ring, device) -> None:
    """Rank 0 shifts right and waits for rank 1's message, which rank 1
    never posts."""
    if ring.axis_index == 0:
        ring.shift_right(torch.ones(4))
    else:
        time.sleep(3600)


def fail_on_rank_one(ring: Ring, device) -> int:
    if ring.axis_index == 1:
        raise ValueError("rank 1 stops here")
    return ring.axis_index
