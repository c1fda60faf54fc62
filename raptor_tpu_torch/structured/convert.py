"""Build the port's structured objects from plain NumPy data.

``hierarchy_from_numpy`` takes a hierarchy as a dict of NumPy arrays and
Python metadata (for example one exported from another implementation) and
returns an ``SHierarchy`` on ``device``, so two implementations can be run
on identical level data.  The layout of ``tree``:

    {"levels": [{"A": dia, "Pt": dia | None, "Rt": dia | None,
                 "dinv": array, "red": bool array, "cheb_lmax": array | None,
                 "dims": tuple, "cdim": int}, ...],
     "coarse_inv": array, "tail_op": array | None, "tail_start": int,
     "config": {AmgConfig field: value}}

with each ``dia`` a dict ``{"data", "offsets", "dims", "const_planes"}``.
Arrays may be bfloat16 arrays of the ``ml_dtypes`` kind: ``torch.from_numpy``
rejects those, so they go through float32 (exact) and back to bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.structured.dia import DiaMatrix
from raptor_tpu_torch.structured.solver import SHierarchy, SLevel

__all__ = ["dia_from_numpy", "hierarchy_from_numpy"]


def _tensor(a, device) -> torch.Tensor:
    """Copy of array ``a`` on ``device`` with the same dtype (bfloat16
    included)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                          dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def dia_from_numpy(data, offsets, dims, const_planes=None, *,
                   device) -> DiaMatrix:
    return DiaMatrix(
        data=_tensor(data, device),
        offsets=tuple(tuple(int(v) for v in o) for o in offsets),
        dims=tuple(int(d) for d in dims),
        const_planes=(None if const_planes is None
                      else tuple(float(c) for c in const_planes)),
    )


def _dia(d, device):
    return None if d is None else dia_from_numpy(
        d["data"], d["offsets"], d["dims"], d.get("const_planes"), device=device)


def _opt(a, device):
    return None if a is None else _tensor(a, device)


def hierarchy_from_numpy(tree: dict, device) -> SHierarchy:
    levels = tuple(
        SLevel(A=_dia(lv["A"], device), Pt=_dia(lv["Pt"], device),
               Rt=_dia(lv["Rt"], device),
               dinv=_tensor(lv["dinv"], device),
               red=_tensor(lv["red"], device),
               cheb_lmax=_opt(lv["cheb_lmax"], device),
               dims=tuple(int(d) for d in lv["dims"]), cdim=int(lv["cdim"]))
        for lv in tree["levels"]
    )
    return SHierarchy(levels=levels,
                      coarse_inv=_tensor(tree["coarse_inv"], device),
                      config=AmgConfig(**tree["config"]),
                      tail_op=_opt(tree["tail_op"], device),
                      tail_start=int(tree["tail_start"]))
