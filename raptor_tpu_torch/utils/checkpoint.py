"""Hierarchy and solver-state checkpoints.

Counterpart of ``raptor_tpu/utils/checkpoint.py``.  Setup is the phase
worth caching.  A checkpoint is one ``torch.save`` file holding a list of
tensors (NumPy leaves stored as tensors) and a JSON string that describes
the structure around them: tuples, lists, dicts, plain scalars, torch
dtypes and the package's own dataclasses by name with their fields.  It
loads with ``torch.load(weights_only=True)`` only, which admits tensors and
plain containers and refuses every other global, so no class of the package
(and nothing else) is ever unpickled: the dataclasses are rebuilt from the
JSON description through a fixed table of names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "save_hierarchy", "load_hierarchy"]

FORMAT = "raptor_tpu_torch.checkpoint/1"
_SUFFIX = ".pt"


def _classes() -> dict:
    """The dataclasses a checkpoint may name, by class name."""
    from raptor_tpu_torch.config import AmgConfig, SolveConfig
    from raptor_tpu_torch.core.bell import BlockEllMatrix
    from raptor_tpu_torch.core.ell import EllMatrix
    from raptor_tpu_torch.core.hybrid import (BandedMatrix, FarBlock,
                                              GeoTransfer, HybridMatrix,
                                              RectBanded)
    from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level
    from raptor_tpu_torch.solve.krylov import KrylovInfo
    from raptor_tpu_torch.structured.dia import DiaMatrix
    from raptor_tpu_torch.structured.solver import SHierarchy, SLevel

    return {c.__name__: c for c in (
        AmgConfig, SolveConfig, BlockEllMatrix, EllMatrix, BandedMatrix,
        FarBlock, GeoTransfer, HybridMatrix, RectBanded, Hierarchy, Level,
        KrylovInfo, DiaMatrix, SHierarchy, SLevel)}


def _store(t: torch.Tensor, tensors: list) -> int:
    """Append ``t`` on the host with its strides (a transposed operator
    keeps its layout, so its products keep their bits); a view of a larger
    storage is copied to its own bytes."""
    t = t.detach().cpu()
    if t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone(memory_format=torch.preserve_format)
    tensors.append(t)
    return len(tensors) - 1


def _encode(obj, tensors: list, classes: dict):
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        return {"t": _store(obj, tensors)}
    if isinstance(obj, np.ndarray):
        from raptor_tpu_torch.core.ell import to_tensor

        return {"np": _store(to_tensor(obj, "cpu"), tensors)}
    if isinstance(obj, np.generic):
        return {"npscalar": obj.dtype.str, "v": obj.item()}
    if isinstance(obj, torch.dtype):
        return {"dtype": str(obj).removeprefix("torch.")}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        name = type(obj).__name__
        if classes.get(name) is not type(obj):
            raise TypeError(f"cannot checkpoint a {type(obj).__qualname__}")
        return {"dc": name, "f": {f.name: _encode(getattr(obj, f.name),
                                                  tensors, classes)
                                  for f in dataclasses.fields(obj)}}
    if isinstance(obj, tuple):
        return {"tuple": [_encode(v, tensors, classes) for v in obj]}
    if isinstance(obj, list):
        return {"list": [_encode(v, tensors, classes) for v in obj]}
    if isinstance(obj, dict):
        return {"dict": [[_encode(k, tensors, classes),
                          _encode(v, tensors, classes)]
                         for k, v in obj.items()]}
    raise TypeError(f"cannot checkpoint a {type(obj).__qualname__}")


def _decode(d, tensors: list, classes: dict, device):
    if not isinstance(d, dict):
        return d

    def dec(v):
        return _decode(v, tensors, classes, device)

    if "t" in d:
        return tensors[d["t"]].to(device)
    if "np" in d:
        t = tensors[d["np"]]
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if "npscalar" in d:
        return np.dtype(d["npscalar"]).type(d["v"])
    if "dtype" in d:
        dt = getattr(torch, d["dtype"], None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"checkpoint names no torch dtype: {d['dtype']!r}")
        return dt
    if "dc" in d:
        if d["dc"] not in classes:
            raise ValueError(f"checkpoint names an unknown class {d['dc']!r}")
        return classes[d["dc"]](**{k: dec(v) for k, v in d["f"].items()})
    if "tuple" in d:
        return tuple(dec(v) for v in d["tuple"])
    if "list" in d:
        return [dec(v) for v in d["list"]]
    if "dict" in d:
        return {_freeze(dec(k)): dec(v) for k, v in d["dict"]}
    raise ValueError(f"malformed checkpoint entry: {sorted(d)}")


def _freeze(k):
    return tuple(_freeze(v) for v in k) if isinstance(k, list) else k


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors, arrays, scalars, containers and the
    package's dataclasses) to ``path + '.pt'``."""
    tensors: list = []
    meta = _encode(tree, tensors, _classes())
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    torch.save({"format": FORMAT, "meta": json.dumps(meta),
                "tensors": tensors}, path + _SUFFIX)


def load_pytree(path: str, device="cpu") -> Any:
    """Read a ``save_pytree`` file; tensor leaves land on ``device``, NumPy
    leaves stay NumPy.  Raises on any file that holds more than tensors and
    plain containers (``weights_only=True``)."""
    blob = torch.load(path + _SUFFIX, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path + _SUFFIX}: not a {FORMAT} checkpoint")
    return _decode(json.loads(blob["meta"]), blob["tensors"], _classes(),
                   device)


def save_hierarchy(path: str, hier) -> None:
    """Checkpoint a built hierarchy (``Hierarchy`` or ``SHierarchy``)."""
    save_pytree(path, hier)


def load_hierarchy(path: str, device):
    """Load a ``save_hierarchy`` checkpoint onto ``device``."""
    hier = load_pytree(path, device="cpu")
    return hier.to(device)
