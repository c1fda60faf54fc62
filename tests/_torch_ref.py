"""Shared helpers for the raptor_tpu_torch tests: stencils, the numpy
bridge from a JAX ``SHierarchy`` to the port's ``hierarchy_from_numpy``
tree, and error measures.  Data passes between the packages as numpy."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch


def cuda_device() -> torch.device:
    """The card for a ``cuda``-marked test; skips (decided at run time,
    never at import) when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def stencil_7pt() -> np.ndarray:
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    return st


def stencil_5pt() -> np.ndarray:
    return np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], float)


def np32(a) -> np.ndarray:
    """float32 (bf16 widened exactly) numpy copy of a JAX or torch array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _dia_tree(m):
    if m is None:
        return None
    return {"data": np.asarray(m.data), "offsets": m.offsets, "dims": m.dims,
            "const_planes": m.const_planes}


def tree_from_jax(hier) -> dict:
    """The plain-numpy tree of a JAX ``SHierarchy`` (bf16 arrays stay
    ml_dtypes bf16; the port's converter widens them exactly)."""
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return {
        "levels": [
            {"A": _dia_tree(lv.A), "Pt": _dia_tree(lv.Pt), "Rt": _dia_tree(lv.Rt),
             "dinv": np.asarray(lv.dinv), "red": np.asarray(lv.red),
             "cheb_lmax": opt(lv.cheb_lmax), "dims": lv.dims, "cdim": lv.cdim}
            for lv in hier.levels
        ],
        "coarse_inv": np.asarray(hier.coarse_inv),
        "tail_op": opt(hier.tail_op),
        "tail_start": hier.tail_start,
        "config": dataclasses.asdict(hier.config),
    }
