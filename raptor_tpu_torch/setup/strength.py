"""Strength of connection on padded-ELL operators.

Counterpart of ``raptor_tpu/setup/strength.py``.  The strength graph is a
boolean slot mask aligned with ``A.data`` ((K, n_pad)), so every consumer
combines it with ``A.cols`` directly.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.core.ell import EllMatrix

__all__ = ["strength_mask", "strong_transpose_counts"]


def strength_mask(A: EllMatrix, theta: float,
                  kind: str = "classical") -> torch.Tensor:
    """(K, n_pad) bool: slot (k, i) True iff entry a_ij is a strong
    connection.

    classical: -a_ij >= theta * max_k(-a_ik)   (only negative couplings)
    abs:      |a_ij| >= theta * max_k |a_ik|   (symmetric variant)
    """
    off = (A.cols != A.row_index()) & A.slot_mask()
    if kind == "classical":
        v = torch.where(off, -A.data, float("-inf"))
        row_max = v.amax(0)
        return off & (v >= theta * row_max) & (row_max > 0) & (v > 0)
    if kind == "abs":
        v = torch.where(off, A.data.abs(), 0)
        row_max = v.amax(0)
        return off & (v >= theta * row_max) & (v > 0)
    raise ValueError(f"unknown strength kind: {kind}")


def strong_transpose_counts(A: EllMatrix, smask: torch.Tensor) -> torch.Tensor:
    """lambda_i = |S^T_i|: how many points strongly depend on i (int32)."""
    m = A.n_cols_pad
    tgt = torch.where(smask & (A.cols < m), A.cols, m).long().reshape(-1)
    counts = torch.zeros(m + 1, dtype=torch.int32, device=tgt.device)
    counts.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return counts[:m]
