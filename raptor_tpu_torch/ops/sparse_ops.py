"""Sparse linear algebra on padded-ELL matrices.

Counterpart of ``raptor_tpu/ops/sparse_ops.py``.  Only the gather SpMV is
ported: the solve path applies it on levels without a banded layout and to
the identity columns that fold the coarse tail.  It is plain PyTorch, as
the reference's is plain jnp (no Pallas kernel).  SpGEMM, transpose, add,
RAP and filtering serve the device-level setup, which is not ported yet.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.core.ell import EllMatrix

__all__ = ["spmv"]


def spmv(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  x has shape (..., n_cols_pad); y has (..., n_rows_pad):
    ``y[..., i] = sum_k data[k, i] * x[..., cols[k, i]]``.  Padding slots
    hold value 0 with a valid gather index, so no mask is needed."""
    return (A.data * x[..., A.cols]).sum(-2)
