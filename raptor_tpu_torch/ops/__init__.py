"""Sparse operations of the algebraic engine (SpMV, transpose, SpGEMM,
filtering, RAP) and the hand-written CUDA kernels under ``ops/cuda``."""
from raptor_tpu_torch.ops.sparse_ops import (
    spmv,
    spmv_t,
    ell_transpose,
    ell_transpose_fixed,
    spgemm,
    spgemm_fixed,
    ell_add,
    ell_add_fixed,
    ell_filter,
    rap,
)

__all__ = [
    "spmv",
    "spmv_t",
    "ell_transpose",
    "ell_transpose_fixed",
    "spgemm",
    "spgemm_fixed",
    "ell_add",
    "ell_add_fixed",
    "ell_filter",
    "rap",
]
