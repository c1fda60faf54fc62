"""Sparse matrix containers of the algebraic engine."""
from raptor_tpu_torch.core.ell import EllMatrix, ell_from_csr, ell_to_csr, pad_rows, pad_vector

__all__ = ["EllMatrix", "ell_from_csr", "ell_to_csr", "pad_rows", "pad_vector"]
