"""Sparse matrix containers of the algebraic engine."""
