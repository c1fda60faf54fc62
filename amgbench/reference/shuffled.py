"""The shuffled 7-point Poisson matrix, assembled by SciPy (the reference
bench's input: the natural-ordered operator symmetrically permuted by
``default_rng(0)``), and its fp64 residual."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def poisson7_csr(n: int) -> sp.csr_matrix:
    """The 7-point Laplacian on n^3 (last index fastest), fp64 CSR."""
    e = np.ones(n)
    T = sp.diags([-e[:-1], 2 * e, -e[:-1]], [-1, 0, 1], format="csr")
    I = sp.identity(n, format="csr")
    A = (sp.kron(sp.kron(T, I), I) + sp.kron(sp.kron(I, T), I)
         + sp.kron(sp.kron(I, I), T))
    A = A.tocsr()
    A.sort_indices()
    return A


def permutation(n_rows: int, perm_seed: int) -> np.ndarray:
    return np.random.default_rng(perm_seed).permutation(n_rows)


def shuffled_poisson7(n: int, perm_seed: int = 0) -> sp.csr_matrix:
    """P A P^T for the 7-point Laplacian on n^3, P from default_rng(seed)."""
    A = poisson7_csr(n)
    p = permutation(A.shape[0], perm_seed)
    B = A[p][:, p].tocsr()
    B.sort_indices()
    return B


def relres(A: sp.csr_matrix, x64: np.ndarray, b64: np.ndarray) -> float:
    """||b - A x|| / ||b|| in fp64."""
    r = b64 - A @ x64
    return float(np.linalg.norm(r) / np.linalg.norm(b64))
