"""Matrix-free fp64 residual of a constant-coefficient 3D stencil with
Dirichlet truncation (a neighbour outside the grid is dropped), for numpy
arrays or torch tensors alike (basic slicing only)."""

from __future__ import annotations

import numpy as np


def poisson7(shift: float = 0.0) -> np.ndarray:
    """(3, 3, 3) 7-point Laplacian with the diagonal 6 + shift, every entry
    rounded to fp32, the precision in which the operator is given."""
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0 + shift
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    return st.astype(np.float32).astype(np.float64)


def stencil_entries(stencil: np.ndarray) -> list:
    """[(offset, value)] of the stencil's non-zero entries, in
    ``np.ndindex`` order, offsets relative to the centre."""
    stencil = np.asarray(stencil)
    centre = [s // 2 for s in stencil.shape]
    return [(tuple(i - c for i, c in zip(idx, centre)), float(stencil[idx]))
            for idx in np.ndindex(*stencil.shape) if stencil[idx] != 0.0]


def apply(stencil: np.ndarray, x, dims):
    """A x for x of length prod(dims), in x's own type and precision."""
    X = x.reshape(tuple(dims))
    Y = X * 0
    for off, v in stencil_entries(stencil):
        dst, src = [], []
        for o, n in zip(off, dims):
            dst.append(slice(max(0, -o), n - max(0, o)))
            src.append(slice(max(0, o), n - max(0, -o)))
        Y[tuple(dst)] += v * X[tuple(src)]
    return Y.reshape(-1)


def relres(stencil: np.ndarray, x64, b64, dims) -> float:
    """||b - A x|| / ||b|| with x and b given in fp64."""
    r = b64 - apply(stencil, x64, dims)
    return float((r * r).sum() ** 0.5 / (b64 * b64).sum() ** 0.5)
