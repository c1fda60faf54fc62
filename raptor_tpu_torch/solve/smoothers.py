"""Smoothers on padded-ELL operators: weighted Jacobi, multicolor and
two-stage Gauss-Seidel, Chebyshev and fourth-kind Chebyshev.

Counterpart of ``raptor_tpu/solve/smoothers.py``.  Vectors may carry a
leading batch dimension (B, n): ``solve/cycle.materialize_tail`` smooths
every identity column at once.  ``x0_zero`` asserts x == 0 on entry, so the
first residual is exactly ``b`` and one operator apply is saved.
``estimate_lmax`` gives the Chebyshev smoothers their eigenvalue bound on
levels built on the device; ``greedy_coloring_host`` colours a level for
the multicolor smoother at setup.  The block smoothers are in
``core/bell.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.ops.sparse_ops import spmv

__all__ = ["jacobi", "multicolor_gs", "two_stage_gs", "triangular_apply",
           "chebyshev", "chebyshev4", "estimate_lmax", "greedy_coloring_host"]


def jacobi(A: EllMatrix, dinv, b, x, omega: float = 2.0 / 3.0,
           sweeps: int = 1, x0_zero: bool = False) -> torch.Tensor:
    """x <- x + omega D^{-1} (b - A x), ``sweeps`` times."""
    if x0_zero and sweeps:
        x = omega * dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        x = x + omega * dinv * (b - spmv(A, x))
    return x


def multicolor_gs(A: EllMatrix, dinv, b, x, color, ncolors: int,
                  sweeps: int = 1, backward: bool = False,
                  x0_zero: bool = False) -> torch.Tensor:
    """Multicolor Gauss-Seidel: per colour c, x_c <- x_c + (D^{-1}(b - Ax))_c.

    With 2 colours on a bipartite stencil graph this is red-black GS.
    ``backward`` reverses the colour order, so a forward-pre /
    backward-post pair keeps the V-cycle symmetric for CG.  With
    ``x0_zero`` the first colour of the first sweep sees r = b."""
    order = list(range(ncolors))
    if backward:
        order.reverse()
    if x0_zero and sweeps:
        x = torch.where(color == order[0], dinv * b, torch.zeros_like(b))
        for c in order[1:]:
            x = x + torch.where(color == c, dinv * (b - spmv(A, x)), 0)
        sweeps -= 1
    for _ in range(sweeps):
        for c in order:
            x = x + torch.where(color == c, dinv * (b - spmv(A, x)), 0)
    return x


def triangular_apply(A: EllMatrix, x, upper: bool,
                     col_bound: int | None = None) -> torch.Tensor:
    """y = L @ x (strict lower triangle) or U @ x (strict upper): a masked
    ELL SpMV.  Padding slots have ``col == row`` or value 0, so the strict
    tests drop them.  ``col_bound`` further keeps only columns < bound (the
    sharded smoother masks halo columns out of the triangle)."""
    rows = A.row_index()
    mask = (A.cols > rows) if upper else (A.cols < rows)
    if col_bound is not None:
        mask = mask & (A.cols < col_bound)
    return spmv(dataclasses.replace(A, data=torch.where(mask, A.data, 0)), x)


def two_stage_gs(A: EllMatrix, dinv, b, x, sweeps: int = 1, inner: int = 2,
                 backward: bool = False,
                 x0_zero: bool = False) -> torch.Tensor:
    """Two-stage Gauss-Seidel: the triangular solve of a GS sweep,
    x <- x + (D+L)^{-1} (b - A x), replaced by ``inner`` Jacobi iterations
    on the triangular system,

        z_0 = D^{-1} r,   z_{j+1} = D^{-1} (r - L z_j),

    with the strict upper triangle when ``backward``.  With ``x0_zero`` the
    first outer residual is b."""
    def inner_series(r):
        z = dinv * r
        for _ in range(inner):
            z = dinv * (r - triangular_apply(A, z, upper=backward))
        return z

    if x0_zero and sweeps:
        x = inner_series(b)
        sweeps -= 1
    for _ in range(sweeps):
        x = x + inner_series(b - spmv(A, x))
    return x


def chebyshev(A: EllMatrix, dinv, b, x, lmin, lmax, degree: int = 3,
              x0_zero: bool = False) -> torch.Tensor:
    """Chebyshev polynomial smoothing on D^{-1}A over [lmin, lmax]
    (three-term semi-iteration, diagonally preconditioned)."""
    d = (lmax + lmin) / 2
    c = (lmax - lmin) / 2
    p = torch.zeros_like(x)
    alpha = torch.zeros_like(d)
    for i in range(degree):
        z = dinv * b if (x0_zero and i == 0) else dinv * (b - spmv(A, x))
        if i == 0:
            p = z
            alpha = 1.0 / d
        else:
            beta = (c * alpha / 2) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = z + beta * p
        x = x + alpha * p
    return x


def chebyshev4(A: EllMatrix, dinv, b, x, lmax, degree: int = 3,
               x0_zero: bool = False) -> torch.Tensor:
    """Fourth-kind Chebyshev smoother:

        d_1 = (4/3) / lmax * D^{-1} r
        d_k = (2k-3)/(2k+1) d_{k-1} + (8k-4)/((2k+1) lmax) D^{-1} r_k
    """
    r = b if x0_zero else b - spmv(A, x)
    d = (4.0 / 3.0) / lmax * (dinv * r)
    x = x + d
    for k in range(2, degree + 1):
        r = r - spmv(A, d)
        d = ((2 * k - 3) / (2 * k + 1)) * d + (
            (8 * k - 4) / ((2 * k + 1)) / lmax
        ) * (dinv * r)
        x = x + d
    return x


def estimate_lmax(A: EllMatrix, dinv, iters: int = 40,
                  safety: float = 1.1) -> torch.Tensor:
    """Largest eigenvalue of D^{-1}A by ``iters`` rounds of power iteration
    from the deterministic start ``sin(0.7511 i) + 0.01``, times
    ``safety`` (0-d tensor on A's device, no host read)."""
    i = torch.arange(A.n_rows_pad, dtype=A.dtype, device=A.data.device)
    v = torch.sin(i * 0.7511) + 0.01
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = dinv * spmv(A, v)
        v = w / torch.linalg.norm(w)
    w = dinv * spmv(A, v)
    return safety * torch.dot(v, w) / torch.dot(v, v)


def greedy_coloring_host(indptr, indices, n) -> tuple:
    """Greedy graph colouring in natural order (setup only): 2 colours,
    red-black, on a bipartite stencil graph.  Returns (colour array,
    ncolors).  Runs the native kernel when it builds, else the loop below,
    which gives the same colours."""
    from raptor_tpu_torch.utils.native import greedy_coloring_native

    out = greedy_coloring_native(indptr, indices, n)
    if out is not None:
        return out
    return _greedy_coloring_py(indptr, indices, n)


def _greedy_coloring_py(indptr, indices, n) -> tuple:
    color = -np.ones(n, dtype=np.int32)
    for i in range(n):
        nbr = indices[indptr[i]: indptr[i + 1]]
        used = set(color[nbr[nbr < i]].tolist()) if nbr.size else set()
        c = 0
        while c in used:
            c += 1
        color[i] = c
    return color, int(color.max()) + 1
