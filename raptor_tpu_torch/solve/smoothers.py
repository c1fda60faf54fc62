"""Smoothers on padded-ELL operators: weighted Jacobi, Chebyshev and
fourth-kind Chebyshev.

Counterpart of ``raptor_tpu/solve/smoothers.py``.  Vectors may carry a
leading batch dimension (B, n): ``solve/cycle.materialize_tail`` smooths
every identity column at once.  ``x0_zero`` asserts x == 0 on entry, so the
first residual is exactly ``b`` and one operator apply is saved.
``estimate_lmax`` gives the Chebyshev smoothers their eigenvalue bound on
levels built on the device.

Multicolor and two-stage Gauss-Seidel and the block smoothers are not
ported yet (``NOT_PORTED``).
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.ops.sparse_ops import spmv

__all__ = ["jacobi", "chebyshev", "chebyshev4", "estimate_lmax", "NOT_PORTED"]

# the reference's other smoothers; setup and the cycle raise for them
NOT_PORTED = ("mcgs", "tsgs", "block_jacobi", "block_cheb")


def jacobi(A: EllMatrix, dinv, b, x, omega: float = 2.0 / 3.0,
           sweeps: int = 1, x0_zero: bool = False) -> torch.Tensor:
    """x <- x + omega D^{-1} (b - A x), ``sweeps`` times."""
    if x0_zero and sweeps:
        x = omega * dinv * b
        sweeps -= 1
    for _ in range(sweeps):
        x = x + omega * dinv * (b - spmv(A, x))
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
