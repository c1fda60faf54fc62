"""Smoothers, the V-/W-cycle and the Krylov solvers."""
from raptor_tpu_torch.solve.smoothers import (
    jacobi,
    multicolor_gs,
    chebyshev,
    estimate_lmax,
)
from raptor_tpu_torch.solve.cycle import cycle, make_preconditioner
from raptor_tpu_torch.solve.krylov import KrylovInfo, bicgstab, krylov_dispatch, pcg

__all__ = [
    "jacobi",
    "multicolor_gs",
    "chebyshev",
    "estimate_lmax",
    "cycle",
    "make_preconditioner",
    "pcg",
    "bicgstab",
    "KrylovInfo",
    "krylov_dispatch",
]
