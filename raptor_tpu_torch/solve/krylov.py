"""Krylov solvers: preconditioned CG.

Counterpart of ``raptor_tpu/solve/krylov.py``.  The reference runs a whole
solve as one ``lax.while_loop`` with the convergence test on the device;
here the loop is Python and reads the convergence flag on the host once per
iteration, which keeps the iteration counts identical.  Per-iteration
relative residuals go into a NaN-padded device tensor of length
``maxiter + 1``, and breakdown (p^T A p <= 0) sets a status code.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["KrylovInfo", "pcg", "krylov_dispatch", "STATUS_CONVERGED",
           "STATUS_MAXITER", "STATUS_BREAKDOWN"]

STATUS_CONVERGED = 0
STATUS_MAXITER = 1
STATUS_BREAKDOWN = 2

_NOT_PORTED = ("bicgstab", "gmres", "fgmres")


@dataclasses.dataclass(frozen=True)
class KrylovInfo:
    iterations: torch.Tensor  # int32
    status: torch.Tensor  # int32, STATUS_*
    relres: torch.Tensor  # final relative residual
    res_hist: torch.Tensor  # (maxiter+1,) relative residual per iteration (nan-padded)

    def to(self, device) -> "KrylovInfo":
        return KrylovInfo(*(getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)))


def _identity(r):
    return r


def krylov_dispatch(name: str) -> Callable:
    """Solver lookup by name; only 'cg' is ported so far."""
    if name == "cg":
        return pcg
    if name in _NOT_PORTED:
        raise ValueError(f"krylov {name!r} not yet ported (only 'cg')")
    raise ValueError(f"unknown krylov: {name!r} (one of cg, {', '.join(_NOT_PORTED)})")


def pcg(
    apply_A: Callable,
    b: torch.Tensor,
    apply_M: Callable = _identity,
    tol: float | torch.Tensor = 1e-8,
    maxiter: int = 200,
    x0: torch.Tensor | None = None,
):
    """Preconditioned conjugate gradients. Returns (x, KrylovInfo).

    Convergence test: ||r||_2 <= tol * ||b||_2.  ``tol`` may be a 0-d tensor
    (the refined solve passes its inner tolerance in b's dtype).  The
    preconditioner is not applied after the final iteration: its result
    would not be read."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    z = apply_M(r)
    p = z
    rz = torch.dot(r, z)
    bnorm2 = torch.dot(b, b)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * bnorm2
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[0] = torch.sqrt(torch.dot(r, r) / bnorm2)
    status = STATUS_MAXITER
    it = 0
    while it < maxiter:
        Ap = apply_A(p)
        pAp = torch.dot(p, Ap)
        breakdown = pAp <= 0
        alpha = torch.where(breakdown, torch.zeros_like(pAp),
                            rz / torch.where(pAp != 0, pAp, torch.ones_like(pAp)))
        x = x + alpha * p
        r = r - alpha * Ap
        rr = torch.dot(r, r)
        it += 1
        hist[it] = torch.sqrt(rr / bnorm2)
        flags = torch.stack([breakdown, rr <= tol2]).tolist()  # one host read
        if flags[0]:
            status = STATUS_BREAKDOWN
            break
        if flags[1]:
            status = STATUS_CONVERGED
            break
        if it == maxiter:
            break
        z = apply_M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, torch.ones_like(rz))
        p = z + beta * p
        rz = rz_new
    info = KrylovInfo(
        iterations=torch.tensor(it, dtype=torch.int32, device=b.device),
        status=torch.tensor(status, dtype=torch.int32, device=b.device),
        relres=torch.sqrt(torch.dot(r, r) / bnorm2),
        res_hist=hist,
    )
    return x, info
