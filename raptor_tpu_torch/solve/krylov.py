"""Krylov solvers: preconditioned CG, BiCGStab and restarted (F)GMRES.

Counterpart of ``raptor_tpu/solve/krylov.py``.  The reference runs a whole
solve as one ``lax.while_loop`` with the convergence test on the device;
here the loops are Python and read the convergence flag on the host once
per iteration (GMRES: once per Arnoldi step), which keeps the iteration
counts identical.  Per-iteration relative residuals go into a NaN-padded
device tensor of length ``maxiter + 1``, and breakdown sets a status code.

Every solver takes ``dot_fn``, the inner product.  The default ``vdot`` is
``a @ b``: a dot product for two vectors, and the k dot products of a
(k, n) basis with one vector in a single call, which is how GMRES's
classical Gram-Schmidt passes use it.  The sharded solve passes a dot that
sums over the ring, so each of those passes is one collective.

``host_reads`` counts, by site, the host's reads of device values on the
solve path (each waits for the device's queue to drain): ``pcg``,
``bicgstab`` and ``gmres`` here, ``refine`` in the df64-refined solves'
outer loops, ``stationary`` in ``api.solve_hier``'s AMG iteration.
"""

from __future__ import annotations

import collections
import dataclasses
from functools import partial
from typing import Callable

import torch

from raptor_tpu_torch.utils.profiling import spanned

__all__ = ["KrylovInfo", "pcg", "bicgstab", "gmres", "krylov_dispatch",
           "vdot", "host_read", "host_reads", "STATUS_CONVERGED",
           "STATUS_MAXITER", "STATUS_BREAKDOWN"]

STATUS_CONVERGED = 0
STATUS_MAXITER = 1
STATUS_BREAKDOWN = 2

# reads of device values by the host on the solve path, by site
host_reads: collections.Counter = collections.Counter()


def host_read(site: str, t: torch.Tensor):
    """``t.tolist()``, counted in ``host_reads[site]``."""
    host_reads[site] += 1
    return t.tolist()


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


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``: the dot product of two vectors, or of each row of a
    (k, n) ``a`` with the vector ``b``."""
    return a @ b


def _nonzero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v != 0, v, torch.ones_like(v))


def _info(it: int, status: int, relres, hist, device) -> KrylovInfo:
    return KrylovInfo(
        iterations=torch.tensor(it, dtype=torch.int32, device=device),
        status=torch.tensor(status, dtype=torch.int32, device=device),
        relres=relres, res_hist=hist)


def krylov_dispatch(name: str, restart: int = 30) -> Callable:
    """Solver lookup shared by every engine: 'cg' | 'bicgstab' | 'gmres' |
    'fgmres'.  ``restart`` is the GMRES restart length (cg and bicgstab
    have none)."""
    table = {"cg": pcg, "bicgstab": bicgstab,
             "gmres": partial(gmres, restart=restart),
             "fgmres": partial(gmres, restart=restart, flexible=True)}
    if name not in table:
        raise ValueError(f"unknown krylov: {name!r} (one of {sorted(table)})")
    return table[name]


@spanned("pcg")
def pcg(
    apply_A: Callable,
    b: torch.Tensor,
    apply_M: Callable = _identity,
    tol: float | torch.Tensor = 1e-8,
    maxiter: int = 200,
    x0: torch.Tensor | None = None,
    dot_fn: Callable = vdot,
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
    rz = dot_fn(r, z)
    bnorm2 = dot_fn(b, b)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * bnorm2
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[0] = torch.sqrt(dot_fn(r, r) / bnorm2)
    status = STATUS_MAXITER
    it = 0
    while it < maxiter:
        Ap = apply_A(p)
        pAp = dot_fn(p, Ap)
        breakdown = pAp <= 0
        alpha = torch.where(breakdown, torch.zeros_like(pAp), rz / _nonzero(pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        rr = dot_fn(r, r)
        it += 1
        hist[it] = torch.sqrt(rr / bnorm2)
        flags = host_read("pcg", torch.stack([breakdown, rr <= tol2]))
        if flags[0]:
            status = STATUS_BREAKDOWN
            break
        if flags[1]:
            status = STATUS_CONVERGED
            break
        if it == maxiter:
            break
        z = apply_M(r)
        rz_new = dot_fn(r, z)
        beta = rz_new / _nonzero(rz)
        p = z + beta * p
        rz = rz_new
    return x, _info(it, status, torch.sqrt(dot_fn(r, r) / bnorm2), hist, b.device)


@spanned("bicgstab")
def bicgstab(
    apply_A: Callable,
    b: torch.Tensor,
    apply_M: Callable = _identity,
    tol: float | torch.Tensor = 1e-8,
    maxiter: int = 200,
    x0: torch.Tensor | None = None,
    dot_fn: Callable = vdot,
):
    """Preconditioned BiCGStab (right preconditioning). Returns
    (x, KrylovInfo).  Breakdown: |rhat . v| or |rhat . r| below 1e-30;
    convergence is tested first, as in the reference."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - apply_A(x) if x0 is not None else b
    rhat = r
    rho = dot_fn(rhat, r)
    p = r
    bnorm2 = dot_fn(b, b)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    tol2 = (tol * tol) * bnorm2
    eps = 1e-30
    hist = torch.full((maxiter + 1,), float("nan"), dtype=b.dtype, device=b.device)
    hist[0] = torch.sqrt(dot_fn(r, r) / bnorm2)
    status = STATUS_MAXITER
    it = 0
    while it < maxiter:
        ph = apply_M(p)
        v = apply_A(ph)
        rhv = dot_fn(rhat, v)
        bd1 = rhv.abs() < eps
        alpha = rho / _nonzero(rhv)
        sres = r - alpha * v
        sh = apply_M(sres)
        t = apply_A(sh)
        tt = dot_fn(t, t)
        omega = dot_fn(t, sres) / _nonzero(tt)
        x = x + alpha * ph + omega * sh
        r = sres - omega * t
        rr = dot_fn(r, r)
        it += 1
        hist[it] = torch.sqrt(rr / bnorm2)
        rho_new = dot_fn(rhat, r)
        bd2 = rho_new.abs() < eps
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p = r + beta * (p - omega * v)
        rho = rho_new
        converged, broke = host_read("bicgstab",
                                     torch.stack([rr <= tol2, bd1 | bd2]))
        if converged:
            status = STATUS_CONVERGED
            break
        if broke:
            status = STATUS_BREAKDOWN
            break
    return x, _info(it, status, torch.sqrt(dot_fn(r, r) / bnorm2), hist, b.device)


@spanned("gmres")
def gmres(
    apply_A: Callable,
    b: torch.Tensor,
    apply_M: Callable = _identity,
    tol: float | torch.Tensor = 1e-8,
    maxiter: int = 200,
    restart: int = 30,
    x0: torch.Tensor | None = None,
    dot_fn: Callable = vdot,
    flexible: bool = False,
):
    """Restarted GMRES(m) with right preconditioning. Returns (x, KrylovInfo).

    Orthogonalization is CGS2 (classical Gram-Schmidt, applied twice): each
    pass is one ``dot_fn`` of the whole (m+1, n) basis with the new vector,
    masked to the live rows.  Givens rotations and the triangular solve run
    in b's dtype on b's device.  The monitored residual |g[j+1]| is the true
    residual norm under right preconditioning.  ``flexible=True`` is FGMRES:
    the preconditioned directions are stored and the update uses them."""
    n = b.shape[0]
    m = int(min(restart, maxiter))
    dt, dev = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm2 = dot_fn(b, b)
    bnorm2 = torch.where(bnorm2 > 0, bnorm2, torch.ones_like(bnorm2))
    bnorm = torch.sqrt(bnorm2)
    tol_r = tol * bnorm
    eps = 1e-30
    hist = torch.full((maxiter + 1,), float("nan"), dtype=dt, device=dev)
    rows = torch.arange(m + 1, device=dev)
    idx = torch.arange(m, device=dev)
    it, status = 0, -1
    while status < 0 and it < maxiter:
        r = b - apply_A(x)
        beta = torch.sqrt(dot_fn(r, r))
        hist[it] = beta / bnorm
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = r / torch.where(beta > 0, beta, torch.ones_like(beta))
        Z = torch.zeros((m, n), dtype=dt, device=dev) if flexible else None
        R = torch.zeros((m + 1, m), dtype=dt, device=dev)
        cs = torch.zeros(m, dtype=dt, device=dev)
        sn = torch.zeros(m, dtype=dt, device=dev)
        g = torch.zeros(m + 1, dtype=dt, device=dev)
        g[0] = beta
        done = host_read("gmres", beta <= tol_r)
        j = 0
        while not done and j < m and it + j < maxiter:
            zj = apply_M(V[j])
            if flexible:
                Z[j] = zj
            w = apply_A(zj)
            mask = (rows <= j).to(dt)
            h = dot_fn(V, w) * mask
            w = w - h @ V
            h2 = dot_fn(V, w) * mask  # CGS2: one reorthogonalization pass
            w = w - h2 @ V
            h = h + h2
            hj1 = torch.sqrt(dot_fn(w, w))
            V[j + 1] = w / torch.where(hj1 > eps, hj1, torch.ones_like(hj1))
            h[j + 1] = hj1
            for i in range(j):  # the stored rotations, in order
                hi, hi1 = h[i].clone(), h[i + 1].clone()
                h[i] = cs[i] * hi + sn[i] * hi1
                h[i + 1] = -sn[i] * hi + cs[i] * hi1
            denom = torch.sqrt(h[j] ** 2 + h[j + 1] ** 2)
            safe = torch.where(denom > 0, denom, torch.ones_like(denom))
            c_new = torch.where(denom > eps, h[j] / safe, torch.ones_like(denom))
            s_new = torch.where(denom > eps, h[j + 1] / safe,
                                torch.zeros_like(denom))
            cs[j], sn[j] = c_new, s_new
            h[j], h[j + 1] = denom, 0.0
            R[:, j] = h
            res = (s_new * g[j]).abs()  # |g[j+1]| after the rotation
            gj = g[j].clone()
            g[j + 1] = -s_new * gj
            g[j] = c_new * gj
            hist[it + j + 1] = res / bnorm
            done = host_read("gmres", res <= tol_r)  # one a step
            j += 1
        # y = R[:m,:m]^{-1} g[:m] over the j steps taken: the unused columns
        # get 1 on the diagonal and 0 in g, so their y_i = 0
        Rm = R[:m, :m] + torch.diag((idx >= j).to(dt))
        gm = torch.where(idx < j, g[:m], torch.zeros_like(g[:m]))
        y = torch.linalg.solve_triangular(Rm, gm[:, None], upper=True)[:, 0]
        x = x + (y @ Z if flexible else apply_M(y @ V[:m]))
        it += j
        status = (STATUS_CONVERGED if done
                  else STATUS_BREAKDOWN if j == 0 else -1)
    if status < 0:
        status = STATUS_MAXITER
    r = b - apply_A(x)
    return x, _info(it, status, torch.sqrt(dot_fn(r, r) / bnorm2), hist, dev)
