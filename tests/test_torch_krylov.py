"""raptor_tpu_torch.solve.krylov against the JAX package's solvers on a DIA
Poisson operator with a Jacobi preconditioner: equal iteration counts and
status, residual histories within 1e-4 relative (fp32 dot products summed
in another order drift by a few ulps per iteration).  BiCGStab, (F)GMRES
and PCG with a caller's ``dot_fn`` run in float64 on the 16^3 operator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.structured.dia as jdia
import raptor_tpu_torch.structured.dia as tdia
from raptor_tpu.solve.krylov import bicgstab as jbicgstab
from raptor_tpu.solve.krylov import gmres as jgmres
from raptor_tpu.solve.krylov import pcg as jpcg
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.solve.krylov import (
    STATUS_BREAKDOWN,
    STATUS_CONVERGED,
    STATUS_MAXITER,
    KrylovInfo,
    bicgstab,
    gmres,
    krylov_dispatch,
    pcg,
)
from tests._torch_ref import rel_err, stencil_5pt, stencil_7pt

HIST_TOL = 1e-4


def _problem(dims):
    st = stencil_7pt() if len(dims) == 3 else stencil_5pt()
    JA = jdia.dia_from_stencil(st, dims, dtype=jnp.float32)
    TA = tdia.dia_from_stencil(st, dims, device="cpu")
    b = default_rhs(TA.n, dtype=np.float32)
    return JA, TA, b


def _run_both(dims, x0=None, **kw):
    JA, TA, b = _problem(dims)
    jdinv = 1.0 / JA.diagonal()
    tdinv = 1.0 / TA.diagonal()
    jx0 = None if x0 is None else jnp.asarray(x0)
    tx0 = None if x0 is None else torch.from_numpy(x0)
    xj, ij = jpcg(lambda v: jdia.dia_spmv(JA, v), jnp.asarray(b),
                  lambda r: jdinv * r, x0=jx0, **kw)
    xt, it = pcg(lambda v: tdia.dia_spmv(TA, v), torch.from_numpy(b),
                 lambda r: tdinv * r, x0=tx0, **kw)
    return (xj, ij), (xt, it)


def _same_info(it, ij):
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status)
    ht, hj = it.res_hist.numpy(), np.asarray(ij.res_hist)
    assert ht.shape == hj.shape
    assert np.array_equal(np.isnan(ht), np.isnan(hj))
    ok = ~np.isnan(hj)
    assert np.all(np.abs(ht[ok] - hj[ok]) <= HIST_TOL * np.abs(hj[ok]))


@pytest.mark.parametrize("dims,tol", [((16, 16, 16), 1e-6), ((32, 32), 1e-5)])
def test_pcg_matches_jax(dims, tol):
    (xj, ij), (xt, it) = _run_both(dims, tol=tol, maxiter=200)
    assert int(it.status) == STATUS_CONVERGED
    _same_info(it, ij)
    assert rel_err(xt.numpy(), xj) <= HIST_TOL
    assert float(it.relres) <= tol


def test_pcg_maxiter_and_x0_match_jax():
    x0 = np.random.default_rng(0).standard_normal(16 * 16).astype(np.float32)
    (xj, ij), (xt, it) = _run_both((16, 16), x0=x0, tol=1e-12, maxiter=5)
    assert int(it.status) == STATUS_MAXITER and int(it.iterations) == 5
    _same_info(it, ij)
    assert rel_err(xt.numpy(), xj) <= HIST_TOL


def test_pcg_breakdown_matches_jax():
    b = default_rhs(64, dtype=np.float32)
    _, ij = jpcg(lambda v: -v, jnp.asarray(b), tol=1e-8, maxiter=10)
    _, it = pcg(lambda v: -v, torch.from_numpy(b), tol=1e-8, maxiter=10)
    assert int(it.status) == STATUS_BREAKDOWN
    _same_info(it, ij)


def test_pcg_skips_the_unused_last_preconditioner():
    _, TA, b = _problem((12, 12))
    calls = []

    def apply_M(r):
        calls.append(1)
        return r / 4.0

    _, info = pcg(lambda v: tdia.dia_spmv(TA, v), torch.from_numpy(b), apply_M,
                  tol=1e-6)
    assert int(info.status) == STATUS_CONVERGED
    assert len(calls) == int(info.iterations)  # initial + one per continuing step


def test_krylov_dispatch():
    assert krylov_dispatch("cg") is pcg
    assert krylov_dispatch("bicgstab") is bicgstab
    g = krylov_dispatch("gmres")
    assert g.func is gmres and g.keywords == {"restart": 30}
    fg = krylov_dispatch("fgmres", restart=7)
    assert fg.func is gmres and fg.keywords == {"restart": 7, "flexible": True}
    assert krylov_dispatch("cg", restart=7) is pcg
    with pytest.raises(ValueError, match="unknown"):
        krylov_dispatch("minres")


def test_krylov_info_to():
    info = KrylovInfo(torch.tensor(3, dtype=torch.int32),
                      torch.tensor(0, dtype=torch.int32), torch.tensor(1e-7),
                      torch.full((4,), float("nan")))
    moved = info.to("cpu")
    assert int(moved.iterations) == 3 and moved.res_hist.shape == (4,)


# ---------------------------------------------------------------------------
# float64, 16^3: dot_fn, BiCGStab, (F)GMRES
# ---------------------------------------------------------------------------

def _problem64():
    """The 16^3 7-point operator shifted by 0.5 on the diagonal: BiCGStab's
    rounding differences grow about tenfold every three iterations, so the
    problem must converge in a few dozen for the counts to be comparable
    (unshifted Poisson with Jacobi takes 46 and the two histories part
    after 30)."""
    st = stencil_7pt()
    st[1, 1, 1] += 0.5
    JA = jdia.dia_from_stencil(st, (16, 16, 16), dtype=jnp.float64)
    TA = tdia.dia_from_stencil(st, (16, 16, 16), dtype=torch.float64,
                               device="cpu")
    b = default_rhs(TA.n, dtype=np.float64)
    jdinv, tdinv = 1.0 / JA.diagonal(), 1.0 / TA.diagonal()
    jax_ops = (lambda v: jdia.dia_spmv(JA, v), jnp.asarray(b), lambda r: jdinv * r)
    torch_ops = (lambda v: tdia.dia_spmv(TA, v), torch.from_numpy(b),
                 lambda r: tdinv * r)
    return jax_ops, torch_ops


def _same64(xt, it, xj, ij):
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status) == STATUS_CONVERGED
    assert float(it.relres) <= 1e-8
    assert rel_err(xt.numpy(), xj) <= 1e-9
    ht, hj = it.res_hist.numpy(), np.asarray(ij.res_hist)
    assert np.array_equal(np.isnan(ht), np.isnan(hj))
    ok = ~np.isnan(hj)
    # the file's history tolerance: BiCGStab's rounding differences grow
    # about tenfold every three iterations (8e-6 relative at its last one)
    assert np.all(np.abs(ht[ok] - hj[ok]) <= HIST_TOL * np.abs(hj[ok]))


def test_pcg_dot_fn_matches_jax():
    """A caller's inner product (here a plain sum of products) is the only
    one pcg uses."""
    (jA, jb, jM), (tA, tb, tM) = _problem64()
    calls = []

    def tdot(a, c):
        calls.append(a.shape)
        return (a * c).sum()

    xj, ij = jpcg(jA, jb, jM, tol=1e-8, maxiter=200,
                  dot_fn=lambda a, c: jnp.sum(a * c))
    xt, it = pcg(tA, tb, tM, tol=1e-8, maxiter=200, dot_fn=tdot)
    _same64(xt, it, xj, ij)
    assert len(calls) == 3 * int(it.iterations) + 3  # pAp, rr, rz; b, r, final


def test_bicgstab_matches_jax():
    (jA, jb, jM), (tA, tb, tM) = _problem64()
    xj, ij = jbicgstab(jA, jb, jM, tol=1e-8, maxiter=200)
    xt, it = bicgstab(tA, tb, tM, tol=1e-8, maxiter=200)
    _same64(xt, it, xj, ij)


@pytest.mark.parametrize("flexible", [False, True])
def test_gmres_matches_jax(flexible):
    """restart 8 < the iteration count, so the restart path runs too; each
    CGS2 pass is one dot_fn call over the whole (m+1, n) basis."""
    (jA, jb, jM), (tA, tb, tM) = _problem64()
    batched = []

    def tdot(a, c):
        batched.append(a.dim() == 2)
        return a @ c

    xj, ij = jgmres(jA, jb, jM, tol=1e-8, maxiter=200, restart=8,
                    flexible=flexible)
    xt, it = gmres(tA, tb, tM, tol=1e-8, maxiter=200, restart=8,
                   flexible=flexible, dot_fn=tdot)
    _same64(xt, it, xj, ij)
    assert int(it.iterations) > 8
    assert sum(batched) == 2 * int(it.iterations)
