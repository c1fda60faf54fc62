"""raptor_tpu_torch.structured.solver against the JAX package on the CPU.

* setup (16^3 and 32^2, cheb4 degree 2): plan, level dims, offsets and
  cdim equal; planes, dinv and cheb_lmax within 1e-5 relative (fp32 setup
  arithmetic in another evaluation order); coarse_inv and the folded tail
  within 1e-4 (a dense fp32 inverse amplifies those differences by the
  coarse operator's condition number);
* one cycle on a hierarchy carried over from JAX as numpy, for every
  smoother, V and W, and with the coarse tail folded: within 1e-5 * max|y|;
* bf16 storage: bit-identical planes;
* solves at 16^3 (bf16 preconditioner, tol 1e-8): equal iteration counts;
  the refined solve's true fp64 relres <= 1e-8 in both packages.

The JAX hierarchies are built once per module.  The JAX cycles and solves
run op by op (``jax.disable_jit``): after the first cycle has compiled the
ops, that costs far less than one compile per configuration.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.structured.dia as jdia
import raptor_tpu.structured.solver as js
import raptor_tpu_torch.structured.dia as tdia
import raptor_tpu_torch.structured.solver as ts
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.gallery import default_rhs, stencil_grid
from raptor_tpu_torch.structured.convert import hierarchy_from_numpy
from tests._torch_ref import np32, rel_err, stencil_5pt, stencil_7pt, tree_from_jax

CFG = dict(smoother="cheb4", cheb_degree=2, coarse_size=64, max_levels=40)
PLANE_TOL = 1e-5
DENSE_TOL = 1e-4
CYCLE_TOL = 1e-5
DIMS3, DIMS2 = (16, 16, 16), (32, 32)


def _jax_build(stencil, dims, **kw):
    A = jdia.dia_from_stencil(stencil, dims, dtype=jnp.float32)
    return js.build_structured_hierarchy(A, JCfg(**{**CFG, **kw}),
                                         dim_policy="size")


@pytest.fixture(scope="module")
def jh3():
    """16^3 without a folded tail (at 128^3 the headline config folds
    nothing either: its first level of <= 2048 rows is the coarsest)."""
    return _jax_build(stencil_7pt(), DIMS3, tail_max_n=0)


@pytest.fixture(scope="module")
def jh2_tail():
    """32^2 as the default config builds it: the tail folded from level 1
    (512 rows, the first level at or below 2048 after the fine one)."""
    h = _jax_build(stencil_5pt(), DIMS2)
    assert h.tail_start == 1
    return h


def _carry(jh):
    return hierarchy_from_numpy(tree_from_jax(jh), "cpu")


def _same_levels(th, jh):
    assert len(th.levels) == len(jh.levels)
    for tl, jl in zip(th.levels, jh.levels):
        assert (tl.dims, tl.cdim) == (jl.dims, jl.cdim)
        for name in ("A", "Pt", "Rt"):
            tm, jm = getattr(tl, name), getattr(jl, name)
            assert (tm is None) == (jm is None)
            if tm is not None:
                assert tm.offsets == jm.offsets and tm.dims == jm.dims
                assert tm.const_planes == jm.const_planes
                assert rel_err(np32(tm.data), np32(jm.data)) <= PLANE_TOL
        assert rel_err(tl.dinv.numpy(), jl.dinv) <= PLANE_TOL
        assert np.array_equal(tl.red.numpy(), np.asarray(jl.red))
        assert rel_err(tl.cheb_lmax.numpy(), jl.cheb_lmax) <= PLANE_TOL
    assert rel_err(th.coarse_inv.numpy(), jh.coarse_inv) <= DENSE_TOL


# ---------------------------------------------------------------------------
# setup
# ---------------------------------------------------------------------------

def test_setup_3d_matches_jax(jh3):
    A = tdia.dia_from_stencil(stencil_7pt(), DIMS3, device="cpu")
    th = ts.build_structured_hierarchy(A, TCfg(**CFG, tail_max_n=0),
                                       dim_policy="size")
    _same_levels(th, jh3)
    assert th.tail_op is None and th.tail_start == -1


def test_setup_2d_with_tail_matches_jax(jh2_tail):
    A = tdia.dia_from_stencil(stencil_5pt(), DIMS2, device="cpu")
    th = ts.build_structured_hierarchy(A, TCfg(**CFG), dim_policy="size")
    _same_levels(th, jh2_tail)
    assert th.tail_start == jh2_tail.tail_start
    assert rel_err(th.tail_op.numpy(), jh2_tail.tail_op) <= DENSE_TOL


@pytest.mark.parametrize("dims", [(32, 32), (24, 16, 8)])
def test_operator_plan_matches_jax(dims):
    """The 'operator' dim policy on an anisotropic stencil."""
    st = stencil_5pt() if len(dims) == 2 else stencil_7pt()
    st = st * np.linspace(0.5, 1.5, st.size).reshape(st.shape)
    st[(1,) * len(dims)] = -(st.sum() - st[(1,) * len(dims)])
    J = jdia.dia_from_stencil(st, dims, dtype=jnp.float32)
    T = tdia.dia_from_stencil(st, dims, device="cpu")
    assert ts.plan_coarsening(T, TCfg(**CFG)) == js.plan_coarsening(J, JCfg(**CFG))


def test_w_tail_fold_matches_jax(jh2_tail):
    """Folding a W-cycle tail (coarse map 2M - M A' M) on carried levels."""
    jh2 = dataclasses.replace(jh2_tail, tail_op=None, tail_start=-1,
                              config=JCfg(**CFG, cycle="W"))
    jw = js.materialize_tail(jh2, 512)
    tw = ts.materialize_tail(
        dataclasses.replace(_carry(jh2), config=TCfg(**CFG, cycle="W")), 512)
    assert tw.tail_start == jw.tail_start == 1
    assert rel_err(tw.tail_op.numpy(), jw.tail_op) <= DENSE_TOL


# ---------------------------------------------------------------------------
# one cycle on carried-over level data
# ---------------------------------------------------------------------------

def _cycle_pair(jh, th, cfg_kw, seed=0):
    b = np.random.default_rng(seed).standard_normal(th.levels[0].A.n)
    b = b.astype(np.float32)
    with jax.disable_jit():
        yj = js.scycle(jh, jnp.asarray(b), JCfg(**{**CFG, **cfg_kw}))
    yt = ts.scycle(th, torch.from_numpy(b), TCfg(**{**CFG, **cfg_kw}))
    return yt.numpy(), np.asarray(yj)


@pytest.mark.parametrize("cycle", ["V", "W"])
@pytest.mark.parametrize("smoother",
                         ["jacobi", "mcgs", "tsgs", "chebyshev", "cheb4"])
def test_cycle_matches_jax(jh3, smoother, cycle):
    th = _carry(jh3)
    yt, yj = _cycle_pair(jh3, th, dict(smoother=smoother, cycle=cycle,
                                       tail_max_n=0))
    assert yt.shape == yj.shape and np.isfinite(yt).all()
    assert rel_err(yt, yj) <= CYCLE_TOL


def test_cycle_with_folded_tail_matches_jax(jh2_tail):
    th = _carry(jh2_tail)
    assert th.tail_start == 1 and th.tail_op.shape == (512, 512)
    yt, yj = _cycle_pair(jh2_tail, th, {})
    assert rel_err(yt, yj) <= CYCLE_TOL


def test_cast_bf16_bit_identical_and_cycle(jh2_tail):
    jb = js.cast_hierarchy(jh2_tail, jnp.bfloat16)
    tb = ts.cast_hierarchy(_carry(jh2_tail), torch.bfloat16)
    for tl, jl in zip(tb.levels, jb.levels):
        for name in ("A", "Pt", "Rt"):
            tm, jm = getattr(tl, name), getattr(jl, name)
            if tm is not None:
                assert tm.dtype == torch.bfloat16
                assert np.array_equal(np32(tm.data), np32(jm.data))
    assert np.array_equal(np32(tb.tail_op), np32(jb.tail_op))
    # the carried bf16 tree converts exactly, too
    assert np.array_equal(np32(_carry(jb).levels[1].A.data),
                          np32(tb.levels[1].A.data))
    yt, yj = _cycle_pair(jb, tb, {}, seed=1)
    assert rel_err(yt, yj) <= CYCLE_TOL


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------

def _true_relres(xh, xl, b):
    x64 = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    b64 = np.asarray(b, np.float64)
    return np.linalg.norm(b64 - stencil_grid(stencil_7pt(), DIMS3) @ x64) \
        / np.linalg.norm(b64)


def test_structured_solve_matches_jax(jh3):
    """Plain fp32 PCG with a bf16 preconditioner: equal iterations, the
    recurrence residual at tol, and the true residual at the fp32 floor
    (~2e-7 here; only the refined solve certifies 1e-8)."""
    b = default_rhs(int(np.prod(DIMS3)), dtype=np.float32)
    with jax.disable_jit():
        xj, ij = js.structured_solve(jh3, jnp.asarray(b), tol=1e-8,
                                     M_hier=js.cast_hierarchy(jh3, jnp.bfloat16))
    th = _carry(jh3)
    xt, it = ts.structured_solve(th, torch.from_numpy(b), tol=1e-8,
                                 M_hier=ts.cast_hierarchy(th, torch.bfloat16))
    assert int(it.iterations) == int(ij.iterations)
    assert int(it.status) == int(ij.status) == 0
    assert float(it.relres) <= 1e-8 and float(ij.relres) <= 1e-8
    assert _true_relres(xt.numpy(), 0.0, b) <= 1e-6
    assert _true_relres(xj, 0.0, b) <= 1e-6
    assert rel_err(xt.numpy(), xj) <= 1e-4


@pytest.fixture(scope="module")
def jax_refined(jh3):
    """The JAX refined solve at 16^3 with a bf16 preconditioner."""
    b = default_rhs(int(np.prod(DIMS3)), dtype=np.float32)
    with jax.disable_jit():
        (xh, xl), rel, it = js.structured_solve_refined(
            jh3, jnp.asarray(b), tol=1e-8,
            M_hier=js.cast_hierarchy(jh3, jnp.bfloat16))
    return b, np.asarray(xh), np.asarray(xl), float(rel), int(it)


def test_structured_solve_refined_matches_jax(jh3, jax_refined):
    b, jxh, jxl, jrel, jit_ = jax_refined
    th = _carry(jh3)
    (txh, txl), trel, tit = ts.structured_solve_refined(
        th, torch.from_numpy(b), tol=1e-8,
        M_hier=ts.cast_hierarchy(th, torch.bfloat16))
    assert int(tit) == jit_
    assert float(trel) <= 1e-8 and jrel <= 1e-8
    assert _true_relres(txh.numpy(), txl.numpy(), b) <= 1e-8
    assert _true_relres(jxh, jxl, b) <= 1e-8


def test_refined_solve_on_port_built_hierarchy(jax_refined):
    """The whole slice in the port alone: setup, bf16 cast, refined solve."""
    b, _, _, _, jit_ = jax_refined
    A = tdia.dia_from_stencil(stencil_7pt(), DIMS3, device="cpu")
    th = ts.build_structured_hierarchy(A, TCfg(**CFG, tail_max_n=0),
                                       dim_policy="size")
    (xh, xl), rel, it = ts.structured_solve_refined(
        th, torch.from_numpy(b), tol=1e-8,
        M_hier=ts.cast_hierarchy(th, torch.bfloat16))
    assert int(it) == jit_
    assert _true_relres(xh.numpy(), xl.numpy(), b) <= 1e-8


def test_hierarchy_to_device_roundtrip(jh3):
    th = _carry(jh3)
    moved = th.to("cpu")
    assert moved.levels[2].A.offsets == th.levels[2].A.offsets
    assert torch.equal(moved.levels[2].A.data, th.levels[2].A.data)
