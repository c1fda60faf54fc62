"""Full coarsening of the port's structured engine (every dimension per
step, ``FULL_STEP``, BoxMG-style staged interpolation) against the JAX
package on the CPU.

* ``plan_coarsening`` with ``allow_full`` (unset, on, off) equal to the
  reference's on isotropic and anisotropic 2D and 3D grids, by both dim
  policies, with the reference's anisotropy case (a strongly anisotropic
  operator semicoarsens its strong dimension first);
* ``_build_transfer_full``, ``_compact_dia_full`` (of the Galerkin product
  kept on even offsets), ``_compact_full`` and ``_expand_full`` (batched
  too) on 2D 9x7 and 3D 7x6x5, odd extents, called eagerly on both sides:
  offsets equal, planes within 1e-6 relative in fp32, the reshapes exact;
* the whole 2D 64^2 hierarchy in fp64 (the reference's integration case,
  ``tests/integration/test_structured.py``): the plan takes full steps,
  at most 5 levels, dims and offsets equal, planes within 1e-12, the coarse
  tail folded from a full level (V and W) within 1e-10, and a PCG solve
  with the reference's iterations (at most 9) and true relres;
* a 3D hierarchy with odd extents built by the port alone: the reference's
  plan, and its refined solve to a true 1e-8.

The 3D whole-hierarchy comparison is left out: the reference compiles its
one jitted 3D setup for about 90 s on the CPU.
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
from raptor_tpu_torch.gallery import default_rhs, diffusion_stencil_2d, stencil_grid
from tests._torch_ref import np32, rel_err, stencil_5pt, stencil_7pt

FP32_TOL = 1e-6
FP64_TOL = 1e-12
TAIL_TOL = 1e-10
FULL = ts.FULL_STEP


def _aniso_3d() -> np.ndarray:
    st = stencil_7pt()
    st[1, 1, 0] = st[1, 1, 2] = -1e-3  # weak coupling along the last dim
    st[1, 1, 1] = -(st.sum() - st[1, 1, 1])
    return st


STENCILS = {"5pt": stencil_5pt, "7pt": stencil_7pt,
            "aniso2d": lambda: diffusion_stencil_2d(1e-3, 0.0),
            "aniso3d": _aniso_3d}
GRIDS = {"5pt": (64, 64), "7pt": (33, 32, 31), "aniso2d": (64, 64),
         "aniso3d": (32, 32, 32)}


@pytest.mark.parametrize("allow_full", [None, True, False])
@pytest.mark.parametrize("policy", ["operator", "size"])
@pytest.mark.parametrize("case", sorted(STENCILS))
def test_plan_matches_reference(case, policy, allow_full):
    st, dims = STENCILS[case](), GRIDS[case]
    kw = dict(coarse_size=32, max_levels=30, full_coarsening=True)
    J = jdia.dia_from_stencil(st, dims, dtype=jnp.float64)
    T = tdia.dia_from_stencil(st, dims, dtype=torch.float64, device="cpu")
    plan = ts.plan_coarsening(T, TCfg(**kw), policy, allow_full=allow_full)
    assert plan == js.plan_coarsening(J, JCfg(**kw), policy,
                                      allow_full=allow_full)
    if allow_full is False:
        assert FULL not in plan
    elif case in ("5pt", "7pt"):
        assert plan[0] == FULL
    elif policy == "operator":
        # the reference's anisotropy case: the strong dimension first
        assert plan[0] != FULL and FULL not in plan[:3]


SMALL = {"2d": (stencil_5pt, (9, 7)), "3d": (stencil_7pt, (7, 6, 5))}


def _random_operator(st, dims, seed):
    """A variable-coefficient operator of the stencil's pattern (so the
    collapsed weights differ from point to point), fp32."""
    T = tdia.dia_from_stencil(st, dims, device="cpu")
    scale = np.random.default_rng(seed).uniform(
        0.5, 1.5, tuple(T.data.shape)).astype(np.float32)
    data = (T.data.numpy() * scale).astype(np.float32)
    J = jdia.DiaMatrix(data=jnp.asarray(data), offsets=T.offsets, dims=T.dims)
    return J, tdia.DiaMatrix(data=torch.from_numpy(data), offsets=T.offsets,
                             dims=T.dims)


@pytest.mark.parametrize("case", sorted(SMALL))
def test_transfer_and_galerkin_match_reference(case):
    st, dims = SMALL[case]
    J, T = _random_operator(st(), dims, seed=len(dims))
    jp, tp = js._build_transfer_full(J), ts._build_transfer_full(T)
    assert tp.offsets == jp.offsets and tp.dims == jp.dims
    assert all(max(abs(v) for v in o) <= 1 for o in tp.offsets)
    assert rel_err(np32(tp.data), np32(jp.data)) <= FP32_TOL

    def keep_even(o):
        return all(v % 2 == 0 for v in o)

    je = jdia.dia_mult(jdia.dia_transpose(jp), jdia.dia_mult(J, jp),
                       keep=keep_even)
    te = tdia.dia_mult(tdia.dia_transpose(tp), tdia.dia_mult(T, tp),
                       keep=ts._all_even)
    jc, tc = js._compact_dia_full(je), ts._compact_dia_full(te)
    assert tc.offsets == jc.offsets
    assert tc.dims == jc.dims == tuple((d + 1) // 2 for d in dims)
    assert rel_err(np32(tc.data), np32(jc.data)) <= FP32_TOL


@pytest.mark.parametrize("case", sorted(SMALL))
def test_compact_expand_full_match_reference(case):
    dims = SMALL[case][1]
    n = int(np.prod(dims))
    nc = int(np.prod([(d + 1) // 2 for d in dims]))
    rng = np.random.default_rng(0)
    v = rng.standard_normal(n).astype(np.float32)
    vc = rng.standard_normal(nc).astype(np.float32)
    got = ts._compact_full(torch.from_numpy(v), dims).numpy()
    assert np.array_equal(got, np.asarray(js._compact_full(jnp.asarray(v), dims)))
    got = ts._expand_full(torch.from_numpy(vc), dims).numpy()
    assert np.array_equal(got, np.asarray(js._expand_full(jnp.asarray(vc), dims)))
    # the batched form (materialize_tail's) row by row
    vb = rng.standard_normal((3, nc)).astype(np.float32)
    yb = ts._expand_full(torch.from_numpy(vb), dims)
    for i in range(3):
        assert np.array_equal(yb[i].numpy(),
                              ts._expand_full(torch.from_numpy(vb[i]), dims).numpy())
    assert np.array_equal(ts._compact_full(yb, dims).numpy(), vb)


FC2D = dict(smoother="cheb4", cheb_degree=2, coarse_size=32, max_levels=30,
            full_coarsening=True, tail_max_n=0)
DIMS2D = (64, 64)


@pytest.fixture(scope="module")
def jh2d():
    """The reference's 64^2 full-coarsening hierarchy, fp64, no tail."""
    A = jdia.dia_from_stencil(stencil_5pt(), DIMS2D, dtype=jnp.float64)
    return js.build_structured_hierarchy(A, JCfg(**FC2D), "operator")


@pytest.fixture(scope="module")
def th2d():
    A = tdia.dia_from_stencil(stencil_5pt(), DIMS2D, dtype=torch.float64,
                              device="cpu")
    return ts.build_structured_hierarchy(A, TCfg(**FC2D), "operator")


def test_hierarchy_2d_matches_reference(jh2d, th2d):
    assert len(th2d.levels) == len(jh2d.levels) <= 5  # semicoarsening: 8
    assert [lv.cdim for lv in th2d.levels] == [lv.cdim for lv in jh2d.levels]
    assert th2d.levels[0].cdim == FULL
    for tl, jl in zip(th2d.levels, jh2d.levels):
        assert tl.dims == jl.dims
        for name in ("A", "Pt", "Rt"):
            tm, jm = getattr(tl, name), getattr(jl, name)
            assert (tm is None) == (jm is None)
            if tm is not None:
                assert tm.offsets == jm.offsets
                assert rel_err(tm.data.numpy(), jm.data) <= FP64_TOL
        assert rel_err(tl.dinv.numpy(), jl.dinv) <= FP64_TOL
        assert rel_err(tl.cheb_lmax.numpy(), jl.cheb_lmax) <= FP64_TOL
    assert rel_err(th2d.coarse_inv.numpy(), jh2d.coarse_inv) <= FP64_TOL


@pytest.mark.parametrize("cycle", ["V", "W"])
def test_tail_fold_on_full_levels_matches_reference(jh2d, th2d, cycle):
    """The dense coarse tail folded from level 1, a full-coarsening level."""
    cfg = dict(FC2D, cycle=cycle)
    jt = js.materialize_tail(dataclasses.replace(jh2d, config=JCfg(**cfg)),
                             2048)
    tt = ts.materialize_tail(dataclasses.replace(th2d, config=TCfg(**cfg)),
                             2048)
    assert tt.tail_start == jt.tail_start == 1
    assert tt.levels[1].cdim == FULL
    assert rel_err(tt.tail_op.numpy(), jt.tail_op) <= TAIL_TOL
    b = default_rhs(int(np.prod(DIMS2D)))
    with jax.disable_jit():
        yj = js.scycle(jt, jnp.asarray(b))
    yt = ts.scycle(tt, torch.from_numpy(b))
    assert rel_err(yt.numpy(), yj) <= TAIL_TOL


def test_solve_2d_matches_reference(jh2d, th2d):
    b = default_rhs(int(np.prod(DIMS2D)))
    with jax.disable_jit():
        xj, ij = js.structured_solve(jh2d, jnp.asarray(b), tol=1e-8,
                                     maxiter=100)
    xt, it = ts.structured_solve(th2d, torch.from_numpy(b), tol=1e-8,
                                 maxiter=100)
    assert int(it.iterations) == int(ij.iterations) <= 9
    assert float(it.relres) <= 1e-8
    A = stencil_grid(stencil_5pt(), DIMS2D)
    assert np.linalg.norm(A @ xt.numpy() - b) / np.linalg.norm(b) <= 1e-7


def test_hierarchy_3d_odd_extents_solves():
    """A 3D full-coarsening hierarchy on odd extents, the port alone: the
    reference's plan (host arithmetic), full levels in fp32 with the tail
    folded, and the df64-refined solve to a true 1e-8."""
    dims = (17, 16, 15)
    cfg = dict(smoother="cheb4", cheb_degree=2, coarse_size=64, max_levels=30,
               full_coarsening=True)
    T = tdia.dia_from_stencil(stencil_7pt(), dims, device="cpu")
    J = jdia.dia_from_stencil(stencil_7pt(), dims, dtype=jnp.float32)
    plan = js.plan_coarsening(J, JCfg(**cfg), "size")
    assert plan[0] == FULL
    h = ts.build_structured_hierarchy(T, TCfg(**cfg), "size")
    assert tuple(lv.cdim for lv in h.levels[:-1]) == plan
    assert h.levels[1].dims == (9, 8, 8)
    assert all(len(lv.A.offsets) == 27 for lv in h.levels[1:])
    b = default_rhs(int(np.prod(dims)), dtype=np.float32)
    (xh, xl), rel, it = ts.structured_solve_refined(
        h, torch.from_numpy(b), tol=1e-8,
        M_hier=ts.cast_hierarchy(h, torch.bfloat16))
    x = xh.double().numpy() + xl.double().numpy()
    A = stencil_grid(stencil_7pt(), dims)
    assert float(rel) <= 1e-8 and int(it) <= 12
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-8
