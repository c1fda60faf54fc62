"""The plane mode of the port's algebraic engine against the JAX package
on the CPU: grid detection, the DIA-plane layout (``HybridMatrix``), the
geo-split transfers (``GeoTransfer``), geo-split host setup, cycles on a
carried geo hierarchy, the DIA-plane df64 residual and the refined solve.

Inputs are natural-ordered grid operators given as scipy CSR with no grid
information (the reference bench's alg128 row, cut to 16^3 and 20^3 in 3D
and 64^2 in 2D), with its configuration: PMIS, extended interpolation,
``fine_layout='banded'``, cheb4 degree 3.

Tolerances: layouts, offsets, permutations, level sizes and geo metas
exact; plane values bit-equal where both sides copy the same fp32 entries
(``hybrid_from_ell``, the bf16 cast); values built by the host setup
(RAP, interpolation weights, planes of coarse levels) within 1e-6
relative, applies (SpMV, transfers) within 1e-6 * max|y|, one cycle within
1e-5 * max|y| (the tolerances of tests/test_torch_algebraic.py), the
DIA-plane df64 residual within 1e-12 * max|A @ xh| of NumPy fp64.  The
JAX cycles run op by op (``jax.disable_jit``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
import raptor_tpu.core.hybrid as jhyb
import raptor_tpu_torch.api as tapi
import raptor_tpu_torch.core.hybrid as thyb
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import ell_from_csr as j_ell_from_csr
from raptor_tpu.setup.hierarchy import cast_hierarchy_algebraic as jcast
from raptor_tpu.solve.cycle import cycle as jcycle
from raptor_tpu.solve.cycle import materialize_tail as jtail
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import ell_from_csr as t_ell_from_csr
from raptor_tpu_torch.gallery import (anisotropic_2d, default_rhs, poisson_2d,
                                      poisson_3d)
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from raptor_tpu_torch.ops.sparse_ops import spmv as tspmv
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic as tcast
from raptor_tpu_torch.solve.cycle import cycle as tcycle
from raptor_tpu_torch.solve.cycle import materialize_tail as ttail
from tests._torch_ref import (algebraic_tree_from_jax, np32, rel_err,
                              shuffled_poisson)
from tests.test_torch_algebraic import _same_hierarchy

GEO = dict(splitting="pmis", interp="extended", fine_layout="banded",
           smoother="cheb4", cheb_degree=3)
VAL_TOL = 1e-6
APPLY_TOL = 1e-6
CYCLE_TOL = 1e-5
RESID_TOL = 1e-12
REFINED = dict(tol=1e-8, refine=True)
JAX_ITERS = {"3d16": 6, "3d20": 6}  # the reference's refined-solve iterations
# every input but 16^3 folds the tail from its 1024-row level: the folded
# tail is the same linear operator as the cycle below it, and the port's
# fold of a 4096-row level (a (4096, K, 4096) gather per operator apply)
# takes 15 s of CPU
KW = {"3d16": {}, "3d20": {"tail_max_n": 1024}, "2d64": {"tail_max_n": 1024}}
MATS = {"3d16": lambda: poisson_3d(16), "3d20": lambda: poisson_3d(20),
        "3d12x10x8": lambda: poisson_3d(12, 10, 8),
        "2d64": lambda: poisson_2d(64),
        "aniso": lambda: anisotropic_2d(32, epsilon=1e-3, theta=0.4)}


def _mat(name):
    return sp.csr_matrix(MATS[name]())


@pytest.fixture(scope="module")
def hiers():
    """hiers(name, side, **cfg): the setup of matrix ``name`` by the JAX
    package (side "jax") or the port on the CPU ("torch"), built once."""
    cache = {}

    def get(name, side, **kw):
        key = (name, side, tuple(sorted(kw.items())))
        if key not in cache:
            A = _mat(name)
            cache[key] = (japi.setup(A, JCfg(**GEO, **kw)) if side == "jax"
                          else tapi.setup(A, TCfg(**GEO, **kw), device="cpu"))
        return cache[key]

    return get


def _layout(lv) -> str:
    return ("hyb" if lv.Ahyb is not None else
            "band" if lv.Aband is not None else "ell")


def _same_geo(th, jh):
    """The geo-specific parts of two hierarchies: layouts, hyb offsets,
    perms and planes, geo metas and weights."""
    assert [_layout(lv) for lv in th.levels] == [_layout(lv) for lv in jh.levels]
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        assert (tl.Tgeo is None) == (jl.Tgeo is None), f"L{i} Tgeo"
        if tl.Tgeo is not None:
            assert tl.Tgeo.meta == jl.Tgeo.meta, f"L{i} meta"
            for w in ("wm", "wp"):
                assert rel_err(np32(getattr(tl.Tgeo, w)),
                               np32(getattr(jl.Tgeo, w))) <= VAL_TOL, f"L{i} {w}"
        if tl.Ahyb is not None:
            th_, jh_ = tl.Ahyb, jl.Ahyb
            assert (th_.offsets, th_.shape, th_.n_pad) == (
                jh_.offsets, jh_.shape, jh_.n_pad), f"L{i} hyb"
            assert (th_.spill is None) == (jh_.spill is None), f"L{i} spill"
            assert np.array_equal(th_.perm.numpy(), np.asarray(jh_.perm))
            assert rel_err(np32(th_.planes), np32(jh_.planes)) <= VAL_TOL


# ---------------------------------------------------------------------------
# grid detection
# ---------------------------------------------------------------------------

def _pentadiagonal(n: int):
    return sp.diags([-1.0, -4.0, 10.0, -4.0, -1.0], [-2, -1, 0, 1, 2],
                    shape=(n, n)).tocsr()


@pytest.mark.parametrize("case,want", [
    ("3d12x10x8", [8, 10, 12]), ("2d24", [24, 24, 1]), ("shuffled12", None),
    ("aniso", "some"), ("penta", [2, 500, 1])])
def test_detect_grid_matches_reference(case, want):
    A = {"3d12x10x8": lambda: poisson_3d(12, 10, 8),
         "2d24": lambda: poisson_2d(24),
         "shuffled12": lambda: shuffled_poisson(12),
         "aniso": MATS["aniso"],
         "penta": lambda: _pentadiagonal(1000)}[case]()
    coo = sp.csr_matrix(A).tocoo()
    got = tapi._detect_grid(coo, A.shape[0])
    assert got == japi._detect_grid(coo, A.shape[0])
    if want == "some":  # detected; the weak-dimension bail handles it
        assert got is not None
    else:
        assert got == want


# ---------------------------------------------------------------------------
# the DIA-plane layout
# ---------------------------------------------------------------------------

HYB_CASES = {"natural": (lambda: poisson_3d(12, 10, 8), False, 512),
             "natural_spill": (lambda: poisson_3d(12, 10, 8), False, 5),
             "shuffled_rcm": (lambda: shuffled_poisson(10), True, 512),
             "shuffled": (lambda: shuffled_poisson(10), False, 512)}


def _hybrids(case):
    make, reorder, max_off = HYB_CASES[case]
    A = sp.csr_matrix(make())
    kw = dict(reorder=reorder, max_offsets=max_off, pad_multiple=1024)
    th = thyb.hybrid_from_ell(t_ell_from_csr(A, row_pad_multiple=1024), **kw)
    jh = jhyb.hybrid_from_ell(j_ell_from_csr(A, row_pad_multiple=1024,
                                             device=False), device=False, **kw)
    return A, th, jh


@pytest.mark.parametrize("case", list(HYB_CASES))
def test_hybrid_from_ell_matches_reference(case):
    _, th, jh = _hybrids(case)
    assert (th.offsets, th.shape, th.n_pad) == (jh.offsets, jh.shape, jh.n_pad)
    assert np.array_equal(th.perm, np.asarray(jh.perm))
    assert np.array_equal(th.iperm, np.asarray(jh.iperm))
    assert th.planes.dtype == np.float32
    assert np.array_equal(th.planes, np.asarray(jh.planes))
    assert (th.spill is None) == (jh.spill is None)
    assert (th.spill is not None) == (case != "natural")
    if th.spill is not None:
        ts, js = th.spill, jh.spill
        assert (ts.shape, ts.n_rows_pad, ts.n_cols_pad) == (
            js.shape, js.n_rows_pad, js.n_cols_pad)
        for name in ("data", "cols", "row_nnz"):
            assert np.array_equal(getattr(ts, name),
                                  np.asarray(getattr(js, name))), name


@pytest.mark.parametrize("case", ["natural_spill", "shuffled_rcm"])
def test_hybrid_spmv_matches_reference(case):
    A, th, jh = _hybrids(case)
    th = th.to("cpu")
    x = np.zeros(th.n_pad, np.float32)
    x[:A.shape[0]] = np.random.default_rng(0).standard_normal(A.shape[0])
    for tf, jf in ((thyb.hybrid_spmv_ro, jhyb.hybrid_spmv_ro),
                   (thyb.hybrid_spmv, jhyb.hybrid_spmv)):
        y = tf(th, torch.from_numpy(x)).numpy()
        assert rel_err(y, np.asarray(jf(jh, jnp.asarray(x)))) <= APPLY_TOL
    y = thyb.hybrid_spmv(th, torch.from_numpy(x)).numpy()
    assert rel_err(y[:A.shape[0]], A @ x[:A.shape[0]]) <= APPLY_TOL


def test_geo_level_planes_through_pallas_k1(hiers):
    """The 15 planes of 16^3 level 1 through the reference's Pallas K1 in
    interpret mode against the port's plain K1."""
    from raptor_tpu.ops.pallas.dia_kernel import dia_spmv_pallas_v2

    H = hiers("3d16", "torch").levels[1].Ahyb
    assert len(H.offsets) == 15 and H.n_pad == 2048
    x = np.random.default_rng(2).standard_normal(H.n_pad).astype(np.float32)
    y = tk.dia_spmv_v2_ref(H.planes, H.offsets, torch.from_numpy(x)).numpy()
    y_pallas = dia_spmv_pallas_v2(jnp.asarray(H.planes.numpy()), H.offsets,
                                  jnp.asarray(x), tile=2048, interpret=True)
    assert rel_err(y, np.asarray(y_pallas)) <= APPLY_TOL


# ---------------------------------------------------------------------------
# geo-split transfers
# ---------------------------------------------------------------------------

# coarse_size 16: the geo levels of poisson_3d(12, 10, 8) then coarsen
# extents 12, 10, 8, 6, 5, 4, 3, both parities of m
TRANSFER = dict(coarse_size=16, tail_max_n=0)


@pytest.mark.parametrize("level", range(7))
@pytest.mark.parametrize("op", ["prolong", "restrict"])
def test_geo_transfer_matches_reference_and_ell(hiers, level, op):
    """Every geo level of poisson_3d(12, 10, 8)."""
    tl = hiers("3d12x10x8", "torch", **TRANSFER).levels[level]
    jl = hiers("3d12x10x8", "jax", **TRANSFER).levels[level]
    assert tl.Tgeo is not None
    H, m, mc, s, n_f, n_pad_f, nc_pad = tl.Tgeo.meta
    rng = np.random.default_rng(level)
    if op == "prolong":
        x = np.zeros(nc_pad, np.float32)
        x[:H * mc * s] = rng.standard_normal(H * mc * s)
        y = thyb.geo_prolong(tl.Tgeo, torch.from_numpy(x)).numpy()
        y_j = jhyb.geo_prolong(jl.Tgeo, jnp.asarray(x))
        y_ell = tspmv(tl.P, torch.from_numpy(x)).numpy()
    else:
        x = np.zeros(n_pad_f, np.float32)
        x[:n_f] = rng.standard_normal(n_f)
        y = thyb.geo_restrict(tl.Tgeo, torch.from_numpy(x)).numpy()
        y_j = jhyb.geo_restrict(jl.Tgeo, jnp.asarray(x))
        y_ell = tspmv(tl.R, torch.from_numpy(x)).numpy()
    assert rel_err(y, np.asarray(y_j)) <= APPLY_TOL
    assert rel_err(y, y_ell) <= APPLY_TOL


def test_geo_levels_cover_both_parities(hiers):
    th, jh = (hiers("3d12x10x8", side, **TRANSFER) for side in ("torch", "jax"))
    _same_geo(th, jh)
    metas = [lv.Tgeo.meta for lv in th.levels if lv.Tgeo is not None]
    assert [m for _, m, *_ in metas] == [12, 10, 8, 6, 5, 4, 3]


# ---------------------------------------------------------------------------
# plane-mode setup
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["3d16", "3d12x10x8", "2d64"])
def test_plane_mode_setup_matches_reference(hiers, name):
    kw = KW.get(name, {})
    th, jh = hiers(name, "torch", **kw), hiers(name, "jax", **kw)
    _same_hierarchy(th, jh)
    _same_geo(th, jh)
    assert th.levels[0].Tgeo is not None
    assert np.array_equal(th.perm.numpy(), np.arange(th.levels[0].A.n_rows_pad))
    if name != "3d12x10x8":  # 960 rows: below the plane layouts' 2048
        assert isinstance(th.levels[0].Ahyb.planes, torch.Tensor)
        assert isinstance(th.levels[0].Tgeo.wm, torch.Tensor)


@pytest.mark.parametrize("case", ["anisotropic_bail", "geo_split_off"])
def test_pmis_fallbacks_match_reference(hiers, case):
    """The weak-dimension bail (anisotropic 2D: the grid is detected, the
    semicoarsened dimension is weakly coupled) and geo_split=False both
    coarsen by PMIS, as the reference does."""
    name, kw = (("aniso", {}) if case == "anisotropic_bail"
                else ("3d12x10x8", {"geo_split": False}))
    th, jh = hiers(name, "torch", **kw), hiers(name, "jax", **kw)
    _same_hierarchy(th, jh)
    _same_geo(th, jh)
    assert all(lv.Tgeo is None for lv in th.levels)
    assert th.levels[1].n != th.levels[0].n // 2


def test_bf16_cast_matches_reference(hiers):
    th = tcast(hiers("3d16", "torch"), torch.bfloat16)
    jh = jcast(hiers("3d16", "jax"), jnp.bfloat16)
    for tl, jl in zip(th.levels, jh.levels):
        if tl.Ahyb is not None:
            assert tl.Ahyb.planes.dtype == torch.bfloat16
            assert np.array_equal(np32(tl.Ahyb.planes), np32(jl.Ahyb.planes))
        if tl.Tgeo is not None:  # the weights keep their precision
            assert tl.Tgeo.wm.dtype == torch.float32


def test_carried_geo_hierarchy_equals_port_setup(hiers):
    jh = hiers("3d16", "jax")
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(jh), "cpu")
    _same_hierarchy(th, jh)
    _same_geo(th, jh)
    _same_geo(hiers("3d16", "torch"), jh)


# ---------------------------------------------------------------------------
# cycles on the carried JAX hierarchy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", [False, True], ids=["no_tail", "tail"])
@pytest.mark.parametrize("store", ["fp32", "bf16"])
def test_cycle_matches_reference(hiers, store, tail):
    """16^3 runs K1's plain version on levels 0 and 1 and the geo
    transfers on every level down to the tail (from level 2, 1024 rows)."""
    jh = hiers("3d16", "jax", tail_max_n=0)
    assert jh.tail_op is None and jh.levels[1].Ahyb is not None
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(jh), "cpu")
    if tail:
        jh, th = jtail(jh, 1024), ttail(th, 1024)
        assert th.tail_start == jh.tail_start == 2
    if store == "bf16":
        jh, th = jcast(jh, jnp.bfloat16), tcast(th, torch.bfloat16)
    b = default_rhs(jh.levels[0].A.n_rows_pad, dtype=np.float32)
    with jax.disable_jit():
        y_j = np.asarray(jcycle(jh, jnp.asarray(b)))
    y_t = tcycle(th, torch.from_numpy(b)).numpy()
    assert rel_err(y_t, y_j) <= CYCLE_TOL


# ---------------------------------------------------------------------------
# the DIA-plane df64 residual and the refined solve
# ---------------------------------------------------------------------------

def test_dia_plane_df64_residual_matches_fp64(hiers):
    th = hiers("3d16", "torch")
    H = th.levels[0].Ahyb
    A = _mat("3d16")
    n, n_pad = A.shape[0], H.n_pad
    rng = np.random.default_rng(5)

    def vec(scale=1.0):
        v = np.zeros(n_pad, np.float32)
        v[:n] = rng.standard_normal(n) * scale
        return v

    xh, b64 = vec(), np.zeros(n_pad)
    b64[:n] = rng.standard_normal(n) * 6
    bh = b64.astype(np.float32)
    bl = (b64 - bh).astype(np.float32)
    v = vec(1e-7)
    rh, rl = thyb.hybrid_df64_residual(
        H, *(torch.from_numpy(a) for a in (xh, bh, bl, v)))
    r64 = b64[:n] - v[:n] - A @ xh[:n].astype(np.float64)
    got = rh.double().numpy()[:n] + rl.double().numpy()[:n]
    scale = np.abs(A @ xh[:n].astype(np.float64)).max()
    assert np.abs(got - r64).max() <= RESID_TOL * scale
    # the fp32 sum alone is far off: the compensation carries the digits
    assert np.abs(rh.double().numpy()[:n] - r64).max() > RESID_TOL * scale


@pytest.mark.parametrize("name", ["3d16", "3d20"])
def test_refined_solve_takes_reference_iterations(hiers, monkeypatch, name):
    A = _mat(name)
    b = np.ones(A.shape[0])
    kw = KW[name]
    jh, th = hiers(name, "jax", **kw), hiers(name, "torch", **kw)
    _, info_j = japi.solve(A, b, JCfg(**GEO, **kw), JSolve(**REFINED), hier=jh)
    calls = []
    resid = thyb.hybrid_df64_residual
    monkeypatch.setattr(thyb, "hybrid_df64_residual",
                        lambda *a: calls.append(1) or resid(*a))
    x, info = tapi.solve(A, b, TCfg(**GEO, **kw), TSolve(**REFINED), hier=th)
    assert info["iterations"] == info_j["iterations"] == JAX_ITERS[name]
    assert info["stats"]["sizes"] == [lv.n for lv in jh.levels]
    assert calls  # certified through the DIA-plane residual
    true = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    assert true <= 1e-8 and abs(info["relres"] - true) <= 1e-10


def test_refined_solve_with_bf16_preconditioner(hiers):
    """The alg128 configuration: bf16-stored preconditioner operators."""
    A = _mat("3d16")
    b = default_rhs(A.shape[0])
    cfg = dataclasses.replace(TCfg(**GEO), operator_store_dtype="bfloat16")
    x, info = tapi.solve(A, b, cfg, TSolve(**REFINED), hier=hiers("3d16", "torch"))
    assert float(np.linalg.norm(b - A @ x) / np.linalg.norm(b)) <= 1e-8
    assert info["iterations"] <= JAX_ITERS["3d16"] + 1
