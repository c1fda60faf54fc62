"""The port's RCM-banded layout against the JAX package on the CPU: the host
plan builders (``ops/banded_plan.py``) and the plain versions of the three
banded kernels (``ops/cuda/banded_kernel.py``).

* plans: ``pidx``, ``vals``, meta, slot ranges and far blocks equal to the
  reference's, and ``BandedPlanError`` where it raises;
* K4's function (``banded_spmv_ref``) against the Pallas kernel in
  interpret mode (shuffled 10^3, one tile) and against the reference's plain
  version (16^3), fp32 and bf16 values, within 1e-6 * max|y| (the slot sums
  run in the same order; only the reference's plain version sums otherwise);
  the permuting apply against scipy in fp64 within 1e-12;
* K6's function on the 16^3 hierarchy's level-0 P and R against the
  reference's plain version and its Pallas kernel in interpret mode, within
  1e-6 * max|y|;
* K5's function on the pi-scaled 16^3 operator with its fp32 truncation
  remainder: ``rh`` equal to the Pallas kernel's (interpret mode) and
  ``rh + rl`` within 1e-12 * max|A xh| of a numpy fp64 residual.

The JAX hierarchies are built once per module.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.core.hybrid as jhyb
import raptor_tpu.ops.pallas.banded_kernel as jbk
import raptor_tpu_torch.core.hybrid as thyb
import raptor_tpu_torch.ops.banded_plan as tplan
import raptor_tpu_torch.ops.cuda.banded_kernel as tbk
from raptor_tpu.api import setup as jsetup
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.setup.convert import algebraic_hierarchy_from_numpy
from tests._torch_ref import algebraic_tree_from_jax, rel_err, shuffled_poisson

TOL = 1e-6
ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)


@pytest.fixture(scope="module")
def jh16():
    return jsetup(shuffled_poisson(16), JCfg(**ALG))


@pytest.fixture(scope="module")
def jh16_pi():
    h = jsetup(shuffled_poisson(16, scale=np.pi), JCfg(**ALG))
    assert h.a0_lo_band is not None
    return h


def _tplan(plan: dict) -> dict:
    """A JAX plan dict with its arrays as CPU tensors (bf16 widened exactly
    and cast back)."""
    out = dict(plan)
    for k in ("vals", "pidx"):
        a = np.asarray(plan[k])
        t = torch.from_numpy(a.astype(np.float32) if a.dtype.name == "bfloat16"
                             else np.array(a))
        out[k] = t.bfloat16() if a.dtype.name == "bfloat16" else t
    return out


def _vec(n, seed=1):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _same_plan(tp: dict, jp: dict):
    assert set(tp) == set(jp)
    for k in tp:
        if k in ("vals", "pidx"):
            assert np.array_equal(np.asarray(tp[k]), np.asarray(jp[k])), k
            assert np.asarray(tp[k]).dtype == np.asarray(jp[k]).dtype, k
        else:
            assert tp[k] == jp[k], k


def _same_far(tf, jf):
    assert (tf is None) == (jf is None)
    if tf is not None:
        assert set(tf) == set(jf)
        for k in tf:
            assert np.array_equal(np.asarray(tf[k]), np.asarray(jf[k])), k


def _ell_arrays(A, multiple=1024):
    E = ell_from_csr(A, dtype=np.float32, row_pad_multiple=multiple)
    return E.cols, E.row_nnz, E.data


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nx", [10, 12])
def test_square_plan_matches_reference(nx):
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = shuffled_poisson(nx)
    p = reverse_cuthill_mckee(A + A.T, symmetric_mode=True)
    cols, nnz, vals = _ell_arrays(A[p][:, p].tocsr())
    _same_plan(tplan.banded_plan(cols, nnz, vals),
               jbk.banded_plan(cols, nnz, vals))
    # the layout built from scipy input: RCM perms and plan equal too
    tb, jb = thyb.banded_from_csr(A), jhyb.banded_from_csr(A)
    assert tb.meta == jb.meta and tb.slot_ranges == jb.slot_ranges
    for k in ("vals", "pidx", "perm", "iperm"):
        assert np.array_equal(getattr(tb, k), np.asarray(getattr(jb, k))), k


def test_plan_error_where_the_reference_raises():
    """Shuffled 40^3 without RCM: the bandwidth exceeds the window caps."""
    cols, nnz, vals = _ell_arrays(shuffled_poisson(40))
    with pytest.raises(jbk.BandedPlanError):
        jbk.banded_plan(cols, nnz, vals)
    with pytest.raises(tplan.BandedPlanError):
        tplan.banded_plan(cols, nnz, vals)
    assert thyb.banded_from_csr(shuffled_poisson(40), reorder=False) is None


def _split_square():
    """test_banded.py's split input: a band with 1% long-range outliers."""
    rng = np.random.default_rng(4)
    n, K = 65536, 5
    rows = np.arange(n)
    cols = np.stack([np.clip(rows + d, 0, n - 1) for d in (-2000, -1, 0, 1)]
                    + [np.clip(rows + 30000, 0, n - 1)]).astype(np.int32)
    data = rng.standard_normal((K, n)).astype(np.float32)
    far_rows = (rng.random(n) < 0.01) & (rows < 30000)
    nnz = np.where(far_rows, K, K - 1).astype(np.int32)
    data[K - 1, ~far_rows] = 0.0
    return cols, nnz, data


def _split_rect():
    """test_banded.py's rectangular split input (2% outliers)."""
    rng = np.random.default_rng(5)
    n = nc = 65536
    K = 3
    rows = np.arange(n)
    cols = np.stack([np.clip(rows - 300, 0, nc - 1),
                     np.clip(rows + 300, 0, nc - 1),
                     np.clip(rows + 52000, 0, nc - 1)]).astype(np.int32)
    data = rng.standard_normal((K, n)).astype(np.float32)
    far_rows = rng.random(n) < 0.02
    nnz = np.where(far_rows, K, K - 1).astype(np.int32)
    data[K - 1, ~far_rows] = 0.0
    return cols, nnz, data, nc


def test_split_plans_match_reference():
    cols, nnz, data = _split_square()
    (tp, tf), (jp, jf) = (tplan.banded_plan_split(cols, nnz, data),
                          jbk.banded_plan_split(cols, nnz, data))
    assert tf is not None
    _same_plan(tp, jp)
    _same_far(tf, jf)
    cols, nnz, data, nc = _split_rect()
    (tp, tf), (jp, jf) = (tplan.banded_plan_rect_split(cols, nnz, data, nc),
                          jbk.banded_plan_rect_split(cols, nnz, data, nc))
    assert tf is not None
    _same_plan(tp, jp)
    _same_far(tf, jf)


def test_split_layouts_apply_exactly():
    """The far blocks add the out-of-window entries back: the split
    layouts' applies equal the ELL SpMV (fp32 data, fp64 check)."""
    import scipy.sparse as sp

    from raptor_tpu_torch.core.ell import EllMatrix
    from raptor_tpu_torch.solve.cycle import apply_transfer

    for cols, nnz, data, nc in (_split_square() + (None,), _split_rect()):
        K, n = cols.shape
        square = nc is None
        nc = n if square else nc
        E = EllMatrix(data=data, cols=cols, row_nnz=nnz, shape=(n, nc),
                      n_rows_pad=n, n_cols_pad=nc)
        B = (thyb.banded_from_ell(E) if square
             else thyb.rect_banded_from_ell(E, nc))
        assert B is not None and B.far is not None
        x = _vec(nc, seed=6)
        B = B.to("cpu")
        y = (thyb.banded_spmv_ro(B, torch.from_numpy(x)) if square
             else apply_transfer(B, None, torch.from_numpy(x)))
        mask = np.arange(K)[:, None] < nnz[None, :]
        rows = np.broadcast_to(np.arange(n), (K, n))
        M = sp.coo_matrix((data[mask].astype(np.float64),
                           (rows[mask], cols[mask])), shape=(n, nc)).tocsr()
        ref = M @ x.astype(np.float64)
        assert np.abs(y.double().numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_rect_plans_match_reference(jh16):
    """The 16^3 hierarchy's level-0 P and R: rectangular plans equal."""
    lv = jh16.levels[0]
    for E in (lv.P, lv.R):
        args = (np.asarray(E.cols), np.asarray(E.row_nnz), np.asarray(E.data),
                -(-E.n_cols_pad // 1024) * 1024)
        _same_plan(tplan.banded_plan_rect(*args), jbk.banded_plan_rect(*args))


# ---------------------------------------------------------------------------
# K4: square banded SpMV
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_k4_plain_matches_pallas_interpret(dtype):
    """Shuffled 10^3 (1000 rows, one tile)."""
    B = jhyb.banded_from_csr(shuffled_poisson(10), dtype=np.float32)
    plan = dict(B.plan(), vals=B.vals.astype(dtype))
    x = _vec(B.n_pad, seed=2)
    y_j = np.asarray(jbk.banded_spmv_pallas(plan, jnp.asarray(x),
                                            interpret=True))
    y_t = tbk.banded_spmv_ref(_tplan(plan), torch.from_numpy(x))
    assert rel_err(y_t.numpy(), y_j) <= TOL


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_k4_plain_matches_reference_plain(jh16, level, dtype):
    """The 16^3 hierarchy's banded levels (K 7 and 24, four and two tiles)."""
    B = jh16.levels[level].Aband
    plan = dict(B.plan(), vals=B.vals.astype(dtype))
    x = _vec(B.n_pad, seed=3)
    y_j = np.asarray(jbk.banded_spmv_ref(plan, jnp.asarray(x)))
    y_t = tbk.banded_spmv_ref(_tplan(plan), torch.from_numpy(x))
    assert rel_err(y_t.numpy(), y_j) <= TOL


@pytest.mark.parametrize("nx,reorder", [(12, True), (12, False), (9, True)])
def test_banded_apply_matches_scipy(nx, reorder):
    """banded_spmv (permute in, K4's plain version, permute out) in fp64."""
    A = shuffled_poisson(nx)
    n = A.shape[0]
    B = thyb.banded_from_csr(A, dtype=np.float64, reorder=reorder).to("cpu")
    x = np.random.default_rng(1).standard_normal(B.n_pad)
    x[n:] = 0
    y = thyb.banded_spmv(B, torch.from_numpy(x)).numpy()
    assert np.allclose(y[:n], A @ x[:n], rtol=1e-12, atol=1e-12)


def test_banded_from_ell_reorder_fallback_matches_reference():
    """Shuffled 40^3 in its given ordering exceeds the caps; the RCM retry
    gives the reference's reordered layout, and its permuting apply is the
    exact SpMV in the caller's ordering."""
    A = shuffled_poisson(40)
    n = A.shape[0]
    E = ell_from_csr(A, dtype=np.float64, row_pad_multiple=1024)
    assert thyb.banded_from_ell(E) is None
    tb = thyb.banded_from_ell(E, reorder=True)
    from raptor_tpu.core.ell import ell_from_csr as jell

    jb = jhyb.banded_from_ell(jell(A, dtype=np.float64, row_pad_multiple=1024,
                                   device=False), reorder=True)
    assert tb.reordered and jb.reordered and tb.meta == jb.meta
    assert tb.slot_ranges == jb.slot_ranges
    for k in ("vals", "pidx", "perm", "iperm"):
        assert np.array_equal(getattr(tb, k), np.asarray(getattr(jb, k))), k
    x = np.random.default_rng(2).standard_normal(E.n_rows_pad)
    y = thyb.banded_spmv(tb.to("cpu"), torch.from_numpy(x)).numpy()
    assert np.allclose(y[:n], A @ x[:n], rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# K6: rectangular transfer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["Pband", "Rband"])
def test_k6_plain_matches_reference(jh16, which):
    band = getattr(jh16.levels[0], which)
    assert band is not None and band.far is None
    plan = band.plan()
    x = _vec(plan["n_cols"], seed=4)
    y_t = tbk.banded_spmv_rect_ref(_tplan(plan), torch.from_numpy(x)).numpy()
    assert rel_err(y_t, np.asarray(jbk.banded_spmv_rect_ref(plan, jnp.asarray(x)))) <= TOL
    y_k = np.asarray(jbk.banded_spmv_rect_pallas(plan, jnp.asarray(x),
                                                 interpret=True))
    assert rel_err(y_t, y_k) <= TOL


# ---------------------------------------------------------------------------
# K5: fused df64 residual
# ---------------------------------------------------------------------------

def test_k5_plain_matches_pallas_and_fp64(jh16_pi):
    h = jh16_pi
    A = shuffled_poisson(16, scale=np.pi)
    n = A.shape[0]
    band = h.levels[0].Aband
    n_pad = band.n_pad
    perm = np.asarray(h.perm)[:n]
    Ar = A[perm][:, perm]
    rng = np.random.default_rng(1)

    def pad(a):
        out = np.zeros(n_pad, np.float32)
        out[:n] = a
        return out

    xh = pad(rng.standard_normal(n).astype(np.float32))
    b64 = rng.standard_normal(n)
    bh = pad(b64.astype(np.float32))
    bl = pad((b64 - bh[:n].astype(np.float64)).astype(np.float32))
    v = pad((rng.standard_normal(n) * 1e-6).astype(np.float32))
    args = (xh, bh, bl, v)
    lo = np.array(h.a0_lo_band)
    rh_j, rl_j = jbk.banded_df64_residual_pallas(
        band.plan(), jnp.asarray(lo), *map(jnp.asarray, args), interpret=True)
    rh, rl = tbk.banded_df64_residual_ref(
        _tplan(band.plan()), torch.from_numpy(lo), *map(torch.from_numpy, args))
    assert np.array_equal(rh.numpy(), np.asarray(rh_j))
    got = rh.double().numpy() + rl.double().numpy()
    ref = b64 - v[:n] - Ar @ xh[:n].astype(np.float64)
    scale = np.abs(Ar @ xh[:n].astype(np.float64)).max()
    assert np.abs(got[:n] - ref).max() <= 1e-12 * scale
    # the layout-level entry point on the hierarchy carried over as numpy
    th = algebraic_hierarchy_from_numpy(algebraic_tree_from_jax(h), "cpu")
    rh2, rl2 = thyb.banded_df64_residual(th.levels[0].Aband, th.a0_lo_band,
                                         *map(torch.from_numpy, args))
    assert torch.equal(rh2, rh) and torch.equal(rl2, rl)


def test_live_slots_skip_only_padding(jh16):
    """Slots whose page range is empty hold only padding: skipping them (as
    the kernels do) changes nothing against visiting every slot."""
    plan = jh16.levels[1].Aband.plan()
    live = tbk.live_slots(plan)
    vals = np.asarray(plan["vals"])
    dead = [k for k in range(plan["K"]) if k not in live]
    assert all(not vals[:, k].any() for k in dead)
    x = torch.from_numpy(_vec(plan["n"], seed=5))
    y_live = tbk.banded_spmv_ref(_tplan(plan), x)
    y_all = tbk.banded_spmv_ref(dict(_tplan(plan), ranges=None), x)
    assert torch.equal(y_live, y_all)
