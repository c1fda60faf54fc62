"""The port's padded-ELL sparse operations of the device-level setup
(``raptor_tpu_torch/ops/sparse_ops.py`` and the two ELL helpers of
``setup/interp.py``) against the JAX package on the CPU.

Inputs are seeded random ELL matrices (``np.random.default_rng``) with
padding rows (row_nnz 0, or identity rows on square operators) and padding
slots, in fp32 and fp64.  ``cols``, ``row_nnz`` and ``leftover`` must be
exact; values within 1e-6 relative in fp32 and 1e-12 in fp64 (another
summation order at most).  A run whose expand is forced through row chunks
(the port's ``_EXPAND_ELEM_BUDGET`` monkeypatched) must be bit-equal to the
port's own unchunked run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.ops.sparse_ops as jso
import raptor_tpu_torch.ops.sparse_ops as tso
from raptor_tpu.core.ell import EllMatrix as JEll
from raptor_tpu.setup.interp import add_identity_padding as j_add_identity
from raptor_tpu.setup.interp import tighten_coarse_space as j_tighten
from raptor_tpu_torch.core.ell import EllMatrix as TEll
from raptor_tpu_torch.core.ell import ell_from_csr, ell_to_csr
from raptor_tpu_torch.setup.interp import add_identity_padding as t_add_identity
from raptor_tpu_torch.setup.interp import tighten_coarse_space as t_tighten
from tests._torch_ref import rel_err

TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]


def rand_ell(seed: int, n: int, m: int, K: int, n_pad: int, m_pad: int,
             dtype, identity_pad: bool = False):
    """(data, cols, row_nnz) of a random n x m matrix as ELL arrays padded
    to n_pad rows: sorted distinct columns, padding slots at column 0 with
    value 0, padding rows empty (or identity for square operators)."""
    rng = np.random.default_rng(seed)
    data = np.zeros((K, n_pad), dtype)
    cols = np.zeros((K, n_pad), np.int32)
    nnz = np.zeros(n_pad, np.int32)
    for i in range(n):
        k = int(rng.integers(0, K + 1))
        c = np.sort(rng.choice(m, size=k, replace=False))
        cols[:k, i] = c
        data[:k, i] = rng.standard_normal(k)
        nnz[i] = k
    if identity_pad:
        data[0, n:] = 1.0
        cols[0, n:] = np.arange(n, n_pad)
        nnz[n:] = 1
    return data, cols, nnz


def pair(data, cols, nnz, shape, n_rows_pad, n_cols_pad):
    """The same ELL matrix as a JAX and a port (CPU tensors) EllMatrix."""
    meta = dict(shape=tuple(shape), n_rows_pad=n_rows_pad,
                n_cols_pad=n_cols_pad)
    return (JEll(data=jnp.asarray(data), cols=jnp.asarray(cols),
                 row_nnz=jnp.asarray(nnz), **meta),
            TEll(data=torch.from_numpy(np.array(data)),
                 cols=torch.from_numpy(np.array(cols)),
                 row_nnz=torch.from_numpy(np.array(nnz)), **meta))


def same_ell(te: TEll, je: JEll, tol: float, what: str = ""):
    assert (te.shape, te.n_rows_pad, te.n_cols_pad) == (
        je.shape, je.n_rows_pad, je.n_cols_pad), what
    assert te.cols.dtype == torch.int32 and te.row_nnz.dtype == torch.int32
    assert np.array_equal(te.cols.numpy(), np.asarray(je.cols)), what
    assert np.array_equal(te.row_nnz.numpy(), np.asarray(je.row_nnz)), what
    assert te.data.numpy().dtype == np.asarray(je.data).dtype, what
    assert rel_err(te.data.numpy(), np.asarray(je.data)) <= tol, what


def product_pair(dtype, seed=0):
    """A (300 x 250 in 320 x 256 padded) and B (250 x 180 in 256 x 184)."""
    A = pair(*rand_ell(seed, 300, 250, 7, 320, 256, dtype),
             (300, 250), 320, 256)
    B = pair(*rand_ell(seed + 1, 250, 180, 5, 256, 184, dtype),
             (250, 180), 256, 184)
    return A, B


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("width", ["exact", "short"])
def test_spgemm_fixed_matches_reference(dtype, width):
    (jA, tA), (jB, tB) = product_pair(dtype)
    w = int(jso._spgemm_width(jA, jB))
    assert int(tso._spgemm_width(tA, tB)) == w
    k_out = w if width == "exact" else w - 4
    jC, j_left = jso._spgemm_fixed_full(jA, jB, k_out)
    tC, t_left = tso._spgemm_fixed_full(tA, tB, k_out)
    same_ell(tC, jC, TOL[dtype], "C")
    assert int(t_left) == int(j_left) == (0 if width == "exact" else 4)
    if width == "exact":  # and the product itself
        ref = (ell_to_csr(tA) @ ell_to_csr(tB)).toarray()
        assert rel_err(ell_to_csr(tC).toarray(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_spgemm_and_rap_wrappers_match_reference(dtype):
    (jA, tA), (jB, tB) = product_pair(dtype, seed=3)
    same_ell(tso.spgemm(tA, tB), jso.spgemm(jA, jB), TOL[dtype], "spgemm")
    # R A P with R = P^T
    a = sp.random(200, 200, density=0.03, random_state=4, dtype=dtype)
    a = (a + a.T + sp.identity(200, dtype=dtype) * 4).tocsr()
    E = ell_from_csr(a, dtype=dtype, row_pad_multiple=16)
    jA2, tA2 = pair(E.data, E.cols, E.row_nnz, E.shape, E.n_rows_pad,
                    E.n_cols_pad)
    P = ell_from_csr(sp.random(200, 60, density=0.05, random_state=5,
                               dtype=dtype).tocsr(), dtype=dtype,
                     row_pad_multiple=16, n_cols_pad=64, identity_pad_rows=False)
    jP, tP = pair(P.data, P.cols, P.row_nnz, P.shape, P.n_rows_pad,
                  P.n_cols_pad)
    jR, tR = jso.ell_transpose(jP), tso.ell_transpose(tP)
    same_ell(tR, jR, TOL[dtype], "R")
    same_ell(tso.rap(tR, tA2, tP), jso.rap(jR, jA2, jP), TOL[dtype], "RAP")


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_ell_transpose_fixed_matches_reference(dtype):
    jA, tA = pair(*rand_ell(7, 300, 250, 7, 320, 256, dtype), (300, 250),
                  320, 256)
    counts = np.asarray(jso._transpose_col_counts(jA))
    assert np.array_equal(tso._transpose_col_counts(tA).numpy(), counts)
    k = int(counts.max())
    same_ell(tso.ell_transpose_fixed(tA, k), jso.ell_transpose_fixed(jA, k),
             TOL[dtype], "A^T")
    assert (ell_to_csr(tso.ell_transpose_fixed(tA, k))
            != ell_to_csr(tA).T).nnz == 0


def _square_operator(dtype, seed: int):
    """A symmetric, diagonally dominant 300 x 300 operator padded to 320
    rows (identity padding rows)."""
    a = sp.random(300, 300, density=0.02, random_state=seed, dtype=dtype)
    a = a + a.T
    a = (a + sp.diags(np.asarray(abs(a).sum(1)).ravel() + 1.0)).tocsr()
    E = ell_from_csr(a, dtype=dtype, row_pad_multiple=64)
    return pair(E.data, E.cols, E.row_nnz, E.shape, E.n_rows_pad,
                E.n_cols_pad)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_ell_filter_matches_reference(dtype):
    jA, tA = _square_operator(dtype, 8)
    tol = 0.2
    same_ell(tso.ell_filter_fixed(tA, tol, tA.K),
             jso.ell_filter_fixed(jA, tol, jA.K), TOL[dtype], "fixed")
    tF, jF = tso.ell_filter(tA, tol), jso.ell_filter(jA, tol)
    same_ell(tF, jF, TOL[dtype], "compacted")
    assert tF.K < tA.K  # something was dropped
    # row sums are kept (the dropped entries are lumped into the diagonal)
    ones = torch.ones(tA.n_rows_pad, dtype=tA.data.dtype)
    assert rel_err(tso.spmv(tF, ones).numpy(),
                   tso.spmv(tA, ones).numpy()) <= TOL[dtype] * 10
    assert tso.ell_filter(tA, 0.0) is tA


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_spmv_t_matches_reference(dtype):
    jA, tA = pair(*rand_ell(9, 300, 250, 7, 320, 256, dtype), (300, 250),
                  320, 256)
    y = np.random.default_rng(10).standard_normal(320).astype(dtype)
    got = tso.spmv_t(tA, torch.from_numpy(y)).numpy()
    assert got.shape == (256,)
    assert rel_err(got, np.asarray(jso.spmv_t(jA, jnp.asarray(y)))) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_merge_sorted_rows_matches_reference(dtype):
    """Duplicate-column runs summed in slot order, runs past k_out dropped
    (the merge under ext+i and the filter)."""
    rng = np.random.default_rng(11)
    W, n, sent = 24, 300, 50
    cols = np.sort(np.where(rng.random((W, n)) < 0.2, sent,
                            rng.integers(0, 12, (W, n))), axis=0).astype(np.int32)
    vals = rng.standard_normal((W, n)).astype(dtype)
    for k_out in (W, 6):
        j = jso._merge_sorted_rows(jnp.asarray(cols), jnp.asarray(vals), sent,
                                   k_out)
        t = tso._merge_sorted_rows(torch.from_numpy(cols),
                                   torch.from_numpy(vals), sent, k_out, W)
        assert np.array_equal(t[0].numpy(), np.asarray(j[0]))
        assert np.array_equal(t[2].numpy(), np.asarray(j[2]))
        assert rel_err(t[1].numpy(), np.asarray(j[1])) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tighten_and_identity_padding_match_reference(dtype):
    jA, tA = _square_operator(dtype, 12)
    # a dead row (zero diagonal) and a logical size below the rows in use
    data = tA.data.clone()
    diag = (tA.cols == tA.row_index()) & tA.slot_mask()
    data[:, 17] = torch.where(diag[:, 17], 0, data[:, 17])
    jA, tA = pair(data.numpy(), tA.cols.numpy(), tA.row_nnz.numpy(), tA.shape,
                  tA.n_rows_pad, tA.n_cols_pad)
    same_ell(t_add_identity(tA, 290), j_add_identity(jA, 290), 0.0, "padded")
    P = rand_ell(13, 300, 90, 4, 320, 320, dtype)
    jP, tP = pair(*P, (300, 320), 320, 320)
    tT, jT = t_tighten(tP, 90, 16), j_tighten(jP, 90, 16)
    assert (tT.shape, tT.n_cols_pad) == (jT.shape, jT.n_cols_pad) == ((300, 90), 96)


def test_chunked_expand_is_bit_equal(monkeypatch):
    """The row-chunked expand (the memory fence of large levels) gives the
    unchunked run's bits: the product, its leftover and the width."""
    (_, tA), (_, tB) = product_pair(np.float32, seed=14)
    w = int(tso._spgemm_width(tA, tB))
    C0, l0 = tso._spgemm_fixed_full(tA, tB, w - 2)
    monkeypatch.setattr(tso, "_EXPAND_ELEM_BUDGET", 35 * 128)
    assert tso._row_chunk_plan(tA.K * tB.K, tA.n_rows_pad) == (3, 128)
    C1, l1 = tso._spgemm_fixed_full(tA, tB, w - 2)
    assert int(tso._spgemm_width(tA, tB)) == w
    assert int(l1) == int(l0) == 2
    for name in ("data", "cols", "row_nnz"):
        assert torch.equal(getattr(C1, name), getattr(C0, name)), name


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_merge_passes_are_bit_equal_to_slot_scatters(dtype, monkeypatch):
    """``_merge_sorted_rows`` summing by term position (one pass a
    position) against summing by slot (one scatter a slot), each forced:
    the same adds in the same order, bit for bit, with -0.0 and
    single-term runs among the terms, and with runs beyond k_out dropped
    alike."""
    rng = np.random.default_rng(5)
    W, n, sent = 48, 300, 40
    cols = np.sort(rng.integers(0, 44, size=(W, n)), axis=0)  # >= 40: invalid
    cols = np.where(cols >= sent, sent, cols)
    vals = rng.standard_normal((W, n)).astype(dtype)
    vals[rng.random((W, n)) < 0.1] = -0.0
    max_run = int(max(np.unique(c[c < sent], return_counts=True)[1].max(initial=1)
                      for c in cols.T))
    c, v = torch.from_numpy(cols), torch.from_numpy(vals)
    for k_out in (40, 6):
        monkeypatch.setattr(tso, "_merge_by_passes", lambda *a: False)
        ref = tso._merge_sorted_rows(c, v, sent, k_out, max_run)
        monkeypatch.setattr(tso, "_merge_by_passes", lambda *a: True)
        got = tso._merge_sorted_rows(c, v, sent, k_out, max_run)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        assert torch.equal(torch.signbit(got[1]), torch.signbit(ref[1]))


@pytest.mark.parametrize("case", ["sa", "pmis_extended", "aggressive"])
def test_run_bounds_hold_on_the_device_routes(case, monkeypatch):
    """Every caller's run bound holds: the device routes build the same
    levels, bit for bit, whether every merge sums by slot or by term
    position (a bound below a real run would drop terms in the second form
    only): SA (nodal condensation, strength pattern, SpGEMM, ell_add), PMIS
    with ext+i (its candidate merge) and aggressive coarsening (multipass,
    Jacobi refinement, filter)."""
    import raptor_tpu_torch.api as tapi
    from raptor_tpu_torch.config import PRESETS
    from raptor_tpu_torch.gallery import anisotropic_2d, elasticity_3d, poisson_3d

    A, B = {"sa": lambda: elasticity_3d(5)[:2],
            "pmis_extended": lambda: (poisson_3d(12), None),
            "aggressive": lambda: (anisotropic_2d(24), None)}[case]()
    preset = {"sa": "config4", "pmis_extended": "config5",
              "aggressive": "config3"}[case]
    cfg = dataclasses.replace(PRESETS[preset], host_setup_threshold=0)
    built = []
    for passes in (False, True):
        monkeypatch.setattr(tso, "_merge_by_passes", lambda *a, p=passes: p)
        built.append(tapi.setup(A, cfg, B=B, device="cpu"))
    slots, by_pass = built
    assert [lv.n for lv in slots.levels] == [lv.n for lv in by_pass.levels]
    for a, b in zip(slots.levels, by_pass.levels):
        for E, F in ((a.A, b.A), (a.P, b.P)):
            if E is None:
                assert F is None
                continue
            for name in ("data", "cols", "row_nnz"):
                assert torch.equal(getattr(E, name), getattr(F, name)), name
