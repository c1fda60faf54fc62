"""Comparisons of the port's algebraic hierarchies with the JAX package's,
shared by tests/test_torch_algebraic.py and
tests/test_torch_algebraic_cycles.py: level sizes, RCM permutation, ELL
structure and banded plans equal; values, dinv and cheb_lmax within
VAL_TOL relative (the same NumPy code, another fp32 evaluation order at
most); the dense coarse inverse and the folded tail within DENSE_TOL (a
dense fp32 inverse amplifies differences by the coarse operator's
condition number).  Imports no JAX: the reference's arrays are read as
numpy."""

import numpy as np

from tests._torch_ref import np32, rel_err

# the reference bench row's configuration
ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)
VAL_TOL = 1e-6
DENSE_TOL = 1e-5


def _ell_same(te, je, what):
    assert (te is None) == (je is None), what
    if te is None:
        return
    assert (te.shape, te.n_rows_pad, te.n_cols_pad) == (
        je.shape, je.n_rows_pad, je.n_cols_pad), what
    assert np.array_equal(te.cols.numpy(), np.asarray(je.cols)), what
    assert np.array_equal(te.row_nnz.numpy(), np.asarray(je.row_nnz)), what
    assert rel_err(np32(te.data), np32(je.data)) <= VAL_TOL, what


def _band_same(tb, jb, what):
    assert (tb is None) == (jb is None), what
    if tb is None:
        return
    assert (tb.meta, tb.shape, tb.slot_ranges) == (
        jb.meta, jb.shape, jb.slot_ranges), what
    assert (tb.far is None) == (jb.far is None), what
    assert np.array_equal(tb.pidx.numpy(), np.asarray(jb.pidx)), what
    assert rel_err(np32(tb.vals), np32(jb.vals)) <= VAL_TOL, what
    if hasattr(jb, "perm"):
        assert tb.reordered == jb.reordered, what
        assert np.array_equal(tb.perm.numpy(), np.asarray(jb.perm)), what


def _same_hierarchy(th, jh):
    assert [lv.n for lv in th.levels] == [lv.n for lv in jh.levels]
    for name in ("perm", "iperm"):
        t, j = getattr(th, name), getattr(jh, name)
        assert (t is None) == (j is None)
        if t is not None:
            assert np.array_equal(t.numpy(), np.asarray(j)), name
    for i, (tl, jl) in enumerate(zip(th.levels, jh.levels)):
        for name in ("A", "P", "R"):
            _ell_same(getattr(tl, name), getattr(jl, name), f"L{i} {name}")
        for name in ("Aband", "Pband", "Rband"):
            _band_same(getattr(tl, name), getattr(jl, name), f"L{i} {name}")
        assert rel_err(np32(tl.dinv), np32(jl.dinv)) <= VAL_TOL, f"L{i} dinv"
        assert (tl.cheb_lmax is None) == (jl.cheb_lmax is None)
        if tl.cheb_lmax is not None:
            assert rel_err(np32(tl.cheb_lmax), np32(jl.cheb_lmax)) <= VAL_TOL
    assert rel_err(np32(th.coarse_inv), np32(jh.coarse_inv)) <= DENSE_TOL
    assert th.tail_start == jh.tail_start
    assert (th.tail_op is None) == (jh.tail_op is None)
    if th.tail_op is not None:
        assert rel_err(np32(th.tail_op), np32(jh.tail_op)) <= DENSE_TOL
    for name in ("a0_lo", "a0_lo_band"):
        t, j = getattr(th, name), getattr(jh, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert np.array_equal(t.numpy(), np.asarray(j)), name
