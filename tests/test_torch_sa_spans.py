"""The smoothed-aggregation set-up's spans and the block applies' spans and
counter (``setup/aggregation.py``, ``core/bell.py``), on the CPU at small
sizes: config 4's preset on the device route (``host_setup_threshold`` 0)
over elasticity.

* The set-up's stages nest in ``setup.sa.level[k]``, under the fenced
  ``setup.algebraic`` root, and ``setup.coarse_inverse`` follows them.
* A recorded W-cycle holds ``bell.spmv`` and ``bell.prec`` spans, one a
  call that ``bell.launches`` counts.
* The aggregation's host read is counted under ``sa.aggregate``.
* Recording changes no arithmetic: a hierarchy and a solve are bit-equal
  with it on and off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import raptor_tpu_torch.api as api
from raptor_tpu_torch.config import PRESETS
from raptor_tpu_torch.core import bell
from raptor_tpu_torch.gallery import elasticity_3d
from raptor_tpu_torch.solve import krylov
from raptor_tpu_torch.solve.cycle import cycle
from raptor_tpu_torch.utils.profiling import recording

CFG = dataclasses.replace(PRESETS["config4"], host_setup_threshold=0)
STAGES = ("setup.sa.condense", "setup.sa.strength", "setup.sa.aggregate",
          "setup.sa.tentative", "setup.sa.smooth_p", "setup.sa.transpose",
          "setup.sa.rap")


def _tree(rec) -> dict:
    """{name: set of parent names} of a recording."""
    out: dict = {}
    for s in rec.spans:
        parent = rec.spans[s.parent].name if s.parent >= 0 else None
        out.setdefault(s.name, set()).add(parent)
    return out


def _rhs(h, n, seed=0):
    b = torch.zeros(h.levels[0].A.n_rows_pad)
    b[:n] = torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32))
    return b


@pytest.fixture(scope="module")
def elasticity():
    A, B, _ = elasticity_3d(6)
    return A, B


def test_sa_setup_spans_enclose_every_stage(elasticity):
    A, B = elasticity
    krylov.host_reads.clear()
    with recording() as rec:
        h = api.setup(A.copy(), CFG, B=B, device="cpu")
    t = _tree(rec)
    assert [s.name for s in rec.roots()] == ["setup.algebraic"]
    assert rec.roots()[0].fenced
    nl = len(h.levels)
    assert nl >= 2
    levels = {f"setup.sa.level[{k}]" for k in range(nl)}
    assert {n for n in t if n.startswith("setup.sa.level")} == levels
    assert all(t[n] == {"setup.algebraic"} for n in levels)
    assert t["setup.ell"] == {"setup.algebraic"}
    built = levels - {f"setup.sa.level[{nl - 1}]"}
    for name in STAGES:
        assert t[name] == built, name
    for name in ("setup.sa.smoother", "setup.sa.block_layout"):
        assert t[name] == levels, name
    assert t["setup.coarse_inverse"] == {"setup.algebraic"}
    # the stages are timed between fences, the level spans too
    assert all(s.fenced for s in rec.spans if s.name.startswith("setup.sa."))
    # every stage closes before the coarse inverse starts
    inv = next(s for s in rec.spans if s.name == "setup.coarse_inverse")
    assert all(s.end_ns <= inv.start_ns for s in rec.spans
               if s.name.startswith("setup.sa."))
    # one aggregation read a level tried (the built ones; the coarsest
    # level is not aggregated when it is at most coarse_size)
    assert krylov.host_reads["sa.aggregate"] >= nl - 1


def test_block_applies_carry_spans_and_counts(elasticity):
    A, B = elasticity
    h = api.setup(A.copy(), CFG, B=B, device="cpu")
    assert h.levels[0].Abell is not None and h.config.cycle == "W"
    b = _rhs(h, A.shape[0])
    bell.launches.clear()
    with recording() as rec:
        cycle(h, b)
    t = _tree(rec)
    A0 = h.levels[0].Abell
    spmv0 = f"bell.spmv[{A0.nb_pad},{A0.K},3,float32]"
    prec0 = f"bell.prec[{A0.nb_pad},3,float32]"
    assert t[spmv0] == {"vcycle.smooth[0]", "vcycle.residual[0]"}
    assert t[prec0] == {"vcycle.smooth[0]"}
    names = [s.name for s in rec.spans]
    deg = CFG.cheb_degree
    # block Chebyshev: degree - 1 applies before, the residual, degree after
    assert names.count(spmv0) == 2 * deg and names.count(prec0) == 2 * deg
    assert bell.launches["bell_spmv"] == sum(
        n.startswith("bell.spmv[") for n in names)
    assert bell.launches["bell_prec"] == sum(
        n.startswith("bell.prec[") for n in names)


def _leaves(x, path="h"):
    """(path, tensor or array) of every array a hierarchy holds."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        yield path, x
    elif dataclasses.is_dataclass(x) and not isinstance(x, type):
        for f in dataclasses.fields(x):
            yield from _leaves(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}[{i}]")


def test_recording_changes_no_arithmetic(elasticity):
    A, B = elasticity
    h0 = api.setup(A.copy(), CFG, B=B, device="cpu")
    b = _rhs(h0, A.shape[0], seed=3)
    x0 = api.solve_hier_refined(h0, b, tol=1e-8)
    with recording():
        h1 = api.setup(A.copy(), CFG, B=B, device="cpu")
        x1 = api.solve_hier_refined(h1, b, tol=1e-8)
    l0, l1 = list(_leaves(h0)), list(_leaves(h1))
    assert [p for p, _ in l0] == [p for p, _ in l1] and len(l0) > 20
    for (p, u), (_, v) in zip(l0, l1):
        same = (torch.equal(u, v) if isinstance(u, torch.Tensor)
                else np.array_equal(u, v))
        assert same, p
    (xh0, xl0), rel0, it0 = x0
    (xh1, xl1), rel1, it1 = x1
    assert torch.equal(xh0, xh1) and torch.equal(xl0, xl1)
    assert float(rel0) == float(rel1) <= 1e-8 and int(it0) == int(it1)


# ---------------------------------------------------------------------------
# The set-up's repairs against the routes they replaced
# ---------------------------------------------------------------------------

def _round_transpose(A, k_out):
    """The transpose that ``ell_transpose_fixed`` replaced, as it was:
    rounds of per-column minimum placement, one round an output slot."""
    from raptor_tpu_torch.core.ell import EllMatrix
    from raptor_tpu_torch.ops.sparse_ops import (_drop, _fix_padding_cols,
                                                 _transpose_col_counts)

    m = A.n_cols_pad
    sent = A.n_rows_pad
    dev = A.data.device
    valid = A.slot_mask()
    src = A.row_index().to(torch.int32)
    tgt = _drop(A.cols, valid, m)
    tgt_c = tgt.clamp(max=m - 1)
    flat_tgt = tgt.reshape(-1)
    data_flat, src_flat = A.data.reshape(-1), src.reshape(-1)
    out_data = torch.zeros(k_out, m, dtype=A.dtype, device=dev)
    out_cols = torch.zeros(k_out, m, dtype=torch.int32, device=dev)
    active = valid.clone()
    for r in range(k_out):
        key = torch.where(active, src, sent)
        minv = torch.full((m + 1,), sent, dtype=torch.int32, device=dev)
        minv.scatter_reduce_(0, flat_tgt, key.reshape(-1), "amin")
        minv = minv[:m]
        sel = active & (key == minv[tgt_c])
        dst = torch.where(sel, tgt, m).reshape(-1)
        vbuf = torch.zeros(m + 1, dtype=A.dtype, device=dev).scatter_(
            0, dst, data_flat)
        cbuf = torch.zeros(m + 1, dtype=torch.int32, device=dev).scatter_(
            0, dst, src_flat)
        placed = minv < sent
        out_data[r] = torch.where(placed, vbuf[:m], 0)
        out_cols[r] = torch.where(placed, cbuf[:m], 0)
        active &= ~sel
    row_nnz = _transpose_col_counts(A)
    return EllMatrix(data=out_data, cols=_fix_padding_cols(out_cols, row_nnz),
                     row_nnz=row_nnz, shape=(A.shape[1], A.shape[0]),
                     n_rows_pad=A.n_cols_pad, n_cols_pad=A.n_rows_pad)


def _host_ell_to_bell(E, bs):
    """The block layout that ``ell_to_bell`` replaced: through SciPy's CSR
    and BSR on the host, then to E's device when E holds tensors."""
    from raptor_tpu_torch.core.ell import _np, ell_to_csr

    out = bell.bell_from_bsr(ell_to_csr(E), bs=bs,
                             dtype=_np(E.data[:1, :1]).dtype,
                             row_pad_multiple=E.n_rows_pad // bs)
    return out.to(E.data.device) if isinstance(E.data, torch.Tensor) else out


def _same(a, b, fields):
    for f in fields:
        u, v = getattr(a, f), getattr(b, f)
        if isinstance(u, torch.Tensor):
            assert isinstance(v, torch.Tensor) and u.dtype == v.dtype, f
            assert torch.equal(u, v), f
        elif isinstance(u, np.ndarray):
            assert isinstance(v, np.ndarray) and u.dtype == v.dtype, f
            assert np.array_equal(u, v), f
        else:
            assert u == v, f


ELL_FIELDS = ("data", "cols", "row_nnz", "shape", "n_rows_pad", "n_cols_pad")
BELL_FIELDS = ("data", "cols", "row_nnz", "shape", "bs", "nb_pad")


def _random_ell(seed, n=37, m=29, K=7, n_pad=48, m_pad=40, dump=False,
                unsorted=False):
    """An ELL with padding slots, padding rows, explicit zeros, rows of
    distinct columns (optionally out of order) and, with ``dump``, real
    entries pointing at column n_cols_pad (the dropped column)."""
    from raptor_tpu_torch.core.ell import EllMatrix

    g = torch.Generator().manual_seed(seed)
    cols = torch.zeros(K, n_pad, dtype=torch.int32)
    nnz = torch.randint(0, K + 1, (n_pad,), generator=g).to(torch.int32)
    hi = m_pad + 1 if dump else m
    for i in range(n_pad):
        c = torch.randperm(hi, generator=g)[:K]
        cols[:, i] = c if unsorted else torch.sort(c).values
    data = torch.randn(K, n_pad, generator=g)
    data[torch.rand(K, n_pad, generator=g) < 0.1] = 0.0
    return EllMatrix(data=data, cols=cols, row_nnz=nnz, shape=(n, m),
                     n_rows_pad=n_pad, n_cols_pad=m_pad)


@pytest.mark.parametrize("seed,dump,cut", [(0, False, 0), (1, True, 0),
                                           (2, False, 3), (3, True, 2)])
def test_sorted_transpose_is_the_round_transpose(seed, dump, cut):
    from raptor_tpu_torch.ops.sparse_ops import (_transpose_col_counts,
                                                 ell_transpose_fixed)

    A = _random_ell(seed, dump=dump, unsorted=bool(seed % 2))
    k = int(_transpose_col_counts(A).max()) - cut  # cut > 0: truncated
    _same(ell_transpose_fixed(A, k), _round_transpose(A, k), ELL_FIELDS)


@pytest.mark.parametrize("bs,seed", [(3, 0), (3, 1), (6, 2)])
def test_device_block_layout_is_the_host_one(bs, seed):
    """Rows of one block row with different patterns, out-of-order slots,
    explicit zeros, padding rows: the same arrays as SciPy's BSR, for
    tensors and for NumPy leaves."""
    from raptor_tpu_torch.core.ell import EllMatrix

    A = _random_ell(seed, n=36, m=36, K=9, n_pad=48, m_pad=48,
                    unsorted=True)
    A = dataclasses.replace(A, shape=(36, 36))
    if bs == 6:
        A = dataclasses.replace(A, data=A.data.double())
    _same(bell.ell_to_bell(A, bs), _host_ell_to_bell(A, bs), BELL_FIELDS)
    An = EllMatrix(data=A.data.numpy(), cols=A.cols.numpy(),
                   row_nnz=A.row_nnz.numpy(), shape=A.shape,
                   n_rows_pad=A.n_rows_pad, n_cols_pad=A.n_cols_pad)
    _same(bell.ell_to_bell(An, bs), _host_ell_to_bell(An, bs), BELL_FIELDS)


def test_repaired_sa_setup_gives_the_old_levels(elasticity, monkeypatch):
    """The SA hierarchy (every level's operators, transfers, block layouts,
    smoother data, the tail) with the sorted transpose and the device
    block layout is the one the round transpose and the host block layout
    gave, bit for bit; each block level's layout is the host one; and the
    fp32 remainder split on the card is ``attach_residual_lo``'s."""
    import raptor_tpu_torch.ops.sparse_ops as so
    from raptor_tpu_torch.setup.hierarchy import attach_residual_lo

    A, B = elasticity
    h_new = api.setup(A.copy(), CFG, B=B, device="cpu")
    assert h_new.a0_lo is not None
    host_lo = attach_residual_lo(dataclasses.replace(h_new, a0_lo=None),
                                 A).a0_lo
    assert torch.equal(h_new.a0_lo, host_lo)
    for lv in h_new.levels:
        if lv.Abell is not None:
            _same(lv.Abell, _host_ell_to_bell(lv.A, lv.Abell.bs), BELL_FIELDS)
        if lv.R is not None:
            _same(lv.R, _round_transpose(lv.P, lv.R.K), ELL_FIELDS)
    monkeypatch.setattr(so, "ell_transpose_fixed", _round_transpose)
    monkeypatch.setattr(bell, "ell_to_bell", _host_ell_to_bell)
    h_old = api.setup(A.copy(), CFG, B=B, device="cpu")
    l0, l1 = list(_leaves(h_old)), list(_leaves(h_new))
    assert [p for p, _ in l0] == [p for p, _ in l1]
    for (p, u), (_, v) in zip(l0, l1):
        assert torch.equal(u, v), p


def _slot_chain(A, lo, xh, bh, bl, v):
    """The gather-chain df64 residual as it was: one slot at a time."""
    from raptor_tpu_torch.utils.df64 import df_add, two_prod

    rh, rl = df_add(bh, bl, -v, torch.zeros_like(v))
    for k in range(A.K):
        gh = xh[A.cols[k]]
        ph, pe = two_prod(A.data[k], gh)
        if lo is not None:
            pe = pe + lo[k] * gh
        rh, rl = df_add(rh, rl, -ph, -pe)
    return rh, rl



@pytest.mark.parametrize("slots", [1, 7, 81], ids=["slot", "groups", "whole"])
@pytest.mark.parametrize("with_lo", [True, False])
def test_grouped_residual_is_the_slot_chain(elasticity, monkeypatch, slots,
                                            with_lo):
    """The gather-chain df64 residual, its products taken a group of slots
    at a time, gives the slot-by-slot chain's pair bit for bit, with the
    fp32 remainder and without."""
    A, B = elasticity
    h = api.setup(A.copy(), CFG, B=B, device="cpu")
    E, lo = h.levels[0].A, (h.a0_lo if with_lo else None)
    n = E.n_rows_pad
    assert E.K == 81 and h.a0_lo is not None
    g = torch.Generator().manual_seed(7)
    xh, bh, v = (torch.randn(n, generator=g) for _ in range(3))
    bl = torch.randn(n, generator=g) * 1e-8
    monkeypatch.setattr(api, "RESIDUAL_GROUP_ELEMS", slots * n)
    got = api._gather_df64_residual(E, lo, xh, bh, bl, v)
    want = _slot_chain(E, lo, xh, bh, bl, v)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_grouped_residual_leaves_the_solve_as_it_was(elasticity,
                                                     monkeypatch):
    A, B = elasticity
    h = api.setup(A.copy(), CFG, B=B, device="cpu")
    b = _rhs(h, A.shape[0], seed=5)
    out = []
    for elems in (1, 1 << 26):  # a slot a group, as the chain was; all
        monkeypatch.setattr(api, "RESIDUAL_GROUP_ELEMS", elems)
        out.append(api.solve_hier_refined(h, b, tol=1e-8))
    ((h0, l0), r0, i0), ((h1, l1), r1, i1) = out
    assert torch.equal(h0, h1) and torch.equal(l0, l1)
    assert float(r0) == float(r1) <= 1e-8 and int(i0) == int(i1)
