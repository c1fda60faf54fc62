"""Sparse linear algebra on padded-ELL matrices.

Counterpart of ``raptor_tpu/ops/sparse_ops.py``: the gather SpMV of the
solve path, and the SpGEMM, transpose and filter of the device-level setup
(``setup/hierarchy.py``), all eager PyTorch on the matrices' device.  None
of them is a Pallas kernel in the reference, so the plain version is the
port.

SpGEMM output widths are data dependent: the expand -> merge scheme works
at a static output width ``k_out``, and the host wrappers (``spgemm``,
``ell_transpose``, ``ell_filter``) measure the exact width with one host
read first.

Out-of-range scatter targets (the reference's ``mode="drop"`` updates) go
to one extra dump row or slot that is sliced away, and every float scatter
writes unique positions.  Every float sum over the slot axis runs in slot
order, one slot at a time (``_slot_sum``, and the merges' slot-by-slot
scatters): torch's own reductions group their terms differently on the
CPU and on the card, and a last-bit difference in a Galerkin entry can
flip a strength test at a tie (``theta * row_max``) and with it a level's
C/F set.  In slot order the device route gives the same bits on every
device, and the same bits as the host route's NumPy and SciPy arithmetic
where the algorithms agree (direct interpolation, the geo chain).
"""

from __future__ import annotations

import dataclasses

import torch

from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.utils.profiling import phase

__all__ = ["spmv", "spmv_t", "spgemm", "spgemm_fixed", "rap",
           "ell_transpose", "ell_transpose_fixed", "ell_add", "ell_add_fixed",
           "ell_filter", "ell_filter_fixed"]


def _slot_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 one slot at a time, in slot order: NumPy's order for
    an axis-0 sum, and the same bits on every device."""
    s = x[0].clone()
    for k in range(1, x.shape[0]):
        s += x[k]
    return s


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------


def spmv(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  x has shape (..., n_cols_pad); y has (..., n_rows_pad):
    ``y[..., i] = sum_k data[k, i] * x[..., cols[k, i]]``.  Padding slots
    hold value 0 with a valid gather index, so no mask is needed.  A span
    ``ell.spmv[n_rows_pad,K,dtype]``."""
    with phase("ell.spmv", (A.data.shape[-1], A.K, A.data.dtype)):
        return (A.data * x[..., A.cols]).sum(-2)


def _drop(idx: torch.Tensor, valid: torch.Tensor, bound: int) -> torch.Tensor:
    """int64 scatter targets with every invalid one sent to the dump slot
    ``bound`` (one past the end of the real output)."""
    return torch.where(valid, idx, bound).long()


def spmv_t(A: EllMatrix, y: torch.Tensor) -> torch.Tensor:
    """x = A.T @ y by a scatter-add (where a stored transpose is not worth
    it).  y has length n_rows_pad; the result n_cols_pad.  The adds are
    float atomics on CUDA: not bit-reproducible there."""
    contrib = torch.where(A.slot_mask(), A.data * y[None, :], 0)
    tgt = _drop(A.cols, A.cols < A.n_cols_pad, A.n_cols_pad)
    out = torch.zeros(A.n_cols_pad + 1, dtype=A.dtype, device=A.data.device)
    out.index_add_(0, tgt.reshape(-1), contrib.reshape(-1))
    return out[: A.n_cols_pad]


# ---------------------------------------------------------------------------
# Row-wise merge machinery
# ---------------------------------------------------------------------------

# What one launch costs in the merge's two forms, in elements moved:
# scripts/bench_merge.py's fit on an H100 80GB HBM3 (700 W), 11.55 us a
# launch over 2.79 ps an element (see _merge_by_passes)
_MERGE_LAUNCH_ELEMS = 4_140_000


def _merge_costs(W: int, n: int, k_out: int, max_run: int) -> dict:
    """(launches, elements moved) of the run sum's two forms, counted from
    their code: by slot, W scatters of a row each; by pass, 8 launches
    over (W, n) set-up arrays, then 6 over (k_out + 1, n) a pass."""
    return {"slots": (W, W * n),
            "passes": (8 + 6 * max_run, (5 * W + 6 * max_run * (k_out + 1)) * n)}


def _merge_by_passes(W: int, n: int, k_out: int, max_run: int) -> bool:
    """Whether the per-term-position form of the run sum is expected to
    take less time than the per-slot form: launches times
    _MERGE_LAUNCH_ELEMS plus elements moved."""
    (ls, es), (lp, ep) = _merge_costs(W, n, k_out, max_run).values()
    return lp * _MERGE_LAUNCH_ELEMS + ep < ls * _MERGE_LAUNCH_ELEMS + es


def _sum_runs_by_slots(vals, pos, k_out: int):
    """(k_out + 1, n) run sums: one scatter a slot, in slot order."""
    W, n = vals.shape
    out = torch.zeros(k_out + 1, n, dtype=vals.dtype, device=vals.device)
    for w in range(W):
        out.scatter_add_(0, pos[w:w + 1], vals[w:w + 1])
    return out


def _sum_runs_by_passes(vals, pos, first, keep, k_out: int, max_run: int):
    """(k_out + 1, n) run sums: pass r adds each run's r-th term, so the
    adds are _sum_runs_by_slots' in the same order.  A run shorter than r
    adds 0.0, which leaves a sum that started at +0.0 unchanged."""
    W, n = vals.shape
    dev = vals.device
    slot = torch.arange(W, device=dev)[:, None].expand(W, n)
    start = torch.zeros(k_out + 1, n, dtype=torch.long, device=dev).scatter_(
        0, torch.where(first & keep, pos, k_out), slot)
    length = torch.zeros(k_out + 1, n, dtype=torch.int32, device=dev).scatter_add_(
        0, pos, keep.to(torch.int32))
    out = torch.zeros(k_out + 1, n, dtype=vals.dtype, device=dev)
    for r in range(max_run):
        term = vals.gather(0, (start + r).clamp(max=W - 1))
        out += torch.where(length > r, term, 0)
    return out


def _merge_sorted_rows(cols, vals, sentinel: int, k_out: int, max_run: int):
    """Merge duplicate columns in per-row sorted (W, n) col/val arrays.

    ``cols`` ascends along axis 0 within each row (a column of the array),
    with ``sentinel`` marking invalid slots (sorted to the end); no run of
    equal columns is longer than ``max_run`` (each caller bounds it from
    its operands).  Returns (out_cols, out_vals, row_nnz) at static width
    ``k_out``; runs beyond ``k_out`` are dropped.  A run's values are
    summed in slot order, one term at a time, so the sum does not depend
    on float atomics: by slot or by term position, whichever
    _merge_by_passes expects to be faster (the same bits)."""
    W, n = cols.shape
    first = torch.ones_like(cols, dtype=torch.bool)
    first[1:] = cols[1:] != cols[:-1]
    is_real = cols < sentinel
    newrun = first & is_real
    run = torch.cumsum(newrun, 0, dtype=torch.int32) - 1
    keep = is_real & (run < k_out)
    pos = torch.where(keep, run, k_out).long()
    if _merge_by_passes(W, n, k_out, max_run):
        out_vals = _sum_runs_by_passes(vals, pos, newrun, keep, k_out, max_run)
    else:
        out_vals = _sum_runs_by_slots(vals, pos, k_out)
    # every slot of a run carries the run's column
    out_cols = torch.zeros(k_out + 1, n, dtype=cols.dtype,
                           device=cols.device).scatter_(0, pos, cols)
    row_nnz = newrun.sum(0, dtype=torch.int32)
    return out_cols[:k_out], out_vals[:k_out], row_nnz


def _fix_padding_cols(cols, row_nnz):
    """Point padding slots at column 0 (value-0 semantics; stays valid if
    the logical column space is tightened after setup)."""
    k = torch.arange(cols.shape[0], device=cols.device)[:, None]
    return torch.where(k < row_nnz[None, :], cols, 0)


def _distinct_max(cols, sent: int) -> torch.Tensor:
    """Max over rows of the number of distinct non-sentinel values in the
    (W, n) ``cols`` (0-d int64 tensor).  The reference counts rounds of
    per-row min retirement until every row is empty, which is the same
    number; a sort counts it with no host read."""
    s = torch.sort(cols, dim=0).values
    new = s < sent
    new[1:] &= s[1:] != s[:-1]
    return new.sum(0).max()


# ---------------------------------------------------------------------------
# SpGEMM
# ---------------------------------------------------------------------------

def _expand_candidates(A: EllMatrix, B: EllMatrix, with_vals: bool = True):
    """Expand phase of SpGEMM: per A slot (a_ik at col k) gather B's row k,
    yielding (Ka*Kb, n) candidate columns (sentinel = invalid) and
    products, A's slot major: the terms of one output entry come in A's
    slot order (ascending k), SciPy's order for a CSR product."""
    Ka, n = A.data.shape
    Kb = B.K
    sent = B.n_cols_pad
    ac = A.cols.long()
    kb = torch.arange(Kb, device=ac.device)[None, :, None]
    valid = A.slot_mask()[:, None, :] & (kb < B.row_nnz[ac][:, None, :])
    cols = torch.where(valid, B.cols[:, ac].transpose(0, 1), sent)
    if not with_vals:
        return cols.reshape(Ka * Kb, n), None, sent
    vals = torch.where(valid, A.data[:, None, :] * B.data[:, ac].transpose(0, 1), 0)
    return cols.reshape(Ka * Kb, n), vals.reshape(Ka * Kb, n), sent


def _sort_merge(cols, vals, sent: int, k_out: int, max_run: int):
    """Merge duplicate candidate columns into rows of width ``k_out``: a
    stable sort of each row's candidates, then ``_merge_sorted_rows``, so
    duplicates are summed in candidate order.  The reference merges by
    k_out rounds of min extraction (``_min_extract_merge``), which sums
    each column's candidates with one masked reduction; the columns, their
    order and the counts are the same.  Returns (out_cols, out_vals,
    row_nnz, leftover), ``leftover`` (0-d) the most distinct columns of a
    row that did not fit in k_out (0 = exact)."""
    cols, order = torch.sort(cols, dim=0, stable=True)
    oc, ov, runs = _merge_sorted_rows(cols, vals.gather(0, order), sent, k_out,
                                      max_run)
    return oc, ov, runs.clamp(max=k_out), (runs - k_out).clamp(min=0).max()


# Memory fence for the expand phase: the (Ka*Kb, n) candidate arrays are
# the peak allocation of the setup.  Above this element count the
# expand+merge runs over row chunks, with identical results.
_EXPAND_ELEM_BUDGET = 1 << 26  # 64M elements = 256 MiB per (W, chunk) fp32 buffer


def _row_chunk_plan(W: int, n: int):
    """(n_chunks, chunk) splitting the row axis so W*chunk stays under the
    budget, or None when no chunking is needed.  chunk is a multiple of
    128."""
    if W * n <= _EXPAND_ELEM_BUDGET or n <= 128:
        return None
    n_chunks = -(-(W * n) // _EXPAND_ELEM_BUDGET)
    chunk = ((-(-n // n_chunks) + 127) // 128) * 128
    return -(-n // chunk), chunk


def _chunked_rows(A: EllMatrix, B: EllMatrix, n_chunks: int,
                  chunk: int) -> list:
    """A cut into ``n_chunks`` row blocks of ``chunk`` rows (the last one
    shorter), each an EllMatrix whose products with B are the matching
    rows of A @ B."""
    out = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, A.n_rows_pad)
        out.append(EllMatrix(
            data=A.data[:, lo:hi], cols=A.cols[:, lo:hi],
            row_nnz=A.row_nnz[lo:hi], shape=(hi - lo, B.shape[1]),
            n_rows_pad=hi - lo, n_cols_pad=B.n_cols_pad))
    return out


def _spgemm_core(A: EllMatrix, B: EllMatrix, k_out: int):
    """Expand + merge under the memory fence (shared by the wrappers and
    the level programs of setup/hierarchy.py).  B's rows hold distinct
    columns, as every operand the setup builds does (merged products,
    interpolation and strength patterns)."""
    plan = _row_chunk_plan(A.K * B.K, A.n_rows_pad)
    # a column appears at most once a slot of A (B's rows hold distinct
    # columns): no run is longer than A.K
    parts = [_sort_merge(*_expand_candidates(Ac, B), k_out, max_run=A.K)
             for Ac in ([A] if plan is None else _chunked_rows(A, B, *plan))]
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1),
            torch.cat([p[2] for p in parts]),
            torch.stack([p[3] for p in parts]).max())


def _spgemm_fixed_full(A: EllMatrix, B: EllMatrix, k_out: int):
    """(C = A @ B at width k_out, leftover) — see ``_sort_merge``."""
    out_cols, out_vals, row_nnz, leftover = _spgemm_core(A, B, k_out)
    C = EllMatrix(data=out_vals, cols=_fix_padding_cols(out_cols, row_nnz),
                  row_nnz=row_nnz, shape=(A.shape[0], B.shape[1]),
                  n_rows_pad=A.n_rows_pad, n_cols_pad=B.n_cols_pad)
    return C, leftover


def spgemm_fixed(A: EllMatrix, B: EllMatrix, k_out: int) -> EllMatrix:
    """C = A @ B at static output width ``k_out``: expand (gather B's rows
    per A slot), then merge; rows with more than ``k_out`` distinct columns
    silently truncate (``spgemm`` measures the width)."""
    return _spgemm_fixed_full(A, B, k_out)[0]


def _spgemm_width(A: EllMatrix, B: EllMatrix) -> torch.Tensor:
    """Max distinct columns of any row of A @ B (0-d tensor), under the
    same memory fence as ``_spgemm_core``."""
    plan = _row_chunk_plan(A.K * B.K, A.n_rows_pad)
    widths = []
    for Ac in [A] if plan is None else _chunked_rows(A, B, *plan):
        cols, _, sent = _expand_candidates(Ac, B, with_vals=False)
        widths.append(_distinct_max(cols, sent))
    return torch.stack(widths).max()


def spgemm(A: EllMatrix, B: EllMatrix, k_out: int | None = None) -> EllMatrix:
    """C = A @ B at its exact output width (one host read to measure it)."""
    if k_out is None:
        k_out = max(int(_spgemm_width(A, B)), 1)
    return spgemm_fixed(A, B, k_out)


def rap(R: EllMatrix, A: EllMatrix, P: EllMatrix) -> EllMatrix:
    """Galerkin coarse operator A_c = R @ A @ P."""
    return spgemm(R, spgemm(A, P))


# ---------------------------------------------------------------------------
# Transpose
# ---------------------------------------------------------------------------

def _transpose_col_counts(A: EllMatrix) -> torch.Tensor:
    """(n_cols_pad,) int32: the real entries in each column of A."""
    m = A.n_cols_pad
    tgt = _drop(A.cols, A.slot_mask() & (A.cols < m), m).reshape(-1)
    counts = torch.zeros(m + 1, dtype=torch.int32, device=tgt.device)
    counts.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    return counts[:m]


def ell_transpose_fixed(A: EllMatrix, k_out: int) -> EllMatrix:
    """A.T at static output width ``k_out``.

    One sort of the real entries by (column, source row): output row c (=
    A's column c) holds A's entries in column c in ascending source row,
    the first ``k_out`` of them (a wider column truncates silently; its
    ``row_nnz`` keeps the full count).  Output rows come out
    column-sorted, as the reference's rounds of per-column minimum
    placement leave them; values are moved, never summed."""
    m = A.n_cols_pad
    dev = A.data.device
    keep = A.slot_mask() & (A.cols < m)
    cols = A.cols[keep].long()
    src = torch.arange(A.n_rows_pad, device=dev).expand(A.K, -1)[keep]
    key, order = torch.sort(cols * A.n_rows_pad + src)
    col = torch.div(key, A.n_rows_pad, rounding_mode="floor")
    row_nnz = _transpose_col_counts(A)
    start = torch.cumsum(row_nnz.long(), 0) - row_nnz.long()
    slot = torch.arange(key.numel(), device=dev) - start[col]
    fit = slot < k_out
    out_data = torch.zeros(k_out, m, dtype=A.dtype, device=dev)
    out_cols = torch.zeros(k_out, m, dtype=torch.int32, device=dev)
    out_data[slot[fit], col[fit]] = A.data[keep][order][fit]
    out_cols[slot[fit], col[fit]] = (key - col * A.n_rows_pad)[fit].to(
        torch.int32)
    return EllMatrix(data=out_data, cols=_fix_padding_cols(out_cols, row_nnz),
                     row_nnz=row_nnz, shape=(A.shape[1], A.shape[0]),
                     n_rows_pad=A.n_cols_pad, n_cols_pad=A.n_rows_pad)


def ell_transpose(A: EllMatrix, k_out: int | None = None) -> EllMatrix:
    """A.T at its exact width (one host read to measure it)."""
    if k_out is None:
        k_out = max(int(_transpose_col_counts(A).max()), 1)
    return ell_transpose_fixed(A, k_out)


# ---------------------------------------------------------------------------
# Addition (pattern union)
# ---------------------------------------------------------------------------

def ell_add_fixed(A: EllMatrix, B: EllMatrix, k_out: int, alpha: float = 1.0,
                  beta: float = 1.0) -> EllMatrix:
    """alpha*A + beta*B at static output width ``k_out`` (same padded
    shapes).  A column present in both sums A's term and then B's."""
    assert A.n_rows_pad == B.n_rows_pad and A.n_cols_pad == B.n_cols_pad
    sent = A.n_cols_pad
    am, bm = A.slot_mask(), B.slot_mask()
    cols = torch.cat([torch.where(am, A.cols, sent),
                      torch.where(bm, B.cols, sent)])
    vals = torch.cat([torch.where(am, alpha * A.data, 0),
                      torch.where(bm, beta * B.data.to(A.dtype), 0)])
    cols, order = torch.sort(cols, dim=0, stable=True)
    # a row of A and a row of B each hold a column once
    oc, ov, nnz = _merge_sorted_rows(cols, vals.gather(0, order), sent, k_out,
                                     max_run=2)
    return EllMatrix(data=ov, cols=_fix_padding_cols(oc, nnz), row_nnz=nnz,
                     shape=A.shape, n_rows_pad=A.n_rows_pad,
                     n_cols_pad=A.n_cols_pad)


def ell_add(A: EllMatrix, B: EllMatrix, alpha: float = 1.0,
            beta: float = 1.0) -> EllMatrix:
    """alpha*A + beta*B at width A.K + B.K (no host read)."""
    return ell_add_fixed(A, B, k_out=A.K + B.K, alpha=alpha, beta=beta)


# ---------------------------------------------------------------------------
# Sparsification
# ---------------------------------------------------------------------------

def ell_filter_fixed(A: EllMatrix, tol: float, k_out: int) -> EllMatrix:
    """Drop off-diagonal entries with |a_ij| < tol * sqrt(|a_ii a_jj|) and
    lump them into the diagonal (row sums kept).  The symmetric criterion
    keeps a symmetric operator symmetric."""
    row = A.row_index()
    sm = A.slot_mask()
    off = (A.cols != row) & sm
    mag = torch.where(off, A.data.abs(), 0)
    dabs = A.diagonal().abs()
    scale = torch.sqrt(dabs[None, :]
                       * dabs[A.cols.long().clamp(0, dabs.shape[0] - 1)])
    drop = off & (mag < tol * scale)
    lump = _slot_sum(torch.where(drop, A.data, 0))
    keep = sm & ~drop
    sent = A.n_cols_pad
    cols = torch.where(keep, A.cols, sent)
    is_diag = keep & (A.cols == row)
    vals = torch.where(keep, A.data + torch.where(is_diag, lump[None, :], 0), 0)
    cols, order = torch.sort(cols, dim=0, stable=True)
    # a compaction: the kept entries' columns are distinct
    oc, ov, nnz = _merge_sorted_rows(cols, vals.gather(0, order), sent, k_out,
                                     max_run=1)
    return EllMatrix(data=ov, cols=_fix_padding_cols(oc, nnz), row_nnz=nnz,
                     shape=A.shape, n_rows_pad=A.n_rows_pad,
                     n_cols_pad=A.n_cols_pad)


def ell_filter(A: EllMatrix, tol: float) -> EllMatrix:
    """Filter, then compact to the measured max width (one host read)."""
    if tol <= 0:
        return A
    F = ell_filter_fixed(A, tol, A.K)
    k = max(int(F.row_nnz.max()), 1)
    if k == A.K:
        return F
    return dataclasses.replace(F, data=F.data[:k], cols=F.cols[:k])
