"""C/F splittings: PMIS on the device and the serial Ruge-Stüben
splitting on the host.

Counterpart of ``raptor_tpu/setup/splitting.py``.  PMIS weights are exact
integers, ``w_i = min(lambda_i, 63) * n_pad + perm_i``, with ``perm`` drawn
from NumPy's ``default_rng`` (never torch's generator), so the C/F sets are
the reference's bit for bit.  ``pmis_splitting`` runs its Luby rounds as
tensor ops on the matrix's device, one host read per round.
"""

from __future__ import annotations

import numpy as np
import torch

from raptor_tpu_torch.core.ell import EllMatrix

__all__ = ["UNDECIDED", "C_PT", "F_PT", "make_perm_np", "make_perm_ids_np",
           "make_perm", "make_perm_ids", "splitting_weights",
           "pmis_splitting", "rs_splitting_host"]

UNDECIDED, C_PT, F_PT = 0, 1, 2

# w = min(lam, 63) * n_pad + perm stays exact in int32 only while
# 64 * n_pad < 2^31; int64 beyond
_MAX_INT32_ROWS = (2**31) // 64

# the reference's cap on PMIS rounds
_MAX_PMIS_ROUNDS = 1000


def make_perm_np(n: int, n_pad: int, seed: int = 0) -> np.ndarray:
    """Random permutation tie-break weights; padding rows get the tail values
    (they are isolated and forced F regardless)."""
    perm = np.empty(n_pad, dtype=np.int32)
    perm[:n] = np.random.default_rng(seed).permutation(n)
    perm[n:] = np.arange(n, n_pad)
    return perm


def make_perm_ids_np(ids: np.ndarray, n_pad: int, seed: int = 0) -> np.ndarray:
    """Permutation-invariant tie-break weights: row i gets the random value
    its original id would get in the unpermuted run, so the PMIS outcome is
    the same C/F set whatever ordering the hierarchy is built in."""
    n = ids.shape[0]
    base = np.random.default_rng(seed).permutation(n).astype(np.int32)
    rank = np.argsort(np.argsort(ids, kind="stable"), kind="stable")
    perm = np.empty(n_pad, dtype=np.int32)
    perm[:n] = base[rank]
    perm[n:] = np.arange(n, n_pad)
    return perm


def make_perm(n: int, n_pad: int, seed: int = 0, *, device) -> torch.Tensor:
    """``make_perm_np`` as an int32 tensor on ``device``."""
    return torch.from_numpy(make_perm_np(n, n_pad, seed)).to(device)


def make_perm_ids(ids: np.ndarray, n_pad: int, seed: int = 0, *,
                  device) -> torch.Tensor:
    """``make_perm_ids_np`` as an int32 tensor on ``device``."""
    return torch.from_numpy(make_perm_ids_np(ids, n_pad, seed)).to(device)


def splitting_weights(lam: torch.Tensor, perm: torch.Tensor,
                      n_pad: int) -> torch.Tensor:
    """Exact total-order MIS weights ``min(lam, 63) * n_pad + perm``: int32
    up to ``_MAX_INT32_ROWS`` rows, int64 beyond."""
    dt = torch.int32 if n_pad <= _MAX_INT32_ROWS else torch.int64
    return lam.clamp(max=63).to(dt) * n_pad + perm.to(dt)


def pmis_splitting(A: EllMatrix, smask: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
    """PMIS C/F splitting on A's device.  Returns (n_pad,) int32 in {C_PT,
    F_PT} (UNDECIDED only if the round cap is hit).  Each round: an
    undecided point whose weight beats every undecided strong neighbour
    (both directions) becomes C, then the undecided strong neighbours of C
    become F."""
    from raptor_tpu_torch.setup.strength import strong_transpose_counts

    n = A.n_rows_pad
    dev = A.data.device
    lam = strong_transpose_counts(A, smask)
    w = splitting_weights(lam, perm, n)
    cols = A.cols.long()
    tgt = torch.where(smask, cols, n).reshape(-1)  # n = the dump slot
    iso = ~smask.any(0) & (lam == 0)
    cf = torch.where(iso, F_PT, UNDECIDED).to(torch.int32)
    it = 0
    while it < _MAX_PMIS_ROUNDS and bool((cf == UNDECIDED).any()):
        und = cf == UNDECIDED
        w_und = torch.where(und, w, -1)
        # max undecided-neighbour weight over S_i (deps) and S^T_i (dependents)
        row_part = torch.where(smask, w_und[cols], -1).amax(0)
        edge_w = torch.where(smask, w_und[None, :], -1).reshape(-1)
        col_part = torch.full((n + 1,), -1, dtype=w.dtype, device=dev)
        col_part = col_part.scatter_reduce_(0, tgt, edge_w, "amax")[:n]
        cf = torch.where(und & (w > torch.maximum(row_part, col_part)), C_PT, cf)
        c = cf == C_PT
        c_row = (smask & c[cols]).any(0)
        edge_c = (smask & c[None, :]).to(torch.int32).reshape(-1)
        c_col = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        c_col = c_col.scatter_reduce_(0, tgt, edge_c, "amax")[:n] > 0
        cf = torch.where((cf == UNDECIDED) & (c_row | c_col), F_PT, cf)
        it += 1
    return cf


def rs_splitting_host(S_csr) -> np.ndarray:
    """Serial classical Ruge-Stüben first-pass splitting (host).

    Runs the native C++ kernel (``native/host_kernels.cpp``) when it builds,
    else the interpreted loop below, which gives the same splitting."""
    from raptor_tpu_torch.utils.native import rs_splitting_native

    cf_native = rs_splitting_native(S_csr)
    if cf_native is not None:
        return cf_native

    import heapq

    import scipy.sparse as sp

    S = sp.csr_matrix(S_csr)
    n = S.shape[0]
    St = S.T.tocsr()
    lam = np.asarray(St.sum(axis=1)).ravel().astype(np.float64)
    cf = np.full(n, UNDECIDED, dtype=np.int8)
    iso = (lam == 0) & (np.diff(S.indptr) == 0)
    cf[iso] = F_PT

    heap = [(-lam[i], i) for i in range(n) if cf[i] == UNDECIDED]
    heapq.heapify(heap)
    while heap:
        negw, i = heapq.heappop(heap)
        if cf[i] != UNDECIDED or -negw != lam[i]:
            continue
        cf[i] = C_PT
        for j in St.indices[St.indptr[i]: St.indptr[i + 1]]:
            if cf[j] == UNDECIDED:
                cf[j] = F_PT
                for k in S.indices[S.indptr[j]: S.indptr[j + 1]]:
                    if cf[k] == UNDECIDED:
                        lam[k] += 1
                        heapq.heappush(heap, (-lam[k], k))
    cf[cf == UNDECIDED] = F_PT
    return cf.astype(np.int32)
