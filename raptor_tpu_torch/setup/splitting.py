"""C/F splitting helpers on the host: PMIS tie-break permutations and the
serial Ruge-Stüben splitting.

Counterpart of the NumPy part of ``raptor_tpu/setup/splitting.py``.  PMIS
weights are exact integers, ``w_i = min(lambda_i, 63) * n_pad + perm_i``,
with ``perm`` drawn from NumPy's ``default_rng``, so the C/F sets are the
reference's bit for bit.  The jitted device PMIS waits for the device-level
setup.
"""

from __future__ import annotations

import numpy as np

__all__ = ["UNDECIDED", "C_PT", "F_PT", "make_perm_np", "make_perm_ids_np",
           "rs_splitting_host"]

UNDECIDED, C_PT, F_PT = 0, 1, 2


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
