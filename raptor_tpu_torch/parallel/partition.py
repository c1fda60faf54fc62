"""Row partitioning and halo-exchange plans of the algebraic sharded solve.

Counterpart of ``raptor_tpu/parallel/partition.py`` (RAPtor's
``Partition``/``ParComm`` construction).  Plans are built on the host from
the global ELL structure, once, at setup: ``plan_and_remap`` is the
reference's NumPy structure pass as it is.  The execution model
(``parallel/halo.py``) is ring rounds over a ``Ring``: for ring offset d,
every rank sends a fixed-width buffer to rank (i + d).  Widths are maxima
over ranks; a rank with less traffic pads, and its receiver drops the
padding by scattering it to the extended vector's drop slot ``n_ext``.

A ``HaloPlan`` as ``plan_and_remap`` returns it holds every rank's rows,
``(ndev, m_d)`` NumPy arrays; ``HaloPlan.shard(rank, device)`` keeps one
rank's row of each as a tensor, which is all a rank holds afterwards.  A
``DistMatrix`` holds only its rank's rows, with their columns remapped into
the rank's extended vector ``[owned | halo]``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.core.ell import (EllMatrix, _np, ell_from_csr, ell_to_csr,
                                       to_tensor)
from raptor_tpu_torch.parallel.comm import Ring

__all__ = ["HaloPlan", "DistMatrix", "distribute_matrix", "plan_and_remap",
           "repartition_pad"]


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Exchange plan.

    send_idx: per ring offset, the indices into the owned vector that are
              gathered into the send buffer (padding: 0).
    recv_tgt: per ring offset, the indices into the extended vector that the
              received buffer is scattered to (padding: n_ext, the drop
              slot).
    Each is an (ndev, m_d) int32 array for every rank (``plan_and_remap``)
    or, after ``shard``, one rank's (m_d,) row as a tensor.
    offsets:  the ring offsets with traffic.
    n_local:  the owned vector's length on every rank.
    n_ext:    the extended vector's length: n_local + the widest halo + 1
              (the reference's drop slot, kept so both index the same).
    """

    send_idx: Tuple[Any, ...]
    recv_tgt: Tuple[Any, ...]
    offsets: Tuple[int, ...]
    n_local: int
    n_ext: int

    def shard(self, rank: int, device) -> "HaloPlan":
        """Rank ``rank``'s rows of the every-rank plan, on ``device``."""
        return dataclasses.replace(
            self, send_idx=tuple(to_tensor(s[rank], device) for s in self.send_idx),
            recv_tgt=tuple(to_tensor(r[rank], device) for r in self.recv_tgt))


@dataclasses.dataclass(frozen=True)
class DistMatrix:
    """One rank's rows of a row-sharded ELL operator whose columns index the
    extended (owned + halo) vector of the column partition (RAPtor's
    on_proc/off_proc split collapsed into one local ELL with remapped
    columns)."""

    data: Any  # (K, n_rows_local)
    cols: Any  # (K, n_rows_local) int32 -> [0, halo.n_ext)
    row_nnz: Any  # (n_rows_local,)
    halo: HaloPlan
    n_rows_local: int
    K: int
    shape: Tuple[int, int]  # the global operator's logical shape

    def local_ell(self) -> EllMatrix:
        """The rank's rows as an ``EllMatrix`` over the extended vector."""
        return EllMatrix(data=self.data, cols=self.cols, row_nnz=self.row_nnz,
                         shape=(self.n_rows_local, self.halo.n_ext),
                         n_rows_pad=self.n_rows_local,
                         n_cols_pad=self.halo.n_ext)


def repartition_pad(E: EllMatrix, ndev: int, dtype=None) -> EllMatrix:
    """Host: re-pad a global square ELL so the row count divides ndev*8
    (identity padding rows), returning the new EllMatrix (NumPy leaves)."""
    return ell_from_csr(ell_to_csr(E), dtype=dtype or _np(E.data).dtype,
                        row_pad_multiple=8 * ndev)


def distribute_matrix(E: EllMatrix, ring: Ring,
                      n_col_owned: Optional[int] = None) -> DistMatrix:
    """This rank's block of ``E`` split over the ring's ranks in contiguous
    row blocks, with the halo plan built from the off-block column sets.
    The result lies on E's device (NumPy leaves: the CPU).

    ``n_col_owned``: owned-column count per rank (defaults to the row count
    per rank for square operators; for rectangular P/R pass the column
    partition's per-rank size)."""
    ndev, me = ring.axis_size, ring.axis_index
    n_rows = E.n_rows_pad
    if n_rows % ndev:
        raise ValueError(f"{n_rows} rows do not divide over {ndev} ranks "
                         f"(repad first)")
    nl = n_rows // ndev
    nc_own = n_col_owned if n_col_owned is not None else nl
    if E.n_cols_pad != nc_own * ndev:
        raise ValueError(f"{E.n_cols_pad} columns, {nc_own} owned by each of "
                         f"{ndev} ranks")
    plan, new_cols = plan_and_remap(_np(E.cols), _np(E.row_nnz), ndev, nc_own)
    dev = E.data.device if isinstance(E.data, torch.Tensor) else "cpu"
    rows = slice(me * nl, (me + 1) * nl)
    data = (E.data[:, rows].contiguous() if isinstance(E.data, torch.Tensor)
            else to_tensor(E.data[:, rows], dev))
    return DistMatrix(
        data=data, cols=to_tensor(new_cols[:, rows], dev),
        row_nnz=to_tensor(_np(E.row_nnz)[rows], dev),
        halo=plan.shard(me, dev), n_rows_local=nl, K=E.K, shape=E.shape)


def plan_and_remap(cols: np.ndarray, nnz: np.ndarray, ndev: int, nc_own: int,
                   extra_ghosts=None):
    """Host structure pass: from global ELL structure (``cols`` (K, n_rows),
    ``nnz`` (n_rows,), contiguous row blocks, column space owned ``nc_own``
    per rank) build every rank's HaloPlan and the extended-vector column
    remap.  Values never pass through here: this is RAPtor-style
    comm-package construction, index bookkeeping only.

    ``extra_ghosts``: optional per-rank arrays of additional global indices
    each rank must receive beyond the matrix's own column pattern (the
    distributed RAP of long-range interpolation needs fine rows outside the
    operator's distance-1 halo)."""
    K, n_rows = cols.shape
    if n_rows % ndev:
        raise ValueError(f"{n_rows} rows do not divide over {ndev} ranks")
    nl = n_rows // ndev
    mask = np.arange(K)[:, None] < nnz[None, :]

    owner = cols // nc_own  # (K, n_rows)
    shard_of_row = np.repeat(np.arange(ndev), nl)[None, :]

    # ghost columns per rank (sorted unique off-owned cols of real entries)
    ghosts = []
    for p in range(ndev):
        sel = mask & (shard_of_row == p) & (owner != p)
        g = cols[sel]
        if extra_ghosts is not None and len(extra_ghosts[p]):
            e = np.asarray(extra_ghosts[p])
            g = np.concatenate([g, e[e // nc_own != p]])
        ghosts.append(np.unique(g))
    n_halo = max((g.size for g in ghosts), default=0)
    n_ext = nc_own + n_halo + 1  # +1 drop slot

    # remap columns to extended-vector indices
    new_cols = np.zeros_like(cols)
    for p in range(ndev):
        c = cols[:, p * nl:(p + 1) * nl]
        m = mask[:, p * nl:(p + 1) * nl]
        local = c - p * nc_own
        gpos = np.searchsorted(ghosts[p], c)
        gpos = np.clip(gpos, 0, max(ghosts[p].size - 1, 0))
        is_ghost = (c // nc_own) != p
        mapped = np.where(is_ghost, nc_own + gpos, local)
        new_cols[:, p * nl:(p + 1) * nl] = np.where(m, mapped, 0)

    # ring rounds: offset d sends p -> (p+d) % ndev
    send_idx, recv_tgt, offsets = [], [], []
    for d in range(1, ndev):
        per_dev_send = []
        per_dev_recv = []
        m_d = 0
        for p in range(ndev):
            q = (p + d) % ndev  # p sends q's ghosts that p owns
            g = ghosts[q]
            owned_by_p = g[(g // nc_own) == p]
            per_dev_send.append(owned_by_p - p * nc_own)  # local indices on p
            m_d = max(m_d, owned_by_p.size)
        for q in range(ndev):
            src = (q - d) % ndev
            g = ghosts[q]
            from_src = np.nonzero((g // nc_own) == src)[0]  # ghost ranks
            per_dev_recv.append(nc_own + from_src)
        if m_d == 0:
            continue
        S = np.zeros((ndev, m_d), dtype=np.int32)
        Rt = np.full((ndev, m_d), n_ext, dtype=np.int32)  # drop by default
        for p in range(ndev):
            s = per_dev_send[p]
            S[p, : s.size] = s
            r = per_dev_recv[p]
            Rt[p, : r.size] = r
        send_idx.append(S)
        recv_tgt.append(Rt)
        offsets.append(d)

    plan = HaloPlan(send_idx=tuple(send_idx), recv_tgt=tuple(recv_tgt),
                    offsets=tuple(offsets), n_local=nc_own, n_ext=n_ext)
    return plan, new_cols
