"""TAPS-style two-level aggregated halo exchange.

Counterpart of ``raptor_tpu/parallel/taps.py`` (RAPtor's ``TAPComm``
node-aware three-step communication).  The ranks form a (node, chip) grid,
rank = node * n_chips + chip; the "chip" ring joins the ranks of one node,
the "node" ring the ranks with the same chip index:

  1. gather: the chips of a node all-gather their owned blocks over the
     chip ring,
  2. transfer: the node aggregate bound for node (N + d) is split evenly
     across the node's chips, and ONE shift per node-ring offset moves it
     over the node ring, each chip carrying 1/n_chips of it,
  3. scatter: the receivers all-gather the pieces over the chip ring and
     scatter them into their halo slots.

Plans are built on the host from the global structure: ``build_taps_plan``
is the reference's NumPy pass as it is, with every rank's arrays;
``TapsPlan.shard`` keeps one rank's.  The extended vector is laid out as
the flat plan's (``parallel/partition.py``: the same sorted-unique ghost
order), so the remapped columns of the two are interchangeable.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.core.ell import EllMatrix, _np, to_tensor
from raptor_tpu_torch.parallel.comm import Ring

__all__ = ["TapsPlan", "TapsMesh", "build_taps_plan", "make_taps_mesh",
           "taps_exchange"]


@dataclasses.dataclass(frozen=True)
class TapsPlan:
    """Per node-ring offset d (every rank's arrays from ``build_taps_plan``,
    shaped (n_nodes, n_chips, ...); one rank's (...) row after ``shard``):

    send_idx[d]: (m_d,) int32 indices into the node's gathered owned vector
                 that this chip contributes to its node's aggregate for
                 node (node + d) (padding: 0, ignored by the receiver).
    recv_tgt[d]: (n_chips * m_d,) int32 targets in the extended vector of
                 the reassembled aggregate from node (node - d) (padding:
                 n_ext, the drop slot).
    local_src / local_tgt: (m_l,) the node-local ghosts' sources in the
                 gathered node vector and their extended-vector targets.
    """

    send_idx: Tuple[Any, ...]
    recv_tgt: Tuple[Any, ...]
    local_src: Any
    local_tgt: Any
    offsets: Tuple[int, ...]
    n_local: int
    n_ext: int
    n_nodes: int
    n_chips: int

    def shard(self, rank: int, device) -> "TapsPlan":
        """Rank ``rank``'s rows of the every-rank plan, on ``device``."""
        at = divmod(rank, self.n_chips)  # (node, chip)
        row = lambda a: to_tensor(a[at], device)  # noqa: E731
        return dataclasses.replace(
            self, send_idx=tuple(row(s) for s in self.send_idx),
            recv_tgt=tuple(row(r) for r in self.recv_tgt),
            local_src=row(self.local_src), local_tgt=row(self.local_tgt))


class TapsMesh(NamedTuple):
    """The rings of a (node, chip) grid of ranks, as seen by one rank."""
    ring: Ring  # every rank, in order
    node: Ring  # the ranks of this chip index, one per node
    chip: Ring  # the ranks of this node


def make_taps_mesh(n_nodes: int, n_chips: int) -> TapsMesh:
    """Split the default process group into its node and chip rings.  Every
    rank calls this (creating a group is collective); the group must hold
    n_nodes * n_chips ranks."""
    ring = Ring()
    if ring.axis_size != n_nodes * n_chips:
        raise ValueError(f"{n_nodes} x {n_chips} ranks asked, the process "
                         f"group has {ring.axis_size}")
    node_of, chip_of = divmod(ring.axis_index, n_chips)
    chips = [dist.new_group([N * n_chips + c for c in range(n_chips)])
             for N in range(n_nodes)]
    nodes = [dist.new_group([N * n_chips + c for N in range(n_nodes)])
             for c in range(n_chips)]
    return TapsMesh(ring=ring, node=Ring(nodes[chip_of]), chip=Ring(chips[node_of]))


def build_taps_plan(E: EllMatrix, n_nodes: int, n_chips: int,
                    n_col_owned: Optional[int] = None):
    """Two-level plan from a global ELL row-partitioned over
    n_nodes * n_chips contiguous blocks.  Returns (TapsPlan with every
    rank's arrays, remapped cols) compatible with DistMatrix's
    extended-vector convention (same sorted-unique ghost order, so the
    remapped cols are interchangeable with ``distribute_matrix``'s).

    ``n_col_owned``: owned-column count per rank for rectangular transfer
    operators (defaults to the per-rank row count for square operators)."""
    ndev = n_nodes * n_chips
    n_rows = E.n_rows_pad
    if n_rows % ndev:
        raise ValueError(f"{n_rows} rows do not divide over {ndev} ranks")
    nl = n_rows // ndev
    nc_own = n_col_owned if n_col_owned is not None else nl
    if E.n_cols_pad != nc_own * ndev:
        raise ValueError(f"{E.n_cols_pad} columns, {nc_own} owned by each of "
                         f"{ndev} ranks")

    cols = _np(E.cols)
    nnz = _np(E.row_nnz)
    K = E.K
    mask = np.arange(K)[:, None] < nnz[None, :]
    owner = cols // nc_own
    shard_of_row = np.repeat(np.arange(ndev), nl)[None, :]

    ghosts = []
    for p in range(ndev):
        sel = mask & (shard_of_row == p) & (owner != p)
        ghosts.append(np.unique(cols[sel]))
    n_halo = max((g.size for g in ghosts), default=0)
    n_ext = nc_own + n_halo + 1

    new_cols = np.zeros_like(cols)
    for p in range(ndev):
        c = cols[:, p * nl:(p + 1) * nl]
        m = mask[:, p * nl:(p + 1) * nl]
        gpos = np.searchsorted(ghosts[p], c)
        gpos = np.clip(gpos, 0, max(ghosts[p].size - 1, 0))
        is_ghost = (c // nc_own) != p
        mapped = np.where(is_ghost, nc_own + gpos, c - p * nc_own)
        new_cols[:, p * nl:(p + 1) * nl] = np.where(m, mapped, 0)

    node_of = lambda p: p // n_chips  # noqa: E731
    send_idx, recv_tgt, offsets = [], [], []
    for d in range(1, n_nodes):
        # node N sends to node (N+d): the union over (N+d)'s chips' ghosts
        # that node N owns, in global sorted order (canonical aggregate order)
        agg = {}
        for Nn in range(n_nodes):
            dstN = (Nn + d) % n_nodes
            need = np.unique(np.concatenate(
                [ghosts[dstN * n_chips + c] for c in range(n_chips)]
            )) if n_chips else np.zeros(0, np.int64)
            need = need[(need // (nc_own * n_chips)) == Nn]  # owned by node Nn
            agg[Nn] = need
        m_total = max(v.size for v in agg.values())
        if m_total == 0:
            continue
        m_d = -(-m_total // n_chips)  # per-chip piece size
        S = np.zeros((n_nodes, n_chips, m_d), dtype=np.int32)
        Rt = np.full((n_nodes, n_chips, n_chips * m_d), n_ext, dtype=np.int32)
        for Nn in range(n_nodes):
            g = agg[Nn]  # global indices node Nn sends to node Nn+d
            padded = np.zeros(n_chips * m_d, dtype=np.int64)
            padded[: g.size] = g
            # chip c of node Nn contributes slice [c*m_d:(c+1)*m_d] of the
            # node aggregate, indexed against the node's gathered owned
            # vector
            for c in range(n_chips):
                piece = padded[c * m_d:(c + 1) * m_d]
                S[Nn, c] = (piece - Nn * n_chips * nc_own).astype(np.int32)
            # receiver side: node (Nn+d)'s chips scatter the aggregate
            dstN = (Nn + d) % n_nodes
            for c in range(n_chips):
                p = dstN * n_chips + c
                gl = ghosts[p]
                pos = np.searchsorted(gl, padded[: g.size])
                hit = (pos < gl.size) & (gl[np.clip(pos, 0, gl.size - 1)]
                                         == padded[: g.size])
                tgt = np.full(n_chips * m_d, n_ext, dtype=np.int32)
                tgt[: g.size][hit] = (nc_own + pos[hit]).astype(np.int32)
                Rt[dstN, c] = tgt
        send_idx.append(S)
        recv_tgt.append(Rt)
        offsets.append(d)

    # intra-node ghosts: filled straight from the node-level all-gather
    m_l = 0
    locs = []
    for p in range(ndev):
        Nn = node_of(p)
        g = ghosts[p]
        same = g[(g // (nc_own * n_chips)) == Nn]
        rank = np.searchsorted(g, same)
        locs.append((same - Nn * n_chips * nc_own, nc_own + rank))
        m_l = max(m_l, same.size)
    Ls = np.zeros((n_nodes, n_chips, max(m_l, 1)), dtype=np.int32)
    Lt = np.full((n_nodes, n_chips, max(m_l, 1)), n_ext, dtype=np.int32)
    for p in range(ndev):
        src, tgt = locs[p]
        Ls[node_of(p), p % n_chips, : src.size] = src
        Lt[node_of(p), p % n_chips, : tgt.size] = tgt

    plan = TapsPlan(send_idx=tuple(send_idx), recv_tgt=tuple(recv_tgt),
                    local_src=Ls, local_tgt=Lt, offsets=tuple(offsets),
                    n_local=nc_own, n_ext=n_ext, n_nodes=n_nodes,
                    n_chips=n_chips)
    return plan, new_cols


def taps_exchange(x_own: torch.Tensor, plan: TapsPlan, mesh: TapsMesh) -> torch.Tensor:
    """Two-level exchange: this rank's (n_local,) owned block to its
    (n_ext,) extended vector, laid out as ``halo_exchange``'s."""
    x_ext = x_own.new_zeros(plan.n_ext + 1)  # + the drop slot
    x_ext[: plan.n_local] = x_own
    # the node's concatenated owned vector (step 1); the intra-node ghosts
    # come straight from it (RAPtor's local communication)
    x_node = mesh.chip.all_gather(x_own)
    x_ext[plan.local_tgt] = x_node[plan.local_src]
    for d, sidx, rtgt in zip(plan.offsets, plan.send_idx, plan.recv_tgt):
        piece = x_node[sidx]  # my 1/n_chips of the aggregate
        # step 2: ONE inter-node transfer, split across the chips
        piece = mesh.node.shift(piece, d)
        # step 3: reassemble within the node and scatter
        x_ext[rtgt] = mesh.chip.all_gather(piece)
    return x_ext[: plan.n_ext]
