"""Smoothed-aggregation AMG setup.

Counterpart of ``raptor_tpu/setup/aggregation.py``.  The pipeline, on the
hierarchy's device (per-level widths and counts read by the host loop):

  1. nodal condensation of the block matrix (|a_ij| summed per b x b block),
  2. SA symmetric strength  |a_ij| >= theta sqrt(a_ii a_jj),
  3. distance-2 MIS roots through PMIS on G^2 (G the strength pattern plus
     the diagonal, squared by SpGEMM),
  4. two capped rounds of neighbour assignment, then a straggler pass,
  5. the tentative prolongator: a batched QR of the near-nullspace
     candidates per aggregate, signs fixed so that R's diagonal is >= 0,
  6. prolongator smoothing  P = (I - omega D^{-1} A) P_tent, and the
     Galerkin product.

``build_sa_hierarchy`` builds on the host (``setup/host_aggregation.py``)
when the input has at most ``host_setup_threshold`` rows, else here, as
the reference does.  Aggregation keys on exact integer weights
``min(lam, 63) * nn_pad + perm`` (int64 above ``_MAX_INT32_ROWS`` rows),
with ``perm`` from NumPy's ``default_rng``.

The device route's spans (``utils/profiling.py``, no-ops unless
recording): ``setup.ell`` (the ELL on the card, and an fp32 build's
fp32 remainder), then ``setup.sa.level[k]`` a level, holding the
stages ``setup.sa.condense``, ``.strength``, ``.aggregate``,
``.tentative``, ``.smooth_p`` (the ``D^{-1} A P_t`` product and the
sum), ``.transpose``, ``.rap``, ``.smoother`` and ``.block_layout``
(``ell_to_bell``, the block inverses, the block lmax); the coarsest
level's ``setup.sa.level[k]`` holds the last two, then
``setup.coarse_inverse``.  The stages are fenced: with no profiler
active, each is timed between device syncs on the host clock.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, pad_rows
from raptor_tpu_torch.ops.sparse_ops import (_fix_padding_cols,
                                             _merge_sorted_rows, _slot_sum,
                                             ell_add, ell_transpose, spgemm)
from raptor_tpu_torch.setup.interp import add_identity_padding
from raptor_tpu_torch.setup.splitting import (C_PT, make_perm,
                                              pmis_splitting,
                                              splitting_weights)
from raptor_tpu_torch.solve.krylov import host_read
from raptor_tpu_torch.solve.smoothers import estimate_lmax
from raptor_tpu_torch.utils.profiling import phase

__all__ = ["build_sa_hierarchy", "nodal_condense", "sa_strength_mask",
           "aggregate", "tentative_prolongator", "AGG_SIZE_CAP"]

# joins that would push an aggregate past this size are refused (per round,
# so same-round joiners can overshoot slightly)
AGG_SIZE_CAP = 64


# ---------------------------------------------------------------------------
# 1. Nodal condensation
# ---------------------------------------------------------------------------

def _condense_wide(A: EllMatrix, bs: int):
    """The bs dof rows of each node grouped into one row of width bs*K, with
    |value| entries and node column ids, sorted by column (stably, so a
    run's terms keep their slot order).  Returns (cols, vals, sentinel)."""
    K, n = A.data.shape
    nn = n // bs

    def fold(t):  # (K, nn*bs) -> (bs*K, nn), the dof axis leading
        return t.reshape(K, nn, bs).permute(2, 0, 1).reshape(K * bs, nn)

    data = fold(A.data.abs())
    cols = fold(torch.div(A.cols, bs, rounding_mode="floor"))
    mask = fold(A.slot_mask())
    cols = torch.where(mask, cols, nn)
    vals = torch.where(mask, data, 0)
    cols, order = torch.sort(cols, dim=0, stable=True)
    return cols, vals.gather(0, order), nn


def nodal_condense(A: EllMatrix, bs: int) -> EllMatrix:
    """Block matrix -> nodal matrix: C[u, v] = sum |A[bu+i, bv+j]| (one host
    read for the exact width)."""
    assert A.n_rows_pad % bs == 0
    nn = A.n_rows_pad // bs
    cols, vals, sent = _condense_wide(A, bs)
    first = torch.ones_like(cols, dtype=torch.bool)
    first[1:] = cols[1:] != cols[:-1]
    width = int((first & (cols < sent)).sum(0).max())
    # each of a node's bs rows meets a neighbour node in at most bs columns
    oc, ov, nnz = _merge_sorted_rows(cols, vals, sent, max(width, 1),
                                     max_run=bs * bs)
    return EllMatrix(
        data=ov, cols=_fix_padding_cols(oc, nnz), row_nnz=nnz,
        shape=(A.shape[0] // bs if A.shape[0] % bs == 0 else nn, nn),
        n_rows_pad=nn, n_cols_pad=nn)


# ---------------------------------------------------------------------------
# 2. SA strength
# ---------------------------------------------------------------------------

def sa_strength_mask(C: EllMatrix, theta: float) -> torch.Tensor:
    """|c_ij| >= theta * sqrt(c_ii * c_jj), off-diagonal (the symmetric SA
    test)."""
    diag = C.diagonal()
    off = (C.cols != C.row_index()) & C.slot_mask()
    dj = diag[C.cols.long()]
    thresh = theta * torch.sqrt(diag.abs()[None, :] * dj.abs())
    return off & (C.data.abs() >= thresh) & (C.data.abs() > 0)


# ---------------------------------------------------------------------------
# 3+4. Aggregation: distance-2 MIS roots, assignment rounds
# ---------------------------------------------------------------------------

def _strength_ell(C: EllMatrix, smask, with_diag: bool) -> EllMatrix:
    """The strength pattern (with the diagonal when ``with_diag``) as an
    EllMatrix of 1.0 entries, compacted to the front of each row."""
    keep = smask
    if with_diag:
        keep = keep | ((C.cols == C.row_index()) & C.slot_mask())
    sent = C.n_cols_pad
    cols = torch.where(keep, C.cols, sent)
    vals = torch.where(keep, 1.0, 0.0).to(C.dtype)
    cols, order = torch.sort(cols, dim=0, stable=True)
    # a compaction: the kept entries' columns are distinct
    oc, ov, nnz = _merge_sorted_rows(cols, vals.gather(0, order), sent, C.K,
                                     max_run=1)
    return EllMatrix(data=ov.clamp(max=1.0), cols=_fix_padding_cols(oc, nnz),
                     row_nnz=nnz, shape=C.shape, n_rows_pad=C.n_rows_pad,
                     n_cols_pad=C.n_cols_pad)


def _agg_sizes(agg: torch.Tensor) -> torch.Tensor:
    """(nn+1,) current aggregate sizes (ids are < nn; -1 counts in slot
    nn)."""
    nn = agg.shape[0]
    return torch.bincount(torch.where(agg >= 0, agg, nn).long(),
                          minlength=nn + 1)


def _assign_rounds(G: EllMatrix, smask_g, agg, w):
    """Two rounds: unaggregated nodes join the strong neighbour's aggregate
    of the largest weight (ties by the larger aggregate id), skipping
    aggregates at the size cap."""
    nn = agg.shape[0]
    gc = G.cols.long()
    for _ in range(2):
        sizes = _agg_sizes(agg)
        nbr_agg = agg[gc]
        room = sizes[nbr_agg.clamp(0, nn).long()] < AGG_SIZE_CAP
        cand = smask_g & (nbr_agg >= 0) & room
        wn = torch.where(cand, w[gc], -1)
        m = wn.amax(0)
        pick = torch.where(cand & (wn == m[None, :]), nbr_agg, -1).amax(0)
        agg = torch.where((agg < 0) & (m >= 0), pick, agg)
    return agg


def _join_smallest(C: EllMatrix, agg):
    """Straggler pass: nodes still unaggregated join the smallest adjacent
    aggregate over the full nodal pattern (weak edges included; ties by
    the larger aggregate id)."""
    nn = agg.shape[0]
    off = (C.cols != C.row_index()) & C.slot_mask()
    sizes = _agg_sizes(agg)
    nbr_agg = agg[C.cols.long()]
    cand = off & (nbr_agg >= 0)
    wn = torch.where(cand, -sizes[nbr_agg.clamp(0, nn).long()], -(2**30))
    m = wn.amax(0)
    pick = torch.where(cand & (wn == m[None, :]), nbr_agg, -1).amax(0)
    return torch.where((agg < 0) & (pick >= 0), pick, agg)


def aggregate(C: EllMatrix, smask, seed: int):
    """Node -> aggregate id map by distance-2 MIS roots and assignment.
    Returns (agg (nn,) int32 with -1 for padding, n_agg int).  Isolated
    nodes become singleton aggregates.  Host reads: one a PMIS round, the
    SpGEMM's width and the two counts at the end."""
    nn = C.n_rows_pad
    n = C.shape[0]
    dev = C.data.device
    G = _strength_ell(C, smask, with_diag=True)
    G2 = spgemm(G, G)
    g2_off = (G2.cols != G2.row_index()) & G2.slot_mask()
    perm = make_perm(n, nn, seed, device=dev)
    cf = pmis_splitting(G2, g2_off, perm)

    is_real = torch.arange(nn, device=dev) < n
    is_root = (cf == C_PT) & is_real
    singleton = is_real & ~smask.any(0) & ~is_root
    root_like = is_root | singleton
    agg = torch.where(root_like,
                      torch.cumsum(root_like, 0, dtype=torch.int32) - 1, -1)
    agg = agg.to(torch.int32)
    w = splitting_weights(smask.sum(0), perm, nn)  # assignment preference
    # G's slots are the compacted strength entries: gate on G's own mask
    agg = _assign_rounds(G, G.slot_mask(), agg, w)
    agg = torch.where(is_real, _join_smallest(C, agg), agg)
    strag = is_real & (agg < 0)
    n_so_far, n_strag = host_read("sa.aggregate", torch.stack(
        [root_like.sum(), strag.sum()]))
    extra = torch.cumsum(strag, 0, dtype=torch.int32) - 1
    agg = torch.where(strag, n_so_far + extra, agg).to(torch.int32)
    return agg, n_so_far + n_strag


# ---------------------------------------------------------------------------
# 5. Tentative prolongator (batched QR over aggregates)
# ---------------------------------------------------------------------------

def tentative_prolongator(agg: torch.Tensor, n_agg: int, B: torch.Tensor,
                          bs: int, n_dof: int, pad_multiple: int = 8):
    """(P_tent as an ELL of dofs x n_agg*nc, Bc (n_agg*nc, nc), n_agg*nc).
    B is (n_dof_pad, nc).  Aggregate a's dof block of P_tent is Q_a of the
    reduced QR of B's rows in that aggregate; Bc's rows are R_a."""
    nc = B.shape[1]
    counts = torch.bincount(torch.where(agg >= 0, agg, n_agg).long(),
                            minlength=n_agg + 1)
    max_nodes = int(counts[:n_agg].max()) if n_agg else 1
    P_data, P_cols, p_nnz, Bc = _tentative(agg, B, bs, n_agg, max_nodes, nc)
    ncoarse = n_agg * nc
    # the coarse padding divides by pad_multiple and by nc, the next
    # level's block size
    mult = pad_multiple * nc // int(np.gcd(pad_multiple, nc))
    P = EllMatrix(data=P_data, cols=P_cols, row_nnz=p_nnz,
                  shape=(n_dof, ncoarse), n_rows_pad=B.shape[0],
                  n_cols_pad=pad_rows(ncoarse, mult))
    return P, Bc, ncoarse


def _tentative(agg, B, bs: int, n_agg: int, max_nodes: int, nc: int):
    nn = agg.shape[0]
    n_pad = B.shape[0]
    dev = B.device
    node = torch.arange(nn, device=dev)
    key = torch.where(agg >= 0, agg, n_agg).long()
    # by aggregate, then node id: a stable sort of the aggregate ids
    skey, snode = torch.sort(key, stable=True)
    first = torch.ones(nn, dtype=torch.bool, device=dev)
    first[1:] = skey[1:] != skey[:-1]
    run_start = torch.cummax(torch.where(first, node, 0), 0).values
    slot = node - run_start
    ok = (skey < n_agg) & (slot < max_nodes)
    # node-slot table (n_agg, max_nodes): node ids, -1 padding
    tgt = torch.where(ok, skey * max_nodes + slot, n_agg * max_nodes)
    tbl = torch.full((n_agg * max_nodes + 1,), -1, dtype=torch.int64,
                     device=dev)
    tbl = tbl.scatter_reduce_(0, tgt, torch.where(ok, snode, -1), "amax")
    tbl = tbl[:-1].reshape(n_agg, max_nodes)
    # candidate rows (n_agg, max_nodes*bs, nc), zero rows for padding
    dof_tbl = tbl[:, :, None] * bs + torch.arange(bs, device=dev)
    dof_tbl = torch.where(tbl[:, :, None] >= 0, dof_tbl, n_pad).reshape(
        n_agg, max_nodes * bs)
    Bz = torch.cat([B, B.new_zeros(1, nc)])
    rows = Bz[dof_tbl.clamp(max=n_pad)]
    rows = torch.where((dof_tbl < n_pad)[:, :, None], rows, 0)
    Q, R = torch.linalg.qr(rows, mode="reduced")
    # signs fixed so that R's diagonal is >= 0
    sgn = torch.where(torch.diagonal(R, dim1=1, dim2=2) < 0, -1.0, 1.0).to(B.dtype)
    Q = Q * sgn[:, None, :]
    R = R * sgn[:, :, None]
    # Q into the ELL rows of P_tent: dof d of node (a, s) is row
    # tbl[a, s]*bs + d with nc entries (cols a*nc + j, vals Q[a, s*bs+d, j]);
    # padding entries go to the dump row n_pad
    tgt_dof = dof_tbl.reshape(-1)
    a_idx = torch.arange(n_agg, device=dev)[:, None].expand(
        n_agg, max_nodes * bs).reshape(-1)
    j = torch.arange(nc, device=dev)[:, None]
    P_data = B.new_zeros(nc, n_pad + 1).index_copy_(
        1, tgt_dof, Q.permute(2, 0, 1).reshape(nc, -1))[:, :n_pad]
    P_cols = torch.zeros(nc, n_pad + 1, dtype=torch.int32, device=dev).index_copy_(
        1, tgt_dof, (a_idx[None, :] * nc + j).to(torch.int32))[:, :n_pad]
    hit = torch.zeros(n_pad + 1, dtype=torch.bool, device=dev)
    hit[tgt_dof] = True
    p_nnz = torch.where(hit[:n_pad], nc, 0).to(torch.int32)
    return P_data, P_cols, p_nnz, R.reshape(n_agg * nc, nc)


def _lumped_filter(A: EllMatrix, tol: float, bs: int) -> EllMatrix:
    """Lumped strength filtering of A for prolongator smoothing (filtered
    SA, ``sa_filter``): off-node entries failing |a_ij| >= tol*sqrt(|a_ii
    a_jj|) are dropped and added to the diagonal.  Dropped slots point at
    the row's diagonal with value 0 (the SpGEMM merge folds them)."""
    ri = A.row_index()
    valid = A.slot_mask()
    isdiag = (A.cols == ri) & valid
    dabs = A.diagonal().abs()
    dj = dabs[A.cols.long()]
    thr = tol * torch.sqrt(dabs[None, :] * dj)
    samenode = torch.div(A.cols, bs, rounding_mode="floor") == torch.div(
        ri, bs, rounding_mode="floor")
    drop = valid & ~samenode & (A.data.abs() < thr)
    lump = _slot_sum(torch.where(drop, A.data, 0))
    data = torch.where(drop, 0, A.data) + torch.where(isdiag, lump[None, :], 0)
    cols = torch.where(drop, ri, A.cols).to(torch.int32)
    return dataclasses.replace(A, data=data, cols=cols)


# ---------------------------------------------------------------------------
# 6. The hierarchy loop
# ---------------------------------------------------------------------------

def _block_layout(A: EllMatrix, config: AmgConfig, bs: int, lmax_s):
    """(Abell, binv, cheb_lmax) of a level when a block smoother is
    configured: A re-laid as bs x bs BlockELL on A's device.  bs == 1
    levels and levels whose padding breaks the block alignment keep the
    scalar path."""
    if config.smoother not in ("block_jacobi", "block_cheb") or bs <= 1:
        return None, None, lmax_s
    if A.n_rows_pad % bs or A.shape[0] % bs:
        return None, None, lmax_s
    from raptor_tpu_torch.core.bell import (block_diag_inv, ell_to_bell,
                                            estimate_lmax_bell)

    Abell = ell_to_bell(A, bs)
    binv = block_diag_inv(Abell)
    if config.smoother == "block_cheb":
        lmax_s = estimate_lmax_bell(Abell, binv)
    return Abell, binv, lmax_s


def build_sa_hierarchy(A, config: AmgConfig, dtype=np.float32, B=None,
                       block_size: int | None = None, *, device):
    """Smoothed-aggregation hierarchy (config 4).

    ``B``: (n, nc) near-nullspace candidates (rigid body modes for
    elasticity); the constant vector by default, at most
    ``config.num_candidates`` used.  The block size is 3 when nc >= 3 and
    3 divides n (elasticity), else 1; ``block_size`` overrides.  A scipy
    input of at most ``host_setup_threshold`` rows is built on the host;
    otherwise every level is built with tensors on ``device``."""
    from raptor_tpu_torch.core.ell import ell_from_csr
    from raptor_tpu_torch.setup.hierarchy import (Hierarchy, Level,
                                                  _dense_inverse,
                                                  _smoother_data,
                                                  attach_residual_lo)

    if B is None and isinstance(A, tuple) and len(A) in (2, 3):
        A, B = A[0], A[1]  # gallery tuples (A, B[, coords])
    n_in = A.shape[0]
    if (not isinstance(A, EllMatrix)
            and 0 < n_in <= config.host_setup_threshold):
        from raptor_tpu_torch.setup.host_aggregation import \
            host_build_sa_hierarchy

        return attach_residual_lo(
            host_build_sa_hierarchy(A, config, dtype=dtype, B=B,
                                    block_size=block_size), A)
    if B is None:
        B = np.ones((n_in, 1), dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)[:, : config.num_candidates]
    nc = B.shape[1]
    bs = block_size or (3 if (nc >= 3 and n_in % 3 == 0) else 1)
    A_in = None if isinstance(A, EllMatrix) else A
    # an fp32 build keeps the operator's fp32 truncation remainder in the
    # ELL slots for the refined solve's certified residual (what
    # ``attach_residual_lo`` computes on the host): here from one fp64 ELL
    # on the card, which the fp32 level-0 operator is cast from
    lo = None
    with phase("setup.ell"):
        if A_in is not None:
            # the padded size divides by pad_multiple and by the block size
            mult = config.pad_multiple * bs // int(np.gcd(config.pad_multiple,
                                                          bs))
            split = np.dtype(dtype) == np.float32
            A = ell_from_csr(A, dtype=np.float64 if split else dtype,
                             row_pad_multiple=mult).to(device)
            if split:
                hi = A.data.to(torch.float32)
                lo = (A.data - hi.double()).to(torch.float32)
                A = dataclasses.replace(A, data=hi)
        else:
            A = A.to(device)
    assert A.n_rows_pad % bs == 0, (A.n_rows_pad, bs)
    n = A.shape[0]
    tdt = A.data.dtype

    def candidates(rows: int, vals) -> torch.Tensor:
        Bd = torch.zeros(rows, nc, dtype=tdt, device=A.data.device)
        Bd[: vals.shape[0]] = torch.as_tensor(vals, device=A.data.device).to(tdt)
        return Bd

    def stage(name):
        return phase("setup.sa." + name, fence=True)

    Bd = candidates(A.n_rows_pad, B)
    levels = []
    while len(levels) + 1 < config.max_levels and n > config.coarse_size:
        with phase("setup.sa.level", len(levels), fence=True):
            with stage("condense"):
                C = nodal_condense(A, bs) if bs > 1 else A
            with stage("strength"):
                smask = sa_strength_mask(C, config.theta)
            with stage("aggregate"):
                agg, n_agg = aggregate(C, smask, config.seed + len(levels))
            # stop when coarsening stalls
            if n_agg == 0 or n_agg * nc >= 0.7 * n:
                break
            with stage("tentative"):
                P_t, Bc, ncoarse = tentative_prolongator(
                    agg, n_agg, Bd, bs, n, config.pad_multiple)
            with stage("smooth_p"):
                dA = A.diagonal()
                dinv = 1.0 / torch.where(dA != 0, dA, 1.0)
                omega = config.sa_omega / float(estimate_lmax(A, dinv))
                A_sm = (_lumped_filter(A, config.sa_filter, bs)
                        if config.sa_filter > 0 else A)
                DA_P = spgemm(dataclasses.replace(
                    A_sm, data=A_sm.data * (dinv * omega)[None, :]), P_t)
                P = ell_add(P_t, DA_P, alpha=1.0, beta=-1.0)
            with stage("transpose"):
                R = ell_transpose(P)
            with stage("rap"):
                Ac = add_identity_padding(spgemm(R, spgemm(A, P)), ncoarse)
            with stage("smoother"):
                dinv_s, color, ncolors, lmax_s = _smoother_data(A, config,
                                                                smask)
            with stage("block_layout"):
                Abell, binv, lmax_s = _block_layout(A, config, bs, lmax_s)
            levels.append(Level(A=A, dinv=dinv_s, P=P, R=R, color=color,
                                cheb_lmax=lmax_s, n=n, ncolors=ncolors,
                                Abell=Abell, binv=binv))
            # next level: block size nc, candidates Bc
            A, n, bs = Ac, ncoarse, nc
            Bd = candidates(A.n_rows_pad, Bc)

    with phase("setup.sa.level", len(levels), fence=True):
        with stage("smoother"):
            dinv_s, color, ncolors, lmax_s = _smoother_data(A, config, None)
        with stage("block_layout"):
            Abell, binv, lmax_s = _block_layout(A, config, bs, lmax_s)
    levels.append(Level(A=A, dinv=dinv_s, P=None, R=None, color=color,
                        cheb_lmax=lmax_s, n=n, ncolors=ncolors, Abell=Abell,
                        binv=binv))
    hier = Hierarchy(levels=tuple(levels),
                     coarse_inv=_dense_inverse(A, n_true=n), config=config)
    if lo is not None and bool(lo.any()):
        hier = dataclasses.replace(hier, a0_lo=lo)
    return hier
