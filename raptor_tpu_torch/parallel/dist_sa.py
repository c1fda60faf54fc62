"""The sharded smoothed-aggregation setup: config 4's pipeline with the
setup itself on row shards over a ``Ring``.

Counterpart of ``raptor_tpu/parallel/dist_sa.py`` (RAPtor's parallel
aggregation setup, ``aggregation/par_*``).  The reference runs each
per-level program under ``shard_map`` from one controller; here one
process per rank runs the same program on its own shard, and every mesh
collective is a ``Ring`` call, as in ``parallel/dist_setup.py``:

* the aggregation decisions are a host structure pass: every rank gathers
  the level's values and structure and runs the same NumPy pass as the
  single-device host route (nodal condensation, SA strength, distance-two
  MIS on G^2, the capped assignment rounds;
  ``setup/host_aggregation._np_aggregate``), then keeps its own part;
* every numeric phase runs on the rank's rows on its device: the batched
  tentative QR (each rank factors the aggregates it owns, the remote
  member rows of the candidates delivered by a widened halo plan and the Q
  rows returned to their owners by the adjoint halo reduce), the
  prolongator smoothing SpGEMM, the Galerkin RAP (``dist_setup``'s
  ``_run_rap`` and ``_run_ac`` over the P-pattern-widened plan), the
  lambda_max power iterations and the block-diagonal inverses.

An aggregate lives on the rank owning its smallest member node; coarse
dofs are numbered block-padded, ``rank * (max_agg * nc) + local``, as in
the rest of the sharded setup.  Coarse levels stay sharded until they drop
to ``tail_size`` rows; the decision pass compacts the block-padded lanes
and scatters the ids back.  The rest is built whole on every rank by the
single-device ``build_sa_hierarchy`` on the gathered padded operator,
whose identity padding rows become singleton aggregates there.

One departure from the reference keeps the filtered operator equal to the
single-device build's: the lumped filter sums each row's dropped entries
in slot order (``_slot_sum``, as ``setup/aggregation._lumped_filter``
does), where the reference's ``jnp.sum`` reduces in another order.

``dist_build_sa_hierarchy`` returns the port's ``DistHierarchy``, which
``dist_solve`` takes unchanged; its levels carry no banded layout, so the
sharded solve takes the ELL halo route, as in the reference.  On CUDA
tensors every program runs on the device; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import (EllMatrix, _np, ell_from_csr, ell_to_csr,
                                       pad_rows, to_tensor)
from raptor_tpu_torch.ops.sparse_ops import (_slot_sum, _spgemm_width,
                                             ell_add_fixed, ell_transpose,
                                             spgemm_fixed, spmv)
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.parallel.dist import DistHierarchy, DistLevel
from raptor_tpu_torch.parallel.dist_setup import (_as_P, _dinv, _dist_lmax,
                                                  _exchange_rows, _ext2glob,
                                                  _gather_structure, _host_int,
                                                  _make_dist, _np_dtype, _rows,
                                                  _run_ac, _run_rap,
                                                  _run_widths, _widen_rap_plan)
from raptor_tpu_torch.parallel.halo import (halo_exchange, halo_exchange_many,
                                            halo_reduce)
from raptor_tpu_torch.parallel.partition import DistMatrix, plan_and_remap

__all__ = ["dist_build_sa_hierarchy"]


# ---------------------------------------------------------------------------
# Host structure passes (every rank runs them on the gathered level)
# ---------------------------------------------------------------------------

def _host_aggregate(data_np, cols_np, nnz_np, real_nodal, n_pad: int, bs: int,
                    cfg: AmgConfig, seed: int):
    """The decision pass: nodal condensation, SA strength, distance-two MIS
    and capped assignment on the level's global values (the host route's
    ``_np_aggregate``: the same aggregates).  ``real_nodal`` (nn_pad,)
    marks the real nodal lanes: on coarse levels each rank's padding lies
    inside the lane space, so the pass runs on the compacted real
    submatrix and scatters the ids back.  Returns (agg (nn_pad,) int32,
    -1 on padding lanes; n_agg; nn_pad)."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.aggregation import AGG_SIZE_CAP
    from raptor_tpu_torch.setup.host_aggregation import _np_aggregate
    from raptor_tpu_torch.setup.host_setup import _ell_np_to_coo

    A_csr = _ell_np_to_coo(data_np, cols_np, nnz_np, n_pad, n_pad).tocsr()
    if bs > 1:
        nn_pad = n_pad // bs
        S = sp.csr_matrix((np.ones(n_pad, data_np.dtype),
                           (np.arange(n_pad), np.arange(n_pad) // bs)),
                          shape=(n_pad, nn_pad))
        absA = A_csr.copy()
        absA.data = np.abs(absA.data)
        C = (S.T @ absA @ S).tocsr()
    else:
        C, nn_pad = A_csr, n_pad
    r = np.flatnonzero(real_nodal)
    agg_c, n_agg = _np_aggregate(C[r][:, r].tocsr(), r.size, r.size, cfg.theta,
                                 seed, AGG_SIZE_CAP)
    agg = np.full(nn_pad, -1, np.int32)
    agg[r] = agg_c
    return agg, n_agg, nn_pad


def _coarse_numbering(agg, n_agg: int, nn_pad: int, ndev: int):
    """Aggregate ownership (the rank of the smallest member lane) and the
    block-padded numbering.  Returns (owner, rank within the owner, (ndev,)
    aggregates per rank, max_agg: the largest count rounded up to 8)."""
    first_member = np.full(n_agg, nn_pad, np.int64)
    lanes = np.arange(nn_pad)
    real = agg >= 0
    np.minimum.at(first_member, agg[real], lanes[real])
    owner = first_member // (nn_pad // ndev)
    cc_agg = np.bincount(owner, minlength=ndev)
    max_agg = pad_rows(int(cc_agg.max(initial=1)), 8)
    rank = np.zeros(n_agg, np.int64)
    for p in range(ndev):
        sel = owner == p
        rank[sel] = np.arange(int(sel.sum()))
    return owner, rank, cc_agg, max_agg


def _member_table(agg, n_agg: int, owner, rank, ndev: int, max_agg: int):
    """(ndev, max_agg, max_nodes) int64: each rank's owned aggregates'
    member lanes in ascending order, -1 padding."""
    lanes = np.flatnonzero(agg >= 0)
    order = np.argsort(agg[lanes], kind="stable")
    mem_lanes, mem_aggs = lanes[order], agg[lanes][order]
    counts = np.bincount(mem_aggs, minlength=n_agg)
    starts = np.r_[0, np.cumsum(counts[:-1])]
    max_nodes = max(int(counts.max(initial=1)), 1)
    tbl = np.full((ndev, max_agg, max_nodes), -1, np.int64)
    slot = np.arange(mem_lanes.size) - starts[mem_aggs]
    tbl[owner[mem_aggs], rank[mem_aggs], slot] = mem_lanes
    return tbl


def _ghost_sets(cols_np, nnz_np, ndev: int, nc_own: int, extra) -> list:
    """Every rank's sorted ghost set as ``plan_and_remap`` builds it (host
    bookkeeping that maps any global index to its extended position)."""
    K, n_rows = cols_np.shape
    nl = n_rows // ndev
    mask = np.arange(K)[:, None] < nnz_np[None, :]
    owner = cols_np // nc_own
    shard_of_row = np.repeat(np.arange(ndev), nl)[None, :]
    out = []
    for p in range(ndev):
        g = cols_np[mask & (shard_of_row == p) & (owner != p)]
        if extra is not None and len(extra[p]):
            e = np.asarray(extra[p])
            g = np.concatenate([g, e[e // nc_own != p]])
        out.append(np.unique(g))
    return out


def _member_ext(tbl_p, ghosts_p, p: int, n_local: int, bs: int):
    """(ext, valid), each (max_agg, max_nodes * bs): rank p's member dofs
    as indices of its extended vector (owned block, then ghosts), and
    which slots hold a member (padding: index 0, not valid)."""
    t = tbl_p[:, :, None]
    dofs = np.where(t >= 0, t * bs + np.arange(bs), -1).reshape(
        tbl_p.shape[0], -1)
    own = (dofs >= p * n_local) & (dofs < (p + 1) * n_local)
    gpos = np.searchsorted(ghosts_p, np.maximum(dofs, 0))
    gpos = np.clip(gpos, 0, max(ghosts_p.size - 1, 0))
    ext = np.where(own, dofs - p * n_local, n_local + gpos)
    return np.where(dofs >= 0, ext, 0).astype(np.int64), dofs >= 0


# ---------------------------------------------------------------------------
# Per-level programs, each run by every rank on its own shard
# ---------------------------------------------------------------------------

def _run_qr(ring: Ring, plan, B_loc, ext, valid, nc: int):
    """The batched tentative QR (``setup/aggregation._tentative`` on
    shards): the rank factors its owned aggregates from the halo-delivered
    candidate rows, scatters Q into the member dofs' extended slots and
    folds them onto the dofs' owners with the adjoint halo reduce.
    ``B_loc`` (nc, n_local) holds the rank's candidate rows.  Returns (the
    tentative P's (nc, n_local) values, Bc (max_agg * nc, nc): the R
    blocks, the next level's candidates)."""
    max_agg = ext.shape[0]
    B_ext = halo_exchange_many(B_loc, plan, ring)  # (nc, n_ext)
    rows = B_ext[:, ext].permute(1, 2, 0)  # (max_agg, max_nodes * bs, nc)
    rows = torch.where(valid[:, :, None], rows, 0)
    Q, R = torch.linalg.qr(rows, mode="reduced")
    # signs fixed so that R's diagonal is >= 0
    sgn = torch.where(torch.diagonal(R, dim1=1, dim2=2) < 0, -1.0, 1.0).to(B_loc.dtype)
    Q = Q * sgn[:, None, :]
    R = R * sgn[:, :, None]
    # padding slots scatter into a drop slot one past the extended vector
    tgt = torch.where(valid, ext, plan.n_ext).reshape(-1)
    Qm = torch.where(valid[:, :, None], Q, 0).permute(2, 0, 1).reshape(nc, -1)
    vals_ext = B_loc.new_zeros(nc, plan.n_ext + 1).index_add_(1, tgt, Qm)
    Pt = torch.stack([halo_reduce(vals_ext[j, :plan.n_ext], plan, ring, op="add")
                      for j in range(nc)])
    return Pt, R.reshape(max_agg * nc, nc)


def _lane_ids(ring: Ring, n_local: int, device) -> torch.Tensor:
    """(n_local,) global indices of the rank's rows."""
    return ring.axis_index * n_local + torch.arange(n_local, device=device)


def _sm_lumped_filter(ring: Ring, A_loc: EllMatrix, plan, gext, tol: float,
                      bs: int) -> EllMatrix:
    """``setup/aggregation._lumped_filter`` on the rank's rows: the column
    diagonals arrive by halo exchange, the same-node test runs on global
    lane ids, and the lump sums in slot order, so the filtered rows equal
    the single-device build's."""
    ri = A_loc.row_index()
    valid = A_loc.slot_mask()
    isdiag = (A_loc.cols == ri) & valid
    cols = A_loc.cols.long()
    dabs = A_loc.diagonal().abs()
    dj = halo_exchange(dabs, plan, ring)[cols]
    thr = tol * torch.sqrt(dabs[None, :] * dj)
    lane_g = _lane_ids(ring, A_loc.n_rows_pad, A_loc.data.device)
    samenode = torch.div(gext[cols], bs, rounding_mode="floor") == (lane_g // bs)[None, :]
    drop = valid & ~samenode & (A_loc.data.abs() < thr)
    lump = _slot_sum(torch.where(drop, A_loc.data, 0))
    data = torch.where(drop, 0, A_loc.data) + torch.where(isdiag, lump[None, :], 0)
    return dataclasses.replace(A_loc, data=data,
                               cols=torch.where(drop, ri, cols).to(torch.int32))


def _block_smoother(ring: Ring, A_loc: EllMatrix, plan, gext, bs: int,
                    iters: int = 40, safety: float = 1.1):
    """(binv, lambda_max): the inverses of the rank's (bs x bs) diagonal
    blocks, and lambda_max(Dblk^-1 A) by power iteration from the scalar
    estimate's start vector, its norms summed over the ring."""
    n_local = A_loc.n_rows_pad
    dev = A_loc.data.device
    cols = A_loc.cols.long()
    colsg = gext[cols].long()
    lane_g = _lane_ids(ring, n_local, dev)
    hit = (torch.div(colsg, bs, rounding_mode="floor")
           == (lane_g // bs)[None, :]) & A_loc.slot_mask()
    nb = n_local // bs
    # (block, row in block, column in block) flattened; the rest to a dump
    # slot.  A row meets each column once, so every target is hit once
    pos = (torch.arange(n_local, device=dev) // bs * bs + lane_g % bs) * bs
    tgt = torch.where(hit, pos[None, :] + colsg % bs, nb * bs * bs).reshape(-1)
    dblk = A_loc.data.new_zeros(nb * bs * bs + 1).index_add_(
        0, tgt, torch.where(hit, A_loc.data, 0).reshape(-1))
    binv = torch.linalg.inv(dblk[:-1].reshape(nb, bs, bs)).to(A_loc.dtype)

    def app(v):
        w = spmv(A_loc, halo_exchange(v, plan, ring)).reshape(-1, bs)
        return torch.einsum("nij,nj->ni", binv, w).reshape(-1)

    def nrm2(u):
        return ring.psum(torch.dot(u, u))

    v = torch.sin(lane_g.to(A_loc.dtype) * 0.7511) + 0.01
    v = v / torch.sqrt(nrm2(v))
    for _ in range(iters):
        w = app(v)
        v = w / torch.sqrt(nrm2(w))
    w = app(v)
    return binv, safety * ring.psum(torch.dot(v, w)) / nrm2(v)


def _run_smooth(ring: Ring, dm: DistMatrix, pt_arrs, cfg: AmgConfig,
                nc_glob: int, bs: int, gext):
    """P = (I - omega D^-1 A_f) P_t (A_f: A, lumped-filtered when
    ``sa_filter`` > 0) on the rank's rows, and the level's smoother data.
    ``gext``: the rank's extended-index -> global-column map.  Returns
    ((P data, cols, row_nnz), dinv, lambda_max, binv or None)."""
    A_loc = dm.local_ell()
    plan = dm.halo
    n_local = dm.n_rows_local
    nc = pt_arrs[0].shape[0]
    Pl = _as_P(*pt_arrs, n_local, nc_glob)
    dinv = _dinv(A_loc)
    lmax = _dist_lmax(ring, A_loc, plan, dinv, n_local)
    omega = (cfg.sa_omega / lmax).to(A_loc.dtype)
    P_ext = _exchange_rows(Pl, plan, nc_glob, ring)
    A_sm = (_sm_lumped_filter(ring, A_loc, plan, gext, cfg.sa_filter, bs)
            if cfg.sa_filter > 0 else A_loc)
    k_dap = _host_int(ring, _spgemm_width(A_sm, P_ext), op="max")
    W = dataclasses.replace(A_sm, data=A_sm.data * (dinv * omega)[None, :])
    DAP = dataclasses.replace(spgemm_fixed(W, P_ext, k_out=k_dap),
                              shape=(n_local, nc_glob), n_cols_pad=nc_glob)
    # the merge's width bound: the distinct columns are at most the sum
    Psm = ell_add_fixed(Pl, DAP, k_out=nc + k_dap, alpha=1.0, beta=-1.0)
    binv = None
    if cfg.smoother in ("block_jacobi", "block_cheb") and bs > 1:
        binv, lmax = _block_smoother(ring, A_loc, plan, gext, bs)
    return (Psm.data, Psm.cols, Psm.row_nnz), dinv, lmax, binv


# ---------------------------------------------------------------------------
# The level loop
# ---------------------------------------------------------------------------

def dist_build_sa_hierarchy(A, config: AmgConfig, ring: Ring, B=None,
                            tail_size: int = 4096, dtype=torch.float32, *,
                            device) -> DistHierarchy:
    """Build this rank's share of a smoothed-aggregation DistHierarchy with
    the setup itself sharded over ``ring`` (module docstring).

    ``A`` is the global scipy matrix on every rank, ``B`` its (n, nc)
    near-nullspace candidates (rigid body modes for elasticity; the
    constant vector by default, at most ``config.num_candidates`` used);
    the rank uploads only its row block to ``device``.  Levels are sharded
    down to ``tail_size`` rows; the rest is built whole on every rank.  The
    result solves with ``dist_solve`` unchanged."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.aggregation import build_sa_hierarchy
    from raptor_tpu_torch.solve.cycle import materialize_tail

    ndev, me = ring.axis_size, ring.axis_index
    np_dtype = _np_dtype(dtype)
    n_in = A.shape[0]
    if B is None:
        B = np.ones((n_in, 1), np.float64)
    B = np.asarray(B, np.float64)[:, :config.num_candidates]
    nc = B.shape[1]
    bs = 3 if (nc >= 3 and n_in % 3 == 0) else 1
    mult = int(np.lcm(max(config.pad_multiple, 8 * ndev), bs * ndev))
    E = ell_from_csr(sp.csr_matrix(A), dtype=np_dtype, row_pad_multiple=mult)
    n_real, n_pad = n_in, E.n_rows_pad
    nl = n_pad // ndev
    data_np, cols_np, nnz_np = E.data, E.cols, E.row_nnz
    A_dist = _make_dist(to_tensor(_rows(E.data, ring), device).contiguous(),
                        cols_np, nnz_np, ring, nl, E.K, E.shape, device)
    Bd = np.zeros((nc, n_pad), np_dtype)
    Bd[:, :n_real] = B.T
    B_loc = to_tensor(_rows(Bd, ring), device).contiguous()
    # the real nodal lanes: a prefix on the fine level, and on a coarse one
    # the first cc_agg[p] aggregates of each rank's max_agg block
    real_nodal = np.arange(n_pad // bs) < (n_in // bs)

    records = []  # the parts of each sharded level
    while n_real > tail_size and len(records) + 2 < config.max_levels:
        if data_np is None:
            data_np = _np(ring.all_gather(A_dist.data))
        agg, n_agg, nn_pad = _host_aggregate(data_np, cols_np, nnz_np,
                                             real_nodal, n_pad, bs, config,
                                             config.seed + len(records))
        if n_agg == 0 or n_agg * nc >= 0.7 * n_real:
            break

        # ---- ownership and the block-padded coarse numbering ----
        owner, rank, cc_agg, max_agg = _coarse_numbering(agg, n_agg, nn_pad, ndev)
        agg_glob = owner * max_agg + rank  # aggregate -> global block id
        max_c = max_agg * nc
        nc_glob = ndev * max_c
        tbl = _member_table(agg, n_agg, owner, rank, ndev, max_agg)

        # ---- the widened plan: owners receive their members' rows ----
        extra = [(m[:, None] * bs + np.arange(bs)).ravel()
                 for m in (t[t >= 0] for t in tbl)]
        plan_qr, _ = plan_and_remap(cols_np, nnz_np, ndev, nl, extra_ghosts=extra)
        ghosts = _ghost_sets(cols_np, nnz_np, ndev, nl, extra)
        ext, valid = _member_ext(tbl[me], ghosts[me], me, nl, bs)
        Pt_data, Bc = _run_qr(ring, plan_qr.shard(me, device), B_loc,
                              to_tensor(ext, device), to_tensor(valid, device),
                              nc)

        # the tentative P's pattern (host-known): columns agg_glob * nc + j
        nd = _rows(agg[np.arange(n_pad) // bs], ring)
        agg_dof = np.where(nd >= 0, agg_glob[np.maximum(nd, 0)], -1)
        Pt_cols = np.where(agg_dof[None, :] >= 0,
                           np.maximum(agg_dof[None, :], 0) * nc
                           + np.arange(nc)[:, None], 0).astype(np.int32)
        Pt_nnz = np.where(agg_dof >= 0, nc, 0).astype(np.int32)

        # ---- prolongator smoothing and the level's smoother data ----
        gext = to_tensor(_ext2glob(cols_np, nnz_np, ndev, nl,
                                   A_dist.halo.n_ext)[me], device)
        P, dinv, lmax, binv = _run_smooth(
            ring, A_dist, (Pt_data, to_tensor(Pt_cols, device),
                           to_tensor(Pt_nnz, device)),
            config, nc_glob, bs, gext)

        # ---- the RAP over the P-pattern-widened plan (multi-hop reach) ----
        P_cols_np, P_nnz_np = _gather_structure(ring, P[1], P[2])
        A_rap = _widen_rap_plan(ring, A_dist, cols_np, nnz_np, P_cols_np,
                                P_nnz_np, max_c, device)
        k_ap, k_pt = _run_widths(ring, A_rap, P, max_c)
        AP, Pt, k_ac = _run_rap(ring, A_rap, P, k_ap, k_pt, max_c)
        Ac = _run_ac(ring, A_rap, AP, Pt, int(cc_agg[me]) * nc, k_ac, max_c,
                     filter_tol=config.filter_tol)
        records.append(dict(A=A_dist, dinv=dinv, cheb_lmax=lmax, binv=binv,
                            n=n_real, n_pad=n_pad, P=P,
                            P_host=(P_cols_np, P_nnz_np), Pt=Pt, max_c=max_c,
                            rap_halo=A_rap.halo))

        # ---- the coarse level (a host structure pass) ----
        nc_real = int(cc_agg.sum()) * nc
        cols_np, nnz_np = _gather_structure(ring, Ac[1], Ac[2])
        A_dist = _make_dist(Ac[0], cols_np, nnz_np, ring, max_c, k_ac,
                            (nc_real, nc_real), device)
        data_np = None
        n_real, n_pad, nl, bs = nc_real, nc_glob, max_c, nc
        B_loc = Bc.T.contiguous()
        lanes = np.arange(ndev * max_agg)
        real_nodal = lanes % max_agg < cc_agg[lanes // max_agg]

    if not records:
        raise ValueError(f"nothing to shard: n={n_real} <= tail_size="
                         f"{tail_size} (use build_sa_hierarchy + "
                         "distribute_hierarchy)")

    # ---- the tail, whole on every rank, from the gathered coarse level ----
    A_tail = EllMatrix(data=ring.all_gather(A_dist.data), cols=cols_np,
                       row_nnz=nnz_np, shape=(n_pad, n_pad), n_rows_pad=n_pad,
                       n_cols_pad=n_pad)
    B_tail = _np(ring.all_gather(B_loc)).T.astype(np.float64)  # (n_pad, nc)
    tail_cfg = dataclasses.replace(
        config, max_levels=max(config.max_levels - len(records), 1),
        pad_multiple=8)
    # the block size is the coarse nc, not the fine inference
    tail = build_sa_hierarchy(ell_to_csr(A_tail), tail_cfg, dtype=np_dtype,
                              B=B_tail, block_size=nc, device=device).to(device)
    if config.tail_max_n > 0:
        # the tail cycle as one dense matvec (min_start=0: already coarse)
        tail = materialize_tail(tail, config.tail_max_n, min_start=0)

    # ---- the DistLevels; the last sharded level bridges to the tail ----
    last = records[-1]
    P_g = EllMatrix(data=ring.all_gather(last["P"][0]),
                    cols=to_tensor(last["P_host"][0], device),
                    row_nnz=to_tensor(last["P_host"][1], device),
                    shape=(last["n_pad"], n_pad), n_rows_pad=last["n_pad"],
                    n_cols_pad=n_pad)
    dlevels = []
    for k, rec in enumerate(records):
        Pm = Rm = None
        if k + 1 < len(records):
            nxt = records[k + 1]
            Pd = rec["P"][0]
            Pm = _make_dist(Pd, *rec["P_host"], ring, rec["max_c"], Pd.shape[0],
                            (rec["n"], nxt["n"]), device)
            # R's rows are the owned coarse points, its columns the RAP
            # plan's extended fine space
            Rm = DistMatrix(data=rec["Pt"][0], cols=rec["Pt"][1],
                            row_nnz=rec["Pt"][2], halo=rec["rap_halo"],
                            n_rows_local=rec["max_c"], K=rec["Pt"][0].shape[0],
                            shape=(nxt["n"], rec["n"]))
        dlevels.append(DistLevel(
            A=rec["A"], dinv=rec["dinv"], Pmat=Pm, Rmat=Rm,
            cheb_lmax=rec["cheb_lmax"], n_local=rec["n_pad"] // ndev,
            n=rec["n"], binv=rec["binv"]))
    return DistHierarchy(levels=tuple(dlevels), bridge_P=P_g,
                         bridge_R=ell_transpose(P_g), tail=tail, config=config,
                         ndev=ndev)
