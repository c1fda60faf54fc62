"""The sharded algebraic setup: PMIS or CLJP, direct, classical or
extended+i interpolation, aggressive coarsening with multipass
interpolation, and the Galerkin products, each on row shards over a
``Ring``.

Counterpart of ``raptor_tpu/parallel/dist_setup.py`` (RAPtor's
distributed setup: par_strength, par_splitting, par_interpolation and the
ParCSRMatrix RAP).  The reference runs each per-level program under
``shard_map`` from one controller; here one process per rank runs the same
program on its own shard, and every mesh collective is a ``Ring`` call
(``psum``, ``pmax``, ``all_gather``, the halo rounds of ``halo.py``):

* every numeric phase (strength, the PMIS or CLJP rounds, interpolation
  weights, both SpGEMMs of the RAP) runs on the rank's rows and its halo,
  on the rank's device;
* a ``lax.while_loop`` whose bound is a ``psum``'d count becomes a Python
  loop with one ``ring.psum`` read on the host a round, under the
  reference's caps (1000 PMIS rounds, 500 CLJP rounds);
* a scatter with ``mode="drop"`` scatters into a buffer one slot longer and
  slices the dump slot off.

The host keeps the level's integer structure: every rank all-gathers the
level's ``cols`` and ``row_nnz`` and runs the same deterministic NumPy pass
the reference runs on its controller (``plan_and_remap``, ``_ext2glob``,
``_widen_rap_plan``, ``_host_colors``, the G^2 pattern, the block-padded
perm), then keeps its own shard (``HaloPlan.shard``).  Values are gathered
only where the reference brings them to the host:

* the tail operator, which every rank builds whole;
* the last sharded level's P, the bridge to the tail;
* the owned coarse diagonals of ``_run_ac``'s symmetric filter;
* the level's values for the aggressive G^2 strength pass.

Coarse points are numbered block-padded: rank p owns the coarse points of
the fine rows it owned, ``max_c`` a rank (the largest count over the ranks,
rounded up to 8), padding rows taking identity rows.  The hierarchy equals
the single-device one (``setup/hierarchy.py``'s device route) up to this
per-level coarse renumbering, bit for bit: the PMIS and CLJP weights are
taken at each point's single-device ("comparable") index, every sum runs
in the single-device order, and two departures from the reference keep
it so:

* the RAP sums each coarse row's terms in global fine order, not in the
  order of the rank's extended vector (``_run_rap``);
* the aggressive programs take a coarse level's real rows as a prefix of
  each rank's block; the reference tests the global row index against the
  level's size, which takes the last ranks' real rows for padding and
  leaves them out of multipass and refinement.

``dist_build_hierarchy`` returns the port's ``DistHierarchy``, which
``dist_solve`` takes unchanged.  Its levels carry no banded layout, so the
sharded solve on them takes the ELL halo route, as in the reference.  On
CUDA tensors every program runs on the device; nothing falls back to the
CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.core.ell import EllMatrix, _np, ell_from_csr, pad_rows, to_tensor
from raptor_tpu_torch.ops.sparse_ops import (
    _fix_padding_cols,
    _merge_sorted_rows,
    _slot_sum,
    _spgemm_width,
    ell_add_fixed,
    ell_transpose,
    ell_transpose_fixed,
    spgemm_fixed,
    spmv,
)
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.parallel.dist import DistHierarchy, DistLevel
from raptor_tpu_torch.parallel.halo import (halo_exchange, halo_exchange_many,
                                            halo_reduce)
from raptor_tpu_torch.parallel.partition import DistMatrix, plan_and_remap
from raptor_tpu_torch.setup.cljp import MAX_CLJP_ROUNDS
from raptor_tpu_torch.setup.interp import direct_interpolation_core
from raptor_tpu_torch.setup.splitting import (_MAX_PMIS_ROUNDS, C_PT, F_PT,
                                              UNDECIDED, make_perm_np,
                                              splitting_weights)
from raptor_tpu_torch.setup.strength import strength_mask, strong_transpose_counts

__all__ = ["dist_build_hierarchy"]


def _host_int(ring: Ring, t: torch.Tensor, op: str = "sum") -> int:
    """One scalar reduced over the ring, read on the host."""
    t = t.reshape(()).to(torch.int64)
    return int(ring.psum(t) if op == "sum" else ring.pmax(t))


def _counts(ring: Ring, t: torch.Tensor) -> np.ndarray:
    """(ndev,) host array: each rank's scalar ``t``, in rank order."""
    return _np(ring.all_gather(t.reshape(1).to(torch.int64)))


def _scatter_max(n: int, tgt: torch.Tensor, vals: torch.Tensor,
                 fill: int) -> torch.Tensor:
    """(n,) max of ``vals`` at ``tgt`` over ``fill``; targets equal to n are
    dropped (``.at[tgt].max(vals, mode="drop")``)."""
    out = torch.full((n + 1,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, tgt, vals, "amax")[:n]


def _beats_neighbours(ring: Ring, plan, mask, cols, w, und) -> torch.Tensor:
    """(n_local,) bool: undecided points whose weight beats every undecided
    neighbour over the edges ``mask`` in both directions, the incoming
    edges' maxima folded back onto their owners by the adjoint halo."""
    n_ext = plan.n_ext
    w_und = torch.where(und, w, -1)
    row_part = torch.where(mask, halo_exchange(w_und, plan, ring)[cols],
                           -1).amax(0)
    edge_w = torch.where(mask, w_und[None, :], -1).reshape(-1)
    tgt = torch.where(mask, cols, n_ext).reshape(-1)
    col_part = halo_reduce(_scatter_max(n_ext, tgt, edge_w, -1), plan, ring,
                           op="max")
    return und & (w > torch.maximum(row_part, col_part))


def _scatter_count(n: int, tgt: torch.Tensor) -> torch.Tensor:
    """(n,) int32 count of the targets ``tgt`` (n: dropped)."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=tgt.device)
    return out.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))[:n]


# ---------------------------------------------------------------------------
# Per-level programs, each run by every rank on its own shard
# ---------------------------------------------------------------------------

def _run_split(ring: Ring, dm: DistMatrix, perm, cfg: AmgConfig,
               n_pad_cmp: int):
    """Distributed PMIS.  Returns (the rank's (n_local,) int32 C/F shard,
    (ndev,) host array of every rank's C count)."""
    A_loc = dm.local_ell()
    plan = dm.halo
    n_ext = plan.n_ext
    smask = strength_mask(A_loc, cfg.theta, cfg.strength)
    lam = halo_reduce(strong_transpose_counts(A_loc, smask), plan, ring)
    w = splitting_weights(lam, perm, n_pad_cmp)
    cols = A_loc.cols.long()
    tgt = torch.where(smask, cols, n_ext).reshape(-1)  # one per strong edge
    iso = ~smask.any(0) & (lam == 0)
    cf = torch.where(iso, F_PT, UNDECIDED).to(torch.int32)
    rem = _host_int(ring, (cf == UNDECIDED).sum())
    it = 0
    while rem > 0 and it < _MAX_PMIS_ROUNDS:
        cf = torch.where(_beats_neighbours(ring, plan, smask, cols, w,
                                           cf == UNDECIDED), C_PT, cf)
        # neighbours of new C points become F (both edge directions)
        c = (cf == C_PT).to(torch.int32)
        c_ext = halo_exchange(c, plan, ring)
        c_row = (smask & (c_ext[cols] > 0)).any(0)
        edge_c = (smask & (c[None, :] > 0)).to(torch.int32).reshape(-1)
        c_col = halo_reduce(_scatter_max(n_ext, tgt, edge_c, 0), plan, ring,
                            op="max") > 0
        cf = torch.where((cf == UNDECIDED) & (c_row | c_col), F_PT, cf)
        rem = _host_int(ring, (cf == UNDECIDED).sum())
        it += 1
    return cf, _counts(ring, (cf == C_PT).sum())


def _run_split_cljp(ring: Ring, dm: DistMatrix, perm, gidx, cfg: AmgConfig,
                    n_pad_cmp: int):
    """Distributed CLJP (setup/cljp.py on shards): the same integer weights
    and H1/H2 edge updates, the weight decrements assembled by the adjoint
    halo reduce.  ``gidx`` maps each owned slot to its single-device
    (comparable) index, where the H2 bit positions are taken, so the
    trajectory is the single-device one.  Returns (C/F shard, (ndev,) host
    C counts)."""
    from raptor_tpu_torch.utils.threefry import cljp_bits

    A_loc = dm.local_ell()
    plan = dm.halo
    n_ext = plan.n_ext
    n_loc = A_loc.n_rows_pad
    dev = A_loc.data.device
    cols = A_loc.cols.long()
    smask = strength_mask(A_loc, cfg.theta, cfg.strength)
    lam = halo_reduce(strong_transpose_counts(A_loc, smask), plan, ring)
    gidx = gidx.long()

    def scatter_dec(mask):
        part = _scatter_count(n_ext, torch.where(mask, cols, n_ext).reshape(-1))
        return halo_reduce(part, plan, ring)

    cf = torch.full((n_loc,), UNDECIDED, dtype=torch.int32, device=dev)
    edges = smask
    rem = _host_int(ring, torch.tensor(n_loc, device=dev))
    it = 0
    while rem > 0 and it < MAX_CLJP_ROUNDS:
        cf = torch.where((cf == UNDECIDED) & (lam <= 0), F_PT, cf)
        und = cf == UNDECIDED
        new_c = _beats_neighbours(ring, plan, edges, cols,
                                  splitting_weights(lam, perm, n_pad_cmp), und)
        cf = torch.where(new_c, C_PT, cf)

        # H1: new C rows stop depending on their influences
        h1 = edges & new_c[None, :]
        dec = scatter_dec(h1)
        # satisfied dependencies: edges into new C
        new_c_ext = halo_exchange(new_c.to(torch.int32), plan, ring) > 0
        to_c = edges & new_c_ext[cols]

        # H2 with the bit positions of the comparable index
        bits = cljp_bits(it, n_pad_cmp, device=dev)[gidx]
        cbit = torch.where(new_c, torch.ones_like(bits) << bits, 0)
        cbit_ext = halo_exchange(cbit, plan, ring)
        contrib = torch.where(to_c, cbit_ext[cols], 0)
        sig = contrib[0]
        for k in range(1, contrib.shape[0]):  # an OR onto the owned rows
            sig = sig | contrib[k]
        still_und = und & ~new_c
        sig_ext = halo_exchange(sig, plan, ring)
        su_ext = halo_exchange(still_und.to(torch.int32), plan, ring) > 0
        share = (sig[None, :] & sig_ext[cols]) != 0
        h2 = edges & share & still_und[None, :] & su_ext[cols]
        dec = dec + scatter_dec(h2)

        lam = lam - dec
        edges = edges & ~h1 & ~to_c & ~h2
        rem = _host_int(ring, (cf == UNDECIDED).sum())
        it += 1
    cf = torch.where(cf == UNDECIDED, F_PT, cf)
    return cf, _counts(ring, (cf == C_PT).sum())


def _dist_lmax(ring: Ring, A_loc: EllMatrix, plan, dinv, n_local: int,
               iters: int = 40, safety: float = 1.1) -> torch.Tensor:
    """Power iteration for lambda_max(D^-1 A) on shards: the single-device
    ``solve/smoothers.estimate_lmax`` with its norms and dot summed over
    the ring (a 0-d tensor, the same on every rank)."""
    me = ring.axis_index
    dev = A_loc.data.device
    i = (me * n_local + torch.arange(n_local, device=dev)).to(A_loc.dtype)
    v = torch.sin(i * 0.7511) + 0.01

    def nrm2(u):
        return ring.psum(torch.dot(u, u))

    v = v / torch.sqrt(nrm2(v))
    for _ in range(iters):
        w = dinv * spmv(A_loc, halo_exchange(v, plan, ring))
        v = w / torch.sqrt(nrm2(w))
    w = dinv * spmv(A_loc, halo_exchange(v, plan, ring))
    return safety * ring.psum(torch.dot(v, w)) / nrm2(v)


def _as_P(pd, pc, pn, n_rows: int, nc_glob: int) -> EllMatrix:
    return EllMatrix(data=pd, cols=pc, row_nnz=pn, shape=(n_rows, nc_glob),
                     n_rows_pad=n_rows, n_cols_pad=nc_glob)


def _exchange_rows(E: EllMatrix, plan, nc_glob: int, ring: Ring) -> EllMatrix:
    """The rank's (n_local rows) ELL extended with its halo rows: the rank
    then holds whole rows for every fine index of its extended vector."""
    return EllMatrix(data=halo_exchange_many(E.data, plan, ring),
                     cols=halo_exchange_many(E.cols, plan, ring),
                     row_nnz=halo_exchange(E.row_nnz, plan, ring),
                     shape=(plan.n_ext, nc_glob), n_rows_pad=plan.n_ext,
                     n_cols_pad=nc_glob)


def _ext2glob(cols_np: np.ndarray, nnz_np: np.ndarray, ndev: int,
              nc_own: int, n_ext: int) -> np.ndarray:
    """(ndev, n_ext) int32: each rank's extended-index -> global-column map
    (the owned block, then the sorted ghosts, as ``plan_and_remap`` orders
    them).  Unused halo slots point at the rank's first owned column;
    consumers mask them through row_nnz."""
    K, n_rows = cols_np.shape
    nl = n_rows // ndev
    mask = np.arange(K)[:, None] < nnz_np[None, :]
    owner = cols_np // nc_own
    shard_of_row = np.repeat(np.arange(ndev), nl)[None, :]
    out = np.zeros((ndev, n_ext), np.int32)
    for p in range(ndev):
        out[p, :nc_own] = np.arange(p * nc_own, (p + 1) * nc_own)
        g = np.unique(cols_np[mask & (shard_of_row == p) & (owner != p)])
        out[p, nc_own:nc_own + g.size] = g
        out[p, nc_own + g.size:] = p * nc_own
    return out


def _rap_widths(ring: Ring, A_loc: EllMatrix, P_ext: EllMatrix, max_c: int):
    """(k_ap, k_pt), each the maximum over the ring: the width of A @ P on
    the owned rows and of the owned-coarse-column transpose of the
    halo-extended P."""
    me = ring.axis_index
    k_ap = _host_int(ring, _spgemm_width(A_loc, P_ext), op="max")
    owned = (P_ext.slot_mask() & (P_ext.cols >= me * max_c)
             & (P_ext.cols < (me + 1) * max_c))
    loc = torch.where(owned, P_ext.cols - me * max_c, max_c).long()
    k_pt = _host_int(ring, _scatter_count(max_c, loc.reshape(-1)).max(),
                     op="max")
    return k_ap, k_pt


def _coarse_views(ring: Ring, cf, plan, max_c: int):
    """(is_c, is_c_ext, cmap, cmap_ext): C flags and block-padded global
    coarse ids of the owned rows and of the extended vector."""
    is_c = cf == C_PT
    rank = torch.cumsum(is_c, 0, dtype=torch.int32) - 1
    cmap = torch.where(is_c, ring.axis_index * max_c + rank, 0).to(torch.int32)
    is_c_ext = halo_exchange(is_c.to(torch.int32), plan, ring) > 0
    return is_c, is_c_ext, cmap, halo_exchange(cmap, plan, ring)


def _dinv(A_loc: EllMatrix) -> torch.Tensor:
    d = A_loc.diagonal()
    return 1.0 / torch.where(d != 0, d, 1.0)


def _want_lmax(cfg: AmgConfig) -> bool:
    return cfg.smoother in ("chebyshev", "cheb4")


def _run_interp(ring: Ring, dm: DistMatrix, cf, cfg: AmgConfig, max_c: int,
                gext=None):
    """Direct, modified-classical or extended+i interpolation with
    block-padded global coarse columns, the level's smoother data and the
    RAP widths.  ``gext`` ((n_ext,) int32, for classical and extended): the
    rank's extended-index -> global-column map, so the distance-two pass
    compares neighbour-row columns across ranks.

    Returns ((P data, cols, row_nnz), dinv, k_ap, k_pt, lmax or None)."""
    nc_glob = ring.axis_size * max_c
    A_loc = dm.local_ell()
    plan = dm.halo
    n_local = dm.n_rows_local
    smask = strength_mask(A_loc, cfg.theta, cfg.strength)
    is_c, is_c_ext, cmap, cmap_ext = _coarse_views(ring, cf, plan, max_c)

    if cfg.interp == "classical":
        from raptor_tpu_torch.setup.interp import classical_interpolation_core

        colsg = gext[A_loc.cols.long()]  # owned rows, global ids
        Pl = classical_interpolation_core(
            A_loc, halo_exchange_many(A_loc.data, plan, ring),
            halo_exchange_many(colsg, plan, ring),
            halo_exchange(A_loc.row_nnz, plan, ring), smask,
            is_c, is_c_ext, cmap, cmap_ext, gext)
    elif cfg.interp == "extended":
        # the strength-compacted ext+i of the single-device levels:
        # compact the owned rows, then ship the S rows with each entry's
        # global id and coarse id and each row's strong-C sum through the
        # level's halo; distance-two targets ride with the rows
        from raptor_tpu_torch.setup.interp import (EXT_STRONG_MAX_K,
                                                   ext_mm_core,
                                                   strength_compact)

        S_loc, dii0 = strength_compact(A_loc, smask, EXT_STRONG_MAX_K)
        Sc = S_loc.cols.long()
        colsg = gext[Sc]
        sc_own = S_loc.slot_mask() & is_c_ext[Sc]
        cc_own = torch.where(sc_own, cmap_ext[Sc], -1).to(torch.int32)
        rowsum_c = _slot_sum(torch.where(sc_own, S_loc.data, 0))
        Pl = ext_mm_core(
            S_loc, halo_exchange_many(S_loc.data, plan, ring),
            halo_exchange_many(colsg, plan, ring),
            halo_exchange(S_loc.row_nnz, plan, ring),
            halo_exchange_many(cc_own, plan, ring),
            halo_exchange(rowsum_c, plan, ring),
            is_c, is_c_ext, cmap, cmap_ext, gext[:n_local], dii0,
            p_max=cfg.p_max_elements)
    else:
        Pl = direct_interpolation_core(A_loc, smask, is_c, is_c_ext, cmap,
                                       cmap_ext)
    Pl = _as_P(Pl.data, Pl.cols, Pl.row_nnz, n_local, nc_glob)
    k_ap, k_pt = _rap_widths(ring, A_loc, _exchange_rows(Pl, plan, nc_glob, ring),
                             max_c)
    dinv = _dinv(A_loc)
    lmax = _dist_lmax(ring, A_loc, plan, dinv, n_local) if _want_lmax(cfg) else None
    return (Pl.data, Pl.cols, Pl.row_nnz), dinv, k_ap, k_pt, lmax


def _run_split_aggressive(ring: Ring, data_np, cols_np, nnz_np, perm,
                          cfg: AmgConfig, n_pad_cmp: int, n_real: int, device):
    """Distributed aggressive (distance-two) splitting: PMIS on G^2 of the
    strength graph (setup/aggressive.aggressive_splitting on shards).

    The G^2 pattern is a host structure pass over the level's global
    values (NumPy strength mask, SciPy boolean square), laid out with -1
    off-diagonal and +1 diagonal data, so the unchanged ``_run_split`` sees
    every off-diagonal entry as strong and runs the same exact-integer
    PMIS rounds: the C/F set is the single-device one."""
    import scipy.sparse as sp

    from raptor_tpu_torch.setup.host_setup import np_strength_mask

    n_pad = cols_np.shape[1]
    smask = np_strength_mask(data_np, cols_np, nnz_np, cfg.theta, cfg.strength)
    rows = np.broadcast_to(np.arange(n_pad)[None, :], cols_np.shape)
    G = sp.csr_matrix(
        (np.ones(int(smask.sum()) + n_pad, np.float32),
         (np.r_[rows[smask], np.arange(n_pad)],
          np.r_[cols_np[smask], np.arange(n_pad)])),
        shape=(n_pad, n_pad))
    G2 = (G @ G).tocsr()
    G2.sort_indices()
    nnz2 = np.diff(G2.indptr).astype(np.int32)
    K2 = max(int(nnz2.max(initial=1)), 1)
    g2_cols = np.zeros((K2, n_pad), np.int32)
    g2_data = np.zeros((K2, n_pad), np.float32)
    r = np.repeat(np.arange(n_pad), nnz2)
    slot = np.arange(len(G2.indices)) - np.repeat(G2.indptr[:-1], nnz2)
    g2_cols[slot, r] = G2.indices
    g2_data[slot, r] = np.where(G2.indices == r, 1.0, -1.0)

    nl = n_pad // ring.axis_size
    G2_dist = _make_dist(to_tensor(_rows(g2_data, ring), device), g2_cols,
                         nnz2, ring, nl, K2, (n_real, n_real), device)
    # -1 off / +1 diagonal: classical strength marks every off-diagonal
    # entry strong for any theta <= 1
    cfg_g2 = dataclasses.replace(cfg, theta=min(cfg.theta, 0.9),
                                 strength="classical")
    return _run_split(ring, G2_dist, perm, cfg_g2, n_pad_cmp)


def _pad_slots(a: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([a, a.new_zeros((k - a.shape[0],) + a.shape[1:])])


def _run_multipass(ring: Ring, dm: DistMatrix, cf, cfg: AmgConfig,
                   max_c: int, n_own: int, max_passes: int = 4):
    """Distributed Stüben multipass interpolation
    (setup/aggressive.multipass_interpolation on shards): pass 0 is the
    direct core on rows with a strong C neighbour; each later pass
    interpolates the still-empty F rows through interpolated strong
    neighbours, P's halo rows exchanged a pass (the reach grows one graph
    distance a pass, which the level's halo plan covers).  Host-driven
    passes with the rows left and active summed and the product width
    maximised over the ring.  ``n_own``: the rank's real rows (a prefix
    of its block; the rest is padding).

    Returns ((P data, cols, row_nnz), dinv, k_ap, k_pt, lmax or None)."""
    nc_glob = ring.axis_size * max_c
    A_loc = dm.local_ell()
    plan = dm.halo
    n_local = dm.n_rows_local
    dev = A_loc.data.device
    smask = strength_mask(A_loc, cfg.theta, cfg.strength)
    is_c, is_c_ext, cmap, cmap_ext = _coarse_views(ring, cf, plan, max_c)
    P0 = direct_interpolation_core(A_loc, smask, is_c, is_c_ext, cmap, cmap_ext)
    Pl = _as_P(P0.data, P0.cols, P0.row_nnz, n_local, nc_glob)

    is_real_f = (cf == F_PT) & (torch.arange(n_local, device=dev) < n_own)
    off = (A_loc.cols != A_loc.row_index()) & A_loc.slot_mask()
    row_sum = _slot_sum(torch.where(off, A_loc.data, 0))
    diag = A_loc.diagonal()
    cols = A_loc.cols.long()
    for _ in range(max_passes):
        done = Pl.row_nnz > 0
        done_ext = halo_exchange(done.to(torch.int32), plan, ring) > 0
        todo = is_real_f & ~done
        usable = smask & done_ext[cols]
        active = todo & usable.any(0)
        wvals = torch.where(usable & active[None, :], A_loc.data, 0)
        W = dataclasses.replace(A_loc, data=wvals, row_nnz=torch.where(
            active, A_loc.row_nnz, 0).to(torch.int32))
        P_ext = _exchange_rows(Pl, plan, nc_glob, ring)
        k_wp = _host_int(ring, _spgemm_width(W, P_ext), op="max")
        n_todo = _host_int(ring, todo.sum())
        n_act = _host_int(ring, active.sum())
        if n_todo == 0 or n_act == 0:
            break
        k_new = max(Pl.K, k_wp)
        dtil = diag + (row_sum - _slot_sum(wvals))
        dtil = torch.where(dtil != 0, dtil, 1.0)
        WP = spgemm_fixed(W, P_ext, k_out=k_wp)
        scale = torch.where(active, -1.0 / dtil, 0.0).to(WP.dtype)
        # active rows were empty in P (that is what made them active), so
        # the update is a per-row select, no merge
        sel = active[None, :]
        Pl = _as_P(
            torch.where(sel, _pad_slots(WP.data * scale[None, :], k_new),
                        _pad_slots(Pl.data, k_new)),
            torch.where(sel, _pad_slots(WP.cols, k_new), _pad_slots(Pl.cols, k_new)),
            torch.where(active, WP.row_nnz, Pl.row_nnz).to(torch.int32),
            n_local, nc_glob)

    k_ap, k_pt = _rap_widths(ring, A_loc, _exchange_rows(Pl, plan, nc_glob, ring),
                             max_c)
    dinv = _dinv(A_loc)
    lmax = _dist_lmax(ring, A_loc, plan, dinv, n_local) if _want_lmax(cfg) else None
    return (Pl.data, Pl.cols, Pl.row_nnz), dinv, k_ap, k_pt, lmax


def _run_interp_refine(ring: Ring, dm: DistMatrix, cf, p_arrs, cfg: AmgConfig,
                       max_c: int, n_own: int):
    """Distributed Jacobi interpolation refinement
    (setup/aggressive.jacobi_refine_p on shards): a pass exchanges P's halo
    rows, forms U = A @ P_ext scaled by -omega D^-1 on the real F rows, and
    sets P <- trunc_{p_max}(P + U); one width maximised over the ring a
    pass.  ``n_own``: the rank's real rows, as in ``_run_multipass``."""
    from raptor_tpu_torch.setup.aggressive import ell_truncate_p

    nc_glob = ring.axis_size * max_c
    A_loc = dm.local_ell()
    plan = dm.halo
    n_local = dm.n_rows_local
    dev = A_loc.data.device
    real = torch.arange(n_local, device=dev) < n_own
    scale = torch.where((cf == F_PT) & real,
                        -cfg.interp_refine_omega * _dinv(A_loc), 0.0)
    Pl = _as_P(*p_arrs, n_local, nc_glob)
    for _ in range(cfg.interp_refine):
        P_ext = _exchange_rows(Pl, plan, nc_glob, ring)
        k_ap = _host_int(ring, _spgemm_width(A_loc, P_ext), op="max")
        U = spgemm_fixed(A_loc, P_ext, k_out=k_ap)
        U = dataclasses.replace(U, data=U.data * scale.to(U.dtype)[None, :])
        Pl = ell_truncate_p(ell_add_fixed(Pl, U, k_out=Pl.K + k_ap),
                            cfg.p_max_elements)
    return Pl.data, Pl.cols, Pl.row_nnz


def _run_widths(ring: Ring, dm: DistMatrix, p_arrs, max_c: int):
    """(k_ap, k_pt) of the RAP measured against this DistMatrix's halo plan:
    a widened plan (``_widen_rap_plan``) assembles more fine rows per owned
    coarse column than the level's distance-one plan."""
    nc_glob = ring.axis_size * max_c
    Pl = _as_P(*p_arrs, dm.n_rows_local, nc_glob)
    return _rap_widths(ring, dm.local_ell(),
                       _exchange_rows(Pl, dm.halo, nc_glob, ring), max_c)


def _global_order(ring: Ring, dm: DistMatrix) -> torch.Tensor:
    """(n_ext,) int64: the extended slots of ``dm``'s plan in ascending
    global index, the unused halo slots and the drop slot last."""
    nl = dm.n_rows_local
    own = (torch.arange(1, nl + 1, device=dm.data.device)
           + ring.axis_index * nl)
    gid = halo_exchange(own, dm.halo, ring)  # 0 in the unused slots
    key = torch.where(gid > 0, gid, torch.iinfo(gid.dtype).max)
    return torch.argsort(key, stable=True)


def _run_rap(ring: Ring, dm: DistMatrix, p_arrs, k_ap: int, k_pt: int,
             max_c: int):
    """AP = A @ P on the owned rows; Pt = the owned-coarse-column transpose
    of the halo-extended P; and the exact Ac width over the ring.  Returns
    ((AP data, cols, row_nnz), (Pt data, cols, row_nnz), k_ac)."""
    nc_glob = ring.axis_size * max_c
    A_loc = dm.local_ell()
    plan = dm.halo
    me = ring.axis_index
    P_ext = _exchange_rows(_as_P(*p_arrs, dm.n_rows_local, nc_glob), plan,
                           nc_glob, ring)
    AP = spgemm_fixed(A_loc, P_ext, k_out=k_ap)
    # entries of other ranks' coarse columns go to the sentinel column
    # max_c, which the transpose drops: their coarse rows are assembled by
    # their owners, which hold the fine rows they need in their own halo
    owned = (P_ext.cols >= me * max_c) & (P_ext.cols < (me + 1) * max_c)
    # the transpose lists each coarse row's fine rows in the order of its
    # input rows, and Ac = Pt @ AP_ext sums their terms in that order: the
    # extended slots go in global fine order (lower ranks' ghosts, the
    # owned block, higher ranks' ghosts), so the sums are the single-device
    # build's bit for bit.  In extended order (the owned block first) they
    # round differently, and a strength test that meets its threshold
    # exactly (Poisson's Galerkin values do) can then come out otherwise
    order = _global_order(ring, dm)
    P_lc = EllMatrix(data=P_ext.data[:, order],
                     cols=torch.where(owned, P_ext.cols - me * max_c,
                                      max_c)[:, order],
                     row_nnz=P_ext.row_nnz[order], shape=(plan.n_ext, max_c),
                     n_rows_pad=plan.n_ext, n_cols_pad=max_c)
    Pt = ell_transpose_fixed(P_lc, k_out=k_pt)  # (max_c, n_ext fine)
    Pt = dataclasses.replace(Pt, cols=_fix_padding_cols(
        order[Pt.cols.long()].to(torch.int32), Pt.row_nnz))
    AP_ext = _exchange_rows(AP, plan, nc_glob, ring)
    k_ac = _host_int(ring, _spgemm_width(Pt, AP_ext), op="max")
    return ((AP.data, AP.cols, AP.row_nnz), (Pt.data, Pt.cols, Pt.row_nnz),
            k_ac)


def _run_ac(ring: Ring, dm: DistMatrix, ap_arrs, pt_arrs, n_c: int, k_ac: int,
            max_c: int, filter_tol: float = 0.0):
    """The owned coarse rows Ac = Pt @ AP_ext (global coarse columns),
    identity-padded on the rank's coarse padding (rank >= ``n_c``, its C
    count) and on dead rows.  ``filter_tol`` applies
    ops.sparse_ops.ell_filter_fixed to the owned rows (the diagonal test on
    the global coarse ids; the remote diagonals from one all-gather)."""
    nc_glob = ring.axis_size * max_c
    plan = dm.halo
    dev = ap_arrs[0].device
    AP_ext = _exchange_rows(_as_P(*ap_arrs, dm.n_rows_local, nc_glob), plan,
                            nc_glob, ring)
    Pt = EllMatrix(data=pt_arrs[0], cols=pt_arrs[1], row_nnz=pt_arrs[2],
                   shape=(max_c, plan.n_ext), n_rows_pad=max_c,
                   n_cols_pad=plan.n_ext)
    Ac = spgemm_fixed(Pt, AP_ext, k_out=k_ac)
    rank = torch.arange(max_c, device=dev)
    row_g = (ring.axis_index * max_c + rank)[None, :]

    if filter_tol > 0:
        # the symmetric criterion |a_ij| < tol * sqrt(d_i d_j), the dropped
        # entries lumped into the diagonal
        sm = Ac.slot_mask()
        off = (Ac.cols != row_g) & sm
        mag = torch.where(off, Ac.data.abs(), 0)
        d_own = _slot_sum(torch.where((Ac.cols == row_g) & sm, Ac.data, 0)).abs()
        d_glob = ring.all_gather(d_own)
        scale = torch.sqrt(d_own[None, :]
                           * d_glob[Ac.cols.long().clamp(0, nc_glob - 1)])
        drop = off & (mag < filter_tol * scale)
        lump = _slot_sum(torch.where(drop, Ac.data, 0))
        keep = sm & ~drop
        fcols = torch.where(keep, Ac.cols, nc_glob)
        is_diag = keep & (Ac.cols == row_g)
        fvals = torch.where(keep, Ac.data + torch.where(is_diag, lump[None, :], 0), 0)
        fcols, order = torch.sort(fcols, dim=0, stable=True)
        # a compaction: the kept entries' columns are distinct
        oc, ov, nnz2 = _merge_sorted_rows(fcols, fvals.gather(0, order),
                                          nc_glob, k_ac, max_run=1)
        Ac = dataclasses.replace(Ac, data=ov, cols=_fix_padding_cols(oc, nnz2),
                                 row_nnz=nnz2)
    hit = (Ac.cols == row_g) & Ac.slot_mask()
    diag = torch.where(hit, Ac.data, 0).sum(0)
    padrow = (rank >= n_c) | (diag == 0)
    k0 = torch.arange(Ac.K, device=dev)[:, None] == 0
    pad = padrow[None, :]
    data = torch.where(pad & k0, 1.0, torch.where(pad, 0.0, Ac.data)).to(Ac.dtype)
    cols = torch.where(pad & k0, row_g, torch.where(pad, 0, Ac.cols)).to(torch.int32)
    nnz = torch.where(padrow, 1, Ac.row_nnz).to(torch.int32)
    return data, cols, nnz


# ---------------------------------------------------------------------------
# Host structure passes (every rank runs them on the gathered structure)
# ---------------------------------------------------------------------------

def _rows(a: np.ndarray, ring: Ring) -> np.ndarray:
    """This rank's contiguous block of the last axis of a global array."""
    nl = a.shape[-1] // ring.axis_size
    return a[..., ring.axis_index * nl:(ring.axis_index + 1) * nl]


def _make_dist(data, cols_np: np.ndarray, nnz_np: np.ndarray, ring: Ring,
               nc_own: int, K: int, shape, device,
               extra_ghosts=None) -> DistMatrix:
    """The rank's DistMatrix from its values (``data``, (K, n_local) on the
    device) and the global host structure; the values are not touched."""
    plan, new_cols = plan_and_remap(cols_np, nnz_np, ring.axis_size, nc_own,
                                    extra_ghosts=extra_ghosts)
    return DistMatrix(
        data=data, cols=to_tensor(_rows(new_cols, ring), device),
        row_nnz=to_tensor(_rows(nnz_np, ring), device),
        halo=plan.shard(ring.axis_index, device),
        n_rows_local=cols_np.shape[1] // ring.axis_size, K=K, shape=shape)


def _gather_structure(ring: Ring, cols, nnz):
    """The global host (cols, row_nnz) of a row-sharded ELL."""
    return _np(ring.all_gather(cols)), _np(ring.all_gather(nnz))


def _widen_rap_plan(ring: Ring, dm: DistMatrix, cols_np, nnz_np, P_cols_np,
                    P_nnz_np, max_c: int, device) -> DistMatrix:
    """A's DistMatrix on its halo plan widened with the P^T pattern: when P
    reaches coarse points more than one graph distance away (multipass,
    ext+i), each coarse row's owner must receive every contributing fine
    row, which the operator's distance-one halo no longer covers."""
    n_pad = cols_np.shape[1]
    pmask = np.arange(P_cols_np.shape[0])[:, None] < P_nnz_np[None, :]
    fine = np.broadcast_to(np.arange(n_pad)[None, :], P_cols_np.shape)
    owner_c = P_cols_np // max_c
    extra = [np.unique(fine[pmask & (owner_c == p)])
             for p in range(ring.axis_size)]
    return _make_dist(dm.data, cols_np, nnz_np, ring, n_pad // ring.axis_size,
                      dm.K, dm.shape, device, extra_ghosts=extra)


def _host_colors(cols_np, nnz_np, n_pad: int):
    """Greedy multicolour Gauss-Seidel colours of the global structure."""
    import scipy.sparse as sp

    from raptor_tpu_torch.solve.smoothers import greedy_coloring_host

    K = cols_np.shape[0]
    mask = np.arange(K)[:, None] < nnz_np[None, :]
    rows = np.broadcast_to(np.arange(n_pad), (K, n_pad))
    a = sp.coo_matrix((np.ones(int(mask.sum())), (rows[mask], cols_np[mask])),
                      shape=(n_pad, n_pad)).tocsr()
    g = ((a + a.T) != 0).tocsr()
    col, ncolors = greedy_coloring_host(g.indptr, g.indices, n_pad)
    return col.astype(np.int32), ncolors


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _comparable_order(cc: np.ndarray, max_c: int, n_pad_cmp: int, seed: int):
    """(perm, gidx), each (ndev * max_c,) int32 on the host: the block-
    padded coarse level's PMIS tie-break weights and comparable indices.
    Slot (p, r) is the global C point offset[p] + r of the single-device
    order; padding slots take the last comparable index."""
    ndev = cc.shape[0]
    nc_real = int(cc.sum())
    ps = make_perm_np(nc_real, n_pad_cmp, seed)
    pd = np.zeros(ndev * max_c, dtype=np.int32)
    gd = np.full(ndev * max_c, n_pad_cmp - 1, dtype=np.int32)
    off = np.concatenate([[0], np.cumsum(cc)[:-1]]).astype(np.int64)
    for p in range(ndev):
        lo, c = p * max_c, int(cc[p])
        pd[lo:lo + c] = ps[off[p]:off[p] + c]
        gd[lo:lo + c] = np.arange(off[p], off[p] + c, dtype=np.int32)
    return pd, gd


# ---------------------------------------------------------------------------
# The level loop
# ---------------------------------------------------------------------------

def dist_build_hierarchy(A, config: AmgConfig, ring: Ring,
                         tail_size: int = 4096, dtype=torch.float32, *,
                         device) -> DistHierarchy:
    """Build this rank's share of a DistHierarchy with the setup itself
    sharded over ``ring``.

    ``A`` is the global scipy CSR matrix (or an EllMatrix whose padded row
    count divides over the ranks) on every rank; the rank uploads only its
    row block to ``device``.  Supports PMIS or CLJP splitting with direct,
    modified-classical or extended+i interpolation, and aggressive
    (distance-two) coarsening with multipass interpolation (config 3's
    pipeline); smoothed aggregation is ``parallel/dist_sa.py``'s
    ``dist_build_sa_hierarchy``, and RS takes the single-device build and
    ``distribute_hierarchy``.  Levels are sharded down to
    ``tail_size`` rows; the rest is built whole on every rank.  The result
    equals the single-device hierarchy up to the block-padded coarse
    renumbering and solves with ``dist_solve`` unchanged."""
    if config.splitting == "aggregation":
        raise ValueError("dist_build_hierarchy supports splitting='pmis' or "
                         "'cljp'; smoothed aggregation is "
                         "dist_build_sa_hierarchy")
    if config.splitting not in ("pmis", "cljp"):
        raise ValueError("dist_build_hierarchy supports splitting='pmis' or "
                         f"'cljp' (got {config.splitting!r})")
    if config.interp not in ("direct", "classical", "extended"):
        raise ValueError("dist_build_hierarchy supports interp='direct', "
                         f"'classical' or 'extended' (got {config.interp!r})")
    if config.aggressive and config.splitting != "pmis":
        raise ValueError("distributed aggressive coarsening runs on the "
                         "PMIS engine (distance-2 MIS on G^2)")
    from raptor_tpu_torch.setup.hierarchy import build_hierarchy
    from raptor_tpu_torch.solve.cycle import materialize_tail

    ndev, me = ring.axis_size, ring.axis_index
    np_dtype = _np_dtype(dtype)
    if not isinstance(A, EllMatrix):
        A = ell_from_csr(A, dtype=np_dtype,
                         row_pad_multiple=max(config.pad_multiple, 8 * ndev))
    if A.n_rows_pad % ndev:
        raise ValueError(f"{A.n_rows_pad} rows do not divide over {ndev} "
                         "ranks (pad to a multiple of 8 * ranks first)")

    # the host-resident global structure of the current level
    cols_np, nnz_np = _np(A.cols), _np(A.row_nnz)
    n_real, n_pad = A.shape[0], A.n_rows_pad
    nl = n_pad // ndev
    data0 = to_tensor(_rows(A.data, ring), device).contiguous()
    A_dist = _make_dist(data0, cols_np, nnz_np, ring, nl, A.K, A.shape, device)
    perm = to_tensor(_rows(make_perm_np(n_real, n_pad, config.seed), ring), device)
    gidx = torch.arange(me * nl, (me + 1) * nl, dtype=torch.int32, device=device)
    n_pad_cmp = n_pad
    # the rank's real rows, a prefix of its block: padding rows sit at the
    # end of every rank's block on the coarse levels, so a test of the
    # global row index against n_real would take the last ranks' real rows
    # for padding
    n_own = min(max(n_real - me * nl, 0), nl)

    records = []  # the parts of each sharded level
    while n_real > tail_size and len(records) + 2 < config.max_levels:
        if config.aggressive:
            cf, cc = _run_split_aggressive(
                ring, _np(ring.all_gather(A_dist.data)), cols_np, nnz_np, perm,
                config, n_pad_cmp, n_real, device)
        elif config.splitting == "cljp":
            cf, cc = _run_split_cljp(ring, A_dist, perm, gidx, config, n_pad_cmp)
        else:
            cf, cc = _run_split(ring, A_dist, perm, config, n_pad_cmp)
        nc_real = int(cc.sum())
        if nc_real == 0 or nc_real >= n_real:
            break
        max_c = pad_rows(int(cc.max()), 8)
        nc_glob = ndev * max_c

        A_rap = A_dist
        widen = config.aggressive or config.interp == "extended"
        if config.aggressive:
            P, dinv, k_ap, k_pt, lmax = _run_multipass(ring, A_dist, cf, config,
                                                       max_c, n_own)
            if config.interp_refine > 0:
                P = _run_interp_refine(ring, A_dist, cf, P, config, max_c,
                                       n_own)
        else:
            gext = None
            if config.interp in ("classical", "extended"):
                gext = to_tensor(_ext2glob(cols_np, nnz_np, ndev, nl,
                                           A_dist.halo.n_ext)[me], device)
            P, dinv, k_ap, k_pt, lmax = _run_interp(ring, A_dist, cf, config,
                                                    max_c, gext)
        P_cols_np, P_nnz_np = _gather_structure(ring, P[1], P[2])
        if widen:
            # multipass and ext+i P reach coarse points two or more graph
            # distances away: the RAP's transpose needs the P^T-widened
            # halo, and its width re-measured over it (ell_transpose_fixed
            # truncates silently on a narrow measure)
            A_rap = _widen_rap_plan(ring, A_dist, cols_np, nnz_np, P_cols_np,
                                    P_nnz_np, max_c, device)
            k_ap, k_pt = _run_widths(ring, A_rap, P, max_c)
        AP, Pt, k_ac = _run_rap(ring, A_rap, P, k_ap, k_pt, max_c)
        Ac = _run_ac(ring, A_rap, AP, Pt, int(cc[me]), k_ac, max_c,
                     filter_tol=config.filter_tol)

        color, ncolors = None, 1
        if config.smoother == "mcgs":
            col_np, ncolors = _host_colors(cols_np, nnz_np, n_pad)
            color = to_tensor(_rows(col_np, ring), device)

        records.append(dict(A=A_dist, dinv=dinv, color=color, ncolors=ncolors,
                            cheb_lmax=lmax, n=n_real, n_pad=n_pad, P=P,
                            P_host=(P_cols_np, P_nnz_np), Pt=Pt, max_c=max_c,
                            # Pt's columns index the RAP plan's extended
                            # space (the widened one where there is one)
                            rap_halo=A_rap.halo))

        # ---- the coarse level (a host structure pass) ----
        cols_np, nnz_np = _gather_structure(ring, Ac[1], Ac[2])
        A_dist = _make_dist(Ac[0], cols_np, nnz_np, ring, max_c, k_ac,
                            (nc_real, nc_real), device)
        n_real, n_pad, nl, n_own = nc_real, nc_glob, max_c, int(cc[me])
        # the block-padded perm reproducing the single-device total order
        n_pad_cmp = pad_rows(nc_real, config.pad_multiple)
        pd, gd = _comparable_order(cc, max_c, n_pad_cmp,
                                   config.seed + len(records))
        perm = to_tensor(_rows(pd, ring), device)
        gidx = to_tensor(_rows(gd, ring), device)

    if not records:
        raise ValueError(f"nothing to shard: n={n_real} <= tail_size="
                         f"{tail_size} (use build_hierarchy + "
                         "distribute_hierarchy)")

    # ---- the tail, whole on every rank, from the last coarse operator ----
    A_tail = EllMatrix(data=ring.all_gather(A_dist.data),
                       cols=to_tensor(cols_np, device),
                       row_nnz=to_tensor(nnz_np, device),
                       shape=(n_pad, n_pad), n_rows_pad=n_pad, n_cols_pad=n_pad)
    tail_cfg = dataclasses.replace(
        config, max_levels=max(config.max_levels - len(records), 1))
    tail = build_hierarchy(A_tail, tail_cfg, dtype=_np_dtype(A_tail.dtype),
                           device=device).to(device)
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
            n=rec["n"], color=rec["color"], ncolors=rec["ncolors"]))
    return DistHierarchy(levels=tuple(dlevels), bridge_P=P_g,
                         bridge_R=ell_transpose(P_g), tail=tail, config=config,
                         ndev=ndev)
