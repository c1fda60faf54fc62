"""Shared helpers for the raptor_tpu_torch tests: stencils, shuffled
Poisson matrices, the numpy bridges from a JAX ``SHierarchy`` to the port's
``hierarchy_from_numpy`` tree and from a JAX algebraic ``Hierarchy`` to
``algebraic_hierarchy_from_numpy``'s, and error measures.  Data passes
between the packages as numpy."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

# One intra-op thread a test process.  A run with several pytest workers
# (xdist) puts them on one machine, and every worker imports this module
# when it collects the port's tests.  torch's OpenMP threads spin while they wait,
# so with its default (a thread a core) in each worker they take the cores
# the other workers' work needs; the port's tests run small operators,
# which one thread serves, as it serves the spawned ranks
# (raptor_tpu_torch.parallel.comm._run_rank).
torch.set_num_threads(1)


def cuda_device() -> torch.device:
    """The card for a ``cuda``-marked test; skips (decided at run time,
    never at import) when there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda", 0)


def stencil_7pt() -> np.ndarray:
    st = np.zeros((3, 3, 3))
    st[1, 1, 1] = 6.0
    for d in range(3):
        i = [1, 1, 1]
        for s in (0, 2):
            i[d] = s
            st[tuple(i)] = -1.0
    return st


def stencil_5pt() -> np.ndarray:
    return np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], float)


def np32(a) -> np.ndarray:
    """float32 (bf16 widened exactly) numpy copy of a JAX or torch array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref|."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _dia_tree(m):
    if m is None:
        return None
    return {"data": np.asarray(m.data), "offsets": m.offsets, "dims": m.dims,
            "const_planes": m.const_planes}


def tree_from_jax(hier) -> dict:
    """The plain-numpy tree of a JAX ``SHierarchy`` (bf16 arrays stay
    ml_dtypes bf16; the port's converter widens them exactly)."""
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return {
        "levels": [
            {"A": _dia_tree(lv.A), "Pt": _dia_tree(lv.Pt), "Rt": _dia_tree(lv.Rt),
             "dinv": np.asarray(lv.dinv), "red": np.asarray(lv.red),
             "cheb_lmax": opt(lv.cheb_lmax), "dims": lv.dims, "cdim": lv.cdim}
            for lv in hier.levels
        ],
        "coarse_inv": np.asarray(hier.coarse_inv),
        "tail_op": opt(hier.tail_op),
        "tail_start": hier.tail_start,
        "config": dataclasses.asdict(hier.config),
    }


def shuffled_poisson(nx: int, scale: float = 1.0, seed: int = 0):
    """3D 7-point Poisson on nx^3, symmetrically permuted by
    default_rng(seed) (the reference bench's shuffled input), times
    ``scale`` (pi makes the entries fp32-inexact)."""
    import scipy.sparse as sp

    from raptor_tpu_torch.gallery import poisson_3d

    A = sp.csr_matrix(poisson_3d(nx)) * scale
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def diag_scaled(A, seed: int = 0):
    """D A D with D a diagonal of default_rng(seed) draws in [0.5, 1.5]:
    the same sparsity and an SPD M-matrix again, with coarse Galerkin
    values that meet the strength threshold theta * max at no exact tie
    (the gallery stencils' rational coarse values do, and a tie resolves
    by the summation order, which differs between the two packages)."""
    import scipy.sparse as sp

    d = np.random.default_rng(seed).uniform(0.5, 1.5, A.shape[0])
    D = sp.diags(d)
    return (D @ sp.csr_matrix(A) @ D).tocsr()


def rcm_ell(nx: int):
    """Shuffled nx^3 Poisson, RCM-ordered, as ELL arrays (cols, row_nnz,
    data) with the rows padded to a multiple of 1024."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from raptor_tpu_torch.core.ell import ell_from_csr

    A = shuffled_poisson(nx)
    p = reverse_cuthill_mckee(A + A.T, symmetric_mode=True)
    E = ell_from_csr(A[p][:, p].tocsr(), dtype=np.float32,
                     row_pad_multiple=1024)
    return E.cols, E.row_nnz, E.data


def wide_band(n: int, reach: int):
    """ELL arrays of a matrix with entries at row - reach, row and row +
    reach (clipped to the matrix), random values."""
    rows = np.arange(n)
    cols = np.stack([np.clip(rows - reach, 0, n - 1), rows,
                     np.clip(rows + reach, 0, n - 1)]).astype(np.int32)
    vals = np.random.default_rng(3).standard_normal((3, n)).astype(np.float32)
    return cols, np.full(n, 3, np.int32), vals


def banded_tensors(plan: dict, dtype=torch.float32, device="cpu") -> dict:
    """A NumPy banded plan with ``vals`` (cast to ``dtype``) and ``pidx`` as
    tensors on ``device``."""
    return dict(plan,
                vals=torch.from_numpy(plan["vals"]).to(device=device, dtype=dtype),
                pidx=torch.from_numpy(plan["pidx"]).to(device))


def with_dead_slots(plan: dict, at=(0, 3)) -> dict:
    """A tensor plan with a padding-only slot (range (1, 0), zero values,
    offset 0) put in before each slot index of ``at``: the live slots are
    then no prefix of the slots."""
    vals, pidx, ranges = plan["vals"], plan["pidx"], list(plan["ranges"])
    for k in sorted(at, reverse=True):
        vals = torch.cat([vals[:, :k], torch.zeros_like(vals[:, :1]),
                          vals[:, k:]], 1)
        pidx = torch.cat([pidx[:, :k], torch.zeros_like(pidx[:, :1]),
                          pidx[:, k:]], 1)
        ranges.insert(k, (1, 0))
    return dict(plan, vals=vals.contiguous(), pidx=pidx.contiguous(),
                K=vals.shape[1], ranges=tuple(ranges))


def slots_twice(plan: dict) -> dict:
    """A tensor plan with every slot stored twice (twice the matrix)."""
    return dict(plan, vals=torch.cat([plan["vals"]] * 2, 1).contiguous(),
                pidx=torch.cat([plan["pidx"]] * 2, 1).contiguous(),
                K=2 * plan["K"], ranges=tuple(plan["ranges"]) * 2)


def clamped_rect_plan(device="cpu") -> dict:
    """A rectangular tensor plan (K6's) on ``device``: four tiles over four
    pages of x with WpP 2 and a 5-page window.  Slot 0 reads two pages left
    (x page t - 2), live from tile 2 on; slot 1 the diagonal; slot 2 two
    pages right (x page t + 2), live up to tile 1.
    A masked entry reads its slot's lowest page at index 0, so tiles 0-1
    read x[0] through window pages that clamp from -2 and -1, and tiles 2-3
    read x[3072] through pages that clamp from 4 and 5."""
    T, tile, K = 4, 1024, 3
    rng = np.random.default_rng(11)
    vals = rng.standard_normal((T, K, tile)).astype(np.float32)
    j = np.arange(tile)
    pidx = np.empty((T, K, tile), np.int32)
    for t in range(T):
        pidx[t, 0] = j if t >= 2 else 0
        pidx[t, 1] = 2 * 1024 + j
        pidx[t, 2] = 4 * 1024 + j if t < 2 else 4 * 1024
    vals[:2, 0] = 0.0
    vals[2:, 2] = 0.0
    shape = (T, K, tile // 128, 128)
    return dict(vals=torch.from_numpy(vals.reshape(shape)).to(device),
                pidx=torch.from_numpy(pidx.reshape(shape)).to(device), K=K,
                n=T * tile, n_cols=T * tile, tile=tile, WpP=2, npage=5,
                ranges=((0, 0), (2, 2), (4, 4)))


def random_bell(nb: int, b: int, per_row: int, seed: int = 0,
                pad: int = 8):
    """(BlockEllMatrix with NumPy fp64 leaves, the scipy BSR matrix): nb
    block rows of random b x b blocks, each the diagonal block and 0 to
    per_row - 1 others, so rows differ in length and the shorter ones hold
    zero blocks in their padded slots; identity blocks pad nb up to a
    multiple of ``pad``."""
    import scipy.sparse as sp

    from raptor_tpu_torch.core.bell import bell_from_bsr

    rng = np.random.default_rng(seed)
    cols = [np.union1d(rng.choice(nb, size=min(int(rng.integers(0, per_row)),
                                               nb), replace=False), [i])
            for i in range(nb)]
    indptr = np.cumsum([0] + [len(c) for c in cols])
    blocks = rng.standard_normal((int(indptr[-1]), b, b))
    a = sp.bsr_matrix((blocks, np.concatenate(cols), indptr),
                      shape=(nb * b, nb * b))
    return bell_from_bsr(a, bs=b, dtype=np.float64, row_pad_multiple=pad), a


def star(nd: int) -> list:
    """The 2 * nd + 1 point star's offsets, in C order."""
    import itertools

    return [o for o in itertools.product((-1, 0, 1), repeat=nd)
            if sum(map(abs, o)) <= 1]


def _opt(a):
    return None if a is None else np.asarray(a)


def _ell_tree(E):
    if E is None:
        return None
    return {"data": np.asarray(E.data), "cols": np.asarray(E.cols),
            "row_nnz": np.asarray(E.row_nnz), "shape": E.shape,
            "n_rows_pad": E.n_rows_pad, "n_cols_pad": E.n_cols_pad}


def _band_tree(B):
    if B is None:
        return None
    far = None if B.far is None else {
        "rows": np.asarray(B.far.rows), "cols": np.asarray(B.far.cols),
        "vals": np.asarray(B.far.vals), "meta": B.far.meta}
    d = {"vals": np.asarray(B.vals), "pidx": np.asarray(B.pidx),
         "meta": B.meta, "shape": B.shape, "slot_ranges": B.slot_ranges,
         "far": far}
    if hasattr(B, "perm"):  # square BandedMatrix
        d.update(perm=np.asarray(B.perm), iperm=np.asarray(B.iperm),
                 reordered=B.reordered)
    return d


def _hyb_tree(H):
    if H is None:
        return None
    return {"planes": np.asarray(H.planes), "spill": _ell_tree(H.spill),
            "perm": np.asarray(H.perm), "iperm": np.asarray(H.iperm),
            "offsets": H.offsets, "shape": H.shape, "n_pad": H.n_pad}


def _geo_tree(T):
    if T is None:
        return None
    return {"wm": np.asarray(T.wm), "wp": np.asarray(T.wp), "meta": T.meta}


def _bell_tree(B):
    if B is None:
        return None
    return {"data": np.asarray(B.data), "cols": np.asarray(B.cols),
            "row_nnz": np.asarray(B.row_nnz), "shape": B.shape, "bs": B.bs,
            "nb_pad": B.nb_pad}


def algebraic_tree_from_jax(hier) -> dict:
    """The plain-numpy tree of a JAX algebraic ``Hierarchy`` for
    ``raptor_tpu_torch.setup.convert.algebraic_hierarchy_from_numpy``."""
    return {
        "levels": [
            {"A": _ell_tree(lv.A), "P": _ell_tree(lv.P), "R": _ell_tree(lv.R),
             "dinv": np.asarray(lv.dinv), "cheb_lmax": _opt(lv.cheb_lmax),
             "n": lv.n, "Aband": _band_tree(lv.Aband),
             "Pband": _band_tree(lv.Pband), "Rband": _band_tree(lv.Rband),
             "Ahyb": _hyb_tree(lv.Ahyb), "Tgeo": _geo_tree(lv.Tgeo),
             "color": _opt(lv.color), "ncolors": lv.ncolors,
             "Abell": _bell_tree(lv.Abell), "binv": _opt(lv.binv)}
            for lv in hier.levels
        ],
        "coarse_inv": np.asarray(hier.coarse_inv),
        "perm": _opt(hier.perm), "iperm": _opt(hier.iperm),
        "tail_op": _opt(hier.tail_op), "tail_start": hier.tail_start,
        "a0_lo": _opt(hier.a0_lo), "a0_lo_band": _opt(hier.a0_lo_band),
        "config": dataclasses.asdict(hier.config),
    }


def _dm_block(m, rank: int, ndev: int):
    """Rank ``rank``'s block of a JAX DistMatrix (global arrays, (ndev, m)
    plans) as the plain-numpy dict of a port DistMatrix."""
    if m is None:
        return None
    nl = m.n_rows_local

    def block(a):
        return np.asarray(a)[..., rank * nl:(rank + 1) * nl]

    return {"data": block(m.data), "cols": block(m.cols),
            "row_nnz": block(m.row_nnz),
            "send_idx": [np.asarray(s)[rank] for s in m.halo.send_idx],
            "recv_tgt": [np.asarray(r)[rank] for r in m.halo.recv_tgt],
            "offsets": m.halo.offsets, "n_ext": m.halo.n_ext,
            "n_local": m.halo.n_local, "n_rows_local": nl, "K": m.K,
            "shape": m.shape}


def dist_tree_from_jax(dh, rank: int) -> dict:
    """One rank's blocks of a JAX ``DistHierarchy`` (sharded levels on the
    ELL route) as the plain-numpy tree of
    ``tests/_torch_dist_setup_spmd.hierarchy_from_tree``; the tail (an
    algebraic or a smoothed-aggregation one) and the bridge whole.  A
    level's block-diagonal inverses (``binv``, one (b, b) block per b
    rows) shard with its rows."""
    ndev = dh.ndev
    levels = []
    for lv in dh.levels:
        nl = lv.n_local
        own = slice(rank * nl, (rank + 1) * nl)
        binv = None
        if lv.binv is not None:
            nb = np.asarray(lv.binv).shape[0] // ndev
            binv = np.asarray(lv.binv)[rank * nb:(rank + 1) * nb]
        levels.append({
            "A": _dm_block(lv.A, rank, ndev), "P": _dm_block(lv.Pmat, rank, ndev),
            "R": _dm_block(lv.Rmat, rank, ndev),
            "dinv": np.asarray(lv.dinv)[own],
            "cheb_lmax": _opt(lv.cheb_lmax),
            "color": None if lv.color is None else np.asarray(lv.color)[own],
            "ncolors": lv.ncolors, "n": lv.n, "n_local": nl, "binv": binv})
    return {"levels": levels, "bridge_P": _ell_tree(dh.bridge_P),
            "bridge_R": _ell_tree(dh.bridge_R),
            "tail": algebraic_tree_from_jax(dh.tail),
            "config": dataclasses.asdict(dh.config), "ndev": ndev}


def strict_json(line: str) -> dict:
    """One JSON object, refusing NaN and infinities (not JSON)."""
    def refuse(c):
        raise ValueError(f"{c} is not JSON")

    return json.loads(line, parse_constant=refuse)


def bench_rows(rows, *extra) -> tuple:
    """bench_torch.main on the CPU at its CI sizes for ``rows``: (exit
    code, the row lines by row, the last line), each line strict JSON."""
    import bench_torch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench_torch.main(["--device", "cpu", "--small", "--rows",
                               ",".join(rows), *extra])
    lines = [strict_json(ln) for ln in buf.getvalue().splitlines()]
    return rc, {ln["row"]: ln for ln in lines[:-1]}, lines[-1]
