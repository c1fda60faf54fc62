"""DIA (offset-diagonal) matrices on structured grids.

Counterpart of ``raptor_tpu/structured/dia.py``.  A stencil-structured
operator stored by diagonals turns SpMV into ``sum_o data_o * x[i + o]``
with no indirect addressing.  Offsets are kept as vector grid offsets
(plain Python metadata) and linearized only when shifting; products of DIA
operators add offset vectors exactly, and boundary-truncated diagonals
guarantee that out-of-grid reads meet zero coefficients.

``dia_spmv`` routes by where the operator's planes live: on the card to a
hand-written kernel (K2 for a constant-coefficient operator, K1 otherwise;
see ``ops/cuda/dia_kernel.py``), elsewhere to the plain roll sum
``dia_spmv_ref``.  ``dia_df64_residual``, the compensated residual of the
refined solve, routes the same way: K7 on the card (its const form for a
constant-coefficient operator, its planes form otherwise),
``dia_df64_residual_ref`` elsewhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raptor_tpu_torch.ops.cuda.dia_kernel import (
    _strides,
    dia_df64_residual_const,
    dia_df64_residual_v2,
    dia_df64_residual_v2_ref,
    dia_spmv_const,
    dia_spmv_const_ref,
    dia_spmv_v2,
    dia_spmv_v2_ref,
    in_grid_mask,
)

__all__ = ["DiaMatrix", "boundary_mask", "boundary_mask_traced",
           "dia_from_stencil", "dia_from_scipy", "dia_to_scipy", "dia_spmv",
           "dia_spmv_ref", "dia_df64_residual", "dia_df64_residual_ref",
           "dia_tri_spmv", "dia_mult", "dia_transpose",
           "dia_add", "dia_filter_offsets", "dia_prune", "dia_rap"]

Vec = Tuple[int, ...]


def _linear(off: Vec, dims: Vec) -> int:
    return int(np.dot(off, _strides(dims)))


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Square operator on a structured grid, stored by diagonals.

    data:    (n_off, n) tensor; ``data[k, i]`` multiplies ``x[i + lin(off_k)]``.
             Boundary-truncated: zero wherever ``i + off_k`` leaves the grid.
    offsets: tuple of integer grid-offset vectors.
    dims:    grid dims, last dim fastest.
    const_planes: None, or one float per offset when every diagonal is
             exactly ``scalar * boundary_mask`` (constant-coefficient
             stencils); SpMV then synthesizes the planes instead of reading
             them.
    """

    data: torch.Tensor
    offsets: Tuple[Vec, ...]
    dims: Vec
    const_planes: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.data.shape != (len(self.offsets), self.n):
            raise ValueError(f"data shape {tuple(self.data.shape)} does not "
                             f"match {len(self.offsets)} offsets on {self.dims}")
        if self.const_planes is not None and (
                len(self.const_planes) != len(self.offsets)
                or any(c is None for c in self.const_planes)):
            raise ValueError("const_planes must give one float per offset")

    @property
    def n(self) -> int:
        return int(np.prod(self.dims))

    @property
    def n_off(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    def linear_offsets(self) -> Tuple[int, ...]:
        return tuple(_linear(o, self.dims) for o in self.offsets)

    def diagonal(self) -> torch.Tensor:
        k = self.offsets.index(tuple([0] * len(self.dims)))
        return self.data[k]

    def to(self, device) -> "DiaMatrix":
        return dataclasses.replace(self, data=self.data.to(device))

    def __repr__(self):
        return f"DiaMatrix(dims={self.dims}, n_off={self.n_off}, dtype={self.dtype})"


def boundary_mask(dims: Vec, off: Vec) -> np.ndarray:
    """(n,) bool: True where i + off stays on the grid (host)."""
    m = np.ones(dims, dtype=bool)
    for ax, d in enumerate(off):
        idx = np.arange(dims[ax])
        ok = (idx + d >= 0) & (idx + d < dims[ax])
        shape = [1] * len(dims)
        shape[ax] = dims[ax]
        m &= ok.reshape(shape)
    return m.ravel()


# (n,) bool boundary mask built on a device from index arithmetic
boundary_mask_traced = in_grid_mask


def _rounded(v: float, dtype: torch.dtype) -> float:
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def dia_from_stencil(stencil: np.ndarray, dims: Vec,
                     dtype: torch.dtype = torch.float32, *,
                     device) -> DiaMatrix:
    """Constant-stencil operator (matches gallery.stencil_grid truncation)."""
    stencil = np.asarray(stencil)
    dims = tuple(int(d) for d in dims)
    offs, planes, consts = [], [], []
    centers = [s // 2 for s in stencil.shape]
    for idx in np.ndindex(*stencil.shape):
        v = stencil[idx]
        if v == 0.0:
            continue
        off = tuple(i - c for i, c in zip(idx, centers))
        offs.append(off)
        planes.append(np.where(boundary_mask(dims, off), v, 0.0))
        # dtype-rounded so the synthesized and stored planes match exactly
        consts.append(_rounded(float(v), dtype))
    data = torch.from_numpy(np.stack(planes).astype(np.float64))
    return DiaMatrix(data=data.to(device=device, dtype=dtype),
                     offsets=tuple(offs), dims=dims, const_planes=tuple(consts))


def dia_from_scipy(a, dims: Vec, dtype: torch.dtype = torch.float32,
                   tol: float = 0.0, *, device) -> DiaMatrix:
    """General conversion: groups entries by vector grid offset (host).

    Entries sharing a (row, offset) are summed in COO order, each step
    rounded to float32 as the reference does (float64 for a float64
    target; a bfloat16 target is rounded once at the end)."""
    import scipy.sparse as sp

    a = sp.coo_matrix(a)
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    if a.shape != (n, n):
        raise ValueError(f"matrix shape {a.shape} does not match dims {dims}")
    ri = np.stack(np.unravel_index(a.row, dims), 1)
    ci = np.stack(np.unravel_index(a.col, dims), 1)
    uniq, inv = np.unique(ci - ri, axis=0, return_inverse=True)
    acc = np.float64 if dtype == torch.float64 else np.float32
    data = np.zeros((len(uniq), n), dtype=acc)
    np.add.at(data, (inv.reshape(-1), a.row), a.data)
    offsets = [tuple(int(v) for v in o) for o in uniq]
    if tol > 0:
        keep = np.abs(data).max(axis=1) > tol
        data = data[keep]
        offsets = [o for o, k in zip(offsets, keep) if k]
    return DiaMatrix(data=torch.from_numpy(data).to(device=device, dtype=dtype),
                     offsets=tuple(offsets), dims=dims)


def dia_to_scipy(A: DiaMatrix):
    import scipy.sparse as sp

    data = A.data.detach().cpu()
    if data.dtype == torch.bfloat16:
        data = data.float()
    data = data.numpy()
    rows, cols, vals = [], [], []
    for k, off in enumerate(A.offsets):
        m = boundary_mask(A.dims, off)
        r = np.nonzero(m & (data[k] != 0))[0]
        rows.append(r)
        cols.append(r + _linear(off, A.dims))
        vals.append(data[k][r])
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(A.n, A.n),
    ).tocsr()


def dia_spmv_ref(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain y = A @ x: the roll sum in offset order, with the planes
    synthesized from ``const_planes`` where the operator has them."""
    if A.const_planes is not None:
        return dia_spmv_const_ref(A.const_planes, A.offsets, A.dims, x)
    return dia_spmv_v2_ref(A.data, A.linear_offsets(), x)


def dia_spmv(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (n,) or (B, n).

    An operator on the card launches K2 when it is constant-coefficient and
    K1 otherwise; anything the kernels do not take (an fp64 or a CPU x,
    say) raises.  An operator elsewhere takes the plain roll sum."""
    if not A.data.is_cuda:
        return dia_spmv_ref(A, x)
    if A.const_planes is not None:
        return dia_spmv_const(A.const_planes, A.offsets, A.dims, x)
    return dia_spmv_v2(A.data, A.linear_offsets(), x)


def dia_df64_residual_ref(A: DiaMatrix, xh, xl, bh, bl):
    """Plain ``(rh, rl) = df64[(bh, bl) - A @ (xh, xl)]``: compensated
    (double-float32) accumulation over the stored planes, op by op (exact
    to ~1e-14 relative, so it certifies 1e-8 without fp64)."""
    return dia_df64_residual_v2_ref(A.data, A.linear_offsets(), xh, xl, bh, bl)


def dia_df64_residual(A: DiaMatrix, xh, xl, bh, bl):
    """The compensated residual ``(rh, rl) = df64[(bh, bl) - A @ (xh, xl)]``
    for vectors of shape (n,).

    An operator on the card launches K7, in its const form (planes
    synthesized from ``const_planes``, which match the stored planes) when
    it is constant-coefficient and in its planes form otherwise; bit-equal
    to the plain version but for the sign of a zero.  Anything K7 does not
    take (fp64 or CPU vectors, bf16 planes, a batch) raises, as
    ``dia_spmv`` does.  An operator elsewhere takes the plain version."""
    if not A.data.is_cuda:
        return dia_df64_residual_ref(A, xh, xl, bh, bl)
    if A.const_planes is not None:
        return dia_df64_residual_const(A.const_planes, A.offsets, A.dims, xh,
                                       xl, bh, bl)
    return dia_df64_residual_v2(A.data, A.linear_offsets(), xh, xl, bh, bl)


def _plane(A: DiaMatrix, k: int, like: torch.Tensor) -> torch.Tensor:
    if A.const_planes is None:
        return A.data[k]
    return torch.zeros(A.n, dtype=like.dtype, device=like.device).masked_fill_(
        boundary_mask_traced(A.dims, A.offsets[k], like.device),
        A.const_planes[k])


def dia_tri_spmv(A: DiaMatrix, x: torch.Tensor, upper: bool) -> torch.Tensor:
    """Strict-triangular product L @ x (lower) or U @ x (upper): the rolled
    read pattern of ``dia_spmv`` restricted to diagonals on one side of the
    main one (linear offset < 0 is exactly the strict lower triangle)."""
    y = torch.zeros_like(x)
    for k, o in enumerate(A.linear_offsets()):
        if o == 0 or (o > 0) != upper:
            continue
        y = y + _plane(A, k, x) * torch.roll(x, -o, dims=-1)
    return y


def dia_transpose(A: DiaMatrix) -> DiaMatrix:
    """A.T: diagonal at -o holds roll(data_o, lin(o)).  Offsets re-sorted so
    structurally-equal operators have identical metadata."""
    items = []
    for k, off in enumerate(A.offsets):
        lin = _linear(off, A.dims)
        items.append((tuple(-d for d in off), torch.roll(A.data[k], lin)))
    items.sort(key=lambda t: t[0])
    return DiaMatrix(data=torch.stack([p for _, p in items]),
                     offsets=tuple(o for o, _ in items), dims=A.dims)


def dia_mult(A: DiaMatrix, B: DiaMatrix, keep=None) -> DiaMatrix:
    """C = A @ B: C_{o1+o2} += A_{o1} * roll(B_{o2}, -lin(o1)).

    The terms of each output offset are summed in the reference's order
    (A's offsets outer, B's inner).  ``keep``: optional predicate
    offset -> bool; output offsets failing it are skipped."""
    if A.dims != B.dims:
        raise ValueError(f"dims differ: {A.dims} vs {B.dims}")
    out: dict = {}
    for i, o1 in enumerate(A.offsets):
        lin1 = _linear(o1, A.dims)
        a = A.data[i]
        for j, o2 in enumerate(B.offsets):
            key = tuple(x + y for x, y in zip(o1, o2))
            if keep is not None and not keep(key):
                continue
            term = a * (B.data[j] if lin1 == 0 else torch.roll(B.data[j], -lin1))
            out[key] = term if key not in out else out[key] + term
    offs = sorted(out)
    return DiaMatrix(data=torch.stack([out[o] for o in offs]),
                     offsets=tuple(offs), dims=A.dims)


def dia_add(A: DiaMatrix, B: DiaMatrix, alpha=1.0, beta=1.0) -> DiaMatrix:
    if A.dims != B.dims:
        raise ValueError(f"dims differ: {A.dims} vs {B.dims}")
    out: dict = {}
    for k, o in enumerate(A.offsets):
        out[o] = alpha * A.data[k]
    for k, o in enumerate(B.offsets):
        t = beta * B.data[k]
        out[o] = out[o] + t if o in out else t
    offs = sorted(out)
    return DiaMatrix(data=torch.stack([out[o] for o in offs]),
                     offsets=tuple(offs), dims=A.dims)


def dia_filter_offsets(A: DiaMatrix, pred) -> DiaMatrix:
    """Drop planes whose offset fails a predicate."""
    idx = [k for k, o in enumerate(A.offsets) if pred(o)]
    return DiaMatrix(data=A.data[idx], offsets=tuple(A.offsets[k] for k in idx),
                     dims=A.dims)


def dia_prune(A: DiaMatrix, tol: float = 0.0) -> DiaMatrix:
    """Drop identically-(near-)zero diagonals (host sync; setup-time only)."""
    mx = A.data.abs().amax(dim=1).float().cpu().numpy()
    scale = mx.max() if mx.size else 1.0
    keep = mx > tol * scale if tol > 0 else mx > 0
    if keep.all():
        return A
    idx = np.nonzero(keep)[0].tolist()
    return DiaMatrix(data=A.data[idx], offsets=tuple(A.offsets[i] for i in idx),
                     dims=A.dims)


def dia_rap(R: DiaMatrix, A: DiaMatrix, P: DiaMatrix) -> DiaMatrix:
    return dia_mult(R, dia_mult(A, P))
