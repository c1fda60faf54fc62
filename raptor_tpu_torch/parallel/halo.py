"""Halo exchange over a ``Ring``.

Counterpart of ``raptor_tpu/parallel/halo.py`` (RAPtor's ``ParComm``):
gather the plan's send indices from the owned vector, one ring shift per
offset, scatter into the extended vector.  The reference scatters with
``mode="drop"`` into the drop slot ``n_ext``; PyTorch has no drop mode, so
the scatter goes into a buffer one element longer and the drop slot is
sliced off.  The local block's SpMV is the port's plain gather ELL
``ops/sparse_ops.spmv``, as the reference's is plain jnp.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.ops.sparse_ops import spmv
from raptor_tpu_torch.parallel.comm import Ring
from raptor_tpu_torch.parallel.partition import DistMatrix, HaloPlan
from raptor_tpu_torch.solve.krylov import vdot

__all__ = ["halo_exchange", "halo_exchange_many", "halo_reduce", "dist_spmv",
           "psum_dot"]


def halo_exchange(x_own: torch.Tensor, plan: HaloPlan, ring: Ring) -> torch.Tensor:
    """The (n_ext,) extended vector ``[owned | halo | 0]`` of this rank's
    (n_local,) owned block, with the halo values from the other ranks."""
    return halo_exchange_many(x_own[None], plan, ring)[0]


def halo_exchange_many(M: torch.Tensor, plan: HaloPlan, ring: Ring) -> torch.Tensor:
    """Row-batched halo exchange: ``M`` is (K, n_local), K vectors sharing
    one plan (e.g. the K ELL slots of a matrix's rows, exchanged so each
    rank holds whole neighbour rows).  Returns (K, n_ext)."""
    ext = M.new_zeros((M.shape[0], plan.n_ext + 1))  # + the drop slot
    ext[:, : plan.n_local] = M
    for d, sidx, rtgt in zip(plan.offsets, plan.send_idx, plan.recv_tgt):
        ext[:, rtgt] = ring.shift(M[:, sidx], d)
    return ext[:, : plan.n_ext]


def halo_reduce(x_ext: torch.Tensor, plan: HaloPlan, ring: Ring,
                op: str = "add") -> torch.Tensor:
    """Adjoint of ``halo_exchange``: fold halo-slot contributions back onto
    their owners.  ``x_ext`` is the (n_ext,) extended vector whose halo
    slots hold partial contributions for remote-owned entries; returns the
    (n_local,) owned vector with every remote contribution combined in
    (``op`` "add" or "max").  Each ring round of the plan runs backwards:
    gather at recv_tgt, shift by -d, combine at send_idx.  The drop slot
    reads as the op's identity, so plan padding is inert."""
    if op == "add":
        ident = 0
    elif op == "max":
        dt = x_ext.dtype
        ident = (torch.finfo(dt).min if dt.is_floating_point
                 else torch.iinfo(dt).min)
    else:
        raise ValueError(f"halo_reduce op {op!r}: 'add' or 'max'")
    padded = torch.cat([x_ext, x_ext.new_full((1,), ident)])
    out = x_ext[: plan.n_local].clone()
    for d, sidx, rtgt in zip(plan.offsets, plan.send_idx, plan.recv_tgt):
        buf = ring.shift(padded[rtgt], -d)  # halo partials (or identity)
        idx = sidx.long()
        if op == "add":
            out = out.index_add(0, idx, buf)
        else:
            out = out.scatter_reduce(0, idx, buf, reduce="amax")
    return out


def dist_spmv(A: DistMatrix, x_own: torch.Tensor, ring: Ring) -> torch.Tensor:
    """y_own = A_own @ [x_own | halo(x)]."""
    return spmv(A.local_ell(), halo_exchange(x_own, A.halo, ring))


def psum_dot(ring: Ring):
    """Distributed inner product: the local ``vdot`` and one sum over the
    ring, the only global reduction per Krylov iteration (GMRES's batched
    Gram-Schmidt dots reduce in one sum too)."""

    def dot(a, b):
        return ring.psum(vdot(a, b))

    return dot
