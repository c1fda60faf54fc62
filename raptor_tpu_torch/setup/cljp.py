"""CLJP parallel classical coarsening on the matrix's device.

Counterpart of ``raptor_tpu/setup/cljp.py``.  Cleary-Luby-Jones-Plassmann:
weights w_i = |S_i^T| + rand; each round

  0. undecided points whose weight fell below 1 (no remaining dependents)
     become F,
  1. the independent set of local weight maxima over the active strength
     graph becomes C,
  2. weight-update heuristics rewire the graph:
     H1 — a new C point c stops depending on its influences j in S_c:
          remove c's out-edges, decrement w_j;
     H2 — if j and k both strongly depend on a common new C point c and
          j depends on k, j can get k's information through c:
          remove edge (j, k), decrement w_k;
     edges into new C points (satisfied dependencies) are removed.

H2's common-new-C test uses random 31-bit signatures: each new C point
draws a bit position, a row ORs the bits of its new-C targets, and an edge
matches when the two signatures intersect.  The bit positions are the
reference's threefry draws, bit for bit (``utils/threefry.py``), and every
other step is integer, so the C/F set equals the reference's exactly.
The rounds run as tensor ops on A's device with one host read per round.
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.setup.splitting import (C_PT, F_PT, UNDECIDED,
                                              splitting_weights)
from raptor_tpu_torch.setup.strength import strong_transpose_counts
from raptor_tpu_torch.utils.threefry import cljp_bits

__all__ = ["cljp_splitting", "MAX_CLJP_ROUNDS"]

MAX_CLJP_ROUNDS = 500  # the reference's cap


def cljp_splitting(A: EllMatrix, smask: torch.Tensor,
                   perm: torch.Tensor) -> torch.Tensor:
    """CLJP C/F splitting.  Returns (n_pad,) int32 in {C_PT, F_PT}."""
    n = A.n_rows_pad
    dev = A.data.device
    cols = A.cols.long()
    lam = strong_transpose_counts(A, smask)
    ones = torch.ones(cols.numel(), dtype=torch.int32, device=dev)

    def scatter_count(mask):
        tgt = torch.where(mask, cols, n).reshape(-1)  # n = the dump slot
        out = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        return out.index_add_(0, tgt, ones)[:n]

    cf = torch.full((n,), UNDECIDED, dtype=torch.int32, device=dev)
    edges = smask
    it = 0
    while it < MAX_CLJP_ROUNDS and bool((cf == UNDECIDED).any()):
        # 0. no remaining dependents -> F (lam is tracked unclamped; the
        # clamp applies only inside the weight encoding)
        cf = torch.where((cf == UNDECIDED) & (lam <= 0), F_PT, cf)
        und = cf == UNDECIDED
        w = splitting_weights(lam, perm, n)

        # 1. independent set of local maxima over active edges (both dirs)
        w_und = torch.where(und, w, -1)
        row_part = torch.where(edges, w_und[cols], -1).amax(0)
        edge_w = torch.where(edges, w_und[None, :], -1).reshape(-1)
        col_part = torch.full((n + 1,), -1, dtype=w.dtype, device=dev)
        col_part = col_part.scatter_reduce_(
            0, torch.where(edges, cols, n).reshape(-1), edge_w, "amax",
            include_self=True)[:n]
        new_c = und & (w > torch.maximum(row_part, col_part))
        cf = torch.where(new_c, C_PT, cf)

        # 2a. H1: new C rows stop depending on their influences
        h1 = edges & new_c[None, :]
        dec = scatter_count(h1)

        # 2b. edges into new C are satisfied
        to_c = edges & new_c[cols]

        # 2c. H2 with random bit signatures: each slot's contribution goes
        # to its own row, so a row's signature is the OR over its slots
        bits = cljp_bits(it, n, device=dev)
        cbit = torch.where(new_c, torch.ones_like(bits) << bits, 0)
        contrib = torch.where(to_c, cbit[cols], 0)
        sig = contrib[0]
        for k in range(1, contrib.shape[0]):
            sig = sig | contrib[k]
        still_und = und & ~new_c
        share = (sig[None, :] & sig[cols]) != 0
        h2 = edges & share & still_und[None, :] & still_und[cols]
        dec = dec + scatter_count(h2)

        lam = lam - dec
        edges = edges & ~h1 & ~to_c & ~h2
        it += 1
    return torch.where(cf == UNDECIDED, F_PT, cf)
