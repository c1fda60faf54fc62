"""The least memory traffic of one cycle of an algebraic hierarchy whose
levels may be laid out as b x b blocks (smoothed aggregation, block
Chebyshev), with each level's visits counted as ``solve/cycle._level``
makes them: a W-cycle visits the level below twice from every visit of a
level, and before the second visit applies that level's operator once to
the first one's answer.

Per visit of a level above the tail, with the block (or scalar) fourth-kind
Chebyshev smoother of degree d and one sweep each way: d - 1 applications
of A in the pre-smoother (its first residual is b), one for the residual,
d in the post-smoother; 2d applications of the block-diagonal inverse on a
block level (d a sweep); one R and one P.  The tail is one dense matvec a
visit.  An application reads the operator's values once at the value
precision (a block level's whole blocks, a scalar level's non-zeros, never
a layout's padding), its input vector once and writes its output once;
vector updates are not counted (``amgbench/counts.py``).
"""

from __future__ import annotations

import dataclasses

from amgbench.counts import apply_bytes


@dataclasses.dataclass(frozen=True)
class BlockLevel:
    n: int  # rows of this level
    nnz_a: int  # values of A an application reads (blocks x b^2 on a block level)
    n_coarse: int = 0  # rows of the next level (0 at the tail)
    nnz_p: int = 0  # non-zeros of P; R = P^T has as many
    inv_block: int = 0  # b of the block-diagonal inverse (0: a scalar level)


def _doubled(k: int, n_above: int, cycle: str, revisit_tail: bool) -> bool:
    """Whether a visit of level k visits level k + 1 twice."""
    return cycle == "W" and (k + 1 < n_above or revisit_tail)


def visits(n_above: int, cycle: str, revisit_tail: bool) -> list:
    """Visits of levels 0 .. n_above in one cycle; level n_above is the
    tail (or the coarsest level).  ``revisit_tail``: whether the last
    level above the tail visits it twice in a W-cycle (it does unless the
    tail is the coarsest level itself)."""
    v = [1]
    for k in range(n_above):
        v.append(v[-1] * (2 if _doubled(k, n_above, cycle, revisit_tail) else 1))
    return v


def a_applies(n_above: int, degree: int, cycle: str,
              revisit_tail: bool) -> list:
    """Applications of each level's A in one cycle, levels 0 .. n_above:
    2 * degree a visit above the tail, and one a W revisit of the level
    below, made before its second visit."""
    v = visits(n_above, cycle, revisit_tail)
    out = [2 * degree * v[k] for k in range(n_above)] + [0]
    for k in range(n_above):
        if _doubled(k, n_above, cycle, revisit_tail):
            out[k + 1] += v[k]
    return out


def cycle_bytes(levels: list, tail_n: int, degree: int, cycle: str,
                revisit_tail: bool, value_bytes: int, tail_bytes: int,
                inv_bytes: int = 4, vec_bytes: int = 4) -> int:
    """Bytes of one cycle: ``levels`` are levels 0 .. ts (``BlockLevel``;
    the last one's A counts only for the W revisits), ``tail_n`` the rows
    of the dense operator that ends the cycle at level ts."""
    ts = len(levels) - 1
    v = visits(ts, cycle, revisit_tail)
    na = a_applies(ts, degree, cycle, revisit_tail)
    total = 0
    for k, lv in enumerate(levels):
        total += na[k] * apply_bytes(lv.nnz_a, lv.n, lv.n, value_bytes, vec_bytes)
        if k == ts:
            break
        if lv.inv_block:
            inv = apply_bytes(lv.n * lv.inv_block, lv.n, lv.n, inv_bytes,
                              vec_bytes)
            total += 2 * degree * v[k] * inv
        t = apply_bytes(lv.nnz_p, lv.n_coarse, lv.n, value_bytes, vec_bytes)
        total += 2 * v[k] * t
    total += v[ts] * apply_bytes(tail_n * tail_n, tail_n, tail_n, tail_bytes,
                                 vec_bytes)
    return total
