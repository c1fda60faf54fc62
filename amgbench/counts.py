"""The least memory traffic of one V-cycle, counted from the hierarchy's
level sizes and non-zero counts (never from a layout's padding, slots or
planes), and the card's peak that turns it into a least time.

Per operator application: the non-zeros at the configuration's value
precision (none for a constant stencil, whose values are not streamed),
the input vector read once and the output written once.  Elementwise
vector updates are not counted.  A V-cycle with the cheb4 smoother of
degree d makes, on every level above the dense tail: d - 1 applications of
A in the pre-smoother (its first residual is b), one for the residual, d in
the post-smoother, one R and one P; the tail is one dense matvec."""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM 80 GB: HBM3 bandwidth, bytes/s (NVIDIA's data sheet)
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def peak_bytes_per_s(kind: str) -> float | None:
    return PEAK_BYTES_PER_S.get(kind)


@dataclasses.dataclass(frozen=True)
class LevelCount:
    n: int  # rows of this level
    nnz_a: int  # non-zeros of A
    n_coarse: int = 0  # rows of the next level (0 at the tail)
    nnz_p: int = 0  # non-zeros of P (n x n_coarse); R = P^T has as many
    const_a: bool = False  # A is a constant stencil: no value stream


def apply_bytes(nnz: int, n_in: int, n_out: int, value_bytes: int,
                vec_bytes: int, const: bool = False) -> int:
    return (0 if const else nnz * value_bytes) + (n_in + n_out) * vec_bytes


def vcycle_bytes(levels: list, tail: LevelCount, degree: int,
                 value_bytes: int, tail_bytes: int, vec_bytes: int = 4) -> int:
    """Bytes of one cheb4 V-cycle: ``levels`` above the tail, ``tail`` the
    dense operator that ends it (nnz_a = its rows squared)."""
    total = 0
    for lv in levels:
        a = apply_bytes(lv.nnz_a, lv.n, lv.n, value_bytes, vec_bytes, lv.const_a)
        t = apply_bytes(lv.nnz_p, lv.n_coarse, lv.n, value_bytes, vec_bytes)
        total += 2 * degree * a + 2 * t
    total += apply_bytes(tail.nnz_a, tail.n, tail.n, tail_bytes, vec_bytes)
    return total
