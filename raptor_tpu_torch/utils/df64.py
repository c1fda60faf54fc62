"""Double-float32 ("df64") compensated arithmetic for residuals.

Error-free transformations (Knuth two-sum, Dekker two-product) represent a
value as an unevaluated fp32 pair (hi, lo) with an effective ~48-bit
mantissa (~1e-14 relative): enough to certify a 1e-8 residual with fp32
vector operations only.  Counterpart of ``raptor_tpu/utils/df64.py``.

These identities need strict fp32 semantics: every product and sum must be
rounded to fp32 before the next operation reads it.  Eager PyTorch runs one
kernel per operation and writes each result to memory, so every value is
rounded and ``_fence`` is an identity here.  It becomes load-bearing again
under ``torch.compile`` or inside any fused kernel: a fusing compiler may
contract ``x - a*b`` into ``fma(-a, b, x)``, which uses the UNROUNDED
product and voids Knuth's identity, and may rewrite ``(a + b) - a`` to
``b``, which zeroes the compensation (the reference package measured a
fused residual losing 7 digits to exactly these rewrites).  Whoever fuses
these functions must replace ``_fence`` with a real barrier, or compute the
product error as ``fmaf(a, b, -p)``, and test the result against NumPy fp64.

The Veltkamp split uses integer bitmasking (exact, branch-free): the fp32
bit pattern is viewed as int32 and masked with ``0xFFFFF000`` (``-4096`` as
int32, since torch's uint32 bitwise support is partial).
"""

from __future__ import annotations

import torch

__all__ = ["two_sum", "two_prod", "df_add", "df_add_single", "df_neg",
           "df_from", "df_to_f32"]

_HI_MASK = -4096  # 0xFFFFF000 as int32: sign + exponent + high 11 mantissa bits


def _fence(x: torch.Tensor) -> torch.Tensor:
    """Identity in eager mode (every op result is already rounded to fp32);
    see the module docstring for when it must become a real barrier."""
    return x


def two_sum(a, b):
    """Error-free sum: a + b = s + e exactly (Knuth)."""
    s = _fence(a + b)
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a: torch.Tensor):
    """Bitmask split: a = hi + lo, each with <= 12 significand bits, so all
    cross products in two_prod are exact in fp32."""
    hi = (a.contiguous().view(torch.int32) & _HI_MASK).view(torch.float32)
    lo = a - hi  # exact: same exponent, low 12 mantissa bits
    return hi, lo


def two_prod(a, b):
    """Error-free product: a * b = p + e exactly (Dekker)."""
    p = _fence(a * b)
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh,xl) + (yh,yl) -> normalized df64 pair."""
    sh, se = two_sum(xh, yh)
    te = se + (xl + yl)
    rh, rl = two_sum(sh, te)
    return rh, rl


def df_add_single(xh, xl, y):
    """(xh,xl) + fp32 y."""
    sh, se = two_sum(xh, y)
    rh, rl = two_sum(sh, se + xl)
    return rh, rl


def df_neg(xh, xl):
    return -xh, -xl


def df_from(x):
    return x, torch.zeros_like(x)


def df_to_f32(xh, xl):
    return xh + xl
