"""Threefry-2x32 counter-based random bits, as JAX draws them.

CLJP's H2 heuristic draws one random bit position per row each round with
``jax.random.randint(jax.random.fold_in(jax.random.PRNGKey(17), it), (n,),
0, 31, int32)`` in the reference.  This module reproduces those bits
exactly (JAX 0.9.0 with ``jax_threefry_partitionable`` on, its default):

* ``PRNGKey(seed)`` is the key pair ``(0, seed)``;
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` under ``key``;
* ``split(key)`` hashes the counters ``(0, 0)`` and ``(0, 1)``: the two
  outputs of counter i are subkey i;
* 32 random bits for element i hash the counter pair ``(0, i)`` and XOR
  the two output words;
* ``randint(key, (n,), lo, hi)`` splits the key, draws ``higher`` from the
  first subkey and ``lower`` from the second, and returns
  ``lo + ((higher % span) * m + lower % span) % span`` with ``span = hi -
  lo`` and ``m = (2^16 % span)^2 % span``.

The hash runs as int64 tensor ops masked to 32 bits after every add and
shift, so the bits are drawn on the tensor's device (on the card, with no
host copy) and never with torch's own generator.
"""

from __future__ import annotations

import torch

__all__ = ["prng_key", "threefry_2x32", "fold_in", "split", "random_bits",
           "randint", "cljp_bits"]

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _add(a, b):
    return (a + b) & _MASK


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry_2x32(key, x0, x1):
    """The 20-round Threefry-2x32 hash of the counter words ``(x0, x1)``
    under ``key = (k0, k1)``.  Words are int64 tensors (or Python ints)
    holding values in [0, 2^32); returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = _add(x0, ks[0]), _add(x1, ks[1])
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = _add(x0, x1)
            x1 = _rotl(x1, r) ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(_add(x1, ks[(i + 2) % 3]), i + 1)
    return x0, x1


def _scalar(v) -> int:
    return int(v) & _MASK


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return 0, _scalar(seed)


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry_2x32(tuple(_scalar(k) for k in key), 0, _scalar(data))
    return y0, y1


def split(key) -> tuple[tuple[int, int], tuple[int, int]]:
    """``jax.random.split(key)`` (two subkeys, the partitionable form)."""
    key = tuple(_scalar(k) for k in key)
    a = threefry_2x32(key, 0, 0)
    b = threefry_2x32(key, 0, 1)
    return a, b


def random_bits(key, n: int, *, device) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` as an int64 tensor of values
    in [0, 2^32) on ``device``."""
    cnt = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry_2x32(tuple(_scalar(k) for k in key),
                           torch.zeros_like(cnt), cnt)
    return y0 ^ y1


def randint(key, n: int, minval: int, maxval: int, *,
            device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), minval, maxval, int32)``."""
    span = max(int(maxval) - int(minval), 1)
    mult = (pow(2, 16, span) ** 2) % span
    k1, k2 = split(key)
    higher = random_bits(k1, n, device=device)
    lower = random_bits(k2, n, device=device)
    off = ((higher % span) * mult + lower % span) % span
    return (int(minval) + off).to(torch.int32)


def cljp_bits(it: int, n: int, *, device) -> torch.Tensor:
    """The reference CLJP round ``it``'s H2 bit positions, (n,) int32 in
    [0, 31)."""
    return randint(fold_in(prng_key(17), it), n, 0, 31, device=device)
