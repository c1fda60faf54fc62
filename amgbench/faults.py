"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  A run names none of them: ``run_cell(..., faults=...)``
takes them from a test.

* ``state_unchanged``: the solve returns its starting state, x = 0;
* ``answer_altered``: the solve's answer is changed where it is produced
  (one entry moved by a hundredth of the largest).
"""

from __future__ import annotations

import torch

KNOWN = ("state_unchanged", "answer_altered")


def check(names) -> tuple:
    bad = sorted(set(names) - set(KNOWN))
    if bad:
        raise ValueError(f"unknown faults {bad}; known: {KNOWN}")
    return tuple(names)


def _alter(t: torch.Tensor) -> torch.Tensor:
    t = t.clone()
    t[t.numel() // 3] += 1e-2 * float(t.abs().max()) + 1e-2
    return t


def wrap_solve(fn, names):
    """``fn`` (a solve returning (x, ...) or ((x_hi, x_lo), ...)) with the
    named faults planted in its answer."""
    if "state_unchanged" not in names and "answer_altered" not in names:
        return fn

    def broken(*a, **kw):
        out = fn(*a, **kw)
        x, rest = out[0], out[1:]
        pair = isinstance(x, tuple)
        xh = x[0] if pair else x
        if "state_unchanged" in names:
            xh = torch.zeros_like(xh)
            x = (xh, torch.zeros_like(xh)) if pair else xh
        else:
            x = (_alter(xh), x[1]) if pair else _alter(xh)
        return (x, *rest)

    return broken

