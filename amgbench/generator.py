"""The one traffic generator: every mix is a closed loop with one solve in
flight, and its data file (``traffic/<mix>.json``) gives the parameters:

* ``rhs``: ``{"low": a, "high": b}``, each right-hand side uniform in
  [a, b) in fp32, drawn on the device from (seed, step): every step
  solves a vector no other step of the run has solved;
* ``diag_shift``: null, or ``{"low": a, "high": b}``: step k's operator
  adds sigma_k, uniform in [a, b] from (seed, step), to the diagonal and
  the step builds its hierarchy anew.

A right-hand side depends on the seed, the step and the length only, so
every rank of a sharded run draws the same global vector and keeps its
slab, and the stream is the same for any rank count.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

WARM = -1  # the step index of the warm-up solve, outside the window's stream


def step_seed(seed: int, step: int, what: str = "rhs") -> int:
    """A 63-bit seed for (seed, step, what)."""
    h = hashlib.sha256(f"{int(seed)}:{int(step)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)


class Stream:
    """The inputs of one run: step k's right-hand side and shift."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.seed = mix, int(seed)
        rhs = mix["rhs"]
        self.low, self.high = float(rhs["low"]), float(rhs["high"])
        if not self.low < self.high:
            raise ValueError(f"mix {mix.get('name')}: rhs low >= high")
        sh = mix.get("diag_shift")
        self.rebuild = sh is not None
        self.shift_range = None if sh is None else (float(sh["low"]),
                                                    float(sh["high"]))

    def rhs(self, step: int, n: int, device) -> torch.Tensor:
        """(n,) fp32 right-hand side of ``step`` on ``device``."""
        g = torch.Generator(device=device)
        g.manual_seed(step_seed(self.seed, step))
        b = torch.rand(n, generator=g, device=device, dtype=torch.float32)
        return b.mul_(self.high - self.low).add_(self.low)

    def shift(self, step: int) -> float:
        """sigma of ``step`` (0.0 for a mix without a diagonal shift),
        rounded to fp32 so that the operator holds it exactly."""
        if self.shift_range is None:
            return 0.0
        rng = np.random.default_rng(step_seed(self.seed, step, "shift"))
        return float(np.float32(rng.uniform(*self.shift_range)))


class Reservoir:
    """A uniform sample of at most ``size`` of a window's results, drawn
    from the seed (reservoir sampling), whatever the window's length."""

    def __init__(self, size: int, seed: int):
        self.size = int(size)
        self.rng = np.random.default_rng(step_seed(seed, 0, "sample"))
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
            return
        j = int(self.rng.integers(self.seen))
        if j < self.size:
            self.items[j] = item
