"""The traffic generator: a seed gives one stream, whatever the rank count."""

import numpy as np
import pytest
import torch

from amgbench import spec
from amgbench.generator import Reservoir, Stream, step_seed

BIG = 2**31 + 12345


@pytest.mark.parametrize("mix", ["rhs-stream", "shift-steps"])
def test_stream_repeats_for_a_seed(mix):
    a, b = Stream(spec.load_mix(mix), BIG), Stream(spec.load_mix(mix), BIG)
    for k in (0, 1, 7):
        assert torch.equal(a.rhs(k, 1000, "cpu"), b.rhs(k, 1000, "cpu"))
        assert a.shift(k) == b.shift(k)
    assert not torch.equal(a.rhs(0, 1000, "cpu"), a.rhs(1, 1000, "cpu"))
    c = Stream(spec.load_mix(mix), BIG + 1)
    differs = [not torch.equal(a.rhs(k, 1000, "cpu"), c.rhs(k, 1000, "cpu"))
               for k in range(8)]
    assert any(differs)


def test_every_step_solves_a_fresh_vector():
    """rhs-stream: no two steps of a run, and no two seeds at one step,
    draw the same right-hand side."""
    mix = spec.load_mix("rhs-stream")
    assert set(mix["rhs"]) == {"low", "high"}
    a, b = Stream(mix, BIG), Stream(mix, 3)
    va = [a.rhs(k, 64, "cpu") for k in range(-1, 16)]
    assert all(not torch.equal(va[i], va[j])
               for i in range(len(va)) for j in range(i))
    assert all(not torch.equal(a.rhs(k, 64, "cpu"), b.rhs(k, 64, "cpu"))
               for k in range(-1, 16))


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_slabs_make_the_global_stream(ranks):
    """Every rank draws the same global vector and keeps its slab, so the
    slabs of any rank count make one stream."""
    s = Stream(spec.load_mix("rhs-stream"), BIG)
    n = 16 ** 3
    nl = n // ranks
    slabs = [Stream(spec.load_mix("rhs-stream"), BIG).rhs(3, n, "cpu")[r * nl:(r + 1) * nl]
             for r in range(ranks)]
    assert torch.equal(torch.cat(slabs), s.rhs(3, n, "cpu"))


def test_values_in_range():
    s = Stream(spec.load_mix("shift-steps"), BIG)
    b = s.rhs(0, 100000, "cpu")
    assert b.dtype == torch.float32
    assert float(b.min()) >= -1.0 and float(b.max()) < 1.0
    sig = [s.shift(k) for k in range(200)]
    assert min(sig) >= 0.0 and max(sig) <= 0.06
    assert all(np.float32(x) == x for x in sig)
    assert Stream(spec.load_mix("rhs-stream"), BIG).shift(5) == 0.0


def test_step_seed_takes_large_and_negative_seeds():
    for seed in (0, BIG, 2**40, -7):
        assert 0 <= step_seed(seed, 3) < 2**63


def test_reservoir_is_a_seeded_uniform_sample():
    picks = []
    for seed in range(400):
        r = Reservoir(2, seed)
        for i in range(10):
            r.offer(i)
        picks += r.items
        assert len(r.items) == 2 and len(set(r.items)) == 2
    counts = np.bincount(picks, minlength=10)
    assert counts.min() > 50  # 80 expected for each of the ten
    a, b = Reservoir(3, 9), Reservoir(3, 9)
    for i in range(50):
        a.offer(i)
        b.offer(i)
    assert a.items == b.items
