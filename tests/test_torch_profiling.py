"""The port's spans and its host-read counter (``utils/profiling.py``,
``solve/krylov.py``), on the CPU at small sizes.

* Off: ``phase`` is one shared no-op; it enters no ``record_function`` and
  builds no name.
* On, under ``torch.profiler``: a span's host event (``PREFIX`` + name)
  encloses the ATen ops run inside it; no span fences.
* On, no profiler: ``fence=True`` spans are host-clock spans; parents nest.
* The solve and set-up paths of both engines carry their spans.
* ``krylov.host_reads`` counts one read a PCG iteration and, in the
  refined solves, one a round for the iterations and one a round (and one
  more) for the residual test.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raptor_tpu_torch.api as api
import raptor_tpu_torch.structured.solver as ts
from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.solve import krylov
from raptor_tpu_torch.structured.dia import dia_from_stencil
from raptor_tpu_torch.utils import profiling
from raptor_tpu_torch.utils.profiling import (PREFIX, phase, recording,
                                              spanned)
from tests._torch_ref import shuffled_poisson, stencil_7pt

CHEB = dict(smoother="cheb4", cheb_degree=2)


def _never():
    raise AssertionError("a span's name was built with recording off")


def test_off_is_the_shared_noop(monkeypatch):
    def no_rf(*a, **k):
        raise AssertionError("record_function entered with recording off")

    monkeypatch.setattr(torch.profiler, "record_function", no_rf)
    assert not profiling.ON
    a, b = phase(_never), phase("x", (1, 2), fence=True)
    assert a is b
    with a:
        pass

    @spanned("f")
    def f(v):
        return v + 1

    with profile(activities=[ProfilerActivity.CPU]):
        with phase(_never, 3):
            assert f(1) == 2


def test_spans_enclose_their_aten_ops_under_the_profiler(monkeypatch):
    fences = []
    monkeypatch.setattr(profiling, "_fence", lambda: fences.append(1))
    with profile(activities=[ProfilerActivity.CPU]) as prof, recording() as rec:
        with phase("outer", fence=True):
            with phase(lambda: "inner", (3, torch.bfloat16)):
                torch.ones(64).mul_(2.0)
    assert fences == []  # no fence under a profiler
    assert [s.name for s in rec.spans] == ["outer", "inner[3,bfloat16]"]
    assert [s.parent for s in rec.spans] == [-1, 0]
    assert not rec.spans[0].fenced
    ev = {e.name: e for e in prof.events()}
    inner = ev[PREFIX + "inner[3,bfloat16]"]
    outer = ev[PREFIX + "outer"]
    mul = ev["aten::mul_"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert inner.time_range.start <= mul.time_range.start
    assert mul.time_range.end <= inner.time_range.end
    assert not profiling.ON  # restored


def test_fenced_spans_keep_the_host_clock_with_parents(monkeypatch):
    fences = []
    monkeypatch.setattr(profiling, "_fence", lambda: fences.append(1))
    with recording() as rec:
        with phase("setup.a", fence=True):
            with phase("setup.b"):
                pass
            with phase("setup.b"):
                with phase("setup.c", 0):
                    pass
        with phase("setup.d", fence=True):
            pass
    assert len(fences) == 4  # both edges of both fenced spans
    names = [s.name for s in rec.spans]
    assert names == ["setup.a", "setup.b", "setup.b", "setup.c[0]", "setup.d"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2, -1]
    assert [s.name for s in rec.roots()] == ["setup.a", "setup.d"]
    assert all(s.fenced == (s.parent < 0) for s in rec.spans)
    assert all(s.end_ns >= s.start_ns for s in rec.spans)
    assert rec.totals()["setup.b"][0] == 2


def _structured(n=8):
    A = dia_from_stencil(stencil_7pt(), (n, n, n), device="cpu")
    return ts.build_structured_hierarchy(
        A, AmgConfig(**CHEB, coarse_size=16, tail_max_n=64), dim_policy="size")


def _rhs(n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32))


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


@pytest.mark.parametrize("n", [8, 12])
def test_host_reads_of_the_structured_refined_solve(monkeypatch, n):
    h = _structured(n)
    rounds = _count_calls(monkeypatch, ts, "pcg")
    krylov.host_reads.clear()
    _, rel, it = ts.structured_solve_refined(h, _rhs(n ** 3), tol=1e-8)
    assert float(rel) <= 1e-8 and len(rounds) >= 1
    assert dict(krylov.host_reads) == {"pcg": int(it),
                                       "refine": 2 * len(rounds) + 1}


def test_host_reads_of_the_algebraic_refined_solve(monkeypatch):
    A = shuffled_poisson(10)
    h = api.setup(A, AmgConfig(**CHEB, fine_layout="banded"), device="cpu")
    inner = api.krylov_dispatch
    rounds = []

    def dispatch(*a, **k):
        fn = inner(*a, **k)

        def counted(*b, **kw):
            rounds.append(1)
            return fn(*b, **kw)
        return counted

    monkeypatch.setattr(api, "krylov_dispatch", dispatch)
    b = torch.zeros(h.levels[0].A.n_rows_pad)
    b[:A.shape[0]] = _rhs(A.shape[0])
    krylov.host_reads.clear()
    _, rel, it = api.solve_hier_refined(h, b, tol=1e-8)
    assert float(rel) <= 1e-8 and len(rounds) >= 1
    assert dict(krylov.host_reads) == {"pcg": int(it),
                                       "refine": 2 * len(rounds) + 1}


def test_other_krylov_reads_are_counted():
    h = _structured(8)
    b = _rhs(512)
    for name in ("bicgstab", "gmres"):
        krylov.host_reads.clear()
        _, info = ts.structured_solve(h, b, tol=1e-6, krylov=name)
        assert krylov.host_reads[name] >= int(info.iterations) > 0
        assert set(krylov.host_reads) == {name}


def _tree(rec) -> dict:
    """{name: set of parent names} of a recording."""
    out: dict = {}
    for s in rec.spans:
        parent = rec.spans[s.parent].name if s.parent >= 0 else None
        out.setdefault(s.name, set()).add(parent)
    return out


def test_structured_paths_carry_their_spans():
    A = dia_from_stencil(stencil_7pt(), (8, 8, 8), device="cpu")
    cfg = AmgConfig(**CHEB, coarse_size=16, tail_max_n=64)
    with recording() as rec:
        h = ts.build_structured_hierarchy(A, cfg, dim_policy="size")
        hM = ts.cast_hierarchy(h, torch.bfloat16)
        ts.structured_solve_refined(h, _rhs(512), tol=1e-8, M_hier=hM)
    t = _tree(rec)
    assert [s.name for s in rec.roots()] == ["setup.structured", "setup.cast",
                                              "solve"]
    assert all(s.fenced for s in rec.roots()[:2])
    assert t["setup.plan"] == t["setup.tail"] == {"setup.structured"}
    assert t["setup.rap[0]"] == t["setup.transfer[0]"] == {"setup.structured"}
    assert t["setup.coarse_inverse"] == {"setup.structured"}
    assert t["refine.residual"] == t["pcg"] == {"solve"}
    assert t["vcycle"] == {"pcg"}
    assert t["vcycle.smooth[0]"] == t["vcycle.restrict[0]"] == {"vcycle"}
    assert t["vcycle.coarse"] == {"vcycle"}  # the folded tail, one matvec
    assert "vcycle.smooth[1]" in t


def test_algebraic_paths_carry_their_spans():
    A = shuffled_poisson(16)
    cfg = AmgConfig(**CHEB, fine_layout="banded", host_setup_threshold=1024)
    with recording() as rec:
        h = api.setup(A, cfg, device="cpu")
        b = torch.zeros(h.levels[0].A.n_rows_pad)
        b[:A.shape[0]] = _rhs(A.shape[0])
        api.solve_hier_refined(h, b, tol=1e-8)
    t = _tree(rec)
    assert [s.name for s in rec.roots()] == ["setup.algebraic", "solve"]
    assert rec.roots()[0].fenced and not rec.roots()[1].fenced
    for name in ("setup.order", "setup.ell", "setup.layout", "setup.to_device",
                 "setup.tail"):
        assert "setup.algebraic" in t[name], name
    assert t["setup.level[0]"] == {"setup.algebraic"}
    for name in ("setup.strength", "setup.splitting", "setup.interp",
                 "setup.smoother", "setup.rap"):
        assert t[name] == {"setup.level[0]", "setup.level[1]"}, name
    assert t["setup.host_tail"] == {"setup.algebraic"}
    assert t["refine.residual"] == t["pcg"] == {"solve"}
    assert t["vcycle.smooth[0]"] == {"vcycle"}
    assert any(name.startswith("ell.spmv[") for name in t)
