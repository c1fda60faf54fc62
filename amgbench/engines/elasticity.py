"""The elasticity engine: Q1 linear elasticity, assembled by the harness
(``amgbench/reference/elasticity.py``) with its six rigid-body modes,
through ``api.setup`` (smoothed aggregation on the card, BlockELL levels)
and ``api.solve_hier_refined``.  Each right-hand side is a load vector on
the free dofs, drawn on the card; the answer is judged by the
element-by-element fp64 residual."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from amgbench import counts, counts_block, faults
from amgbench.reference import elasticity as ref_el
from amgbench.trace import sync

# W-cycles profiled with the program's spans for the level-0 block
# applies' device time (``counts``)
BELL_CYCLES = 5


class Engine:
    def __init__(self, config: dict, stream, dev, faults_on=()):
        from raptor_tpu_torch import AmgConfig

        if stream.rebuild:
            raise ValueError("the elasticity engine takes no diagonal shift")
        p = config["problem"]
        if p.get("clamp", "x0") != "x0":
            raise ValueError(f"clamp {p['clamp']!r}: only the x = 0 face")
        self.config, self.stream, self.dev = config, stream, dev
        self.n, self.E, self.nu = int(p["n"]), float(p["E"]), float(p["nu"])
        self.A, self.B = ref_el.assemble(self.n, self.E, self.nu)
        self.N = self.A.shape[0]
        self.amg = AmgConfig(**config["amg"])
        self.tol = float(config["tol"])
        self.faults = tuple(faults_on)
        self.h = self.rec = None

    def setup(self) -> None:
        from raptor_tpu_torch import setup
        from raptor_tpu_torch.utils import profiling

        # the set-up's spans are kept; an enclosing recording
        # (amgbench.spans) keeps them itself
        with (contextlib.nullcontext() if profiling.ON
              else profiling.recording()) as rec:
            # setup may sort the column indices of the matrix it is given
            self.h = setup(self.A.copy(), self.amg, B=self.B, device=self.dev)
        self.rec = rec
        self.A = None  # the reference needs no assembled matrix
        if self.h.levels[0].Abell is None:
            raise RuntimeError("level 0 has no BlockELL layout")
        self.n_pad = self.h.levels[0].A.n_rows_pad

    def _pad(self, b):
        bd = torch.zeros(self.n_pad, dtype=b.dtype, device=self.dev)
        bd[:self.N] = b
        return bd

    def step(self, k: int) -> dict:
        from raptor_tpu_torch.api import solve_hier_refined

        bd = self._pad(self.stream.rhs(k, self.N, self.dev))
        solve = faults.wrap_solve(solve_hier_refined, self.faults)
        (xh, xl), rel, iters = solve(self.h, bd, tol=self.tol,
                                     b_lo=torch.zeros_like(bd))
        rel = float(rel)
        return {"iters": int(iters), "certified": rel, "build_s": None,
                "ok": bool(np.isfinite(rel) and rel <= self.tol),
                "sample": {"k": k, "x": (xh[:self.N], xl[:self.N])}}

    def vcycle(self):
        """One preconditioner application of the configured kind (a
        W-cycle) on a fixed right-hand side."""
        from raptor_tpu_torch.solve.cycle import cycle

        bd = self._pad(self.stream.rhs(0, self.N, self.dev))
        return lambda: cycle(self.h, bd)

    def _levels(self):
        """(BlockLevel counts of levels 0 .. ts, the tail's rows, whether
        the W-cycle visits the tail twice)."""
        h = self.h
        ts = h.tail_start if h.tail_op is not None else len(h.levels) - 1
        out = []
        for k in range(ts + 1):
            lv = h.levels[k]
            nxt = h.levels[k + 1].n if k < ts else 0
            if lv.Abell is not None:
                bs = lv.Abell.bs
                nnz_a = _blocks(lv.Abell, lv.n) * bs * bs
            else:
                bs, nnz_a = 0, _nnz_ell(lv.A)
            out.append(counts_block.BlockLevel(
                n=lv.n, nnz_a=nnz_a, n_coarse=nxt,
                nnz_p=_nnz_ell(lv.P) if k < ts else 0, inv_block=bs))
        return out, h.levels[ts].n, ts < len(h.levels) - 1

    def counts(self) -> dict:
        """The cycle's least bytes; the level-0 block applies' least bytes
        and device self time over ``BELL_CYCLES`` cycles under the
        program's spans; the set-up's fenced root and stages."""
        levels, tail_n, revisit = self._levels()
        vb = torch.tensor([], dtype=getattr(
            torch, self.config["preconditioner_dtype"])).element_size()
        cyc = counts_block.cycle_bytes(levels, tail_n, self.amg.cheb_degree,
                                       self.amg.cycle, revisit, vb, vb)
        out = {"vcycle_bytes": cyc, "levels": len(self.h.levels),
               "sizes": [lv.n for lv in self.h.levels],
               "bell0": self._bell0(levels[0], vb)}
        if self.rec is not None:
            roots = [s for s in self.rec.roots() if s.fenced]
            out["setup_root_s"] = sum(s.seconds for s in roots) or None
            out["setup_stages"] = {k: t for k, (_, t) in
                                   self.rec.totals().items()}
        return out

    def _bell0(self, lv0, value_bytes: int) -> dict:
        """Level 0's ``bell.spmv`` spans over profiled cycles: calls, their
        least bytes (block values, x in, y out) and device self time."""
        from amgbench import spans
        from raptor_tpu_torch.utils import profiling

        A = self.h.levels[0].Abell
        label = (f"bell.spmv[{A.nb_pad},{A.K},{A.bs},"
                 f"{str(A.data.dtype).removeprefix('torch.')}]")
        cyc = self.vcycle()
        cyc()
        sync(self.dev)
        with profiling.recording():
            p = spans.profile(lambda: [cyc() for _ in range(BELL_CYCLES)],
                              self.dev)
        calls = sum(1 for s in p.spans if s[0] == label)
        self_s = sum(s for s, c in p.launched() if c and c[-1] == label)
        per_call = counts.apply_bytes(lv0.nnz_a, lv0.n, lv0.n, value_bytes, 4)
        return {"label": label, "calls": calls, "bytes": calls * per_call,
                "self_s": self_s}

    def control(self, k: int) -> dict:
        """The program's fp32 path below the configuration's df64 solve:
        ``solve_hier`` (fp32 PCG, no refinement) to the same tol."""
        from raptor_tpu_torch.api import solve_hier

        x, _ = solve_hier(self.h, self._pad(self.stream.rhs(k, self.N, self.dev)),
                          tol=self.tol)
        x = x[:self.N]
        return {"k": k, "x": (x, torch.zeros_like(x))}

    def free(self) -> None:
        self.h = None

    def judge(self, sample: dict) -> float:
        """fp64 true relative residual, element by element on the card,
        b drawn again from the seed."""
        xh, xl = sample["x"]
        x64 = xh.double() + xl.double()
        b64 = self.stream.rhs(sample["k"], self.N, self.dev).double()
        return ref_el.relres(x64, b64, self.n, self.E, self.nu)


def _nnz_ell(m) -> int:
    """True entries of an ELL operator (its row counts, no padding)."""
    return int(m.row_nnz[:m.n_rows].sum())


def _blocks(A, n: int) -> int:
    """Blocks of a BlockELL operator's real block rows (no padding)."""
    return int(A.row_nnz[:n // A.bs].sum())
