"""The algebraic engine: a general CSR, made by the harness, through
``api.setup`` (fp32 operators) and ``api.solve_hier_refined`` on the card.
Each right-hand side is drawn in the caller's ordering, permuted into the
hierarchy's ordering on the card, and the answer permuted back there."""

from __future__ import annotations

import numpy as np
import torch

from amgbench import counts, faults
from amgbench.reference import shuffled as ref_shuffled


class Engine:
    def __init__(self, config: dict, stream, dev, faults_on=()):
        from raptor_tpu_torch import AmgConfig

        if stream.rebuild:
            raise ValueError("the algebraic engine takes no diagonal shift")
        self.config, self.stream, self.dev = config, stream, dev
        p = config["problem"]
        self.A = ref_shuffled.shuffled_poisson7(int(p["n"]), int(p["perm_seed"]))
        self.N = self.A.shape[0]
        self.amg = AmgConfig(**config["amg"])
        self.tol = float(config["tol"])
        self.faults = tuple(faults_on)
        self.h = None

    def setup(self) -> None:
        from raptor_tpu_torch import setup

        # setup may sort the column indices of the matrix it is given, so
        # the program gets a copy and the reference keeps the harness's
        self.h = setup(self.A.copy(), self.amg, device=self.dev)
        self.pm = torch.as_tensor(self.h.perm)[:self.N].to(self.dev).long()
        self.n_pad = self.h.levels[0].A.n_rows_pad

    def _to_hier(self, b):
        bd = torch.zeros(self.n_pad, dtype=b.dtype, device=self.dev)
        bd[:self.N] = b[self.pm]
        return bd

    def _to_caller(self, x):
        xc = torch.empty(self.N, dtype=x.dtype, device=self.dev)
        xc[self.pm] = x[:self.N]
        return xc

    def step(self, k: int) -> dict:
        from raptor_tpu_torch.api import solve_hier_refined

        b = self.stream.rhs(k, self.N, self.dev)
        bd = self._to_hier(b)
        solve = faults.wrap_solve(solve_hier_refined, self.faults)
        (xh, xl), rel, iters = solve(self.h, bd, tol=self.tol,
                                     b_lo=torch.zeros_like(bd))
        rel = float(rel)
        return {"iters": int(iters), "certified": rel, "build_s": None,
                "ok": bool(np.isfinite(rel) and rel <= self.tol),
                "sample": {"k": k, "x": (self._to_caller(xh),
                                         self._to_caller(xl))}}

    def vcycle(self):
        from raptor_tpu_torch.solve.cycle import cycle

        bd = self._to_hier(self.stream.rhs(0, self.N, self.dev))
        return lambda: cycle(self.h, bd)

    def counts(self) -> dict:
        h = self.h
        ts = h.tail_start if h.tail_op is not None else len(h.levels) - 1
        levels = []
        for k in range(ts):
            lv = h.levels[k]
            levels.append(counts.LevelCount(
                n=lv.n, nnz_a=_nnz_ell(lv.A), n_coarse=h.levels[k + 1].n,
                nnz_p=_nnz_ell(lv.P)))
        nt = h.levels[ts].n
        vb = torch.tensor([], dtype=getattr(torch, self.config[
            "preconditioner_dtype"])).element_size()
        cyc = counts.vcycle_bytes(levels, counts.LevelCount(n=nt, nnz_a=nt * nt),
                                  self.amg.cheb_degree, vb, vb)
        return {"vcycle_bytes": cyc, "levels": len(h.levels),
                "sizes": [lv.n for lv in h.levels]}

    def control(self, k: int) -> dict:
        """The program's fp32 path below the configuration's df64 solve:
        ``solve_hier`` (fp32 PCG, no refinement) to the same tol."""
        from raptor_tpu_torch.api import solve_hier

        bd = self._to_hier(self.stream.rhs(k, self.N, self.dev))
        x, _ = solve_hier(self.h, bd, tol=self.tol)
        x = self._to_caller(x)
        return {"k": k, "x": (x, torch.zeros_like(x))}

    def free(self) -> None:
        self.h = None

    def judge(self, sample: dict) -> float:
        """fp64 true relative residual with SciPy on the harness's CSR."""
        xh, xl = sample["x"]
        x64 = xh.double().cpu().numpy() + xl.double().cpu().numpy()
        b64 = self.stream.rhs(sample["k"], self.N, self.dev).double().cpu().numpy()
        return ref_shuffled.relres(self.A, x64, b64)


def _nnz_ell(m) -> int:
    """True entries of an ELL operator (its row counts, no padding)."""
    return int(m.row_nnz[:m.n_rows].sum())
