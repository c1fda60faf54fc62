"""The structured engine: a constant 3D stencil through
``build_structured_hierarchy`` -> ``cast_hierarchy`` ->
``structured_solve_refined``.  With a mix that shifts the diagonal, every
step makes its own operator and builds and casts its hierarchy before the
solve."""

from __future__ import annotations

import time

import numpy as np
import torch

from amgbench import counts, faults
from amgbench.reference import stencil as ref_stencil
from amgbench.trace import sync


def stencil_operator(stencil: np.ndarray, dims, dev, dtype=torch.float32):
    """The program's ``DiaMatrix`` of a constant stencil with Dirichlet
    truncation, its planes made on ``dev`` (equal to ``dia_from_stencil``,
    which makes them on the host)."""
    from raptor_tpu_torch.structured.dia import DiaMatrix

    dims = tuple(int(d) for d in dims)
    entries = ref_stencil.stencil_entries(stencil)
    data = torch.empty((len(entries), int(np.prod(dims))), dtype=dtype,
                       device=dev)
    consts = []
    for k, (off, v) in enumerate(entries):
        vr = torch.tensor(v, dtype=torch.float64).to(dtype)
        plane = data[k].view(dims)
        plane.fill_(vr.item())
        for ax, o in enumerate(off):
            idx = [slice(None)] * len(dims)
            if o > 0:
                idx[ax] = slice(dims[ax] - o, None)
                plane[tuple(idx)] = 0
            elif o < 0:
                idx[ax] = slice(None, -o)
                plane[tuple(idx)] = 0
        consts.append(float(vr))
    return DiaMatrix(data=data, offsets=tuple(off for off, _ in entries),
                     dims=dims, const_planes=tuple(consts))


def _nnz_dia(m) -> int:
    """Non-zeros of a DIA operator: its planes are zero wherever the
    neighbour leaves the grid, and the embedded Pt holds P's entries only
    (identity at coarse points, the interpolation weights at fine ones)."""
    return int((m.data != 0).sum())


class Engine:
    def __init__(self, config: dict, stream, dev, faults_on=()):
        from raptor_tpu_torch import AmgConfig

        self.config, self.stream, self.dev = config, stream, dev
        p = config["problem"]
        self.dims = (int(p["n"]),) * 3
        self.N = int(np.prod(self.dims))
        self.amg = AmgConfig(**config["amg"])
        self.tol = float(config["tol"])
        self.pdtype = getattr(torch, config["preconditioner_dtype"])
        self.faults = tuple(faults_on)
        self.h = self.hM = None
        self.sigma = None

    # -- the program --------------------------------------------------
    def _build(self, sigma: float) -> None:
        from raptor_tpu_torch import build_structured_hierarchy, cast_hierarchy

        self.h = self.hM = None  # free the last step's hierarchy first
        A = stencil_operator(ref_stencil.poisson7(sigma), self.dims, self.dev)
        self.h = build_structured_hierarchy(A, self.amg,
                                            dim_policy=self.config["dim_policy"])
        self.hM = cast_hierarchy(self.h, self.pdtype)
        self.sigma = sigma

    def _solve(self, b):
        from raptor_tpu_torch import structured_solve_refined

        return faults.wrap_solve(structured_solve_refined, self.faults)(
            self.h, b, tol=self.tol, M_hier=self.hM)

    def setup(self) -> None:
        self._build(self.stream.shift(0) if self.stream.rebuild else 0.0)

    def step(self, k: int) -> dict:
        """Step k of the window: (rebuild,) solve; the answer as the
        sample the reference may judge."""
        build_s = None
        if self.stream.rebuild:
            sync(self.dev)
            t0 = time.perf_counter()
            self._build(self.stream.shift(k))
            sync(self.dev)
            build_s = time.perf_counter() - t0
        b = self.stream.rhs(k, self.N, self.dev)
        (xh, xl), rel, iters = self._solve(b)
        rel = float(rel)
        return {"iters": int(iters), "certified": rel, "build_s": build_s,
                "ok": bool(np.isfinite(rel) and rel <= self.tol),
                "sample": {"k": k, "sigma": self.sigma, "x": (xh, xl)}}

    def vcycle(self):
        """One preconditioner application on a fixed right-hand side."""
        from raptor_tpu_torch import scycle

        b = self.stream.rhs(0, self.N, self.dev)
        return lambda: scycle(self.hM, b)

    def counts(self) -> dict:
        """The V-cycle's least bytes from the levels' sizes and non-zeros."""
        h = self.h
        ts = h.tail_start if h.tail_op is not None else len(h.levels) - 1
        levels = []
        for k in range(ts):
            lv = h.levels[k]
            nc = h.levels[k + 1].A.n
            levels.append(counts.LevelCount(
                n=lv.A.n, nnz_a=_nnz_dia(lv.A), n_coarse=nc,
                nnz_p=_nnz_dia(lv.Pt), const_a=lv.A.const_planes is not None))
        nt = h.levels[ts].A.n
        vb = torch.tensor([], dtype=self.pdtype).element_size()
        cyc = counts.vcycle_bytes(levels, counts.LevelCount(n=nt, nnz_a=nt * nt),
                                  self.amg.cheb_degree, vb, vb)
        return {"vcycle_bytes": cyc, "levels": len(h.levels),
                "sizes": [lv.A.n for lv in h.levels]}

    def control(self, k: int) -> dict:
        """The program's fp32 path below the configuration's df64 solve:
        ``structured_solve`` (fp32 PCG, no refinement) to the same tol."""
        from raptor_tpu_torch import structured_solve

        if self.stream.rebuild:
            self._build(self.stream.shift(k))
        b = self.stream.rhs(k, self.N, self.dev)
        x, _ = structured_solve(self.h, b, tol=self.tol, M_hier=self.hM)
        return {"k": k, "sigma": self.sigma, "x": (x, torch.zeros_like(x))}

    def free(self) -> None:
        self.h = self.hM = None

    # -- the reference ------------------------------------------------
    def judge(self, sample: dict) -> float:
        """fp64 true relative residual of the sample's answer against the
        matrix-free stencil of its step, b drawn again from the seed."""
        xh, xl = sample["x"]
        x64 = xh.double() + xl.double()
        b64 = self.stream.rhs(sample["k"], self.N, self.dev).double()
        return ref_stencil.relres(ref_stencil.poisson7(sample["sigma"]), x64,
                                  b64, self.dims)

