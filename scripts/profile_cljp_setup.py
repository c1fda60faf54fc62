#!/usr/bin/env python3
"""Where the seconds of a CLJP setup on the card go.

    python3 scripts/profile_cljp_setup.py [--n 96]

Builds shuffled n^3 Poisson with CLJP (direct interpolation, the banded
layout, cheb4 degree 2: chip_smoke.py's phase 23) through api.setup on the
first CUDA device and times, with a device synchronize on both sides of
each call, the setup's stages: every device level (``_fused_level``) and
inside it the splitting, the Galerkin products and their merges; the
layout plans (``banded_from_ell``, its RCM retry, ``banded_plan``, the
transfers' plans); the folded tail.  Prints one line a level and the
totals by function, largest first.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

STAGES = {
    "raptor_tpu_torch.setup.hierarchy": ("_fused_level", "_level_phase2"),
    "raptor_tpu_torch.setup.cljp": ("cljp_splitting",),
    "raptor_tpu_torch.ops.sparse_ops": (
        "_spgemm_fixed_full", "spgemm_fixed", "ell_transpose_fixed",
        "_merge_sorted_rows", "_sort_merge", "_sum_runs_by_passes"),
    "raptor_tpu_torch.core.hybrid": (
        "banded_from_ell", "_banded_from_ell_rcm", "rect_banded_from_ell"),
    "raptor_tpu_torch.ops.banded_plan": (
        "banded_plan", "banded_plan_split", "banded_plan_rect_split"),
    "raptor_tpu_torch.api": ("materialize_tail", "attach_residual_lo",
                             "build_hierarchy"),
}


def shuffled_poisson(nx: int) -> sp.csr_matrix:
    from raptor_tpu_torch.gallery import poisson_3d

    A = sp.csr_matrix(poisson_3d(nx))
    p = np.random.default_rng(0).permutation(A.shape[0])
    return A[p][:, p].tocsr()


def instrument(seconds: dict, calls: collections.Counter) -> None:
    """Wrap every stage so that it adds its synchronized wall time."""
    for modname, names in STAGES.items():
        mod = importlib.import_module(modname)
        for name in names:
            fn = getattr(mod, name)

            def timed(*args, _fn=fn, _name=name, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*args, **kwargs)
                torch.cuda.synchronize()
                seconds[_name] += time.perf_counter() - t0
                calls[_name] += 1
                return out

            setattr(mod, name, timed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=96)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    from raptor_tpu_torch import AmgConfig, setup

    dev = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0))
    seconds, calls = collections.defaultdict(float), collections.Counter()
    instrument(seconds, calls)
    hier = importlib.import_module("raptor_tpu_torch.setup.hierarchy")
    level = hier._fused_level

    def per_level(A, n, config, seed, perm=None):
        t0 = time.perf_counter()
        out = level(A, n, config, seed, perm=perm)
        print(f"level n={n} K={A.K}: {time.perf_counter() - t0:.2f} s")
        return out

    hier._fused_level = per_level
    cfg = AmgConfig(splitting="cljp", interp="direct", fine_layout="banded",
                    smoother="cheb4", cheb_degree=2)
    A = shuffled_poisson(args.n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = setup(A, cfg, device=dev)
    torch.cuda.synchronize()
    print(f"api.setup {time.perf_counter() - t0:.2f} s, sizes "
          f"{[lv.n for lv in h.levels]}")
    for name in sorted(seconds, key=seconds.get, reverse=True):
        print(f"{name}: {seconds[name]:.2f} s in {calls[name]} calls")


if __name__ == "__main__":
    main()
