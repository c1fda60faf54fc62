#!/usr/bin/env python3
"""Where the seconds of the sharded smoothed-aggregation setup go.

    python3 scripts/profile_dist_sa_setup.py [--n 48]

Builds elasticity_3d(n) with config 4's preset (fp32, tail 4096) by
``dist_build_sa_hierarchy`` on a ring of one (gloo, this process) on the
first CUDA device, twice (the first builds are cold), and times, with a
device synchronize on both sides of each call, the stages of
``parallel/dist_sa.py``: the host decision pass, the numbering and member
tables, the widened plans, the tentative QR, prolongator smoothing (and in
it lambda_max and the block smoother data), the RAP's widths, products and
coarse rows, the structure gathers and the tail.  Stages nest: a stage's
seconds include those of the stages it calls.  Then the single-device
device SA route (``api.setup``) on the same input for comparison.  Prints
the card's name and power limit, one line a stage and the totals.  Needs
a GPU.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

DIST_SA = "raptor_tpu_torch.parallel.dist_sa"
STAGES = {
    DIST_SA: ("_host_aggregate", "_coarse_numbering", "_member_table",
              "plan_and_remap", "_ghost_sets", "_member_ext", "_run_qr",
              "_run_smooth", "_dist_lmax", "_block_smoother", "_ext2glob",
              "_gather_structure", "_widen_rap_plan", "_run_widths",
              "_run_rap", "_run_ac", "_make_dist"),
    # the tail (imported where it is called)
    "raptor_tpu_torch.setup.aggregation": ("build_sa_hierarchy",),
}


def instrument(seconds: dict, calls: collections.Counter) -> None:
    """Wrap every stage, in the namespace its caller reads it from, so that
    it adds its synchronized wall time."""
    for modname, names in STAGES.items():
        mod = importlib.import_module(modname)
        for name in names:
            _wrap(mod, name, seconds, calls)


def _wrap(mod, name: str, seconds: dict, calls: collections.Counter) -> None:
    fn = getattr(mod, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds[name] += time.perf_counter() - t0
        calls[name] += 1
        return out

    setattr(mod, name, timed)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    import torch.distributed as dist

    from raptor_tpu_torch import PRESETS, setup
    from raptor_tpu_torch.gallery import elasticity_3d
    from raptor_tpu_torch.parallel import Ring
    from raptor_tpu_torch.parallel import dist_sa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    A, B, _ = elasticity_3d(args.n)
    cfg = PRESETS["config4"]
    seconds, calls = collections.defaultdict(float), collections.Counter()
    instrument(seconds, calls)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        ring = Ring()
        for run in ("cold", "warm"):
            seconds.clear()
            calls.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            dh = dist_sa.dist_build_sa_hierarchy(A, cfg, ring, B, 4096,
                                                 torch.float32, device=dev)
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            print(f"[{run}] dist_build_sa_hierarchy of elasticity_3d({args.n}) "
                  f"({A.shape[0]} rows): {total:.3f} s, peak "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, "
                  f"sharded sizes {[lv.n for lv in dh.levels]}, tail "
                  f"{[lv.n for lv in dh.tail.levels]}")
            for name in sorted(seconds, key=seconds.get, reverse=True):
                print(f"[{run}] {name}: {seconds[name]:.3f} s in {calls[name]} "
                      f"calls")
            del dh
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = setup(A, cfg, B=B, device=dev)
    torch.cuda.synchronize()
    print(f"single-device device SA (api.setup): {time.perf_counter() - t0:.3f} "
          f"s, sizes {[lv.n for lv in h.levels]}")


if __name__ == "__main__":
    main()
