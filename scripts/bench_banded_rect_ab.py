#!/usr/bin/env python3
"""Old against new: the rectangular banded transfer K6 (both forms) and the
df64 residual K5 of ``csrc/banded_kernel.cu`` against an earlier version of
that source, in turns, on one NVIDIA GPU.

    python3 scripts/bench_banded_rect_ab.py --old OLD_banded_kernel.cu \\
        [--out FILE] [--reps N]

``--old`` is a copy of the earlier ``banded_kernel.cu`` whose K6 and K5 take
a slot list and no launch plan (``raptor_banded_rect_*(vals, pidx, x, y, n,
K, tile, x_len, map_cols, WpP, slots, n_live, stream)``,
``raptor_banded_df64_f32(vals, vals_lo, pidx, xh, bh, bl, v, rh, rl, n, K,
tile, Wp, slots, n_live, stream)``) and whose K4 takes this package's live
mask and launch plan (e.g. commit e40bb06's: ``git show
e40bb06:raptor_tpu_torch/csrc/banded_kernel.cu`` into a directory that
``.gitignore`` lists, such as ``build/``).  nvcc builds it into a library of
its own under ``build/``.  ``--variant FILE.cu`` (repeatable) times another
version of ``banded_kernel.cu`` with this package's C interface of K6 in
turns with this one at every K6 shape.

At each shape the script checks every kernel against the plain PyTorch
version (bit for bit, ``torch.equal``) and times them by CUDA-graph replay
(``chip_smoke.cuda_ms``), L2-warm and then L2-cold (256 MB written between
replays).  L2-warm, one graph holds ``inner`` calls back to back (up to 50,
fewer as the call's bytes grow past 1 MB), so that a short kernel is not
timed as the graph's launch; the time is per call.  The order is old,
staged, direct, direct, staged, old: staged and direct are the new kernel's
two variants, forced; ``picked`` names the one ``banded_launch_plan`` takes
by itself.

* K6 (and its other layouts: rows 1 or 32 apart, one row a thread) at
  every P and R of the shuffled 48^3 and 96^3 hierarchies (built on
  the host by ``raptor_tpu_torch.api.setup`` as ``chip_smoke.py`` builds
  them), and in its map_cols form at rank 0's six P and R blocks of the
  four-rank 96^3 hierarchy (``chip_smoke.sharded_cases``, phase 14);
* K5 at level 0 of the 48^3 hierarchy, without and with the pi-scaled
  operator's ``vals_lo``, and of the 96^3 one;
* K4, old against new by the default launch plan, at the 48^3 levels and
  96^3 level 0: K4's source is unchanged in function, and this shows it.

For the 48^3 and 96^3 paths the script also runs one refined solve and
counts its launches by shape, and prints the sum over the path's shapes of
launches x (L2-warm time - bound), old and new.  Each shape prints one JSON
line (also written to ``--out``): times in ms, the bound (bytes over 3.35
TB/s, or fp32 operations over 67 TFLOP/s where more), and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from bench_banded_const_ab import _pair, _turns  # noqa: E402
from bench_dia_tiles_ab import _library  # noqa: E402
from chip_smoke import (ADIST_RANKS, ALG_CFG, K5_OPS_PER_ENTRY,  # noqa: E402
                        bound, setup_four_rank_hierarchy, sharded_cases,
                        shuffled_poisson)

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


def build_old(src: Path) -> ctypes.CDLL:
    old = _library(src, "old_rect")
    for name in ("raptor_banded_rect_f32", "raptor_banded_rect_bf16"):
        getattr(old, name).argtypes = [P, P, P, P, I64, I32, I32, I64, I64, I32,
                                       P, I32, P]
    old.raptor_banded_df64_f32.argtypes = [P] * 9 + [I64, I32, I32, I32, P,
                                                     I32, P]
    for name in ("raptor_banded_f32", "raptor_banded_bf16"):
        getattr(old, name).argtypes = [P, P, P, P, I64, I32, I32, I32, I64, I64,
                                       P, I32, I32, I32, I32, I32, P]
    return old


def build_variant(src: Path) -> ctypes.CDLL:
    """Another version of banded_kernel.cu with this package's C interface
    of K6."""
    var = _library(src, "variant_rect")
    for name in ("raptor_banded_rect_f32", "raptor_banded_rect_bf16"):
        getattr(var, name).argtypes = [P, P, P, P, I64, I32, I32, I64, I64, I32,
                                       I32, P, I32, I32, I32, I32, I32, I32, P]
    return var


def variant_k6(var, plan, x, launch, map_cols=None):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    fn = (var.raptor_banded_rect_bf16 if plan["vals"].dtype == torch.bfloat16
          else var.raptor_banded_rect_f32)
    y = torch.empty(plan["n"], dtype=x.dtype, device=x.device)
    rc = fn(plan["vals"].data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
            y.data_ptr(), plan["n"], plan["K"], plan["tile"], x.shape[0],
            plan["n_cols"] if map_cols is None else map_cols, plan["WpP"],
            plan["npage"], bk._live_mask(live), len(live), int(launch.staged),
            int(launch.stride == 32), launch.threads, launch.page0,
            launch.pages, _stream())
    if rc:
        raise RuntimeError(f"variant K6 launch failed: cudaError {rc}")
    return y


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_k6(old, plan, x, map_cols=None):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    fn = (old.raptor_banded_rect_bf16 if plan["vals"].dtype == torch.bfloat16
          else old.raptor_banded_rect_f32)
    y = torch.empty(plan["n"], dtype=x.dtype, device=x.device)
    rc = fn(plan["vals"].data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
            y.data_ptr(), plan["n"], plan["K"], plan["tile"], x.shape[0],
            plan["n_cols"] if map_cols is None else map_cols, plan["WpP"],
            bk._slots(live), len(live), _stream())
    if rc:
        raise RuntimeError(f"old K6 launch failed: cudaError {rc}")
    return y


def old_k5(old, plan, lo, xh, bh, bl, v):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    rc = old.raptor_banded_df64_f32(
        plan["vals"].data_ptr(), None if lo is None else lo.data_ptr(),
        plan["pidx"].data_ptr(), xh.data_ptr(), bh.data_ptr(), bl.data_ptr(),
        v.data_ptr(), rh.data_ptr(), rl.data_ptr(), plan["n"], plan["K"],
        plan["tile"], plan["Wp"], bk._slots(live), len(live), _stream())
    if rc:
        raise RuntimeError(f"old K5 launch failed: cudaError {rc}")
    return rh, rl


def old_k4(old, plan, x, launch):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    fn = (old.raptor_banded_bf16 if plan["vals"].dtype == torch.bfloat16
          else old.raptor_banded_f32)
    y = torch.empty_like(x)
    rc = fn(plan["vals"].data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
            y.data_ptr(), plan["n"], plan["K"], plan["tile"], plan["Wp"], 0,
            plan["n"], bk._live_mask(live), len(live), int(launch.staged),
            launch.threads, launch.page0, launch.pages, _stream())
    if rc:
        raise RuntimeError(f"old K4 launch failed: cudaError {rc}")
    return y


def _same(a, b) -> bool:
    if isinstance(a, tuple):
        return all(bool(torch.equal(p, q)) for p, q in zip(a, b))
    return bool(torch.equal(a, b))


def _record(kernel, label, plan, fo, fs, fd, ref, nbytes, ops, reps, n_sm,
            extra=None):
    """Check old, staged and direct against ``ref`` and time them in
    turns; one record."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    equal = all(_same(f(), ref) for f in (fo, fs, fd))
    inner, warm, cold = _turns((fo, fs, fd, fd, fs, fo), nbytes, reps)
    picked = bk.banded_launch_plan(plan, n_sm)
    staged = bk.banded_launch_plan(plan, n_sm, staged=True)
    bms, by = bound(nbytes, ops)
    rec = {"kernel": kernel, "shape": label, "n": plan["n"], "K": plan["K"],
           "live": len(bk.live_slots(plan)), "npage": bk._window_pages(plan),
           "dtype": str(plan["vals"].dtype).removeprefix("torch."),
           "inner": inner, "equal": equal,
           "picked": "staged" if picked.staged else "direct",
           "threads": picked.threads, "pages": staged.pages,
           "smem_bytes": staged.smem_bytes,
           "old_ms": warm[0::5], "staged_ms": warm[1::3], "direct_ms": warm[2:4],
           "old_cold_ms": cold[0::5], "staged_cold_ms": cold[1::3],
           "direct_cold_ms": cold[2:4], "bound_ms": bms, "bound_by": by,
           "bytes": nbytes, **(extra or {})}
    new = rec["staged_ms"] if picked.staged else rec["direct_ms"]
    rec["new_ms"] = new
    print(f"{kernel} {label} n={plan['n']} K={plan['K']} live {rec['live']} "
          f"{rec['dtype']} threads {picked.threads} pages {staged.pages} of "
          f"{rec['npage']}: warm old {_pair(rec['old_ms']):.2f} staged "
          f"{_pair(rec['staged_ms']):.2f} direct {_pair(rec['direct_ms']):.2f} "
          f"us; cold old {_pair(rec['old_cold_ms']):.2f} staged "
          f"{_pair(rec['staged_cold_ms']):.2f} direct "
          f"{_pair(rec['direct_cold_ms']):.2f} us; bound {bms * 1e3:.2f} us "
          f"({by}), picked {rec['picked']} ({bms / np.mean(new) * 100:.0f}% "
          f"of bound), equal {equal}", flush=True)
    return rec


def measure_k6(old, label, plan, x, reps, n_sm, map_cols=None, variants=()):
    """K6's record: old, staged and direct as the launch plan makes them
    (direct: one row a thread on a level of more than 8 live slots); then,
    in turns (staged, direct, direct, staged), the other layouts under
    ``other_layout``: staged at the other row stride, and direct with four
    rows a thread (at the plan's stride) where the plan's direct takes one,
    else at the other stride."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    ref = bk.banded_spmv_rect_ref(plan, x, map_cols)
    staged = bk.banded_launch_plan(plan, n_sm, staged=True)
    direct = bk.banded_launch_plan(plan, n_sm, staged=False)
    live = len(bk.live_slots(plan))
    # the live slots' values and offsets, x (the whole buffer) and y
    nbytes = (live * plan["n"] * (plan["vals"].element_size() + 4)
              + 4 * plan["n"] + 4 * x.shape[0])
    other = 33 - staged.stride
    direct2 = (bk.banded_launch_plan(plan, n_sm, staged=False, rows=4)
               if direct.rows == 1 else direct._replace(stride=other))
    fs = lambda: bk._launch_k6(plan, x, staged._replace(stride=other), map_cols)  # noqa: E731
    fd = lambda: bk._launch_k6(plan, x, direct2, map_cols)  # noqa: E731
    equal = _same(fs(), ref) and _same(fd(), ref)
    _, warm, cold = _turns((fs, fd, fd, fs), nbytes, reps)
    rec = _record(
        "K6" if map_cols is None else "K6-map_cols", label, plan,
        lambda: old_k6(old, plan, x, map_cols),
        lambda: bk._launch_k6(plan, x, staged, map_cols),
        lambda: bk._launch_k6(plan, x, direct, map_cols), ref, nbytes,
        2 * live * plan["n"], reps, n_sm,
        {"stride": staged.stride, "direct_rows": direct.rows,
         "direct_stride": direct.stride, "other_layout": {
             "staged_stride": other, "direct_rows": direct2.rows,
             "direct_stride": direct2.stride, "staged_ms": warm[0::3],
             "direct_ms": warm[1:3], "staged_cold_ms": cold[0::3],
             "direct_cold_ms": cold[1:3]}})
    rec["equal"] = rec["equal"] and equal
    print(f"  staged rows {other} apart {_pair(warm[0::3]):.2f} us warm, "
          f"{_pair(cold[0::3]):.2f} cold; direct {direct2.rows} rows a thread "
          f"{direct2.stride} apart {_pair(warm[1:3]):.2f} warm, "
          f"{_pair(cold[1:3]):.2f} cold; equal {equal}", flush=True)
    # other versions of the source, each variant in turns with this one's
    # (new, version, version, new), L2-warm, at the launch plan's stride
    rec["variants"] = {}
    for name, var in variants:
        out = {}
        for tag, lp in (("staged", staged), ("direct", direct)):
            fn = lambda: bk._launch_k6(plan, x, lp, map_cols)  # noqa: E731
            fv = lambda: variant_k6(var, plan, x, lp, map_cols)  # noqa: E731
            rec["equal"] = rec["equal"] and _same(fv(), ref)
            _, w, _ = _turns((fn, fv, fv, fn), nbytes, reps, cold=False)
            out[tag] = {"new_ms": w[0::3], "var_ms": w[1:3]}
        rec["variants"][name] = out
        print(f"  {name}: " + "; ".join(
            f"{tag} {_pair(v['var_ms']):.2f} (new {_pair(v['new_ms']):.2f})"
            for tag, v in out.items()) + " us", flush=True)
    return rec


def measure_k5(old, label, plan, lo, args, nnz, reps, n_sm):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    ref = bk.banded_df64_residual_ref(plan, lo, *args)
    staged = bk.banded_launch_plan(plan, n_sm, staged=True)
    direct = bk.banded_launch_plan(plan, n_sm, staged=False)
    live = len(bk.live_slots(plan))
    nbytes = live * plan["n"] * (8 if lo is None else 12) + 24 * plan["n"]
    return _record(
        "K5", label, plan, lambda: old_k5(old, plan, lo, *args),
        lambda: bk._launch_k5(plan, lo, *args, staged),
        lambda: bk._launch_k5(plan, lo, *args, direct), ref, nbytes,
        K5_OPS_PER_ENTRY[lo is not None] * nnz, reps, n_sm,
        {"vals_lo": lo is not None})


def measure_k4(old, label, plan, x, reps, n_sm):
    """K4 old against new by the default launch plan: old, new, new, old."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    lp = bk.banded_launch_plan(plan, n_sm)
    ref = bk.banded_spmv_ref(plan, x)
    fo = lambda: old_k4(old, plan, x, lp)  # noqa: E731
    fn = lambda: bk._launch_k4(plan, x, lp)  # noqa: E731
    equal = _same(fo(), ref) and _same(fn(), ref)
    live = len(bk.live_slots(plan))
    nbytes = live * plan["n"] * (plan["vals"].element_size() + 4) + 8 * plan["n"]
    inner, warm, cold = _turns((fo, fn, fn, fo), nbytes, reps)
    rec = {"kernel": "K4", "shape": label, "n": plan["n"], "K": plan["K"],
           "live": live, "dtype": str(plan["vals"].dtype).removeprefix("torch."),
           "inner": inner, "equal": equal,
           "picked": "staged" if lp.staged else "direct",
           "old_ms": warm[0::3], "new_ms": warm[1:3], "old_cold_ms": cold[0::3],
           "new_cold_ms": cold[1:3], "bound_ms": nbytes / 3.35e12 * 1e3,
           "bytes": nbytes}
    print(f"K4 {label} n={plan['n']} live {live} {rec['dtype']}: warm old "
          f"{_pair(rec['old_ms']):.2f} new {_pair(rec['new_ms']):.2f} us, cold "
          f"old {_pair(rec['old_cold_ms']):.2f} new "
          f"{_pair(rec['new_cold_ms']):.2f} us, {rec['picked']}, equal {equal}",
          flush=True)
    return rec


def _k5_args(h, dev, seed):
    band = h.levels[0].Aband
    rng = np.random.default_rng(seed)
    n = band.n_pad
    b64 = rng.standard_normal(n)
    bh = b64.astype(np.float32)
    vecs = (rng.standard_normal(n).astype(np.float32), bh,
            (b64 - bh).astype(np.float32),
            (rng.standard_normal(n) * 1e-6).astype(np.float32))
    return band.plan(), tuple(torch.from_numpy(a).to(dev) for a in vecs)


def path_launches(A, h, cfg) -> dict:
    """Launches by (kernel, n, K) of one refined solve on ``h``."""
    from raptor_tpu_torch import SolveConfig, solve
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    bk.launches_by_shape.clear()
    solve(A, np.ones(A.shape[0]), cfg, SolveConfig(tol=1e-8, refine=True), hier=h)
    torch.cuda.synchronize()
    return {(k, n, K): c for (k, n, K, dtype), c in bk.launches_by_shape.items()
            if dtype == "float32"}


def excess(tag, recs, counts) -> dict:
    """Sigma over the path's shapes of launches x (L2-warm - bound), old and
    new, per kernel."""
    out = {}
    for kern in ("K6", "K5"):
        tot = {"old": 0.0, "new": 0.0}
        for r in recs:
            c = counts.get((kern, r["n"], r["K"]), 0)
            if r["kernel"] != kern or r.get("vals_lo") or r["dtype"] != "float32":
                continue
            for which in tot:
                tot[which] += c * (np.mean(r[f"{which}_ms"]) - r["bound_ms"])
        out[kern] = tot
        print(f"{tag} {kern}: sum of launches x (L2-warm - bound) old "
              f"{tot['old']:.4f} ms, new {tot['new']:.4f} ms", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variant", type=Path, action="append", default=[],
                    help="another version of banded_kernel.cu with this "
                         "package's C interface of K6, timed in turns with "
                         "it at every K6 shape")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    from raptor_tpu_torch import AmgConfig, setup
    from raptor_tpu_torch.ops.cuda.build import load_library

    load_library()
    old = build_old(args.old)
    variants = [(v.stem, build_variant(v)) for v in args.variant]
    dev = torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = open(args.out, "w") if args.out else None
    failed = []

    def keep(rec):
        rec["card"] = card
        if not rec["equal"]:
            failed.append(f"{rec['kernel']} {rec['shape']}")
        if out:
            out.write(json.dumps(rec) + "\n")
            out.flush()
        return rec

    for nx, extra in ((48, {}), (96, {"host_setup_threshold": 2**20})):
        cfg = AmgConfig(**ALG_CFG, **extra)
        A = shuffled_poisson(nx)
        h = setup(A, cfg, device=dev)
        recs = []
        for i, lv in enumerate(h.levels):
            if lv.Aband is not None and (nx == 48 or i == 0):
                plan = lv.Aband.plan()
                x = torch.randn(plan["n"], generator=gen, device="cuda")
                keep(measure_k4(old, f"{nx}^3 L{i} A", plan, x, args.reps, n_sm))
                if i == 0 and nx == 48:
                    keep(measure_k4(old, f"{nx}^3 L0 A", dict(
                        plan, vals=plan["vals"].bfloat16()), x, args.reps, n_sm))
            for name, band in (("P", lv.Pband), ("R", lv.Rband)):
                if band is None:
                    continue
                plan = band.plan()
                x = torch.randn(plan["n_cols"], generator=gen, device="cuda")
                recs.append(keep(measure_k6(old, f"{nx}^3 L{i} {name}", plan, x,
                                            args.reps, n_sm, variants=variants)))
        hs = [(h, A, "without vals_lo")]
        if nx == 48:
            A_pi = shuffled_poisson(48, scale=np.pi)
            hs.append((setup(A_pi, cfg, device=dev), A_pi, "with vals_lo"))
        for hh, AA, what in hs:
            plan, vecs = _k5_args(hh, dev, nx)
            recs.append(keep(measure_k5(old, f"{nx}^3 L0 {what}", plan,
                                        hh.a0_lo_band, vecs, AA.nnz, args.reps,
                                        n_sm)))
        ex = excess(f"alg{nx}", recs, path_launches(A, h, cfg))
        if out:
            out.write(json.dumps({"path": f"alg{nx}", "excess_ms": ex,
                                  "card": card}) + "\n")
        del h, hs
        torch.cuda.empty_cache()
    h4 = setup_four_rank_hierarchy(dev)
    for kern, label, rank, plan, length, map_cols, *_ in sharded_cases(
            h4, ADIST_RANKS):
        if kern != "K6-map_cols" or rank != 0:
            continue
        x = torch.randn(length, generator=gen, device="cuda")
        keep(measure_k6(old, f"96^3 {label} rank 0 of {ADIST_RANKS}", plan, x,
                        args.reps, n_sm, map_cols=map_cols, variants=variants))
    if failed:
        raise SystemExit(f"not bit-equal to the plain version: {failed}")


if __name__ == "__main__":
    main()
