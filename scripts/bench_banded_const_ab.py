#!/usr/bin/env python3
"""Old against new: the banded SpMV K4 (``csrc/banded_kernel.cu``) and the
constant-stencil DIA SpMV K2 (``csrc/dia_const_kernel.cu``) against earlier
versions of those sources, in turns, on one NVIDIA GPU.

    python3 scripts/bench_banded_const_ab.py --old-banded OLD_banded_kernel.cu \\
        --old-dia OLD_dia_kernel.cu [--out FILE] [--no-96]

``--old-banded`` is a copy of the earlier ``banded_kernel.cu`` whose K4 takes
a slot list and no launch plan (``raptor_banded_*(vals, pidx, x, y, n, K,
tile, Wp, slots, n_live, stream)``); ``--old-dia`` a copy of the earlier
``dia_kernel.cu`` whose K2 takes no tile plan (``raptor_dia_const_f32(x, y,
n, batch, dims, nd, offs, lins, consts, n_off, stream)``).  Each is built
by nvcc into a library of its own under ``build/`` (e.g. ``git show
<commit>:raptor_tpu_torch/csrc/banded_kernel.cu`` into a directory that
``.gitignore`` lists).  ``--variant-banded FILE.cu`` times another version
of K4 with this package's C interface in turns too.

At each shape the script checks every kernel against the plain PyTorch
version (bit for bit, ``torch.equal``) and times them by CUDA-graph replay
(``chip_smoke.cuda_ms``), L2-warm and then L2-cold (256 MB written between
replays).  L2-warm, one graph holds ``inner`` calls back to back (up to 50,
fewer as the call's bytes grow past 1 MB), so that a short kernel is not
timed as the graph's launch; the time is per call.

* K4, in the order old, staged, direct, direct, staged, old: every banded
  level of the shuffled 48^3 hierarchy (level 0 also with bf16 values) and,
  unless ``--no-96``, of the shuffled 96^3 one, built on the host by
  ``raptor_tpu_torch.api.setup`` as ``chip_smoke.py`` builds them.  Staged
  and direct are the two variants of the new kernel, forced; ``picked``
  names the one ``banded_launch_plan`` takes by itself.
  Then three synthetic plans of three entries a row reaching 2, 8 and 23
  pages (windows of 5, 17 and 47 pages), where a staged value is read
  least often; ``--sweep-threads`` also times the staged variant at every
  block size.
* K2, in the order old, new, new, old: the 7-point stencil at 128^3 and
  256^3, the batched 16^3 grid (batch 4) and a 5-point stencil at 2048^2.

Each shape prints one JSON line (also written to ``--out``): times in ms,
the bound (bytes over 3.35 TB/s), and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from bench_dia_tiles_ab import _library  # noqa: E402
from chip_smoke import (ALG_CFG, HBM_BYTES_PER_S, cuda_ms,  # noqa: E402
                        shuffled_poisson, stencil_7pt)

P, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
K4_NEW_ARGS = [P, P, P, P, I64, I32, I32, I32, P, I32, I32, I32, I32, I32, P]


def build_old_banded(src: Path) -> ctypes.CDLL:
    old = _library(src, "old_banded")
    for name in ("raptor_banded_f32", "raptor_banded_bf16"):
        getattr(old, name).argtypes = [P, P, P, P, I64, I32, I32, I32, P, I32, P]
    return old


def build_old_dia(src: Path) -> ctypes.CDLL:
    old = _library(src, "old_dia")
    old.raptor_dia_const_f32.argtypes = [P, P, I64, I32, P, I32, P, P, P, I32, P]
    return old


def build_variant_banded(src: Path) -> ctypes.CDLL:
    var = _library(src, "variant_banded")
    for name in ("raptor_banded_f32", "raptor_banded_bf16"):
        getattr(var, name).argtypes = K4_NEW_ARGS
    return var


def _fn(lib, plan):
    return (lib.raptor_banded_bf16 if plan["vals"].dtype == torch.bfloat16
            else lib.raptor_banded_f32)


def old_k4(old, plan, x):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    y = torch.empty_like(x)
    rc = _fn(old, plan)(plan["vals"].data_ptr(), plan["pidx"].data_ptr(),
                        x.data_ptr(), y.data_ptr(), plan["n"], plan["K"],
                        plan["tile"], plan["Wp"], bk._slots(live), len(live),
                        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old K4 launch failed: cudaError {rc}")
    return y


def variant_k4(var, plan, x, launch):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    live = bk.live_slots(plan)
    y = torch.empty_like(x)
    rc = _fn(var, plan)(plan["vals"].data_ptr(), plan["pidx"].data_ptr(),
                        x.data_ptr(), y.data_ptr(), plan["n"], plan["K"],
                        plan["tile"], plan["Wp"], bk._live_mask(live),
                        len(live), int(launch.staged), launch.threads,
                        launch.page0, launch.pages,
                        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"variant K4 launch failed: cudaError {rc}")
    return y


def old_k2(old, consts, offsets, dims, x):
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    n = int(np.prod(dims))
    batch = 1 if x.dim() == 1 else x.shape[0]
    y = torch.empty_like(x)
    rc = old.raptor_dia_const_f32(
        x.data_ptr(), y.data_ptr(), n, batch, tk._int_array(dims), len(dims),
        tk._int_array([v for o in offsets for v in o]),
        tk._int_array(tk._const_lins(offsets, dims)),
        (ctypes.c_float * len(consts))(*consts), len(offsets),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"old K2 launch failed: cudaError {rc}")
    return y


def _turns(fns, nbytes, reps, cold=True):
    """(inner, warm ms per call, cold ms) of ``fns``, timed in the order
    given."""
    inner = max(1, min(50, (1 << 20) * 50 // nbytes))
    warm = [cuda_ms(lambda: [f() for _ in range(inner)], reps) / inner
            for f in fns]
    cold_ms = [cuda_ms(f, reps, flush_l2=True) for f in fns] if cold else []
    return inner, warm, cold_ms


def _pair(v):
    """Mean of the two readings of one kernel, in µs."""
    return float(np.mean(v)) * 1e3


def measure_k4(old, label, plan, x, reps, variants, n_sm, sweep_threads=False):
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    picked = bk.banded_launch_plan(plan, n_sm)
    staged = bk.banded_launch_plan(plan, n_sm, staged=True)
    direct = bk.banded_launch_plan(plan, n_sm, staged=False)
    ref = bk.banded_spmv_ref(plan, x)
    fo = lambda: old_k4(old, plan, x)  # noqa: E731
    fs = lambda: bk._launch_k4(plan, x, staged)  # noqa: E731
    fd = lambda: bk._launch_k4(plan, x, direct)  # noqa: E731
    equal = all(bool(torch.equal(f(), ref)) for f in (fo, fs, fd))
    live = len(bk.live_slots(plan))
    itemsize = plan["vals"].element_size()
    # the live slots' values and offsets, x and y
    nbytes = live * plan["n"] * (itemsize + 4) + 8 * plan["n"]
    inner, warm, cold = _turns((fo, fs, fd, fd, fs, fo), nbytes, reps)
    var_ms = {}
    for name, var in variants:
        for tag, lp in (("staged", staged), ("direct", direct)):
            fv = lambda: variant_k4(var, plan, x, lp)  # noqa: E731
            fn = fs if lp.staged else fd
            equal = equal and bool(torch.equal(fv(), ref))
            _, w, c = _turns((fn, fv, fv, fn), nbytes, reps)
            var_ms[f"{name} {tag}"] = {"new_ms": w[0::3], "var_ms": w[1:3],
                                       "new_cold_ms": c[0::3],
                                       "var_cold_ms": c[1:3]}
    # the staged variant at every block size, L2-warm, smallest first and
    # back again
    sweep = {}
    if sweep_threads:
        sizes = (32, 64, 128, 256)
        fts = [(lambda lp: lambda: bk._launch_k4(plan, x, lp))(
            bk.banded_launch_plan(plan, n_sm, staged=True, threads=th))
            for th in sizes]
        _, w, _ = _turns(fts + fts[::-1], nbytes, reps, cold=False)
        sweep = {th: [w[i], w[-1 - i]] for i, th in enumerate(sizes)}
    rec = {"kernel": "K4", "shape": label, "n": plan["n"], "K": plan["K"],
           "live": live, "npage": (plan["tile"] + 2 * plan["Wp"]) // 1024,
           "dtype": str(plan["vals"].dtype).removeprefix("torch."),
           "inner": inner, "equal": equal,
           "picked": "staged" if picked.staged else "direct",
           "threads": picked.threads, "pages": staged.pages,
           "smem_bytes": staged.smem_bytes,
           "old_ms": warm[0::5], "staged_ms": warm[1::3], "direct_ms": warm[2:4],
           "old_cold_ms": cold[0::5], "staged_cold_ms": cold[1::3],
           "direct_cold_ms": cold[2:4],
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
           "variants": var_ms, "staged_ms_by_threads": sweep}
    print(f"K4 {label} n={plan['n']} K={plan['K']} live {live} {rec['dtype']} "
          f"threads {picked.threads} pages {staged.pages}: warm old "
          f"{_pair(rec['old_ms']):.1f} staged {_pair(rec['staged_ms']):.1f} "
          f"direct {_pair(rec['direct_ms']):.1f} us; cold old "
          f"{_pair(rec['old_cold_ms']):.1f} staged "
          f"{_pair(rec['staged_cold_ms']):.1f} direct "
          f"{_pair(rec['direct_cold_ms']):.1f} us; bound "
          f"{rec['bound_ms'] * 1e3:.1f} us, picked {rec['picked']}, equal "
          f"{equal}" + "".join(
              f"; {name}: warm {_pair(v['var_ms']):.1f} (new "
              f"{_pair(v['new_ms']):.1f}), cold {_pair(v['var_cold_ms']):.1f} "
              f"(new {_pair(v['new_cold_ms']):.1f})"
              for name, v in var_ms.items()) + (
              "; staged by threads " + ", ".join(
                  f"{th}: {_pair(v):.1f}" for th, v in sweep.items())
              if sweep else ""), flush=True)
    return rec


def measure_k2(old, label, consts, offsets, dims, x, reps):
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk

    ref = tk.dia_spmv_const_ref(consts, offsets, dims, x)
    fo = lambda: old_k2(old, consts, offsets, dims, x)  # noqa: E731
    fn = lambda: tk.dia_spmv_const(consts, offsets, dims, x)  # noqa: E731
    equal = bool(torch.equal(fo(), ref) and torch.equal(fn(), ref))
    del ref
    nbytes = 8 * x.numel()
    inner, warm, cold = _turns((fo, fn, fn, fo), nbytes, reps)
    batch = 1 if x.dim() == 1 else x.shape[0]
    plan = tk.const_tile_plan(offsets, dims, batch,
                              torch.cuda.get_device_properties(x.device)
                              .multi_processor_count)
    rec = {"kernel": "K2", "shape": label, "n": int(np.prod(dims)),
           "n_off": len(offsets), "batch": batch, "inner": inner,
           "tile": plan.tile, "bands": len(plan.bands), "equal": equal,
           "old_ms": warm[0::3], "new_ms": warm[1:3],
           "old_cold_ms": cold[0::3], "new_cold_ms": cold[1:3],
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes}
    print(f"K2 {label} n={rec['n']} n_off={rec['n_off']} batch {batch}: warm "
          f"old {_pair(rec['old_ms']):.1f} new {_pair(rec['new_ms']):.1f} us, "
          f"cold old {_pair(rec['old_cold_ms']):.1f} new "
          f"{_pair(rec['new_cold_ms']):.1f} us, bound "
          f"{rec['bound_ms'] * 1e3:.1f} us, tile {plan.tile}, "
          f"{len(plan.bands)} bands, equal {equal}", flush=True)
    return rec


def sweep_k2(label, consts, offsets, dims, x, reps):
    """K2 at every (rows a thread, threads a block) the kernel is built
    for, L2-warm, each checked against the plain version: the tile plan is
    made by hand, as ``tile_plan`` makes it, for a tile of rows x threads."""
    from raptor_tpu_torch.ops.cuda import dia_kernel as tk
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    n = int(np.prod(dims))
    batch = 1 if x.dim() == 1 else x.shape[0]
    lins = tk._const_lins(offsets, dims)
    ref = tk.dia_spmv_const_ref(consts, offsets, dims, x)
    head = (tk._int_array(dims), len(dims),
            tk._int_array([v for o in offsets for v in o]), tk._int_array(lins),
            (ctypes.c_float * len(consts))(*consts), len(offsets))
    out = {}
    for rows in tk.CONST_ROWS:
        if dims[-1] % rows and rows != 4:
            continue
        for threads in (64, 128, 256):
            tile = rows * threads
            bands = tk._bands(lins, tile)
            wins = [tk._window(tile, lo, hi) for lo, hi in bands]
            if 8 * sum(wins) > tk.SMEM_BYTES:
                continue
            band_of = [next(b for b, (lo, hi) in enumerate(bands)
                            if lo <= o <= hi) for o in lins]
            tail = (rows, tile, len(bands),
                    tk._int_array([lo for lo, _ in bands]), tk._int_array(wins),
                    tk._int_array(band_of))

            def call():
                y = torch.empty_like(x)
                rc = lib.raptor_dia_const_f32(
                    x.data_ptr(), y.data_ptr(), n, batch, *head, *tail,
                    torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"K2 launch failed: cudaError {rc}")
                return y

            equal = bool(torch.equal(call(), ref))
            _, w, _ = _turns((call, call), 8 * x.numel(), reps, cold=False)
            out[f"{rows}x{threads}"] = {"ms": w, "equal": equal,
                                        "smem_bytes": 8 * sum(wins)}
    print(f"K2 {label} by rows x threads, warm us: " + ", ".join(
        f"{k}: {_pair(v['ms']):.1f}{'' if v['equal'] else ' NOT EQUAL'}"
        for k, v in out.items()), flush=True)
    return out


def k4_shapes(nx: int, dev, **cfg_extra):
    """(label, plan) for every banded level of the shuffled nx^3 hierarchy;
    level 0 also with bf16 values."""
    from raptor_tpu_torch import AmgConfig, setup

    h = setup(shuffled_poisson(nx), AmgConfig(**ALG_CFG, **cfg_extra), device=dev)
    for i, lv in enumerate(h.levels):
        if lv.Aband is None:
            continue
        plan = lv.Aband.plan()
        yield f"{nx}^3 L{i}", plan
        if i == 0:
            yield f"{nx}^3 L0", dict(plan, vals=plan["vals"].bfloat16())


def wide_shapes(dev, n: int = 442368):
    """(label, plan): three entries a row at row - reach, row, row + reach,
    for windows of 5, 17 and 47 pages (banded_plan's cap is 48): the
    shapes where a staged value is read least often."""
    from raptor_tpu_torch.ops.banded_plan import banded_plan

    rows = np.arange(n)
    for pages in (2, 8, 23):
        reach = pages * 1024
        cols = np.stack([np.clip(rows - reach, 0, n - 1), rows,
                         np.clip(rows + reach, 0, n - 1)]).astype(np.int32)
        vals = np.random.default_rng(pages).standard_normal((3, n))
        plan = banded_plan(cols, np.full(n, 3, np.int32),
                           vals.astype(np.float32))
        yield f"3 entries, reach {pages} pages", dict(
            plan, vals=torch.from_numpy(plan["vals"]).to(dev),
            pidx=torch.from_numpy(plan["pidx"]).to(dev))


def k2_shapes(gen):
    """(label, consts, offsets, dims, x): star stencils in C order."""
    five = np.array([[0, -1, 0], [-1, 4, -1], [0, -1, 0]], float)
    for label, st, dims, batch in (("128^3", stencil_7pt(), (128,) * 3, None),
                                   ("256^3", stencil_7pt(), (256,) * 3, None),
                                   ("16^3 batch 4", stencil_7pt(), (16,) * 3, 4),
                                   ("2048^2 5-point", five, (2048, 2048), None)):
        offsets = [o for o in itertools.product((-1, 0, 1), repeat=len(dims))
                   if sum(map(abs, o)) <= 1]
        consts = [float(st[tuple(np.add(o, 1))]) for o in offsets]
        n = int(np.prod(dims))
        x = torch.randn((n,) if batch is None else (batch, n), generator=gen,
                        device="cuda")
        yield label, consts, offsets, dims, x


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-banded", type=Path, required=True)
    ap.add_argument("--old-dia", type=Path, required=True)
    ap.add_argument("--variant-banded", type=Path, action="append", default=[])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--no-96", action="store_true")
    ap.add_argument("--sweep-k2", action="store_true",
                    help="also time K2 at every rows a thread x threads a "
                         "block")
    ap.add_argument("--only-k2", action="store_true")
    ap.add_argument("--sweep-threads", action="store_true",
                    help="also time K4's staged variant at 32, 64, 128 and "
                         "256 threads a block")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times kernels on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    from raptor_tpu_torch.ops.cuda.build import load_library

    load_library()
    old_b, old_d = build_old_banded(args.old_banded), build_old_dia(args.old_dia)
    variants = [(v.stem, build_variant_banded(v)) for v in args.variant_banded]
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

    for label, consts, offsets, dims, x in k2_shapes(gen):
        rec = measure_k2(old_d, label, consts, offsets, dims, x, args.reps)
        if args.sweep_k2:
            rec["by_rows_x_threads"] = sweep_k2(label, consts, offsets, dims, x,
                                                args.reps)
        keep(rec)
        if args.only_k2:
            continue
        del x
    if args.only_k2:
        return
    sizes = [(48, {})] + ([] if args.no_96 else
                          [(96, {"host_setup_threshold": 2**20})])
    for nx, extra in sizes:
        for label, plan in k4_shapes(nx, dev, **extra):
            x = torch.randn(plan["n"], generator=gen, device="cuda")
            keep(measure_k4(old_b, label, plan, x, args.reps, variants, n_sm,
                            args.sweep_threads))
    for label, plan in wide_shapes(dev):
        x = torch.randn(plan["n"], generator=gen, device="cuda")
        keep(measure_k4(old_b, label, plan, x, args.reps, variants, n_sm,
                        args.sweep_threads))
    if failed:
        raise SystemExit(f"not bit-equal to the plain version: {failed}")


if __name__ == "__main__":
    main()
