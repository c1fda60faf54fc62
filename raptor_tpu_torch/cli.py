"""Command-line interface: the five acceptance configurations as named
presets, ad-hoc solves and device information.

  python -m raptor_tpu_torch bench --preset config2
  python -m raptor_tpu_torch solve --problem poisson3d --method structured
  python -m raptor_tpu_torch solve --matrix A.rbm --layout banded --out x.npy
  python -m raptor_tpu_torch info

Counterpart of ``raptor_tpu/cli.py``.  Every command runs on ``--device``
(default ``cuda``); without a card it exits with an error unless the
caller asks for ``--device cpu``.  Each command prints one JSON object:
iterations, relative residual, setup and solve seconds.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _problem(name: str, n: int):
    from raptor_tpu_torch import gallery

    if name == "poisson2d":
        return gallery.poisson_2d(n), None, (n, n)
    if name == "poisson3d":
        return gallery.poisson_3d(n), None, (n, n, n)
    if name == "anisotropic":
        A = gallery.anisotropic_2d(n, epsilon=1e-3, theta=np.pi / 6)
        return A, None, (n, n)
    if name == "convdiff":
        # nonsymmetric: pair with --krylov gmres / bicgstab
        return gallery.convection_diffusion_2d(n, epsilon=1e-2), None, (n, n)
    if name == "elasticity":
        A, B, _ = gallery.elasticity_3d(n)
        return A, B, None
    raise SystemExit(f"unknown problem: {name}")


# preset -> (gallery problem, default n); the AmgConfig always comes from
# config.PRESETS, so the CLI benches the configuration the library ships
PRESET_PROBLEMS = {
    "config1": ("poisson2d", 64),
    "config2": ("poisson3d", 32),
    "config3": ("anisotropic", 64),
    "config4": ("elasticity", 8),
    "config5": ("poisson3d", 256),
}


def _device(name: str) -> torch.device:
    """The device a command runs on; exits when it asks for a missing
    card (never drops to the CPU on its own)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"--device {name}: no CUDA device is available "
            "(torch.cuda.is_available() is false); pass --device cpu to "
            "run on the CPU")
    return dev


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_solve(args):
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.gallery import default_rhs

    dev = _device(args.device)
    if args.matrix:
        from raptor_tpu_torch.utils.io import read_matrix

        A = read_matrix(args.matrix)
        if A.shape[0] != A.shape[1]:
            raise SystemExit(f"--matrix must be square, got {A.shape}")
        B, dims = None, None
    else:
        A, B, dims = _problem(args.problem, args.n)
    if args.rhs:
        from raptor_tpu_torch.utils.io import read_vector

        b = read_vector(args.rhs)
        if b.shape[0] != A.shape[0]:
            raise SystemExit(
                f"--rhs length {b.shape[0]} != matrix rows {A.shape[0]}")
    else:
        b = default_rhs(A.shape[0])
    if args.method == "structured":
        if dims is None:
            raise SystemExit("structured method needs a grid problem")
        from raptor_tpu_torch.structured import (build_structured_hierarchy,
                                                 dia_from_scipy,
                                                 structured_solve)

        dt = torch.float64 if args.fp64 else torch.float32
        D = dia_from_scipy(A, dims, dtype=dt, device=dev)
        hier = build_structured_hierarchy(D, AmgConfig(
            smoother=args.smoother or "mcgs"))
        _sync(dev)
        t0 = time.perf_counter()
        x, info = structured_solve(
            hier, torch.as_tensor(b, dtype=dt, device=dev), tol=args.tol,
            maxiter=args.maxiter, krylov=args.krylov or "cg")
        x = x.double().cpu().numpy()
        out = {
            "iterations": int(info.iterations),
            "relres": float(info.relres),
            "seconds": time.perf_counter() - t0,
            "true_relres": float(np.linalg.norm(A @ x - b)
                                 / np.linalg.norm(b)),
        }
    else:
        cfg = AmgConfig(splitting=args.splitting,
                        smoother=args.smoother or "jacobi",
                        fine_layout=args.layout)
        sc = SolveConfig(dtype="float64" if args.fp64 else "float32",
                         tol=args.tol, maxiter=args.maxiter,
                         refine=not args.fp64, krylov=args.krylov or "cg")
        t0 = time.perf_counter()
        x, info = solve(A, b, cfg, sc, device=dev)
        out = {
            "iterations": info["iterations"],
            "relres": info["relres"],
            "seconds": time.perf_counter() - t0,
            "stats": info["stats"],
        }
    if args.out:
        from raptor_tpu_torch.utils.io import write_vector

        write_vector(args.out, np.asarray(x, np.float64)[: A.shape[0]])
        out["solution"] = args.out
    print(json.dumps(out))


def cmd_bench(args):
    from raptor_tpu_torch import setup
    from raptor_tpu_torch.api import solve_hier
    from raptor_tpu_torch.config import PRESETS
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.setup.hierarchy import hierarchy_stats

    dev = _device(args.device)
    name, n = PRESET_PROBLEMS[args.preset]
    n = args.n or n
    if args.preset == "config5":
        # the plane-sharded structured path over every visible card; the
        # single-device structured engine on one
        return _bench_config5(n, args, dev)

    A, B, _ = _problem(name, n)
    b = default_rhs(A.shape[0])
    cfg = PRESETS[args.preset]
    _sync(dev)
    t0 = time.perf_counter()
    if B is not None:
        from raptor_tpu_torch.setup.aggregation import build_sa_hierarchy

        hier = build_sa_hierarchy(A, cfg, dtype=np.float32, B=B,
                                  device=dev).to(dev)
    else:
        hier = setup(A, cfg, dtype=np.float32, device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    bd = pad_vector(b.astype(np.float32), hier.levels[0].A.n_rows_pad,
                    device=dev)
    solve_hier(hier, bd, tol=1e-6, maxiter=args.maxiter)  # warm
    _sync(dev)
    t0 = time.perf_counter()
    x, info = solve_hier(hier, bd, tol=1e-6, maxiter=args.maxiter)
    relres = float(info.relres)
    solve_s = time.perf_counter() - t0
    print(json.dumps({
        "preset": args.preset,
        "problem": f"{name} n={n}",
        "setup_s": setup_s,
        "solve_s": solve_s,
        "iterations": int(info.iterations),
        "relres": relres,
        "stats": hierarchy_stats(hier),
    }))


def config5_rank(ring, device, n: int, maxiter: int) -> dict:
    """One rank of the sharded config-5 bench on the device ``spawn`` gave
    it (under NCCL, card r for rank r): ``sdist_build_hierarchy`` then
    ``sdist_solve`` to 1e-6.  Returns the rank's iterations, relres and
    seconds."""
    from raptor_tpu_torch.structured.dist import (CONFIG5, config5_problem,
                                                  sdist_solve)
    from raptor_tpu_torch.structured.dist_setup import sdist_build_hierarchy

    dev = torch.device(device)
    A, b = config5_problem(n, dev)
    _sync(dev)
    t0 = time.perf_counter()
    dh = sdist_build_hierarchy(A, CONFIG5, ring, dim_policy="size")
    _sync(dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, info = sdist_solve(dh, b, ring, tol=1e-6, maxiter=maxiter)
    _sync(dev)
    return {"setup_s": setup_s, "solve_s": time.perf_counter() - t0,
            "iterations": int(info.iterations), "relres": float(info.relres)}


def config5_ranks(n: int, n_cards: int) -> int:
    """The ranks of ``bench --preset config5`` at n^3 with ``n_cards``
    visible: every card when n divides over them (the reference's rule,
    one mesh device a card), else one."""
    return n_cards if n_cards > 1 and n % n_cards == 0 else 1


def _bench_config5(n, args, dev):
    from raptor_tpu_torch.structured import (build_structured_hierarchy,
                                             structured_solve)
    from raptor_tpu_torch.structured.dist import CONFIG5, config5_problem

    ndev = config5_ranks(n, torch.cuda.device_count() if dev.type == "cuda"
                         else 1)
    if ndev > 1:
        from raptor_tpu_torch.parallel.comm import spawn

        # one NCCL rank a card, rank r on cuda:r
        res = spawn(config5_rank, ndev, "nccl", "cuda", n, args.maxiter,
                    timeout=3600.0)[0]
        setup_s, solve_s = res["setup_s"], res["solve_s"]
        iters, relres = res["iterations"], res["relres"]
    else:
        A, b = config5_problem(n, dev)
        _sync(dev)
        t0 = time.perf_counter()
        hier = build_structured_hierarchy(A, CONFIG5, dim_policy="size")
        _sync(dev)
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, info = structured_solve(hier, b, tol=1e-6, maxiter=args.maxiter)
        _sync(dev)
        solve_s = time.perf_counter() - t0
        iters, relres = int(info.iterations), float(info.relres)
    print(json.dumps({
        "preset": "config5",
        "problem": f"poisson3d n={n} (structured, {ndev} device(s))",
        "setup_s": setup_s,
        "solve_s": solve_s,
        "iterations": iters,
        "relres": relres,
    }))


def cmd_info(args):
    import raptor_tpu_torch

    dev = _device(args.device)
    if dev.type == "cuda":
        devices = [torch.cuda.get_device_name(i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = ["cpu"]
    print(json.dumps({
        "version": raptor_tpu_torch.__version__,
        "torch": torch.__version__,
        "devices": devices,
        "backend": dev.type,
    }))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="raptor_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda; "
                            "'cpu' runs on the host)")

    s = sub.add_parser("solve", help="solve a gallery problem or a matrix "
                                     "read from a file")
    s.add_argument("--problem", default="poisson3d",
                   choices=["poisson2d", "poisson3d", "anisotropic",
                            "convdiff", "elasticity"])
    s.add_argument("--matrix", default=None, metavar="PATH",
                   help="solve this operator instead of a gallery problem "
                        "(.mtx/.mtx.gz/.npz/.rbm, see utils/io.py)")
    s.add_argument("--rhs", default=None, metavar="PATH",
                   help="right-hand side (.npy or text; default: "
                        "deterministic unit-norm random)")
    s.add_argument("--out", default=None, metavar="PATH",
                   help="write the solution vector here (.npy or text)")
    s.add_argument("--krylov", default=None,
                   choices=["cg", "bicgstab", "gmres", "fgmres", "none"],
                   help="outer Krylov method (default: cg)")
    s.add_argument("--n", type=int, default=32)
    s.add_argument("--method", default="algebraic",
                   choices=["algebraic", "structured"])
    s.add_argument("--splitting", default="pmis",
                   choices=["rs", "pmis", "cljp", "aggregation"])
    s.add_argument("--smoother", default=None)
    s.add_argument("--tol", type=float, default=1e-8)
    s.add_argument("--maxiter", type=int, default=200)
    s.add_argument("--fp64", action="store_true")
    s.add_argument("--layout", default="ell", choices=["ell", "banded"],
                   help="operator layout of the algebraic solve; 'banded' "
                        "= RCM + the paged-gather banded kernels")
    device_arg(s)
    s.set_defaults(fn=cmd_solve)

    bench = sub.add_parser("bench", help="run an acceptance-config preset")
    bench.add_argument("--preset", default="config2",
                       choices=sorted(PRESET_PROBLEMS))
    bench.add_argument("--n", type=int, default=0)
    bench.add_argument("--maxiter", type=int, default=200)
    device_arg(bench)
    bench.set_defaults(fn=cmd_bench)

    info = sub.add_parser("info", help="device/version info")
    device_arg(info)
    info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
