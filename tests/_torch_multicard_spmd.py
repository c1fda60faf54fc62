"""Bodies of the spawned ranks of tests/test_torch_multicard.py (gloo on
the CPU) and of the multi-card ``cuda`` tests in tests/test_torch_cuda.py
(NCCL, one rank a card).

Each function runs on every rank of a ``raptor_tpu_torch.parallel.spawn``
run and returns plain Python or numpy data.  This module imports no JAX: a
spawned child imports it fresh.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from raptor_tpu_torch.parallel import Ring

DTYPES = (torch.float32, torch.float64, torch.int64, torch.bfloat16)


def placement(ring: Ring, device) -> dict:
    """What the rank was given: its device, rank, ring and transport, and
    its current card under CUDA."""
    return {"device": str(device), "rank": ring.axis_index,
            "size": ring.axis_size, "host_staged": ring.host_staged,
            "current": (torch.cuda.current_device() if device.type == "cuda"
                        else None)}


def fail_on_last(ring: Ring, device) -> None:
    """The last rank raises while the others wait in a collective that it
    never enters."""
    if ring.axis_index == ring.axis_size - 1:
        raise ValueError("the last rank fails on purpose")
    ring.psum(torch.ones(1, device=device))


def _tensor(q: int, dtype, shape, device) -> torch.Tensor:
    """Rank q's input: multiples of 1/8 in [-1, 1] (integers for int64),
    so a sum over a few ranks is exact in every dtype and the same in any
    reduction order."""
    g = torch.Generator().manual_seed(100 + q)
    t = torch.randint(-8, 9, shape, generator=g)
    return (t if dtype == torch.int64 else t.to(dtype) / 8).to(device)


def ring_against_gloo(ring: Ring, device) -> dict:
    """The world ring's shifts by +-1 and +-2 (1-D, 2-D and empty), psum,
    pmax and all_gather in each of DTYPES, against a gloo ring over the
    same ranks on the same inputs and against what the ranks' inputs give.
    Returns the number of equal results, the names of those that differ
    and the rank's placement."""
    gloo = Ring(dist.new_group(backend="gloo"))
    r, p = ring.axis_index, ring.axis_size
    equal, differ = 0, []

    def same(what, got, want):
        nonlocal equal
        if (got.device == want.device and got.dtype == want.dtype
                and torch.equal(got, want)):
            equal += 1
        else:
            differ.append(what)

    for dtype in DTYPES:
        for shape in ((513,), (3, 65), (0,)):
            t = [_tensor(q, dtype, shape, device) for q in range(p)]
            for d in (1, -1, 2, -2):
                got = ring.shift(t[r], d)
                same(f"shift {d} {dtype} {shape}", got, t[(r - d) % p])
                same(f"shift {d} {dtype} {shape} gloo", got, gloo.shift(t[r], d))
            if not t[r].numel():
                continue
            wants = {"psum": torch.stack([u.double() for u in t]).sum(0).to(dtype),
                     "pmax": torch.stack(t).amax(0),
                     "all_gather": torch.cat(t, dim=-1)}
            for op, want in wants.items():
                got = getattr(ring, op)(t[r])
                same(f"{op} {dtype} {shape}", got, want)
                same(f"{op} {dtype} {shape} gloo", got, getattr(gloo, op)(t[r]))
    return dict(placement(ring, device), equal=equal, differ=differ)


def config5(ring: Ring, device, n: int) -> dict:
    """``sdist_config5`` at n^3 on the ring: the iterations, the certified
    relres and, on rank 0, the gathered x."""
    from raptor_tpu_torch.structured.dist import gather, sdist_config5

    out = sdist_config5(ring, device, n=n)
    x = gather(out["x"], ring)
    return {"iters": int(out["info"].iterations),
            "relres": float(out["info"].relres), "device": str(device),
            "x": x.cpu().numpy().astype(np.float64) if ring.axis_index == 0
            else None}
