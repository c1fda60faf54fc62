"""Ring collectives over ``torch.distributed`` and an SPMD launcher.

Counterpart of the ``shard_map`` collectives the JAX package's sharded
engines use on a mesh axis: the ring ``ppermute`` by any offset (the two
neighbour shifts of ``raptor_tpu/structured/dist.py:197-202``, the halo
rounds of ``raptor_tpu/parallel/halo.py``), ``psum`` and the tiled
``all_gather``.  One process per rank holds its own shard; a ``Ring`` wraps
the process group those ranks share, the whole world or a subgroup (the
"node" and "chip" axes of the TAPS exchange, ``parallel/taps.py``).

Transports:

* NCCL: every message stays on the device; the shifts are one
  ``batch_isend_irecv`` each.
* gloo: every message is copied to a host buffer, sent, and copied back to
  the tensor's device.  This is how several ranks share one GPU (NCCL takes
  one rank per GPU, and gloo moves no CUDA tensor point to point), and what
  the CPU tests run on.  The caller picks the backend; nothing falls back
  from one transport to the other.

A ring of one sends nothing: each shift returns the rank's own slice, as
``jax.lax.ppermute`` with ``[(0, 0)]`` does.

``spawn(fn, world, backend, device, *args)`` starts ``world`` processes,
joins them into one group through a ``FileStore`` in a fresh temporary
directory (no TCP port, so concurrent runs cannot collide), calls
``fn(ring, device, *args)`` on each and returns the results by rank.  A rank
that raises, dies or outlives ``timeout`` ends the run: every process is
stopped and ``spawn`` raises.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Ring", "spawn"]

# seconds a spawned run may take to start: fresh interpreters importing
# torch (and, on a GPU, creating their CUDA contexts) and the rendezvous
START_TIMEOUT = 300.0


class Ring:
    """The ranks of one process group, seen as a ring (rank r's right
    neighbour is r + 1 mod size)."""

    def __init__(self, group: Optional[dist.ProcessGroup] = None):
        self.group = group
        self.axis_size = dist.get_world_size(group)
        self.axis_index = dist.get_rank(group)
        self.host_staged = dist.get_backend(group) == "gloo"
        # the global rank of each ring position (point-to-point ops name
        # their peer by global rank)
        self._peer = (list(range(self.axis_size)) if group is None else
                      [dist.get_global_rank(group, i)
                       for i in range(self.axis_size)])

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        return t.cpu() if self.host_staged else t

    def shift(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """Send ``t`` to the rank ``d`` places to the right (mod the ring's
        size) and return what the rank ``d`` places to the left sent:
        ``ppermute`` with ``[(i, (i + d) % size)]``.  Every rank passes a
        tensor of the same shape; a shift by a multiple of the size returns
        ``t`` itself."""
        r, p = self.axis_index, self.axis_size
        if d % p == 0:
            return t
        send = self._stage(t)
        recv = torch.empty_like(send)
        ops = [dist.P2POp(dist.isend, send, self._peer[(r + d) % p], self.group),
               dist.P2POp(dist.irecv, recv, self._peer[(r - d) % p], self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return recv.to(t.device)

    def shift_right(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the right neighbour; return the left one's."""
        return self.shift(t, 1)

    def shift_left(self, t: torch.Tensor) -> torch.Tensor:
        """Send ``t`` to the left neighbour; return the right one's."""
        return self.shift(t, -1)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ring (a new tensor)."""
        if self.axis_size == 1:
            return t
        buf = self._stage(t).clone()
        dist.all_reduce(buf, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.axis_size == 1:
            return t
        send = self._stage(t)
        parts = [torch.empty_like(send) for _ in range(self.axis_size)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, dim=dim).to(t.device)


def _run_rank(rank, fn, world, backend, device, tmp, args):
    """Body of one spawned rank: join the group, mark itself started, run
    ``fn`` and write its result to the run's directory."""
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(hours=1))
    open(os.path.join(tmp, f"started{rank}"), "w").close()
    out = fn(Ring(), dev, *args)
    dist.barrier()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"result{rank}"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world: int, backend: str, device, *args,
          timeout: float = 300.0) -> List:
    """Run ``fn(ring, device, *args)`` on ``world`` new processes and return
    the results in rank order.

    ``fn`` must be importable (a module-level function) and its result
    picklable.  ``START_TIMEOUT`` bounds the start (interpreter, imports,
    rendezvous) and ``timeout`` the run from the moment every rank has
    joined.  A rank that raises or dies stops every process and raises
    ``RuntimeError``; a run past its time stops them and raises
    ``TimeoutError``."""
    tmp = tempfile.mkdtemp(prefix="raptor_spmd_")
    ctx = mp.start_processes(_run_rank, nprocs=world, join=False, daemon=True,
                             args=(fn, world, backend, str(device), tmp, args),
                             start_method="spawn")
    procs = ctx.processes

    def marked(kind):
        return [os.path.exists(os.path.join(tmp, f"{kind}{r}"))
                for r in range(world)]

    try:
        started, deadline = False, time.monotonic() + START_TIMEOUT
        while True:
            try:
                if ctx.join(timeout=0.5):
                    break
            except mp.ProcessRaisedException as e:
                raise RuntimeError(f"rank {e.error_index} failed:\n{e}") from None
            except mp.ProcessExitedException as e:
                raise RuntimeError(f"rank {e.error_index} exited with code "
                                   f"{e.exit_code} ({e.signal_name})") from None
            if not started and all(marked("started")):
                started, deadline = True, time.monotonic() + timeout
            if time.monotonic() > deadline:
                if started:
                    late = [r for r, p in enumerate(procs) if p.is_alive()]
                else:
                    late = [r for r, ok in enumerate(marked("started")) if not ok]
                what, limit = ("run", timeout) if started else ("start", START_TIMEOUT)
                raise TimeoutError(f"ranks {late} did not finish the {what} "
                                   f"within {limit} s")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
