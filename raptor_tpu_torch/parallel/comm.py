"""Ring collectives over ``torch.distributed`` and an SPMD launcher.

Counterpart of the ``shard_map`` collectives the JAX package's sharded
engines use on a mesh axis: the ring ``ppermute`` by any offset (the two
neighbour shifts of ``raptor_tpu/structured/dist.py:197-202``, the halo
rounds of ``raptor_tpu/parallel/halo.py``), ``psum``, ``pmax`` and the tiled
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

Placement (``rank_devices``): under NCCL, one rank a card.  A CUDA device
given without an index puts rank r on ``cuda:r``; a list names each rank's
device.  Each rank makes its device current before it joins the group and
binds the NCCL communicator to it (``device_id``), and ``fn`` gets that
device.  More ranks than cards, two ranks on one card or a CPU device raise
``ValueError`` before any process starts.  Under gloo every rank takes the
one device given (several ranks may share a card).
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["Ring", "rank_devices", "spawn"]

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

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``t`` over the ring (a new tensor)."""
        if self.axis_size == 1:
            return t
        buf = self._stage(t).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
        return buf.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        if self.axis_size == 1:
            return t
        send = self._stage(t)
        parts = [torch.empty_like(send) for _ in range(self.axis_size)]
        dist.all_gather(parts, send, group=self.group)
        return torch.cat(parts, dim=dim).to(t.device)


def rank_devices(backend: str, device: Union[str, torch.device, Sequence],
                 world: int, n_cards: int) -> List[torch.device]:
    """Each rank's device for ``spawn(fn, world, backend, device)`` on a
    machine with ``n_cards`` visible cards.

    ``device`` is one device or a sequence of ``world`` devices, one a
    rank.  Under NCCL a CUDA device without an index gives rank r
    ``cuda:r``; the ranks' cards must be distinct and visible.  Under gloo
    the one device is every rank's.  Raises ``ValueError`` for a placement
    the backend cannot run."""
    if isinstance(device, (list, tuple)):
        if len(device) != world:
            raise ValueError(f"{len(device)} devices given for {world} ranks")
        devs = [torch.device(d) for d in device]
    else:
        dev = torch.device(device)
        if backend == "nccl" and dev.type == "cuda" and dev.index is None:
            devs = [torch.device("cuda", r) for r in range(world)]
        else:
            devs = [dev] * world
    if backend != "nccl":
        return devs
    if any(d.type != "cuda" for d in devs):
        raise ValueError(f"NCCL takes CUDA devices, not {devs}")
    if world > n_cards:
        raise ValueError(f"{world} NCCL ranks need {world} cards, "
                         f"{n_cards} visible")
    idx = [0 if d.index is None else d.index for d in devs]
    if len(set(idx)) < world:
        raise ValueError(f"NCCL takes one rank a card: {world} ranks on "
                         f"cards {idx}")
    if max(idx) >= n_cards:
        raise ValueError(f"card {max(idx)} asked, {n_cards} visible")
    return [torch.device("cuda", i) for i in idx]


def _run_rank(rank, fn, world, backend, devices, tmp, args):
    """Body of one spawned rank: make its device current, join the group,
    mark itself started, run ``fn`` and write its result (or its
    traceback) to the run's directory."""
    torch.set_num_threads(1)
    dev = torch.device(devices[rank])
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        # under NCCL the communicator is bound to the rank's card and made
        # at once (every rank joins here)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(hours=1),
                                device_id=dev if backend == "nccl" else None)
        open(os.path.join(tmp, f"started{rank}"), "w").close()
        out = fn(Ring(), dev, *args)
        dist.barrier()
        dist.destroy_process_group()
    except BaseException:
        # the parent reads this at once: a rank whose exit waits on its
        # peers cannot delay the failure
        with open(os.path.join(tmp, f"error{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(tmp, f"result{rank}"), "wb") as f:
        pickle.dump(out, f)


def spawn(fn: Callable, world: int, backend: str, device, *args,
          timeout: float = 300.0) -> List:
    """Run ``fn(ring, device, *args)`` on ``world`` new processes and return
    the results in rank order.

    ``device`` is placed by ``rank_devices`` (NCCL: ``"cuda"`` is one card
    a rank), which raises before any process starts; ``fn`` gets its rank's
    device.  ``fn`` must be importable (a module-level function) and its
    result picklable.  ``START_TIMEOUT`` bounds the start (interpreter,
    imports, rendezvous) and ``timeout`` the run from the moment every rank
    has joined.  A rank that raises or dies stops every process and raises
    ``RuntimeError``; a run past its time stops them and raises
    ``TimeoutError``."""
    n_cards = torch.cuda.device_count() if backend == "nccl" else 0
    devices = [str(d) for d in rank_devices(backend, device, world, n_cards)]
    tmp = tempfile.mkdtemp(prefix="raptor_spmd_")
    ctx = mp.start_processes(_run_rank, nprocs=world, join=False, daemon=True,
                             args=(fn, world, backend, devices, tmp, args),
                             start_method="spawn")
    procs = ctx.processes

    def marked(kind):
        return [os.path.exists(os.path.join(tmp, f"{kind}{r}"))
                for r in range(world)]

    def raise_first_error():
        """Raise the traceback of the rank that failed first (the others'
        often only report their lost peer)."""
        paths = [os.path.join(tmp, f"error{r}") for r in range(world)]
        failed = sorted((os.stat(p).st_mtime_ns, r) for r, p in enumerate(paths)
                        if os.path.exists(p))
        if failed:
            r = failed[0][1]
            with open(paths[r]) as f:
                raise RuntimeError(f"rank {r} failed first (of ranks "
                                   f"{sorted(q for _, q in failed)}):\n"
                                   f"{f.read()}")

    try:
        started, deadline = False, time.monotonic() + START_TIMEOUT
        while True:
            try:
                if ctx.join(timeout=0.5):
                    break
            except mp.ProcessRaisedException as e:
                raise_first_error()
                raise RuntimeError(f"rank {e.error_index} failed:\n{e}") from None
            except mp.ProcessExitedException as e:
                raise_first_error()
                raise RuntimeError(f"rank {e.error_index} exited with code "
                                   f"{e.exit_code} ({e.signal_name})") from None
            raise_first_error()
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
