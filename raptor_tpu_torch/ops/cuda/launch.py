"""The one launch path of the hand-written kernels K1-K8.

Each wrapper in ``ops/cuda`` validates its tensors, packs its own C
arguments and calls ``launch_kernel``, which calls the library's entry on the
card's current stream, raises on a failed launch and counts it.  The
wrappers take CUDA tensors alone and raise ``ValueError`` on any other;
the module that owns a format (``structured/dia.py``, ``structured/dist.py``,
``core/hybrid.py``, ``parallel/dist.py``, ``core/bell.py``) sends CPU
tensors to the kernel's plain version instead.

``launches`` counts launches by kernel: "K1", "K1v1", "K2", "K3", "K4",
"K4-halo", "K5", "K6", "K6-map_cols", "K7" and "K8" (both of K8's forms).
``launches_by_shape`` counts them by the key each wrapper gives: the
kernel's name ("K8-diag" for K8's diagonal form) and its shape fields,
(n, offsets or slots, dtype name) for K1-K7 and (nb, K, b, dtype name) for
K8.  A plain version is never counted, so a run can show that its path
went through the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import functools

import torch

__all__ = ["launch_kernel", "launches", "launches_by_shape", "sm_count"]

launches: collections.Counter = collections.Counter()
launches_by_shape: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=64)
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of ``device``'s card."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def launch_kernel(entry: str, key: str, shape: tuple, device: torch.device,
                  *args) -> None:
    """Call the library's ``entry`` with ``args`` and then the current
    stream of ``device``'s card; raise ``RuntimeError`` naming the kernel
    (``shape[0]``) on a nonzero return, else count one launch under
    ``key`` and ``shape``."""
    from raptor_tpu_torch.ops.cuda.build import load_library

    fn = getattr(load_library(), entry)
    dev = device.index
    # making the card current costs 4 us of host time a call (H100
    # machine), so it is done only where another card is current
    with (contextlib.nullcontext() if dev == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        # the raw handle of the card's current stream, without building a
        # Stream object (0.17 against 4.1 us)
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
    if rc != 0:
        raise RuntimeError(f"{shape[0]} launch failed: cudaError {rc}")
    launches[key] += 1
    launches_by_shape[shape] += 1
