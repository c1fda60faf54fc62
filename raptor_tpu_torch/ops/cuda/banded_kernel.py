"""Banded paged-gather kernels K4, K5 and K6: wrappers around
``csrc/banded_kernel.cu`` and their plain PyTorch versions.

* K4 ``banded_spmv``: square SpMV over an RCM-banded ELL plan,
  ``y[i] = sum_k vals[t,k,j] * x[t*tile - Wp + pidx[t,k,j]]`` (x read as 0
  outside [0, n)).  Counterpart of
  ``raptor_tpu/ops/pallas/banded_kernel.py::banded_spmv_pallas``.
  ``banded_spmv_halo`` is the same kernel in its halo form: x is a rank's
  buffer ``[left halo | x_own | right halo]`` of ``n + 2h`` elements,
  ``h = kh * tile``, and window element ``t*tile - Wp + p`` is read at
  ``h + t*tile - Wp + p``: the TPU kernel ``_banded_call`` on the x_pad
  that ``raptor_tpu/parallel/dist.py::dist_banded_spmv`` builds.
* K6 ``banded_spmv_rect``: rectangular transfer over a window of ``npage``
  pages whose base moves with the tile in proportion to the columns.
  Counterpart of ``banded_spmv_rect_pallas``.  Given ``map_cols`` it takes
  its map_cols form (``_banded_call_rect(map_cols=...)``, the sharded
  caller's): x is a halo-extended buffer, the window base is
  ``(t * map_cols) // (T * 1024) - WpP`` and the clamp is to the buffer.
* K5 ``banded_df64_residual``: ``(rh, rl) = df64[(bh, bl) - v - A @ xh]``
  with Dekker's product error and an optional ``vals_lo * xh`` term.
  Counterpart of ``banded_df64_residual_pallas``.

A plan is the dict of ``ops/banded_plan.py`` with ``vals`` and ``pidx`` as
tensors ``(T, K, tile // 128, 128)``.  Every function visits the live slots
(non-empty ``ranges``) in slot order and rounds each product and sum on its
own, so each kernel agrees with its plain version bit for bit.  The plain
versions are vectorised over all tiles.

A wrapper given CPU tensors returns its plain version; given CUDA tensors it
launches its kernel or raises; there is no fallback.  ``launches`` counts
kernel launches (plain-version calls are not counted) under "K4", "K5",
"K6" and, for the two sharded forms, "K4-halo" and "K6-map_cols";
``launches_by_shape`` counts them by (that key, n, K, vals dtype).

K4's host-side launch plan (``banded_launch_plan``: x from a shared-memory
window or straight from device memory, threads per block, the window's
pages) is built here; ``banded_spmv_tiled_ref`` is a plain emulation of the
kernel's algorithm, block by block, for the CPU tests.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from raptor_tpu_torch.ops.banded_plan import PAGE
from raptor_tpu_torch.utils.df64 import df_add, two_prod

__all__ = ["banded_spmv", "banded_spmv_ref", "banded_spmv_halo",
           "banded_spmv_halo_ref", "banded_spmv_rect",
           "banded_spmv_rect_ref", "banded_df64_residual",
           "banded_df64_residual_ref", "banded_launch_plan",
           "banded_spmv_tiled_ref", "BandedLaunch", "live_slots", "launches",
           "launches_by_shape"]

MAX_SLOTS = 256  # RAPTOR_MAX_SLOTS in csrc/banded_kernel.cu
# K4 (csrc/banded_kernel.cu): the slots its live mask covers, rows per
# thread, the most live slots of its loop-free kernels and the looping
# kernel's slots per chunk, threads per block at most and at least,
# the shared memory a window may take on Hopper (a block's 227 KB less the
# kernel's slot list), the floats a staged window holds beyond its pages
# (the 16-byte round-down of its start)
MAX_K = 1024
K4_ROWS, K4_SINGLE_MAX, K4_LOOP_CHUNK = 4, 8, 4
K4_THREADS, K4_MIN_THREADS = 256, 128
SMEM_BYTES = 232448 - 2 * MAX_SLOTS
WINDOW_SLACK = 4
H100_SMS = 132
# K4 stages the window when each staged value is read at least this often
# (live slots x a block's rows / the window's floats).  Measured on an H100
# (scripts/bench_banded_const_ab.py): staged is faster down to 0.47 (96^3
# level 0: 20.6 against 24.8 us), direct from 0.18 down (3 slots over 17
# pages: 6.3 against 6.5 us; over 47 pages: 6.3 against 12.7)
STAGE_MIN_REUSE = 0.3

# keys "K4", "K4-halo", "K5", "K6", "K6-map_cols"
launches: collections.Counter = collections.Counter()
# keys (kernel, n, K, vals dtype name)
launches_by_shape: collections.Counter = collections.Counter()


def _count(key: str, plan: dict) -> None:
    launches[key] += 1
    launches_by_shape[(key, plan["n"], plan["K"],
                       str(plan["vals"].dtype).removeprefix("torch."))] += 1


def live_slots(plan: dict) -> list:
    """Slots whose static page range is non-empty, in slot order."""
    ranges = plan.get("ranges")
    if ranges is None:
        return list(range(plan["K"]))
    return [k for k, (lo, hi) in enumerate(ranges) if lo <= hi]


def _tiles(plan: dict, device) -> torch.Tensor:
    """(T, 1, 1) int64 tile index."""
    T = plan["n"] // plan["tile"]
    return torch.arange(T, device=device).view(T, 1, 1)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def halo_width(plan: dict) -> int:
    """h = kh * tile: the halo on each side of K4's halo-form buffer."""
    return plan["kh"] * plan["tile"]


def _window_gather(plan: dict, x: torch.Tensor, halo: bool = False):
    """Closure k -> x at slot k's window offsets, (T, R, 128).  Zero-pad
    form: 0 outside [0, n) (x padded by Wp zeros on each side).  Halo form:
    x is the buffer of ``n + 2h`` elements, and the windows start at its
    element h - Wp (every read lies inside it)."""
    Wp = plan["Wp"]
    if halo:
        xp = x[halo_width(plan) - Wp:]
    else:
        xp = torch.cat([x.new_zeros(Wp), x, x.new_zeros(Wp)])
    base = _tiles(plan, x.device) * plan["tile"]
    return lambda k: xp[base + plan["pidx"][:, k]]


def _banded_sum(plan: dict, gather, x: torch.Tensor) -> torch.Tensor:
    T, _, R, L = plan["vals"].shape
    y = torch.zeros((T, R, L), dtype=x.dtype, device=x.device)
    for k in live_slots(plan):
        y = y + plan["vals"][:, k] * gather(k)
    return y.reshape(-1)


def banded_spmv_ref(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: y = sum over live slots of ``vals * x_window``
    in slot order (a bf16 value widens to fp32 in the multiply)."""
    return _banded_sum(plan, _window_gather(plan, x), x)


def banded_spmv_halo_ref(plan: dict, x_pad: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's halo form: ``x_pad`` is
    ``[left halo | x_own | right halo]`` with ``h = kh * tile`` values on
    each side (``banded_ref_padded`` of the reference)."""
    return _banded_sum(plan, _window_gather(plan, x_pad, halo=True), x_pad)


def banded_spmv_rect_ref(plan: dict, x: torch.Tensor,
                         map_cols: Optional[int] = None) -> torch.Tensor:
    """Plain version of K6: window page p of tile t is
    ``clamp((t * map_cols) // (T * 1024) - WpP + p, 0, len(x) / 1024 - 1)``.
    n_cols form (``map_cols`` None): map_cols is ``n_cols`` and x has that
    length.  map_cols form: x is a halo-extended buffer (the reference's
    ``banded_rect_ref_buf`` with the plan's WpP, which its caller sets to
    0)."""
    n, tile = plan["n"], plan["tile"]
    if map_cols is None:
        map_cols = plan["n_cols"]
    T = n // tile
    base = (_tiles(plan, x.device) * map_cols) // (T * PAGE) - plan["WpP"]
    last = x.shape[0] // PAGE - 1
    _, _, R, L = plan["vals"].shape
    y = torch.zeros((T, R, L), dtype=x.dtype, device=x.device)
    for k in live_slots(plan):
        p = plan["pidx"][:, k].long()
        page = torch.clamp(base + (p >> 10), 0, last)
        y = y + plan["vals"][:, k] * x[page * PAGE + (p & (PAGE - 1))]
    return y.reshape(-1)


def banded_df64_residual_ref(plan: dict, vals_lo, xh, bh, bl, v):
    """Plain version of K5: the error-free sequence of
    ``banded_kernel.py:432-452`` per row, slot by slot."""
    gather = _window_gather(plan, xh)
    T, _, R, L = plan["vals"].shape
    sh, se = df_add(bh.view(T, R, L), bl.view(T, R, L), -v.view(T, R, L),
                    torch.zeros((T, R, L), dtype=v.dtype, device=v.device))
    for k in live_slots(plan):
        gh = gather(k)
        ph, pe = two_prod(plan["vals"][:, k], gh)
        if vals_lo is not None:
            pe = pe + vals_lo[:, k] * gh
        sh, se = df_add(sh, se, -ph, -pe)
    return sh.reshape(-1), se.reshape(-1)


# ---------------------------------------------------------------------------
# K4: the launch plan and a plain emulation of the kernel's algorithm
# ---------------------------------------------------------------------------

class BandedLaunch(NamedTuple):
    """K4's launch plan for one banded plan."""
    staged: bool      # x from a shared-memory window (else from device memory)
    rows: int         # consecutive rows per thread
    threads: int      # threads per block: a block covers rows * threads rows
    split: int        # blocks per tile
    page0: int        # the staged window: pages [page0, page0 + pages) of
    pages: int        # the tile's window (what the live slots' ranges touch)
    smem_bytes: int   # the window's shared memory, 0 when not staged


def _live_pages(plan: dict) -> tuple:
    """(page0, pages): the pages of a tile's window that the live slots'
    ranges touch; the whole window where the plan keeps no ranges."""
    npage = (plan["tile"] + 2 * plan["Wp"]) // PAGE
    ranges = plan.get("ranges")
    if ranges is None:
        return 0, npage
    live = [(lo, hi) for lo, hi in ranges if lo <= hi]
    if not live:
        return 0, 1
    lo, hi = min(r[0] for r in live), max(r[1] for r in live)
    if lo < 0 or hi >= npage:
        raise ValueError(f"slot ranges {lo}..{hi} outside the window's "
                         f"{npage} pages")
    return lo, hi - lo + 1


def banded_launch_plan(plan: dict, n_sm: int = H100_SMS,
                       staged: Optional[bool] = None,
                       threads: Optional[int] = None) -> BandedLaunch:
    """The host-side launch plan of K4 for a square banded plan.

    A thread takes ``K4_ROWS`` consecutive rows, a block of 256 threads a
    page of 1024 rows; a level with fewer such blocks than SMs takes 128
    threads a block, so that it spreads further over the card (a block is
    then half a page and, when staged, copies the whole window all the
    same; smaller blocks measured slower).  x is staged in shared memory
    when every staged value is read at least ``STAGE_MIN_REUSE`` times
    (live slots x the block's rows over the window's floats) and the window
    fits a block's shared memory; ``staged`` given forces the choice, and a
    forced window that does not fit raises.  ``threads`` given (32, 64, 128
    or 256) forces the block size."""
    n, tile = plan["n"], plan["tile"]
    if n % tile or tile % PAGE or n < 1:
        raise ValueError(f"K4: n={n}, tile={tile} out of range")
    if threads is None:
        threads = K4_THREADS
        while threads > K4_MIN_THREADS and n // (threads * K4_ROWS) < n_sm:
            threads //= 2
    elif threads not in (32, 64, 128, 256):
        raise ValueError(f"K4: {threads} threads a block: 32, 64, 128 or 256")
    page0, pages = _live_pages(plan)
    smem = 4 * (pages * PAGE + WINDOW_SLACK)
    if staged is None:
        reuse = len(live_slots(plan)) * threads * K4_ROWS / (pages * PAGE)
        staged = reuse >= STAGE_MIN_REUSE and smem <= SMEM_BYTES
    elif staged and smem > SMEM_BYTES:
        raise ValueError(f"K4: a window of {pages} pages needs {smem} bytes "
                         f"of shared memory (max {SMEM_BYTES})")
    if not staged:
        return BandedLaunch(False, K4_ROWS, threads,
                            tile // (threads * K4_ROWS), 0, 0, 0)
    return BandedLaunch(True, K4_ROWS, threads, tile // (threads * K4_ROWS),
                        page0, pages, smem)


def banded_spmv_tiled_ref(plan: dict, x: torch.Tensor,
                          launch: Optional[BandedLaunch] = None,
                          x_misalign: int = 0,
                          halo: bool = False) -> torch.Tensor:
    """Plain emulation of K4 (``csrc/banded_kernel.cu``), block by block.

    x holds ``x_len`` floats and row 0's x sits at ``x_off``: the vector
    itself (0, n) or, with ``halo``, the halo-form buffer (h, n + 2h).
    Staged: the block's window, pages ``[page0, page0 + pages)`` of its
    tile's, is copied from the 16-byte boundary of x at or below its start
    (``x_misalign``: x's start, in elements past such a boundary), zeros
    outside [0, x_len), and ``pidx`` indexes that copy.  Direct: x is read
    at the index clamped into [0, x_len) and a select gives 0 outside.
    Either way each thread's ``rows`` rows sum ``f32(vals) * x`` over the
    live slots in slot order, a chunk of slots at a time (all of them up to
    ``K4_SINGLE_MAX``, else ``K4_LOOP_CHUNK``)."""
    if launch is None:
        launch = banded_launch_plan(plan)
    n, K, tile, Wp = plan["n"], plan["K"], plan["tile"], plan["Wp"]
    x_off = halo_width(plan) if halo else 0
    x_len = x.shape[0]
    live = live_slots(plan)
    vals = plan["vals"].reshape(n // tile, K, tile)
    pidx = plan["pidx"].reshape(n // tile, K, tile).long()
    rows_blk = launch.rows * launch.threads
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    for row0 in range(0, n, rows_blk):
        t, j = divmod(row0, tile)
        xbase = x_off + t * tile - Wp
        if launch.staged:
            j0 = xbase + launch.page0 * PAGE
            rem = (x_misalign + j0) % 4
            a0, width = j0 - rem, launch.pages * PAGE + WINDOW_SLACK
            if launch.smem_bytes < 4 * width:
                raise ValueError("the launch plan's shared memory does not "
                                 "hold its window")
            win = x.new_zeros(width)
            lo, hi = max(a0, 0), min(a0 + width, x_len)
            if lo < hi:
                win[lo - a0:hi - a0] = x[lo:hi]
            wbase = launch.page0 * PAGE - rem

            def gather(p):
                return win[p - wbase]
        else:
            def gather(p):
                xi = xbase + p
                ok = (xi >= 0) & (xi < x_len)
                return torch.where(ok, x[torch.where(ok, xi, 0)], 0.0)
        acc = torch.zeros(rows_blk, dtype=x.dtype, device=x.device)
        step = K4_SINGLE_MAX if len(live) <= K4_SINGLE_MAX else K4_LOOP_CHUNK
        for s0 in range(0, len(live), step):
            chunk = live[s0:s0 + step]
            g = [gather(pidx[t, k, j:j + rows_blk]) for k in chunk]
            for k, gk in zip(chunk, g):
                acc = acc + vals[t, k, j:j + rows_blk] * gk
        y[row0:row0 + rows_blk] = acc
    return y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_plan(plan: dict, dev, name: str, *, rect: bool = False) -> list:
    """Validate a plan's tensors for a launch; returns its live slots."""
    vals, pidx = plan["vals"], plan["pidx"]
    K, n, tile = plan["K"], plan["n"], plan["tile"]
    T = n // tile
    for what, t in (("vals", vals), ("pidx", pidx)):
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, x on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    if pidx.dtype != torch.int32:
        raise ValueError(f"{name}: pidx dtype {pidx.dtype}, expected int32")
    shape = (T, K, tile // 128, 128)
    if tuple(vals.shape) != shape or tuple(pidx.shape) != shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, pidx "
                         f"{tuple(pidx.shape)}: expected {shape}")
    if n % tile or tile % PAGE or not 0 < K * n < 2**31:
        raise ValueError(f"{name}: n={n}, tile={tile}, K={K} out of range")
    if rect and (plan["n_cols"] % PAGE or not 0 < plan["n_cols"] < 2**31):
        raise ValueError(f"{name}: n_cols={plan['n_cols']} not a positive "
                         f"multiple of {PAGE}")
    live = live_slots(plan)
    if len(live) > MAX_SLOTS:
        raise ValueError(f"{name}: {len(live)} live slots (max {MAX_SLOTS})")
    return live


def _check_vec(v: torch.Tensor, n: int, name: str, what: str = "x"):
    if not v.is_cuda:
        raise ValueError(f"{name}: {what} on {v.device}, expected a CUDA tensor")
    if v.dtype != torch.float32:
        raise ValueError(f"{name}: {what} dtype {v.dtype}: the kernels take "
                         f"float32 vectors")
    if tuple(v.shape) != (n,):
        raise ValueError(f"{name}: {what} shape {tuple(v.shape)}: expected ({n},)")
    if not v.is_contiguous():
        raise ValueError(f"{name}: {what} must be contiguous")


def _slots(live) -> ctypes.Array:
    return (ctypes.c_int * max(len(live), 1))(*live)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _lib():
    from raptor_tpu_torch.ops.cuda.build import load_library

    return load_library()


@functools.lru_cache(maxsize=64)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _live_mask(live) -> ctypes.Array:
    """The live slots as the kernel's bit mask: bit k of word k // 32."""
    words = [0] * (MAX_K // 32)
    for k in live:
        words[k >> 5] |= 1 << (k & 31)
    return (ctypes.c_uint32 * len(words))(*words)


@functools.lru_cache(maxsize=256)
def _default_launch(ranges, n: int, K: int, tile: int, Wp: int,
                    n_sm: int) -> BandedLaunch:
    return banded_launch_plan(dict(ranges=ranges, n=n, K=K, tile=tile, Wp=Wp),
                              n_sm)


def _launch_k4(plan: dict, x: torch.Tensor, launch: Optional[BandedLaunch] = None,
               halo: bool = False) -> torch.Tensor:
    """K4 on CUDA tensors with ``launch`` (default: ``banded_launch_plan``
    for x's card), in its zero-pad form or, with ``halo``, its halo form
    (x the ``n + 2h`` buffer); raises on what the kernel does not take."""
    vals = plan["vals"]
    n, K = plan["n"], plan["K"]
    name = "K4-halo" if halo else "K4"
    x_off = halo_width(plan) if halo else 0
    _check_vec(x, n + 2 * x_off, name)
    live = _check_plan(plan, x.device, name)
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: vals dtype {vals.dtype}: float32 or bfloat16")
    if K > MAX_K:
        raise ValueError(f"{name}: K={K} slots (max {MAX_K})")
    if halo and x_off < plan["Wp"]:
        raise ValueError(f"{name}: halo {x_off} narrower than Wp={plan['Wp']}")
    if vals.data_ptr() % 16 or plan["pidx"].data_ptr() % 16:
        raise ValueError(f"{name}: vals and pidx must be 16-byte aligned")
    if launch is None:
        ranges = plan.get("ranges")
        launch = _default_launch(None if ranges is None else tuple(ranges), n,
                                 K, plan["tile"], plan["Wp"], _n_sm(x.device))
    if (launch.rows != K4_ROWS or launch.split * launch.threads * launch.rows
            != plan["tile"]):
        raise ValueError(f"{name}: launch plan {launch} does not tile "
                         f"{plan['tile']} rows")
    lib = _lib()
    fn = lib.raptor_banded_bf16 if vals.dtype == torch.bfloat16 else lib.raptor_banded_f32
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
                y.data_ptr(), n, K, plan["tile"], plan["Wp"], x_off,
                x.shape[0], _live_mask(live), len(live), int(launch.staged),
                launch.threads, launch.page0, launch.pages, _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    _count(name, plan)
    return y


def banded_spmv(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """K4: y = A @ x over a square banded plan; x fp32 (n,), vals fp32 or
    bf16."""
    if x.device.type == "cpu" and plan["vals"].device.type == "cpu":
        return banded_spmv_ref(plan, x)
    return _launch_k4(plan, x)


def banded_spmv_halo(plan: dict, x_pad: torch.Tensor) -> torch.Tensor:
    """K4 in its halo form: y = A_own @ x over a rank's tile block of a
    square banded plan; x_pad fp32 ``(n + 2 * kh * tile,)``, the rank's
    ``[left halo | x_own | right halo]``."""
    if x_pad.device.type == "cpu" and plan["vals"].device.type == "cpu":
        return banded_spmv_halo_ref(plan, x_pad)
    return _launch_k4(plan, x_pad, halo=True)


def banded_spmv_rect(plan: dict, x: torch.Tensor,
                     map_cols: Optional[int] = None) -> torch.Tensor:
    """K6: y = B @ x over a rectangular banded plan.  n_cols form: x fp32
    ``(n_cols,)``.  map_cols form (``map_cols`` given): x fp32 is a
    halo-extended buffer of whole pages and ``map_cols`` the numerator of
    the window index map."""
    vals = plan["vals"]
    if x.device.type == "cpu" and vals.device.type == "cpu":
        return banded_spmv_rect_ref(plan, x, map_cols)
    name = "K6" if map_cols is None else "K6-map_cols"
    if map_cols is None:
        _check_vec(x, plan["n_cols"], name)
        map_cols = plan["n_cols"]
    else:
        _check_vec(x, x.shape[0], name)
        if x.shape[0] % PAGE or x.shape[0] < PAGE or not 0 <= map_cols < 2**40:
            raise ValueError(f"{name}: buffer of {x.shape[0]} (a positive "
                             f"multiple of {PAGE}), map_cols={map_cols}")
    live = _check_plan(plan, x.device, name, rect=True)
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: vals dtype {vals.dtype}: float32 or bfloat16")
    lib = _lib()
    fn = (lib.raptor_banded_rect_bf16 if vals.dtype == torch.bfloat16
          else lib.raptor_banded_rect_f32)
    y = torch.empty(plan["n"], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
                y.data_ptr(), plan["n"], plan["K"], plan["tile"],
                x.shape[0], map_cols, plan["WpP"], _slots(live), len(live),
                _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    _count(name, plan)
    return y


def banded_df64_residual(plan: dict, vals_lo, xh, bh, bl, v):
    """K5: (rh, rl) = df64[(bh, bl) - v - A @ xh] over a square banded plan
    with fp32 vals; ``vals_lo``: optional fp32 truncation remainder of the
    operator in the plan's blocked layout."""
    vals = plan["vals"]
    if xh.device.type == "cpu" and vals.device.type == "cpu":
        return banded_df64_residual_ref(plan, vals_lo, xh, bh, bl, v)
    n = plan["n"]
    for what, t in (("xh", xh), ("bh", bh), ("bl", bl), ("v", v)):
        _check_vec(t, n, "K5", what)
        if t.device != xh.device:
            raise ValueError(f"K5: {what} on {t.device}, xh on {xh.device}")
    live = _check_plan(plan, xh.device, "K5")
    if vals.dtype != torch.float32:
        raise ValueError(f"K5: vals dtype {vals.dtype}: the df64 residual "
                         f"takes float32")
    lo_ptr = None
    if vals_lo is not None:
        if (vals_lo.device != xh.device or vals_lo.dtype != torch.float32
                or vals_lo.shape != vals.shape or not vals_lo.is_contiguous()):
            raise ValueError(f"K5: vals_lo {tuple(vals_lo.shape)} "
                             f"{vals_lo.dtype} on {vals_lo.device}: expected "
                             f"contiguous float32 {tuple(vals.shape)}")
        lo_ptr = vals_lo.data_ptr()
    rh = torch.empty_like(xh)
    rl = torch.empty_like(xh)
    with torch.cuda.device(xh.device):
        rc = _lib().raptor_banded_df64_f32(
            vals.data_ptr(), lo_ptr, plan["pidx"].data_ptr(), xh.data_ptr(),
            bh.data_ptr(), bl.data_ptr(), v.data_ptr(), rh.data_ptr(),
            rl.data_ptr(), n, plan["K"], plan["tile"], plan["Wp"],
            _slots(live), len(live), _stream(xh.device))
    if rc != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {rc}")
    _count("K5", plan)
    return rh, rl
