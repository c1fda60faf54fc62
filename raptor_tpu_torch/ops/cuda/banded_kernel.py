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

The wrappers take CUDA tensors alone and launch their kernel or raise;
there is no fallback.  The callers route: ``core/hybrid.py`` and
``parallel/dist.py`` send CPU tensors to the plain versions.  Each launch
goes through ``ops/cuda/launch.py``, which counts it under "K4", "K5",
"K6" or, for the two sharded forms, "K4-halo" and "K6-map_cols", and by
(that key, n, K, vals dtype); each launch is a span of that name
(``utils/profiling.py``).

The three kernels share K4's design and its host-side launch plan
(``banded_launch_plan``: x from a shared-memory window or straight from
device memory, threads per block, the window's pages), built here for a
square plan (K4, K5) or a rectangular one (K6).  ``banded_spmv_tiled_ref``,
``banded_spmv_rect_tiled_ref`` and ``banded_df64_residual_tiled_ref`` are
plain emulations of the kernels' algorithms, block by block, for the CPU
tests.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from raptor_tpu_torch.ops.banded_plan import PAGE
from raptor_tpu_torch.ops.cuda.launch import launch_kernel, sm_count
from raptor_tpu_torch.utils.df64 import df_add, two_prod
from raptor_tpu_torch.utils.profiling import phase

__all__ = ["banded_spmv", "banded_spmv_ref", "banded_spmv_halo",
           "banded_spmv_halo_ref", "banded_spmv_rect",
           "banded_spmv_rect_ref", "banded_df64_residual",
           "banded_df64_residual_ref", "banded_launch_plan",
           "banded_spmv_tiled_ref", "banded_spmv_rect_tiled_ref",
           "banded_df64_residual_tiled_ref", "BandedLaunch", "live_slots"]

MAX_SLOTS = 1024  # RAPTOR_MAX_SLOTS in csrc/banded_kernel.cu
# K4, K5 and K6 (csrc/banded_kernel.cu): the slots a live mask covers,
# rows per thread, the most live slots of the loop-free kernels and the
# looping kernels' slots per chunk, threads per block at most and at least,
# the shared memory a window may take on Hopper (a block's 227 KB less the
# kernel's slot list), the floats a staged square window holds beyond its
# pages (the 16-byte round-down of its start), and the floats K6's staged
# window gives each page (RAPTOR_WPAGE: a page and its round-down)
MAX_K = 1024
K4_ROWS, K4_SINGLE_MAX, K4_LOOP_CHUNK = 4, 8, 4
K4_THREADS, K4_MIN_THREADS = 256, 128
SMEM_BYTES = 232448 - 2 * MAX_SLOTS
WINDOW_SLACK = 4
RECT_PAGE_FLOATS = PAGE + WINDOW_SLACK
H100_SMS = 132
# The kernels stage the window when each staged value is read at least this
# often (live slots x a block's rows / the window's floats).  Measured for
# K4 on an H100 (many calls a CUDA graph): staged is faster down
# to 0.47 (96^3 level 0: 20.6 against 24.8 us), direct from 0.18 down (3
# slots over 17 pages: 6.3 against 6.5 us; over 47 pages: 6.3 against
# 12.7).
STAGE_MIN_REUSE = 0.3
# K6 stages its window only where a staged value is read this often: with
# four consecutive rows a thread, the staged variant lost to the direct one
# at every path shape read less than 1.7 times (96^3 level 0 R, 0.30: 17.3
# against 11.2 us; 48^3 level 1 R, 0.63: 6.0 against 5.2) and won from 1.7
# up (48^3 level 2 R: 5.2 against 5.5; 96^3 level 3 P, 3.5: 2.6 against
# 2.8; H100, many calls a CUDA graph).  Its windows are wide for
# the rows a block covers (an R block reads two pages of x a tile, its
# window spans up to 39).
RECT_STAGE_MIN_REUSE = 1.5
# K6 gives a thread four rows 32 apart, so that a warp's gather covers 32
# consecutive rows, whose x lies close (few L1 sectors direct, few
# shared-memory bank conflicts staged: four consecutive rows put a warp's
# R reads 8 floats apart, on 4 of the 32 banks), at the price of 4-byte
# plan loads; on a level of at least RECT_CONSECUTIVE_BLOCKS blocks of
# 1024 rows an SM, bound by its plan's bytes, the rows are consecutive and
# the plan loads 16 bytes.  Measured on an H100 (many calls a CUDA
# graph), 32 apart against consecutive, direct: 96^3
# level 0 R 10.2 against 13.5 us, level 1 P 8.1 against 11.7, 48^3 level 0
# P 3.72 against 3.75; but 96^3 level 0 P (6.5 blocks an SM) 21.5 against
# 20.5
RECT_CONSECUTIVE_BLOCKS = 4


def _shape(key: str, plan: dict) -> tuple:
    """The launch's shape key: (kernel, n, K, vals dtype name)."""
    return (key, plan["n"], plan["K"],
            str(plan["vals"].dtype).removeprefix("torch."))


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
# the launch plan and plain emulations of the kernels' algorithms
# ---------------------------------------------------------------------------

class BandedLaunch(NamedTuple):
    """The launch plan of K4, K5 or K6 for one banded plan."""
    staged: bool      # x from a shared-memory window (else from device memory)
    rows: int         # rows per thread (K6 on levels of many slots: 1)
    threads: int      # threads per block: a block covers rows * threads rows
    split: int        # blocks per tile
    page0: int        # the staged window: pages [page0, page0 + pages) of
    pages: int        # the tile's window (what the live slots' ranges touch)
    smem_bytes: int   # the window's shared memory, 0 when not staged
    stride: int = 1   # K6: a thread's rows lie 1 (consecutive) or 32 apart


def _is_rect(plan: dict) -> bool:
    return "n_cols" in plan


def _window_pages(plan: dict) -> int:
    """A tile's x window in pages: the rectangular plan's ``npage``, the
    square one's (tile + 2 Wp) / 1024."""
    if _is_rect(plan):
        return plan["npage"]
    return (plan["tile"] + 2 * plan["Wp"]) // PAGE


def _window_bytes(plan: dict, pages: int) -> int:
    """Shared memory of a staged window of ``pages`` pages: the square
    window in one piece from its 16-byte round-down, the rectangular one
    page by page, ``RECT_PAGE_FLOATS`` apart (its pages need not be
    contiguous in x)."""
    if _is_rect(plan):
        return 4 * pages * RECT_PAGE_FLOATS
    return 4 * (pages * PAGE + WINDOW_SLACK)


def _live_pages(plan: dict) -> tuple:
    """(page0, pages): the pages of a tile's window that the live slots'
    ranges touch; the whole window where the plan keeps no ranges."""
    npage = _window_pages(plan)
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
                       threads: Optional[int] = None,
                       stride: Optional[int] = None,
                       rows: Optional[int] = None) -> BandedLaunch:
    """The host-side launch plan of K4 or K5 for a square banded plan, or
    of K6 for a rectangular one (a plan with ``n_cols``).

    A thread takes ``K4_ROWS`` consecutive rows, a block of 256 threads a
    page of 1024 rows; a level with fewer such blocks than SMs takes 128
    threads a block, so that it spreads further over the card (a block is
    then half a page and, when staged, copies the whole window all the
    same; smaller blocks measured slower).  x is staged in shared memory
    when every staged value is read at least ``STAGE_MIN_REUSE`` times
    (K6: ``RECT_STAGE_MIN_REUSE``; live slots x the block's rows over the
    window's floats) and the window fits a block's shared memory;
    ``staged`` given forces the choice, and a forced window that does not
    fit raises.  ``threads`` given (32, 64, 128
    or 256) forces the block size.  The window is the tile's: ``tile + 2
    Wp`` elements of a square plan, ``npage`` pages of a rectangular one.
    ``stride``: K6's thread rows lie 1 or 32 apart (32 unless the level has
    ``RECT_CONSECUTIVE_BLOCKS`` blocks of 1024 rows an SM); K4's and K5's
    are consecutive.  ``rows``: K6 gives a thread one row, direct, on a
    level of more than ``K4_SINGLE_MAX`` live slots unless staging is
    forced; four everywhere else."""
    n, tile = plan["n"], plan["tile"]
    if n % tile or tile % PAGE or n < 1:
        raise ValueError(f"K4: n={n}, tile={tile} out of range")
    if threads is not None and threads not in (32, 64, 128, 256):
        raise ValueError(f"K4: {threads} threads a block: 32, 64, 128 or 256")
    if rows is None:
        rows = (1 if _is_rect(plan) and staged is not True
                and len(live_slots(plan)) > K4_SINGLE_MAX else K4_ROWS)
    elif rows not in ((1, K4_ROWS) if _is_rect(plan) else (K4_ROWS,)):
        raise ValueError(f"{rows} rows a thread: K6 takes 1 or 4, K4 and K5 4")
    if rows == 1:
        if staged:
            raise ValueError("K6 with one row a thread reads x direct")
        threads = threads or K4_THREADS
        return BandedLaunch(False, 1, threads, tile // threads, 0, 0, 0, 1)
    if stride is None:
        stride = (32 if _is_rect(plan) and n < RECT_CONSECUTIVE_BLOCKS * n_sm
                  * PAGE else 1)
    elif stride not in ((1, 32) if _is_rect(plan) else (1,)):
        raise ValueError(f"rows {stride} apart: K6 takes 1 or 32, K4 and K5 1")
    if threads is None:
        threads = K4_THREADS
        while threads > K4_MIN_THREADS and n // (threads * K4_ROWS) < n_sm:
            threads //= 2
    page0, pages = _live_pages(plan)
    smem = _window_bytes(plan, pages)
    if staged is None:
        reuse = len(live_slots(plan)) * threads * K4_ROWS / (pages * PAGE)
        staged = (reuse >= (RECT_STAGE_MIN_REUSE if _is_rect(plan)
                            else STAGE_MIN_REUSE) and smem <= SMEM_BYTES)
    elif staged and smem > SMEM_BYTES:
        raise ValueError(f"K4: a window of {pages} pages needs {smem} bytes "
                         f"of shared memory (max {SMEM_BYTES})")
    if not staged:
        return BandedLaunch(False, K4_ROWS, threads,
                            tile // (threads * K4_ROWS), 0, 0, 0, stride)
    return BandedLaunch(True, K4_ROWS, threads, tile // (threads * K4_ROWS),
                        page0, pages, smem, stride)


def _chunks(live: list) -> list:
    """The live slots in the kernels' chunks: all of them up to
    ``K4_SINGLE_MAX``, else ``K4_LOOP_CHUNK`` at a time."""
    step = K4_SINGLE_MAX if len(live) <= K4_SINGLE_MAX else K4_LOOP_CHUNK
    return [live[s:s + step] for s in range(0, len(live), step)]


def _checked(win: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """win[idx], refusing an index outside the staged window (a negative
    one would wrap around)."""
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= win.numel()):
        raise IndexError("a read outside the staged window")
    return win[idx]


def _square_gather(plan: dict, x: torch.Tensor, launch: BandedLaunch,
                   x_off: int, x_misalign: int):
    """Closure t -> (p -> x at window offset p of tile t) of K4's and K5's
    square window.  Staged: the block's window, pages ``[page0, page0 +
    pages)`` of its tile's, is copied from the 16-byte boundary of x at or
    below its start (``x_misalign``: x's start, in elements past such a
    boundary), zeros outside [0, x_len), and ``pidx`` indexes that copy.
    Direct: x is read at the index clamped into [0, x_len) and a select
    gives 0 outside."""
    tile, Wp = plan["tile"], plan["Wp"]
    x_len = x.shape[0]

    def gather_of(t):
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
            return lambda p: _checked(win, p - wbase)

        def gather(p):
            xi = xbase + p
            ok = (xi >= 0) & (xi < x_len)
            return torch.where(ok, x[torch.where(ok, xi, 0)], 0.0)
        return gather
    return gather_of


def _rect_gather(plan: dict, x: torch.Tensor, launch: BandedLaunch,
                 map_cols: int, x_misalign: int):
    """Closure t -> (p -> x at window offset p of tile t) of K6's window,
    whose page w is x's page ``clamp(base_t + w, 0, last)``.  Staged: each
    window page of ``[page0, page0 + pages)`` copied on its own from the
    16-byte boundary at or below its clamped page's start,
    ``RECT_PAGE_FLOATS`` apart, zeros outside [0, x_len) (never read);
    ``p`` reads ``p + 4 * (p >> 10)`` of that copy.  Direct: x at the
    clamped page."""
    n, tile = plan["n"], plan["tile"]
    T, x_len = n // tile, x.shape[0]
    last = x_len // PAGE - 1
    rem = x_misalign % 4

    def gather_of(t):
        base = (t * map_cols) // (T * PAGE) - plan["WpP"]
        if not launch.staged:
            return lambda p: x[torch.clamp(base + (p >> 10), 0, last) * PAGE
                               + (p & (PAGE - 1))]
        width = launch.pages * RECT_PAGE_FLOATS
        if launch.smem_bytes < 4 * width:
            raise ValueError("the launch plan's shared memory does not "
                             "hold its window")
        win = x.new_zeros(width)
        for w in range(launch.pages):
            a0 = min(max(base + launch.page0 + w, 0), last) * PAGE - rem
            lo, hi = max(a0, 0), min(a0 + RECT_PAGE_FLOATS, x_len)
            at = w * RECT_PAGE_FLOATS - a0
            win[lo + at:hi + at] = x[lo:hi]
        wbase = launch.page0 * RECT_PAGE_FLOATS - rem
        return lambda p: _checked(win, p + 4 * (p >> 10) - wbase)
    return gather_of


def _tiled_sum(plan: dict, x: torch.Tensor, launch: BandedLaunch,
               gather_of) -> torch.Tensor:
    """y block by block: each thread's ``rows`` rows sum ``f32(vals) * x``
    over the live slots in slot order, a chunk of slots at a time, with x
    read by the block's tile's ``gather_of(t)``."""
    n, K, tile = plan["n"], plan["K"], plan["tile"]
    vals = plan["vals"].reshape(n // tile, K, tile)
    pidx = plan["pidx"].reshape(n // tile, K, tile).long()
    rows_blk = launch.rows * launch.threads
    chunks = _chunks(live_slots(plan))
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    for row0 in range(0, n, rows_blk):
        t, j = divmod(row0, tile)
        gather = gather_of(t)
        rows = slice(j, j + rows_blk)
        acc = torch.zeros(rows_blk, dtype=x.dtype, device=x.device)
        for chunk in chunks:
            g = [gather(pidx[t, k, rows]) for k in chunk]
            for k, gk in zip(chunk, g):
                acc = acc + vals[t, k, rows] * gk
        y[row0:row0 + rows_blk] = acc
    return y


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
    x_off = halo_width(plan) if halo else 0
    return _tiled_sum(plan, x, launch,
                      _square_gather(plan, x, launch, x_off, x_misalign))


def banded_spmv_rect_tiled_ref(plan: dict, x: torch.Tensor,
                               launch: Optional[BandedLaunch] = None,
                               map_cols: Optional[int] = None,
                               x_misalign: int = 0) -> torch.Tensor:
    """Plain emulation of K6 (``csrc/banded_kernel.cu``), block by block,
    in either form (``map_cols`` as in ``banded_spmv_rect``).  Staged: the
    block's window pages ``[page0, page0 + pages)``, each clamped into x
    on its own and copied from the 16-byte boundary at or below its start
    (``x_misalign`` as in ``banded_spmv_tiled_ref``), ``RECT_PAGE_FLOATS``
    apart; direct: x at the clamped page.  Four rows a thread sum over the
    live slots in slot order, a chunk at a time."""
    if launch is None:
        launch = banded_launch_plan(plan)
    if map_cols is None:
        map_cols = plan["n_cols"]
    return _tiled_sum(plan, x, launch,
                      _rect_gather(plan, x, launch, map_cols, x_misalign))


def banded_df64_residual_tiled_ref(plan: dict, vals_lo, xh, bh, bl, v,
                                   launch: Optional[BandedLaunch] = None,
                                   x_misalign: int = 0):
    """Plain emulation of K5 (``csrc/banded_kernel.cu``), block by block:
    K4's square window over xh (staged or direct, ``x_misalign`` as in
    ``banded_spmv_tiled_ref``), and for each thread's rows the error-free
    sequence of ``banded_df64_residual_ref``, (sh, se) from (bh, bl, -v)
    and then one compensated term per live slot, in slot order, a chunk at
    a time."""
    if launch is None:
        launch = banded_launch_plan(plan)
    n, K, tile = plan["n"], plan["K"], plan["tile"]
    vals = plan["vals"].reshape(n // tile, K, tile)
    lo = None if vals_lo is None else vals_lo.reshape(n // tile, K, tile)
    pidx = plan["pidx"].reshape(n // tile, K, tile).long()
    gather_of = _square_gather(plan, xh, launch, 0, x_misalign)
    rows_blk = launch.rows * launch.threads
    chunks = _chunks(live_slots(plan))
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    for row0 in range(0, n, rows_blk):
        t, j = divmod(row0, tile)
        gather = gather_of(t)
        rows, out = slice(j, j + rows_blk), slice(row0, row0 + rows_blk)
        sh, se = df_add(bh[out], bl[out], -v[out], torch.zeros_like(v[out]))
        for chunk in chunks:
            g = [gather(pidx[t, k, rows]) for k in chunk]
            for k, gh in zip(chunk, g):
                ph, pe = two_prod(vals[t, k, rows], gh)
                if lo is not None:
                    pe = pe + lo[t, k, rows] * gh
                sh, se = df_add(sh, se, -ph, -pe)
        rh[out], rl[out] = sh, se
    return rh, rl


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_plan(plan: dict, dev, name: str, dtypes=(torch.float32,
                                                  torch.bfloat16)) -> list:
    """Validate a plan's tensors for a launch (on ``dev``, contiguous,
    16-byte aligned, shapes, vals of ``dtypes``); returns its live
    slots."""
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
    if vals.dtype not in dtypes:
        raise ValueError(f"{name}: vals dtype {vals.dtype}: " + " or ".join(
            str(d).removeprefix("torch.") for d in dtypes))
    shape = (T, K, tile // 128, 128)
    if tuple(vals.shape) != shape or tuple(pidx.shape) != shape:
        raise ValueError(f"{name}: vals {tuple(vals.shape)}, pidx "
                         f"{tuple(pidx.shape)}: expected {shape}")
    if n % tile or tile % PAGE or not 0 < K * n < 2**31:
        raise ValueError(f"{name}: n={n}, tile={tile}, K={K} out of range")
    if _is_rect(plan) and (plan["n_cols"] % PAGE
                           or not 0 < plan["n_cols"] < 2**31):
        raise ValueError(f"{name}: n_cols={plan['n_cols']} not a positive "
                         f"multiple of {PAGE}")
    if K > MAX_K:
        raise ValueError(f"{name}: K={K} slots (max {MAX_K})")
    if vals.data_ptr() % 16 or pidx.data_ptr() % 16:
        raise ValueError(f"{name}: vals and pidx must be 16-byte aligned")
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


def _suffix(vals: torch.Tensor) -> str:
    """The entry points' suffix for ``vals``' dtype."""
    return "bf16" if vals.dtype == torch.bfloat16 else "f32"


def _live_mask(live) -> ctypes.Array:
    """The live slots as the kernel's bit mask: bit k of word k // 32."""
    words = [0] * (MAX_K // 32)
    for k in live:
        words[k >> 5] |= 1 << (k & 31)
    return (ctypes.c_uint32 * len(words))(*words)


@functools.lru_cache(maxsize=256)
def _default_launch(ranges, n: int, K: int, tile: int, window: int,
                    rect: bool, n_sm: int) -> BandedLaunch:
    shape = dict(ranges=ranges, n=n, K=K, tile=tile)
    shape.update(dict(n_cols=None, npage=window) if rect else dict(Wp=window))
    return banded_launch_plan(shape, n_sm)


def _launch_for(plan: dict, name: str, device,
                launch: Optional[BandedLaunch]) -> BandedLaunch:
    """``launch``, or by default ``banded_launch_plan`` for the card of
    ``device`` (cached by the plan's shape); raises unless it tiles the
    plan's tiles."""
    if launch is None:
        ranges = plan.get("ranges")
        rect = _is_rect(plan)
        launch = _default_launch(None if ranges is None else tuple(ranges),
                                 plan["n"], plan["K"], plan["tile"],
                                 plan["npage"] if rect else plan["Wp"], rect,
                                 sm_count(device))
    if (launch.rows not in ((1, K4_ROWS) if _is_rect(plan) else (K4_ROWS,))
            or launch.split * launch.threads * launch.rows != plan["tile"]):
        raise ValueError(f"{name}: launch plan {launch} does not tile "
                         f"{plan['tile']} rows")
    if launch.stride not in ((1, 32) if _is_rect(plan) else (1,)):
        raise ValueError(f"{name}: rows {launch.stride} apart")
    if launch.rows == 1 and launch.staged:
        raise ValueError(f"{name}: one row a thread reads x direct")
    return launch


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
    if halo and x_off < plan["Wp"]:
        raise ValueError(f"{name}: halo {x_off} narrower than Wp={plan['Wp']}")
    launch = _launch_for(plan, name, x.device, launch)
    y = torch.empty(n, dtype=x.dtype, device=x.device)
    with phase(name, (n, K, vals.dtype)):
        launch_kernel(
            "raptor_banded_" + _suffix(vals), name, _shape(name, plan),
            x.device, vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
            y.data_ptr(), n, K, plan["tile"], plan["Wp"], x_off, x.shape[0],
            _live_mask(live), len(live), int(launch.staged), launch.threads,
            launch.page0, launch.pages)
    return y


def banded_spmv(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """K4: y = A @ x over a square banded plan; x fp32 (n,), vals fp32 or
    bf16."""
    return _launch_k4(plan, x)


def banded_spmv_halo(plan: dict, x_pad: torch.Tensor) -> torch.Tensor:
    """K4 in its halo form: y = A_own @ x over a rank's tile block of a
    square banded plan; x_pad fp32 ``(n + 2 * kh * tile,)``, the rank's
    ``[left halo | x_own | right halo]``."""
    return _launch_k4(plan, x_pad, halo=True)


def _launch_k6(plan: dict, x: torch.Tensor, launch: Optional[BandedLaunch] = None,
               map_cols: Optional[int] = None) -> torch.Tensor:
    """K6 on CUDA tensors with ``launch`` (default: ``banded_launch_plan``
    for x's card), in its n_cols form or, with ``map_cols``, its map_cols
    form; raises on what the kernel does not take."""
    vals = plan["vals"]
    name = "K6" if map_cols is None else "K6-map_cols"
    if map_cols is None:
        _check_vec(x, plan["n_cols"], name)
        map_cols = plan["n_cols"]
    else:
        _check_vec(x, x.shape[0], name)
        if (x.shape[0] % PAGE or not PAGE <= x.shape[0] < 2**31
                or not 0 <= map_cols < 2**40):
            raise ValueError(f"{name}: buffer of {x.shape[0]} (a positive "
                             f"multiple of {PAGE}), map_cols={map_cols}")
    live = _check_plan(plan, x.device, name)
    launch = _launch_for(plan, name, x.device, launch)
    y = torch.empty(plan["n"], dtype=x.dtype, device=x.device)
    with phase(name, (plan["n"], plan["K"], vals.dtype)):
        launch_kernel(
            "raptor_banded_rect_" + _suffix(vals), name, _shape(name, plan),
            x.device, vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
            y.data_ptr(), plan["n"], plan["K"], plan["tile"], x.shape[0],
            map_cols, plan["WpP"], plan["npage"], _live_mask(live), len(live),
            int(launch.staged),
            2 if launch.rows == 1 else int(launch.stride == 32),
            launch.threads, launch.page0, launch.pages)
    return y


def banded_spmv_rect(plan: dict, x: torch.Tensor,
                     map_cols: Optional[int] = None) -> torch.Tensor:
    """K6: y = B @ x over a rectangular banded plan.  n_cols form: x fp32
    ``(n_cols,)``.  map_cols form (``map_cols`` given): x fp32 is a
    halo-extended buffer of whole pages and ``map_cols`` the numerator of
    the window index map."""
    return _launch_k6(plan, x, map_cols=map_cols)


def _launch_k5(plan: dict, vals_lo, xh, bh, bl, v,
               launch: Optional[BandedLaunch] = None):
    """K5 on CUDA tensors with ``launch`` (default: ``banded_launch_plan``
    for xh's card, as K4's); raises on what the kernel does not take."""
    vals = plan["vals"]
    n = plan["n"]
    for what, t in (("xh", xh), ("bh", bh), ("bl", bl), ("v", v)):
        _check_vec(t, n, "K5", what)
        if t.device != xh.device:
            raise ValueError(f"K5: {what} on {t.device}, xh on {xh.device}")
    if vals.dtype != torch.float32:
        raise ValueError(f"K5: vals dtype {vals.dtype}: the df64 residual "
                         f"takes float32")
    live = _check_plan(plan, xh.device, "K5")
    lo_ptr = None
    if vals_lo is not None:
        if (vals_lo.device != xh.device or vals_lo.dtype != torch.float32
                or vals_lo.shape != vals.shape or not vals_lo.is_contiguous()
                or vals_lo.data_ptr() % 16):
            raise ValueError(f"K5: vals_lo {tuple(vals_lo.shape)} "
                             f"{vals_lo.dtype} on {vals_lo.device}: expected "
                             f"contiguous, 16-byte aligned float32 "
                             f"{tuple(vals.shape)}")
        lo_ptr = vals_lo.data_ptr()
    launch = _launch_for(plan, "K5", xh.device, launch)
    rh = torch.empty_like(xh)
    rl = torch.empty_like(xh)
    with phase("K5", (n, plan["K"], vals.dtype)):
        launch_kernel(
            "raptor_banded_df64_f32", "K5", _shape("K5", plan), xh.device,
            vals.data_ptr(), lo_ptr, plan["pidx"].data_ptr(), xh.data_ptr(),
            bh.data_ptr(), bl.data_ptr(), v.data_ptr(), rh.data_ptr(),
            rl.data_ptr(), n, plan["K"], plan["tile"], plan["Wp"],
            _live_mask(live), len(live), int(launch.staged), launch.threads,
            launch.page0, launch.pages)
    return rh, rl


def banded_df64_residual(plan: dict, vals_lo, xh, bh, bl, v):
    """K5: (rh, rl) = df64[(bh, bl) - v - A @ xh] over a square banded plan
    with fp32 vals; ``vals_lo``: optional fp32 truncation remainder of the
    operator in the plan's blocked layout."""
    return _launch_k5(plan, vals_lo, xh, bh, bl, v)
