"""DIA SpMV kernels K1, K1v1, K2 and K3 and the df64 DIA residual K7:
wrappers around ``csrc/dia_kernel.cu`` (K2: ``csrc/dia_const_kernel.cu``,
K7: ``csrc/dia_df64_kernel.cu``) and their plain PyTorch versions.

* K1 ``dia_spmv_v2``: ``y[i] = sum_k f32(data[k, i]) * x[i + lin_k]`` over
  boundary-zeroed planes (fp32 or bf16), fp32 x.  Counterpart of
  ``raptor_tpu/ops/pallas/dia_kernel.py::dia_spmv_pallas_v2``.
* K1v1 ``dia_spmv_v1``: the same sum with x zero-filled outside [0, n), for
  any planes.  Counterpart of ``dia_spmv_pallas`` (the v1 kernel); it
  launches K1's device code, which reads nothing outside [0, n).
* K2 ``dia_spmv_const``: the same product for a constant-coefficient
  stencil, each plane synthesized from the row's grid coordinates, so only
  x is read.  Counterpart of ``dia_spmv_pallas_const``.
* K3 ``dia_spmv_halo``: the sum over the window
  ``[halo_left | x | halo_right]`` of one plane-sharded block, zero beyond.
  Counterpart of ``dia_spmv_pallas_v2_halo``.
* K7 ``dia_df64_residual_v2`` and ``dia_df64_residual_const``: the
  compensated residual ``(rh, rl) = df64[(bh, bl) - A @ (xh, xl)]`` over
  boundary-zeroed fp32 planes, or over a constant stencil's synthesized
  planes, in one pass (the structured engine's refinement residual; no
  TPU kernel).

x has shape (n,) or (B, n) (K3: (nl,)).  A wrapper of K1, K1v1, K2 or K3
given CPU tensors returns its plain version (``dia_spmv_v2_ref``,
``dia_spmv_v1_ref``, ``dia_spmv_const_ref``, ``dia_spmv_halo_ref``); given
CUDA tensors it launches its kernel or raises — there is no fallback.  K7's
wrappers take CUDA tensors alone: ``structured/dia.py::dia_df64_residual``
routes, sending CPU tensors to the plain version ``dia_df64_residual_v2_ref``.  ``launches`` counts
kernel launches (plain-version calls are not counted), so a run can show
that its path went through the kernels; ``launches_by_shape`` counts them
by (kernel, n, n_off, plane dtype), and each launch is a span of that
name (``utils/profiling.py``).

K1, K1v1 and K3 launch one tiled kernel whose host-side plan
(``tile_plan``: row tile, offset bands, window sizes, whether the planes
take 16-byte loads) is built here; ``dia_spmv_tiled_ref`` is a plain
emulation of that kernel's algorithm, window by window, for the CPU tests.
K2 walks the same tiles and windows (``tile_plan`` with four rows per
thread) over planes it synthesizes (``const_planes``); K7 walks them with
two vectors, xh and xl, staged side by side (``df64_tile_plan``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from raptor_tpu_torch.utils.df64 import df_add, two_prod
from raptor_tpu_torch.utils.profiling import phase

__all__ = ["dia_spmv_v2", "dia_spmv_v2_ref", "dia_spmv_v1", "dia_spmv_v1_ref",
           "dia_spmv_const", "dia_spmv_const_ref", "dia_spmv_halo",
           "dia_spmv_halo_ref", "dia_spmv_tiled_ref", "const_planes",
           "const_tile_plan", "halo_reach", "dia_df64_residual_v2",
           "dia_df64_residual_v2_ref", "dia_df64_residual_const",
           "df64_tile_plan",
           "in_grid_mask", "launches", "launches_by_shape", "tile_plan",
           "TilePlan"]

MAX_OFF = 32
MAX_DIMS = 4
MAX_BATCH = 65535
MAX_CONST_REACH = 32767  # K2 keeps a stencil's per-dimension steps in 16 bits
# the tiled kernel (csrc/dia_kernel.cu): threads per block at most and at
# least, a block's shared memory on Hopper (227 KB), and the floats a window
# holds beyond tile + span (RAPTOR_WIN_SLACK: the 16-byte round-down of its
# start and the last thread's extra float4 read)
TILE_THREADS, MIN_TILE_THREADS = 256, 32
SMEM_BYTES = 232448
WIN_SLACK = 7
H100_SMS = 132

# keys "K1", "K1v1", "K2", "K3", "K7"
launches: collections.Counter = collections.Counter()
# keys (kernel, n, n_off, plane dtype name)
launches_by_shape: collections.Counter = collections.Counter()


class TilePlan(NamedTuple):
    """The tiled kernel's launch plan for one operator shape."""
    tile: int                         # rows per tile (a block's rows)
    rows: int                         # rows per thread: 16 bytes of planes
    vec: bool                         # 16-byte plane loads (planes aligned)
    bands: Tuple[Tuple[int, int], ...]  # (lo, hi) linear offsets per band
    band_of: Tuple[int, ...]          # each offset's band, in offset order
    windows: Tuple[int, ...]          # floats staged per band and tile
    smem_bytes: int                   # two stages of windows (each vector)


def _bands(lins: Sequence[int], tile: int) -> Tuple[Tuple[int, int], ...]:
    """Sorted distinct offsets, grouped: a gap of more than ``tile`` starts
    a new band, since one window over the gap then costs fewer floats than
    two windows of ``tile`` each."""
    u = sorted(set(int(o) for o in lins))
    bands = [[u[0], u[0]]]
    for o in u[1:]:
        if o - bands[-1][1] > tile:
            bands.append([o, o])
        else:
            bands[-1][1] = o
    return tuple((lo, hi) for lo, hi in bands)


def _window(tile: int, lo: int, hi: int) -> int:
    """Floats of one band's window: the tile, the band's span and the
    slack, rounded up to whole 16-byte chunks."""
    return -(-(tile + hi - lo + WIN_SLACK) // 4) * 4


def tile_plan(lins: Sequence[int], n: int, itemsize: int,
              planes_aligned: bool = True, batch: int = 1,
              n_sm: int = H100_SMS, rows: Optional[int] = None,
              max_threads: int = TILE_THREADS, vectors: int = 1) -> TilePlan:
    """The host-side plan of the tiled kernel for ``n`` rows, offsets
    ``lins``, planes of ``itemsize`` bytes (4 fp32, 2 bf16) and ``batch``
    vectors.

    A thread takes 16 bytes of each plane (``rows`` = 16 / itemsize rows),
    a block of up to 256 threads one tile.  The tile halves, down to 32
    threads, while two stages of the bands' windows exceed a block's shared
    memory, or while there are fewer tiles than SMs (a short level then
    still spreads over the card).  The planes take 16-byte loads when
    ``planes_aligned`` (their base address is) and n is a multiple of
    ``rows``, so that every plane's rows stay aligned.  ``rows`` given
    (a multiple of 4) sets the rows per thread, and ``max_threads`` the
    largest block, for a kernel that loads no planes (K2).  ``vectors``
    is the number of vectors whose windows a tile stages (K7: 2)."""
    return _tile_plan(tuple(int(o) for o in lins), int(n), int(itemsize),
                      bool(planes_aligned), int(batch), int(n_sm),
                      None if rows is None else int(rows), int(max_threads),
                      int(vectors))


@functools.lru_cache(maxsize=1024)
def _tile_plan(lins: Tuple[int, ...], n: int, itemsize: int,
               planes_aligned: bool, batch: int, n_sm: int,
               rows: Optional[int] = None,
               max_threads: int = TILE_THREADS, vectors: int = 1) -> TilePlan:
    if (not 0 < len(lins) <= MAX_OFF or n < 1 or itemsize not in (2, 4)
            or (rows is not None and (rows < 4 or rows % 4))
            or max_threads not in (32, 64, 128, 256) or vectors not in (1, 2)):
        raise ValueError(f"no tile plan for {len(lins)} offsets, n={n}, "
                         f"itemsize {itemsize}, rows {rows}, at most "
                         f"{max_threads} threads")
    if rows is None:
        rows = 16 // itemsize
    tile = rows * max_threads
    while True:
        bands = _bands(lins, tile)
        windows = tuple(_window(tile, lo, hi) for lo, hi in bands)
        smem = 2 * 4 * vectors * sum(windows)
        tiles = batch * -(-n // tile)
        if tile == rows * MIN_TILE_THREADS or (
                smem <= SMEM_BYTES and tiles >= n_sm):
            break
        tile //= 2
    if smem > SMEM_BYTES:
        raise ValueError(f"{len(lins)} offsets need {smem} bytes of shared "
                         f"memory at the least tile {tile}")
    band_of = tuple(next(b for b, (lo, hi) in enumerate(bands)
                         if lo <= o <= hi) for o in lins)
    return TilePlan(tile=tile, rows=rows,
                    vec=planes_aligned and n % rows == 0, bands=bands,
                    band_of=band_of, windows=windows, smem_bytes=smem)


def _strides(dims: Sequence[int]) -> Tuple[int, ...]:
    s = [1] * len(dims)
    for i in range(len(dims) - 2, -1, -1):
        s[i] = s[i + 1] * dims[i + 1]
    return tuple(s)


def in_grid_mask(dims, off, device) -> torch.Tensor:
    """(n,) bool: True where ``coord(i) + off`` stays inside the grid box."""
    dims = tuple(int(d) for d in dims)
    n = 1
    for d in dims:
        n *= d
    m = torch.ones(n, dtype=torch.bool, device=device)
    i = torch.arange(n, device=device)
    for d, s, o in zip(dims, _strides(dims), off):
        if o == 0:
            continue
        c = (i // s) % d + o
        m &= (c >= 0) & (c < d)
    return m


def dia_spmv_v2_ref(data: torch.Tensor, lins: Sequence[int],
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the roll sum in offset order, ``plane * shifted``
    then ``+`` (a bf16 plane widens to fp32 in the multiply)."""
    y = None
    for k, o in enumerate(lins):
        shifted = x if o == 0 else torch.roll(x, -int(o), dims=-1)
        term = data[k] * shifted
        y = term if y is None else y + term
    return y


def _shift_zero(x: torch.Tensor, o: int) -> torch.Tensor:
    """``x[..., i + o]`` where ``0 <= i + o < n``, else 0."""
    if o == 0:
        return x
    n = x.shape[-1]
    out = torch.zeros_like(x)
    if abs(o) < n:
        if o > 0:
            out[..., :n - o] = x[..., o:]
        else:
            out[..., -o:] = x[..., :n + o]
    return out


def dia_spmv_v1_ref(data: torch.Tensor, lins: Sequence[int],
                    x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1v1: the sum in offset order over shifts of x that
    fill with zeros (the TPU kernel's zero-padded x), so planes need not be
    boundary-zeroed."""
    y = None
    for k, o in enumerate(lins):
        term = data[k] * _shift_zero(x, int(o))
        y = term if y is None else y + term
    return y


def halo_reach(lins: Sequence[int]) -> Tuple[int, int]:
    """(LP, RP): how far the offsets reach left and right of a block."""
    lins = [int(o) for o in lins]
    return max(0, -min(lins)), max(0, max(lins))


def dia_spmv_halo_ref(data: torch.Tensor, lins: Sequence[int], x: torch.Tensor,
                      halo_left: torch.Tensor,
                      halo_right: torch.Tensor) -> torch.Tensor:
    """Plain version of K3: the window ``[halo_left | x | halo_right]``,
    zero-padded to the offsets' reach (LP, RP), and ``data[k] *
    window[LP + lin_k : LP + lin_k + nl]`` summed in offset order.  Halo
    values beyond the reach are never read."""
    nl = x.shape[0]
    LP, RP = halo_reach(lins)
    hl = halo_left[max(halo_left.shape[0] - LP, 0):].to(x.dtype)
    hr = halo_right[:RP].to(x.dtype)
    window = torch.cat([x.new_zeros(LP - hl.shape[0]), hl, x, hr,
                        x.new_zeros(RP - hr.shape[0])])
    y = None
    for k, o in enumerate(lins):
        term = data[k] * window[LP + int(o):LP + int(o) + nl]
        y = term if y is None else y + term
    return y


def dia_spmv_tiled_ref(data: torch.Tensor, lins: Sequence[int],
                       x: torch.Tensor, halo_left: Optional[torch.Tensor] = None,
                       halo_right: Optional[torch.Tensor] = None,
                       plan: Optional[TilePlan] = None,
                       x_misalign: int = 0) -> torch.Tensor:
    """Plain emulation of the tiled kernel (K1, K1v1, K3): for each tile of
    ``plan.tile`` rows and each band, the window ``[a0, a0 + window)`` of
    ``xw = [halo_left | x | halo_right]`` (0 beyond) is staged, ``a0`` being
    the window's first element rounded down to a 16-byte boundary of x
    (``x_misalign``: x's start, in elements past such a boundary); each row
    then sums ``f32(data[k, i]) * window[...]`` in offset order, the first
    term standing alone.  Without halos it is K1's (and K1v1's) function,
    with them K3's.  x is (n,) or (B, n)."""
    n = data.shape[1]
    lins = [int(o) for o in lins]
    if plan is None:
        plan = tile_plan(tuple(lins), n, data.element_size(),
                         batch=1 if x.dim() == 1 else x.shape[0])
    hl = x.new_zeros(0) if halo_left is None else halo_left.to(x.dtype)
    hr = x.new_zeros(0) if halo_right is None else halo_right.to(x.dtype)
    if x.dim() == 1:
        return dia_spmv_tiled_ref(data, lins, x[None], hl, hr, plan,
                                  x_misalign)[0]
    # xw over [-len(hl) - reach, n + len(hr) + reach): every window lies
    # inside, and is 0 beyond the halos
    pad = max(abs(o) for o in lins) + plan.tile + WIN_SLACK + 4
    lo_end = hl.shape[0] + pad
    y = torch.empty_like(x)
    for b in range(x.shape[0]):
        xw = torch.cat([x.new_zeros(pad), hl, x[b], hr, x.new_zeros(pad)])
        mis = (x_misalign + b * n) % 4
        for row0 in range(0, n, plan.tile):
            rows = min(plan.tile, n - row0)
            wins = []
            for (lo, _), width in zip(plan.bands, plan.windows):
                j0 = row0 + lo
                a0 = j0 - (mis + j0) % 4
                wins.append(xw[lo_end + a0:lo_end + a0 + width])
            acc = None
            for k, o in enumerate(lins):
                lo = plan.bands[plan.band_of[k]][0]
                # the kernel's read start: the offset's place in its band,
                # plus the window's 16-byte remainder (row0 % 4 == 0)
                start = o - lo + (mis + lo) % 4
                win = wins[plan.band_of[k]][start:start + rows]
                term = data[k, row0:row0 + rows] * win
                acc = term if acc is None else acc + term
            y[b, row0:row0 + rows] = acc
    return y


def const_planes(consts: Sequence[float], offsets, dims, dtype=torch.float32,
                 device="cpu") -> torch.Tensor:
    """(n_off, n) planes of a constant-coefficient stencil: ``c_k`` where
    offset k's neighbour stays inside the grid, 0 elsewhere."""
    n = 1
    for d in dims:
        n *= int(d)
    data = torch.zeros((len(offsets), n), dtype=dtype, device=device)
    for k, (c, off) in enumerate(zip(consts, offsets)):
        data[k].masked_fill_(in_grid_mask(dims, off, device), float(c))
    return data


def _const_lins(offsets, dims) -> list:
    strides = _strides(dims)
    return [sum(o * s for o, s in zip(off, strides)) for off in offsets]


def dia_spmv_const_ref(consts: Sequence[float], offsets, dims,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the roll sum with each plane synthesized as
    ``c_k`` inside the grid and 0 outside."""
    lins = _const_lins(offsets, dims)
    data = const_planes(consts, offsets, dims, x.dtype, x.device)
    y = None
    for k, o in enumerate(lins):
        shifted = x if o == 0 else torch.roll(x, -o, dims=-1)
        term = data[k] * shifted
        y = term if y is None else y + term
    return y


CONST_ROWS = (16, 8, 4)  # rows per thread K2 is built for
CONST_TILE = 2048  # K2's full tile: 16 rows x 128 threads or 8 x 256


def const_tile_plan(offsets, dims, batch: int = 1,
                    n_sm: int = H100_SMS) -> TilePlan:
    """K2's launch plan: the tiled kernel's plan for the stencil's linear
    offsets (no planes are loaded, so ``vec`` means nothing here).  On a
    grid that gives every SM a full tile of 2048 rows a thread takes 16 or 8
    rows, whichever divides the last dimension (the rows then share every
    other coordinate); 4 on any other grid.  Measured on an H100
    (scripts/bench_banded_const_ab.py --sweep-k2, 7 points at 256^3): 73.1
    us at 16 rows x 128 threads, 85.2 at 8 x 256, 136.6 at 4 x 256."""
    n = 1
    for d in dims:
        n *= int(d)
    big = n * batch >= CONST_TILE * n_sm
    rows = next((r for r in CONST_ROWS[:-1] if big and int(dims[-1]) % r == 0),
                CONST_ROWS[-1])
    p = tile_plan(_const_lins(offsets, dims), n, 4, True, batch, n_sm, rows,
                  CONST_TILE // rows if rows > 4 else TILE_THREADS)
    # the kernel rounds a stage up to whole 256-byte swizzle groups
    return p._replace(smem_bytes=2 * 4 * (-(-sum(p.windows) // 64) * 64))


def _int_array(values) -> ctypes.Array:
    values = [int(v) for v in values]
    return (ctypes.c_int * max(len(values), 1))(*values)


def _check_x(x: torch.Tensor, n: int) -> int:
    """Validate x for a kernel; returns the batch size."""
    if not x.is_cuda:
        raise ValueError(f"x on {x.device}, expected a CUDA tensor")
    if x.dtype != torch.float32:
        raise ValueError(f"x dtype {x.dtype}: the kernels take float32 x")
    if x.dim() not in (1, 2) or x.shape[-1] != n:
        raise ValueError(f"x shape {tuple(x.shape)}: expected ({n},) or (B, {n})")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 < n < 2**31:
        raise ValueError(f"n={n} outside (0, 2**31)")
    batch = 1 if x.dim() == 1 else x.shape[0]
    if not 0 < batch <= MAX_BATCH:
        raise ValueError(f"batch {batch} outside (0, {MAX_BATCH}]")
    return batch


def _check_planes(data: torch.Tensor, lins: Sequence[int], x: torch.Tensor,
                  key: str) -> None:
    n_off = data.shape[0]
    if data.device != x.device:
        raise ValueError(f"data on {data.device}, x on {x.device}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"plane dtype {data.dtype}: {key} takes float32 or "
                         "bfloat16")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if not 0 < n_off <= MAX_OFF or len(lins) != n_off:
        raise ValueError(f"{n_off} planes, {len(lins)} offsets (max {MAX_OFF})")


@functools.lru_cache(maxsize=64)
def _n_sm(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=1024)
def _plan_args(lins: Tuple[int, ...], n: int, itemsize: int, aligned: bool,
               batch: int, n_sm: int) -> tuple:
    """The C arguments of a tiled launch: lins, n_off, tile, n_band,
    band_lo, band_win, band_of, vec."""
    p = _tile_plan(lins, n, itemsize, aligned, batch, n_sm)
    return (_int_array(lins), len(lins), p.tile, len(p.bands),
            _int_array([lo for lo, _ in p.bands]), _int_array(p.windows),
            _int_array(p.band_of), int(p.vec))


def _tiled_args(data: torch.Tensor, lins: Sequence[int], x: torch.Tensor,
                batch: int) -> tuple:
    return _plan_args(tuple(int(o) for o in lins), data.shape[1],
                      data.element_size(), data.data_ptr() % 16 == 0, batch,
                      _n_sm(x.device))


def _count(key: str, data: torch.Tensor) -> None:
    launches[key] += 1
    launches_by_shape[(key, data.shape[1], data.shape[0],
                       str(data.dtype).removeprefix("torch."))] += 1


def _launch_planes(data: torch.Tensor, lins: Sequence[int], x: torch.Tensor,
                   key: str) -> torch.Tensor:
    """K1's device code on CUDA tensors; counted under ``key``."""
    n_off, n = data.shape
    batch = _check_x(x, n)
    _check_planes(data, lins, x, key)
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    fn = (lib.raptor_dia_planes_bf16 if data.dtype == torch.bfloat16
          else lib.raptor_dia_planes_f32)
    y = torch.empty_like(x)
    with phase(key, (n, n_off, data.dtype)), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch,
                *_tiled_args(data, lins, x, batch), stream)
    if rc != 0:
        raise RuntimeError(f"{key} launch failed: cudaError {rc}")
    _count(key, data)
    return y


def dia_spmv_v2(data: torch.Tensor, lins: Sequence[int],
                x: torch.Tensor) -> torch.Tensor:
    """K1: streamed-plane DIA SpMV.  ``data`` (n_off, n) fp32 or bf16,
    boundary-zeroed; ``lins`` the linear offsets; x fp32 (n,) or (B, n)."""
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_v2_ref(data, lins, x)
    return _launch_planes(data, lins, x, "K1")


def dia_spmv_v1(data: torch.Tensor, lins: Sequence[int],
                x: torch.Tensor) -> torch.Tensor:
    """K1v1: DIA SpMV with x zero-filled outside [0, n), for planes that
    need not be boundary-zeroed.  ``data`` (n_off, n) fp32 or bf16; x fp32
    (n,) or (B, n).  Launches K1's device code, which skips every column
    outside [0, n)."""
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_v1_ref(data, lins, x)
    return _launch_planes(data, lins, x, "K1v1")


def dia_spmv_halo(data: torch.Tensor, lins: Sequence[int], x: torch.Tensor,
                  halo_left: torch.Tensor,
                  halo_right: torch.Tensor) -> torch.Tensor:
    """K3: ``y[i] = sum_k f32(data[k, i]) * xw[i + lin_k]`` with
    ``xw = [halo_left | x | halo_right]`` and 0 beyond.  ``data`` (n_off,
    nl) fp32 or bf16; x, halos fp32 1-D.  ``halo_left`` holds the left
    neighbour's trailing values, ``halo_right`` the right one's leading
    values; any length works, and only the offsets' reach (``halo_reach``)
    is read."""
    if all(t.device.type == "cpu" for t in (data, x, halo_left, halo_right)):
        return dia_spmv_halo_ref(data, lins, x, halo_left, halo_right)
    n_off, nl = data.shape
    if x.dim() != 1:
        raise ValueError(f"x shape {tuple(x.shape)}: K3 takes one vector")
    _check_x(x, nl)
    _check_planes(data, lins, x, "K3")
    for name, h in (("halo_left", halo_left), ("halo_right", halo_right)):
        if h.device != x.device or h.dtype != torch.float32 or h.dim() != 1:
            raise ValueError(f"{name}: {h.dtype} {tuple(h.shape)} on {h.device}, "
                             f"expected float32 (m,) on {x.device}")
        if not h.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    LP, RP = halo_reach(lins)
    hl = halo_left[max(halo_left.shape[0] - LP, 0):]
    hr = halo_right[:RP]
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    fn = (lib.raptor_dia_halo_bf16 if data.dtype == torch.bfloat16
          else lib.raptor_dia_halo_f32)
    y = torch.empty_like(x)
    with phase("K3", (nl, n_off, data.dtype)), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), hl.data_ptr(), hr.data_ptr(),
                y.data_ptr(), nl, hl.shape[0], hr.shape[0],
                *_tiled_args(data, lins, x, 1), stream)
    if rc != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {rc}")
    _count("K3", data)
    return y


@functools.lru_cache(maxsize=256)
def _const_args(consts: tuple, offsets: tuple, dims: tuple, batch: int,
                n_sm: int) -> tuple:
    """The C arguments of a K2 launch after x, y, n and batch: dims, nd,
    offs, lins, consts, n_off, rows, tile, n_band, band_lo, band_win,
    band_of."""
    lins = _const_lins(offsets, dims)
    p = const_tile_plan(offsets, dims, batch, n_sm)
    return (_int_array(dims), len(dims),
            _int_array([v for o in offsets for v in o]), _int_array(lins),
            (ctypes.c_float * len(consts))(*consts), len(offsets), p.rows,
            p.tile,
            len(p.bands), _int_array([lo for lo, _ in p.bands]),
            _int_array(p.windows), _int_array(p.band_of))


def _check_stencil(consts: Sequence[float], offsets, dims,
                   key: str) -> Tuple[tuple, tuple, int]:
    """Validate a constant stencil for K2 or K7; returns (dims, offsets, n)
    as ints."""
    dims = tuple(int(d) for d in dims)
    n = 1
    for d in dims:
        n *= d
    nd, n_off = len(dims), len(offsets)
    if not 0 < nd <= MAX_DIMS:
        raise ValueError(f"{nd} dims: {key} takes 1 to {MAX_DIMS}")
    if not 0 < n_off <= MAX_OFF or len(consts) != n_off:
        raise ValueError(f"{n_off} offsets, {len(consts)} consts (max {MAX_OFF})")
    if any(len(o) != nd for o in offsets):
        raise ValueError(f"offsets {offsets} do not match dims {dims}")
    offsets = tuple(tuple(int(v) for v in o) for o in offsets)
    if any(abs(v) > MAX_CONST_REACH for o in offsets for v in o):
        raise ValueError(f"offsets {offsets}: {key} takes steps of at most "
                         f"{MAX_CONST_REACH} cells per dimension")
    return dims, offsets, n


def dia_spmv_const(consts: Sequence[float], offsets, dims,
                   x: torch.Tensor) -> torch.Tensor:
    """K2: constant-coefficient DIA SpMV on grid ``dims`` (1 to 4 dims);
    ``consts[k]`` multiplies ``x[i + off_k]`` where that neighbour is in the
    grid.  x fp32 (n,) or (B, n)."""
    if x.device.type == "cpu":
        return dia_spmv_const_ref(consts, offsets, dims, x)
    dims, offsets, n = _check_stencil(consts, offsets, dims, "K2")
    batch = _check_x(x, n)
    n_off = len(offsets)
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    args = _const_args(tuple(float(v) for v in consts), offsets, dims, batch,
                       _n_sm(x.device))
    y = torch.empty_like(x)
    with phase("K2", (n, n_off, "float32")), torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.raptor_dia_const_f32(x.data_ptr(), y.data_ptr(), n, batch,
                                      *args, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    launches["K2"] += 1
    launches_by_shape[("K2", n, n_off, "float32")] += 1
    return y


# ---------------------------------------------------------------------------
# K7: the df64 DIA residual
# ---------------------------------------------------------------------------

DF64_ROWS = 4  # K7's rows per thread: one 16-byte load of each vector


def dia_df64_residual_v2_ref(data: torch.Tensor, lins: Sequence[int], xh, xl,
                             bh, bl) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K7: ``(rh, rl) = df64[(bh, bl) - A @ (xh, xl)]``
    op by op, offset by offset in order: each plane's product with the
    rolled xh split exactly by ``two_prod``, plus ``plane * xl``,
    subtracted by ``df_add``.  Every product and sum is a torch op of its
    own, so each is rounded apart, as the identities need
    (``utils/df64.py``).  Exact to ~1e-14 relative."""
    rh, rl = bh, bl
    for k, o in enumerate(int(o) for o in lins):
        sh = xh if o == 0 else torch.roll(xh, -o)
        sl = xl if o == 0 else torch.roll(xl, -o)
        ph, pe = two_prod(data[k], sh)
        pe = pe + data[k] * sl
        rh, rl = df_add(rh, rl, -ph, -pe)
    return rh, rl


def df64_tile_plan(lins: Sequence[int], n: int, planes_aligned: bool = True,
                   n_sm: int = H100_SMS) -> TilePlan:
    """K7's launch plan: the tiled kernel's for ``lins``, four rows a
    thread, with xh's and xl's windows staged (two vectors)."""
    return tile_plan(lins, n, 4, planes_aligned, 1, n_sm, DF64_ROWS,
                     TILE_THREADS, 2)


def _check_df64(n: int, xh, xl, bh, bl) -> None:
    """Validate K7's vectors: fp32, (n,), contiguous, on one CUDA device.
    The dtype and shape are checked first, on any device."""
    vecs = (("xh", xh), ("xl", xl), ("bh", bh), ("bl", bl))
    for name, v in vecs:
        if v.dtype != torch.float32:
            raise ValueError(f"{name} dtype {v.dtype}: K7 takes float32 "
                             "vectors")
        if v.dim() != 1 or v.shape[0] != n:
            raise ValueError(f"{name} shape {tuple(v.shape)}: K7 takes "
                             f"({n},)")
    if not 0 < n < 2**31:
        raise ValueError(f"n={n} outside (0, 2**31)")
    for name, v in vecs:
        if not v.is_cuda or v.device != xh.device:
            raise ValueError(f"{name} on {v.device}: K7 takes CUDA tensors "
                             "on one device")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=256)
def _df64_args(lins: Tuple[int, ...], n: int, aligned: bool,
               n_sm: int) -> tuple:
    """The plan arguments of a K7 launch: lins, n_off, tile, n_band,
    band_lo, band_win, band_of, vec."""
    p = df64_tile_plan(lins, n, aligned, n_sm)
    return (_int_array(lins), len(lins), p.tile, len(p.bands),
            _int_array([lo for lo, _ in p.bands]), _int_array(p.windows),
            _int_array(p.band_of), int(p.vec))


@functools.lru_cache(maxsize=256)
def _df64_stencil_args(consts: tuple, offsets: tuple, dims: tuple) -> tuple:
    """The stencil arguments of a K7 const launch: dims, nd, offs, consts."""
    return (_int_array(dims), len(dims),
            _int_array([v for o in offsets for v in o]),
            (ctypes.c_float * len(consts))(*consts))


def _launch_df64(data: Optional[torch.Tensor], lins: Tuple[int, ...],
                 stencil: tuple, xh, xl, bh, bl):
    """K7 on CUDA tensors: the planes form given ``data``, the const form
    given ``stencil`` (``_df64_stencil_args``) and ``data`` None."""
    n = xh.shape[0]
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    aligned = data is None or data.data_ptr() % 16 == 0
    args = _df64_args(lins, n, aligned, _n_sm(xh.device))
    rh, rl = torch.empty_like(xh), torch.empty_like(xh)
    with phase("K7", (n, len(lins), "float32")), torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream(xh.device).cuda_stream
        rc = lib.raptor_dia_df64_f32(
            None if data is None else data.data_ptr(), xh.data_ptr(),
            xl.data_ptr(), bh.data_ptr(), bl.data_ptr(), rh.data_ptr(),
            rl.data_ptr(), n, *stencil, *args, stream)
    if rc != 0:
        raise RuntimeError(f"K7 launch failed: cudaError {rc}")
    launches["K7"] += 1
    launches_by_shape[("K7", n, len(lins), "float32")] += 1
    return rh, rl


def dia_df64_residual_v2(data: torch.Tensor, lins: Sequence[int], xh, xl, bh,
                         bl) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, planes form: ``(rh, rl) = df64[(bh, bl) - A @ (xh, xl)]`` with
    ``data`` (n_off, n) boundary-zeroed fp32 planes and ``lins`` the linear
    offsets; xh, xl, bh, bl fp32 (n,).  Bit-equal to
    ``dia_df64_residual_v2_ref`` but for the sign of a zero."""
    n_off, n = data.shape
    _check_df64(n, xh, xl, bh, bl)
    if data.dtype != torch.float32:
        raise ValueError(f"plane dtype {data.dtype}: K7 takes float32 planes")
    if data.device != xh.device:
        raise ValueError(f"data on {data.device}, xh on {xh.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if not 0 < n_off <= MAX_OFF or len(lins) != n_off:
        raise ValueError(f"{n_off} planes, {len(lins)} offsets (max {MAX_OFF})")
    return _launch_df64(data, tuple(int(o) for o in lins), (None, 0, None, None),
                        xh, xl, bh, bl)


def dia_df64_residual_const(consts: Sequence[float], offsets, dims, xh, xl, bh,
                            bl) -> Tuple[torch.Tensor, torch.Tensor]:
    """K7, const form: the residual of the constant stencil ``consts`` at
    ``offsets`` on grid ``dims`` (1 to 4 dims), its planes synthesized from
    the rows' grid coordinates, so only xh, xl, bh and bl are read.
    Bit-equal to ``dia_df64_residual_v2_ref`` over the planes
    ``const_planes`` synthesizes, but for the sign of a zero."""
    dims, offsets, n = _check_stencil(consts, offsets, dims, "K7")
    _check_df64(n, xh, xl, bh, bl)
    stencil = _df64_stencil_args(tuple(float(v) for v in consts), offsets,
                                 dims)
    return _launch_df64(None, tuple(_const_lins(offsets, dims)), stencil, xh,
                        xl, bh, bl)
