"""Banded paged-gather kernels K4, K5 and K6: wrappers around
``csrc/banded_kernel.cu`` and their plain PyTorch versions.

* K4 ``banded_spmv``: square SpMV over an RCM-banded ELL plan,
  ``y[i] = sum_k vals[t,k,j] * x[t*tile - Wp + pidx[t,k,j]]`` (x read as 0
  outside [0, n)).  Counterpart of
  ``raptor_tpu/ops/pallas/banded_kernel.py::banded_spmv_pallas``.
* K6 ``banded_spmv_rect``: rectangular transfer over a window of ``npage``
  pages whose base moves with the tile in proportion to the columns.
  Counterpart of ``banded_spmv_rect_pallas``.
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
kernel launches (plain-version calls are not counted), ``launches_by_shape``
counts them by (kernel, n, K, vals dtype).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from raptor_tpu_torch.ops.banded_plan import PAGE
from raptor_tpu_torch.utils.df64 import df_add, two_prod

__all__ = ["banded_spmv", "banded_spmv_ref", "banded_spmv_rect",
           "banded_spmv_rect_ref", "banded_df64_residual",
           "banded_df64_residual_ref", "live_slots", "launches", "launches_by_shape"]

MAX_SLOTS = 256  # RAPTOR_MAX_SLOTS in csrc/banded_kernel.cu

launches: collections.Counter = collections.Counter()  # keys "K4", "K5", "K6"
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

def _window_gather(plan: dict, x: torch.Tensor):
    """Closure k -> x at slot k's window offsets, (T, R, 128), with 0
    outside [0, n): x padded by Wp zeros on each side."""
    Wp = plan["Wp"]
    xp = torch.cat([x.new_zeros(Wp), x, x.new_zeros(Wp)])
    base = _tiles(plan, x.device) * plan["tile"]
    return lambda k: xp[base + plan["pidx"][:, k]]


def banded_spmv_ref(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K4: y = sum over live slots of ``vals * x_window``
    in slot order (a bf16 value widens to fp32 in the multiply)."""
    gather = _window_gather(plan, x)
    T, _, R, L = plan["vals"].shape
    y = torch.zeros((T, R, L), dtype=x.dtype, device=x.device)
    for k in live_slots(plan):
        y = y + plan["vals"][:, k] * gather(k)
    return y.reshape(-1)


def banded_spmv_rect_ref(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: window page p of tile t is
    ``clamp((t * n_cols) // (T * 1024) - WpP + p, 0, n_cols / 1024 - 1)``;
    x has length ``n_cols``."""
    n, tile, n_cols = plan["n"], plan["tile"], plan["n_cols"]
    T = n // tile
    base = (_tiles(plan, x.device) * n_cols) // (T * PAGE) - plan["WpP"]
    last = n_cols // PAGE - 1
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


def banded_spmv(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """K4: y = A @ x over a square banded plan; x fp32 (n,), vals fp32 or
    bf16."""
    vals = plan["vals"]
    if x.device.type == "cpu" and vals.device.type == "cpu":
        return banded_spmv_ref(plan, x)
    n = plan["n"]
    _check_vec(x, n, "K4")
    live = _check_plan(plan, x.device, "K4")
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K4: vals dtype {vals.dtype}: float32 or bfloat16")
    lib = _lib()
    fn = lib.raptor_banded_bf16 if vals.dtype == torch.bfloat16 else lib.raptor_banded_f32
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = fn(vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
                y.data_ptr(), n, plan["K"], plan["tile"], plan["Wp"],
                _slots(live), len(live), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {rc}")
    _count("K4", plan)
    return y


def banded_spmv_rect(plan: dict, x: torch.Tensor) -> torch.Tensor:
    """K6: y = B @ x over a rectangular banded plan; x fp32 (n_cols,)."""
    vals = plan["vals"]
    if x.device.type == "cpu" and vals.device.type == "cpu":
        return banded_spmv_rect_ref(plan, x)
    _check_vec(x, plan["n_cols"], "K6")
    live = _check_plan(plan, x.device, "K6", rect=True)
    if vals.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K6: vals dtype {vals.dtype}: float32 or bfloat16")
    lib = _lib()
    fn = (lib.raptor_banded_rect_bf16 if vals.dtype == torch.bfloat16
          else lib.raptor_banded_rect_f32)
    y = torch.empty(plan["n"], dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = fn(vals.data_ptr(), plan["pidx"].data_ptr(), x.data_ptr(),
                y.data_ptr(), plan["n"], plan["K"], plan["tile"],
                plan["n_cols"], plan["WpP"], _slots(live), len(live),
                _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"K6 launch failed: cudaError {rc}")
    _count("K6", plan)
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
