"""DIA SpMV kernels K1 and K2: wrappers around ``csrc/dia_kernel.cu`` and
their plain PyTorch versions.

* K1 ``dia_spmv_v2``: ``y[i] = sum_k f32(data[k, i]) * x[i + lin_k]`` over
  boundary-zeroed planes (fp32 or bf16), fp32 x.  Counterpart of
  ``raptor_tpu/ops/pallas/dia_kernel.py::dia_spmv_pallas_v2``.
* K2 ``dia_spmv_const``: the same product for a constant-coefficient
  stencil, each plane synthesized from the row's grid coordinates, so only
  x is read.  Counterpart of ``dia_spmv_pallas_const``.

x has shape (n,) or (B, n).  A wrapper given CPU tensors returns its plain
version (``dia_spmv_v2_ref`` / ``dia_spmv_const_ref``); given CUDA tensors
it launches its kernel or raises — there is no fallback.  ``launches``
counts kernel launches (plain-version calls are not counted), so a run can
show that its path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Sequence, Tuple

import torch

__all__ = ["dia_spmv_v2", "dia_spmv_v2_ref", "dia_spmv_const",
           "dia_spmv_const_ref", "in_grid_mask", "launches"]

MAX_OFF = 32
MAX_DIMS = 4
MAX_BATCH = 65535

launches: collections.Counter = collections.Counter()  # keys "K1", "K2"


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


def dia_spmv_const_ref(consts: Sequence[float], offsets, dims,
                       x: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the roll sum with each plane synthesized as
    ``c_k`` inside the grid and 0 outside."""
    n = x.shape[-1]
    lins = [sum(o * s for o, s in zip(off, _strides(dims))) for off in offsets]
    y = None
    for c, off, o in zip(consts, offsets, lins):
        shifted = x if o == 0 else torch.roll(x, -o, dims=-1)
        plane = torch.zeros(n, dtype=x.dtype, device=x.device).masked_fill_(
            in_grid_mask(dims, off, x.device), float(c))
        term = plane * shifted
        y = term if y is None else y + term
    return y


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


def dia_spmv_v2(data: torch.Tensor, lins: Sequence[int],
                x: torch.Tensor) -> torch.Tensor:
    """K1: streamed-plane DIA SpMV.  ``data`` (n_off, n) fp32 or bf16,
    boundary-zeroed; ``lins`` the linear offsets; x fp32 (n,) or (B, n)."""
    if x.device.type == "cpu" and data.device.type == "cpu":
        return dia_spmv_v2_ref(data, lins, x)
    n_off, n = data.shape
    batch = _check_x(x, n)
    if data.device != x.device:
        raise ValueError(f"data on {data.device}, x on {x.device}")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"plane dtype {data.dtype}: K1 takes float32 or bfloat16")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if not 0 < n_off <= MAX_OFF or len(lins) != n_off:
        raise ValueError(f"{n_off} planes, {len(lins)} offsets (max {MAX_OFF})")
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    fn = (lib.raptor_dia_planes_bf16 if data.dtype == torch.bfloat16
          else lib.raptor_dia_planes_f32)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(data.data_ptr(), x.data_ptr(), y.data_ptr(), n, batch,
                _int_array(lins), n_off, stream)
    if rc != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {rc}")
    launches["K1"] += 1
    return y


def dia_spmv_const(consts: Sequence[float], offsets, dims,
                   x: torch.Tensor) -> torch.Tensor:
    """K2: constant-coefficient DIA SpMV on grid ``dims`` (1 to 4 dims);
    ``consts[k]`` multiplies ``x[i + off_k]`` where that neighbour is in the
    grid.  x fp32 (n,) or (B, n)."""
    if x.device.type == "cpu":
        return dia_spmv_const_ref(consts, offsets, dims, x)
    dims = tuple(int(d) for d in dims)
    n = 1
    for d in dims:
        n *= d
    batch = _check_x(x, n)
    nd, n_off = len(dims), len(offsets)
    if not 0 < nd <= MAX_DIMS:
        raise ValueError(f"{nd} dims: K2 takes 1 to {MAX_DIMS}")
    if not 0 < n_off <= MAX_OFF or len(consts) != n_off:
        raise ValueError(f"{n_off} offsets, {len(consts)} consts (max {MAX_OFF})")
    if any(len(o) != nd for o in offsets):
        raise ValueError(f"offsets {offsets} do not match dims {dims}")
    strides = _strides(dims)
    lins = [sum(o * s for o, s in zip(off, strides)) for off in offsets]
    from raptor_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    c = (ctypes.c_float * n_off)(*[float(v) for v in consts])
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.raptor_dia_const_f32(
            x.data_ptr(), y.data_ptr(), n, batch, _int_array(dims), nd,
            _int_array([v for o in offsets for v in o]), _int_array(lins), c,
            n_off, stream)
    if rc != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {rc}")
    launches["K2"] += 1
    return y
