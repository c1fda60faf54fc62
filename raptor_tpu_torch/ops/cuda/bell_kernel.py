"""BlockELL apply kernel K8: the wrapper around ``csrc/bell_kernel.cu`` and
its plain PyTorch versions.

* ``bell_spmv`` (general form): ``y = A x`` over a BlockELL matrix's
  blocks ``data (K, nb, b, b)``, int32 block columns ``cols (K, nb)`` and
  live slots ``row_nnz (nb,)`` (``core/bell.py::bell_spmv``).
* ``bell_diag`` (diagonal form): ``z = Binv r`` for block inverses
  ``binv (nb, b, b)``, no index read (``core/bell.py::_block_prec``).

No TPU kernel: the JAX package computes both applies as plain ``jnp``
einsums (``raptor_tpu/core/bell.py``).  The plain versions
``bell_spmv_ref`` and ``bell_diag_ref`` sum as K8 does, over the live
slots in order and then over j in order, each product and sum rounded on
its own, so K8 agrees with them bit for bit.  They differ from the einsums
only in the order of a row's sum.

x is (n,) or (B, n) with n = nb * b, contiguous: float32 with float32 or
bfloat16 blocks (bf16 widened to fp32 before the product), float64 with
float64 blocks; any other dtype raises.  The general form takes contiguous
blocks; the diagonal form's may have any strides (``torch.linalg.inv``
gives column-major blocks).  Both forms run one thread a scalar row.

The wrappers take CUDA tensors alone: ``core/bell.py`` routes, sending CPU
tensors to its einsums.  They launch through ``ops/cuda/launch.py``, which
counts every form under "K8" and by ("K8" or "K8-diag", nb, K, b, block
dtype name).  The wrappers open no span of their own: the launch sites'
``bell.spmv[...]`` and ``bell.prec[...]`` stay the innermost spans over
the kernel's device time (``amgbench/engines/elasticity.py`` reads them).
"""

from __future__ import annotations

import torch

from raptor_tpu_torch.ops.cuda.launch import launch_kernel

__all__ = ["bell_spmv", "bell_spmv_ref", "bell_diag", "bell_diag_ref"]

# block dtype -> (entry point, the dtype of x and y)
_ENTRY = {torch.float32: ("raptor_bell_f32", torch.float32),
          torch.bfloat16: ("raptor_bell_bf16", torch.float32),
          torch.float64: ("raptor_bell_f64", torch.float64)}
# launch key -> the entry points' form argument
_FORM = {"K8": 0, "K8-diag": 1}


def bell_spmv_ref(data: torch.Tensor, cols: torch.Tensor,
                  row_nnz: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K8's general form in plain PyTorch: slot by slot, the slots beyond a
    block row's ``row_nnz`` left out, each column clamped into [0, nb)."""
    K, nb, b, _ = data.shape
    xb = x.reshape(*x.shape[:-1], nb, b)
    c = cols.long().clamp(0, nb - 1)
    live = torch.arange(K, device=data.device)[:, None] < row_nnz[None, :]
    y = torch.zeros_like(xb)
    for k in range(K):
        a = data[k].to(x.dtype)
        xg = xb[..., c[k], :]
        yk = y
        for j in range(b):
            yk = yk + a[:, :, j] * xg[..., j:j + 1]
        y = torch.where(live[k][:, None], yk, y)
    return y.reshape(x.shape)


def bell_diag_ref(binv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K8's diagonal form in plain PyTorch."""
    nb, b, _ = binv.shape
    xb = x.reshape(*x.shape[:-1], nb, b)
    a = binv.to(x.dtype)
    y = torch.zeros_like(xb)
    for j in range(b):
        y = y + a[:, :, j] * xb[..., j:j + 1]
    return y.reshape(x.shape)


def _check(blocks: torch.Tensor, x: torch.Tensor, nb: int, b: int) -> int:
    """Validate the blocks' dtype and device and x; returns the batch."""
    if blocks.dtype not in _ENTRY:
        raise ValueError(f"block dtype {blocks.dtype}: K8 takes float32, "
                         "bfloat16 or float64 blocks")
    want = _ENTRY[blocks.dtype][1]
    if x.dtype != want:
        raise ValueError(f"x dtype {x.dtype}: K8 takes {want} x with "
                         f"{blocks.dtype} blocks")
    n = nb * b
    if x.dim() not in (1, 2) or x.shape[-1] != n:
        raise ValueError(f"x shape {tuple(x.shape)}: expected ({n},) or "
                         f"(B, {n})")
    if not x.is_cuda or blocks.device != x.device:
        raise ValueError(f"blocks on {blocks.device}, x on {x.device}: K8 "
                         "takes CUDA tensors on one device")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not 0 < n < 2**31:
        raise ValueError(f"nb * b = {n} outside (0, 2**31)")
    batch = 1 if x.dim() == 1 else x.shape[0]
    if batch < 1:
        raise ValueError("an empty batch")
    return batch


def _launch(key: str, blocks: torch.Tensor, cols, row_nnz, x: torch.Tensor,
            nb: int, K: int, b: int, batch: int,
            strides=(0, 0, 0)) -> torch.Tensor:
    y = torch.empty_like(x)
    launch_kernel(_ENTRY[blocks.dtype][0], "K8",
                  (key, nb, K, b, str(blocks.dtype).removeprefix("torch.")),
                  x.device, _FORM[key], blocks.data_ptr(),
                  None if cols is None else cols.data_ptr(),
                  None if row_nnz is None else row_nnz.data_ptr(),
                  x.data_ptr(), y.data_ptr(), nb, K, b, batch, *strides)
    return y


def bell_spmv(data: torch.Tensor, cols: torch.Tensor, row_nnz: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """K8, general form: ``y = A x``; bit-equal to ``bell_spmv_ref``."""
    if data.dim() != 4 or data.shape[2] != data.shape[3]:
        raise ValueError(f"blocks shape {tuple(data.shape)}: expected "
                         "(K, nb, b, b)")
    K, nb, b, _ = data.shape
    batch = _check(data, x, nb, b)
    if not data.is_contiguous():
        raise ValueError("blocks must be contiguous")
    for name, t, shape in (("cols", cols, (K, nb)),
                           ("row_nnz", row_nnz, (nb,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}; K8 takes contiguous int32 {shape} "
                             f"on {x.device}")
    return _launch("K8", data, cols, row_nnz, x, nb, K, b, batch)


def bell_diag(binv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K8, diagonal form: ``z = Binv x`` block row by block row; bit-equal
    to ``bell_diag_ref``."""
    if binv.dim() != 3 or binv.shape[1] != binv.shape[2]:
        raise ValueError(f"block inverses shape {tuple(binv.shape)}: "
                         "expected (nb, b, b)")
    nb, b, _ = binv.shape
    batch = _check(binv, x, nb, b)
    return _launch("K8-diag", binv, None, None, x, nb, 1, b, batch,
                   binv.stride())
