"""The one launch path of the hand-written kernels (``ops/cuda/launch.py``):
every public wrapper in ``ops/cuda`` takes CUDA tensors alone.  Given
otherwise valid CPU tensors it raises ``ValueError`` before any build or
launch and counts nothing; the CPU-or-card choice is the caller's (the
module that owns the format)."""

import numpy as np
import pytest
import torch

import raptor_tpu_torch.ops.banded_plan as tplan
import raptor_tpu_torch.structured.dia as tdia
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.cuda import bell_kernel as k8
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import (banded_tensors, clamped_rect_plan, random_bell,
                              rcm_ell, stencil_7pt)


def _vec(n: int, seed: int = 0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def _calls() -> dict:
    """Each public wrapper, called with otherwise valid CPU tensors."""
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 8), device="cpu")
    lins = A.linear_offsets()
    x = _vec(A.n)
    xh, xl, bh, bl = (_vec(A.n, s) for s in range(4))
    sq = banded_tensors(tplan.banded_plan(*rcm_ell(10)))
    h = bk.halo_width(sq)
    rect = clamped_rect_plan()
    Eb = random_bell(16, 3, 4)[0]
    data = torch.as_tensor(np.asarray(Eb.data), dtype=torch.float32)
    cols = torch.as_tensor(np.asarray(Eb.cols)).int()
    nnz = torch.as_tensor(np.asarray(Eb.row_nnz)).int()
    xb = _vec(data.shape[1] * data.shape[2])
    binv = torch.eye(3).expand(data.shape[1], 3, 3).contiguous()
    return {
        "K1": lambda: tk.dia_spmv_v2(A.data, lins, x),
        "K1v1": lambda: tk.dia_spmv_v1(A.data, lins, x),
        "K2": lambda: tk.dia_spmv_const(A.const_planes, A.offsets, A.dims, x),
        "K3": lambda: tk.dia_spmv_halo(A.data, lins, x, x[:64], x[:64]),
        "K4": lambda: bk.banded_spmv(sq, _vec(sq["n"])),
        "K4-halo": lambda: bk.banded_spmv_halo(sq, _vec(sq["n"] + 2 * h)),
        "K5": lambda: bk.banded_df64_residual(
            sq, None, *(_vec(sq["n"], s) for s in range(4))),
        "K6": lambda: bk.banded_spmv_rect(rect, _vec(rect["n_cols"])),
        "K6-map_cols": lambda: bk.banded_spmv_rect(
            dict(rect, WpP=0), _vec(rect["n_cols"] + 2048), map_cols=4096),
        "K7-const": lambda: tk.dia_df64_residual_const(
            A.const_planes, A.offsets, A.dims, xh, xl, bh, bl),
        "K7-planes": lambda: tk.dia_df64_residual_v2(A.data, lins, xh, xl,
                                                     bh, bl),
        "K8": lambda: k8.bell_spmv(data, cols, nnz, xb),
        "K8-diag": lambda: k8.bell_diag(binv, xb),
    }


@pytest.mark.parametrize("kernel", ["K1", "K1v1", "K2", "K3", "K4", "K4-halo",
                                    "K5", "K6", "K6-map_cols", "K7-const",
                                    "K7-planes", "K8", "K8-diag"])
def test_wrappers_refuse_cpu_tensors_and_count_nothing(kernel):
    call = _calls()[kernel]
    before = (dict(launch.launches), dict(launch.launches_by_shape))
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert (dict(launch.launches), dict(launch.launches_by_shape)) == before
