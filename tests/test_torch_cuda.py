"""raptor_tpu_torch on an NVIDIA GPU: the hand-written kernels against
their plain versions on the same CUDA tensors, and the structured cycle and
refined solve on the card against the same computation on the CPU.

Every test is marked ``cuda`` and skips where torch.cuda.is_available() is
false.  The module imports no JAX, so it also runs on a machine without
it; there the repository's conftest (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Kernel tolerance 1e-6 * max|y_ref|: the kernels round each product and sum
as the plain versions do, so only a reordering could differ.
"""

import itertools

import numpy as np
import pytest
import torch

import raptor_tpu_torch.structured.dia as tdia
import raptor_tpu_torch.structured.solver as ts
from raptor_tpu_torch.config import AmgConfig
from raptor_tpu_torch.gallery import default_rhs
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from tests._torch_ref import cuda_device, rel_err, stencil_5pt, stencil_7pt

pytestmark = pytest.mark.cuda

TOL = 1e-6
CUBE = list(itertools.product((-1, 0, 1), repeat=3))
OFFSETS = {3: [(-1, 0, 0), (0, 0, 0), (1, 0, 0)],
           15: [o for o in CUBE if abs(o[1]) + abs(o[2]) <= 1],
           27: CUBE}
CFG = dict(smoother="cheb4", cheb_degree=2, coarse_size=64, max_levels=40)


def _planes(dims, offsets, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), int(np.prod(dims))))
    data = data.astype(np.float32)
    for k, o in enumerate(offsets):
        data[k] *= tdia.boundary_mask(dims, o)
    lins = [tdia._linear(o, dims) for o in offsets]
    return torch.from_numpy(data).to(dev, dtype), lins


def _x(n, dev, batch=None, seed=1):
    shape = (n,) if batch is None else (batch, n)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_off,batch", [(3, None), (15, None), (27, 4)])
def test_k1_kernel_matches_plain(n_off, batch, dtype):
    dev = cuda_device()
    dims = (16, 32, 64)
    data, lins = _planes(dims, OFFSETS[n_off], dtype, dev)
    x = _x(data.shape[1], dev, batch)
    before = tk.launches["K1"]
    y = tk.dia_spmv_v2(data, lins, x)
    assert tk.launches["K1"] == before + 1
    assert rel_err(y.cpu(), tk.dia_spmv_v2_ref(data, lins, x).cpu()) <= TOL


@pytest.mark.parametrize("stencil,dims", [
    (stencil_7pt(), (32, 32, 32)), (stencil_5pt(), (64, 48)),
    (-np.ones((3, 3, 3)), (8, 16, 24))])
def test_k2_kernel_matches_plain(stencil, dims):
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil, dims, device=dev)
    x = _x(A.n, dev, batch=2)
    before = tk.launches["K2"]
    y = tk.dia_spmv_const(A.const_planes, A.offsets, dims, x)
    assert tk.launches["K2"] == before + 1
    y_ref = tk.dia_spmv_const_ref(A.const_planes, A.offsets, dims, x)
    assert rel_err(y.cpu(), y_ref.cpu()) <= TOL


def test_kernels_refuse_what_they_do_not_take():
    dev = cuda_device()
    data = torch.zeros(3, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        tk.dia_spmv_v2(data, (-1, 0, 1),
                       torch.zeros(64, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="plane dtype"):
        tk.dia_spmv_v2(data.double(), (-1, 0, 1), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        tk.dia_spmv_v2(data, (-1, 0, 1), torch.zeros(65, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        tk.dia_spmv_v2(data, (-1, 0, 1), torch.zeros(128, device=dev)[::2])


def test_dia_spmv_counts_and_routes():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 8), device=dev)
    B = tdia.DiaMatrix(A.data, A.offsets, A.dims)  # stored planes: K1
    x = _x(A.n, dev)
    calls, k1, k2 = (tdia.cuda_calls["dia_spmv"], tk.launches["K1"],
                     tk.launches["K2"])
    ya, yb = tdia.dia_spmv(A, x), tdia.dia_spmv(B, x)
    assert tdia.cuda_calls["dia_spmv"] == calls + 2
    assert (tk.launches["K1"], tk.launches["K2"]) == (k1 + 1, k2 + 1)
    assert torch.equal(ya, yb)


def test_cycle_and_refined_solve_on_card_match_cpu():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (16, 16, 16), device=dev)
    h = ts.build_structured_hierarchy(A, AmgConfig(**CFG), dim_policy="size")
    hc = h.to("cpu")
    b = torch.from_numpy(default_rhs(A.n, dtype=np.float32))
    hb, hcb = ts.cast_hierarchy(h, torch.bfloat16), ts.cast_hierarchy(hc, torch.bfloat16)
    assert rel_err(ts.scycle(hb, b.to(dev)).cpu(), ts.scycle(hcb, b)) <= 1e-5
    (xh, xl), rel, it = ts.structured_solve_refined(h, b.to(dev), tol=1e-8,
                                                    M_hier=hb)
    _, rel_c, it_c = ts.structured_solve_refined(hc, b, tol=1e-8, M_hier=hcb)
    assert int(it) == int(it_c)
    assert float(rel) <= 1e-8 and float(rel_c) <= 1e-8


def test_kernels_build_and_load():
    cuda_device()
    from raptor_tpu_torch.ops.cuda.build import build, load_library

    path, _ = build()
    assert path.exists()
    assert load_library().raptor_dia_planes_f32.restype is not None
