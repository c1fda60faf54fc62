"""The BlockELL applies on the CPU: K8's plain versions
(``ops/cuda/bell_kernel.py``: ``bell_spmv_ref``, ``bell_diag_ref``, the
slot-order sums K8 computes) against the CPU route's einsums and SciPy,
the routing of ``core/bell.py`` (CPU tensors never launch K8) and the
argument checks of K8's wrappers.  K8 itself runs on the card only
(``tests/test_torch_bell_kernel.py``).

The plain versions and the einsums sum each row's K * b products in
different orders, so each differs from the exact sum by at most about
K * b * u * (|A| |x|) (u = eps / 2, the unit roundoff), and the two from
each other by at most K * b * eps * (|A| |x|), row by row."""

import numpy as np
import pytest
import torch

from raptor_tpu_torch.core import bell
from raptor_tpu_torch.ops.cuda import bell_kernel as k8
from tests._torch_ref import random_bell

# (block rows, b, most blocks a row): level 0's 3x3 blocks, the coarse
# levels' 6x6 and a size no kernel form is specialised for
SHAPES = [(45, 3, 27), (29, 6, 12), (23, 5, 7)]


def _case(nb, b, per_row, dtype, batch=None, seed=0):
    E, a = random_bell(nb, b, per_row, seed=seed)
    A = E.to("cpu").cast(dtype)
    n = A.nb_pad * b
    rng = np.random.default_rng(seed + 1)
    shape = (n,) if batch is None else (batch, n)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dtype)
    return A, a, x


def _abs_bound(A, x):
    """|A| |x| row by row, the scale of a row's rounding error."""
    return k8.bell_spmv_ref(A.data.abs(), A.cols, A.row_nnz, x.abs())


@pytest.mark.parametrize("batch", [None, 3], ids=["vector", "batch3"])
@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=["b3", "b6", "b5"])
def test_spmv_ref_agrees_with_einsum(nb, b, per_row, batch):
    A, _, x = _case(nb, b, per_row, torch.float32, batch)
    got = k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x)
    ref = bell.bell_spmv(A, x)
    tol = A.K * b * torch.finfo(torch.float32).eps * _abs_bound(A, x)
    assert got.shape == ref.shape == x.shape
    assert bool(((got - ref).abs() <= tol).all())
    # the batch's rows are each vector's own product
    if batch is not None:
        assert torch.equal(got[1], k8.bell_spmv_ref(A.data, A.cols,
                                                    A.row_nnz, x[1]))


@pytest.mark.parametrize("batch", [None, 3], ids=["vector", "batch3"])
@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=["b3", "b6", "b5"])
def test_diag_ref_agrees_with_einsum(nb, b, per_row, batch):
    A, _, x = _case(nb, b, per_row, torch.float32, batch)
    binv = bell.block_diag_inv(A)
    got = k8.bell_diag_ref(binv, x)
    ref = bell._block_prec(binv, A, x)
    bound = k8.bell_diag_ref(binv.abs(), x.abs())
    assert got.shape == ref.shape == x.shape
    assert bool(((got - ref).abs()
                 <= b * torch.finfo(torch.float32).eps * bound).all())


@pytest.mark.parametrize("op", ["spmv", "diag"])
@pytest.mark.parametrize("batch", [None, 3], ids=["vector", "batch3"])
@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=["b3", "b6", "b5"])
def test_refs_agree_with_einsum_fp64(nb, b, per_row, batch, op):
    """fp64 blocks with fp64 x, which K8 takes too: the same bound at
    fp64's eps."""
    A, _, x = _case(nb, b, per_row, torch.float64, batch)
    eps = torch.finfo(torch.float64).eps
    if op == "spmv":
        got = k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x)
        ref = bell.bell_spmv(A, x)
        tol = A.K * b * eps * _abs_bound(A, x)
    else:
        binv = bell.block_diag_inv(A)
        got = k8.bell_diag_ref(binv, x)
        ref = bell._block_prec(binv, A, x)
        tol = b * eps * k8.bell_diag_ref(binv.abs(), x.abs())
    assert got.dtype == ref.dtype == torch.float64
    assert bool(((got - ref).abs() <= tol).all())


@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=["b3", "b6", "b5"])
def test_spmv_ref_is_the_product(nb, b, per_row):
    """In fp64 the plain version is the SciPy product on the logical rows
    and the identity on the padding rows."""
    A, a, x = _case(nb, b, per_row, torch.float64)
    assert A.nb_pad > nb  # identity rows pad the block rows
    assert int(A.row_nnz.min()) < A.K  # rows shorter than K
    y = k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x).numpy()
    xn = x.numpy()
    n = nb * b
    ref = a @ xn[:n]
    assert np.abs(y[:n] - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.array_equal(y[n:], xn[n:])


def test_ref_widens_bf16_blocks():
    """bf16 blocks with fp32 x: the product of the widened blocks, exactly,
    as K8 computes it."""
    A, _, x = _case(45, 3, 27, torch.float32, batch=2)
    A16 = A.cast(torch.bfloat16)
    got = k8.bell_spmv_ref(A16.data, A16.cols, A16.row_nnz, x)
    wide = A16.data.to(torch.float32)
    assert got.dtype == torch.float32
    assert torch.equal(got, k8.bell_spmv_ref(wide, A16.cols, A16.row_nnz, x))
    binv = bell.block_diag_inv(A).to(torch.bfloat16)
    assert torch.equal(k8.bell_diag_ref(binv, x),
                       k8.bell_diag_ref(binv.to(torch.float32), x))


def test_ref_clamps_columns_and_row_counts():
    """Columns outside [0, nb) read the nearest block row's x; row counts
    above K take every slot and below 0 none, as K8 clamps them."""
    A, _, x = _case(29, 6, 12, torch.float64)
    cols, nnz = A.cols.clone(), A.row_nnz.clone()
    cols[0, 0], cols[0, 1] = -5, A.nb_pad + 7
    nnz[2], nnz[3] = A.K + 4, -1
    y = k8.bell_spmv_ref(A.data, cols, nnz, x)
    c = cols.clone()
    c[0, 0], c[0, 1] = 0, A.nb_pad - 1
    m = nnz.clone()
    m[2], m[3] = A.K, 0
    assert torch.equal(y, k8.bell_spmv_ref(A.data, c, m, x))
    assert bool((y.reshape(A.nb_pad, 6)[3] == 0).all())


def test_cpu_route_takes_the_einsums():
    """CPU tensors take the reference's einsums through every block apply:
    K8 is never launched and the results are the einsums', bit for bit."""
    A, _, x = _case(45, 3, 27, torch.float32)
    binv = bell.block_diag_inv(A)
    before = k8.launches["K8"]
    y = bell.bell_spmv(A, x)
    z = bell._block_prec(binv, A, x)
    bell.block_chebyshev4(A, binv, x, torch.zeros_like(x), 1.7, degree=3)
    bell.block_jacobi(A, binv, x, torch.zeros_like(x), sweeps=2)
    bell.estimate_lmax_bell(A, binv, iters=3)
    assert k8.launches["K8"] == before
    assert torch.equal(y, bell._spmv_einsum(A.data, A.cols, x))
    assert torch.equal(z, bell._prec_einsum(binv, x))


@pytest.mark.parametrize("case", ["fp16_blocks", "fp64_x", "bf16_fp64_x",
                                  "shape", "cpu", "diag_shape"])
def test_wrappers_refuse(case):
    """K8's wrappers raise on what the kernel does not take, before any
    build or launch: the checks run on the CPU."""
    A, _, x = _case(23, 5, 7, torch.float32)
    data, cols, nnz = A.data, A.cols, A.row_nnz
    binv = bell.block_diag_inv(A)
    call = {
        "fp16_blocks": lambda: k8.bell_spmv(data.half(), cols, nnz, x),
        "fp64_x": lambda: k8.bell_spmv(data, cols, nnz, x.double()),
        "bf16_fp64_x": lambda: k8.bell_diag(binv.bfloat16(), x.double()),
        "shape": lambda: k8.bell_spmv(data, cols, nnz, x[:-1]),
        "cpu": lambda: k8.bell_spmv(data, cols, nnz, x),
        "diag_shape": lambda: k8.bell_diag(binv[:, :, :2], x),
    }[case]
    with pytest.raises(ValueError):
        call()
    assert k8.launches["K8"] == 0
