"""K8, the BlockELL apply kernel (``csrc/bell_kernel.cu``), on an NVIDIA
GPU: bit for bit (``torch.equal``) against its slot-order plain versions
``bell_spmv_ref`` and ``bell_diag_ref`` on the same CUDA tensors, its
refusals, a small config-4 problem solved through K8 and through the
einsum route, and the span the benchmark reads its device time under.

Every test is marked ``cuda`` and skips where torch.cuda.is_available() is
false.  The module imports no JAX; run it on the card with

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_bell_kernel.py
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from raptor_tpu_torch.core import bell
from raptor_tpu_torch.ops.cuda import bell_kernel as k8
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import cuda_device, random_bell

pytestmark = pytest.mark.cuda

# (block rows, b, most blocks a row): 3x3 blocks (level 0), 6x6 (the levels
# under six candidates) and b = 5, which takes the runtime-b code; each
# with rows of every length up to K and padded, on levels of few and of
# many block rows, and 6x6 rows as long as config 4's level 2's
SHAPES = [(3001, 3, 100), (12001, 3, 27), (517, 6, 60), (6001, 6, 40),
          (401, 5, 60), (7001, 5, 9), (450, 6, 400)]
SHAPE_IDS = ["b3-short", "b3-tall", "b6-short", "b6-tall", "b5-short",
             "b5-tall", "b6-long-rows"]
# block dtype, x dtype
DTYPES = {"fp32": (torch.float32, torch.float32),
          "bf16": (torch.bfloat16, torch.float32),
          "fp64": (torch.float64, torch.float64)}


@pytest.fixture(scope="module")
def dev():
    return cuda_device()


def _case(dev, nb, b, per_row, dtype, batch=None, seed=0):
    blocks, vec = DTYPES[dtype]
    E, _ = random_bell(nb, b, per_row, seed=seed)
    A = E.to(dev).cast(blocks)
    n = A.nb_pad * b
    rng = np.random.default_rng(seed + 1)
    shape = (n,) if batch is None else (batch, n)
    x = torch.from_numpy(rng.standard_normal(shape)).to(dev, vec)
    return A, x


def _binv(A):
    """Block inverses as the set-up makes them (torch.linalg.inv: blocks
    column-major), in A's block dtype."""
    wide = A.cast(torch.float64 if A.dtype == torch.float64 else torch.float32)
    return bell.block_diag_inv(wide).to(A.dtype)


@pytest.mark.parametrize("batch", [None, 3], ids=["vector", "batch3"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=SHAPE_IDS)
def test_k8_general_bit_equal(dev, nb, b, per_row, dtype, batch):
    A, x = _case(dev, nb, b, per_row, dtype, batch)
    assert A.nb_pad > nb and int(A.row_nnz.min()) < A.K
    key = ("K8", A.nb_pad, A.K, b, str(A.dtype).removeprefix("torch."))
    before = launch.launches["K8"], launch.launches_by_shape[key]
    y = k8.bell_spmv(A.data, A.cols, A.row_nnz, x)
    torch.cuda.synchronize()
    assert (launch.launches["K8"], launch.launches_by_shape[key]) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(y, k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x))


@pytest.mark.parametrize("batch", [None, 3], ids=["vector", "batch3"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nb,b,per_row", SHAPES, ids=SHAPE_IDS)
def test_k8_diag_bit_equal(dev, nb, b, per_row, dtype, batch):
    A, x = _case(dev, nb, b, per_row, dtype, batch)
    binv = _binv(A)
    # blocks at any strides are read in place
    for m in (binv, binv.transpose(1, 2), binv.contiguous()):
        z = k8.bell_diag(m, x)
        assert torch.equal(z, k8.bell_diag_ref(m, x))


def test_k8_batch_over_grid_limit(dev):
    """A batch longer than the grid's 65535 rows of blocks: each thread
    block takes several vectors."""
    A, x = _case(dev, 5, 3, 4, "fp32", batch=70000)
    assert torch.equal(k8.bell_spmv(A.data, A.cols, A.row_nnz, x),
                       k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x))
    binv = _binv(A)
    assert torch.equal(k8.bell_diag(binv, x), k8.bell_diag_ref(binv, x))


def test_k8_clamps_columns_and_row_counts(dev):
    A, x = _case(dev, 517, 6, 40, "fp32")
    cols, nnz = A.cols.clone(), A.row_nnz.clone()
    cols[0, :5] = torch.tensor([-7, A.nb_pad, A.nb_pad + 100, -1, 2**30],
                               dtype=torch.int32)
    nnz[:3] = torch.tensor([A.K + 5, -2, 0], dtype=torch.int32)
    y = k8.bell_spmv(A.data, cols, nnz, x)
    assert torch.equal(y, k8.bell_spmv_ref(A.data, cols, nnz, x))


@pytest.mark.parametrize("case", ["fp16_blocks", "fp64_x", "bf16_fp64_x",
                                  "x_strided", "cols_int64", "nnz_shape",
                                  "cols_on_cpu", "x_on_cpu", "diag_shape",
                                  "blocks_strided"])
def test_k8_refuses(dev, case):
    A, x = _case(dev, 401, 5, 9, "fp32", batch=2)
    data, cols, nnz = A.data, A.cols, A.row_nnz
    binv = _binv(A)
    call = {
        "fp16_blocks": lambda: k8.bell_spmv(data.half(), cols, nnz, x),
        "fp64_x": lambda: k8.bell_spmv(data, cols, nnz, x.double()),
        "bf16_fp64_x": lambda: k8.bell_diag(binv.bfloat16(), x.double()),
        "x_strided": lambda: k8.bell_spmv(data, cols, nnz, x.T.contiguous().T),
        "cols_int64": lambda: k8.bell_spmv(data, cols.long(), nnz, x),
        "nnz_shape": lambda: k8.bell_spmv(data, cols, nnz[:-1], x),
        "cols_on_cpu": lambda: k8.bell_spmv(data, cols.cpu(), nnz, x),
        "x_on_cpu": lambda: k8.bell_diag(binv, x.cpu()),
        "diag_shape": lambda: k8.bell_diag(binv[:, :, :4], x),
        "blocks_strided": lambda: k8.bell_spmv(
            data.transpose(2, 3).contiguous().transpose(2, 3), cols, nnz, x),
    }[case]
    before = launch.launches["K8"]
    with pytest.raises(ValueError):
        call()
    assert launch.launches["K8"] == before


def test_k8_on_a_card_not_current(dev):
    """Tensors on a card other than the current one: K8 launches there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    other = torch.device("cuda", 1)
    A, x = _case(other, 517, 6, 60, "fp32")
    assert torch.cuda.current_device() == 0
    y = k8.bell_spmv(A.data, A.cols, A.row_nnz, x)
    assert y.device == other
    assert torch.equal(y, k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x))


def test_block_applies_launch_k8(dev):
    """``core/bell.py`` sends CUDA tensors to K8: one launch an apply,
    counted beside ``bell.launches``; a strided x is made contiguous."""
    A, x = _case(dev, 3001, 3, 27, "fp32", batch=2)
    binv = _binv(A)
    k0, s0, p0 = (launch.launches["K8"], bell.launches["bell_spmv"],
                  bell.launches["bell_prec"])
    y = bell.bell_spmv(A, x.T.contiguous().T)
    z = bell._block_prec(binv, A, x)
    assert launch.launches["K8"] == k0 + 2
    assert (bell.launches["bell_spmv"], bell.launches["bell_prec"]) == (
        s0 + 1, p0 + 1)
    assert torch.equal(y, k8.bell_spmv_ref(A.data, A.cols, A.row_nnz, x))
    assert torch.equal(z, k8.bell_diag_ref(binv, x))


# ---------------------------------------------------------------------------
# config 4 on the card at 10^3 nodes
# ---------------------------------------------------------------------------

def _einsum_route(monkeypatch):
    """Send the card's block applies to ``core/bell.py``'s einsums, the
    route K8 replaced."""
    monkeypatch.setattr(k8, "bell_spmv",
                        lambda data, cols, row_nnz, x:
                        bell._spmv_einsum(data, cols, x))
    monkeypatch.setattr(k8, "bell_diag", bell._prec_einsum)


def _config4(dev):
    from raptor_tpu_torch import setup
    from raptor_tpu_torch.config import PRESETS
    from raptor_tpu_torch.gallery import default_rhs, elasticity_3d

    A, B, _ = elasticity_3d(10)
    cfg = dataclasses.replace(PRESETS["config4"], host_setup_threshold=0)
    h = setup(A.copy(), cfg, B=B, device=dev)
    b = default_rhs(A.shape[0], dtype=np.float32)
    bd = torch.zeros(h.levels[0].A.n_rows_pad, dtype=torch.float32,
                     device=dev)
    bd[:A.shape[0]] = torch.from_numpy(b).to(dev)
    return A, h, bd


def _solve(A, h, bd):
    """The benchmark's solve (``api.solve_hier_refined`` to 1e-8); returns
    (iterations, certified relres, fp64 true relres)."""
    from raptor_tpu_torch.api import solve_hier_refined

    (xh, xl), rel, iters = solve_hier_refined(h, bd, tol=1e-8,
                                              b_lo=torch.zeros_like(bd))
    n = A.shape[0]
    x = xh[:n].double().cpu().numpy() + xl[:n].double().cpu().numpy()
    b = bd[:n].double().cpu().numpy()
    return int(iters), float(rel), float(np.linalg.norm(b - A @ x)
                                         / np.linalg.norm(b))


@pytest.fixture(scope="module")
def config4(dev):
    return _config4(dev)


def test_config4_kernel_and_einsum_routes_agree(dev, config4, monkeypatch):
    """Set-up and refined solve through K8, then through the einsums: both
    reach tol in the same number of PCG iterations.  Every block apply of
    the K8 solve launched K8 once."""
    A, h, bd = config4
    assert h.levels[0].Abell.bs == 3 and h.levels[1].Abell.bs == 6
    before = (launch.launches["K8"],
              bell.launches["bell_spmv"] + bell.launches["bell_prec"])
    its, rel, true = _solve(A, h, bd)
    applies = (bell.launches["bell_spmv"] + bell.launches["bell_prec"]
               - before[1])
    assert applies > 0 and launch.launches["K8"] - before[0] == applies
    _einsum_route(monkeypatch)
    A2, h2, bd2 = _config4(dev)
    its2, rel2, true2 = _solve(A2, h2, bd2)
    assert launch.launches["K8"] - before[0] == applies  # none on this route
    assert max(rel, rel2, true, true2) <= 1e-8, (rel, rel2, true, true2)
    assert its == its2, (its, its2)


def test_bell0_reads_k8_under_the_spmv_span(dev, config4):
    """The benchmark's ``bell_roofline_share.solve`` reader
    (``amgbench/engines/elasticity.py::_bell0``) finds level 0's applies:
    K8's device time falls under ``bell.spmv[...]`` as the innermost span;
    a W-cycle's K8 launches equal its card block applies."""
    from amgbench import counts_block
    from amgbench.engines.elasticity import Engine
    from raptor_tpu_torch.solve.cycle import cycle

    A, h, bd = config4
    lv = h.levels[0]
    nnz_a = int(lv.Abell.row_nnz[:lv.n // 3].sum()) * 9
    shim = types.SimpleNamespace(h=h, dev=dev,
                                 vcycle=lambda: (lambda: cycle(h, bd)))
    out = Engine._bell0(shim, counts_block.BlockLevel(n=lv.n, nnz_a=nnz_a),
                        4)
    assert out["calls"] > 0 and out["self_s"] > 0, out
    before = (launch.launches["K8"],
              bell.launches["bell_spmv"] + bell.launches["bell_prec"])
    cycle(h, bd)
    torch.cuda.synchronize()
    applies = (bell.launches["bell_spmv"] + bell.launches["bell_prec"]
               - before[1])
    assert applies > 0 and launch.launches["K8"] - before[0] == applies
