"""The structured engine's df64 residual (``structured/dia.py``
``dia_df64_residual``) on the CPU: the plain version against NumPy fp64, the
routing rules, the argument checks of its kernel K7 and K7's launch plan.
K7 itself runs on the card only (``tests/test_torch_cuda.py``)."""

import itertools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu_torch.structured.dia as tdia
import raptor_tpu_torch.structured.solver as ts
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from tests._torch_ref import stencil_7pt

CUBE = list(itertools.product((-1, 0, 1), repeat=3))


def _variable_27pt(dims, seed=0) -> sp.csr_matrix:
    """A 27-point operator with a random coefficient per entry, diagonally
    dominant, entries exact in fp32."""
    rng = np.random.default_rng(seed)
    idx = np.arange(int(np.prod(dims))).reshape(dims)
    rows, cols, vals = [], [], []
    for off in CUBE:
        src = tuple(slice(max(0, -o), d - max(0, o)) for o, d in zip(off, dims))
        dst = tuple(slice(max(0, o), d - max(0, -o)) for o, d in zip(off, dims))
        r, c = idx[src].ravel(), idx[dst].ravel()
        v = rng.uniform(-1.0, 0.0, r.size) if any(off) else rng.uniform(
            27.0, 30.0, r.size)
        rows.append(r), cols.append(c), vals.append(v)
    n = idx.size
    return sp.csr_matrix((np.concatenate(vals).astype(np.float32),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def _df_vectors(n, seed=1, scale=30.0):
    """(xh, xl, bh, bl): random fp32 heads and tails below half an ulp."""
    rng = np.random.default_rng(seed)

    def pair(s):
        h = (rng.standard_normal(n) * s).astype(np.float32)
        lo = (h * rng.uniform(-1, 1, n) * 2.0**-25).astype(np.float32)
        return torch.from_numpy(h), torch.from_numpy(lo)

    return (*pair(1.0), *pair(scale))


@pytest.mark.parametrize("dims", [(9, 7, 6), (12, 10, 8), (5, 7, 3)])
def test_plain_residual_matches_numpy_fp64(dims):
    """The plain version on a variable-coefficient 27-point operator:
    rh + rl against b - A x in fp64 (x = xh + xl, b = bh + bl exact)."""
    A = _variable_27pt(dims)
    D = tdia.dia_from_scipy(A, dims, device="cpu")
    assert D.const_planes is None and D.n_off == 27
    xh, xl, bh, bl = _df_vectors(D.n)
    rh, rl = tdia.dia_df64_residual_ref(D, xh, xl, bh, bl)
    x64 = xh.double().numpy() + xl.double().numpy()
    r64 = bh.double().numpy() + bl.double().numpy() - A.astype(np.float64) @ x64
    got = rh.double().numpy() + rl.double().numpy()
    assert np.abs(got - r64).max() <= 1e-13 * np.abs(r64).max()
    # the head alone is the fp32 rounding of the residual, no more
    assert np.abs(rh.double().numpy() - r64).max() <= 2**-23 * np.abs(r64).max()


@pytest.mark.parametrize("shift", [0.0, 0.0371])
@pytest.mark.parametrize("dims", [(8, 8, 8), (5, 7, 3)])
def test_cpu_routes_to_the_plain_version(dims, shift):
    """On the CPU ``dia_df64_residual`` (and the solver's
    ``_df64_residual``) is the plain version bit for bit, launching
    nothing; K7's own wrappers, which only the router calls, refuse CPU
    tensors in either form."""
    st = stencil_7pt()
    st[1, 1, 1] += shift
    D = tdia.dia_from_stencil(st, dims, device="cpu")
    assert D.const_planes is not None
    xh, xl, bh, bl = _df_vectors(D.n, seed=3)
    calls, k7 = dict(tdia.cuda_calls), tk.launches["K7"]
    want = tdia.dia_df64_residual_ref(D, xh, xl, bh, bl)
    for got in (tdia.dia_df64_residual(D, xh, xl, bh, bl),
                ts._df64_residual(D, xh, xl, bh, bl)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_df64_residual_const(D.const_planes, D.offsets, dims,
                                   xh, xl, bh, bl)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_df64_residual_v2(D.data, D.linear_offsets(), xh, xl, bh, bl)
    assert dict(tdia.cuda_calls) == calls and tk.launches["K7"] == k7


def test_plain_residual_is_the_op_by_op_sum():
    """The plain version is the op-by-op df64 sum in offset order (the
    structured solver's residual before K7), written out here."""
    from raptor_tpu_torch.utils.df64 import df_add, two_prod

    dims = (6, 5, 4)
    D = tdia.dia_from_scipy(_variable_27pt(dims, seed=4), dims, device="cpu")
    xh, xl, bh, bl = _df_vectors(D.n, seed=5)
    rh, rl = bh, bl
    for k, o in enumerate(D.linear_offsets()):
        sh, sl = torch.roll(xh, -o), torch.roll(xl, -o)
        ph, pe = two_prod(D.data[k], sh)
        rh, rl = df_add(rh, rl, -ph, -(pe + D.data[k] * sl))
    got = tdia.dia_df64_residual(D, xh, xl, bh, bl)
    assert torch.equal(got[0], rh) and torch.equal(got[1], rl)


@pytest.mark.parametrize("bad,match", [
    (dict(dtype=torch.float64), "float32"),
    (dict(shape=(2, 60)), "shape"),
    (dict(), "CUDA"),
])
def test_k7_refuses_what_it_does_not_take(bad, match):
    """K7's checks: fp64 vectors and batches raise (dtype and shape are
    checked before the device), and CPU tensors are not K7's."""
    n = 120
    v = torch.zeros(bad.get("shape", (n,)), dtype=bad.get("dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        tk._check_df64(n, v, v, v, v)


@pytest.mark.parametrize("dims,offsets", [
    ((512,) * 3, [o for o in CUBE if sum(map(abs, o)) <= 1]),
    ((128,) * 3, CUBE),
    ((256,) * 3, [o for o in CUBE if sum(map(abs, o)) <= 1]),
    ((33, 17, 9), CUBE),
    ((5, 7, 3), CUBE),
])
def test_k7_tile_plan_fits(dims, offsets):
    """K7's plan: four rows a thread, two stages of xh's and xl's windows
    within a block's shared memory, every offset's reads inside its band's
    window (the kernel's make_plan checks), and a tile per SM where the grid
    has enough rows."""
    lins = [tdia._linear(o, dims) for o in offsets]
    n = int(np.prod(dims))
    p = tk.df64_tile_plan(lins, n)
    assert p.rows == 4 and p.tile % 4 == 0 and p.tile // 4 <= tk.TILE_THREADS
    assert p.smem_bytes == 2 * 2 * 4 * sum(p.windows) <= tk.SMEM_BYTES
    for o, b in zip(lins, p.band_of):
        lo, _ = p.bands[b]
        assert 0 <= o - lo and o - lo + p.tile + tk.WIN_SLACK <= p.windows[b]
    assert -(-n // p.tile) >= tk.H100_SMS or p.tile == 4 * tk.MIN_TILE_THREADS


def test_k7_tile_plan_at_the_headline_shape():
    """512^3, 7 points: tiles of 1024 rows; bands -262144, -512..512 and
    +262144; 66 KB of shared memory."""
    dims = (512,) * 3
    lins = [tdia._linear(o, dims) for o in CUBE if sum(map(abs, o)) <= 1]
    p = tk.df64_tile_plan(lins, 512**3)
    assert p.tile == 1024
    assert p.bands == ((-262144, -262144), (-512, 512), (262144, 262144))
    assert p.windows == (1032, 2056, 1032)
    assert p.smem_bytes == 16 * 4120
