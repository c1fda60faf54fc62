"""raptor_tpu_torch.structured.dia and the K1/K2 wrappers against the JAX
package on the CPU.

Construction must match exactly.  The plain versions of K1 and K2 are held
against the JAX Pallas kernels in interpret mode (tile 1024 for fp32
planes, 2048 for bf16) and against the JAX roll path, within
1e-6 * max|y|: both sides sum the same fp32 terms in the same offset order,
so only the backends' rounding of the products may differ.  The
hand-written kernels are held against the plain versions on the card in
tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.structured.dia as jdia
import raptor_tpu_torch.structured.dia as tdia
from raptor_tpu.ops.pallas.dia_kernel import (
    dia_spmv_pallas_const,
    dia_spmv_pallas_v2,
)
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from tests._torch_ref import (
    np32,
    rel_err,
    stencil_5pt,
    stencil_7pt,
)

TOL = 1e-6
CUBE = list(itertools.product((-1, 0, 1), repeat=3))
OFFSETS = {7: [o for o in CUBE if sum(map(abs, o)) <= 1],
           15: [o for o in CUBE if abs(o[1]) + abs(o[2]) <= 1],
           27: CUBE}


def stencil_27pt():
    st = -np.ones((3, 3, 3))
    st[1, 1, 1] = 26.0
    return st


def _planes(dims, offsets, seed=0):
    """Random boundary-zeroed planes (float32 numpy) and their lins."""
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), int(np.prod(dims))))
    data = data.astype(np.float32)
    for k, o in enumerate(offsets):
        data[k] *= jdia.boundary_mask(dims, o)
    lins = tuple(jdia._linear(o, dims) for o in offsets)
    return data, lins


def _x(n, seed=1, batch=None):
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (batch, n)
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# construction: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stencil,dims", [
    (stencil_7pt(), (8, 6, 5)),
    (stencil_27pt(), (5, 7, 4)),
    (stencil_5pt(), (9, 7)),
])
def test_dia_from_stencil_exact(stencil, dims):
    J = jdia.dia_from_stencil(stencil, dims, dtype=jnp.float32)
    T = tdia.dia_from_stencil(stencil, dims, device="cpu")
    assert T.offsets == J.offsets and T.dims == J.dims
    assert T.const_planes == J.const_planes
    assert np.array_equal(T.data.numpy(), np.asarray(J.data))


def test_dia_from_stencil_bf16_exact():
    st = stencil_7pt() * 0.3  # not bf16-representable: rounding must agree
    J = jdia.dia_from_stencil(st, (6, 5, 4), dtype=jnp.bfloat16)
    T = tdia.dia_from_stencil(st, (6, 5, 4), dtype=torch.bfloat16, device="cpu")
    assert T.const_planes == J.const_planes
    assert np.array_equal(np32(T.data), np32(J.data))


@pytest.mark.parametrize("tol", [0.0, 0.15])
def test_dia_from_scipy_and_back_exact(tol):
    from raptor_tpu_torch.gallery import anisotropic_2d

    rng = np.random.default_rng(0)
    dims = (9, 8)
    a = sp.coo_matrix(anisotropic_2d(*dims, 0.1, 0.3))
    # duplicate entries exercise the per-(row, offset) accumulation
    a = sp.coo_matrix((np.concatenate([a.data, rng.random(a.nnz) / 3]),
                       (np.concatenate([a.row, a.row]),
                        np.concatenate([a.col, a.col]))), shape=a.shape)
    J = jdia.dia_from_scipy(a, dims, dtype=jnp.float32, tol=tol)
    T = tdia.dia_from_scipy(a, dims, tol=tol, device="cpu")
    assert T.offsets == J.offsets and T.const_planes is None
    assert np.array_equal(T.data.numpy(), np.asarray(J.data))
    St, Sj = tdia.dia_to_scipy(T), jdia.dia_to_scipy(J)
    assert St.dtype == Sj.dtype
    assert (St != Sj).nnz == 0 and np.array_equal(St.indptr, Sj.indptr)


@pytest.mark.parametrize("off", [(1, 0, -1), (0, 0, 0), (-1, -1, 1)])
def test_boundary_mask_traced(off):
    dims = (5, 4, 6)
    got = tdia.boundary_mask_traced(dims, off, "cpu").numpy()
    assert np.array_equal(got, tdia.boundary_mask(dims, off))
    assert np.array_equal(got, np.asarray(jdia.boundary_mask_traced(dims, off)))


# ---------------------------------------------------------------------------
# K1's function: dia_spmv_v2_ref against the JAX kernel and roll path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_off", [7, 15, 27])
def test_k1_plain_matches_jax(n_off, dtype):
    dims = (8, 16, 32)
    offs = OFFSETS[n_off]
    data, lins = _planes(dims, offs)
    x = _x(data.shape[1])
    jd = jnp.asarray(data, dtype=getattr(jnp, dtype))
    td = torch.from_numpy(data).to(getattr(torch, dtype))
    assert np.array_equal(np32(td), np32(jd))  # same bf16 rounding
    y = tk.dia_spmv_v2_ref(td, lins, torch.from_numpy(x)).numpy()
    y_pallas = dia_spmv_pallas_v2(jd, lins, jnp.asarray(x),
                                  tile=2048 if dtype == "bfloat16" else 1024,
                                  interpret=True)
    y_roll = jdia.dia_spmv(jdia.DiaMatrix(jd, tuple(offs), dims), jnp.asarray(x))
    assert rel_err(y, y_pallas) <= TOL
    assert rel_err(y, y_roll) <= TOL


def test_k1_wrapper_takes_plain_version_on_cpu():
    dims = (4, 8, 8)
    data, lins = _planes(dims, OFFSETS[15])
    x = torch.from_numpy(_x(data.shape[1], batch=3))
    before = dict(tk.launches)
    y = tk.dia_spmv_v2(torch.from_numpy(data), lins, x)
    assert torch.equal(y, tk.dia_spmv_v2_ref(torch.from_numpy(data), lins, x))
    assert dict(tk.launches) == before  # plain versions are not launches
    # each batch row is the unbatched product
    for r in range(3):
        assert torch.equal(y[r], tk.dia_spmv_v2_ref(torch.from_numpy(data),
                                                    lins, x[r]))


# ---------------------------------------------------------------------------
# K2's function: dia_spmv_const_ref against the JAX const kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stencil,dims", [
    (stencil_7pt(), (16, 16, 16)),
    (stencil_27pt(), (8, 8, 16)),
    (stencil_5pt(), (32, 32)),
])
def test_k2_plain_matches_jax(stencil, dims):
    J = jdia.dia_from_stencil(stencil, dims, dtype=jnp.float32)
    x = _x(J.n)
    y = tk.dia_spmv_const_ref(J.const_planes, J.offsets, dims,
                              torch.from_numpy(x)).numpy()
    y_pallas = dia_spmv_pallas_const(J.const_planes, J.offsets, dims,
                                     jnp.asarray(x), tile=1024, interpret=True)
    assert rel_err(y, y_pallas) <= TOL
    assert rel_err(y, jdia.dia_spmv(J, jnp.asarray(x))) <= TOL


def test_k2_wrapper_batched_on_cpu():
    A = tdia.dia_from_stencil(stencil_7pt(), (6, 5, 4), device="cpu")
    x = torch.from_numpy(_x(A.n, batch=2))
    y = tk.dia_spmv_const(A.const_planes, A.offsets, A.dims, x)
    for r in range(2):
        # synthesized planes equal the stored ones
        assert torch.equal(y[r], tk.dia_spmv_v2_ref(A.data, A.linear_offsets(),
                                                    x[r]))


def test_dia_spmv_router_on_cpu():
    A = tdia.dia_from_stencil(stencil_7pt(), (6, 5, 4), device="cpu")
    B = tdia.DiaMatrix(A.data, A.offsets, A.dims)  # same planes, no consts
    x = torch.from_numpy(_x(A.n))
    calls = dict(tdia.cuda_calls)
    assert torch.equal(tdia.dia_spmv(A, x), tdia.dia_spmv_ref(A, x))
    assert torch.equal(tdia.dia_spmv(B, x), tdia.dia_spmv_ref(B, x))
    assert dict(tdia.cuda_calls) == calls  # only CUDA calls are counted


def test_kernels_refuse_non_cpu_non_cuda_tensors():
    """A tensor that is not on the CPU never takes the plain version."""
    data = torch.zeros(3, 64, device="meta")
    x = torch.zeros(64, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_spmv_v2(data, (-1, 0, 1), x)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_spmv_const((1.0,), ((0,),), (64,), x)


def test_dia_matrix_validates_metadata():
    A = tdia.dia_from_stencil(stencil_5pt(), (4, 4), device="cpu")
    with pytest.raises(ValueError):
        tdia.DiaMatrix(A.data[:3], A.offsets, A.dims)
    with pytest.raises(ValueError):
        tdia.DiaMatrix(A.data, A.offsets, A.dims, const_planes=(1.0,) * 4)
    assert A.to("cpu").const_planes == A.const_planes


# ---------------------------------------------------------------------------
# other operations against JAX: offsets exact, planes within 1e-6
# ---------------------------------------------------------------------------

def _pair(dims, offsets, seed):
    data, _ = _planes(dims, offsets, seed)
    return (jdia.DiaMatrix(jnp.asarray(data), tuple(offsets), dims),
            tdia.DiaMatrix(torch.from_numpy(data), tuple(offsets), dims))


def _same(T, J):
    assert T.offsets == J.offsets and T.dims == J.dims
    assert rel_err(T.data.numpy(), J.data) <= TOL


DIMS = (6, 8, 10)


def test_dia_transpose():
    J, T = _pair(DIMS, OFFSETS[15], 0)
    _same(tdia.dia_transpose(T), jdia.dia_transpose(J))


@pytest.mark.parametrize("na,nb", [(7, 15), (27, 7)])
def test_dia_mult(na, nb):
    Ja, Ta = _pair(DIMS, OFFSETS[na], 1)
    Jb, Tb = _pair(DIMS, OFFSETS[nb], 2)
    _same(tdia.dia_mult(Ta, Tb), jdia.dia_mult(Ja, Jb))
    keep = lambda o: o[0] % 2 == 0  # noqa: E731
    _same(tdia.dia_mult(Ta, Tb, keep=keep), jdia.dia_mult(Ja, Jb, keep=keep))


def test_dia_rap():
    Jr, Tr = _pair(DIMS, OFFSETS[7][2:5], 3)
    Ja, Ta = _pair(DIMS, OFFSETS[7], 4)
    Jp, Tp = _pair(DIMS, OFFSETS[7][2:5], 5)
    _same(tdia.dia_rap(Tr, Ta, Tp), jdia.dia_rap(Jr, Ja, Jp))


def test_dia_add_filter_prune():
    Ja, Ta = _pair(DIMS, OFFSETS[7], 6)
    Jb, Tb = _pair(DIMS, OFFSETS[15], 7)
    _same(tdia.dia_add(Ta, Tb, 0.5, -2.0), jdia.dia_add(Ja, Jb, 0.5, -2.0))
    pred = lambda o: o[2] >= 0  # noqa: E731
    _same(tdia.dia_filter_offsets(Tb, pred), jdia.dia_filter_offsets(Jb, pred))
    zeroed = Ta.data.clone()
    zeroed[[1, 4]] = 0.0
    Tz = tdia.DiaMatrix(zeroed, Ta.offsets, DIMS)
    Jz = jdia.DiaMatrix(jnp.asarray(zeroed.numpy()), Ja.offsets, DIMS)
    _same(tdia.dia_prune(Tz), jdia.dia_prune(Jz))
    assert tdia.dia_prune(Tz).n_off == 5


@pytest.mark.parametrize("upper", [False, True])
def test_dia_tri_spmv(upper):
    st = stencil_7pt()
    J = jdia.dia_from_stencil(st, DIMS, dtype=jnp.float32)
    T = tdia.dia_from_stencil(st, DIMS, device="cpu")
    x = _x(T.n)
    y = tdia.dia_tri_spmv(T, torch.from_numpy(x), upper)
    assert rel_err(y.numpy(), jdia.dia_tri_spmv(J, jnp.asarray(x), upper)) <= TOL
