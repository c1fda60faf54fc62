"""The plain references against SciPy, and the harness's inputs against
the program's own constructors."""

import numpy as np
import scipy.sparse as sp
import torch

from amgbench.reference import shuffled, stencil


def test_stencil_residual_matches_scipy_at_12():
    n = 12
    A = shuffled.poisson7_csr(n)
    rng = np.random.default_rng(1)
    x, b = rng.standard_normal(n ** 3), rng.standard_normal(n ** 3)
    want = np.linalg.norm(b - A @ x) / np.linalg.norm(b)
    st = stencil.poisson7()
    assert abs(stencil.relres(st, x, b, (n,) * 3) - want) <= 1e-14 * want
    got_t = stencil.relres(st, torch.from_numpy(x), torch.from_numpy(b), (n,) * 3)
    assert abs(got_t - want) <= 1e-14 * want
    assert abs(shuffled.relres(A, x, b) - want) <= 1e-14 * want


def test_shifted_stencil_matches_scipy():
    n, sig = 12, 0.0375
    st = stencil.poisson7(sig)
    diag = float(np.float32(6.0 + sig))
    assert st[1, 1, 1] == diag
    A = shuffled.poisson7_csr(n) + (diag - 6.0) * sp.identity(n ** 3)
    x = np.random.default_rng(2).standard_normal(n ** 3)
    assert np.allclose(stencil.apply(st, x, (n,) * 3), A @ x, rtol=0, atol=1e-12)


def test_anisotropic_dims():
    dims = (5, 7, 3)
    x = np.random.default_rng(3).standard_normal(int(np.prod(dims)))
    st = stencil.poisson7()
    T = [sp.diags([-np.ones(d - 1), 2 * np.ones(d), -np.ones(d - 1)], [-1, 0, 1])
         for d in dims]
    I = [sp.identity(d) for d in dims]
    A = (sp.kron(sp.kron(T[0], I[1]), I[2]) + sp.kron(sp.kron(I[0], T[1]), I[2])
         + sp.kron(sp.kron(I[0], I[1]), T[2]))
    assert np.allclose(stencil.apply(st, x, dims), A @ x, rtol=0, atol=1e-12)


def test_shuffled_matrix_is_the_reference_benchs():
    """The harness's CSR equals the program's gallery operator permuted by
    default_rng(0), as the reference bench builds it."""
    from raptor_tpu_torch.gallery import poisson_3d

    n = 8
    A = sp.csr_matrix(poisson_3d(n))
    p = np.random.default_rng(0).permutation(A.shape[0])
    want = A[p][:, p].tocsr()
    got = shuffled.shuffled_poisson7(n, 0)
    assert (abs(got - want)).max() == 0
    assert got.dtype == np.float64


def test_device_operator_equals_dia_from_stencil():
    from raptor_tpu_torch import dia_from_stencil

    from amgbench.engines.structured import stencil_operator

    for sig, dims in ((0.0, (6, 5, 4)), (0.0412, (8, 8, 8))):
        st = stencil.poisson7(sig)
        want = dia_from_stencil(st, dims, device="cpu")
        got = stencil_operator(st, dims, torch.device("cpu"))
        assert got.offsets == want.offsets and got.dims == want.dims
        assert got.const_planes == want.const_planes
        assert torch.equal(got.data, want.data)
