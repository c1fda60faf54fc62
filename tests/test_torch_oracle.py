"""The port's setup against the independent NumPy/SciPy oracle
(``tests/oracle/amg_oracle.py``), as ``tests/unit/test_setup.py`` holds the
reference: strength of connection and the transpose counts, the PMIS C/F
set (device route and host route), the serial RS splitting, direct and
modified classical interpolation, and config 1's PCG iteration count
(``tests/integration/test_configs.py``) within one of the oracle's."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.config import AmgConfig, SolveConfig
from raptor_tpu_torch.core.ell import ell_from_csr, ell_to_csr
from raptor_tpu_torch.gallery import (anisotropic_2d, default_rhs, poisson_2d,
                                      poisson_3d)
from raptor_tpu_torch.setup import (C_PT, F_PT, classical_interpolation,
                                    direct_interpolation, make_perm,
                                    pmis_splitting, rs_splitting_host,
                                    strength_mask, strong_transpose_counts,
                                    tighten_coarse_space)
from raptor_tpu_torch.setup.host_setup import (np_pmis_splitting,
                                               np_strength_mask)
from raptor_tpu_torch.setup.splitting import make_perm_np
from tests.oracle import amg_oracle as oracle


def _ell(A):
    return ell_from_csr(sp.csr_matrix(A), dtype=np.float64).to("cpu")


def _strength_csr(E, sm) -> sp.csr_matrix:
    sm = sm.numpy() if isinstance(sm, torch.Tensor) else np.asarray(sm)
    cols = np.asarray(E.cols)
    rows = np.broadcast_to(np.arange(E.n_rows_pad), sm.shape)
    n = E.shape[0]
    return sp.coo_matrix((np.ones(int(sm.sum())), (rows[sm], cols[sm])),
                         shape=(E.n_rows_pad, E.n_rows_pad)).tocsr()[:n, :n]


STRENGTH = {
    "poisson_2d(13)": (lambda: poisson_2d(13), 0.25),
    "poisson_3d(7)": (lambda: poisson_3d(7), 0.25),
    "anisotropic_2d(11)": (
        lambda: anisotropic_2d(11, epsilon=1e-2, theta=0.4), 0.35),
}


@pytest.mark.parametrize("case", sorted(STRENGTH))
def test_strength_matches_oracle(case):
    gen, theta = STRENGTH[case]
    A = gen()
    E = _ell(A)
    sm = strength_mask(E, theta, "classical")
    S_or = oracle.classical_strength(A, theta)
    assert (_strength_csr(E, sm) != S_or).nnz == 0
    lam = strong_transpose_counts(E, sm).numpy()[: A.shape[0]]
    assert np.array_equal(lam, np.asarray(S_or.T.tocsr().sum(axis=1)).ravel())
    # the host route's strength too
    smh = np_strength_mask(E.data.numpy(), E.cols.numpy(), E.row_nnz.numpy(),
                           theta, "classical")
    assert (_strength_csr(E, smh) != S_or).nnz == 0


PMIS = {
    "poisson_2d(12)": lambda: poisson_2d(12),
    "poisson_3d(6)": lambda: poisson_3d(6),
    "anisotropic_2d(10)": lambda: anisotropic_2d(10, epsilon=1e-3, theta=0.5),
}


@pytest.mark.parametrize("case", sorted(PMIS))
def test_pmis_matches_oracle(case):
    A = PMIS[case]()
    n = A.shape[0]
    E = _ell(A)
    sm = strength_mask(E, 0.25, "classical")
    cf = pmis_splitting(E, sm, make_perm(n, E.n_rows_pad, 0, device="cpu"))
    cf_or = oracle.pmis_splitting(oracle.classical_strength(A, 0.25), seed=0)
    assert np.array_equal(cf.numpy()[:n], cf_or)
    assert (cf.numpy()[n:] == F_PT).all()
    cfh = np_pmis_splitting(E.cols.numpy(), sm.numpy(),
                            make_perm_np(n, E.n_rows_pad, 0), E.n_rows_pad)
    assert np.array_equal(np.asarray(cfh)[:n], cf_or)


def test_rs_matches_oracle():
    A = anisotropic_2d(12, epsilon=1e-2, theta=0.3)
    S = oracle.classical_strength(A, 0.25)
    assert np.array_equal(rs_splitting_host(S), oracle.rs_splitting(S))


INTERP = {
    "direct poisson_2d(12)": (direct_interpolation, oracle.direct_interpolation,
                              lambda: poisson_2d(12), 0.25),
    "classical poisson_2d(12)": (classical_interpolation,
                                 oracle.classical_interpolation,
                                 lambda: poisson_2d(12), 0.25),
    "classical anisotropic_2d(9)": (
        classical_interpolation, oracle.classical_interpolation,
        lambda: anisotropic_2d(9, epsilon=1e-2, theta=0.6), 0.35),
}


@pytest.mark.parametrize("case", sorted(INTERP))
def test_interpolation_matches_oracle(case):
    interp, interp_or, gen, theta = INTERP[case]
    A = gen()
    n = A.shape[0]
    E = _ell(A)
    sm = strength_mask(E, theta, "classical")
    cf = pmis_splitting(E, sm, make_perm(n, E.n_rows_pad, 0, device="cpu"))
    P_wide, nc = interp(E, sm, cf)
    P = tighten_coarse_space(P_wide, int(nc))
    S = oracle.classical_strength(A, theta)
    P_or = interp_or(A, S, oracle.pmis_splitting(S, seed=0))
    assert int(nc) == P_or.shape[1]
    assert int((cf.numpy()[:n] == C_PT).sum()) == P_or.shape[1]
    got = ell_to_csr(P).toarray()[:n, : P_or.shape[1]]
    assert np.allclose(got, P_or.toarray(), rtol=0, atol=1e-12)


def test_config1_iterations_match_oracle():
    """Config 1 (RS, weighted Jacobi, PCG) on 2D Poisson 64^2: the port's
    iteration count within one of the oracle's."""
    A = poisson_2d(64)
    b = default_rhs(A.shape[0])
    _, it_oracle, _ = oracle.amg_pcg(A, b, tol=1e-8, splitting="rs")
    x, info = tapi.solve(A, b, AmgConfig(splitting="rs", smoother="jacobi"),
                         SolveConfig(dtype="float64"), device="cpu")
    assert info["relres"] <= 1e-8
    assert abs(info["iterations"] - it_oracle) <= 1
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
