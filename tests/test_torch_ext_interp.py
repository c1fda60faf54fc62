"""The port's extended+i interpolation on the full operator
(``setup/interp.py::extended_interpolation``) against the JAX package's on
the CPU, on the reference test's inputs (``tests/unit/test_extended_interp
.py``): PMIS on 3D Poisson 10^3, natural and shuffled, with and without
P_max truncation, in fp64; and the 7-point fp32 case where the strength-
compacted form equals the full one.  P's structure (columns, row counts)
is exact and its values within 1e-12 relative (fp64) or 1e-6 (fp32); the
port's P equals the reference's host oracle
(``np_distance_two_interpolation``) to 1e-12."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raptor_tpu.core.ell import ell_from_csr as j_ell
from raptor_tpu.setup.host_setup import np_distance_two_interpolation
from raptor_tpu.setup.interp import extended_interpolation as j_ext
from raptor_tpu.setup.splitting import make_perm as j_make_perm
from raptor_tpu.setup.splitting import pmis_splitting as j_pmis
from raptor_tpu.setup.strength import strength_mask as j_strength
from raptor_tpu_torch.core.ell import _np, ell_from_csr
from raptor_tpu_torch.gallery import poisson_3d
from raptor_tpu_torch.setup.interp import (extended_interpolation,
                                           extended_interpolation_strong)
from tests._torch_ref import rel_err
from tests.unit.test_extended_interp import _problem

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _csr(P) -> sp.csr_matrix:
    data, cols, nnz = _np(P.data), _np(P.cols), _np(P.row_nnz)
    K, n = data.shape
    m = np.arange(K)[:, None] < nnz[None, :]
    rows = np.broadcast_to(np.arange(n)[None, :], (K, n))
    return sp.coo_matrix((data[m], (rows[m], cols[m])),
                         shape=(n, P.n_cols_pad)).tocsr()


def _same_p(Pt, Pj, dtype):
    assert np.array_equal(_np(Pt.cols), np.asarray(Pj.cols))
    assert np.array_equal(_np(Pt.row_nnz), np.asarray(Pj.row_nnz))
    assert rel_err(_np(Pt.data), np.asarray(Pj.data)) <= TOL[dtype]


@pytest.mark.parametrize("shuffle,p_max", [(False, 4), (True, 4), (False, 0)])
def test_extended_matches_reference(shuffle, p_max):
    A, _, data, cols, nnz, smask, cf = _problem(shuffle=shuffle)
    E = ell_from_csr(A, dtype=np.float64, row_pad_multiple=64).to("cpu")
    Pt, nc = extended_interpolation(E, torch.from_numpy(smask),
                                    torch.from_numpy(cf), p_max=p_max)
    J = j_ell(A, dtype=np.float64, row_pad_multiple=64)
    Pj, ncj = j_ext(J, jnp.asarray(smask), jnp.asarray(cf), p_max=p_max)
    assert int(nc) == int(ncj)
    _same_p(Pt, Pj, np.float64)
    # and the reference's host oracle
    P_ref, nc_ref = np_distance_two_interpolation(
        data, cols, nnz, smask, cf, variant="extended", p_max=p_max)
    assert int(nc) == nc_ref
    d = _csr(Pt)[:, :nc_ref] - sp.csr_matrix(P_ref)
    scale = np.abs(sp.csr_matrix(P_ref).data).max()
    assert (np.abs(d.data).max() if d.nnz else 0.0) <= 1e-12 * scale


def test_strong_equals_full_when_all_strong():
    """7-point Poisson: every off-diagonal is strong and K = 7 <= k_s, so
    the strength-compacted ext+i sees the same entries as the full one."""
    A = sp.csr_matrix(poisson_3d(10))
    E = ell_from_csr(A, dtype=np.float32).to("cpu")
    J = j_ell(A, dtype=np.float32)
    sm = j_strength(J, 0.25, "classical")
    cf = j_pmis(J, sm, j_make_perm(10**3, J.n_rows_pad, 0))
    smt, cft = torch.from_numpy(np.array(sm)), torch.from_numpy(np.array(cf))
    P1, nc1 = extended_interpolation(E, smt, cft, p_max=4)
    P2, nc2 = extended_interpolation_strong(E, smt, cft, p_max=4)
    assert int(nc1) == int(nc2)
    assert abs(_csr(P1) - _csr(P2)).max() < 1e-6
    Pj, ncj = j_ext(J, sm, cf, p_max=4)
    assert int(nc1) == int(ncj)
    _same_p(P1, Pj, np.float32)
