"""The V-cycle byte counts against hand counts on 3-level 16^3
hierarchies, and one operator counted alike in its structured and its
shuffled layout."""

import numpy as np
import torch

from amgbench import counts, spec
from amgbench.generator import Stream

N = 16
DEV = torch.device("cpu")


def _engine(cell, **amg):
    _, config, mix = spec.resolve(cell, {"n": N})
    config = {**config, "amg": {**config["amg"], **amg}}
    e = spec.load_engine(config["engine"]).Engine(config, Stream(mix, 5), DEV)
    e.setup()
    return e


def _dense(m):
    """A DIA operator as a dense matrix, through the program's own apply."""
    from raptor_tpu_torch.structured.dia import dia_spmv

    eye = torch.eye(m.n, dtype=torch.float64)
    return dia_spmv(type(m)(data=m.data.double(), offsets=m.offsets,
                            dims=m.dims), eye).T.numpy()


def test_structured_hand_count():
    e = _engine("structured-solve", coarse_size=1024, tail_max_n=0)
    h = e.h
    assert [lv.A.n for lv in h.levels] == [4096, 2048, 1024]
    vb, xb, deg = 2, 4, 2  # bf16 values, fp32 vectors, cheb4 degree 2
    want = 0
    for k in range(2):
        n, nc = h.levels[k].A.n, h.levels[k + 1].A.n
        nnz_a = np.count_nonzero(_dense(h.levels[k].A))
        nnz_p = np.count_nonzero(_dense(h.levels[k].Pt))
        a_vals = 0 if k == 0 else nnz_a * vb  # the fine level is a constant stencil
        want += 2 * deg * (a_vals + 2 * n * xb) + 2 * (nnz_p * vb + (n + nc) * xb)
        if k == 0:
            assert nnz_a == 7 * 4096 - 6 * 256
            # identity at the 8 coarse planes, two weights at 7 fine
            # planes and one at the last (its outer neighbour is off the grid)
            assert nnz_p == 8 * 256 + 15 * 256
    want += 1024 * 1024 * vb + 2 * 1024 * xb  # the coarse inverse
    assert e.counts()["vcycle_bytes"] == want


def test_algebraic_hand_count():
    from raptor_tpu_torch.core.ell import ell_to_csr

    e = _engine("shuffled-solve", tail_max_n=0)
    h = e.h
    assert len(h.levels) >= 3
    vb, xb, deg = 4, 4, 2
    want = 0
    for k in range(len(h.levels) - 1):
        lv, n, nc = h.levels[k], h.levels[k].n, h.levels[k + 1].n
        nnz_a = ell_to_csr(lv.A).nnz
        nnz_p = ell_to_csr(lv.P).nnz
        want += 2 * deg * (nnz_a * vb + 2 * n * xb) + 2 * (nnz_p * vb + (n + nc) * xb)
    nt = h.levels[-1].n
    want += nt * nt * vb + 2 * nt * xb
    assert e.counts()["vcycle_bytes"] == want


def test_one_operator_counts_alike_in_both_layouts():
    """The 7-point operator on 16^3: its DIA planes and the ELL of its
    shuffled CSR hold the same non-zeros, so an application counts the same
    bytes at one precision."""
    from amgbench.engines.algebraic import _nnz_ell
    from amgbench.engines.structured import _nnz_dia, stencil_operator
    from amgbench.reference import shuffled, stencil
    from raptor_tpu_torch.core.ell import ell_from_csr

    dia = stencil_operator(stencil.poisson7(), (N,) * 3, DEV)
    ell = ell_from_csr(shuffled.shuffled_poisson7(N), dtype=np.float32,
                       row_pad_multiple=1024)
    assert _nnz_dia(dia) == _nnz_ell(ell) == 7 * N**3 - 6 * N**2
    b = [counts.apply_bytes(nnz, N**3, N**3, 4, 4)
         for nnz in (_nnz_dia(dia), _nnz_ell(ell))]
    assert b[0] == b[1] == (7 * N**3 - 6 * N**2) * 4 + 2 * N**3 * 4
    assert counts.apply_bytes(123, 10, 10, 4, 4, const=True) == 80
