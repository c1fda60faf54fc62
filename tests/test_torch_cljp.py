"""The port's CLJP splitting (``setup/cljp.py``) and its threefry bits
(``utils/threefry.py``) against the JAX package on the CPU.

* threefry: ``fold_in``, the raw 32-bit draws and ``randint(0, 31)`` equal
  to ``jax.random``'s at n in {1, 7, 1000, 4097} and round in {0, 1, 5,
  499}, and ``split`` equal to ``jax.random.split``;
* ``cljp_splitting``: the C/F set equal to the reference's on its three
  property cases (``tests/unit/test_cljp.py``), with the reference's
  invariants checked on the port's output;
* whole CLJP hierarchies through ``api.setup``/``api.solve``: poisson_2d(32)
  with jacobi (the reference's convergence case) and shuffled 10^3 on the
  banded layout with cheb4 (no folded tail: folding a 1024-row CLJP tail
  costs both packages tens of seconds on the CPU); level sizes and
  iterations equal, true relres within the tolerance;
* a CLJP hierarchy on a detected grid, and the banded layout of levels
  too wide for any plan.

The reference's hierarchies are built once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import raptor_tpu.api as japi
from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.config import SolveConfig as JSolve
from raptor_tpu.core.ell import ell_from_csr as j_ell
from raptor_tpu.setup.cljp import cljp_splitting as j_cljp
from raptor_tpu.setup.splitting import make_perm as j_make_perm
from raptor_tpu.setup.strength import strength_mask as j_strength
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import ell_from_csr
from raptor_tpu_torch.gallery import (anisotropic_2d, default_rhs, poisson_2d,
                                      poisson_3d)
from raptor_tpu_torch.setup.cljp import cljp_splitting
from raptor_tpu_torch.setup.splitting import C_PT, F_PT, make_perm
from raptor_tpu_torch.setup.strength import strength_mask
from raptor_tpu_torch.utils import threefry
from tests._torch_ref import shuffled_poisson

NS = [1, 7, 1000, 4097]
ROUNDS = [0, 1, 5, 499]


def _key_words(key) -> tuple:
    return tuple(int(v) for v in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("it", ROUNDS)
@pytest.mark.parametrize("n", NS)
def test_threefry_matches_jax(n, it):
    jkey = jax.random.fold_in(jax.random.PRNGKey(17), it)
    key = threefry.fold_in(threefry.prng_key(17), it)
    assert key == _key_words(jkey)
    bits = threefry.random_bits(key, n, device="cpu")
    jbits = np.asarray(jax.random.bits(jkey, (n,), jnp.uint32))
    assert np.array_equal(bits.numpy(), jbits.astype(np.int64))
    got = threefry.cljp_bits(it, n, device="cpu")
    ref = np.asarray(jax.random.randint(jkey, (n,), 0, 31, dtype=jnp.int32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("span", [(0, 31), (3, 4), (-5, 1000)])
def test_split_and_randint_spans_match_jax(span):
    jkey = jax.random.PRNGKey(5)
    a, b = threefry.split(threefry.prng_key(5))
    ja, jb = jax.random.split(jkey)
    assert (a, b) == (_key_words(ja), _key_words(jb))
    got = threefry.randint(threefry.prng_key(5), 513, *span, device="cpu")
    ref = jax.random.randint(jkey, (513,), *span, dtype=jnp.int32)
    assert np.array_equal(got.numpy(), np.asarray(ref))


CASES = {
    "poisson_2d(12)": (lambda: poisson_2d(12), 0.25),
    "poisson_3d(6)": (lambda: poisson_3d(6), 0.25),
    "anisotropic_2d(10)": (
        lambda: anisotropic_2d(10, epsilon=1e-2, theta=0.5), 0.35),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cljp_splitting_equals_reference(case):
    gen, theta = CASES[case]
    A = sp.csr_matrix(gen())
    n = A.shape[0]
    E = ell_from_csr(A, dtype=np.float64).to("cpu")
    sm = strength_mask(E, theta, "classical")
    cf = cljp_splitting(E, sm, make_perm(n, E.n_rows_pad, 0, device="cpu"))
    cf = cf.numpy()
    J = j_ell(A, dtype=np.float64)
    ref = np.asarray(j_cljp(J, j_strength(J, theta, "classical"),
                            j_make_perm(n, J.n_rows_pad, 0)))
    assert np.array_equal(cf, ref)

    # the reference's invariants, on the port's output
    assert set(np.unique(cf)) <= {C_PT, F_PT}
    assert (cf[n:] == F_PT).all()
    assert 0 < int((cf[:n] == C_PT).sum()) < n
    smn, cols = sm.numpy(), E.cols.numpy()
    for i in np.flatnonzero(cf[:n] == F_PT):
        deps = cols[smn[:, i], i]
        if deps.size:
            assert (cf[deps] == C_PT).any(), f"F point {i} has no C influence"


HIER = {
    "poisson_2d(32) jacobi": (
        lambda: sp.csr_matrix(poisson_2d(32)),
        dict(splitting="cljp", smoother="jacobi"),
        dict(dtype="float64")),
    "shuffled 10^3 banded cheb4": (
        lambda: shuffled_poisson(10),
        dict(splitting="cljp", interp="direct", fine_layout="banded",
             smoother="cheb4", cheb_degree=2, tail_max_n=0),
        dict(tol=1e-8, refine=True)),
}


@pytest.fixture(scope="module")
def jsolves():
    """The reference's hierarchy sizes and solves, one per case."""
    out = {}
    for name, (mk, cfg, sc) in HIER.items():
        A = mk()
        b = default_rhs(A.shape[0])
        h = japi.setup(A, JCfg(**cfg),
                       dtype=np.float64 if sc.get("dtype") else np.float32)
        _, info = japi.solve(A, b, JCfg(**cfg), JSolve(**sc), hier=h)
        out[name] = ([lv.n for lv in h.levels], info["iterations"])
    return out


@pytest.mark.parametrize("name", sorted(HIER))
def test_cljp_hierarchy_matches_reference(jsolves, name):
    mk, cfg, sc = HIER[name]
    A = mk()
    b = default_rhs(A.shape[0])
    x, info = tapi.solve(A, b, TCfg(**cfg), TSolve(**sc), device="cpu")
    sizes, iters = jsolves[name]
    assert info["stats"]["sizes"] == sizes
    assert info["iterations"] == iters
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8


def test_cljp_on_a_detected_grid_leaves_the_chain_at_the_threshold():
    """A repair: natural-ordered 8^3 in plane mode with the threshold at
    300 rows.  The geo chain builds the level above it; below, the port
    goes on with CLJP levels, where the reference plans an empty chain and
    fails."""
    A = sp.csr_matrix(poisson_3d(8))
    b = default_rhs(A.shape[0])
    cfg = dict(splitting="cljp", interp="direct", fine_layout="banded",
               smoother="cheb4", cheb_degree=2, host_setup_threshold=300,
               tail_max_n=0)
    h = tapi.setup(A, TCfg(**cfg), device="cpu")
    assert h.levels[0].Tgeo is not None
    assert all(lv.Tgeo is None for lv in h.levels[1:])
    assert [lv.n for lv in h.levels[:2]] == [512, 256]
    x, info = tapi.solve(A, b, TCfg(**cfg), TSolve(tol=1e-8, refine=True),
                         hier=h)
    assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) <= 1e-8
    with pytest.raises(ValueError, match="at least one array"):
        japi.setup(A, JCfg(**cfg))


@pytest.mark.parametrize("K", [800, 832])
def test_banded_layout_of_wide_levels(K):
    """CLJP's coarse levels reach thousands of slots.  ``banded_from_ell``
    gives them no layout without planning when no plan of that many slots
    passes the plan caps in any ordering (``slots_fit``: from 832 slots at
    fp32); a narrower level still plans."""
    from raptor_tpu_torch.core.ell import EllMatrix
    from raptor_tpu_torch.core.hybrid import banded_from_ell
    from raptor_tpu_torch.ops.banded_plan import (BandedPlanError,
                                                  banded_plan, slots_fit)

    n = 2048
    rows = np.arange(n)
    cols = np.clip(rows[None, :] + np.arange(K)[:, None] - K // 2, 0, n - 1)
    cols = np.sort(cols, axis=0).astype(np.int32)
    vals = np.random.default_rng(0).standard_normal((K, n)).astype(np.float32)
    nnz = np.full(n, K, np.int32)
    E = EllMatrix(data=vals, cols=cols, row_nnz=nnz, shape=(n, n),
                  n_rows_pad=n, n_cols_pad=n)
    fits = slots_fit(K, 1024, 4)
    assert fits == (K < 832)
    if fits:
        assert banded_plan(cols, nnz, vals, tile=1024)["K"] == K
        assert banded_from_ell(E) is not None
    else:
        with pytest.raises(BandedPlanError):
            banded_plan(cols, nnz, vals, tile=1024)
        assert banded_from_ell(E, reorder=True) is None
