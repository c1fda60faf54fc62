"""The port's device-level algebraic setup functions (strength, PMIS,
interpolation, the power-iteration lmax, the two level programs) against
the JAX package's, on identical inputs on the CPU.

Inputs: the levels of a host-built shuffled 12^3 hierarchy padded to 128
rows (widths 7, then the coarse levels' wide Galerkin rows) and a 27-point
8^3 operator whose rows outgrow the strength compaction, in fp32 and fp64.
``strength_mask`` and the PMIS C/F sets exact (with ``make_perm``, and
with ``make_perm_ids`` on a permuted input, where the C/F set is also the
unpermuted one's); direct, classical and strength-compacted extended
interpolation with P's structure exact and values within 1e-6 relative
(fp32) or 1e-12 (fp64); ``estimate_lmax`` within 1e-5 in fp32 (the two
packages' sin and sum orders differ in the last bits, and 40 rounds of
power iteration carry that); ``_fused_level``'s P, R, Ac, C/F set, dinv
and lmax.  Whole builds are in ``tests/test_torch_devsetup_builds.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.config import AmgConfig as JCfg
from raptor_tpu.core.ell import EllMatrix as JEll
from raptor_tpu.setup.hierarchy import _fused_level as j_fused_level
from raptor_tpu.setup.interp import (classical_interpolation as j_classical,
                                     direct_interpolation as j_direct,
                                     extended_interpolation_strong as j_ext)
from raptor_tpu.setup.splitting import make_perm as j_make_perm
from raptor_tpu.setup.splitting import make_perm_ids as j_make_perm_ids
from raptor_tpu.setup.splitting import pmis_splitting as j_pmis
from raptor_tpu.setup.splitting import splitting_weights as j_weights
from raptor_tpu.setup.strength import strength_mask as j_strength
from raptor_tpu.solve.smoothers import estimate_lmax as j_lmax
import raptor_tpu_torch.api as tapi
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.core.ell import EllMatrix as TEll
from raptor_tpu_torch.core.ell import _np, ell_from_csr
from raptor_tpu_torch.gallery import laplacian_27pt
from raptor_tpu_torch.setup.hierarchy import _fused_level as t_fused_level
from raptor_tpu_torch.setup.hierarchy import build_hierarchy
from raptor_tpu_torch.setup.interp import (classical_interpolation as t_classical,
                                           direct_interpolation as t_direct,
                                           extended_interpolation_strong as t_ext)
from raptor_tpu_torch.setup.splitting import C_PT
from raptor_tpu_torch.setup.splitting import make_perm as t_make_perm
from raptor_tpu_torch.setup.splitting import make_perm_ids as t_make_perm_ids
from raptor_tpu_torch.setup.splitting import pmis_splitting as t_pmis
from raptor_tpu_torch.setup.splitting import splitting_weights as t_weights
from raptor_tpu_torch.setup.strength import strength_mask as t_strength
from raptor_tpu_torch.solve.smoothers import estimate_lmax as t_lmax
from tests._torch_ref import rel_err, shuffled_poisson

TOL = {np.float32: 1e-6, np.float64: 1e-12}
LMAX_TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
DT_IDS = ["fp32", "fp64"]
LEVELS = ["L0", "L1", "L2", "lap27"]
INTERPS = {"direct": (j_direct, t_direct), "classical": (j_classical, t_classical),
           "extended": (j_ext, t_ext)}


def _pair(arrays: dict):
    """A JAX and a port (CPU tensors) EllMatrix of the same arrays."""
    meta = {k: arrays[k] for k in ("shape", "n_rows_pad", "n_cols_pad")}
    return (JEll(data=jnp.asarray(arrays["data"]),
                 cols=jnp.asarray(arrays["cols"]),
                 row_nnz=jnp.asarray(arrays["row_nnz"]), **meta),
            TEll(data=torch.from_numpy(np.array(arrays["data"])),
                 cols=torch.from_numpy(np.array(arrays["cols"])),
                 row_nnz=torch.from_numpy(np.array(arrays["row_nnz"])), **meta))


def _arrays(E) -> dict:
    return dict(data=_np(E.data), cols=_np(E.cols), row_nnz=_np(E.row_nnz),
                shape=E.shape, n_rows_pad=E.n_rows_pad, n_cols_pad=E.n_cols_pad)


@pytest.fixture(scope="module")
def level_inputs():
    """{(dtype, name): ELL arrays}: levels 0-2 of the port's host-built
    shuffled 12^3 hierarchy (PMIS, extended, rows padded to 128: widths 7,
    then the coarse levels' wide Galerkin rows) and a 27-point 8^3
    operator padded to 640 rows."""
    out = {}
    for dt in DTYPES:
        h = tapi.setup(shuffled_poisson(12),
                       TCfg(splitting="pmis", interp="extended",
                            pad_multiple=128), dtype=dt, device="cpu")
        for i in range(3):
            out[(dt, f"L{i}")] = _arrays(h.levels[i].A)
        out[(dt, "lap27")] = _arrays(ell_from_csr(laplacian_27pt(8), dtype=dt,
                                                  row_pad_multiple=640))
    return out


def _same_ell(te, je, tol, what=""):
    assert (te is None) == (je is None), what
    if te is None:
        return
    assert (te.shape, te.n_rows_pad, te.n_cols_pad) == (
        je.shape, je.n_rows_pad, je.n_cols_pad), what
    assert np.array_equal(_np(te.cols), np.asarray(je.cols)), what
    assert np.array_equal(_np(te.row_nnz), np.asarray(je.row_nnz)), what
    assert rel_err(_np(te.data), np.asarray(je.data)) <= tol, what


# ---------------------------------------------------------------------------
# level functions on identical inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", LEVELS)
@pytest.mark.parametrize("kind", ["classical", "abs"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_strength_mask_matches_reference(level_inputs, dtype, kind, name):
    jA, tA = _pair(level_inputs[(dtype, name)])
    j = np.asarray(j_strength(jA, 0.25, kind))
    t = t_strength(tA, 0.25, kind)
    assert t.dtype == torch.bool and np.array_equal(t.numpy(), j)
    assert j.any()


@pytest.mark.parametrize("name", LEVELS)
def test_pmis_splitting_matches_reference(level_inputs, name):
    jA, tA = _pair(level_inputs[(np.float32, name)])
    n, n_pad = tA.shape[0], tA.n_rows_pad
    jp, tp = j_make_perm(n, n_pad, 5), t_make_perm(n, n_pad, 5, device="cpu")
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    jcf = np.asarray(j_pmis(jA, j_strength(jA, 0.25), jp))
    tcf = t_pmis(tA, t_strength(tA, 0.25), tp)
    assert tcf.dtype == torch.int32 and np.array_equal(tcf.numpy(), jcf)
    assert 0 < (jcf == C_PT).sum() < n and (jcf[n:] != C_PT).all()


@pytest.mark.parametrize("n_pad", [1 << 20, 1 << 26], ids=["int32", "int64"])
def test_splitting_weights_match_reference(n_pad):
    """min(lam, 63) * n_pad + perm, exact: int32 up to 2**25 rows, int64
    above, where int32 would wrap."""
    rng = np.random.default_rng(8)
    lam = rng.integers(0, 80, 1000).astype(np.int32)
    perm = rng.permutation(n_pad)[:1000].astype(np.int32)
    j = np.asarray(j_weights(jnp.asarray(lam), jnp.asarray(perm), n_pad))
    t = t_weights(torch.from_numpy(lam), torch.from_numpy(perm), n_pad)
    assert t.dtype == (torch.int32 if n_pad <= 1 << 25 else torch.int64)
    assert np.array_equal(t.numpy(), j)
    assert np.array_equal(t.numpy(), np.minimum(lam, 63).astype(np.int64)
                          * n_pad + perm)


def test_pmis_with_row_ids_is_permutation_invariant(level_inputs):
    """make_perm_ids on a symmetrically permuted input: both packages give
    the same C/F set, and it is the unpermuted input's, permuted."""
    import scipy.sparse as sp

    from raptor_tpu_torch.core.ell import ell_to_csr

    base = level_inputs[(np.float32, "L0")]
    a = ell_to_csr(TEll(**{k: base[k] for k in
                           ("data", "cols", "row_nnz", "shape", "n_rows_pad",
                            "n_cols_pad")}))
    n = a.shape[0]
    q = np.random.default_rng(6).permutation(n)
    aq = sp.csr_matrix(a)[q][:, q].tocsr()
    arrays = _arrays(ell_from_csr(aq, dtype=np.float32, row_pad_multiple=128))
    jA, tA = _pair(arrays)
    jp = j_make_perm_ids(q, tA.n_rows_pad, 3)
    tp = t_make_perm_ids(q, tA.n_rows_pad, 3, device="cpu")
    assert np.array_equal(tp.numpy(), np.asarray(jp))
    jcf = np.asarray(j_pmis(jA, j_strength(jA, 0.25), jp))
    tcf = t_pmis(tA, t_strength(tA, 0.25), tp).numpy()
    assert np.array_equal(tcf, jcf)
    jA0, tA0 = _pair(base)
    cf0 = t_pmis(tA0, t_strength(tA0, 0.25),
                 t_make_perm(n, tA0.n_rows_pad, 3, device="cpu")).numpy()
    assert np.array_equal(tcf[:n], cf0[q])


@pytest.mark.parametrize("name", ["L0", "L1", "lap27"])
@pytest.mark.parametrize("interp", list(INTERPS))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_interpolation_matches_reference(level_inputs, dtype, interp, name):
    jA, tA = _pair(level_inputs[(dtype, name)])
    n, n_pad = tA.shape[0], tA.n_rows_pad
    jsm = j_strength(jA, 0.25)
    jcf = j_pmis(jA, jsm, j_make_perm(n, n_pad, 2))
    jf, tf = INTERPS[interp]
    jP, jnc = jf(jA, jsm, jcf)
    tP, tnc = tf(tA, t_strength(tA, 0.25), torch.from_numpy(np.array(jcf)))
    assert int(tnc) == int(jnc)
    assert tP.data.dtype == tA.data.dtype
    _same_ell(tP, jP, TOL[dtype], interp)


def test_strength_compaction_drops_entries(level_inputs):
    """lap27 rows hold 26 strong couplings, more than EXT_STRONG_MAX_K:
    the compacted operator keeps 12 and lumps the rest (the path the
    parity above covers)."""
    from raptor_tpu_torch.setup.interp import EXT_STRONG_MAX_K, strength_compact

    _, tA = _pair(level_inputs[(np.float32, "lap27")])
    S, dii0 = strength_compact(tA, t_strength(tA, 0.25), EXT_STRONG_MAX_K)
    assert S.K == EXT_STRONG_MAX_K and int(S.row_nnz.max()) == EXT_STRONG_MAX_K
    assert (dii0 < tA.diagonal()).any()


@pytest.mark.parametrize("name", LEVELS)
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_estimate_lmax_matches_reference(level_inputs, dtype, name):
    jA, tA = _pair(level_inputs[(dtype, name)])
    jd = 1.0 / jA.diagonal()
    td = 1.0 / tA.diagonal()
    got = float(t_lmax(tA, td))
    assert abs(got - float(j_lmax(jA, jd))) <= LMAX_TOL[dtype] * abs(got)


@pytest.mark.parametrize("interp,dtype", [
    ("direct", np.float32), ("extended", np.float32), ("classical", np.float64)])
def test_fused_level_matches_reference(level_inputs, interp, dtype):
    jA, tA = _pair(level_inputs[(dtype, "L1")])
    n = tA.shape[0]
    kw = dict(splitting="pmis", interp=interp, smoother="cheb4",
              pad_multiple=128)
    jo = j_fused_level(jA, n, JCfg(**kw), 4)
    to = t_fused_level(tA, n, TCfg(**kw), 4)
    assert to[3] == jo[3] > 0  # nc
    assert np.array_equal(to[6], np.asarray(jo[6]))  # cf
    for i, what in enumerate(("P", "R", "Ac")):
        _same_ell(to[i], jo[i], TOL[dtype], what)
    assert rel_err(to[4].numpy(), np.asarray(jo[4])) <= TOL[dtype]  # dinv
    assert rel_err(to[5].numpy(), np.asarray(jo[5])) <= LMAX_TOL[dtype]


@pytest.mark.parametrize("name", ["L1", "L2", "lap27"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_fat_interp_refine_matches_reference(level_inputs, dtype, name):
    """``fat_interp_refine`` on a fat level (every input here but L0 is
    wider than EXT_DEVICE_MAX_K): the Jacobi sweep on the
    strength-compacted ext+i (``aggressive.jacobi_refine_p``) gives the
    reference's C/F set and P's row sums within TOL.  On the Galerkin
    levels P, R and Ac also match (structure exact, values within TOL).
    On lap27's constant 27-point stencil the truncation to p_max chooses
    among equal weights, which rounding orders (fp64 keeps other entries
    than the reference there); the kept parts are rescaled to the full
    row sums, so the sums hold on every input."""
    jA, tA = _pair(level_inputs[(dtype, name)])
    n = tA.shape[0]
    kw = dict(splitting="pmis", interp="extended", fat_interp_refine=1,
              pad_multiple=128)
    jo = j_fused_level(jA, n, JCfg(**kw), 0)
    to = t_fused_level(tA, n, TCfg(**kw), 0)
    assert to[3] == jo[3] > 0
    assert np.array_equal(to[6], np.asarray(jo[6]))
    sums = [np.where(np.arange(P.K)[:, None] < _np(P.row_nnz)[None, :],
                     _np(P.data), 0).sum(0) for P in (to[0], jo[0])]
    assert rel_err(*sums) <= TOL[dtype]
    if name != "lap27":
        for i, what in enumerate(("P", "R", "Ac")):
            _same_ell(to[i], jo[i], TOL[dtype], what)
    # the sweep changed P: it is not the unrefined level's
    plain = t_fused_level(tA, n, TCfg(**dict(kw, fat_interp_refine=0)), 0)
    assert not torch.equal(plain[0].data, to[0].data)


def test_device_route_leaves_and_host_tail():
    """build_hierarchy: the levels above the threshold hold tensors on the
    device it was given, the host tail NumPy arrays, until .to()."""
    cfg = TCfg(splitting="pmis", interp="direct", host_setup_threshold=1000)
    h = build_hierarchy(shuffled_poisson(16), cfg, device="cpu")
    assert [lv.n for lv in h.levels] == [4096, 2048, 270, 49]
    for lv in h.levels:
        on_device = lv.n > cfg.host_setup_threshold
        for arr in (lv.A.data, lv.A.cols, lv.dinv):
            assert isinstance(arr, torch.Tensor) == on_device, lv.n
        if lv.P is not None:
            assert isinstance(lv.P.data, torch.Tensor) == on_device
    moved = h.to("cpu")
    assert all(isinstance(lv.A.data, torch.Tensor) for lv in moved.levels)
