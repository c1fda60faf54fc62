"""raptor_tpu_torch.utils.df64 against numpy fp64 and against the JAX
package's df64 (mirrors tests/unit/test_df64.py).  The error-free
transformations must be exact; the compensated residual must reach ~1e-14
relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raptor_tpu.utils import df64 as jdf
from raptor_tpu_torch.utils.df64 import (
    _split,
    df_add,
    df_add_single,
    df_from,
    df_neg,
    df_to_f32,
    two_prod,
    two_sum,
)
from tests._torch_ref import stencil_5pt


def _f32(rng, n, scale=1.0):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _f64(*ts):
    return sum(t.double().numpy() for t in ts)


def test_two_sum_exact():
    rng = np.random.default_rng(0)
    a, b = _f32(rng, 1000), _f32(rng, 1000, 1e-6)
    s, e = two_sum(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(_f64(s, e), a.astype(np.float64) + b)  # error-free


def test_two_prod_exact():
    rng = np.random.default_rng(1)
    a, b = _f32(rng, 1000), _f32(rng, 1000)
    p, e = two_prod(torch.from_numpy(a), torch.from_numpy(b))
    # fp32 products are exact in fp64
    assert np.array_equal(_f64(p, e), a.astype(np.float64) * b)


def test_split_is_exact_and_short():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(_f32(rng, 1000, 1e3))
    hi, lo = _split(a)
    assert torch.equal(hi + lo, a)
    # hi keeps sign, exponent and the top 11 explicit mantissa bits
    assert not (hi.view(torch.int32) & 0xFFF).any()


@pytest.mark.parametrize("fn", ["two_sum", "two_prod", "df_add"])
def test_matches_jax_bitwise(fn):
    """The port and the JAX package give the same (hi, lo) bits."""
    rng = np.random.default_rng(3)
    args = [_f32(rng, 512, s) for s in (1.0, 1e-4, 1e-3, 1e-9)]
    n_args = 4 if fn == "df_add" else 2
    got = globals()[fn](*[torch.from_numpy(a) for a in args[:n_args]])
    want = getattr(jdf, fn)(*[jnp.asarray(a) for a in args[:n_args]])
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_df_helpers():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_f32(rng, 64))
    y = torch.from_numpy(_f32(rng, 64, 1e-9))
    xh, xl = df_from(x)
    assert torch.equal(xh, x) and not xl.any()
    sh, sl = df_add_single(xh, xl, y)
    assert np.array_equal(_f64(sh, sl), x.double().numpy() + y.double().numpy())
    nh, nl = df_neg(sh, sl)
    assert torch.equal(nh, -sh) and torch.equal(nl, -sl)
    assert torch.equal(df_to_f32(sh, sl), sh + sl)


def test_df64_residual_precision():
    from raptor_tpu_torch.gallery import stencil_grid
    from raptor_tpu_torch.structured import dia_from_stencil
    from raptor_tpu_torch.structured.solver import _df64_residual

    st, dims = stencil_5pt(), (32, 32)
    A = dia_from_stencil(st, dims, device="cpu")
    rng = np.random.default_rng(2)
    x, b = _f32(rng, A.n), _f32(rng, A.n)
    z = torch.zeros(A.n)
    rh, rl = _df64_residual(A, torch.from_numpy(x), z, torch.from_numpy(b), z)
    ref = b.astype(np.float64) - stencil_grid(st, dims) @ x.astype(np.float64)
    err = np.abs(_f64(rh, rl) - ref).max() / np.abs(ref).max()
    assert err < 1e-12, err


def test_df64_exact_in_long_chain_with_gathers():
    """A deep two_prod/df_add chain with gathers keeps df64 accuracy
    (the shape that lost 7 digits to fp contraction in the reference;
    eager torch rounds every op).  Healthy df64 accumulates ~1e-11 over
    27 terms of magnitude ~100; 1e-10 is ~1e5 below broken behaviour."""
    rng = np.random.default_rng(0)
    N, K = 512, 27
    d64 = rng.standard_normal((K, N)) * 1e5
    x64 = rng.standard_normal(N) * 1e-3
    b64 = rng.standard_normal(N)
    split = lambda v: (v.astype(np.float32),  # noqa: E731
                       (v - v.astype(np.float32)).astype(np.float32))
    d, lo = (torch.from_numpy(a) for a in split(d64))
    xh, xl = (torch.from_numpy(a) for a in split(x64))
    rh, rl = (torch.from_numpy(a) for a in split(b64))
    cols = rng.integers(0, N, (K, N))
    for k in range(K):
        idx = torch.from_numpy(cols[k])
        gh, gl = xh[idx], xl[idx]
        ph, pe = two_prod(d[k], gh)
        pe = pe + d[k] * gl + lo[k] * gh
        rh, rl = df_add(rh, rl, -ph, -pe)
    xx = xh.double().numpy() + xl.double().numpy()
    ref = b64.copy()
    for k in range(K):
        ref -= d64[k] * xx[cols[k]]
    assert np.abs(_f64(rh, rl) - ref).max() < 1e-10
