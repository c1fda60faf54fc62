"""The redesigned K6 and K5 kernels' host plans and indexing, on the CPU.

K6 (``csrc/banded_kernel.cu`` ``banded_rect_kernel``) takes K4's launch plan
(``banded_launch_plan`` on a rectangular plan: staged or direct, threads a
block, the live pages of its ``npage`` window) and a window whose page w
is x's page ``clamp(base_t + w, 0, last)``; ``banded_spmv_rect_tiled_ref``
emulates it block by block (each window page staged on its own from the
16-byte boundary at or below its clamped page's start, four rows a thread,
the live slots in slot order a chunk at a time).  K5
(``banded_df64_kernel``) is K4's zero-pad form with a df64 body;
``banded_df64_residual_tiled_ref`` emulates it.  Each emulation must equal
the unchanged plain version bit for bit (``torch.equal``): neither design
changes the order of a row's sum.  One case each goes through the JAX
Pallas kernels in interpret mode: K6 in both forms within 1e-6 * max|y|,
K5's ``rh`` bit for bit.  The kernels themselves are held against the plain
versions on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.ops.pallas.banded_kernel as jbk
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import (banded_tensors, clamped_rect_plan, rcm_ell,
                              rel_err, shuffled_poisson, slots_twice,
                              with_dead_slots)

ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)
PAGE = 1024
DTYPES = [torch.float32, torch.bfloat16]
# the transfers of the shuffled 16^3 hierarchy: (level, name) -> live
# slots, npage (level 1's R runs the looping kernel)
BANDS = {(0, "Pband"): (6, 3), (0, "Rband"): (7, 4), (1, "Pband"): (5, 1),
         (1, "Rband"): (19, 2)}


def _setup(scale=1.0):
    from raptor_tpu_torch.api import setup
    from raptor_tpu_torch.config import AmgConfig

    return setup(shuffled_poisson(16, scale=scale), AmgConfig(**ALG),
                 device="cpu")


@pytest.fixture(scope="module")
def h16():
    return _setup()


@pytest.fixture(scope="module")
def h16_pi():
    h = _setup(np.pi)
    assert h.a0_lo_band is not None
    return h


def _vec(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32))


def _band_plan(h, key, dtype=torch.float32) -> dict:
    level, name = key
    plan = getattr(h.levels[level], name).plan()
    assert (len(bk.live_slots(plan)), plan["npage"]) == BANDS[key]
    return dict(plan, vals=plan["vals"].to(dtype))


def _rank_block(plan: dict, rank: int, ndev: int) -> tuple:
    """Rank ``rank``'s tiles of a rectangular plan as the sharded caller
    takes them (WpP folded into the buffer): (plan, buffer length,
    map_cols)."""
    T = plan["n"] // plan["tile"]
    t0, t1 = rank * T // ndev, (rank + 1) * T // ndev
    cols = plan["n_cols"] // ndev
    mine = dict(plan, n=(t1 - t0) * plan["tile"], WpP=0,
                vals=plan["vals"][t0:t1].contiguous(),
                pidx=plan["pidx"][t0:t1].contiguous())
    length = cols + plan["npage"] * PAGE
    return dict(mine, n_cols=length), length, cols


# ---------------------------------------------------------------------------
# K6: the launch plan
# ---------------------------------------------------------------------------

def test_k6_launch_plan_spreads_short_levels(h16):
    """A level with fewer 256-thread blocks than SMs takes 128 threads a
    block staged (a block is then half a tile); any block size can be
    forced."""
    plan = _band_plan(h16, (0, "Rband"))  # 2048 rows, two tiles
    for n_sm, threads in ((1, 256), (2, 256), (3, 128), (132, 128)):
        lp = bk.banded_launch_plan(plan, n_sm=n_sm, staged=True)
        assert (lp.threads, lp.rows) == (threads, 4)
        assert lp.split * lp.threads * lp.rows == plan["tile"]
    for threads in (32, 64, 128, 256):
        lp = bk.banded_launch_plan(plan, threads=threads)
        assert lp.threads == threads and lp.split == 1024 // (4 * threads)
    with pytest.raises(ValueError, match="threads"):
        bk.banded_launch_plan(plan, threads=48)


@pytest.mark.parametrize("key", list(BANDS))
def test_k6_launch_plan_stages_only_the_live_pages(h16, key):
    """The live slots' page ranges within the plan's ``npage``; each staged
    page takes RECT_PAGE_FLOATS floats; no ranges: the whole window."""
    plan = _band_plan(h16, key)
    lp = bk.banded_launch_plan(plan, n_sm=1, staged=True)
    live = [r for r in plan["ranges"] if r[0] <= r[1]]
    lo, hi = min(r[0] for r in live), max(r[1] for r in live)
    assert (lp.page0, lp.pages) == (lo, hi - lo + 1)
    assert lp.page0 + lp.pages <= plan["npage"]
    assert lp.smem_bytes == 4 * lp.pages * bk.RECT_PAGE_FLOATS
    lp = bk.banded_launch_plan(dict(plan, ranges=None), n_sm=1, staged=True)
    assert (lp.page0, lp.pages) == (0, plan["npage"])
    direct = bk.banded_launch_plan(plan, n_sm=1, staged=False)
    assert (direct.staged, direct.smem_bytes, direct.pages) == (False, 0, 0)
    with pytest.raises(ValueError, match="outside the window"):
        bk.banded_launch_plan(dict(plan, npage=hi), n_sm=1, staged=True)


def test_k6_launch_plan_picks_staging_by_reuse(h16):
    """Staged where a staged value is read RECT_STAGE_MIN_REUSE times or
    more: live slots x the block's rows over the window's floats.  A
    thread's rows lie 32 apart, consecutive on a level of
    RECT_CONSECUTIVE_BLOCKS blocks of 1024 rows an SM or more."""
    picked = set()
    for key in BANDS:
        plan = _band_plan(h16, key)
        live = len(bk.live_slots(plan))
        for n_sm in (1, 132):
            lp = bk.banded_launch_plan(plan, n_sm=n_sm)
            if live > bk.K4_SINGLE_MAX:
                continue  # one row a thread, test_k6_launch_plan_one_row
            forced = bk.banded_launch_plan(plan, n_sm=n_sm, staged=True)
            reuse = live * lp.threads * lp.rows / (forced.pages * PAGE)
            assert lp.staged == (reuse >= bk.RECT_STAGE_MIN_REUSE)
            fills = plan["n"] >= bk.RECT_CONSECUTIVE_BLOCKS * n_sm * PAGE
            assert lp.stride == (1 if fills else 32)
            picked.add((lp.staged, lp.stride))
    assert picked >= {(True, 1), (False, 32)}


def test_k6_launch_plan_one_row(h16):
    """More live slots than the loop-free kernels take: one row a thread,
    256 threads a block, direct; four rows where staging or four rows are
    forced; K4 and K5 take four rows only."""
    plan = _band_plan(h16, (1, "Rband"))  # 19 live slots
    for n_sm in (1, 132):
        lp = bk.banded_launch_plan(plan, n_sm=n_sm)
        assert (lp.rows, lp.threads, lp.staged, lp.split) == (1, 256, False, 4)
    assert bk.banded_launch_plan(plan, staged=False).rows == 1
    assert bk.banded_launch_plan(plan, staged=True).rows == 4
    assert bk.banded_launch_plan(plan, staged=False, rows=4).rows == 4
    assert bk.banded_launch_plan(_band_plan(h16, (0, "Rband"))).rows == 4
    assert bk.banded_launch_plan(_band_plan(h16, (0, "Rband")), rows=1,
                                 threads=64).split == 16
    with pytest.raises(ValueError, match="direct"):
        bk.banded_launch_plan(plan, staged=True, rows=1)
    square = h16.levels[0].Aband.plan()
    with pytest.raises(ValueError, match="rows a thread"):
        bk.banded_launch_plan(square, rows=1)
    # one live slot across 30 pages: read 128 / 30720 times a value
    thin = dict(_band_plan(h16, (1, "Pband")), npage=30, ranges=((0, 29),)
                + ((1, 0),) * 23)
    assert not bk.banded_launch_plan(thin, n_sm=132).staged


def test_k6_launch_plan_refuses_a_window_that_does_not_fit():
    """banded_plan's page cap (48) fits a block's shared memory page by
    page; a wider window is refused when staging is forced and runs direct
    otherwise."""
    cap = dict(n=8192, K=8, tile=1024, n_cols=16384, WpP=3, npage=48,
               ranges=None)
    lp = bk.banded_launch_plan(cap, staged=True)
    assert lp.pages == 48 and lp.smem_bytes == 48 * 4 * 1028 <= bk.SMEM_BYTES
    wide = dict(cap, npage=60)
    with pytest.raises(ValueError, match="shared memory"):
        bk.banded_launch_plan(wide, staged=True)
    assert not bk.banded_launch_plan(wide).staged


# ---------------------------------------------------------------------------
# K6: the emulation against the plain version, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 128, 32])
@pytest.mark.parametrize("key", list(BANDS), ids=lambda k: f"L{k[0]}{k[1][0]}")
def test_k6_emulation_equals_plain(h16, key, threads, staged, dtype):
    """P and R of levels 0 and 1 (5, 6, 7 and 19 live slots: one chunk of
    8, or the loop over chunks of 4); whole-tile blocks, half and eighth
    tiles; x at every 16-byte remainder when staged; direct also with one
    row a thread."""
    plan = _band_plan(h16, key, dtype)
    x = _vec(plan["n_cols"], 1)
    y_ref = bk.banded_spmv_rect_ref(plan, x)
    for rows in ((4,) if staged else (4, 1)):
        lp = bk.banded_launch_plan(plan, staged=staged, threads=threads,
                                   rows=rows)
        for mis in (range(4) if staged else (0,)):
            y = bk.banded_spmv_rect_tiled_ref(plan, x, lp, x_misalign=mis)
            assert torch.equal(y, y_ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False])
def test_k6_emulation_skips_dead_slots(h16, staged, dtype):
    """Live slots that are no prefix, slots of range (1, 0) among them, and
    the slots twice over (a last chunk that is not full)."""
    base = _band_plan(h16, (0, "Rband"), dtype)
    plan = with_dead_slots(base)
    live = bk.live_slots(plan)
    assert live != list(range(len(live)))
    x = _vec(plan["n_cols"], 2)
    lp = bk.banded_launch_plan(plan, n_sm=8, staged=staged)
    assert torch.equal(bk.banded_spmv_rect_tiled_ref(plan, x, lp),
                       bk.banded_spmv_rect_ref(base, x))
    twice = slots_twice(plan)
    n_live = len(bk.live_slots(twice))
    assert n_live > bk.K4_SINGLE_MAX and n_live % bk.K4_LOOP_CHUNK
    assert torch.equal(bk.banded_spmv_rect_tiled_ref(twice, x, lp),
                       bk.banded_spmv_rect_ref(twice, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("key", [(0, "Pband"), (0, "Rband")],
                         ids=["L0P", "L0R"])
def test_k6_map_cols_form_on_a_halo_buffer(h16, key, staged, dtype):
    """The map_cols form on each of two ranks' tiles (WpP folded into the
    buffer, the local column count as the map's numerator), and on a
    three-page buffer whose windows clamp at both ends."""
    full = _band_plan(h16, key, dtype)
    for rank in (0, 1):
        plan, length, cols = _rank_block(full, rank, 2)
        cases = [(plan, length, cols),
                 (dict(plan, WpP=2, n_cols=3 * PAGE), 3 * PAGE, full["n_cols"])]
        for p, m, mc in cases:
            x = _vec(m, 3 + rank)
            lp = bk.banded_launch_plan(p, staged=staged)
            y_ref = bk.banded_spmv_rect_ref(p, x, map_cols=mc)
            for mis in (0, 3):
                assert torch.equal(bk.banded_spmv_rect_tiled_ref(
                    p, x, lp, map_cols=mc, x_misalign=mis), y_ref)


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("at", [0, 3 * PAGE], ids=["first page", "last page"])
def test_k6_clamped_pages_carry_non_finite_x(staged, at):
    """A masked entry reads a window page that the clamp maps onto an end
    page of x; with a NaN or an inf there, 0 * x is NaN, so a window staged
    with zeros in place of the clamped pages would differ."""
    plan = clamped_rect_plan()
    x = _vec(plan["n_cols"], 5)
    x[at] = float("nan") if at == 0 else float("inf")
    y_ref = bk.banded_spmv_rect_ref(plan, x)
    # the clamped reads reach whole tiles: 0 and 1 from x[0], 2 and 3 from
    # x[3072]; one live entry reads the same element
    bad = slice(0, 2048) if at == 0 else slice(2048, 4096)
    assert torch.isnan(y_ref[bad]).all()
    assert int(torch.isfinite(y_ref).logical_not().sum()) == 2049
    for threads in (256, 64):
        lp = bk.banded_launch_plan(plan, staged=staged, threads=threads)
        assert (lp.page0, lp.pages) == ((0, 5) if staged else (0, 0))
        for mis in (range(4) if staged else (0,)):
            y = bk.banded_spmv_rect_tiled_ref(plan, x, lp, x_misalign=mis)
            torch.testing.assert_close(y, y_ref, rtol=0, atol=0,
                                       equal_nan=True)


def test_k6_emulation_refuses_a_short_window(h16):
    plan = _band_plan(h16, (0, "Rband"))
    x = _vec(plan["n_cols"], 6)
    lp = bk.banded_launch_plan(plan, staged=True)
    with pytest.raises(ValueError, match="does not hold"):
        bk.banded_spmv_rect_tiled_ref(plan, x, lp._replace(
            smem_bytes=lp.smem_bytes - 4))
    # a window that leaves out a live page: the read falls outside it
    with pytest.raises(IndexError, match="outside the staged window"):
        bk.banded_spmv_rect_tiled_ref(plan, x, lp._replace(pages=lp.pages - 1))


def test_k6_emulation_matches_jax():
    """Both forms through the Pallas kernel in interpret mode, on the plan
    whose windows clamp at both ends."""
    plan = clamped_rect_plan()
    jplan = dict(plan, vals=jnp.asarray(plan["vals"].numpy()),
                 pidx=jnp.asarray(plan["pidx"].numpy()))
    x = _vec(plan["n_cols"], 7)
    y_jax = jbk.banded_spmv_rect_pallas(jplan, jnp.asarray(x.numpy()),
                                        interpret=True)
    for staged in (True, False):
        lp = bk.banded_launch_plan(plan, staged=staged)
        y = bk.banded_spmv_rect_tiled_ref(plan, x, lp)
        assert rel_err(y.numpy(), np.asarray(y_jax)) <= 1e-6
    mine, length, cols = _rank_block(plan, 1, 2)
    xb = _vec(length, 8)
    y_jax = jbk._banded_call_rect(
        jnp.asarray(mine["vals"].numpy()), jnp.asarray(mine["pidx"].numpy()),
        jnp.asarray(xb.numpy()), K=mine["K"], n=mine["n"], n_cols=length,
        tile=mine["tile"], WpP=0, npage=mine["npage"], interpret=True,
        map_cols=cols, ranges=tuple(mine["ranges"]))
    y = bk.banded_spmv_rect_tiled_ref(mine, xb, map_cols=cols)
    assert rel_err(y.numpy(), np.asarray(y_jax)) <= 1e-6


# ---------------------------------------------------------------------------
# K5: the emulation against the plain version, bit for bit
# ---------------------------------------------------------------------------

def _k5_args(h, seed):
    """(plan, vals_lo, xh, bh, bl, v) on level 0 of ``h``: a residual of a
    random xh against a random fp64 right-hand side split into (bh, bl)."""
    band = h.levels[0].Aband
    n = band.n_pad
    rng = np.random.default_rng(seed)
    b64 = rng.standard_normal(n)
    bh = b64.astype(np.float32)
    vecs = (rng.standard_normal(n).astype(np.float32), bh,
            (b64 - bh).astype(np.float32),
            (rng.standard_normal(n) * 1e-6).astype(np.float32))
    return (band.plan(), h.a0_lo_band) + tuple(map(torch.from_numpy, vecs))


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 128, 32])
@pytest.mark.parametrize("with_lo", [False, True])
def test_k5_emulation_equals_plain(h16, h16_pi, with_lo, threads, staged):
    plan, lo, *vecs = _k5_args(h16_pi if with_lo else h16, 9)
    assert (lo is not None) == with_lo
    lp = bk.banded_launch_plan(plan, staged=staged, threads=threads)
    rh_ref, rl_ref = bk.banded_df64_residual_ref(plan, lo, *vecs)
    for mis in ((0, 1, 3) if staged else (0,)):
        rh, rl = bk.banded_df64_residual_tiled_ref(plan, lo, *vecs, lp,
                                                   x_misalign=mis)
        assert torch.equal(rh, rh_ref) and torch.equal(rl, rl_ref)


@pytest.mark.parametrize("staged", [True, False])
def test_k5_emulation_takes_the_loop(h16_pi, staged):
    """The slots twice over (14 live: the looping kernel) and live slots
    that are no prefix."""
    plan, lo, *vecs = _k5_args(h16_pi, 10)
    twice = slots_twice(plan)
    lo2 = torch.cat([lo] * 2, 1).contiguous()
    lp = bk.banded_launch_plan(twice, n_sm=8, staged=staged)
    got = bk.banded_df64_residual_tiled_ref(twice, lo2, *vecs, lp)
    ref = bk.banded_df64_residual_ref(twice, lo2, *vecs)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    dead = with_dead_slots(plan)
    lo_dead = torch.cat([torch.zeros_like(lo[:, :1]), lo[:, :3],
                         torch.zeros_like(lo[:, :1]), lo[:, 3:]], 1)
    lp = bk.banded_launch_plan(dead, staged=staged)
    got = bk.banded_df64_residual_tiled_ref(dead, lo_dead, *vecs, lp)
    ref = bk.banded_df64_residual_ref(plan, lo, *vecs)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_k5_emulation_matches_jax():
    """``rh`` equal to the Pallas kernel's in interpret mode, bit for bit
    (as the plain version is in tests/test_torch_banded.py), on a one-tile
    pi-scaled operator with its fp32 truncation remainder."""
    import raptor_tpu_torch.ops.banded_plan as tplan

    cols, nnz, data = rcm_ell(10)
    a64 = data.astype(np.float64) * np.pi
    hi = a64.astype(np.float32)
    plan = banded_tensors(tplan.banded_plan(cols, nnz, hi))
    lo = torch.from_numpy(tplan.banded_plan(
        cols, nnz, (a64 - hi).astype(np.float32))["vals"])
    rng = np.random.default_rng(12)
    vecs = [torch.from_numpy(rng.standard_normal(plan["n"]).astype(np.float32))
            for _ in range(4)]
    jplan = dict(plan, vals=jnp.asarray(plan["vals"].numpy()),
                 pidx=jnp.asarray(plan["pidx"].numpy()))
    rh_j, _ = jbk.banded_df64_residual_pallas(
        jplan, jnp.asarray(lo.numpy()), *(jnp.asarray(t.numpy()) for t in vecs),
        interpret=True)
    for staged in (True, False):
        lp = bk.banded_launch_plan(plan, staged=staged)
        rh, _ = bk.banded_df64_residual_tiled_ref(plan, lo, *vecs, lp)
        assert np.array_equal(rh.numpy(), np.asarray(rh_j))


def test_k5_k6_wrappers_count_only_on_the_card(h16, h16_pi):
    """K5's and K6's wrappers, in both K6 forms, refuse CPU tensors and
    count nothing."""
    before = (dict(launch.launches), dict(launch.launches_by_shape))
    plan = _band_plan(h16, (0, "Rband"))
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_spmv_rect(plan, _vec(plan["n_cols"], 13))
    mine, length, cols = _rank_block(plan, 0, 2)
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_spmv_rect(mine, _vec(length, 14), map_cols=cols)
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_df64_residual(*_k5_args(h16_pi, 15))
    assert (dict(launch.launches), dict(launch.launches_by_shape)) == before
