"""The redesigned K4 and K2 kernels' host plans and indexing, on the CPU.

K4 (``csrc/banded_kernel.cu``): ``banded_launch_plan`` decides whether x
comes from a shared-memory window or straight from device memory, how many
threads a block has and which pages of the window it copies;
``banded_spmv_tiled_ref`` emulates the kernel block by block (the window
copied from a 16-byte boundary of x with zeros outside [0, n), ``pidx`` as
an index into it, four rows per thread, the live slots in slot order, a
chunk of eight at a time).  K2 (``csrc/dia_const_kernel.cu``) walks the tiled DIA
kernel's windows over planes it synthesizes; ``dia_spmv_tiled_ref`` over
``const_planes`` emulates it.  Each emulation must equal the unchanged plain
version (``banded_spmv_ref``, ``dia_spmv_const_ref``) bit for bit: neither
design changes the order of a row's sum.  One case per kernel also goes
through the JAX Pallas kernel in interpret mode, within 1e-6 * max|y| (the
backends may round the products differently).  The kernels themselves are
held against the plain versions on the card in tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu.ops.pallas.banded_kernel as jbk
import raptor_tpu_torch.ops.banded_plan as tplan
from raptor_tpu.ops.pallas.dia_kernel import dia_spmv_pallas_const
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import (banded_tensors, rcm_ell, rel_err, slots_twice,
                              star, wide_band, with_dead_slots)

DTYPES = [torch.float32, torch.bfloat16]
PAGE = tplan.PAGE


def _vec(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _grid_plan(nx: int, dtype=torch.float32) -> dict:
    return banded_tensors(tplan.banded_plan(*rcm_ell(nx)), dtype)


# ---------------------------------------------------------------------------
# K4: the launch plan
# ---------------------------------------------------------------------------

def test_k4_launch_plan_spreads_short_levels():
    """A level with fewer 256-thread blocks than SMs takes 128 threads a
    block (a block is then half a tile); any block size can be forced."""
    plan = _grid_plan(16)  # 4096 rows, four tiles
    for n_sm, threads in ((1, 256), (4, 256), (5, 128), (132, 128)):
        lp = bk.banded_launch_plan(plan, n_sm=n_sm)
        assert (lp.threads, lp.rows) == (threads, 4)
        assert lp.split * lp.threads * lp.rows == plan["tile"]
    for threads in (32, 64, 128, 256):
        lp = bk.banded_launch_plan(plan, threads=threads)
        assert lp.threads == threads and lp.split == 1024 // (4 * threads)
    with pytest.raises(ValueError, match="threads"):
        bk.banded_launch_plan(plan, threads=96)


def test_k4_launch_plan_stages_only_the_live_pages():
    plan = _grid_plan(16)
    npage = (plan["tile"] + 2 * plan["Wp"]) // PAGE
    lp = bk.banded_launch_plan(plan, n_sm=1, staged=True)
    live = [r for r in plan["ranges"] if r[0] <= r[1]]
    lo, hi = min(r[0] for r in live), max(r[1] for r in live)
    assert (lp.page0, lp.pages) == (lo, hi - lo + 1) and lp.pages <= npage
    assert lp.smem_bytes == 4 * (lp.pages * PAGE + bk.WINDOW_SLACK)
    # no ranges kept: the whole window
    lp = bk.banded_launch_plan(dict(plan, ranges=None), n_sm=1, staged=True)
    assert (lp.page0, lp.pages) == (0, npage)
    direct = bk.banded_launch_plan(plan, n_sm=1, staged=False)
    assert (direct.staged, direct.smem_bytes, direct.pages) == (False, 0, 0)


def test_k4_launch_plan_picks_staging_by_reuse():
    """Staged where a staged value is read STAGE_MIN_REUSE times or more:
    live slots x the block's rows over the window's floats."""
    plan = _grid_plan(16)
    live = len(bk.live_slots(plan))
    for n_sm in (1, 132):
        lp = bk.banded_launch_plan(plan, n_sm=n_sm)
        forced = bk.banded_launch_plan(plan, n_sm=n_sm, staged=True)
        reuse = live * lp.threads * lp.rows / (forced.pages * PAGE)
        assert lp.staged == (reuse >= bk.STAGE_MIN_REUSE)
    many = with_dead_slots(plan, at=())
    many = dict(many, ranges=tuple([many["ranges"][0]] * many["K"]))
    assert bk.banded_launch_plan(many, n_sm=1).staged == (
        many["K"] * 1024 / PAGE >= bk.STAGE_MIN_REUSE)


def test_k4_launch_plan_refuses_a_window_that_does_not_fit():
    """A window at banded_plan's page cap fits one block's shared
    memory; a wider one is refused when staging is forced and runs direct
    otherwise."""
    n = 48 * 1024
    plan = banded_tensors(tplan.banded_plan(*wide_band(n, 23 * PAGE)))
    assert plan["npage"] == 47  # the odd count at or below the cap of 48
    lp = bk.banded_launch_plan(plan, staged=True)
    assert lp.pages == 47 and lp.smem_bytes <= bk.SMEM_BYTES
    assert not bk.banded_launch_plan(plan).staged  # three slots: no reuse
    wide = dict(n=n, K=40, tile=1024, Wp=40 * PAGE, ranges=None)
    with pytest.raises(ValueError, match="shared memory"):
        bk.banded_launch_plan(wide, staged=True)
    assert not bk.banded_launch_plan(wide).staged
    with pytest.raises(ValueError, match="out of range"):
        bk.banded_launch_plan(dict(wide, n=n + 512))


# ---------------------------------------------------------------------------
# K4: the emulation against the plain version, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 32])
@pytest.mark.parametrize("nx", [10, 16, 20])
def test_k4_emulation_equals_plain(nx, threads, staged, dtype):
    """One tile (10^3), four (16^3) and eight (20^3); whole-tile blocks and
    blocks of 128 rows; x at every 16-byte remainder when staged."""
    plan = _grid_plan(nx, dtype)
    assert plan["n"] // plan["tile"] == {10: 1, 16: 4, 20: 8}[nx]
    x = _vec(plan["n"], nx)
    lp = bk.banded_launch_plan(plan, staged=staged, threads=threads)
    y_ref = bk.banded_spmv_ref(plan, x)
    for mis in (range(4) if staged else (0,)):
        y = bk.banded_spmv_tiled_ref(plan, x, lp, x_misalign=mis)
        assert torch.equal(y, y_ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False])
def test_k4_emulation_skips_dead_slots(staged, dtype):
    """Live slots that are no prefix, slots of range (1, 0) among them,
    and more live slots than one chunk."""
    base = _grid_plan(16, dtype)
    plan = with_dead_slots(base)
    live = bk.live_slots(plan)
    assert live != list(range(len(live))) and (1, 0) in plan["ranges"]
    x = _vec(plan["n"], 5)
    lp = bk.banded_launch_plan(plan, n_sm=8, staged=staged)
    assert torch.equal(bk.banded_spmv_tiled_ref(plan, x, lp),
                       bk.banded_spmv_ref(base, x))
    # the slots twice over: more than the loop-free kernels take, and a
    # last chunk that is not full
    twice = slots_twice(plan)
    n_live = len(bk.live_slots(twice))
    assert n_live > bk.K4_SINGLE_MAX and n_live % bk.K4_LOOP_CHUNK
    assert torch.equal(bk.banded_spmv_tiled_ref(twice, x, lp),
                       bk.banded_spmv_ref(twice, x))


def test_k4_emulation_takes_split_plans():
    """banded_plan_split: the near part of a band with long-range outliers
    at the window cap; the dummy targets of the far entries stay inside the
    staged window."""
    rng = np.random.default_rng(4)
    n, K = 65536, 5
    rows = np.arange(n)
    cols = np.stack([np.clip(rows + d, 0, n - 1) for d in (-2000, -1, 0, 1)]
                    + [np.clip(rows + 30000, 0, n - 1)]).astype(np.int32)
    data = rng.standard_normal((K, n)).astype(np.float32)
    far_rows = (rng.random(n) < 0.01) & (rows < 30000)
    nnz = np.where(far_rows, K, K - 1).astype(np.int32)
    data[K - 1, ~far_rows] = 0.0
    near, far = tplan.banded_plan_split(cols, nnz, data)
    assert far is not None
    plan = banded_tensors(near)
    x = _vec(n, 6)
    y_ref = bk.banded_spmv_ref(plan, x)
    for staged in (True, False):
        lp = bk.banded_launch_plan(plan, n_sm=16, staged=staged)
        assert torch.equal(bk.banded_spmv_tiled_ref(plan, x, lp, 3), y_ref)


def test_k4_emulation_at_the_page_cap():
    plan = banded_tensors(tplan.banded_plan(*wide_band(48 * 1024, 23 * PAGE)))
    x = _vec(plan["n"], 7)
    lp = bk.banded_launch_plan(plan, n_sm=64, staged=True)
    assert lp.pages == 47
    assert torch.equal(bk.banded_spmv_tiled_ref(plan, x, lp, 1),
                       bk.banded_spmv_ref(plan, x))
    short = lp._replace(smem_bytes=lp.smem_bytes - 4)
    with pytest.raises(ValueError, match="does not hold"):
        bk.banded_spmv_tiled_ref(plan, x, short)


def test_k4_emulation_matches_jax():
    cols, nnz, vals = rcm_ell(10)
    jplan = jbk.banded_plan(cols, nnz, vals)
    x = _vec(jplan["n"], 8)
    y_jax = jbk.banded_spmv_pallas(jplan, jnp.asarray(x.numpy()),
                                   interpret=True)
    plan = banded_tensors(tplan.banded_plan(cols, nnz, vals))
    for staged in (True, False):
        lp = bk.banded_launch_plan(plan, staged=staged)
        y = bk.banded_spmv_tiled_ref(plan, x, lp)
        assert rel_err(y.numpy(), np.asarray(y_jax)) <= 1e-6


def test_k4_wrapper_counts_only_on_the_card():
    """K4's wrapper refuses CPU tensors and counts nothing."""
    plan = _grid_plan(10)
    before = (dict(launch.launches), dict(launch.launches_by_shape))
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_spmv(plan, _vec(plan["n"], 9))
    assert (dict(launch.launches), dict(launch.launches_by_shape)) == before


# ---------------------------------------------------------------------------
# K2: the tiled emulation over synthesized planes
# ---------------------------------------------------------------------------

CUBE = list(itertools.product((-1, 0, 1), repeat=3))
# name: (dims, offsets, batch)
K2_CASES = {"1d": ((50,), star(1), None),
            "2d odd last": ((13, 18), star(2), None),
            "3d": ((6, 7, 12), star(3), None),
            "3d odd last": ((8, 6, 11), star(3), None),
            "3d 27-point": ((7, 8, 10), CUBE, None),
            "4d": ((3, 4, 5, 6), star(4), None),
            "batch 3": ((5, 9, 7), star(3), 3),
            "batch 3, 27-point": ((4, 6, 8), CUBE, 3),
            "8 rows a thread": ((8, 12, 24), star(3), None),
            "16 rows a thread, 27-point, batch 3": ((6, 10, 32), CUBE, 3)}


@pytest.mark.parametrize("n_sm", [1, tk.H100_SMS])
@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_emulation_equals_plain(case, n_sm):
    dims, offsets, batch = K2_CASES[case]
    n = int(np.prod(dims))
    consts = [float(c) for c in
              np.random.default_rng(1).standard_normal(len(offsets))]
    x = _vec((n,) if batch is None else (batch, n), 2)
    plan = tk.const_tile_plan(offsets, dims, batch or 1, n_sm)
    # 8 or 16 rows a thread where the last dimension allows and one SM is
    # asked to fill; 4 everywhere else
    assert plan.rows == (int(case.split()[0]) if "rows" in case and n_sm == 1
                         else 4)
    assert plan.tile % plan.rows == 0
    data = tk.const_planes(consts, offsets, dims)
    lins = tk._const_lins(offsets, dims)
    y_ref = tk.dia_spmv_const_ref(consts, offsets, dims, x)
    for mis in range(4):
        y = tk.dia_spmv_tiled_ref(data, lins, x, plan=plan, x_misalign=mis)
        assert torch.equal(y, y_ref)


@pytest.mark.parametrize("dims,offsets", [
    ((128, 128, 128), star(3)), ((256, 256, 256), star(3)),
    ((256, 256, 256), CUBE), ((4096, 4096), star(2)),
    ((16, 16, 16), star(3)), ((12, 40, 40, 40), star(4)), ((1 << 20,), star(1))])
def test_k2_tile_plan_fits_shared_memory(dims, offsets):
    """Two stages of the stencil's windows fit a block's shared memory and
    every offset's reads stay inside its band's window."""
    p = tk.const_tile_plan(offsets, dims)
    assert 8 * sum(p.windows) <= p.smem_bytes <= tk.SMEM_BYTES
    assert p.smem_bytes % 512 == 0
    for o, b in zip(tk._const_lins(offsets, dims), p.band_of):
        lo, hi = p.bands[b]
        assert lo <= o <= hi
        assert o - lo + p.tile + tk.WIN_SLACK <= p.windows[b]


def test_k2_tile_plan_at_the_headline_shape():
    """128^3, 7 points: one band per value of the slowest axis' offset, 16
    rows a thread and 2048 a tile, about 26 KB a stage; fewer rows a thread
    where the last dimension is no multiple of 16 or the grid is small."""
    p = tk.const_tile_plan(star(3), (128,) * 3)
    assert p.bands == ((-16384, -16384), (-128, 128), (16384, 16384))
    assert (p.tile, p.rows) == (2048, 16)
    # two stages, each rounded up to a multiple of 64 floats
    assert p.windows == (2056, 2312, 2056) and p.smem_bytes == 8 * 6464
    assert (tk.const_tile_plan(star(3), (128, 128, 120)).rows,
            tk.const_tile_plan(star(3), (128, 128, 120)).tile) == (8, 2048)
    assert tk.const_tile_plan(star(3), (128, 128, 124)).rows == 4
    assert tk.const_tile_plan(star(3), (16,) * 3, batch=4).rows == 4
    assert tk.const_tile_plan(star(3), (16, 16, 24), batch=4, n_sm=8).rows == 8
    assert tk.const_tile_plan(star(3), (16,) * 3, batch=4, n_sm=8).rows == 16
    with pytest.raises(ValueError):
        tk.tile_plan([0], 64, 4, max_threads=96)


@pytest.mark.parametrize("rows", [4, 8, 16])
@pytest.mark.parametrize("dims,offsets", [
    ((6, 7, 16), CUBE), ((5, 16), star(2)), ((3, 4, 5, 16), star(4)), ((16,), star(1))])
def test_k2_shared_coordinates_give_the_grid_mask(dims, offsets, rows):
    """Where the last dimension is a multiple of a thread's row count, its
    aligned rows share every coordinate but the last: one coordinate chain
    for the first row, the outer tests once per offset, and the last
    coordinate's test per row give ``in_grid_mask``."""
    assert dims[-1] % rows == 0
    n = int(np.prod(dims))
    for k, off in enumerate(offsets):
        got = np.zeros(n, bool)
        for row in range(0, n, rows):
            c = np.unravel_index(row, dims)
            outer = all(0 <= c[a] + off[a] < dims[a]
                        for a in range(len(dims) - 1))
            for r in range(rows):
                got[row + r] = outer and 0 <= c[-1] + r + off[-1] < dims[-1]
        assert np.array_equal(got, tk.in_grid_mask(dims, off, "cpu").numpy()), k


def test_k2_emulation_matches_jax():
    dims, offsets = (8, 8, 16), star(3)
    consts = [6.0 if o == (0, 0, 0) else -1.0 for o in offsets]
    x = _vec(int(np.prod(dims)), 3)
    y = tk.dia_spmv_tiled_ref(tk.const_planes(consts, offsets, dims),
                              tk._const_lins(offsets, dims), x,
                              plan=tk.const_tile_plan(offsets, dims))
    y_jax = dia_spmv_pallas_const(consts, offsets, dims, jnp.asarray(x.numpy()),
                                  interpret=True)
    assert rel_err(y.numpy(), np.asarray(y_jax)) <= 1e-6


def test_k2_wrapper_counts_only_on_the_card():
    """K2's wrapper refuses CPU tensors and counts nothing."""
    offsets, dims = star(2), (6, 8)
    before = (dict(launch.launches), dict(launch.launches_by_shape))
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_spmv_const([1.0] * 5, offsets, dims, _vec(48, 4))
    assert (dict(launch.launches), dict(launch.launches_by_shape)) == before
