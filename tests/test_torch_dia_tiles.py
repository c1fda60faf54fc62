"""The tiled DIA kernel's host plan and indexing (K1, K1v1, K3), on the CPU.

``tile_plan`` (row tile, offset bands, window sizes, 16-byte plane loads)
is what the wrappers hand to ``csrc/dia_kernel.cu``; ``dia_spmv_tiled_ref``
emulates that kernel window by window: staged windows per band, rounded
down to a 16-byte boundary of x, zero or halo fill at the edges, each row's
sum in offset order.  The emulation must equal the unchanged plain versions
(``dia_spmv_v2_ref``, ``dia_spmv_v1_ref``, ``dia_spmv_halo_ref``) bit for
bit: banding changes where x is read from, never the order of the sum.  One
case per kernel also goes through the JAX Pallas kernel in interpret mode,
within 1e-6 * max|y| (the backends may round the products differently).
The kernel itself is held against the plain versions on the card in
tests/test_torch_cuda.py."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raptor_tpu_torch.structured.dia as tdia
from raptor_tpu.ops.pallas.dia_kernel import (dia_spmv_pallas_v2,
                                              dia_spmv_pallas_v2_halo)
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import rel_err

CUBE = list(itertools.product((-1, 0, 1), repeat=3))
# 32 offsets: the 27-point cube and five reaching two cells
OFFSETS = {1: [(0, 1, 0)],
           7: [o for o in CUBE if sum(map(abs, o)) <= 1],
           15: [o for o in CUBE if abs(o[1]) + abs(o[2]) <= 1],
           27: CUBE,
           32: CUBE + [(-2, 0, 0), (0, -2, 0), (0, 0, 2), (0, 2, 0), (2, 0, 0)]}
DTYPES = [torch.float32, torch.bfloat16]


def _lins(dims, offsets):
    return [tdia._linear(o, dims) for o in offsets]


def _planes(dims, offsets, dtype, zeroed=True, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), int(np.prod(dims))))
    data = data.astype(np.float32)
    if zeroed:
        for k, o in enumerate(offsets):
            data[k] *= tdia.boundary_mask(dims, o)
    return torch.from_numpy(data).to(dtype), _lins(dims, offsets)


def _vec(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def test_plan_bands_are_the_slowest_axis_offsets():
    """At 256^3 (7 fp32 planes) and at 128^3 level 1 (15 bf16 planes) a
    band is one value of the slowest axis' offset."""
    dims = (256, 256, 256)
    p = tk.tile_plan(_lins(dims, OFFSETS[7]), 256 ** 3, 4)
    assert p.bands == ((-65536, -65536), (-256, 256), (65536, 65536))
    assert (p.tile, p.rows, p.vec) == (1024, 4, True)
    assert p.band_of == (0, 1, 1, 1, 1, 1, 2)  # offset order kept
    dims = (64, 128, 128)
    p = tk.tile_plan(_lins(dims, OFFSETS[15]), 64 * 128 * 128, 2)
    assert [hi - lo for lo, hi in p.bands] == [256, 256, 256]
    assert (p.tile, p.rows, p.vec) == (2048, 8, True)
    # three windows of 2048 + 256 rows (+ slack), two stages: about 55 KB
    assert p.windows == (2312, 2312, 2312)
    assert p.smem_bytes == 2 * 4 * 3 * 2312


@pytest.mark.parametrize("itemsize", [2, 4])
def test_plan_windows_cover_every_read(itemsize):
    """Every offset's reads (tile rows, shifted by up to 3 for the 16-byte
    round-down, plus the last float4) stay inside its band's window, and
    two stages fit a block's shared memory."""
    for n_off, dims in ((27, (20, 20, 20)), (32, (20, 18, 16)),
                        (7, (256, 256, 256))):
        lins = _lins(dims, OFFSETS[n_off])
        p = tk.tile_plan(lins, int(np.prod(dims)), itemsize)
        assert p.smem_bytes == 8 * sum(p.windows) <= tk.SMEM_BYTES
        for o, b in zip(lins, p.band_of):
            lo, hi = p.bands[b]
            assert lo <= o <= hi
            assert o - lo + p.tile + tk.WIN_SLACK <= p.windows[b]
            assert p.windows[b] % 4 == 0


def test_plan_shrinks_the_tile_to_fit_shared_memory():
    """32 offsets far apart are 32 bands: at 2048 bf16 rows their windows
    would need 527 KB, so the tile halves until two stages fit."""
    lins = [k * 100_000 for k in range(-16, 16)]
    p = tk.tile_plan(lins, 1 << 24, 2)
    assert len(p.bands) == 32
    assert p.smem_bytes <= tk.SMEM_BYTES
    assert p.tile == 512 and 2 * 4 * 32 * (2 * p.tile + 8) > tk.SMEM_BYTES
    with pytest.raises(ValueError):
        tk.tile_plan(list(range(33)), 1 << 20, 4)
    with pytest.raises(ValueError):
        tk.tile_plan([0], 1 << 20, 8)


def test_plan_spreads_short_levels_over_the_sms():
    """A level shorter than one tile per SM takes smaller tiles, down to 32
    threads; a batch counts its rows' tiles."""
    lins = _lins((8, 16, 16), CUBE)
    p = tk.tile_plan(lins, 2048, 2)
    assert p.tile == 8 * tk.MIN_TILE_THREADS
    assert len(p.bands) == 1  # the offsets lie closer than a tile
    assert tk.tile_plan(lins, 2048, 2, n_sm=1).tile == 2048
    big = tk.tile_plan(_lins((64, 128, 128), OFFSETS[15]), 1 << 20, 2)
    assert big.tile == 2048
    assert tk.tile_plan(lins, 8192, 4, batch=4).tile == 128
    assert tk.tile_plan(lins, 8192, 4, batch=4, n_sm=16).tile == 1024


def test_plan_alignment_decides_the_plane_loads():
    lins = _lins((8, 8, 8), OFFSETS[7])
    assert tk.tile_plan(lins, 512, 2).vec
    assert not tk.tile_plan(lins, 512, 2, planes_aligned=False).vec
    # plane k starts at element k * n: 16-byte loads need n % rows == 0
    assert not tk.tile_plan(lins, 511, 4).vec
    assert tk.tile_plan(lins, 516, 4).vec and not tk.tile_plan(lins, 516, 2).vec


# ---------------------------------------------------------------------------
# the emulation against the plain versions, bit for bit
# ---------------------------------------------------------------------------

# (dims, n_sm for the plan, batch, x misalignment): several tiles with a
# ragged last one; n shorter than one tile; a batch of 3 whose rows start
# at every 16-byte remainder
CASES = {"ragged": ((10, 12, 14), tk.H100_SMS, None, 0),
         "short": ((6, 10, 12), 1, None, 2),
         "batch3": ((9, 10, 11), tk.H100_SMS, 3, 1)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_off", sorted(OFFSETS))
def test_emulation_equals_k1_plain(n_off, dtype, case):
    dims, n_sm, batch, mis = CASES[case]
    n = int(np.prod(dims))
    data, lins = _planes(dims, OFFSETS[n_off], dtype)
    x = _vec((n,) if batch is None else (batch, n), 1)
    plan = tk.tile_plan(lins, n, data.element_size(), batch=batch or 1,
                        n_sm=n_sm)
    if case == "short":
        assert plan.tile > n
    else:
        assert n % plan.tile != 0 and n > 2 * plan.tile
    y = tk.dia_spmv_tiled_ref(data, lins, x, plan=plan, x_misalign=mis)
    assert torch.equal(y, tk.dia_spmv_v2_ref(data, lins, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_off", [15, 32])
def test_emulation_equals_k1v1_plain(n_off, dtype):
    """Planes that are not boundary-zeroed: the zero fill of the windows
    is what K1v1 computes."""
    dims = (12, 10, 16)
    n = int(np.prod(dims))
    data, lins = _planes(dims, OFFSETS[n_off], dtype, zeroed=False, seed=4)
    x = _vec((2, n), 5)
    for mis in range(4):
        y = tk.dia_spmv_tiled_ref(data, lins, x, x_misalign=mis)
        assert torch.equal(y, tk.dia_spmv_v1_ref(data, lins, x))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_off", [7, 27])
@pytest.mark.parametrize("halo", ["empty", "reach", "longer", "short"])
def test_emulation_equals_k3_plain(halo, n_off, dtype):
    """K3: the windows filled from halo_left / halo_right, 0 beyond them;
    halos of length 0, exactly the reach, longer than it, and shorter."""
    dims = (8, 12, 16)
    n = int(np.prod(dims))
    data, lins = _planes(dims, OFFSETS[n_off], dtype, seed=6)
    LP, RP = tk.halo_reach(lins)
    lengths = {"empty": (0, 0), "reach": (LP, RP),
               "longer": (LP + 300, RP + 37), "short": (LP // 2, 5)}[halo]
    x = _vec(n, 7)
    hl, hr = _vec(lengths[0], 8), _vec(lengths[1], 9)
    y_ref = tk.dia_spmv_halo_ref(data, lins, x, hl, hr)
    for n_sm, mis in ((tk.H100_SMS, 0), (1, 3)):
        plan = tk.tile_plan(lins, n, data.element_size(), n_sm=n_sm)
        y = tk.dia_spmv_tiled_ref(data, lins, x, hl, hr, plan=plan,
                                  x_misalign=mis)
        assert torch.equal(y, y_ref)


@pytest.mark.parametrize("kernel", ["K1", "K3"])
def test_emulation_matches_jax(kernel):
    dims = (8, 16, 32)
    data, lins = _planes(dims, OFFSETS[15], torch.float32, seed=10)
    x = _vec(data.shape[1], 11)
    jd, jx = jnp.asarray(data.numpy()), jnp.asarray(x.numpy())
    if kernel == "K1":
        y = tk.dia_spmv_tiled_ref(data, lins, x)
        y_jax = dia_spmv_pallas_v2(jd, lins, jx, tile=1024, interpret=True)
    else:
        hl, hr = _vec(700, 12), _vec(300, 13)
        y = tk.dia_spmv_tiled_ref(data, lins, x, hl, hr)
        y_jax = dia_spmv_pallas_v2_halo(jd, lins, jx, jnp.asarray(hl.numpy()),
                                        jnp.asarray(hr.numpy()), tile=1024,
                                        interpret=True)
    assert rel_err(y.numpy(), np.asarray(y_jax)) <= 1e-6


def test_wrappers_count_launches_by_shape_only_on_the_card():
    """The wrappers refuse CPU tensors and count nothing."""
    data, lins = _planes((4, 8, 8), OFFSETS[7], torch.float32)
    x = _vec(data.shape[1], 2)
    before = (dict(launch.launches), dict(launch.launches_by_shape))
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_spmv_v2(data, lins, x)
    with pytest.raises(ValueError, match="CUDA"):
        tk.dia_spmv_halo(data, lins, x, x[:64], x[:64])
    assert (dict(launch.launches), dict(launch.launches_by_shape)) == before
