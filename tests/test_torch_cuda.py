"""raptor_tpu_torch on an NVIDIA GPU: the hand-written kernels against
their plain versions on the same CUDA tensors, and the structured and
algebraic (banded) cycles and refined solves on the card against the same
computation on the CPU.

Every test is marked ``cuda`` and skips where torch.cuda.is_available() is
false.  The module imports no JAX, so it also runs on a machine without
it; there the repository's conftest (which imports JAX) is skipped:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

Kernel tolerance 1e-6 * max|y_ref|: the kernels round each product and sum
as the plain versions do, so only a reordering could differ.
"""

import itertools

import numpy as np
import pytest
import torch

import scipy.sparse as sp

import raptor_tpu_torch.structured.dia as tdia
import raptor_tpu_torch.structured.solver as ts
from raptor_tpu_torch.config import AmgConfig, SolveConfig
from raptor_tpu_torch.gallery import default_rhs, poisson_3d
from raptor_tpu_torch.ops.cuda import banded_kernel as bk
from raptor_tpu_torch.ops.cuda import dia_kernel as tk
from raptor_tpu_torch.ops.cuda import launch
from tests._torch_ref import (banded_tensors, clamped_rect_plan, cuda_device,
                              rcm_ell, rel_err, slots_twice, star,
                              stencil_5pt, stencil_7pt, wide_band,
                              with_dead_slots)

pytestmark = pytest.mark.cuda

TOL = 1e-6
CUBE = list(itertools.product((-1, 0, 1), repeat=3))
OFFSETS = {1: [(0, 1, 0)],
           3: [(-1, 0, 0), (0, 0, 0), (1, 0, 0)],
           7: [o for o in CUBE if sum(map(abs, o)) <= 1],
           15: [o for o in CUBE if abs(o[1]) + abs(o[2]) <= 1],
           27: CUBE,
           # the cube and five offsets reaching two cells
           32: CUBE + [(-2, 0, 0), (0, -2, 0), (0, 0, 2), (0, 2, 0), (2, 0, 0)]}
CFG = dict(smoother="cheb4", cheb_degree=2, coarse_size=64, max_levels=40)


def _planes(dims, offsets, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.standard_normal((len(offsets), int(np.prod(dims))))
    data = data.astype(np.float32)
    for k, o in enumerate(offsets):
        data[k] *= tdia.boundary_mask(dims, o)
    lins = [tdia._linear(o, dims) for o in offsets]
    return torch.from_numpy(data).to(dev, dtype), lins


def _x(n, dev, batch=None, seed=1):
    shape = (n,) if batch is None else (batch, n)
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_off,batch", [(3, None), (15, None), (27, 4)])
def test_k1_kernel_matches_plain(n_off, batch, dtype):
    dev = cuda_device()
    dims = (16, 32, 64)
    data, lins = _planes(dims, OFFSETS[n_off], dtype, dev)
    x = _x(data.shape[1], dev, batch)
    before = launch.launches["K1"]
    y = tk.dia_spmv_v2(data, lins, x)
    assert launch.launches["K1"] == before + 1
    assert rel_err(y.cpu(), tk.dia_spmv_v2_ref(data, lins, x).cpu()) <= TOL


@pytest.mark.parametrize("stencil,dims", [
    (stencil_7pt(), (32, 32, 32)), (stencil_5pt(), (64, 48)),
    (-np.ones((3, 3, 3)), (8, 16, 24))])
def test_k2_kernel_matches_plain(stencil, dims):
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil, dims, device=dev)
    x = _x(A.n, dev, batch=2)
    before = launch.launches["K2"]
    y = tk.dia_spmv_const(A.const_planes, A.offsets, dims, x)
    assert launch.launches["K2"] == before + 1
    y_ref = tk.dia_spmv_const_ref(A.const_planes, A.offsets, dims, x)
    assert rel_err(y.cpu(), y_ref.cpu()) <= TOL


def test_kernels_refuse_what_they_do_not_take():
    dev = cuda_device()
    data = torch.zeros(3, 64, device=dev)
    with pytest.raises(ValueError, match="float32"):
        tk.dia_spmv_v2(data, (-1, 0, 1),
                       torch.zeros(64, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="plane dtype"):
        tk.dia_spmv_v2(data.double(), (-1, 0, 1), torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="shape"):
        tk.dia_spmv_v2(data, (-1, 0, 1), torch.zeros(65, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        tk.dia_spmv_v2(data, (-1, 0, 1), torch.zeros(128, device=dev)[::2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_off,halo", [(7, (0, 0)), (7, (96, 96)),
                                        (7, (1024, 512)), (7, (4096, 4096)),
                                        (27, (4096, 300))])
def test_k3_kernel_matches_plain(n_off, halo, dtype):
    """K3 on the halo cases of tests/unit/test_pallas_dia.py:111 (16^3;
    the 7-offset reach is 256, so the short halos are zero-filled)."""
    dev = cuda_device()
    dims = (16, 16, 16)
    data, lins = _planes(dims, OFFSETS[n_off], dtype, dev)
    x = _x(data.shape[1], dev)
    hl, hr = _x(halo[0], dev, seed=2), _x(halo[1], dev, seed=3)
    before = launch.launches["K3"]
    y = tk.dia_spmv_halo(data, lins, x, hl, hr)
    assert launch.launches["K3"] == before + 1
    y_ref = tk.dia_spmv_halo_ref(data, lins, x, hl, hr)
    assert rel_err(y.cpu(), y_ref.cpu()) <= TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch", [None, 3])
def test_k1v1_kernel_matches_plain(batch, dtype):
    """Planes that are not boundary-zeroed: K1v1 reads x as zero outside
    [0, n)."""
    dev = cuda_device()
    dims = (16, 32, 64)
    n = int(np.prod(dims))
    rng = np.random.default_rng(6)
    data = torch.from_numpy(rng.standard_normal((15, n)).astype(np.float32))
    data = data.to(dev, dtype)
    lins = [tdia._linear(o, dims) for o in OFFSETS[15]]
    x = _x(n, dev, batch)
    before = launch.launches["K1v1"]
    y = tk.dia_spmv_v1(data, lins, x)
    assert launch.launches["K1v1"] == before + 1
    assert rel_err(y.cpu(), tk.dia_spmv_v1_ref(data, lins, x).cpu()) <= TOL


# ---------------------------------------------------------------------------
# the tiled kernel (K1, K1v1, K3) at its edges: bit for bit
# ---------------------------------------------------------------------------

def _view_at(t: torch.Tensor, skip: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``skip`` elements into a
    larger buffer, so its address is off a 16-byte boundary."""
    buf = torch.empty(t.numel() + skip, dtype=t.dtype, device=t.device)
    v = buf[skip:].view(t.shape)
    v.copy_(t)
    return v


# (dims, batch, x misalignment, planes misaligned): odd n, so plane k >= 1
# is off 16 bytes; an x view at an odd element offset; a level shorter
# than one tile; a batch of 3 whose rows start at every 16-byte remainder;
# planes whose base address is off 16 bytes
EDGES = {"odd n": ((7, 9, 11), None, 0, False),
         "x view": ((8, 16, 16), None, 1, False),
         "short": ((3, 5, 7), None, 3, False),
         "batch 3": ((5, 7, 9), 3, 2, False),
         "planes view": ((8, 8, 16), None, 0, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_off", [1, 7, 27, 32])
@pytest.mark.parametrize("edge", list(EDGES))
def test_k1_tiles_at_the_edges_bit_for_bit(edge, n_off, dtype):
    dev = cuda_device()
    dims, batch, mis, planes_view = EDGES[edge]
    data, lins = _planes(dims, OFFSETS[n_off], dtype, dev)
    n = data.shape[1]
    if planes_view:
        data = _view_at(data, 1)
    x = _view_at(_x(n, dev, batch), mis)
    plan = tk.tile_plan(lins, n, data.element_size(), data.data_ptr() % 16 == 0,
                        batch or 1, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    assert plan.vec == (not planes_view and n % plan.rows == 0)
    if edge == "short":
        assert n < plan.tile
    before = launch.launches["K1"]
    y = tk.dia_spmv_v2(data, lins, x)
    assert launch.launches["K1"] == before + 1
    assert torch.equal(y.cpu(), tk.dia_spmv_v2_ref(data, lins, x).cpu())
    y1 = tk.dia_spmv_v1(data, lins, x)
    assert torch.equal(y1.cpu(), tk.dia_spmv_v1_ref(data, lins, x).cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("halo", ["empty", "reach", "longer"])
@pytest.mark.parametrize("edge", ["odd n", "x view", "short"])
def test_k3_tiles_at_the_edges_bit_for_bit(edge, halo, dtype):
    dev = cuda_device()
    dims, _, mis, _ = EDGES[edge]
    data, lins = _planes(dims, OFFSETS[27], dtype, dev, seed=7)
    n = data.shape[1]
    LP, RP = tk.halo_reach(lins)
    lengths = {"empty": (0, 0), "reach": (LP, RP),
               "longer": (LP + 301, RP + 33)}[halo]
    x = _view_at(_x(n, dev, seed=8), mis)
    hl = _view_at(_x(lengths[0], dev, seed=9), 1)
    hr = _view_at(_x(lengths[1], dev, seed=10), 2)
    before = launch.launches["K3"]
    y = tk.dia_spmv_halo(data, lins, x, hl, hr)
    assert launch.launches["K3"] == before + 1
    assert torch.equal(y.cpu(), tk.dia_spmv_halo_ref(data, lins, x, hl, hr).cpu())


# name: (dims, offsets, batch, x misalignment): 1 to 4 dims; last dimensions
# that are no multiple of 4 (the per-row coordinates); a batch whose rows
# start at every 16-byte remainder; n smaller than the least tile; 5, 7, 9
# and 27 offsets (the generic body takes the 9)
K2_EDGES = {"1d": ((4099,), star(1), None, 0),
            "2d odd last": ((37, 18), star(2), None, 1),
            "2d": ((48, 64), star(2), 2, 0),
            "3d": ((16, 20, 24), star(3), None, 2),
            "3d odd last": ((9, 10, 11), star(3), 3, 3),
            "3d 27-point": ((12, 16, 20), CUBE, None, 0),
            "3d 27-point odd": ((7, 9, 13), CUBE, 2, 1),
            "4d": ((5, 6, 7, 8), star(4), None, 0),
            "4d odd last": ((3, 4, 5, 6), star(4), 3, 2),
            "short": ((5, 6), star(2), None, 1),
            # large enough for 8 or 16 rows a thread (the last dimension a
            # multiple of them)
            "3d 8 rows": ((64, 64, 72), star(3), None, 3),
            "3d 8 rows 27-point": ((48, 80, 88), CUBE, None, 0),
            "2d 16 rows": ((600, 512), star(2), 2, 1),
            "4d 8 rows": ((8, 8, 64, 72), star(4), None, 2),
            "1d 8 rows": ((300008,), star(1), None, 0),
            "3d 16 rows": ((80, 96, 80), star(3), None, 1),
            "3d 16 rows 27-point": ((96, 80, 96), CUBE, None, 2),
            "1d 16 rows, batch 2": ((300000,), star(1), 2, 3)}


@pytest.mark.parametrize("edge", list(K2_EDGES))
def test_k2_tiles_at_the_edges_bit_for_bit(edge):
    dev = cuda_device()
    dims, offsets, batch, mis = K2_EDGES[edge]
    n = int(np.prod(dims))
    consts = [float(c) for c in
              np.random.default_rng(2).standard_normal(len(offsets))]
    x = _view_at(_x(n, dev, batch), mis)
    plan = tk.const_tile_plan(offsets, dims, batch or 1,
                              torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    assert plan.rows == (int(edge.split()[1]) if "rows" in edge else 4)
    if edge == "short":
        assert n < plan.tile
    before = launch.launches["K2"]
    y = tk.dia_spmv_const(consts, offsets, dims, x)
    assert launch.launches["K2"] == before + 1
    y_ref = tk.dia_spmv_const_ref(consts, offsets, dims, x)
    assert torch.equal(y.cpu(), y_ref.cpu())


def test_k2_refuses_what_it_does_not_take():
    dev = cuda_device()
    x = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="dims"):
        tk.dia_spmv_const([1.0], [(0,) * 5], (2, 2, 2, 2, 4), x)
    with pytest.raises(ValueError, match="consts"):
        tk.dia_spmv_const([1.0, 2.0], [(0, 0)], (8, 8), x)
    with pytest.raises(ValueError, match="shape"):
        tk.dia_spmv_const([1.0], [(0, 0)], (8, 9), x)
    with pytest.raises(ValueError, match="steps"):
        tk.dia_spmv_const([1.0], [(0, 40000)], (8, 8), x)


# ---------------------------------------------------------------------------
# K7: the df64 DIA residual, bit for bit against the op-by-op version
# ---------------------------------------------------------------------------

def _stencil_27pt() -> np.ndarray:
    st = -np.ones((3, 3, 3))
    st[1, 1, 1] = 26.0
    return st


# (stencil, dims, diagonal shift): the const form at the structured
# engine's shapes, a last dimension no multiple of four (each row's own
# grid test), a grid shorter than a tile, 27 points and a 2D stencil
K7_CONST = {
    "64^3": (stencil_7pt, (64,) * 3, 0.0),
    "64^3 shifted": (stencil_7pt, (64,) * 3, 0.0371),
    "128^3": (stencil_7pt, (128,) * 3, 0.0),
    "128^3 shifted": (stencil_7pt, (128,) * 3, 0.0123),
    "33x17x9": (stencil_7pt, (33, 17, 9), 0.0),
    "5x7x3 shifted": (stencil_7pt, (5, 7, 3), 0.5),
    "27 points 20x24x28": (_stencil_27pt, (20, 24, 28), 0.0),
    "27 points 33x17x9": (_stencil_27pt, (33, 17, 9), 0.25),
    "2D 64x48": (stencil_5pt, (64, 48), 0.0),
}

# (offsets, dims) of variable-coefficient operators for the planes form:
# 7 and 27 points (their own kernels), 15 and 32 offsets (the generic
# body), odd n (planes loaded one value at a time)
K7_PLANES = {
    "7 points 64^3": (7, (64,) * 3),
    "27 points 32x40x48": (27, (32, 40, 48)),
    "7 points 33x17x9": (7, (33, 17, 9)),
    "27 points 5x7x3": (27, (5, 7, 3)),
    "15 offsets 16x32x64": (15, (16, 32, 64)),
    "32 offsets 16^3": (32, (16,) * 3),
}


def _df_vectors(n, dev, seed=1):
    """(xh, xl, bh, bl) on the card: random heads, tails under half an ulp,
    and one head in twenty scaled into fp32's subnormal range, so a
    flush to zero anywhere would show."""
    rng = np.random.default_rng(seed)
    out = []
    for scale in (1.0, 30.0):
        h = rng.standard_normal(n) * scale
        h[rng.random(n) < 0.05] *= 2.0**-130
        h = h.astype(np.float32)
        lo = (h * rng.uniform(-1, 1, n) * 2.0**-25).astype(np.float32)
        out += [torch.from_numpy(h).to(dev), torch.from_numpy(lo).to(dev)]
    return out


def _k7_equal(A, vecs):
    """K7 through ``dia_df64_residual`` (one call, one launch) against the
    plain version over the stored planes, on the card and on the CPU."""
    k7 = launch.launches["K7"]
    rh, rl = tdia.dia_df64_residual(A, *vecs)
    assert launch.launches["K7"] == k7 + 1
    want = tdia.dia_df64_residual_ref(A, *vecs)
    assert torch.equal(rh, want[0]) and torch.equal(rl, want[1])
    want = tdia.dia_df64_residual_ref(A.to("cpu"), *(v.cpu() for v in vecs))
    assert torch.equal(rh.cpu(), want[0]) and torch.equal(rl.cpu(), want[1])


@pytest.mark.parametrize("case", sorted(K7_CONST))
def test_k7_const_form_bit_for_bit(case):
    dev = cuda_device()
    stencil, dims, shift = K7_CONST[case]
    st = stencil()
    st[(1,) * st.ndim] += shift
    A = tdia.dia_from_stencil(st, dims, device=dev)
    assert A.const_planes is not None
    _k7_equal(A, _df_vectors(A.n, dev))


@pytest.mark.parametrize("case", sorted(K7_PLANES))
def test_k7_planes_form_bit_for_bit(case):
    dev = cuda_device()
    n_off, dims = K7_PLANES[case]
    data, _ = _planes(dims, OFFSETS[n_off], torch.float32, dev, seed=n_off)
    A = tdia.DiaMatrix(data=data, offsets=tuple(OFFSETS[n_off]), dims=dims)
    _k7_equal(A, _df_vectors(A.n, dev, seed=2))


@pytest.mark.parametrize("form", ["const", "planes"])
def test_k7_views_off_16_bytes(form):
    """xh, xl, bh and bl each start at another 16-byte remainder (the
    windows' round-down, element-wise loads and stores of the rows)."""
    dev = cuda_device()
    dims = (24, 20, 16)
    A = tdia.dia_from_stencil(stencil_7pt(), dims, device=dev)
    if form == "planes":
        A = tdia.DiaMatrix(data=_view_at(A.data, 1), offsets=A.offsets,
                           dims=dims)
    vecs = [_view_at(v, skip) for v, skip in
            zip(_df_vectors(A.n, dev, seed=3), (1, 2, 3, 0))]
    _k7_equal(A, vecs)


def test_k7_refuses_what_it_does_not_take():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 8), device=dev)
    v = torch.zeros(512, device=dev)
    with pytest.raises(ValueError, match="float32"):
        tdia.dia_df64_residual(A, *(v.double(),) * 4)
    with pytest.raises(ValueError, match="shape"):
        tdia.dia_df64_residual(A, *(v[None],) * 4)
    with pytest.raises(ValueError, match="plane dtype"):
        tdia.dia_df64_residual(tdia.DiaMatrix(data=A.data.bfloat16(),
                                              offsets=A.offsets, dims=A.dims),
                               v, v, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        tdia.dia_df64_residual(A, v, v, v.cpu(), v)


def test_k7_span_inside_the_refinement_residual():
    """The solver's residual is a ``refine.residual`` span holding one
    ``K7[n,offsets,dtype]`` span, as K1-K6 are spans of their launches."""
    from raptor_tpu_torch.utils.profiling import recording

    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 8), device=dev)
    with recording() as rec:
        ts._df64_residual(A, *_df_vectors(A.n, dev))
    names = [s.name for s in rec.spans]
    assert names == ["refine.residual", "K7[512,7,float32]"]
    assert rec.spans[1].parent == 0


def test_refined_solve_with_k7_equals_the_op_by_op_route(monkeypatch):
    """A refined solve at 64^3: three K7 launches or fewer (one a round and
    the first), the same iterations, relres and (xh, xl), bit for bit, as
    the route that computes every residual op by op on the card."""
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (64,) * 3, device=dev)
    h = ts.build_structured_hierarchy(A, AmgConfig(**CFG), dim_policy="size")
    hb = ts.cast_hierarchy(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(A.n, dtype=np.float32)).to(dev)
    k7 = launch.launches["K7"]
    (xh, xl), rel, it = ts.structured_solve_refined(h, b, tol=1e-8, M_hier=hb)
    launched = launch.launches["K7"] - k7
    monkeypatch.setattr(ts, "dia_df64_residual", tdia.dia_df64_residual_ref)
    (xh0, xl0), rel0, it0 = ts.structured_solve_refined(h, b, tol=1e-8,
                                                        M_hier=hb)
    assert launch.launches["K7"] - k7 == launched and 2 <= launched <= 4
    assert int(it) == int(it0) and float(rel) <= 1e-8
    assert torch.equal(rel, rel0)
    assert torch.equal(xh, xh0) and torch.equal(xl, xl0)


def test_tiled_launches_count_by_shape():
    dev = cuda_device()
    data, lins = _planes((8, 8, 16), OFFSETS[7], torch.bfloat16, dev)
    x = _x(data.shape[1], dev)
    key = ("K1", data.shape[1], 7, "bfloat16")
    before = launch.launches_by_shape[key]
    tk.dia_spmv_v2(data, lins, x)
    assert launch.launches_by_shape[key] == before + 1


def test_kernel_spans_hold_their_launches():
    """With recording on under the profiler, a K1 and a K2 launch each sit
    in a span named by kernel and shape, and the runtime call that launched
    the kernel (the one with the kernel's correlation id) lies inside it."""
    from torch.profiler import ProfilerActivity, profile

    from raptor_tpu_torch.utils.profiling import PREFIX, recording

    dev = cuda_device()
    data, lins = _planes((8, 8, 16), OFFSETS[7], torch.bfloat16, dev)
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 16), device=dev)
    x = _x(data.shape[1], dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        with recording():
            tk.dia_spmv_v2(data, lins, x)
            tk.dia_spmv_const(A.const_planes, A.offsets, A.dims, x)
        torch.cuda.synchronize()
    evs = p.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    spans = {e.name()[len(PREFIX):]: (e.start_ns(), e.start_ns()
                                      + e.duration_ns())
             for e in evs if e.name().startswith(PREFIX)
             and e.device_type() != cuda}
    assert set(spans) == {"K1[1024,7,bfloat16]", "K2[1024,7,float32]"}
    started = {e.correlation_id(): e.start_ns() for e in evs
              if e.device_type() != cuda and e.name().startswith("cu")}
    kernels = sorted((e for e in evs if e.device_type() == cuda
                      and not e.name().startswith(PREFIX)),
                     key=lambda e: e.start_ns())
    assert len(kernels) == 2
    for k, (a, b) in zip(kernels, (spans["K1[1024,7,bfloat16]"],
                                   spans["K2[1024,7,float32]"])):
        assert a <= started[k.correlation_id()] <= b


def test_k3_refuses_what_it_does_not_take():
    dev = cuda_device()
    data = torch.zeros(3, 64, device=dev)
    x, h = torch.zeros(64, device=dev), torch.zeros(8, device=dev)
    with pytest.raises(ValueError, match="one vector"):
        tk.dia_spmv_halo(data, (-8, 0, 8), torch.zeros(2, 64, device=dev), h, h)
    with pytest.raises(ValueError, match="halo_left"):
        tk.dia_spmv_halo(data, (-8, 0, 8), x, h.double(), h)
    with pytest.raises(ValueError, match="halo_right"):
        tk.dia_spmv_halo(data, (-8, 0, 8), x, h, h.cpu())
    with pytest.raises(ValueError, match="float32"):
        tk.dia_spmv_halo(data, (-8, 0, 8), x.double(), h, h)


def test_dia_spmv_counts_and_routes():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (8, 8, 8), device=dev)
    B = tdia.DiaMatrix(A.data, A.offsets, A.dims)  # stored planes: K1
    x = _x(A.n, dev)
    k1, k2 = launch.launches["K1"], launch.launches["K2"]
    ya, yb = tdia.dia_spmv(A, x), tdia.dia_spmv(B, x)
    assert (launch.launches["K1"], launch.launches["K2"]) == (k1 + 1, k2 + 1)
    assert torch.equal(ya, yb)


def test_cycle_and_refined_solve_on_card_match_cpu():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (16, 16, 16), device=dev)
    h = ts.build_structured_hierarchy(A, AmgConfig(**CFG), dim_policy="size")
    hc = h.to("cpu")
    b = torch.from_numpy(default_rhs(A.n, dtype=np.float32))
    hb, hcb = ts.cast_hierarchy(h, torch.bfloat16), ts.cast_hierarchy(hc, torch.bfloat16)
    assert rel_err(ts.scycle(hb, b.to(dev)).cpu(), ts.scycle(hcb, b)) <= 1e-5
    (xh, xl), rel, it = ts.structured_solve_refined(h, b.to(dev), tol=1e-8,
                                                    M_hier=hb)
    _, rel_c, it_c = ts.structured_solve_refined(hc, b, tol=1e-8, M_hier=hcb)
    assert int(it) == int(it_c)
    assert float(rel) <= 1e-8 and float(rel_c) <= 1e-8


def test_kernels_build_and_load():
    cuda_device()
    from raptor_tpu_torch.ops.cuda.build import build, load_library

    path, _ = build()
    assert path.exists()
    assert load_library().raptor_dia_planes_f32.restype is not None


# ---------------------------------------------------------------------------
# banded kernels K4, K5, K6 on the shuffled 16^3 algebraic hierarchy
# ---------------------------------------------------------------------------

ALG = dict(splitting="pmis", interp="direct", fine_layout="banded",
           smoother="cheb4", cheb_degree=2)


def _shuffled(nx, scale=1.0, seed=0):
    A = sp.csr_matrix(poisson_3d(nx)) * scale
    p = np.random.default_rng(seed).permutation(A.shape[0])
    return A[p][:, p].tocsr()


@pytest.fixture(scope="module")
def alg16():
    from raptor_tpu_torch.api import setup

    dev = cuda_device()
    A = _shuffled(16)
    return A, setup(A, AmgConfig(**ALG), device=dev)


def _bands(h):
    out = []
    for i, lv in enumerate(h.levels):
        for name in ("Aband", "Pband", "Rband"):
            band = getattr(lv, name)
            if band is not None:
                out.append((f"L{i} {name}", band))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_k6_kernels_match_plain(alg16, dtype):
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic

    _, h = alg16
    if dtype == torch.bfloat16:
        h = cast_hierarchy_algebraic(h, dtype)
    bands = _bands(h)
    assert {b for b, _ in bands} >= {"L0 Aband", "L0 Pband", "L0 Rband",
                                     "L1 Aband"}
    for label, band in bands:
        plan = band.plan()
        square = "n_cols" not in plan
        x = _x(plan["n"] if square else plan["n_cols"], plan["vals"].device)
        key = "K4" if square else "K6"
        fn, ref = ((bk.banded_spmv, bk.banded_spmv_ref) if square
                   else (bk.banded_spmv_rect, bk.banded_spmv_rect_ref))
        before = launch.launches[key]
        y = fn(plan, x)
        assert launch.launches[key] == before + 1, label
        assert rel_err(y.cpu(), ref(plan, x).cpu()) <= TOL, label
        assert torch.equal(y.cpu(), ref(plan, x).cpu()), label


@pytest.mark.parametrize("with_lo", [False, True])
def test_k5_kernel_matches_plain_and_fp64(with_lo):
    from raptor_tpu_torch.api import setup

    dev = cuda_device()
    A = _shuffled(16, scale=np.pi if with_lo else 1.0)
    h = setup(A, AmgConfig(**ALG), device=dev)
    band, lo = h.levels[0].Aband, h.a0_lo_band
    assert (lo is not None) == with_lo
    n, n_pad = A.shape[0], band.n_pad
    pm = h.perm[:n].cpu().numpy()
    Ar = A[pm][:, pm]
    rng = np.random.default_rng(3)

    def pad(a):
        out = np.zeros(n_pad, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    xh64 = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    b64 = rng.standard_normal(n)
    bh = b64.astype(np.float32)
    v = (rng.standard_normal(n) * 1e-6).astype(np.float32)
    args = (pad(xh64), pad(bh), pad(b64 - bh), pad(v))
    plan = band.plan()
    before = launch.launches["K5"]
    rh, rl = bk.banded_df64_residual(plan, lo, *args)
    assert launch.launches["K5"] == before + 1
    rh_ref, rl_ref = bk.banded_df64_residual_ref(plan, lo, *args)
    assert torch.equal(rh.cpu(), rh_ref.cpu())
    assert torch.equal(rl.cpu(), rl_ref.cpu())
    got = rh.double().cpu().numpy() + rl.double().cpu().numpy()
    ref = b64 - v - Ar @ xh64
    scale = np.abs(Ar @ xh64).max()
    assert np.abs(got[:n] - ref).max() <= 1e-12 * scale
    # both variants forced at every block size, xh also as a view off 16
    # bytes (the staged window's round-down)
    for staged in (True, False):
        for threads in (256, 128, 32):
            lp = bk.banded_launch_plan(plan, staged=staged, threads=threads)
            for mis in (0, 1):
                xh = _view_at(args[0], mis)
                before = launch.launches["K5"]
                rh, rl = bk._launch_k5(plan, lo, xh, *args[1:], lp)
                assert launch.launches["K5"] == before + 1
                assert torch.equal(rh.cpu(), rh_ref.cpu()), (staged, threads)
                assert torch.equal(rl.cpu(), rl_ref.cpu()), (staged, threads)
                got = rh.double().cpu().numpy() + rl.double().cpu().numpy()
                assert np.abs(got[:n] - ref).max() <= 1e-12 * scale


def test_banded_kernels_refuse_what_they_do_not_take(alg16):
    _, h = alg16
    plan = h.levels[0].Aband.plan()
    dev = plan["vals"].device
    n = plan["n"]
    with pytest.raises(ValueError, match="float32"):
        bk.banded_spmv(plan, torch.zeros(n, device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        bk.banded_spmv(plan, torch.zeros(n + 1, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_spmv(plan, torch.zeros(n))
    with pytest.raises(ValueError, match="contiguous"):
        bk.banded_spmv(plan, torch.zeros(2 * n, device=dev)[::2])
    rplan = h.levels[0].Rband.plan()
    with pytest.raises(ValueError, match="shape"):
        bk.banded_spmv_rect(rplan, torch.zeros(rplan["n_cols"] - 1, device=dev))
    z = torch.zeros(n, device=dev)
    with pytest.raises(ValueError, match="float32"):
        bk.banded_df64_residual(dict(plan, vals=plan["vals"].bfloat16()),
                                None, z, z, z, z)


def test_banded_calls_count_and_route(alg16):
    from raptor_tpu_torch.core import hybrid

    _, h = alg16
    lv = h.levels[0]
    x = _x(lv.Aband.n_pad, lv.Aband.vals.device)
    k4 = launch.launches["K4"]
    y = hybrid.banded_spmv_ro(lv.Aband, x)
    assert launch.launches["K4"] == k4 + 1
    from raptor_tpu_torch.ops.sparse_ops import spmv

    assert rel_err(y.cpu(), spmv(lv.A, x).cpu()) <= 1e-5


def test_banded_cycle_and_solve_on_card_match_cpu(alg16):
    from raptor_tpu_torch.api import solve
    from raptor_tpu_torch.solve.cycle import cycle

    A, h = alg16
    hc = h.to("cpu")
    b = torch.from_numpy(default_rhs(h.levels[0].A.n_rows_pad, dtype=np.float32))
    assert rel_err(cycle(h, b.to(h.device)).cpu(), cycle(hc, b)) <= 1e-5
    rhs = np.ones(A.shape[0])
    sc = SolveConfig(tol=1e-8, refine=True)
    x, info = solve(A, rhs, AmgConfig(**ALG), sc, hier=h)
    _, info_c = solve(A, rhs, AmgConfig(**ALG), sc, hier=hc)
    assert info["iterations"] == info_c["iterations"] == 7
    assert np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs) <= 1e-8


@pytest.mark.parametrize("smoother", ["mcgs", "tsgs"])
def test_gauss_seidel_banded_cycle_on_card_matches_cpu(smoother):
    """An mcgs and a tsgs V-cycle on shuffled 16^3 with banded levels: each
    colour's residual (mcgs) and the outer residual (tsgs) go through K4,
    the transfers through K6; the card's cycle against the CPU's."""
    from raptor_tpu_torch.api import setup
    from raptor_tpu_torch.solve.cycle import cycle

    dev = cuda_device()
    cfg = AmgConfig(**dict(ALG, smoother=smoother))
    h = setup(_shuffled(16), cfg, device=dev)
    assert h.levels[0].Aband is not None
    if smoother == "mcgs":
        assert h.levels[0].color is not None and h.levels[0].ncolors > 1
    hc = h.to("cpu")
    b = torch.from_numpy(default_rhs(h.levels[0].A.n_rows_pad, dtype=np.float32))
    before = dict(launch.launches)
    y = cycle(h, b.to(dev)).cpu()
    assert launch.launches["K4"] > before.get("K4", 0)
    assert launch.launches["K6"] > before.get("K6", 0)
    assert rel_err(y, cycle(hc, b)) <= 1e-5


# ---------------------------------------------------------------------------
# K4 at every variant its launch plan can pick: bit for bit
# ---------------------------------------------------------------------------

def _k4_plan(case: str, dtype, dev) -> dict:
    from raptor_tpu_torch.ops import banded_plan as bp

    if case == "page cap":
        return banded_tensors(bp.banded_plan(*wide_band(48 * 1024, 23 * 1024)),
                              dtype, dev)
    plan = banded_tensors(bp.banded_plan(*rcm_ell(10 if case == "one tile"
                                                  else 16)), dtype, dev)
    if case in ("dead slots", "two chunks"):
        plan = with_dead_slots(plan)
    return slots_twice(plan) if case == "two chunks" else plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 128, 64, 32])
@pytest.mark.parametrize("case", ["one tile", "four tiles", "dead slots",
                                  "two chunks", "page cap"])
def test_k4_variants_bit_for_bit(case, threads, staged, dtype):
    """Staged and direct; 256, 128, 64 and 32 threads a block; 3, 7 and 14
    live slots (the two loop-free kernels and the looping one); live slots
    that are no prefix; a one-tile level; a 47-page window (188 KB of
    shared memory); x views at 16-byte remainders 0, 1 and 3."""
    dev = cuda_device()
    plan = _k4_plan(case, dtype, dev)
    if case != "page cap":
        live = bk.live_slots(plan)
        assert (live != list(range(len(live)))) == (case in ("dead slots",
                                                             "two chunks"))
    lp = bk.banded_launch_plan(plan, staged=staged, threads=threads)
    assert lp.staged == staged and lp.threads == threads
    for mis in (0, 1, 3):
        x = _view_at(_x(plan["n"], dev, seed=4 + mis), mis)
        before = launch.launches["K4"]
        y = bk._launch_k4(plan, x, lp)
        assert launch.launches["K4"] == before + 1
        assert torch.equal(y.cpu(), bk.banded_spmv_ref(plan, x).cpu())
        assert torch.equal(y.cpu(), bk.banded_spmv_tiled_ref(
            {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in plan.items()},
            x.cpu(), lp, mis).cpu())


def test_k4_default_launch_and_refusals():
    dev = cuda_device()
    plan = _k4_plan("dead slots", torch.float32, dev)
    x = _x(plan["n"], dev)
    assert torch.equal(bk.banded_spmv(plan, x).cpu(),
                       bk.banded_spmv_ref(plan, x).cpu())
    lp = bk.banded_launch_plan(plan)
    with pytest.raises(ValueError, match="does not tile"):
        bk._launch_k4(plan, x, lp._replace(threads=lp.threads * 2))
    with pytest.raises(ValueError, match="aligned"):
        bk._launch_k4(dict(plan, vals=_view_at(plan["vals"], 1)), x)
    # the C entry point refuses a window beyond the tile's
    with pytest.raises(RuntimeError, match="cudaError"):
        bk._launch_k4(plan, x, bk.banded_launch_plan(plan, staged=True)
                      ._replace(pages=64))


# ---------------------------------------------------------------------------
# K6 at every variant its launch plan can pick: bit for bit
# ---------------------------------------------------------------------------

def _k6_plan(case: str, h, dtype) -> dict:
    if case == "clamped":
        plan = clamped_rect_plan(h.device)
    else:
        level, name = int(case[1]), {"P": "Pband", "R": "Rband"}[case[3]]
        plan = getattr(h.levels[level], name).plan()
        if case.endswith("dead slots"):
            plan = slots_twice(with_dead_slots(plan))
    return dict(plan, vals=plan["vals"].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 128, 64, 32])
@pytest.mark.parametrize("case", ["L0 P", "L0 R", "L1 R", "L0 R dead slots",
                                  "clamped"])
def test_k6_variants_bit_for_bit(alg16, case, threads, staged, dtype):
    """Staged and direct, each with a thread's rows consecutive or 32
    apart, and direct with one row a thread; 256, 128, 64 and 32 threads a
    block; 3, 6, 7 and 19 live slots
    and the slots twice over with dead ones among them (one chunk of 4, one
    of 8, the loop); windows clamped at both ends of x; x views at 16-byte
    remainders 0, 1 and 3."""
    _, h = alg16
    plan = _k6_plan(case, h, dtype)
    lps = [bk.banded_launch_plan(plan, staged=staged, threads=threads,
                                 rows=4, stride=stride) for stride in (1, 32)]
    if not staged:
        lps.append(bk.banded_launch_plan(plan, staged=False, threads=threads,
                                         rows=1))
    assert all(lp.staged == staged and lp.threads == threads for lp in lps)
    cpu = {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in plan.items()}
    for mis in (0, 1, 3):
        x = _view_at(_x(plan["n_cols"], h.device, seed=20 + mis), mis)
        y_ref = bk.banded_spmv_rect_ref(plan, x).cpu()
        assert torch.equal(y_ref, bk.banded_spmv_rect_tiled_ref(
            cpu, x.cpu(), lps[0], x_misalign=mis))
        for lp in lps:
            before = launch.launches["K6"]
            y = bk._launch_k6(plan, x, lp)
            assert launch.launches["K6"] == before + 1
            assert torch.equal(y.cpu(), y_ref), (lp, mis)


@pytest.mark.parametrize("staged", [True, False])
def test_k6_clamped_pages_carry_non_finite_x(alg16, staged):
    """A NaN on x's first page and an inf on its last, read by masked
    entries through window pages the clamp maps there: 0 * x is NaN on the
    card as in the plain version."""
    _, h = alg16
    plan = clamped_rect_plan(h.device)
    for at, bad in ((0, float("nan")), (3072, float("inf"))):
        x = _x(plan["n_cols"], h.device, seed=30)
        x[at] = bad
        y_ref = bk.banded_spmv_rect_ref(plan, x)
        assert int(torch.isnan(y_ref).sum()) >= 2048
        for threads in (256, 64):
            lps = [bk.banded_launch_plan(plan, staged=staged, threads=threads,
                                         rows=4, stride=stride)
                   for stride in (1, 32)]
            if not staged:
                lps.append(bk.banded_launch_plan(plan, staged=False,
                                                 threads=threads, rows=1))
            for lp in lps:
                torch.testing.assert_close(bk._launch_k6(plan, x, lp), y_ref,
                                           rtol=0, atol=0, equal_nan=True)


def test_k6_k5_refusals(alg16):
    """A window wider than a block's shared memory is refused when staging
    is forced and runs direct otherwise; the C entry points refuse a
    window beyond the plan's pages; vals_lo off 16 bytes is refused."""
    _, h = alg16
    rplan = h.levels[0].Rband.plan()
    x = _x(rplan["n_cols"], h.device)
    wide = dict(rplan, npage=60, ranges=None)
    with pytest.raises(ValueError, match="shared memory"):
        bk.banded_launch_plan(wide, staged=True)
    assert not bk.banded_launch_plan(wide).staged
    assert torch.equal(bk._launch_k6(wide, x).cpu(),
                       bk.banded_spmv_rect_ref(wide, x).cpu())
    lp = bk.banded_launch_plan(rplan, staged=True)
    with pytest.raises(RuntimeError, match="cudaError"):
        bk._launch_k6(rplan, x, lp._replace(pages=rplan["npage"] + 1))
    with pytest.raises(ValueError, match="does not tile"):
        bk._launch_k6(rplan, x, lp._replace(threads=lp.threads * 2))
    with pytest.raises(ValueError, match="apart"):
        bk._launch_k6(rplan, x, lp._replace(stride=4))
    with pytest.raises(ValueError, match="direct"):
        bk._launch_k6(rplan, x, lp._replace(rows=1, split=lp.split * 4))
    aplan = h.levels[0].Aband.plan()
    z = torch.zeros(aplan["n"], device=h.device)
    lo = torch.zeros(aplan["vals"].shape, device=h.device)
    with pytest.raises(ValueError, match="aligned"):
        bk.banded_df64_residual(aplan, _view_at(lo, 1), z, z, z, z)
    with pytest.raises(RuntimeError, match="cudaError"):
        bk._launch_k5(aplan, None, z, z, z, z, bk.banded_launch_plan(
            aplan, staged=True)._replace(pages=64))


# ---------------------------------------------------------------------------
# the sharded forms: K4 on a halo buffer, K6 with map_cols; bit for bit
# ---------------------------------------------------------------------------

def _tile_rows(plan: dict, t0: int, t1: int) -> dict:
    """Tiles [t0, t1) of a tensor plan: one rank's block."""
    return dict(plan, n=(t1 - t0) * plan["tile"],
                vals=plan["vals"][t0:t1].contiguous(),
                pidx=plan["pidx"][t0:t1].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("threads", [256, 128, 32])
@pytest.mark.parametrize("case", ["four tiles", "two chunks", "page cap"])
def test_k4_halo_form_bit_for_bit(case, threads, staged, dtype):
    """K4's halo form on a rank's tiles (the middle two of four, so every
    window reaches into both halos; a 47-page window) against its plain
    version and the block-by-block emulation, with x_pad views at 16-byte
    remainders 0, 1 and 3."""
    dev = cuda_device()
    plan = _k4_plan(case, dtype, dev)
    T = plan["n"] // plan["tile"]
    mine = _tile_rows(plan, T // 4, T // 4 + max(T // 2, 1))
    lp = bk.banded_launch_plan(mine, staged=staged, threads=threads)
    h = bk.halo_width(mine)
    for mis in (0, 1, 3):
        x_pad = _view_at(_x(mine["n"] + 2 * h, dev, seed=7 + mis), mis)
        before = launch.launches["K4-halo"]
        y = bk._launch_k4(mine, x_pad, lp, halo=True)
        assert launch.launches["K4-halo"] == before + 1
        ref = bk.banded_spmv_halo_ref(mine, x_pad)
        assert torch.equal(y.cpu(), ref.cpu())
        assert torch.equal(y.cpu(), bk.banded_spmv_tiled_ref(
            {k: (v.cpu() if torch.is_tensor(v) else v) for k, v in mine.items()},
            x_pad.cpu(), lp, mis, halo=True))


def _rect_block(band, rank: int, ndev: int) -> tuple:
    """Rank ``rank``'s tiles of a RectBanded over ``ndev`` ranks as
    dist_rect_banded_spmv calls K6 (WpP folded into the buffer), the
    buffer's length and the map_cols numerator."""
    plan = band.plan()
    K, n, n_cols, tile, WpP, npage = band.meta
    t_loc = n // tile // ndev
    mine = _tile_rows(plan, rank * t_loc, (rank + 1) * t_loc)
    cols_loc = n_cols // ndev
    return dict(mine, WpP=0), cols_loc + npage * 1024, cols_loc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_map_cols_form_bit_for_bit(alg16, dtype):
    """K6's map_cols form on rank 0's and the last rank's tiles of every
    banded P and R of the 16^3 hierarchy over 2 ranks, and with windows
    clamped at both ends of a short buffer (WpP 2, three pages); by its
    default launch and with each variant forced on buffers at 16-byte
    remainders 0 and 1."""
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic

    _, h = alg16
    if dtype == torch.bfloat16:
        h = cast_hierarchy_algebraic(h, dtype)
    # the transfers that split over 2 ranks in whole tiles and pages
    bands = [(label, b) for label, b in _bands(h) if "Aband" not in label
             and (b.meta[1] // b.meta[3]) % 2 == 0 and b.meta[2] % 2048 == 0]
    assert {label for label, _ in bands} >= {"L0 Pband", "L0 Rband"}
    for label, band in bands:
        for rank in (0, 1):
            plan, length, cols_loc = _rect_block(band, rank, 2)
            cases = [(plan, length, cols_loc), (dict(plan, WpP=2), 3 * 1024,
                                                 band.meta[2])]
            for p, m, mc in cases:
                x = _x(m, plan["vals"].device, seed=rank)
                before = launch.launches["K6-map_cols"]
                y = bk.banded_spmv_rect(p, x, map_cols=mc)
                assert launch.launches["K6-map_cols"] == before + 1, label
                y_ref = bk.banded_spmv_rect_ref(p, x, map_cols=mc)
                assert torch.equal(y.cpu(), y_ref.cpu()), (label, rank)
                # both variants forced, the buffer also off 16 bytes
                lps = [bk.banded_launch_plan(p, staged=staged, stride=stride,
                                             rows=4)
                       for staged, stride in itertools.product((True, False),
                                                               (1, 32))]
                lps.append(bk.banded_launch_plan(p, staged=False, rows=1))
                for lp in lps:
                    for mis in (0, 1):
                        xv = _view_at(x, mis)
                        assert torch.equal(bk._launch_k6(
                            p, xv, lp, map_cols=mc).cpu(), y_ref.cpu()), (
                                label, rank, lp, mis)


def test_sharded_forms_refuse_what_they_do_not_take(alg16):
    _, h = alg16
    plan = h.levels[0].Aband.plan()
    dev = plan["vals"].device
    n, hw = plan["n"], bk.halo_width(plan)
    with pytest.raises(ValueError, match="shape"):
        bk.banded_spmv_halo(plan, torch.zeros(n, device=dev))
    with pytest.raises(ValueError, match="CUDA"):
        bk.banded_spmv_halo(plan, torch.zeros(n + 2 * hw))
    rplan = h.levels[0].Rband.plan()
    with pytest.raises(ValueError, match="multiple"):
        bk.banded_spmv_rect(rplan, torch.zeros(1000, device=dev), map_cols=1024)


def test_sharded_applies_on_card_launch_the_new_forms(alg16):
    """On a ring of one (gloo, in this process), the sharded operator and
    transfer applies of level 0 launch K4's halo form and K6's map_cols
    form and agree bit for bit with the same applies on the CPU."""
    import torch.distributed as dist

    from raptor_tpu_torch.parallel import Ring
    from raptor_tpu_torch.parallel import dist as pdist

    _, h = alg16
    lv = h.levels[0]
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        ring = Ring()
        for fn, band, key in ((pdist.dist_banded_spmv, lv.Aband, "K4-halo"),
                              (pdist.dist_rect_banded_spmv, lv.Rband,
                               "K6-map_cols")):
            n_in = band.n_pad if key == "K4-halo" else band.meta[2]
            x = _x(n_in, band.vals.device, seed=11)
            before = launch.launches[key]
            y = fn(band, x, ring)
            assert launch.launches[key] == before + 1
            assert torch.equal(y.cpu(), fn(band.to("cpu"), x.cpu(), ring))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# plane mode: K1 on the DIA planes of a geo-split hierarchy
# ---------------------------------------------------------------------------

GEO = dict(splitting="pmis", interp="extended", fine_layout="banded",
           smoother="cheb4", cheb_degree=3)


@pytest.fixture(scope="module")
def geo32():
    """Natural-ordered 32^3 Poisson in plane mode, no folded tail: DIA
    planes on levels 0-4 (32768 rows and 7 offsets, 16384 and 15, then 27
    down to 2048 rows), built on the host and moved to the card."""
    from raptor_tpu_torch.api import setup

    dev = cuda_device()
    A = sp.csr_matrix(poisson_3d(32))
    return A, setup(A, AmgConfig(**GEO, tail_max_n=0), device=dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level,n_off,n", [(0, 7, 32768), (2, 27, 8192),
                                           (4, 27, 2048)])
def test_k1_on_geo_planes_bit_for_bit(geo32, level, n_off, n, dtype):
    """A 7-offset fine level, a 27-offset coarse level and the smallest
    level with planes, fp32 and bf16: through ``_planes_spmv``, which
    launches K1 once."""
    from raptor_tpu_torch.core import hybrid

    H = geo32[1].levels[level].Ahyb
    assert (len(H.offsets), H.n_pad, H.spill) == (n_off, n, None)
    planes = H.planes.to(dtype).contiguous()
    x = _x(n, planes.device, seed=level)
    k1 = launch.launches["K1"]
    y = hybrid._planes_spmv(planes, H.offsets, x)
    assert launch.launches["K1"] == k1 + 1
    assert torch.equal(y, tk.dia_spmv_v2_ref(planes, H.offsets, x))


def test_planes_spmv_raises_where_k1_refuses(geo32):
    """No fallback: 33 planes (K1 takes at most 32), a bf16 x and a CPU x
    with card planes all raise."""
    from raptor_tpu_torch.core import hybrid

    H = geo32[1].levels[2].Ahyb
    dev = H.planes.device
    x = _x(H.n_pad, dev)
    planes33 = torch.cat([H.planes, H.planes[:6]])
    offsets33 = H.offsets + H.offsets[:6]
    with pytest.raises(ValueError, match="planes"):
        hybrid._planes_spmv(planes33, offsets33, x)
    with pytest.raises(ValueError, match="float32"):
        hybrid._planes_spmv(H.planes, H.offsets, x.bfloat16())
    with pytest.raises(ValueError):
        hybrid._planes_spmv(H.planes, H.offsets, x.cpu())


def test_geo_cycle_and_solve_on_card_match_cpu(geo32):
    """A bf16 V-cycle on the card against the same cycle on the CPU, and
    the refined solve's iterations (the CPU's) and true relres."""
    from raptor_tpu_torch.api import solve
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic
    from raptor_tpu_torch.solve.cycle import cycle

    A, h = geo32
    hm = cast_hierarchy_algebraic(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(h.levels[0].A.n_rows_pad, dtype=np.float32))
    assert rel_err(cycle(hm, b.to(h.device)).cpu(), cycle(hm.to("cpu"), b)) <= 1e-5
    rhs = np.ones(A.shape[0])
    cfg = AmgConfig(**GEO, tail_max_n=0, operator_store_dtype="bfloat16")
    sc = SolveConfig(tol=1e-8, refine=True)
    x, info = solve(A, rhs, cfg, sc, hier=h)
    _, info_c = solve(A, rhs, cfg, sc, hier=h.to("cpu"))
    assert info["iterations"] == info_c["iterations"]
    assert np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs) <= 1e-8


# ---------------------------------------------------------------------------
# CLJP on the card: the threefry bits, the splitting and its banded levels
# ---------------------------------------------------------------------------

def _threefry_np(key, x1):
    """Threefry-2x32 of the counters (0, x1) in NumPy uint32 arithmetic,
    which wraps at 32 bits by itself."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = np.zeros_like(x1) + ks[0]
    x1 = x1 + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


@pytest.mark.parametrize("it", [0, 7])
@pytest.mark.parametrize("n", [1, 4097, 884736])
def test_threefry_bits_on_card_match_numpy(n, it):
    from raptor_tpu_torch.utils import threefry

    dev = cuda_device()
    with np.errstate(over="ignore"):
        key = _threefry_np((0, 17), np.array([it], np.uint32))
        key = (int(key[0][0]), int(key[1][0]))
        sub = [_threefry_np(key, np.array([c], np.uint32)) for c in (0, 1)]
        cnt = np.arange(n, dtype=np.uint32)
        hi, lo = (np.bitwise_xor(*_threefry_np((int(a[0]), int(b[0])), cnt))
                  for a, b in sub)
    ref = ((hi % 31) * 4 + lo % 31) % 31  # 2^32 mod 31 = 4
    got = threefry.cljp_bits(it, n, device=dev)
    assert got.is_cuda and got.dtype == torch.int32
    assert np.array_equal(got.cpu().numpy(), ref.astype(np.int32))


CLJP = dict(ALG, splitting="cljp")


@pytest.fixture(scope="module")
def cljp16():
    from raptor_tpu_torch.api import setup

    dev = cuda_device()
    A = _shuffled(16)
    cfg = AmgConfig(**CLJP, host_setup_threshold=0)
    return A, setup(A, cfg, device=dev), setup(A, cfg, device="cpu")


def test_cljp_splitting_on_card_matches_cpu():
    from raptor_tpu_torch.core.ell import ell_from_csr
    from raptor_tpu_torch.setup.cljp import cljp_splitting
    from raptor_tpu_torch.setup.splitting import make_perm
    from raptor_tpu_torch.setup.strength import strength_mask

    dev = cuda_device()
    A = _shuffled(24)
    E = ell_from_csr(A, dtype=np.float32)
    out = []
    for d in (dev, "cpu"):
        Ed = E.to(d)
        sm = strength_mask(Ed, 0.25, "classical")
        out.append(cljp_splitting(Ed, sm, make_perm(A.shape[0], E.n_rows_pad,
                                                    0, device=d)).cpu())
    assert torch.equal(out[0], out[1])


def test_cljp_levels_built_on_card_equal_cpu(cljp16):
    _, h, hc = cljp16
    assert [lv.n for lv in h.levels] == [lv.n for lv in hc.levels]
    for lv, lc in zip(h.levels, hc.levels):
        assert torch.equal(lv.A.cols.cpu(), lc.A.cols)
        assert rel_err(lv.A.data.cpu(), lc.A.data) <= 1e-5


def test_cljp_banded_shapes_bit_for_bit(cljp16):
    """K4 on every banded level and K6 on every banded P and R of a CLJP
    hierarchy (CLJP's denser coarse grids give wider rows than PMIS's)."""
    _, h, _ = cljp16
    n_k4 = n_k6 = 0
    for i, lv in enumerate(h.levels):
        if lv.Aband is not None:
            plan = lv.Aband.plan()
            x = _x(plan["n"], plan["vals"].device, seed=i)
            assert torch.equal(bk.banded_spmv(plan, x), bk.banded_spmv_ref(plan, x))
            n_k4 += 1
        for band in (lv.Pband, lv.Rband):
            if band is not None:
                r = band.plan()
                x = _x(r["n_cols"], r["vals"].device, seed=i)
                assert torch.equal(bk.banded_spmv_rect(r, x),
                                   bk.banded_spmv_rect_ref(r, x))
                n_k6 += 1
    assert n_k4 >= 1 and n_k6 >= 2


def test_cljp_solve_on_card_matches_cpu(cljp16):
    from raptor_tpu_torch.api import solve

    A, h, hc = cljp16
    rhs = np.ones(A.shape[0])
    cfg = AmgConfig(**CLJP, host_setup_threshold=0)
    sc = SolveConfig(tol=1e-8, refine=True)
    before = dict(launch.launches)
    x, info = solve(A, rhs, cfg, sc, hier=h)
    assert all(launch.launches[k] > before.get(k, 0) for k in ("K4", "K5", "K6"))
    _, info_c = solve(A, rhs, cfg, sc, hier=hc)
    assert info["iterations"] == info_c["iterations"]
    assert np.linalg.norm(rhs - A @ x) / np.linalg.norm(rhs) <= 1e-8


# ---------------------------------------------------------------------------
# full coarsening: K1 at its 27-offset transfers and coarse operators
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full32():
    dev = cuda_device()
    A = tdia.dia_from_stencil(stencil_7pt(), (32, 32, 32), device=dev)
    return ts.build_structured_hierarchy(
        A, AmgConfig(**CFG, full_coarsening=True), dim_policy="size")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("what", ["L0 Pt", "L0 Rt", "L1 A"])
def test_k1_at_full_coarsening_shapes_bit_for_bit(full32, what, dtype):
    lev, name = what.split()
    lv = full32.levels[int(lev[1])]
    assert lv.cdim == ts.FULL_STEP if lev == "L0" else True
    M = {"Pt": lv.Pt, "Rt": lv.Rt, "A": lv.A}[name]
    assert len(M.offsets) == 27
    data = M.data.to(dtype).contiguous()
    lins = M.linear_offsets()
    x = _x(M.n, data.device)
    before = launch.launches["K1"]
    y = tk.dia_spmv_v2(data, lins, x)
    assert launch.launches["K1"] == before + 1
    assert torch.equal(y, tk.dia_spmv_v2_ref(data, lins, x))


def test_full_coarsening_cycle_and_solve_on_card_match_cpu(full32):
    h = full32
    hm = ts.cast_hierarchy(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(32**3, dtype=np.float32))
    dev = h.levels[0].A.device
    assert rel_err(ts.scycle(hm, b.to(dev)).cpu(),
                   ts.scycle(hm.to("cpu"), b)) <= 1e-5
    _, _, it = ts.structured_solve_refined(h, b.to(dev), tol=1e-8, M_hier=hm)
    _, _, it_c = ts.structured_solve_refined(h.to("cpu"), b, tol=1e-8,
                                             M_hier=hm.to("cpu"))
    assert int(it) == int(it_c)


# ---------------------------------------------------------------------------
# the sharded algebraic setup (parallel/dist_setup.py) on a ring of one
# ---------------------------------------------------------------------------

def test_dist_setup_one_rank_on_card_matches_cpu():
    """dist_build_hierarchy of poisson_3d(16) on one NCCL rank, in fp64:
    every sharded level holds CUDA tensors, and the level sizes, the C/F
    set of the fine level, every level's A and P structure and their
    values (to 1e-12) equal the same build on the CPU."""
    import torch.distributed as dist

    from raptor_tpu_torch.core.ell import ell_from_csr
    from raptor_tpu_torch.parallel import Ring, dist_build_hierarchy
    from raptor_tpu_torch.parallel import dist_setup as ds
    from raptor_tpu_torch.parallel.partition import distribute_matrix
    from raptor_tpu_torch.setup.splitting import make_perm

    dev = cuda_device()
    A = poisson_3d(16)
    cfg = AmgConfig(splitting="pmis", interp="direct", smoother="cheb4",
                    coarse_size=64, host_setup_threshold=0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        hs = {d: dist_build_hierarchy(A, cfg, ring, 256, torch.float64,
                                      device=d) for d in (dev, "cpu")}
        g, c = hs[dev], hs["cpu"]
        assert [lv.n for lv in g.levels] == [lv.n for lv in c.levels]
        assert [lv.n for lv in g.tail.levels] == [lv.n for lv in c.tail.levels]
        for lg, lc in zip(g.levels, c.levels):
            for mg, mc in ((lg.A, lc.A), (lg.Pmat, lc.Pmat)):
                if mc is None:
                    assert mg is None
                    continue
                assert mg.data.is_cuda and mg.cols.is_cuda
                assert torch.equal(mg.cols.cpu(), mc.cols)
                assert torch.equal(mg.row_nnz.cpu(), mc.row_nnz)
                assert (mg.data.cpu() - mc.data).abs().max() <= 1e-12
        assert torch.equal(g.bridge_P.cols.cpu(), c.bridge_P.cols)
        assert (g.bridge_P.data.cpu() - c.bridge_P.data).abs().max() <= 1e-12
        E = ell_from_csr(A, dtype=np.float64, row_pad_multiple=8)
        perm = make_perm(E.shape[0], E.n_rows_pad, cfg.seed, device="cpu")
        cf = {}
        for d in (dev, "cpu"):
            dm = distribute_matrix(E.to(d) if d != "cpu" else E, ring)
            cf[d] = ds._run_split(ring, dm, perm.to(d), cfg, E.n_rows_pad)[0]
        assert cf[dev].is_cuda and torch.equal(cf[dev].cpu(), cf["cpu"])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the sharded smoothed-aggregation setup (parallel/dist_sa.py) on a ring of
# one
# ---------------------------------------------------------------------------

def _close_to(got, ref, tol=1e-10) -> bool:
    """|got - ref| <= tol * max(1, max|ref|), got moved to the CPU."""
    scale = max(1.0, float(ref.abs().max()))
    return float((got.cpu() - ref).abs().max()) <= tol * scale


@pytest.mark.parametrize("case", ["elastic", "scalar"])
def test_dist_sa_one_rank_on_card_matches_cpu(case):
    """dist_build_sa_hierarchy on a gloo ring of one, in fp64:
    elasticity_3d(8) with config 4's block smoother and its rigid-body
    modes, and poisson_2d(32) with one candidate and cheb4.  Every sharded
    tensor, binv included, lies on the card; the sizes, the A, P and R
    structure, the bridge, and the values of A, P, dinv, binv and
    lambda_max (to 1e-10 of the largest entry: the batched QR and the
    block inverses are other libraries' on the two devices) equal the same
    build on the CPU, and dist_solve takes the same iterations."""
    import torch.distributed as dist

    from raptor_tpu_torch.gallery import elasticity_3d, poisson_2d
    from raptor_tpu_torch.parallel import Ring, dist_build_sa_hierarchy, dist_solve

    dev = cuda_device()
    if case == "elastic":
        A, B, _ = elasticity_3d(8)
        cfg = AmgConfig(splitting="aggregation", interp="smoothed",
                        smoother="block_cheb", num_candidates=6, theta=0.08,
                        coarse_size=64, tail_max_n=0)
    else:
        A, B = poisson_2d(32), None
        cfg = AmgConfig(splitting="aggregation", interp="smoothed",
                        smoother="cheb4", coarse_size=32, tail_max_n=0)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        ring = Ring()
        hs = {d: dist_build_sa_hierarchy(A, cfg, ring, B, 256, torch.float64,
                                         device=d) for d in (dev, "cpu")}
        g, c = hs[dev], hs["cpu"]
        assert [lv.n for lv in g.levels] == [lv.n for lv in c.levels]
        assert [lv.n for lv in g.tail.levels] == [lv.n for lv in c.tail.levels]
        for lg, lc in zip(g.levels, c.levels):
            assert (lg.binv is None) == (lc.binv is None) == (case != "elastic")
            for tg, tc in ((lg.dinv, lc.dinv), (lg.binv, lc.binv),
                           (lg.cheb_lmax, lc.cheb_lmax)):
                if tc is not None:
                    assert tg.is_cuda and _close_to(tg, tc)
            for mg, mc in ((lg.A, lc.A), (lg.Pmat, lc.Pmat), (lg.Rmat, lc.Rmat)):
                if mc is None:
                    assert mg is None
                    continue
                assert mg.data.is_cuda and mg.cols.is_cuda
                assert torch.equal(mg.cols.cpu(), mc.cols)
                assert torch.equal(mg.row_nnz.cpu(), mc.row_nnz)
                assert _close_to(mg.data, mc.data)
        assert torch.equal(g.bridge_P.cols.cpu(), c.bridge_P.cols)
        assert _close_to(g.bridge_P.data, c.bridge_P.data)
        b = torch.zeros(g.levels[0].n_local, dtype=torch.float64)
        b[:A.shape[0]] = torch.from_numpy(default_rhs(A.shape[0]))
        xg, ig = dist_solve(g, b.to(dev), ring, tol=1e-8, maxiter=200)
        xc, ic = dist_solve(c, b, ring, tol=1e-8, maxiter=200)
        assert xg.is_cuda and int(ig.iterations) == int(ic.iterations)
        assert _close_to(xg, xc, 1e-8)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# several cards: one NCCL rank a card (skipped below two cards)
# ---------------------------------------------------------------------------

def _two_cards() -> None:
    cuda_device()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs two or more CUDA cards (one NCCL rank a card): "
                    f"torch.cuda.device_count() is {n}")


def test_ring_over_nccl_equals_gloo_on_two_cards():
    """Two NCCL ranks, spawned with the device "cuda": rank r runs on
    cuda:r, its current device, and every shift, psum, pmax and all_gather
    in fp32, fp64, int64 and bf16 (1-D, 2-D and empty shifts) equals the
    gloo ring's result on the same inputs and what the inputs give."""
    from raptor_tpu_torch.parallel import spawn
    from tests import _torch_multicard_spmd as mc

    _two_cards()
    out = spawn(mc.ring_against_gloo, 2, "nccl", "cuda", timeout=120.0)
    assert [o["device"] for o in out] == ["cuda:0", "cuda:1"]
    assert [o["current"] for o in out] == [0, 1]
    assert not any(o["host_staged"] for o in out)
    for o in out:
        assert o["differ"] == [] and o["equal"] > 0


def test_sdist_config5_on_two_cards_takes_one_ranks_iterations():
    """``sdist_config5`` at 32^3 on two NCCL ranks, one a card: both ranks
    agree, within one iteration of the single-device solve on the one-rank
    plan, certified relres <= 1e-6, the gathered x finite."""
    from raptor_tpu_torch.parallel import spawn
    from raptor_tpu_torch.structured.dist import (CONFIG5, CONFIG5_MAXITER,
                                                  CONFIG5_TOL, config5_problem,
                                                  plan_coarsening_dist)
    from raptor_tpu_torch.structured.solver import (_build_hierarchy_planned,
                                                    structured_solve)
    from tests import _torch_multicard_spmd as mc

    _two_cards()
    n = 32
    out = spawn(mc.config5, 2, "nccl", "cuda", n, timeout=120.0)
    A, b = config5_problem(n, cuda_device())
    plan, _ = plan_coarsening_dist(A, CONFIG5, 1, "size")
    _, info = structured_solve(_build_hierarchy_planned(A, CONFIG5, plan), b,
                               tol=CONFIG5_TOL, maxiter=CONFIG5_MAXITER)
    assert [o["device"] for o in out] == ["cuda:0", "cuda:1"]
    assert out[0]["iters"] == out[1]["iters"]
    assert abs(out[0]["iters"] - int(info.iterations)) <= 1
    assert max(o["relres"] for o in out) <= CONFIG5_TOL
    x = out[0]["x"]
    assert x.shape == (n ** 3,) and np.isfinite(x).all()


def test_bench_kernel_check_and_headline_on_card():
    """``bench_torch.py --rows kernels,structured128`` on the card, as a user
    runs it: exit 0; every kernel equal to its plain version at the bench's
    shapes (the last line's pass flags); the 128^3 structured row at the
    reference's 7 PCG iterations, true relres <= 1e-8; the card named."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    cuda_device()
    p = subprocess.run([sys.executable, "bench_torch.py", "--rows",
                        "kernels,structured128"],
                       cwd=Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(ln) for ln in p.stdout.splitlines()]
    last, rows = lines[-1], {ln["row"]: ln for ln in lines[:-1]}
    assert last["ok"] and last["failed"] == []
    assert last["detail"]["kcheck"] == dict.fromkeys(
        ["K1", "K1v1", "K2", "K3", "K4", "K4-halo", "K5", "K6",
         "K6-map_cols", "K7"], True)
    assert last["detail"]["iters"] == rows["structured128"]["iters"] == 7
    assert rows["structured128"]["relres"] <= 1e-8
    assert last["card"]["name"] == torch.cuda.get_device_name(0)
    assert all(c["ms"] > 0 for c in rows["kernels"]["cases"])
