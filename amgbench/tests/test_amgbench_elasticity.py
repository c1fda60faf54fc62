"""The elasticity cell at CPU sizes: the harness's assembly and its
element-by-element reference against the program's gallery and SciPy,
sound runs correct, planted faults and the control not, and the W-cycle
byte count against the applies a recorded cycle makes."""

import numpy as np
import pytest
import torch

from amgbench import control, counts, counts_block, spec
from amgbench.generator import Stream
from amgbench.reference import elasticity as ref
from amgbench.run import run_cell

CELL = "elasticity-solve"
SIZE = {"n": 8}
E, NU = 1e5, 0.3


@pytest.mark.parametrize("n", [4, 6, 8])
def test_reference_residual_is_scipys(n):
    """b - A x element by element against SciPy's on the gallery's CSR."""
    from raptor_tpu_torch.gallery import elasticity_3d

    A, _, _ = elasticity_3d(n, E=E, nu=NU)
    rng = np.random.default_rng(n)
    x, b = rng.standard_normal(A.shape[0]), rng.standard_normal(A.shape[0])
    want = b - A @ x
    got = ref.residual(torch.from_numpy(x), torch.from_numpy(b), n, E, NU,
                       chunk=29).numpy()
    assert np.linalg.norm(got - want) <= 1e-12 * np.linalg.norm(want)
    assert ref.relres(torch.from_numpy(x), torch.from_numpy(b), n, E, NU) == \
        pytest.approx(np.linalg.norm(want) / np.linalg.norm(b), rel=1e-12)


@pytest.mark.parametrize("n", [3, 4, 5, 7, 9])
def test_assembly_is_the_gallerys(n):
    """The node-neighbour assembly gives the gallery's CSR bit for bit
    (pattern, order and values) and its rigid-body modes."""
    from raptor_tpu_torch.gallery import elasticity_3d

    A, B, _ = elasticity_3d(n, E=E, nu=NU)
    K, Bk = ref.assemble(n, E, NU, chunk=41)
    assert K.shape == A.shape == (ref.n_dof(n),) * 2
    assert np.array_equal(K.indptr, A.indptr)
    assert np.array_equal(K.indices, A.indices)
    assert np.array_equal(K.data, A.data)
    assert np.array_equal(Bk, B)


def test_sound_run_is_correct():
    out = run_cell(CELL, 2**31 + 99, 0.3, True, device="cpu", overrides=SIZE)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    m = out["metrics"]
    assert m["sa_setup_s.solve"]["value"] > 0
    # no device trace on the CPU: the roofline readers read nothing
    assert "bell_roofline_share.solve" not in m
    assert list(out)[-1] == "compared"


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
def test_a_planted_fault_is_not_correct(fault):
    out = run_cell(CELL, 17, 0.3, False, device="cpu", overrides={"n": 6},
                   faults=(fault,))
    assert not out["correct"], out["compared"]


def test_the_control_fails_the_limit():
    limit = spec.load_config(spec.load_cell(CELL)["config"])["limit"]["relres"]
    rows = control.run(CELL, [5, 6, 7], 1, device="cpu", overrides=SIZE)
    assert len(rows) == 3
    assert max(r["program"] for r in rows) <= limit
    assert min(r["control"] for r in rows) > 3 * limit


@pytest.mark.parametrize("tail", [0, 64], ids=["coarsest", "tail"])
def test_cycle_bytes_follow_the_recorded_applies(tail):
    """On a 4-level hierarchy (elasticity 12^3): each level's block
    applies in one recorded W-cycle are the counted visits' (and
    ``bell.launches`` counts them), and the bytes summed over the
    recorded applies are ``counts_block.cycle_bytes``."""
    from raptor_tpu_torch.core import bell
    from raptor_tpu_torch.utils.profiling import recording

    _, config, mix = spec.resolve(CELL, {"n": 12})
    config = {**config, "amg": {**config["amg"], "coarse_size": 8,
                                "tail_max_n": tail}}
    e = spec.load_engine(config["engine"]).Engine(
        config, Stream(mix, 3), torch.device("cpu"))
    e.setup()
    h = e.h
    assert len(h.levels) == 4
    assert all(lv.Abell is not None for lv in h.levels)
    levels, tail_n, revisit = e._levels()
    ts = len(levels) - 1
    assert ts == (2 if tail else 3) and revisit == bool(tail)
    deg = e.amg.cheb_degree
    v = counts_block.visits(ts, "W", revisit)
    na = counts_block.a_applies(ts, deg, "W", revisit)
    assert v == ([1, 2, 4] if tail else [1, 2, 4, 4])
    assert na == ([2 * deg, 4 * deg + 1, 2] if tail
                  else [2 * deg, 4 * deg + 1, 8 * deg + 2, 0])

    cyc = e.vcycle()
    bell.launches.clear()
    with recording() as rec:
        cyc()
    names = [s.name for s in rec.spans]
    assert bell.launches["bell_spmv"] == sum(na)
    assert bell.launches["bell_prec"] == sum(2 * deg * v[k] for k in range(ts))

    # bytes of each recorded apply, by its span's label
    each = {}

    def put(label, b):
        assert each.setdefault(label, b) == b, label

    for k, lc in enumerate(levels):
        A = h.levels[k].Abell
        put(f"bell.spmv[{A.nb_pad},{A.K},{A.bs},float32]",
            counts.apply_bytes(lc.nnz_a, lc.n, lc.n, 4, 4))
        if k < ts:
            put(f"bell.prec[{A.nb_pad},{A.bs},float32]",
                counts.apply_bytes(lc.n * A.bs, lc.n, lc.n, 4, 4))
            for E_ in (h.levels[k].R, h.levels[k].P):
                put(f"ell.spmv[{E_.n_rows_pad},{E_.K},float32]",
                    counts.apply_bytes(lc.nnz_p, lc.n_coarse, lc.n, 4, 4))
    put("vcycle.coarse", counts.apply_bytes(tail_n ** 2, tail_n, tail_n, 4, 4))
    for k in range(ts):
        A = h.levels[k].Abell
        assert names.count(f"bell.spmv[{A.nb_pad},{A.K},{A.bs},float32]") == na[k]
    assert names.count("vcycle.coarse") == v[ts]
    got = sum(each[n] for n in names if n in each)
    assert got == counts_block.cycle_bytes(levels, tail_n, deg, "W", revisit,
                                           4, 4)
    assert got == e.counts()["vcycle_bytes"]


def test_a_v_cycle_visits_each_level_once():
    assert counts_block.visits(3, "V", True) == [1, 1, 1, 1]
    assert counts_block.a_applies(3, 2, "V", True) == [4, 4, 4, 0]
    lv = counts_block.BlockLevel(n=10, nnz_a=30, n_coarse=4, nnz_p=10)
    tail = counts.apply_bytes(16, 4, 4, 4, 4)
    assert counts_block.cycle_bytes([lv, counts_block.BlockLevel(4, 16)], 4, 2,
                                    "V", True, 4, 4) == \
        4 * counts.apply_bytes(30, 10, 10, 4, 4) + \
        2 * counts.apply_bytes(10, 4, 10, 4, 4) + tail


def test_the_reference_and_a_run_load_no_jax():
    """The reference loads nothing of the program; a run of the cell loads
    the port and no JAX."""
    from amgbench.tests.test_amgbench_imports import _loaded
    from amgbench.run import FORBIDDEN

    top = _loaded("import amgbench.reference.elasticity")
    assert not top & (set(FORBIDDEN) | {"raptor_tpu_torch"})
    top = _loaded("from amgbench.run import run_cell\n"
                  "run_cell('elasticity-solve', 1, 0.1, True, device='cpu', "
                  "overrides={'n': 5})")
    assert "raptor_tpu_torch" in top and not top & set(FORBIDDEN)
