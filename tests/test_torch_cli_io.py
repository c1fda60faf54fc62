"""The port's user surface on the CPU: file I/O (``utils/io.py``), the
command line (``cli.py``, run in process with ``--device cpu``),
checkpoints (``utils/checkpoint.py``) and the profiling hooks
(``utils/profiling.py``).

* I/O: the reference's cases (``tests/unit/test_io.py``) against the port's
  copy, ``.mtx.gz`` written by the port, files written by the reference's
  ``write_matrix`` read back equal, and the same bytes for ``.mtx`` and
  ``.rbm``;
* CLI: the reference's CLI cases (``tests/unit/test_cli.py``), CLJP,
  ``--matrix``/``--rhs``/``--out`` and ``bench --preset config5 --n 16``,
  each against the reference CLI's JSON on the same arguments: iterations
  equal, relres within 1e-12 relative where both solve in fp64; the
  multi-card config-5 branch's rank body over two gloo ranks; a missing
  card is an error, never a fall back to the CPU;
* checkpoints: a banded algebraic hierarchy and a structured one saved and
  loaded give a bit-equal solve; solver state restarts warm; a file with
  any pickled global but tensors and plain containers is refused;
* profiling: ``trace`` writes a Chrome trace, ``phase`` and ``timed`` run.
"""

import gzip
import json
import os
import pickle

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

import raptor_tpu.utils.io as jio
import raptor_tpu_torch.api as tapi
from raptor_tpu.cli import main as jmain
from raptor_tpu_torch.cli import main as tmain
from raptor_tpu_torch.config import AmgConfig as TCfg
from raptor_tpu_torch.config import SolveConfig as TSolve
from raptor_tpu_torch.core.ell import pad_vector
from raptor_tpu_torch.gallery import (convection_diffusion_2d, default_rhs,
                                      poisson_2d)
from raptor_tpu_torch.utils.checkpoint import (load_hierarchy, load_pytree,
                                               save_hierarchy, save_pytree)
from raptor_tpu_torch.utils.io import (read_matrix, read_vector, write_matrix,
                                       write_vector)
from tests._torch_ref import shuffled_poisson, stencil_7pt

CPU = ["--device", "cpu"]


def _rand_csr(n=40, density=0.1, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    A = sp.random(n, n, density=density, random_state=rng, format="csr",
                  dtype=dtype)
    A.setdiag(np.abs(A).sum(1).A1 + 1.0)
    return A.tocsr()


# ---------------------------------------------------------------------------
# I/O
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", ["mtx", "mtx.gz", "npz", "rbm"])
def test_matrix_round_trip(tmp_path, ext):
    A = _rand_csr()
    p = tmp_path / f"a.{ext}"
    write_matrix(p, A)
    B = read_matrix(p)
    assert B.shape == A.shape and (B != A).nnz == 0


def test_matrix_round_trip_fp32_rbm(tmp_path):
    A = _rand_csr(dtype=np.float32)
    write_matrix(tmp_path / "a.rbm", A)
    B = read_matrix(tmp_path / "a.rbm")
    assert B.dtype == np.float32 and (B != A).nnz == 0


def test_mtx_gz_of_raw_bytes(tmp_path):
    A = poisson_2d(8)
    write_matrix(tmp_path / "a.mtx", A)
    with gzip.open(tmp_path / "a.mtx.gz", "wb") as f:
        f.write((tmp_path / "a.mtx").read_bytes())
    assert (read_matrix(tmp_path / "a.mtx.gz") != sp.csr_matrix(A)).nnz == 0


def test_read_matrix_canonicalizes(tmp_path):
    coo = sp.coo_matrix(([1.0, 2.0, 0.0], ([0, 0, 1], [1, 1, 0])), shape=(3, 3))
    scipy.io.mmwrite(str(tmp_path / "d.mtx"), coo)
    A = read_matrix(tmp_path / "d.mtx")
    assert A.nnz == 1 and A[0, 1] == 3.0


def test_rbm_rejects_garbage_and_truncation(tmp_path):
    p = tmp_path / "x.rbm"
    p.write_bytes(b"NOTMAGIC" + b"\0" * 64)
    with pytest.raises(ValueError, match="magic"):
        read_matrix(p)
    write_matrix(p, _rand_csr())
    p.write_bytes(p.read_bytes()[:-16])
    with pytest.raises(ValueError, match="truncated"):
        read_matrix(p)


def test_unknown_extension(tmp_path):
    with pytest.raises(ValueError, match="unsupported"):
        write_matrix(tmp_path / "a.xyz", _rand_csr())
    (tmp_path / "a.xyz").write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported"):
        read_matrix(tmp_path / "a.xyz")


@pytest.mark.parametrize("ext", ["npy", "txt"])
def test_vector_round_trip(tmp_path, ext):
    v = np.random.default_rng(0).standard_normal(37)
    write_vector(tmp_path / f"v.{ext}", v)
    assert np.allclose(v, read_vector(tmp_path / f"v.{ext}"), atol=0, rtol=1e-15)


@pytest.mark.parametrize("ext", ["mtx", "npz", "rbm"])
def test_reads_reference_files(tmp_path, ext):
    A = _rand_csr(seed=3)
    jio.write_matrix(tmp_path / f"a.{ext}", A)
    B, R = read_matrix(tmp_path / f"a.{ext}"), jio.read_matrix(tmp_path / f"a.{ext}")
    assert B.dtype == R.dtype and (B != R).nnz == 0 and (B != A).nnz == 0
    if ext != "npz":  # a zip archive carries its write time
        write_matrix(tmp_path / f"b.{ext}", A)
        assert ((tmp_path / f"b.{ext}").read_bytes()
                == (tmp_path / f"a.{ext}").read_bytes())


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def _run(main, argv, capsys):
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _both(argv, capsys):
    return _run(tmain, argv + CPU, capsys), _run(jmain, argv, capsys)


def test_cli_info(capsys):
    out = _run(tmain, ["info"] + CPU, capsys)
    assert out["backend"] == "cpu" and out["devices"] == ["cpu"]
    assert out["version"]


def test_cli_without_a_card_is_an_error(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda would run")
    for argv in (["info"], ["solve", "--n", "8"], ["bench"]):
        with pytest.raises(SystemExit, match="--device cpu"):
            tmain(argv)
    assert capsys.readouterr().out == ""


FP64_CASES = {
    "algebraic": ["solve", "--problem", "poisson2d", "--n", "16", "--fp64"],
    "structured": ["solve", "--problem", "poisson2d", "--n", "32",
                   "--method", "structured", "--fp64"],
    "banded": ["solve", "--problem", "poisson3d", "--n", "12",
               "--layout", "banded", "--fp64"],
}


@pytest.mark.parametrize("case", sorted(FP64_CASES))
def test_cli_fp64_solves_match_reference(case, capsys):
    got, ref = _both(FP64_CASES[case], capsys)
    assert got["iterations"] == ref["iterations"]
    assert got["relres"] <= 1e-8
    assert abs(got["relres"] - ref["relres"]) <= 1e-12 * ref["relres"]
    if case == "structured":
        assert got["true_relres"] <= 1e-7
    else:
        assert got["stats"]["sizes"] == ref["stats"]["sizes"]


@pytest.mark.parametrize("argv", [
    ["solve", "--problem", "poisson2d", "--n", "16", "--splitting", "cljp"],
    ["bench", "--preset", "config1", "--n", "16"],
], ids=["cljp", "config1"])
def test_cli_fp32_runs_match_reference(argv, capsys):
    got, ref = _both(argv, capsys)
    assert got["iterations"] == ref["iterations"]
    assert got["relres"] <= (1e-8 if argv[0] == "solve" else 1e-6)
    assert got["stats"]["sizes"] == ref["stats"]["sizes"]


def test_cli_config5_single_device_matches_reference(capsys):
    """``bench --preset config5`` on one device takes the structured route.
    The reference's CLI shards over every visible device (eight virtual
    CPU devices under the test settings), so its single-device route is
    called directly: the same hierarchy and solve as its CLI on one
    device."""
    import jax.numpy as jnp

    from raptor_tpu.config import AmgConfig as JCfg
    from raptor_tpu.structured import (build_structured_hierarchy,
                                       dia_from_stencil, structured_solve)

    got = _run(tmain, ["bench", "--preset", "config5", "--n", "16"] + CPU,
               capsys)
    assert got["problem"] == "poisson3d n=16 (structured, 1 device(s))"
    A = dia_from_stencil(stencil_7pt(), (16, 16, 16), dtype=jnp.float32)
    h = build_structured_hierarchy(
        A, JCfg(smoother="mcgs", coarse_size=512, max_levels=40),
        dim_policy="size")
    _, info = structured_solve(
        h, jnp.asarray(default_rhs(16**3, dtype=np.float32)), tol=1e-6,
        maxiter=200)
    assert got["iterations"] == int(info.iterations)
    assert got["relres"] <= 1e-6


def test_cli_config5_ranks_over_gloo():
    """The multi-card branch of ``bench --preset config5``, its rank body
    (``cli.config5_rank``) over two gloo ranks on the CPU: both ranks agree,
    the sharded solve reaches 1e-6 and takes the single-device structured
    solve's iterations on the same plan within one (fp32)."""
    from raptor_tpu_torch.cli import config5_rank
    from raptor_tpu_torch.parallel import spawn
    from raptor_tpu_torch.structured.dist import (CONFIG5, config5_problem,
                                                  plan_coarsening_dist)
    from raptor_tpu_torch.structured.solver import (_build_hierarchy_planned,
                                                    structured_solve)

    out = spawn(config5_rank, 2, "gloo", "cpu", 16, 200, timeout=240.0)
    assert out[0]["iterations"] == out[1]["iterations"]
    assert max(r["relres"] for r in out) <= 1e-6
    A, b = config5_problem(16, "cpu")
    plan, _ = plan_coarsening_dist(A, CONFIG5, 2, "size")
    _, info = structured_solve(_build_hierarchy_planned(A, CONFIG5, plan), b,
                               tol=1e-6, maxiter=200)
    assert abs(out[0]["iterations"] - int(info.iterations)) <= 1


def test_cli_solve_from_files(tmp_path, capsys):
    A = convection_diffusion_2d(16, epsilon=1e-2)
    b = default_rhs(A.shape[0])
    write_matrix(tmp_path / "A.rbm", A)
    write_vector(tmp_path / "b.npy", b)
    argv = ["solve", "--matrix", str(tmp_path / "A.rbm"), "--rhs",
            str(tmp_path / "b.npy"), "--krylov", "gmres", "--tol", "1e-8"]
    got = _run(tmain, argv + ["--out", str(tmp_path / "x.npy")] + CPU, capsys)
    ref = _run(jmain, argv, capsys)
    assert got["iterations"] == ref["iterations"] and got["relres"] <= 1e-8
    assert got["solution"] == str(tmp_path / "x.npy")
    x = read_vector(tmp_path / "x.npy")
    assert np.linalg.norm(A @ x - b) / np.linalg.norm(b) <= 1e-7


def test_cli_rhs_length_mismatch(tmp_path):
    write_matrix(tmp_path / "A.npz", poisson_2d(8))
    write_vector(tmp_path / "b.npy", np.ones(5))
    with pytest.raises(SystemExit, match="length"):
        tmain(["solve", "--matrix", str(tmp_path / "A.npz"),
               "--rhs", str(tmp_path / "b.npy")] + CPU)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_hierarchy_checkpoint_solves_bit_equal(tmp_path):
    A = shuffled_poisson(14)
    cfg = TCfg(splitting="pmis", interp="direct", fine_layout="banded",
               smoother="cheb4", cheb_degree=2)
    h = tapi.setup(A, cfg, device="cpu")
    assert h.levels[0].Aband is not None and h.perm is not None
    save_hierarchy(str(tmp_path / "h"), h)
    h2 = load_hierarchy(str(tmp_path / "h"), "cpu")
    assert h2.config == h.config and h2.tail_start == h.tail_start
    assert [lv.n for lv in h2.levels] == [lv.n for lv in h.levels]
    b = np.ones(A.shape[0])
    sc = TSolve(tol=1e-8, refine=True)
    x1, i1 = tapi.solve(A, b, cfg, sc, hier=h)
    x2, i2 = tapi.solve(A, b, cfg, sc, hier=h2)
    assert i1["iterations"] == i2["iterations"]
    assert np.array_equal(x1, x2)


def test_structured_checkpoint_cycles_bit_equal(tmp_path):
    from raptor_tpu_torch.structured import (build_structured_hierarchy,
                                             cast_hierarchy, dia_from_stencil,
                                             scycle)

    A = dia_from_stencil(stencil_7pt(), (12, 12, 12), device="cpu")
    h = cast_hierarchy(build_structured_hierarchy(
        A, TCfg(smoother="cheb4", cheb_degree=2, coarse_size=64,
                full_coarsening=True), "size"), torch.bfloat16)
    save_hierarchy(str(tmp_path / "s"), h)
    h2 = load_hierarchy(str(tmp_path / "s"), "cpu")
    assert h2.levels[0].A.data.dtype == torch.bfloat16
    b = torch.from_numpy(default_rhs(12**3, dtype=np.float32))
    assert torch.equal(scycle(h, b), scycle(h2, b))


def test_solver_state_checkpoint_restarts_warm(tmp_path):
    A = poisson_2d(16)
    b = default_rhs(A.shape[0])
    h = tapi.setup(A, TCfg(splitting="pmis"), dtype=np.float64, device="cpu")
    bd = pad_vector(b, h.levels[0].A.n_rows_pad, device="cpu")
    x1, info1 = tapi.solve_hier(h, bd, tol=1e-4, maxiter=100)
    save_pytree(str(tmp_path / "state"), {"x": x1, "it": int(info1.iterations),
                                          "note": ("warm", 1.5, None)})
    state = load_pytree(str(tmp_path / "state"))
    assert state["it"] == int(info1.iterations)
    assert state["note"] == ("warm", 1.5, None)
    x2, info2 = tapi.solve_hier(h, bd, tol=1e-8, maxiter=100, x0=state["x"])
    assert float(info2.relres) <= 1e-8
    _, info3 = tapi.solve_hier(h, bd, tol=1e-8, maxiter=100)
    assert int(info2.iterations) < int(info3.iterations)


class _Exploit:
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return (os.system, (f"touch {self.path}",))


def test_checkpoint_refuses_pickled_globals(tmp_path):
    marker = tmp_path / "ran"
    torch.save({"format": "raptor_tpu_torch.checkpoint/1",
                "payload": _Exploit(marker)}, tmp_path / "bad.pt")
    with pytest.raises(pickle.UnpicklingError):
        load_pytree(str(tmp_path / "bad"))
    assert not marker.exists()
    # a well-formed file naming a class outside the table
    torch.save({"format": "raptor_tpu_torch.checkpoint/1",
                "meta": json.dumps({"dc": "Popen", "f": {}}), "tensors": []},
               tmp_path / "odd.pt")
    with pytest.raises(ValueError, match="unknown class"):
        load_pytree(str(tmp_path / "odd"))


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_hooks(tmp_path):
    from raptor_tpu_torch.utils.profiling import phase, timed, trace

    sink = {}
    with trace(str(tmp_path / "tr")):
        with timed("setup", sink):
            with phase("strength"):
                _ = torch.ones(8) * 2
    assert sink["setup"] >= 0
    files = os.listdir(tmp_path / "tr")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "tr" / files[0]).read_text())
    assert any(e.get("name") == "strength"
               for e in events.get("traceEvents", []))
