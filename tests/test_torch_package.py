"""Package-level checks of raptor_tpu_torch: it never imports JAX or the
JAX package, its kernel sources and bindings agree, and chip_smoke.py
refuses to run without a GPU.  Import checks run in a subprocess because
this test process has JAX loaded already (tests/conftest.py)."""

import ast
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "raptor_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py"))


def _run(code: str, cwd=ROOT, timeout=120):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, timeout=timeout,
                          capture_output=True, text=True)


def test_import_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'raptor_tpu.')) or m == 'raptor_tpu')\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "raptor_tpu"}, roots


def test_bound_symbols_exist_in_cuda_source():
    """Every C entry point load_library binds is defined in csrc."""
    src = "".join(p.read_text() for p in (PKG / "csrc").glob("*.cu"))
    build = (PKG / "ops" / "cuda" / "build.py").read_text()
    bound = set(re.findall(r"raptor_(?:dia|banded|bell)_\w+", build))
    assert bound == {"raptor_dia_planes_f32", "raptor_dia_planes_bf16",
                     "raptor_dia_const_f32", "raptor_dia_halo_f32",
                     "raptor_dia_halo_bf16", "raptor_banded_f32",
                     "raptor_banded_bf16", "raptor_banded_rect_f32",
                     "raptor_banded_rect_bf16", "raptor_banded_df64_f32",
                     "raptor_dia_df64_f32", "raptor_bell_f32",
                     "raptor_bell_bf16", "raptor_bell_f64"}
    for name in bound:
        assert re.search(rf"\bint {name}\(", src), name


def test_build_flags_target_hopper():
    from raptor_tpu_torch.ops.cuda.build import LINK_FLAGS, NVCC_FLAGS

    assert "arch=compute_90a,code=sm_90a" in NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in LINK_FLAGS
    assert "-O3" in NVCC_FLAGS and "-shared" in LINK_FLAGS


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """No GPU, or no repository beside the script: exit != 0, no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path)
        cwd = tmp_path
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          timeout=120, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.mark.parametrize("sub", ["setup", "solve", "core", "ops", "parallel"])
def test_subpackages_export_the_reference_names(sub):
    """Each subpackage re-exports the names the reference's does (the
    reference's ``__all__``, read from its source; ``parallel`` since its
    sharded SA setup, ``dist_build_sa_hierarchy``), plus CLJP's splitting
    in ``setup``."""
    import importlib

    ref = ast.parse((ROOT / "raptor_tpu" / sub / "__init__.py").read_text())
    names = next(ast.literal_eval(node.value) for node in ref.body
                 if isinstance(node, ast.Assign)
                 and node.targets[0].id == "__all__")
    mod = importlib.import_module(f"raptor_tpu_torch.{sub}")
    assert set(names) <= set(mod.__all__)
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name
    if sub == "setup":
        assert "cljp_splitting" in mod.__all__


def test_cli_info_runs_without_jax():
    """``python -m raptor_tpu_torch info --device cpu`` in a fresh process
    names the CPU and loads no JAX."""
    proc = subprocess.run([sys.executable, "-m", "raptor_tpu_torch", "info",
                           "--device", "cpu"], cwd=ROOT, timeout=120,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = __import__("json").loads(proc.stdout.strip().splitlines()[-1])
    assert out["backend"] == "cpu" and out["devices"] == ["cpu"]
    code = ("import sys, runpy\n"
            "sys.argv = ['raptor_tpu_torch', 'info', '--device', 'cpu']\n"
            "runpy.run_module('raptor_tpu_torch', run_name='__main__')\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'raptor_tpu.')) or m == 'raptor_tpu')\n"
            "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_dist_build_hierarchy_exported_without_jax():
    """``dist_build_hierarchy`` is importable from ``raptor_tpu_torch`` and
    ``raptor_tpu_torch.parallel`` (the reference's ``raptor_tpu.parallel``
    exports it too), and importing them loads no JAX."""
    ref = ast.parse((ROOT / "raptor_tpu" / "parallel" / "__init__.py").read_text())
    assert "dist_build_hierarchy" in ast.dump(ref)
    code = ("import sys\n"
            "import raptor_tpu_torch as r\n"
            "from raptor_tpu_torch.parallel import dist_build_hierarchy as d\n"
            "from raptor_tpu_torch.parallel.dist_setup import "
            "dist_build_hierarchy as e\n"
            "assert r.dist_build_hierarchy is d is e\n"
            "assert 'dist_build_hierarchy' in r.__all__\n"
            "import raptor_tpu_torch.parallel as p\n"
            "assert 'dist_build_hierarchy' in p.__all__\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'raptor_tpu.')) or m == 'raptor_tpu')\n"
            "assert not bad, bad\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_host_kernels_source_is_the_ports_own_copy():
    """The host splitting kernels build from the port's copy of the
    reference's ``native/host_kernels.cpp``, which lies under
    ``raptor_tpu_torch/`` and equals the reference's byte for byte."""
    from raptor_tpu_torch.utils.native import SRC

    assert SRC.resolve().is_relative_to(PKG.resolve())
    assert SRC.read_bytes() == (ROOT / "native" / "host_kernels.cpp").read_bytes()
