"""raptor_tpu_torch — the algebraic-multigrid solver of ``raptor_tpu``
ported to PyTorch, with hand-written CUDA kernels for Hopper.

What is ported so far:

* the structured (DIA) engine's main path: stencil operators,
  semicoarsening setup, V-/W-cycles with five smoothers, PCG and the
  df64-certified refined solve;
* the plane-sharded structured engine (config 5) over torch.distributed:
  one process per rank, halo shifts over NCCL or host-staged gloo
  (``parallel/comm.py``), the block-by-block setup and the sharded cycle
  and solve (``structured/dist.py``, ``structured/dist_setup.py``);
* PCG, BiCGStab and (F)GMRES with an injectable inner product;
* the algebraic engine's banded general-matrix path: ``setup``/``solve``
  on a scipy CSR matrix with the host (NumPy) level loop (RS or PMIS;
  direct, classical or extended interpolation), the RCM-banded layouts,
  V-/W-cycles with jacobi, chebyshev and cheb4, PCG and the df64-refined
  solve;
* the JAX-free configuration and stencil gallery.

The DIA (plain and halo-extended), banded and rectangular SpMVs and the
banded df64 residual run through the kernels of ``raptor_tpu_torch/csrc``
on CUDA tensors and through plain PyTorch on CPU tensors.  This package
never imports JAX.
"""

__version__ = "0.1.0"

from raptor_tpu_torch.config import AmgConfig, SolveConfig, PRESETS
from raptor_tpu_torch.structured import (
    DiaMatrix,
    dia_from_stencil,
    dia_from_scipy,
    dia_to_scipy,
    dia_spmv,
    dia_mult,
    dia_transpose,
    dia_add,
    dia_rap,
    SLevel,
    plan_coarsening,
    SHierarchy,
    build_structured_hierarchy,
    structured_solve,
    structured_solve_refined,
    scycle,
    cast_hierarchy,
    dia_from_numpy,
    hierarchy_from_numpy,
    sdist_build_hierarchy,
    sdist_solve,
)
from raptor_tpu_torch.solve.krylov import KrylovInfo, bicgstab, gmres, pcg
from raptor_tpu_torch.core.ell import EllMatrix
from raptor_tpu_torch.core.hybrid import BandedMatrix, RectBanded
from raptor_tpu_torch.setup.hierarchy import Hierarchy, Level
from raptor_tpu_torch.api import setup, solve, solve_hier, solve_hier_refined

__all__ = [
    "AmgConfig",
    "SolveConfig",
    "PRESETS",
    "DiaMatrix",
    "dia_from_stencil",
    "dia_from_scipy",
    "dia_to_scipy",
    "dia_spmv",
    "dia_mult",
    "dia_transpose",
    "dia_add",
    "dia_rap",
    "SLevel",
    "plan_coarsening",
    "SHierarchy",
    "build_structured_hierarchy",
    "structured_solve",
    "structured_solve_refined",
    "scycle",
    "cast_hierarchy",
    "dia_from_numpy",
    "hierarchy_from_numpy",
    "sdist_build_hierarchy",
    "sdist_solve",
    "KrylovInfo",
    "pcg",
    "bicgstab",
    "gmres",
    "setup",
    "solve",
    "solve_hier",
    "solve_hier_refined",
    "Hierarchy",
    "Level",
    "EllMatrix",
    "BandedMatrix",
    "RectBanded",
]
