"""raptor_tpu_torch — the algebraic-multigrid solver of ``raptor_tpu``
ported to PyTorch, with hand-written CUDA kernels for Hopper.

Everything the JAX package does on one device is ported:

* the structured (DIA) engine: stencil operators, semicoarsening and full
  coarsening (BoxMG-style staged interpolation), V-/W-cycles with five
  smoothers, the folded dense coarse tail, PCG and the df64-certified
  refined solve;
* the algebraic engine (``setup``/``solve`` on a scipy CSR matrix): RS,
  PMIS and CLJP splittings, aggressive coarsening with multipass
  interpolation, direct, classical and extended+i interpolation, smoothed
  aggregation; levels above ``host_setup_threshold`` (CLJP levels at every
  size) built with tensors on the device, the rest on the host in NumPy;
  the ELL, BlockELL, RCM-banded and DIA-plane layouts; jacobi, chebyshev,
  cheb4, multicolor and two-stage Gauss-Seidel and the block smoothers;
* PCG, BiCGStab and (F)GMRES with an injectable inner product;
* the plane-sharded structured engine (config 5), the algebraic sharded
  setup (``dist_build_hierarchy``: PMIS or CLJP, direct, classical or
  extended+i interpolation, aggressive coarsening with multipass
  interpolation, on row shards), the sharded smoothed-aggregation setup
  (``dist_build_sa_hierarchy``, config 4's pipeline) and the algebraic
  sharded solve (``distribute_hierarchy``, ``dist_solve``, TAPS) over
  torch.distributed;
* matrix and vector file I/O, hierarchy and solver-state checkpoints,
  spans over the solve and set-up paths (``utils/profiling.py``), and the
  command line (``python -m raptor_tpu_torch``);
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
from raptor_tpu_torch.parallel.dist_setup import dist_build_hierarchy
from raptor_tpu_torch.parallel.dist_sa import dist_build_sa_hierarchy
from raptor_tpu_torch.utils.io import (read_matrix, read_vector, write_matrix,
                                       write_vector)

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
    "dist_build_hierarchy",
    "dist_build_sa_hierarchy",
    "Hierarchy",
    "Level",
    "EllMatrix",
    "BandedMatrix",
    "RectBanded",
    "read_matrix",
    "read_vector",
    "write_matrix",
    "write_vector",
]
