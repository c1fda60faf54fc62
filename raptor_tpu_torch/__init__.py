"""raptor_tpu_torch — the structured algebraic-multigrid solver of
``raptor_tpu`` ported to PyTorch, with hand-written CUDA kernels for Hopper.

What is ported so far: the structured (DIA) engine's main path — stencil
operators, semicoarsening setup, V-/W-cycles with five smoothers, PCG and
the df64-certified refined solve — plus the JAX-free configuration and
stencil gallery.  The DIA SpMV runs through the kernels of
``raptor_tpu_torch/csrc`` on CUDA tensors and through plain PyTorch on CPU
tensors.  This package never imports JAX.
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
)
from raptor_tpu_torch.solve.krylov import KrylovInfo, pcg

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
    "KrylovInfo",
    "pcg",
]
