from raptor_tpu_torch.structured.dia import (
    DiaMatrix,
    dia_from_stencil,
    dia_from_scipy,
    dia_to_scipy,
    dia_spmv,
    dia_mult,
    dia_transpose,
    dia_add,
    dia_rap,
)
from raptor_tpu_torch.structured.solver import (
    SLevel,
    plan_coarsening,
    SHierarchy,
    build_structured_hierarchy,
    structured_solve,
    structured_solve_refined,
    scycle,
    cast_hierarchy,
)
from raptor_tpu_torch.structured.convert import (
    dia_from_numpy,
    hierarchy_from_numpy,
)

__all__ = [
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
]
