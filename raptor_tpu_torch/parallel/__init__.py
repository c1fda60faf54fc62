from raptor_tpu_torch.parallel.comm import Ring, rank_devices, spawn
from raptor_tpu_torch.parallel.partition import (
    HaloPlan,
    DistMatrix,
    distribute_matrix,
    repartition_pad,
)
from raptor_tpu_torch.parallel.halo import halo_exchange, dist_spmv, psum_dot
from raptor_tpu_torch.parallel.dist import (
    DistLevel,
    DistHierarchy,
    distribute_hierarchy,
    dist_solve,
    make_solve_mesh,
)
from raptor_tpu_torch.parallel.dist_setup import dist_build_hierarchy
from raptor_tpu_torch.parallel.dist_sa import dist_build_sa_hierarchy
from raptor_tpu_torch.parallel.dist_taps import (
    TapsDistHierarchy,
    distribute_hierarchy_taps,
    dist_solve_taps,
    make_taps_mesh,
)

__all__ = [
    "Ring",
    "rank_devices",
    "spawn",
    "TapsDistHierarchy",
    "distribute_hierarchy_taps",
    "dist_solve_taps",
    "make_taps_mesh",
    "HaloPlan",
    "DistMatrix",
    "distribute_matrix",
    "repartition_pad",
    "halo_exchange",
    "dist_spmv",
    "psum_dot",
    "DistLevel",
    "DistHierarchy",
    "distribute_hierarchy",
    "dist_solve",
    "make_solve_mesh",
    "dist_build_hierarchy",
    "dist_build_sa_hierarchy",
]
