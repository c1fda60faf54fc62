"""Algebraic setup: strength, splittings, interpolation, the hierarchy."""
from raptor_tpu_torch.setup.strength import strength_mask, strong_transpose_counts
from raptor_tpu_torch.setup.splitting import (
    pmis_splitting,
    rs_splitting_host,
    make_perm,
    C_PT,
    F_PT,
    UNDECIDED,
)
from raptor_tpu_torch.setup.cljp import cljp_splitting
from raptor_tpu_torch.setup.interp import (direct_interpolation,
                                           classical_interpolation,
                                           tighten_coarse_space)
from raptor_tpu_torch.setup.hierarchy import (
    Level,
    Hierarchy,
    build_hierarchy,
    hierarchy_stats,
)

__all__ = [
    "strength_mask",
    "strong_transpose_counts",
    "pmis_splitting",
    "rs_splitting_host",
    "make_perm",
    "C_PT",
    "F_PT",
    "UNDECIDED",
    "cljp_splitting",
    "direct_interpolation",
    "classical_interpolation",
    "tighten_coarse_space",
    "Level",
    "Hierarchy",
    "build_hierarchy",
    "hierarchy_stats",
]
