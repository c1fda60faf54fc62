"""Configuration dataclasses (SURVEY.md §5.6).

Frozen and hashable so configs can ride along as jit static arguments.  The
five acceptance configurations (BASELINE.json:6-12) ship as named presets.
"""

from __future__ import annotations

import dataclasses

__all__ = ["AmgConfig", "SolveConfig", "PRESETS"]


@dataclasses.dataclass(frozen=True)
class AmgConfig:
    """AMG hierarchy + cycle configuration.

    strength:  'classical' (signed, M-matrix oriented) | 'abs' (symmetric |a_ij|)
    splitting: 'rs' (host serial Ruge-Stüben) | 'pmis' | 'cljp' | 'aggregation'
    interp:    'direct' | 'classical' (modified classical)
               | 'extended' (distance-two ext+i — pair this with PMIS:
                 plain classical diverges off PMIS C/F sets at scale)
               | 'smoothed' (SA)
    smoother:  'jacobi' | 'mcgs' (multicolor/red-black Gauss-Seidel)
               | 'tsgs' (two-stage Gauss-Seidel: the triangular solve
                 replaced by gs_inner Jacobi iterations — PAPERS.md:9;
                 coloring-free, fully parallel; algebraic engine)
               | 'chebyshev' | 'cheb4' (fourth-kind Chebyshev)
               | 'block_jacobi' | 'block_cheb' (block-diag-preconditioned,
               SA/elasticity levels run through the BlockELL layout)
    """

    strength: str = "classical"
    theta: float = 0.25
    splitting: str = "pmis"
    interp: str = "direct"
    smoother: str = "jacobi"
    omega: float = 2.0 / 3.0
    nu1: int = 1
    nu2: int = 1
    cheb_degree: int = 3
    # two-stage GS only: inner Jacobi iterations approximating the
    # triangular solve (0 = plain unweighted Jacobi; more = closer to GS)
    gs_inner: int = 2
    max_levels: int = 20
    coarse_size: int = 64
    cycle: str = "V"
    seed: int = 0
    # smoothed aggregation only:
    num_candidates: int = 1
    sa_omega: float = 4.0 / 3.0
    # filtered SA (classic "filtered smoothed aggregation"): before the
    # prolongator-smoothing product D^{-1} A P_t, drop off-node entries
    # failing |a_ij| >= sa_filter*sqrt(|a_ii a_jj|) and lump them into the
    # diagonal (A_F keeps A's action on constants).  Cuts the smoothed P's
    # fill — and hence Galerkin coarse-operator complexity — on elasticity
    # where weak cross couplings otherwise smear every aggregate wide.
    # The Galerkin RAP itself stays on the UNFILTERED A.  0 disables.
    sa_filter: float = 0.0
    # interpolation truncation for the distance-two interps (hypre's
    # P_max_elmts): keep the p_max_elements largest-|w| entries per row,
    # rescaling +/- parts separately; 0 = no truncation.  Caps the Galerkin
    # coarse-operator fill that distance-two coarse sets otherwise produce.
    p_max_elements: int = 4
    # second coarsening pass / aggressive coarsening (config 3):
    aggressive: bool = False
    # Jacobi interpolation refinement (hypre's jacobi_interp): after the
    # multipass interpolation of an aggressive level, run this many sweeps
    # of P <- trunc_{p_max_elements}(P - omega_r * D_FF^{-1} A P).  The
    # distance-2 splitting's multipass rows are built from already-crude
    # neighbors; refinement recovers the quality (rotated anisotropic 96^2:
    # 63 -> 27 PCG iterations for 2 sweeps at +0.03 operator complexity).
    interp_refine: int = 0
    interp_refine_omega: float = 2.0 / 3.0
    # extra Jacobi refinement sweeps on fat device levels (A.K >
    # interp.EXT_DEVICE_MAX_K).  Those levels run ext+i on the strength-
    # compacted operator (interp.extended_interpolation_strong), which
    # already carries the distance-2 quality — sweeps on top are optional
    # polish (they were essential when fat levels fell back to DIRECT
    # interpolation; measured then: 14 -> 11 PCG iterations at 48^3).
    fat_interp_refine: int = 0
    # coarse-operator sparsification: drop |a_ij| < filter_tol * row max and
    # lump into the diagonal (PAPERS.md:6); 0 disables
    filter_tol: float = 0.0
    # storage dtype for level operators ('same' | 'bfloat16'): bf16 halves
    # operator HBM traffic; vectors/reductions stay in the solve dtype
    operator_store_dtype: str = "same"
    # structured engine: coarsen every dim at once (BoxMG staged
    # interpolation) when couplings are balanced — ~2x fewer levels and less
    # per-cycle work, at the cost of a much larger (one-time, cached) setup
    # compile; opt-in
    full_coarsening: bool = False
    # row padding multiple; the distributed path builds with 8*ndev so every
    # level's padded size divides the device count (SURVEY.md §2b C19)
    pad_multiple: int = 8
    # algebraic-setup latency policy: levels with n <= this threshold build
    # in vectorized host NumPy (setup/host_setup.py — same algorithms, same
    # integer PMIS weights, bit-identical splittings) instead of paying
    # device compile + sync latency per shrinking level; 0 forces every
    # level onto the device (full end-to-end-under-jit setup).  256k default
    # (chosen for the JAX package): each device level costs compiles and
    # host round trips; device levels win again when n is large enough to
    # amortize that.
    host_setup_threshold: int = 262144
    # geo-split coarsening on the banded path: when the input's nonzero
    # offsets factor as a lexicographic grid (api._detect_grid) AND the
    # unit-stride couplings are near-isotropic, levels coarsen by
    # alternating semicoarsening of the largest dim (the structured
    # engine's split) through the general interpolation machinery —
    # dim-restricted direct interp keeps every Galerkin operator <= 27-pt
    # and convergence structured-grade (9 vs 16 PCG iters at 128^3,
    # scripts/exp_alg_quality.py geo).  Falls back to PMIS per level when
    # detection fails; disable to force fully-algebraic coarsening.
    geo_split: bool = True
    # operator layout for the solve path ('ell' | 'banded'):
    # 'banded' RCM-reorders the input and re-lays each large level as a
    # BandedMatrix (core/hybrid.py) — the paged dynamic-gather Pallas
    # kernel, ~20x the gather ELL SpMV on non-grid matrices
    fine_layout: str = "ell"
    # dense coarse tail: the sub-cycle below the first level with
    # n <= tail_max_n is a LINEAR operator, so setup materializes it once
    # (vmap over identity columns) and the solve replaces that whole
    # recursion — hundreds of latency-bound tiny SpMVs — with ONE dense
    # MXU matvec (docs/DESIGN.md §4).  0 disables.  Memory: tail_max_n^2
    # operator entries (4096^2 fp32 = 64 MiB).
    tail_max_n: int = 4096


@dataclasses.dataclass(frozen=True)
class SolveConfig:
    krylov: str = "cg"  # 'cg' | 'bicgstab' | 'gmres' | 'fgmres' | 'none'
    tol: float = 1e-8
    maxiter: int = 200
    # GMRES/FGMRES restart length (Krylov basis size per cycle; memory is
    # restart * n for V plus the same for Z when flexible)
    gmres_restart: int = 30
    # mixed precision: inner solve dtype / outer iterative-refinement dtype
    dtype: str = "float32"
    refine: bool = False
    refine_steps: int = 3
    # on-device refinement (compensated-fp32 residuals, one jit) vs host fp64
    refine_device: bool = True


# The five acceptance configurations (BASELINE.json:7-11).
PRESETS: dict[str, AmgConfig] = {
    # 1: 2D 5-pt Poisson 64x64, classical RS-AMG V(1,1), weighted Jacobi, CG
    "config1": AmgConfig(splitting="rs", smoother="jacobi"),
    # 2: 3D 7-pt Poisson 32^3, PMIS + red-black GS, AMG-PCG.
    # extended+i interpolation (the standard PMIS companion — VERDICT r3
    # next #7): PMIS + direct sat at 17 iterations here while ext+i holds
    # 11-14 across 32-64^3 (same data as config 5's choice below).
    "config2": AmgConfig(splitting="pmis", smoother="mcgs",
                         interp="extended"),
    # 3: 2D rotated anisotropic 9-pt, strength filtering + aggressive
    # coarsening.  cheb4 instead of Jacobi (the spec pins the coarsening,
    # not the smoother; fourth-kind Chebyshev is the TPU-parallel smoother
    # this framework standardizes on): 104 -> 63 PCG iterations at 96^2.
    # filter_tol sparsifies the long-range multipass Galerkin products.
    # interp_refine=2 (Jacobi interpolation refinement of the multipass P,
    # VERDICT r3 next #3): 63 -> 27 iterations at 96^2, operator
    # complexity 1.088 -> 1.116 (measured sweep; w=2/3, p_max 6).
    "config3": AmgConfig(splitting="pmis", theta=0.35, aggressive=True,
                         smoother="cheb4", filter_tol=0.05,
                         interp_refine=2, p_max_elements=6),
    # 4: 3D elasticity 27-pt BSR, smoothed aggregation, block-diag-
    # preconditioned Chebyshev: the solve path runs through the BlockELL
    # layout (bell_spmv, batched 3x3 blocks on the MXU — BASELINE.json:5,10)
    # theta=0.08: the symmetric SA strength test at 0.16 leaves elasticity
    # aggregates ~2 nodes (the coarsening stalls into a one-level direct
    # solve); 0.08 yields ~30-node aggregates and a genuine multilevel cycle.
    # W-cycle: 17 -> 14 PCG iterations at n=22.8k, and with the dense MXU
    # coarse tail folding every level below tail_max_n the W's doubled
    # coarse visits fold into the SAME one matvec — W costs what V costs.
    # (sa_filter measured on this problem: complexity 1.18 -> 1.13 but
    # 17 -> 38 iterations — not worth it here; the knob stays available
    # for fill-heavy SA problems.)
    "config4": AmgConfig(splitting="aggregation", interp="smoothed",
                         smoother="block_cheb", num_candidates=6, theta=0.08,
                         cycle="W"),
    # 5: 3D Poisson 256^3 sharded: distributed hierarchy + halo exchange.
    # extended+i interpolation (the standard PMIS companion): PMIS + direct
    # degrades with size (17/21/26 PCG iterations at 32/48/64^3) while
    # ext+i holds nearly flat (11/12/14); the sharded setup builds it
    # under shard_map (parallel/dist_setup.py)
    "config5": AmgConfig(splitting="pmis", smoother="mcgs",
                         interp="extended"),
}
