#!/usr/bin/env python3
"""Smoke run of raptor_tpu_torch on NVIDIA GPUs (Hopper, sm_90a): every
phase on one card, and phase 28 across every card where there are two or
more.

    python3 chip_smoke.py

Phases, each of which raises on failure (there is no CPU path):

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions; TF32 off, so the dense coarse solve stays full fp32;
2. build: nvcc compiles raptor_tpu_torch/csrc/*.cu into build/raptor_tpu_torch;
3. kernel equality: K1 and K2 against their plain PyTorch versions on the
   same CUDA tensors, at the shapes the main path gives them (each timed
   L2-warm and L2-cold; K2 also at 256^3), K7 (the df64 residual) bit for
   bit against its op-by-op plain version at the main path's 128^3 const
   fine level, at 512^3 const and on 256^3 fp32 planes (each timed L2-warm
   and L2-cold beside its plain version and its bound), and one small
   V-cycle on the card against the same cycle on the CPU;
4. main path: 3D 7-point Poisson at 128^3 -> build_structured_hierarchy
   (cheb4 degree 2, coarse_size 2048) -> cast_hierarchy(bf16) -> V-cycles
   -> structured_solve_refined, checked by a host fp64 residual;
5. proof: phase 4 launched K1, K2 and K7 and no K1v1 (the launches
   counted since just before it); the launches by shape (n, offsets,
   plane dtype);
6. banded kernel equality: the shuffled 48^3 algebraic hierarchy built on
   the host by raptor_tpu_torch.api.setup; K4 on every banded A (fp32, and
   bf16 on level 0), K6 on every banded P and R, K5 on level 0 without and
   with the fp32 truncation remainder of a pi-scaled operator, each against
   its plain version (and K5 against a host fp64 residual);
7. algebraic main path, shuffled 48^3 Poisson (the reference bench row):
   api.setup (PMIS, direct interpolation, RCM-banded layout, cheb4
   degree 2) -> V-cycles -> api.solve with the df64-refined PCG, checked by
   a host fp64 residual, the iteration count and the level sizes;
8. proof: phase 7 launched K4, K5 and K6, each at least once (the
   launches counted since just before phase 7, read just after it);
9. the same path at shuffled 96^3, levels 0-1 (above host_setup_threshold)
   built on the card by the device route (PMIS, direct interpolation,
   SpGEMM Galerkin products), checked to hold CUDA tensors just before the
   hierarchy is moved, peak device memory printed; the same proof on its
   own counts; then K4 on every banded level, K6 on every banded P and R
   and K5 on level 0 of the 96^3 hierarchy against their plain versions,
   each timed, every launch shape of the path among those compared; then
   the host route's build and refined-solve iterations beside the device
   route's;
9a. the algebraic engine's plane mode (the reference bench's alg128 row):
    natural-ordered 128^3 Poisson as scipy CSR with no grid information ->
    api.setup (PMIS, extended interpolation, fine_layout 'banded', cheb4
    degree 3, bf16 preconditioner; levels 0-2 from the device geo chain,
    checked to hold CUDA tensors), timed, each level's size, layout (hyb,
    band or ell) and geo transfer printed -> 10 bf16 V-cycles, timed, and
    torch.profiler over 10 more -> api.solve with the df64-refined PCG
    (certified through the DIA-plane compensated residual), cold then warm
    -> a host fp64 residual with the caller's matrix; checked: the
    reference's 16 level sizes 2**21 ... 2**6, at most 10 PCG iterations
    (the reference takes 9), true relres <= 1e-8;
9b. proof: phase 9a launched K1, at least once; K4, K5 and K6 however
    often (the launches counted since just before phase 9a, read just
    after it); the launches by shape;
9c. K1 on the DIA planes of every level of that hierarchy, fp32 and bf16,
    bit for bit against its plain version on the same CUDA tensors, each
    timed L2-warm and L2-cold beside its bound and cuSPARSE; the path's sum
    of launches x (L2-warm - bound);
9d. the host route of alg128: its refined-solve iterations beside the
    device route's, and the two hierarchies level by level (sizes and geo
    metas equal, A within 1e-5, P within 1e-6); the hierarchy is then
    freed;
9e. the device-setup row (bench.py:322-360): shuffled 96^3, PMIS +
    extended on the ELL layout, levels 0-1 on the card; built cold and
    warm, the two builds bit-equal in every A, P and R; seconds, rows/s,
    levels built on the card (2), peak device memory; the level count and
    refined-solve iterations equal to the host route's;
10. halo kernel equality: K3 against its plain version at the shapes the
    sharded path gives it (the 256^3 fine level with 65536-row halos, a
    15- and a 27-offset coarse level, the 4-rank 128^3 block, bf16
    planes), and K1v1 against its plain version on planes that are not
    boundary-zeroed;
11. the sharded config-5 path at full width on one rank over NCCL: 256^3
    7-point Poisson, fp32, mcgs, coarse_size 512 -> sdist_build_hierarchy
    -> sdist_solve(tol 1e-6), cold then warm, V-cycles; checked by a host
    fp64 residual and against the single-device solve on the same plan;
12. proof: phase 11 launched K3 and no K1v1 (the launches counted since
    just before phase 11, read just after it); the launches by shape;
13. four ranks sharing the card over gloo (host-staged messages) at 128^3:
    every rank launched K3, rank 0's gathered x is checked by a host fp64
    residual and its iterations against one rank at 128^3;
14. sharded-banded kernel equality: the shuffled 96^3 hierarchy built for
    four ranks (pad_multiple 4096, level sizes checked against the
    reference's); K4's halo form on rank 0's and the last rank's tiles of
    every sharded banded A, K6's map_cols form on theirs of every sharded
    banded P and R (level 2's R reads 17 pages right of a 13-page block),
    each bit for bit against its plain version and timed L2-warm and
    L2-cold beside cuSPARSE on the same local block and the bound;
15. the algebraic sharded solve on one rank over NCCL at shuffled 96^3, full
    width, on phase 9's hierarchy: distribute_hierarchy -> dist_solve (cg,
    tol 1e-6), cold then warm -> V-cycles; the route of every sharded
    level; x, put back into the caller's ordering, checked by a host fp64
    residual against the caller's matrix, the iterations against the
    single-device solve_hier on the same hierarchy; torch.profiler over 10
    of its V-cycles;
16. proof: phase 15 launched K4's halo form and no K6-map_cols (the
    launches counted since just before, read just after; at one rank no
    transfer shards, as in the reference);
17. four ranks sharing the card over gloo at shuffled 96^3: each rank runs
    dist_solve and dist_solve_taps (2 nodes x 2 chips) on its block; every
    rank must launch K4's halo form and K6's map_cols form; rank 0's
    gathered x passes the host fp64 check, its iterations are one rank's
    +- 1, and TAPS equals the flat solve on the ELL route exactly (its
    extended vectors are the flat ones'); comm_report's halo bytes and the
    messages per V-cycle of each exchange, from the host plans;
18. the acceptance rows at the reference bench's sizes and settings
    (bench.py:394-470): config1 poisson_2d(64), config2 poisson_3d(32),
    config3 anisotropic_2d(96), config4 elasticity_3d(48) (324,864 rows,
    host_setup_threshold 400000, its rigid body modes), config5
    poisson_3d(64), nonsym_gmres convection_diffusion_2d(128) with PMIS +
    Jacobi and refined GMRES; api.setup + api.solve (refined, tol 1e-8)
    with b = ones; n, level sizes, iterations, true fp64 relres, setup and
    solve seconds; checked: true relres <= 1e-8 and iterations <= the
    reference's count + 1 (CONFIG_ITERS, BENCH_r05.json "cfg"; config3
    against its fence, 32); each solve's K8 launches equal its BlockELL
    applies (bell.launches; both counted since just before the solve),
    more than 0 for config 4 and 0 for the other rows.  The operators and
    transfers use the ELL layout, as the reference's do, and launch no
    hand-written kernel; config 4's block smoother applies launch K8;
19. config 4's preset, unchanged, at 324,864 rows: the default threshold
    sends it through the device SA route, every level checked to hold CUDA
    tensors before Hierarchy.to, peak device memory printed; checked: every
    level size equal to the host route's built with the device route's
    lambda_max estimate (host_build_sa_hierarchy with gershgorin_rows
    math.inf: the host route takes the Gershgorin bound at >= 65536 rows, as
    the reference's does, its device route the power iteration; tests/
    test_torch_sa_routes.py shows the reference's two routes split so),
    levels 0-1 equal to phase 18's, the sizes equal to the regression pin
    CONFIG4_DEVICE_SIZES_PIN, iterations within 3 of phase 18's (the
    reference's fence, tests/unit/test_aggregation.py:124-151), K8's
    launches as in phase 18; then K8 on every BlockELL level of that
    hierarchy, the general form on the level's blocks and the diagonal form
    on its block inverses, bit for bit against their plain versions, each
    timed L2-warm and L2-cold beside the einsum route it replaced, its
    bound (live blocks, x and y) and cuSPARSE;
20. config 3's preset at full width, anisotropic_2d(768) (589,824 rows):
    level 0 aggressive on the card, the rest on the host; beside it the
    host route; checked: equal level sizes, iterations within 1 of each
    other, true relres <= 1e-8 on both;
21. the mcgs path at full width: shuffled 96^3 with config 5's preset and
    fine_layout 'banded', levels 0-1 built on the card and coloured on the
    host; colours per level, V-cycle ms and its profile; the refined solve
    (true <= 1e-8) on the launches counted since just before it: K4, K5
    and K6 each launched; the host route's
    iterations beside it; then dist_solve on one rank over NCCL with mcgs
    (+-1 of solve_hier on the same hierarchy) and with tsgs (printed beside
    the single-device tsgs count: its inner series is processor-local),
    tol 1e-6, true <= 1e-5, every sharded A apply launching K4's halo form;
    after the proofs, K4 (fp32, and bf16 on level 0), K6 and K5 on every
    banded operator of the hierarchy and K4's halo form on every tile shape
    of the one-rank solves, each against its plain version bit for bit,
    and every launch shape of the paths among those compared;
22. four ranks sharing the card over gloo at shuffled 48^3 with config 5's
    preset, fine_layout 'banded' and pad_multiple 4096 (host-built until
    parallel/dist_setup.py is ported): each rank runs dist_solve with mcgs
    and must launch K4's halo form, and K6's map_cols form where a transfer
    shards; rank 0's gathered x passes the host fp64 check, its iterations
    are the single-device solve_hier's on the same hierarchy +- 1; then
    K4's halo form and K6's map_cols form on rank 0's and the last rank's
    tiles of every operator the ranks shard, bit for bit, every launch
    shape of the four ranks among those compared.
    Phases 18-22 print their wall seconds;
23. CLJP: the H2 bit positions drawn on the card for 884,736 rows at
    rounds 0, 1 and 7 against the reference's sha256 digests; then shuffled
    CLJP_N^3 and 96^3 with CLJP (ALG_CFG, splitting "cljp") through api.setup
    and api.solve, every level built on the card (checked before
    Hierarchy.to), level 0's C/F set drawn again on the card and checked on
    the host (every F point with a strong influence has a C influence);
    V-cycles, the refined solve (true <= 1e-8) on the launches counted
    since just before it (K4, K5 and K6 each launched), then K4, K6 and
    K5 bit for bit at every launch shape of
    the path, and K4 at the widest banded level timed; at CLJP_N^3 the
    level sizes are the reference's and the iterations within 1 of its
    count (the reference has no count at 96^3);
24. full coarsening on the main path (CFG, dim_policy "size", bf16
    cast_hierarchy, structured_solve_refined) at 128^3 and 64^3, on the
    launches counted since just before each: the reference's plans, true
    relres <= 1e-8, at 64^3 the reference's iterations +- 1, K1, K2 and
    K7 each launched, then K1
    (fp32, bf16; 27 offsets), K2 and K7 bit for bit at every launch shape
    of the path; V-cycle ms and solve seconds beside phase 4's
    semicoarsening;
25. the user surface: ``python -m raptor_tpu_torch info`` in a subprocess
    (names the card); shuffled SURFACE_N^3 written as .rbm and .mtx.gz
    and read back equal; in process through cli.main: the banded CLJP solve of the
    .rbm (K4 launched, the written x passing the host fp64 check), bench
    config2, and bench config5 at 256^3 on one card (the single-device
    structured route, K2 on the fine level); phase 23's CLJP_N^3
    hierarchy saved with save_hierarchy, loaded on the card and solved again (the
    same iterations, x bit-equal);
26. the sharded algebraic setup (parallel/dist_setup.py): 26a shuffled
    DSETUP_N^3 (PMIS, direct, cheb4 degree 2, ELL) built by
    dist_build_hierarchy on one rank over NCCL, fp32 cold and warm (seconds,
    peak memory, every sharded tensor on the card), dist_solve (cg, tol
    1e-6, true fp64 <= 1e-5) within 1 iteration of the single-device build
    sharded by distribute_hierarchy on the same ring, the fp64 sizes equal
    to the single-device device route's (host_setup_threshold 0); 26b the
    same on DSETUP_RANKS ranks sharing the card over gloo (fp64 sizes equal
    to 26a's, iterations +-1); 26c ext+i at 96^3, CLJP at CLJP_N^3 and
    config 3's preset at 768^2, each on one rank with its fp64 sizes equal
    to the single-device device route's and a solve to true <= 1e-5.
    ``--dist-setup-only`` runs phases 1, 2 and 26 alone;
27. the sharded smoothed-aggregation setup (parallel/dist_sa.py) with
    config 4's preset: 27a elasticity_3d(DSA_N) (324,864 rows) built by
    dist_build_sa_hierarchy on one rank over NCCL, fp32 cold and warm
    (seconds, peak memory, every sharded tensor, binv included, on the
    card), its sharded sizes and real coarse size beside phase 19's (level
    0 and the first coarse size equal), dist_solve (cg, tol 1e-6;
    certified <= 1e-6, host fp64 true <= 1e-5) within DSA_FENCE iterations
    of the single-device device-route build sharded by distribute_hierarchy
    on the same ring; 27b elasticity_3d(DSA_N4) (95,232 rows, two sharded
    levels) on DSA_RANKS ranks sharing the card over gloo: sizes equal to
    one rank's, iterations +-1, each rank's seconds.  ``--dist-sa-only``
    runs phases 1, 2 and 27 alone;
28. the sharded engines on several cards, one NCCL rank a card (four
    where four cards are visible, else two; with one card it prints that
    it did not run), in one spawn: the ring's shifts (by +-1, +-2, 3 and
    the ring's size; 1-D, 2-D and empty), psum, pmax and all_gather in
    fp32, fp64, int64 and bf16, each equal to the gloo ring's result on the
    same inputs and to what the inputs give, and TAPS's node and chip rings
    with their global peer ranks; config 5 at SDIST_N^3 (every rank
    launches K3 and no K1v1, iterations phase 11's +-1, rank 0's
    gathered x true <= SDIST_MAX_TRUE); the algebraic sharded solve of
    shuffled ADIST_N^3 padded for the ranks, flat and TAPS on a (2, N / 2)
    grid (K4-halo and K6-map_cols on every rank, iterations the one-rank
    solve's on the same hierarchy and phase 15's +-1, TAPS equal to the
    flat solve), each rank's messages and words per V-cycle from the host
    plans; dist_build_hierarchy at DSETUP_N^3 (fp64 sizes equal to 26a's,
    iterations +-1) and dist_build_sa_hierarchy at elasticity_3d(DSA_N)
    (sizes equal to 27a's, iterations within DSA_FENCE); V-cycle ms per
    rank and rank 0's V-cycles under torch.profiler; then every launch
    shape of K3, K4-halo and K6-map_cols on every rank bit for bit against
    its plain version; and phase 25's ``bench --preset config5``, the
    CLI's multi-card branch, names the card count.  ``--multi-card-only``
    runs phases 1, 2 and 28 alone, with the one-rank runs it is held to.

Every kernel is timed by CUDA-graph replay beside its plain version (K4 and
K6 also at every shape of the 48^3 path, L2-warm and L2-cold, with the
variant K4's launch plan took, for the launches-by-shape ranking), one
cuSPARSE CSR matvec of the same operator (torch.mv; none for K5), and its
bound: the larger of its bytes over 3.35 TB/s and its operations over 67
TFLOP/s (H100 SXM, NVIDIA's data sheet).

The line before the last is the kernels' JSON record (K1, K1v1, K2, K3, K4,
K5, K6, the sharded forms K4-halo and K6-map_cols, K7, and K8 at phase
19's level 0, each with the launches of its own paths: K4, K5 and K6 those of the 48^3 row, of
phase 21's refined solve and of phase 23's two refined solves, K1, K2 and
K7 those of the 128^3 path and of phase 24's two paths, K4-halo those of
rank 0 of phase 17, of phase 21's two one-rank solves and of rank 0 of
phase 22, K6-map_cols those of rank 0 of phases 17 and 22; where phase 28
ran, rank 0's K3, K4-halo and K6-map_cols launches of it too; K8 those of
the config-4 solves of phases 18 and 19); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import itertools
import json
import math
import subprocess
import time
import warnings

import numpy as np
import scipy.sparse as sp
import torch

from port_common import (ALG128_CFG, ALG_CFG, ALG_MAX_ITERS, ALG_SIZES,
                         CONFIG3_FENCE, CONFIG4_DEVICE_SIZES_PIN, CONFIG_ITERS,
                         CONFIG_SIZES, HOST_ROUTE_THRESHOLD, N_PROFILED,
                         TOL_KERNEL, config_problem, config_settings, graph_ms,
                         poisson7_residual, profile_cycles, shuffled_poisson,
                         stencil_7pt, true_relres)

SIZE = 128
CFG = dict(smoother="cheb4", cheb_degree=2, coarse_size=2048, max_levels=40)
MAX_RELRES = 1e-8
MAX_ITERS = 8  # the JAX reference takes 7
N_CYCLES = 20
K5_TOL = 1e-12  # |rh + rl - r64| <= K5_TOL * max|A @ xh|
# sharded config 5 (raptor_tpu/cli.py:194-241): one rank at SDIST_N^3, four
# ranks sharing the card at SDIST_N4^3
SDIST_N, SDIST_N4, SDIST_RANKS = 256, 128, 4
SDIST_TOL = 1e-6  # the certified (recurrence) relres of the fp32 PCG
# the sharded solve has no df64 refinement: fp32 PCG to 1e-6 leaves a true
# fp64 relres a little above the recurrence's
SDIST_MAX_TRUE = 1e-5
# the algebraic sharded solve (raptor_tpu/parallel/dist.py): one rank at
# shuffled 96^3 on phase 9's hierarchy, four ranks sharing the card on one
# padded for them (1024 rows a tile, a whole number of tiles a rank); the
# same tolerances as the sharded config 5 (fp32 PCG, no df64 refinement)
ADIST_N, ADIST_RANKS, ADIST_TAIL = 96, 4, 4096
ADIST_PAD = 1024 * ADIST_RANKS
ADIST_TOL, ADIST_MAX_TRUE = SDIST_TOL, SDIST_MAX_TRUE
TAPS_GRID = (2, 2)  # (nodes, chips) of the four ranks
# the algebraic engine's plane mode (bench.py:228-320, the alg128 row):
# natural-ordered 128^3 Poisson in, no grid information; levels 0-2 (above
# the default host_setup_threshold) from the device geo chain
ALG128_N = 128
ALG128_SIZES = [2**k for k in range(21, 5, -1)]  # the reference's 16 levels
ALG128_MAX_ITERS = 10  # the reference takes 9
# the device-built geo hierarchy against the host-built one, as the CPU
# test (tests/test_torch_geo_device.py::test_geo_device_matches_host)
GEO_A_TOL, GEO_P_TOL = 1e-5, 1e-6
# the device-setup row (bench.py:322-360): shuffled 96^3, PMIS + extended
# on the ELL layout; levels 0-1 (884736 and 442368 rows) on the device
DEVSETUP_N = 96
DEVSETUP_CFG = dict(splitting="pmis", interp="extended")
DEVSETUP_DEVICE_LEVELS = 2
N_ALG128_CYCLES = 10
ALG128_GRAPH_CALLS = 20
# H100 SXM peaks (NVIDIA's data sheet): HBM3 bytes/s, fp32 outside the
# tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# fp32 operations per stored entry in banded_df64_kernel: two_prod 11 and
# df_add 14, and with vals_lo its term, 2 more (csrc/banded_kernel.cu)
K5_OPS_PER_ENTRY = {False: 25, True: 27}
# K7's fp32 operations an offset a row (sign flips and bitmask splits not
# counted): two_prod 11 (10 where the constant's split is made on the
# host), plane * xl added 2, df_add 14
K7_OPS_PER_OFFSET = {"const": 26, "planes": 27}
# config 3 at full width is anisotropic_2d(CONFIG3_FULL_N).  Phase 19's
# check that matters is against the host route built with the device
# route's lambda_max estimate, in the same run, not CONFIG4_DEVICE_SIZES_PIN
CONFIG3_FULL_N = 768
# phase 22: the four-rank mcgs solve's shuffled grid
MCGS4_N = 48
# phase 23: CLJP (ALG_CFG with splitting "cljp"): all levels built on the
# card.  The reference's CLJP build compiles one program a level on the
# CPU (32^3: 453 s; 48^3: 43 minutes, and its solve past 25 GB of host
# memory), so the sizes and iterations pinned are its CLJP_N^3 ones; 96^3
# runs too, checked by its own relres and kernels
CLJP_CFG = dict(ALG_CFG, splitting="cljp")
CLJP_N, CLJP_N_WIDE = 32, 96
# the reference's level sizes and refined-solve iterations at shuffled
# CLJP_N^3 (raptor_tpu.api.setup and solve on the CPU)
CLJP_SIZES = [32768, 16384, 7645, 3395, 1781, 925, 498, 278, 152, 74, 34]
CLJP_ITERS = 6
# sha256 of the reference's CLJP bit positions, jax.random.randint(
# fold_in(PRNGKey(17), it), (884736,), 0, 31, int32), as little-endian int32
CLJP_BITS_N = 884736
CLJP_BITS_SHA256 = {
    0: "b124b7e9351d278161922fc5253705ad9aa8d9404fccd9461f76305d511b703d",
    1: "cad12691254f4be11a9b4ac8c372ee9d109086428ed92cb332b8edd925aec833",
    7: "e9bce0771c893a1695ebb7b5d9bc74e9cd7531849f71ee7ed2c8ae1006a02885"}
# phase 24: full coarsening on the main path (CFG, dim_policy "size");
# the reference's plan_coarsening at 128^3 and 64^3 (host arithmetic) and
# its refined-solve iterations at 64^3 (its 128^3 solve is not run on the
# CPU); 128^3 is checked by its plan, relres and kernels
FC_CFG = dict(CFG, full_coarsening=True)
FC_PLANS = {128: (-2, -2, -2, -2), 64: (-2, -2, -2)}
FC_ITERS = 7  # at 64^3
FC_ITERS_N = 64
# phase 25: the CLI and I/O on shuffled SURFACE_N^3; files go under the
# checkout's build/
SURFACE_N = 48
SMOKE_DIR = "build/chip_smoke"
# phase 26: the sharded algebraic setup at shuffled DSETUP_N^3 (the size of
# phases 9 and 15) with the reference bench row's smoother on the ELL
# layout, on one rank over NCCL and on DSETUP_RANKS ranks sharing the card
# over gloo; the sharded solve's tolerances (fp32 PCG, no refinement)
DSETUP_N, DSETUP_RANKS, DSETUP_TAIL = 96, 4, 4096
DSETUP_CFG = dict(splitting="pmis", interp="direct", smoother="cheb4",
                  cheb_degree=2)
DSETUP_TOL, DSETUP_MAX_TRUE = SDIST_TOL, SDIST_MAX_TRUE
# phase 27: the sharded smoothed-aggregation setup with config 4's preset:
# elasticity_3d(DSA_N) (the bench's size, 324,864 rows) on one rank over
# NCCL, and elasticity_3d(DSA_N4) (95,232 rows, two sharded levels above
# the tail) on DSA_RANKS ranks sharing the card over gloo; the sharded
# solve's tolerances; iterations within DSA_FENCE of the single-device
# hierarchy sharded by distribute_hierarchy (the reference's own fence,
# tests/distributed/test_dist_algebraic_setup.py:432)
DSA_N, DSA_N4, DSA_RANKS = 48, 32, 4
DSA_FENCE = 2
# phase 28: the sharded engines at the sizes above on several cards, one
# NCCL rank a card; the ring's collectives in the dtypes the engines send
MC_DTYPES = (torch.float32, torch.float64, torch.int64, torch.bfloat16)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``ops`` fp32 operations."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def dia_csr(data: torch.Tensor, lins, n_cols: int, shift: int = 0):
    """The nonzeros of a DIA operator as a float32 CSR tensor on its device:
    row i holds data[k, i] at column i + lin_k + shift, where that column
    lies in [0, n_cols)."""
    n = data.shape[1]
    dev = data.device
    cols = (torch.arange(n, device=dev)[:, None]
            + torch.tensor([int(o) + shift for o in lins], device=dev)[None, :])
    vals = data.t().float()
    keep = (cols >= 0) & (cols < n_cols) & (vals != 0)
    crow = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    crow[1:] = keep.sum(1).cumsum(0)
    return torch.sparse_csr_tensor(crow, cols[keep].int(), vals[keep],
                                   size=(n, n_cols), check_invariants=False)


def host_csr(a: sp.spmatrix, shape, dev):
    """A scipy matrix as a float32 CSR tensor of ``shape`` on ``dev``."""
    a = sp.csr_matrix(a, dtype=np.float32)
    a.sort_indices()
    indptr = np.concatenate([a.indptr, np.full(shape[0] - a.shape[0],
                                               a.indptr[-1])])
    return torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int32)),
        torch.from_numpy(a.indices.astype(np.int32)),
        torch.from_numpy(a.data), size=shape, check_invariants=False).to(dev)


def yardsticks(r: dict, A_csr, x, nbytes: int, ops=None) -> None:
    """Record the library time (one torch.mv of ``A_csr``, cuSPARSE) and the
    bound of a kernel; ``ops`` defaults to 2 per nonzero."""
    r["library_ms"] = graph_ms(lambda: torch.mv(A_csr, x))
    r["bound_ms"], r["bound_by"] = bound(
        nbytes, 2 * A_csr._nnz() if ops is None else ops)


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: "
                           "this smoke runs only on an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    print(smi.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def phase_build() -> None:
    from raptor_tpu_torch.ops.cuda.build import build, load_library

    path, seconds = build()
    print(f"[build] {path.name}: {seconds:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if any(w in line for w in ("Function properties", "registers", "spill")):
            print(f"[build] {line.strip()}")
    load_library()


def _random_planes(dims, offsets, dtype, rng, device):
    from raptor_tpu_torch.structured.dia import boundary_mask

    n = int(np.prod(dims))
    data = rng.standard_normal((len(offsets), n)).astype(np.float32)
    for k, o in enumerate(offsets):
        data[k] *= boundary_mask(dims, o)
    return torch.from_numpy(data).to(device=device, dtype=dtype)


def _lins(dims, offsets):
    from raptor_tpu_torch.structured.dia import _linear

    return [_linear(o, dims) for o in offsets]


def _check(name, y, y_ref) -> float:
    torch.cuda.synchronize()
    if y.shape != y_ref.shape or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: bad output {tuple(y.shape)}")
    err = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    print(f"[kernel] {name}: max_abs_err {err:.3e} (max|y_ref| {scale:.3e})")
    if not err <= TOL_KERNEL * scale:
        raise AssertionError(f"{name}: {err} > {TOL_KERNEL} * {scale}")
    return err


def phase_kernels(dev) -> dict:
    from raptor_tpu_torch.ops.cuda.dia_kernel import (
        const_tile_plan, dia_spmv_const, dia_spmv_const_ref, dia_spmv_v2,
        dia_spmv_v2_ref)

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.default_rng(0)
    st = stencil_7pt()
    fine = (SIZE,) * 3
    lev1, lev2 = (SIZE // 2, SIZE, SIZE), (SIZE // 2, SIZE // 2, SIZE)
    cube = list(itertools.product((-1, 0, 1), repeat=3))
    off7 = [o for o in cube if sum(map(abs, o)) <= 1]
    off15 = [o for o in cube if abs(o[1]) + abs(o[2]) <= 1]
    pt_off = [(-1, 0, 0), (0, 0, 0), (1, 0, 0)]
    consts = [float(st[tuple(np.add(o, 1))]) for o in off7]
    rec = {"K1": {"err": 0.0}, "K2": {"err": 0.0}}

    def vec(n, batch=None):
        shape = (n,) if batch is None else (batch, n)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    from raptor_tpu_torch.structured.dia import dia_from_stencil

    # K2: the const fine level, a batched small grid, and 256^3 (134 MB of
    # x and y: outside the L2)
    for dims, batch in ((fine, None), ((16, 16, 16), 4), ((2 * SIZE,) * 3, None)):
        x = vec(int(np.prod(dims)), batch)
        y = dia_spmv_const(consts, off7, dims, x)
        y_ref = dia_spmv_const_ref(consts, off7, dims, x)
        name = f"K2 {dims} 7 offsets" + (f" batch {batch}" if batch else "")
        rec["K2"]["err"] = max(rec["K2"]["err"], _check(name, y, y_ref))
        del y, y_ref
        if batch is not None:
            continue
        warm = graph_ms(lambda: dia_spmv_const(consts, off7, dims, x))
        cold = graph_ms(lambda: dia_spmv_const(consts, off7, dims, x),
                       flush_l2=True)
        plan = const_tile_plan(off7, dims, 1, n_sm)
        print(f"[kernel] {name}: {warm * 1e3:.1f} us L2-warm, {cold * 1e3:.1f} "
              f"us L2-cold, bound {bound(8 * x.numel(), 0)[0] * 1e3:.1f} us "
              f"({plan.rows} rows a thread, tiles of {plan.tile}; device "
              f"time, graph replay)")
        if dims == fine:
            rec["K2"]["ms"], rec["K2"]["cold_ms"] = warm, cold
            rec["K2"]["plain_ms"] = graph_ms(
                lambda: dia_spmv_const_ref(consts, off7, dims, x))
            rec["K2"]["cold_plain_ms"] = graph_ms(
                lambda: dia_spmv_const_ref(consts, off7, dims, x), flush_l2=True)
            Af = dia_from_stencil(st, dims, device=dev)
            yardsticks(rec["K2"], dia_csr(Af.data, Af.linear_offsets(), Af.n),
                       x, 8 * Af.n)
            del Af
        else:
            rec["K2"]["ms_256"], rec["K2"]["cold_ms_256"] = warm, cold
        del x

    # K1: level 1 (bf16, fp32), level 2 (bf16), a fine-level Pt, a batch
    cases = [("level 1", lev1, off15, torch.bfloat16, None),
             ("level 1", lev1, off15, torch.float32, None),
             ("level 2", lev2, cube, torch.bfloat16, None),
             ("Pt", fine, pt_off, torch.bfloat16, None),
             ("level 2 small", (16, 16, 32), cube, torch.float32, 4)]
    for label, dims, offs, dtype, batch in cases:
        data = _random_planes(dims, offs, dtype, rng, dev)
        lins = _lins(dims, offs)
        x = vec(int(np.prod(dims)), batch)
        y = dia_spmv_v2(data, lins, x)
        name = (f"K1 {label} {dims} {len(offs)} offsets {dtype}"
                + (f" batch {batch}" if batch else ""))
        rec["K1"]["err"] = max(rec["K1"]["err"],
                               _check(name, y, dia_spmv_v2_ref(data, lins, x)))
        warm = graph_ms(lambda: dia_spmv_v2(data, lins, x))
        cold = graph_ms(lambda: dia_spmv_v2(data, lins, x), flush_l2=True)
        moved = data.numel() * data.element_size() + 8 * x.numel()
        print(f"[kernel] {name}: {warm * 1e3:.1f} us L2-warm, {cold * 1e3:.1f} "
              f"us L2-cold, bound {bound(moved, 0)[0] * 1e3:.1f} us (device "
              f"time, graph replay)")
        if label == "level 1" and dtype == torch.bfloat16:
            rec["K1"]["ms"], rec["K1"]["cold_ms"] = warm, cold
            rec["K1"]["plain_ms"] = graph_ms(lambda: dia_spmv_v2_ref(data, lins, x))
            rec["K1"]["cold_plain_ms"] = graph_ms(
                lambda: dia_spmv_v2_ref(data, lins, x), flush_l2=True)
            yardsticks(rec["K1"], dia_csr(data, lins, data.shape[1]), x, moved)
    # bytes the call must move: planes (bf16) + x + y for K1 on level 1,
    # x + y for K2 on the fine level
    moved = {"K1": len(off15) * int(np.prod(lev1)) * 2 + 8 * int(np.prod(lev1)),
             "K2": 8 * int(np.prod(fine))}
    for k in ("K1", "K2"):
        r = rec[k]
        cold = ("" if "cold_ms" not in r else
                f"; L2-cold {r['cold_ms'] * 1e3:.1f} us kernel "
                f"({moved[k] / r['cold_ms'] / 1e9:.3f} TB/s), "
                f"{r['cold_plain_ms'] * 1e3:.1f} us plain")
        print(f"[kernel] {k}: {r['ms'] * 1e3:.1f} us kernel "
              f"({moved[k] / r['ms'] / 1e9:.3f} TB/s), "
              f"{r['plain_ms'] * 1e3:.1f} us plain, "
              f"{r['library_ms'] * 1e3:.1f} us cuSPARSE CSR, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}) "
              f"(device time, graph replay, L2-warm){cold}")

    # K7: the main path's 128^3 const fine level (the kernels line's
    # numbers), 512^3 const (the structured cells' fine level) and 256^3
    # fp32 planes, each timed beside its op-by-op plain version
    from raptor_tpu_torch.structured.dia import DiaMatrix

    gen = torch.Generator(device=dev).manual_seed(7)
    rec["K7"] = {"err": 0.0, "library_ms": None,  # no one PyTorch call
                 "shapes": {}}
    for form, dims in (("const", fine), ("const", (4 * SIZE,) * 3),
                       ("planes", (2 * SIZE,) * 3)):
        A = (dia_from_stencil(st, dims, device=dev) if form == "const" else
             DiaMatrix(data=_random_planes(dims, off7, torch.float32, rng,
                                           dev),
                       offsets=tuple(off7), dims=dims))
        r = _k7_case(f"K7 {form} {dims} 7 offsets", A, gen, plain=True)
        rec["K7"]["err"] = max(rec["K7"]["err"], r.pop("err"))
        rec["K7"]["shapes"][f"{form} {dims}"] = r
        if dims == fine:
            rec["K7"].update(r)
        del A
        torch.cuda.empty_cache()
    return rec


def _k7_vectors(n: int, gen) -> tuple:
    """(xh, xl, bh, bl): random fp32 heads on the card, each tail under
    half an ulp of its head."""
    dev = gen.device
    xh = torch.randn(n, generator=gen, device=dev)
    bh = 30 * torch.randn(n, generator=gen, device=dev)
    tails = [v * 2.0**-25 * (2 * torch.rand(n, generator=gen, device=dev) - 1)
             for v in (xh, bh)]
    return xh, tails[0], bh, tails[1]


def _k7_case(name: str, A, gen, plain: bool = False) -> dict:
    """K7 (``dia_df64_residual`` on CUDA tensors) on operator ``A`` against
    its op-by-op plain version on the same tensors, bit for bit, then timed
    L2-warm and L2-cold beside its bound: xh, xl, bh, bl in and rh, rl out
    (24 B a row), plus the fp32 planes in the planes form.  ``plain`` times
    the plain version too."""
    from raptor_tpu_torch.structured.dia import (dia_df64_residual,
                                                 dia_df64_residual_ref)

    form = "planes" if A.const_planes is None else "const"
    args = (A, *_k7_vectors(A.n, gen))
    got, want = dia_df64_residual(*args), dia_df64_residual_ref(*args)
    err = max(_equal(f"{name} rh", got[0], want[0]),
              _equal(f"{name} rl", got[1], want[1]))
    del got, want
    nbytes = 24 * A.n + (0 if form == "const" else 4 * A.n_off * A.n)
    bms, by = bound(nbytes, K7_OPS_PER_OFFSET[form] * A.n_off * A.n)
    r = {"err": err, "bytes": nbytes, "bound_ms": bms, "bound_by": by,
         "ms": graph_ms(lambda: dia_df64_residual(*args)),
         "cold_ms": graph_ms(lambda: dia_df64_residual(*args), flush_l2=True)}
    if plain:
        r["plain_ms"] = graph_ms(lambda: dia_df64_residual_ref(*args), reps=5)
        r["cold_plain_ms"] = graph_ms(lambda: dia_df64_residual_ref(*args),
                                     reps=5, flush_l2=True)
    print(f"[kernel] {name}: {r['ms'] * 1e3:.1f} us L2-warm, "
          f"{r['cold_ms'] * 1e3:.1f} us L2-cold, bound {bms * 1e3:.1f} us "
          f"({by}, {nbytes / A.n:g} B a row)"
          + (f", plain {r['plain_ms'] * 1e3:.1f} us L2-warm, "
             f"{r['cold_plain_ms'] * 1e3:.1f} us L2-cold" if plain else "")
          + " (device time, graph replay)")
    return r


# the kernels of each wrapper module, for the reads that keep to one
DIA_KERNELS = ("K1", "K1v1", "K2", "K3", "K7")
BANDED_KERNELS = ("K4", "K4-halo", "K5", "K6", "K6-map_cols")


def counts() -> tuple:
    """A snapshot of the kernels' launch counters (``ops/cuda/launch.py``)
    for ``since``: a path's launches are read as the difference, so no
    counter is ever reset."""
    from raptor_tpu_torch.ops.cuda import launch

    return (collections.Counter(launch.launches),
            collections.Counter(launch.launches_by_shape))


def since(snap: tuple, kernels=None) -> tuple:
    """(launches by kernel, launches by shape) counted since ``snap``, of
    ``kernels`` only where given."""
    from raptor_tpu_torch.ops.cuda import launch

    got, shapes = launch.launches - snap[0], launch.launches_by_shape - snap[1]
    if kernels is not None:
        got = collections.Counter({k: c for k, c in got.items()
                                   if k in kernels})
        shapes = collections.Counter({k: c for k, c in shapes.items()
                                      if k[0] in kernels})
    return got, shapes


def per_call(counter, before, calls: int) -> dict:
    """Launches by shape counted since ``before`` was copied, per call."""
    return {key: (c - before[key]) / calls for key, c in counter.items()
            if c != before[key]}


def by_shape(tag: str, counter, kernels) -> list:
    """Print and return the launches of ``kernels`` by shape, as the
    wrappers counted them: [kernel, n, offsets or slots, dtype, launches]."""
    rows = sorted([*key, c] for key, c in counter.items() if key[0] in kernels)
    for k, n, width, dtype, c in rows:
        print(f"[shapes] {tag}: {k} n={n} width={width} {dtype}: {c:g} launches")
    return rows


def phase_small_cycle(dev) -> None:
    """One bf16 V-cycle at 16^3 on the card against the same hierarchy's
    cycle on the CPU (plain versions)."""
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle)

    dims = (16, 16, 16)
    A = dia_from_stencil(stencil_7pt(), dims, device=dev)
    h = cast_hierarchy(build_structured_hierarchy(
        A, AmgConfig(**{**CFG, "coarse_size": 64}), dim_policy="size"),
        torch.bfloat16)
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(A.n)
                         .astype(np.float32))
    y = scycle(h, b.to(dev)).cpu()
    y_ref = scycle(h.to("cpu"), b)
    err = float((y - y_ref).abs().max())
    print(f"[cycle] 16^3 bf16 V-cycle, card vs CPU: max_abs_err {err:.3e}")
    if not err <= 1e-5 * float(y_ref.abs().max()):
        raise AssertionError(f"small V-cycle disagrees: {err}")


def phase_main(dev) -> dict:
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle,
                                  structured_solve_refined)
    from raptor_tpu_torch.gallery import default_rhs, stencil_grid

    st = stencil_7pt()
    dims = (SIZE,) * 3
    n = SIZE ** 3
    cfg = AmgConfig(**CFG)
    A = dia_from_stencil(st, dims, device=dev)
    torch.cuda.synchronize()

    def setup():
        t0 = time.perf_counter()
        h = build_structured_hierarchy(A, cfg, dim_policy="size")
        torch.cuda.synchronize()
        return h, time.perf_counter() - t0

    h, cold = setup()
    h, warm = setup()
    print(f"[main] setup {warm:.3f} s warm, {cold:.3f} s cold, "
          f"{len(h.levels)} levels")
    for lv in h.levels:
        print(f"[main]   dims {lv.dims} n_off {lv.A.n_off} cdim {lv.cdim}")
    plan = tuple(lv.cdim for lv in h.levels[:-1])
    if plan != (0, 1, 2, 0, 1, 2, 0, 1, 2, 0) or h.coarse_inv.shape != (2048, 2048):
        raise AssertionError(f"unexpected hierarchy: plan {plan}, "
                             f"coarse_inv {tuple(h.coarse_inv.shape)}")
    hM = cast_hierarchy(h, torch.bfloat16)
    b = torch.from_numpy(default_rhs(n, dtype=np.float32)).to(dev)

    def vcycle_ms(hier):
        y = scycle(hier, b)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CYCLES):
            y = scycle(hier, b)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise AssertionError("V-cycle output not finite")
        return (time.perf_counter() - t0) / N_CYCLES * 1e3

    from raptor_tpu_torch.ops.cuda.launch import launches_by_shape

    before = collections.Counter(launches_by_shape)
    vc_bf16 = vcycle_ms(hM)
    per_cycle = per_call(launches_by_shape, before, N_CYCLES + 1)
    vc_fp32 = vcycle_ms(h)
    print(f"[main] V-cycle bf16 {vc_bf16:.3f} ms ({n / vc_bf16 * 1e3:.4g} DOF/s), "
          f"fp32 {vc_fp32:.3f} ms ({n / vc_fp32 * 1e3:.4g} DOF/s), "
          f"{N_CYCLES} cycles between syncs")

    def solve():
        t0 = time.perf_counter()
        out = structured_solve_refined(h, b, tol=MAX_RELRES, M_hier=hM)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    solve()  # warm
    ((xh, xl), rel, iters), sol = solve()
    x64 = xh.double().cpu().numpy() + xl.double().cpu().numpy()
    b64 = b.double().cpu().numpy()
    relres = float(np.linalg.norm(b64 - stencil_grid(st, dims) @ x64)
                   / np.linalg.norm(b64))
    print(f"[main] refined solve {sol:.3f} s, {int(iters)} PCG iterations, "
          f"certified {float(rel):.3e}, true fp64 relres {relres:.3e}")
    if x64.shape != (n,) or not np.isfinite(x64).all():
        raise AssertionError("solution not finite or misshapen")
    if not relres <= MAX_RELRES or not int(iters) <= MAX_ITERS:
        raise AssertionError(f"relres {relres} (max {MAX_RELRES}), "
                             f"iterations {int(iters)} (max {MAX_ITERS})")
    by_shape("main 128^3, one bf16 V-cycle", per_cycle, ("K1", "K2"))
    return {"setup_warm_s": warm, "setup_cold_s": cold, "vcycle_bf16_ms": vc_bf16,
            "vcycle_bf16_launches_by_shape": sorted(
                [*key, c] for key, c in per_cycle.items()),
            "vcycle_fp32_ms": vc_fp32, "solve_s": sol, "iters": int(iters),
            "relres": relres}


# ---------------------------------------------------------------------------
# algebraic engine: RCM-banded layouts, kernels K4, K5, K6
# ---------------------------------------------------------------------------

def _banded_bytes(plan: dict, itemsize: int) -> int:
    """Bytes a K4/K6 call must move: vals + pidx of the live slots (the
    others are never read), x (or the transfer's x span) and y."""
    from raptor_tpu_torch.ops.cuda.banded_kernel import live_slots

    n = plan["n"]
    return (len(live_slots(plan)) * n * (itemsize + 4) + 4 * n
            + 4 * plan.get("n_cols", n))


def _banded_line(dev, name: str, plan: dict, call) -> tuple:
    """Time ``call`` (K4, K6 or a sharded form on ``plan``) L2-warm and
    L2-cold and print the line of that shape with its bound and the variant
    its launch plan took; returns (warm, cold, bound) in ms."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    lp = bk.banded_launch_plan(
        plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    live = len(bk.live_slots(plan))
    warm = graph_ms(call)
    cold = graph_ms(call, flush_l2=True)
    bms = bound(_banded_bytes(plan, plan["vals"].element_size()),
                2 * live * plan["n"])[0]
    variant = (f"staged, {lp.pages} of {bk._window_pages(plan)} pages, "
               f"{lp.smem_bytes} B" if lp.staged else "direct")
    rows = f"{lp.rows} rows a thread" + (", 32 apart" if lp.stride == 32 else "")
    print(f"[banded] {name} n={plan['n']} live {live}: {warm * 1e3:.1f} us "
          f"L2-warm, {cold * 1e3:.1f} us L2-cold, bound {bms * 1e3:.1f} us; "
          f"{variant}, {rows}, {lp.threads} threads a block (device time, "
          f"graph replay)")
    return warm, cold, bms


def _equal(name: str, y, y_ref) -> float:
    """_check's tolerance, and then bit for bit."""
    err = _check(name, y, y_ref)
    if not torch.equal(y, y_ref):
        raise AssertionError(f"{name}: not bit-equal to its plain version")
    return err


def _print_levels(tag: str, h) -> None:
    for i, lv in enumerate(h.levels):
        a = lv.Aband
        lay = ("ELL" if a is None else
               f"banded K,n,tile,kh,npage,Wp={a.meta} reordered={a.reordered} "
               f"far={a.far is not None}")
        tr = "".join(f" {nm}(K,n,n_cols,tile,WpP,npage)={b.meta}"
                     for nm, b in (("P", lv.Pband), ("R", lv.Rband)) if b is not None)
        print(f"[{tag}]   L{i} n {lv.n} n_pad {lv.A.n_rows_pad} K {lv.A.K} {lay}{tr}")
    if h.tail_op is not None:
        print(f"[{tag}]   dense tail from L{h.tail_start}: {tuple(h.tail_op.shape)}")


def _k5_case(dev, h, A, rng) -> tuple:
    """K5 on level 0 of ``h`` against its plain version (bit for bit) and a
    host fp64 residual, timed L2-warm and L2-cold beside its bound; returns
    (max_abs_err vs plain, the call, its plain version and its numbers)."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    band, lo = h.levels[0].Aband, h.a0_lo_band
    plan = band.plan()
    n, n_pad = A.shape[0], band.n_pad
    pm = h.perm[:n].cpu().numpy()
    Ar = A[pm][:, pm].tocsr()

    def pad(a):
        out = np.zeros(n_pad, np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(dev)

    xh64 = rng.standard_normal(n).astype(np.float32).astype(np.float64)
    b64 = rng.standard_normal(n)
    bh = b64.astype(np.float32)
    v = (rng.standard_normal(n) * 1e-6).astype(np.float32)
    args = (pad(xh64), pad(bh), pad(b64 - bh), pad(v))
    rh, rl = bk.banded_df64_residual(plan, lo, *args)
    rh_ref, rl_ref = bk.banded_df64_residual_ref(plan, lo, *args)
    label = (f"K5 {round(n ** (1 / 3))}^3 L0 "
             f"{'with' if lo is not None else 'without'} vals_lo")
    err = max(_equal(f"{label} rh", rh, rh_ref), _equal(f"{label} rl", rl, rl_ref))
    got = rh.double().cpu().numpy() + rl.double().cpu().numpy()
    ax = Ar @ xh64
    e64 = float(np.abs(got[:n] - (b64 - v - ax)).max())
    scale = float(np.abs(ax).max())
    print(f"[banded] {label}: |rh + rl - r64| {e64:.3e} (max|A xh| {scale:.3e})")
    if not e64 <= K5_TOL * scale:
        raise AssertionError(f"{label}: {e64} > {K5_TOL} * {scale} against fp64")
    call = lambda: bk.banded_df64_residual(plan, lo, *args)  # noqa: E731
    # the live slots' values (and remainders) and offsets; xh, bh, bl, v
    # in, rh, rl out
    live = len(bk.live_slots(plan))
    nbytes = live * plan["n"] * (8 if lo is None else 12) + 24 * plan["n"]
    bms, by = bound(nbytes, K5_OPS_PER_ENTRY[lo is not None] * A.nnz)
    warm, cold = graph_ms(call), graph_ms(call, flush_l2=True)
    lp = bk.banded_launch_plan(
        plan, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"[banded] {label} n={plan['n']} live {live}: {warm * 1e3:.1f} us "
          f"L2-warm, {cold * 1e3:.1f} us L2-cold, bound {bms * 1e3:.1f} us "
          f"({by}); {'staged' if lp.staged else 'direct'}, {lp.threads} "
          f"threads a block (device time, graph replay)")
    return err, dict(call=call, ref=lambda: bk.banded_df64_residual_ref(
        plan, lo, *args), ms=warm, cold_ms=cold, bytes=nbytes, bound_ms=bms,
        bound_by=by, shape=(plan["n"], plan["K"]))


def phase_banded_kernels(dev, h, h_pi, A_pi) -> dict:
    """K4, K6 and K5 against their plain versions, bit for bit, at every
    shape the 48^3 path gives them; each shape timed L2-warm and L2-cold
    beside its bound (``shapes_48``: (n, K) -> (warm, cold, bound) ms)."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic

    rng = np.random.default_rng(2)
    rec = {k: {"err": 0.0, "shapes_48": {}} for k in ("K4", "K5", "K6")}

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    hb = cast_hierarchy_algebraic(h, torch.bfloat16)
    cases = [(f"L{i} A", lv.Aband, torch.float32)
             for i, lv in enumerate(h.levels) if lv.Aband is not None]
    cases.append(("L0 A", hb.levels[0].Aband, torch.bfloat16))
    cases += [(f"L{i} {nm}", b, torch.float32) for i, lv in enumerate(h.levels)
              for nm, b in (("P", lv.Pband), ("R", lv.Rband)) if b is not None]
    if len(cases) != 10:
        raise AssertionError(f"expected 4 K4 and 6 K6 shapes, got {len(cases)}")
    timed = {}
    for label, band, dtype in cases:
        plan = band.plan()
        square = "n_cols" not in plan
        k = "K4" if square else "K6"
        fn, ref = ((bk.banded_spmv, bk.banded_spmv_ref) if square
                   else (bk.banded_spmv_rect, bk.banded_spmv_rect_ref))
        x = vec(plan["n"] if square else plan["n_cols"])
        name = f"{k} 48^3 {label} K {plan['K']} {dtype}"
        rec[k]["err"] = max(rec[k]["err"], _equal(name, fn(plan, x), ref(plan, x)))
        line = _banded_line(dev, name, plan, lambda: fn(plan, x))
        if dtype == torch.float32:
            rec[k]["shapes_48"][(plan["n"], plan["K"])] = line
        if (label, dtype) in (("L0 A", torch.float32), ("L0 R", torch.float32)):
            timed[k] = (plan, fn, ref, x, line)
    from raptor_tpu_torch.core.ell import ell_to_csr

    lv0 = h.levels[0]
    pm = lv0.Aband.perm[:lv0.A.n_rows].cpu().numpy()
    a0 = ell_to_csr(lv0.A)
    same_op = {"K4": a0[pm][:, pm], "K6": ell_to_csr(lv0.R)}
    for k, (plan, fn, ref, x, (warm, cold, _)) in timed.items():
        rec[k]["ms"], rec[k]["cold_ms"] = warm, cold
        rec[k]["plain_ms"] = graph_ms(lambda: ref(plan, x))
        rec[k]["cold_plain_ms"] = graph_ms(lambda: ref(plan, x), flush_l2=True)
        rec[k]["bytes"] = _banded_bytes(plan, 4)
        shape = (plan["n"], x.shape[0])
        yardsticks(rec[k], host_csr(same_op[k], shape, dev), x, rec[k]["bytes"])
    errs, k5 = [], None
    for hh, AA in ((h, shuffled_poisson(48)), (h_pi, A_pi)):
        err, k5 = _k5_case(dev, hh, AA, rng)
        errs.append(err)
        if hh.a0_lo_band is None:  # the form the 48^3 path runs
            rec["K5"]["shapes_48"][k5["shape"]] = (k5["ms"], k5["cold_ms"],
                                                   k5["bound_ms"])
    if h_pi.a0_lo_band is None or h.a0_lo_band is not None:
        raise AssertionError("the pi-scaled operator must carry a0_lo_band")
    # the kernels line carries K5 with vals_lo, the heavier of its forms
    rec["K5"].update(err=max(errs), plain_ms=graph_ms(k5["ref"]),
                     cold_plain_ms=graph_ms(k5["ref"], flush_l2=True),
                     library_ms=None,  # no one PyTorch call computes it
                     **{key: k5[key] for key in ("ms", "cold_ms", "bytes",
                                                 "bound_ms", "bound_by")})
    for k, what in (("K4", "L0 A"), ("K6", "L0 R"), ("K5", "L0, with vals_lo")):
        r = rec[k]
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms'] * 1e3:.1f} us")
        print(f"[banded] {k} 48^3 {what}: {r['ms'] * 1e3:.1f} us kernel "
              f"({r['bytes'] / r['ms'] / 1e9:.3f} TB/s), "
              f"{r['plain_ms'] * 1e3:.1f} us plain, {lib} cuSPARSE CSR "
              f"(device time, graph replay, L2-warm); L2-cold "
              f"{r['cold_ms'] * 1e3:.1f} us kernel "
              f"({r['bytes'] / r['cold_ms'] / 1e9:.3f} TB/s), "
              f"{r['cold_plain_ms'] * 1e3:.1f} us plain; bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    return rec


@contextlib.contextmanager
def device_route(tag: str, threshold: int, out: dict):
    """Around one api.setup: just before Hierarchy.to moves the built
    hierarchy to the card, check that every level above ``threshold``
    holds CUDA tensors (a device route that built on the CPU would be moved
    there without a trace), and record in ``out`` the number of such
    levels, the peak device memory of the setup and where its seconds
    went: ``before_tail_s`` (ordering, ELL conversion and the device
    levels, up to the host tail), ``host_tail_s``, ``layouts_s`` (the
    layout plans after the tail) and ``upload_s`` (Hierarchy.to, the
    folded tail and the rest of api.setup)."""
    from raptor_tpu_torch.setup.hierarchy import Hierarchy

    # the package's setup function shadows its setup subpackage
    hs = importlib.import_module("raptor_tpu_torch.setup.host_setup")

    to, tail = Hierarchy.to, hs.host_build_tail
    marks = {}

    def timed_tail(*args, **kwargs):
        torch.cuda.synchronize()
        marks["tail_in"] = time.perf_counter()
        try:
            return tail(*args, **kwargs)
        finally:
            marks["tail_out"] = time.perf_counter()

    def checked(self, device):
        torch.cuda.synchronize()
        marks["to"] = time.perf_counter()
        n_dev = 0
        for i, lv in enumerate(self.levels):
            if lv.n <= threshold:
                continue
            leaves = [lv.A.data, lv.A.cols, lv.A.row_nnz, lv.dinv]
            for E in (lv.P, lv.R):
                if E is not None:
                    leaves += [E.data, E.cols, E.row_nnz]
            if lv.Ahyb is not None:
                leaves.append(lv.Ahyb.planes)
            if lv.Tgeo is not None:
                leaves += [lv.Tgeo.wm, lv.Tgeo.wp]
            if lv.Abell is not None:
                leaves += [lv.Abell.data, lv.Abell.cols, lv.binv]
            if lv.color is not None:
                leaves.append(lv.color)
            if not all(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in leaves):
                raise AssertionError(f"[{tag}] level {i} (n={lv.n}) is above "
                                     "the host threshold but was not built "
                                     "on the card")
            n_dev += 1
        out["device_levels"] = n_dev
        return to(self, device)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    Hierarchy.to, hs.host_build_tail = checked, timed_tail
    t0 = time.perf_counter()
    try:
        yield
        torch.cuda.synchronize()
    finally:
        Hierarchy.to, hs.host_build_tail = to, tail
    end = time.perf_counter()
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    tail_in = marks.get("tail_in", marks["to"])
    tail_out = marks.get("tail_out", marks["to"])
    out.update(before_tail_s=tail_in - t0, host_tail_s=tail_out - tail_in,
               layouts_s=marks["to"] - tail_out, upload_s=end - marks["to"])


SETUP_PARTS = ("before_tail_s", "host_tail_s", "layouts_s", "upload_s")


def timed_setup(tag: str, A, cfg, dev, B=None, every_level: bool = False) -> tuple:
    """api.setup on the card under ``device_route``: (hierarchy, record
    with seconds, levels built on the device and peak memory).  ``B``: the
    near-nullspace candidates of a smoothed-aggregation setup;
    ``every_level``: check every level, not only those above the host
    threshold (the device SA route builds them all)."""
    from raptor_tpu_torch import setup

    rec = {}
    t0 = time.perf_counter()
    with device_route(tag, -1 if every_level else cfg.host_setup_threshold,
                      rec):
        h = setup(A, cfg, B=B, device=dev)
    rec["s"] = time.perf_counter() - t0
    print(f"[{tag}] setup {rec['s']:.3f} s: {rec['before_tail_s']:.3f} s "
          f"ordering, ELL conversion and the {rec['device_levels']} levels "
          f"built on the card; {rec['host_tail_s']:.3f} s host tail; "
          f"{rec['layouts_s']:.3f} s layout plans; {rec['upload_s']:.3f} s "
          f"upload, folded tail and the rest; peak device memory "
          f"{rec['peak_mem_gib']:.3f} GiB")
    return h, rec


def host_route(tag: str, A, cfg, dev, sizes: list, iters: int) -> tuple:
    """The same input and configuration with every level built on the
    host (HOST_ROUTE_THRESHOLD): (record of setup seconds, sizes and
    refined-solve iterations, printed beside the device route's; the
    host-built hierarchy)."""
    from raptor_tpu_torch import SolveConfig, solve

    hcfg = dataclasses.replace(cfg, host_setup_threshold=HOST_ROUTE_THRESHOLD)
    hh, rec = timed_setup(f"{tag} host route", A, hcfg, dev)
    host_s = rec["s"]
    b = np.ones(A.shape[0])
    x, info = solve(A, b, hcfg, SolveConfig(tol=MAX_RELRES, refine=True),
                    hier=hh)
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    out = {"setup_s": host_s, "setup_parts": {k: rec[k] for k in SETUP_PARTS},
           "sizes": [lv.n for lv in hh.levels],
           "iters": int(info["iterations"]), "relres": relres}
    print(f"[{tag}] host route (every level on the host): setup {host_s:.3f} "
          f"s, sizes {out['sizes']}, {out['iters']} PCG iterations, true "
          f"relres {relres:.3e}; device route: sizes {sizes}, {iters} "
          "iterations")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"host route: true relres {relres} > {MAX_RELRES}")
    return out, hh


def phase_algebraic(dev, nx: int, cold_and_warm: bool) -> tuple:
    """The algebraic engine's banded path on shuffled nx^3 Poisson, through
    raptor_tpu_torch.api.setup and api.solve as the reference bench calls
    them, checked against a host fp64 residual; the levels above the host
    threshold are built on the card."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.api import solve_hier_refined
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.solve.cycle import cycle

    tag = f"alg{nx}"
    A = shuffled_poisson(nx)
    n = A.shape[0]
    cfg = AmgConfig(**ALG_CFG)

    h, rec = timed_setup(tag, A, cfg, dev)
    out = {"n": n, "setup_cold_s": rec["s"], "device_levels": rec["device_levels"],
           "setup_peak_mem_gib": rec["peak_mem_gib"]}
    msg = f"[{tag}] setup {rec['s']:.3f} s cold"
    if cold_and_warm:
        h, rec = timed_setup(tag, A, cfg, dev)
        out["setup_warm_s"] = rec["s"]
        msg += f", {rec['s']:.3f} s warm"
    out["setup_parts"] = {k: rec[k] for k in SETUP_PARTS}
    sizes = [lv.n for lv in h.levels]
    print(f"{msg}, {len(sizes)} levels, sizes {sizes}; {rec['device_levels']} "
          f"levels built on the card (host_setup_threshold "
          f"{cfg.host_setup_threshold}), peak device memory "
          f"{rec['peak_mem_gib']:.3f} GiB")
    _print_levels(tag, h)
    if sizes != ALG_SIZES[nx]:
        raise AssertionError(f"level sizes {sizes}, the reference's {ALG_SIZES[nx]}")
    if h.levels[0].Aband is None or h.levels[0].Rband is None:
        raise AssertionError("level 0 has no banded layout")

    b = np.ones(n)
    bd = pad_vector(b.astype(np.float32), h.levels[0].A.n_rows_pad, device=dev)
    y = cycle(h, bd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        y = cycle(h, bd)
    torch.cuda.synchronize()
    vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
    if not torch.isfinite(y).all():
        raise AssertionError("V-cycle output not finite")

    sc = SolveConfig(tol=MAX_RELRES, refine=True)
    solve(A, b, cfg, sc, hier=h)  # warm
    t0 = time.perf_counter()
    x, info = solve(A, b, cfg, sc, hier=h)
    sol = time.perf_counter() - t0
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))

    pm = h.perm[:n].cpu().numpy()
    bp = b[pm]
    n_pad = h.levels[0].A.n_rows_pad
    bh = pad_vector(bp.astype(np.float32), n_pad, device=dev)
    bl = pad_vector((bp - bp.astype(np.float32).astype(np.float64))
                    .astype(np.float32), n_pad, device=dev)
    reps = 5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dev_out = solve_hier_refined(h, bh, tol=MAX_RELRES,
                                     maxiter=sc.maxiter, b_lo=bl)
    torch.cuda.synchronize()
    sol_dev = (time.perf_counter() - t0) / reps
    iters = int(info["iterations"])
    print(f"[{tag}] V-cycle {vc:.3f} ms ({n / vc * 1e3:.4g} DOF/s, "
          f"{N_CYCLES} cycles between syncs); api.solve {sol:.3f} s warm, "
          f"solve_hier_refined {sol_dev:.3f} s (device, mean of {reps}); "
          f"{iters} PCG iterations, certified {info['relres']:.3e}, "
          f"true fp64 relres {relres:.3e}")
    if x.shape != (n,) or not np.isfinite(x).all():
        raise AssertionError("solution not finite or misshapen")
    if int(dev_out[2]) != iters:
        raise AssertionError(f"solve_hier_refined took {int(dev_out[2])} "
                             f"iterations, api.solve {iters}")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"true relres {relres} > {MAX_RELRES}")
    limit = ALG_MAX_ITERS.get(nx)
    if limit is not None and not iters <= limit:
        raise AssertionError(f"{iters} iterations (max {limit})")
    out.update(vcycle_ms=vc, solve_s=sol, solve_device_s=sol_dev,
               iters=iters, certified=float(info["relres"]), relres=relres,
               sizes=sizes)
    return out, h


def banded_proof(tag: str, snap: tuple) -> tuple:
    """Read the banded launches of the path driven since ``snap``: K4, K5
    and K6 must each have launched.  Returns (launches by kernel, launches
    by shape)."""
    bl, shapes = since(snap, BANDED_KERNELS)
    kernels = ("K4", "K6", "K5")
    print(f"[proof] {tag} path: " + ", ".join(
        f"{k} {bl[k]} launches" for k in kernels))
    if any(bl[k] == 0 for k in kernels):
        raise AssertionError(f"the {tag} path did not run through the kernels")
    rows = by_shape(tag, shapes, kernels)
    return {k: bl[k] for k in kernels}, rows


def banded_excess(tag: str, rec: dict, rows: list, key: str) -> dict:
    """Sigma over a path's fp32 shapes (``rows`` of banded_proof) of
    launches x (L2-warm time - bound), per kernel, from the per-shape times
    in rec[kernel][key]; a shape with no time is counted apart."""
    out = {}
    for k in ("K4", "K5", "K6"):
        timed = rec[k].get(key, {})
        total, untimed = 0.0, 0
        for kern, n, K, dtype, c in rows:
            if kern != k:
                continue
            if dtype != "float32" or (n, K) not in timed:
                untimed += c
                continue
            warm, _, b = timed[(n, K)]
            total += c * (warm - b)
        out[k] = total
        print(f"[banded] {tag}: {k} sum over the path's shapes of launches x "
              f"(L2-warm - bound) {total:.4f} ms ({untimed} launches at "
              f"shapes not timed)")
    return out


def phase_banded_shapes(dev, tag: str, h, A, rec, rows: list, key: str) -> None:
    """K4 on every banded level, K6 on every P and R and K5 on level 0 of
    ``h`` (the hierarchy of ``A``) against their plain versions, bit for
    bit (after the path's proof, so these launches stay out of its
    counts); each shape timed (rec[kernel][key]), K4's level 0 also with
    bf16 values.  Every (kernel, n, K, dtype) the path launched (``rows``
    of banded_proof) must be among the compared shapes."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    rng = np.random.default_rng(4)
    compared = set()

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)

    for k in ("K4", "K5", "K6"):
        rec[k][key] = {}
    for i, lv in enumerate(h.levels):
        if lv.Aband is None:
            continue
        a = lv.Aband.plan()
        plans = [(a, "torch.float32")]
        if i == 0:
            plans.append((dict(a, vals=a["vals"].bfloat16()), "torch.bfloat16"))
        for plan, dtype in plans:
            x = vec(plan["n"])
            name = (f"K4 {tag} L{i} A K {plan['K']} kh {plan['kh']} npage "
                    f"{plan['npage']} {dtype}")
            rec["K4"]["err"] = max(rec["K4"]["err"], _equal(
                name, bk.banded_spmv(plan, x), bk.banded_spmv_ref(plan, x)))
            compared.add(("K4", plan["n"], plan["K"], dtype.removeprefix("torch.")))
            line = _banded_line(dev, name, plan, lambda: bk.banded_spmv(plan, x))
            if dtype == "torch.float32":
                rec["K4"][key][(plan["n"], plan["K"])] = line
            if i == 0 and dtype == "torch.float32" and key == "shapes_96":
                plain = graph_ms(lambda: bk.banded_spmv_ref(plan, x))
                print(f"[banded] K4 96^3 L0 A: {line[0] * 1e3:.1f} us kernel "
                      f"({_banded_bytes(plan, 4) / line[0] / 1e9:.3f} TB/s), "
                      f"{plain * 1e3:.1f} us plain (device time, graph replay)")
                rec["K4"]["ms_96"], rec["K4"]["plain_ms_96"] = line[0], plain
    for i, lv in enumerate(h.levels):
        for nm, band in (("P", lv.Pband), ("R", lv.Rband)):
            if band is None:
                continue
            r = band.plan()
            xr = vec(r["n_cols"])
            name = f"K6 {tag} L{i} {nm} K {r['K']} npage {r['npage']}"
            rec["K6"]["err"] = max(rec["K6"]["err"], _equal(
                name, bk.banded_spmv_rect(r, xr), bk.banded_spmv_rect_ref(r, xr)))
            compared.add(("K6", r["n"], r["K"], "float32"))
            rec["K6"][key][(r["n"], r["K"])] = _banded_line(
                dev, name, r, lambda: bk.banded_spmv_rect(r, xr))
    err, k5 = _k5_case(dev, h, A, rng)
    rec["K5"]["err"] = max(rec["K5"]["err"], err)
    rec["K5"][key][k5["shape"]] = (k5["ms"], k5["cold_ms"], k5["bound_ms"])
    compared.add(("K5", *k5["shape"], "float32"))
    covered(tag, rows, compared)


def covered(tag: str, rows: list, compared: set) -> None:
    """Raise unless every (kernel, n, K, dtype) of a path's launches by
    shape (``rows``) was held against its plain version."""
    missed = [r[:4] for r in rows if tuple(r[:4]) not in compared]
    print(f"[kernel] {tag}: {len(rows) - len(missed)} of the path's {len(rows)} "
          f"launch shapes compared bit for bit")
    if missed:
        raise AssertionError(f"{tag}: launch shapes never compared: {missed}")


# ---------------------------------------------------------------------------
# the algebraic engine's plane mode: natural-ordered 128^3 (alg128)
# ---------------------------------------------------------------------------

def _layout(lv) -> str:
    return ("hyb" if lv.Ahyb is not None else
            "band" if lv.Aband is not None else "ell")


def phase_alg128(dev) -> tuple:
    """Phase 9a: natural-ordered 128^3 Poisson as scipy CSR with no grid
    information through api.setup and api.solve in plane mode (the
    reference bench's alg128 row); levels 0-2 from the geo chain on the
    card, the rest on the host."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.api import solve_hier_refined
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import poisson_3d
    from raptor_tpu_torch.setup.hierarchy import cast_hierarchy_algebraic
    from raptor_tpu_torch.solve.cycle import cycle

    A = sp.csr_matrix(poisson_3d(ALG128_N))
    n = A.shape[0]
    cfg = AmgConfig(**ALG128_CFG)
    h, rec = timed_setup("alg128", A, cfg, dev)
    setup_s = rec["s"]
    sizes = [lv.n for lv in h.levels]
    layouts = [_layout(lv) for lv in h.levels]
    print(f"[alg128] setup {setup_s:.3f} s, {len(sizes)} levels, "
          f"{rec['device_levels']} built on the card by the geo chain "
          f"(host_setup_threshold {cfg.host_setup_threshold}), peak device "
          f"memory {rec['peak_mem_gib']:.3f} GiB")
    for i, lv in enumerate(h.levels):
        hy = lv.Ahyb
        lay = layouts[i] + ("" if hy is None else
                            f" {len(hy.offsets)} offsets, reach "
                            f"{max(abs(o) for o in hy.offsets)}, spill "
                            f"{hy.spill is not None}")
        geo = "" if lv.Tgeo is None else f" Tgeo (H,m,mc,s,n,n_pad,nc_pad)={lv.Tgeo.meta}"
        print(f"[alg128]   L{i} n {lv.n} n_pad {lv.A.n_rows_pad} K {lv.A.K} "
              f"{lay}{geo}")
    if h.tail_op is not None:
        print(f"[alg128]   dense tail from L{h.tail_start}: {tuple(h.tail_op.shape)}")
    if sizes != ALG128_SIZES:
        raise AssertionError(f"level sizes {sizes}, the reference's {ALG128_SIZES}")
    if h.levels[0].Ahyb is None or h.levels[0].Tgeo is None:
        raise AssertionError("level 0 has no DIA planes or no geo transfer")

    hM = cast_hierarchy_algebraic(h, torch.bfloat16)
    bd = pad_vector(np.ones(n, np.float32), h.levels[0].A.n_rows_pad, device=dev)
    y = cycle(hM, bd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_ALG128_CYCLES):
        y = cycle(hM, bd)
    torch.cuda.synchronize()
    vc = (time.perf_counter() - t0) / N_ALG128_CYCLES * 1e3
    if not torch.isfinite(y).all():
        raise AssertionError("V-cycle output not finite")
    prof = profile_cycles(lambda: cycle(hM, bd), N_ALG128_CYCLES, top=8)
    print(f"[alg128] bf16 V-cycle {vc:.3f} ms ({n / vc * 1e3:.4g} DOF/s, "
          f"{N_ALG128_CYCLES} cycles between syncs); profiled: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms "
          f"({prof['busy_share']:.1%}), {prof['device_events']:g} device "
          f"events a cycle")
    for name, us, c in prof["top"]:
        print(f"[alg128]   {us:9.1f} us, {c:g} events a cycle: {name}")

    b = np.ones(n)
    sc = SolveConfig(tol=MAX_RELRES, refine=True)
    t0 = time.perf_counter()
    solve(A, b, cfg, sc, hier=h)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, info = solve(A, b, cfg, sc, hier=h)
    warm = time.perf_counter() - t0
    prof_solve = profile_cycles(lambda: solve(A, b, cfg, sc, hier=h), 1)
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    iters = int(info["iterations"])
    # the solve on the device alone: api.solve also permutes the caller's
    # matrix on the host (identity here) and casts the preconditioner
    bl = torch.zeros_like(bd)
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        dev_out = solve_hier_refined(h, bd, tol=MAX_RELRES, maxiter=sc.maxiter,
                                     b_lo=bl, M_hier=hM)
    torch.cuda.synchronize()
    sol_dev = (time.perf_counter() - t0) / reps
    if int(dev_out[2]) != iters:
        raise AssertionError(f"solve_hier_refined took {int(dev_out[2])} "
                             f"iterations, api.solve {iters}")
    print(f"[alg128] api.solve {cold:.3f} s cold, {warm:.3f} s warm; {iters} "
          f"PCG iterations, certified {info['relres']:.3e}, true fp64 relres "
          f"{relres:.3e}; solve_hier_refined {sol_dev:.3f} s (device, mean of "
          f"{reps}); profiled api.solve: wall {prof_solve['wall_ms']:.1f} ms, "
          f"device busy {prof_solve['busy_ms']:.3f} ms "
          f"({prof_solve['busy_share']:.1%}), {prof_solve['device_events']:g} "
          f"device events")
    if x.shape != (n,) or not np.isfinite(x).all():
        raise AssertionError("solution not finite or misshapen")
    if not iters <= ALG128_MAX_ITERS:
        raise AssertionError(f"{iters} iterations (max {ALG128_MAX_ITERS})")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"true relres {relres} > {MAX_RELRES}")
    return {"n": n, "setup_s": setup_s, "device_levels": rec["device_levels"],
            "setup_parts": {k: rec[k] for k in SETUP_PARTS},
            "setup_peak_mem_gib": rec["peak_mem_gib"], "sizes": sizes,
            "layouts": layouts,
            "geo_levels": sum(lv.Tgeo is not None for lv in h.levels),
            "vcycle_ms": vc, "dof_per_s": n / vc * 1e3, "profile": prof,
            "solve_cold_s": cold, "solve_warm_s": warm,
            "solve_device_s": sol_dev, "solve_profile": prof_solve, "iters": iters,
            "certified": float(info["relres"]), "relres": relres}, h


def phase_alg128_host(dev, h, iters: int) -> dict:
    """Phase 9d: the host route of alg128 (its refined-solve iterations
    printed beside the device route's), and the device-built hierarchy
    (phase 9a) against the host-built one, level by level: sizes and geo
    metas equal, A within GEO_A_TOL and P within GEO_P_TOL (max abs), as
    the CPU test holds them."""
    from raptor_tpu_torch import AmgConfig
    from raptor_tpu_torch.core.ell import ell_to_csr
    from raptor_tpu_torch.gallery import poisson_3d

    A = sp.csr_matrix(poisson_3d(ALG128_N))
    out, hh = host_route("alg128", A, AmgConfig(**ALG128_CFG), dev,
                         [lv.n for lv in h.levels], iters)
    if [lv.n for lv in hh.levels] != [lv.n for lv in h.levels]:
        raise AssertionError("alg128: the host and device routes' level sizes differ")
    a_err = p_err = 0.0
    for i, (d, o) in enumerate(zip(h.levels, hh.levels)):
        if (d.Tgeo is None) != (o.Tgeo is None) or (
                d.Tgeo is not None and d.Tgeo.meta != o.Tgeo.meta):
            raise AssertionError(f"alg128 L{i}: the geo transfers differ")
        a_err = max(a_err, abs(ell_to_csr(d.A) - ell_to_csr(o.A)).max())
        if d.P is not None:
            p_err = max(p_err, abs(ell_to_csr(d.P) - ell_to_csr(o.P)).max())
    print(f"[alg128] device route against host route: max |A_dev - "
          f"A_host| {a_err:.3e} (limit "
          f"{GEO_A_TOL:g}), max |P_dev - P_host| {p_err:.3e} (limit "
          f"{GEO_P_TOL:g}) over {len(h.levels)} levels")
    if not (a_err <= GEO_A_TOL and p_err <= GEO_P_TOL):
        raise AssertionError("alg128: the device-built hierarchy differs from "
                             "the host-built one")
    out.update(a_err=float(a_err), p_err=float(p_err))
    return out


def phase_devsetup(dev) -> dict:
    """Phase 9e, the reference bench's device-setup row (bench.py:322-360):
    shuffled 96^3 with PMIS + extended on the ELL layout; levels 0-1 are
    built on the card.  Built cold and warm, the two builds bit-equal in
    every A, P and R; seconds, rows/s, levels built on the card and peak
    memory; its level count and refined-solve iterations equal to the
    host route's on the same input."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve

    A = shuffled_poisson(DEVSETUP_N)
    n = A.shape[0]
    cfg = AmgConfig(**DEVSETUP_CFG)
    h0, cold = timed_setup("devsetup", A, cfg, dev)
    h, warm = timed_setup("devsetup", A, cfg, dev)
    for i, (a, b) in enumerate(zip(h0.levels, h.levels)):
        for f in ("A", "P", "R"):
            ea, eb = getattr(a, f), getattr(b, f)
            same = (ea is None) == (eb is None) and (ea is None or all(
                torch.equal(getattr(ea, k), getattr(eb, k))
                for k in ("data", "cols", "row_nnz")))
            if not same:
                raise AssertionError(f"devsetup: two device builds differ in L{i} {f}")
    if len(h0.levels) != len(h.levels):
        raise AssertionError("devsetup: two device builds differ in depth")
    del h0
    sizes = [lv.n for lv in h.levels]
    b = np.ones(n)
    x, info = solve(A, b, cfg, SolveConfig(tol=MAX_RELRES, refine=True), hier=h)
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    iters = int(info["iterations"])
    print(f"[devsetup] n={n}: setup {cold['s']:.3f} s cold, {warm['s']:.3f} s "
          f"warm ({n / warm['s']:.4g} rows/s warm), {warm['device_levels']} of "
          f"{len(sizes)} levels built on the card, peak device memory "
          f"{cold['peak_mem_gib']:.3f} GiB cold, {warm['peak_mem_gib']:.3f} warm; "
          f"the two device builds bit-equal; sizes {sizes}; {iters} PCG "
          f"iterations, true relres {relres:.3e}")
    del h
    torch.cuda.empty_cache()
    host, hh = host_route("devsetup", A, cfg, dev, sizes, iters)
    del hh
    if warm["device_levels"] != DEVSETUP_DEVICE_LEVELS:
        raise AssertionError(f"devsetup: {warm['device_levels']} levels built "
                             f"on the card, expected {DEVSETUP_DEVICE_LEVELS}")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"devsetup: true relres {relres} > {MAX_RELRES}")
    if len(host["sizes"]) != len(sizes) or host["iters"] != iters:
        raise AssertionError(f"devsetup: {len(sizes)} levels and {iters} "
                             f"iterations, the host route {len(host['sizes'])} "
                             f"and {host['iters']}")
    return {"n": n, "setup_cold_s": cold["s"], "setup_warm_s": warm["s"],
            "setup_rows_per_s": n / warm["s"],
            "device_levels": warm["device_levels"], "levels": len(sizes),
            "setup_parts": {k: warm[k] for k in SETUP_PARTS},
            "sizes": sizes, "peak_mem_gib": max(cold["peak_mem_gib"],
                                                warm["peak_mem_gib"]),
            "iters": iters, "relres": relres, "host_route": host}


def alg128_proof(snap: tuple) -> tuple:
    """Phase 9b: read the launches of the alg128 path driven since
    ``snap``: K1 at least once; K4, K5 and K6 however many (none is
    expected: no level falls back to the banded layout)."""
    got, shapes = since(snap)
    k1 = got["K1"]
    banded = ("K4", "K6", "K5")
    others = {k: got[k] for k in ("K1v1", "K2", "K3")}
    print(f"[proof] alg128 path: K1 {k1} launches, " + ", ".join(
        f"{k} {got[k]} launches" for k in (*banded, *others)))
    if k1 == 0:
        raise AssertionError("the alg128 path did not run through K1")
    rows = (by_shape("alg128", shapes, ("K1",))
            + by_shape("alg128", shapes, banded))
    return {"K1": k1, **{k: got[k] for k in banded}, **others}, rows


def phase_hybrid_kernels(dev, h, rec, rows) -> None:
    """Phase 9c: K1 on the DIA planes of every level of the 128^3 plane-mode
    hierarchy, fp32 and as the bf16 cast stores them, bit for bit against
    dia_spmv_v2_ref on the same CUDA tensors (after the proof, so these
    launches stay out of its counts); each timed L2-warm and L2-cold beside
    its bound and one cuSPARSE torch.mv of the same operator; then the
    path's sum of launches x (L2-warm - bound) from its launches by shape.
    L2-warm is read from graphs of ALG128_GRAPH_CALLS calls (a single-call
    replay of a level of <= 2**16 rows times the graph launch, 6-14 us on
    the H100) and from single-call replays, as phase 3 times."""
    from raptor_tpu_torch.ops.cuda.dia_kernel import dia_spmv_v2, dia_spmv_v2_ref

    gen = torch.Generator(device=dev).manual_seed(7)
    shapes = rec["K1"]["shapes_alg128"] = {}
    for i, lv in enumerate(h.levels):
        if lv.Ahyb is None:
            continue
        offs = lv.Ahyb.offsets
        for dtype in (torch.float32, torch.bfloat16):
            planes = lv.Ahyb.planes.to(dtype).contiguous()
            n_off, n = planes.shape
            x = torch.randn(n, generator=gen, device=dev)
            dt = str(dtype).removeprefix("torch.")
            name = f"K1 alg128 L{i} n {n} {n_off} offsets {dt}"
            rec["K1"]["err"] = max(rec["K1"]["err"], _equal(
                name, dia_spmv_v2(planes, offs, x), dia_spmv_v2_ref(planes, offs, x)))
            warm1 = graph_ms(lambda: dia_spmv_v2(planes, offs, x))
            warm = graph_ms(lambda: [dia_spmv_v2(planes, offs, x)
                                    for _ in range(ALG128_GRAPH_CALLS)]
                           ) / ALG128_GRAPH_CALLS
            cold = graph_ms(lambda: dia_spmv_v2(planes, offs, x), flush_l2=True)
            plain = graph_ms(lambda: dia_spmv_v2_ref(planes, offs, x))
            r = {}
            yardsticks(r, dia_csr(planes, offs, n), x,
                       planes.numel() * planes.element_size() + 8 * n,
                       ops=2 * n_off * n)
            shapes[(n, n_off, dt)] = (warm, cold, r["bound_ms"], plain,
                                      r["library_ms"], warm1)
            print(f"[kernel] {name}: {warm * 1e3:.2f} us L2-warm "
                  f"({ALG128_GRAPH_CALLS} calls a graph; one call a graph "
                  f"{warm1 * 1e3:.1f}), {cold * 1e3:.1f} us L2-cold, bound "
                  f"{r['bound_ms'] * 1e3:.2f} "
                  f"us ({r['bound_by']}), plain {plain * 1e3:.1f} us, cuSPARSE "
                  f"CSR {r['library_ms'] * 1e3:.1f} us (device time, graph replay)")
            del planes, x
    total, untimed = 0.0, 0
    for kern, n, n_off, dt, c in rows:
        if kern != "K1":
            continue
        if (n, n_off, dt) not in shapes:
            untimed += c
            continue
        warm, _, b = shapes[(n, n_off, dt)][:3]
        total += c * (warm - b)
    print(f"[kernel] alg128: K1 sum over the path's shapes of launches x "
          f"(L2-warm - bound) {total:.4f} ms ({untimed} launches at shapes "
          "not timed)")
    rec["K1"]["excess_alg128_ms"] = total


# ---------------------------------------------------------------------------
# the plane-sharded structured engine: K3 (and K1v1)
# ---------------------------------------------------------------------------

def _device_planes(dims, offsets, dtype, gen, dev, zeroed=True):
    """Random planes on the card; boundary-zeroed unless ``zeroed`` is
    False."""
    from raptor_tpu_torch.ops.cuda.dia_kernel import in_grid_mask

    n = int(np.prod(dims))
    data = torch.randn((len(offsets), n), generator=gen, device=dev)
    if zeroed:
        for k, o in enumerate(offsets):
            data[k] *= in_grid_mask(dims, o, dev)
    return data.to(dtype)


def phase_halo_kernels(dev) -> dict:
    """K3 against its plain version at the shapes the sharded path gives it,
    K1v1 against its plain version on planes that are not boundary-zeroed;
    times both (K3 on the 256^3 fine level, L2-warm and L2-cold)."""
    from raptor_tpu_torch.ops.cuda.dia_kernel import (
        dia_spmv_halo, dia_spmv_halo_ref, dia_spmv_v1, dia_spmv_v1_ref,
        halo_reach)

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    N, N4 = SDIST_N, SDIST_N4
    cube = list(itertools.product((-1, 0, 1), repeat=3))
    off7 = [o for o in cube if sum(map(abs, o)) <= 1]
    off15 = [o for o in cube if abs(o[1]) + abs(o[2]) <= 1]
    rec = {"K3": {"err": 0.0}, "K1v1": {"err": 0.0}}

    def vec(n):
        return torch.randn(n, generator=gen, device=dev)

    cases = [("256^3 fine", (N,) * 3, off7, torch.float32),
             ("256^3 L1", (N // 2, N, N), off15, torch.float32),
             ("256^3 L1", (N // 2, N, N), off15, torch.bfloat16),
             ("256^3 L2", (N // 2, N // 2, N), cube, torch.float32),
             ("4-rank 128^3 block", (N4 // SDIST_RANKS, N4, N4), off7,
              torch.float32)]
    for label, dims, offs, dtype in cases:
        data = _device_planes(dims, offs, dtype, gen, dev)
        lins = _lins(dims, offs)
        LP, RP = halo_reach(lins)
        x, hl, hr = vec(data.shape[1]), vec(LP), vec(RP)
        name = f"K3 {label} {dims} {len(offs)} offsets {dtype} halos {LP}/{RP}"
        rec["K3"]["err"] = max(rec["K3"]["err"], _check(
            name, dia_spmv_halo(data, lins, x, hl, hr),
            dia_spmv_halo_ref(data, lins, x, hl, hr)))
        if label == "256^3 fine":
            r = rec["K3"]
            r["ms"] = graph_ms(lambda: dia_spmv_halo(data, lins, x, hl, hr))
            r["cold_ms"] = graph_ms(lambda: dia_spmv_halo(data, lins, x, hl, hr),
                                   flush_l2=True)
            r["plain_ms"] = graph_ms(lambda: dia_spmv_halo_ref(data, lins, x, hl, hr))
            n = data.shape[1]
            r["bytes"] = data.numel() * 4 + 4 * (n + LP + RP) + 4 * n
            yardsticks(r, dia_csr(data, lins, n + LP + RP, shift=LP),
                       torch.cat([hl, x, hr]), r["bytes"])
        del data

    dims = (N4,) * 3
    for dtype in (torch.float32, torch.bfloat16):
        data = _device_planes(dims, off7, dtype, gen, dev, zeroed=False)
        lins = _lins(dims, off7)
        x = vec(data.shape[1])
        rec["K1v1"]["err"] = max(rec["K1v1"]["err"], _check(
            f"K1v1 {dims} 7 offsets {dtype}, planes not boundary-zeroed",
            dia_spmv_v1(data, lins, x), dia_spmv_v1_ref(data, lins, x)))
        if dtype == torch.float32:
            r = rec["K1v1"]
            r["ms"] = graph_ms(lambda: dia_spmv_v1(data, lins, x))
            r["plain_ms"] = graph_ms(lambda: dia_spmv_v1_ref(data, lins, x))
            r["bytes"] = data.numel() * 4 + 8 * data.shape[1]
            yardsticks(r, dia_csr(data, lins, data.shape[1]), x, r["bytes"])
    for k, what in (("K3", "256^3 fine, 7 fp32 planes"),
                    ("K1v1", "128^3, 7 fp32 planes")):
        r = rec[k]
        cold = (f"; L2-cold {r['cold_ms'] * 1e3:.1f} us" if "cold_ms" in r
                else "")
        print(f"[halo] {k} {what}: {r['ms'] * 1e3:.1f} us kernel "
              f"({r['bytes'] / r['ms'] / 1e9:.3f} TB/s), "
              f"{r['plain_ms'] * 1e3:.1f} us plain, "
              f"{r['library_ms'] * 1e3:.1f} us cuSPARSE CSR, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}) (device time, "
              f"graph replay, L2-warm){cold}")
    return rec


def _relres(x: torch.Tensor, b: torch.Tensor, n: int) -> float:
    b64 = b.double().cpu().numpy()
    r = poisson7_residual(x.double().cpu().numpy(), b64, n)
    return float(np.linalg.norm(r) / np.linalg.norm(b64))


def phase_sdist_one_rank(dev) -> dict:
    """Phases 11 and 12: the config-5 preset at SDIST_N^3 on one rank over
    NCCL (cold, then warm), V-cycles, the proof on the counts of that run;
    then, outside the counts, the single-device solve on the same plan and
    the one-rank SDIST_N4^3 run that phase 13 compares with."""
    import torch.distributed as dist

    from raptor_tpu_torch.ops.cuda.launch import launches_by_shape
    from raptor_tpu_torch.parallel import Ring
    from raptor_tpu_torch.structured import dist as sd
    from raptor_tpu_torch.structured.solver import (_build_hierarchy_planned,
                                                    structured_solve)

    n = SDIST_N
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        snap = counts()
        cold = sd.sdist_config5(ring, dev, n=n)
        warm = sd.sdist_config5(ring, dev, n=n)
        dh, info = warm["hier"], warm["info"]
        _, b = sd.config5_problem(n, dev)
        before = collections.Counter(launches_by_shape)
        y = sd.sdist_cycle(dh, ring, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CYCLES):
            y = sd.sdist_cycle(dh, ring, b)
        torch.cuda.synchronize()
        vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
        per_cycle = per_call(launches_by_shape, before, N_CYCLES + 1)
        launches, shapes_all = since(snap, DIA_KERNELS)
        k3, v1 = launches["K3"], launches["K1v1"]
        print(f"[proof] sharded {n}^3 path: {k3} K3 launches ({launches['K1']} "
              f"K1, {launches['K2']} K2 in the replicated tail, {v1} K1v1)")
        if k3 == 0:
            raise AssertionError("the sharded path did not run through K3")
        shapes = by_shape(f"sharded {n}^3", shapes_all, ("K1", "K2", "K3"))
        by_shape(f"sharded {n}^3, one V-cycle", per_cycle, ("K1", "K2", "K3"))
        if v1:
            raise AssertionError("the sharded path launched K1v1")
        if not torch.isfinite(y).all():
            raise AssertionError("sharded V-cycle output not finite")

        iters = int(info.iterations)
        certified = float(info.relres)
        relres = _relres(warm["x"], b, n)
        levels = [lv.dims_local for lv in dh.levels]
        print(f"[sdist] {n}^3 on 1 rank (NCCL): setup {warm['setup_s']:.3f} s "
              f"warm, {cold['setup_s']:.3f} s cold; {len(levels)} sharded "
              f"levels {levels[0]}..{levels[-1]}, tail of "
              f"{len(dh.tail.levels)} levels from {dh.tail.levels[0].dims}")
        print(f"[sdist] V-cycle {vc:.3f} ms ({n ** 3 / vc * 1e3:.4g} DOF/s, "
              f"{N_CYCLES} cycles between syncs); solve {warm['solve_s']:.3f} s "
              f"warm, {cold['solve_s']:.3f} s cold; {iters} PCG iterations, "
              f"certified {certified:.3e}, true fp64 relres {relres:.3e}")

        # the single-device solve on the same plan, tail not folded
        A, _ = sd.config5_problem(n, dev)
        plan, _ = sd.plan_coarsening_dist(A, sd.CONFIG5, 1, "size")
        h1 = _build_hierarchy_planned(A, sd.CONFIG5, plan)
        x1, info1 = structured_solve(h1, b, tol=sd.CONFIG5_TOL,
                                     maxiter=sd.CONFIG5_MAXITER)
        it1 = int(info1.iterations)
        print(f"[sdist] single-device structured_solve, same plan: {it1} "
              f"iterations, true fp64 relres {_relres(x1, b, n):.3e}")
        del h1, x1, A
        if warm["x"].shape != (n ** 3,) or not torch.isfinite(warm["x"]).all():
            raise AssertionError("sharded solution not finite or misshapen")
        if int(cold["info"].iterations) != iters:
            raise AssertionError("cold and warm runs took different iterations")
        if not (certified <= SDIST_TOL and relres <= SDIST_MAX_TRUE):
            raise AssertionError(f"certified {certified} (max {SDIST_TOL}), "
                                 f"true {relres} (max {SDIST_MAX_TRUE})")
        # the sharded tail folds nothing and the dots reduce in another
        # order: one iteration either way
        if abs(iters - it1) > 1:
            raise AssertionError(f"{iters} iterations, single-device {it1}")
        out = {"n": n, "setup_warm_s": warm["setup_s"],
               "setup_cold_s": cold["setup_s"], "vcycle_ms": vc,
               "solve_s": warm["solve_s"], "iters": iters,
               "certified": certified, "relres": relres,
               "single_device_iters": it1, "k3_launches": k3,
               "k1v1_launches": v1, "launches_by_shape": shapes,
               "vcycle_launches_by_shape": sorted(
                   [*key, c] for key, c in per_cycle.items())}
        del dh, warm, cold, y

        one4 = sd.sdist_config5(ring, dev, n=SDIST_N4)
        out["one_rank_iters_small"] = int(one4["info"].iterations)
        print(f"[sdist] {SDIST_N4}^3 on 1 rank: "
              f"{out['one_rank_iters_small']} iterations, solve "
              f"{one4['solve_s']:.3f} s")
    finally:
        dist.destroy_process_group()
    return out


def rank_config5(ring, device, n: int) -> dict:
    """One rank of phase 13 (runs in a spawned process): the config-5
    preset on the ring; rank 0 returns the gathered x."""
    from raptor_tpu_torch.structured import dist as sd

    snap = counts()
    out = sd.sdist_config5(ring, device, n=n)
    launches, _ = since(snap)
    x = sd.gather(out["x"], ring)
    info = out["info"]
    return {"iters": int(info.iterations), "certified": float(info.relres),
            "setup_s": out["setup_s"], "solve_s": out["solve_s"],
            "k3": launches["K3"], "k1v1": launches["K1v1"],
            "x": x.cpu().numpy() if ring.axis_index == 0 else None}


def phase_sdist_ranks(dev, one_rank_iters: int) -> dict:
    """Phase 13: SDIST_RANKS ranks sharing the card over gloo at
    SDIST_N4^3; each rank must launch K3, rank 0's gathered x must pass a
    host fp64 residual with the stencil_grid operator."""
    from raptor_tpu_torch.gallery import default_rhs, stencil_grid
    from raptor_tpu_torch.parallel import spawn

    n = SDIST_N4
    t0 = time.perf_counter()
    outs = spawn(rank_config5, SDIST_RANKS, "gloo", dev, n, timeout=600.0)
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        print(f"[sdist{SDIST_RANKS}] rank {r}: {o['iters']} iterations, setup "
              f"{o['setup_s']:.3f} s, solve {o['solve_s']:.3f} s, "
              f"{o['k3']} K3 launches")
        if o["k3"] == 0:
            raise AssertionError(f"rank {r} did not run through K3")
        if o["k1v1"]:
            raise AssertionError(f"rank {r} launched K1v1")
    iters = outs[0]["iters"]
    if any(o["iters"] != iters for o in outs):
        raise AssertionError("the ranks disagree on the iteration count")
    x64 = outs[0]["x"].astype(np.float64)
    b64 = default_rhs(n ** 3, dtype=np.float32).astype(np.float64)
    r_grid = b64 - stencil_grid(stencil_7pt(), (n,) * 3) @ x64
    r_host = poisson7_residual(x64, b64, n)
    relres = float(np.linalg.norm(r_grid) / np.linalg.norm(b64))
    print(f"[sdist{SDIST_RANKS}] {n}^3 on {SDIST_RANKS} ranks sharing the card "
          f"(gloo, host-staged): {iters} iterations (one rank: "
          f"{one_rank_iters}), certified {outs[0]['certified']:.3e}, true fp64 "
          f"relres {relres:.3e}; {wall:.1f} s with the processes' start")
    if x64.shape != (n ** 3,) or not np.isfinite(x64).all():
        raise AssertionError("gathered solution not finite or misshapen")
    # the slicing residual of phase 11 is the stencil_grid operator's
    if not np.abs(r_grid - r_host).max() <= 1e-12 * np.abs(b64).max():
        raise AssertionError("poisson7_residual disagrees with stencil_grid")
    if not relres <= SDIST_MAX_TRUE:
        raise AssertionError(f"true relres {relres} > {SDIST_MAX_TRUE}")
    # four ranks sum each dot in another order than one: one iteration
    # either way in fp32
    if abs(iters - one_rank_iters) > 1:
        raise AssertionError(f"{iters} iterations, one rank {one_rank_iters}")
    return {"n": n, "ranks": SDIST_RANKS, "iters": iters, "relres": relres,
            "setup_s": [o["setup_s"] for o in outs],
            "solve_s": [o["solve_s"] for o in outs],
            "k3_launches": [o["k3"] for o in outs],
            "k1v1_launches": [o["k1v1"] for o in outs]}


# ---------------------------------------------------------------------------
# the algebraic sharded solve: K4's halo form and K6's map_cols form
# ---------------------------------------------------------------------------

def n_sharded(h) -> int:
    """The levels distribute_hierarchy shards with ADIST_TAIL (its own
    rule)."""
    t = 1
    while t < len(h.levels) - 1 and h.levels[t].n > ADIST_TAIL:
        t += 1
    return t


def ell_block_csr(E, r0: int, r1: int, shift: int, n_cols: int, dev):
    """Rows [r0, r1) of an ELL operator as a float32 CSR tensor on ``dev``
    whose column c sits at c + shift (a rank's halo buffer); raises if an
    entry falls outside the buffer."""
    data, cols, nnz = (t.cpu().numpy() for t in (E.data, E.cols, E.row_nnz))
    d, z = data[:, r0:r1], nnz[r0:r1]
    c = cols[:, r0:r1].astype(np.int64) + shift
    keep = np.arange(E.K)[:, None] < z[None, :]
    if (c[keep] < 0).any() or (c[keep] >= n_cols).any():
        raise AssertionError("a block's entry reaches outside its buffer")
    rows = np.broadcast_to(np.arange(r1 - r0)[None, :], d.shape)
    a = sp.csr_matrix((d[keep], (rows[keep], c[keep])), shape=(r1 - r0, n_cols))
    return host_csr(a, a.shape, dev)


def sharded_cases(h, ndev: int, every: bool = True, ranks=None) -> list:
    """(kernel, label, rank, local plan, buffer length, map_cols, ELL
    operator, first row, column shift) for the tiles of ``ranks`` (rank 0's
    and the last rank's by default) of every operator the sharded path runs
    through K4's halo form or K6's map_cols form: as dist_banded_spmv and
    dist_rect_banded_spmv call them.  With ``every``, raises if an operator
    of a sharded level does not shard that way; else skips it (the path
    takes ELL there)."""
    from raptor_tpu_torch.parallel.dist import _shardable_band, _shardable_rect

    t = n_sharded(h)
    ranks = sorted({0, ndev - 1}) if ranks is None else ranks
    out = []
    for k in range(t):
        lev = h.levels[k]
        B = _shardable_band(lev.Aband, ndev)
        if B is None and not every:
            continue
        if B is None:
            raise AssertionError(f"L{k}'s banded A does not shard over {ndev}")
        K, n, tile, kh, npage, Wp = B.meta
        nl, hw = n // ndev, kh * tile
        for rank in ranks:
            tiles = slice(rank * nl // tile, (rank + 1) * nl // tile)
            plan = dict(B.plan(), n=nl, vals=B.vals[tiles].contiguous(),
                        pidx=B.pidx[tiles].contiguous())
            out.append(("K4-halo", f"L{k} A", rank, plan, nl + 2 * hw, None,
                        lev.A, rank * nl, hw - rank * nl))
        if k + 1 >= t:
            continue
        nf, nc = lev.A.n_rows_pad, h.levels[k + 1].A.n_rows_pad
        for name, band, E, rows, cols in (("R", lev.Rband, lev.R, nc, nf),
                                          ("P", lev.Pband, lev.P, nf, nc)):
            B = _shardable_rect(band, ndev, rows, cols)
            if B is None and not every:
                continue
            if B is None:
                raise AssertionError(f"L{k}'s banded {name} does not shard")
            K, n, n_cols, tile, WpP, npage = B.meta
            nl, cl = n // ndev, n_cols // ndev
            for rank in ranks:
                tiles = slice(rank * nl // tile, (rank + 1) * nl // tile)
                length = cl + npage * 1024
                plan = dict(B.plan(), n=nl, n_cols=length, WpP=0,
                            vals=B.vals[tiles].contiguous(),
                            pidx=B.pidx[tiles].contiguous())
                out.append(("K6-map_cols", f"L{k} {name}", rank, plan, length,
                            cl, E, rank * nl, WpP * 1024 - rank * cl))
    return out


def phase_sharded_kernels(dev, h4) -> dict:
    """Phase 14: K4's halo form and K6's map_cols form against their plain
    versions, bit for bit, at every shape the four-rank 96^3 path gives
    them (rank 0's and the last rank's blocks, random buffers); each timed
    L2-warm and L2-cold with its bound; L0 A and L0 R of rank 0 also
    against the plain version and cuSPARSE on the same local block."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    rec = {k: {"err": 0.0, "shapes": {}} for k in ("K4-halo", "K6-map_cols")}
    for kern, label, rank, plan, length, map_cols, E, r0, shift in sharded_cases(
            h4, ADIST_RANKS):
        x = torch.randn(length, generator=gen, device=dev)
        if kern == "K4-halo":
            fn = lambda: bk.banded_spmv_halo(plan, x)  # noqa: E731
            ref = lambda: bk.banded_spmv_halo_ref(plan, x)  # noqa: E731
        else:
            fn = lambda: bk.banded_spmv_rect(plan, x, map_cols=map_cols)  # noqa: E731
            ref = lambda: bk.banded_spmv_rect_ref(plan, x, map_cols=map_cols)  # noqa: E731
        name = f"{kern} {ADIST_N}^3 {label} rank {rank} n={plan['n']} K {plan['K']}"
        err = _equal(name, fn(), ref())
        r = rec[kern]
        r["err"] = max(r["err"], err)
        live = len(bk.live_slots(plan))
        nbytes = live * plan["n"] * 8 + 4 * plan["n"] + 4 * length
        bms = bound(nbytes, 2 * live * plan["n"])[0]
        warm = graph_ms(fn)
        cold = graph_ms(fn, flush_l2=True)
        r["shapes"][f"{label} rank {rank}"] = [plan["n"], plan["K"], warm, cold, bms]
        lp = bk.banded_launch_plan(plan, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        print(f"[sharded] {name} live {live} buffer {length}: {warm * 1e3:.1f} us "
              f"L2-warm, {cold * 1e3:.1f} us L2-cold, bound {bms * 1e3:.1f} us; "
              f"{'staged' if lp.staged else 'direct'}, {lp.rows} rows a "
              f"thread, {lp.threads} threads a block (device time, graph "
              f"replay)")
        if label in ("L0 A", "L0 R") and rank == 0:
            r.update(ms=warm, cold_ms=cold, bytes=nbytes, plain_ms=graph_ms(ref),
                     cold_plain_ms=graph_ms(ref, flush_l2=True))
            yardsticks(r, ell_block_csr(E, r0, r0 + plan["n"], shift, length, dev),
                       x, nbytes)
    for k, what in (("K4-halo", "L0 A"), ("K6-map_cols", "L0 R")):
        r = rec[k]
        print(f"[sharded] {k} {ADIST_N}^3 {what}, rank 0 of {ADIST_RANKS}: "
              f"{r['ms'] * 1e3:.1f} us kernel ({r['bytes'] / r['ms'] / 1e9:.3f} "
              f"TB/s), {r['plain_ms'] * 1e3:.1f} us plain, "
              f"{r['library_ms'] * 1e3:.1f} us cuSPARSE CSR (device time, graph "
              f"replay, L2-warm); L2-cold {r['cold_ms'] * 1e3:.1f} us kernel, "
              f"{r['cold_plain_ms'] * 1e3:.1f} us plain; bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']})")
    return rec


def sharded_equal(dev, tag: str, h, ndev: int, rec, shapes: list,
                  ranks=None) -> None:
    """K4's halo form and K6's map_cols form against their plain versions,
    bit for bit, on the tiles of ``ranks`` (rank 0's and the last rank's
    by default) of every operator the sharded path of ``h`` over ``ndev``
    ranks runs through them (random buffers); every (kernel, n, K, dtype)
    the path launched (``shapes``, launches by shape) must be among
    them."""
    from raptor_tpu_torch.ops.cuda import banded_kernel as bk

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    compared = set()
    for kern, label, rank, plan, length, map_cols, *_ in sharded_cases(
            h, ndev, every=False, ranks=ranks):
        x = torch.randn(length, generator=gen, device=dev)
        name = f"{kern} {tag} {label} rank {rank} n={plan['n']} K {plan['K']}"
        if kern == "K4-halo":
            y, y_ref = bk.banded_spmv_halo(plan, x), bk.banded_spmv_halo_ref(plan, x)
        else:
            y = bk.banded_spmv_rect(plan, x, map_cols=map_cols)
            y_ref = bk.banded_spmv_rect_ref(plan, x, map_cols=map_cols)
        rec[kern]["err"] = max(rec[kern]["err"], _equal(name, y, y_ref))
        compared.add((kern, plan["n"], plan["K"],
                      str(plan["vals"].dtype).removeprefix("torch.")))
    covered(tag, shapes, compared)


def adist_routes(tag: str, dh) -> list:
    """Print and return each sharded level's route for A, P and R."""
    rows = []
    for k, lv in enumerate(dh.levels):
        a = lv.Aband
        route = {"A": "banded" if a is not None else "ELL",
                 "P": ("banded" if lv.Pband is not None else "ELL")
                 if lv.Pmat is not None else "bridge",
                 "R": ("banded" if lv.Rband is not None else "ELL")
                 if lv.Rmat is not None else "bridge"}
        print(f"[{tag}]   L{k} n {lv.n} n_local {lv.n_local}: A {route['A']}"
              + (f" (kh {a.meta[3]}, reordered {a.reordered})" if a is not None
                 else "") + f", P {route['P']}, R {route['R']}")
        rows.append(route)
    return rows


def caller_relres(A, x_rcm, pm, b) -> float:
    """The true fp64 relres of x, put back into the caller's ordering,
    against the caller's matrix and right-hand side."""
    n = A.shape[0]
    x = np.empty(n)
    x[pm] = x_rcm[:n]
    return float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))


def phase_adist_one_rank(dev, h96) -> dict:
    """Phases 15 and 16: distribute_hierarchy and dist_solve at shuffled
    96^3 on one rank over NCCL, on phase 9's hierarchy (its pad_multiple,
    1024, serves a ring of one), cold then warm; V-cycles; the proof on the
    counts of that run; then, outside them, the single-device solve_hier
    on the same hierarchy and the profile of 10 V-cycles."""
    import torch.distributed as dist

    from raptor_tpu_torch.api import solve_hier
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import Ring, dist_solve, distribute_hierarchy
    from raptor_tpu_torch.parallel import dist as pdist

    A = shuffled_poisson(ADIST_N)
    n = A.shape[0]
    pm = h96.perm[:n].cpu().numpy()
    b = default_rhs(n)  # the caller's ordering
    bd = pad_vector(b[pm].astype(np.float32), h96.levels[0].A.n_rows_pad,
                    device=dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        snap = counts()
        runs = []
        for _ in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dh = distribute_hierarchy(h96, ring, ADIST_TAIL)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x, info = dist_solve(dh, bd, ring, tol=ADIST_TOL, maxiter=200)
            torch.cuda.synchronize()
            runs.append((t1 - t0, time.perf_counter() - t1, int(info.iterations),
                         float(info.relres), x))
        ctx = pdist.CommCtx.flat(ring)
        y = pdist.dist_cycle(dh, bd, ctx)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(N_CYCLES):
            y = pdist.dist_cycle(dh, bd, ctx)
        torch.cuda.synchronize()
        vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
        launches, shapes_all = since(snap, BANDED_KERNELS)
        k4h, k6m = launches["K4-halo"], launches["K6-map_cols"]
        print(f"[proof] sharded {ADIST_N}^3 path, 1 rank: {k4h} K4-halo "
              f"launches, {k6m} K6-map_cols launches (no transfer shards on "
              f"one rank); {launches['K4']} K4 launches (tail)")
        if k4h == 0 or k6m != 0:
            raise AssertionError("the one-rank sharded path did not run "
                                 "through K4's halo form alone")
        shapes = by_shape("adist 1 rank", shapes_all,
                          ("K4-halo", "K6-map_cols", "K4", "K6"))
        if not torch.isfinite(y).all():
            raise AssertionError("sharded V-cycle output not finite")
        routes = adist_routes("adist1", dh)

        (dist_cold, sol_cold, it_cold, _, _), (dist_s, sol, iters, certified, x) = runs
        relres = caller_relres(A, x.double().cpu().numpy(), pm, b)
        x1, info1 = solve_hier(h96, bd, tol=ADIST_TOL, maxiter=200)
        it1 = int(info1.iterations)
        rel1 = caller_relres(A, x1.double().cpu().numpy(), pm, b)
        prof = profile_cycles(lambda: pdist.dist_cycle(dh, bd, ctx))
        print(f"[adist1] {ADIST_N}^3 on 1 rank (NCCL): distribute {dist_s:.3f} s "
              f"warm, {dist_cold:.3f} s cold; solve {sol:.3f} s warm, "
              f"{sol_cold:.3f} s cold; {iters} PCG iterations, certified "
              f"{certified:.3e}, true fp64 relres {relres:.3e} (caller's "
              f"ordering); single-device solve_hier {it1} iterations, true "
              f"{rel1:.3e}; V-cycle {vc:.3f} ms ({n / vc * 1e3:.4g} DOF/s, "
              f"{N_CYCLES} cycles between syncs)")
        print(f"[profile] sharded {ADIST_N}^3 V-cycle, 1 rank, {N_PROFILED} cycles "
              f"under torch.profiler: wall {prof['wall_ms']:.3f} ms, device busy "
              f"{prof['busy_ms']:.3f} ms, {prof['device_events']:g} device "
              f"events, busy share {prof['busy_share'] * 100:.1f}% (per cycle)")
        if x.shape != (h96.levels[0].A.n_rows_pad,) or not torch.isfinite(x).all():
            raise AssertionError("sharded solution not finite or misshapen")
        if it_cold != iters:
            raise AssertionError("cold and warm runs took different iterations")
        if not (certified <= ADIST_TOL and relres <= ADIST_MAX_TRUE):
            raise AssertionError(f"certified {certified} (max {ADIST_TOL}), "
                                 f"true {relres} (max {ADIST_MAX_TRUE})")
        if abs(iters - it1) > 1:
            raise AssertionError(f"{iters} iterations, single-device {it1}")
        return {"n": n, "distribute_warm_s": dist_s, "distribute_cold_s": dist_cold,
                "solve_s": sol, "solve_cold_s": sol_cold, "iters": iters,
                "certified": certified, "relres": relres,
                "single_device_iters": it1, "vcycle_ms": vc, "profile": prof,
                "k4_halo_launches": k4h, "k6_map_cols_launches": k6m,
                "routes": routes, "launches_by_shape": shapes}
    finally:
        dist.destroy_process_group()


def exchange_counts(dh, th) -> dict:
    """Messages and words a rank sends per V-cycle, from the host plans:
    the flat solve as it runs (banded levels by tile halos, the rest by
    their ELL plans), the ELL plans alone (comm_report's), and TAPS
    (inter-node shifts and their words; intra-node all-gathers)."""
    from raptor_tpu_torch.parallel.dist import comm_report

    rep = comm_report(dh)
    ndev = dh.ndev
    out = {"flat": [0, 0], "flat_ell": [0, 0], "taps_inter": [0, 0],
           "taps_gathers": 0}
    for k, (lv, row) in enumerate(zip(dh.levels, rep["levels"])):
        a_ex = row["exchanges_per_vcycle"] - (2 if "P" in row else 0)
        for op, times in (("A", a_ex), ("R", 1), ("P", 1)):
            if op not in row:
                continue
            ell = (row[op]["ppermute_rounds"], sum(row[op]["halo_words_per_round"]))
            band = {"A": lv.Aband, "R": lv.Rband, "P": lv.Pband}[op]
            if band is None:
                flat = ell
            elif op == "A":
                flat = (2, 2 * band.meta[3] * band.meta[2])
            else:
                K, n, n_cols, tile, WpP, npage = band.meta
                cl = n_cols // ndev
                lh, rh = WpP * 1024, (npage - WpP) * 1024
                flat = (-(-lh // cl) + -(-rh // cl), lh + rh)
            tp = th.plan((op, k))
            taps = (len(tp.offsets), sum(int(s.shape[-1]) for s in tp.send_idx))
            for key, (msgs, words) in (("flat", flat), ("flat_ell", ell),
                                       ("taps_inter", taps)):
                out[key][0] += times * msgs
                out[key][1] += times * words
            out["taps_gathers"] += times * (1 + len(tp.offsets))
    out["comm_report_bytes"] = rep["halo_bytes_per_vcycle_per_dev"]
    return out


def rank_adist(ring, device, path: str, b_rcm) -> dict:
    """One rank of phase 17 (runs in a spawned process): the hierarchy
    saved by the parent, through ``adist_body`` on a TAPS_GRID mesh."""
    from raptor_tpu_torch.parallel import make_taps_mesh

    h = torch.load(path, weights_only=False, map_location=device)
    b = torch.from_numpy(b_rcm).to(device)
    return adist_body(ring, device, h, b, make_taps_mesh(*TAPS_GRID))[0]


def adist_body(ring, device, h, b, mesh) -> tuple:
    """One rank of the algebraic sharded solve of ``h`` (phases 17 and
    28): sharded, the flat solve on the launches counted since just
    before it;
    then TAPS on ``mesh`` against the flat solve on the ELL route.
    Returns (the rank's record, rank 0's with the gathered x; the sharded
    hierarchy)."""
    from raptor_tpu_torch.parallel import (dist_solve, dist_solve_taps,
                                           distribute_hierarchy,
                                           distribute_hierarchy_taps)
    from raptor_tpu_torch.parallel.halo import halo_exchange
    from raptor_tpu_torch.parallel.taps import taps_exchange

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dh = distribute_hierarchy(h, ring, ADIST_TAIL)
    torch.cuda.synchronize()
    dist_s = time.perf_counter() - t0
    snap = counts()
    t0 = time.perf_counter()
    x, info = dist_solve(dh, b, ring, tol=ADIST_TOL, maxiter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches, shapes_all = since(snap, BANDED_KERNELS)
    got = {k: launches[k] for k in ("K4-halo", "K6-map_cols", "K4", "K6")}
    shapes = sorted([*key, c] for key, c in shapes_all.items())
    xg = ring.all_gather(x)

    th = distribute_hierarchy_taps(h, mesh, ADIST_TAIL)
    t0 = time.perf_counter()
    xt, it_t = dist_solve_taps(th, b, mesh, tol=ADIST_TOL, maxiter=200)
    torch.cuda.synchronize()
    taps_s = time.perf_counter() - t0
    dh_ell = dataclasses.replace(dh, levels=tuple(
        dataclasses.replace(lv, Aband=None, Pband=None, Rband=None)
        for lv in dh.levels))
    xe, it_e = dist_solve(dh_ell, b, ring, tol=ADIST_TOL, maxiter=200)
    gen = torch.Generator(device=device)
    gen.manual_seed(ring.axis_index)
    ext_equal = []
    for (op, k), plan in zip(th.keys, th.plans):
        lv = dh.levels[k]
        dm = {"A": lv.A, "R": lv.Rmat, "P": lv.Pmat}[op]
        v = torch.randn(plan.n_local, generator=gen, device=device)
        ext_equal.append(torch.equal(taps_exchange(v, plan, mesh),
                                     halo_exchange(v, dm.halo, ring)))
    rec = {"iters": int(info.iterations), "certified": float(info.relres),
           "distribute_s": dist_s, "solve_s": solve_s, "taps_s": taps_s,
           "counts": got, "shapes": shapes,
           "routes": [(lv.Aband is not None, lv.Pband is not None,
                       lv.Rband is not None) for lv in dh.levels],
           "taps_iters": int(it_t.iterations), "ell_iters": int(it_e.iterations),
           "taps_equal": torch.equal(xt, xe), "ext_equal": ext_equal,
           "exchanges": exchange_counts(dh, th),
           "x": xg.cpu().numpy() if ring.axis_index == 0 else None}
    return rec, dh


def phase_adist_ranks(dev, h4_cpu, one_rank_iters: int) -> dict:
    """Phase 17: ADIST_RANKS ranks sharing the card over gloo at shuffled
    96^3 on the hierarchy padded for them (``h4_cpu``, moved to the CPU to
    be saved for the ranks); each must launch both sharded forms."""
    import tempfile

    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import spawn

    A = shuffled_poisson(ADIST_N)
    n = A.shape[0]
    pm = h4_cpu.perm[:n].numpy()
    b = default_rhs(n)
    b_rcm = np.zeros(h4_cpu.levels[0].A.n_rows_pad, np.float32)
    b_rcm[:n] = b[pm]
    with tempfile.TemporaryDirectory(prefix="raptor_adist_") as tmp:
        path = f"{tmp}/hier.pt"
        torch.save(h4_cpu, path)
        t0 = time.perf_counter()
        outs = spawn(rank_adist, ADIST_RANKS, "gloo", dev, path, b_rcm,
                     timeout=900.0)
        wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        c = o["counts"]
        print(f"[adist{ADIST_RANKS}] rank {r}: {o['iters']} iterations, "
              f"distribute {o['distribute_s']:.3f} s, solve {o['solve_s']:.3f} s, "
              f"TAPS solve {o['taps_s']:.3f} s; launches {c}")
        if c["K4-halo"] == 0 or c["K6-map_cols"] == 0:
            raise AssertionError(f"rank {r} did not run through both sharded forms")
        if not (o["taps_equal"] and all(o["ext_equal"])
                and o["taps_iters"] == o["ell_iters"]):
            raise AssertionError(f"rank {r}: TAPS differs from the flat solve "
                                 f"on the ELL route")
    iters = outs[0]["iters"]
    if any(o["iters"] != iters for o in outs):
        raise AssertionError("the ranks disagree on the iteration count")
    x = outs[0]["x"].astype(np.float64)
    relres = caller_relres(A, x, pm, b)
    ex = outs[0]["exchanges"]
    print(f"[adist{ADIST_RANKS}] {ADIST_N}^3 on {ADIST_RANKS} ranks sharing the "
          f"card (gloo, host-staged): {iters} iterations (one rank: "
          f"{one_rank_iters}), certified {outs[0]['certified']:.3e}, true fp64 "
          f"relres {relres:.3e}; TAPS {outs[0]['taps_iters']} iterations, x equal "
          f"to the flat ELL-route solve's ({outs[0]['ell_iters']} iterations) "
          f"bit for bit; {wall:.1f} s with the processes' start")
    print(f"[adist{ADIST_RANKS}] per V-cycle per rank, from the host plans: "
          f"comm_report {ex['comm_report_bytes']} halo bytes; flat as run "
          f"{ex['flat'][0]} messages, {ex['flat'][1]} words; flat ELL plans "
          f"{ex['flat_ell'][0]} messages, {ex['flat_ell'][1]} words; TAPS "
          f"{ex['taps_inter'][0]} inter-node messages, {ex['taps_inter'][1]} "
          f"words, {ex['taps_gathers']} intra-node all-gathers")
    for k, (a, p, r) in enumerate(outs[0]["routes"]):
        print(f"[adist{ADIST_RANKS}]   L{k}: A {'banded' if a else 'ELL'}, "
              f"P {'banded' if p else 'ELL'}, R {'banded' if r else 'ELL'}")
    by_shape(f"adist {ADIST_RANKS} ranks, rank 0",
             {tuple(s[:-1]): s[-1] for s in outs[0]["shapes"]},
             ("K4-halo", "K6-map_cols", "K4", "K6"))
    if x.shape != (h4_cpu.levels[0].A.n_rows_pad,) or not np.isfinite(x).all():
        raise AssertionError("gathered solution not finite or misshapen")
    if not relres <= ADIST_MAX_TRUE:
        raise AssertionError(f"true relres {relres} > {ADIST_MAX_TRUE}")
    if abs(iters - one_rank_iters) > 1:
        raise AssertionError(f"{iters} iterations, one rank {one_rank_iters}")
    return {"n": n, "ranks": ADIST_RANKS, "iters": iters, "relres": relres,
            "taps_iters": outs[0]["taps_iters"], "exchanges": ex,
            "distribute_s": [o["distribute_s"] for o in outs],
            "solve_s": [o["solve_s"] for o in outs],
            "taps_s": [o["taps_s"] for o in outs],
            "launches": [o["counts"] for o in outs],
            "launches_by_shape": outs[0]["shapes"]}


def sharded_excess(rec: dict, shapes: list) -> None:
    """Sigma over the four-rank path's shapes (rank 0's launches) of
    launches x (L2-warm time - bound), from phase 14's times of rank 0's
    blocks; into rec[kernel]["excess_ms"]."""
    for kern in ("K4-halo", "K6-map_cols"):
        timed = {(n, K): (warm, b) for label, (n, K, warm, _, b)
                 in rec[kern]["shapes"].items() if label.endswith("rank 0")}
        total = sum(c * (timed[(n, K)][0] - timed[(n, K)][1])
                    for k, n, K, _, c in shapes if k == kern)
        rec[kern]["excess_ms"] = total
        print(f"[sharded] {kern}: sum over rank 0's shapes of the "
              f"{ADIST_RANKS}-rank path of launches x (L2-warm - bound): "
              f"{total:.4f} ms")


def setup_padded_hierarchy(dev, ranks: int = ADIST_RANKS):
    """The shuffled 96^3 hierarchy padded for ``ranks`` ranks (1024 rows a
    tile, a whole number of tiles a rank), with its unpadded level sizes
    checked against the reference's.  Every level is built on the host
    (threshold 2**20): a banded layout, the only route to K4's halo form
    and K6's map_cols form, comes from the host-built levels."""
    from raptor_tpu_torch import AmgConfig, setup

    t0 = time.perf_counter()
    pad = 1024 * ranks
    h = setup(shuffled_poisson(ADIST_N),
              AmgConfig(**ALG_CFG, host_setup_threshold=2**20,
                        pad_multiple=pad), device=dev)
    torch.cuda.synchronize()
    sizes = [lv.n for lv in h.levels]
    print(f"[adist{ranks}] setup (pad_multiple {pad}) "
          f"{time.perf_counter() - t0:.3f} s, sizes {sizes}")
    _print_levels(f"adist{ranks}", h)
    if sizes != ALG_SIZES[ADIST_N]:
        raise AssertionError(f"level sizes {sizes}, the reference's "
                             f"{ALG_SIZES[ADIST_N]}")
    return h


# ---------------------------------------------------------------------------
# the acceptance configurations (phases 18-22)
# ---------------------------------------------------------------------------

def _config_row(tag: str, A, B, cfg, sc, dev, every_level=False) -> tuple:
    """api.setup (timed under device_route) and api.solve of one row with
    b = ones, as the reference bench: (record, hierarchy)."""
    from raptor_tpu_torch import solve
    from raptor_tpu_torch.core import bell

    h, rec = timed_setup(tag, A, cfg, dev, B=B, every_level=every_level)
    b = np.ones(A.shape[0])
    torch.cuda.synchronize()
    snap, applies = counts(), collections.Counter(bell.launches)
    t0 = time.perf_counter()
    x, info = solve(A, b, cfg, sc, hier=h)
    solve_s = time.perf_counter() - t0
    applies = bell.launches - applies
    launches = {"K8": since(snap)[0]["K8"], "block_applies": (
        applies["bell_spmv"] + applies["bell_prec"])}
    relres = true_relres(A, x, b)
    if x.shape != (A.shape[0],) or not np.isfinite(x).all():
        raise AssertionError(f"[{tag}] solution not finite or misshapen")
    if launches["K8"] != launches["block_applies"]:
        raise AssertionError(f"[{tag}] {launches['K8']} K8 launches for "
                             f"{launches['block_applies']} block applies")
    out = {"n": int(A.shape[0]), "sizes": [lv.n for lv in h.levels],
           "iters": int(info["iterations"]), "relres": relres,
           "certified": float(info["relres"]), "setup_s": rec["s"],
           "solve_s": solve_s, "launches": launches,
           "device_levels": rec["device_levels"],
           "peak_mem_gib": rec["peak_mem_gib"],
           "operator_complexity": info["stats"]["operator_complexity"]}
    print(f"[{tag}] n {out['n']}, levels {out['sizes']}, {out['iters']} "
          f"{sc.krylov} iterations, true fp64 relres {relres:.3e} (certified "
          f"{out['certified']:.3e}), operator complexity "
          f"{out['operator_complexity']:.3f}; setup {rec['s']:.3f} s "
          f"({rec['device_levels']} levels on the card), solve {solve_s:.3f} s"
          f"; {launches['block_applies']} block applies, {launches['K8']} K8 "
          "launches")
    return out, h


def phase_configs(dev) -> dict:
    """Phase 18: the acceptance rows at the reference bench's sizes and
    settings (bench.py:394-470): config1 poisson_2d(64), config2
    poisson_3d(32), config3 anisotropic_2d(96), config4 elasticity_3d(48)
    with host_setup_threshold 400000 and its rigid body modes, config5
    poisson_3d(64), nonsym_gmres convection_diffusion_2d(128) with PMIS +
    Jacobi and refined GMRES; each api.setup + api.solve (refined, tol
    1e-8), true fp64 relres <= 1e-8 and iterations <= the reference's
    BENCH_r05 count + 1 (config3: its fence, 32).  These rows use the ELL
    layout, as the reference's do: their operators and transfers launch no
    hand-written kernel (plain torch).  Config 4's block smoothers apply
    its BlockELL levels through K8: each solve's K8 launches equal its
    block applies (_config_row), more than 0 for config 4 and 0 for the
    other rows."""
    out = {}
    t_all = time.perf_counter()
    for name, ref in CONFIG_ITERS.items():
        t0 = time.perf_counter()
        A, B = config_problem(name, CONFIG_SIZES[name])
        cfg, sc = config_settings(name)
        row, _ = _config_row(name, A, B, cfg, sc, dev)
        row["wall_s"] = time.perf_counter() - t0
        limit = CONFIG3_FENCE if name == "config3" else ref + 1
        print(f"[{name}] reference (BENCH_r05 cfg): {ref} iterations; "
              f"limit {limit}; {row['wall_s']:.1f} s with the problem's build")
        if not row["relres"] <= MAX_RELRES:
            raise AssertionError(f"[{name}] true relres {row['relres']} > "
                                 f"{MAX_RELRES}")
        if not row["iters"] <= limit:
            raise AssertionError(f"[{name}] {row['iters']} iterations "
                                 f"(max {limit})")
        if (row["launches"]["K8"] > 0) != (name == "config4"):
            raise AssertionError(f"[{name}] {row['launches']['K8']} K8 "
                                 "launches")
        out[name] = row
    out["phase_s"] = time.perf_counter() - t_all
    print(f"[configs] phase 18: {out['phase_s']:.1f} s")
    return out


def k8_levels(tag: str, h, dev) -> list:
    """K8 on every BlockELL level of ``h``, on the level's own blocks and
    block inverses: the general form (A x) and the diagonal form (Binv x)
    bit for bit against their plain versions, then each timed L2-warm and
    L2-cold beside the einsum route it replaced, its bound (the live
    blocks, x and y) and one cuSPARSE matvec of the level's operator.
    Returns one record a level."""
    from raptor_tpu_torch.core import bell
    from raptor_tpu_torch.ops.cuda import bell_kernel as k8

    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for i, lv in enumerate(h.levels):
        E, binv = lv.Abell, lv.binv
        if E is None:
            continue
        nb, K, b = E.nb_pad, E.K, E.bs
        n = nb * b
        x = torch.randn(n, generator=gen, device=dev)
        name = f"K8 {tag} L{i} nb {nb} K {K} b {b}"

        def spmv():
            return k8.bell_spmv(E.data, E.cols, E.row_nnz, x)

        def diag():
            return k8.bell_diag(binv, x)

        err = max(_equal(f"{name} A x", spmv(),
                         k8.bell_spmv_ref(E.data, E.cols, E.row_nnz, x)),
                  _equal(f"{name} Binv x", diag(), k8.bell_diag_ref(binv, x)))
        live = int(E.row_nnz.sum())
        vec = 2 * n * x.element_size()
        nbytes = live * b * b * E.data.element_size() + vec
        r = {"level": i, "nb": nb, "K": K, "b": b, "live_blocks": live,
             "err": err, "bytes": nbytes, "ms": graph_ms(spmv),
             "cold_ms": graph_ms(spmv, flush_l2=True),
             "plain_ms": graph_ms(lambda: bell._spmv_einsum(E.data, E.cols, x)),
             "diag_ms": graph_ms(diag), "diag_cold_ms": graph_ms(diag,
                                                               flush_l2=True),
             "diag_plain_ms": graph_ms(lambda: bell._prec_einsum(binv, x))}
        yardsticks(r, host_csr(bell.bell_to_bsr(E), (n, n), dev), x, nbytes,
                   ops=2 * live * b * b)
        r["diag_bound_ms"], _ = bound(nb * b * b * binv.element_size() + vec,
                                      2 * nb * b * b)
        print(f"[kernel] {name}: A x {r['ms'] * 1e3:.1f} us L2-warm, "
              f"{r['cold_ms'] * 1e3:.1f} us L2-cold, bound "
              f"{r['bound_ms'] * 1e3:.1f} us ({r['bound_by']}, {live} live "
              f"blocks), einsum route {r['plain_ms'] * 1e3:.1f} us, cuSPARSE "
              f"{r['library_ms'] * 1e3:.1f} us; Binv x {r['diag_ms'] * 1e3:.1f} "
              f"us L2-warm, {r['diag_cold_ms'] * 1e3:.1f} us L2-cold, bound "
              f"{r['diag_bound_ms'] * 1e3:.1f} us, einsum route "
              f"{r['diag_plain_ms'] * 1e3:.1f} us (device time, graph replay)")
        out.append(r)
    return out


def phase_config4_device(dev, host_row: dict) -> dict:
    """Phase 19: config 4's preset, unchanged, at 324,864 rows: the
    default threshold sends it through the device SA route, every level
    built on the card (checked before Hierarchy.to).  The host route (phase
    18) bounds lambda_max(D^-1 A), which sets the prolongator smoothing's
    omega, by Gershgorin on levels of >= 65536 padded rows, as the
    reference's host route does; the device route power-iterates, as the
    reference's does.  So the check is against the host route built again
    with the power iteration on every level: equal level sizes.  Also:
    levels 0-1 equal phase 18's (they depend on A and B alone), the sizes
    equal CONFIG4_DEVICE_SIZES_PIN, and the iterations are within 3 of
    phase 18's (the reference's own fence, tests/unit/
    test_aggregation.py:124-151).  Its solve's block applies launch K8, as
    phase 18's; then K8 on every BlockELL level of the hierarchy
    (k8_levels).  Returns the row and the device-built hierarchy moved to
    the host (phase 27a shards it)."""
    from raptor_tpu_torch import PRESETS
    from raptor_tpu_torch.setup.host_aggregation import host_build_sa_hierarchy

    t0 = time.perf_counter()
    A, B = config_problem("config4", CONFIG_SIZES["config4"])
    _, sc = config_settings("config4")
    cfg = PRESETS["config4"]
    row, h = _config_row("config4 device", A, B, cfg, sc, dev, every_level=True)
    blocks = [lv.Abell is not None for lv in h.levels]
    row["block_levels"] = sum(blocks)
    t1 = time.perf_counter()
    power = host_build_sa_hierarchy(A, cfg, B=B, gershgorin_rows=math.inf)
    row["host_power_sizes"] = [lv.n for lv in power.levels]
    row["host_power_s"] = time.perf_counter() - t1
    del power
    row["wall_s"] = time.perf_counter() - t0
    print(f"[config4 device] {row['device_levels']} levels built on the card, "
          f"{row['block_levels']} with a BlockELL layout, peak device memory "
          f"{row['peak_mem_gib']:.3f} GiB; host route with the power iteration "
          f"on every level: sizes {row['host_power_sizes']} "
          f"({row['host_power_s']:.1f} s); host route (phase 18): sizes "
          f"{host_row['sizes']}, {host_row['iters']} iterations; phase 19: "
          f"{row['wall_s']:.1f} s")
    if row["device_levels"] != len(row["sizes"]):
        raise AssertionError("config 4's levels were not all built on the card")
    if (row["sizes"] != row["host_power_sizes"]
            or row["sizes"][:2] != host_row["sizes"][:2]):
        raise AssertionError(f"device SA sizes {row['sizes']}, host SA with "
                             f"the power iteration {row['host_power_sizes']}, "
                             f"host SA {host_row['sizes']}")
    if row["sizes"] != CONFIG4_DEVICE_SIZES_PIN:
        raise AssertionError(f"device SA sizes {row['sizes']}, pinned "
                             f"{CONFIG4_DEVICE_SIZES_PIN}")
    if abs(row["iters"] - host_row["iters"]) > 3:
        raise AssertionError(f"device SA {row['iters']} iterations, host SA "
                             f"{host_row['iters']}")
    if not row["relres"] <= MAX_RELRES:
        raise AssertionError(f"true relres {row['relres']} > {MAX_RELRES}")
    if row["launches"]["K8"] == 0:
        raise AssertionError("the device SA solve launched no K8")
    row["k8"] = k8_levels("config4 device", h, dev)
    if not row["k8"]:
        raise AssertionError("no BlockELL level")
    return row, h.to("cpu")


def phase_config3_full(dev) -> dict:
    """Phase 20: config 3's preset at full width, anisotropic_2d(768)
    (n = 589,824): level 0 aggressive on the card (distance-2 PMIS,
    multipass, Jacobi refinement, SpGEMM Galerkin product, filter), the
    rest on the host; beside it the host route.  Level sizes equal on both
    routes, refined-solve iterations within +-1, true relres <= 1e-8."""
    from raptor_tpu_torch import PRESETS
    from raptor_tpu_torch.gallery import anisotropic_2d

    t0 = time.perf_counter()
    A = anisotropic_2d(CONFIG3_FULL_N)
    _, sc = config_settings("config3")
    cfg = PRESETS["config3"]
    dev_row, _ = _config_row("config3 768 device", A, None, cfg, sc, dev)
    host_row, _ = _config_row(
        "config3 768 host", A, None,
        dataclasses.replace(cfg, host_setup_threshold=HOST_ROUTE_THRESHOLD),
        sc, dev)
    wall = time.perf_counter() - t0
    print(f"[config3 768] device route {dev_row['device_levels']} levels on "
          f"the card: sizes {dev_row['sizes']}, {dev_row['iters']} iterations; "
          f"host route: sizes {host_row['sizes']}, {host_row['iters']} "
          f"iterations; phase 20: {wall:.1f} s")
    if dev_row["device_levels"] < 1:
        raise AssertionError("no level of config 3 was built on the card")
    if dev_row["sizes"] != host_row["sizes"]:
        raise AssertionError(f"device route sizes {dev_row['sizes']}, host "
                             f"route {host_row['sizes']}")
    if abs(dev_row["iters"] - host_row["iters"]) > 1:
        raise AssertionError(f"device route {dev_row['iters']} iterations, "
                             f"host route {host_row['iters']}")
    for row in (dev_row, host_row):
        if not row["relres"] <= MAX_RELRES:
            raise AssertionError(f"true relres {row['relres']} > {MAX_RELRES}")
    return {"device": dev_row, "host": host_row, "wall_s": wall}


def _one_rank_gs(dev, h, A, smoother: str) -> dict:
    """dist_solve on one rank over NCCL on ``h`` with ``smoother``, on the
    launches counted since just before it: it must launch K4's halo form;
    its iterations, the single-device solve_hier's
    on the same hierarchy and the true fp64 relres in the caller's
    ordering."""
    import torch.distributed as dist

    from raptor_tpu_torch.api import solve_hier
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import Ring, dist_solve, distribute_hierarchy

    h = dataclasses.replace(h, config=dataclasses.replace(h.config,
                                                          smoother=smoother))
    n = A.shape[0]
    pm = h.perm[:n].cpu().numpy()
    b = default_rhs(n)
    bd = pad_vector(b[pm].astype(np.float32), h.levels[0].A.n_rows_pad, device=dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        dh = distribute_hierarchy(h, ring, ADIST_TAIL)
        snap = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x, info = dist_solve(dh, bd, ring, tol=ADIST_TOL, maxiter=200)
        torch.cuda.synchronize()
        sol = time.perf_counter() - t0
        launches, shapes_all = since(snap, BANDED_KERNELS)
        k4h = launches["K4-halo"]
        shapes = by_shape(f"mcgs96 1 rank {smoother}", shapes_all,
                          ("K4-halo", "K6-map_cols", "K4", "K6"))
        print(f"[proof] mcgs96 sharded {smoother}, 1 rank: {k4h} K4-halo "
              f"launches")
        if k4h == 0:
            raise AssertionError(f"the one-rank sharded {smoother} path did not "
                                 "run through K4's halo form")
        routes = adist_routes(f"mcgs96 {smoother}", dh)
    finally:
        dist.destroy_process_group()
    iters, certified = int(info.iterations), float(info.relres)
    relres = caller_relres(A, x.double().cpu().numpy(), pm, b)
    x1, info1 = solve_hier(h, bd, tol=ADIST_TOL, maxiter=200)
    it1 = int(info1.iterations)
    print(f"[mcgs96] dist_solve {smoother} on 1 rank (NCCL): {iters} PCG "
          f"iterations in {sol:.3f} s, certified {certified:.3e}, true fp64 "
          f"relres {relres:.3e}; single-device solve_hier {smoother}: {it1} "
          f"iterations")
    if not (certified <= ADIST_TOL and relres <= ADIST_MAX_TRUE):
        raise AssertionError(f"certified {certified} (max {ADIST_TOL}), "
                             f"true {relres} (max {ADIST_MAX_TRUE})")
    return {"iters": iters, "single_device_iters": it1, "certified": certified,
            "relres": relres, "solve_s": sol, "k4_halo_launches": k4h,
            "routes": routes, "launches_by_shape": shapes}


def phase_mcgs96(dev, krec) -> dict:
    """Phase 21: the mcgs path at full width, shuffled 96^3 with config 5's
    preset and fine_layout 'banded' (levels 0-1 built on the card by the
    device route and coloured on the host, in each level's RCM ordering):
    colours per level, V-cycle ms and a profile, the refined solve (true
    <= 1e-8) on the launches counted since just before it (K4, K5, K6
    each launched), the host route's iterations
    beside it; then dist_solve on one rank over NCCL with mcgs (+-1 of
    solve_hier on the same hierarchy) and with tsgs (its inner series is
    processor-local: printed beside the single-device tsgs count), each
    launching K4's halo form for every sharded A apply; after the proofs,
    every launch shape of these paths against its plain version (errors
    folded into the kernels' records ``krec``)."""
    from raptor_tpu_torch import PRESETS, SolveConfig, solve
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.solve.cycle import cycle

    t_phase = time.perf_counter()
    tag = "mcgs96"
    A = shuffled_poisson(ADIST_N)
    n = A.shape[0]
    cfg = dataclasses.replace(PRESETS["config5"], fine_layout="banded")
    h, rec = timed_setup(tag, A, cfg, dev)
    sizes = [lv.n for lv in h.levels]
    colours = [lv.ncolors for lv in h.levels]
    print(f"[{tag}] sizes {sizes}; colours per level {colours}; "
          f"{rec['device_levels']} levels built on the card")
    _print_levels(tag, h)
    if rec["device_levels"] < 2 or h.levels[0].Aband is None:
        raise AssertionError("mcgs96: levels 0-1 not built on the card, or "
                             "no banded layout")

    b = np.ones(n)
    bd = pad_vector(b.astype(np.float32), h.levels[0].A.n_rows_pad, device=dev)
    y = cycle(h, bd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        y = cycle(h, bd)
    torch.cuda.synchronize()
    vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
    if not torch.isfinite(y).all():
        raise AssertionError("mcgs V-cycle output not finite")
    prof = profile_cycles(lambda: cycle(h, bd), top=6)
    print(f"[{tag}] V-cycle {vc:.3f} ms ({n / vc * 1e3:.4g} DOF/s, {N_CYCLES} "
          f"cycles between syncs); profiled: wall {prof['wall_ms']:.3f} ms, "
          f"device busy {prof['busy_ms']:.3f} ms ({prof['busy_share'] * 100:.1f}%), "
          f"{prof['device_events']:g} device events a cycle; top "
          + "; ".join(f"{k} {us:.1f} us x{c:g}" for k, us, c in prof["top"]))

    sc = SolveConfig(tol=MAX_RELRES, refine=True)
    snap = counts()
    t0 = time.perf_counter()
    x, info = solve(A, b, cfg, sc, hier=h)
    sol = time.perf_counter() - t0
    launches, rows = banded_proof(tag, snap)
    iters = int(info["iterations"])
    relres = true_relres(A, x, b)
    print(f"[{tag}] api.solve {sol:.3f} s, {iters} PCG iterations, certified "
          f"{info['relres']:.3e}, true fp64 relres {relres:.3e}")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"true relres {relres} > {MAX_RELRES}")
    phase_banded_shapes(dev, "mcgs 96^3", h, A, krec, rows, "shapes_mcgs96")
    excess = banded_excess(tag, krec, rows, "shapes_mcgs96")
    host, _ = host_route(tag, A, cfg, dev, sizes, iters)
    gs = {sm: _one_rank_gs(dev, h, A, sm) for sm in ("mcgs", "tsgs")}
    if abs(gs["mcgs"]["iters"] - gs["mcgs"]["single_device_iters"]) > 1:
        raise AssertionError(f"sharded mcgs {gs['mcgs']['iters']} iterations, "
                             f"solve_hier {gs['mcgs']['single_device_iters']}")
    sharded_equal(dev, "mcgs 96^3 1 rank", h, 1, krec,
                  [s for g in gs.values() for s in g["launches_by_shape"]])
    wall = time.perf_counter() - t_phase
    print(f"[{tag}] phase 21: {wall:.1f} s")
    return {"n": n, "sizes": sizes, "colours": colours, "setup_s": rec["s"],
            "setup_parts": {k: rec[k] for k in SETUP_PARTS},
            "device_levels": rec["device_levels"],
            "peak_mem_gib": rec["peak_mem_gib"], "vcycle_ms": vc,
            "profile": prof, "solve_s": sol, "iters": iters,
            "certified": float(info["relres"]), "relres": relres,
            "launches": launches, "launches_by_shape": rows,
            "excess_ms": excess, "host_route": host, "one_rank": gs,
            "wall_s": wall}


def rank_mcgs(ring, device, path: str, b_rcm) -> dict:
    """One rank of phase 22 (runs in a spawned process): the hierarchy
    saved by the parent, sharded; dist_solve with mcgs on the launches
    counted since just before it; rank 0 returns the gathered x."""
    from raptor_tpu_torch.parallel import dist_solve, distribute_hierarchy

    h = torch.load(path, weights_only=False, map_location=device)
    b = torch.from_numpy(b_rcm).to(device)
    dh = distribute_hierarchy(h, ring, ADIST_TAIL)
    snap = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = dist_solve(dh, b, ring, tol=ADIST_TOL, maxiter=200)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches, shapes = since(snap, BANDED_KERNELS)
    xg = ring.all_gather(x)
    return {"iters": int(info.iterations), "certified": float(info.relres),
            "solve_s": solve_s,
            "counts": {k: launches[k] for k in ("K4-halo", "K6-map_cols")},
            "shapes": sorted([*key, c] for key, c in shapes.items()),
            "txf_sharded": any(lv.Pband is not None or lv.Rband is not None
                               for lv in dh.levels),
            "x": xg.cpu().numpy() if ring.axis_index == 0 else None}


def phase_mcgs_ranks(dev, krec) -> dict:
    """Phase 22: ADIST_RANKS ranks sharing the card over gloo at shuffled
    MCGS4_N^3 with config 5's preset, fine_layout 'banded' and pad_multiple
    ADIST_PAD (host-built: the sharded setup is not ported); each rank runs
    dist_solve with mcgs and must launch K4's halo form, and K6's map_cols
    form where a transfer shards; rank 0's gathered x passes the host fp64
    check, its iterations are the single-device solve_hier's on the same
    hierarchy +- 1; then every rank's launch shapes against their plain
    versions on the parent's hierarchy (errors folded into ``krec``)."""
    import tempfile

    from raptor_tpu_torch import PRESETS, setup
    from raptor_tpu_torch.api import solve_hier
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    A = shuffled_poisson(MCGS4_N)
    n = A.shape[0]
    cfg = dataclasses.replace(PRESETS["config5"], fine_layout="banded",
                              pad_multiple=ADIST_PAD)
    h = setup(A, cfg, device=dev)
    pm = h.perm[:n].cpu().numpy()
    b = default_rhs(n)
    b_rcm = np.zeros(h.levels[0].A.n_rows_pad, np.float32)
    b_rcm[:n] = b[pm]
    _, info1 = solve_hier(h, torch.from_numpy(b_rcm).to(dev), tol=ADIST_TOL,
                          maxiter=200)
    it1 = int(info1.iterations)
    h_cpu = h.to("cpu")
    with tempfile.TemporaryDirectory(prefix="raptor_mcgs_") as tmp:
        path = f"{tmp}/hier.pt"
        torch.save(h_cpu, path)
        t0 = time.perf_counter()
        outs = spawn(rank_mcgs, ADIST_RANKS, "gloo", dev, path, b_rcm,
                     timeout=900.0)
        wall_ranks = time.perf_counter() - t0
    for r, o in enumerate(outs):
        c = o["counts"]
        print(f"[mcgs{ADIST_RANKS}] rank {r}: {o['iters']} iterations, solve "
              f"{o['solve_s']:.3f} s; launches {c}; a transfer shards: "
              f"{o['txf_sharded']}")
        if c["K4-halo"] == 0:
            raise AssertionError(f"rank {r} did not run through K4's halo form")
        if (c["K6-map_cols"] > 0) != o["txf_sharded"]:
            raise AssertionError(f"rank {r}: its sharded transfers did not run "
                                 "through K6's map_cols form")
    iters = outs[0]["iters"]
    if any(o["iters"] != iters for o in outs):
        raise AssertionError("the ranks disagree on the iteration count")
    x = outs[0]["x"].astype(np.float64)
    relres = caller_relres(A, x, pm, b)
    wall = time.perf_counter() - t_phase
    print(f"[mcgs{ADIST_RANKS}] {MCGS4_N}^3 mcgs on {ADIST_RANKS} ranks sharing "
          f"the card (gloo): {iters} iterations (single-device solve_hier "
          f"{it1}), certified {outs[0]['certified']:.3e}, true fp64 relres "
          f"{relres:.3e}; ranks {wall_ranks:.1f} s with their start; phase 22: "
          f"{wall:.1f} s")
    by_shape(f"mcgs {ADIST_RANKS} ranks, rank 0",
             {tuple(s[:-1]): s[-1] for s in outs[0]["shapes"]},
             ("K4-halo", "K6-map_cols", "K4", "K6"))
    # the ranks' shapes, on the parent's copy of the hierarchy
    sharded_equal(dev, f"mcgs {MCGS4_N}^3 {ADIST_RANKS} ranks", h, ADIST_RANKS,
                  krec, [s for o in outs for s in o["shapes"]])
    del h
    if x.shape != (h_cpu.levels[0].A.n_rows_pad,) or not np.isfinite(x).all():
        raise AssertionError("gathered solution not finite or misshapen")
    if not relres <= ADIST_MAX_TRUE:
        raise AssertionError(f"true relres {relres} > {ADIST_MAX_TRUE}")
    if abs(iters - it1) > 1:
        raise AssertionError(f"{iters} iterations, single-device {it1}")
    return {"n": n, "ranks": ADIST_RANKS, "iters": iters,
            "single_device_iters": it1, "relres": relres,
            "launches": [o["counts"] for o in outs],
            "launches_by_shape": outs[0]["shapes"], "wall_s": wall}


# ---------------------------------------------------------------------------
# phases 23-25: CLJP, full coarsening, the user surface
# ---------------------------------------------------------------------------

def cljp_bits_digests(dev) -> dict:
    """The CLJP bit positions drawn on the card for n = CLJP_BITS_N at the
    pinned rounds, against the reference's digests."""
    import hashlib

    from raptor_tpu_torch.utils.threefry import cljp_bits

    out = {}
    for it, want in CLJP_BITS_SHA256.items():
        bits = cljp_bits(it, CLJP_BITS_N, device=dev)
        if bits.device != dev:
            raise AssertionError("the CLJP bits were not drawn on the card")
        got = hashlib.sha256(bits.cpu().numpy().astype("<i4").tobytes()).hexdigest()
        print(f"[cljp] threefry bits n={CLJP_BITS_N} round {it}: sha256 {got}")
        if got != want:
            raise AssertionError(f"CLJP bits of round {it}: {got}, the "
                                 f"reference's {want}")
        out[it] = got
    return out


def cljp_invariant(dev, h, cfg) -> int:
    """Level 0's C/F set drawn again on the card as build_hierarchy draws
    it (the strength graph of the RCM-ordered operator, weights keyed on
    the original row ids), checked on the host: every F point with a
    strong influence has a C influence, and the C count is level 1's size.
    Returns the C count."""
    from raptor_tpu_torch.setup.cljp import cljp_splitting
    from raptor_tpu_torch.setup.splitting import C_PT, make_perm_ids
    from raptor_tpu_torch.setup.strength import strength_mask

    E = h.levels[0].A
    n = E.shape[0]
    sm = strength_mask(E, cfg.theta, cfg.strength)
    perm = make_perm_ids(h.perm[:n].cpu().numpy(), E.n_rows_pad, cfg.seed,
                         device=dev)
    cf = cljp_splitting(E, sm, perm)
    if cf.device != dev:
        raise AssertionError("the C/F set was not drawn on the card")
    cf, smh, cols = cf.cpu().numpy(), sm.cpu().numpy(), E.cols.cpu().numpy()
    is_c = cf == C_PT
    strong_c = (smh & is_c[cols]).any(0)
    bad = np.flatnonzero(~is_c[:n] & smh[:, :n].any(0) & ~strong_c[:n])
    nc = int(is_c[:n].sum())
    print(f"[cljp] level 0 C/F set on the card: {nc} C points, {len(bad)} F "
          "points with a strong influence and no C influence")
    if len(bad) or nc != h.levels[1].n:
        raise AssertionError(f"CLJP invariant: {len(bad)} F points without a "
                             f"C influence, {nc} C points against level 1's "
                             f"{h.levels[1].n}")
    return nc


def phase_cljp(dev, krec, nx: int) -> tuple:
    """Phase 23: CLJP on shuffled nx^3 through api.setup and api.solve on
    the card: every level built there (checked before Hierarchy.to), the
    C/F invariant of level 0, V-cycles, the refined solve on the launches
    counted since just before it (K4, K5 and K6 each launched), then every
    launch shape against its plain version.
    At CLJP_N the sizes and iterations are the reference's."""
    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.solve.cycle import cycle

    t_phase = time.perf_counter()
    tag = f"cljp{nx}"
    A = shuffled_poisson(nx)
    n = A.shape[0]
    cfg = AmgConfig(**CLJP_CFG)
    h, rec = timed_setup(tag, A, cfg, dev, every_level=True)
    sizes = [lv.n for lv in h.levels]
    print(f"[{tag}] sizes {sizes}; {rec['device_levels']} of {len(sizes)} "
          "levels built on the card")
    _print_levels(tag, h)
    if rec["device_levels"] != len(sizes) or h.levels[0].Aband is None:
        raise AssertionError(f"{tag}: not every level built on the card, or "
                             "no banded layout")
    if nx == CLJP_N and sizes != CLJP_SIZES:
        raise AssertionError(f"{tag}: sizes {sizes}, the reference's {CLJP_SIZES}")
    nc = cljp_invariant(dev, h, cfg)

    b = np.ones(n)
    bd = pad_vector(b.astype(np.float32), h.levels[0].A.n_rows_pad, device=dev)
    y = cycle(h, bd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        y = cycle(h, bd)
    torch.cuda.synchronize()
    vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
    if not torch.isfinite(y).all():
        raise AssertionError(f"{tag}: V-cycle output not finite")

    sc = SolveConfig(tol=MAX_RELRES, refine=True)
    snap = counts()
    t0 = time.perf_counter()
    x, info = solve(A, b, cfg, sc, hier=h)
    torch.cuda.synchronize()
    sol = time.perf_counter() - t0
    launches, rows = banded_proof(tag, snap)
    iters = int(info["iterations"])
    relres = true_relres(A, x, b)
    print(f"[{tag}] setup {rec['s']:.3f} s, V-cycle {vc:.3f} ms ({n / vc * 1e3:.4g} "
          f"DOF/s, {N_CYCLES} cycles between syncs), api.solve {sol:.3f} s, "
          f"{iters} PCG iterations, certified {info['relres']:.3e}, true fp64 "
          f"relres {relres:.3e}")
    if x.shape != (n,) or not np.isfinite(x).all():
        raise AssertionError(f"{tag}: solution not finite or misshapen")
    if not relres <= MAX_RELRES:
        raise AssertionError(f"{tag}: true relres {relres} > {MAX_RELRES}")
    if nx == CLJP_N and abs(iters - CLJP_ITERS) > 1:
        raise AssertionError(f"{tag}: {iters} iterations, the reference's "
                             f"{CLJP_ITERS}")
    key = f"shapes_{tag}"
    phase_banded_shapes(dev, f"cljp {nx}^3", h, A, krec, rows, key)
    excess = banded_excess(tag, krec, rows, key)
    # K4 at the widest banded level
    wide = max((lv for lv in h.levels if lv.Aband is not None),
               key=lambda lv: lv.Aband.meta[0])
    wk = wide.Aband.meta[0]
    k4_wide = krec["K4"][key][(wide.Aband.n_pad, wk)]
    print(f"[{tag}] K4 at the widest banded level (n={wide.n}, K {wk}): "
          f"{k4_wide[0] * 1e3:.1f} us L2-warm, bound {k4_wide[2] * 1e3:.1f} us")
    wall = time.perf_counter() - t_phase
    print(f"[{tag}] phase 23 at {nx}^3: {wall:.1f} s")
    return {"n": n, "sizes": sizes, "c_points_l0": nc, "setup_s": rec["s"],
            "device_levels": rec["device_levels"],
            "peak_mem_gib": rec["peak_mem_gib"], "vcycle_ms": vc,
            "solve_s": sol, "iters": iters, "relres": relres,
            "certified": float(info["relres"]), "launches": launches,
            "launches_by_shape": rows, "excess_ms": excess,
            "k4_widest": {"K": wk, "n": wide.n, "warm_ms": k4_wide[0],
                          "bound_ms": k4_wide[2]},
            "wall_s": wall}, h, x


def phase_full(dev, krec, nx: int) -> dict:
    """Phase 24: the structured main path with full coarsening at nx^3
    (CFG, dim_policy 'size', bf16 cast_hierarchy, structured_solve_refined)
    on the launches counted since just before it: the reference's plan, K1,
    K2 and K7 each launched; then K1 (fp32 and bf16), K2 and K7 bit for
    bit at every launch shape of the path."""
    from raptor_tpu_torch import (AmgConfig, build_structured_hierarchy,
                                  cast_hierarchy, dia_from_stencil, scycle,
                                  structured_solve_refined)
    from raptor_tpu_torch.gallery import default_rhs, stencil_grid
    from raptor_tpu_torch.ops.cuda.dia_kernel import (dia_spmv_const,
                                                      dia_spmv_const_ref,
                                                      dia_spmv_v2,
                                                      dia_spmv_v2_ref)

    t_phase = time.perf_counter()
    tag = f"full{nx}"
    st = stencil_7pt()
    dims = (nx,) * 3
    n = nx ** 3
    cfg = AmgConfig(**FC_CFG)
    A = dia_from_stencil(st, dims, device=dev)
    b = torch.from_numpy(default_rhs(n, dtype=np.float32)).to(dev)
    snap = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = build_structured_hierarchy(A, cfg, dim_policy="size")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plan = tuple(lv.cdim for lv in h.levels[:-1])
    print(f"[{tag}] setup {setup_s:.3f} s, plan {plan}, {len(h.levels)} levels, "
          f"dense tail from L{h.tail_start}")
    for lv in h.levels:
        print(f"[{tag}]   dims {lv.dims} n_off {lv.A.n_off} cdim {lv.cdim}"
              + ("" if lv.Pt is None else f" Pt/Rt offsets {len(lv.Pt.offsets)}"))
    if plan != tuple(FC_PLANS[nx]):
        raise AssertionError(f"{tag}: plan {plan}, the reference's {FC_PLANS[nx]}")
    hM = cast_hierarchy(h, torch.bfloat16)
    y = scycle(hM, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        y = scycle(hM, b)
    torch.cuda.synchronize()
    vc = (time.perf_counter() - t0) / N_CYCLES * 1e3
    if not torch.isfinite(y).all():
        raise AssertionError(f"{tag}: V-cycle output not finite")
    structured_solve_refined(h, b, tol=MAX_RELRES, M_hier=hM)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (xh, xl), rel, iters = structured_solve_refined(h, b, tol=MAX_RELRES,
                                                    M_hier=hM)
    torch.cuda.synchronize()
    sol = time.perf_counter() - t0
    launches, shapes = since(snap)
    k1, k2, k7 = launches["K1"], launches["K2"], launches["K7"]
    rows = by_shape(tag, shapes, ("K1", "K2", "K7"))
    print(f"[proof] {tag} path: {k1} K1 launches, {k2} K2 launches, {k7} K7 "
          f"launches")
    if k1 == 0 or k2 == 0 or k7 == 0:
        raise AssertionError(f"the {tag} path did not run through the kernels")
    x64 = xh.double().cpu().numpy() + xl.double().cpu().numpy()
    b64 = b.double().cpu().numpy()
    relres = float(np.linalg.norm(b64 - stencil_grid(st, dims) @ x64)
                   / np.linalg.norm(b64))
    print(f"[{tag}] V-cycle bf16 {vc:.3f} ms ({n / vc * 1e3:.4g} DOF/s), refined "
          f"solve {sol:.3f} s, {int(iters)} PCG iterations, certified "
          f"{float(rel):.3e}, true fp64 relres {relres:.3e}")
    if not np.isfinite(x64).all() or not relres <= MAX_RELRES:
        raise AssertionError(f"{tag}: true relres {relres} > {MAX_RELRES}")
    if nx == FC_ITERS_N and abs(int(iters) - FC_ITERS) > 1:
        raise AssertionError(f"{tag}: {int(iters)} iterations, the reference's "
                             f"{FC_ITERS}")
    # every launch shape of the path against its plain version, each timed
    # (L2-warm) beside its bound: planes (none for K2) + x + y, 2
    # operations an offset a row
    gen = torch.Generator(device=dev).manual_seed(11)
    timed = {}
    for hh in (h, hM):
        for lv in hh.levels:
            for M in (lv.A, lv.Pt, lv.Rt):
                if M is None:
                    continue
                x = torch.randn(M.n, generator=gen, device=dev)
                n_off = len(M.offsets)
                if M.const_planes is not None:
                    key = ("K2", M.n, n_off, "float32")
                    args = (M.const_planes, M.offsets, M.dims, x)
                    fn, ref, moved = dia_spmv_const, dia_spmv_const_ref, 8 * M.n
                else:
                    dt = str(M.data.dtype).removeprefix("torch.")
                    key = ("K1", M.n, n_off, dt)
                    args = (M.data, M.linear_offsets(), x)
                    fn, ref = dia_spmv_v2, dia_spmv_v2_ref
                    moved = M.data.numel() * M.data.element_size() + 8 * M.n
                if key in timed:
                    continue
                k = key[0]
                krec[k]["err"] = max(krec[k]["err"], _equal(
                    f"{k} {tag} {M.dims} {n_off} offsets {key[3]}",
                    fn(*args), ref(*args)))
                warm = graph_ms(lambda: fn(*args))
                bms, by = bound(moved, 2 * n_off * M.n)
                timed[key] = (warm, bms)
                print(f"[kernel] {k} {tag} n={M.n} {n_off} offsets {key[3]}: "
                      f"{warm * 1e3:.2f} us L2-warm, bound {bms * 1e3:.2f} us "
                      f"({by}) (device time, graph replay)")
    # K7 on the fine level, the refined solve's residual
    A0 = h.levels[0].A
    r7 = _k7_case(f"K7 {tag} {A0.dims} {A0.n_off} offsets", A0, gen)
    krec["K7"]["err"] = max(krec["K7"]["err"], r7["err"])
    timed[("K7", A0.n, A0.n_off, "float32")] = (r7["ms"], r7["bound_ms"])
    covered(tag, rows, set(timed))
    excess = {k: sum(c * (timed[(k, n, w, dt)][0] - timed[(k, n, w, dt)][1])
                     for k2, n, w, dt, c in rows if k2 == k)
              for k in ("K1", "K2", "K7")}
    print(f"[kernel] {tag}: sum over the path's shapes of launches x (L2-warm "
          f"- bound): K1 {excess['K1']:.4f} ms, K2 {excess['K2']:.4f} ms, K7 "
          f"{excess['K7']:.4f} ms")
    wall = time.perf_counter() - t_phase
    print(f"[{tag}] phase 24 at {nx}^3: {wall:.1f} s")
    return {"n": n, "plan": list(plan), "levels": len(h.levels),
            "setup_s": setup_s, "vcycle_bf16_ms": vc, "solve_s": sol,
            "iters": int(iters), "relres": relres,
            "launches": {"K1": k1, "K2": k2, "K7": k7},
            "launches_by_shape": rows,
            "shapes": {" ".join(map(str, key)): v for key, v in timed.items()},
            "excess_ms": excess, "wall_s": wall}


def _cli(argv: list) -> dict:
    """raptor_tpu_torch.cli.main(argv) in this process: its JSON line."""
    import io

    from raptor_tpu_torch.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli_main(argv)
    line = buf.getvalue().strip().splitlines()[-1]
    print(f"[cli] {' '.join(argv)}: {line[:400]}")
    return json.loads(line)


def cli_config5() -> dict:
    """``bench --preset config5 --n SDIST_N`` through cli.main, as a user
    runs it: on one card the single-device structured route (K2 on the
    fine level, counted here), on several the CLI's multi-card branch (one
    NCCL rank a card, every card when SDIST_N divides over them); its JSON
    must name the device count that rule gives."""
    from raptor_tpu_torch.cli import config5_ranks

    ndev = config5_ranks(SDIST_N, torch.cuda.device_count())
    snap = counts()
    r = _cli(["bench", "--preset", "config5", "--n", str(SDIST_N)])
    k2 = since(snap)[1][("K2", SDIST_N ** 3, 7, "float32")]
    print(f"[cli] bench config5: {ndev} device(s), K2 {k2} launches on the "
          f"{SDIST_N}^3 fine level in this process")
    want = f"poisson3d n={SDIST_N} (structured, {ndev} device(s))"
    if (not r["relres"] <= SDIST_TOL or r["problem"] != want
            or (ndev == 1 and k2 == 0)):
        raise AssertionError(f"bench config5: {r}, K2 {k2} launches; "
                             f"expected {want!r}")
    return dict(r, k2_launches=k2, devices=ndev)


def phase_surface(dev, h_cljp, x_cljp, iters_cljp) -> dict:
    """Phase 25: the user surface.  ``python -m raptor_tpu_torch info`` in
    a subprocess; shuffled SURFACE_N^3 written as .rbm and .mtx.gz and read
    back;
    the CLI's banded CLJP solve of the .rbm (K4 launched, the written x
    checked by a host fp64 residual), bench config2 and bench config5
    (``cli_config5``: on one card the single-device structured route, K2 on
    the fine level; on several the multi-card branch); phase 23's
    hierarchy saved, loaded on the card and solved again (the same
    iterations, x bit-equal)."""
    import os
    import sys

    from raptor_tpu_torch import AmgConfig, SolveConfig, solve
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.utils.checkpoint import load_hierarchy, save_hierarchy
    from raptor_tpu_torch.utils.io import read_matrix, read_vector, write_matrix

    t_phase = time.perf_counter()
    out = {}
    proc = subprocess.run([sys.executable, "-m", "raptor_tpu_torch", "info"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python -m raptor_tpu_torch info: {proc.stderr}")
    info = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[cli] python -m raptor_tpu_torch info: {info}")
    if (info["backend"] != "cuda"
            or torch.cuda.get_device_name(0) not in info["devices"]):
        raise AssertionError("the CLI's info does not name the card")
    out["info"] = info

    os.makedirs(SMOKE_DIR, exist_ok=True)
    A = shuffled_poisson(SURFACE_N)
    t0 = time.perf_counter()
    for ext in ("rbm", "mtx.gz"):
        path = os.path.join(SMOKE_DIR, f"A{SURFACE_N}.{ext}")
        write_matrix(path, A)
        B = read_matrix(path)
        if B.shape != A.shape or (B != A).nnz:
            raise AssertionError(f"{path} did not read back equal")
    out["io_s"] = time.perf_counter() - t0
    print(f"[io] shuffled {SURFACE_N}^3 written and read back as .rbm and .mtx.gz: "
          f"{out['io_s']:.1f} s")

    xpath = os.path.join(SMOKE_DIR, "x.npy")
    snap = counts()
    r = _cli(["solve", "--matrix", os.path.join(SMOKE_DIR, f"A{SURFACE_N}.rbm"),
              "--layout", "banded", "--splitting", "cljp", "--out", xpath])
    k4 = since(snap)[0]["K4"]
    x = read_vector(xpath)
    b = default_rhs(A.shape[0])
    relres = float(np.linalg.norm(b - A @ x) / np.linalg.norm(b))
    print(f"[cli] banded CLJP solve: {r['iterations']} iterations, K4 "
          f"{k4} launches, the written x's true fp64 relres {relres:.3e}")
    if k4 == 0 or not relres <= MAX_RELRES:
        raise AssertionError(f"CLI solve: K4 {k4} launches, relres {relres}")
    out["solve"] = dict(r, k4_launches=k4, true_relres=relres)

    r = _cli(["bench", "--preset", "config2"])
    if not r["relres"] <= 1e-6:
        raise AssertionError(f"bench config2: relres {r['relres']}")
    out["config2"] = r
    out["config5"] = cli_config5()

    path = os.path.join(SMOKE_DIR, f"cljp{CLJP_N}")
    t0 = time.perf_counter()
    save_hierarchy(path, h_cljp)
    h2 = load_hierarchy(path, dev)
    ck_s = time.perf_counter() - t0
    A = shuffled_poisson(CLJP_N)
    b1 = np.ones(A.shape[0])
    cfg = AmgConfig(**CLJP_CFG)
    x2, info2 = solve(A, b1, cfg, SolveConfig(tol=MAX_RELRES, refine=True),
                      hier=h2)
    same = bool(np.array_equal(x2, x_cljp))
    print(f"[ckpt] phase 23's hierarchy saved and loaded on the card in "
          f"{ck_s:.2f} s ({os.path.getsize(path + '.pt') / 2**20:.1f} MiB): "
          f"{info2['iterations']} iterations (phase 23: {iters_cljp}), x "
          f"bit-equal: {same}")
    if info2["iterations"] != iters_cljp or not same:
        raise AssertionError("the loaded hierarchy does not solve as the saved one")
    out["checkpoint"] = {"s": ck_s, "iters": info2["iterations"]}
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[cli] phase 25: {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the sharded algebraic setup (parallel/dist_setup.py)
# ---------------------------------------------------------------------------

def dist_sizes(dh) -> list:
    """A dist-built hierarchy's sharded level sizes and the real coarse size
    below them.  (The tail is built on the block-padded coarse operator,
    whose size counts every rank's padding rows.)"""
    P = dh.bridge_P
    coarse = torch.unique(P.cols[P.slot_mask()]).numel()
    return [lv.n for lv in dh.levels] + [int(coarse)]


def _dm_tensors(dm) -> list:
    if dm is None:
        return []
    return [dm.data, dm.cols, dm.row_nnz, *dm.halo.send_idx, *dm.halo.recv_tgt]


def check_on_card(tag: str, dh, dev) -> None:
    """Raise unless every tensor of the sharded levels (A and its halo
    plan, dinv, P, R, colours, lambda_max, the block inverses), of the
    bridge and of the tail's operators lies on the card ``dev``."""
    dev = torch.device(dev)

    def on_card(ts):
        return all(isinstance(t, torch.Tensor) and t.device == dev for t in ts)

    for k, lv in enumerate(dh.levels):
        ts = (_dm_tensors(lv.A) + _dm_tensors(lv.Pmat) + _dm_tensors(lv.Rmat)
              + [t for t in (lv.dinv, lv.color, lv.cheb_lmax, lv.binv)
                 if t is not None])
        if not on_card(ts):
            raise AssertionError(f"[{tag}] sharded level {k} holds tensors "
                                 f"off {dev}")
    if not on_card([dh.bridge_P.data, dh.bridge_R.data,
                    *(lv.A.data for lv in dh.tail.levels)]):
        raise AssertionError(f"[{tag}] the bridge or the tail is off {dev}")


def timed_dist_build(A, cfg, ring, dtype, dev, B=None) -> tuple:
    """(dist_build_hierarchy, or dist_build_sa_hierarchy with candidates
    ``B`` for smoothed aggregation, on ``dev``; seconds; peak device
    GiB)."""
    from raptor_tpu_torch.parallel import (dist_build_hierarchy,
                                           dist_build_sa_hierarchy)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg.splitting == "aggregation":
        dh = dist_build_sa_hierarchy(A, cfg, ring, B, DSETUP_TAIL, dtype,
                                     device=dev)
    else:
        dh = dist_build_hierarchy(A, cfg, ring, DSETUP_TAIL, dtype, device=dev)
    torch.cuda.synchronize()
    return (dh, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() / 2**30)


def dist_solve_checked(tag: str, A, dh, ring, dtype) -> tuple:
    """dist_solve (cg, DSETUP_TOL) of b = default_rhs on ``dh``: (its
    iterations, the true fp64 relres of the gathered x against A, the
    solve's seconds).  Raises on a non-finite x, a certified (recurrence)
    relres above DSETUP_TOL or a true one above DSETUP_MAX_TRUE."""
    from raptor_tpu_torch.core.ell import pad_vector
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import dist_solve

    n = A.shape[0]
    b = default_rhs(n)
    n_pad = dh.levels[0].n_local * ring.axis_size
    bd = pad_vector(b, n_pad, dtype=dtype, device=dh.levels[0].dinv.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, info = dist_solve(dh, bd, ring, tol=DSETUP_TOL, maxiter=300)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    xg = ring.all_gather(x).double().cpu().numpy()
    if xg.shape != (n_pad,) or not np.isfinite(xg).all():
        raise AssertionError(f"[{tag}] sharded solution not finite or misshapen")
    relres = true_relres(A, xg[:n], b)
    if not relres <= DSETUP_MAX_TRUE:
        raise AssertionError(f"[{tag}] true relres {relres} > {DSETUP_MAX_TRUE}")
    if not float(info.relres) <= DSETUP_TOL:
        raise AssertionError(f"[{tag}] certified relres {float(info.relres)} "
                             f"> {DSETUP_TOL}")
    return int(info.iterations), relres, solve_s


def single_device_sizes(A, cfg, dev) -> tuple:
    """(sizes, seconds) of the single-device build with every level on the
    card (host_setup_threshold 0) in fp64."""
    from raptor_tpu_torch.setup.hierarchy import build_hierarchy

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h = build_hierarchy(A, dataclasses.replace(cfg, host_setup_threshold=0),
                        dtype=np.float64, device=dev)
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    sizes = [lv.n for lv in h.levels]
    del h
    torch.cuda.empty_cache()
    return sizes, s


def same_sizes(tag: str, got: list, ref: list) -> None:
    if got != ref[:len(got)]:
        raise AssertionError(f"[{tag}] dist-built sizes {got}, the single-"
                             f"device build's {ref}")


def phase_dist_setup_one_rank(dev) -> dict:
    """Phases 26a and 26c on one rank over NCCL: shuffled DSETUP_N^3 built
    by dist_build_hierarchy in fp32, cold and warm, every tensor checked on
    the card; dist_solve against the single-device build of the same
    configuration sharded by distribute_hierarchy on the same ring (+-1
    iteration); the fp64 sizes against the single-device device route's
    (threshold 0); then the ext+i, CLJP and config 3 branches, each at its
    own input, by the same checks."""
    import torch.distributed as dist

    from raptor_tpu_torch import AmgConfig, PRESETS, setup
    from raptor_tpu_torch.gallery import anisotropic_2d
    from raptor_tpu_torch.parallel import Ring, distribute_hierarchy

    t_phase = time.perf_counter()
    A = shuffled_poisson(DSETUP_N)
    cfg = AmgConfig(**DSETUP_CFG)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        builds = []
        for _ in ("cold", "warm"):
            dh, s, peak = timed_dist_build(A, cfg, ring, torch.float32, dev)
            builds.append((s, peak))
        check_on_card("dsetup1", dh, dev)
        sizes32 = dist_sizes(dh)
        tail32 = [lv.n for lv in dh.tail.levels]
        iters, relres, solve_s = dist_solve_checked("dsetup1", A, dh, ring,
                                                    np.float32)
        del dh
        torch.cuda.empty_cache()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h1 = setup(A, cfg, device=dev)
        torch.cuda.synchronize()
        single_s = time.perf_counter() - t0
        dh1 = distribute_hierarchy(h1, ring, DSETUP_TAIL)
        it1, rel1, _ = dist_solve_checked("dsetup1 single", A, dh1, ring,
                                          np.float32)
        del h1, dh1
        torch.cuda.empty_cache()

        dh64, s64, peak64 = timed_dist_build(A, cfg, ring, torch.float64, dev)
        sizes64 = dist_sizes(dh64)
        del dh64
        torch.cuda.empty_cache()
        ref64, ref_s = single_device_sizes(A, cfg, dev)
        print(f"[dsetup1] shuffled {DSETUP_N}^3 ({A.shape[0]} rows) on 1 rank "
              f"(NCCL), {DSETUP_CFG}, ELL, fp32: dist_build_hierarchy "
              f"{builds[0][0]:.3f} s cold, {builds[1][0]:.3f} s warm, peak "
              f"device memory {builds[0][1]:.3f} / {builds[1][1]:.3f} GiB; "
              f"single-device api.setup (levels above the default threshold "
              f"on the card) {single_s:.3f} s; fp64 dist build {s64:.3f} s "
              f"(peak {peak64:.3f} GiB), fp64 single-device device route "
              f"(threshold 0) {ref_s:.3f} s")
        print(f"[dsetup1] sizes fp64 {sizes64} (single-device fp64 {ref64}); "
              f"fp32 {sizes32}, tail {tail32}; dist_solve {iters} iterations "
              f"in {solve_s:.3f} s, true fp64 relres {relres:.3e}; the single-"
              f"device build through distribute_hierarchy {it1} iterations "
              f"(true {rel1:.3e})")
        same_sizes("dsetup1", sizes64, ref64)
        if abs(iters - it1) > 1:
            raise AssertionError(f"[dsetup1] {iters} iterations, the single-"
                                 f"device build {it1}")
        one = {"n": A.shape[0], "setup_cold_s": builds[0][0],
               "setup_warm_s": builds[1][0], "peak_mem_gib": builds[0][1],
               "single_device_setup_s": single_s, "sizes64": sizes64,
               "single_sizes64": ref64, "sizes32": sizes32, "tail32": tail32,
               "iters": iters, "relres": relres, "solve_s": solve_s,
               "single_iters": it1, "setup64_s": s64,
               "single64_s": ref_s}

        branches = {}
        for name, M, bcfg in (
                ("ext+i", A, AmgConfig(**DEVSETUP_CFG)),
                ("cljp", shuffled_poisson(CLJP_N),
                 AmgConfig(**dict(DSETUP_CFG, splitting="cljp"))),
                ("config3", anisotropic_2d(CONFIG3_FULL_N), PRESETS["config3"])):
            tag = f"dsetup1 {name}"
            dh, s, peak = timed_dist_build(M, bcfg, ring, torch.float64, dev)
            check_on_card(tag, dh, dev)
            sizes = dist_sizes(dh)
            it, rel, _ = dist_solve_checked(tag, M, dh, ring, np.float64)
            del dh
            torch.cuda.empty_cache()
            ref, ref_s = single_device_sizes(M, bcfg, dev)
            print(f"[{tag}] n={M.shape[0]}: fp64 dist build {s:.3f} s (peak "
                  f"{peak:.3f} GiB), sizes {sizes}; single-device device "
                  f"route {ref_s:.3f} s, sizes {ref}; dist_solve {it} "
                  f"iterations, true relres {rel:.3e}")
            same_sizes(tag, sizes, ref)
            branches[name] = {"n": M.shape[0], "setup_s": s, "sizes": sizes,
                              "single_sizes": ref, "single_s": ref_s,
                              "iters": it, "relres": rel}
        one["branches"] = branches
    finally:
        dist.destroy_process_group()
    one["phase_s"] = time.perf_counter() - t_phase
    print(f"[dsetup1] phases 26a and 26c: {one['phase_s']:.1f} s")
    return one


def rank_dist_setup(ring, device, n: int) -> dict:
    """One rank of phase 26b (runs in a spawned process): shuffled n^3 by
    dist_build_hierarchy in fp64 (sizes) and fp32 (timed, checked on the
    card, solved); rank 0 returns the gathered x."""
    from raptor_tpu_torch import AmgConfig

    A = shuffled_poisson(n)
    cfg = AmgConfig(**DSETUP_CFG)
    dh64, s64, _ = timed_dist_build(A, cfg, ring, torch.float64, device)
    sizes64 = dist_sizes(dh64)
    del dh64
    torch.cuda.empty_cache()
    dh, s, peak = timed_dist_build(A, cfg, ring, torch.float32, device)
    check_on_card(f"dsetup{ring.axis_size} rank {ring.axis_index}", dh,
                  device)
    iters, relres, solve_s = dist_solve_checked(
        f"dsetup{ring.axis_size}", A, dh, ring, np.float32)
    return {"sizes64": sizes64, "sizes32": dist_sizes(dh), "setup_s": s,
            "setup64_s": s64, "peak_mem_gib": peak, "iters": iters,
            "relres": relres, "solve_s": solve_s}


def phase_dist_setup_ranks(dev, one: dict) -> dict:
    """Phase 26b: DSETUP_RANKS ranks sharing the card over gloo (host-
    staged messages), each building its shards of shuffled DSETUP_N^3;
    fp64 sizes equal to 26a's, iterations within one of 26a's, the
    gathered x checked on every rank by the host fp64 residual."""
    from raptor_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    outs = spawn(rank_dist_setup, DSETUP_RANKS, "gloo", dev, DSETUP_N,
                 timeout=900.0)
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        print(f"[dsetup{DSETUP_RANKS}] rank {r}: fp32 dist_build_hierarchy "
              f"{o['setup_s']:.3f} s (peak {o['peak_mem_gib']:.3f} GiB), fp64 "
              f"{o['setup64_s']:.3f} s; {o['iters']} iterations in "
              f"{o['solve_s']:.3f} s, true relres {o['relres']:.3e}")
    o = outs[0]
    print(f"[dsetup{DSETUP_RANKS}] {DSETUP_N}^3 on {DSETUP_RANKS} ranks sharing "
          f"the card (gloo): sizes fp64 {o['sizes64']} (one rank: "
          f"{one['sizes64']}), fp32 {o['sizes32']}; {o['iters']} iterations "
          f"(one rank: {one['iters']}); {wall:.1f} s with the processes' start")
    if any(p["sizes64"] != one["sizes64"] for p in outs):
        raise AssertionError(f"[dsetup{DSETUP_RANKS}] fp64 sizes differ from "
                             f"one rank's {one['sizes64']}")
    if any(p["iters"] != o["iters"] for p in outs):
        raise AssertionError(f"[dsetup{DSETUP_RANKS}] the ranks disagree on "
                             "the iteration count")
    if abs(o["iters"] - one["iters"]) > 1:
        raise AssertionError(f"[dsetup{DSETUP_RANKS}] {o['iters']} iterations, "
                             f"one rank {one['iters']}")
    return {"ranks": DSETUP_RANKS, "wall_s": wall,
            "setup_s": [p["setup_s"] for p in outs],
            "setup64_s": [p["setup64_s"] for p in outs],
            "peak_mem_gib": [p["peak_mem_gib"] for p in outs],
            "sizes64": o["sizes64"], "sizes32": o["sizes32"],
            "iters": o["iters"], "relres": o["relres"]}


def phase_dist_setup(dev) -> dict:
    """Phase 26: 26a and 26c on one rank, then 26b on DSETUP_RANKS."""
    torch.cuda.empty_cache()
    one = phase_dist_setup_one_rank(dev)
    return {"one_rank": one, "ranks": phase_dist_setup_ranks(dev, one)}


# ---------------------------------------------------------------------------
# Phase 27: the sharded smoothed-aggregation setup (parallel/dist_sa.py)
# ---------------------------------------------------------------------------

def phase_dist_sa_one_rank(dev, single=None) -> dict:
    """Phase 27a, and 27b's one-rank builds, on one rank over NCCL:
    config 4's preset at elasticity_3d(DSA_N) built by
    dist_build_sa_hierarchy in fp32, cold and warm (seconds, peak memory,
    every sharded tensor, binv included, on the card); its sharded sizes
    and real coarse size beside phase 19's device route (level 0 and the
    first coarse size equal); dist_solve (cg, tol 1e-6, certified <= 1e-6,
    host fp64 true <= 1e-5) within DSA_FENCE iterations of the single-
    device device-route hierarchy sharded by distribute_hierarchy on the
    same ring: phase 19's (``single``: the hierarchy, on the host, and its
    setup seconds), else built here.  Then elasticity_3d(DSA_N4) on the same
    ring: the sizes and iterations 27b is held to."""
    import torch.distributed as dist

    from raptor_tpu_torch import PRESETS, setup
    from raptor_tpu_torch.gallery import elasticity_3d
    from raptor_tpu_torch.parallel import Ring, distribute_hierarchy

    t_phase = time.perf_counter()
    A, B, _ = elasticity_3d(DSA_N)
    cfg = PRESETS["config4"]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        builds, dh = [], None
        for _ in ("cold", "warm"):
            dh = None
            torch.cuda.empty_cache()
            dh, s, peak = timed_dist_build(A, cfg, ring, torch.float32, dev, B=B)
            builds.append((s, peak))
        check_on_card("dsa1", dh, dev)
        sizes = dist_sizes(dh)
        tail = [lv.n for lv in dh.tail.levels]
        blocks = sum(lv.binv is not None for lv in dh.levels)
        iters, relres, solve_s = dist_solve_checked("dsa1", A, dh, ring,
                                                    np.float32)
        del dh
        torch.cuda.empty_cache()

        if single is None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            h1 = setup(A, cfg, B=B, device=dev)
            torch.cuda.synchronize()
            single = h1, time.perf_counter() - t0
        h1, single_s = single
        h1 = h1.to(dev)
        single_sizes = [lv.n for lv in h1.levels]
        dh1 = distribute_hierarchy(h1, ring, DSETUP_TAIL)
        it1, rel1, _ = dist_solve_checked("dsa1 single", A, dh1, ring,
                                          np.float32)
        del h1, dh1
        torch.cuda.empty_cache()
        print(f"[dsa1] config 4 elasticity_3d({DSA_N}) ({A.shape[0]} rows) on "
              f"1 rank (NCCL), fp32: dist_build_sa_hierarchy "
              f"{builds[0][0]:.3f} s cold, {builds[1][0]:.3f} s warm, peak "
              f"device memory {builds[0][1]:.3f} / {builds[1][1]:.3f} GiB; "
              f"single-device device SA (api.setup, phase 19's where the "
              f"whole smoke runs) {single_s:.3f} s")
        print(f"[dsa1] sharded sizes and the real coarse size {sizes} (tail "
              f"{tail}, {blocks} sharded levels with block inverses); phase "
              f"19's device route {CONFIG4_DEVICE_SIZES_PIN}, this run's "
              f"single-device build {single_sizes}; dist_solve {iters} "
              f"iterations in {solve_s:.3f} s, true fp64 relres {relres:.3e}; "
              f"the single-device build through distribute_hierarchy {it1} "
              f"iterations (true {rel1:.3e})")
        if (sizes[:2] != CONFIG4_DEVICE_SIZES_PIN[:2]
                or sizes[:2] != single_sizes[:2]):
            raise AssertionError(f"[dsa1] sharded sizes {sizes}, phase 19's "
                                 f"{CONFIG4_DEVICE_SIZES_PIN}, this run's "
                                 f"single-device {single_sizes}")
        if blocks != len(sizes) - 1:
            raise AssertionError(f"[dsa1] {blocks} sharded levels with block "
                                 "inverses")
        if abs(iters - it1) > DSA_FENCE:
            raise AssertionError(f"[dsa1] {iters} iterations, the single-"
                                 f"device build {it1}")
        one = {"n": A.shape[0], "setup_cold_s": builds[0][0],
               "setup_warm_s": builds[1][0], "peak_mem_gib": builds[0][1],
               "peak_mem_warm_gib": builds[1][1], "sizes": sizes,
               "tail": tail, "single_sizes": single_sizes,
               "single_setup_s": single_s, "iters": iters, "relres": relres,
               "solve_s": solve_s, "single_iters": it1}

        # 27b's reference: the DSA_N4 input on this ring of one
        A4, B4, _ = elasticity_3d(DSA_N4)
        dh, s4, peak4 = timed_dist_build(A4, cfg, ring, torch.float32, dev, B=B4)
        sizes4 = dist_sizes(dh)
        it4, rel4, _ = dist_solve_checked("dsa1 n4", A4, dh, ring, np.float32)
        del dh
        torch.cuda.empty_cache()
        print(f"[dsa1] elasticity_3d({DSA_N4}) ({A4.shape[0]} rows) on 1 rank: "
              f"sizes {sizes4}, build {s4:.3f} s (peak {peak4:.3f} GiB), {it4} "
              f"iterations, true {rel4:.3e}")
        if len(sizes4) < 3:
            raise AssertionError(f"[dsa1] elasticity_3d({DSA_N4}) gave "
                                 f"{len(sizes4) - 1} sharded levels")
        one["n4"] = {"n": A4.shape[0], "sizes": sizes4, "setup_s": s4,
                     "peak_mem_gib": peak4, "iters": it4, "relres": rel4}
    finally:
        dist.destroy_process_group()
    one["phase_s"] = time.perf_counter() - t_phase
    print(f"[dsa1] phase 27a: {one['phase_s']:.1f} s")
    return one


def rank_dist_sa(ring, device, n: int) -> dict:
    """One rank of phase 27b (runs in a spawned process): config 4's preset
    at elasticity_3d(n) by dist_build_sa_hierarchy in fp32, timed, checked
    on the card and solved."""
    from raptor_tpu_torch import PRESETS
    from raptor_tpu_torch.gallery import elasticity_3d

    A, B, _ = elasticity_3d(n)
    dh, s, peak = timed_dist_build(A, PRESETS["config4"], ring, torch.float32,
                                   device, B=B)
    check_on_card(f"dsa{ring.axis_size} rank {ring.axis_index}", dh, device)
    iters, relres, solve_s = dist_solve_checked(
        f"dsa{ring.axis_size}", A, dh, ring, np.float32)
    return {"sizes": dist_sizes(dh), "setup_s": s, "peak_mem_gib": peak,
            "iters": iters, "relres": relres, "solve_s": solve_s}


def phase_dist_sa_ranks(dev, one: dict) -> dict:
    """Phase 27b: DSA_RANKS ranks sharing the card over gloo, each building
    its shards of elasticity_3d(DSA_N4) with config 4's preset; sizes equal
    to one rank's, iterations within one of one rank's."""
    from raptor_tpu_torch.parallel import spawn

    t0 = time.perf_counter()
    outs = spawn(rank_dist_sa, DSA_RANKS, "gloo", dev, DSA_N4, timeout=900.0)
    wall = time.perf_counter() - t0
    ref = one["n4"]
    for r, o in enumerate(outs):
        print(f"[dsa{DSA_RANKS}] rank {r}: dist_build_sa_hierarchy "
              f"{o['setup_s']:.3f} s (peak {o['peak_mem_gib']:.3f} GiB); "
              f"{o['iters']} iterations in {o['solve_s']:.3f} s, true relres "
              f"{o['relres']:.3e}")
    o = outs[0]
    print(f"[dsa{DSA_RANKS}] elasticity_3d({DSA_N4}) on {DSA_RANKS} ranks "
          f"sharing the card (gloo): sizes {o['sizes']} (one rank: "
          f"{ref['sizes']}); {o['iters']} iterations (one rank: "
          f"{ref['iters']}); {wall:.1f} s with the processes' start")
    if any(p["sizes"] != ref["sizes"] for p in outs):
        raise AssertionError(f"[dsa{DSA_RANKS}] sizes differ from one rank's "
                             f"{ref['sizes']}")
    if any(p["iters"] != o["iters"] for p in outs):
        raise AssertionError(f"[dsa{DSA_RANKS}] the ranks disagree on the "
                             "iteration count")
    if abs(o["iters"] - ref["iters"]) > 1:
        raise AssertionError(f"[dsa{DSA_RANKS}] {o['iters']} iterations, one "
                             f"rank {ref['iters']}")
    return {"ranks": DSA_RANKS, "n": ref["n"], "wall_s": wall,
            "setup_s": [p["setup_s"] for p in outs],
            "peak_mem_gib": [p["peak_mem_gib"] for p in outs],
            "sizes": o["sizes"], "iters": o["iters"], "relres": o["relres"]}


def phase_dist_sa(dev, single=None) -> dict:
    """Phase 27: 27a on one rank (on phase 19's single-device hierarchy
    where given), then 27b on DSA_RANKS."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    one = phase_dist_sa_one_rank(dev, single)
    out = {"one_rank": one, "ranks": phase_dist_sa_ranks(dev, one)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"[dsa] phase 27: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# Phase 28: the sharded engines on several cards, one NCCL rank a card
# ---------------------------------------------------------------------------

def _ring_tensor(q: int, dtype, shape, dev) -> torch.Tensor:
    """Rank q's test tensor: multiples of 1/8 in [-1, 1] (integers for
    int64), so a sum over a few ranks is exact in every dtype, bf16
    included, and any reduction order gives the same bits."""
    g = torch.Generator().manual_seed(1000 + q)
    t = torch.randint(-8, 9, shape, generator=g)
    return (t if dtype == torch.int64 else t.to(dtype) / 8).to(dev)


def ring_checks(ring, gloo, mesh, grid, dev) -> int:
    """Phase 28's first item on one rank: the NCCL ring's shifts by +-1,
    +-2, 3 and its size (1-D, 2-D and empty), psum, pmax and all_gather in
    each of MC_DTYPES, each equal to what every rank's inputs give and to
    the gloo ring's result on the same inputs; TAPS's node and chip rings
    (``mesh`` on ``grid``) with their global peer ranks, a shift on the
    node ring and an all_gather and psum on the chip ring.  Returns the
    number of results checked; raises on the first that differs."""
    r, p = ring.axis_index, ring.axis_size
    n_nodes, n_chips = grid
    node, chip = divmod(r, n_chips)
    node_peers = [N * n_chips + chip for N in range(n_nodes)]
    chip_peers = [node * n_chips + c for c in range(n_chips)]
    if dev.type == "cuda" and (ring.host_staged or not gloo.host_staged):
        raise AssertionError(f"[ring] rank {r}: the NCCL ring stages through "
                             "the host, or the gloo ring does not")
    if mesh.node._peer != node_peers or mesh.chip._peer != chip_peers:
        raise AssertionError(f"[ring] rank {r}: TAPS peers {mesh.node._peer} "
                             f"and {mesh.chip._peer}, expected {node_peers} "
                             f"and {chip_peers}")
    checked = 0

    def same(what, got, want):
        nonlocal checked
        if (got.device != want.device or got.dtype != want.dtype
                or not torch.equal(got, want)):
            raise AssertionError(f"[ring] rank {r}: {what} differs")
        checked += 1

    def exact_sum(ts):
        return torch.stack([t.double() for t in ts]).sum(0).to(ts[0].dtype)

    for dtype in MC_DTYPES:
        for shape in ((1000,), (3, 257), (0,)):
            t = [_ring_tensor(q, dtype, shape, dev) for q in range(p)]
            tag = f"{dtype} {shape}"
            for d in (1, -1, 2, -2, 3, p):
                got = ring.shift(t[r], d)
                same(f"shift {d} {tag}", got, t[(r - d) % p])
                same(f"shift {d} {tag} (gloo)", got, gloo.shift(t[r], d))
            if not t[r].numel():
                continue
            for what, fn, want in (
                    ("psum", "psum", exact_sum(t)),
                    ("pmax", "pmax", torch.stack(t).amax(0)),
                    ("all_gather", "all_gather", torch.cat(t, dim=-1))):
                got = getattr(ring, fn)(t[r])
                same(f"{what} {tag}", got, want)
                same(f"{what} {tag} (gloo)", got, getattr(gloo, fn)(t[r]))
        t = [_ring_tensor(q, dtype, (1000,), dev) for q in range(p)]
        for d in (1, -1):
            same(f"TAPS node shift {d} {dtype}", mesh.node.shift(t[r], d),
                 t[node_peers[(node - d) % n_nodes]])
        same(f"TAPS chip all_gather {dtype}", mesh.chip.all_gather(t[r]),
             torch.cat([t[q] for q in chip_peers]))
        same(f"TAPS chip psum {dtype}", mesh.chip.psum(t[r]),
             exact_sum([t[q] for q in chip_peers]))
    return checked


def ring_times(ring, dev, reps: int = 50) -> dict:
    """Microseconds a call (host clock over ``reps`` calls, ending in a
    synchronize) of the ring's shift by one of 4096 and 65536 fp32 words
    (a small halo; a 256^2 plane, config 5's fine halo) and of a psum of
    one word read on the host, as a Krylov dot is."""
    out = {}
    for what, fn in (
            ("shift_4096", lambda x: ring.shift(x, 1)),
            ("shift_65536", lambda x: ring.shift(x, 1)),
            ("psum_read", lambda x: float(ring.psum(x)))):
        n = int(what.split("_")[1]) if what.startswith("shift") else 1
        x = torch.ones(n, device=dev).reshape(() if n == 1 else (n,))
        fn(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(x)
        torch.cuda.synchronize()
        out[what] = (time.perf_counter() - t0) / reps * 1e6
    return out


def k3_equal(tag: str, dh, dev, shapes: list) -> float:
    """K3 against its plain version, bit for bit, on every operator of a
    rank's sharded config-5 levels (A, Rt, Pt; random x and halos of the
    operator's reach); every K3 launch shape of the path (``shapes``) must
    be among them.  Returns the largest difference (0)."""
    from raptor_tpu_torch.ops.cuda.dia_kernel import (dia_spmv_halo,
                                                      dia_spmv_halo_ref,
                                                      halo_reach)

    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    err, compared = 0.0, set()
    for k, lv in enumerate(dh.levels):
        for name, m in (("A", lv.A), ("Rt", lv.Rt), ("Pt", lv.Pt)):
            if m is None:
                continue
            lins = m.linear_offsets()
            LP, RP = halo_reach(lins)
            n_off, n = m.data.shape
            x, hl, hr = (torch.randn(k_, generator=gen, device=dev)
                         for k_ in (n, LP, RP))
            err = max(err, _equal(
                f"K3 {tag} L{k} {name} n={n} {n_off} offsets halos {LP}/{RP}",
                dia_spmv_halo(m.data, lins, x, hl, hr),
                dia_spmv_halo_ref(m.data, lins, x, hl, hr)))
            compared.add(("K3", n, n_off,
                          str(m.data.dtype).removeprefix("torch.")))
    covered(tag, [s for s in shapes if s[0] == "K3"], compared)
    return err


def _cycles(cycle, profiled: bool) -> tuple:
    """(V-cycle ms over N_CYCLES between syncs, the torch.profiler record
    of N_PROFILED more or None): every rank runs the same cycles (their
    collectives meet), ``profiled`` ones under the profiler."""
    cycle()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CYCLES):
        cycle()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / N_CYCLES * 1e3
    if profiled:
        return ms, profile_cycles(cycle)
    for _ in range(N_PROFILED):
        cycle()
    torch.cuda.synchronize()
    return ms, None


def _mc_sdist(ring, dev, n: int) -> dict:
    """Phase 28's config 5 on one rank: sdist_config5 at n^3 on the
    launches counted since just before it, then V-cycles (rank 0's
    profiled); K3 at every
    launch shape against its plain version after the counts are read."""
    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.structured import dist as sd

    snap = counts()
    res = sd.sdist_config5(ring, dev, n=n)
    dh, info = res["hier"], res["info"]
    b = torch.from_numpy(default_rhs(n ** 3, dtype=np.float32)).to(dev)
    b_loc = sd._block(b, ring, int(np.prod(dh.levels[0].dims_local)))
    vc, prof = _cycles(lambda: sd.sdist_cycle(dh, ring, b_loc),
                       ring.axis_index == 0)
    launches, shapes = since(snap, DIA_KERNELS)
    out = {"iters": int(info.iterations), "certified": float(info.relres),
           "setup_s": res["setup_s"], "solve_s": res["solve_s"],
           "vcycle_ms": vc, "profile": prof, "k3": launches["K3"],
           "k1v1": launches["K1v1"],
           "shapes": sorted([*key, c] for key, c in shapes.items()),
           "dims_local": [lv.dims_local for lv in dh.levels]}
    out["k3_err"] = k3_equal(f"sdist rank {ring.axis_index}", dh, dev,
                             out["shapes"])
    x = sd.gather(res["x"], ring)
    out["x"] = x.cpu().numpy() if ring.axis_index == 0 else None
    return out


def _mc_adist(ring, dev, mesh, path: str, b_rcm) -> dict:
    """Phase 28's algebraic sharded solve on one rank: the parent's
    hierarchy through ``adist_body`` (flat, then TAPS against the flat
    solve on the ELL route), V-cycles (rank 0's profiled), then K4's halo
    form and K6's map_cols form on this rank's own tiles at every launch
    shape, bit for bit."""
    from raptor_tpu_torch.parallel import dist as pdist

    h = torch.load(path, weights_only=False, map_location=dev)
    b = torch.from_numpy(b_rcm).to(dev)
    out, dh = adist_body(ring, dev, h, b, mesh)
    ctx = pdist.CommCtx.flat(ring)
    b_loc = pdist._rows(b, ring, dh.levels[0].n_local)
    out["vcycle_ms"], out["profile"] = _cycles(
        lambda: pdist.dist_cycle(dh, b_loc, ctx), ring.axis_index == 0)
    rec = {k: {"err": 0.0} for k in ("K4-halo", "K6-map_cols")}
    sharded_equal(dev, f"adist{ring.axis_size} rank {ring.axis_index}", h,
                  ring.axis_size, rec,
                  [s for s in out["shapes"] if s[0] in rec],
                  ranks=[ring.axis_index])
    out["err"] = {k: v["err"] for k, v in rec.items()}
    return out


def rank_multicard(ring, device, path: str, b_rcm, sizes: dict) -> dict:
    """One rank of phase 28 (a spawned process, one NCCL rank a card):
    the ring's collectives, config 5, the algebraic sharded solve of the
    parent's hierarchy (``path``), dist_build_hierarchy and
    dist_build_sa_hierarchy, in turn, at ``sizes``; rank 0 returns the
    gathered solutions.  Every check that needs only this rank raises
    here; the parent compares the ranks."""
    import torch.distributed as dist

    from raptor_tpu_torch.parallel import Ring, make_taps_mesh

    out = {"device": str(device),
           "current": torch.cuda.current_device() if device.type == "cuda"
           else None}
    wall = {}
    t0 = time.perf_counter()
    # every rank makes every group, in the same order
    gloo = Ring(dist.new_group(backend="gloo"))
    mesh = make_taps_mesh(*sizes["taps"])
    out["ring_checked"] = ring_checks(ring, gloo, mesh, sizes["taps"], device)
    out["ring_us"] = ring_times(ring, device)
    wall["ring"] = time.perf_counter() - t0
    for name, item in (
            ("sdist", lambda: _mc_sdist(ring, device, sizes["sdist"])),
            ("adist", lambda: _mc_adist(ring, device, mesh, path, b_rcm)),
            ("dsetup", lambda: rank_dist_setup(ring, device, sizes["dsetup"])),
            ("dsa", lambda: rank_dist_sa(ring, device, sizes["dsa"]))):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = item()
        wall[name] = time.perf_counter() - t0
    out["wall_s"] = wall
    return out


def one_rank_refs(dev, h_cpu, b_rcm, refs=None) -> dict:
    """The one-rank runs phase 28 is held to, on one NCCL rank on ``dev``:
    the algebraic sharded solve of ``h_cpu`` (always: the hierarchy the
    ranks shard); and, where the whole smoke did not run them before
    (``refs`` None), config 5 at SDIST_N^3 (phase 11's run, cold then
    warm, V-cycles), shuffled DSETUP_N^3 by dist_build_hierarchy (phase
    26b's rank body) and config 4 at DSA_N by dist_build_sa_hierarchy
    (phase 27b's rank body)."""
    import torch.distributed as dist

    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import Ring, dist_solve, distribute_hierarchy
    from raptor_tpu_torch.parallel import dist as pdist
    from raptor_tpu_torch.structured import dist as sd

    refs = dict(refs or {})
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        ring = Ring()
        h = h_cpu.to(dev)
        b = torch.from_numpy(b_rcm).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dh = distribute_hierarchy(h, ring, ADIST_TAIL)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, info = dist_solve(dh, b, ring, tol=ADIST_TOL, maxiter=200)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t1
        ctx = pdist.CommCtx.flat(ring)
        vc, _ = _cycles(lambda: pdist.dist_cycle(dh, b, ctx), False)
        refs["adist"] = {"iters": int(info.iterations),
                         "distribute_s": t1 - t0, "solve_s": solve_s,
                         "vcycle_ms": vc}
        del h, dh
        torch.cuda.empty_cache()
        if "sdist" not in refs:
            sd.sdist_config5(ring, dev, n=SDIST_N)
            res = sd.sdist_config5(ring, dev, n=SDIST_N)
            b5 = torch.from_numpy(default_rhs(SDIST_N ** 3,
                                              dtype=np.float32)).to(dev)
            dh5 = res["hier"]
            vc5, _ = _cycles(lambda: sd.sdist_cycle(dh5, ring, b5), False)
            refs["sdist"] = {"iters": int(res["info"].iterations),
                             "setup_s": res["setup_s"],
                             "solve_s": res["solve_s"], "vcycle_ms": vc5}
            del res, dh5, b5
            torch.cuda.empty_cache()
        if "dsetup" not in refs:
            refs["dsetup"] = rank_dist_setup(ring, dev, DSETUP_N)
            torch.cuda.empty_cache()
        if "dsa" not in refs:
            refs["dsa"] = rank_dist_sa(ring, dev, DSA_N)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return refs


def phase_multicard(dev, refs=None, h_cpu=None, cli=None) -> dict:
    """Phase 28: the sharded engines on N NCCL ranks, one a card (N = 4
    where four cards are visible, else 2), in one spawn: the ring's
    collectives against gloo's; config 5 at SDIST_N^3 (every K3 call a
    launch, no K1v1, iterations one rank's +- 1, rank 0's gathered x true
    <= SDIST_MAX_TRUE); the algebraic sharded solve of shuffled
    ADIST_N^3 padded for N ranks (``h_cpu`` where given for N), flat and
    TAPS on a (2, N / 2) grid (K4-halo and K6-map_cols on every rank,
    iterations one rank's +- 1 on the same hierarchy and phase 15's where
    given, TAPS equal to the flat solve); dist_build_hierarchy at
    DSETUP_N^3 (fp64 sizes equal to one rank's, iterations +- 1) and
    dist_build_sa_hierarchy at elasticity_3d(DSA_N) (sizes equal, iterations
    within DSA_FENCE); every launch shape of K3, K4-halo and K6-map_cols
    bit-equal to its plain version on every rank.  Then ``bench --preset
    config5`` (``cli``: phase 25's run, else run here) must report the
    cards.  ``h_cpu``: phase 14's hierarchy, padded for ADIST_RANKS;
    ``refs``: one rank's results from phases 11, 15, 26a and 27a; what is
    missing is run here (``one_rank_refs``).  On one card it runs nothing
    and says so."""
    import tempfile

    from raptor_tpu_torch.gallery import default_rhs
    from raptor_tpu_torch.parallel import spawn

    cards = torch.cuda.device_count()
    if cards < 2:
        print(f"[multicard] {cards} card visible: phase 28 needs 2 or more")
        return {"cards": cards, "ran": False}
    t_phase = time.perf_counter()
    ranks = 4 if cards >= 4 else 2
    grid = (2, ranks // 2)
    torch.cuda.empty_cache()
    if h_cpu is None or ranks != ADIST_RANKS:
        h = setup_padded_hierarchy(dev, ranks)
        h_cpu = h.to("cpu")
        del h
        torch.cuda.empty_cache()
    A = shuffled_poisson(ADIST_N)
    n = A.shape[0]
    pm = h_cpu.perm[:n].numpy()
    b = default_rhs(n)
    b_rcm = np.zeros(h_cpu.levels[0].A.n_rows_pad, np.float32)
    b_rcm[:n] = b[pm]
    one = one_rank_refs(dev, h_cpu, b_rcm, refs)
    sizes = {"sdist": SDIST_N, "dsetup": DSETUP_N, "dsa": DSA_N, "taps": grid}
    with tempfile.TemporaryDirectory(prefix="raptor_multicard_") as tmp:
        path = f"{tmp}/hier.pt"
        torch.save(h_cpu, path)
        t0 = time.perf_counter()
        outs = spawn(rank_multicard, ranks, "nccl", "cuda", path, b_rcm,
                     sizes, timeout=900.0)
        wall_ranks = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    cards_line = "; ".join(sorted(set(smi.strip().splitlines())))
    tag = f"multicard{ranks}"
    print(f"[{tag}] {ranks} NCCL ranks, one a card, of {cards} visible "
          f"({cards_line}); ranks {wall_ranks:.1f} s with their start")

    # placement and the ring
    for r, o in enumerate(outs):
        print(f"[{tag}] rank {r}: {o['device']} (current {o['current']}), "
              f"{o['ring_checked']} ring results equal; us a call: "
              + ", ".join(f"{k} {v:.1f}" for k, v in o["ring_us"].items())
              + "; seconds by item "
              + ", ".join(f"{k} {v:.2f}" for k, v in o["wall_s"].items()))
        if o["device"] != f"cuda:{r}" or o["current"] != r:
            raise AssertionError(f"[{tag}] rank {r} on {o['device']}, current "
                                 f"device {o['current']}")

    # config 5
    s1 = one["sdist"]
    sd_ = [o["sdist"] for o in outs]
    for r, o in enumerate(sd_):
        print(f"[{tag}] config 5 {SDIST_N}^3 rank {r}: blocks "
              f"{o['dims_local'][0]}..{o['dims_local'][-1]}; setup "
              f"{o['setup_s']:.3f} s, solve {o['solve_s']:.3f} s, V-cycle "
              f"{o['vcycle_ms']:.3f} ms; {o['k3']} K3 launches, "
              f"{o['k1v1']} K1v1")
        if o["k3"] == 0:
            raise AssertionError(f"[{tag}] rank {r} did not run through K3")
        if o["k1v1"]:
            raise AssertionError(f"[{tag}] rank {r} launched K1v1")
    iters5 = sd_[0]["iters"]
    x5 = sd_[0]["x"]
    b5 = default_rhs(SDIST_N ** 3, dtype=np.float32).astype(np.float64)
    rel5 = float(np.linalg.norm(poisson7_residual(x5.astype(np.float64), b5,
                                                  SDIST_N)) / np.linalg.norm(b5))
    prof = sd_[0]["profile"]
    print(f"[{tag}] config 5 {SDIST_N}^3 on {ranks} cards: {iters5} "
          f"iterations (one rank: {s1['iters']}), certified "
          f"{sd_[0]['certified']:.3e}, true fp64 relres {rel5:.3e}; one rank: "
          f"setup {s1['setup_s']:.3f} s, solve {s1['solve_s']:.3f} s, "
          f"V-cycle {s1['vcycle_ms']:.3f} ms")
    print(f"[profile] sharded {SDIST_N}^3 config-5 V-cycle, rank 0 of "
          f"{ranks} cards, {N_PROFILED} cycles under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"{prof['device_events']:g} device events, busy share "
          f"{prof['busy_share'] * 100:.1f}% (per cycle)")
    by_shape(f"{tag} config 5, rank 0",
             {tuple(s[:-1]): s[-1] for s in sd_[0]["shapes"]}, ("K1", "K2", "K3"))
    if any(o["iters"] != iters5 for o in sd_):
        raise AssertionError(f"[{tag}] the ranks disagree on config 5's "
                             "iterations")
    if x5.shape != (SDIST_N ** 3,) or not np.isfinite(x5).all():
        raise AssertionError(f"[{tag}] config 5's x not finite or misshapen")
    if not (sd_[0]["certified"] <= SDIST_TOL and rel5 <= SDIST_MAX_TRUE):
        raise AssertionError(f"[{tag}] config 5: certified "
                             f"{sd_[0]['certified']}, true {rel5}")
    if abs(iters5 - s1["iters"]) > 1:
        raise AssertionError(f"[{tag}] config 5: {iters5} iterations, one "
                             f"rank {s1['iters']}")

    # the algebraic sharded solve
    a1 = one["adist"]
    ad = [o["adist"] for o in outs]
    for r, o in enumerate(ad):
        c, ex = o["counts"], o["exchanges"]
        print(f"[{tag}] adist {ADIST_N}^3 rank {r}: {o['iters']} iterations, "
              f"distribute {o['distribute_s']:.3f} s, solve {o['solve_s']:.3f} "
              f"s, TAPS solve {o['taps_s']:.3f} s, V-cycle {o['vcycle_ms']:.3f} "
              f"ms; launches {c}; per V-cycle from the host plans: flat "
              f"{ex['flat'][0]} messages, {ex['flat'][1]} words; TAPS "
              f"{ex['taps_inter'][0]} inter-node messages, {ex['taps_inter'][1]} "
              f"words, {ex['taps_gathers']} intra-node all-gathers; comm_report "
              f"{ex['comm_report_bytes']} halo bytes")
        if c["K4-halo"] == 0 or c["K6-map_cols"] == 0:
            raise AssertionError(f"[{tag}] rank {r} did not run through both "
                                 "sharded forms")
        if not (o["taps_equal"] and all(o["ext_equal"])
                and o["taps_iters"] == o["ell_iters"] == o["iters"]):
            raise AssertionError(f"[{tag}] rank {r}: TAPS {o['taps_iters']} "
                                 f"iterations, flat {o['iters']}, flat on the "
                                 f"ELL route {o['ell_iters']}; x equal "
                                 f"{o['taps_equal']}")
    itA = ad[0]["iters"]
    xa = ad[0]["x"].astype(np.float64)
    relA = caller_relres(A, xa, pm, b)
    prof = ad[0]["profile"]
    print(f"[{tag}] adist {ADIST_N}^3 on {ranks} cards (pad_multiple "
          f"{1024 * ranks}): {itA} iterations, TAPS "
          f"{grid[0]} x {grid[1]} {ad[0]['taps_iters']} (x equal to the flat "
          f"ELL-route solve's); true fp64 relres {relA:.3e}; one rank on the "
          f"same hierarchy: {a1['iters']} iterations, solve "
          f"{a1['solve_s']:.3f} s, V-cycle {a1['vcycle_ms']:.3f} ms"
          + (f"; phase 15: {one['adist_phase15']} iterations"
             if "adist_phase15" in one else ""))
    print(f"[profile] sharded {ADIST_N}^3 algebraic V-cycle, rank 0 of "
          f"{ranks} cards, {N_PROFILED} cycles under torch.profiler: wall "
          f"{prof['wall_ms']:.3f} ms, device busy {prof['busy_ms']:.3f} ms, "
          f"{prof['device_events']:g} device events, busy share "
          f"{prof['busy_share'] * 100:.1f}% (per cycle)")
    by_shape(f"{tag} adist, rank 0",
             {tuple(s[:-1]): s[-1] for s in ad[0]["shapes"]},
             ("K4-halo", "K6-map_cols", "K4", "K6"))
    if any(o["iters"] != itA for o in ad):
        raise AssertionError(f"[{tag}] the ranks disagree on the algebraic "
                             "solve's iterations")
    if xa.shape != (h_cpu.levels[0].A.n_rows_pad,) or not np.isfinite(xa).all():
        raise AssertionError(f"[{tag}] the algebraic x not finite or misshapen")
    if not relA <= ADIST_MAX_TRUE:
        raise AssertionError(f"[{tag}] algebraic true relres {relA}")
    for what, ref in (("one rank", a1["iters"]),
                      ("phase 15", one.get("adist_phase15", itA))):
        if abs(itA - ref) > 1:
            raise AssertionError(f"[{tag}] algebraic solve {itA} iterations, "
                                 f"{what} {ref}")

    # the sharded setups
    for key, what, ref_sizes, fence in (
            ("dsetup", f"dist_build_hierarchy shuffled {DSETUP_N}^3", "sizes64", 1),
            ("dsa", f"dist_build_sa_hierarchy elasticity_3d({DSA_N})", "sizes",
             DSA_FENCE)):
        o1, rs = one[key], [o[key] for o in outs]
        for r, o in enumerate(rs):
            print(f"[{tag}] {what} rank {r}: fp32 build {o['setup_s']:.3f} s"
                  + (f", fp64 {o['setup64_s']:.3f} s" if "setup64_s" in o else "")
                  + f" (peak {o['peak_mem_gib']:.3f} GiB); {o['iters']} "
                  f"iterations in {o['solve_s']:.3f} s, true relres "
                  f"{o['relres']:.3e}")
        print(f"[{tag}] {what} on {ranks} cards: sizes {rs[0][ref_sizes]}"
              + (f" (fp32 {rs[0]['sizes32']})" if key == "dsetup" else "")
              + f"; one rank: sizes {o1[ref_sizes]}, {o1['iters']} iterations, "
              f"build {o1['setup_s']:.3f} s")
        if any(o[ref_sizes] != o1[ref_sizes] for o in rs):
            raise AssertionError(f"[{tag}] {what}: sizes differ from one "
                                 f"rank's {o1[ref_sizes]}")
        if any(o["iters"] != rs[0]["iters"] for o in rs):
            raise AssertionError(f"[{tag}] {what}: the ranks disagree on the "
                                 "iterations")
        if abs(rs[0]["iters"] - o1["iters"]) > fence:
            raise AssertionError(f"[{tag}] {what}: {rs[0]['iters']} "
                                 f"iterations, one rank {o1['iters']}")

    # the CLI's multi-card branch (cli_config5 holds its device count to
    # the CLI's rule)
    cli = cli_config5() if cli is None else cli
    if abs(cli["iterations"] - s1["iters"]) > 1:
        raise AssertionError(f"[{tag}] bench config5: {cli}, one rank "
                             f"{s1['iters']} iterations")
    wall = time.perf_counter() - t_phase
    print(f"[{tag}] phase 28: {wall:.1f} s")
    strip = {"x", "shapes", "profile"}
    return {"cards": cards, "ranks": ranks, "ran": True, "card": cards_line,
            "wall_s": wall, "ranks_s": wall_ranks, "one_rank": one,
            "cli": cli, "sdist_true_relres": rel5, "adist_true_relres": relA,
            "sdist_profile": sd_[0]["profile"], "adist_profile": prof,
            "sdist_shapes": sd_[0]["shapes"], "adist_shapes": ad[0]["shapes"],
            "launches": {"K3": sd_[0]["k3"],
                         "K4-halo": ad[0]["counts"]["K4-halo"],
                         "K6-map_cols": ad[0]["counts"]["K6-map_cols"]},
            "per_rank": [{k: ({kk: vv for kk, vv in v.items() if kk not in strip}
                              if isinstance(v, dict) else v)
                          for k, v in o.items()} for o in outs]}


def main() -> None:
    # the CSR yardsticks are built from checked indices; PyTorch warns on
    # every sparse CSR tensor that its support is in beta
    warnings.filterwarnings("ignore", message="Sparse", category=UserWarning)
    dev = phase_device()
    phase_build()
    rec = phase_kernels(dev)
    phase_small_cycle(dev)

    from raptor_tpu_torch.utils.native import status

    snap = counts()
    main_rec = phase_main(dev)
    launches, shapes = since(snap)
    k1, k2, k7 = launches["K1"], launches["K2"], launches["K7"]
    v1_main = launches["K1v1"]
    print(f"[proof] main path: {k1} K1 launches, {k2} K2 launches, {v1_main} "
          f"K1v1 launches, {k7} K7 launches")
    if k1 == 0 or k2 == 0:
        raise AssertionError("the main path did not run through the kernels")
    if k7 == 0:
        raise AssertionError("the main path's residuals did not launch K7")
    if v1_main:
        raise AssertionError("the main path launched K1v1")
    main_rec["launches_by_shape"] = by_shape("main 128^3", shapes,
                                             ("K1", "K2", "K7"))

    from raptor_tpu_torch import AmgConfig, setup

    print(f"[alg] host setup kernels: {status()}")
    cfg = AmgConfig(**ALG_CFG)
    A_pi = shuffled_poisson(48, scale=np.pi)
    rec.update(phase_banded_kernels(dev, setup(shuffled_poisson(48), cfg, device=dev),
                                    setup(A_pi, cfg, device=dev), A_pi))

    # each algebraic path is read on its own counts; the kernels line
    # carries the 48^3 row's (the reference bench row)
    snap = counts()
    alg48, _ = phase_algebraic(dev, 48, cold_and_warm=True)
    counts48, rows48 = banded_proof("alg48", snap)
    launch_counts = {"K1": k1, "K2": k2, "K7": k7, **counts48}
    alg48["excess_ms"] = banded_excess("alg48", rec, rows48, "shapes_48")
    snap = counts()
    alg96, h96 = phase_algebraic(dev, 96, cold_and_warm=False)
    alg96["launches"], rows96 = banded_proof("alg96", snap)
    phase_banded_shapes(dev, "96^3", h96, shuffled_poisson(96), rec, rows96,
                        "shapes_96")
    alg96["excess_ms"] = banded_excess("alg96", rec, rows96, "shapes_96")
    # after the proof and the kernel checks: the host route's launches stay
    # out of the path's counts
    alg96["host_route"] = host_route("alg96", shuffled_poisson(96),
                                     AmgConfig(**ALG_CFG), dev,
                                     alg96["sizes"], alg96["iters"])[0]

    # the plane mode: its own counts, K1's hybrid shapes after the proof,
    # and its hierarchy freed before the sharded phases
    t_alg128 = time.perf_counter()
    snap = counts()
    alg128, h128 = phase_alg128(dev)
    alg128["launches"], rows128 = alg128_proof(snap)
    alg128["launches_by_shape"] = rows128
    phase_hybrid_kernels(dev, h128, rec, rows128)
    alg128["k1_excess_ms"] = rec["K1"]["excess_alg128_ms"]
    alg128["host_route"] = phase_alg128_host(dev, h128, alg128["iters"])
    del h128
    torch.cuda.empty_cache()
    alg128["phase_s"] = time.perf_counter() - t_alg128
    print(f"[alg128] phases 9a-9d: {alg128['phase_s']:.1f} s")
    devsetup = phase_devsetup(dev)

    rec.update(phase_halo_kernels(dev))
    sdist = phase_sdist_one_rank(dev)
    sdist4 = phase_sdist_ranks(dev, sdist["one_rank_iters_small"])
    # K3 carries the sharded path's count; K1v1 lies on no path of either
    # package (the reference calls its v1 kernel only from a unit test):
    # its launches as counted on the 128^3 main path, the sharded 256^3 path
    # and every rank of the four-rank run, each of which raised unless 0
    launch_counts.update(K3=sdist["k3_launches"], K1v1=(
        v1_main + sdist["k1v1_launches"] + sum(sdist4["k1v1_launches"])))

    # the algebraic sharded solve: the sharded forms' launches are rank 0's
    # of the four-rank run, the one path that runs both
    h4 = setup_padded_hierarchy(dev)
    rec.update(phase_sharded_kernels(dev, h4))
    h4_cpu = h4.to("cpu")
    del h4
    adist = phase_adist_one_rank(dev, h96)
    del h96
    torch.cuda.empty_cache()
    adist4 = phase_adist_ranks(dev, h4_cpu, adist["iters"])
    launch_counts.update({k: adist4["launches"][0][k]
                          for k in ("K4-halo", "K6-map_cols")})
    sharded_excess(rec, adist4["launches_by_shape"])
    adist4["sharded_kernels"] = {k: rec[k] for k in ("K4-halo", "K6-map_cols")}

    # the acceptance configurations; the mcgs paths' launches are added to
    # the kernels line, each read on its own counts
    configs = phase_configs(dev)
    configs["config4_device"], h_config4 = phase_config4_device(
        dev, configs["config4"])
    rec["K8"] = configs["config4_device"]["k8"][0]
    launch_counts["K8"] = sum(configs[k]["launches"]["K8"]
                              for k in ("config4", "config4_device"))
    configs["config3_full"] = phase_config3_full(dev)
    torch.cuda.empty_cache()
    mcgs96 = phase_mcgs96(dev, rec)
    mcgs4 = phase_mcgs_ranks(dev, rec)
    for k in ("K4", "K5", "K6"):
        launch_counts[k] += mcgs96["launches"][k]
    launch_counts["K4-halo"] += (sum(g["k4_halo_launches"]
                                     for g in mcgs96["one_rank"].values())
                                 + mcgs4["launches"][0]["K4-halo"])
    launch_counts["K6-map_cols"] += mcgs4["launches"][0]["K6-map_cols"]

    # phases 23-25: CLJP, full coarsening and the user surface; the new
    # paths' launches are added to the kernels line
    torch.cuda.empty_cache()
    cljp = {"bits_sha256": cljp_bits_digests(dev)}
    cljp[str(CLJP_N)], h_cljp, x_cljp = phase_cljp(dev, rec, CLJP_N)
    cljp[str(CLJP_N_WIDE)], _, _ = phase_cljp(dev, rec, CLJP_N_WIDE)
    torch.cuda.empty_cache()
    full = {str(nx): phase_full(dev, rec, nx) for nx in (SIZE, FC_ITERS_N)}
    print(f"[full] 128^3 full coarsening: V-cycle bf16 "
          f"{full[str(SIZE)]['vcycle_bf16_ms']:.3f} ms, solve "
          f"{full[str(SIZE)]['solve_s']:.3f} s, {full[str(SIZE)]['iters']} "
          f"iterations; semicoarsening (phase 4): V-cycle bf16 "
          f"{main_rec['vcycle_bf16_ms']:.3f} ms, solve {main_rec['solve_s']:.3f} "
          f"s, {main_rec['iters']} iterations")
    surface = phase_surface(dev, h_cljp, x_cljp, cljp[str(CLJP_N)]["iters"])
    for r in (cljp[str(CLJP_N)], cljp[str(CLJP_N_WIDE)]):
        for k in ("K4", "K5", "K6"):
            launch_counts[k] += r["launches"][k]
    for r in full.values():
        for k in ("K1", "K2", "K7"):
            launch_counts[k] += r["launches"][k]
    # phase 26: the sharded setup launches no kernel of its own (its levels
    # take the ELL halo route, as the reference's do)
    dsetup = phase_dist_setup(dev)
    # phase 27: the sharded SA setup, likewise on the ELL halo route; 27a
    # shards phase 19's single-device hierarchy
    dsa = phase_dist_sa(dev, (h_config4, configs["config4_device"]["setup_s"]))
    del h_config4
    # phase 28: the sharded engines on several cards, held to the one-rank
    # runs above; rank 0's launches join the kernels line (on one card it
    # runs nothing)
    one26, one27 = dsetup["one_rank"], dsa["one_rank"]
    multicard = phase_multicard(dev, {
        "sdist": {"iters": sdist["iters"], "setup_s": sdist["setup_warm_s"],
                  "solve_s": sdist["solve_s"], "vcycle_ms": sdist["vcycle_ms"]},
        "adist_phase15": adist["iters"],
        "dsetup": dict(one26, setup_s=one26["setup_warm_s"]),
        "dsa": dict(one27, setup_s=one27["setup_warm_s"])},
        h4_cpu, surface["config5"])
    if multicard["ran"]:
        for k, c in multicard["launches"].items():
            launch_counts[k] += c

    print(json.dumps({"main": main_rec, "alg48": alg48, "alg96": alg96,
                      "alg128": alg128, "devsetup": devsetup, "sdist": sdist, "sdist_ranks": sdist4, "adist": adist,
                      "adist_ranks": adist4, "configs": configs,
                      "mcgs96": mcgs96, "mcgs_ranks": mcgs4, "cljp": cljp,
                      "full": full, "surface": surface,
                      "dist_setup": dsetup, "dist_sa": dsa,
                      "multicard": multicard}))
    replaces = {"K1": "raptor_tpu/ops/pallas/dia_kernel.py:186",
                "K1v1": "raptor_tpu/ops/pallas/dia_kernel.py:46",
                "K2": "raptor_tpu/ops/pallas/dia_kernel.py:278",
                "K3": "raptor_tpu/ops/pallas/dia_kernel.py:388",
                "K4": "raptor_tpu/ops/pallas/banded_kernel.py:280",
                "K5": "raptor_tpu/ops/pallas/banded_kernel.py:405",
                "K6": "raptor_tpu/ops/pallas/banded_kernel.py:602",
                "K4-halo": "raptor_tpu/ops/pallas/banded_kernel.py:280 "
                           "(_banded_call) called from "
                           "raptor_tpu/parallel/dist.py:315 (dist_banded_spmv)",
                "K6-map_cols": "raptor_tpu/ops/pallas/banded_kernel.py:602 "
                               "(_banded_call_rect, map_cols) called from "
                               "raptor_tpu/parallel/dist.py:371 "
                               "(dist_rect_banded_spmv)",
                "K7": "raptor_tpu/structured/solver.py:703 (_df64_residual, "
                      "plain jnp; no TPU kernel)",
                "K8": "raptor_tpu/core/bell.py:118 (bell_spmv) and :182 "
                      "(the block smoothers' Binv r), plain jnp einsums; no "
                      "TPU kernel"}
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": "raptor_tpu_torch/csrc/" + (
             "banded_kernel.cu" if k.startswith(("K4", "K5", "K6")) else
             "dia_const_kernel.cu" if k == "K2" else
             "dia_df64_kernel.cu" if k == "K7" else
             "bell_kernel.cu" if k == "K8" else "dia_kernel.cu"),
         "replaces": replaces[k], "launches": launch_counts[k],
         "max_abs_err": rec[k]["err"], "ms": rec[k]["ms"],
         "cold_ms": rec[k].get("cold_ms"), "plain_ms": rec[k]["plain_ms"],
         "bound_ms": rec[k]["bound_ms"],
         "bound_by": rec[k]["bound_by"], "library_ms": rec[k]["library_ms"]}
        for k in replaces]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def main_alone(name: str, phase) -> None:
    """``--dist-setup-only``, ``--dist-sa-only`` and ``--multi-card-only``:
    the device, the kernels' build and phase 26, 27 or 28 alone (no kernels
    line and no final ok line: not the smoke's result)."""
    dev = phase_device()
    phase_build()
    print(json.dumps({name: phase(dev)}))


if __name__ == "__main__":
    import sys

    if sys.argv[1:] == ["--dist-setup-only"]:
        main_alone("dist_setup", phase_dist_setup)
    elif sys.argv[1:] == ["--dist-sa-only"]:
        main_alone("dist_sa", phase_dist_sa)
    elif sys.argv[1:] == ["--multi-card-only"]:
        main_alone("multicard", phase_multicard)
    else:
        main()
