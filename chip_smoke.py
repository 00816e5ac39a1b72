"""Chip smoke test of maxwell_tpu_torch on one NVIDIA GPU: build the CUDA
kernels from the sources in this checkout, hold each against its plain
PyTorch version at the shapes of its path, drive the ported paths and the
probes and check that they ran through the kernels:

  slice 1, the assembled path: maxwell_tpu_torch.solve on the 16^3 RCM
    Nedelec brick, refined to 1e-8 on the host (its kernels checked on that
    operator and, as before, on the 24^3 one);
  slice 2, the matrix-free path: the 64^3 vacuum PEC brick as a tap-stencil
    pencil (n = 811,200), f32 LOBPCG with the spectral preconditioner, then
    the double-word refinement on the device to 1e-8; and config 7 (16^3
    loaded cavity) through the CLI;
  slice 3, the blocked-ELL road (kernel="pallas"): solve() on the 24^3 RCM
    brick to 1e-5 through the blocked-ELL SpMM, twice, bit for bit the
    same, and config 1 (2D, 16x16)
    through the CLI with Lanczos and thick-restart Lanczos, the f32 runs
    through the blocked-ELL SpMV and refined to 1e-8 on the host;
  slice 4, the BELLPairs road (kernel="bellpairs"): solve() on the 24^3 RCM
    brick to 1e-5 through the fused K/M and one-stream paired-chunk SpMM,
    twice, bit for bit the same, and config 2 (2D, 32x32) through the CLI at
    f32, refined to 1e-8 on the host;
  slice 5, the distributed assembled road: the 24^3 RCM brick in 8 row
    shards on the card, lobpcg_dist to 1e-5 through the fused interior SpMM
    + halo copy (union pencil, "rdma_overlap") and through the ring shift
    (blocked-ELL pencil, "rdma"), each twice, bit for bit the same;
    thick-restart Lanczos on the 8-shard 16x16 rectangle; config 4 through
    the CLI (f64 as written, and f32 union refined to 1e-8); and the banded
    union apply at 48^3;
  slice 6, the tile-union probes (K15a, K15b): the probe scripts
    maxwell_tpu_torch.bench.exp_union and exp_union2 at their full default
    sizes, each probe kernel against its plain version;
  slice 7, the BELLPairs per-tile and tap-stencil shift probes (K15d,
    K15f): the probe scripts maxwell_tpu_torch.bench.exp_grid and
    exp_stencil2 at their full default sizes, each probe kernel against its
    plain version, K11 and K4 timed beside them;
  slice 8, the blocked-ELL SpMM and X-gather probes (K15c, K15e): the probe
    scripts maxwell_tpu_torch.bench.exp_spmm and exp_gather at their full
    default sizes, each probe kernel against its plain version, K8, K11 and
    K12 timed beside the first;
  slice 9, the distributed stencil road: the tap kernel on the ghost-
    extended slabs of the 64^3 brick in 8 slabs against the plain slab
    apply, the 8-slab f32 lobpcg_dist with the distributed spectral
    preconditioner and refine_dw_dist to 1e-8 through it, and configs
    4_stencil and 5 through the CLI;
  slice 10, shift-invert and tets: the level-scheduled triangular solve
    (level_solve, one launch a factor solve) against its plain version on
    the 128^2 rectangle's LDL^T factors and config 3's splu factors; config
    3 through the CLI (f64, LDL^T); the 128^2 rectangle on an f32 union
    pencil with the LDL^T backend, refined to 1e-8 on the host; the 64^3
    stencil brick with the MINRES backend through the tap kernel; the
    distributed MINRES shift-invert on 8 row shards and 8 slabs against
    the one-device port; config 6 (tet mesh) through the CLI;
  slice 11, the surface: the device-resident solve -> refine chain at 64^3
    through the probe scripts exp_r5chain (one device) and exp_r5dist (1
    and 8 slabs) with the reference's time_to_1e8 gates, the shift-invert,
    preconditioner-sweep and double-word probes (exp_r5si, exp_conv,
    exp_r4chip), the flagship step entry() and the distributed dry run
    dryrun_multichip(8) on the card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. device    name, nvidia-smi name and power limit, CUDA and nvcc versions
  2. build     nvcc build of maxwell_tpu_torch/csrc (one nvcc per source)
  3. kernels   every union kernel against its plain version on the 24^3
               and the 16^3 (the solve's) RCM operators, for precision in
               {highest, b3} and m in {1, 8, 9}; a layout line with the
               live sub-blocks and runs and the seconds the live form
               takes; one JSON line per case with median times over 20
               launches (CUDA events), the bound of the bytes and operations
               the product needs on the CSR, torch.sparse.mm on that CSR,
               and the bytes the kernel reads (live sub-blocks, live X
               runs, tables, Y) beside those of the full layout
  4. solve     slice 1: solve() to 1e-8 at 16^3, launch counts zeroed just
               before and read just after; then, counted apart, each
               eigenvector's residual through the SpMV entry point
  5. stencil solve   slice 2 at 64^3 (the knobs of the reference bench's
               time-to-1e-8 row), counts zeroed just before and read just
               after; residuals verified with an f64 pencil afterwards
  6. stencil   the tap-stencil kernel against its plain version at 64^3,
               modes K, M, KM at m in {1, 9, 17} on the PEC and an
               all-ones mask, and fused K/M at m 171 (two column passes),
               timed as in phase 3 (the library call: torch.sparse.mm on
               the CSR of the same taps)
  7. dielectric  configs/config7_dielectric.json through the CLI on cuda
  8. bsr kernels  the blocked-ELL kernels (SpMM, windowed SpMM, SpMV)
               against their plain versions on K and M of the 24^3 and 16^3
               RCM bricks and of config 1's 16x16 rectangle, m in {1, 8,
               9}, timed as in phase 3; the windowed kernel's window unit,
               window bytes and whether it staged the window in shared
               memory; the SpMV and the SpMM at m 1 bit for bit; and
               launch_floor_ms, the median time of an empty launch
               (torch.cuda._sleep(0)), beside the SpMV's row
  9. bsr solve  slice 3: solve(kernel="pallas") on the 24^3 RCM brick to
               1e-5 (no refine), counts zeroed just before, read just
               after; run twice, the two histories bitwise equal
 10. lanczos   config 1 through the CLI: (a) as written (f64, plain torch
               on the card), (b) f32 "pallas" Lanczos + host refine, (c) the
               same with thick-restart Lanczos; counts zeroed before each
 11. bellpairs kernels  the BELLPairs kernels against their plain versions:
               at 24^3 the one-stream SpMM (streams a and b), the fused K/M
               SpMM and the windowed SpMM at m in {1, 9}, timed as in phase
               8, with the bytes stored and the bytes of the live pairs; at
               48^3 (n = 318,096) the banded forms at m = 9 with the
               reference's own band split (3 bands), timed beside the
               full-X kernels; the 48^3 layout is freed after
 12. bellpairs solve  slice 4: solve(kernel="bellpairs") on the 24^3 RCM
               brick as phase 9 (tol 1e-5, twice, bitwise equal)
 13. bellpairs cli  config 2 through the CLI: f32 "bellpairs" + host refine
               to 1e-8
 14. union banded  the banded union apply (K7) on the 48^3 RCM brick (the
               problem phase 11 built) with the reference's own band split
               for max_m 96, m = 9, highest and b3: against its plain
               version and bit for bit against the full-X kernel (K2),
               timed beside it; the layout is freed after
 15. dist kernels  the 24^3 RCM brick in 8 row shards (union pencil and
               blocked-ELL pencil): the ring shift (K6, both layouts, m in
               {9, 1}, with the copy unit it chose and launch_floor_ms) and
               the fused interior SpMM + halo copy (K5, one and two
               streams) against their plain versions and bit for bit
               against the plain transport and K2; the sharded K and M
               products against the one-device union pencil; times, bounds
               and library calls
 16. dist solves  slice 5: lobpcg_dist on the 8-shard 24^3 brick, union +
               "rdma_overlap" and "pallas" + "rdma" (tol 1e-5, twice each,
               bitwise equal, counts zeroed before each run), against the
               one-device 24^3 union solve; thick_restart_lanczos_dist on
               the 8-shard 16x16 rectangle ("pallas" + "rdma")
 17. dist cli  config 4 through the CLI: as written (f64, 16^3, 8 shards,
               deep halos, plain torch on the card) and f32 "union" + host
               refine to 1e-8
 18. union probes  slice 6 through the probe scripts' run(): exp_union.run
               (T 298, UC 128: u0_hi, u0_def, u1_runs, u2_km) and
               exp_union2.run (the 24^3 RCM K in six (chunk_lanes, pack)
               layouts at m in {8, 9}: union_unstaged beside K2), counts
               zeroed just before and read just after; every probe kernel
               within 1e-5 of max|plain| (K15b also of scipy), launched,
               and no plain version called; one JSON line per variant
 19. grid and stencil probes  slice 7 through the probe scripts' run():
               exp_grid.run (T 298: e0-e5, then K11 at m 8 on the 24^3 K)
               and exp_stencil2.run (the 64^3 field at m 8 and 9: p0-p6,
               each beside one F.conv3d call; then K4 fused at 64^3, m 9,
               beside p3 on a field with as many outputs), counts zeroed
               just before and read just after; every probe kernel (and
               conv3d) within 1e-5 of max|plain| (p5/p6 also of p1/p3's),
               launched, and no plain version called; one JSON line per
               variant, a grid_launch line (e3's gather_sum plan, e4's
               and e5's row plans: grid, warps, stages, the blocks' rows
               or slots, registers, resident blocks per SM) and a
               shift_launch line: the shift kernel's window, x-chunk,
               shared memory, bytes staged beside the field's, registers
               and resident blocks per SM, per case and m
 20. spmm and gather probes  slice 8 through the probe scripts' run():
               exp_spmm.run (the 24^3 RCM K's blocked-ELL layout at m in
               {8, 32, 64, 128}: v1-v6, then K8, K11 and K12 beside) and
               exp_gather.run (T 298, S 64: g0-g5, g3w), counts zeroed
               just before and read just after; every probe kernel (and
               its library call) within 1e-5 of max|plain| (the _def
               variants against bf16-rounded operands; those and the
               _hi rungs bit for bit across two runs), launched, and no
               plain version called; one JSON line per variant, a
               def_launch line: v2_panel_def's unit, pass width, largest
               union and shared memory, both _def rungs' registers and
               resident blocks per SM at each m, and a gather_launch line:
               gather_sum's grid, the blocks' slot counts, cut tiles, tile
               union sizes, slice bytes read and those of the unions,
               registers and resident blocks per SM (g0, g1, g4; v4 at
               each m), and a taa_launch line: g2's and g3's grid, units,
               the blocks' unit counts, registers, local and shared
               memory; g2, g3, g3w and g5 bit for bit their plain versions
               and across two runs; g2, g3 and g5 also timed by a chain of
               launches (chain_ms) beside both launch floors
 21. dist stencil kernels  the tap kernel (K4) on ghost-extended slabs:
               the 64^3 brick in 8 slabs, each slab's block a (10, 64, 64)
               brick, the slab apply (8 launches a column pass, the blocks'
               build and the owned planes' extraction included) against
               the plain slab apply, modes K, M, KM at m in {1, 9, 171},
               each apply and the plain one timed on the device alone
               (device_ms) and the apply also by median_ms, beside the
               one-brick K4 at 64^3 and torch.sparse.mm on the stacked
               CSR of each mode (on both timers)
 22. dist stencil solve  slice 9 at 64^3 in 8 slabs: f32 lobpcg_dist with
               DistSpectralShift (alpha 15, nev 5, maxiter 60, tol 2e-6,
               stall_window 10, seeded start) and refine_dw_dist to 1e-8,
               counts zeroed just before and read just after; residuals
               verified with the one-device f64 pencil afterwards
 23. dist stencil cli  configs 4_stencil and 5 through the CLI as written
               (f64: the plain slab apply, no launch)
 24. tri solve kernels  level_solve against level_solve_plain on the 128^2
               rectangle's LDL^T L and L^T at sigma 45 (32,512 levels) and
               config 3's splu L and U, f32 and f64, m in {1, 4}: backward
               error within the substitution bound, within 16 times the
               chain's measured rounding growth of the plain version, two
               runs bit for bit; device_ms, the plain version's time, the
               byte bound, the level count, the launch floor, the 16-warp
               tag hand-off floor (level_chain), the route and window, and
               torch.triangular_solve on the factor as a sparse CSR tensor
               (wall_ms: it synchronizes)
 25. si solve  config 3 through the CLI (f64; golden rect2d_16x16 nearest
               sigma to 1e-8; 2 level_solve launches a Lanczos step); the
               128^2 rectangle on an f32 union pencil, LDL^T, sigma 45, nev
               4, 40 steps, then refine_f64 to 1e-8 (factor, apply and
               solve times; residuals before and after; 2 launches an
               apply); the 64^3 stencil brick with MINRES (sigma 60, nev 3,
               30 steps) through the tap kernel, within 2e-3 of 6 pi^2
 26. si dist   shift_invert_lanczos_dist at f32 on the 16x16 rectangle in 8
               row shards (union + "rdma_overlap": K5) and the 16^3 brick in
               8 slabs (K4 on the slabs), and thick_restart_lanczos_dist(
               mode="shift_invert") on the rectangle, each within 1e-4 of
               the one-device port from the same start vector
 27. tet cli   config 6 through the CLI (f64), against a dense eigh to 1e-8
 28. r5chain   exp_r5chain.run() at 64^3: f32 LOBPCG (the knobs of phase
               5) -> refine_dw with the block kept on the card
               (return_device), a cold and one steady run of each, the host
               round trip beside them, then one extra steady chain under
               utils/profiling.trace and its top 5 device kernels (an
               r5chain_top_kernels line); gates: f64-verified residual <=
               2e-8, eigenvalues within 0.5% of the analytic ones, the
               device chain's eigenvalues the host chain's to 1e-12, K4
               launched; counts zeroed just before, read just after
 29. r5dist    exp_r5dist.run() at 64^3 in 1 and 8 slabs: lobpcg_dist ->
               refine_dw_dist with the stacked block kept on the card, a
               cold and one steady run each, the same gates
 30. r5si      exp_r5si.run(solves=False): the 128^2 LDL^T factor (host),
               its shift-invert apply (level_solve) and the 64^3 MINRES
               apply (K4), each timed by a chain of applies
 31. conv      exp_conv.run() for alpha 15, 16 CG sweeps at 64^3, maxiter
               20 (K4)
 32. r4chip    exp_r4chip.run(): two_prod exact for the five broadcast
               shapes on the card, the dw sum of 10^6 values, the copy
               rate, K2 at 24^3 against scipy and its bound, the 64^3 dw
               tap apply against an f64 apply beside the f32 K4 apply and
               the spectral shift solve
 33. entry     entry() on the card (K1, K2) within 1e-5 of the same step on
               the CPU; dryrun_multichip(8) on the card, every check true
               and the bit-for-bit ones 0, K4, K5, K6, K8 and K10 launched;
               then a {"surface": ...} line: each of phases 28-33's
               launches per kernel
 34. result    an {"off_main_path": [...]} line for the kernels no solver
               path calls (the union SpMV, the windowed blocked-ELL and
               BELLPairs SpMMs, the banded BELLPairs and union forms), the
               {"kernels": [...]} line of every ported kernel with the path
               that launches it ("solve: ...", "off-path" with 0 launches,
               or "probe: ..." with the probe phase's launches), the
               nvidia-smi line, and last {"ok": true, "device": {...}}
"""

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# cuBLAS picks its reduction order from a fixed workspace only with this set
# (the documented condition for its bitwise-repeatable results), which the
# repeated blocked-ELL solve checks
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
import torch  # noqa: E402

# the card's timers and bounds (H100 SXM rates), shared with the probes
from maxwell_tpu_torch.bench.timing import (  # noqa: E402
    bound_ms,
    device_ms,
    csr_bytes,
    launch_floor_ms,
    median_ms,
    torch_csr,
    union_bytes,
    wall_ms,
)

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
GRID = 24  # union kernel checks kept from the first slice, n = 38,088
SOLVE_GRID = 16  # slice-1 solve (its host f64 refine grows fast with n)
STENCIL_GRID = 64  # slice 2: n = 811,200 edges
BSR_GRID = 24  # slice 3: the blocked-ELL solve, n = 38,088
BANDED_GRID = 48  # slices 4, 5: the banded forms, n = 318,096
SHARDS = 8  # slice 5: the distributed road's row shards (config 4's count)
NEV = 5
# f32 summation order differs from the plain version's (cuBLAS bmm +
# index_add_ for the union kernels, another tap order and FMA contraction
# for the stencil); the JAX package's own tests use the same union bounds
# for the stencil; the blocked-ELL kernels (all three, the windowed one
# included: it does the same per-element arithmetic in the same order as
# the plain SpMM kernel, only its column index differs) are held to the
# bound of the reference's own SpMM test (tests/unit/test_pallas_spmm.py:27)
TOL = {"highest": 1e-5, "b3": 2e-5, "stencil": 1e-5, "bsr": 1e-5,
       "bellpairs": 1e-5}
# residual of a refined eigenvector recomputed with f32 applies on the card:
# its floor is ~eps_f32 * ||K|| ||x|| / ||Kx||; a wrong vector gives O(1)
DEVICE_RESIDUAL_TOL = 1e-3
# the K15d and K15f probe kernels (phase 19)
GRID_PROBES = ("e0_grid1", "e1_grid6", "e2_grid6_when", "e3_acc424",
               "e4_cat424", "e5_cat424_mm")
SHIFT_PROBES = tuple(f"shift_p{k}" for k in range(7))
# the K15c and K15e probe kernels (phase 20), with their pallas_call lines
SPMM_PROBES = {"v1_panel_hi": 127, "v2_panel_def": 127, "v3_stream": 159,
               "v3b_onedot": 184, "v4_gather": 212, "v5_batched_hi": 277,
               "v5_batched_def": 277, "v6_smem_hi": 244}
GATHER_PROBES = {"g0_slices": 103, "g1_slices2x": 125, "g2_taa0": 151,
                 "g3_taa1": 176, "g3w_taa1_wide": 204, "g4_lane_ds": 228,
                 "g5_floor": 247}
REPLACES = {
    "bellunion_matmat": "maxwell_tpu/kernels/spmm.py:304",
    "bellunion_km_matmat": "maxwell_tpu/kernels/spmm.py:466",
    "bellunion_matvec": "maxwell_tpu/kernels/spmm.py:900",
    "stencil_taps": "maxwell_tpu/kernels/stencil_taps.py:114",
    "bsr_matmat": "maxwell_tpu/kernels/spmm.py:79",
    "bsr_matmat_windowed": "maxwell_tpu/kernels/spmm.py:152",
    "bsr_matvec": "maxwell_tpu/kernels/spmm.py:892",
    "bellpairs_matmat": "maxwell_tpu/kernels/spmm.py:630",
    "bellpairs_km_matmat": "maxwell_tpu/kernels/spmm.py:713",
    "bellpairs_matmat_windowed": "maxwell_tpu/kernels/spmm.py:836",
    "bellpairs_matmat_banded": "maxwell_tpu/kernels/spmm.py:772",
    "bellpairs_km_matmat_banded": "maxwell_tpu/kernels/spmm.py:790",
    "bellunion_matmat_banded": "maxwell_tpu/kernels/spmm.py:568",
    "union_interior_overlap": "maxwell_tpu/kernels/halo_rdma.py:166",
    "ring_shift": "maxwell_tpu/kernels/halo_rdma.py:42",
    "u0_hi": "maxwell_tpu/bench/exp_union.py:92",
    "u0_def": "maxwell_tpu/bench/exp_union.py:92",
    "u1_runs": "maxwell_tpu/bench/exp_union.py:122",
    "u2_km": "maxwell_tpu/bench/exp_union.py:154",
    "union_unstaged": "maxwell_tpu/bench/exp_union2.py:106",
    **{name: f"maxwell_tpu/bench/exp_grid.py:{line}" for name, line in zip(
        GRID_PROBES, (74, 92, 119, 133, 162, 189))},
    # one pallas_call, seven bodies (_mk, exp_stencil2.py:32-90)
    **dict.fromkeys(SHIFT_PROBES, "maxwell_tpu/bench/exp_stencil2.py:120"),
    **{name: f"maxwell_tpu/bench/exp_spmm.py:{line}"
       for name, line in SPMM_PROBES.items()},
    **{name: f"maxwell_tpu/bench/exp_gather.py:{line}"
       for name, line in GATHER_PROBES.items()},
    # not a Pallas kernel: the reference's jnp lax.fori_loop over the levels
    "level_solve": "maxwell_tpu/kernels/tri_solve.py:149",
}
SOURCE = {
    "bellunion_matmat": "maxwell_tpu_torch/csrc/bellunion_spmm.cu",
    "bellunion_km_matmat": "maxwell_tpu_torch/csrc/bellunion_spmm.cu",
    "bellunion_matvec": "maxwell_tpu_torch/csrc/bellunion_spmm.cu",
    "stencil_taps": "maxwell_tpu_torch/csrc/stencil_taps.cu",
    "bsr_matmat": "maxwell_tpu_torch/csrc/bsr_spmm.cu",
    "bsr_matmat_windowed": "maxwell_tpu_torch/csrc/bsr_spmm.cu",
    "bsr_matvec": "maxwell_tpu_torch/csrc/bsr_spmm.cu",
    "bellpairs_matmat": "maxwell_tpu_torch/csrc/bellpairs_spmm.cu",
    "bellpairs_km_matmat": "maxwell_tpu_torch/csrc/bellpairs_spmm.cu",
    "bellpairs_matmat_windowed": "maxwell_tpu_torch/csrc/bellpairs_spmm.cu",
    # the banded forms: a host loop (kernels/bellpairs_spmm.py) launching the
    # two kernels above once per band
    "bellpairs_matmat_banded": "maxwell_tpu_torch/csrc/bellpairs_spmm.cu",
    "bellpairs_km_matmat_banded": "maxwell_tpu_torch/csrc/bellpairs_spmm.cu",
    # a host loop (kernels/spmm.py) launching K2 once per band
    "bellunion_matmat_banded": "maxwell_tpu_torch/csrc/bellunion_spmm.cu",
    "union_interior_overlap": "maxwell_tpu_torch/csrc/halo.cu",
    "ring_shift": "maxwell_tpu_torch/csrc/halo.cu",
    **{name: "maxwell_tpu_torch/csrc/union_probes.cu" for name in (
        "u0_hi", "u0_def", "u1_runs", "u2_km", "union_unstaged")},
    **dict.fromkeys(GRID_PROBES, "maxwell_tpu_torch/csrc/grid_probes.cu"),
    # e3 is gather_sum<16, 8>, the body of g1
    "e3_acc424": "maxwell_tpu_torch/csrc/gather_probes.cu",
    **dict.fromkeys(SHIFT_PROBES,
                    "maxwell_tpu_torch/csrc/stencil_probes.cu"),
    **dict.fromkeys(SPMM_PROBES, "maxwell_tpu_torch/csrc/spmm_probes.cu"),
    **dict.fromkeys(GATHER_PROBES,
                    "maxwell_tpu_torch/csrc/gather_probes.cu"),
    # the gather-only rung is g0's kernel; g5 is K15d's e0 kernel
    "v4_gather": "maxwell_tpu_torch/csrc/gather_probes.cu",
    "g5_floor": "maxwell_tpu_torch/csrc/grid_probes.cu",
    "level_solve": "maxwell_tpu_torch/csrc/tri_solve.cu",
}
# what each path launches. solve(): the fused apply (LOBPCG's W, the
# preconditioner's CG) and the single-stream apply (projector, initial
# SVQB). The stencil path: the fused K/M taps (LOBPCG's W) and the M taps
# (projector). The SpMV entry point is the m = 1 launch of the
# single-stream kernel; no solver calls it. The blocked-ELL road: the SpMM
# (solve(kernel="pallas"): LOBPCG's K and M applies, the preconditioner's
# CG) and the SpMV (Lanczos: K and M applies of vectors, CG on M, the
# projector); the windowed SpMM is off every solver path, as in the
# reference. The BELLPairs road: the fused K/M SpMM (LOBPCG's W apply, the
# preconditioner's CG) and the one-stream SpMM (the first block's K and M,
# the projector's M applies); its windowed and banded forms are off the
# solve path (the reference routed to the bands only where X overflowed
# VMEM). The distributed road: the fused interior SpMM + halo copy (union
# pencil with "rdma_overlap": every K, M and fused K/M apply) and the ring
# shift (blocked-ELL pencil with "rdma": every apply's halo exchange); the
# banded union apply is off the solve path, as the banded BELLPairs forms.
MAIN_PATH = {
    "bellunion_km_matmat": "solve: solve() union, 16^3",
    "bellunion_matmat": "solve: solve() union, 16^3",
    "stencil_taps": "solve: stencil LOBPCG, 64^3",
    "bsr_matmat": "solve: solve(kernel='pallas'), 24^3",
    "bsr_matvec": "solve: config 1, f32 Lanczos",
    "bellpairs_km_matmat": "solve: solve(kernel='bellpairs'), 24^3",
    "bellpairs_matmat": "solve: solve(kernel='bellpairs'), 24^3",
    "union_interior_overlap": "solve: lobpcg_dist union + rdma_overlap, "
                              "24^3 in 8 shards",
    "ring_shift": "solve: lobpcg_dist pallas + rdma, 24^3 in 8 shards",
    "level_solve": "solve: shift_invert_lanczos ldlt, 128^2 f32 union",
}
# off every solve path: 0 launches there (the off_main_path line says what
# else launched them)
OFF_PATH = ("bellunion_matvec", "bsr_matmat_windowed",
            "bellpairs_matmat_windowed", "bellpairs_matmat_banded",
            "bellpairs_km_matmat_banded", "bellunion_matmat_banded")
# the probe kernels, by the script whose run() launches them: the
# tile-union probes in phase 18, the BELLPairs per-tile and tap-stencil
# shift probes in phase 19, the blocked-ELL SpMM and X-gather probes in
# phase 20
PROBES = {"u0_hi": "probe: exp_union", "u0_def": "probe: exp_union",
          "u1_runs": "probe: exp_union", "u2_km": "probe: exp_union",
          "union_unstaged": "probe: exp_union2",
          **dict.fromkeys(GRID_PROBES, "probe: exp_grid"),
          **dict.fromkeys(SHIFT_PROBES, "probe: exp_stencil2"),
          **dict.fromkeys(SPMM_PROBES, "probe: exp_spmm"),
          **dict.fromkeys(GATHER_PROBES, "probe: exp_gather")}


def probes_of(*scripts):
    """The probe kernels that the named scripts launch."""
    return [name for name, path in PROBES.items()
            if path.removeprefix("probe: ") in scripts]
STENCIL_MODES = {"K": (True, False), "M": (False, True), "KM": (True, True)}
# the BELLPairs widths: f32 FMAs at m 1, 2; 3xTF32 mma from m 3, one m-tile
# up to 16, then a second (17) and a third (33)
BELLPAIRS_WIDTHS = (1, 2, 3, 9, 16, 17, 33)


def log(obj):
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        sys.exit(1)
    from maxwell_tpu_torch.kernels import _build

    nvcc = subprocess.run(
        [_build.find_nvcc(), "--version"], capture_output=True, text=True,
        check=True,
    ).stdout.strip().splitlines()[-1]
    log(f"device: {torch.cuda.get_device_name(0)}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvcc: {nvcc}")


def phase_build():
    from maxwell_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "library": lib.name})


def phase_kernels(problem, grid):
    """Each union kernel against its plain version on the problem's RCM
    operator. Returns per-kernel stats at the main path's shape."""
    import scipy.sparse as sp

    from maxwell_tpu_torch.kernels import spmm
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion, LiveBlocks

    dev = torch.device("cuda")
    K, M = problem.K.tocsr(), problem.M.tocsr()
    n, nnz = K.shape[0], K.nnz
    t0 = time.perf_counter()
    A = BELLUnion.from_csr(K, B=M, device=dev).bf16x3()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    # the live form alone, derived again from the finished layout: the work
    # from_csr and bf16x3 did for it (find, list, compact six streams)
    t0 = time.perf_counter()
    LiveBlocks.build(A)
    torch.cuda.synchronize()
    L = A.live
    log({"phase": "layout", "grid": grid, "n": n, "nnz": nnz,
         "chunks": A.n_chunks, "tiles": A.n_tiles,
         "value_bytes_per_stream": A.nnz_dense * 4,
         "live_sub_blocks": L.n_blocks,
         "sub_blocks": A.n_chunks * 16 * (A.cl // 16),
         "live_runs": L.n_runs, "runs": A.n_chunks * (A.cl // 16),
         "x_max": L.x_max, "live_value_bytes_per_stream": L.n_blocks * 512,
         "build_s": build_s, "live_build_s": time.perf_counter() - t0})
    # the library call for each case: torch.sparse.mm (cuSPARSE) on the CSR
    # of the same operator(s); the fused case stacks K over M. The bound
    # counts the bytes of that CSR, not of the union layout's zero fill.
    mats = {"a": K, "b": M, "km": sp.vstack([K, M]).tocsr()}
    csr = {case: torch_csr(mat, dev) for case, mat in mats.items()}

    rng = np.random.default_rng(0)
    stats = {fn.__name__: {"max_abs_err": 0.0} for fn in spmm.KERNELS}
    for precision in ("highest", "b3"):
        for m in (1, 8, 9):
            Xh = np.zeros((A.n_padded, m), np.float32)
            Xh[:n] = rng.standard_normal((n, m))
            X = torch.from_numpy(Xh).to(dev)
            x = X[:, 0].contiguous()
            Xn = X[:n].contiguous()
            cases = {
                "km": (
                    lambda: spmm.bellunion_km_matmat(A, X, precision),
                    lambda: spmm.bellunion_km_matmat_ref(A, X, precision),
                    "bellunion_km_matmat", 2,
                ),
            }
            for s in "ab":
                if m == 1:
                    cases[s] = (
                        lambda s=s: spmm.bellunion_matvec(A, x, s, precision),
                        lambda s=s: spmm.bellunion_matvec_ref(
                            A, x, s, precision),
                        "bellunion_matvec", 1,
                    )
                else:
                    cases[s] = (
                        lambda s=s: spmm.bellunion_matmat(A, X, s, precision),
                        lambda s=s: spmm.bellunion_matmat_ref(
                            A, X, s, precision),
                        "bellunion_matmat", 1,
                    )
            for case, (kern, plain, name, streams) in cases.items():
                got, want = kern(), plain()
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                abs_err = max((g - w).abs().max().item()
                              for g, w in zip(got, want))
                scale = max(w.abs().max().item() for w in want)
                if not abs_err <= TOL[precision] * scale:
                    raise AssertionError(
                        f"{name} {case} m={m} {precision}: max error "
                        f"{abs_err:.3e} > {TOL[precision]} * {scale:.3e}"
                    )
                ms, plain_ms = median_ms(kern), median_ms(plain)
                lib = csr[case]
                library_ms = median_ms(lambda: torch.sparse.mm(lib, Xn))
                nbytes = csr_bytes(mats[case], m)
                # one multiply-add per nonzero and column, three per
                # nonzero in b3 (bf16 products)
                flops = mats[case].nnz * m * 2 * (
                    3 if precision == "b3" else 1)
                b_ms, b_by = bound_ms(
                    nbytes, flops, "bf16" if precision == "b3" else "f32")
                layout_bytes, fill_bytes = union_bytes(A, streams, m)
                row = {
                    "kernel": name, "grid": grid, "case": case,
                    "precision": precision, "m": m, "max_abs_err": abs_err,
                    "rel_err": abs_err / scale,
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                    "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
                    "layout_bytes": layout_bytes,
                    "layout_GB_per_s": layout_bytes / ms / 1e6,
                    "fill_bytes": fill_bytes,
                    # nnz of the operator(s) applied per second, the
                    # reference bench's convention (one count per call)
                    "csr_nnz_per_s": streams * nnz / (ms * 1e-3),
                }
                log(row)
                st = stats[name]
                st["max_abs_err"] = max(st["max_abs_err"], abs_err)
                # the shapes the main path gives each kernel: the solve's
                # b3 block applies at m = 9 (fused K/M for LOBPCG's W, the
                # single stream mostly as M in the projector), the residual
                # check's SpMV
                main = (
                    (name == "bellunion_matvec" and precision == "highest"
                     and case == "a")
                    or (name != "bellunion_matvec" and precision == "b3"
                        and m == 9 and case in ("km", "b"))
                )
                if main:
                    st.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=library_ms)
            if m == 8:
                ref = K @ Xh[:n].astype(np.float64)
                Y = spmm.bellunion_matmat(A, X, "a", precision)
                err = np.abs(Y[:n].cpu().numpy() - ref).max()
                if not err <= TOL[precision] * np.abs(ref).max():
                    raise AssertionError(f"K @ X vs scipy: {err:.3e}")
                log({"check": "scipy_f64", "grid": grid,
                     "precision": precision, "m": m,
                     "rel_err": float(err / np.abs(ref).max())})
    return stats


def _kernel_modules():
    from maxwell_tpu_torch.kernels import (
        bellpairs_spmm,
        bsr_spmm,
        gather_probes,
        grid_probes,
        halo,
        spmm,
        spmm_probes,
        stencil_probes,
        stencil_taps,
        tri_solve,
        union_probes,
    )

    return (spmm, stencil_taps, bsr_spmm, bellpairs_spmm, halo, union_probes,
            grid_probes, stencil_probes, spmm_probes, gather_probes,
            tri_solve)


def all_counts():
    return {k: v for mod in _kernel_modules() for k, v in mod.counts().items()}


def reset_all_counts():
    for mod in _kernel_modules():
        mod.reset_counts()


def phase_solve(problem):
    """Slice 1: solve() on the card, with launch counts zeroed just before
    and read just after. Then, counted on their own, each refined
    eigenvector's residual through the SpMV entry point, which solve() does
    not call. Returns (main-path counts, residual-check counts)."""
    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu_torch.solvers.operator import Pencil
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion

    reset_all_counts()
    t0 = time.perf_counter()
    res = maxwell_tpu_torch.solve(
        problem, nev=NEV, tol=1e-8, dtype=torch.float32, device="cuda",
        maxiter=120, stall_window=12,
    )
    wall = time.perf_counter() - t0
    counts = all_counts()

    A = BELLUnion.from_csr(problem.K, B=problem.M, device="cuda")
    check = Pencil(K=A, kernel="union", precision="highest")
    reset_all_counts()
    dev_res = []
    for i, lam in enumerate(res.eigenvalues):
        x = torch.from_numpy(res.eigenvectors[:, i].astype(np.float32)).cuda()
        kx, mx = check.K_mm(x), check.M_mm(x)
        r = torch.linalg.norm(kx - float(lam) * mx) / (
            torch.linalg.norm(kx) + abs(float(lam)) * torch.linalg.norm(mx)
        )
        dev_res.append(r.item())
    check_counts = all_counts()

    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    rel = np.abs(res.eigenvalues - exact) / exact
    # the refine's history restarts at iter 0 after the device iterations
    device_iters = next(
        (i for i, h in enumerate(res.history) if i and h["iter"] == 0),
        len(res.history),
    )
    log({
        "phase": "solve", "grid": SOLVE_GRID, "n": problem.K.shape[0],
        "converged": res.converged,
        "iterations": res.iterations, "device_iterations": device_iters,
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "analytic_rel_err": [float(v) for v in rel],
        "residuals_f64": [float(v) for v in res.residuals],
        "residuals_device_f32": dev_res,
        **res.timings, "wall_s": wall, "counts": counts,
        "residual_check_counts": check_counts,
    })
    if not res.converged or res.residuals.max() > 1e-8:
        raise AssertionError(f"not converged to 1e-8: {res.residuals}")
    if not np.all(np.isfinite(res.eigenvectors)):
        raise AssertionError("non-finite eigenvectors")
    if res.eigenvectors.shape != (problem.K.shape[0], NEV):
        raise AssertionError(f"eigenvector shape {res.eigenvectors.shape}")
    if not rel.max() <= 1e-2:
        raise AssertionError(f"eigenvalues off the analytic modes: {rel}")
    if not max(dev_res) <= DEVICE_RESIDUAL_TOL:
        raise AssertionError(f"device residual check: {dev_res}")
    for name in ("bellunion_km_matmat", "bellunion_matmat"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    for name in REPLACES:
        plain = name + ("_plain" if name == "level_solve" else "_ref")
        if counts[plain] != 0 or check_counts[plain] != 0:
            raise AssertionError(f"plain {plain} ran on the card")
    if check_counts["bellunion_matvec"] != 2 * NEV:
        raise AssertionError(f"residual check launches: {check_counts}")
    return counts, check_counts


def stencil_csr(pencil, want_K, want_M):
    """CSR of the masked tap operator in the stencil's flat layout, built on
    the host from the tap table (one shifted block per tap), K's rows over
    M's when both are wanted. The library call's operand."""
    import scipy.sparse as sp

    from maxwell_tpu_torch.kernels.stencil_taps import component_shapes

    shapes = component_shapes(pencil.shape)
    offs = np.cumsum([0] + [a * b * c for a, b, c in shapes])
    mask = pencil.mask.cpu().numpy()
    mats = []
    for which in ([2] if want_K else []) + ([3] if want_M else []):
        indptr, cols, vals = [np.zeros(1, np.int64)], [], []
        for alpha, s in enumerate(shapes):
            ix, iy, iz = (g.reshape(-1) for g in np.meshgrid(
                *(np.arange(d) for d in s), indexing="ij"))
            rows = offs[alpha] + np.arange(ix.size)
            C = np.zeros((ix.size, len(pencil.taps[alpha])), np.int64)
            V = np.zeros(C.shape, np.float32)
            for t, tap in enumerate(pencil.taps[alpha]):
                beta, (dx, dy, dz) = tap[0], tap[1]
                bx, by, bz = shapes[beta]
                sx, sy, sz = ix + dx, iy + dy, iz + dz
                ok = ((sx >= 0) & (sx < bx) & (sy >= 0) & (sy < by)
                      & (sz >= 0) & (sz < bz))
                q = offs[beta] + (sx * by + sy) * bz + sz
                C[:, t] = np.where(ok, q, 0)
                V[:, t] = np.where(ok, tap[which] * mask[rows]
                                   * mask[np.where(ok, q, 0)], 0.0)
            keep = V != 0.0
            indptr.append(indptr[-1][-1] + np.cumsum(keep.sum(axis=1)))
            cols.append(C[keep])
            vals.append(V[keep])
        n_pad = pencil.n_padded
        indptr.append(np.full(n_pad - offs[3], indptr[-1][-1]))
        mats.append(sp.csr_matrix(
            (np.concatenate(vals), np.concatenate(cols),
             np.concatenate(indptr)), shape=(n_pad, n_pad)))
    return sp.vstack(mats).tocsr() if len(mats) > 1 else mats[0]


def phase_stencil_kernels(pencil):
    """The tap-stencil kernel against its plain version at the 64^3 shapes,
    on the PEC mask and on an all-ones one (the mask is data: zero only on
    the padding rows), at m 1, 9 and 17, then fused K/M on the PEC mask at
    m 171 (two column passes, each launch in place at X's row stride).
    Returns the stats of the main path's case (fused K/M at m = 9, PEC),
    with the m 171 case's under "m171"."""
    from maxwell_tpu_torch.kernels import stencil_taps as kst

    dev = torch.device("cuda")
    n_pad = pencil.n_padded
    t0 = time.perf_counter()
    libs = {mode: torch_csr(stencil_csr(pencil, *want), dev)
            for mode, want in STENCIL_MODES.items()}
    log({"phase": "stencil_csr", "seconds": time.perf_counter() - t0,
         "nnz": {mode: A.values().numel() for mode, A in libs.items()}})
    ones = torch.zeros_like(pencil.mask)
    ones[: pencil.n] = 1.0
    taps_per_row = np.mean([len(t) for t in pencil.taps])
    rng = np.random.default_rng(1)
    st = {"max_abs_err": 0.0}
    for mask_kind, mask in (("pec", pencil.mask), ("ones", ones)):
        rows = mask.sum().item()  # unmasked rows compute, masked skip
        for m in (1, 9, 17, 171):
            if m == 171 and mask_kind != "pec":
                continue
            # random on every row, masked and padding ones too: the kernel
            # applies both masks itself
            X = torch.from_numpy(
                rng.standard_normal((n_pad, m)).astype(np.float32)).to(dev)
            for mode, (want_K, want_M) in STENCIL_MODES.items():
                if m == 171 and mode != "KM":
                    continue
                kern = lambda: kst.stencil_taps(
                    X, mask, pencil.taps, pencil.shape, want_K, want_M)
                plain = lambda: kst.stencil_taps_ref(
                    X, mask, pencil.taps, pencil.shape, want_K, want_M)
                got, want = kern(), plain()
                torch.cuda.synchronize()
                pairs = [(g, w) for g, w in zip(got, want) if w is not None]
                abs_err = max((g - w).abs().max().item() for g, w in pairs)
                scale = max(w.abs().max().item() for _, w in pairs)
                if not abs_err <= TOL["stencil"] * scale:
                    raise AssertionError(
                        f"stencil_taps {mode} m={m} {mask_kind}: max error "
                        f"{abs_err:.3e} > {TOL['stencil']} * {scale:.3e}")
                ms, plain_ms = median_ms(kern), median_ms(plain)
                # the library's CSR holds the PEC mask's operator
                library_ms = None
                if mask_kind == "pec":
                    lib = libs[mode]
                    library_ms = median_ms(lambda: torch.sparse.mm(lib, X))
                ops = len(pairs)
                nbytes = n_pad * m * 4 + n_pad * 4 + ops * n_pad * m * 4
                flops = ops * rows * taps_per_row * 2 * m
                b_ms, b_by = bound_ms(nbytes, flops, "f32")
                log({"kernel": "stencil_taps", "mode": mode, "m": m,
                     "mask": mask_kind, "max_abs_err": abs_err,
                     "rel_err": abs_err / scale, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms,
                     "bytes": nbytes, "GB_per_s": nbytes / ms / 1e6,
                     "bound_us": b_ms * 1e3, "bound_ms": b_ms,
                     "bound_by": b_by})
                st["max_abs_err"] = max(st["max_abs_err"], abs_err)
                if mode == "KM" and m == 9 and mask_kind == "pec":
                    # LOBPCG's fused W apply
                    st.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, library_ms=library_ms)
                if m == 171:
                    st["m171"] = {
                        "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": library_ms,
                        "passes": [list(p) for p in kst.column_passes(m)]}
    del libs
    torch.cuda.empty_cache()
    return st


def f64_residuals(X, theta):
    """Relative residuals of (theta, X) against an f64 pencil built apart,
    applied by the plain tap version (the kernel is f32)."""
    from maxwell_tpu_torch.kernels.stencil_taps import stencil_taps_ref
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    g = STENCIL_GRID
    p64 = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=torch.float64,
                                device="cuda")
    Xp = torch.zeros((p64.n_padded, X.shape[1]), dtype=torch.float64,
                     device="cuda")
    Xp[: p64.n] = torch.from_numpy(X).cuda()
    KX, MX = stencil_taps_ref(Xp, p64.mask, p64.taps, p64.shape, True, True)
    th = torch.from_numpy(np.asarray(theta, np.float64)).cuda()
    R = KX - MX * th[None, :]
    scale = KX.norm(dim=0) + th.abs() * MX.norm(dim=0)
    return (R.norm(dim=0) / scale).cpu().numpy()


def phase_stencil_solve():
    """Slice 2 at 64^3 with the reference bench's knobs (bench.py:707-762):
    build, spectral preconditioner (alpha 15), f32 LOBPCG (nev 5, maxiter
    60, tol 2e-6, stall_window 10), refine_dw to 1e-8. Counts zeroed just
    before, read just after. Returns (pencil, counts)."""
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.lobpcg import lobpcg
    from maxwell_tpu_torch.solvers.refine_device import refine_dw
    from maxwell_tpu_torch.solvers.spectral import spectral_preconditioner

    g = STENCIL_GRID
    reset_all_counts()
    t0 = time.perf_counter()
    pencil = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=torch.float32,
                                   device="cuda")
    pc = spectral_preconditioner(pencil, alpha=15.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res32 = lobpcg(pencil, nev=NEV, maxiter=60, tol=2e-6, precond=pc,
                   stall_window=10)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lobpcg_counts = all_counts()
    ref = refine_dw(pencil, res32.eigenvectors, tol=1e-8)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = all_counts()

    # outside the counted window: the f64 check and the dw apply's time
    verified = f64_residuals(ref.eigenvectors, ref.eigenvalues)
    Xh = torch.from_numpy(ref.eigenvectors.astype(np.float32)).cuda()
    Xh = torch.nn.functional.pad(Xh, (0, 0, 0, pencil.n_padded - pencil.n))
    Xl = torch.zeros_like(Xh)
    dw_ms = median_ms(lambda: pencil.KM_mm_dw(Xh, Xl), n=5)
    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    rel = np.abs(np.sort(ref.eigenvalues) - exact) / exact
    launches = lobpcg_counts["stencil_taps"]
    log({
        "phase": "stencil_solve", "grid": g, "n": pencil.n,
        "n_padded": pencil.n_padded,
        "setup_s": t1 - t0, "lobpcg_s": t2 - t1, "refine_s": t3 - t2,
        "wall_s": t3 - t0, "lobpcg_iterations": res32.iterations,
        "lobpcg_max_res": float(res32.residuals.max()),
        "refine_sweeps": ref.iterations - 1, "converged": ref.converged,
        "eigenvalues": [float(v) for v in ref.eigenvalues],
        "analytic_rel_err": [float(v) for v in rel],
        "residuals_dw": [float(v) for v in ref.residuals],
        "residuals_f64_verified": [float(v) for v in verified],
        "stencil_taps_launches_lobpcg": launches,
        "launches_per_lobpcg_iteration": launches / max(res32.iterations, 1),
        "KM_mm_dw_ms_m5": dw_ms, "counts": counts,
    })
    if not ref.converged or ref.residuals.max() > 1e-8:
        raise AssertionError(f"refine_dw not converged: {ref.residuals}")
    if not verified.max() <= 2e-8:
        raise AssertionError(f"f64-verified residuals {verified}")
    if not np.all(np.isfinite(ref.eigenvectors)) or (
        ref.eigenvectors.shape != (pencil.n, NEV)
    ):
        raise AssertionError("refined eigenvectors: shape or values")
    if not rel.max() <= 5e-3:
        raise AssertionError(f"eigenvalues off the analytic modes: {rel}")
    if counts["stencil_taps"] <= 0 or counts["stencil_taps_ref"] != 0:
        raise AssertionError(f"stencil path counts: {counts}")
    return pencil, counts


def run_cli(cfg_path):
    """The port's CLI in this process on cuda, its counts zeroed just
    before and read just after. Returns (rc, report, counts, wall s)."""
    from maxwell_tpu_torch.cli import run as cli

    out = io.StringIO()
    reset_all_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main([cfg_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = all_counts()
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), counts, wall


def phase_dielectric():
    """configs/config7_dielectric.json through the port's CLI on cuda."""
    path = os.path.join(CONFIGS, "config7_dielectric.json")
    rc, rep, _, wall = run_cli(path)
    log({"phase": "dielectric", "rc": rc, "wall_s": wall,
         **{k: rep[k] for k in ("converged", "iterations", "n", "t_solve_s",
                                "t_refine_s", "eigenvalues", "residuals")}})
    if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
        raise AssertionError(f"config7 through the CLI: {rep}")


def phase_bsr_kernels(problems):
    """The blocked-ELL kernels against their plain versions on K and M of
    each (label, problem). Returns per-kernel stats at the main paths'
    shapes: the SpMM (and the windowed SpMM beside it) on the 24^3 K at
    m = 9, LOBPCG's block; the SpMV on config 1's M at m = 1, the mass CG's
    vector."""
    from maxwell_tpu_torch.kernels import bsr_spmm as kb
    from maxwell_tpu_torch.sparse.bsr import BSRMatrix

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    stats = {fn.__name__: {"max_abs_err": 0.0} for fn in kb.KERNELS}
    floor_ms = launch_floor_ms()
    log({"phase": "launch_floor", "launch_floor_ms": floor_ms})
    for label, problem in problems:
        for op, mat in (("K", problem.K.tocsr()), ("M", problem.M.tocsr())):
            t0 = time.perf_counter()
            A = BSRMatrix.from_csr(mat, block=8, device=dev)
            torch.cuda.synchronize()
            n = mat.shape[0]
            slots_read = int(A.slot_count.sum())
            # the stored layout: every slot's 8x8 values and its column
            layout_bytes = A.nnz_dense * 4 + A.n_brows * A.slots * 4
            log({"phase": "bsr_layout", "problem": label, "op": op, "n": n,
                 "nnz": mat.nnz, "n_padded": A.n_padded, "slots": A.slots,
                 "nonzero_blocks": slots_read, "win_unit": A.win_unit,
                 "layout_bytes": layout_bytes,
                 "build_s": time.perf_counter() - t0})
            lib = torch_csr(mat, dev)
            for m in (1, 8, 9):
                Xh = np.zeros((A.n_padded, m), np.float32)
                Xh[:n] = rng.standard_normal((n, m))
                X = torch.from_numpy(Xh).to(dev)
                x = X[:, 0].contiguous()
                Xn = X[:n].contiguous()
                cases = [
                    ("bsr_matmat", lambda: kb.bsr_matmat(A, X),
                     lambda: kb.bsr_matmat_ref(A, X), Xn),
                    ("bsr_matmat_windowed",
                     lambda: kb.bsr_matmat_windowed(A, X),
                     lambda: kb.bsr_matmat_windowed_ref(A, X), Xn),
                ]
                if m == 1:
                    cases.append(("bsr_matvec", lambda: kb.bsr_matvec(A, x),
                                  lambda: kb.bsr_matvec_ref(A, x), Xn))
                got_by = {}
                for name, kern, plain, Xlib in cases:
                    got, want = kern(), plain()
                    torch.cuda.synchronize()
                    got_by[name] = got
                    abs_err = (got - want).abs().max().item()
                    scale = want.abs().max().item()
                    if not abs_err <= TOL["bsr"] * scale:
                        raise AssertionError(
                            f"{name} {label} {op} m={m}: max error "
                            f"{abs_err:.3e} > {TOL['bsr']} * {scale:.3e}")
                    ms, plain_ms = median_ms(kern), median_ms(plain)
                    library_ms = median_ms(lambda: torch.sparse.mm(lib, Xlib))
                    nbytes = csr_bytes(mat, m)
                    b_ms, b_by = bound_ms(nbytes, mat.nnz * m * 2, "f32")
                    # what the kernel reads: the slots up to each row's last
                    # nonzero block (values and columns), the slot counts,
                    # X once, Y once
                    read_bytes = (slots_read * (64 * 4 + 4) + A.n_brows * 4
                                  + 2 * A.n_padded * m * 4)
                    row = {
                        "kernel": name, "problem": label, "op": op, "m": m,
                        "max_abs_err": abs_err, "rel_err": abs_err / scale,
                        "ms": ms, "plain_ms": plain_ms,
                        "library_ms": library_ms, "bytes": nbytes,
                        "bound_ms": b_ms, "bound_by": b_by,
                        "layout_bytes": layout_bytes, "read_bytes": read_bytes,
                        "read_GB_per_s": read_bytes / ms / 1e6,
                    }
                    if name == "bsr_matmat_windowed":
                        row.update(win_unit=A.win_unit,
                                   window_bytes=kb.window_bytes(A, m),
                                   window_staged=kb.window_staged(A, m))
                    if name == "bsr_matvec":
                        # the SpMV is the SpMM's m = 1 launch
                        row.update(
                            launch_floor_ms=floor_ms,
                            bitwise_equal_spmm=bool(torch.equal(
                                got, got_by["bsr_matmat"][:, 0])))
                        if not row["bitwise_equal_spmm"]:
                            raise AssertionError(
                                f"K10 != K8 at m 1, {label} {op}")
                    log(row)
                    st = stats[name]
                    st["max_abs_err"] = max(st["max_abs_err"], abs_err)
                    main = (
                        (name != "bsr_matvec" and label == f"{BSR_GRID}^3"
                         and op == "K" and m == 9)
                        or (name == "bsr_matvec" and label == "config1"
                            and op == "M")
                    )
                    if main:
                        st.update({k: row[k] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "layout_bytes")})
                        if name == "bsr_matmat_windowed":
                            st.update({k: row[k] for k in (
                                "win_unit", "window_bytes", "window_staged")})
                        if name == "bsr_matvec":
                            st["launch_floor_ms"] = floor_ms
                    if (name == "bsr_matmat" and label == f"{BSR_GRID}^3"
                            and op == "K" and m == 8):
                        st["m8"] = {k: row[k] for k in (
                            "max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "library_ms")}
                # the two SpMM forms hold each other, not only the plain one
                Y8, Y9 = got_by["bsr_matmat"], got_by["bsr_matmat_windowed"]
                d = (Y8 - Y9).abs().max().item()
                if not d <= TOL["bsr"] * Y8.abs().max().item():
                    raise AssertionError(f"K8 vs K9 {label} {op} m={m}: {d}")
                log({"check": "bsr_matmat_vs_windowed", "problem": label,
                     "op": op, "m": m, "max_abs_diff": d,
                     "bitwise_equal": bool(torch.equal(Y8, Y9))})
            del A, lib
    torch.cuda.empty_cache()
    return stats


def phase_repeat_solve(problem, kernel, family, required):
    """A slice's solve(kernel=...) on the 24^3 RCM brick at slice 1's knobs
    (tol 1e-5, maxiter 120, stall_window 12, a seeded X0), on the card only
    (no host refine: at 24^3 it takes minutes on the host). Counts zeroed
    just before, read just after; every kernel in `required` must have
    launched, and nothing outside the `family` of the road's kernels, nor
    any plain version. Run twice: no step of the road adds in an order that
    varies (no atomics), so the two runs agree bit for bit and the
    tolerance is met on every run or on none."""
    import maxwell_tpu_torch
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d

    g, tol = BSR_GRID, 1e-5
    n = problem.K.shape[0]
    X0 = np.random.default_rng(5).standard_normal((n, 9))
    runs = []
    for _ in range(2):
        reset_all_counts()
        t0 = time.perf_counter()
        res = maxwell_tpu_torch.solve(
            problem, kernel=kernel, dtype=torch.float32, device="cuda",
            nev=NEV, tol=tol, refine=False, maxiter=120, stall_window=12,
            X0=X0,
        )
        torch.cuda.synchronize()
        runs.append((res, all_counts(), time.perf_counter() - t0))
    (res, counts, wall), (res2, _, wall2) = runs
    hist = [h["max_rel_res"] for h in res.history]
    identical = (hist == [h["max_rel_res"] for h in res2.history]
                 and np.array_equal(res.eigenvectors, res2.eigenvectors))
    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    rel = np.abs(res.eigenvalues - exact) / exact
    phase = {"pallas": "bsr_solve"}.get(kernel, f"{kernel}_solve")
    log({
        "phase": phase, "grid": g, "n": n, "kernel": kernel,
        "converged": res.converged, "iterations": res.iterations,
        "eigenvalues": [float(v) for v in res.eigenvalues],
        "analytic_rel_err": [float(v) for v in rel],
        "residuals": [float(v) for v in res.residuals],
        "history_max_res": hist, "repeat_identical": identical,
        **res.timings, "wall_s": wall, "repeat_wall_s": wall2,
        "ms_per_iteration": res.timings["device_solve_s"]
        / max(res.iterations, 1) * 1e3,
        "device": torch.cuda.get_device_name(0), "nvidia_smi": nvidia_smi_line(),
        "counts": {k: v for k, v in counts.items() if v},
    })
    if not res.converged or res.residuals.max() > tol:
        raise AssertionError(f"{kernel} solve not converged: {res.residuals}")
    if not identical:
        raise AssertionError(f"two runs of the {kernel} solve differ")
    if not np.all(np.isfinite(res.eigenvectors)) or (
        res.eigenvectors.shape != (n, NEV)
    ):
        raise AssertionError(f"{kernel} solve eigenvectors: shape or values")
    if not rel.max() <= 1e-2:
        raise AssertionError(f"eigenvalues off the analytic modes: {rel}")
    for name in required:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the main path")
    stray = {k: v for k, v in counts.items()
             if v and (k.endswith("_ref") or not k.startswith(family))}
    if stray:
        raise AssertionError(
            f"the {kernel} solve ran other kernels or plain versions: {stray}")
    return counts


def phase_lanczos():
    """Config 1 through the CLI: (a) as written (f64, kernel auto -> the
    plain blocked-ELL apply on the card), (b) f32 "pallas" Lanczos refined
    to 1e-8 on the host (the reference's config-1 route on the TPU), (c)
    (b) with thick-restart Lanczos. Returns the counts of (b)."""
    path = os.path.join(CONFIGS, "config1.json")
    with open(path) as f:
        cfg = json.load(f)
    variants = {"a": cfg}
    b = json.loads(json.dumps(cfg))
    b["storage"] = {"dtype": "f32", "kernel": "pallas"}
    b["solver"]["refine"] = True
    variants["b"] = b
    c = json.loads(json.dumps(b))
    c["solver"].update(kind="tr_lanczos", ncv=24, max_restarts=60)
    variants["c"] = c
    reports, counts = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, variant in variants.items():
            p = path
            if key != "a":
                p = os.path.join(tmp, f"config1_{key}.json")
                with open(p, "w") as f:
                    json.dump(variant, f)
            rc, rep, cnt, wall = run_cli(p)
            reports[key], counts[key] = rep, cnt
            log({"phase": "lanczos", "variant": key,
                 "solver": variant["solver"]["kind"],
                 "storage": variant["storage"], "rc": rc, "wall_s": wall,
                 **{k: rep.get(k) for k in (
                     "converged", "iterations", "n", "t_solve_s",
                     "t_refine_s", "eigenvalues", "residuals",
                     "analytic_rel_err")},
                 "counts": {k: v for k, v in cnt.items() if v}})
            if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
                raise AssertionError(f"config 1 ({key}) through the CLI: {rep}")
            if key != "a" and (cnt["bsr_matvec"] <= 0 or any(
                    cnt[k] for k in cnt if k.startswith("bsr_")
                    and k.endswith("_ref"))):
                raise AssertionError(f"config 1 ({key}) counts: {cnt}")
    if max(reports["a"]["analytic_rel_err"]) > 2.5e-2:
        raise AssertionError(f"config 1 (a) vs analytic: {reports['a']}")
    ev_a = np.asarray(reports["a"]["eigenvalues"])
    for key in ("b", "c"):
        rel = np.abs(np.asarray(reports[key]["eigenvalues"]) - ev_a) / ev_a
        if not rel.max() <= 1e-8:
            raise AssertionError(f"config 1 ({key}) vs (a): {rel}")
    return counts["b"]


def _check_close(label, got, want, tol):
    """Max abs error of got against want (tensors or tuples of them), raised
    unless within tol * max|want|. Returns (error, scale)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err = max((g - w).abs().max().item() for g, w in zip(got, want))
    scale = max(w.abs().max().item() for w in want)
    if not abs_err <= tol * scale:
        raise AssertionError(
            f"{label}: max error {abs_err:.3e} > {tol} * {scale:.3e}")
    return abs_err, scale


def phase_bellpairs_kernels(problem):
    """The BELLPairs kernels against their plain versions on the K and M of
    the 24^3 RCM brick (one pair structure, two value streams), at m 1 and
    2 (f32 FMAs) and 3, 9, 16, 17 and 33 (3xTF32 mma; 17 and 33 walk a
    second and third m-tile). Returns per-kernel stats at the main path's
    shapes, m = 9: the fused K/M SpMM (LOBPCG's W, the preconditioner's
    CG), the one-stream SpMM on stream b (the projector's M applies) and,
    beside it, the windowed SpMM; m 1 beside."""
    import scipy.sparse as sp

    from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
    from maxwell_tpu_torch.sparse.bellpairs import BELLPairs

    dev = torch.device("cuda")
    K, M = problem.K.tocsr(), problem.M.tocsr()
    n = K.shape[0]
    t0 = time.perf_counter()
    A = BELLPairs.from_csr(K, B=M, device=dev)
    torch.cuda.synchronize()
    live = int(A.npairs.sum())
    stored = A.nnz_dense * 4  # value bytes of one stream, padding included
    pair_bytes = live * 2 * A.b * A.b * 4  # one stream's live pair panels
    log({"phase": "bellpairs_layout", "grid": BSR_GRID, "n": n,
         "nnz": K.nnz, "n_padded": A.n_padded, "slots": A.slots,
         "max_ch": A.max_ch, "live_pairs": live,
         "mean_live_pairs_per_block_row": live / A.n_brows,
         "win_unit": A.win_unit, "value_bytes_per_stream": stored,
         "chunk_clamped_bytes_per_stream": A.nnz_streamed * 4,
         "live_pair_bytes_per_stream": pair_bytes,
         "build_s": time.perf_counter() - t0})
    mats = {"a": K, "b": M, "km": sp.vstack([K, M]).tocsr()}
    csr = {case: torch_csr(mat, dev) for case, mat in mats.items()}
    rng = np.random.default_rng(3)
    names = ("bellpairs_matmat", "bellpairs_km_matmat",
             "bellpairs_matmat_windowed")
    stats = {name: {"max_abs_err": 0.0} for name in names}
    for m in BELLPAIRS_WIDTHS:
        Xh = np.zeros((A.n_padded, m), np.float32)
        Xh[:n] = rng.standard_normal((n, m))
        X = torch.from_numpy(Xh).to(dev)
        Xn = X[:n].contiguous()
        cases = [
            ("bellpairs_matmat", "a", lambda: kp.bellpairs_matmat(A, X, "a"),
             lambda: kp.bellpairs_matmat_ref(A, X, "a")),
            ("bellpairs_matmat", "b", lambda: kp.bellpairs_matmat(A, X, "b"),
             lambda: kp.bellpairs_matmat_ref(A, X, "b")),
            ("bellpairs_km_matmat", "km", lambda: kp.bellpairs_km_matmat(A, X),
             lambda: kp.bellpairs_km_matmat_ref(A, X)),
            ("bellpairs_matmat_windowed", "a",
             lambda: kp.bellpairs_matmat_windowed(A, X),
             lambda: kp.bellpairs_matmat_windowed_ref(A, X)),
        ]
        got_by = {}
        for name, case, kern, plain in cases:
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got_by[name, case] = got
            abs_err, scale = _check_close(f"{name} {case} m={m}", got, want,
                                          TOL["bellpairs"])
            ms, plain_ms = median_ms(kern), median_ms(plain)
            lib = csr[case]
            library_ms = median_ms(lambda: torch.sparse.mm(lib, Xn))
            streams = 2 if case == "km" else 1
            nbytes = csr_bytes(mats[case], m)
            b_ms, b_by = bound_ms(nbytes, mats[case].nnz * m * 2, "f32")
            # what the kernel reads: the live pairs' values and columns, the
            # pair counts, X once; Y written once per stream
            read_bytes = (streams * pair_bytes + live * 4 + A.n_brows * 4
                          + A.n_padded * m * 4 * (1 + streams))
            row = {
                "kernel": name, "grid": BSR_GRID, "case": case, "m": m,
                "max_abs_err": abs_err, "rel_err": abs_err / scale,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
                "layout_bytes": streams * stored + A.cols.numel() * 4,
                "read_bytes": read_bytes,
                "read_GB_per_s": read_bytes / ms / 1e6,
            }
            if name == "bellpairs_matmat_windowed":
                row.update(win_unit=A.win_unit,
                           window_bytes=kp.window_bytes(A, m),
                           window_staged=kp.window_staged(A, m))
            log(row)
            st = stats[name]
            st["max_abs_err"] = max(st["max_abs_err"], abs_err)
            if m == 1 and case in ("km", "b"):
                st["m1"] = {k: row[k] for k in ("ms", "plain_ms",
                                                "library_ms", "bound_ms")}
            if m == 9 and case in ("km", "b") or (
                    m == 9 and name == "bellpairs_matmat_windowed"):
                st.update({k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "layout_bytes", "read_bytes")})
                if name == "bellpairs_matmat_windowed":
                    st.update({k: row[k] for k in (
                        "win_unit", "window_bytes", "window_staged")})
        # the one-stream, fused and windowed forms do the same per-element
        # arithmetic in the same order
        Ya = got_by["bellpairs_matmat", "a"]
        same = {
            "km_vs_a": torch.equal(got_by["bellpairs_km_matmat", "km"][0], Ya),
            "km_vs_b": torch.equal(got_by["bellpairs_km_matmat", "km"][1],
                                   got_by["bellpairs_matmat", "b"]),
            "windowed_vs_a": torch.equal(
                got_by["bellpairs_matmat_windowed", "a"], Ya),
        }
        log({"check": "bellpairs_forms_bitwise_equal", "m": m, **same})
        if not all(same.values()):
            raise AssertionError(f"BELLPairs forms differ at m={m}: {same}")
    del A, csr
    torch.cuda.empty_cache()
    return stats


# the reference's band split for its max_m = 96
# (maxwell_tpu/solvers/operator.py:337-346): window rows capped at the
# lane-padded VMEM budget over 128 lanes of 4 B, with 5/6 headroom
BAND_M = 96
BAND_BUDGET = 96 * 1024 * 1024 // (128 * 4) * 5 // 6 * BAND_M * 4


def phase_bellpairs_banded(problem):
    """The banded BELLPairs forms on the 48^3 RCM brick (n = 318,096) at
    every BELLPAIRS_WIDTHS width, with the reference's own band split
    (BAND_BUDGET), against their plain versions and bit for bit against
    the one-stream and fused kernels on the full X, and timed beside them
    at m = 9. Frees the 48^3 layout before it returns."""
    import scipy.sparse as sp

    from maxwell_tpu_torch.kernels import bellpairs_spmm as kp
    from maxwell_tpu_torch.sparse.bellpairs import BELLPairs

    dev = torch.device("cuda")
    g = BANDED_GRID
    K, M = problem.K.tocsr(), problem.M.tocsr()
    t1 = time.perf_counter()
    A = BELLPairs.from_csr(K, B=M, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    AB = A.banded(m=BAND_M, budget_bytes=BAND_BUDGET)
    t3 = time.perf_counter()
    n = K.shape[0]
    log({"phase": "bellpairs_banded_layout", "grid": g, "n": n,
         "nnz": K.nnz, "n_padded": A.n_padded, "slots": A.slots,
         "value_bytes_per_stream": A.nnz_dense * 4,
         "bands": len(AB.bands), "col_starts": list(AB.col_starts),
         "col_rows": list(AB.col_rows),
         "build_s": t2 - t1, "band_s": t3 - t2})
    mats = {"a": K, "km": sp.vstack([K, M]).tocsr()}
    rng = np.random.default_rng(4)
    stats = {name: {"max_abs_err": 0.0} for name in (
        "bellpairs_matmat_banded", "bellpairs_km_matmat_banded")}
    for m in BELLPAIRS_WIDTHS:
        Xh = np.zeros((A.n_padded, m), np.float32)
        Xh[:n] = rng.standard_normal((n, m))
        X = torch.from_numpy(Xh).to(dev)
        cases = [
            ("bellpairs_matmat_banded", "a",
             lambda: kp.bellpairs_matmat_banded(AB, X),
             lambda: kp.bellpairs_matmat_banded_ref(AB, X),
             lambda: kp.bellpairs_matmat(A, X)),
            ("bellpairs_km_matmat_banded", "km",
             lambda: kp.bellpairs_km_matmat_banded(AB, X),
             lambda: kp.bellpairs_km_matmat_banded_ref(AB, X),
             lambda: kp.bellpairs_km_matmat(A, X)),
        ]
        for name, case, kern, plain, full in cases:
            got, want, whole = kern(), plain(), full()
            torch.cuda.synchronize()
            abs_err, scale = _check_close(f"{name} m={m}", got, want,
                                          TOL["bellpairs"])
            _check_close(f"{name} m={m} against the full-X kernel", got,
                         whole, TOL["bellpairs"])
            bitwise = all(torch.equal(a, b) for a, b in zip(
                got if isinstance(got, tuple) else (got,),
                whole if isinstance(whole, tuple) else (whole,)))
            row = {"kernel": name, "grid": g, "case": case, "m": m,
                   "max_abs_err": abs_err, "rel_err": abs_err / scale,
                   "bitwise_equal_full_x": bitwise}
            if m == 9:  # the solver's width: timed
                ms, plain_ms = median_ms(kern), median_ms(plain)
                full_ms = median_ms(full)
                lib = torch_csr(mats[case], dev)
                Xn = X[:n].contiguous()
                library_ms = median_ms(lambda: torch.sparse.mm(lib, Xn))
                del lib, Xn
                nbytes = csr_bytes(mats[case], m)
                b_ms, b_by = bound_ms(nbytes, mats[case].nnz * m * 2, "f32")
                row.update(ms=ms, plain_ms=plain_ms, full_x_kernel_ms=full_ms,
                           library_ms=library_ms, bytes=nbytes,
                           bound_ms=b_ms, bound_by=b_by,
                           bands=len(AB.bands), col_rows=list(AB.col_rows))
                stats[name].update({k: row[k] for k in (
                    "ms", "plain_ms", "full_x_kernel_ms", "bound_ms",
                    "bound_by", "library_ms", "bands", "col_rows")})
            log(row)
            if not bitwise:
                raise AssertionError(f"{name} m={m} differs from the full-X "
                                     "kernel's bits")
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             abs_err)
        del X
    del A, AB
    torch.cuda.empty_cache()
    return stats


def phase_union_banded(problem):
    """The banded union apply (K7) on the 48^3 RCM brick's K at m = 9 with
    the reference's band split, highest and b3 (bands built with
    split_bf16: views of the full layout's bf16 streams): against its plain
    version, bit for bit against the full-X kernel (K2), timed beside it.
    Frees the 48^3 layout before it returns."""
    from maxwell_tpu_torch.kernels import spmm
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion

    dev = torch.device("cuda")
    K = problem.K.tocsr()
    n = K.shape[0]
    t0 = time.perf_counter()
    A = BELLUnion.from_csr(K, device=dev).bf16x3()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    AB = A.banded(m=BAND_M, budget_bytes=BAND_BUDGET, split_bf16=True)
    t2 = time.perf_counter()
    log({"phase": "union_banded_layout", "grid": BANDED_GRID, "n": n,
         "nnz": K.nnz, "chunks": A.n_chunks,
         "value_bytes_per_stream": A.nnz_dense * 4,
         "bands": len(AB.bands), "col_starts": list(AB.col_starts),
         "col_rows": list(AB.col_rows), "build_s": t1 - t0,
         "band_s": t2 - t1})
    m = 9
    Xh = np.zeros((A.n_padded, m), np.float32)
    Xh[:n] = np.random.default_rng(8).standard_normal((n, m))
    X = torch.from_numpy(Xh).to(dev)
    Xn = X[:n].contiguous()
    lib = torch_csr(K, dev)
    library_ms = median_ms(lambda: torch.sparse.mm(lib, Xn))
    stats = {"max_abs_err": 0.0}
    for precision in ("highest", "b3"):
        kern = lambda: spmm.bellunion_matmat_banded(AB, X, "a", precision)
        plain = lambda: spmm.bellunion_matmat_banded_ref(AB, X, "a",
                                                         precision)
        full = lambda: spmm.bellunion_matmat(A, X, "a", precision)
        got, want, whole = kern(), plain(), full()
        torch.cuda.synchronize()
        abs_err, scale = _check_close(f"bellunion_matmat_banded {precision}",
                                      got, want, TOL[precision])
        bitwise = torch.equal(got, whole)
        if not bitwise:
            raise AssertionError(
                f"banded union apply ({precision}) differs from the full-X "
                "kernel")
        ms, plain_ms, full_ms = median_ms(kern), median_ms(plain), median_ms(
            full)
        flops = K.nnz * m * 2 * (3 if precision == "b3" else 1)
        b_ms, b_by = bound_ms(csr_bytes(K, m), flops,
                              "bf16" if precision == "b3" else "f32")
        row = {"kernel": "bellunion_matmat_banded", "grid": BANDED_GRID,
               "precision": precision, "m": m, "max_abs_err": abs_err,
               "rel_err": abs_err / scale, "ms": ms, "plain_ms": plain_ms,
               "full_x_kernel_ms": full_ms, "library_ms": library_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bands": len(AB.bands),
               "col_rows": list(AB.col_rows), "bitwise_equal_full_x": bitwise}
        log(row)
        stats["max_abs_err"] = max(stats["max_abs_err"], abs_err)
        if precision == "highest":  # the reference's banded route
            stats.update({k: row[k] for k in (
                "ms", "plain_ms", "full_x_kernel_ms", "bound_ms", "bound_by",
                "library_ms", "bands", "col_rows")})
    del A, AB, X, Xn, lib
    torch.cuda.empty_cache()
    return stats


def _dist_pencils(problem):
    """The 24^3 RCM brick in SHARDS row shards on the card: the union
    pencil with "rdma_overlap" and the blocked-ELL pencil with "rdma". The
    problem is already RCM-ordered, so the partitioner keeps its order."""
    from maxwell_tpu_torch.dist import partition_problem

    out = {}
    for kernel, impl in (("union", "rdma_overlap"), ("pallas", "rdma")):
        t0 = time.perf_counter()
        dp = partition_problem(problem, SHARDS, kernel=kernel,
                               dtype=torch.float32, reorder=False,
                               halo_impl=impl, device="cuda")
        torch.cuda.synchronize()
        info = {"phase": "dist_layout", "grid": GRID, "kernel": kernel,
                "halo_impl": impl, "shards": SHARDS, "L": dp.L, "H": dp.H,
                "rows_per_shard": dp.Lb, "halo_rows": dp.Hb,
                "shallow": dp.H <= dp.L, "build_s": time.perf_counter() - t0}
        if kernel == "union":
            info.update(
                interior_chunks=dp.Ui.n_chunks, boundary_chunks=dp.Ub.n_chunks,
                interior_value_bytes=2 * dp.Ui.nnz_dense * 4,
                boundary_value_bytes=2 * dp.Ub.nnz_dense * 4)
        else:
            info.update(
                interior_block_bytes=(dp.K_int.nnz_dense
                                      + dp.M_int.nnz_dense) * 4,
                boundary_block_bytes=(dp.K_bnd.nnz_dense
                                      + dp.M_bnd.nnz_dense) * 4)
        log(info)
        if not dp.H <= dp.L:
            raise AssertionError(f"24^3 in {SHARDS} shards is not shallow")
        out[kernel] = dp
    return out


def _block_diag_interior(problem, dp):
    """CSR of each shard's interior part of K and M, block diagonal over the
    shards (what K5's SpMM computes), from the host CSR."""
    import scipy.sparse as sp

    Lb = dp.Lb
    mats = []
    for A in (problem.K, problem.M):
        C = sp.csr_matrix(A).copy()
        C.resize((dp.global_rows, dp.global_rows))
        C = C.tocoo()
        keep = C.row // Lb == C.col // Lb
        mats.append(sp.csr_matrix(
            (C.data[keep], (C.row[keep], C.col[keep])), shape=C.shape))
    return mats


def phase_dist_kernels(problem, pencils):
    """K6 and K5 on the 8-shard 24^3 brick, m = 9 (LOBPCG's block) and
    m = 1, against their plain versions and bit for bit against the plain
    transport and K2; the sharded products against the one-device union
    pencil. Returns per-kernel stats at the main path's shapes: K5 with both
    streams and K6 writing the halo-extended buffer, m = 9."""
    from maxwell_tpu_torch.kernels import halo, spmm
    from maxwell_tpu_torch.solvers.operator import Pencil
    from maxwell_tpu_torch.sparse.bellunion import BELLUnion

    import scipy.sparse as sp

    dev = torch.device("cuda")
    du, dpl = pencils["union"], pencils["pallas"]
    D, Lb, Hb = du.D, du.Lb, du.Hb
    n = problem.K.shape[0]
    rng = np.random.default_rng(9)
    single = Pencil(K=BELLUnion.from_csr(problem.K, B=problem.M, device=dev),
                    kernel="union", precision="highest")
    Ki, Mi = _block_diag_interior(problem, du)
    lib_i = {"a": torch_csr(Ki, dev), "b": torch_csr(Mi, dev),
             "ab": torch_csr(sp.vstack([Ki, Mi]).tocsr(), dev)}
    stats = {"union_interior_overlap": {"max_abs_err": 0.0},
             "ring_shift": {"max_abs_err": 0.0}}
    floor_ms = launch_floor_ms()
    for m in (9, 1):
        Xh = np.zeros((du.global_rows, m), np.float32)
        Xh[:n] = rng.standard_normal((n, m))
        X = torch.from_numpy(Xh).to(dev)
        # K6: both output layouts, f32, bit for bit the plain transport
        for own, pad in ((True, du.b), (False, 0)):
            kern = lambda: halo.ring_shift(X, D, Hb, own, pad)
            plain = lambda: halo.ring_shift_ref(X, D, Hb, own, pad)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"ring_shift own={own} m={m} differs")
            # the library call: one index_select of the buffer's rows from
            # X with a zero row appended
            rows = got.shape[0] // D
            r = torch.arange(rows, device=dev)
            base = torch.arange(D, device=dev)[:, None] * Lb
            h = r - (Lb if own else 0)
            src = torch.where(
                (r < Lb) & own, base + r,
                torch.where((h >= 0) & (h < Hb), base - Hb + h,
                            torch.where((h >= Hb) & (h < 2 * Hb),
                                        base + Lb + h - Hb, -1)))
            src = torch.where((src < 0) | (src >= D * Lb), D * Lb, src)
            src = src.reshape(-1)
            Xz = torch.cat([X, X.new_zeros((1, m))])
            if not torch.equal(torch.index_select(Xz, 0, src), want):
                raise AssertionError("the index_select yardstick differs")
            ms, plain_ms = median_ms(kern), median_ms(plain)
            library_ms = median_ms(lambda: torch.index_select(Xz, 0, src))
            nbytes = X.numel() * 4 + got.numel() * 4
            b_ms, b_by = bound_ms(nbytes, 0, "f32")
            # the copy unit the wrapper chose: the plan's, narrowed to the
            # pointers
            unit = halo.copy_unit(halo.ring_shift_plan(
                D, Lb, Hb, own, pad, m * 4)[0], X, got)
            row = {"kernel": "ring_shift", "grid": GRID, "shards": D, "m": m,
                   "own": own, "rows_out": got.shape[0], "max_abs_err": 0.0,
                   "bitwise_equal_plain": True, "unit_bytes": unit,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                   "launch_floor_ms": floor_ms,
                   "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
                   "GB_per_s": nbytes / ms / 1e6}
            log(row)
            if own and m == 9:  # the "rdma" blocked-ELL apply's exchange
                stats["ring_shift"].update({k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "launch_floor_ms", "unit_bytes")})
        dpl_chk = dpl.halo_checksum(X).item()
        if dpl_chk != 0.0:
            raise AssertionError(f"halo checksum {dpl_chk}")
        # K5: one and two streams, bit for bit K2 + the plain transport
        for streams in ("b", "ab"):
            kern = lambda: halo.union_interior_overlap(du.Ui, X, D, Hb,
                                                       streams)
            plain = lambda: halo.union_interior_overlap_ref(du.Ui, X, D, Hb,
                                                            streams)
            got, want = kern(), plain()
            split = [spmm.bellunion_matmat(du.Ui, X, s) for s in streams]
            split.append(halo.ppermute(X, D, Hb))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, split))
            if not same:
                raise AssertionError(f"K5 {streams} m={m} != K2 + transport")
            abs_err, scale = _check_close(f"union_interior_overlap {streams}",
                                          got, want, TOL["highest"])
            ms, plain_ms = median_ms(kern), median_ms(plain)
            lib = lib_i[streams]
            library_ms = median_ms(lambda: torch.sparse.mm(lib, X))
            mat = {"b": Mi, "ab": None}[streams]
            nnz = Mi.nnz if mat is not None else Ki.nnz + Mi.nnz
            # interior values and columns, row pointers per stream, X read
            # once, each Y and the halo section written once
            nbytes = (nnz * 8 + len(streams) * (du.global_rows + 1) * 4
                      + X.numel() * 4 * (1 + len(streams))
                      + D * 2 * Hb * m * 4)
            b_ms, b_by = bound_ms(nbytes, nnz * m * 2, "f32")
            layout_bytes, fill_bytes = union_bytes(du.Ui, len(streams), m)
            row = {"kernel": "union_interior_overlap", "grid": GRID,
                   "shards": D, "streams": streams, "m": m,
                   "max_abs_err": abs_err, "rel_err": abs_err / scale,
                   "bitwise_equal_k2_and_transport": same, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": library_ms,
                   "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by,
                   "layout_bytes": layout_bytes,
                   "layout_GB_per_s": layout_bytes / ms / 1e6,
                   "fill_bytes": fill_bytes}
            log(row)
            st = stats["union_interior_overlap"]
            st["max_abs_err"] = max(st["max_abs_err"], abs_err)
            if streams == "ab" and m == 9:  # LOBPCG's W, the CG sweeps
                st.update({k: row[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
        # the sharded products against the one-device union pencil
        Xs = torch.zeros((single.n_padded, m), device=dev)
        Xs[:n] = X[:n]
        for dp in (du, dpl):
            for which in ("K", "M"):
                Yd = (dp.K_mm if which == "K" else dp.M_mm)(X)[:n]
                Ys = (single.K_mm if which == "K" else single.M_mm)(Xs)[:n]
                torch.cuda.synchronize()
                err, scale = _check_close(
                    f"spmm_dist {dp.kernel} {which} m={m}", Yd, Ys, 2e-5)
                log({"check": "spmm_dist_vs_single", "kernel": dp.kernel,
                     "halo_impl": dp.halo_impl, "op": which, "m": m,
                     "rel_err": err / scale})
    del single, lib_i
    torch.cuda.empty_cache()
    return stats


def phase_dist_solves(problem, pencils):
    """Slice 5's solves: lobpcg_dist on the 8-shard 24^3 brick at slice 1's
    knobs (tol 1e-5, maxiter 120, stall_window 12, a seeded X0, shifted CG
    with the smallest analytic eigenvalue), union + "rdma_overlap" and
    "pallas" + "rdma", each run twice (bitwise equal), counts zeroed just
    before each run and read just after; their eigenvalues against the
    one-device 24^3 union solve's; then thick_restart_lanczos_dist on the
    8-shard 16x16 rectangle ("pallas" + "rdma"). Returns {name: counts}."""
    import maxwell_tpu_torch
    from maxwell_tpu_torch.dist import partition_problem
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
    from maxwell_tpu_torch.solvers.trlanczos import thick_restart_lanczos_dist

    tol = 1e-5
    n = problem.K.shape[0]
    X0 = np.random.default_rng(5).standard_normal((n, 9))
    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    one = maxwell_tpu_torch.solve(
        problem, kernel="union", dtype=torch.float32, device="cuda", nev=NEV,
        tol=tol, refine=False, maxiter=120, stall_window=12, X0=X0)
    log({"phase": "dist_single_reference", "grid": GRID,
         "converged": one.converged, "iterations": one.iterations,
         "eigenvalues": [float(v) for v in one.eigenvalues]})
    out = {}
    required = {"union": ("union_interior_overlap", "bellunion_matmat"),
                "pallas": ("ring_shift", "bsr_matmat")}
    for kernel, dp in pencils.items():
        runs = []
        for _ in range(2):
            reset_all_counts()
            t0 = time.perf_counter()
            res = lobpcg_dist(dp, nev=NEV, maxiter=120, tol=tol,
                              stall_window=12, X0=X0,
                              precond_alpha=float(exact[0]))
            torch.cuda.synchronize()
            runs.append((res, all_counts(), time.perf_counter() - t0))
        (res, counts, wall), (res2, _, wall2) = runs
        hist = [h["max_rel_res"] for h in res.history]
        identical = (hist == [h["max_rel_res"] for h in res2.history]
                     and np.array_equal(res.eigenvectors, res2.eigenvectors))
        rel_one = np.abs(res.eigenvalues - one.eigenvalues) / one.eigenvalues
        rel = np.abs(res.eigenvalues - exact) / exact
        log({"phase": "dist_solve", "grid": GRID, "shards": dp.D,
             "kernel": kernel, "halo_impl": dp.halo_impl,
             "converged": res.converged, "iterations": res.iterations,
             "eigenvalues": [float(v) for v in res.eigenvalues],
             "rel_to_single_device": [float(v) for v in rel_one],
             "analytic_rel_err": [float(v) for v in rel],
             "residuals": [float(v) for v in res.residuals],
             "history_max_res": hist, "repeat_identical": identical,
             "wall_s": wall, "repeat_wall_s": wall2,
             "ms_per_iteration": wall / max(res.iterations, 1) * 1e3,
             "device": torch.cuda.get_device_name(0),
             "nvidia_smi": nvidia_smi_line(),
             "counts": {k: v for k, v in counts.items() if v}})
        if not res.converged or res.residuals.max() > tol:
            raise AssertionError(f"dist {kernel} not converged: "
                                 f"{res.residuals}")
        if not identical:
            raise AssertionError(f"two runs of the dist {kernel} solve differ")
        if not np.all(np.isfinite(res.eigenvectors)) or (
                res.eigenvectors.shape != (n, NEV)):
            raise AssertionError("dist solve eigenvectors: shape or values")
        if not rel_one.max() <= 1e-4:
            raise AssertionError(f"dist {kernel} vs one device: {rel_one}")
        for name in required[kernel]:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched by the "
                                     f"dist {kernel} solve")
        stray = {k: v for k, v in counts.items() if v and k.endswith("_ref")}
        if stray:
            raise AssertionError(f"plain versions ran on the card: {stray}")
        out[kernel] = counts

    cav = RectCavity2D(nx=16, ny=16)
    dp = partition_problem(cav, SHARDS, kernel="pallas", dtype=torch.float32,
                           halo_impl="rdma", device="cuda")
    reset_all_counts()
    t0 = time.perf_counter()
    res = thick_restart_lanczos_dist(dp, nev=3, ncv=20, max_restarts=40,
                                     tol=1e-5)
    torch.cuda.synchronize()
    counts = all_counts()
    exact2 = np.sort(cav.analytic_eigenvalues(3))
    rel = np.abs(np.sort(res.eigenvalues) - exact2) / exact2
    log({"phase": "dist_trlanczos", "problem": "rect 16x16",
         "shards": dp.D, "H": dp.H, "L": dp.L, "converged": res.converged,
         "iterations": res.iterations,
         "eigenvalues": [float(v) for v in res.eigenvalues],
         "residuals": [float(v) for v in res.residuals],
         "analytic_rel_err": [float(v) for v in rel],
         "wall_s": time.perf_counter() - t0,
         "counts": {k: v for k, v in counts.items() if v}})
    if not res.converged or not rel.max() <= 2.5e-2:
        raise AssertionError(f"dist thick-restart Lanczos: {res}")
    if counts["ring_shift"] <= 0 or counts["bsr_matvec"] <= 0:
        raise AssertionError(f"dist thick-restart Lanczos counts: {counts}")
    out["trlanczos"] = counts
    return out


def phase_dist_cli():
    """Config 4 through the CLI on cuda: (a) as written (f64, 16^3, 8
    shards: deep halos, the plain blocked-ELL apply on the card), (b) f32
    "union" + host refine to 1e-8, the reference's TPU route."""
    path = os.path.join(CONFIGS, "config4.json")
    with open(path) as f:
        cfg = json.load(f)
    b = json.loads(json.dumps(cfg))
    b["storage"] = {"dtype": "f32", "kernel": "union"}
    b["solver"]["refine"] = True
    reports = {}
    with tempfile.TemporaryDirectory() as tmp:
        for key, variant in (("a", cfg), ("b", b)):
            p = path
            if key == "b":
                p = os.path.join(tmp, "config4_union.json")
                with open(p, "w") as f:
                    json.dump(variant, f)
            rc, rep, cnt, wall = run_cli(p)
            reports[key] = rep
            log({"phase": "dist_cli", "config": "config4", "variant": key,
                 "storage": variant["storage"], "rc": rc, "wall_s": wall,
                 **{k: rep.get(k) for k in (
                     "converged", "iterations", "n", "t_solve_s",
                     "t_refine_s", "eigenvalues", "residuals",
                     "analytic_rel_err")},
                 "counts": {k: v for k, v in cnt.items() if v}})
            if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
                raise AssertionError(f"config 4 ({key}) through the CLI: {rep}")
            if max(rep["analytic_rel_err"]) > 2.5e-2:
                raise AssertionError(f"config 4 ({key}) vs analytic: {rep}")
            stray = {k: v for k, v in cnt.items() if v and k.endswith("_ref")}
            if stray or (key == "b" and cnt["bellunion_matmat"] <= 0):
                raise AssertionError(f"config 4 ({key}) counts: {cnt}")
    ev_a = np.asarray(reports["a"]["eigenvalues"])
    rel = np.abs(np.asarray(reports["b"]["eigenvalues"]) - ev_a) / ev_a
    if not rel.max() <= 1e-8:
        raise AssertionError(f"config 4 (b) vs (a): {rel}")


def phase_bellpairs_cli():
    """Config 2 (2D, 32x32) through the CLI on cuda with `storage: {"dtype":
    "f32", "kernel": "bellpairs"}`, refined to 1e-8 on the host. Returns its
    counts."""
    path = os.path.join(CONFIGS, "config2.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["storage"] = {"dtype": "f32", "kernel": "bellpairs"}
    cfg["solver"]["refine"] = True
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "config2_bellpairs.json")
        with open(p, "w") as f:
            json.dump(cfg, f)
        rc, rep, cnt, wall = run_cli(p)
    log({"phase": "bellpairs_cli", "config": "config2", "rc": rc,
         "storage": cfg["storage"], "wall_s": wall,
         **{k: rep.get(k) for k in (
             "converged", "iterations", "n", "t_solve_s", "t_refine_s",
             "eigenvalues", "residuals", "analytic_rel_err")},
         "counts": {k: v for k, v in cnt.items() if v}})
    if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
        raise AssertionError(f"config 2 (bellpairs) through the CLI: {rep}")
    if max(rep["analytic_rel_err"]) > 2.5e-2:
        raise AssertionError(f"config 2 (bellpairs) vs analytic: {rep}")
    stray = {k: v for k, v in cnt.items()
             if v and (k.endswith("_ref") or not k.startswith("bellpairs_"))}
    if cnt["bellpairs_km_matmat"] <= 0 or stray:
        raise AssertionError(f"config 2 (bellpairs) counts: {cnt}")
    return cnt


def phase_union_probes():
    """The tile-union probes at their full default sizes, through the
    probe scripts' own run() (no subprocess): K15a (exp_union.run, T 298,
    UC 128: u0_hi, u0_def, u1_runs, u2_km) and K15b (exp_union2.run on the
    24^3 RCM K: six layouts, m in {8, 9}, union_unstaged beside K2). The
    probe scripts hold every kernel and K15a's library calls against
    their plain versions (1e-5 of max|plain|; u0_def against the plain
    product of bf16-rounded operands, its TF32 and bf16-output library
    calls at 1e-2) and K15b against scipy (1e-5), and raise past it; their
    oracles are uncounted. Counts are zeroed just before and read just
    after: every probe kernel launched, no plain version called. One JSON
    line per variant. Returns (stats of the kernels line, counts)."""
    from maxwell_tpu_torch.bench import exp_union, exp_union2
    from maxwell_tpu_torch.kernels import union_probes as up

    reset_all_counts()
    t0 = time.perf_counter()
    r1 = exp_union.run()
    t1 = time.perf_counter()
    r2 = exp_union2.run(GRID, ms=(8, 9))
    t2 = time.perf_counter()
    counts = all_counts()
    torch.cuda.empty_cache()
    panel = ("u0_hi", "u0_def", "u1_runs", "u2_km")
    log({"phase": "exp_union", "seconds": t1 - t0,
         **{k: v for k, v in r1.items() if k not in panel}})
    for name in panel:
        log({"probe": "exp_union", "variant": name, **r1[name]})
    log({"phase": "exp_union2", "seconds": t2 - t1,
         **{k: v for k, v in r2.items() if k != "variants"}})
    for name, v in r2["variants"].items():
        log({"probe": "exp_union2", "variant": name, **v})

    worst = max(v[f"m{m}"]["unstaged"]["max_abs_err"]
                for v in r2["variants"].values() for m in (8, 9)
                if "unstaged" in v[f"m{m}"])
    for name in (*probes_of("exp_union", "exp_union2"), "bellunion_matmat"):
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the probes")
    stray = {k: v for k, v in counts.items() if v and k.endswith("_ref")}
    if stray:
        raise AssertionError(f"plain versions ran on the card: {stray}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    stats = {name: {"max_abs_err": r1[name]["max_abs_err"],
                    **{k: r1[name][k] for k in (*keys, "library_bf16_ms")
                       if k in r1[name]}} for name in panel}
    # the kernels line reports the unstaged kernel on the reference's
    # production layout (1024, 2) at the probe's m = 8
    pm = r2["variants"]["pair1024"]["m8"]
    stats["union_unstaged"] = {
        "max_abs_err": worst, "ms": pm["unstaged"]["ms"],
        **{k: pm[k] for k in keys[1:]}}
    return stats, {name: counts[name] for name in up.counts()}


def phase_grid_and_stencil_probes():
    """The BELLPairs per-tile probe (K15d: exp_grid.run, T 298, e0-e5, then
    K11 at m 8 on the 24^3 K) and the tap-stencil shift probe (K15f:
    exp_stencil2.run, the 64^3 field at m 8 and 9, p0-p6, then K4 fused at
    64^3, m 9), at their full default sizes through the probe scripts' own
    run(). The scripts hold every kernel against its plain version (1e-5 of
    max|plain|; p5 and p6 also against p1's and p3's plain output) and raise
    past it; their oracles are uncounted. Counts are zeroed just before and
    read just after: every probe kernel launched, no plain version called.
    One JSON line per variant. Returns (stats of the kernels line, counts);
    a shift case reports m 8 (the reference's default) with m 9 beside."""
    from maxwell_tpu_torch.bench import exp_grid, exp_stencil2

    reset_all_counts()
    t0 = time.perf_counter()
    r1 = exp_grid.run()
    t1 = time.perf_counter()
    r2 = exp_stencil2.run()
    t2 = time.perf_counter()
    counts = all_counts()
    torch.cuda.empty_cache()
    log({"phase": "exp_grid", "seconds": t1 - t0,
         **{k: v for k, v in r1.items() if k not in GRID_PROBES}})
    # e3-e5's launch: gather_sum's plan (e3) and the row plans (e4, e5):
    # grid, the blocks' slots or rows, registers, blocks per SM
    log({"grid_launch": {name: r1[name]["launch"]
                         for name in exp_grid.GATHERS}})
    for name in GRID_PROBES:
        log({"probe": "exp_grid", "variant": name, **r1[name]})
    log({"phase": "exp_stencil2", "seconds": t2 - t1, "grid": r2["grid"],
         "k4": r2["k4"]})
    # the shift kernel's launch per case and m: window, chunk, shared
    # memory, bytes staged beside the field's, registers, blocks per SM
    log({"shift_launch": {
        **{f"p{k}": {f"m{m}": r2[f"m{m}"][f"p{k}"]["launch"] for m in (8, 9)}
           for k in range(7)},
        "p3_same_outputs": r2["k4"]["p3_same_outputs"]["launch"]}})
    for m in (8, 9):
        res = r2[f"m{m}"]
        log({"probe": "exp_stencil2", "m": m,
             **{k: v for k, v in res.items() if not k.startswith("p")}})
        for case in (f"p{k}" for k in range(7)):
            log({"probe": "exp_stencil2", "variant": case, "m": m,
                 **res[case]})

    mine = probes_of("exp_grid", "exp_stencil2")
    for name in mine:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the probes")
    stray = {k: v for k, v in counts.items() if v and k.endswith("_ref")}
    if stray:
        raise AssertionError(f"plain versions ran on the card: {stray}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    stats = {name: {"max_abs_err": r1[name]["max_abs_err"],
                    **{k: r1[name][k] for k in (*keys, "l2_floor_ms")
                       if k in r1[name]}}
             for name in GRID_PROBES}
    for k in range(7):
        m8, m9 = r2["m8"][f"p{k}"], r2["m9"][f"p{k}"]
        stats[f"shift_p{k}"] = {
            "max_abs_err": max(m8["max_abs_err"], m9["max_abs_err"]),
            **{key: m8[key] for key in keys},
            "m9": {key: m9[key] for key in ("max_abs_err", *keys)}}
    # p3 on the grid-91 field (K4's output count), with its byte bound
    p3 = r2["k4"]["p3_same_outputs"]
    stats["shift_p3"]["p3_grid91"] = {
        key: p3[key] for key in ("grid", "max_abs_err", "ms", "bound_ms",
                                 "bound_by")}
    return stats, {name: counts[name] for name in mine}


def phase_spmm_and_gather_probes():
    """The blocked-ELL SpMM probe (K15c: exp_spmm.run, the 24^3 RCM K at m
    in {8, 32, 64, 128}, v1-v6, then K8, K11 and K12 beside) and the
    X-gather probe (K15e: exp_gather.run, T 298, S 64, g0-g5 and g3w), at
    their full default sizes through the probe scripts' own run(). The
    scripts hold every kernel and every library call against its plain
    version (1e-5 of max|plain|; the _def variants against the product of
    bf16-rounded operands, the TF32 and bf16-output library calls at 1e-2,
    K12 also against (K + M) X in f64) and raise past it; their oracles
    are uncounted. Counts are zeroed just before and read just after: every
    probe kernel launched, no plain version called. One JSON line per
    variant, and the gather kernels' launches (gather_launch, taa_launch).
    Returns (stats of the kernels line, counts); a K15c variant reports m 8
    with m 32, 64 and 128 beside, g2, g3 and g5 their chain_ms and both
    launch floors."""
    from maxwell_tpu_torch.bench import exp_gather, exp_spmm

    reset_all_counts()
    t0 = time.perf_counter()
    r1 = exp_spmm.run()
    t1 = time.perf_counter()
    r2 = exp_gather.run()
    t2 = time.perf_counter()
    counts = all_counts()
    torch.cuda.empty_cache()
    widths = [k for k in r1 if k.startswith("m") and k[1:].isdigit()]
    log({"phase": "exp_spmm", "seconds": t1 - t0,
         **{k: v for k, v in r1.items() if k not in widths}})
    for w in widths:
        for name, row in r1[w].items():
            log({"probe": "exp_spmm", "variant": name, "m": int(w[1:]),
                 **row})
    # the _def rungs' launch: v2's unit, pass width, largest union and
    # shared memory; both rungs' registers and resident blocks per SM
    log({"def_launch": {name: {w: r1[w][name]["launch"] for w in widths}
                        for name in ("v2_panel_def", "v5_batched_def")}})
    log({"phase": "exp_gather", "seconds": t2 - t1,
         **{k: v for k, v in r2.items() if k not in GATHER_PROBES}})
    # gather_sum's launch: grid, the blocks' slot counts, cut tiles, union
    # sizes, slice bytes and the unions', registers, blocks per SM
    log({"gather_launch": {
        **{name: r2[name]["launch"]
           for name in ("g0_slices", "g1_slices2x", "g4_lane_ds")},
        "v4_gather": {w: r1[w]["v4_gather"]["launch"] for w in widths}}})
    # g2's and g3's launch at the probe's shape: grid, units and the
    # blocks' unit counts, registers, local and shared memory
    from maxwell_tpu_torch.kernels import gather_probes as gpr

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    taa = {}
    for name, kind in (("g2_taa0", "taa0"), ("g3_taa1", "taa1")):
        plan = gpr.taa_plan(kind, r2["T"], r2["P"], sms)
        taa[name] = {**plan.summary(), **gpr.taa_shape(plan)}
    log({"taa_launch": taa})
    for name in GATHER_PROBES:
        log({"probe": "exp_gather", "variant": name, **r2[name]})

    mine = probes_of("exp_spmm", "exp_gather")
    for name in mine:
        if counts[name] <= 0:
            raise AssertionError(f"{name} was not launched by the probes")
    stray = {k: v for k, v in counts.items() if v and k.endswith("_ref")}
    if stray:
        raise AssertionError(f"plain versions ran on the card: {stray}")
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_bf16_ms")
    stats = {name: {k: r2[name][k] for k in (
        *keys, "l2_floor_ms", "chain_ms", "launch_floor_ms",
        "chain_floor_ms") if k in r2[name]} for name in GATHER_PROBES}
    for name in SPMM_PROBES:
        stats[name] = {
            **{k: r1["m8"][name][k] for k in keys if k in r1["m8"][name]},
            **{w: {k: r1[w][name][k] for k in keys if k in r1[w][name]}
               for w in widths if w != "m8"}}
    return stats, {name: counts[name] for name in mine}


def stacked_csr(dp, A, blocks):
    """The CSR of a one-device operator A (rows in `blocks` stacked copies
    of the global stencil layout, padded) moved to the slab pencil's stacked
    layout: read each global column from the stacked row that
    gather_vector reads, write each stacked row from its global row. On
    vectors whose interface copies agree it is the slab apply's function:
    the library call's operand."""
    import scipy.sparse as sp

    idx, valid = (t.cpu().numpy() for t in dp._scatter_idx())
    rows = np.nonzero(valid)[0]
    G, n_pad = dp.global_rows, A.shape[1]
    R = sp.csr_matrix((np.ones(rows.size), (rows, idx[rows])),
                      shape=(G, n_pad))
    src = np.empty(dp.n_full, np.int64)
    src[idx[rows]] = rows  # the last copy wins, as in gather_vector
    C = sp.csr_matrix((np.ones(dp.n_full), (np.arange(dp.n_full), src)),
                      shape=(n_pad, G))
    return (sp.block_diag([R] * blocks) @ A @ C).tocsr()


def phase_dist_stencil_kernels():
    """The tap kernel K4 on ghost-extended slabs: the 64^3 vacuum PEC brick
    in 8 slabs (cells 8: each slab's extended block a (10, 64, 64) brick),
    the slab apply through K4 (8 launches a column pass, with the extended
    blocks' build and the owned planes' extraction) against the plain slab
    apply on the same card, modes K, M, KM at m 1, 9 and 171, within 1e-5
    of max|plain|; each timed beside the plain slab apply, the one-brick K4
    at 64^3 and one torch.sparse.mm on the mode's stacked CSR, each CSR
    checked on a vector with agreeing interface copies. Returns the stats
    of fused K/M at m 9, with "m1" and "m171". The slab apply's ms and
    plain_ms and the library's library_ms are device_ms (each call queued
    whole behind a device sleep: the device's time); call_ms and
    library_call_ms are median_ms (the host's enqueue included)."""
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.kernels import stencil_taps as kst
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D

    g = STENCIL_GRID
    dev = torch.device("cuda")
    dp = DistStencilPencil3D.build(nx=g, ny=g, nz=g, D=SHARDS,
                                   dtype=torch.float32, device=dev)
    one = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=torch.float32,
                                device=dev)
    t0 = time.perf_counter()
    libs = {mode: torch_csr(stacked_csr(dp, stencil_csr(one, *want),
                                        want[0] + want[1]), dev)
            for mode, want in STENCIL_MODES.items()}
    log({"phase": "dist_stencil_csr", "seconds": time.perf_counter() - t0,
         "nnz": {mode: A.values().numel() for mode, A in libs.items()}})
    # each CSR is the slab apply's function on a vector whose interface
    # copies agree (the layout maps', make_block's)
    Xc = dp.make_block(3, torch.Generator(dev).manual_seed(3))
    for mode, (want_K, want_M) in STENCIL_MODES.items():
        Yl = torch.sparse.mm(libs[mode], Xc)
        Yk = torch.cat([Y for Y in dp._taps_apply_slab(Xc, want_K, want_M)
                        if Y is not None])
        lib_err = (Yl - Yk).abs().max().item()
        if not lib_err <= TOL["stencil"] * Yk.abs().max().item():
            raise AssertionError(f"stacked CSR {mode} off: {lib_err:.3e}")
    taps_per_row = np.mean([len(t) for t in dp.taps])
    rows = dp.mask.sum().item()
    rng = np.random.default_rng(2)
    G = dp.global_rows
    st = {"max_abs_err": 0.0, "slabs": dp.D, "ext_shape": list(dp.ext_shape),
          "n_full": dp.n_full, "global_rows": G}
    for m in (1, 9, 171):
        # random on every row (masked, padding and both interface copies)
        X = torch.from_numpy(
            rng.standard_normal((G, m)).astype(np.float32)).to(dev)
        Xone = torch.from_numpy(
            rng.standard_normal((one.n_padded, m)).astype(np.float32)).to(dev)
        for mode, (want_K, want_M) in STENCIL_MODES.items():
            kern = lambda: dp._taps_apply_slab(X, want_K, want_M)
            plain = lambda: dp._taps_apply_plain(X, want_K, want_M)
            kst.reset_counts()
            got = kern()
            torch.cuda.synchronize()
            if kst.counts() != {"stencil_taps": dp.D * len(
                    kst.column_passes(m)), "stencil_taps_ref": 0}:
                raise AssertionError(f"slab apply counts: {kst.counts()}")
            want = plain()
            pairs = [(a, b) for a, b in zip(got, want) if b is not None]
            abs_err = max((a - b).abs().max().item() for a, b in pairs)
            scale = max(b.abs().max().item() for _, b in pairs)
            if not abs_err <= TOL["stencil"] * scale:
                raise AssertionError(
                    f"slab stencil_taps {mode} m={m}: max error {abs_err:.3e}"
                    f" > {TOL['stencil']} * {scale:.3e}")
            # an apply is tens (plain: hundreds) of launches, the host's
            # enqueue longer than the device's work at m <= 9: time each
            # call queued whole behind a device sleep (the device's time),
            # and the slab apply by median_ms too (what a caller waits,
            # the host's enqueue included)
            ms, plain_ms = device_ms(kern), device_ms(plain)
            call_ms = median_ms(kern)
            one_ms = median_ms(lambda: kst.stencil_taps(
                Xone, one.mask, one.taps, one.shape, want_K, want_M))
            # the library call on both timers: device_ms beside ms,
            # median_ms beside call_ms
            lib = libs[mode]
            library_ms = device_ms(lambda: torch.sparse.mm(lib, X))
            library_call_ms = median_ms(lambda: torch.sparse.mm(lib, X))
            ops = len(pairs)
            nbytes = G * m * 4 + G * 4 + ops * G * m * 4
            flops = ops * rows * taps_per_row * 2 * m
            b_ms, b_by = bound_ms(nbytes, flops, "f32")
            row = {"max_abs_err": abs_err, "rel_err": abs_err / scale,
                   "ms": ms, "plain_ms": plain_ms, "call_ms": call_ms,
                   "single_brick_ms": one_ms,
                   "library_ms": library_ms,
                   "library_call_ms": library_call_ms, "bound_ms": b_ms,
                   "bound_by": b_by, "bytes": nbytes,
                   "launches_per_apply": dp.D * len(kst.column_passes(m))}
            log({"kernel": "stencil_taps", "route": "slab", "mode": mode,
                 "m": m, **row})
            st["max_abs_err"] = max(st["max_abs_err"], abs_err)
            if mode == "KM" and m == 9:
                st.update(row)
            elif mode == "KM":
                st[f"m{m}"] = row
            del got, want
        del X, Xone
    del libs, lib
    torch.cuda.empty_cache()
    return st


def phase_dist_stencil_solve():
    """The reference bench's `dist time_to_1e8_64` row in 8 slabs: the 64^3
    vacuum PEC brick as a slab pencil, f32 lobpcg_dist with the distributed
    spectral preconditioner (alpha 15, nev 5, maxiter 60, tol 2e-6,
    stall_window 10, a seeded start block), then refine_dw_dist to 1e-8;
    counts zeroed just before, read just after. Gates: f64-verified
    residual <= 2e-8 against the one-device f64 pencil, eigenvalues within
    0.5% of the analytic ones, stencil_taps launched on the path."""
    from maxwell_tpu_torch.dist import make_mesh
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.problems.analytic import cavity_eigenvalues_3d
    from maxwell_tpu_torch.solvers.dist_solve import lobpcg_dist
    from maxwell_tpu_torch.solvers.refine_device import refine_dw_dist

    g = STENCIL_GRID
    mesh = make_mesh(SHARDS, "cuda")
    reset_all_counts()
    t0 = time.perf_counter()
    dp = DistStencilPencil3D.build(nx=g, ny=g, nz=g, D=SHARDS,
                                   dtype=torch.float32, device="cuda")
    X0 = dp.make_block(NEV + 4, torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res32 = lobpcg_dist(dp, mesh, nev=NEV, maxiter=60, tol=2e-6,
                        precond="spectral", precond_alpha=15.0,
                        stall_window=10, X0=X0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    lobpcg_counts = all_counts()
    ref = refine_dw_dist(dp, mesh, res32.eigenvectors, tol=1e-8)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = all_counts()

    verified = f64_residuals(ref.eigenvectors, ref.eigenvalues)
    exact = cavity_eigenvalues_3d(1.0, 1.0, 1.0, NEV)
    rel = np.abs(np.sort(ref.eigenvalues) - exact) / exact
    launches = lobpcg_counts["stencil_taps"]
    out = {
        "phase": "dist_stencil_solve", "grid": g, "slabs": SHARDS,
        "n_full": dp.n_full, "global_rows": dp.global_rows,
        "setup_s": t1 - t0, "lobpcg_s": t2 - t1, "refine_s": t3 - t2,
        "wall_s": t3 - t0, "lobpcg_iterations": res32.iterations,
        "lobpcg_max_res": float(res32.residuals.max()),
        "refine_sweeps": ref.iterations - 1, "converged": ref.converged,
        "eigenvalues": [float(v) for v in ref.eigenvalues],
        "analytic_rel_err": [float(v) for v in rel],
        "residuals_dw": [float(v) for v in ref.residuals],
        "residuals_f64_verified": [float(v) for v in verified],
        "stencil_taps_launches_lobpcg": launches,
        "launches_per_lobpcg_iteration": launches / max(res32.iterations, 1),
        "counts": {k: v for k, v in counts.items() if v},
    }
    log(out)
    if not ref.converged or ref.residuals.max() > 1e-8:
        raise AssertionError(f"refine_dw_dist not converged: {ref.residuals}")
    if not verified.max() <= 2e-8:
        raise AssertionError(f"f64-verified residuals {verified}")
    if not np.all(np.isfinite(ref.eigenvectors)) or (
        ref.eigenvectors.shape != (dp.n_full, NEV)
    ):
        raise AssertionError("refined eigenvectors: shape or values")
    if not rel.max() <= 5e-3:
        raise AssertionError(f"eigenvalues off the analytic modes: {rel}")
    if counts["stencil_taps"] <= 0 or counts["stencil_taps_ref"] != 0:
        raise AssertionError(f"slab stencil path counts: {counts}")
    return out


def phase_dist_stencil_cli():
    """Configs 4_stencil (32^3, 8 slabs, nev 5) and 5 (32^3, 8 slabs, nev
    20 in stages of 10, each stage polished by refine_dw_dist) through the
    CLI on cuda as written: f64, so the plain slab apply (the tap kernel is
    f32), and no kernel launched. Returns {config: (report, wall s)}."""
    out = {}
    for name in ("config4_stencil", "config5"):
        rc, rep, cnt, wall = run_cli(os.path.join(CONFIGS, f"{name}.json"))
        log({"phase": "dist_stencil_cli", "config": name, "rc": rc,
             "wall_s": wall,
             **{k: rep.get(k) for k in (
                 "converged", "iterations", "n", "t_solve_s", "t_refine_s",
                 "eigenvalues", "residuals", "analytic_rel_err")},
             "counts": {k: v for k, v in cnt.items() if v}})
        if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
            raise AssertionError(f"{name} through the CLI: {rep}")
        if max(rep["analytic_rel_err"]) > 2.5e-2:
            raise AssertionError(f"{name} vs analytic: {rep}")
        if any(cnt.values()):
            raise AssertionError(f"{name} (f64) launched: {cnt}")
        out[name] = (rep, wall)
    return out


SI_GRID = 128  # slice 10: the reference probe's 2D shift-invert row
SI_SIGMA = 45.0  # config 3's shift
SI_STENCIL_SIGMA = 60.0  # the probe's 64^3 stencil row: near 6 pi^2
SI_WIDTHS = (1, 4)


def _factor_csr(S):
    """The triangular factor of S (diagonal and off-diagonal entries) as a
    scipy CSR, for the library call."""
    import scipy.sparse as sp

    n = S.n
    cols = S.cols.cpu().numpy()
    rows = np.broadcast_to(S.rows.cpu().numpy()[:, :, None], cols.shape)
    vals = S.vals.cpu().double().numpy()
    keep = cols < n
    T = sp.csr_matrix((vals[keep], (rows[keep], cols[keep])), shape=(n, n))
    return (T + sp.diags(S.diag.cpu().double().numpy())).tocsr()


def phase_tri_solve_kernels():
    """The level-scheduled triangular solve (level_solve) against its plain
    version on the 128^2 rectangle's LDL^T factors L and L^T at sigma 45
    (chains of 32,512 levels) and config 3's splu factors L and U, at f32
    and f64 and m in {1, 4}. Two gates on every case: (1) the kernel's
    componentwise backward error (tri_solve.backward_error) at most 2, the
    bound substitution meets in any summation order; (2) the kernel within
    max(16 g, 8) eps max|x| of the plain version in the same dtype, g =
    max|plain_f32 - plain_f64| / (eps_f32 max|x|), how far rounding grows
    along this chain for these inputs (the f32 LDL^T solve at 128^2 is
    off the f64 one by 5e-5 to 4.5e-3). Two kernel runs must agree bit for
    bit. Each case timed on the device alone (device_ms, one launch a
    call), the plain version by its one call between synchronizes
    (host-bound: about 7 launches a level), beside the byte bound, the
    level count, the launch floor, the chain floor (tri_solve.level_chain:
    the 16-warp tag hand-off floor, no loads, over as many positions as
    the factor has levels), the route (x's window in shared or device memory), the
    window and the library call: torch.triangular_solve on the factor as a
    sparse CSR tensor, timed by wall_ms (it synchronizes). Returns the
    kernels-line stats."""
    from maxwell_tpu_torch.bench import profile_tri_solve
    from maxwell_tpu_torch.kernels import tri_solve

    dev = torch.device("cuda")
    floor = launch_floor_ms()
    t0 = time.perf_counter()
    factors = profile_tri_solve.factors(dev)
    torch.cuda.synchronize()
    L = factors[(f"ldlt{profile_tri_solve.GRID}", "L")][torch.float64]
    log({"phase": "tri_factor", "grid": profile_tri_solve.GRID, "n": L.n,
         "dtypes": ["f64", "f32"], "factor_s": time.perf_counter() - t0,
         "levels": L.n_levels, "L_shape": list(L.cols.shape),
         "Lt_shape": list(factors[(f"ldlt{profile_tri_solve.GRID}", "Lt")][
             torch.float64].cols.shape)})

    rng = np.random.default_rng(0)
    cases = {}
    stats = {"max_abs_err": 0.0, "launch_floor_ms": floor}
    chain_floor = {lv: profile_tri_solve.chain_floor_ms(lv, dev) for lv in
                   {d[torch.float64].n_levels for d in factors.values()}}
    for (prob, fac), by_dtype in factors.items():
        n = by_dtype[torch.float64].n
        B4 = torch.from_numpy(rng.standard_normal((n, 4))).to(dev)
        plain, plain_ms = {}, {}
        for dt, S in by_dtype.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain[dt] = tri_solve.level_solve_plain(S, B4.to(dt))
            torch.cuda.synchronize()
            plain_ms[dt] = (time.perf_counter() - t0) * 1e3
        p64 = plain[torch.float64]
        growth = ((plain[torch.float32].double() - p64).abs().max().item()
                  / (torch.finfo(torch.float32).eps * p64.abs().max().item()))
        for dt, S in by_dtype.items():
            dname = "f64" if dt == torch.float64 else "f32"
            eps = torch.finfo(dt).eps
            lib_T = torch_csr(_factor_csr(S), dev, dt)
            live = int(S.cnt.sum())
            for m in SI_WIDTHS:
                Bm = B4[:, :m].to(dt).contiguous()
                got = tri_solve.level_solve(S, Bm)
                again = tri_solve.level_solve(S, Bm)
                torch.cuda.synchronize()
                want = plain[dt][:, :m]
                scale = want.abs().max().item()
                err = (got - want).abs().max().item()
                tol = max(16 * growth, 8) * eps * scale
                berr = tri_solve.backward_error(S, Bm, got)
                label = f"{prob} {fac} {dname} m={m}"
                if not berr <= 2:
                    raise AssertionError(f"level_solve {label}: backward "
                                         f"error {berr:.3g} of its bound")
                if not err <= tol:
                    raise AssertionError(f"level_solve {label}: max error "
                                         f"{err:.3e} > {tol:.3e}")
                if not torch.equal(got, again):
                    raise AssertionError(f"level_solve {label}: two runs "
                                         f"differ")
                ms = device_ms(lambda: tri_solve.level_solve(S, Bm), n=5)
                nbytes, flops = profile_tri_solve.work(S, m, dt)
                b_ms, b_by = bound_ms(nbytes, flops, dname)
                upper = not S.lower
                lib = torch.triangular_solve(Bm, lib_T, upper=upper).solution
                torch.cuda.synchronize()
                library_ms = wall_ms(
                    lambda: torch.triangular_solve(Bm, lib_T, upper=upper))
                row = {"kernel": "level_solve", "factor": f"{prob} {fac}",
                       "dtype": dname, "m": m, "n": n, "levels": S.n_levels,
                       "shape": list(S.cols.shape), "live_slots": live,
                       "route": S.route(dt), "window": S.window,
                       "ring": S.ring(dt),
                       "chain_floor_ms": chain_floor[S.n_levels],
                       "max_abs_err": err, "rel_err": err / scale,
                       "tol_rel": tol / scale, "growth": growth,
                       "backward_error": berr, "bitwise_repeat": True,
                       "ms": ms, "us_per_level": ms * 1e3 / S.n_levels,
                       "plain_ms": plain_ms[dt], "bound_ms": b_ms,
                       "bound_by": b_by, "bytes": nbytes,
                       "launch_floor_ms": floor, "library_ms": library_ms,
                       "library_rel_err":
                           (lib - got).abs().max().item() / scale}
                log(row)
                cases[f"{prob}_{fac}_{dname}_m{m}"] = {
                    k: row[k] for k in ("levels", "route", "window",
                                        "rel_err", "ms", "plain_ms",
                                        "bound_ms", "chain_floor_ms",
                                        "library_ms")}
                stats["max_abs_err"] = max(stats["max_abs_err"], err)
                # the shape the main path gives the kernel: the 128^2 f32
                # shift-invert apply, one vector
                main = (f"ldlt{profile_tri_solve.GRID}", "L", "f32", 1)
                if (prob, fac, dname, m) == main:
                    stats.update(ms=ms, plain_ms=plain_ms[dt],
                                 bound_ms=b_ms, bound_by=b_by,
                                 library_ms=library_ms, levels=S.n_levels,
                                 window_route=S.route(dt),
                                 window=S.window,
                                 chain_floor_ms=chain_floor[S.n_levels])
    stats["cases"] = cases
    return stats


def phase_si_solve():
    """Slice 10's shift-invert solves, counts zeroed just before each and
    read just after:
    (a) config 3 through the CLI as written (f64, 16x16, sigma 45, the
        LDL^T backend: level_solve in f64), against golden rect2d_16x16's
        four eigenvalues nearest sigma to 1e-8;
    (b) the 128^2 rectangle on an f32 union pencil, backend "ldlt" with the
        problem's K and M, sigma 45, nev 4, maxiter 40, tol 1e-6, then
        refine_f64 to 1e-8 on the host: factor, apply (device_ms) and solve
        times, residuals before and after, two level_solve launches an
        apply; the refined eigenvalues within 1e-3 of the analytic ones
        nearest sigma (the 128^2 discretization error is ~1e-4);
    (c) the 64^3 stencil pencil with the MINRES backend (sigma 60, nev 3,
        maxiter 30, tol 1e-5), its applies through the tap kernel; its
        eigenvalues within 2e-3 of 6 pi^2, the triple mode nearest sigma
        (the 64^3 discretization error is 6e-4).
    Returns {"cli": counts, "ldlt": counts, "stencil": counts}."""
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.problems.analytic import te_eigenvalues_2d
    from maxwell_tpu_torch.problems.golden import golden_eigenvalues
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.operator import Pencil
    from maxwell_tpu_torch.solvers.refine import refine_f64
    from maxwell_tpu_torch.solvers.shift_invert import (
        build_shift_invert_op,
        shift_invert_lanczos,
    )

    def nearest(vals, sigma, k):
        vals = np.asarray(vals)
        return np.sort(vals[np.argsort(np.abs(vals - sigma))[:k]])

    out = {}
    # (a)
    path = os.path.join(CONFIGS, "config3.json")
    with open(path) as f:
        steps = json.load(f)["solver"]["maxiter"]
    rc, rep, cnt, wall = run_cli(path)
    golden, _, _ = golden_eigenvalues("rect2d_16x16")
    want = nearest(golden, SI_SIGMA, 4)
    rel = np.abs(np.sort(rep["eigenvalues"]) - want) / want
    log({"phase": "si_cli", "config": "config3", "rc": rc, "wall_s": wall,
         **{k: rep.get(k) for k in ("converged", "iterations", "n",
                                    "t_solve_s", "eigenvalues",
                                    "residuals")},
         "golden_rel_err": [float(v) for v in rel],
         "counts": {k: v for k, v in cnt.items() if v}})
    if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
        raise AssertionError(f"config3 through the CLI: {rep}")
    if not rel.max() <= 1e-8:
        raise AssertionError(f"config3 vs golden: {rel}")
    if cnt["level_solve"] != 2 * steps or cnt["level_solve_plain"]:
        raise AssertionError(f"config3 counts: {cnt}")
    out["cli"] = cnt

    # (b)
    cav = RectCavity2D(nx=SI_GRID, ny=SI_GRID)
    KM = (cav.K, cav.M)
    t0 = time.perf_counter()
    pencil = Pencil.from_problem(cav, kernel="union", dtype=torch.float32,
                                 device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = build_shift_invert_op(pencil, SI_SIGMA, backend="ldlt", KM=KM)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    x = pencil.project(torch.randn(pencil.n_padded, device="cuda",
                                   generator=torch.Generator(
                                       "cuda").manual_seed(1)))
    # host clock: the apply's projector (CG on the nodal system) reads its
    # residual on the host, so device_ms's sleep cannot hold it back
    apply_ms = wall_ms(lambda: op(x))
    del op
    maxiter = 40
    reset_all_counts()
    t0 = time.perf_counter()
    res = shift_invert_lanczos(
        pencil, SI_SIGMA, nev=4, maxiter=maxiter, tol=1e-6, backend="ldlt",
        KM=KM, generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = all_counts()
    t0 = time.perf_counter()
    ref = refine_f64(cav, res.eigenvectors, theta=res.eigenvalues, tol=1e-8)
    refine_s = time.perf_counter() - t0
    exact = nearest(te_eigenvalues_2d(1.0, 1.0, 20), SI_SIGMA, 4)
    rel = np.abs(np.sort(ref.eigenvalues) - exact) / exact
    log({"phase": "si_ldlt", "grid": SI_GRID, "n": cav.n_edges,
         "dtype": "f32", "kernel": "union", "setup_s": setup_s,
         "factor_s": factor_s, "apply_ms": apply_ms, "solve_s": solve_s,
         "refine_s": refine_s, "lanczos_steps": maxiter,
         "eigenvalues_f32": [float(v) for v in res.eigenvalues],
         "residuals_f32": [float(v) for v in res.residuals],
         "eigenvalues": [float(v) for v in ref.eigenvalues],
         "residuals_refined": [float(v) for v in ref.residuals],
         "refine_sweeps": ref.iterations, "converged": ref.converged,
         "analytic_rel_err": [float(v) for v in rel],
         "level_solve_per_apply": counts["level_solve"] / maxiter,
         "device": torch.cuda.get_device_name(0),
         "nvidia_smi": nvidia_smi_line(),
         "counts": {k: v for k, v in counts.items() if v}})
    if not ref.converged or ref.residuals.max() > 1e-8:
        raise AssertionError(f"128^2 shift-invert refine: {ref.residuals}")
    if not np.all(np.isfinite(ref.eigenvectors)) or (
            ref.eigenvectors.shape != (cav.n_edges, 4)):
        raise AssertionError("128^2 shift-invert eigenvectors")
    if not rel.max() <= 1e-3:
        raise AssertionError(f"128^2 shift-invert vs analytic: {rel}")
    if counts["level_solve"] != 2 * maxiter:
        raise AssertionError(f"level_solve launches: {counts}")
    stray = {k: v for k, v in counts.items() if v and k.endswith(
        ("_ref", "_plain"))}
    if stray:
        raise AssertionError(f"plain versions ran on the card: {stray}")
    out["ldlt"] = counts
    del pencil

    # (c)
    g = STENCIL_GRID
    stp = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=torch.float32,
                                device="cuda")
    reset_all_counts()
    t0 = time.perf_counter()
    res = shift_invert_lanczos(
        stp, SI_STENCIL_SIGMA, nev=3, maxiter=30, tol=1e-5,
        backend="iterative", generator=torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    counts = all_counts()
    exact = 6 * np.pi ** 2
    rel = np.abs(np.asarray(res.eigenvalues) - exact) / exact
    log({"phase": "si_stencil", "grid": g, "n": stp.n, "dtype": "f32",
         "solve_s": solve_s, "lanczos_steps": 30,
         "eigenvalues": [float(v) for v in res.eigenvalues],
         "residuals": [float(v) for v in res.residuals],
         "converged": res.converged,
         "analytic_rel_err": [float(v) for v in rel],
         "stencil_taps_per_apply": counts["stencil_taps"] / 30,
         "counts": {k: v for k, v in counts.items() if v}})
    if not rel.max() <= 2e-3 or not np.all(np.isfinite(res.eigenvectors)):
        raise AssertionError(f"64^3 MINRES shift-invert: {res}")
    if counts["stencil_taps"] <= 0 or counts["stencil_taps_ref"]:
        raise AssertionError(f"64^3 MINRES shift-invert counts: {counts}")
    out["stencil"] = counts
    return out


def phase_si_dist():
    """shift_invert_lanczos_dist at f32 on the card, each against the
    one-device port on the same problem from the same start vector:
    the 16x16 rectangle in 8 row shards (union pencil, "rdma_overlap": the
    fused interior SpMM + halo copy, K5), sigma 45, nev 4, maxiter 30; the
    16^3 brick in 8 slabs (the tap kernel on the ghost-extended slabs),
    sigma 60, nev 3, maxiter 24; and thick_restart_lanczos_dist(mode=
    "shift_invert") on the 8-shard rectangle (ncv 20). The f32 MINRES
    inner solves stop at 16 eps, so the eigenvalues are held to the
    one-device port's within 1e-4. Counts zeroed just before each
    distributed run."""
    from maxwell_tpu_torch.dist import make_mesh, partition_problem
    from maxwell_tpu_torch.dist.stencil_dist import DistStencilPencil3D
    from maxwell_tpu_torch.problems import RectCavity2D
    from maxwell_tpu_torch.problems.stencil3d import StencilPencil3D
    from maxwell_tpu_torch.solvers.dist_solve import (
        shift_invert_lanczos_dist,
    )
    from maxwell_tpu_torch.solvers.operator import Pencil
    from maxwell_tpu_torch.solvers.shift_invert import (
        iterative_apply,
        shift_invert_lanczos,
    )
    from maxwell_tpu_torch.solvers.trlanczos import (
        thick_restart_lanczos,
        thick_restart_lanczos_dist,
    )

    mesh = make_mesh(SHARDS, "cuda")
    out = {}

    def check(name, res, one, wall, counts, need):
        got, want = np.sort(res.eigenvalues), np.sort(one.eigenvalues)
        rel = np.abs(got - want) / np.abs(want)
        log({"phase": "si_dist", "case": name, "wall_s": wall,
             "iterations": res.iterations, "converged": res.converged,
             "eigenvalues": [float(v) for v in got],
             "one_device": [float(v) for v in want],
             "rel_to_one_device": [float(v) for v in rel],
             "residuals": [float(v) for v in res.residuals],
             "counts": {k: v for k, v in counts.items() if v}})
        if not rel.max() <= 1e-4 or not np.all(np.isfinite(
                res.eigenvectors)):
            raise AssertionError(f"si dist {name} vs one device: {rel}")
        if counts[need] <= 0:
            raise AssertionError(f"si dist {name}: {need} not launched")
        stray = {k: v for k, v in counts.items() if v and k.endswith(
            ("_ref", "_plain"))}
        if stray:
            raise AssertionError(f"plain versions ran on the card: {stray}")
        out[name] = counts

    cav = RectCavity2D(nx=16, ny=16)
    dp = partition_problem(cav, SHARDS, kernel="union", dtype=torch.float32,
                           halo_impl="rdma_overlap", device="cuda")
    one = Pencil.from_problem(cav, kernel="union", dtype=torch.float32,
                              precision="highest", device="cuda")
    v0 = dp.make_block(1, torch.Generator("cuda").manual_seed(0))[:, 0]
    v_one = dp.extract_vectors(v0[:, None])[:, 0]
    want = shift_invert_lanczos(one, 45.0, nev=4, maxiter=30, tol=1e-5,
                                backend="iterative", v0=v_one)
    reset_all_counts()
    t0 = time.perf_counter()
    res = shift_invert_lanczos_dist(dp, mesh, sigma=45.0, nev=4, maxiter=30,
                                    tol=1e-5, v0=v0)
    torch.cuda.synchronize()
    check("rect16_8shards", res, want, time.perf_counter() - t0,
          all_counts(), "union_interior_overlap")

    kw = dict(nev=4, ncv=20, max_restarts=6, tol=1e-5, mode="shift_invert",
              sigma=45.0)
    want = thick_restart_lanczos(one, v0=v_one,
                                 apply_op=iterative_apply(one, 45.0), **kw)
    reset_all_counts()
    t0 = time.perf_counter()
    res = thick_restart_lanczos_dist(dp, mesh, v0=v0, **kw)
    torch.cuda.synchronize()
    check("rect16_8shards_trlanczos", res, want, time.perf_counter() - t0,
          all_counts(), "union_interior_overlap")
    del dp, one

    g = 16
    dps = DistStencilPencil3D.build(nx=g, ny=g, nz=g, D=SHARDS,
                                    dtype=torch.float32, device="cuda")
    stp = StencilPencil3D.build(nx=g, ny=g, nz=g, dtype=torch.float32,
                                device="cuda")
    v0 = dps.make_block(1, torch.Generator("cuda").manual_seed(0))[:, 0]
    v_one = dps.extract_vectors(v0[:, None])[:, 0]
    want = shift_invert_lanczos(stp, 60.0, nev=3, maxiter=24, tol=1e-5,
                                backend="iterative", v0=v_one)
    reset_all_counts()
    t0 = time.perf_counter()
    res = shift_invert_lanczos_dist(dps, mesh, sigma=60.0, nev=3,
                                    maxiter=24, tol=1e-5, v0=v0)
    torch.cuda.synchronize()
    check(f"brick{g}_8slabs", res, want, time.perf_counter() - t0,
          all_counts(), "stencil_taps")
    return out


def phase_tet_cli():
    """Config 6 (the jiggled 6^3 tet mesh, f64 LOBPCG) through the CLI on
    cuda, held to a dense scipy.linalg.eigh of its assembled K, M to
    1e-8. Returns (report, counts)."""
    import scipy.linalg

    from maxwell_tpu_torch.cli.run import build_problem

    path = os.path.join(CONFIGS, "config6_tet.json")
    rc, rep, cnt, wall = run_cli(path)
    with open(path) as f:
        cav = build_problem(json.load(f)["problem"])
    w = scipy.linalg.eigh(cav.K.toarray(), cav.M.toarray(), eigvals_only=True)
    dense = np.sort(w[w > 1e-6])[: len(rep["eigenvalues"])]
    rel = np.abs(np.asarray(rep["eigenvalues"]) - dense) / dense
    log({"phase": "tet_cli", "config": "config6_tet", "rc": rc,
         "wall_s": wall,
         **{k: rep.get(k) for k in ("converged", "iterations", "n",
                                    "t_solve_s", "eigenvalues", "residuals",
                                    "analytic_rel_err")},
         "dense_rel_err": [float(v) for v in rel],
         "counts": {k: v for k, v in cnt.items() if v}})
    if rc != 0 or not rep["converged"] or max(rep["residuals"]) > 1e-8:
        raise AssertionError(f"config6 through the CLI: {rep}")
    if not rel.max() <= 1e-8:
        raise AssertionError(f"config6 vs dense eigh: {rel}")
    return rep, cnt


# --- slice 11, the surface: the device-resident chain, the probes, entry --
R5_SLABS = (1, SHARDS)  # the reference's mesh of one, and config 5's slabs
TIME_TO_1E8_RES = 2e-8  # the reference's time_to_1e8 gates (bench.py)
TIME_TO_1E8_EIG = 5e-3
TRACE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "maxwell_tpu_torch", "traces")


def launched(counts):
    """The kernels (and plain versions) of a counted window that ran."""
    return {k: v for k, v in counts.items() if v}


def _time_to_1e8_gates(label, out):
    """The reference's time_to_1e8 gates on a chain probe's result."""
    if not out["converged"] or out["refine_res"] > 1e-8:
        raise AssertionError(f"{label}: refine not converged: {out}")
    if not max(out["residuals_f64_verified"]) <= TIME_TO_1E8_RES:
        raise AssertionError(f"{label}: f64-verified residuals "
                             f"{out['residuals_f64_verified']}")
    if not max(out["analytic_rel_err"]) <= TIME_TO_1E8_EIG:
        raise AssertionError(f"{label}: eigenvalues off the analytic "
                             f"modes: {out['analytic_rel_err']}")


def _check_launched(label, counts, kernels):
    missing = [k for k in kernels if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: {missing} not launched: {counts}")


def phase_r5chain():
    """exp_r5chain.run() at 64^3: a cold run and one steady run of f32
    LOBPCG -> refine_dw with the block kept on the card, the host round
    trip beside them, then one extra steady chain under profiling.trace
    (its top 5 device kernels printed); counts zeroed just before, read
    just after. Gates: the reference's time_to_1e8 gates, the tap kernel
    launched, the device chain's eigenvalues those of the host chain."""
    from maxwell_tpu_torch.bench import exp_r5chain

    reset_all_counts()
    out = exp_r5chain.run(STENCIL_GRID, steady=1, trace_dir=TRACE_DIR)
    counts = all_counts()
    log({"phase": "r5chain", **out, "counts": launched(counts)})
    log({"r5chain_top_kernels": out["top_kernels"]})
    _time_to_1e8_gates("r5chain", out)
    if not out["host_vs_device_eig_rel"] <= 1e-12:
        raise AssertionError(f"device chain vs host chain: {out}")
    _check_launched("r5chain", counts, ("stencil_taps",))
    if counts["stencil_taps_ref"]:
        raise AssertionError(f"r5chain ran the plain taps: {counts}")
    return counts


def phase_r5dist():
    """exp_r5dist.run() at 64^3 in 1 and 8 slabs: a cold and one steady
    run of lobpcg_dist -> refine_dw_dist with the stacked block kept on
    the card; counts zeroed just before each, read just after. Gates: the
    reference's time_to_1e8 gates, the tap kernel launched."""
    from maxwell_tpu_torch.bench import exp_r5dist

    out = {}
    for slabs in R5_SLABS:
        reset_all_counts()
        res = exp_r5dist.run(STENCIL_GRID, slabs=slabs, steady=1)
        counts = all_counts()
        log({"phase": "r5dist", **res, "counts": launched(counts)})
        _time_to_1e8_gates(f"r5dist {slabs} slabs", res)
        _check_launched(f"r5dist {slabs} slabs", counts, ("stencil_taps",))
        if counts["stencil_taps_ref"]:
            raise AssertionError(f"r5dist ran the plain taps: {counts}")
        out[f"slabs{slabs}"] = counts
        torch.cuda.empty_cache()
    return out


def phase_r5si():
    """exp_r5si.run(solves=False): the 128^2 LDL^T factor (host) and the
    shift-invert apply (two level_solve launches between the union M apply
    and the projector), the 64^3 MINRES apply through the tap kernel, each
    timed by a chain of applies; the solves are phases 25 and 26. Counts
    zeroed just before, read just after."""
    from maxwell_tpu_torch.bench import exp_r5si

    reset_all_counts()
    out = exp_r5si.run(solves=False)
    counts = all_counts()
    log({"phase": "r5si", **out, "counts": launched(counts)})
    _check_launched("r5si", counts, ("level_solve", "stencil_taps"))
    for key in ("si_apply_2d128_s", "si_apply_64_stencil_s"):
        if not out[key] > 0:
            raise AssertionError(f"r5si {key}: {out[key]}")
    return counts


def phase_conv():
    """exp_conv.run() for one combination (alpha 15, 16 CG sweeps) at 64^3
    with maxiter 20: f32 LOBPCG twice through the tap kernel (every sweep a
    fused K/M launch); counts zeroed just before, read just after."""
    from maxwell_tpu_torch.bench import exp_conv

    reset_all_counts()
    out = exp_conv.run(STENCIL_GRID, maxiter=20, combos=((15.0, 16),))
    counts = all_counts()
    row = out[f"g{STENCIL_GRID}_a15_i16"]
    log({"phase": "conv", **out, "counts": launched(counts)})
    if not (np.isfinite(row["max_res"]) and row["iterations"] > 0
            and row["max_res"] < 1.0):
        raise AssertionError(f"conv: {row}")
    _check_launched("conv", counts, ("stencil_taps",))
    return counts


def phase_r4chip():
    """exp_r4chip.run(): two_prod exact (error 0) for the five broadcast
    shapes on the card and the dw sum of 10^6 values; the copy rate and K2
    on the 24^3 RCM K at m 8 against scipy and its bound; the 64^3
    double-word tap apply against an f64 apply, beside the f32 tap kernel
    and the spectral shift solve. Counts zeroed just before, read after."""
    from maxwell_tpu_torch.bench import exp_r4chip

    reset_all_counts()
    out = exp_r4chip.run()
    counts = all_counts()
    log({"phase": "r4chip", **out, "counts": launched(counts)})
    if any(v != 0.0 for v in out["two_prod_err"].values()):
        raise AssertionError(f"two_prod not exact on the card: {out}")
    if not (out["dw_sum_err"] <= 1e-9 and out["union_prod"]["err"] <= 1e-5
            and out["dw_apply_rel_err"] <= 1e-12
            and out["spectral_sigma_finite"]):
        raise AssertionError(f"r4chip: {out}")
    _check_launched("r4chip", counts, ("bellunion_matmat", "stencil_taps"))
    return counts


def phase_entry():
    """entry() on the card: one LOBPCG iteration on the 32x32 rectangle's
    union pencil (K1 and K2), its Ritz values within 1e-5 of the same step
    on the CPU ("ref" pencil, the same X0); then dryrun_multichip(8) on
    the card, every check true and the bit-for-bit ones 0, with K4, K5,
    K6, K8 and K10 launched. Counts zeroed just before each, read just
    after."""
    from maxwell_tpu_torch.entry import dryrun_multichip, entry

    fn, (pencil, X0) = entry("cuda")
    reset_all_counts()
    theta, res = fn(pencil, X0)
    torch.cuda.synchronize()
    counts = all_counts()
    fn_cpu, (p_cpu, X0_cpu) = entry("cpu")
    theta_cpu, res_cpu = fn_cpu(p_cpu, X0_cpu)
    rel = float(((theta.cpu() - theta_cpu).abs() / theta_cpu.abs()).max())
    log({"phase": "entry", "theta": theta.tolist(),
         "theta_cpu": theta_cpu.tolist(), "theta_rel_err": rel,
         "residuals": res.tolist(), "counts": launched(counts)})
    if not rel <= 1e-5 or not torch.isfinite(res).all():
        raise AssertionError(f"entry on the card vs the CPU: {rel}")
    _check_launched("entry", counts,
                    ("bellunion_km_matmat", "bellunion_matmat"))
    del pencil, X0
    out = {"entry": counts}

    reset_all_counts()
    t0 = time.perf_counter()
    checks = dryrun_multichip(SHARDS, "cuda")
    torch.cuda.synchronize()
    counts = all_counts()
    log({"phase": "dryrun", "shards": SHARDS, "checks": checks,
         "seconds": time.perf_counter() - t0, "counts": launched(counts)})
    if not all(v is True or v == 0.0 for v in checks.values()):
        raise AssertionError(f"dryrun_multichip: {checks}")
    _check_launched("dryrun", counts, (
        "stencil_taps", "union_interior_overlap", "ring_shift",
        "bsr_matmat", "bsr_matvec"))
    out["dryrun"] = counts
    torch.cuda.empty_cache()
    return out


def timed(fn, *args):
    """fn(*args), with a {"phase_seconds": ...} line for its wall time."""
    t0 = time.perf_counter()
    out = fn(*args)
    log({"phase_seconds": fn.__name__, "seconds": time.perf_counter() - t0})
    return out


def main():
    phase_device()
    from maxwell_tpu_torch.problems import BrickCavity3D, RectCavity2D
    from maxwell_tpu_torch.sparse.reorder import PermutedProblem

    timed(phase_build)
    grid_problem = PermutedProblem(BrickCavity3D(nx=GRID, ny=GRID, nz=GRID))
    timed(phase_kernels, grid_problem, GRID)
    problem = PermutedProblem(BrickCavity3D(
        nx=SOLVE_GRID, ny=SOLVE_GRID, nz=SOLVE_GRID))
    # the kernels line reports the union kernels at the solve's shapes
    stats = timed(phase_kernels, problem, SOLVE_GRID)
    counts, check_counts = timed(phase_solve, problem)
    pencil, stencil_counts = timed(phase_stencil_solve)
    stats["stencil_taps"] = timed(phase_stencil_kernels, pencil)
    del pencil
    timed(phase_dielectric)
    stats.update(timed(phase_bsr_kernels, [
        (f"{BSR_GRID}^3", grid_problem),
        (f"{SOLVE_GRID}^3", problem),
        ("config1", RectCavity2D(nx=16, ny=16)),
    ]))
    bsr_counts = timed(phase_repeat_solve, grid_problem, "pallas", "bsr_",
                       ("bsr_matmat",))
    lanczos_counts = timed(phase_lanczos)
    stats.update(timed(phase_bellpairs_kernels, grid_problem))
    t0 = time.perf_counter()
    big = PermutedProblem(BrickCavity3D(
        nx=BANDED_GRID, ny=BANDED_GRID, nz=BANDED_GRID))
    log({"phase": "banded_problem", "grid": BANDED_GRID,
         "seconds": time.perf_counter() - t0})
    stats.update(timed(phase_bellpairs_banded, big))
    stats["bellunion_matmat_banded"] = timed(phase_union_banded, big)
    del big
    bp_counts = timed(
        phase_repeat_solve, grid_problem, "bellpairs", "bellpairs_",
        ("bellpairs_km_matmat", "bellpairs_matmat"))
    timed(phase_bellpairs_cli)
    pencils = timed(_dist_pencils, grid_problem)
    stats.update(timed(phase_dist_kernels, grid_problem, pencils))
    dist_counts = timed(phase_dist_solves, grid_problem, pencils)
    del pencils
    torch.cuda.empty_cache()
    timed(phase_dist_cli)
    probe_stats, probe_counts = timed(phase_union_probes)
    stats.update(probe_stats)
    probe_stats, probe2_counts = timed(phase_grid_and_stencil_probes)
    stats.update(probe_stats)
    probe_stats, probe3_counts = timed(phase_spmm_and_gather_probes)
    stats.update(probe_stats)
    slab = timed(phase_dist_stencil_kernels)
    slab_solve = timed(phase_dist_stencil_solve)
    timed(phase_dist_stencil_cli)
    stats["level_solve"] = timed(phase_tri_solve_kernels)
    si_counts = timed(phase_si_solve)
    timed(phase_si_dist)
    timed(phase_tet_cli)
    surface = {"r5chain": timed(phase_r5chain), "r5dist": timed(phase_r5dist),
               "r5si": timed(phase_r5si), "conv": timed(phase_conv),
               "r4chip": timed(phase_r4chip), **timed(phase_entry)}
    # the surface phases' launches per kernel (plain versions' calls too)
    log({"surface": {
        phase: ({k: launched(c) for k, c in counts.items()}
                if phase == "r5dist" else launched(counts))
        for phase, counts in surface.items()}})
    stats["level_solve"].update(
        config3_cli_launches=si_counts["cli"]["level_solve"],
        note="not a Pallas kernel in the reference: a jnp fori_loop over "
             "the levels")
    # the tap kernel's second path: the slab apply in the 8-slab solve
    stats["stencil_taps"]["slab"] = {
        **slab, "launches": slab_solve["counts"]["stencil_taps"],
        "path": "solve: lobpcg_dist + refine_dw_dist, 64^3 in 8 slabs"}

    launches = {**counts, "stencil_taps": stencil_counts["stencil_taps"],
                "bsr_matmat": bsr_counts["bsr_matmat"],
                "bsr_matmat_windowed": bsr_counts["bsr_matmat_windowed"],
                "bsr_matvec": lanczos_counts["bsr_matvec"],
                **{k: v for k, v in bp_counts.items()
                   if k.startswith("bellpairs_") and not k.endswith("_ref")},
                "union_interior_overlap":
                    dist_counts["union"]["union_interior_overlap"],
                "ring_shift": dist_counts["pallas"]["ring_shift"],
                "level_solve": si_counts["ldlt"]["level_solve"],
                **{name: probe_counts[name]
                   for name in probes_of("exp_union", "exp_union2")},
                **probe2_counts, **probe3_counts}

    def entry(name, *extra):
        st = stats[name]
        return {"name": name, "route": "cuda", "source": SOURCE[name],
                "replaces": REPLACES[name], "launches": launches[name],
                **{k: st[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms",
                                      *extra)}}

    window = ("win_unit", "window_bytes", "window_staged")
    bands = ("bands", "col_rows", "full_x_kernel_ms")
    log({"off_main_path": [
        {**entry("bellunion_matvec"),
         "residual_check_launches": check_counts["bellunion_matvec"],
         "si_solve_launches": si_counts["ldlt"]["bellunion_matvec"]},
        entry("bsr_matmat_windowed", *window),
        entry("bellpairs_matmat_windowed", *window),
        entry("bellpairs_matmat_banded", *bands),
        entry("bellpairs_km_matmat_banded", *bands),
        entry("bellunion_matmat_banded", *bands),
    ]})
    # every ported kernel, with the path that launches it
    paths = {**MAIN_PATH, **{name: "off-path" for name in OFF_PATH},
             **PROBES}
    # other widths: m 8 (K8), m 9 (K15f), m 32, 64, 128 (K15c); the empty
    # launch's time beside K6 and K10, K6's copy unit, and the bf16 probes'
    # library call on operands rounded beforehand
    log({"kernels": [{**entry(name), "path": path,
                      **{w: stats[name][w] for w in (
                          "m1", "m8", "m9", "m32", "m64", "m128", "m171",
                          "launch_floor_ms", "chain_ms", "chain_floor_ms",
                          "unit_bytes", "library_bf16_ms", "l2_floor_ms",
                          "p3_grid91", "slab", "levels", "window",
                          "window_route", "cases",
                          "config3_cli_launches", "note")
                         if w in stats[name]}}
                     for name, path in paths.items()]})
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
