"""Chip smoke test of the PyTorch / CUDA port (pcx_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line with its numbers, and the first
failure ends the run with a non-zero exit:

1. device  — require CUDA; print the card's name and power limit, and the
             peak rates the kernels' bounds use: IEEE f32 on the CUDA cores
             (K1, K2) and 3xTF32 on the tensor cores (K3).
2. build   — compile the CUDA kernels (nvcc, sm_90a, one process per
             source, all at once) from the sources.
3. k1      — K1 resid_precond vs its plain version at m=16, N=120; then
             on a lane axis (the lockstep k-point batch) at 4 lanes of
             m=16, each lane with its own symbol, vs its plain version,
             lane 0 bit for bit against the one-lane launch, timed beside
             its bound and four one-lane launches.
4. k2      — K2 axis_dft (the mixed-radix FFT) at B=48, N=100, 120, 150,
             each direction against the einsum and complex128 (5e-6 of the
             output scale), dft3 forward against torch.fft.fftn and forward
             then inverse against x; the time per pass beside its bytes
             bound, the plan's operations and their time at the f32 peak,
             the one-axis torch.fft.fft (the library call) and
             torch.matmul on the permuted view, the tensor-map encode per
             launch; then both directions at N=16, 32,
             34 (a dense stage), 50, 60, 75 (odd K: cp.async); then at
             N=120 and B=12, 24 (the W apply under w_cap at widths 4 and
             8), each direction against the einsum and complex128, timed
             beside its bytes bound, the einsum and the one-axis
             torch.fft.fft; then at B=96, 144 and 192, the operator
             apply of two, three and four lanes of 16 columns (phases 22
             and 23, where lanes leave a batch of four as they stop); and
             the wrapper's host cost per call.
5. k3      — K3 gram9 vs its plain version at m=16, D=3*120^3, chunk 2048
             (and both against complex128); timed beside the stacked
             cuBLAS route (K6's plain version, the rr_gram="xla" route
             before K6), with and without the torch.cat that builds its
             input; then on a lane axis at 4 lanes, as phase 3's, beside
             the cuBLAS route of the stacked lanes;
             then K4 block_combine at the main path's three calls (m=16,
             N=120: the second SVQB's projection and scaling, the
             Rayleigh-Ritz update of the stacked block), each
             against its plain version and complex128 (no worse than 1.5x
             the error of one cuBLAS GEMM over the concatenated blocks),
             timed beside its bound, the plain version, one cuBLAS call and
             the same with the concatenation; then K5 op_blocks at N=120,
             m=16 (pre, post, post with the penalty and a shift), each bit
             for bit against the eager composition it replaces, its error
             against complex128, timed beside its bytes bound and that
             composition (``library_ms``); then K6 gram_chunks at N=120,
             m=16 (a 16 x 16 Gram, the second SVQB's projection [X|W]^H P,
             the six-block 48 x 48 Rayleigh-Ritz Gram), each against
             complex128 (no worse than 1.25x the cuBLAS route, at most
             5e-7), two launches bit for bit, timed beside its bound (bytes,
             or operations at the f32 peak for 48 x 48), its plain version
             (with its concatenations) and the cuBLAS route on operands
             stacked beforehand (``library_ms``).
6. operator — complex64 ama_bb through the kernels vs complex128 torch.fft
             on a 2-column block at N=120.
7. single  — cold sc_curv chiral N=120 nev=10 solve at alpha=(pi,0,0), the
             point of ``bench.py --sweep 0``, gated against the committed
             complex64 library row (output_c64/chiral/bandgap_sc_curv.json).
8. warm    — fcc chiral N=120: a cold solve at k_path("fcc")[9], then a
             warm solve at 10 (the sweep protocol of bench.py, whose 20
             points phase 20 runs), each gated like the single point
             against bandgap_fcc.json.
9. sweep   — ``bandgap`` fcc N=120 complex64 with rr_gram="pallas" over
             k_path indices 8-11 (one cold point, three warm), every row
             within 3.5e-3 of bandgap_fcc.json; then row 10 marked failed
             and swept again, which must go through the warm feeder,
             restore it and leave rows 9 and 11 byte for byte.

10. pseudo-operator — the Hermitian-tensor dielectrics at N=120 on a
             2-column block: complex64 ama_bb (K2) with the cross-DoF and
             the trivial eps^{-1} vs complex128 torch.fft (limit as phase
             6), each eps^{-1} apply alone complex64 vs complex128, and
             <x, M y> = conj <y, M x> to 1e-5 in complex64; ms per
             16-column apply of each dielectric (cross-DoF with preset 0,
             one non-zero off-diagonal entry, and preset 3, all three).
11. pseudo-sweep — ``bandgap`` sc_curv pseudochiral_crossdof N=120 complex64
             with rr_gram="pallas" over k_path indices 7-9 (one cold point,
             two warm), every row CONVERGED or FLOOR, inside the 1e-3
             spurious gate and within 3.5e-3 of
             output_c64/pseudochiral_crossdof/bandgap_sc_curv.json (a warm
             solve that the sweep rejects and retries cold is printed and
             passes if the retry does).  Then three single cold solves, each
             gated against its committed row: pseudochiral_trivial at k_path
             index 10 with solver="softlock" and with solver="descent", and
             the chiral point of phase 7 with solver="nolock" (the two
             variants may also end MAXITER: the gates still decide).
             The indices keep |alpha| > 1, where a point costs least; the
             rows next to Gamma are phase 14's.
12. solvers-32 — every eigensolver of pcx at sc_curv chiral N=32,
             alpha=(pi,0,0), complex64, tol 1e-3, nev=6, maxiter 200 (the
             protocol of tools/tpu_smoke.py): ``KPointSolver`` with solver
             softlock, nolock, mixed, descent, davidson and jd, each inside
             the 1e-3 spurious gate (MAXITER passes for descent and davidson
             alone, and only with the gate); ``lobpcg_sep_max_rs`` on the
             operator (6 columns, nev 2) against the power method to 1e-3
             relative (PM_STEPS steps: the operator's two largest clusters
             lie 0.3% apart, so the protocol's 200 steps leave the power
             method itself 3.3e-3 low); ``lobpcg_gep_rs`` and
             ``descent_gep_rs`` on the pencil (H, I + B / max B) (8 columns,
             nev 4), relative residual
             max ||H x - lambda M x|| / ((|lambda| + 1) ||x||) within 10 tol;
             ``lobpcg_default`` on the 64-point shifted Laplacian against
             3 - 2 cos(k pi / 65) within 10 tol; ``lobpcg_svd`` (complex128)
             of a seeded 64x48 complex matrix against numpy's singular
             values to 1e-6 relative.
13. solvers-120 — single cold solves at the full width of phase 7 (sc_curv
             chiral N=120, nev=10, alpha=(pi,0,0), complex64), gated like it
             against the committed row: solver="mixed" with
             rr_gram="pallas", "davidson" and "jd" (capped at 80 and 20
             iterations, past the flattening of their residuals; these two
             may end
             MAXITER: they have no FLOOR rule, and the complex64 residual
             floor lies above tol); the launch counts and peak device memory
             of each solve.  Each launches K2, "mixed" K3 too and never K1.
14. near-gamma — ROADMAP F2: a copy of each of output_c64/{chiral,
             pseudochiral_trivial,pseudochiral_crossdof}/bandgap_sc_curv.json
             with rows 0-3 (|alpha| = 0.05 pi - 0.2 pi, next to Gamma) reset
             to pending, resumed in this process by ``bandgap`` (N=120,
             complex64, rr_gram="pallas", refine="light", indices=None: the
             runner's settings); every row CONVERGED or FLOOR, inside the
             1e-3 spurious gate and within 3.5e-3 of the committed row, with
             its iterations, seconds and whether the light refine accepted
             it or the sweep escalated to the complex128 refine.  K1, K2 and
             K3 must all launch.
15. runner  — ``python -m pcx_torch.run_sweep --n 120 --lattice fcc --diel
             chiral --output <copy> --max-rounds 1`` in a subprocess on a
             copy of output_c64/chiral/bandgap_fcc.json with rows 9-11
             pending: exit 0, rows 9-11 within 3.5e-3 of the committed ones,
             the other rows untouched, the heartbeat file touched; then
             ``python -m pcx_torch check`` on the result (exit 0, every row
             computed) and ``python -m pcx_torch eigen1p --n 32 --lattice
             sc_curv --alpha 1,0,0`` (exit 0), both on the card.
16. keywords — the point of phase 7 with the ``KPointSolver`` keywords,
             each gated like phase 7: x0_mode="coarse" (the 60^3 twin's time
             printed beside phase 7's plane-wave start), x0_mode="random",
             solver_impl="complex" with fft_mode="matmul" (K2) and "fft"
             (cuFFT), and refine=False.  K1 and K2 must launch in the
             two-grid start's run.
17. experiments — ``pcx_torch.experiments`` and ``profiling`` on the card:
             ``runtime.pack_cmp`` at N=100, 120, 150 (sc_curv chiral,
             alpha=(pi,pi,pi), k_path index 59, complex64, run_cpu=False)
             with each N's iterations, seconds, peak memory and K1/K2
             launches, each timed solve gated like phase 7 (against the
             committed row at N=100 and 120; N=150 has none);
             ``global_precision_cmp`` at N=120 (complex128 against
             complex64, max omega difference <= 1e-4); ``phase_breakdown``
             at fcc N=120, k_path index 9, m=16, beside phase 8's measured
             ms/iteration; ``check_sdd`` at N=120 on the card against the
             CPU and ``check_component_hpd`` at N=120 (smallest eigenvalue
             of the cross-DoF eps^-1 positive); ``python -m
             pcx_torch.experiments tol_cmp --n 32`` in a subprocess (exit 0).
18. parallel — several cards: W = min(cards, 2) ranks started by spawn, one
             card each over NCCL (``init_distributed``, ``make_mesh``); with
             one card W is 1 and the collectives carry nothing.
             (a) ``solve_batch(mesh=)`` of fcc chiral N=120 k_path 9-10,
             complex64, each member gated like phase 8 and within 1e-6 of
             rank 0's serial solve from the same start; (b) ``bandgap(mesh=)``
             resuming rows 8-11 of a copy of the fcc library with
             rr_gram="pallas" and refine="light": every row within 3.5e-3
             of the committed one, the other rows untouched, only rank 0's
             library and metrics written, K1, K2 and K3 launched on rank 0;
             (c) ``solve_kpoint_sharded`` at n_grid=W, sc_curv N=120,
             alpha=(pi,0,0), complex64, chiral and cross-DoF: the gathered
             Ritz vectors inside the 1e-3 spurious gate (validate.recompute),
             within 3.5e-3 of the committed row and 1e-4 of a single-card
             solve from the same start block, with iterations, seconds and
             each rank's peak memory; (d) the native mask engine at N=120
             for sc_curv and fcc, bit-identical to numpy, both timed.
19. library — the library-recovery tools (``pcx_torch.f64_truth``,
             ``record_vs_truth``, ``rescue_point``, ``preflight_queue``,
             ``iter_tail``) and the gyroid lattices at N=120, everything
             written under a temporary directory ($PCX_GEOMETRY_CACHE
             too): (a) ``f64_truth`` at bcc_sg k_path 100, complex128 on
             the card, CONVERGED or FLOOR, within 1e-6 of
             data/bcc_sg_n120_k100_f64.json on all ten bands, in its keys,
             with iterations, ms/iteration and peak memory; (b)
             ``record_vs_truth`` there into a copy of
             output_c64/chiral/bandgap_bcc_sg.json, whose row 100 is
             failed: recorded within 1e-3 of the pin, no failed row left,
             the other 159 rows exactly as committed; (c) ``rescue_point``
             with the rungs refine64, coarse and f64 on a second copy, and
             with the f64 rung alone on a third (the ladder stops at the
             first rung that recovers the row): row 100 recovered within
             1e-3 of the pin, with the rung that did it, each rung's
             seconds and peak memory; (d) bcc_sg rows
             36-37 and bcc_dg rows 18-20 (19 is exact Gamma) of copies of
             the committed libraries reset and swept with the runner's
             settings (rr_gram="pallas", refine="light"), gated like phase
             14, bcc_sg 37 and bcc_dg 19 within 1e-5 of their f64 pins,
             K1, K2 and K3 launched; (e) the pseudochiral gyroid rows
             (bcc_sg 37, bcc_dg 40; trivial and cross-DoF, no committed
             library) through ``bandgap`` with the runner's settings, each
             accepted, with the light refine's frequencies against the
             complex128 refine's on a twin solve; (f) ``preflight_queue``'s
             14 configurations at N=16, 2 points, complex128, every solve
             OK (the golden column printed, not gated); (g) ``iter_tail``
             at N=48, sc_curv chiral: every status CONVERGED or FLOOR and
             every val <= 1e-3.  Nothing is cut.
20. bench  — the port's benchmarks through their entry points
             (``pcx_torch.bench.run``, ``bench_matrix.main``): (a) the
             default protocol of ``python -m pcx_torch.bench``, fcc N=120
             over 20 warm points: its JSON record without ``_partial`` and
             with points 20, every point's frequencies within 3.5e-3 of its
             row (10 + i) of output_c64/chiral/bandgap_fcc.json, with
             s/k-point, each point's iterations, the cold retries and the
             peak memory; (b) ``--sweep 0 --repeats 1``, sc_curv N=120 at
             (pi, 0, 0), within 3.5e-3 of the committed row as in phase 7; (c)
             ``bench_matrix --rows north_star --reps 1`` (bcc_dg chiral and
             cross-DoF, N=120) into a temporary ``--out``: both rows, each
             within the 1e-3 spurious gate; (d) ``python -m pcx_torch.bench
             --sweep 0 --repeats 1`` in a subprocess: exit 0, the JSON line
             last.  K1 and K2 must launch in (a), (b) and (c).
21. w_cap  — the W/P width cap of the production LOBPCG: (b) phase 7's
             point cold with col_patience=3 and w_cap=8, then with
             w_cap="auto", each gated like phase 7, with its iterations,
             ms/iteration, the iterations and ms/iteration at each width
             (``iteration_clock``) and at each active count, the launches
             (K2 by batch B; K2 must launch at B=24 under w_cap=8) and the
             peak memory; (b') w_cap=4 cut at 24 iterations, to time the
             width-4 iteration (not gated; K2 must launch at B=12); (c) the
             default protocol of ``python -m pcx_torch.bench`` with
             LIBRARIES.md's lever stack, ``--solver-opt lam_tol=2e-6
             floor_patience=3 col_patience=3 w_cap=auto``: 20 points, each
             within 3.5e-3 of its committed row, the mean s/k-point beside
             the stack's 0.906 s without w_cap (PR 11), each point's
             iterations at each width, and the same numbers.  K1 and K2
             must launch in each solve of (b) and in (c).
22. lanes  — the lockstep k-point batch (``solve_batch``, ``bandgap(
             k_batch=)``): (a) cold fcc N=120 groups of 1, 2 and 4 lanes
             from k_path index 9, cut at 24 iterations (timed only, not
             gated, after a 2-iteration warm-up group), with ms per
             lane-iteration, peak memory and launches (K1 and K2 must
             launch at 1, 2 and 4 lanes), then the device's busy share
             under torch.profiler over 12-iteration groups of 1 and 4
             lanes; (b) ``bandgap(k_batch=4)`` over fcc rows 9-16 with
             rr_gram="pallas" (two groups of four lanes, the second warm
             from the first's last block): every row CONVERGED or FLOOR,
             max|omega - omega_re| <= 1e-3 and within 3.5e-3 of
             output_c64/chiral/bandgap_fcc.json; K1, K3 and K2 must
             launch.
23. complex-lanes — the lockstep batch of the complex LOBPCG family
             (``solver_impl="complex"``, ``lobpcg_sep_lanes``): (a) as
             phase 22 (a), cold fcc N=120 groups of 1, 2 and 4 lanes from
             k_path index 9 cut at 24 iterations (timed only, after a
             2-iteration warm-up group), with ms per lane-iteration, peak
             memory and launches: K2 must launch at B = 3 L 16, K1 and K3
             (either form) never, which shows the path is the complex body;
             then the busy share over 12-iteration groups of 1 and 4 lanes;
             (b) ``bandgap(k_batch=4, solver_kw={"solver_impl":
             "complex"})`` resuming rows 9-12 of a copy of
             output_c64/chiral/bandgap_fcc.json (one group of four lanes,
             which leave the batch as they stop): every row
             CONVERGED or FLOOR, max|omega - omega_re| <= 1e-3 and within
             3.5e-3 of its committed row, every other row as committed; K2
             must launch, K1 and K3 never.

The kernel launch counts are reset just before phase 7 and read after
phases 7 and 8 (K1, K2 and K4 must have launched: the default
rr_gram="xla" route), reset again just before phase 9 and read after it
(K1, K2, K3 and K4 must all have launched; K4 then joins every later check
that all the serial kernels launched); after both, the counter
``dense.matmul`` (complex64 block combinations past K4's limits, which
take ``torch.matmul``) must read 0 and ``dense.k4`` more than 0, and
``dense.gram_plain`` (complex64 Grams past K6's limits, which take the
cuBLAS route) 0 and ``dense.gram`` K6's launches, more than 0; K5
(``op_pre``, ``op_post``) must launch wherever K4 must; and once
more before phase 11: read after its sweep (K1, K2, K3) and after its
single solves (K1, K2), and around each solve of phase 13, around phase
14, around each solve of phase 16, around phase 17 (K1 and K2 must
launch), on rank 0 around phase 18's ``bandgap(mesh=)`` (K1, K2 and K3
must launch) and around phase 19 (K1, K2 and K3 must launch, in its sweeps
(d) too), around each of phase 20's (a), (b) and (c) (K1 and K2 must
launch), and around each solve of phase 21 (b) and its (c) (K1 and K2 must
launch), and around each group of phase 22 (a) and its (b) (K1, K3 and
K2), and around each group of phase 23 (a) and its (b) (K2
alone).
The ``{"kernels": [...]}`` line gives, per
kernel, the sweep's launches (K1's and K3's counted as lane-launches, one
per lane served, as ``kernels.launches()`` counts them; the others'
launches) (and ``launches_solvers``: phase 13's;
``launches_near_gamma``: phase 14's; ``launches_coarse_start``: the
two-grid start's of phase 16; ``launches_experiments``: phase 17's;
``launches_parallel``: rank 0's in phase 18's ``bandgap(mesh=)``;
``launches_library``: phase 19's; ``launches_bench``: phase 20's
default protocol; ``launches_wcap``: phase 21 (c)'s, K2's also by batch
in ``launches_wcap_by_batch``; ``launches_lanes``: phase 22 (b)'s; ``launches_complex_lanes``:
phase 23 (b)'s; K2's
``by_batch``: phase 4 at B=12, 24, 96, 144, 192), then K1 and K3 on a
lane axis (``resid_precond`` and ``gram9`` with ``lanes``, whose
``launches`` are phase 22 (b)'s, one per lane served), the kernel's time
beside its plain
version's, its bound on this card at the peak of the units it runs on
(``arith``, ``bound_peak``) and the time of the PyTorch library call that
computes the same function (null where there is none).

The last line of standard output is the JSON object
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
There is no CPU path: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
N = 120
NEV = 10
SPURIOUS_TOL = 1e-3      # |omega - omega_re| gate (pcx validate.recompute)
GOLDEN_TOL = 3.5e-3      # complex64 golden scale (README, ROADMAP R3)
HBM_BYTES_S = 3.35e12    # H100 SXM device-memory rate (NVIDIA data sheet)
# Dense TF32 on the H100 SXM tensor cores at 700 W (NVIDIA data sheet); the
# 3xTF32 split of K3 runs three TF32 products per f32 product.
TF32X3_FLOPS = 495e12 / 3
FP32_FMA, TF32X3 = "cuda fp32 fma", "cuda mma.sync 3xTF32"
# The wrappers of the one-point solve; phase 22 runs them on lanes.
SERIAL_KERNELS = ("resid_precond", "axis_dft", "gram9")
# The kernels of the default route (rr_gram="xla"), phases 7-8.
PATH_KERNELS = ("resid_precond", "axis_dft", "block_combine", "op_pre",
                "op_post", "gram_chunks")
# Phase 22: the lockstep k-point batch.
LANES_K = 4                  # lanes of K1 / K3 on a lane axis (phases 3, 5)
LANE_COUNTS = (1, 2, 4)      # (a): lanes of the timed groups
LANE_FIRST = 9               # (a): fcc k_path index of the first lane
LANE_CUT = 24                # (a): iterations of each timed group
LANE_PROFILED = 12           # (a): iterations of the profiled groups
LANE_ROWS = list(range(9, 17))   # (b): bandgap(k_batch=4) rows
LANE_BATCH = 4
COMPLEX_LANE_ROWS = list(range(9, 13))   # phase 23 (b): one group of four

# Phase 4: K2 at the solver's B = 3 m, on the grids of the main path and
# pack_cmp, then on those of phase 12, the coarse starts (N // 2) and a dense
# stage (34 = 2 x 17); each pass within 5e-6 of the output scale.
K2_B, K2_TOL = 48, 5e-6
K2_NS = [100, 120, 150]
K2_SMALL_NS = [16, 32, 34, 50, 60, 75]
# ... and at N=120 at the batches of the W apply under w_cap: B = 3 wc for
# the buckets wc = m/4 and m/2 of m=16 (phase 21), and of the operator apply
# of 2, 3 and 4 lanes of 16 columns (phases 22 and 23)
K2_WCAP_BS = [12, 24]
K2_LANES_BS = [3 * 16 * lanes for lanes in range(2, LANES_K + 1)]
SWEEP_INDICES = [8, 9, 10, 11]
WARM_INDICES = (9, 10)
PSEUDO_INDICES = [7, 8, 9]
TRIVIAL_INDEX = 10
CROSSDOF, TRIVIAL = "pseudochiral_crossdof", "pseudochiral_trivial"
# Phase 12: the tools/tpu_smoke.py protocol; phase 13: the full-width solves
# and the iteration cap of each.
SMALL_N, SMALL_NEV, SMALL_TOL, SMALL_MAXITER = 32, 6, 1e-3, 200
KPS_SOLVERS = ("softlock", "nolock", "mixed", "descent", "davidson", "jd")
PM_STEPS = 1000
FULL_SOLVES = (("mixed", {"rr_gram": "pallas"}, 300),
               ("davidson", {}, 80), ("jd", {}, 20))
# Phase 14: the rows next to Gamma of each dielectric; phase 15: the rows the
# runner resumes; phase 16: the KPointSolver keywords on phase 7's point.
NEAR_GAMMA_ROWS = [0, 1, 2, 3]
NEAR_GAMMA_DIELS = ("chiral", TRIVIAL, CROSSDOF)
RUNNER_ROWS = [9, 10, 11]
KEYWORD_SOLVES = (
    ("x0_mode='coarse'", {"x0_mode": "coarse"}),
    ("x0_mode='random'", {"x0_mode": "random"}),
    ("solver_impl='complex' fft_mode='matmul'",
     {"solver_impl": "complex", "fft_mode": "matmul"}),
    ("solver_impl='complex' fft_mode='fft'",
     {"solver_impl": "complex", "fft_mode": "fft"}),
    ("refine=False", {"refine": False}))
# Phase 17: pack_cmp's grids (the reference's runtime_sc_curv.json), the
# sc_curv k_path index of its default alpha = (pi,pi,pi), the SDD and HPD
# checks' grid, and the CLI's run.
PACK_NS = [100, 120, 150]
R_INDEX = 59
CHECK_N = 120
EXPERIMENTS_CLI = ["tol_cmp", "--n", "32", "--lattice", "sc_curv", "--nev",
                   "6", "--values", "1e-3,1e-4"]

FAIL = 1


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(FAIL)


def cuda_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def smi(query: str) -> str:
    """nvidia-smi's first line for ``query``, '' if it fails."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def bound(ops: float, nbytes: float, peak_flops: float) -> dict:
    """The least time the card could take for work of ``ops`` f32
    operations on ``nbytes`` read once and written once: the larger of
    bytes over the memory rate and operations over ``peak_flops``, the peak
    of the units the kernel computes on."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak_flops
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_peak": peak_flops}


def tensor_core_record(ms: float, lib_ms: float, ops: float,
                       nbytes: float, peak: float) -> tuple:
    """(record keys, printable summary) of a 3xTF32 kernel: its bound on
    the tensor cores and on the CUDA cores, its share of the former and its
    time over the library call's."""
    b = bound(ops, nbytes, TF32X3_FLOPS)
    b_fp32 = bound(ops, nbytes, peak)["bound_ms"]
    rec = {"arith": TF32X3, **b, "bound_fp32_ms": b_fp32,
           "share": b["bound_ms"] / ms, "over_library": ms / lib_ms}
    text = (f"bound {b['bound_ms']:.3f} ms ({b['bound_by']}, 3xTF32 at "
            f"{TF32X3_FLOPS / 1e12:.2f} TFLOP/s) = {100 * rec['share']:.1f}%"
            f" reached; on the CUDA cores' f32 peak {b_fp32:.3f} ms; kernel "
            f"/ library {rec['over_library']:.3f}")
    return rec, text


def phase_device() -> float:
    """Print the card and return its IEEE f32 peak in FLOP/s: SMs x 128
    f32 lanes x 2 (an FMA) x the maximum SM clock."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this smoke test needs a "
             "CUDA GPU")
    print(smi("name,power.limit"), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float((smi("clocks.max.sm") or "nan").split()[0])  # "1980 MHz"
    peak = sms * 128 * 2 * clock_mhz * 1e6
    print(f"phase device: {torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__},"
          f" cuda {torch.version.cuda}; {sms} SMs at {clock_mhz:.0f} MHz max:"
          f" IEEE f32 peak {peak / 1e12:.2f} TFLOP/s (CUDA cores, K1, K2); "
          f"3xTF32 peak {TF32X3_FLOPS / 1e12:.2f} TFLOP/s (dense TF32 495 "
          f"TFLOP/s at 700 W, data sheet, / 3; K3); memory "
          f"{HBM_BYTES_S / 1e12:.2f} TB/s (data sheet)", flush=True)
    if not peak > 0:
        fail("could not read the SM clock from nvidia-smi")
    return peak


def phase_build() -> None:
    from pcx_torch.kernels import _build
    t0 = time.time()
    path = _build.build()
    _build.load()
    with open(path[:-3] + ".log") as f:
        report = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    print(f"phase build: {time.time() - t0:.2f} s -> {path}", flush=True)
    for ln in report:
        print(f"  ptxas: {ln}", flush=True)


def phase_k1(gen, dev, peak: float) -> dict:
    from pcx_torch.kernels.resid_precond import (resid_precond,
                                                 resid_precond_plain)
    m, n = 16, 120
    d = n ** 3
    x = torch.randn((m, 3, d), generator=gen, device=dev,
                    dtype=torch.complex64)
    hx = torch.randn((m, 3, d), generator=gen, device=dev,
                     dtype=torch.complex64)
    lam = torch.rand((m,), generator=gen, device=dev) * 100.0
    inv_diag = torch.rand((3, d), generator=gen, device=dev)
    inv_sd = 0.1 * torch.randn((3, d), generator=gen, device=dev,
                               dtype=torch.complex64)
    args = (x, hx, lam, inv_diag, inv_sd)
    w_k, ss_k = resid_precond(*args)
    w_p, ss_p = resid_precond_plain(*args)
    torch.cuda.synchronize()
    err_w = max_err(w_k, w_p)
    w_scale = float(w_p.abs().max())
    ok_w = torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6 * w_scale)
    ok_ss = torch.allclose(ss_k, ss_p, rtol=1e-5, atol=0.0)
    ms = cuda_ms(lambda: resid_precond(*args))
    plain_ms = cuda_ms(lambda: resid_precond_plain(*args))
    ss_rel = float(((ss_k - ss_p).abs() / ss_p.abs()).max())
    # per (column, index): residual and its squares 24 flop, the Hermitian
    # 3x3 multiply 54; bytes: x, hx, the symbols and lam in, w, sumsq out
    b = bound(78.0 * m * d, sum(t.numel() * t.element_size()
                                for t in args + (w_k, ss_k)), peak)
    print(f"phase k1: m={m} N={n} max|dw|={err_w:.3e} (max|w| {w_scale:.3e})"
          f" max rel dsumsq={ss_rel:.3e} kernel {ms:.3f} ms plain "
          f"{plain_ms:.3f} ms bound {b['bound_ms']:.3f} ms "
          f"({b['bound_by']}, IEEE f32 on the CUDA cores) = "
          f"{100 * b['bound_ms'] / ms:.1f}% reached; no library call",
          flush=True)
    if not (ok_w and ok_ss):
        fail("K1 disagrees with its plain version (w rtol 1e-5 atol "
             "1e-6*max|w|, sumsq rtol 1e-5)")
    return {"name": "resid_precond", "route": "cuda", "arith": FP32_FMA,
            "source": "pcx_torch/kernels/csrc/resid_precond.cu",
            "replaces": "pcx/operators/pallas_kernels.py:130",
            "max_abs_err": err_w, "ms": ms, "plain_ms": plain_ms, **b,
            "share": b["bound_ms"] / ms, "library_ms": None}


def phase_k1_lanes(gen, dev, peak: float, one_ms: float,
                   lanes: int = LANES_K) -> dict:
    """K1 on a lane axis at ``lanes`` lanes of m=16, N=120, each lane with
    its own symbol, against its plain version (phase 3's tolerances); lane
    0 against the launch without a lane axis bit for bit; its time beside
    the bound and ``lanes`` times phase 3's one-lane launch."""
    from pcx_torch.kernels.resid_precond import (resid_precond,
                                                 resid_precond_plain)
    m, d = 16, N ** 3
    c = lambda *sh: torch.randn(sh, generator=gen, device=dev,
                                dtype=torch.complex64)
    args = (c(lanes, m, 3, d), c(lanes, m, 3, d),
            torch.rand((lanes, m), generator=gen, device=dev) * 100.0,
            torch.rand((lanes, 3, d), generator=gen, device=dev),
            0.1 * c(lanes, 3, d))
    w_k, ss_k = resid_precond(*args)
    w_p, ss_p = resid_precond_plain(*args)
    w_1, ss_1 = resid_precond(*(a[0] for a in args))
    torch.cuda.synchronize()
    err_w = max_err(w_k, w_p)
    w_scale = float(w_p.abs().max())
    ok = (torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6 * w_scale)
          and torch.allclose(ss_k, ss_p, rtol=1e-5, atol=0.0))
    same = bool(torch.equal(w_k[0], w_1) and torch.equal(ss_k[0], ss_1))
    del w_p, ss_p, w_1, ss_1
    ms = cuda_ms(lambda: resid_precond(*args))
    plain_ms = cuda_ms(lambda: resid_precond_plain(*args))
    b = bound(78.0 * lanes * m * d, sum(t.numel() * t.element_size()
                                        for t in args + (w_k, ss_k)), peak)
    print(f"phase k1 lanes: L={lanes} m={m} N={N} max|dw|={err_w:.3e} (max|w|"
          f" {w_scale:.3e}); lane 0 equals the one-lane launch: {same}; "
          f"kernel {ms:.3f} ms ({ms / lanes:.3f} ms per lane against "
          f"{one_ms:.3f} ms for one lane) plain {plain_ms:.3f} ms bound "
          f"{b['bound_ms']:.3f} ms ({b['bound_by']}) = "
          f"{100 * b['bound_ms'] / ms:.1f}% reached; no library call",
          flush=True)
    if not (ok and same):
        fail("K1 on a lane axis disagrees with its plain version (phase "
             "3's tolerances) or, on lane 0, with the one-lane launch")
    del args, w_k, ss_k
    torch.cuda.empty_cache()   # the subprocess phases need the card's memory
    return {"name": "resid_precond", "route": "cuda", "arith": FP32_FMA,
            "source": "pcx_torch/kernels/csrc/resid_precond.cu",
            "replaces": "pcx/operators/pallas_kernels.py:130",
            "lanes": lanes, "max_abs_err": err_w, "ms": ms,
            "ms_per_lane": ms / lanes, "one_lane_ms": one_ms,
            "plain_ms": plain_ms, **b, "share": b["bound_ms"] / ms,
            "library_ms": None}


def _k2_pass(x, inverse: bool, scale_tol: float = K2_TOL) -> tuple:
    """One K2 pass against its plain version and against complex128:
    (max|dy|, scale, max|dy_128|, scale_128); fails past ``scale_tol``."""
    from pcx_torch.kernels.axis_dft import (axis_dft, axis_dft_plain,
                                            dft_matrix)
    w = dft_matrix(x.shape[1], inverse, x.device)
    y_k = axis_dft(x, inverse)
    y_p = axis_dft_plain(x, w)
    torch.cuda.synchronize()
    err, scale = max_err(y_k, y_p), float(y_p.abs().max())
    del y_p
    y_128 = axis_dft_plain(x.to(torch.complex128), w.to(torch.complex128))
    err_128 = max_err(y_k.to(torch.complex128), y_128)
    scale_128 = float(y_128.abs().max())
    del y_k, y_128
    if not (err <= scale_tol * scale and err_128 <= scale_tol * scale_128):
        fail(f"K2 N={x.shape[1]} {'inverse' if inverse else 'forward'}: "
             f"{err / scale:.3e} of scale from its plain version, "
             f"{err_128 / scale_128:.3e} from complex128 (limit "
             f"{scale_tol:g})")
    return err, scale, err_128, scale_128


def _k2_batch(gen, dev, b: int, peak: float, lib) -> dict:
    """K2 at N=120 and batch ``b``: both directions against the plain
    version and complex128, each timed beside its bytes bound, the plain
    version and the one-axis torch.fft.fft at the same shape."""
    from pcx_torch.kernels.axis_dft import (axis_dft, axis_dft_plain,
                                            plan_flops)
    from pcx_torch.operators.dft import dft_mats
    n = N
    x = torch.randn((b, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex64)
    bd = bound(plan_flops(n) * b * n ** 3, 8.0 * 2 * b * n ** 3, peak)
    errs, worst, worst_128 = [], 0.0, 0.0
    for inverse in (False, True):
        err, scale, err_128, scale_128 = _k2_pass(x, inverse)
        worst, worst_128 = max(worst, err), max(worst_128, err_128)
        errs.append(f"{'inv' if inverse else 'fwd'} {err / scale:.3e} "
                    f"(c128 {err_128 / scale_128:.3e})")
    ms = cuda_ms(lambda: axis_dft(x))
    ms_inv = cuda_ms(lambda: axis_dft(x, True))
    mats = dft_mats(n, torch.complex64, dev)
    plain_ms = cuda_ms(lambda: axis_dft_plain(x, mats.fwd))
    xp = x.permute(0, 2, 3, 1)
    fft_dense = torch.fft.fft(xp, dim=-1).is_contiguous()
    fft_ms = cuda_ms(lambda: torch.fft.fft(xp, dim=-1) if fft_dense
                     else torch.fft.fft(xp, dim=-1).contiguous())
    enc_us = lib.pcx_axis_dft_encode_us(x.data_ptr(), b, n, n, n, 1000)
    what = (f"the apply of {b // 48} lanes of 16 columns" if b > 48
            else f"the W apply at w_cap width {b // 3}")
    print(f"phase k2: B={b} N={n} ({what}) "
          f"max|dy|/scale {'; '.join(errs)}; kernel fwd {ms:.3f} ms inv "
          f"{ms_inv:.3f} ms, bound {bd['bound_ms']:.3f} ms "
          f"({bd['bound_by']}) = {100 * bd['bound_ms'] / ms:.1f}% / "
          f"{100 * bd['bound_ms'] / ms_inv:.1f}% reached; einsum "
          f"{plain_ms:.3f} ms; library: torch.fft.fft on the contracted axis"
          f" {fft_ms:.3f} ms; tensor-map encode {enc_us:.2f} us per launch",
          flush=True)
    del x, xp
    return {"ms": ms, "ms_inverse": ms_inv, "plain_ms": plain_ms, **bd,
            "share": bd["bound_ms"] / ms, "library_ms": fft_ms,
            "encode_us": enc_us, "max_abs_err": worst,
            "max_abs_err_c128": worst_128}


def phase_k2(gen, dev, peak: float) -> dict:
    """K2 at B=48 and the grids of the paths: each direction against its
    plain version and complex128, dft3 against fftn and back, the time per
    pass beside its bytes bound, the plan's operations and the library
    calls (one-axis torch.fft.fft, torch.matmul on the permuted view).
    Returns the record of N=120 forward; max_abs_err is the worst over all
    grids and directions."""
    from pcx_torch.kernels import _build
    from pcx_torch.kernels.axis_dft import (axis_dft, axis_dft_plain,
                                            factor_pair, plan_flops)
    from pcx_torch.operators.dft import dft3, dft_mats
    b = K2_B
    lib = _build.load()
    worst = worst_128 = 0.0
    rec = None
    for n in K2_NS + K2_SMALL_NS:
        x = torch.randn((b, n, n, n), generator=gen, device=dev,
                        dtype=torch.complex64)
        nbytes = 8.0 * 2 * b * n ** 3   # x read once, y written once
        ops = plan_flops(n) * b * n ** 3
        bd = bound(ops, nbytes, peak)
        errs = []
        for inverse in (False, True):
            err, scale, err_128, scale_128 = _k2_pass(x, inverse)
            worst, worst_128 = max(worst, err), max(worst_128, err_128)
            errs.append(f"{'inv' if inverse else 'fwd'} {err / scale:.3e} "
                        f"(c128 {err_128 / scale_128:.3e})")
        ms = cuda_ms(lambda: axis_dft(x))
        ms_inv = cuda_ms(lambda: axis_dft(x, True))
        head = (f"phase k2: B={b} N={n} plan {factor_pair(n)} max|dy|/scale"
                f" {'; '.join(errs)}; kernel fwd {ms:.3f} ms inv "
                f"{ms_inv:.3f} ms, bound {bd['bound_ms']:.3f} ms "
                f"({bd['bound_by']}) = {100 * bd['bound_ms'] / ms:.1f}% "
                f"reached")
        if n not in K2_NS:
            print(head, flush=True)
            continue
        mats = dft_mats(n, torch.complex64, dev)
        f_k = dft3(x, mats)
        f_ref = torch.fft.fftn(x, dim=(-3, -2, -1))
        err_f, scale_f = max_err(f_k, f_ref), float(f_ref.abs().max())
        del f_ref
        back = dft3(f_k, mats, inverse=True)
        err_b, scale_b = max_err(back, x), float(x.abs().max())
        del back, f_k
        plain_ms = cuda_ms(lambda: axis_dft_plain(x, mats.fwd))
        xp = x.permute(0, 2, 3, 1)
        # torch.fft.fft along the contracted axis computes K2's function;
        # a .contiguous() only where its output is not (B, J, K, C)-dense
        fft_dense = torch.fft.fft(xp, dim=-1).is_contiguous()
        fft_ms = cuda_ms(lambda: torch.fft.fft(xp, dim=-1) if fft_dense
                         else torch.fft.fft(xp, dim=-1).contiguous())
        mm_ms = cuda_ms(lambda: torch.matmul(xp, mats.fwd))
        dft3_ms = cuda_ms(lambda: dft3(x, mats))
        fftn_ms = cuda_ms(lambda: torch.fft.fftn(x, dim=(-3, -2, -1)))
        enc_us = lib.pcx_axis_dft_encode_us(x.data_ptr(), b, n, n, n, 1000)
        layout = ("already (B, J, K, C)-contiguous" if fft_dense else
                  "not (B, J, K, C)-contiguous, + .contiguous()")
        print(f"{head}; plan "
              f"{ops / 1e9:.3f} GFLOP ({plan_flops(n):.2f} per output), "
              f"{1e3 * ops / peak:.3f} ms at the f32 peak; einsum "
              f"{plain_ms:.3f} ms; library: torch.fft.fft on the contracted "
              f"axis {fft_ms:.3f} ms (output {layout}), torch.matmul "
              f"{mm_ms:.3f} ms; dft3 fwd vs fftn "
              f"{err_f / scale_f:.3e}, fwd+inv vs x {err_b / scale_b:.3e}; "
              f"3-D: dft3 {dft3_ms:.3f} ms, cuFFT fftn {fftn_ms:.3f} ms; "
              f"tensor-map encode {enc_us:.2f} us per launch", flush=True)
        if not (err_f <= K2_TOL * scale_f and err_b <= K2_TOL * scale_b):
            fail(f"K2 N={n}: dft3 forward {err_f / scale_f:.3e} of scale "
                 f"from fftn, forward+inverse {err_b / scale_b:.3e} from x "
                 f"(limit {K2_TOL:g})")
        if n == N:
            rec = {"name": "axis_dft", "route": "cuda", "arith": FP32_FMA,
                   "source": "pcx_torch/kernels/csrc/axis_dft.cu",
                   "replaces": "pcx/operators/pallas_kernels.py:288",
                   "ms": ms, "ms_inverse": ms_inv,
                   "plain_ms": plain_ms, **bd,
                   "share": bd["bound_ms"] / ms, "library_ms": fft_ms,
                   "library_call": "torch.fft.fft(x.permute(0, 2, 3, 1), "
                                   "dim=-1)" + ("" if fft_dense
                                                else ".contiguous()"),
                   "matmul_ms": mm_ms, "plan": list(factor_pair(n)),
                   "plan_gflop": ops / 1e9, "dft3_ms": dft3_ms,
                   "cufft_fftn_ms": fftn_ms, "encode_us": enc_us}
        del x, xp
    rec["by_batch"] = {b: _k2_batch(gen, dev, b, peak, lib)
                       for b in K2_WCAP_BS + K2_LANES_BS}
    worst = max([worst] + [r["max_abs_err"] for r in rec["by_batch"].values()])
    worst_128 = max([worst_128] + [r["max_abs_err_c128"]
                                   for r in rec["by_batch"].values()])
    # the wrapper's host cost per call at a launch-bound size
    x = torch.randn((2, 16, 16, 16), generator=gen, device=dev,
                    dtype=torch.complex64)
    axis_dft(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        axis_dft(x)
    host_us = 1e6 * (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    print(f"phase k2: host us per axis_dft call at (2, 16, 16, 16): "
          f"{host_us:.1f}", flush=True)
    rec.update(max_abs_err=worst, max_abs_err_c128=worst_128,
               host_us=host_us)
    return rec


def phase_k3(gen, dev, peak: float) -> dict:
    from pcx_torch.kernels.gram9 import gram9, gram9_plain
    from pcx_torch.kernels.gram_chunks import gram_chunks_plain
    m, d = 16, 3 * N ** 3
    blocks = [torch.randn((m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(6)]
    t_k = gram9(*blocks)
    t_p = gram9_plain(*blocks)
    s, hs = torch.cat(blocks[:3]), torch.cat(blocks[3:])
    t_128 = s.to(torch.complex128).conj() @ hs.to(torch.complex128).T
    torch.cuda.synchronize()
    err = max_err(t_k, t_p)
    scale = float(t_p.abs().max())
    err_k128, err_p128 = max_err(t_k, t_128), max_err(t_p, t_128)
    err_lib = max_err(gram_chunks_plain((s,), (hs,)), t_p)
    lib_ms = cuda_ms(lambda: gram_chunks_plain((s,), (hs,)))
    del s, hs, t_128
    ms = cuda_ms(lambda: gram9(*blocks))
    plain_ms = cuda_ms(lambda: gram9_plain(*blocks))
    cat_ms = cuda_ms(lambda: gram_chunks_plain(blocks[:3], blocks[3:]))
    # (3m)^2 D complex conjugate products (8 flop); six blocks in, T out
    rec, text = tensor_core_record(ms, lib_ms, 8.0 * (3 * m) ** 2 * d,
                                   8.0 * 6 * m * d + 16.0 * (3 * m) ** 2,
                                   peak)
    print(f"phase k3: m={m} D={d} chunk 2048 max|dT|/max|T|="
          f"{err / scale:.3e} (vs complex128: kernel {err_k128 / scale:.3e},"
          f" plain {err_p128 / scale:.3e}; the cuBLAS route at chunk 256 vs "
          f"plain {err_lib / scale:.3e}); kernel {ms:.3f} ms plain "
          f"{plain_ms:.3f} ms library (the cuBLAS route on the stacked "
          f"blocks) {lib_ms:.3f} ms, with the two torch.cat {cat_ms:.3f} ms;"
          f" {text}", flush=True)
    if not err <= 1e-5 * scale:
        fail("K3 disagrees with its plain version (atol 1e-5*max|T|)")
    return {"name": "gram9", "route": "cuda",
            "source": "pcx_torch/kernels/csrc/gram9.cu",
            "replaces": "pcx/operators/pallas_kernels.py:27",
            "max_abs_err": err, "max_abs_err_c128": err_k128, "ms": ms,
            "plain_ms": plain_ms, **rec, "library_ms": lib_ms,
            "library_with_cat_ms": cat_ms}


def phase_k3_lanes(gen, dev, peak: float, one_ms: float,
                   lanes: int = LANES_K) -> dict:
    """K3 on a lane axis: six (lanes, 16, 3*120^3) blocks against the
    plain version (phase 5's tolerance), lane 0 against the launch without
    a lane axis bit for bit, timed beside the bound, ``lanes`` one-lane
    launches and the cuBLAS route of the stacked lanes (K6's plain
    version, the rr_gram="xla" route before K6)."""
    from pcx_torch.kernels.gram9 import gram9, gram9_plain
    from pcx_torch.kernels.gram_chunks import gram_chunks_plain
    m, d = 16, 3 * N ** 3
    blocks = [torch.randn((lanes, m, d), generator=gen, device=dev,
                          dtype=torch.complex64) for _ in range(6)]
    t_k = gram9(*blocks)
    t_p = gram9_plain(*blocks)
    same = bool(torch.equal(t_k[0], gram9(*(b[0] for b in blocks))))
    torch.cuda.synchronize()
    err, scale = max_err(t_k, t_p), float(t_p.abs().max())
    del t_p
    ms = cuda_ms(lambda: gram9(*blocks))
    plain_ms = cuda_ms(lambda: gram9_plain(*blocks))
    s, hs = torch.cat(blocks[:3], dim=1), torch.cat(blocks[3:], dim=1)
    lib_ms = cuda_ms(lambda: gram_chunks_plain((s,), (hs,)))
    del s, hs
    rec, text = tensor_core_record(ms, lib_ms,
                                   8.0 * lanes * (3 * m) ** 2 * d,
                                   8.0 * 6 * lanes * m * d
                                   + 16.0 * lanes * (3 * m) ** 2, peak)
    print(f"phase k3 lanes: L={lanes} m={m} D={d} max|dT|/max|T|="
          f"{err / scale:.3e}; lane 0 equals the one-lane launch: {same}; "
          f"kernel {ms:.3f} ms ({ms / lanes:.3f} ms per lane against "
          f"{one_ms:.3f} ms for one lane) plain {plain_ms:.3f} ms library "
          f"(the cuBLAS route on the stacked lanes) {lib_ms:.3f} ms; {text}",
          flush=True)
    if not (err <= 1e-5 * scale and same):
        fail("K3 on a lane axis disagrees with its plain version (atol "
             "1e-5*max|T|) or, on lane 0, with the one-lane launch")
    del blocks, t_k
    torch.cuda.empty_cache()   # the subprocess phases need the card's memory
    return {"name": "gram9", "route": "cuda",
            "source": "pcx_torch/kernels/csrc/gram9.cu",
            "replaces": "pcx/operators/pallas_kernels.py:27",
            "lanes": lanes, "max_abs_err": err, "ms": ms,
            "ms_per_lane": ms / lanes, "one_lane_ms": one_ms,
            "plain_ms": plain_ms, **rec, "library_ms": lib_ms}


def phase_k4(gen, dev, peak: float, m: int = 16) -> dict:
    """K4 block_combine at the three calls of the main path at N=120, m=16:
    the second SVQB's projection P - [X|W] C (two blocks and an addend),
    its scaling C^T P, and the Rayleigh-Ritz update X' = [X|W|P] C of the
    stacked (48, D) block (the densest call).  Each against its plain
    version (atol 1e-5 of the output scale) and complex128 (no worse than
    1.5x the error of the stacked composition: one cuBLAS cgemm over the
    concatenated blocks, then the subtraction);
    timed beside its bound, the plain version, one cuBLAS call of the same
    products on operands stacked beforehand (``library_ms``) and the
    stacked composition with its concatenation (``stacked_ms``)."""
    from pcx_torch.kernels.block_combine import (block_combine,
                                                 block_combine_plain,
                                                 bytes_moved)
    d = 3 * N ** 3
    c = lambda *sh: torch.randn(sh, generator=gen, device=dev,
                                dtype=torch.complex64)
    stack, coef, add = c(3 * m, d), c(3 * m, m), c(m, d)
    x, w = stack[:m], stack[m:2 * m]
    calls = {
        "projection": (((x, w), (coef[:m], coef[m:2 * m])),
                       {"addend": add, "subtract": True},
                       lambda: torch.addmm(add, coef[:2 * m].T,
                                           stack[:2 * m], alpha=-1),
                       lambda: add - coef[:2 * m].T @ torch.cat((x, w))),
        "scaling": (((add,), (coef[:m],)), {},
                    lambda: coef[:m].T @ add, lambda: coef[:m].T @ add),
        "update": (((stack,), (coef,)), {}, lambda: coef.T @ stack,
                   lambda: coef.T @ stack),
    }
    out = {}
    for name, (args, kw, lib_fn, stacked_fn) in calls.items():
        got = block_combine(*args, **kw)
        want = block_combine_plain(*args, **kw)
        a128 = [[t.to(torch.complex128) for t in grp] for grp in args]
        kw128 = {k: (v.to(torch.complex128) if torch.is_tensor(v) else v)
                 for k, v in kw.items()}
        exact = block_combine_plain(*a128, **kw128)
        torch.cuda.synchronize()
        scale = float(want.abs().max())
        err = max_err(got, want)
        err_k = max_err(got.to(torch.complex128), exact)
        err_p = max_err(want.to(torch.complex128), exact)
        err_lib = max_err(stacked_fn().to(torch.complex128), exact)
        del got, want, exact, a128, kw128
        ms = cuda_ms(lambda: block_combine(*args, **kw))
        plain_ms = cuda_ms(lambda: block_combine_plain(*args, **kw))
        lib_ms = cuda_ms(lib_fn)
        stacked_ms = cuda_ms(stacked_fn)
        rows = sum(b.shape[0] for b in args[0])
        b = bound(8.0 * rows * m * d, bytes_moved(*args, kw.get("addend")),
                  peak)
        print(f"phase k4 {name}: {rows} rows -> {m} at D={d} "
              f"{'with' if kw else 'without'} addend: max|d|/max|out|="
              f"{err / scale:.3e} (vs complex128: kernel "
              f"{err_k / scale:.3e}, plain {err_p / scale:.3e}, stacked "
              f"{err_lib / scale:.3e}); kernel "
              f"{ms:.3f} ms plain {plain_ms:.3f} ms library (one cuBLAS "
              f"call, stacked) {lib_ms:.3f} ms with the concatenation "
              f"{stacked_ms:.3f} ms bound {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}) = {100 * b['bound_ms'] / ms:.1f}% reached",
              flush=True)
        if not err <= 1e-5 * scale:
            fail(f"K4 {name} disagrees with its plain version (atol "
                 f"1e-5*max|out|)")
        if not err_k <= 1.5 * err_lib:
            fail(f"K4 {name}: error against complex128 {err_k:.3e} over "
                 f"1.5x the stacked cuBLAS composition's {err_lib:.3e}")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "stacked_ms": stacked_ms, **b,
                     "share": b["bound_ms"] / ms, "max_abs_err": err,
                     "err_c128": err_k, "err_c128_plain": err_p,
                     "err_c128_stacked": err_lib}
    del stack, coef, add, x, w, calls
    torch.cuda.empty_cache()
    upd = out["update"]
    return {"name": "block_combine", "route": "cuda", "arith": FP32_FMA,
            "source": "pcx_torch/kernels/csrc/block_combine.cu",
            "replaces": None, **upd, "calls": out}


def phase_k5(gen, dev, m: int = 16) -> dict:
    """K5 op_blocks at the operator's shapes, N=120 and m=16: pre (A(-conj
    d) x), post without the penalty (``ama``) and post with it and a shift
    (``ama_bb``).  Each against its plain version, which is the eager
    composition it replaces, bit for bit (``torch.equal``), and its error
    against complex128 beside the plain version's; timed beside its bytes
    bound and the plain composition (``library_ms``: the eager PyTorch
    calls the operator made before K5)."""
    from pcx_torch.kernels.op_blocks import (POST, POST_PENALTY, PRE,
                                             bytes_moved, op_post,
                                             op_post_plain, op_pre,
                                             op_pre_plain)
    from pcx_torch.operators.symbols import HermSymbol
    shape, sym_shape = (m, 3, N, N, N), (3, N, N, N)
    c = lambda sh: torch.randn(sh, generator=gen, device=dev,
                               dtype=torch.complex64)
    x, z, d_a = c(shape), c(shape), c(sym_shape)
    b = HermSymbol(torch.rand(sym_shape, generator=gen, device=dev),
                   c(sym_shape))
    shift = 0.731
    w = torch.complex128
    b128 = HermSymbol(b.diag.double(), b.sdiag.to(w))
    calls = {
        "pre": (PRE, lambda: op_pre(x, d_a), lambda: op_pre_plain(x, d_a),
                lambda: op_pre_plain(x.to(w), d_a.to(w))),
        "post": (POST, lambda: op_post(z, d_a), lambda: op_post_plain(z, d_a),
                 lambda: op_post_plain(z.to(w), d_a.to(w))),
        "post_penalty": (POST_PENALTY, lambda: op_post(z, d_a, x, b, shift),
                         lambda: op_post_plain(z, d_a, x, b, shift),
                         lambda: op_post_plain(z.to(w), d_a.to(w), x.to(w),
                                               b128, shift)),
    }
    out = {}
    for name, (kind, k5_fn, plain_fn, exact_fn) in calls.items():
        got, want = k5_fn(), plain_fn()
        torch.cuda.synchronize()
        same = bool(torch.equal(got, want))
        exact = exact_fn()
        norm = float(torch.linalg.vector_norm(exact))
        err_k = float(torch.linalg.vector_norm(got.to(w) - exact)) / norm
        err_p = float(torch.linalg.vector_norm(want.to(w) - exact)) / norm
        del got, want, exact
        ms = cuda_ms(k5_fn)
        lib_ms = cuda_ms(plain_fn)
        nbytes = bytes_moved(kind, x, d_a)
        b_ms = 1e3 * nbytes / HBM_BYTES_S
        print(f"phase k5 {name}: {m} columns at N={N}: equal to the eager "
              f"composition {same}; relative error vs complex128 kernel "
              f"{err_k:.3e} plain {err_p:.3e}; kernel {ms:.3f} ms, eager "
              f"composition {lib_ms:.3f} ms, bound {b_ms:.3f} ms ({nbytes} "
              f"bytes) = {100 * b_ms / ms:.1f}% reached", flush=True)
        if not same:
            fail(f"K5 {name} differs from the eager composition")
        out[name] = {"ms": ms, "plain_ms": lib_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": "bytes",
                     "share": b_ms / ms, "err_c128": err_k,
                     "err_c128_plain": err_p}
    del x, z, d_a, b, b128, calls
    torch.cuda.empty_cache()
    post = out["post_penalty"]
    return {"name": "op_post", "route": "cuda", "arith": FP32_FMA,
            "source": "pcx_torch/kernels/csrc/op_blocks.cu",
            "replaces": None, **post, "calls": out}


def phase_k6(gen, dev, peak: float, m: int = 16) -> dict:
    """K6 gram_chunks at the main path's Grams at N=120, m=16: a 16 x 16
    Gram, the second SVQB's projection [X|W]^H P (one launch that reads P
    once) and the six-block Rayleigh-Ritz Gram [X|W|P]^H [HX|HW|HP].  Each
    against complex128 (relative Frobenius error no worse than 1.25x the
    cuBLAS route's and at most 5e-7), two launches bit for bit; timed
    beside its bound (bytes, or operations at the f32 peak), the plain
    version (the cuBLAS route with its concatenations) and the cuBLAS route
    on operands stacked beforehand (``library_ms``)."""
    from pcx_torch.kernels.gram_chunks import (bytes_moved, gram_chunks,
                                               gram_chunks_plain)
    d = 3 * N ** 3
    c = lambda *sh: torch.randn(sh, generator=gen, device=dev,
                                dtype=torch.complex64)
    stack, hstack = c(3 * m, d), c(3 * m, d)
    s3 = [stack[i * m:(i + 1) * m] for i in range(3)]
    h3 = [hstack[i * m:(i + 1) * m] for i in range(3)]
    calls = {"gram16": ((s3[0],), (h3[0],)),
             "projection": ((s3[0], s3[1]), (s3[2],)),
             "rayleigh_ritz": (tuple(s3), tuple(h3))}
    out = {}
    for name, (left, right) in calls.items():
        got, again = gram_chunks(left, right), gram_chunks(left, right)
        lstack, rstack = torch.cat(left), torch.cat(right)
        exact = gram_chunks_plain((lstack.to(torch.complex128),),
                                  (rstack.to(torch.complex128),))
        norm = float(torch.linalg.vector_norm(exact))

        def rel(a):
            return float(torch.linalg.vector_norm(a.to(torch.complex128)
                                                  - exact)) / norm

        err_k = rel(got)
        err_lib = rel(gram_chunks_plain((lstack,), (rstack,)))
        same = bool(torch.equal(got, again))
        del got, again, exact
        ms = cuda_ms(lambda: gram_chunks(left, right))
        plain_ms = cuda_ms(lambda: gram_chunks_plain(left, right))
        lib_ms = cuda_ms(lambda: gram_chunks_plain((lstack,), (rstack,)))
        del lstack, rstack
        p, q = (sum(b.shape[0] for b in side) for side in (left, right))
        nbytes = bytes_moved(left, right)
        b = bound(8.0 * p * q * d, nbytes, peak)
        print(f"phase k6 {name}: {p} x {q} rows at D={d}: relative error "
              f"vs complex128 kernel {err_k:.3e} cuBLAS route {err_lib:.3e}"
              f" ({err_k / err_lib:.3f}x); two launches equal {same}; "
              f"kernel {ms:.3f} ms plain (with its concatenations) "
              f"{plain_ms:.3f} ms library (the cuBLAS route, stacked) "
              f"{lib_ms:.3f} ms bound {b['bound_ms']:.3f} ms ({b['bound_by']}"
              f", {nbytes} bytes) = {100 * b['bound_ms'] / ms:.1f}% reached",
              flush=True)
        if not same:
            fail(f"K6 {name}: two launches differ")
        if not (err_k <= 1.25 * err_lib and err_k <= 5e-7):
            fail(f"K6 {name}: error against complex128 {err_k:.3e} over "
                 f"1.25x the cuBLAS route's {err_lib:.3e} or 5e-7")
        out[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     **b, "share": b["bound_ms"] / ms, "bytes": nbytes,
                     "err_c128": err_k, "err_c128_library": err_lib}
    del stack, hstack, s3, h3, calls
    torch.cuda.empty_cache()
    rr_rec = out["rayleigh_ritz"]
    return {"name": "gram_chunks", "route": "cuda", "arith": FP32_FMA,
            "source": "pcx_torch/kernels/csrc/gram_chunks.cu",
            "replaces": None, **rr_rec, "calls": out}


def phase_operator(gen, dev, n: int = N, diel_type: str = "chiral"):
    """complex64 ama_bb through K2 against complex128 through torch.fft;
    returns the solver (for its dielectric)."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.operators import maxwell
    from pcx_torch.operators import symbols as sym
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV,
                                     diel_type=diel_type),
                       device=dev, dtype=torch.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    sy = kps.symbols_for(alpha)
    d_a = sym.build_curl(kps.parts, alpha)
    b = sym.penalty(d_a, sy.pnt)
    x = torch.randn((2, 3, n, n, n), generator=gen, device=dev,
                    dtype=torch.complex128)
    y32 = maxwell.ama_bb(x.to(torch.complex64), sy.d_a, sy.b, kps.diel,
                         sy.shift, kps.dft)
    y64 = maxwell.ama_bb(x, d_a, b, kps.diel, sy.shift)
    rel = float(torch.linalg.norm(y32.to(torch.complex128) - y64)
                / torch.linalg.norm(y64))
    print(f"phase operator: {diel_type} N={n} complex64 ama_bb (K2) vs "
          f"complex128 torch.fft: relative error {rel:.3e}", flush=True)
    if not rel <= 1e-5:
        fail(f"complex64 {diel_type} operator disagrees with complex128 "
             f"(> 1e-5)")
    return kps


def phase_pseudo_operator(gen, dev, n: int = N) -> dict:
    """Phase 10; returns the ms per 16-column apply of each dielectric."""
    from pcx_torch.operators.dielectric import build
    ms = {}
    for diel_type in (CROSSDOF, TRIVIAL, "chiral", CROSSDOF + " preset 3"):
        if diel_type == "chiral":     # the last two: timed only
            diel = build(diel_type, n, "sc_curv", dev)
        elif diel_type.endswith("preset 3"):   # all three component pairs
            diel = build(CROSSDOF, n, "sc_curv", dev, eps_opt=3)
        else:
            diel = phase_operator(gen, dev, n, diel_type).diel
            x, y = (torch.randn((2, 3, n, n, n), generator=gen, device=dev,
                                dtype=torch.complex128) for _ in range(2))
            x32, y32 = x.to(torch.complex64), y.to(torch.complex64)
            my64, my32 = diel(y), diel(y32)
            rel = float(torch.linalg.norm(my32.to(torch.complex128) - my64)
                        / torch.linalg.norm(my64))
            a = torch.vdot(x32.flatten(), my32.flatten())
            b = torch.vdot(y32.flatten(), diel(x32).flatten()).conj()
            herm = float((a - b).abs() / a.abs())
            print(f"phase pseudo-operator: {diel_type} N={n} eps^-1 apply "
                  f"complex64 vs complex128: relative error {rel:.3e}; "
                  f"|<x,My> - conj<y,Mx>| / |<x,My>| = {herm:.3e} "
                  f"(complex64)", flush=True)
            if my32.dtype != torch.complex64 or not rel <= 1e-6:
                fail(f"complex64 {diel_type} apply disagrees with "
                     f"complex128 (> 1e-6) or was promoted")
            if not herm <= 1e-5:
                fail(f"{diel_type} apply is not Hermitian in complex64 "
                     f"(> 1e-5)")
            del x, y, x32, y32, my64, my32
        if dev.type == "cuda":
            x16 = torch.randn((16, 3, n, n, n), generator=gen, device=dev,
                              dtype=torch.complex64)
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            ms[diel_type] = cuda_ms(lambda: diel(x16))
            extra = torch.cuda.max_memory_allocated(dev) - base
            print(f"phase pseudo-operator: {diel_type} eps^-1 apply on a "
                  f"(16, 3, {n}^3) complex64 block "
                  f"({x16.numel() * 8 / 2**20:.0f} MiB): "
                  f"{ms[diel_type]:.3f} ms (CUDA events, median of 10), "
                  f"{extra / 2**20:.0f} MiB above the block at its peak",
                  flush=True)
            del x16
    return ms


def golden_row(lattice: str, n: int, index: int, diel_type: str = "chiral"):
    path = os.path.join(HERE, "output_c64", diel_type,
                        f"bandgap_{lattice}.json")
    with open(path) as f:
        return np.asarray(json.load(f)[f"{lattice}_{n}_frequencies"][index])


def gate(kps, alpha, res, golden, tag: str, maxiter_ok: bool = False) -> str:
    """'' if the solve passes the gates, else why not: status CONVERGED or
    FLOOR (with ``maxiter_ok`` also MAXITER: the slower solver variants),
    refined |omega - omega_re| <= 1e-3, finite Ritz vectors of the block
    shape, and omega_re within 3.5e-3 of the golden row."""
    from pcx_torch.solvers.lobpcg import Status
    ok = (Status.CONVERGED, Status.FLOOR) + ((Status.MAXITER,) if maxiter_ok
                                             else ())
    if res.status not in ok:
        return f"status {Status(res.status).name}"
    rep = kps.validate_solution(alpha, res, raise_on_spurious=False)
    dev = float(np.abs(rep.omega_pnt - rep.omega_re).max())
    gold = (float(np.abs(rep.omega_re - golden).max())
            if golden is not None else float("nan"))
    ok_x = (tuple(res.x.shape[1:]) == (3,) + (kps.cfg.n,) * 3
            and bool(torch.isfinite(torch.view_as_real(res.x)).all()))
    print(f"  {tag}: status {Status(res.status).name} iters "
          f"{res.iterations} wall {res.wall_time:.3f} s "
          f"({1e3 * res.wall_time / max(res.iterations, 1):.1f} ms/iter) "
          f"max|omega-omega_re| {dev:.3e} max|omega_re-golden| {gold:.3e}",
          flush=True)
    print(f"    omega_re {np.array2string(rep.omega_re, precision=6)}",
          flush=True)
    if rep.spurious or not dev <= SPURIOUS_TOL:
        return f"spurious (max|omega-omega_re| {dev:.3e})"
    if not ok_x:
        return "Ritz vectors not finite or of the wrong shape"
    if golden is not None and not gold <= GOLDEN_TOL:
        return f"omega_re {gold:.3e} from the golden row"
    return ""


def phase_single(dev, n: int = N, golden: bool = True) -> tuple:
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                       device=dev, dtype=torch.complex64)
    alpha = np.array([np.pi, 0.0, 0.0])
    t0 = time.time()
    res = kps.solve(alpha, seed=0, validate_result=False)
    print(f"phase single: sc_curv N={n} alpha=(pi,0,0) cold solve, "
          f"{time.time() - t0:.3f} s with the plane-wave start", flush=True)
    why = gate(kps, alpha, res, golden_row("sc_curv", n, 19) if golden
               else None, "k=19")
    if why:
        fail(f"single point: {why}")
    return res.iterations, res.wall_time


def phase_warm(dev, n: int = N, golden: bool = True) -> float:
    """Phase 8; returns the ms per iteration of its cold solve."""
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=NEV),
                       device=dev, dtype=torch.complex64)
    path = lattices.k_path("fcc")
    print(f"phase warm: fcc N={n}, cold at k_path index {WARM_INDICES[0]}, "
          f"warm at {', '.join(map(str, WARM_INDICES[1:]))}", flush=True)
    x_prev = None
    for i in WARM_INDICES:
        alpha = path[i]
        gold = golden_row("fcc", n, i) if golden else None
        res = kps.solve(alpha, x0=x_prev, seed=i, validate_result=False)
        kind = "cold" if x_prev is None else "warm"
        why = gate(kps, alpha, res, gold, f"k={i} {kind}")
        if why and x_prev is not None:
            # bench.py's sweep protocol: a rejected warm solve gets one cold
            # retry with a fresh seed, and its time counts for the point.
            print(f"  k={i}: warm solve rejected ({why}, doom "
                  f"{kps.last_doom}); cold retry", flush=True)
            res = kps.solve(alpha, seed=i + 10007, validate_result=False)
            why = gate(kps, alpha, res, gold, f"k={i} cold retry")
        if why:
            fail(f"warm chain k={i}: {why}")
        if x_prev is None:
            cold_ms = 1e3 * res.wall_time / max(res.iterations, 1)
        x_prev = res.x
    return cold_ms


def phase_sweep(dev, n: int = N, golden: bool = True) -> None:
    """The sweep entry point with K3's route: bandgap over SWEEP_INDICES,
    then the failed-row retry of index 10 through the warm feeder."""
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.io import BandLibrary
    from pcx_torch.lattices import k_path
    from pcx_torch.metrics import load_jsonl
    from pcx_torch.solvers.lobpcg import Status
    n_k = k_path("fcc").shape[0]
    with tempfile.TemporaryDirectory(prefix="pcx_sweep_") as out:
        metrics = os.path.join(out, "metrics.jsonl")
        kw = dict(n=n, lattice="fcc", nev=NEV, dtype=torch.complex64,
                  device=dev, output_dir=out, metrics_path=metrics,
                  solver_opts={"rr_gram": "pallas"})
        path = os.path.join(out, "chiral", "bandgap_fcc.json")
        print(f"phase sweep: bandgap fcc N={n} complex64 rr_gram='pallas' "
              f"indices {SWEEP_INDICES}", flush=True)
        t0 = time.time()
        err = bandgap(indices=SWEEP_INDICES, verbose=False, **kw)
        wall = time.time() - t0
        recs = load_jsonl(metrics)
        for i, rec in zip(SWEEP_INDICES, recs):
            print(f"  k={i}: status {Status(rec['status']).name} iters "
                  f"{rec['iterations']} wall {rec['wall_s']:.3f} s "
                  f"({1e3 * rec['wall_s'] / max(rec['iterations'], 1):.1f} "
                  f"ms/iter)", flush=True)
        print(f"  sweep of {len(SWEEP_INDICES)} points: {wall:.3f} s, "
              f"{wall / len(SWEEP_INDICES):.3f} s/k-point", flush=True)
        if err or len(recs) != len(SWEEP_INDICES):
            fail(f"sweep: failed indices {err}, {len(recs)} records")
        lib = BandLibrary(path, "fcc", n, n_k, NEV)
        for i in SWEEP_INDICES:
            gold = golden_row("fcc", n, i) if golden else None
            dev_i = (float(np.abs(np.array(lib.frequencies[i]) - gold).max())
                     if golden else float("nan"))
            print(f"  k={i}: max|omega - golden| {dev_i:.3e}", flush=True)
            if golden and not dev_i <= GOLDEN_TOL:
                fail(f"sweep row {i}: {dev_i:.3e} from the golden row")

        # The failed-row retry: mark row 10 failed and sweep it alone.
        before = {i: (list(lib.iterations[i]), list(lib.frequencies[i]))
                  for i in (9, 11)}
        lib.record(10, -1, -1, None)
        log = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(log):
            err = bandgap(indices=[10], verbose=True, **kw)
        print(f"  retry of row 10: {time.time() - t0:.3f} s", flush=True)
        for line in log.getvalue().splitlines():
            print(f"    {line}", flush=True)
        lib = BandLibrary(path, "fcc", n, n_k, NEV)
        if err or lib.failed_indices():
            fail(f"retry of row 10: failed indices {err}")
        if "warm-feeder solve of computed neighbor k=11" not in log.getvalue():
            fail("retry of row 10 did not go through the warm feeder")
        after = {i: (list(lib.iterations[i]), list(lib.frequencies[i]))
                 for i in (9, 11)}
        if after != before:
            fail("the retry of row 10 changed rows 9 or 11")
        if golden:
            dev10 = float(np.abs(np.array(lib.frequencies[10])
                                 - golden_row("fcc", n, 10)).max())
            print(f"  k=10 restored: max|omega - golden| {dev10:.3e}; rows "
                  f"9 and 11 unchanged", flush=True)
            if not dev10 <= GOLDEN_TOL:
                fail(f"restored row 10: {dev10:.3e} from the golden row")


def phase_pseudo_sweep(dev, n: int = N, golden: bool = True) -> None:
    """Phase 11, the sweep: bandgap of the cross-DoF dielectric over
    PSEUDO_INDICES with K3's route, gated row by row."""
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.io import BandLibrary
    from pcx_torch.lattices import k_path
    from pcx_torch.metrics import load_jsonl
    from pcx_torch.solvers.lobpcg import Status
    n_k = k_path("sc_curv").shape[0]
    with tempfile.TemporaryDirectory(prefix="pcx_pseudo_") as out:
        metrics = os.path.join(out, "metrics.jsonl")
        print(f"phase pseudo-sweep: bandgap sc_curv {CROSSDOF} N={n} "
              f"complex64 rr_gram='pallas' indices {PSEUDO_INDICES}",
              flush=True)
        log = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(log):
            err = bandgap(n=n, lattice="sc_curv", diel_type=CROSSDOF,
                          nev=NEV, dtype=torch.complex64, device=dev,
                          output_dir=out, metrics_path=metrics,
                          indices=PSEUDO_INDICES, verbose=True,
                          solver_opts={"rr_gram": "pallas"})
        wall = time.time() - t0
        for line in log.getvalue().splitlines():   # rejections and retries
            print(f"    {line}", flush=True)
        recs = load_jsonl(metrics) if os.path.exists(metrics) else []
        if err or len(recs) != len(PSEUDO_INDICES):
            fail(f"pseudo-sweep: failed indices {err}, {len(recs)} records")
        lib = BandLibrary(os.path.join(out, CROSSDOF, "bandgap_sc_curv.json"),
                          "sc_curv", n, n_k, NEV)
        for i, rec in zip(PSEUDO_INDICES, recs):
            row = np.array(lib.frequencies[i])
            dev_i = float(np.abs(np.array(rec["omega_pnt"])
                                 - np.array(rec["omega"])).max())
            gold = (float(np.abs(row - golden_row("sc_curv", n, i,
                                                  CROSSDOF)).max())
                    if golden else float("nan"))
            print(f"  k={i}: status {Status(rec['status']).name} iters "
                  f"{rec['iterations']} wall {rec['wall_s']:.3f} s "
                  f"({1e3 * rec['wall_s'] / max(rec['iterations'], 1):.1f} "
                  f"ms/iter) max|omega-omega_re| {dev_i:.3e} "
                  f"max|omega - golden| {gold:.3e}", flush=True)
            if rec["status"] not in (Status.CONVERGED, Status.FLOOR):
                fail(f"pseudo-sweep row {i}: status "
                     f"{Status(rec['status']).name}")
            if not np.array_equal(row, np.array(rec["omega"])):
                fail(f"pseudo-sweep row {i}: the library read back differs "
                     f"from the solve's frequencies")
            if not dev_i <= SPURIOUS_TOL:
                fail(f"pseudo-sweep row {i}: spurious ({dev_i:.3e})")
            if golden and not gold <= GOLDEN_TOL:
                fail(f"pseudo-sweep row {i}: {gold:.3e} from the golden row")
        print(f"  sweep of {len(PSEUDO_INDICES)} points: {wall:.3f} s, "
              f"{wall / len(PSEUDO_INDICES):.3f} s/k-point", flush=True)


def phase_variants(dev, n: int = N, golden: bool = True) -> None:
    """Phase 11, the single cold solves: the trivial Hermitian-tensor
    dielectric with softlock and descent, the chiral point of phase 7 with
    nolock."""
    from pcx_torch import lattices
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    print(f"phase variants: sc_curv N={n} single cold solves", flush=True)
    cfg = ProblemConfig(n=n, lattice="sc_curv", nev=NEV, diel_type=TRIVIAL)
    diel = None
    for solver in ("softlock", "descent"):
        kps = KPointSolver(cfg, device=dev, dtype=torch.complex64,
                           solver=solver, diel=diel)
        diel = kps.diel
        alpha = lattices.k_path("sc_curv")[TRIVIAL_INDEX]
        res = kps.solve(alpha, seed=TRIVIAL_INDEX, validate_result=False)
        why = gate(kps, alpha, res,
                   golden_row("sc_curv", n, TRIVIAL_INDEX, TRIVIAL)
                   if golden else None,
                   f"{TRIVIAL} k={TRIVIAL_INDEX} {solver}",
                   maxiter_ok=solver != "softlock")
        if why:
            fail(f"{TRIVIAL} {solver}: {why}")
        del kps, res
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                       device=dev, dtype=torch.complex64, solver="nolock")
    alpha = np.array([np.pi, 0.0, 0.0])
    res = kps.solve(alpha, seed=0, validate_result=False)
    why = gate(kps, alpha, res, golden_row("sc_curv", n, 19) if golden
               else None, "chiral k=19 nolock", maxiter_ok=True)
    if why:
        fail(f"chiral nolock: {why}")


def phase_solvers_small(dev, n: int = SMALL_N) -> None:
    """Phase 12: every solver of the JAX package's tools/tpu_smoke.py."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.operators import maxwell
    from pcx_torch.operators.blocks import h_block
    from pcx_torch.operators.symbols import HermSymbol
    from pcx_torch.solvers import lobpcg, lobpcg_rs
    from pcx_torch.solvers import rayleigh_ritz as rr
    from pcx_torch.solvers.lobpcg import Status
    tol, maxiter = SMALL_TOL, SMALL_MAXITER
    alpha = np.array([np.pi, 0.0, 0.0])
    cfg = ProblemConfig(n=n, lattice="sc_curv", nev=SMALL_NEV)
    print(f"phase solvers-32: sc_curv chiral N={n} alpha=(pi,0,0) "
          f"complex64 tol {tol} nev {SMALL_NEV} maxiter {maxiter}",
          flush=True)
    kps = None
    for name in KPS_SOLVERS:
        kps = KPointSolver(cfg, device=dev, tol=tol, maxiter=maxiter,
                           dtype=torch.complex64, solver=name,
                           diel=kps.diel if kps else None)
        res = kps.solve(alpha, seed=0, validate_result=False)
        why = gate(kps, alpha, res, None, name,
                   maxiter_ok=name in ("descent", "davidson"))
        if why:
            fail(f"solvers-32 {name}: {why}")

    kps = KPointSolver(cfg, device=dev, dtype=torch.complex64, diel=kps.diel)
    sy = kps.symbols_for(alpha)

    def h_func(v):
        return maxwell.ama_bb(v, sy.d_a, sy.b, kps.diel, sy.shift, kps.dft)

    bmax = sy.b.diag.max()
    m_sym = HermSymbol(sy.b.diag / bmax, sy.b.sdiag / bmax)

    def m_func(v):
        return v + h_block(v, m_sym)

    def p_func(v):
        return h_block(v, sy.inv)

    rng = np.random.default_rng(7)
    shape = (10, 3, n, n, n)
    x0 = torch.as_tensor((rng.standard_normal(shape) + 1j
                          * rng.standard_normal(shape)).astype(np.complex64),
                         device=dev)

    def report(tag, res, t0, metric, value, limit, maxiter_ok=False):
        wall = time.time() - t0
        st = Status(res.status)
        print(f"  {tag}: status {st.name} iters {res.iterations} wall "
              f"{wall:.3f} s ({1e3 * wall / max(res.iterations, 1):.1f} "
              f"ms/iter) {metric} {value:.3e} (limit {limit:.0e}); lambdas "
              f"{np.array2string(res.lambdas.cpu().numpy()[:4], precision=6)}",
              flush=True)
        ok = (st in (Status.CONVERGED, Status.FLOOR)
              or (maxiter_ok and st == Status.MAXITER))
        if not (ok and np.isfinite(value) and value <= limit
                and bool(torch.isfinite(res.lambdas).all())):
            fail(f"solvers-32 {tag}: status {st.name}, {metric} {value:.3e}")

    t0 = time.time()
    res = lobpcg_rs.lobpcg_sep_max_rs(h_func, x0[:6], 2, tol=tol,
                                      maxiter=maxiter)
    _, v, _ = rr.power_method(h_func, x0[:1], maxiter=PM_STEPS,
                               tol=0.0)
    lam_pm = float(torch.vdot(v.flatten(), h_func(v).flatten()).real
                   / torch.vdot(v.flatten(), v.flatten()).real)
    report("lobpcg_sep_max_rs", res, t0, "|lambda_max - power method| / "
           "lambda", abs(float(res.lambdas[0]) - lam_pm) / lam_pm, 1e-3)

    for name in ("lobpcg_gep_rs", "descent_gep_rs"):
        t0 = time.time()
        res = getattr(lobpcg_rs, name)(h_func, m_func, p_func, x0[:8], 4,
                                       tol=tol, maxiter=maxiter)
        xs, lam = res.x[:4], res.lambdas[:4]
        r = h_func(xs) - lam.to(xs.dtype)[:, None, None, None, None] \
            * m_func(xs)
        rel = float((rr.colnorms(r) / ((lam.abs() + 1.0)
                                       * rr.colnorms(xs))).max())
        report(name, res, t0, "relative residual", rel, 10 * tol,
               maxiter_ok=name == "descent_gep_rs")

    nd = 64
    lap = (np.diag(np.full(nd, 3.0)) - np.diag(np.ones(nd - 1), 1)
           - np.diag(np.ones(nd - 1), -1)).astype(np.float32)
    exact = 3.0 - 2.0 * np.cos(np.arange(1, 5) * np.pi / (nd + 1))
    t0 = time.time()
    res = lobpcg.lobpcg_default(lap, nev=4, rlx=3, tol=tol, maxiter=maxiter,
                                seed=11, device=dev)
    report("lobpcg_default", res, t0, "max|lambda - exact|",
           float(np.abs(res.lambdas[:4].cpu().numpy() - exact).max()),
           10 * tol)

    rng = np.random.default_rng(5)
    a = torch.as_tensor(rng.standard_normal((64, 48))
                        + 1j * rng.standard_normal((64, 48)), device=dev)
    want = np.sort(np.linalg.svd(a.cpu().numpy(), compute_uv=False))[:3]
    xs = torch.as_tensor(rng.standard_normal((6, 48))
                         + 1j * rng.standard_normal((6, 48)), device=dev)
    t0 = time.time()
    res = lobpcg.lobpcg_svd(lambda v: v @ a.T, lambda u: u @ a.conj(), xs, 3,
                            tol=1e-8, maxiter=maxiter)
    report("lobpcg_svd (complex128)", res, t0,
           "max relative error of the 3 smallest singular values",
           float(np.abs(res.lambdas[:3].cpu().numpy() - want).max()
                 / want.min()), 1e-6)


def phase_solvers_full(dev, n: int = N, golden: bool = True) -> dict:
    """Phase 13: the full-width solves of mixed, davidson and jd; returns
    the launches of each kernel over the three solves."""
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    alpha = np.array([np.pi, 0.0, 0.0])
    print(f"phase solvers-{n}: sc_curv chiral N={n} nev={NEV} "
          f"alpha=(pi,0,0) cold complex64 solves", flush=True)
    total = dict.fromkeys(kmod.launches(), 0)
    cfg = ProblemConfig(n=n, lattice="sc_curv", nev=NEV)
    ref = golden_row("sc_curv", n, 19) if golden else None
    diel = None
    for name, opts, maxiter in FULL_SOLVES:
        kps = KPointSolver(cfg, device=dev, dtype=torch.complex64,
                           solver=name, maxiter=maxiter, solver_opts=opts,
                           diel=diel)
        diel = kps.diel
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        res = kps.solve(alpha, seed=0, validate_result=False)
        counts = kmod.launches()
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else float("nan"))
        print(f"  {name} {opts}: launches {counts}, peak device memory "
              f"{peak:.2f} GiB, maxiter {maxiter}", flush=True)
        why = gate(kps, alpha, res, ref, f"{name} k=19",
                   maxiter_ok=name != "mixed")
        if why:
            fail(f"solvers-{n} {name}: {why}")
        if dev.type == "cuda":
            if not counts["axis_dft"]:
                fail(f"solvers-{n} {name}: K2 never launched: {counts}")
            if name == "mixed" and (counts["resid_precond"]
                                    or not counts["gram9"]):
                fail(f"solvers-{n} mixed: K1 launched or K3 did not: "
                     f"{counts}")
        for k, v in counts.items():
            total[k] += v
        del kps, res
    return total


def reset_rows(src: str, dst: str, key: str, rows,
               src_key: str = None) -> dict:
    """Copy the band library ``src`` to ``dst`` with ``rows`` of the record
    ``key`` reset to pending ([0, 0], zero frequencies); returns the
    original library.  ``src_key`` (a CPU rehearsal at a small N) renames
    the source's record ``src_key`` to ``key`` first."""
    with open(src) as f:
        lib = json.load(f)
    if src_key and src_key != key:
        lib = {f"{key}_{part}": lib[f"{src_key}_{part}"]
               for part in ("iterations", "frequencies")}
    out = json.loads(json.dumps(lib))
    for i in rows:
        out[f"{key}_iterations"][i] = [0, 0]
        out[f"{key}_frequencies"][i] = [0.0] * NEV
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    with open(dst, "w") as f:
        json.dump(out, f, indent=4)
    return lib


def gate_resumed_rows(path: str, metrics: str, text: str, key: str,
                      ref: dict, alphas, rows, tag: str,
                      golden: bool) -> list:
    """Print and gate the ``rows`` that a ``bandgap`` resume recorded into
    the library at ``path`` (its metrics file ``metrics``, its log
    ``text``): every row computed, CONVERGED or FLOOR, read back as solved,
    inside the 1e-3 spurious gate and (``golden``) within 3.5e-3 of the
    committed row of ``ref``; how it was accepted.  Returns the
    problems."""
    from pcx_torch.metrics import load_jsonl
    from pcx_torch.solvers.lobpcg import Status
    recs = load_jsonl(metrics) if os.path.exists(metrics) else []
    with open(path) as f:
        lib = json.load(f)
    problems = []
    for i in rows:
        tag_i = f"{tag} k={i}"
        rec = next((r for r in recs if np.allclose(r["alpha"], alphas[i])),
                   None)
        if rec is None or lib[f"{key}_iterations"][i][0] <= 0:
            print(f"  {tag_i}: not computed {lib[f'{key}_iterations'][i]}",
                  flush=True)
            problems.append(f"{tag_i}: not computed")
            continue
        row = np.array(lib[f"{key}_frequencies"][i])
        spur = float(np.abs(np.array(rec["omega_pnt"])
                            - np.array(rec["omega"])).max())
        gold = (float(np.abs(row - np.array(
            ref[f"{key}_frequencies"][i])).max())
            if golden else float("nan"))
        how = ("escalated to the complex128 refine"
               if f"k={i}: f64 re-validation PASSED" in text
               else "light refine accepted")
        if f"Warm-started k={i} failed" in text:
            how += "; warm solve rejected, cold retry"
        status = Status(rec["status"]).name
        print(f"  {tag_i}: status {status} iters {rec['iterations']} "
              f"wall {rec['wall_s']:.3f} s "
              f"({1e3 * rec['wall_s'] / max(rec['iterations'], 1):.1f}"
              f" ms/iter) max|omega-omega_re| {spur:.3e} "
              f"max|omega - committed| {gold:.3e}; {how}",
              flush=True)
        if rec["status"] not in (Status.CONVERGED, Status.FLOOR):
            problems.append(f"{tag_i}: status {status}")
        if not np.array_equal(row, np.array(rec["omega"])):
            problems.append(f"{tag_i}: the library read back differs "
                            f"from the solve's frequencies")
        if not spur <= SPURIOUS_TOL:
            problems.append(f"{tag_i}: spurious ({spur:.3e})")
        if golden and not gold <= GOLDEN_TOL:
            problems.append(f"{tag_i}: {gold:.3e} from the committed row")
    return problems


def phase_near_gamma(dev, n: int = N, golden: bool = True) -> None:
    """Phase 14 (F2): resume sc_curv rows NEAR_GAMMA_ROWS of each
    dielectric's committed library with the runner's settings and gate
    every row; all rows are printed before a failure ends the phase."""
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.lattices import k_path
    key = f"sc_curv_{n}"
    alphas = k_path("sc_curv")
    problems = []
    with tempfile.TemporaryDirectory(prefix="pcx_near_gamma_") as out:
        for diel_type in NEAR_GAMMA_DIELS:
            path = os.path.join(out, diel_type, "bandgap_sc_curv.json")
            ref = reset_rows(os.path.join(HERE, "output_c64", diel_type,
                                          "bandgap_sc_curv.json"), path, key,
                             NEAR_GAMMA_ROWS)
            metrics = os.path.join(out, f"{diel_type}.jsonl")
            print(f"phase near-gamma: bandgap sc_curv {diel_type} N={n} "
                  f"complex64 rr_gram='pallas' refine='light', resuming "
                  f"rows {NEAR_GAMMA_ROWS}", flush=True)
            log = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(log):
                err = bandgap(n=n, lattice="sc_curv", diel_type=diel_type,
                              nev=NEV, dtype=torch.complex64, device=dev,
                              output_dir=out, metrics_path=metrics,
                              indices=None, verbose=True,
                              solver_opts={"rr_gram": "pallas"},
                              solver_kw={"refine": "light"})
            wall = time.time() - t0
            text = log.getvalue()
            for line in text.splitlines():
                print(f"    {line}", flush=True)
            if err:
                problems.append(f"{diel_type}: failed indices {err}")
            problems += gate_resumed_rows(path, metrics, text, key, ref,
                                          alphas, NEAR_GAMMA_ROWS, diel_type,
                                          golden)
            print(f"  {diel_type}: {len(NEAR_GAMMA_ROWS)} rows in "
                  f"{wall:.3f} s", flush=True)
    if problems:
        fail(f"near-gamma: {'; '.join(problems)}")


def run_cmd(cmd, env=None, timeout: float = 600) -> subprocess.CompletedProcess:
    """Run ``cmd`` from the checkout in a session of its own; on a timeout
    kill the whole session (the runner's worker too) and fail."""
    p = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"{' '.join(cmd[1:4])}: no end within {timeout:.0f} s")
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def phase_runner(n: int = N, golden: bool = True) -> None:
    """Phase 15: the production runner in a subprocess on a copy of the fcc
    library with RUNNER_ROWS pending, then ``check`` and ``eigen1p`` of the
    command-line launcher."""
    key = f"fcc_{n}"
    with tempfile.TemporaryDirectory(prefix="pcx_runner_") as tmp:
        out = os.path.join(tmp, "out")
        path = os.path.join(out, "chiral", "bandgap_fcc.json")
        ref = reset_rows(os.path.join(HERE, "output_c64", "chiral",
                                      "bandgap_fcc.json"), path, key,
                         RUNNER_ROWS)
        env = dict(os.environ, TMPDIR=tmp)
        hb = os.path.join(tmp, f"pcx_hb_fcc{n}_chiral.hb")
        cmd = [sys.executable, "-m", "pcx_torch.run_sweep", "--n", str(n),
               "--lattice", "fcc", "--diel", "chiral", "--output", out,
               "--max-rounds", "1"]
        print(f"phase runner: {' '.join(cmd[1:])} (rows {RUNNER_ROWS} "
              f"pending); this process holds {_reserved_gib():.2f} GiB of "
              f"the card", flush=True)
        t0 = time.time()
        r = run_cmd(cmd, env=env)
        wall = time.time() - t0
        for line in (r.stdout + r.stderr).splitlines()[-12:]:
            print(f"    {line}", flush=True)
        print(f"  run_sweep: exit {r.returncode}, {wall:.3f} s for "
              f"{len(RUNNER_ROWS)} rows", flush=True)
        if r.returncode != 0:
            fail(f"run_sweep exited {r.returncode}")
        if not os.path.exists(hb):
            fail("run_sweep: the worker never touched the heartbeat file")
        with open(path) as f:
            lib = json.load(f)
        for i in range(len(ref[f"{key}_iterations"])):
            row = np.array(lib[f"{key}_frequencies"][i])
            gold = np.array(ref[f"{key}_frequencies"][i])
            if i not in RUNNER_ROWS:
                if lib[f"{key}_iterations"][i] != ref[f"{key}_iterations"][i] \
                        or not np.array_equal(row, gold):
                    fail(f"run_sweep changed row {i}, which was computed")
                continue
            it, sec = lib[f"{key}_iterations"][i]
            dev_i = float(np.abs(row - gold).max()) if golden else 0.0
            print(f"  k={i}: iters {it:.0f} wall {sec:.3f} s "
                  f"max|omega - committed| {dev_i:.3e}", flush=True)
            if it <= 0 or not dev_i <= GOLDEN_TOL:
                fail(f"run_sweep row {i}: iterations {it}, {dev_i:.3e} from "
                     f"the committed row")

        cmd = [sys.executable, "-m", "pcx_torch", "check", "--n", str(n),
               "--lattice", "fcc", "--output", out]
        r = run_cmd(cmd, timeout=300)
        print(f"  check: exit {r.returncode}: {r.stdout.strip()}", flush=True)
        if r.returncode != 0 or "computed without errors" not in r.stdout:
            fail(f"check: exit {r.returncode}, {r.stdout + r.stderr}")
    cmd = [sys.executable, "-m", "pcx_torch", "eigen1p", "--n", "32",
           "--lattice", "sc_curv", "--alpha", "1,0,0"]
    t0 = time.time()
    r = run_cmd(cmd, timeout=300)
    tail = [ln for ln in r.stdout.splitlines() if ln.startswith("n = ")]
    print(f"  eigen1p: exit {r.returncode} in {time.time() - t0:.3f} s: "
          f"{tail[-1] if tail else ''}", flush=True)
    if r.returncode != 0 or not tail:
        fail(f"eigen1p: exit {r.returncode}, {r.stderr[-2000:]}")


def phase_keywords(dev, single, n: int = N, golden: bool = True) -> dict:
    """Phase 16: the KPointSolver keywords on the cold point of phase 7,
    each solve gated like it; ``single`` is phase 7's (iterations, wall).
    Returns the kernel launches of the two-grid start's run."""
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    alpha = np.array([np.pi, 0.0, 0.0])
    cfg = ProblemConfig(n=n, lattice="sc_curv", nev=NEV)
    ref = golden_row("sc_curv", n, 19) if golden else None
    print(f"phase keywords: sc_curv chiral N={n} alpha=(pi,0,0) cold "
          f"complex64; phase 7's plane-wave start took {single[0]} "
          f"iterations, {single[1]:.3f} s", flush=True)
    diel, coarse = None, None
    for tag, kw in KEYWORD_SOLVES:
        kps = KPointSolver(cfg, device=dev, dtype=torch.complex64, diel=diel,
                           **kw)
        diel = kps.diel
        kmod.reset_launches()
        res = kps.solve(alpha, seed=0, validate_result=False)
        counts = kmod.launches()
        extra = ""
        if kps.x0_mode == "coarse":
            coarse = counts
            extra = (f"; the {kps._coarse_n}^3 coarse solve took "
                     f"{kps.last_x0_wall:.3f} s of the wall")
        print(f"  {tag}: launches {counts}{extra}", flush=True)
        why = gate(kps, alpha, res, ref, tag)
        if why:
            fail(f"keywords {tag}: {why}")
        if dev.type == "cuda" and kps.x0_mode == "coarse" and not (
                counts["resid_precond"] and counts["axis_dft"]):
            fail(f"keywords {tag}: K1 or K2 never launched: {counts}")
        del kps, res
    return coarse


def phase_experiments(dev, warm_ms: float, n: int = N, pack_ns=PACK_NS,
                      check_n: int = CHECK_N, golden: bool = True) -> None:
    """Phase 17: the experiments and the profiling of the port on the card.
    ``warm_ms`` is phase 8's cold ms per iteration, the measurement beside
    which ``phase_breakdown``'s measured iteration is printed."""
    from pcx_torch import kernels as kmod
    from pcx_torch.experiments import precision, runtime, structure
    from pcx_torch.lattices import k_path
    from pcx_torch.profiling import phase_breakdown
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    alpha = k_path("sc_curv")[R_INDEX]
    print(f"phase experiments: pack_cmp({pack_ns}, 'sc_curv', run_cpu=False)"
          f" at alpha=(pi,pi,pi), complex64", flush=True)
    last = [kmod.launches()]
    problems = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    def on_point(n_pt, solver, res):
        now = kmod.launches()
        counts = {k: now[k] - last[0][k] for k in now}
        peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                if dev.type == "cuda" else float("nan"))
        print(f"  N={n_pt}: launches {counts} (warm-up and timed solve), "
              f"peak device memory {peak:.2f} GiB", flush=True)
        gold = None
        if golden and n_pt in (100, 120):
            gold = golden_row("sc_curv", n_pt, R_INDEX)
        why = gate(solver, alpha, res, gold, f"N={n_pt} timed solve")
        if why:
            problems.append(f"N={n_pt}: {why}")
        if dev.type == "cuda" and not (counts["resid_precond"]
                                       and counts["axis_dft"]):
            problems.append(f"N={n_pt}: K1 or K2 never launched: {counts}")
        last[0] = kmod.launches()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)

    table = runtime.pack_cmp(pack_ns, "sc_curv", run_cpu=False, device=dev,
                             on_point=on_point, verbose=False)
    for key, rec in table.items():
        print(f"  {key}: [iters, cpu_s, accel_s, speedup] = {rec}; "
              f"{1e3 * rec[2] / max(rec[0], 1):.1f} ms/iter", flush=True)
    if problems:
        fail(f"experiments pack_cmp: {'; '.join(problems)}")

    gp = precision.global_precision_cmp(n, "sc_curv", device=dev,
                                        verbose=False)
    worst = float(gp["omega_diff"].max())
    print(f"  global_precision_cmp N={n}: complex128 {gp['double'].iterations}"
          f" iters {gp['double'].wall_time:.3f} s, complex64 "
          f"{gp['single'].iterations} iters {gp['single'].wall_time:.3f} s, "
          f"max omega_diff {worst:.3e}", flush=True)
    if not worst <= 1e-4:
        fail(f"global_precision_cmp: omega_diff {worst:.3e} > 1e-4")

    solver = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=NEV),
                          device=dev, dtype=torch.complex64)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pb = phase_breakdown(solver, k_path("fcc")[9], m=16, verbose=False)
    phases = ("operator_s", "precond_s", "gram_rr_s", "ortho_s")
    print(f"  phase_breakdown fcc N={n} k_path[9] m=16 (ms): "
          + ", ".join(f"{k[:-2]} {1e3 * pb[k]:.3f}" for k in phases)
          + f"; measured iteration {1e3 * pb['iteration_s']:.3f} "
          f"ms against phase 8's {warm_ms:.3f} ms/iter; peak "
          f"{pb['memory_mib']:.0f} MiB", flush=True)
    if not (all(np.isfinite(pb[k]) and pb[k] > 0 for k in phases)
            and sum(pb[k] for k in phases) < pb["iteration_s"]):
        fail(f"phase_breakdown: {pb}")
    del solver

    t0 = time.time()
    n_bad = structure.check_sdd(check_n, device=dev, verbose=False)
    n_cpu = structure.check_sdd(check_n, device="cpu", verbose=False)
    print(f"  check_sdd N={check_n}: {n_bad} rows not SDD on the card, "
          f"{n_cpu} on the CPU ({time.time() - t0:.3f} s)", flush=True)
    if n_bad != n_cpu:
        fail(f"check_sdd: {n_bad} on the card, {n_cpu} on the CPU")
    t0 = time.time()
    eig = structure.check_component_hpd(check_n, device=dev, verbose=False)
    print(f"  check_component_hpd N={check_n}: smallest eigenvalues of "
          f"eps^-1 {eig} ({time.time() - t0:.3f} s)", flush=True)
    if not eig[0] > 0:
        fail(f"check_component_hpd: {eig}")

    with tempfile.TemporaryDirectory(prefix="pcx_experiments_") as tmp:
        cmd = [sys.executable, "-m", "pcx_torch.experiments",
               *EXPERIMENTS_CLI, "--output", tmp,
               *(["--cpu"] if dev.type == "cpu" else [])]
        t0 = time.time()
        r = run_cmd(cmd, timeout=300)
        print(f"  {' '.join(cmd[1:])}: exit {r.returncode} in "
              f"{time.time() - t0:.3f} s", flush=True)
        for line in r.stdout.splitlines()[:2]:
            print(f"    {line}", flush=True)
        if r.returncode != 0:
            fail(f"experiments CLI: exit {r.returncode}, {r.stderr[-2000:]}")


# Phase 18: several cards.  The rank processes run _parallel_rank; the
# parent runs the mask engine and checks what the ranks wrote back.
BATCH_INDICES = [9, 10]
MESH_ROWS = [8, 9, 10, 11]
SHARDED_INDEX = 19          # k_path("sc_curv") index of alpha = (pi, 0, 0)
SHARDED_DIELS = ("chiral", CROSSDOF)
MASK_LATTICES = ("sc_curv", "fcc")
PARALLEL_TIMEOUT = 900      # seconds for the ranks of phase 18


def gate_record(res, golden, tag: str) -> str:
    """``gate`` on a ``solve_batch`` member by its own validation report
    (its block may lie on another rank): status, the spurious gate and the
    golden row."""
    from pcx_torch.solvers.lobpcg import Status
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        return f"status {Status(res.status).name}"
    rep = res.report
    dev = float(np.abs(rep.omega_pnt - rep.omega_re).max())
    gold = (float(np.abs(rep.omega_re - golden).max())
            if golden is not None else float("nan"))
    print(f"  {tag}: status {Status(res.status).name} iters "
          f"{res.iterations} wall {res.wall_time:.3f} s "
          f"max|omega-omega_re| {dev:.3e} max|omega_re-golden| {gold:.3e}",
          flush=True)
    if rep.spurious or not dev <= SPURIOUS_TOL:
        return f"spurious (max|omega-omega_re| {dev:.3e})"
    if golden is not None and not gold <= GOLDEN_TOL:
        return f"omega_re {gold:.3e} from the golden row"
    return ""


def _reserved_gib() -> float:
    """Device memory this process's allocator holds, free or not."""
    return (torch.cuda.memory_reserved() / 2**30
            if torch.cuda.is_available() else float("nan"))


def _peak_gib(dev) -> float:
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))


def _parallel_batch(dev, dtype, mesh, n, golden, say) -> list:
    """(a): solve_batch(mesh=) of fcc BATCH_INDICES, each member gated and
    held against rank 0's serial solve from the same start."""
    import torch.distributed as dist
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.lattices import k_path
    alphas = [k_path("fcc")[i] for i in BATCH_INDICES]
    kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=NEV),
                       device=dev, dtype=dtype)
    t0 = time.time()
    res = kps.solve_batch(alphas, seed=BATCH_INDICES[0], mesh=mesh)
    wall = time.time() - t0
    problems = []
    say(f"  (a) solve_batch(mesh=) fcc N={n} k_path {BATCH_INDICES}: "
        f"{wall:.3f} s for the group")
    if dist.get_rank() != 0:
        return problems
    for j, (i, r) in enumerate(zip(BATCH_INDICES, res)):
        why = gate_record(r, golden_row("fcc", n, i) if golden else None,
                          f"k={i} member {j}")
        if why:
            problems.append(f"(a) k={i}: {why}")
        serial = kps.solve(alphas[j], seed=BATCH_INDICES[0] + j)
        diff = float(np.abs(serial.omega_re - r.omega_re).max())
        print(f"    k={i}: max|omega_re - serial solve| {diff:.3e} (serial "
              f"{serial.iterations} iters, {serial.wall_time:.3f} s)",
              flush=True)
        if not diff <= 1e-6:
            problems.append(f"(a) k={i}: {diff:.3e} from the serial solve")
    return problems


def _parallel_sweep(dev, dtype, mesh, n, golden, out_dir, say) -> tuple:
    """(b): bandgap(mesh=) resuming MESH_ROWS of the fcc library copy in
    rank 0's directory; returns (problems, rank 0's launch counts)."""
    import torch.distributed as dist
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import bandgap
    rank = dist.get_rank()
    mine = os.path.join(out_dir, f"sweep{rank}")
    kmod.reset_launches()
    log = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(log):
        err = bandgap(n=n, lattice="fcc", nev=NEV, dtype=dtype, device=dev,
                      output_dir=mine, metrics_path=mine + ".jsonl",
                      indices=None, verbose=True, mesh=mesh,
                      solver_opts={"rr_gram": "pallas"},
                      solver_kw={"refine": "light"})
    wall = time.time() - t0
    counts = kmod.launches()
    problems = [f"(b) rank {rank}: failed indices {err}"] if err else []
    if rank != 0:
        if os.path.exists(mine) or os.path.exists(mine + ".jsonl"):
            problems.append(f"(b) rank {rank} wrote a library or metrics")
        return problems, counts
    for line in log.getvalue().splitlines():
        print(f"    {line}", flush=True)
    key = f"fcc_{n}"
    with open(os.path.join(out_dir, "reference.json")) as f:
        ref = json.load(f)
    with open(os.path.join(mine, "chiral", "bandgap_fcc.json")) as f:
        lib = json.load(f)
    print(f"  (b) bandgap(mesh=) fcc N={n} rows {MESH_ROWS} resumed, "
          f"rr_gram='pallas' refine='light': {wall:.3f} s, "
          f"{wall / len(MESH_ROWS):.3f} s/k-point; rank 0 launches "
          f"{counts}", flush=True)
    for i, (it, row) in enumerate(zip(lib[f"{key}_iterations"],
                                      lib[f"{key}_frequencies"])):
        if i not in MESH_ROWS:
            if (it != ref[f"{key}_iterations"][i]
                    or row != ref[f"{key}_frequencies"][i]):
                problems.append(f"(b) row {i} changed")
            continue
        gold = (float(np.abs(np.array(row)
                             - np.array(ref[f"{key}_frequencies"][i])).max())
                if golden else float("nan"))
        print(f"    k={i}: iters {it[0]:.0f} wall {it[1]:.3f} s "
              f"max|omega - committed| {gold:.3e}", flush=True)
        if it[0] <= 0 or (golden and not gold <= GOLDEN_TOL):
            problems.append(f"(b) row {i}: {it}, {gold:.3e} from the "
                            f"committed row")
    if dev.type == "cuda" and not all(counts[k] for k in SERIAL_KERNELS):
        problems.append(f"(b) a kernel never launched on rank 0: {counts}")
    return problems, counts


def _parallel_sharded(dev, dtype, n, golden, say) -> list:
    """(c): solve_kpoint_sharded over the whole world as the grid axis, at
    sc_curv alpha=(pi,0,0), each dielectric of SHARDED_DIELS, against its
    committed row and a single-card solve from the same start block."""
    import torch.distributed as dist
    from pcx_torch import geometry, stencils, validate
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import CHIRAL_EPS_EG, ProblemConfig
    from pcx_torch.lattices import k_path
    from pcx_torch.operators import dielectric as diel_mod
    from pcx_torch.operators import maxwell
    from pcx_torch.operators.blocks import h_block
    from pcx_torch.parallel.mesh import GRID_AXIS, gather_shards, make_mesh
    from pcx_torch.parallel.solve import solve_kpoint_sharded
    from pcx_torch.solvers.lobpcg import Status, lobpcg_sep
    rank = dist.get_rank()
    mesh = make_mesh(n_grid=dist.get_world_size(), device_type=dev.type)
    group = mesh.get_group(GRID_AXIS)
    alpha = k_path("sc_curv")[SHARDED_INDEX]
    em = geometry.edge_mask(n, "sc_curv")
    problems = []
    for diel_type in SHARDED_DIELS:
        cfg = ProblemConfig(n=n, lattice="sc_curv", diel_type=diel_type,
                            nev=NEV)
        kps = KPointSolver(cfg, device=dev, dtype=dtype,
                           solver_impl="complex", fft_mode="fft")
        sy = kps.symbols_for(alpha)
        if diel_type == "chiral":
            scale = np.where(em, 1.0 / CHIRAL_EPS_EG["sc_curv"], 1.0)
        else:
            eps_loc = diel_mod._eps_components("sc_curv", 0, None)
            scale = {"crossdof": (
                diel_mod._masked_diag(em, eps_loc), em.astype(np.float64),
                tuple(float(w) for w in stencils.mfd_stencil(cfg.k, 0)),
                *(complex(e) for e in eps_loc[3:6]))}
        x0 = kps._x0_cold(alpha, kps.block_width(alpha), SHARDED_INDEX)
        opts = dict(kps.solver_opts, tol=kps.tol, maxiter=kps.maxiter)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize(dev)
        t0 = time.time()
        res = solve_kpoint_sharded(mesh, sy.d_a, tuple(sy.b), tuple(sy.inv),
                                   scale, sy.shift, x0, NEV, **opts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall = time.time() - t0
        peaks = [None] * dist.get_world_size()
        dist.all_gather_object(peaks, _peak_gib(dev))
        x = gather_shards(res.x, -1, group)
        tag = f"(c) {diel_type}"
        if rank != 0:
            del x, res
            continue

        def a_apply(v):
            return maxwell.ama(v, sy.d_a, kps.diel)

        rep = validate.recompute(res.lambdas[:NEV].cpu().numpy(), x[:NEV],
                                 a_apply, shift=sy.shift, scal=cfg.scal,
                                 raise_on_spurious=False)
        spur = float(np.abs(rep.omega_pnt - rep.omega_re).max())
        gold = (float(np.abs(rep.omega_re - golden_row(
            "sc_curv", n, SHARDED_INDEX, diel_type)).max())
            if golden else float("nan"))
        del x
        t1 = time.time()
        one = lobpcg_sep(
            lambda v: maxwell.ama_bb(v, sy.d_a, sy.b, kps.diel, sy.shift),
            lambda v: h_block(v, sy.inv), x0, NEV, rr_mode="f64", **opts)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_one = time.time() - t1
        rep1 = validate.recompute(one.lambdas[:NEV].cpu().numpy(),
                                  one.x[:NEV], a_apply, shift=sy.shift,
                                  scal=cfg.scal, raise_on_spurious=False)
        diff = float(np.abs(rep.omega_re - rep1.omega_re).max())
        print(f"  {tag} solve_kpoint_sharded sc_curv N={n} alpha=(pi,0,0) "
              f"n_grid={dist.get_world_size()}: status "
              f"{Status(res.status).name} iters {res.iterations} "
              f"{wall:.3f} s ({1e3 * wall / max(res.iterations, 1):.1f} "
              f"ms/iter); peak memory per rank {peaks} GiB; "
              f"max|omega-omega_re| {spur:.3e} max|omega_re - committed| "
              f"{gold:.3e}; single card {Status(one.status).name} "
              f"{one.iterations} iters {wall_one:.3f} s, max|omega_re - "
              f"single card| {diff:.3e}", flush=True)
        print(f"    omega_re {np.array2string(rep.omega_re, precision=6)}",
              flush=True)
        if res.status not in (Status.CONVERGED, Status.FLOOR):
            problems.append(f"{tag}: status {Status(res.status).name}")
        if rep.spurious or not spur <= SPURIOUS_TOL:
            problems.append(f"{tag}: spurious ({spur:.3e})")
        if golden and not gold <= GOLDEN_TOL:
            problems.append(f"{tag}: {gold:.3e} from the committed row")
        if not diff <= 1e-4:
            problems.append(f"{tag}: {diff:.3e} from the single-card solve")
        del one, res
    return problems


def _parallel_rank(rank: int, world: int, store: str, out_dir: str,
                   device_type: str, n: int, golden: bool) -> None:
    """One rank of phase 18: (a), (b) and (c) over the world, then its
    problems and launch counts pickled into ``out_dir``."""
    import pickle
    import torch.distributed as dist
    from pcx_torch.parallel.mesh import init_distributed, make_mesh
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    init_distributed(f"file://{store}", world, rank, device_type=device_type,
                     timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT))
    try:
        dev = (torch.device("cuda", rank) if device_type == "cuda"
               else torch.device("cpu"))
        dtype = torch.complex64 if dev.type == "cuda" else torch.complex128

        def say(msg):
            if rank == 0:
                print(msg, flush=True)

        mesh = make_mesh(device_type=device_type)
        say(f"  rank 0: world size {world}, backend "
            f"{dist.get_backend()}, mesh {tuple(mesh.shape)} "
            f"{mesh.mesh_dim_names}")
        problems = _parallel_batch(dev, dtype, mesh, n, golden, say)
        more, counts = _parallel_sweep(dev, dtype, mesh, n, golden, out_dir,
                                       say)
        problems += more
        problems += _parallel_sharded(dev, dtype, n, golden, say)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump((problems, counts), f)
    finally:
        dist.destroy_process_group()


def phase_mask_engine(n: int = N) -> None:
    """(d): the native mask engine against numpy at N, with both times."""
    from pcx_torch import geometry, native
    print(f"  (d) mask engine {os.path.basename(native.build())}",
          flush=True)
    for lattice in MASK_LATTICES:
        times, masks = {}, {}
        for native in (True, False):
            t0 = time.time()
            masks[native] = (
                geometry.edge_mask(n, lattice, cache=False,
                                   use_native=native),
                geometry.volume_mask(n, lattice, cache=False,
                                     use_native=native))
            times[native] = time.time() - t0
        same = all(np.array_equal(a, b)
                   for a, b in zip(masks[True], masks[False]))
        print(f"  (d) masks {lattice} N={n} (edge and volume): native "
              f"{times[True]:.3f} s, numpy {times[False]:.3f} s, "
              f"bit-identical {same}", flush=True)
        if not same:
            fail(f"mask engine {lattice} N={n}: native != numpy")


def phase_parallel(dev, n: int = N, golden: bool = True) -> dict:
    """Phase 18: solve_batch(mesh=), bandgap(mesh=) and the grid-sharded
    solve on W = min(cards, 2) spawned ranks, one card each over NCCL (on
    the CPU: two ranks over gloo), then the mask engine.  Returns rank 0's
    kernel launches in bandgap(mesh=)."""
    import multiprocessing as mp
    import pickle
    world = (min(torch.cuda.device_count(), 2) if dev.type == "cuda"
             else 2)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    note = ("" if world > 1 else "; one card: the collectives carry "
            "nothing, the two-rank runs wait for a machine with two cards "
            "(the CPU tests over gloo hold the multi-rank logic)")
    print(f"phase parallel: {world} rank(s) over {backend}, one card each"
          f"{note}", flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="pcx_parallel_") as out:
        src = os.path.join(out, "reference.json")
        if golden:
            shutil.copy(os.path.join(HERE, "output_c64", "chiral",
                                     "bandgap_fcc.json"), src)
        else:   # a rehearsal at a grid with no committed library
            from pcx_torch.io import BandLibrary
            from pcx_torch.lattices import k_path
            lib = BandLibrary(src, "fcc", n, len(k_path("fcc")), NEV)
            for i in range(lib.n_k):
                lib.record(i, 1, 0.5, np.zeros(NEV))
        reset_rows(src, os.path.join(out, "sweep0", "chiral",
                                     "bandgap_fcc.json"), f"fcc_{n}",
                   MESH_ROWS)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_parallel_rank,
                             args=(r, world, os.path.join(out, "store"), out,
                                   dev.type, n, golden))
                 for r in range(world)]
        t0 = time.time()
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, PARALLEL_TIMEOUT - (time.time() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
        if hung:
            fail(f"parallel: ranks {hung} did not end within "
                 f"{PARALLEL_TIMEOUT} s")
        codes = [p.exitcode for p in procs]
        if any(codes):
            fail(f"parallel: rank exit codes {codes}")
        results = []
        for r in range(world):
            with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    print(f"  ranks done in {time.time() - t0:.3f} s", flush=True)
    problems = [p for probs, _ in results for p in probs]
    if problems:
        fail(f"parallel: {'; '.join(problems)}")
    phase_mask_engine(n)
    return results[0][1]


# Phase 19: the library-recovery tools at full width on the gyroids.  (a)-(c)
# take bcc_sg row LIB_K, failed in the committed library, which has an f64
# pin; (d) resumes chiral rows with the runner's settings, two of them
# pinned; (e) solves pseudochiral gyroid rows, which have no library yet;
# (f) and (g) run the pre-flight and the lever matrix at their defaults.
LIB_K = 100
LIB_PIN = "bcc_sg_n120_k100_f64.json"
PIN_TOL = 1e-6           # (a): the complex128 solve against the pin
RECORD_GATE = 1e-3       # (b), (c): record_vs_truth's gate
GYROID_ROWS = (("bcc_sg", [36, 37]), ("bcc_dg", [18, 19, 20]))
GYROID_PINS = {("bcc_sg", 37): "bcc_sg_k37_f64.json",
               ("bcc_dg", 19): "bcc_dg_n120_k19_f64.json"}
GYROID_PIN_TOL = 1e-5    # tests/test_bandstructure.py:597-628
PSEUDO_GYROIDS = (("bcc_sg", 37), ("bcc_dg", 40))
PREFLIGHT_N, PREFLIGHT_POINTS = 16, 2
ITER_TAIL_N = 48
RUNNER_SETTINGS = {"solver_opts": {"rr_gram": "pallas"},
                   "solver_kw": {"refine": "light"}}


@contextlib.contextmanager
def geometry_cache(path: str):
    """Point $PCX_GEOMETRY_CACHE, and the module's cache directory read
    from it at import, at ``path`` for the block."""
    from pcx_torch import geometry
    env, cache = os.environ.get("PCX_GEOMETRY_CACHE"), geometry.CACHE_DIR
    os.environ["PCX_GEOMETRY_CACHE"] = geometry.CACHE_DIR = path
    try:
        yield
    finally:
        geometry.CACHE_DIR = cache
        if env is None:
            del os.environ["PCX_GEOMETRY_CACHE"]
        else:
            os.environ["PCX_GEOMETRY_CACHE"] = env


def captured(fn, *args, **kw):
    """(fn(...), its standard output), the output echoed indented."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = fn(*args, **kw)
    for line in log.getvalue().splitlines():
        print(f"    {line}", flush=True)
    return out, log.getvalue()


def library_copy(lattice: str, n: int, dst_dir: str, rows=()) -> tuple:
    """(path, committed library) of a copy of
    output_c64/chiral/bandgap_<lattice>.json under ``dst_dir`` with
    ``rows`` reset to pending (the N=120 record renamed to N=n below
    N)."""
    path = os.path.join(dst_dir, "chiral", f"bandgap_{lattice}.json")
    ref = reset_rows(os.path.join(HERE, "output_c64", "chiral",
                                  f"bandgap_{lattice}.json"), path,
                     f"{lattice}_{n}", rows, src_key=f"{lattice}_{N}")
    return path, ref


def pin(name: str, lattice: str, n: int) -> np.ndarray:
    from pcx_torch.record_vs_truth import load_truth
    return np.asarray(load_truth(os.path.join(HERE, "data", name), lattice,
                                 n)["omega_f64"], float)


def _lib_truth(dev, n: int, golden: bool, out: str) -> tuple:
    """(a): f64_truth at bcc_sg row LIB_K; returns (its pin's path, the
    frequencies (b) and (c) are held to)."""
    from pcx_torch import f64_truth as ft
    from pcx_torch.solvers.lobpcg import Status
    truth = ft.f64_truth("bcc_sg", n, LIB_K, device=dev)
    rec, res = truth.record, truth.result
    path = os.path.join(out, f"bcc_sg_n{n}_k{LIB_K}_f64.json")
    ft.write_pin(rec, path)
    omega = np.asarray(res.omega_re, float)
    want = pin(LIB_PIN, "bcc_sg", n) if golden else omega
    dev_pin = float(np.abs(omega - want).max())
    with open(os.path.join(HERE, "data", LIB_PIN)) as f:
        keys = list(json.load(f))
    print(f"  (a) f64_truth bcc_sg N={n} k={LIB_K} complex128: status "
          f"{Status(res.status).name} iters {res.iterations} (JAX on the "
          f"CPU: 198) wall {res.wall_time:.3f} s "
          f"({1e3 * res.wall_time / max(res.iterations, 1):.1f} ms/iter), "
          f"peak device memory {truth.peak_gib:.2f} GiB; max|omega - pin| "
          f"{dev_pin:.3e}; keys as the committed pin's "
          f"{list(rec) == keys}", flush=True)
    print(f"    omega {np.array2string(omega, precision=8)}", flush=True)
    if res.status not in (Status.CONVERGED, Status.FLOOR):
        fail(f"library (a): status {Status(res.status).name}")
    if not dev_pin <= PIN_TOL:
        fail(f"library (a): {dev_pin:.3e} from {LIB_PIN}")
    if list(rec) != keys:
        fail(f"library (a): record keys {list(rec)} != {keys}")
    return (os.path.join(HERE, "data", LIB_PIN) if golden else path), want


def _lib_record(dev, n: int, out: str, pin_path: str, want) -> None:
    """(b): record_vs_truth at bcc_sg row LIB_K into a copy of the library;
    the other rows stay exactly as committed."""
    from pcx_torch.record_vs_truth import record_vs_truth
    key = f"bcc_sg_{n}"
    lib_dir = os.path.join(out, "record")
    path, ref = library_copy("bcc_sg", n, lib_dir)
    t0 = time.time()
    r, _ = captured(record_vs_truth, "bcc_sg", LIB_K, n=n, truth=pin_path,
                    output=lib_dir, device=dev)
    with open(path) as f:
        lib = json.load(f)
    row = np.array(lib[f"{key}_frequencies"][LIB_K])
    print(f"  (b) record_vs_truth bcc_sg N={n} k={LIB_K}: recorded "
          f"{r.recorded}, deviation from the pin {r.deviation:.3e} (gate "
          f"{RECORD_GATE}), tries {r.tries}, {time.time() - t0:.3f} s",
          flush=True)
    if not (r.recorded and r.deviation <= RECORD_GATE):
        fail(f"library (b): not recorded, deviation {r.deviation:.3e}")
    if lib[f"{key}_iterations"][LIB_K][0] <= 0 or \
            float(np.abs(row - want).max()) > RECORD_GATE:
        fail(f"library (b): row {LIB_K} reads {row}")
    failed = [i for i, it in enumerate(lib[f"{key}_iterations"])
              if it[0] == -1]
    changed = [i for i in range(len(lib[f"{key}_iterations"]))
               if i != LIB_K and any(lib[f"{key}_{p}"][i] != ref[f"{key}_{p}"][i]
                                     for p in ("iterations", "frequencies"))]
    print(f"  (b) failed rows after {failed}; other rows changed {changed}",
          flush=True)
    if failed or changed:
        fail(f"library (b): failed rows {failed}, changed rows {changed}")


def _lib_rescue(dev, n: int, out: str, want) -> None:
    """(c): rescue_point on a copy for row LIB_K, with the whole ladder and
    then with its top rung alone (complex128 at full width: the ladder
    stops at the first rung that recovers the row)."""
    from pcx_torch.rescue_point import STEPS, rescue
    for steps in (STEPS, ("f64",)):
        lib_dir = os.path.join(out, "rescue_" + "_".join(steps))
        path, _ = library_copy("bcc_sg", n, lib_dir)
        r, _ = captured(rescue, n=n, lattice="bcc_sg", output=lib_dir,
                        steps=steps, device=dev)
        for rung in r.rungs:
            print(f"  (c) rung {rung.step}: rows {rung.todo}, left failed "
                  f"{rung.failed}, {rung.seconds:.3f} s, peak device memory "
                  f"{rung.peak_gib:.2f} GiB", flush=True)
        with open(path) as f:
            lib = json.load(f)
        it, sec = lib[f"bcc_sg_{n}_iterations"][LIB_K]
        row = np.array(lib[f"bcc_sg_{n}_frequencies"][LIB_K])
        dev_pin = float(np.abs(row - want).max()) if it > 0 else float("nan")
        by = r.rungs[-1].step if r.ok and r.rungs else None
        print(f"  (c) rescue_point --steps {' '.join(steps)} bcc_sg N={n} "
              f"k={LIB_K}: recovered by {by}, iters {it:.0f} wall "
              f"{sec:.3f} s, max|omega - pin| {dev_pin:.3e}", flush=True)
        if not r.ok or not dev_pin <= RECORD_GATE:
            fail(f"library (c) {steps}: row {LIB_K} not recovered within "
                 f"{RECORD_GATE} of the pin ({dev_pin:.3e}; left {r.left})")


def _lib_gyroids(dev, n: int, golden: bool, out: str) -> dict:
    """(d): the chiral gyroid rows GYROID_ROWS resumed with the runner's
    settings, each gated against its committed row and, where pinned,
    against the pin; returns the kernel launches."""
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.lattices import k_path
    before = kmod.launches()
    problems = []
    for lattice, rows in GYROID_ROWS:
        key = f"{lattice}_{n}"
        path, ref = library_copy(lattice, n, os.path.join(out, "gyroid"),
                                 rows)
        metrics = os.path.join(out, f"gyroid_{lattice}.jsonl")
        print(f"  (d) bandgap {lattice} chiral N={n} complex64 "
              f"rr_gram='pallas' refine='light', resuming rows {rows} "
              f"(committed iterations "
              f"{[ref[f'{key}_iterations'][i][0] for i in rows]})",
              flush=True)
        t0 = time.time()
        # the rows by name: a resume would also retry the failed row LIB_K
        err, text = captured(bandgap, n=n, lattice=lattice, nev=NEV,
                             dtype=torch.complex64, device=dev,
                             output_dir=os.path.join(out, "gyroid"),
                             metrics_path=metrics, indices=rows,
                             verbose=True, **RUNNER_SETTINGS)
        print(f"  (d) {lattice}: {len(rows)} rows in {time.time() - t0:.3f}"
              f" s", flush=True)
        if err:
            problems.append(f"{lattice}: failed indices {err}")
        problems += gate_resumed_rows(path, metrics, text, key, ref,
                                      k_path(lattice), rows, lattice, golden)
        with open(path) as f:
            lib = json.load(f)
        for i in rows:
            name = GYROID_PINS.get((lattice, i))
            if name and golden:
                d = float(np.abs(np.array(lib[f"{key}_frequencies"][i])
                                 - pin(name, lattice, n)).max())
                print(f"  (d) {lattice} k={i}: max|omega - f64 pin| "
                      f"{d:.3e} ({name})", flush=True)
                if not d <= GYROID_PIN_TOL:
                    problems.append(f"{lattice} k={i}: {d:.3e} from {name}")
    after = kmod.launches()
    counts = {k: after[k] - before[k] for k in after}
    print(f"  (d) launches {counts}", flush=True)
    if dev.type == "cuda" and not all(counts[k] for k in SERIAL_KERNELS):
        problems.append(f"a kernel never launched: {counts}")
    if problems:
        fail(f"library (d): {'; '.join(problems)}")
    return counts


def _lib_pseudo(dev, n: int, out: str) -> None:
    """(e): the pseudochiral gyroid rows through bandgap with the runner's
    settings, each accepted by the sweep's gate; a twin solve of the row
    (the sweep's seed, the same settings) gives the light refine's
    frequencies against the complex128 refine's."""
    from pcx_torch.bandstructure import KPointSolver, bandgap
    from pcx_torch.config import ProblemConfig
    from pcx_torch.lattices import k_path
    problems = []
    for lattice, i in PSEUDO_GYROIDS:
        alpha = k_path(lattice)[i]
        for diel_type in (TRIVIAL, CROSSDOF):
            tag = f"{lattice} {diel_type} k={i}"
            path = os.path.join(out, "pseudo", diel_type,
                                f"bandgap_{lattice}.json")
            t0 = time.time()
            err, _ = captured(bandgap, n=n, lattice=lattice,
                              diel_type=diel_type, nev=NEV,
                              dtype=torch.complex64, device=dev,
                              output_dir=os.path.join(out, "pseudo"),
                              indices=[i], verbose=True, **RUNNER_SETTINGS)
            wall = time.time() - t0
            with open(path) as f:
                lib = json.load(f)
            it, sec = lib[f"{lattice}_{n}_iterations"][i]
            row = np.array(lib[f"{lattice}_{n}_frequencies"][i])
            kps = KPointSolver(ProblemConfig(n=n, lattice=lattice,
                                             diel_type=diel_type, nev=NEV),
                               device=dev, dtype=torch.complex64,
                               refine="light",
                               solver_opts=RUNNER_SETTINGS["solver_opts"])
            res = kps.solve(alpha, seed=i, raise_on_spurious=False)
            rep_f64 = kps._refine_report(alpha, res.x, mode="f64",
                                         raise_on_spurious=False)[0]
            d_ref = float(np.abs(res.report.omega_re
                                 - rep_f64.omega_re).max())
            d_twin = float(np.abs(res.report.omega_re - row).max())
            print(f"  (e) {tag}: iters {it:.0f} wall {sec:.3f} s (bandgap "
                  f"{wall:.3f} s); light against complex128 refine "
                  f"{d_ref:.3e}; twin solve iters {res.iterations}, "
                  f"{d_twin:.3e} from the row", flush=True)
            print(f"    omega {np.array2string(row, precision=6)}",
                  flush=True)
            if err or it <= 0:
                problems.append(f"{tag}: not accepted ({err})")
            del kps, res
    if problems:
        fail(f"library (e): {'; '.join(problems)}")


def _lib_preflight(dev, n: int, configs) -> None:
    """(f): preflight_queue's configurations at N=n, 2 points each."""
    from pcx_torch.preflight_queue import preflight
    t0 = time.time()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        results = preflight(configs, n=n, points=PREFLIGHT_POINTS,
                            device=dev)
    for line in log.getvalue().splitlines():
        if line.startswith(("OK", "FAIL")):
            print(f"    {line}", flush=True)
    bad = [f"{r.lattice} {r.diel} eps{r.eps_opt}: {r.bad}"
           for r in results if not r.ok]
    print(f"  (f) preflight_queue N={n} {PREFLIGHT_POINTS} points, "
          f"{len(results)} configurations, complex128: "
          f"{len(results) - len(bad)} OK in {time.time() - t0:.3f} s "
          f"(golden column printed, not gated)", flush=True)
    if bad:
        fail(f"library (f): {'; '.join(bad)}")


def _lib_iter_tail(dev, n: int) -> None:
    """(g): iter_tail's lever matrix at sc_curv chiral N=n."""
    from pcx_torch.iter_tail import iter_tail
    from pcx_torch.solvers.lobpcg import Status
    t0 = time.time()
    recs, _ = captured(iter_tail, n=n, device=dev)
    print(f"  (g) iter_tail sc_curv chiral N={n}: {len(recs)} variants in "
          f"{time.time() - t0:.3f} s", flush=True)
    bad = [r["variant"] for r in recs
           if any(s not in (Status.CONVERGED, Status.FLOOR)
                  for s in r["status"])
           or any(v is None or v > SPURIOUS_TOL for v in r["val"])]
    if bad:
        fail(f"library (g): variants {bad} not CONVERGED/FLOOR within "
             f"{SPURIOUS_TOL}")


def phase_library(dev, n: int = N, golden: bool = True,
                  preflight_n: int = PREFLIGHT_N, preflight_configs=None,
                  iter_tail_n: int = ITER_TAIL_N) -> dict:
    """Phase 19: the library-recovery tools and the gyroid lattices, (a) to
    (g), everything written under a temporary directory, the geometry cache
    too.  ``golden`` holds (a)-(d) to the committed pins and rows (False: a
    CPU rehearsal at a small N, against (a)'s own pin).  Returns the kernel
    launches of (d)."""
    from pcx_torch.preflight_queue import CONFIGS
    print(f"phase library: N={n}, bcc_sg row {LIB_K} and the gyroid sweeps",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="pcx_library_") as out:
        with geometry_cache(os.path.join(out, "geometry_cache")):
            t0 = time.time()
            pin_path, want = _lib_truth(dev, n, golden, out)
            _lib_record(dev, n, out, pin_path, want)
            _lib_rescue(dev, n, out, want)
            counts = _lib_gyroids(dev, n, golden, out)
            _lib_pseudo(dev, n, out)
            _lib_preflight(dev, preflight_n, preflight_configs or CONFIGS)
            _lib_iter_tail(dev, iter_tail_n)
            print(f"  phase library: {time.time() - t0:.3f} s", flush=True)
    return counts


# Phase 20: the benchmarks' arguments: the default protocol (fcc, 20 warm
# points), the single point, the matrix's north-star rows and the command.
BENCH_DEFAULT = []
BENCH_SINGLE = ["--sweep", "0", "--repeats", "1"]
BENCH_MATRIX = ["--rows", "north_star", "--reps", "1"]
BENCH_CLI = ["-m", "pcx_torch.bench", "--sweep", "0", "--repeats", "1"]


def _bench_launched(dev, counts: dict, tag: str) -> None:
    print(f"  {tag}: launches {counts}", flush=True)
    if dev.type == "cuda" and not (counts["resid_precond"]
                                   and counts["axis_dft"]):
        fail(f"bench {tag}: K1 or K2 never launched: {counts}")


def phase_bench(dev, n: int = N, golden: bool = True,
                points: int = 20, default=BENCH_DEFAULT,
                single=BENCH_SINGLE, matrix=BENCH_MATRIX,
                cli=BENCH_CLI) -> dict:
    """Phase 20: ``python -m pcx_torch.bench`` and ``bench_matrix`` through
    their entry points, in this process but (d): (a) the default protocol,
    (b) ``--sweep 0``, (c) the matrix's north-star rows into a temporary
    ``--out``, (d) the command in a subprocess.  ``golden`` holds (a) and
    (b) to the committed rows.  Returns the kernel launches of (a)."""
    from pcx_torch import bench, bench_matrix
    from pcx_torch import kernels as kmod
    print(f"phase bench: python -m pcx_torch.bench {' '.join(default)} "
          f"(the default protocol), {' '.join(single)}; bench_matrix "
          f"{' '.join(matrix)}; the command", flush=True)
    t_phase = time.time()

    def entry(fn, argv):
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        t0 = time.time()
        out, _ = captured(fn, argv)
        return out, time.time() - t0, kmod.launches(), _peak_gib(dev)

    (code, rec, pts), wall, counts_a, peak = entry(bench.run, default)
    if code or rec is None:
        fail(f"bench (a): exit {code}")
    want = f"fcc_n{n}_sweep_mean_seconds"
    print(f"  (a) {rec['metric']}: {rec['value']} s/k-point over "
          f"{rec['points']} points ({wall:.3f} s with the warm-up), "
          f"vs_baseline {rec['vs_baseline']}; iterations "
          f"{[p['iters'] for p in pts]}; {sum(p['cold_retry'] for p in pts)}"
          f" cold retries; peak device memory {peak:.2f} GiB", flush=True)
    if rec["metric"] != want or rec["points"] != points:
        fail(f"bench (a): {rec['metric']} over {rec['points']} points, "
             f"not {want} over {points}")
    for p in pts:
        gold = golden_row("fcc", n, p["index"]) if golden else None
        d = (float(np.abs(np.asarray(p["omega"]) - gold).max())
             if golden else float("nan"))
        print(f"    k={p['index']}: {p['status']} iters {p['iters']} wall "
              f"{p['wall']:.3f} s{' (cold retry)' if p['cold_retry'] else ''}"
              f" max|omega - committed| {d:.3e}", flush=True)
        if golden and not d <= GOLDEN_TOL:
            fail(f"bench (a) k={p['index']}: {d:.3e} from the committed row")
    _bench_launched(dev, counts_a, "(a)")

    (code, rec, pts), wall, counts, peak = entry(bench.run, single)
    if code or rec is None:
        fail(f"bench (b): exit {code}")
    gold = golden_row("sc_curv", n, 19) if golden else None
    devs = [float(np.abs(np.asarray(p["omega"]) - gold).max())
            if golden else float("nan") for p in pts]
    print(f"  (b) {rec['metric']}: {rec['value']} s, vs_baseline "
          f"{rec['vs_baseline']}; iterations {[p['iters'] for p in pts]}; "
          f"max|omega - committed| {max(devs):.3e}; peak device memory "
          f"{peak:.2f} GiB", flush=True)
    if rec["metric"] != f"sc_curv_n{n}_kpoint_solve_seconds":
        fail(f"bench (b): metric {rec['metric']}")
    if golden and not max(devs) <= GOLDEN_TOL:
        fail(f"bench (b): {max(devs):.3e} from the committed row")
    _bench_launched(dev, counts, "(b)")

    with tempfile.TemporaryDirectory(prefix="pcx_bench_") as tmp:
        out = os.path.join(tmp, "matrix.jsonl")
        code, wall, counts, peak = entry(bench_matrix.main,
                                         matrix + ["--out", out])
        rows = {}
        if os.path.exists(out):
            with open(out) as f:
                rows = {r["row"]: r for r in map(json.loads, f)}
    for r in rows.values():
        print(f"  (c) {r['row']}: {r['seconds']} s, {r['iters']} iters, "
              f"validation {r['validation']:.3e}, vs_baseline "
              f"{r['vs_baseline']} ({r['device']})", flush=True)
    print(f"  (c) {wall:.3f} s; peak device memory {peak:.2f} GiB",
          flush=True)
    want = {r[0] for r in bench_matrix.ROWS[:2]}
    if code or set(rows) != want:
        fail(f"bench_matrix (c): exit {code}, rows {sorted(rows)}")
    if not all(r["validation"] <= SPURIOUS_TOL for r in rows.values()):
        fail("bench_matrix (c): a row above the spurious gate")
    _bench_launched(dev, counts, "(c)")

    t0 = time.time()
    r = run_cmd([sys.executable] + cli, timeout=600)
    lines = r.stdout.strip().splitlines()
    print(f"  (d) python {' '.join(cli)}: exit {r.returncode} in "
          f"{time.time() - t0:.3f} s: {lines[-1] if lines else ''}",
          flush=True)
    if r.returncode != 0 or not lines or '"metric"' not in lines[-1]:
        fail(f"bench (d): exit {r.returncode}, {r.stderr[-2000:]}")
    print(f"  phase bench: {time.time() - t_phase:.3f} s", flush=True)
    return counts_a


# Phase 21: the W/P width cap.  (b) phase 7's point cold under an int cap
# and under "auto"; (c) the default protocol of python -m pcx_torch.bench
# with LIBRARIES.md's lever stack, beside its mean without w_cap (PR 11's
# measurement, PERF.md section 6: NVIDIA H100 80GB HBM3, 700.00 W).
WCAP_SOLVES = (("w_cap=8", {"col_patience": 3, "w_cap": 8}),
               ("w_cap='auto'", {"col_patience": 3, "w_cap": "auto"}))
# (b') the width-4 iteration, which (b) and (c) may never reach, timed over
# a solve cut at this many iterations (not gated: it ends MAXITER)
WCAP_TIMED = ("w_cap=4", {"col_patience": 3, "w_cap": 4}, 24)
PROTOCOL = ["lam_tol=2e-6", "floor_patience=3", "col_patience=3",
            "w_cap=auto"]
PROTOCOL_ARGS = [a for kv in PROTOCOL for a in ("--solver-opt", kv)]
PROTOCOL_NO_WCAP_S = 0.906


@contextlib.contextmanager
def iteration_clock():
    """Wall time of each iteration of the production LOBPCG, with its W/P
    width.  ``lobpcg_sep_rs`` builds its width rule once a solve
    (``lobpcg_rs.width_rule``) and calls it once an iteration, right after
    the iteration's one host synchronization; this wraps the builder so
    that each call is stamped.  Yields a list that gets one list of
    (perf_counter, width, active count) per solve."""
    from pcx_torch.solvers import lobpcg_rs
    build = lobpcg_rs.width_rule
    solves = []

    def stamped(*args, **kw):
        rule, stamps = build(*args, **kw), []
        solves.append(stamps)

        def timed(it, n_act):
            w = rule(it, n_act)
            stamps.append((time.perf_counter(), w, n_act))
            return w
        return timed

    lobpcg_rs.width_rule = stamped
    try:
        yield solves
    finally:
        lobpcg_rs.width_rule = build


def ms_by_width(solves) -> dict:
    """{width: [iterations timed, mean ms]}: each gap between two stamps of
    a solve is one iteration at the first stamp's width (its step, then the
    next residual pass and read-back; a refresh of H X and H P falls in the
    iteration it follows)."""
    gaps = {}
    for stamps in solves:
        for (t0, w, _), (t1, _, _) in zip(stamps, stamps[1:]):
            gaps.setdefault(w, []).append(t1 - t0)
    return {w: [len(g), round(1e3 * float(np.mean(g)), 3)]
            for w, g in sorted(gaps.items())}


def active_counts(solves) -> dict:
    """{active columns: iterations} over the stamped solves."""
    acts = [a for stamps in solves for _, _, a in stamps]
    a, c = np.unique(np.asarray(acts, int), return_counts=True)
    return dict(zip(a.tolist(), c.tolist()))


def _wcap_launches(dev, tag: str, need_batch=None) -> dict:
    """The launches since the last reset, K2's split by batch; fails
    unless K1 and K2 launched (and K2 at ``need_batch``, if given)."""
    from pcx_torch import kernels as kmod
    counts, by_b = kmod.launches(), kmod.k2_launches_by_batch()
    print(f"  {tag}: launches {counts}; K2 by batch B {by_b}", flush=True)
    if dev.type == "cuda" and not (counts["resid_precond"]
                                   and counts["axis_dft"]):
        fail(f"w_cap {tag}: K1 or K2 never launched: {counts}")
    if dev.type == "cuda" and need_batch and not by_b.get(need_batch):
        fail(f"w_cap {tag}: K2 never launched at B={need_batch}: {by_b}")
    return {**counts, "axis_dft_by_batch": by_b}


def phase_wcap(dev, n: int = N, golden: bool = True,
               protocol=PROTOCOL_ARGS, points: int = 20) -> dict:
    """Phase 21: (b) the cold solves of WCAP_SOLVES at phase 7's point,
    each gated like phase 7, with iterations, ms/iteration, the iterations
    and ms/iteration at each width, the launches (K2 by batch) and the peak
    memory; (c) ``pcx_torch.bench.run(protocol)``: every point within
    3.5e-3 of its committed row, the mean s/k-point beside the mean
    without w_cap, the same numbers over the chain.  Returns the launches
    of (c), K2's by batch included."""
    from pcx_torch import bench
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    t_phase = time.time()
    alpha = np.array([np.pi, 0.0, 0.0])
    print(f"phase w_cap: sc_curv N={n} alpha=(pi,0,0) cold with "
          f"{', '.join(t for t, _ in WCAP_SOLVES)}; python -m "
          f"pcx_torch.bench {' '.join(protocol)}", flush=True)
    for tag, opts in WCAP_SOLVES:
        kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                           device=dev, dtype=torch.complex64,
                           solver_opts=dict(opts))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        with iteration_clock() as solves:
            res = kps.solve(alpha, seed=0, validate_result=False)
        m = kps.block_width(alpha)
        cap = opts["w_cap"] if isinstance(opts["w_cap"], int) else None
        _wcap_launches(dev, f"(b) {tag}",
                       need_batch=3 * min(cap, m) if cap else None)
        w, c = np.unique(res.widths, return_counts=True)
        print(f"  (b) {tag}: m={m}, iterations at each width "
              f"{dict(zip(w.tolist(), c.tolist()))}; [iterations timed, ms] "
              f"by width {ms_by_width(solves)}; iterations at each active "
              f"count {active_counts(solves)}; peak device memory "
              f"{_peak_gib(dev):.2f} GiB", flush=True)
        why = gate(kps, alpha, res, golden_row("sc_curv", n, 19) if golden
                   else None, f"(b) {tag}")
        if why:
            fail(f"w_cap (b) {tag}: {why}")
        del kps, res
    tag, opts, cut = WCAP_TIMED
    kps = KPointSolver(ProblemConfig(n=n, lattice="sc_curv", nev=NEV),
                       device=dev, dtype=torch.complex64, maxiter=cut,
                       solver_opts=dict(opts))
    kmod.reset_launches()
    with iteration_clock() as solves:
        res = kps.solve(alpha, seed=0, validate_result=False)
    _wcap_launches(dev, f"(b') {tag}", need_batch=3 * opts["w_cap"])
    print(f"  (b') {tag}, cut at {cut} iterations (timed, not gated): status "
          f"{res.status} after {res.iterations}; [iterations timed, ms] by "
          f"width {ms_by_width(solves)}", flush=True)
    del kps, res

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    t0 = time.time()
    with iteration_clock() as solves:
        (code, rec, pts), _ = captured(bench.run, protocol)
    wall = time.time() - t0
    counts = _wcap_launches(dev, "(c)")
    if code or rec is None or rec["points"] != points:
        fail(f"w_cap (c): exit {code}, record {rec}")
    widths = {}
    for p in pts:
        for w, c in p["widths"].items():
            widths[w] = widths.get(w, 0) + c
    print(f"  (c) {rec['metric']}: {rec['value']} s/k-point over "
          f"{rec['points']} points ({wall:.3f} s with the warm-up) against "
          f"{PROTOCOL_NO_WCAP_S} s without w_cap; iterations "
          f"{[p['iters'] for p in pts]} ({sum(p['iters'] for p in pts)}); "
          f"{sum(p['cold_retry'] for p in pts)} cold retries; iterations at "
          f"each width over the points {dict(sorted(widths.items()))}; "
          f"[iterations timed, ms] by width over every solve, warm-up "
          f"included, {ms_by_width(solves)}; iterations at each active "
          f"count {active_counts(solves)}; peak device memory "
          f"{_peak_gib(dev):.2f} GiB", flush=True)
    for p in pts:
        gold = golden_row("fcc", n, p["index"]) if golden else None
        d = (float(np.abs(np.asarray(p["omega"]) - gold).max())
             if golden else float("nan"))
        print(f"    k={p['index']}: {p['status']} iters {p['iters']} "
              f"widths {p['widths']} wall {p['wall']:.3f} s"
              f"{' (cold retry)' if p['cold_retry'] else ''} "
              f"max|omega - committed| {d:.3e}", flush=True)
        if golden and not d <= GOLDEN_TOL:
            fail(f"w_cap (c) k={p['index']}: {d:.3e} from the committed row")
    print(f"  phase w_cap: {time.time() - t_phase:.3f} s", flush=True)
    return counts


def _busy_share(fn) -> tuple:
    """(wall ms, device ms) of fn() under torch.profiler: the device time
    of every kernel and copy over the host wall of the call (one stream:
    the events do not overlap)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return 1e3 * wall, dev_us / 1e3


def _lane_group(dev, n: int, lanes: int, cut: int, **kw):
    """A cold group of ``lanes`` fcc points from LANE_FIRST through
    ``solve_batch`` of a ``KPointSolver`` with the keywords ``kw``, cut at
    ``cut`` iterations, not validated; returns (results, group wall s,
    lane-iterations)."""
    from pcx_torch.bandstructure import KPointSolver
    from pcx_torch.config import ProblemConfig
    from pcx_torch.lattices import k_path
    kps = KPointSolver(ProblemConfig(n=n, lattice="fcc", nev=NEV),
                       device=dev, dtype=torch.complex64, maxiter=cut, **kw)
    alphas = [k_path("fcc")[LANE_FIRST + j] for j in range(lanes)]
    res = kps.solve_batch(alphas, seed=LANE_FIRST, validate_result=False)
    its = sum(r.iterations for r in res)
    return res, res[0].wall_time * lanes, its


def phase_lanes(dev, n: int = N, golden: bool = True,
                counts=LANE_COUNTS, cut: int = LANE_CUT,
                profiled: int = LANE_PROFILED, rows=LANE_ROWS,
                k_batch: int = LANE_BATCH) -> dict:
    """Phase 22: (a) ms per lane-iteration of cold fcc groups of 1, 2 and 4
    lanes cut at ``cut`` iterations (timed only, not gated), each with its
    peak device memory, then the device's busy share over groups of 1 and
    4 lanes cut at ``profiled`` iterations; (b) ``bandgap(k_batch=4)`` over
    ``rows`` with rr_gram="pallas" (two lockstep groups, the second warm
    from the first's last block), each row CONVERGED or FLOOR, its
    max|omega - omega_re| <= 1e-3 and within 3.5e-3 of its committed row.
    K1, K3 and K2 must launch in (b) (counts reset just before it);
    returns the launches of (b)."""
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.metrics import load_jsonl
    from pcx_torch.solvers.lobpcg import Status
    t_phase = time.time()
    cuda = dev.type == "cuda"
    print(f"phase lanes: (a) cold fcc N={n} groups of {list(counts)} lanes "
          f"from k_path index {LANE_FIRST}, {cut} iterations; (b) bandgap "
          f"k_batch={k_batch} rr_gram='pallas' rows {rows[0]}-{rows[-1]}",
          flush=True)
    # the first group of each route pays the libraries' first calls
    for lanes in sorted({counts[0], counts[-1]}):
        _lane_group(dev, n, lanes, 2)
    per_lane = {}
    for lanes in counts:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        res, wall, its = _lane_group(dev, n, lanes, cut)
        got = kmod.launches()
        per_lane[lanes] = 1e3 * wall / max(its, 1)
        print(f"  (a) L={lanes}: {its} lane-iterations "
              f"({[r.iterations for r in res]}) in {wall:.3f} s = "
              f"{per_lane[lanes]:.3f} ms per lane-iteration "
              f"({per_lane[lanes] / per_lane[counts[0]]:.3f} of L="
              f"{counts[0]}); peak device memory {_peak_gib(dev):.2f} GiB; "
              f"launches {got}", flush=True)
        if cuda and not (got["resid_precond"] and got["axis_dft"]):
            fail(f"lanes (a) L={lanes}: K1 or K2 never launched: {got}")
        del res
    busy = {}
    if cuda:
        for lanes in (counts[0], counts[-1]):
            wall_ms, dev_ms = _busy_share(
                lambda: _lane_group(dev, n, lanes, profiled))
            busy[lanes] = dev_ms / wall_ms
            print(f"  (a) L={lanes} under torch.profiler, {profiled} "
                  f"iterations: wall {wall_ms:.1f} ms, device {dev_ms:.1f} "
                  f"ms, busy {100 * busy[lanes]:.1f}%, idle "
                  f"{100 * (1 - busy[lanes]):.1f}%", flush=True)

    with tempfile.TemporaryDirectory(prefix="pcx_lanes_") as out:
        metrics = os.path.join(out, "metrics.jsonl")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        t0 = time.time()
        err = bandgap(n=n, lattice="fcc", nev=NEV, dtype=torch.complex64,
                      device=dev, output_dir=out, metrics_path=metrics,
                      indices=rows, k_batch=k_batch, verbose=False,
                      solver_opts={"rr_gram": "pallas"})
        wall = time.time() - t0
        got = kmod.launches()
        recs = load_jsonl(metrics)
        print(f"  (b) bandgap k_batch={k_batch}: {wall:.3f} s for "
              f"{len(rows)} rows ({wall / len(rows):.3f} s/k-point); peak "
              f"device memory {_peak_gib(dev):.2f} GiB; launches {got}; K2 "
              f"by batch {kmod.k2_launches_by_batch()}", flush=True)
        if err or len(recs) != len(rows):
            fail(f"lanes (b): failed indices {err}, {len(recs)} records")
        for i, rec in zip(rows, recs):
            om, om_pnt = np.asarray(rec["omega"]), np.asarray(rec["omega_pnt"])
            spur = float(np.abs(om_pnt - om).max())
            gold = (float(np.abs(om - golden_row("fcc", n, i)).max())
                    if golden else float("nan"))
            print(f"    k={i}: status {Status(rec['status']).name} iters "
                  f"{rec['iterations']} wall {rec['wall_s']:.3f} s "
                  f"max|omega-omega_re| {spur:.3e} max|omega_re-golden| "
                  f"{gold:.3e}", flush=True)
            if rec["status"] not in (Status.CONVERGED, Status.FLOOR):
                fail(f"lanes (b) k={i}: status {Status(rec['status']).name}")
            if not spur <= SPURIOUS_TOL:
                fail(f"lanes (b) k={i}: spurious ({spur:.3e})")
            if golden and not gold <= GOLDEN_TOL:
                fail(f"lanes (b) k={i}: {gold:.3e} from the golden row")
    if cuda and not (got["resid_precond"] and got["gram9"]
                     and got["axis_dft"]):
        fail(f"lanes (b): a kernel of the lane path never launched: {got}")
    print(f"  phase lanes: {time.time() - t_phase:.3f} s", flush=True)
    return {**got, "ms_per_lane_iteration": per_lane, "busy_share": busy}


def phase_complex_lanes(dev, n: int = N, golden: bool = True,
                        counts=LANE_COUNTS, cut: int = LANE_CUT,
                        profiled: int = LANE_PROFILED,
                        rows=COMPLEX_LANE_ROWS,
                        k_batch: int = LANE_BATCH) -> dict:
    """Phase 23: the lockstep batch of the complex LOBPCG family
    (``solver_impl="complex"``).  (a) ms per lane-iteration of cold fcc
    groups of 1, 2 and 4 lanes cut at ``cut`` iterations (timed only, not
    gated), each with its peak device memory and launches: K2 must launch
    at B = 3 L m, K1 and K3 never; then the device's busy
    share over groups of 1 and 4 lanes cut at ``profiled`` iterations.
    (b) ``bandgap(k_batch=4)`` resuming ``rows`` of a copy of the
    committed fcc library (one lockstep group of four lanes; a group warm
    from the previous one's last block is phase 22 (b)'s): each row CONVERGED or FLOOR, its max|omega -
    omega_re| <= 1e-3 and within 3.5e-3 of its committed row, every other
    row as committed; K2 must launch, K1 and K3 never (counts reset just
    before (b)).  Returns the launches of (b)."""
    from pcx_torch import kernels as kmod
    from pcx_torch.bandstructure import bandgap
    from pcx_torch.metrics import load_jsonl
    from pcx_torch.solvers.lobpcg import Status
    t_phase = time.time()
    cuda = dev.type == "cuda"
    impl = {"solver_impl": "complex"}
    off_path = ("resid_precond", "gram9")
    print(f"phase complex-lanes: solver_impl='complex'; (a) cold fcc N={n} "
          f"groups of {list(counts)} lanes from k_path index {LANE_FIRST}, "
          f"{cut} iterations; (b) bandgap k_batch={k_batch} resuming rows "
          f"{rows[0]}-{rows[-1]}", flush=True)
    for lanes in sorted({counts[0], counts[-1]}):
        _lane_group(dev, n, lanes, 2, **impl)
    per_lane, peaks = {}, {}
    for lanes in counts:
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        res, wall, its = _lane_group(dev, n, lanes, cut, **impl)
        got, by_b = kmod.launches(), kmod.k2_launches_by_batch()
        batch = 3 * lanes * res[0].x.shape[0]
        per_lane[lanes] = 1e3 * wall / max(its, 1)
        peaks[lanes] = _peak_gib(dev)
        print(f"  (a) L={lanes}: {its} lane-iterations "
              f"({[r.iterations for r in res]}) in {wall:.3f} s = "
              f"{per_lane[lanes]:.3f} ms per lane-iteration "
              f"({per_lane[lanes] / per_lane[counts[0]]:.3f} of L="
              f"{counts[0]}); peak device memory {peaks[lanes]:.2f} GiB "
              f"({peaks[lanes] / lanes:.2f} a lane); launches {got}; K2 by "
              f"batch {by_b}", flush=True)
        if cuda and not by_b.get(batch):
            fail(f"complex-lanes (a) L={lanes}: K2 never launched at "
                 f"B={batch}: {by_b}")
        if any(got[k] for k in off_path):
            fail(f"complex-lanes (a) L={lanes}: K1 or K3 launched on the "
                 f"complex path: {got}")
        del res
    busy = {}
    if cuda:
        for lanes in (counts[0], counts[-1]):
            wall_ms, dev_ms = _busy_share(
                lambda: _lane_group(dev, n, lanes, profiled, **impl))
            busy[lanes] = dev_ms / wall_ms
            print(f"  (a) L={lanes} under torch.profiler, {profiled} "
                  f"iterations: wall {wall_ms:.1f} ms, device {dev_ms:.1f} "
                  f"ms, busy {100 * busy[lanes]:.1f}%, idle "
                  f"{100 * (1 - busy[lanes]):.1f}%", flush=True)

    key = f"fcc_{n}"
    with tempfile.TemporaryDirectory(prefix="pcx_complex_lanes_") as out:
        path = os.path.join(out, "chiral", "bandgap_fcc.json")
        ref = reset_rows(os.path.join(HERE, "output_c64", "chiral",
                                      "bandgap_fcc.json"), path, key, rows,
                         src_key=f"fcc_{N}")
        metrics = os.path.join(out, "metrics.jsonl")
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        kmod.reset_launches()
        t0 = time.time()
        err = bandgap(n=n, lattice="fcc", nev=NEV, dtype=torch.complex64,
                      device=dev, output_dir=out, metrics_path=metrics,
                      indices=None, k_batch=k_batch, verbose=False,
                      solver_kw=impl)
        wall = time.time() - t0
        got = kmod.launches()
        recs = load_jsonl(metrics)
        with open(path) as f:
            lib = json.load(f)
        print(f"  (b) bandgap k_batch={k_batch}: {wall:.3f} s for "
              f"{len(rows)} rows ({wall / len(rows):.3f} s/k-point); peak "
              f"device memory {_peak_gib(dev):.2f} GiB; launches {got}; K2 "
              f"by batch {kmod.k2_launches_by_batch()}", flush=True)
    if err or len(recs) != len(rows):
        fail(f"complex-lanes (b): failed indices {err}, {len(recs)} records")
    for i, rec in zip(rows, recs):
        om, om_pnt = np.asarray(rec["omega"]), np.asarray(rec["omega_pnt"])
        spur = float(np.abs(om_pnt - om).max())
        gold = (float(np.abs(om - np.asarray(ref[f"{key}_frequencies"][i])
                             ).max()) if golden else float("nan"))
        print(f"    k={i}: status {Status(rec['status']).name} iters "
              f"{rec['iterations']} wall {rec['wall_s']:.3f} s "
              f"max|omega-omega_re| {spur:.3e} max|omega_re-committed| "
              f"{gold:.3e}", flush=True)
        if rec["status"] not in (Status.CONVERGED, Status.FLOOR):
            fail(f"complex-lanes (b) k={i}: status "
                 f"{Status(rec['status']).name}")
        if not np.array_equal(np.asarray(lib[f"{key}_frequencies"][i]), om):
            fail(f"complex-lanes (b) k={i}: the library differs from the "
                 f"solve")
        if not spur <= SPURIOUS_TOL:
            fail(f"complex-lanes (b) k={i}: spurious ({spur:.3e})")
        if golden and not gold <= GOLDEN_TOL:
            fail(f"complex-lanes (b) k={i}: {gold:.3e} from the committed "
                 f"row")
    others = [i for i in range(len(ref[f"{key}_iterations"]))
              if i not in rows
              and lib[f"{key}_frequencies"][i] != ref[f"{key}_frequencies"][i]]
    if others:
        fail(f"complex-lanes (b): rows {others} changed")
    if cuda and not got["axis_dft"]:
        fail(f"complex-lanes (b): K2 never launched: {got}")
    if any(got[k] for k in off_path):
        fail(f"complex-lanes (b): K1 or K3 launched on the complex path: "
             f"{got}")
    print(f"  phase complex-lanes: {time.time() - t_phase:.3f} s",
          flush=True)
    return {**got, "ms_per_lane_iteration": per_lane, "busy_share": busy,
            "peak_gib": peaks}


def dense_routes(where: str) -> None:
    """Gate the dense algebra's routes since the last counter reset: every
    complex64 block combination launched K4 (``dense.k4`` > 0), none took
    ``torch.matmul`` (``dense.matmul`` 0); every complex64 Gram launched
    K6 (``dense.gram`` > 0, as many as K6's launches), none took its plain
    version (``dense.gram_plain`` 0)."""
    from pcx_torch import kernels as kmod
    from pcx_torch import tracing
    got = {k: v for k, v in tracing.counts().items()
           if k.startswith(("dense.", "k4.", "gram."))}
    launched = kmod.launches()["gram_chunks"]
    print(f"phase routes: {got}, K6 launches {launched} in {where}",
          flush=True)
    if got.get("dense.matmul", 0) or not got.get("dense.k4", 0):
        fail(f"a complex64 block combination took torch.matmul in "
             f"{where}: {got}")
    if (got.get("dense.gram_plain", 0) or not got.get("dense.gram", 0)
            or got["dense.gram"] != launched):
        fail(f"a complex64 Gram took the cuBLAS route in {where}: {got}, "
             f"K6 launches {launched}")


def main() -> None:
    t_start = time.time()
    peak = phase_device()
    import pcx_torch  # noqa: F401  (TF32 off, highest f32 matmul precision)
    phase_build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    kernels = [phase_k1(gen, dev, peak), phase_k2(gen, dev, peak),
               phase_k3(gen, dev, peak)]
    lane_kernels = [phase_k1_lanes(gen, dev, peak, kernels[0]["ms"]),
                    phase_k3_lanes(gen, dev, peak, kernels[2]["ms"])]
    kernels.append(phase_k4(gen, dev, peak))
    kernels.append(phase_k5(gen, dev))
    kernels.append(phase_k6(gen, dev, peak))
    phase_operator(gen, dev)
    from pcx_torch import kernels as kmod
    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    single = phase_single(dev)
    counts = kmod.launches()
    if not all(counts[k] for k in PATH_KERNELS):
        fail(f"K1, K2, K4 or K5 never launched in the single point: "
             f"{counts}")
    warm_ms = phase_warm(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the solves of phases 7-8 "
          f"(rr_gram='xla'); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    if not all(counts[k] for k in PATH_KERNELS):
        fail(f"K1, K2, K4 or K5 never launched in the solves: {counts}")
    dense_routes("the solves of phases 7-8")
    for rec in kernels:
        rec["launches_solves"] = counts[rec["name"]]

    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    phase_sweep(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the sweep of phase 9 "
          f"(rr_gram='pallas'); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    for rec in kernels:
        rec["launches"] = counts[rec["name"]]
    if not all(rec["launches"] > 0 for rec in kernels):
        fail(f"a kernel of the path never launched in the sweep: {counts}")
    dense_routes("the sweep of phase 9")

    diel_ms = phase_pseudo_operator(gen, dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    phase_pseudo_sweep(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the pseudochiral sweep of phase 11 "
          f"(rr_gram='pallas'); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    for rec in kernels:
        rec["launches_pseudo_sweep"] = counts[rec["name"]]
    if not all(rec["launches_pseudo_sweep"] > 0 for rec in kernels):
        fail(f"a kernel never launched in the pseudochiral sweep: {counts}")
    kmod.reset_launches()
    phase_variants(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the single solves of phase 11 "
          f"(rr_gram='xla'); peak device memory of phase 11 "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; eps^-1 "
          f"ms per 16-column apply {diel_ms}", flush=True)
    if not (counts["resid_precond"] and counts["axis_dft"]):
        fail(f"K1 or K2 never launched in the variants' solves: {counts}")
    for rec in kernels:
        rec["launches_variants"] = counts[rec["name"]]
    phase_solvers_small(dev)
    counts = phase_solvers_full(dev)
    print(f"phase launches: {counts} in the solves of phase 13", flush=True)
    for rec in kernels:
        rec["launches_solvers"] = counts[rec["name"]]

    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    phase_near_gamma(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the near-Gamma sweeps of phase 14 "
          f"(rr_gram='pallas', refine='light'); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    for rec in kernels:
        rec["launches_near_gamma"] = counts[rec["name"]]
    if not all(rec["launches_near_gamma"] > 0 for rec in kernels):
        fail(f"a kernel never launched in the near-Gamma sweeps: {counts}")
    phase_runner()
    counts = phase_keywords(dev, single)
    for rec in kernels:
        rec["launches_coarse_start"] = counts[rec["name"]]
    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    phase_experiments(dev, warm_ms)
    counts = kmod.launches()
    print(f"phase launches: {counts} in the experiments of phase 17",
          flush=True)
    if not (counts["resid_precond"] and counts["axis_dft"]):
        fail(f"K1 or K2 never launched in the experiments: {counts}")
    for rec in kernels:
        rec["launches_experiments"] = counts[rec["name"]]
    counts = phase_parallel(dev)
    print(f"phase launches: {counts} on rank 0 in bandgap(mesh=) of phase "
          f"18 (rr_gram='pallas', refine='light')", flush=True)
    for rec in kernels:
        rec["launches_parallel"] = counts[rec["name"]]
    if not all(rec["launches_parallel"] > 0 for rec in kernels):
        fail(f"a kernel never launched in bandgap(mesh=): {counts}")
    torch.cuda.reset_peak_memory_stats(dev)
    kmod.reset_launches()
    gyroid = phase_library(dev)
    counts = kmod.launches()
    print(f"phase launches: {counts} in phase 19 ({gyroid} in its chiral "
          f"gyroid sweeps); peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    for rec in kernels:
        rec["launches_library"] = counts[rec["name"]]
    if not all(rec["launches_library"] > 0 for rec in kernels):
        fail(f"a kernel never launched in phase 19: {counts}")
    counts = phase_bench(dev)
    for rec in kernels:
        rec["launches_bench"] = counts[rec["name"]]
    counts = phase_wcap(dev)
    for rec in kernels:
        rec["launches_wcap"] = counts[rec["name"]]
    kernels[1]["launches_wcap_by_batch"] = counts["axis_dft_by_batch"]
    counts = phase_lanes(dev)
    for rec in kernels + lane_kernels:
        rec["launches_lanes"] = counts[rec["name"]]
    for rec in lane_kernels:
        rec["launches"] = counts[rec["name"]]
    counts = phase_complex_lanes(dev)
    for rec in kernels + lane_kernels:
        rec["launches_complex_lanes"] = counts[rec["name"]]
    print(f"total: {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels + lane_kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
