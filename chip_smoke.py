#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (libstb_tpu_torch) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each timed; any failure raises and the exit code is non-zero:
  0. device: require CUDA, print the card's name and power limit, turn
     TF32 off;
  1. build the hand-written kernels K1-K3 (csrc/*.cu, all three sharing
     csrc/row_walk.cuh), the TI sweep (csrc/ti_sweep.cu), the slice moves
     (csrc/slice_move.cu) and the probes (csrc/vpu_probe.cu) with nvcc, one
     process per source, all at once, and the native long-double oracle
     (native/stb_ref.cpp) with g++ beside them, before any rank of phase
     16 starts;
  2. K1 against its plain PyTorch version: (a) at (G=8, N=160, M=48) and
     at the row walk's tile edges (G = 1 and 64) in f32 and f64, (b) at
     the grid-fill benchmark shape (64 x 16384 x 1024, f32) on 8 of the
     discounts against the f64 plain fill, (c) the kernel's and the plain
     f32 fill's times (CUDA events, median of runs), the kernel's bound
     and its share of it, and its share of a copy roofline measured on the
     card, (d) past 8192 columns, through agrid.make_grid at (G=2, 12288,
     12288) in f32 against the f64 plain fill, and at 8193 columns (a last
     tile of one column);
  3. the main path: make_grid(512, 128, g=64) + run_gibbs with 1024
     chains x 125 iterations (the Quick-start's 500 cut to a quarter,
     PERF.md section 4) on crp_generate(0, 4, 20, 100) data, with
     the kernels' launch counts over that run (the TI sweep's one a
     sweep, all on the grid route, the slice moves' at least one a move);
  4. the acceptance gate: run_gibbs (f32, this card) against the JAX
     package's CPU-f64 posterior moments in tests/data/torch_gate_ref.json
     for seeds 7, 11, 23, within tools/oracle_compare.compare()'s bands,
     with the kernels' launch counts over the gate;
  5. K2 (csrc/fill_table.cu) against its plain version: (a) at (0.4321,
     200, 64), edge shapes and tile edges in f32 and f64, (b) at (16384,
     1024) in f32 against the f64 plain fill, (c) K2's and the plain f32
     fill's times, K2's bound, its share of it and of the copy roofline;
  6. K3 (csrc/fill_table_cols.cu) against its plain version: (a) the
     tests/test_pallas.py cases, edge shapes, narrow tables on K3's side
     of the route (m = 1, 2, 17) and the pipeline's chunk edges (n a
     chunk - 1, + 1 and three chunks at m = 1, 2, 40) in f32 and f64, and
     past the resident capacity (2^21, 16), chunks in two waves, in f32
     and f64 against K1 at G=1 in f64, (b) at (2^20, 1024) in f32 against
     K1 at G=1 in f64, (c) K3's and the plain f32 fill's times at (2^16,
     1024), K3's at (2^20, 1024), each as a share of its bound and per
     column, and at 2^20 as a share of the copy roofline;
  7. the single-table path: make(1000, 200, 10^6, 10^4, 0.5) (K3, n >=
     4 m) and make(1000, 300, ...) (K2), ensure to 81920 x 256 (K3, the
     anchored S1),
     remake, cli/list_torch.py, and an S-only make(65535, 1024,
     build_v=False), which must take K3,
     held to plain-f64 tables built on the card, with each kernel's launch
     count over that run and no plain fill on it;
  8. the K2/K3 crossover: both kernels at the CROSSOVER (n, m) shapes,
     two of them at the routing cutoff (CUDA events, median of 7), and
     stirling.fill_route's choice at each, which must be within 1.1x of
     the faster;
  9. the ARS Gibbs path: run_gibbs with GibbsConfig(kernel="ars") at the
     gate's configuration, seed 7, against the same reference moments and
     bands as phase 4, with K1's launch count, the share of ARS calls'
     chains that gave up (must be 0), the mean density evaluations per
     chain per ARS call, the run's grid against the f64 plain fill, and
     the time of a sample_b / sample_a call by either kernel;
 10. the hyperparameter layer on a single table, every table and grid it
     fills held to its plain-f64 version at its own shape: (a)
     sample_table_config on a make(2048, 64) table (K3): table and
     customer totals per chain equal the closed forms exactly; (b)
     sample_table_config and sample_a_m on a make(64, 12) table (K3) and
     on a discount grid that holds the table's discount as a node, under
     the same draws: equal histograms and equal a in all but at most 2
     of 64 chains; (c) ti_sweep_blocked on a StirlingTable (K2) and on
     such a grid: E[T_j] within 3 combined SE + 0.05, the table's
     sweeps on the kernel's rows route and the grid's on its grid route;
     then the TI sweep's kernel (csrc/ti_sweep.cu) against its plain
     loop at the Quick-start's shape (crp_generate(0, 4, 20, 100), 16384
     chains, group schedule, a make_grid(512, 128, g=64) K1 grid in f32):
     the grid route, t and T bitwise equal over 3 sweeps, the kernel's
     time (CUDA events) on both routes beside its byte bound, the whole
     sweep's (ti.prepare + kernel) on both routes and the plain loop's
     (host clock), and the kernel's launches by route, one a sweep; (d)
     special.digamma, trigamma and digamma_inv at 10^6 points on [0.01,
     10^4] against torch.special, and data_curve_sparse against
     data_curve at 2^18 + 5 pairs; (e) the slice moves' kernel
     (csrc/slice_move.cu) against its plain version slice_move_ref at the
     cells' shapes (16384 x 4, 512 x 100, 512 x 1), both moves, f32 and
     f64 under the same draws: x and ok equal on >= 99.9% of the chains,
     the others within 64 eps of the terms' size of the level, one launch
     a batch; in f32 a move's time by the kernel (host and device, the
     draws and the read included), by slice_move_ref and by the per-try
     loop slice_sample, and a launch's device time beside its byte bound;
 11. the check.c samplers: run_gibbs with CT, CTW (w = 10) and HSA (f32,
     K1 grids) against the JAX package's CPU-f64 moments in
     tests/data/torch_check_ref.json, within phase 4's bands, with each
     grid held to its plain-f64 fill and the final states' invariants
     exact; and the host SA oracle against fixed-(a, b) HSA and CT runs
     on the card (6 SE + 0.15);
 12. check.c scale (100 groups x 1000 items, 20 categories, 32 chains):
     stirling.make on K2, held to its plain-f64 table; four sweeps each
     of the pair-major TI, the relative-window CTW and the pair-major HSA,
     timed (item-updates/s, CUDA events), their invariants exact; one TI
     and one CTW sweep under the card's draws by both V / Srel routes
     (equal) and through the same sweeps on the CPU in f64 on a plain-f64
     table (equal in all but at most 2 of 32 chains); one profiled sweep
     of each (kernels, device-busy share);
 13. traces and checkpoint/resume at the gate's configuration, seed 7, on
     a K1 grid: (a) run_gibbs(collect_traces=True), 1000 iterations:
     traces (iters, 64), a_rhat and b_rhat below 1.1, 0 < ESS <= the kept
     draws x 1.5, the moments inside phase 4's bands; (b) 50 iterations,
     checkpoint.save of the state and the CUDA generator, load onto the
     card, 50 more through driver._run_chunk: t, T, a, b equal to
     one straight 100-iteration run bitwise;
 14. the HPYP model: (a) run_hpyp (f32, K1 grid, 256 chains, 1000
     iterations, hyper cycle 2) on the Quick-start data against the JAX
     package's CPU-f64 moments in tests/data/torch_hpyp_ref.json (E[T1_j],
     E[T0], E[a1], E[b1], E[a0], E[b0]; phase 4's bands), the state's
     invariants exact; (b) check.c's MAXDATA (phase 12's data, 32 chains,
     100 iterations, hyper cycle 5) from make_grid(454, 454, g=32), which
     run_hpyp must grow through K1 to cover the level-0 bound (5761 + 1),
     the grown grid held to the f64 plain fill on three discounts, the
     invariants exact, ms an iteration, one profiled iteration;
 15. NGG and precision: (a) ngg_table, ngg_ratio_table (recurrence,
     quadrature), the five saddle points and ngg_quadrature_log in f64 on
     the card against the JAX f64 values in tests/data/torch_ngg_ref.json
     (rtol 1e-10; the tables within their condition-number bound), at
     cli/ngg.py's (n, k) grid and at 256 workload points; (b)
     cli/ngg_torch.py's table mode, then its --chains 100000 workload
     (the saddle representations agree within 0.05; saddle-evals/s, one
     profiled pass); (c) cli/precision_torch.py at N = 10000, M = 4000:
     ratio/f32's error below log/f32's;
 16. the multi-device layer on the one card, each rank a process of this
     script on cuda:0 (gloo between ranks that share it; any failing rank
     fails the phase; c, d and a run at once): (b) make_grid(mesh=...) of phase 2b's 8 discounts
     at 16384 x 1024 f32 over 2 ranks, the gathered tables bitwise equal
     to a one-process K1 fill, the fill and the all-gather timed apart;
     (c) entry.dryrun_multichip over 4 ranks on a 2 x 2 chains x data
     mesh at the JAX package's shapes (1024 chains, a 512 x 128 x 32
     grid): data-group peers bitwise equal, t, T, b of each chain shard
     equal to the one-process step on its chains under the same shard
     generators, a within 1e-5 relative in all but 1% of them, the
     invariants exact, the means finite; (d) the gate's configuration over
     2 ranks through .p0 / .p1 checkpoints, the resumed run bitwise equal
     to the straight one; (a) NCCL at world size 1: an
     all-reduce, an all-gather and make_grid(mesh=...) bitwise equal to
     the unsharded fill; (e) torchrun --nproc_per_node 2
     cli/ngg_torch.py --chains 100000: worst equal to 15b's, mean within
     rtol 1e-12; (f) tools/scaling_bench_torch.py, each run a process of
     the tool that starts its own ranks: the Gibbs step + cross-chain
     moments at 2 and 4 gloo ranks, the NGG workload (--ngg) at 2, 10
     steps each; one-card figures, every figure and moment finite, NGG's
     worst < 0.2, K1 launched in every rank;
 17. the long-double oracle: native.fill_ref(0.5, 8192, 1024) against K1
     (G = 1), K2, K3 and the plain fill in f32 and f64 (max |d log S|,
     |dSrel|, V relative error; each kernel within 1.5 x its plain
     version's error + 1e-7 and the bench bounds 5e-2 / 1e-4), and the
     native crp_generate against the Python one at check.c's MAXDATA;
 18. the ported on-device tools at their own sizes, earlier phases' memory
     freed first: (a) tools/extra_bench_torch.py's make at (2^20, 1024)
     through K3 and the anchored S1 (stirling.s1_route), its wall time and
     apart its fill, the S1's host anchors, their copy and its fill on the
     card beside the host route's S1 and copy, the table equal bitwise to
     a direct K3 fill and its S1 pair to s1_anchored, hi + lo within 5e-4
     of s1_host at every row (the JAX package's budget) at a = 0, 0.05,
     0.5, 0.9; (b) its ensure(2^19 -> 2^20): time, peak
     allocated memory beside the old and new tables' bytes, the grown table
     bitwise equal to a fresh make; (c) its sparse sample_a over 2^20 + 17
     pairs (C = 4, a make_grid(96, 32, g=16) grid through K1, 8 moves):
     samples/s, every a in [A_MIN, A_MAX], the streamed curve within 1e-5
     of max |curve| of one whole-pair gather; (d) data_curve's gather route
     and the one-hot product route (_data_curve_mm, run with allow_tf32 on)
     at the Quick-start's sample_a shape (make_grid(512, 128, g=64), 80
     pairs) at 1024 and 16384 chains: each timed, within 1e-5 of max
     |curve| of each other; (e) tools/lgcache_bench_torch.py at batch 2^20,
     4 reps;
 19. the probes of the card's floors (csrc/vpu_probe.cu, the port of
     tools/vpu_probe.py): (a) each probe kernel against its plain version
     at small shapes: the write floor bitwise in its three modes (a chunk
     past the last whole one, chunks in two waves), every issue-rate op
     (f32 within 1e-5 relative, the approximate reciprocal and logf 1e-4;
     f64 1e-12: each orbit is contractive or of period 2, so a rounding
     does not grow along it), the shared-memory modes and the overlap
     variants bitwise; (b) tools/vpu_probe_torch.py's measurements at
     their full size, each timed call's output held to its plain version
     (the same tolerances) and the library's compiled steps counted
     (cuobjdump -sass: each P2 / P4 kernel holds one mark a step of its
     unrolled loop, vpu_probe_torch.SASS_MARKS: the FMA, multiply,
     shuffle or hardware reciprocal of the step, or logf's exponent
     conversion); a mismatch, a missing step, any byte rate over 105%
     of 3.35 TB/s, op rate over 105% of the FMA rate of its type or overlap
     fraction outside [-0.05, 1.05] fails the run; (c) K1-K3's time
     against each floor: the data sheet's bound(), the measured write
     floor, the measured issue floor and the two combined by the measured
     overlap; the outputs freed at the end.  P5 (mix, and staged through
     a double-buffered staging area) and every rung of P6's ladder (from
     K3's memory mix step by step to K3's structure) and of its branch
     from the top rung (the top rung with storewarps, with early and with
     both: levers that move work between warps; where storewarps fits) are
     held to their plain versions in 19a at the same small shapes and in
     19b at K3's two shapes (bitwise; where div_pos / log_pos are in play
     the f64 sinks within 1e-12 relative and the f32 tables within one
     f32 ulp; the branch, where it fits, bitwise to the top rung, in 19a
     also over a quarter of the blocks), each rung's SASS marks counted
     against the rung before (a branch rung's against the top rung, and
     the top rung's marks against P5 mix); 19b fails on a ladder rung
     faster than the rung before it by more than the noise, a branch rung
     faster than the faster of P5's modes, or either faster than P1
     piecewise; 19c prints the ladder, us a column, beside K3's own time
     from 6c (the ladder's times, K3's beside it and P1 piecewise's there
     are each call's device time, queued behind a spin so that the events
     hold no host work), and at (2^16, 256) and (2^16, 512) too, with
     each one's fill and period from the three m and the line's
     residual.

Every time is printed beside the card's name and power limit.  The
second-to-last line is a JSON object with each kernel's launches (summed
over the paths of phases 3, 7, 9, 10, 11, 12, 13, 14, 16a-d, 16f (over each
path's ranks, which report theirs in a RANK json line), 17, 18 and 19, each driven
with the counts set to 0 just before it; "launches_by_path" splits them),
error and times; the last line is {"ok": true, "device": {...}}.

"""
import concurrent.futures
import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GATE_REF = os.path.join(ROOT, "tests", "data", "torch_gate_ref.json")
CHECK_REF = os.path.join(ROOT, "tests", "data", "torch_check_ref.json")
HPYP_REF = os.path.join(ROOT, "tests", "data", "torch_hpyp_ref.json")
NGG_REF = os.path.join(ROOT, "tests", "data", "torch_ngg_ref.json")
# the ARS run of phase 9: one of the gate's seeds at half the gate's depth (an
# ARS iteration costs 44-51 ms on an H100, 2000 of them ~100 s)
ARS_SEED, ARS_ITERS = "7", 1000
# phase 10a: chains, pairs, the largest count + 1 and table count + 1
CONFIG_SHAPE = (64, 512, 2000, 41)
SPECIAL_POINTS = 10 ** 6
BENCH_SHAPE = (64, 1 << 14, 1024)      # bench.py:77, the headline grid fill
MAIN_ITERS = 125               # phase 3: the Quick-start's 500, cut to 1/4
# The least time for a fill: its tables written once (2 cells' bytes a
# cell) at the H100 SXM's 3.35 TB/s, or its f64 work at 34 TFLOP/s (f64
# outside the tensor cores; NVIDIA's data sheet), whichever is larger.  A
# cell of the function is ~12 flops plus two divides and one log, each of
# those counted as 20, whichever kernel computes it (K3's scans are the
# cost of its algorithm, not of the function).
HBM_BPS = 3.35e12
F64_FLOPS = 34e12
FILL_FLOPS = 12 + 3 * 20
# the row walk's tile edges (32 columns a tile, the halo read 32 rows at a
# time): m = 1, m < 32, m = 32, 33, 65; n = 1, 2, n < 32, n = 33
TILE_EDGES = [(20, 1), (33, 1), (20, 17), (33, 32), (20, 33), (33, 33),
              (33, 65), (1, 65), (2, 33), (100, 65)]
# K2 against K3; (4096, 1024) and (8192, 2048) are at the cutoff, n = 4 m
CROSSOVER = [(1000, 200), (1024, 1024), (4096, 1024), (8192, 2048),
             (16384, 1024), (65535, 1024), (16384, 64)]


def bound(cells, itemsize):
    """(ms, "bytes" or "operations"): the least time of a fill of
    ``cells`` cells of ``itemsize`` bytes, V and Srel."""
    b_ms = 2 * itemsize * cells / HBM_BPS * 1e3
    o_ms = FILL_FLOPS * cells / F64_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def done(t0, msg=""):
    print(f"   ok {time.perf_counter() - t0:.2f}s {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def reset_launches(*mods):
    for mod in mods:
        for name in mod.LAUNCHES:
            mod.LAUNCHES[name] = 0


def host_ms(fn, reps):
    """Mean host-clock time of ``fn`` in ms over ``reps`` calls, the
    device drained before the first and after the last."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def cuda_ms(fn, reps):
    """Median device time of ``fn`` in ms, one CUDA-event pair per run."""
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def table_errors(v, s, v64, s64, chunk=64):
    """Natural-layout (n, m) tables (views allowed) against the f64 ones,
    in column blocks: max V relative error on live cells, max |dSrel| on
    finite cells, max absolute error of either; checks the sentinels
    (V(., 1) = +inf, V = 0 and Srel = -inf where the f64 table has them,
    no NaN).  ``s``/``s64`` may be None."""
    v_rel = s_abs = max_abs = 0.0
    check(bool(torch.isposinf(v[:, 0]).all()), "V(., 1) is not +inf")
    for j0 in range(0, v.shape[1], chunk):
        vv, vr = v[:, j0:j0 + chunk].double(), v64[:, j0:j0 + chunk]
        live = torch.isfinite(vr) & (vr > 0)
        check(not bool(torch.isnan(vv).any()), "NaN in V")
        check(bool((vv[torch.isfinite(vr) & (vr == 0)] == 0).all()),
              "above-diagonal V is not 0")
        if bool(live.any()):
            dv = (vv - vr).abs()[live]
            v_rel = max(v_rel, (dv / vr[live]).max().item())
            max_abs = max(max_abs, dv.max().item())
        if s is None:
            continue
        ss, sr = s[:, j0:j0 + chunk].double(), s64[:, j0:j0 + chunk]
        check(not bool(torch.isnan(ss).any()), "NaN in Srel")
        check(bool((torch.isneginf(ss) == torch.isneginf(sr)).all()),
              "-inf pattern of Srel differs")
        fin = torch.isfinite(sr)
        if bool(fin.any()):
            ds = (ss - sr).abs()[fin].max().item()
            s_abs = max(s_abs, ds)
            max_abs = max(max_abs, ds)
    return v_rel, s_abs, max_abs


def fill_errors(v, s, v64, s64):
    """table_errors over the G tables of a grid fill, (G, n, m) each."""
    errs = [table_errors(v[g], s[g], v64[g], s64[g])
            for g in range(v.shape[0])]
    return tuple(max(e[i] for e in errs) for i in range(3))


def check_grid(sc, grid, what):
    """A grid that a path filled with K1, held to the f64 plain fill at its
    own (G, n, m): V within 2e-5 relative and |dSrel| / max(1, |Srel|) <
    1e-4 in f32, 1e-12 and 1e-10 in f64.  Returns the two errors."""
    v_tol, s_tol = ((2e-5, 1e-4) if grid.srel.dtype == torch.float32
                    else (1e-12, 1e-10))
    v64, s64 = sc.fill_grid_ref(grid.avec.double(), grid.n_max, grid.m_max)
    e_v, _, _ = fill_errors(grid.vtab, grid.srel, v64, s64)
    e_s = max(scaled_err(grid.srel[g], s64[g]) for g in range(grid.g_max))
    check(e_v < v_tol and e_s < s_tol,
          f"{what}: K1 {grid.srel.dtype} at {tuple(grid.srel.shape)}: V rel "
          f"{e_v:.3g} (< {v_tol}), scaled |dSrel| {e_s:.3g} (< {s_tol})")
    return e_v, e_s


def scaled_err(s, s64):
    """max |dSrel| / max(1, |Srel|) over the finite cells."""
    fin = torch.isfinite(s64)
    if not bool(fin.any()):
        return 0.0
    return ((s.double() - s64).abs()[fin]
            / s64[fin].abs().clamp(min=1.0)).max().item()


# edge shapes: m = 1, n < m, a = 0, m not a multiple of 8 / 32 / the thread
# count, n not a multiple of a warp's 32-row group
EDGE_CASES = [(0.0, 5, 1), (0.3, 3, 9), (0.5, 77, 33), (0.9, 40, 50),
              (0.2, 1, 1), (0.55, 3000, 1500)]
# narrow tables that fill_route sends to K3 (n >= 4 m): m = 1, 2, 17
NARROW_CASES = [(0.4321, 20, 1), (0.4321, 33, 1), (0.0, 700, 1),
                (0.3, 40, 2), (0.9, 100, 2), (0.5, 300, 17),
                (0.0, 1000, 17)]
# K3's chunk edges (chunks of 512 rows below 2^16 rows): n one below and
# one above a chunk, and three chunks, at m = 1, 2, 40
CHUNK_EDGES = [(0.37, n, m) for m in (1, 2, 40) for n in (511, 513, 1500)]
# past K3's resident capacity: 2^21 rows make 228 chunks on 132 SMs
WAVES_SHAPE = (1 << 21, 16)
# an S-only table (build_v=False) on K3's side of the route
S_ONLY = (65535, 1024)
# K1 past 8192 columns: a square grid table, and a last tile of one column
WIDE_SHAPE = (2, 12288, 12288)
WIDE_RAGGED = (2, 600, 8193)


def phase5_k2(dev, sc, stirling, card, roof):
    """K2 against its plain version; returns its kernels-line fields."""
    t0 = phase("5a K2 vs plain at (0.4321, 200, 64), edge shapes and tile "
               "edges")
    for a, n, m in [(0.4321, 200, 64)] + EDGE_CASES + [
            (0.4321, n, m) for n, m in TILE_EDGES]:
        v64, s64 = sc.fill_table_ref(torch.tensor(a, dtype=torch.float64,
                                                  device=dev), n, m)
        for dt, v_tol, s_tol in ((torch.float32, 2e-5, 1e-4),
                                 (torch.float64, 1e-12, 1e-10)):
            v, s = sc.fill_table_cuda(torch.tensor(a, dtype=dt, device=dev),
                                      n, m)
            torch.cuda.synchronize()
            v_rel, s_abs, _ = table_errors(v, s, v64, s64)
            # |dSrel| scaled by max(1, |Srel|): one f32 rounding of an
            # |Srel| ~ 1e4 (m ~ 1500) is 5e-4 absolute
            s_sc = scaled_err(s, s64)
            check(v_rel < v_tol and s_sc < s_tol,
                  f"K2 {dt} at ({a}, {n}, {m}): V rel {v_rel:.3g}, "
                  f"scaled |dSrel| {s_sc:.3g} (|dSrel| {s_abs:.3g})")
            check((a, n, m) != (0.4321, 200, 64) or s_abs < s_tol,
                  f"K2 {dt} at (0.4321, 200, 64): |dSrel| {s_abs:.3g}")
            if dt == torch.float32 and n >= 2:
                k = min(n, m)
                s1 = torch.as_tensor(stirling.s1_host(a, k), device=dev)
                diag = torch.diagonal(s[:k, :k]).double()[1:]
                check(bool(((diag + s1[1:]).abs()
                             < 2e-5 * s1[1:].abs().clamp(min=1.0)).all()),
                      f"K2 diagonal != -S1 at a={a}")
        v_n, s_n = sc.fill_table_cuda(torch.tensor(a, device=dev), n, m,
                                      with_srel=False)
        check(s_n is None and torch.equal(
            v_n, sc.fill_table_cuda(torch.tensor(a, device=dev), n, m)[0]),
            "K2 with_srel=False path")
    done(t0)

    t0 = phase("5b K2 vs f64 plain at (16384, 1024)")
    N, M = 1 << 14, 1024
    a32 = torch.tensor(0.5, device=dev)
    v, s = sc.fill_table_cuda(a32, N, M)
    torch.cuda.synchronize()
    v64, s64 = sc.fill_table_ref(a32.double(), N, M)
    v_rel, s_abs, max_abs = table_errors(v, s, v64, s64)
    print(f"   V max rel err {v_rel:.6g}, max |dSrel| {s_abs:.6g}, "
          f"max abs err {max_abs:.6g}")
    check(v_rel < 1e-4 and s_abs <= 5e-2,
          f"K2 (16384, 1024): V rel {v_rel:.3g} (< 1e-4), |dSrel| "
          f"{s_abs:.3g} (<= 5e-2)")
    del v, s, v64, s64
    done(t0)

    t0 = phase("5c K2 times at (16384, 1024) (CUDA events)")
    k_ms = cuda_ms(lambda: sc.fill_table_cuda(a32, N, M), 5)
    p_ms = cuda_ms(lambda: sc.fill_table_ref(a32, N, M), 1)
    b_ms, b_by = bound(N * M, 4)
    k_bw = 2 * 4 * N * M / (k_ms * 1e-3)
    print(f"   K2 {k_ms:.4f} ms (median of 5) = {100 * b_ms / k_ms:.2f}% of "
          f"its bound {b_ms:.4f} ms ({b_by}) = {100 * k_bw / roof:.2f}% of "
          f"the copy roofline; plain f32 fill {p_ms:.1f} ms (one run) "
          f"[{card}]")
    done(t0)
    return {"max_abs_err": max_abs, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def phase6_k3(dev, sc, stirling, card, roof):
    """K3 against its plain version and K1; returns its kernels-line
    fields."""
    t0 = phase("6a K3 vs plain: test_pallas cases, edge shapes, narrow "
               "tables, chunk edges; two waves vs K1")
    cases = [(0.4321, 200, 64), (0.55, 512, 48), (0.05, 384, 32),
             (0.0, 256, 24)]
    for a, n, m in cases + EDGE_CASES + NARROW_CASES + CHUNK_EDGES:
        v64, s64 = sc.fill_table_ref(torch.tensor(a, dtype=torch.float64,
                                                  device=dev), n, m)
        for dt in (torch.float32, torch.float64):
            v, s = sc.fill_table_cols_cuda(
                torch.tensor(a, dtype=dt, device=dev), n, m)
            torch.cuda.synchronize()
            check(tuple(v.shape) == (m, n), "K3 layout is (m, n)")
            v, s = v.T, s.T
            v_rel, _, _ = table_errors(v, s, v64, s64)
            s_sc = scaled_err(s, s64)
            fin = torch.isfinite(s64)
            tol = (3e-5, 1e-4) if dt == torch.float32 else (1e-12, 1e-12)
            check(v_rel < tol[0] and s_sc < tol[1],
                  f"K3 {dt} at ({a}, {n}, {m}): V rel {v_rel:.3g}, scaled "
                  f"|dSrel| {s_sc:.3g}")
            check(bool((v[~fin] == 0).all() and torch.isneginf(s[~fin]).all()),
                  "K3: V 0 / Srel -inf above the diagonal")
    v_n, s_n = sc.fill_table_cols_cuda(torch.tensor(0.3, device=dev), 300, 40,
                                       with_srel=False)
    check(s_n is None and torch.equal(v_n, sc.fill_table_cols_cuda(
        torch.tensor(0.3, device=dev), 300, 40)[0]), "K3 with_srel=False")
    # two waves: the f64 row walk is the reference (the plain fill would
    # take minutes at 2M rows); f32 to the 6b bounds, f64 to 1e-9 (two
    # f64 orders of summation over 2M rows)
    n, m = WAVES_SHAPE
    a = torch.tensor(0.5, dtype=torch.float64, device=dev)
    plan = sc.cols_plan(n, m, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    check(plan.waves >= 2, f"{WAVES_SHAPE} runs in one wave: {plan}")
    v64, s64 = sc.fill_grid_cuda(a.reshape(1), n, m)
    for dt, tol in ((torch.float32, (1e-4, 5e-2)), (torch.float64,
                                                    (1e-9, 1e-9))):
        v, s = sc.fill_table_cols_cuda(a.to(dt), n, m)
        torch.cuda.synchronize()
        v_rel, s_abs, _ = table_errors(v.T, s.T, v64[0], s64[0])
        print(f"   {WAVES_SHAPE} {dt} ({plan.chunks} chunks of {plan.chunk} "
              f"rows, {plan.waves} waves): V rel {v_rel:.6g}, |dSrel| "
              f"{s_abs:.6g}")
        check(v_rel < tol[0] and s_abs <= tol[1],
              f"K3 {dt} at {WAVES_SHAPE}: V rel {v_rel:.3g}, |dSrel| "
              f"{s_abs:.3g}")
    del v, s, v64, s64
    done(t0)

    t0 = phase("6b K3 (f32) vs K1 at G=1 (f64) at (2^20, 1024)")
    N, M = 1 << 20, 1024
    a32 = torch.tensor(0.5, device=dev)
    v, s = sc.fill_table_cols_cuda(a32, N, M)
    v64, s64 = sc.fill_grid_cuda(a32.double().reshape(1), N, M)
    torch.cuda.synchronize()
    v_rel, s_abs, max_abs = table_errors(v.T, s.T, v64[0], s64[0])
    print(f"   V max rel err {v_rel:.6g}, max |dSrel| {s_abs:.6g}, "
          f"max abs err {max_abs:.6g}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    check(v_rel < 1e-4 and s_abs <= 5e-2,
          f"K3 (2^20, 1024): V rel {v_rel:.3g} (< 1e-4), |dSrel| "
          f"{s_abs:.3g} (<= 5e-2)")
    del v, s, v64, s64
    torch.cuda.empty_cache()
    done(t0)

    t0 = phase("6c K3 times (CUDA events)")
    n16 = 1 << 16
    k16 = cuda_ms(lambda: sc.fill_table_cols_cuda(a32, n16, M), 5)
    p16 = cuda_ms(lambda: sc.fill_table_cols_ref(a32, n16, M), 1)
    k20 = cuda_ms(lambda: sc.fill_table_cols_cuda(a32, N, M), 3)
    bw = 2 * 4 * N * M / (k20 * 1e-3)
    b16, b16_by = bound(n16 * M, 4)
    b20, b20_by = bound(N * M, 4)
    print(f"   (2^16, 1024): K3 {k16:.4f} ms (median of 5) = "
          f"{1e3 * k16 / M:.3f} us a column = {100 * b16 / k16:.2f}% of its "
          f"bound {b16:.4f} ms ({b16_by}), plain f32 fill {p16:.1f} ms (one "
          f"run); (2^20, 1024): K3 {k20:.4f} ms (median of 3) = "
          f"{1e3 * k20 / M:.3f} us a column = {bw / 1e9:.1f} GB/s = "
          f"{100 * bw / roof:.1f}% of the copy roofline = "
          f"{100 * b20 / k20:.2f}% of its bound {b20:.4f} ms ({b20_by}) "
          f"[{card}]")
    done(t0)
    return {"max_abs_err": max_abs, "ms": k16, "plain_ms": p16,
            "bound_ms": b16, "bound_by": b16_by, "library_ms": None,
            "ms_2_20": k20}


def plain_table(stirling, t, n, m, a, dev):
    """A plain-f64 table on the card with ``t``'s bounds: fill_rows (not a
    kernel) and the host S1."""
    from scipy.special import gammaln
    vtab, srel, _ = stirling.fill_rows(a, n, m, dtype=torch.float64,
                                       device=dev)
    s1 = torch.as_tensor(stirling.s1_host(a, n), device=dev)
    f64 = dict(dtype=torch.float64, device=dev)
    return stirling.StirlingTable(
        a=torch.tensor(a, **f64), lga1=torch.tensor(gammaln(1.0 - a), **f64),
        s1_hi=s1, s1_lo=torch.zeros_like(s1), vtab=vtab, srel=srel,
        n_max=n, m_max=m, max_n=t.max_n, max_m=t.max_m,
        use_asympt=t.use_asympt, a_pos=a > 0)


QUERY_BOUNDS = {"S": (1e-6, 5e-2), "Srel": (0.0, 5e-2), "V": (1e-4, 0.0),
                "U": (1e-4, 0.0), "UV": (1e-4, 0.0), "S1": (1e-6, 5e-2)}


def check_queries(t, ref, n, m, what, queries=tuple(QUERY_BOUNDS)):
    """The ``queries`` of ``t`` (f32) against the plain-f64 ``ref`` at the
    points (n, m): same -inf / 0 pattern; S, S1 within 1e-6 relative +
    5e-2 (one f32 rounding of log S); Srel within 5e-2; V, U, UV within
    1e-4 relative."""
    dev = t.device
    n = torch.as_tensor(n, device=dev)
    m = torch.as_tensor(m, device=dev)
    worst = {}
    for q in queries:
        rtol, atol = QUERY_BOUNDS[q]
        args = (n,) if q == "S1" else (n, m)
        got = getattr(t, q)(*args).double()
        want = getattr(ref, q)(*args)
        check(bool((torch.isneginf(got) == torch.isneginf(want)).all()
                   and (torch.isposinf(got) == torch.isposinf(want)).all()
                   and ((got == 0) == (want == 0)).all()),
              f"{what}: {q} sentinel pattern differs")
        fin = torch.isfinite(want)
        diff = (got - want).abs()[fin]
        bound = rtol * want[fin].abs() + atol
        err = torch.where(bound > 0, diff / bound,
                          torch.where(diff == 0, 0.0, torch.inf))
        err = err.max().item() if err.numel() else 0.0
        worst[q] = err
        check(err <= 1.0, f"{what}: {q} off by {err:.3g} x its bound")
    return worst


def phase7_table(dev, sc, stirling, card):
    """The single-table path end to end; returns each kernel's launches."""
    t0 = phase("7 single-table path: make (K3; K2), ensure (K3), remake, "
               "list_torch")
    plain_calls = []
    fill_rows = stirling.fill_rows

    def counted(*args, **kw):
        plain_calls.append(args[:3])
        return fill_rows(*args, **kw)

    rng = np.random.default_rng(0)
    reset_launches(sc)
    stirling.fill_rows = counted
    try:
        t_run = time.perf_counter()
        t = stirling.make(1000, 200, 10 ** 6, 10 ** 4, 0.5, use_asympt=True,
                          device=dev)
        torch.cuda.synchronize()
        make_s = time.perf_counter() - t_run
        k3_make = sc.LAUNCHES["fill_table_cols"]
        tw = stirling.make(1000, 300, 10 ** 6, 10 ** 4, 0.5, use_asympt=True,
                           device=dev)
        torch.cuda.synchronize()
        k2_make = sc.LAUNCHES["fill_table"]
        t_run = time.perf_counter()
        t2 = stirling.ensure(t, 70000, 200)
        torch.cuda.synchronize()
        ensure_s = time.perf_counter() - t_run
        t3 = stirling.remake(t2, 0.3)
        torch.cuda.synchronize()
        sys.path.insert(0, os.path.join(ROOT, "cli"))
        import list_torch
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            list_torch.main(["--device", "cuda", "--asymptote"])
        torch.cuda.synchronize()
        before = dict(sc.LAUNCHES)
        t_run = time.perf_counter()
        t_s = stirling.make(*S_ONLY, 10 ** 6, 10 ** 4, 0.5, build_v=False,
                            use_asympt=True, device=dev)
        torch.cuda.synchronize()
        s_only_s = time.perf_counter() - t_run
        s_only = {k: sc.LAUNCHES[k] - before[k] for k in before}
    finally:
        stirling.fill_rows = fill_rows
    launches = dict(sc.LAUNCHES)
    print(f"   launches on this path: {launches}; plain fills "
          f"{len(plain_calls)}")
    check(launches["fill_table"] >= 1 and launches["fill_table_cols"] >= 1,
          "the single-table path did not launch both K2 and K3")
    check(not plain_calls, "the plain fill ran on the single-table path")
    print("   " + "\n   ".join(buf.getvalue().strip().splitlines()[-3:]))

    # the Quick-start table has n >= 4 m: K3; (1000, 300) is on K2's side
    check(t.cols and k3_make == 1 and t.report().endswith(
        f"float32 mem={(2 * 1000 * 200 * 4 + 2 * 1000 * 4) // 1024}k"),
        f"make: {t.report()}")
    ref = plain_table(stirling, t, 1000, 200, 0.5, dev)
    s_200_43 = float(t.S(200, 43))
    check(abs(s_200_43 - 763.6337) < 1e-3, f"S(200, 43) = {s_200_43}")
    n = np.concatenate([[200, 1000, 2, 1, 7, 9, 3, 1500, 2 * 10 ** 6],
                        rng.integers(1, 1001, 300),
                        rng.integers(1001, 3 * 10 ** 6, 40)])
    m = np.concatenate([[43, 200, 2, 1, 7, 1, 5, 5, 5],
                        rng.integers(1, 201, 340)])
    m[9:30] = n[9:30]                       # the diagonal identity
    m[30:50] = 1                            # S1
    w1 = check_queries(t, ref, n, m, "make")
    check(float(t.S(7, 7)) == 0.0 and np.isneginf(float(t.S(3, 5)))
          and float(t.S(9, 1)) == float(t.S1(9)), "make: identities")
    asy = float(stirling.s_asympt(0.5, ref.lga1, torch.tensor(
        2.0e6, dtype=torch.float64), 5))
    check(abs(float(t.S(2 * 10 ** 6, 5)) - asy) < 1e-6 * abs(asy) + 5e-2,
          "make: the asymptote beyond max_n")

    check(t2.cols and (t2.n_max, t2.m_max) == (81920, 256),
          f"ensure(70000, 200): {t2.report()}")
    ref2 = plain_table(stirling, t2, t2.n_max, t2.m_max, 0.5, dev)
    n2 = np.concatenate([[70001, 81920, 65536, 200], rng.integers(
        1, 81921, 300), rng.integers(81921, 10 ** 6, 20)])
    m2 = np.concatenate([[200, 256, 100, 43], rng.integers(1, 257, 320)])
    m2[4:24] = n2[4:24] % 257
    w2 = check_queries(t2, ref2, n2, m2, "ensure")
    check(abs(float(t2.S(200, 43)) - 763.6337) < 1e-3, "ensure: S(200, 43)")

    check(t3.cols and float(t3.a) == np.float32(0.3), "remake")
    ref3 = plain_table(stirling, t3, 2000, t3.m_max, float(t3.a), dev)
    n3 = rng.integers(1, 2001, 300)
    m3 = rng.integers(1, 257, 300)
    w3 = check_queries(t3, ref3, n3, m3, "remake")

    check(not tw.cols and k2_make == 1, f"make(1000, 300): {tw.report()}")
    refw = plain_table(stirling, tw, 1000, 300, 0.5, dev)
    ww = check_queries(tw, refw, rng.integers(1, 1001, 300),
                       rng.integers(1, 301, 300), "make (1000, 300)")
    # an S-only table on K3's side of the route takes K3 and keeps no V
    check(s_only == {"fill_grid": 0, "fill_table": 0, "fill_table_cols": 1},
          f"make{S_ONLY}, build_v=False launched {s_only}")
    check(t_s.cols and t_s.vtab is None and t_s.srel is not None,
          f"S-only make: {t_s.report()}")
    refs = plain_table(stirling, t_s, *S_ONLY, 0.5, dev)
    ns_ = np.concatenate([[65535, 65535, 4096, 200], rng.integers(
        1, S_ONLY[0] + 1, 300), rng.integers(S_ONLY[0] + 1, 10 ** 6, 20)])
    ms_ = np.concatenate([[1024, 2, 1000, 43], rng.integers(1, 1025, 320)])
    ms_[4:24] = ns_[4:24] % 1025
    ws = check_queries(t_s, refs, ns_, ms_, "S-only make",
                       queries=("S", "Srel", "S1"))
    check(float(t_s.V(200, 43)) == 0.0, "S-only make: V is not 0")
    del refs
    torch.cuda.empty_cache()
    print(f"   S-only make{S_ONLY}: launches {s_only}, {s_only_s:.4f} s "
          f"(host clock, incl. S1), worst error / bound "
          f"{max(ws.values()):.3g}")
    print(f"   make {make_s:.3f} s, ensure to {t2.n_max} x {t2.m_max} "
          f"{ensure_s:.3f} s (host clock, incl. S1); worst error / bound: "
          f"make {max(w1.values()):.3g}, ensure {max(w2.values()):.3g}, "
          f"remake {max(w3.values()):.3g}, make (1000, 300) "
          f"{max(ww.values()):.3g}; S(200, 43) = {s_200_43:.6f} "
          f"[{card}]")
    done(t0)
    return launches


def phase8_crossover(dev, sc, stirling, card):
    """K2 against K3 at the CROSSOVER shapes; fill_route must pick one
    within 1.1x of the faster."""
    t0 = phase("8 K2 vs K3 crossover (CUDA events, median of 7, f32)")
    a32 = torch.tensor(0.5, device=dev)
    for n, m in CROSSOVER:
        k2 = cuda_ms(lambda: sc.fill_table_cuda(a32, n, m), 7)
        k3 = cuda_ms(lambda: sc.fill_table_cols_cuda(a32, n, m), 7)
        route = stirling.fill_route(dev, n, m)
        routed = k2 if route == "fill_table" else k3
        print(f"   ({n}, {m}): K2 {k2:.4f} ms, K3 {k3:.4f} ms; fill_route "
              f"-> {route} [{card}]")
        check(routed <= 1.1 * min(k2, k3),
              f"fill_route({n}, {m}) picks {route} at {routed:.4f} ms")
    done(t0)


def phase2d_wide(dev, sc, agrid, card):
    """K1 past 8192 columns, through make_grid, against the f64 plain
    fill under the bench-shape bounds."""
    G, N, M = WIDE_SHAPE
    t0 = phase(f"2d K1 past 8192 columns: make_grid at {WIDE_SHAPE}, and "
               f"{WIDE_RAGGED}")
    before = sc.LAUNCHES["fill_grid"]
    grid = agrid.make_grid(N, M, g=G, a_lo=0.25, a_hi=0.75, device=dev)
    torch.cuda.synchronize()
    check(sc.LAUNCHES["fill_grid"] == before + 1,
          "make_grid did not launch K1 once")
    check(tuple(grid.vtab.shape) == WIDE_SHAPE, "wide grid shape")
    v64, s64 = sc.fill_grid_ref(grid.avec.double(), N, M)
    v_rel, s_abs, _ = fill_errors(grid.vtab, grid.srel, v64, s64)
    del v64, s64
    k_ms = cuda_ms(lambda: sc.fill_grid_cuda(grid.avec, N, M), 3)
    b_ms, b_by = bound(G * N * M, 4)
    print(f"   {WIDE_SHAPE} f32: V max rel err {v_rel:.6g}, max |dSrel| "
          f"{s_abs:.6g}; K1 {k_ms:.4f} ms (median of 3) = "
          f"{100 * b_ms / k_ms:.2f}% of its bound {b_ms:.4f} ms ({b_by}) "
          f"[{card}]")
    check(v_rel < 1e-4 and s_abs <= 5e-2,
          f"K1 at {WIDE_SHAPE}: V rel {v_rel:.3g} (< 1e-4), |dSrel| "
          f"{s_abs:.3g} (<= 5e-2)")
    del grid
    torch.cuda.empty_cache()
    G, N, M = WIDE_RAGGED
    avec = torch.linspace(0.0, 0.9, G, dtype=torch.float64, device=dev)
    e64 = sc.fill_grid_ref(avec, N, M)
    for dt, v_tol, s_tol in ((torch.float32, 2e-5, 1e-4),
                             (torch.float64, 1e-12, 1e-10)):
        v, s = sc.fill_grid_cuda(avec.to(dt), N, M)
        e_v, _, _ = fill_errors(v, s, *e64)
        e_s = max(scaled_err(s[g], e64[1][g]) for g in range(G))
        check(e_v < v_tol and e_s < s_tol,
              f"K1 {dt} at {WIDE_RAGGED}: V rel {e_v:.3g}, scaled |dSrel| "
              f"{e_s:.3g}")
    done(t0)


def gate_seed(dev, agrid, driver, pyp, ref, seed, cfg):
    """One seed of the gate: run_gibbs (f32, on the card) at the reference's
    configuration against its CPU-f64 posterior moments, within 2 combined
    MC-SE plus the floors 0.05 / 0.01 / 0.05.  Returns (all moments inside
    their bands, run_gibbs wall seconds, the run's output)."""
    r = ref["seeds"][seed]
    data = pyp.crp_generate(int(seed), *ref["data_args"])
    check(np.array_equal(data.n, np.asarray(r["n"])),
          f"seed {seed}: crp_generate differs from the reference data")
    n_max = max(int(data.N.max()) + 2, 16)
    grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    out = driver.run_gibbs(gen, data, grid, ref["chains"], ref["a0"],
                           ref["b0"], cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    ok = within_bands(r, out, f"seed {seed}")
    out["grid"], out["data"] = grid, data
    return ok, run_s, out


def within_bands(r, out, label):
    """The run's per-chain E[T_j], E[a], E[b] against the reference ``r``:
    |difference| within 2 combined MC-SE plus the floors 0.05 / 0.01 /
    0.05 (tools/oracle_compare.compare()).  Prints each; returns whether
    all hold."""
    ours = dict(T=out["Tave"].double().cpu().numpy(),
                a=out["aave"].double().cpu().numpy()[:, None],
                b=out["bave"].double().cpu().numpy()[:, None])
    ok = True
    for name, floor in (("T", 0.05), ("a", 0.01), ("b", 0.05)):
        vals = ours[name]
        om = vals.mean(0)
        osd = vals.std(0, ddof=1) / np.sqrt(len(vals))
        rm = np.asarray(r[name]["mean"])
        rs = np.asarray(r[name]["se"])
        band = 2 * np.sqrt(rs ** 2 + osd ** 2) + floor
        good = bool(np.all(np.abs(rm - om) <= band))
        ok &= good
        print(f"   {label} E[{name}]: ref={np.round(rm, 4)} "
              f"ours={np.round(om, 4)} band={np.round(band, 4)} -> "
              f"{'OK' if good else 'MISMATCH'}")
    return ok


def phase9_ars(dev, sc, agrid, driver, pyp, card, ref, slice_s):
    """The ARS Gibbs path on the card; returns the kernels' launches."""
    from libstb_tpu_torch.samplers import ars, hyper

    t0 = phase(f"9 ARS Gibbs path: run_gibbs(kernel=\"ars\"), seed "
               f"{ARS_SEED}, {ARS_ITERS} iterations, vs the JAX CPU-f64 "
               "moments")
    cfg = driver.GibbsConfig(**dict(ref["config"], iters=ARS_ITERS,
                                    kernel="ars"))
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    stats = dict(calls=0, chains=zero, gave_up=zero, neval=zero)
    ars_sample = ars.ars_sample

    def counted(*args, with_info=False, **kw):
        x, ok, nev = ars_sample(*args, with_info=True, **kw)
        stats["calls"] += 1
        stats["chains"] = stats["chains"] + ok.numel()
        stats["gave_up"] = stats["gave_up"] + (~ok).sum()
        stats["neval"] = stats["neval"] + nev.sum()
        return (x, ok, nev) if with_info else (x, ok)

    reset_launches(sc)
    ars.ars_sample = counted
    try:
        ok, run_s, out = gate_seed(dev, agrid, driver, pyp, ref, ARS_SEED,
                                   cfg)
    finally:
        ars.ars_sample = ars_sample
    launches = dict(sc.LAUNCHES)
    check(ok, "ARS run: a posterior moment is outside its band")
    check(launches["fill_grid"] >= 1, "the ARS run did not launch K1")
    e_v, e_s = check_grid(sc, out["grid"], "the ARS run's grid")
    print(f"   the run's grid {tuple(out['grid'].srel.shape)} vs the f64 "
          f"plain fill: V rel {e_v:.3g}, scaled |dSrel| {e_s:.3g}")
    chains, gave_up, neval = (int(stats[k]) for k in ("chains", "gave_up",
                                                      "neval"))
    check(stats["calls"] == -(-cfg.iters // cfg.bcycle)
          + -(-cfg.iters // cfg.acycle),
          f"ARS calls {stats['calls']}: sample_a / sample_b did not both "
          "go through ars_sample")
    check(gave_up == 0, f"{gave_up} of {chains} ARS draws hit the reject cap")
    print(f"   run_gibbs wall {run_s:.3f} s = {1e3 * run_s / cfg.iters:.2f} "
          f"ms an iteration (slice kernel, phase 4: "
          f"{np.round(slice_s, 3).tolist()} s a seed of "
          f"{ref['config']['iters']} iterations); launches {launches}; "
          f"{stats['calls']} ARS calls, {gave_up} of {chains} draws gave "
          f"up, {neval / chains:.3f} density evaluations a draw [{card}]")

    # one (a, b) move by either kernel on the run's final state, as the
    # driver calls them
    grid, data = out["grid"], out["data"]
    C = ref["chains"]
    dt = grid.srel.dtype
    t, T, a, b = out["t"], out["T"], out["a"], out["b"]
    gen = torch.Generator(device=dev).manual_seed(3)
    ns_flat = torch.as_tensor(data.n.reshape(-1), device=dev)
    N_b = torch.as_tensor(data.N[: cfg.b_groups], dtype=dt, device=dev)
    for kernel in ("slice", "ars"):
        b_ms = host_ms(lambda: hyper.sample_b(
            gen, b, N_b, T[:, : cfg.b_groups].to(dt), a, cfg.shape, cfg.scale,
            kernel=kernel), 20)
        a_ms = host_ms(lambda: hyper.sample_a(
            gen, a, grid, ns_flat, t.reshape(C, -1), T.to(dt),
            b[:, None].expand(T.shape), kernel=kernel), 20)
        print(f"   kernel={kernel}: sample_b {b_ms:.3f} ms, sample_a "
              f"{a_ms:.3f} ms a call (host clock, mean of 20) [{card}]")
    done(t0)
    return launches


def config_totals(ns, ts):
    """(customers, tables) a table configuration of the pairs (ns, ts)
    holds, per chain: pairs with 1 < t < n seat all n customers at t
    tables, t == 1 pairs seat n at one, t == n pairs (all singletons) are
    left out."""
    active = (ts > 1) & (ts < ns)
    one = ts == 1
    return ((ns * (active | one)).sum(1),
            (ts * active).sum(1) + one.sum(1))


def phase10c_ti_kernel(dev, agrid, pyp, ti_cuda, data, card):
    """The TI sweep's kernel against its plain loop at the Quick-start's
    shape: the grid route, bitwise over 3 sweeps, then the times of both
    routes (the rows route is the one a grid took before the grid route:
    ti.prepare builds the V rows and the kernel gathers from them)."""
    C = 16384
    grid = agrid.make_grid(512, 128, g=64, device=dev)
    plan = pyp.ti_plan(data, pyp.ti_schedule(data, "group"), dev)
    t, T = pyp.init_state(data, C, dev)
    a = torch.linspace(0.15, 0.85, C, device=dev)
    b = torch.full((C,), 10.0, device=dev)
    check(pyp.ti_route(grid, plan, a.dtype) == "grid",
          "the Quick-start's grid does not take the grid route")
    before = dict(ti_cuda.LAUNCHES)
    for k in range(3):
        ref = pyp._ti_run_ref(torch.Generator(device=dev).manual_seed(20 + k),
                              t, T, a, b, grid, plan, True, False)
        got = pyp._ti_run(torch.Generator(device=dev).manual_seed(20 + k), t,
                          T, a, b, grid, plan, True, False)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
              f"the TI kernel differs from the plain loop in sweep {k}")
        check(not torch.equal(got[0], t), f"sweep {k} moved no count")
        t, T = got
    gen = torch.Generator(device=dev).manual_seed(30)
    live, nf, H, vrows, u = pyp._ti_prepare(gen, t, a, grid, plan, True)
    k_ms = cuda_ms(lambda: ti_cuda.ti_sweep(t, T, a, b, None, u, plan, live,
                                            nf, H, False, grid=grid), 21)
    rows_k_ms = cuda_ms(lambda: ti_cuda.ti_sweep(t, T, a, b, vrows, u, plan,
                                                 live, nf, H, False), 21)
    sweep_ms = host_ms(lambda: pyp._ti_run(gen, t, T, a, b, grid, plan, True,
                                           False), 20)

    def rows_sweep():
        p = pyp._ti_prepare(gen, t, a, grid, plan, True)
        return ti_cuda.ti_sweep(t, T, a, b, p[3], p[4], plan, *p[:3], False)

    rows_ms = host_ms(rows_sweep, 20)
    ref_ms = host_ms(lambda: pyp._ti_run_ref(gen, t, T, a, b, grid, plan,
                                             True, False), 5)
    counts = {k: n - before[k] for k, n in ti_cuda.LAUNCHES.items()}
    check(counts == {"ti_sweep": 21 + 20, "ti_sweep_grid": 3 + 21 + 20,
                     "ti_grid_v": 0},
          f"44 grid-route and 41 rows-route sweeps launched {counts}")
    S, W = plan.flat.shape
    # the uniforms once and t and T read and written once; the rows route
    # adds a 32-byte sector of V a lane-step, the grid route's taps come
    # from L2
    nbytes = u.numel() * u.element_size() + 2 * 4 * (t.numel() + T.numel())
    rows_bytes = nbytes + 32 * S * C * W
    bound_ms, rows_bound_ms = (x / HBM_BPS * 1e3 for x in (nbytes,
                                                           rows_bytes))
    geo = ti_cuda.sweep_plan(C, W, t[0].numel(), T.shape[1])
    print(f"   TI kernel at (S={S}, C={C}, W={W}) f32, CUDA events, median "
          f"of 21: grid route {k_ms:.4f} ms = {100 * bound_ms / k_ms:.2f}% "
          f"of its byte bound {bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB); "
          f"rows route {rows_k_ms:.4f} ms = "
          f"{100 * rows_bound_ms / rows_k_ms:.2f}% of {rows_bound_ms:.4f} ms"
          f" ({rows_bytes / 1e6:.1f} MB). The whole sweep (ti.prepare + "
          f"kernel, host clock, mean of 20): grid route {sweep_ms:.4f} ms, "
          f"rows route {rows_ms:.4f} ms (PERF.md section 6 row 10 has both "
          f"as measured on an H100); the plain loop {ref_ms:.4f} ms (mean "
          f"of 5); geometry {geo}; launches by route {counts} [{card}]")
    return k_ms


def phase10e_slice_kernel(dev, card):
    """The slice moves' kernel (csrc/slice_move.cu) against its plain
    version slice_move_ref at the cells' shapes, both densities, f32 and
    f64, on tests/test_torch_slice_kernel.py's inputs: x and ok equal on
    >= 99.9% of the chains, the rest within the rounding of the level; a
    launch a batch; then the times of a move by the kernel, by
    slice_move_ref and by the per-try loop, and of a launch beside its
    byte bound."""
    from libstb_tpu_torch.core import rng
    from libstb_tpu_torch.ops import slice_cuda
    from libstb_tpu_torch.samplers import slice as slicemod
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import test_torch_slice_kernel as tsk
    rows = []
    for density in ("b", "a"):
        for C, I in tsk.SHAPES:
            for dt in (torch.float32, torch.float64):
                eps = torch.finfo(dt).eps
                m = tsk.move_inputs(density, C, I, dt, dev, seed=40 + I)
                draws = []
                real = rng.uniform

                def counted(*args, **kw):
                    draws.append(None)
                    return real(*args, **kw)

                before = slice_cuda.LAUNCHES["slice_move"]
                rng.uniform = counted
                try:
                    got = m.kernel(torch.Generator(device=dev).manual_seed(7))
                finally:
                    rng.uniform = real
                torch.cuda.synchronize()
                launches = slice_cuda.LAUNCHES["slice_move"] - before
                batches = -(-(len(draws) - 1) // slice_cuda.K)
                ref = slice_cuda.slice_move_ref(
                    m.logpost, torch.Generator(device=dev).manual_seed(7),
                    m.x0, m.lo, m.hi)
                u0 = torch.rand((C,), generator=torch.Generator(device=dev)
                                .manual_seed(7), dtype=dt, device=dev)
                share, gap = tsk.agreement(m.logpost, m.scale, m.x0, u0, got,
                                           ref)
                print(f"   slice move {density} ({C}, {I}) {dt}: x and ok "
                      f"equal on {100 * share:.3f}% of chains, worst level "
                      f"gap {gap / eps:.3g} eps of the terms, ok "
                      f"{100 * float(got[1].double().mean()):.2f}%, "
                      f"{launches} launches, {batches} batches")
                check(share >= 0.999, f"slice move {density} ({C}, {I}) "
                      f"{dt}: {100 * share:.3f}% of chains as the plain "
                      "version (< 99.9%)")
                check(gap <= 64 * eps, f"slice move {density} ({C}, {I}) "
                      f"{dt}: a differing chain {gap / eps:.3g} eps below "
                      "the level")
                check(launches == batches, f"{batches} batches launched the "
                      f"slice kernel {launches} times")
                if dt != torch.float32:
                    continue
                gen = torch.Generator(device=dev).manual_seed(8)
                k_host = host_ms(lambda: m.kernel(gen), 20)
                k_dev = cuda_ms(lambda: m.kernel(gen), 21)
                r_host = host_ms(lambda: slice_cuda.slice_move_ref(
                    m.logpost, gen, m.x0, m.lo, m.hi), 5)
                p_host = host_ms(lambda: slicemod.slice_sample(
                    m.logpost, gen, m.x0, m.lo, m.hi), 5)
                # each launch's device time, a CUDA-event pair around it
                pairs, real_launch = [], slice_cuda._launch

                def timed(*args, **kw):
                    ev = [torch.cuda.Event(enable_timing=True)
                          for _ in range(2)]
                    ev[0].record()
                    real_launch(*args, **kw)
                    ev[1].record()
                    pairs.append(ev)

                slice_cuda._launch = timed
                try:
                    for _ in range(21):
                        m.kernel(gen)
                finally:
                    slice_cuda._launch = real_launch
                torch.cuda.synchronize()
                one = float(np.median([p[0].elapsed_time(p[1])
                                       for p in pairs]))
                bound = m.nbytes / HBM_BPS * 1e3
                print(f"   slice move {density} ({C}, {I}) f32: kernel "
                      f"move {k_host:.4f} ms host / {k_dev:.4f} ms device "
                      f"(mean of 20 / median of 21, draws and read "
                      f"included); a launch of up to K = {slice_cuda.K} "
                      f"tries {one:.4f} ms (CUDA events, median of "
                      f"{len(pairs)}) = {100 * bound / one:.2f}% of its byte "
                      f"bound {bound * 1e3:.3f} us ({m.nbytes / 1e6:.2f} MB)"
                      f"; slice_move_ref {r_host:.4f} ms, per-try loop "
                      f"{p_host:.4f} ms (host, mean of 5) [{card}]")
                rows.append(dict(density=density, C=C, I=I, move_ms=k_host,
                                 move_dev_ms=k_dev, launch_ms=one,
                                 bound_ms=bound, ref_ms=r_host,
                                 loop_ms=p_host))
    return rows


def phase10_hyper(dev, sc, agrid, stirling, pyp, card):
    """The hyperparameter layer on a single table; returns the kernels'
    launches."""
    from libstb_tpu_torch.core import special
    from libstb_tpu_torch.ops import slice_cuda, ti_cuda
    from libstb_tpu_torch.samplers import hyper

    reset_launches(sc, ti_cuda, slice_cuda)
    C, P, max_n, max_t = CONFIG_SHAPE
    t0 = phase(f"10a sample_table_config on make(2048, 64) (K3): {C} chains "
               f"x {P} pairs, n < {max_n}, t < {max_t}")
    r = np.random.default_rng(10)
    tab = stirling.make(2048, 64, 2048, 64, 0.5, device=dev)
    check(tab.cols and sc.LAUNCHES["fill_table_cols"] == 1,
          f"make(2048, 64) did not take K3: {tab.report()}")
    worst = check_queries(
        tab, plain_table(stirling, tab, 2048, 64, 0.5, dev),
        np.concatenate([[2048, 2048, 64], r.integers(1, 2049, 400)]),
        np.concatenate([[64, 1, 64], r.integers(1, 65, 400)]),
        "make(2048, 64)")
    ns = torch.as_tensor(r.integers(1, max_n, (C, P)), device=dev)
    ts = torch.minimum(torch.as_tensor(r.integers(1, max_t, (C, P)),
                                       device=dev), ns)
    a = torch.full((C,), 0.5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(10)
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    hist = hyper.sample_table_config(gen, tab, ns, ts, a, max_t, max_n)
    torch.cuda.synchronize()
    cfg_ms = (time.perf_counter() - t_run) * 1e3
    want_n, want_t = config_totals(ns, ts)
    sizes = torch.arange(max_n + 1, device=dev, dtype=torch.float64)
    got_n = (hist.double() * sizes).sum(1)
    got_t = hist.double().sum(1)
    check(bool((got_n == want_n).all() and (got_t == want_t).all()),
          "sample_table_config: customer or table totals differ from the "
          "closed forms")
    check(bool((hist >= 0).all() and (hist == hist.round()).all()),
          "sample_table_config: counts are not whole numbers")
    print(f"   {int(want_t.sum())} tables seating {int(want_n.sum())} "
          f"customers, totals exact in all {C} chains; one call "
          f"{cfg_ms:.1f} ms (host clock, {max_t - 1} peel steps); the table's "
          f"worst query error / bound {max(worst.values()):.3g} [{card}]")
    del hist, ns, ts
    done(t0)

    t0 = phase("10b sample_table_config and sample_a_m on make(64, 12) "
               "(K3) vs on a grid with its discount as a node, same draws")
    r = np.random.default_rng(3)
    C, P = 64, 16
    ns_h = r.integers(2, 25, (C, P))
    ts_h = np.maximum(1, (ns_h * 0.4).astype(np.int64))
    ns = torch.as_tensor(ns_h, device=dev)
    ts = torch.as_tensor(ts_h, device=dev)
    T = torch.as_tensor(ts_h.sum(1, keepdims=True), dtype=torch.float32,
                        device=dev)
    b = torch.full((C, 1), 5.0, device=dev)
    k3 = sc.LAUNCHES["fill_table_cols"]
    tab = stirling.make(64, 12, 64, 12, 0.5, device=dev)
    check(tab.cols and sc.LAUNCHES["fill_table_cols"] == k3 + 1,
          f"make(64, 12) did not take K3: {tab.report()}")
    worst = check_queries(tab, plain_table(stirling, tab, 64, 12, 0.5, dev),
                          r.integers(1, 65, 300), r.integers(1, 13, 300),
                          "make(64, 12)")
    grid = agrid.make_grid(64, 12, g=100, device=dev)
    node = int(torch.argmin((grid.avec - 0.5).abs()))
    check(abs(float(grid.avec[node]) - 0.5) < 1e-6,
          "the grid has no node at a = 0.5")
    e_v, e_s = check_grid(sc, grid, "phase 10b")
    # the two tables hold one discount's S to f32 rounding, so under one
    # seed the Gumbel-max draws pick the same sizes but for a tie within
    # that rounding (~1e-6 of ~10^4 draws): at most 2 chains may differ
    a = torch.full((C,), 0.5, device=dev)
    hists, moves = [], []
    for table in (tab, grid):
        gen = torch.Generator(device=dev).manual_seed(11)
        hists.append(hyper.sample_table_config(gen, table, ns, ts, a, 12, 32))
        gen = torch.Generator(device=dev).manual_seed(12)
        x, ok = hyper.sample_a_m(gen, a, table, ns, ts, T, b, max_t=12,
                                 max_n=32)
        check(bool(ok.all()), "sample_a_m: a slice move gave up")
        moves.append(x)
    h_diff = int((hists[0] != hists[1]).any(1).sum())
    a_diff = int(((moves[0] - moves[1]).abs() > 1e-6).sum())
    check(bool((moves[0] != 0.5).any()), "sample_a_m did not move a")
    print(f"   chains whose histogram differs {h_diff}, whose a differs "
          f"{a_diff}, of {C} (at most 2 each); E[a] after the move "
          f"{float(moves[0].mean()):.4f}; make(64, 12) worst query error / "
          f"bound {max(worst.values()):.3g}; grid V rel {e_v:.3g}, scaled "
          f"|dSrel| {e_s:.3g}")
    check(h_diff <= 2 and a_diff <= 2,
          "the config route on the K3 table and on the grid disagree under "
          "the same draws")
    done(t0)

    t0 = phase("10c ti_sweep_blocked on a StirlingTable (K2) vs on a grid "
               "with its discount as a node")
    data = pyp.crp_generate(0, 4, 20, 100, 0.5, 10.0)
    n_req = int(data.n.max()) + 2
    k2 = sc.LAUNCHES["fill_table"]
    tab = stirling.make(n_req, n_req, n_req, n_req, 0.5, device=dev)
    check(not tab.cols and sc.LAUNCHES["fill_table"] == k2 + 1,
          f"make({n_req}, {n_req}) did not take K2: {tab.report()}")
    r = np.random.default_rng(12)
    worst = check_queries(
        tab, plain_table(stirling, tab, tab.n_max, tab.m_max, 0.5, dev),
        r.integers(1, tab.n_max + 1, 300), r.integers(1, tab.m_max + 1, 300),
        f"make({n_req}, {n_req})")
    grid = agrid.make_grid(n_req, n_req, g=100, device=dev)
    e_v, e_s = check_grid(sc, grid, "phase 10c")
    print(f"   make({n_req}, {n_req}) worst query error / bound "
          f"{max(worst.values()):.3g}; grid {tuple(grid.srel.shape)} V rel "
          f"{e_v:.3g}, scaled |dSrel| {e_s:.3g}")
    node = int(torch.argmin((grid.avec - 0.5).abs()))
    check(abs(float(grid.avec[node]) - 0.5) < 1e-6,
          "the grid has no node at a = 0.5")
    C, sweeps, burn = 256, 120, 40
    a = torch.full((C,), 0.5, device=dev)
    b = torch.full((C,), 10.0, device=dev)
    occ = torch.as_tensor((data.n > 0).sum(axis=1), device=dev)
    tot = torch.as_tensor(data.N, device=dev)
    means = {}
    for seed, name, table in ((12, "table", tab), (13, "grid", grid)):
        gen = torch.Generator(device=dev).manual_seed(seed)
        plan = pyp.ti_plan(data, pyp.ti_schedule(data, "group"), dev)
        t, T = pyp.init_state(data, C, dev)
        acc = torch.zeros(T.shape, dtype=torch.float64, device=dev)
        for it in range(sweeps):
            t, T = pyp.ti_sweep_blocked(gen, t, T, a, b, table, data,
                                        sched=plan)
            check(bool(((T >= occ) & (T <= tot)).all()),
                  f"{name}: T_j outside [occupied categories, N_j]")
            if it >= burn:
                acc += T
        check(bool((t.sum(-1) == T).all()), f"{name}: sum_i t_ji != T_j")
        means[name] = (acc / (sweeps - burn)).cpu().numpy()
    mt, mg = means["table"], means["grid"]
    se = np.sqrt(mt.var(0, ddof=1) / C + mg.var(0, ddof=1) / C)
    diff = np.abs(mt.mean(0) - mg.mean(0))
    print(f"   E[T_j]: table {np.round(mt.mean(0), 3).tolist()}, grid "
          f"{np.round(mg.mean(0), 3).tolist()}, |diff| "
          f"{np.round(diff, 3).tolist()} vs 3 SE + 0.05 = "
          f"{np.round(3 * se + 0.05, 3).tolist()}")
    check(bool(np.all(diff <= 3 * se + 0.05)),
          "the sweep on the single table and on the grid disagree on E[T_j]")
    routes = tuple(ti_cuda.LAUNCHES[k] for k in ("ti_sweep", "ti_sweep_grid"))
    check(routes == (sweeps, sweeps),
          f"{sweeps} sweeps on the table and {sweeps} on the grid launched "
          f"the TI kernel {routes} times (rows route, grid route)")
    phase10c_ti_kernel(dev, agrid, pyp, ti_cuda, data, card)
    done(t0)

    t0 = phase(f"10d special functions at {SPECIAL_POINTS} points; "
               "data_curve_sparse at 2^18 + 5 pairs")
    x64 = torch.exp(torch.empty(SPECIAL_POINTS, dtype=torch.float64, device=dev)
                    .uniform_(np.log(0.01), np.log(1e4),
                              generator=torch.Generator(device=dev)
                              .manual_seed(13)))
    # f64 to 2e-9 relative (torch.special's own f64 polygamma series is
    # good to ~5e-10), f32 to 2e-5, which is what the series gives in f32;
    # + 1e-12 / 2e-5 absolute for digamma beside its root at 1.4616
    for dt, rtol, atol in ((torch.float64, 2e-9, 1e-12),
                           (torch.float32, 2e-5, 2e-5)):
        x = x64.to(dt)
        ref_in = x.double()                  # the point the f32 call saw
        for name in ("digamma", "trigamma"):
            got = getattr(special, name)(x)
            check(got.dtype == dt, f"special.{name} changed the dtype")
            ref = (torch.special.digamma(ref_in) if name == "digamma"
                   else torch.special.polygamma(1, ref_in))
            err = ((got.double() - ref).abs()
                   / (rtol * ref.abs() + (atol if name == "digamma"
                                          else 0.0))).max().item()
            print(f"   special.{name} {dt}: worst error / bound {err:.3g}")
            check(err <= 1.0, f"special.{name} {dt} off by {err:.3g} x its "
                  "bound")
        # digamma_inv: psi(digamma_inv(y)) = y, to 1e-10 / 1e-5 of 1 + |y|
        y = torch.special.digamma(x64).to(dt)
        back = torch.special.digamma(special.digamma_inv(y).double())
        tol = 1e-10 if dt == torch.float64 else 1e-5
        err = ((back - y.double()).abs() / (tol * (1 + y.double().abs()))
               ).max().item()
        print(f"   special.digamma_inv {dt}: worst error / bound {err:.3g}")
        check(err <= 1.0, f"special.digamma_inv {dt} off by {err:.3g} x its "
              "bound")
    x32 = x64.float()
    print(f"   digamma at {SPECIAL_POINTS} f32 points: special "
          f"{cuda_ms(lambda: special.digamma(x32), 5):.4f} ms, "
          f"torch.special {cuda_ms(lambda: torch.special.digamma(x32), 5):.4f}"
          f" ms (CUDA events, median of 5) [{card}]")
    del x64, x32
    r = np.random.default_rng(14)
    P = (1 << 18) + 5
    ns = torch.as_tensor(r.integers(0, 65, P), device=dev)
    ts = torch.minimum(torch.as_tensor(r.integers(0, 65, (4, P)),
                                       device=dev), ns.clamp(min=1))
    # the chunked sum regroups 262149 terms: f32 to 1e-4, f64 to 1e-10
    for dt, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        g = agrid.make_grid(64, 64, g=32, dtype=dt, device=dev)
        check_grid(sc, g, "phase 10d")
        dense = g.data_curve(ns, ts)
        sparse = g.data_curve_sparse(ns, ts, chunk=50000)
        check(sparse.shape == dense.shape == (4, 32), "curve shape")
        err = ((sparse - dense).abs() / dense.abs()).max().item()
        print(f"   data_curve_sparse vs data_curve {dt}: max rel diff "
              f"{err:.3g}")
        check(err < rtol, f"data_curve_sparse {dt} off by {err:.3g}")
    done(t0)

    t0 = phase("10e the slice moves' kernel vs slice_move_ref at the "
               "cells' shapes")
    phase10e_slice_kernel(dev, card)
    done(t0)
    return {**sc.LAUNCHES, **ti_cuda.LAUNCHES, **slice_cuda.LAUNCHES}


def check_state(t, T, n, what):
    """Exact invariants of a (C, J, D) table-count state: T_j = sum_i
    t_ji, 1 <= t <= n on occupied pairs, t = 0 elsewhere."""
    n = torch.as_tensor(n, device=t.device)[None]
    check(bool(torch.equal(t.sum(-1, dtype=torch.int32), T)),
          f"{what}: T_j != sum_i t_ji")
    check(bool(torch.where(n > 0, (t >= 1) & (t <= n), t == 0).all()),
          f"{what}: t outside [1, n] on an occupied pair, or not 0 off one")


def phase11_check(dev, sc, agrid, driver, pyp, card, ref):
    """The check.c samplers through run_gibbs on the card against the JAX
    CPU-f64 moments, and SA on the host against fixed-(a, b) HSA and CT
    runs; returns K1's launches on the main path."""
    from libstb_tpu_torch.models import sa

    t0 = phase(f"11 check.c multi-sampler gate: run_gibbs "
               f"{'/'.join(ref['samplers'])} (f32, {ref['chains']} chains, "
               f"{ref['config']['iters']} iterations) vs the JAX CPU-f64 "
               "moments; SA vs fixed-(a, b) HSA and CT")
    reset_launches(sc)
    ok, runs = True, []
    for sampler, r in ref["samplers"].items():
        data = pyp.crp_generate(r["seed"], *ref["data_args"])
        check(np.array_equal(data.n, np.asarray(r["n"])),
              f"{sampler}: crp_generate differs from the reference data")
        n_max = max(int(data.N.max()) + 2, 16)
        grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], device=dev)
        cfg = driver.GibbsConfig(sampler=sampler, **ref["config"])
        gen = torch.Generator(device=dev).manual_seed(r["seed"] + 2)
        torch.cuda.synchronize()
        t_run = time.perf_counter()
        out = driver.run_gibbs(gen, data, grid, ref["chains"], ref["a0"],
                               ref["b0"], cfg)
        torch.cuda.synchronize()
        runs.append((sampler, time.perf_counter() - t_run, cfg.iters, out,
                     grid, data))
        ok &= within_bands(r, out, sampler)
    launches = dict(sc.LAUNCHES)
    check(ok, "check.c gate: a posterior moment is outside its band")
    check(launches["fill_grid"] >= 1, "the check.c gate did not launch K1")
    for sampler, run_s, iters, out, grid, data in runs:
        check_state(out["t"], out["T"], data.n, sampler)
        if sampler == "HSA":
            h = out["hist"]
            sizes = torch.arange(h.shape[-1], device=dev)
            check(bool(torch.equal(h.sum(-1, dtype=torch.int32), out["t"])
                       and torch.equal((h * sizes).sum(-1), torch.as_tensor(
                           data.n, device=dev).long().expand(h.shape[:-1]))
                       and (h >= 0).all()),
                  "HSA: the histogram does not seat n_ji customers at t_ji "
                  "tables")
        e_v, e_s = check_grid(sc, grid, f"phase 11 {sampler}")
        print(f"   {sampler}: run_gibbs {1e3 * run_s / iters:.3f} ms an "
              f"iteration ({run_s:.3f} s / {iters}); grid "
              f"{tuple(grid.srel.shape)} V rel {e_v:.3g}, scaled |dSrel| "
              f"{e_s:.3g} [{card}]")

    # SA (exact explicit seating, host) against the card's HSA and CT at
    # fixed (a, b): tests/test_sa.py's data and band, 6 SE + 0.15
    data = pyp.crp_generate(11, 1, 5, 30, 0.5, 1.0)
    t_run = time.perf_counter()
    T_sa = float(sa.sa_run(data, iters=3000, a=0.5, b=1.0,
                           seed=3)["Tave"].sum())
    sa_s = time.perf_counter() - t_run
    grid = agrid.make_grid(48, 36, g=100, device=dev)
    C = 256
    for name in ("HSA", "CT"):
        out = driver.run_gibbs(torch.Generator(device=dev).manual_seed(4),
                               data, grid, C, 0.5, 1.0,
                               driver.GibbsConfig(iters=160, sampler=name))
        Tave = out["Tave"].double().sum(1).cpu().numpy()
        m, se = Tave.mean(), Tave.std() / np.sqrt(C)
        good = abs(m - T_sa) < 6 * se + 0.15
        print(f"   fixed (a, b): SA E[T] {T_sa:.4f} ({sa_s:.2f} s host, 3000 "
              f"sweeps), {name} {m:.4f} +- {se:.4f} -> "
              f"{'OK' if good else 'MISMATCH'}")
        check(good, f"{name} disagrees with SA: {m:.4f} vs {T_sa:.4f}")
    print(f"   launches on the gate's path: {launches}")
    done(t0)
    return launches


# check.c scale (check.c:83 MAXDATA = 10^5; bench.py:143-204): 100 groups x
# 1000 items, 20 categories, 32 chains, four sweeps of each sampler
CHECKC_DATA = (1, 100, 20, 1000, 0.5, 10.0)
CHECKC_CHAINS, CHECKC_SWEEPS, CHECKC_WINDOW = 32, 4, 10


def profile_sweep(fn, top=0):
    """(device operations, device-busy ms, wall ms) of one call of ``fn``
    under torch.profiler (kernels, copies and fills on the one stream),
    or None where the profiler sees no device; with ``top`` also the
    ``top`` operators by the device time of their own kernels, as (name,
    ms, calls)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_run = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_run) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    if not top:
        return len(kernels), busy, wall
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.self_device_time_total > 0]
    return len(kernels), busy, wall, sorted(ops, key=lambda o: -o[1])[:top]


def phase12_checkc(dev, sc, stirling, pyp, card):
    """The check.c-scale sweeps on a K2 table: pair-major TI, relative-
    window CTW and pair-major HSA, timed, their state invariants exact,
    TI and CTW replayed through the same sweeps on the CPU in f64; returns
    the kernels' launches on the main path."""
    from libstb_tpu_torch.core import rng

    C, sweeps, w = CHECKC_CHAINS, CHECKC_SWEEPS, CHECKC_WINDOW
    t0 = phase(f"12 check.c scale: crp_generate{CHECKC_DATA}, {C} chains, "
               f"{sweeps} sweeps each of pair TI, CTW (w = {w}) and pair "
               "HSA on a stirling.make table")
    t_run = time.perf_counter()
    data = pyp.crp_generate(*CHECKC_DATA)
    gen_s = time.perf_counter() - t_run
    L = int(data.data_cat.size)
    J, D = data.n.shape
    n_max = int(data.n.max()) + 2
    m_max = min(n_max, 1024)
    f32 = dict(dtype=torch.float32, device=dev)
    a = torch.full((C,), 0.5, **f32)
    b = torch.full((C,), 10.0, **f32)
    jvec, ivec, nvec = pyp.ti_pair_layout(data)
    order, stages = pyp.ti_pair_stages(nvec)
    jv, iv, nv = jvec[order], ivec[order], nvec[order]
    h_order, h_stages = pyp.ti_pair_stages(nvec, skip_first=False)
    jl, il = (torch.as_tensor(x, device=dev).long() for x in (jv, iv))
    t_init, T_init = pyp.init_state(data, C, dev)
    gen = torch.Generator(device=dev).manual_seed(12)

    def timed(step, state):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(sweeps):
            state = step(state)
        end.record()
        torch.cuda.synchronize()
        return state, start.elapsed_time(end)

    # -- the main path: make (K2) and the sweeps ----------------------------
    reset_launches(sc)
    tab = stirling.make(n_max, m_max, n_max + 64, m_max + 64, 0.5,
                        use_asympt=True, device=dev)
    m_ti = pyp.ti_pair_m_sel(tab, nv)
    m_ctw = pyp.ctw_m_sel(tab, data, window=w)

    def ti_step(s):
        return pyp.ti_sweep_pairs_staged(gen, s[0], s[1], a, b, tab, data,
                                         jv, iv, nv, stages, m_sel=m_ti)

    def ctw_step(s):
        return pyp.ctw_sweep_rel(gen, s[0], s[1], a, b, tab, data, window=w,
                                 m_sel=m_ctw)

    def hsa_step(s):
        return pyp.hsa_sweep_pairs_staged(gen, s[0], s[1], a, b, data,
                                          jvec[h_order], ivec[h_order],
                                          nvec[h_order], h_stages)

    hp0, hT0 = pyp.init_hsa_pairs(data, C, dev, order=h_order)
    states, ms = {}, {}
    for name, step, state in (("TI pairs", ti_step, (t_init[:, jl, il],
                                                     T_init)),
                              ("CTW rel", ctw_step, (t_init, T_init)),
                              ("HSA pairs", hsa_step, (hp0, hT0))):
        step(state)                      # first call: allocator, lazy init
        states[name], ms[name] = timed(step, state)
    launches = dict(sc.LAUNCHES)
    check(not tab.cols and launches["fill_table"] == 1,
          f"make({n_max}, {m_max}) did not take K2: {tab.report()}, "
          f"launches {launches}")
    check(m_ti == m_ctw == n_max - 1, f"m_sel {m_ti} / {m_ctw}: the row route "
          "is off on the check.c table")

    # -- the table against its plain-f64 version -----------------------------
    ref = plain_table(stirling, tab, n_max, m_max, 0.5, dev)
    r = np.random.default_rng(12)
    worst = check_queries(tab, ref, np.concatenate(
        [nvec, r.integers(1, n_max + 1, 300)]), np.concatenate(
        [np.minimum(nvec, r.integers(1, 40, nvec.size)),
         r.integers(1, m_max + 1, 300)]), f"make({n_max}, {m_max})")
    del ref

    # -- exact invariants -----------------------------------------------------
    tp, T = states["TI pairs"]
    nl = torch.as_tensor(nv, device=dev)[None]
    check(bool(((tp >= 1) & (tp <= nl)).all()), "TI pairs: t outside [1, n]")
    check(bool(torch.equal(torch.zeros_like(T).index_add_(1, jl, tp), T)),
          "TI pairs: T_j != sum of the group's pair counts")
    check_state(*states["CTW rel"], data.n, "CTW rel")
    hp, T = states["HSA pairs"]
    sizes = torch.arange(hp.shape[-1], device=dev)
    hl = torch.as_tensor(jvec[h_order], device=dev).long()
    check(bool((hp >= 0).all() and torch.equal(
        (hp * sizes).sum(-1), torch.as_tensor(nvec[h_order], device=dev)
        .long().expand(hp.shape[:2]))), "HSA pairs: sum_s s h_s != n_p")
    check(bool(torch.equal(torch.zeros_like(T).index_add_(
        1, hl, hp.sum(-1, dtype=torch.int32)), T)),
        "HSA pairs: T_j != tables of the group")
    rates = {k: L * C * sweeps / (v * 1e-3) for k, v in ms.items()}
    print(f"   data {gen_s:.2f} s host: {L} items, {int((data.n > 0).sum())} "
          f"occupied pairs, largest count {int(data.n.max())}; "
          f"make({n_max}, {m_max}) K2, worst query error / bound "
          f"{max(worst.values()):.3g}; launches {launches}")
    for k in ms:
        print(f"   {k}: {ms[k] / sweeps:.3f} ms a sweep = {rates[k]:.4g} "
              f"item-updates/s (CUDA events, {sweeps} sweeps) [{card}]")

    # -- both V / Srel routes, and the CPU-f64 replay --------------------------
    def draw_ti():
        return [rng.uniform(gen, (r1 - r0, 2, C, p), torch.float32, dev)
                .cpu().numpy() for (p, r0, r1) in stages]

    def draw_ctw():
        return [rng.gumbel(gen, (D, C * J, 2 * w + 1), torch.float32, dev)
                .cpu().numpy()]

    cpu = torch.device("cpu")
    ref64 = plain_table(stirling, tab, n_max, m_max, 0.5, cpu)
    tp0, T0 = states["TI pairs"]
    t1, T1 = states["CTW rel"]
    u = draw_ti()
    ti_card = [pyp.ti_sweep_pairs_staged(rng.Replay(u), tp0, T0, a, b, tab,
                                         data, jv, iv, nv, stages, m_sel=m)
               for m in (m_ti, 0)]
    ti_cpu = pyp.ti_sweep_pairs_staged(
        rng.Replay(u), tp0.cpu(), T0.cpu(), a.double().cpu(),
        b.double().cpu(), ref64, data, jv, iv, nv, stages,
        m_sel=pyp.ti_pair_m_sel(ref64, nv))
    g = draw_ctw()
    ctw_card = [pyp.ctw_sweep_rel(rng.Replay(g), t1, T1, a, b, tab, data,
                                  window=w, m_sel=m) for m in (m_ctw, 0)]
    ctw_cpu = pyp.ctw_sweep_rel(rng.Replay(g), t1.cpu(), T1.cpu(),
                                a.double().cpu(), b.double().cpu(), ref64,
                                data, window=w,
                                m_sel=pyp.ctw_m_sel(ref64, data, window=w))
    for name, card_out, cpu_out in (("TI pairs", ti_card, ti_cpu),
                                    ("CTW rel", ctw_card, ctw_cpu)):
        check(all(torch.equal(x, y) for x, y in zip(*card_out)),
              f"{name}: the row and point-query routes differ on the card")
        diff = (card_out[0][0].cpu() != cpu_out[0]).flatten(1).any(1)
        diff |= (card_out[0][1].cpu() != cpu_out[1]).any(1)
        print(f"   {name}: both routes equal on the card; the f64 CPU replay "
              f"differs in {int(diff.sum())} of {C} chains (at most 2)")
        check(int(diff.sum()) <= 2, f"{name}: the CPU-f64 replay differs in "
              f"{int(diff.sum())} chains")

    # -- where the time goes: one profiled sweep each -------------------------
    for name, step in (("TI pairs", ti_step), ("CTW rel", ctw_step),
                       ("HSA pairs", hsa_step)):
        prof = profile_sweep(lambda: step(states[name]))
        if prof is None:
            print(f"   {name}: the profiler saw no device kernels (not "
                  "measured)")
            continue
        k, dev_ms, wall = prof
        print(f"   {name}: one sweep under the profiler: {k} kernels, "
              f"device busy {dev_ms:.3f} ms of {wall:.3f} ms wall "
              f"({100 * (1 - dev_ms / wall):.1f}% idle) [{card}]")
    done(t0)
    return launches


# phase 13: the gate's configuration at half its depth with traces (as phase
# 9 runs ARS), then RESUME_K iterations, a checkpoint, RESUME_K more
TRACE_SEED, TRACE_ITERS, RESUME_K = "7", 1000, 50
# phase 14b: check.c's MAXDATA through run_hpyp (32 chains, 100 iterations,
# hyper moves every 5); the start grid's hard bounds let ensure_grid grow it
HPYP_CHECKC_CHAINS, HPYP_CHECKC_CFG = 32, dict(iters=100, hyper_cycle=5)
HPYP_START, HPYP_HARD, HPYP_G = 454, 8192, 32
HPYP_SEED = 14
HPYP_FLOORS = dict(T1=0.05, T0=0.05, a1=0.01, b1=0.05, a0=0.01, b0=0.05)
HPYP_MOMENTS = dict(T1="T1ave", T0="T0ave", a1="a1ave", b1="b1ave",
                    a0="a0ave", b0="b0ave")
NGG_CHAINS = 100000            # BASELINE.json:11, the NGG workload


def phase13_traces(dev, sc, agrid, driver, pyp, card, ref):
    """collect_traces at the gate's configuration, and a checkpointed run
    resumed against the straight run; returns K1's launches on the path."""
    from libstb_tpu_torch.utils import checkpoint

    t0 = phase(f"13 traces and checkpoint/resume: run_gibbs(collect_traces="
               f"True), seed {TRACE_SEED}, {TRACE_ITERS} iterations; "
               f"{RESUME_K} + {RESUME_K} iterations through a checkpoint vs "
               f"one straight run")
    reset_launches(sc)
    cfg = driver.GibbsConfig(**dict(ref["config"], iters=TRACE_ITERS,
                                    collect_traces=True))
    ok, run_s, out = gate_seed(dev, agrid, driver, pyp, ref, TRACE_SEED, cfg)
    C = ref["chains"]
    kept = cfg.iters - cfg.resolved_burnin()
    for x in ("a", "b"):
        tr = out[f"{x}_trace"]
        check(tuple(tr.shape) == (cfg.iters, C),
              f"{x}_trace shape {tuple(tr.shape)}")
        check(torch.equal(tr[-1], out[x]), f"{x}_trace[-1] != the final {x}")
        r, e = float(out[f"{x}_rhat"]), float(out[f"{x}_ess"])
        check(np.isfinite(r) and r < 1.1, f"{x}_rhat {r:.4g} (< 1.1)")
        check(0 < e <= kept * C * 1.5,
              f"{x}_ess {e:.4g} (in (0, {kept * C * 1.5:g}])")
    check(ok, "traced run: a posterior moment is outside its band")
    print(f"   a_rhat {float(out['a_rhat']):.5f} b_rhat "
          f"{float(out['b_rhat']):.5f} a_ess {float(out['a_ess']):.1f} "
          f"b_ess {float(out['b_ess']):.1f} (of {kept} x {C} kept draws); "
          f"run_gibbs {1e3 * run_s / cfg.iters:.3f} ms an iteration "
          f"[{card}]")

    # resume: k iterations, save, load, k more == one straight 2k run
    data, grid = out["data"], out["grid"]
    k = RESUME_K
    scfg = driver.GibbsConfig(**dict(ref["config"], iters=2 * k))
    seed = int(TRACE_SEED) + 10
    t_run = time.perf_counter()
    straight = driver.run_gibbs(torch.Generator(device=dev).manual_seed(seed),
                                data, grid, C, ref["a0"], ref["b0"], scfg)
    torch.cuda.synchronize()
    straight_s = time.perf_counter() - t_run
    grid, plan = driver._prepare(data, grid, scfg)
    half = dataclasses.replace(scfg, iters=k)
    gen = torch.Generator(device=dev).manual_seed(seed)
    first = driver._run_chunk(gen, data, grid, driver._init(
        data, grid, C, ref["a0"], ref["b0"], plan), half, plan, 0)
    keys = ("t", "T", "hist", "a", "b")
    with tempfile.TemporaryDirectory() as d:
        t_run = time.perf_counter()
        path = checkpoint.save(os.path.join(d, "run"),
                               {"state": {x: first[x] for x in keys},
                                "gen": gen}, meta={"iters_done": k})
        ck, meta = checkpoint.load(path, device=dev)
        ck_s = time.perf_counter() - t_run
        ck_bytes = os.path.getsize(path)
    del first, gen
    check(meta == {"iters_done": k} and ck["gen"].device.type == "cuda"
          and ck["state"]["t"].device.type == "cuda",
          "the checkpoint did not come back on the card")
    resumed = driver._run_chunk(ck["gen"], data, grid, ck["state"], half,
                                plan, 0)
    torch.cuda.synchronize()
    for x in ("t", "T", "a", "b"):
        check(resumed[x].dtype == straight[x].dtype
              and torch.equal(resumed[x], straight[x]),
              f"resume: {x} differs from the straight {2 * k}-iteration run")
    launches = dict(sc.LAUNCHES)
    check(launches["fill_grid"] >= 1, "phase 13 did not launch K1")
    print(f"   resume: {k} + {k} iterations through a checkpoint "
          f"({ck_bytes} bytes, save + load {1e3 * ck_s:.1f} ms) equal the "
          f"straight run bitwise in t, T, a, b; straight run "
          f"{1e3 * straight_s / (2 * k):.3f} ms an iteration [{card}]")
    print(f"   launches on the path: {launches}")
    done(t0)
    return launches


def hpyp_bands(ref, out):
    """The nine HPYP moments (E[T1_j], E[T0], E[a1], E[b1], E[a0], E[b0])
    against the reference: |difference| within 2 combined MC-SE plus the
    floors (0.05 for table counts and concentrations, 0.01 for
    discounts).  Prints each; returns whether all hold."""
    ok = True
    for name, src in HPYP_MOMENTS.items():
        vals = out[src].double().cpu().numpy().reshape(ref["chains"], -1)
        om = vals.mean(0)
        osd = vals.std(0, ddof=1) / np.sqrt(len(vals))
        rm = np.asarray(ref["moments"][name]["mean"])
        rs = np.asarray(ref["moments"][name]["se"])
        band = 2 * np.sqrt(rs ** 2 + osd ** 2) + HPYP_FLOORS[name]
        good = bool(np.all(np.abs(rm - om) <= band))
        ok &= good
        print(f"   HPYP E[{name}]: ref={np.round(rm, 4)} "
              f"ours={np.round(om, 4)} band={np.round(band, 4)} -> "
              f"{'OK' if good else 'MISMATCH'}")
    return ok


def check_hpyp_state(out, data, what):
    """Exact invariants of an HPYP state: 1 <= t1 <= n on occupied pairs
    (0 elsewhere), t0 <= n0 = sum_j t1, t0 >= 1 where n0 > 0, T1 and T0
    their sums."""
    t1, T1, t0, T0 = (out[k] for k in ("t1", "T1", "t0", "T0"))
    check_state(t1, T1, data.n, f"{what} level 1")
    n0 = t1.sum(1, dtype=torch.int32)
    check(bool(((t0 <= n0) & (t0 >= 0)).all()), f"{what}: t0 > n0")
    check(bool(torch.where(n0 > 0, t0 >= 1, t0 == 0).all()),
          f"{what}: t0 < 1 on an occupied category, or not 0 off one")
    check(bool(torch.equal(t0.sum(-1, dtype=torch.int32), T0)),
          f"{what}: T0 != sum_i t0_i")


def phase14_hpyp(dev, sc, agrid, pyp, card, ref):
    """The HPYP model on the card: the gate against the JAX CPU-f64
    moments, then check.c scale with the grid grown through K1; returns
    K1's launches on the path."""
    from libstb_tpu_torch.models import hpyp

    t0 = phase(f"14a HPYP gate: run_hpyp (f32, {ref['chains']} chains, "
               f"{ref['config']}) vs the JAX CPU-f64 moments")
    reset_launches(sc)
    data = pyp.crp_generate(*ref["data_args"])
    check(np.array_equal(data.n, np.asarray(ref["n"])),
          "HPYP gate: crp_generate differs from the reference data")
    grid = agrid.make_grid(ref["grid_n"], ref["grid_n"], g=ref["grid_g"],
                           device=dev)
    cfg = hpyp.HPYPConfig(**ref["config"])
    gen = torch.Generator(device=dev).manual_seed(HPYP_SEED)
    st = ref["starts"]
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    out = hpyp.run_hpyp(gen, data, grid, ref["chains"], st["a1"], st["b1"],
                        st["a0"], st["b0"], cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    ok = hpyp_bands(ref, out)
    check_hpyp_state(out, data, "HPYP gate")
    check(ok, "HPYP gate: a posterior moment is outside its band")
    e_v, e_s = check_grid(sc, grid, "phase 14a")
    print(f"   run_hpyp {1e3 * run_s / cfg.iters:.3f} ms an iteration "
          f"({run_s:.3f} s / {cfg.iters}); grid {tuple(grid.srel.shape)} V "
          f"rel {e_v:.3g}, scaled |dSrel| {e_s:.3g} [{card}]")
    del grid, out
    done(t0)

    C = HPYP_CHECKC_CHAINS
    cfg = hpyp.HPYPConfig(**HPYP_CHECKC_CFG)
    t0 = phase(f"14b HPYP at check.c scale: crp_generate{CHECKC_DATA}, {C} "
               f"chains, {HPYP_CHECKC_CFG}, from make_grid({HPYP_START}, "
               f"{HPYP_START}, g={HPYP_G}) grown through K1")
    data = pyp.crp_generate(*CHECKC_DATA)
    n0_bound = int(data.n.sum(axis=0).max())
    grid = agrid.make_grid(HPYP_START, HPYP_START, g=HPYP_G, device=dev,
                           max_n=HPYP_HARD, max_m=HPYP_HARD)
    torch.cuda.synchronize()
    grown, ensure = [], agrid.ensure_grid

    def timed_ensure(*args, **kw):
        t_g = time.perf_counter()
        g = ensure(*args, **kw)
        torch.cuda.synchronize()
        grown.append((g, time.perf_counter() - t_g))
        return g

    before = sc.LAUNCHES["fill_grid"]
    gen = torch.Generator(device=dev).manual_seed(HPYP_SEED + 1)
    agrid.ensure_grid = timed_ensure
    try:
        t_run = time.perf_counter()
        out = hpyp.run_hpyp(gen, data, grid, C, 0.5, 10.0, 0.5, 10.0, cfg)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t_run
    finally:
        agrid.ensure_grid = ensure
    launches = dict(sc.LAUNCHES)
    (big, grow_s), = grown
    check(big.n_max >= n0_bound + 1 and big.m_max >= n0_bound + 1,
          f"run_hpyp left the grid at ({big.n_max}, {big.m_max}) below the "
          f"level-0 bound {n0_bound} + 1")
    check(launches["fill_grid"] - before >= 1,
          "run_hpyp's regrow did not launch K1")
    check_hpyp_state(out, data, "HPYP check.c")
    for x in ("T1ave", "T0ave", "a1ave", "b1ave", "a0ave", "b0ave"):
        check(bool(torch.isfinite(out[x]).all()), f"HPYP check.c: {x}")
    nbytes = sum(t.numel() * t.element_size() for t in (big.vtab, big.srel))
    # the grown grid against the f64 plain fill on three discounts (2b's
    # bounds)
    pick = torch.tensor([0, HPYP_G // 2, HPYP_G - 1], device=dev)
    v64, s64 = sc.fill_grid_ref(big.avec[pick].double(), big.n_max,
                                big.m_max)
    v_rel, s_abs, _ = fill_errors(big.vtab[pick], big.srel[pick], v64, s64)
    del v64, s64
    check(v_rel < 1e-4 and s_abs <= 5e-2,
          f"grown grid: V rel {v_rel:.3g} (< 1e-4), |dSrel| {s_abs:.3g} "
          "(<= 5e-2)")
    iter_ms = 1e3 * (run_s - grow_s) / cfg.iters
    print(f"   level-0 bound {n0_bound}: grid grown ({HPYP_START}, "
          f"{HPYP_START}) -> ({big.n_max}, {big.m_max}) x {HPYP_G} "
          f"discounts, {nbytes / 1e9:.3f} GB of f32 V + Srel, in "
          f"{1e3 * grow_s:.1f} ms (K1 + host S1) [{card}]; V rel "
          f"{v_rel:.3g}, |dSrel| {s_abs:.3g} on a = "
          f"{big.avec[pick].tolist()}")
    print(f"   run_hpyp {iter_ms:.3f} ms an iteration ({run_s:.3f} s for "
          f"{cfg.iters}, the regrow excluded); E[T1] "
          f"{float(out['T1ave_mean'].sum()):.2f} E[T0] "
          f"{float(out['T0ave_mean']):.2f} E[a1] "
          f"{float(out['a1ave'].mean()):.4f} E[a0] "
          f"{float(out['a0ave'].mean()):.4f}; K1 launches "
          f"{launches['fill_grid']} [{card}]")
    # where an iteration's time goes: one iteration with both hyper moves
    prof = profile_sweep(lambda: hpyp.run_hpyp(
        gen, data, big, C, 0.5, 10.0, 0.5, 10.0,
        hpyp.HPYPConfig(iters=1, hyper_cycle=1)), top=6)
    if prof is None:
        print("   the profiler saw no device kernels (not measured)")
    else:
        k, dev_ms, wall, top = prof
        print(f"   one iteration under the profiler: {k} device operations, "
              f"busy {dev_ms:.3f} ms of {wall:.3f} ms wall "
              f"({100 * (1 - dev_ms / wall):.1f}% idle) [{card}]")
        for name, ms_, calls in top:
            print(f"     {ms_:9.3f} ms in {calls:5d} calls of {name}")
    print(f"   launches on the path: {launches}")
    done(t0)
    return launches


def phase15_ngg(dev, card, ref):
    """The NGG subsystem in f64 on the card against the JAX f64 values,
    the NGG workload at 10^5 chains, and the precision comparison."""
    from libstb_tpu_torch.core import ngg
    from libstb_tpu_torch.utils import metrics

    sys.path.insert(0, os.path.join(ROOT, "cli"))
    import ngg_torch
    import precision_torch

    t0 = phase("15a NGG vs JAX f64: ngg_table, ngg_ratio_table (recurrence, "
               "quadrature), the five saddle points and the quadrature")
    a, M = ref["a"], ref["M"]
    eps, ulps, rtol = 2.0 ** -52, ref["kappa_ulps"], ref["rtol"]
    f64 = dict(dtype=torch.float64, device=dev)

    def t(x):
        return torch.tensor(x, **f64)

    S, kap = (np.asarray(ref["table"][k], np.float64) for k in ("S", "kappa"))
    got = ngg.ngg_table(a, M, *ref["table"]["shape"], device=dev)
    check(got.dtype == torch.float64 and got.device.type == "cuda",
          "ngg_table is not f64 on the card")
    got = got.cpu().numpy()
    fin = np.isfinite(S)
    check(np.array_equal(np.isneginf(got), np.isneginf(S))
          and bool(np.isfinite(got[fin]).all()), "ngg_table -inf pattern")
    bound = ulps * eps * (kap[fin] + np.abs(S[fin]))
    worst = {"table": float(np.max(np.abs(got[fin] - S[fin]) / bound))}
    R, rho = (np.asarray(ref["ratio_recurrence"][k]) for k in ("R", "rho"))
    got = ngg.ngg_ratio_table(a, M, *ref["ratio_recurrence"]["shape"],
                              method="recurrence", device=dev).cpu().numpy()
    v = R != 0
    check(np.array_equal(got == 0, R == 0), "ratio table zero pattern")
    worst["ratio_recurrence"] = float(np.max(
        np.abs(got[v] - R[v]) / np.abs(R[v]) / (ulps * eps * rho[v])))
    Rq = np.asarray(ref["ratio_quadrature"]["R"])
    got = ngg.ngg_ratio_table(a, M, *ref["ratio_quadrature"]["shape"],
                              method="quadrature", device=dev).cpu().numpy()
    v = Rq != 0
    check(np.array_equal(got == 0, Rq == 0), "quadrature ratio zero pattern")
    worst["ratio_quadrature"] = float(np.max(np.abs(got[v] - Rq[v])
                                             / (rtol * np.abs(Rq[v]))))
    for where, pts in ref["points"].items():
        N, K = t(pts["N"]), t(pts["K"])
        for fn in ("umax_log", "smax_log", "hmax_log", "hmax2_log",
                   "gmax_log", "ngg_quadrature_log"):
            want = np.asarray(pts[fn], np.float64)
            got = getattr(ngg, fn)(a, M, N, K).cpu().numpy()
            check(np.array_equal(np.isnan(got), np.isnan(want)),
                  f"{fn} at the {where} points: NaN pattern differs")
            ok = ~np.isnan(want)
            worst[f"{fn}@{where}"] = float(np.max(
                np.abs(got[ok] - want[ok]) / (rtol * np.abs(want[ok]))))
    for k_, w in worst.items():
        check(w <= 1.0, f"NGG {k_}: off by {w:.3g} x its bound")
    print(f"   worst error / bound: {max(worst.values()):.3g} "
          f"({max(worst, key=worst.get)}); bounds: rtol {rtol:g}, the "
          f"tables {ulps} x 2^-52 x (kappa + |S|)")
    done(t0)

    t0 = phase(f"15b cli/ngg_torch.py (defaults, then --chains {NGG_CHAINS})")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_run = time.perf_counter()
        ngg_torch.main(["--device", "cuda"])
        table_s = time.perf_counter() - t_run
    rows = [ln for ln in buf.getvalue().splitlines()
            if len(ln.split()) == 9 and ln.split()[0].isdigit()]
    check(len(rows) == 30, f"ngg_torch table mode printed {len(rows)} rows")
    res = ngg_torch.main(["--device", "cuda", "--chains", str(NGG_CHAINS)])
    workload = res
    check(res["worst"] < ngg_torch.AGREE, "NGG workload disagrees")
    N, K = ngg_torch.workload_inputs(NGG_CHAINS, dev)
    ev_ms = 1e3 * metrics.device_timer(ngg_torch.evaluate, a, M, N, K)
    prof = profile_sweep(lambda: ngg_torch.evaluate(a, M, N, K))
    idle = ("not measured" if prof is None else
            f"{prof[0]} device operations, busy {prof[1]:.3f} ms of "
            f"{prof[2]:.3f} ms wall ({100 * (1 - prof[1] / prof[2]):.1f}% "
            "idle)")
    print(f"   table mode {table_s:.2f} s (30 rows, six methods each); "
          f"{NGG_CHAINS} chains: {res['evals_per_s']:.4g} saddle-evals/s "
          f"({1e3 * res['seconds']:.3f} ms a pass, host clock; "
          f"{ev_ms:.3f} ms by CUDA events, best of 3), agreement max "
          f"{res['worst']:.3g} mean {res['mean']:.3g}; one pass under the "
          f"profiler: {idle} [{card}]")
    done(t0)

    t0 = phase("15c cli/precision_torch.py (N = 10000, M = 4000)")
    with contextlib.redirect_stdout(io.StringIO()):
        res = precision_torch.main(["--device", "cuda"])
    errs, ms = res["errors"], res["ms"]
    check(errs["ratio/f32"] < errs["log/f32"],
          f"precision: ratio/f32 error {errs['ratio/f32']:.4g} is not below "
          f"log/f32's {errs['log/f32']:.4g}")
    for name in errs:
        print(f"   {name:10s}: max|err| {errs[name]:.4g}, fill "
              f"{ms[name]:.1f} ms (host clock, synchronized) [{card}]")
    done(t0)
    return workload


# -- phases 16-17: the multi-device layer and the long-double oracle ---------
#
# Phase 16 runs the port's multi-device path on the one card: each phase
# starts its ranks as processes of this script (``--rank PHASE RANK WORLD
# RDZV OUT``), all on cuda:0, joined through a file rendezvous; NCCL at
# world size 1, gloo between ranks that share the card (NCCL refuses two
# ranks on one device).  Each rank prints one ``RANK {json}`` line with its
# K1 launches on the path and its measurements; a failing rank fails the
# phase.  16e runs cli/ngg_torch.py under torchrun.

DRY_SHAPE = dict(chains=1024, n_max=512, m_max=128, g=32, dim=16,
                 n_per_group=200)       # __graft_entry__.dryrun_multichip's
SHARD_FILL = (8, 1 << 14, 1024)         # phase 2b's 8 discounts, f32
SHARD_A = (0.01, 0.9)                   # ... of linspace(0.01, 0.9, 64)
CKPT_K = 20                             # 16d: 20 + 20 iterations, lcm 10
ORACLE = (0.5, 8192, 1024)              # phase 17: fill_ref's shape
TPU_K2_DSREL = 2.4e-3                   # stirling_pallas.py:327, the TPU's


def _rank_env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "2"
    return env


def _wait(procs, timeout, what):
    """Outputs of ``procs``; kills them all and fails if one fails or
    they outlive ``timeout``."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{what}: ranks did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(text[-4000:], flush=True)
            raise AssertionError(f"{what}: rank {r} exited {p.returncode}")
    return outs


_STARTED = []                  # every process phase 16 started


def _start(argv):
    proc = subprocess.Popen(argv, cwd=ROOT, env=_rank_env(),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _STARTED.append(proc)
    return proc


def _stop_all():
    for p in _STARTED:
        if p.poll() is None:
            p.kill()
            p.wait()


def start_ranks(name, world, out):
    """Start phase ``name`` in ``world`` processes of this script on
    cuda:0; finish_ranks collects them."""
    rdzv = os.path.join(out, f"rdzv_{name}")
    return name, [_start([sys.executable, os.path.abspath(__file__),
                          "--rank", name, str(r), str(world), rdzv, out])
                  for r in range(world)]


def run_ranks(name, world, out, timeout=240):
    """Phase ``name`` in ``world`` processes of this script on cuda:0;
    returns each rank's RANK json."""
    return finish_ranks(start_ranks(name, world, out), timeout)


def finish_ranks(started, timeout=240):
    """Each rank's RANK json of ``started`` (from start_ranks)."""
    name, procs = started
    outs = _wait(procs, timeout, f"phase {name}")
    res = []
    for text in outs:
        lines = [ln for ln in text.splitlines() if ln.startswith("RANK ")]
        check(len(lines) == 1, f"phase {name}: a rank printed no result")
        res.append(json.loads(lines[0][5:]))
    return res


def _k1_path(results):
    """K1 launches of a phase-16 path, summed over its ranks; every rank
    must have launched K1."""
    check(all(r["launches"]["fill_grid"] >= 1 for r in results),
          "a rank of the path did not launch K1")
    return {name: sum(r["launches"][name] for r in results)
            for name in results[0]["launches"]}


def rank16a_nccl(dev, rank, world, out):
    """NCCL at world size 1: an all-reduce and an all-gather on the card;
    the mesh fill bitwise equal to the unsharded fill."""
    import torch.distributed as dist
    from libstb_tpu_torch.core import agrid
    from libstb_tpu_torch.ops import stirling_cuda as sc
    from libstb_tpu_torch.parallel import mesh as pmesh

    check(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    x = torch.arange(1024.0, device=dev)
    y = x.clone()
    dist.all_reduce(y)
    g = pmesh._all_gather(x, dist.group.WORLD)
    torch.cuda.synchronize()
    check(torch.equal(y, x) and torch.equal(g, x),
          "NCCL all-reduce / all-gather at world 1 changed the tensor")
    cm = pmesh.chain_mesh(device=dev)
    reset_launches(sc)
    grid = agrid.make_grid(512, 128, g=64, mesh=cm)
    launches = dict(sc.LAUNCHES)
    one = agrid.make_grid(512, 128, g=64, device=dev)
    for k in ("avec", "s1_hi", "s1_lo", "vtab", "srel"):
        check(torch.equal(getattr(grid, k), getattr(one, k)),
              f"16a: the mesh fill's {k} differs from the unsharded fill")
    return dict(launches=launches, backend=dist.get_backend())


def rank16b_fill(dev, rank, world, out):
    """Phase 2b's 8 discounts through make_grid(mesh=...): each rank fills
    G / P of them through K1 and the shares are all-gathered (staged
    through host memory on gloo); the fill and the gather timed apart,
    the gathered tables bitwise equal to a one-process K1 fill."""
    import torch.distributed as dist
    from libstb_tpu_torch.core import agrid
    from libstb_tpu_torch.ops import stirling_cuda as sc
    from libstb_tpu_torch.parallel import mesh as pmesh

    G, N, M = SHARD_FILL
    avec = np.linspace(*SHARD_A, G)
    cm = pmesh.chain_mesh(device=dev)
    reset_launches(sc)
    grid = agrid.make_grid(N, M, g=G, a_lo=SHARD_A[0], a_hi=SHARD_A[1],
                           mesh=cm)
    torch.cuda.synchronize()
    launches = dict(sc.LAUNCHES)
    nbytes = sum(x.numel() * x.element_size() for x in (grid.vtab, grid.srel))
    check(torch.equal(grid.avec, torch.as_tensor(avec, dtype=torch.float32,
                                                 device=dev)), "16b: avec")
    v, s = sc.fill_grid_cuda(grid.avec, N, M)
    check(torch.equal(v, grid.vtab) and torch.equal(s, grid.srel),
          "16b: the gathered grid differs from a one-process K1 fill")
    del v, s, grid
    # the fill and the gather apart, warm: make_grid(mesh=...)'s two halves
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    dist.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    shard = agrid._fill_shard(avec, N, M, True, True, torch.float32, cm)
    ev[1].record()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    agrid._gather_shard(shard, cm)
    ev[2].record()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(launches=launches, bytes=nbytes,
                fill_ms=ev[0].elapsed_time(ev[1]),
                gather_ms=ev[1].elapsed_time(ev[2]),
                fill_host_ms=1e3 * (t1 - t0), gather_host_ms=1e3 * (t2 - t1))


def rank16c_dryrun(dev, rank, world, out):
    """dryrun_multichip on the 2 x 2 chains x data mesh, then the
    one-process step on this rank's chains with the same shard
    generators: t, T, b exactly equal, a within 1e-5 relative in all but
    1% of the chains; the state's invariants exact."""
    from libstb_tpu_torch import entry
    from libstb_tpu_torch.models import pyp
    from libstb_tpu_torch.ops import stirling_cuda as sc

    reset_launches(sc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = entry.dryrun_multichip(world, **DRY_SHAPE)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(sc.LAUNCHES)
    cm = res["mesh"]
    data = pyp.crp_generate(0, 2, DRY_SHAPE["dim"],
                            DRY_SHAPE["n_per_group"], 0.5, 2.0)
    check_state(res["t"], res["T"], data.n, "16c")
    kw = {k: DRY_SHAPE[k] for k in ("n_max", "m_max", "g", "dim",
                                    "n_per_group")}
    step, args = entry._build(res["local"], dev, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = step(entry.step_generators(0, dev, cm.coord("chains")), *args[1:])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    for k, x in zip("tTb", (ref[0], ref[1], ref[3])):
        check(torch.equal(res[k], x),
              f"16c: {k} differs from the one-process step on the chains")
    rel = ((res["a"].double() - ref[2].double()).abs()
           / ref[2].double().abs())
    off = float((rel > 1e-5).double().mean())
    check(off <= 0.01, f"16c: a off by > 1e-5 in {100 * off:.2f}% of chains")
    np.savez(os.path.join(out, f"dry{rank}.npz"),
             **{k: res[k].cpu().numpy() for k in "tTab"})
    return dict(launches=launches, mesh=cm.shape, coords=list(cm.coords),
                chains=res["chains"], a_mean=res["a_mean"],
                b_mean=res["b_mean"], a_max_rel=float(rel.max()),
                a_off=off, run_s=run_s, step_s=step_s)


def rank16d_checkpoint(dev, rank, world, out):
    """The gate's configuration (seed 7, its 64 chains split over the
    ranks) through the driver: CKPT_K iterations, checkpoint.save of the
    rank's chains and CUDA generator to .p<rank>, load, re-shard with
    shard_chain_tree_global, CKPT_K more; equal to the straight 2 CKPT_K
    bitwise.
    The cross-chain mean of a, reduced over the ranks, is printed."""
    from libstb_tpu_torch.core import agrid
    from libstb_tpu_torch.models import driver, pyp
    from libstb_tpu_torch.ops import stirling_cuda as sc
    from libstb_tpu_torch.parallel import distributed
    from libstb_tpu_torch.parallel import mesh as pmesh
    from libstb_tpu_torch.utils import checkpoint

    with open(GATE_REF) as f:
        ref = json.load(f)
    data = pyp.crp_generate(int(TRACE_SEED), *ref["data_args"])
    cm = pmesh.chain_mesh(device=dev)
    C = ref["chains"]
    local = distributed.host_local_chains(C)
    reset_launches(sc)
    n_max = max(int(data.N.max()) + 2, 16)
    grid = agrid.make_grid(n_max, n_max, g=ref["grid_g"], mesh=cm)
    cfg = driver.GibbsConfig(**dict(ref["config"], iters=2 * CKPT_K))
    half = dataclasses.replace(cfg, iters=CKPT_K)
    grid, plan = driver._prepare(data, grid, cfg)
    init = driver._init(data, grid, C, ref["a0"], ref["b0"], plan)
    sl = pmesh.chain_slice(cm, C)
    st = pmesh.shard_chain_tree_global(
        {k: None if v is None else v[sl] for k, v in init.items()}, cm, C)
    seed = 1000 * (rank + 1) + int(TRACE_SEED)
    straight = driver._run_chunk(torch.Generator(device=dev).manual_seed(
        seed), data, grid, st, cfg, plan, 0)
    gen = torch.Generator(device=dev).manual_seed(seed)
    first = driver._run_chunk(gen, data, grid, st, half, plan, 0)
    keys = ("t", "T", "hist", "a", "b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    path = checkpoint.save(os.path.join(out, "ckpt"),
                           {"state": {k: first[k] for k in keys},
                            "gen": gen}, meta={"iters_done": CKPT_K},
                           chains=local)
    ck, meta = checkpoint.load(os.path.join(out, "ckpt"), device=dev)
    ck_ms = 1e3 * (time.perf_counter() - t0)
    check(path.endswith(f"ckpt.p{rank}.npz"), f"16d: saved to {path}")
    with open(path + ".json") as f:
        side = json.load(f)
    check(side["world_size"] == world and side["rank"] == rank
          and len(side["chain_sharded"]) == 4, f"16d: sidecar {side}")
    state = pmesh.shard_chain_tree_global(ck["state"], cm, C)
    resumed = driver._run_chunk(ck["gen"], data, grid, state, half, plan, 0)
    for k in ("t", "T", "a", "b"):
        check(torch.equal(resumed[k], straight[k]),
              f"16d: resumed {k} differs from the straight run")
    launches = dict(sc.LAUNCHES)
    a_mean = pmesh.cross_chain_moments(resumed["a"].double(), mesh=cm)[0]
    return dict(launches=launches, bytes=os.path.getsize(path),
                ckpt_ms=ck_ms, a_mean=repr(float(a_mean)),
                local=local)


RANK_PHASES = {"16a": rank16a_nccl, "16b": rank16b_fill,
               "16c": rank16c_dryrun, "16d": rank16d_checkpoint}


def rank_main(argv):
    """One rank of a phase-16 path (see run_ranks)."""
    name, rank, world, rdzv, out = argv
    rank, world = int(rank), int(world)
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    from libstb_tpu_torch.parallel import distributed

    distributed.init(f"file://{rdzv}", world, rank)
    dev = distributed.local_device()
    res = RANK_PHASES[name](dev, rank, world, out)
    print("RANK " + json.dumps(res), flush=True)
    import torch.distributed as dist
    dist.destroy_process_group()


# 16f: the tool's sizes, 10 timed steps (its 30 cut: on an H100 a run took
# ~35 s at 30 steps, most of it process start-up, against a 90 s phase)
SCALING_RUNS = tuple(argv + ["--iters", "10"] for argv in (
    ["--devices", "2"], ["--devices", "4"], ["--devices", "2", "--ngg"]))


def phase16f_scaling(card):
    """tools/scaling_bench_torch.py's SCALING_RUNS, each a process of the
    tool that starts its own ranks on cuda:0; every figure finite, the
    moments finite, NGG's worst < 0.2, K1 launched in r1 and in every
    rank.  Returns the kernels' launches summed over the runs."""
    launches = {}
    for argv in SCALING_RUNS:
        t_run = time.perf_counter()
        proc = _start([sys.executable, os.path.join(ROOT, "tools",
                                                    "scaling_bench_torch.py"),
                       *argv])
        text = _wait([proc], 240, "16f " + " ".join(argv))[0]
        run_s = time.perf_counter() - t_run
        res = json.loads([ln for ln in text.splitlines()
                          if ln.startswith("{")][-1])
        n = int(argv[argv.index("--devices") + 1])
        r1, rn = res["r1"], res["rn"]
        check(res["shared_card"] and res["backend"] == "gloo"
              and rn["devices"] == n and rn["chains"] == n * r1["chains"],
              f"16f {argv}: {res}")
        figs = [r[k] for r in (r1, rn) for k in (
            "sec_per_step", "chain_steps_per_s",
            "per_device_chain_steps_per_s")]
        check(all(np.isfinite(x) and x > 0 for x in figs)
              and np.isfinite(res["weak_scaling_efficiency"]),
              f"16f {argv}: figures {figs}")
        if "--ngg" in argv:
            check(r1["worst"] < 0.2 and rn["worst"] < 0.2,
                  f"16f {argv}: worst {r1['worst']}, {rn['worst']} (< 0.2)")
            extra = f"worst {r1['worst']:.4g} / {rn['worst']:.4g}"
        else:
            check(np.isfinite(r1["stats"]).all()
                  and np.isfinite(rn["stats"]).all(),
                  f"16f {argv}: moments {r1['stats']}, {rn['stats']}")
            check(r1["launches"]["fill_grid"] >= 1
                  and rn["launches"]["fill_grid"] >= n,
                  f"16f {argv}: K1 not launched in every rank")
            for r in (r1, rn):
                for k, c in r["launches"].items():
                    launches[k] = launches.get(k, 0) + c
            extra = (f"[a_mean, a_var, b_mean, b_var] {r1['stats']} / "
                     f"{rn['stats']}")
        print(f"   {' '.join(argv)}: 1 process {r1['chains']} chains "
              f"{1e3 * r1['sec_per_step']:.3f} ms a step, "
              f"{r1['chain_steps_per_s']:.4g} chain-steps/s; {n} ranks on "
              f"one card {rn['chains']} chains {1e3 * rn['sec_per_step']:.3f}"
              f" ms a step, {rn['chain_steps_per_s']:.4g} chain-steps/s "
              f"({rn['per_device_chain_steps_per_s']:.4g} a rank), ratio "
              f"{res['weak_scaling_efficiency']} (one card shared, not weak "
              f"scaling); {extra}; the run {run_s:.1f} s (host) [{card}]")
    return launches


def phase16_multidevice(dev, card, ngg_one):
    """Phases 16a-f; returns {path: K1 launches summed over its ranks}."""
    paths = {}
    out = tempfile.mkdtemp(prefix="chip_smoke16_")
    try:
        G, N, M = SHARD_FILL
        t0 = phase(f"16b sharded K1 fill, 2 gloo ranks on cuda:0: {G} "
                   f"discounts at ({N}, {M}) f32, gathered on every rank")
        res = run_ranks("16b", 2, out)
        paths["16b"] = _k1_path(res)
        for r, x in enumerate(res):
            print(f"   rank {r}: fill {x['fill_ms']:.3f} ms (CUDA events), "
                  f"{x['fill_host_ms']:.3f} ms (host); all-gather "
                  f"{x['gather_ms']:.3f} ms (CUDA events), "
                  f"{x['gather_host_ms']:.3f} ms (host); {x['bytes'] / 1e9:.3f}"
                  f" GB of V + Srel a rank [{card}]")
        done(t0, f"bitwise equal to a one-process K1 fill; launches "
                 f"{paths['16b']}")

        t0 = phase(f"16c dryrun_multichip, 4 gloo ranks on cuda:0 (2 x 2 "
                   f"chains x data), {DRY_SHAPE}; 16d and 16a beside it")
        dry = start_ranks("16c", 4, out)
        nccl = start_ranks("16a", 1, out)
        ckpt = start_ranks("16d", 2, out)
        res = finish_ranks(dry)
        paths["16c"] = _k1_path(res)
        states = [dict(np.load(os.path.join(out, f"dry{r}.npz")))
                  for r in range(4)]
        by_shard = {}
        for r, x in enumerate(res):
            check(x["mesh"] == {"chains": 2, "data": 2}, f"16c: {x['mesh']}")
            by_shard.setdefault(x["coords"][0], []).append(r)
        for peers in by_shard.values():
            for r in peers[1:]:
                for k in "tTab":
                    check(np.array_equal(states[r][k], states[peers[0]][k]),
                          f"16c: data-group peers differ in {k}")
        a_mean, b_mean = res[0]["a_mean"], res[0]["b_mean"]
        check(np.isfinite(a_mean) and np.isfinite(b_mean)
              and 0.01 <= a_mean <= 0.98, f"16c: means {a_mean}, {b_mean}")
        print(f"   chains={res[0]['chains']}, a_mean={a_mean:.6f}, "
              f"b_mean={b_mean:.6f}; a vs the one-process step: max rel "
              f"{max(x['a_max_rel'] for x in res):.3g}, chains off > 1e-5: "
              f"{max(x['a_off'] for x in res):.4f}; dry run "
              f"{max(x['run_s'] for x in res):.3f} s (host, slowest rank; "
              f"cold: the group, the grid, first calls); the one-process "
              f"step on a rank's {res[0]['chains'] // 2} chains after it "
              f"{max(x['step_s'] for x in res):.3f} s (host, slowest of "
              f"4; 16d's 2 ranks and 16a share the card) [{card}]")
        done(t0, f"peers bitwise equal; t, T, b equal the one-process "
                 f"step; launches {paths['16c']}")

        t0 = phase(f"16d (run beside 16c) checkpoint .p0 / .p1: 2 ranks, the "
                   f"gate's 64 chains split, {CKPT_K} + {CKPT_K} iterations "
                   f"vs {2 * CKPT_K} straight")
        res = finish_ranks(ckpt)
        paths["16d"] = _k1_path(res)
        check(res[0]["a_mean"] == res[1]["a_mean"],
              "16d: the cross-chain mean differs between the ranks")
        print(f"   resumed == straight bitwise on both ranks; checkpoint "
              f"{res[0]['bytes']} bytes a rank, save + load "
              f"{max(x['ckpt_ms'] for x in res):.1f} ms; mean a over all "
              f"chains {res[0]['a_mean']} on both ranks [{card}]")
        done(t0, f"launches {paths['16d']}")

        t0 = phase("16a NCCL at world size 1 (run beside 16c): all-reduce, "
                   "all-gather, make_grid(512, 128, g=64, mesh=...) vs the "
                   "unsharded fill")
        res = finish_ranks(nccl)
        paths["16a"] = _k1_path(res)
        done(t0, f"backend {res[0]['backend']}; launches {paths['16a']}")

        t0 = phase(f"16e torchrun --nproc_per_node 2 cli/ngg_torch.py "
                   f"--chains {NGG_CHAINS} on cuda:0")
        js = os.path.join(out, "ngg.json")
        proc = _start(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "2", os.path.join(ROOT, "cli",
                                                   "ngg_torch.py"),
             "--chains", str(NGG_CHAINS), "--json", js])
        text = _wait([proc], 240, "16e")[0]
        with open(js) as f:
            res = json.load(f)
        check(res["chains"] == NGG_CHAINS and res["worst"] < 0.05,
              f"16e: {res}")
        check(res["worst"] == ngg_one["worst"],
              f"16e: worst {res['worst']!r} != one process's "
              f"{ngg_one['worst']!r}")
        check(abs(res["mean"] - ngg_one["mean"])
              <= 1e-12 * abs(ngg_one["mean"]),
              f"16e: mean {res['mean']!r} vs {ngg_one['mean']!r}")
        line = [ln for ln in text.splitlines() if "NGG workload" in ln]
        print(f"   {line[0] if line else text[-500:]}")
        print(f"   {res['evals_per_s']:.4g} saddle-evals/s over 2 ranks "
              f"(one process, 15b: {ngg_one['evals_per_s']:.4g}); worst "
              f"{res['worst']!r} == 15b's, mean {res['mean']!r} vs "
              f"{ngg_one['mean']!r} [{card}]")
        done(t0)

        t0 = phase("16f tools/scaling_bench_torch.py on cuda:0: the Gibbs "
                   "step + cross-chain moments at 2 and 4 gloo ranks, the "
                   "NGG workload at 2 (one card shared: not weak scaling)")
        paths["16f"] = phase16f_scaling(card)
        done(t0, f"launches {paths['16f']}")
    finally:
        _stop_all()
        shutil.rmtree(out, ignore_errors=True)
    return paths


def oracle_errors(v, s, logS, V, S1):
    """(max |d log S|, max |dSrel|, max V rel) of natural-layout (n, m)
    tables against the long-double oracle (f64 tensors on the card)."""
    s1 = S1[:, None]
    fin = torch.isfinite(logS)
    live = torch.isfinite(V) & (V > 0)
    live[:, 0] = False
    ss = s.double()
    d_log = ((ss + s1) - logS).abs()[fin].max().item()
    d_srel = (ss - (logS - s1)).abs()[fin].max().item()
    vv = v.double()
    v_rel = ((vv - V).abs()[live] / V[live]).max().item()
    check(bool((torch.isneginf(ss) == ~fin).all()),
          "-inf pattern differs from the oracle's")
    return d_log, d_srel, v_rel


def phase17_oracle(dev, sc, stirling, pyp, card):
    """K1 (G = 1), K2, K3 and the plain fill, each in f32 and f64, against
    the long-double fill_ref at (0.5, 8192, 1024); the native CRP
    generator against the Python one at check.c's MAXDATA.  Returns the
    kernels' launches in the phase."""
    from libstb_tpu_torch import native

    a, N, M = ORACLE
    t0 = phase(f"17 the long-double oracle: fill_ref{ORACLE} vs K1, K2, K3 "
               "and the plain fill, f32 and f64")
    t_run = time.perf_counter()
    logS, V, S1 = native.fill_ref(a, N, M)
    ref_s = time.perf_counter() - t_run
    logS, V = (torch.as_tensor(x, device=dev) for x in (logS, V))
    s1 = torch.as_tensor(stirling.s1_host(a, N), device=dev)
    S1 = torch.as_tensor(S1, device=dev)
    check(bool(((s1 - S1).abs() <= 1e-13 * S1.abs()).all()),
          "host S1 differs from the oracle's (rtol 1e-13)")
    reset_launches(sc)
    rows = {}
    for dt in (torch.float32, torch.float64):
        at = torch.tensor(a, dtype=dt, device=dev)
        fills = {
            "plain": lambda: sc.fill_table_ref(at, N, M),
            "K1": lambda: tuple(x[0] for x in sc.fill_grid_cuda(
                at.reshape(1), N, M)),
            "K2": lambda: sc.fill_table_cuda(at, N, M),
            "K3": lambda: tuple(x.T for x in sc.fill_table_cols_cuda(
                at, N, M)),
        }
        for name, fill in fills.items():
            v, s = fill()
            torch.cuda.synchronize()
            rows[(name, dt)] = oracle_errors(v, s, logS, V, s1)
            del v, s
    launches = dict(sc.LAUNCHES)
    for dt in (torch.float32, torch.float64):
        plain = rows[("plain", dt)]
        for name in ("plain", "K1", "K2", "K3"):
            e = rows[(name, dt)]
            print(f"   {name:5s} {str(dt)[6:]}: max |d log S| {e[0]:.4g}, "
                  f"max |dSrel| {e[1]:.4g}, V max rel {e[2]:.4g}"
                  + (f" (the TPU kernel's |dSrel| at n = 8192: "
                     f"{TPU_K2_DSREL:g})" if name == "K2"
                     and dt == torch.float32 else ""))
            if name == "plain":
                continue
            for i, what in enumerate(("d log S", "dSrel", "V rel")):
                check(e[i] <= 1.5 * plain[i] + 1e-7,
                      f"17: {name} {dt} {what} {e[i]:.4g} > 1.5 x plain "
                      f"{plain[i]:.4g} + 1e-7")
            check(e[1] <= 5e-2 and e[2] < 1e-4,
                  f"17: {name} {dt}: |dSrel| {e[1]:.4g} (<= 5e-2), V rel "
                  f"{e[2]:.4g} (< 1e-4)")
    t_run = time.perf_counter()
    nat = native.crp_generate(*CHECKC_DATA)
    nat_s = time.perf_counter() - t_run
    t_run = time.perf_counter()
    py = pyp.crp_generate(*CHECKC_DATA)
    py_s = time.perf_counter() - t_run
    check(int(nat.N.sum()) == int(py.N.sum()) == 100 * 1000,
          "17: crp_generate item counts")
    print(f"   fill_ref {ref_s:.3f} s (host, long double); crp_generate"
          f"{CHECKC_DATA}: native {1e3 * nat_s:.2f} ms, Python "
          f"{1e3 * py_s:.1f} ms (host) [{card}]")
    print(f"   launches: {launches}")
    done(t0)
    return launches


S1_DISCOUNTS = (0.0, 0.05, 0.5, 0.9)      # 18a: tests/test_stirling.py's
S1_ABS = 5e-4                             # ... and its budget
SPARSE_P, SPARSE_C = (1 << 20) + 17, 4    # 18c: extra_bench.py's shape
CURVE_CHAINS = (1024, 16384)              # 18d: the Quick-start's and 16x
LGCACHE_REPS = 4                          # 18e: the tool's 32 cut to 4


def phase18_tools(dev, sc, agrid, stirling, pyp, card):
    """The JAX package's on-device tools, ported (tools/extra_bench_torch.py,
    tools/lgcache_bench_torch.py), at their own sizes; both data_curve
    routes at the Quick-start's sample_a shape.  Returns the kernels'
    launches in the phase."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import extra_bench_torch as eb
    import lgcache_bench_torch as lb
    from libstb_tpu_torch.samplers import hyper

    torch.cuda.empty_cache()
    reset_launches(sc)
    N, M = 1 << 20, 1024
    t0 = phase(f"18a production make({N}, {M}) through K3 and the anchored "
               "S1: wall, fill, anchors, their copy, the S1 fill")
    mk = eb.bench_make(dev, card, n=N, m=M)
    check(mk["route"] == "fill_table_cols", f"make({N}, {M}) routed to "
          f"{mk['route']}, not K3")
    check(mk["s1_route"] == "anchored"
          and stirling.s1_route(dev, torch.float32, N) == "anchored",
          f"make({N}, {M}) took the {mk['s1_route']} S1, not the anchored")
    tab = stirling.make(N, M, 2 * N, 2 * M, 0.5, use_asympt=True, device=dev)
    v, s = sc.fill_table_cols(torch.tensor(0.5, device=dev), N, M)
    check(tab.cols and torch.equal(tab.vtab, v) and torch.equal(tab.srel, s),
          "18a: make's tables differ from a direct K3 fill")
    hi, lo = stirling.s1_anchored(0.5, N, device=dev)
    check(torch.equal(tab.s1_hi, hi) and torch.equal(tab.s1_lo, lo),
          "18a: make's S1 pair differs from s1_anchored")
    del tab, v, s
    # the JAX package's budget for the anchored pair
    # (tests/test_stirling.py:257-270), at every row and four discounts
    errs = {}
    for a in S1_DISCOUNTS:
        hi, lo = stirling.s1_anchored(a, N, device=dev)
        got = hi.double() + lo.double()
        want = torch.as_tensor(stirling.s1_host(a, N), device=dev)
        errs[a] = (got - want).abs().max().item()
        check(errs[a] < S1_ABS and got[0].item() == 0.0,
              f"18a: anchored S1 at a={a} off by {errs[a]:.3g} (< "
              f"{S1_ABS}), S1(1) = {got[0].item()}")
    print(f"   anchored S1 vs s1_host, max |diff| at {N} rows: "
          + ", ".join(f"a={a} {e:.4g}" for a, e in errs.items())
          + f" (< {S1_ABS})")
    anchored = mk["anchors_ms"] + mk["anchor_h2d_ms"] + mk["s1_fill_ms"]
    print(f"   wall {mk['wall_ms']:.4f} ms: K3 fill {mk['fill_ms']:.4f} ms; "
          f"anchored S1 {anchored:.4f} ms (host anchors "
          f"{mk['anchors_ms']:.4f}, copy {mk['anchor_h2d_ms']:.4f}, fill on "
          f"the card {mk['s1_fill_ms']:.4f}); the host route's S1 + copy "
          f"would be {mk['s1_host_ms'] + mk['split_ms'] + mk['h2d_ms']:.4f} "
          f"ms [{card}]")
    done(t0)

    t0 = phase(f"18b ensure({N // 2} -> {N}): time and peak memory")
    torch.cuda.empty_cache()
    en = eb.bench_ensure(dev, card, n=N, m=M)
    check(en["equal_fresh"], "18b: the grown table differs from a fresh "
          "make")
    print(f"   the call added {(en['peak'] - en['before']) / 1e9:.4f} GB at "
          f"its peak to {en['before'] / 1e9:.4f} GB held (old "
          f"{en['old'] / 1e9:.4f} GB, new {en['new'] / 1e9:.4f} GB) [{card}]")
    done(t0)

    t0 = phase(f"18c sparse sample_a over {SPARSE_P} pairs, C = {SPARSE_C}")
    torch.cuda.empty_cache()
    sp = eb.bench_sparse(dev, card, P=SPARSE_P, C=SPARSE_C)
    a = sp["a"]
    check(bool(((a >= hyper.A_MIN) & (a <= hyper.A_MAX)).all()),
          f"18c: a outside [A_MIN, A_MAX]: {a.tolist()}")
    grid = agrid.make_grid(96, 32, g=16, device=dev)
    ns, ts, _ = eb.sparse_inputs(SPARSE_P, SPARSE_C, dev)
    streamed = grid.data_curve_sparse(ns, ts, chunk=1 << 16)
    whole = grid._data_curve_gather(ns, ts)
    err = ((streamed - whole).abs().max() / whole.abs().max()).item()
    print(f"   a = {a.tolist()}; streamed vs whole-pair gather curve: max "
          f"|diff| / max |curve| {err:.4g}")
    check(err <= 1e-5, f"18c: streamed curve off by {err:.3g} of max |curve|")
    del grid, ns, ts, streamed, whole
    done(t0)

    t0 = phase("18d data_curve by gathers and by the one-hot product at the "
               "Quick-start's sample_a shape")
    grid = agrid.make_grid(512, 128, g=64, device=dev)
    data = pyp.crp_generate(0, 4, 20, 100, 0.5, 10.0)
    n_flat = data.n.reshape(-1)
    ns = torch.as_tensor(n_flat, device=dev)
    r = np.random.default_rng(18)
    for C in CURVE_CHAINS:
        ts = torch.as_tensor(np.where(n_flat > 0, r.integers(
            1, np.maximum(n_flat, 1) + 1, (C, n_flat.size)), 0), device=dev)
        g_ms = cuda_ms(lambda: grid._data_curve_gather(ns, ts), 7)
        gather = grid._data_curve_gather(ns, ts)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            mm = grid._data_curve_mm(ns, ts)
            mm_ms = cuda_ms(lambda: grid._data_curve_mm(ns, ts), 7)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        err = ((mm - gather).abs().max() / gather.abs().max()).item()
        print(f"   {C} chains x {n_flat.size} pairs x {grid.g_max} "
              f"discounts: gather {g_ms:.4f} ms, one-hot product "
              f"{mm_ms:.4f} ms (allow_tf32 on), max |diff| / max |curve| "
              f"{err:.4g} (CUDA events, median of 7) [{card}]")
        check(tuple(mm.shape) == tuple(gather.shape) == (C, grid.g_max),
              "18d: curve shapes")
        check(err <= 1e-5, f"18d: the routes differ by {err:.3g} of max "
              f"|curve| at {C} chains")
    del grid
    done(t0)

    t0 = phase(f"18e lgcache_bench: batch 2^20, {LGCACHE_REPS} reps")
    rows = lb.run(dev, card, reps=LGCACHE_REPS)
    check(all(np.isfinite(x) and x > 0 for x in rows.values()),
          f"18e: {rows}")
    done(t0)
    launches = dict(sc.LAUNCHES)
    print(f"   launches in phase 18: {launches}")
    return launches


# phase 19: the probes of the card's floors (csrc/vpu_probe.cu), each in
# place of a pl.pallas_call site of tools/vpu_probe.py
PROBE_REPLACES = {"write_floor": "tools/vpu_probe.py:93",
                  "alu": "tools/vpu_probe.py:166",
                  "smem": "tools/vpu_probe.py:232",
                  "overlap": "tools/vpu_probe.py:375",
                  "mix": "tools/vpu_probe.py:331",
                  "bisect": "tools/vpu_probe.py:476",
                  "mix_staged": "tools/vpu_probe.py:331",
                  "bisect_storewarps": "tools/vpu_probe.py:476",
                  "bisect_early": "tools/vpu_probe.py:476",
                  "bisect_storewarps_early": "tools/vpu_probe.py:476"}
# 19a's (n, m): a last chunk cut short (40000 rows: 78 chunks of 512 and 64
# rows), and chunks in two waves (2^21 rows: 228 chunks of 9216, 132 SMs)
PROBE_SHAPES = ((40000, 9), (1 << 21, 4))
PROBE_PIECES = (None, 1000)             # the TPU probe's sub-store, and short
PROBE_ALU_R = 8                         # 19a: 64 steps a stream
PROBE_SMEM = ((None, 3), (2048, 5))     # 19a: (chunk or K3's, steps)
PROBE_ITERS = 16                        # 19a: a chain short of its fixed point
# P3's floor: a warp's shared-memory access moves 32 x 8 bytes (scalar f64)
# or 32 x 16 (two rows), through 32 banks of 4 bytes a cycle an SM
SMEM_BYTES_A_CYCLE = 128


def check_probes(dev, vp, tool):
    """19a: each probe kernel against its plain version on the card, and
    each rung of P6's branch bitwise against the ladder's top rung, also
    over a quarter of the blocks (several chunks a block, in turn); returns
    the largest absolute error of each probe and the relative error of
    each issue-rate op."""
    errs = dict.fromkeys(vp.PROBES, 0.0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, m in PROBE_SHAPES:
        for mode in vp.WRITE_MODES:
            for piece in PROBE_PIECES if mode == "piecewise" else (None,):
                piece = piece or vp.PIECE
                got = vp.write_floor_cuda(m, n, mode, piece, device=dev)
                want = vp.write_floor_ref(m, n, mode, piece, device=dev)
                check(all(g is w is None or torch.equal(g, w)
                          for g, w in zip(got, want)),
                      f"19a: write_floor {mode} (piece {piece}) at "
                      f"{(n, m)} differs from its plain version")
        for alu, store in ((True, False), (False, True), (True, True)):
            got = vp.overlap_cuda(m, n, PROBE_ITERS, alu, store, dev)
            want = vp.overlap_ref(m, n, PROBE_ITERS if alu else 0, store,
                                  sms, dev)
            check(all(torch.equal(g, w) for g, w in zip(
                got if store else [got], want if store else [want])),
                  f"19a: overlap (alu {alu}, store {store}) at {(n, m)} "
                  "differs from its plain version")
    rel = {}
    for dtype, ops in vp.ALU_OPS.items():
        dt = "f32" if dtype == torch.float32 else "f64"
        for op in ops:
            for u in vp.ALU_U.get(op, (8,)):
                got = vp.alu_cuda(op, dtype, u, PROBE_ALU_R, vp.ALU_UNROLL,
                                  device=dev)
                want = vp.alu_ref(op, dtype, u, PROBE_ALU_R, vp.ALU_UNROLL,
                                  got.numel(), dev)
                e = ((got - want).abs() / want.abs()).max().item()
                tol = vp.alu_rtol(op, dtype)
                rel[f"{dt}_{op}_u{u}"] = e
                check(bool(torch.isfinite(got).all()) and e <= tol,
                      f"19a: alu {dt} {op} u={u}: relative error {e:.3g} "
                      f"(<= {tol})")
                errs["alu"] = max(errs["alu"],
                                  (got - want).abs().max().item())
    for mode in vp.SMEM_MODES:
        for pad in (True, False):
            for chunk, steps in PROBE_SMEM:
                got = vp.smem_cuda(mode, pad, chunk, steps, device=dev)
                want = vp.smem_ref(mode, torch.float64,
                                   chunk or vp.headline_chunk(sms), steps,
                                   got.numel() // vp.ROW_THREADS, dev)
                check(torch.equal(got, want),
                      f"19a: smem {mode} pad {pad} chunk {chunk} differs "
                      "from its plain version")
    a32 = torch.full((1,), vp.A_SMEM, device=dev)
    for n, m in PROBE_SHAPES:
        # short pieces only where the piece table fits beside the pair
        for piece in PROBE_PIECES if n < (1 << 20) else (None,):
            piece = piece or vp.PIECE
            want = vp.mix_ref(m, n, piece=piece, sms=sms, device=dev)
            for mode in vp.MIX_MODES:
                got = vp.mix_cuda(m, n, mode, piece, device=dev)
                err, ok = vp.mix_errors(got, want)
                check(ok, f"19a: mix {mode} (piece {piece}) at {(n, m)} "
                          "differs from its plain version")
                name = vp.probe_name((), mode)
                errs[name] = max(errs[name], err)
            top = None
            blocks = max(1, vp.cols_plan(n, m, sms).blocks // 4)
            for steps in vp.ladder() + vp.branch():
                # storewarps' columns of V do not fit at (2^21, 4)'s chunks
                if not tool.rung_fits(steps, False, n, m, sms, piece):
                    continue
                got = vp.bisect_cuda(m, n, steps, piece, a32, device=dev)
                want = vp.bisect_ref(m, n, steps, piece=piece, sms=sms,
                                     device=dev)
                err, ok = vp.mix_errors(got, want, steps)
                check(ok, f"19a: bisect {steps[-1]} (piece {piece}) at "
                          f"{(n, m)}: largest difference {err:.3g}")
                name = vp.probe_name(steps)
                errs[name] = max(errs[name], err)
                if steps == vp.BISECT_STEPS:
                    top = got
                elif steps in vp.branch():
                    few = vp.bisect_cuda(m, n, steps, piece, a32, device=dev,
                                         blocks=blocks)
                    for out, how in ((got, ""), (few, f" over {blocks} "
                                                      "blocks")):
                        check(all(torch.equal(g, t)
                                  for g, t in zip(out, top)),
                              f"19a: bisect {steps[-1]} (piece {piece}) at "
                              f"{(n, m)}{how} differs from the top rung")
    return errs, rel


def phase19_probes(dev, vp, card, fills):
    """The probes of the card's floors (tools/vpu_probe_torch.py) and K1-K3
    against them (``fills``: each kernel's time from phases 2c, 5c, 6c).
    Returns the probes' launches in the measuring run and their
    kernels-line fields."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import vpu_probe_torch as tool

    torch.cuda.empty_cache()
    t0 = phase("19a the probes (csrc/vpu_probe.cu) vs their plain versions")
    errs, rel = check_probes(dev, vp, tool)
    print("   write_floor, smem, overlap bitwise equal; alu relative errors: "
          + ", ".join(f"{k} {e:.3g}" for k, e in rel.items())
          + f"; mix and staged bitwise, bisect's ladder and branch "
          f"within its tolerance (largest difference "
          f"{max(errs[x] for x in vp.PROBES if x.startswith('bisect')):.3g})"
          f", the branch bitwise equal to the top rung, at cols_plan's "
          f"blocks and at a quarter of them")
    done(t0)

    t0 = phase("19b tools/vpu_probe_torch.py at full size")
    for name in vp.LAUNCHES:
        vp.LAUNCHES[name] = 0
    res = tool.run(dev, card, tool.SIZES["cuda"])
    launches = dict(vp.LAUNCHES)
    bad = tool.impossible(res)
    check(not bad, f"19b: readings that cannot stand: {bad}")
    fl, alu, wr = res["floors"], res["alu"], res["write"]
    print("   every timed output equal to its plain version (P1, P3, P4 "
          "bitwise); alu relative errors at full size: "
          + ", ".join(f"{k} {v['rel_err']:.3g}" for k, v in alu.items()))
    print("   compiled steps (mark: count / the unrolled loop's steps): "
          + ", ".join(f"{k} {v['mark']} {v['count']}/{v['need']}"
                      for k, v in sorted(res["sass"]["kernels"].items())))
    print(f"   K3's write floor (P1 piecewise): (2^20, 1024) "
          f"{wr['piecewise']['ms']:.4f} ms = {wr['piecewise']['GBps']:.1f} "
          f"GB/s, (2^16, 1024) {wr['piecewise_65536']['ms']:.4f} ms = "
          f"{wr['piecewise_65536']['GBps']:.1f} GB/s; the card's (full) "
          f"{wr['full']['GBps']:.1f} GB/s [{card}]")
    print(f"   f64 ops/s: fma " + ", ".join(
        f"u={u} {alu[f'f64_fma_u{u}']['ops_per_s']:.4g}" for u in (4, 8, 16))
        + f"; div_pos {fl['f64_div_pos_per_s']:.4g}; log_pos "
        f"{fl['f64_log_pos_per_s']:.4g}; SM clock under load "
        f"{res['clocks_sm_under_load']['sm_mhz']} MHz of "
        f"{res['clocks_sm_under_load']['max_sm_mhz']} [{card}]")
    print(f"   K1's issue floor at 64 x 16384 x 1024: "
          f"{fl['kernels']['K1']['issue_floor_ms']:.4f} ms; overlap "
          f"fraction {fl['overlap_fraction']:.4f} (at "
          f"{fl['overlap_iters']} FMA steps a column)")
    print("   ladder marks (count / the rung before / need): " + ", ".join(
        f"{k} {v['count']}/{v['before']}/+{v['need']}"
        for k, v in res["sass"]["ladder"].items()))
    print(f"   launches in phase 19b: {launches}")
    done(t0)

    t0 = phase("19c K1-K3 against the measured floors; the probes' plain "
               "and library times")
    for kern, ms in fills.items():
        f = fl["kernels"][kern]
        b_ms, b_by = bound(f["cells"], 4)
        print(f"   {kern} {ms:.4f} ms: data-sheet bound {b_ms:.4f} ms "
              f"({b_by}) {100 * b_ms / ms:.2f}%; measured write floor "
              f"{f['write_floor_ms']:.4f} ms ({f['write_from']}) "
              f"{100 * f['write_floor_ms'] / ms:.2f}%; measured issue floor "
              f"{f['issue_floor_ms']:.4f} ms "
              f"{100 * f['issue_floor_ms'] / ms:.2f}%; both at the measured "
              f"overlap {f['floor_ms']:.4f} ms "
              f"{100 * f['floor_ms'] / ms:.2f}% [{card}]")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n, m = tool.K3_SHAPES[0]
    none = "no PyTorch call computes a probe's orbit"
    probes = {}
    plain = cuda_ms(lambda: vp.write_floor_ref(m, n, "full", device=dev), 3)
    v = torch.empty((m, n), device=dev)
    s = torch.empty_like(v)
    col = 1 + (torch.arange(m, device=dev) % 7).float()[:, None]
    copy = (lambda: (v.copy_(col.expand(m, n)),
                     s.copy_((col + 1).expand(m, n))))
    copy()
    probes["write_floor"] = {
        "max_abs_err": errs["write_floor"], "ms": wr["full"]["ms"],
        "plain_ms": plain, "bound_ms": 2 * 4 * m * n / HBM_BPS * 1e3,
        "bound_by": "bytes", "library_ms": cuda_ms(copy, 5),
        "library": "out.copy_(col.expand(m, n)) for V and for Srel"}
    del v, s
    row = alu["f64_fma_u8"]
    plain = cuda_ms(lambda: vp.alu_ref(
        "fma", torch.float64, 8, tool.SIZES["cuda"]["alu_r"], vp.ALU_UNROLL,
        row["threads"], dev), 1)
    probes["alu"] = {
        "max_abs_err": errs["alu"], "ms": row["ms"], "plain_ms": plain,
        "bound_ms": max(2 * row["ops"] / F64_FLOPS,
                        8 * row["threads"] / HBM_BPS) * 1e3,
        "bound_by": "operations", "library_ms": None, "library": none}
    row = res["smem"]["load1_pad"]
    threads = sms * vp.ROW_THREADS
    plain = cuda_ms(lambda: vp.smem_ref("load1", torch.float64, row["chunk"],
                                        row["steps"], sms, dev), 1)
    # the shared memory's bytes (each row read once a step, 8 bytes, at
    # SMEM_BYTES_A_CYCLE an SM at the card's top SM clock), or the f64
    # multiply and add a row (two instructions, at half the FMA data
    # sheet's 34 TFLOP/s each)
    clock_hz = res["clocks_sm_under_load"]["max_sm_mhz"] * 1e6
    rows_read = threads * row["steps"] * (row["chunk"] // vp.ROW_THREADS)
    s_ms = 8 * rows_read / (SMEM_BYTES_A_CYCLE * sms * clock_hz) * 1e3
    o_ms = 2 * rows_read / (F64_FLOPS / 2) * 1e3
    probes["smem"] = {
        "max_abs_err": errs["smem"], "ms": row["ms"], "plain_ms": plain,
        "bound_ms": max(s_ms, o_ms),
        "bound_by": "bytes" if s_ms >= o_ms else "operations",
        "library_ms": None, "library": none}
    iters = fl["overlap_iters"]
    row = res["overlap"][str(iters)]
    plain = cuda_ms(lambda: vp.overlap_ref(m, n, iters, device=dev), 1)
    plan_blocks = vp.cols_plan(n, m, sms).blocks
    flops = 2 * 4 * iters * vp.ROW_THREADS * plan_blocks * m
    b_ms = 2 * 4 * m * n / HBM_BPS * 1e3
    o_ms = flops / F64_FLOPS * 1e3
    probes["overlap"] = {
        "max_abs_err": errs["overlap"], "ms": row["both_ms"],
        "plain_ms": plain, "bound_ms": max(b_ms, o_ms),
        "bound_by": "bytes" if b_ms >= o_ms else "operations",
        "library_ms": None, "library": none}
    # P5 / P6 at (2^16, 1024), the shape whose per-column time the ladder
    # splits: P5's bound its bytes, P6's top rung's the larger of its bytes
    # and its f64 operations (tool.ladder_flops)
    n, m = tool.K3_SHAPES[1]
    lad = res["ladder"][str(n)]
    k = lad["chunk"] // vp.ROW_THREADS
    top_steps = vp.ladder()[-1]
    b_ms = 2 * 4 * m * n / HBM_BPS * 1e3
    o_ms = tool.ladder_flops(top_steps, k) * m * n / F64_FLOPS * 1e3
    top_bound = (max(b_ms, o_ms), "bytes" if b_ms >= o_ms else "operations")
    for name in ("mix", "bisect", "mix_staged", "bisect_storewarps",
                 "bisect_early", "bisect_storewarps_early"):
        rung = ("handoff" if name == "bisect" else name.split("_", 1)[-1])
        row = lad["rungs"][rung]
        bnd, by = (b_ms, "bytes") if name.startswith("mix") else top_bound
        probes[name] = {
            "max_abs_err": max(errs[name], row["max_abs_err"]),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": bnd,
            "bound_by": by, "library_ms": None,
            "library": "no PyTorch call computes the column recurrence"}
    for key, sh in res["ladder"].items():
        k3_6c = fills[f"K3_{key}"]
        print(f"   ladder at ({sh['n']}, {sh['m']}), us a column (+ over the "
              f"rung before): {tool.ladder_summary(sh)} [{card}]")
        print(f"   K3 at ({sh['n']}, {sh['m']}): {k3_6c:.4f} ms a call in "
              f"6c = {k3_6c * 1e3 / sh['m']:.4f} us a column; beside the "
              f"ladder its device time {sh['k3_ms']:.4f} ms a call (host "
              f"gap {sh['k3_host_ms']:.4f} ms); the top rung's "
              f"{sh['rungs'][top_steps[-1]]['ms']:.4f} ms is "
              f"{100 * sh['top_share']:.2f}% of K3's device time, "
              f"{100 * sh['rungs'][top_steps[-1]]['ms'] / k3_6c:.2f}% of "
              f"6c's call [{card}]")
    for key, sh in res["ladder_short"].items():
        print(f"   ladder at ({sh['n']}, {sh['m']}), us a column: "
              f"{tool.ladder_summary(sh)}; K3 {sh['k3_us_col']:.4f} [{card}]")
    for key, f in res["fit"].items():
        print(f"   fill + m x period at n = {key} (m = "
              f"{tool.fit_ms(res, key)}): {tool.fit_summary(f)} [{card}]")
    for name, p in probes.items():
        print(f"   {name}: {p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, "
              f"bound {p['bound_ms']:.4f} ms ({p['bound_by']}), library "
              f"{p['library_ms']} [{card}]")
    torch.cuda.empty_cache()
    done(t0)
    return launches, probes


def main():
    t0 = phase("0 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "the port has no CPU fallback to smoke-test")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sys.path.insert(0, ROOT)
    from libstb_tpu_torch.core import agrid, stirling
    from libstb_tpu_torch.models import driver, pyp
    from libstb_tpu_torch.ops import stirling_cuda as sc
    done(t0)
    paths = {}                 # launches of each main path, by phase

    t0 = phase("1 build K1, K2, K3, the TI sweep, the slice moves, the "
               "probes and the native oracle")
    from libstb_tpu_torch import native
    from libstb_tpu_torch.ops import _nvcc
    from libstb_tpu_torch.ops import slice_cuda, ti_cuda
    from libstb_tpu_torch.ops import vpu_probe_cuda as vp
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(native.build)      # g++ beside the nvcc processes
        _nvcc.bind_all()                     # every registered library
        so = gxx.result()
    check(native.available(), "the native oracle did not load")
    names = ", ".join(lib.source.name for lib in _nvcc.LIBRARIES.values())
    done(t0, f"({names} -> sm_90a; {so.name} by g++)")

    t0 = phase("2a K1 vs plain at (8, 160, 48) and tile edges")
    avec = torch.linspace(0.0, 0.9, 8, dtype=torch.float64, device=dev)
    v64, s64 = sc.fill_grid_ref(avec, 160, 48)
    v, s = sc.fill_grid_cuda(avec.float(), 160, 48)
    torch.cuda.synchronize()
    v_rel, s_abs, _ = fill_errors(v, s, v64, s64)
    check(v_rel < 2e-5 and s_abs < 1e-4,
          f"f32 K1: V rel {v_rel:.3g} (< 2e-5), |dSrel| {s_abs:.3g} (< 1e-4)")
    for gi, a in enumerate(avec.tolist()):
        s1 = torch.as_tensor(stirling.s1_host(a, 48), device=dev)
        diag = torch.diagonal(s[gi, :48, :48]).double()[1:]
        check(bool(((diag + s1[1:]).abs() < 2e-5).all()),
              f"diagonal != -S1 at a={a}")
    v_d, s_d = sc.fill_grid_cuda(avec, 160, 48)
    vd_rel, sd_abs, _ = fill_errors(v_d, s_d, v64, s64)
    check(vd_rel < 1e-12 and sd_abs < 1e-10,
          f"f64 K1: V rel {vd_rel:.3g}, |dSrel| {sd_abs:.3g}")
    v_n, s_n = sc.fill_grid_cuda(avec.float(), 160, 48, with_srel=False)
    check(s_n is None and torch.equal(v_n, v), "with_srel=False path")
    for n, m in TILE_EDGES:
        for G in (1, 64):
            av = torch.linspace(0.0, 0.9, G, dtype=torch.float64, device=dev)
            e64 = sc.fill_grid_ref(av, n, m)
            for dt, v_tol, s_tol in ((torch.float32, 2e-5, 1e-4),
                                     (torch.float64, 1e-12, 1e-10)):
                e_v, e_s, _ = fill_errors(*sc.fill_grid_cuda(av.to(dt), n, m),
                                          *e64)
                check(e_v < v_tol and e_s < s_tol,
                      f"K1 {dt} G={G} ({n}, {m}): V rel {e_v:.3g}, |dSrel| "
                      f"{e_s:.3g}")
    done(t0, f"f32 V rel {v_rel:.3g} |dSrel| {s_abs:.3g}; "
             f"f64 V rel {vd_rel:.3g} |dSrel| {sd_abs:.3g}; "
             f"{len(TILE_EDGES)} tile edges x G = 1, 64 x f32, f64 in bounds")

    t0 = phase(f"2b K1 vs f64 plain at {BENCH_SHAPE}")
    G, N, M = BENCH_SHAPE
    avec = torch.linspace(0.01, 0.9, G, dtype=torch.float32, device=dev)
    v, s = sc.fill_grid_cuda(avec, N, M)
    torch.cuda.synchronize()
    pick = torch.arange(0, G, 9, device=dev)[:8]       # 8 of the 64
    v64, s64 = sc.fill_grid_ref(avec[pick].double(), N, M)
    v_rel, s_abs, max_abs = fill_errors(v[pick], s[pick], v64, s64)
    print(f"   V max rel err {v_rel:.6g}, max |dSrel| {s_abs:.6g}, "
          f"max abs err {max_abs:.6g} (a = {avec[pick].tolist()})")
    check(v_rel < 1e-4 and s_abs <= 5e-2,
          f"bench shape: V rel {v_rel:.3g} (< 1e-4), |dSrel| {s_abs:.3g} "
          "(<= 5e-2)")
    del v, s, v64, s64
    done(t0)

    t0 = phase("2c times (CUDA events, median)")
    nbytes = G * N * M * 8
    k_ms = cuda_ms(lambda: sc.fill_grid_cuda(avec, N, M), 5)
    p_ms = cuda_ms(lambda: sc.fill_grid_ref(avec, N, M), 3)
    x = torch.rand(128 << 20, device=dev)              # 0.5 GB of f32
    y = torch.empty_like(x)
    torch.mul(x, 1.0000001, out=y)
    c_ms = cuda_ms(lambda: torch.mul(x, 1.0000001, out=y), 9)
    roof = 2 * x.numel() * 4 / (c_ms * 1e-3)
    k_bw = nbytes / (k_ms * 1e-3)
    del x, y
    torch.cuda.empty_cache()
    k1_bound, k1_by = bound(G * N * M, 4)
    print(f"   K1 {k_ms:.4f} ms = {k_bw / 1e9:.1f} GB/s = "
          f"{100 * k_bw / roof:.1f}% of the copy roofline "
          f"({roof / 1e9:.1f} GB/s r+w) = {100 * k1_bound / k_ms:.2f}% of "
          f"its bound {k1_bound:.4f} ms ({k1_by}); plain f32 fill "
          f"{p_ms:.1f} ms [{card}]")
    done(t0)

    phase2d_wide(dev, sc, agrid, card)

    t0 = phase(f"3 main path: make_grid + run_gibbs (1024 chains x "
               f"{MAIN_ITERS})")
    reset_launches(sc, ti_cuda, slice_cuda)
    grid = agrid.make_grid(512, 128, g=64, device=dev)
    data = pyp.crp_generate(0, 4, 20, 100, 0.5, 10.0)
    cfg = driver.GibbsConfig(iters=MAIN_ITERS, bcycle=2, acycle=5)
    t_run = time.perf_counter()
    out = driver.run_gibbs(torch.Generator(device=dev).manual_seed(1), data,
                           grid, 1024, 0.5, 10.0, cfg)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    paths["3"] = {**sc.LAUNCHES, **ti_cuda.LAUNCHES, **slice_cuda.LAUNCHES}
    launches = paths["3"]["fill_grid"]
    check(launches >= 1, "the main path did not launch K1")
    check((paths["3"]["ti_sweep_grid"], paths["3"]["ti_sweep"])
          == (MAIN_ITERS, 0),
          f"{MAIN_ITERS} TI sweeps launched the TI kernel's grid route "
          f"{paths['3']['ti_sweep_grid']} times and its rows route "
          f"{paths['3']['ti_sweep']}")
    moves = -(-MAIN_ITERS // cfg.bcycle) - (-MAIN_ITERS // cfg.acycle)
    check(paths["3"]["slice_move"] >= moves,
          f"{moves} slice moves launched the slice kernel "
          f"{paths['3']['slice_move']} times")
    for k in ("tave", "Tave", "aave", "bave", "t", "T", "a", "b"):
        check(bool(torch.isfinite(out[k].double()).all()), f"{k} not finite")
    check(tuple(out["Tave"].shape) == (1024, 4), "Tave shape")
    aave, bave = out["aave"], out["bave"]
    check(bool(((aave >= 0.01) & (aave <= 0.98)).all()), "a outside bounds")
    check(bool(((bave >= 0.01) & (bave <= 2000)).all()), "b outside bounds")
    occ = torch.as_tensor((data.n > 0).sum(axis=1), device=dev)
    tot = torch.as_tensor(data.N, device=dev)
    for T_ in (out["T"], out["Tave"]):
        check(bool(((T_ >= occ) & (T_ <= tot)).all()),
              "T_j outside [occupied categories, N_j]")
    print(f"   E[T_j] {out['Tave_mean'].tolist()} E[a] "
          f"{out['aave_mean'].item():.6g} E[b] {out['bave_mean'].item():.6g}")
    print(f"   run_gibbs wall {run_s:.3f} s; K1 launches {launches}, TI "
          f"sweep launches {paths['3']['ti_sweep_grid']}, slice launches "
          f"{paths['3']['slice_move']} for {moves} moves [{card}]")
    done(t0)

    t0 = phase("4 gate vs JAX CPU-f64 moments (f32 on this card)")
    with open(GATE_REF) as f:
        ref = json.load(f)
    cfg = driver.GibbsConfig(**ref["config"])
    ok = True
    reset_launches(sc)
    slice_s = []
    for seed in ref["seeds"]:
        good, run_s, _ = gate_seed(dev, agrid, driver, pyp, ref, seed, cfg)
        ok &= good
        slice_s.append(run_s)
    check(ok, "gate: a posterior moment is outside its band")
    gate_launches = dict(sc.LAUNCHES)
    print(f"   launches in the gate: {gate_launches}")
    check(gate_launches["fill_grid"] >= 1, "the gate did not launch K1")
    done(t0)

    k2 = phase5_k2(dev, sc, stirling, card, roof)
    k3 = phase6_k3(dev, sc, stirling, card, roof)
    paths["7"] = phase7_table(dev, sc, stirling, card)
    phase8_crossover(dev, sc, stirling, card)
    paths["9"] = phase9_ars(dev, sc, agrid, driver, pyp, card, ref, slice_s)
    paths["10"] = phase10_hyper(dev, sc, agrid, stirling, pyp, card)
    with open(CHECK_REF) as f:
        paths["11"] = phase11_check(dev, sc, agrid, driver, pyp, card,
                                    json.load(f))
    paths["12"] = phase12_checkc(dev, sc, stirling, pyp, card)
    paths["13"] = phase13_traces(dev, sc, agrid, driver, pyp, card, ref)
    with open(HPYP_REF) as f:
        paths["14"] = phase14_hpyp(dev, sc, agrid, pyp, card, json.load(f))
    with open(NGG_REF) as f:
        ngg_one = phase15_ngg(dev, card, json.load(f))
    paths.update(phase16_multidevice(dev, card, ngg_one))
    paths["17"] = phase17_oracle(dev, sc, stirling, pyp, card)
    paths["18"] = phase18_tools(dev, sc, agrid, stirling, pyp, card)
    fills = {"K1": k_ms, "K2": k2["ms"], "K3_1048576": k3.pop("ms_2_20"),
             "K3_65536": k3["ms"]}
    paths["19"], probes = phase19_probes(dev, vp, card, fills)
    # every kernel of a path was launched in that path's own run
    for path, names in (("3", ["fill_grid", "ti_sweep_grid"]),
                        ("7", ["fill_table", "fill_table_cols"]),
                        ("9", ["fill_grid"]),
                        ("10", ["fill_table", "fill_table_cols",
                                "ti_sweep", "ti_sweep_grid"]),
                        ("11", ["fill_grid"]),
                        ("12", ["fill_table"]),
                        ("13", ["fill_grid"]),
                        ("14", ["fill_grid"]),
                        ("16a", ["fill_grid"]),
                        ("16b", ["fill_grid"]),
                        ("16c", ["fill_grid"]),
                        ("16d", ["fill_grid"]),
                        ("16f", ["fill_grid"]),
                        ("17", ["fill_grid", "fill_table",
                                "fill_table_cols"]),
                        ("18", ["fill_grid", "fill_table_cols"]),
                        ("19", list(vp.PROBES))):
        for name in names:
            check(paths[path][name] >= 1,
                  f"phase {path} did not launch {name}")

    def path_launches(*names):
        by_path = {p: sum(c[n] for n in names) for p, c in paths.items()
                   if names[0] in c}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path}

    print(json.dumps({"kernels": [{
        "name": "fill_grid",
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/fill_grid.cu",
        "replaces": "libstb_tpu/ops/stirling_pallas.py:71",
        **path_launches("fill_grid"),
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }, {
        "name": "fill_table",
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/fill_table.cu",
        "replaces": "libstb_tpu/ops/stirling_pallas.py:293",
        **path_launches("fill_table"),
        **k2,
    }, {
        "name": "fill_table_cols",
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/fill_table_cols.cu",
        "replaces": "libstb_tpu/ops/stirling_pallas.py:652",
        **path_launches("fill_table_cols"),
        **k3,
    }, {
        "name": "ti_sweep",
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/ti_sweep.cu",
        "replaces": None,
        **path_launches("ti_sweep", "ti_sweep_grid"),
        "launches_by_route": {
            "rows": path_launches("ti_sweep")["launches"],
            "grid": path_launches("ti_sweep_grid")["launches"]},
    }, {
        "name": "slice_move",
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/slice_move.cu",
        "replaces": None,
        **path_launches("slice_move"),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "libstb_tpu_torch/csrc/vpu_probe.cu",
        "replaces": PROBE_REPLACES[name],
        **path_launches(name),
        **probes[name],
    } for name in vp.PROBES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main()
