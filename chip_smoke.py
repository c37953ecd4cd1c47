#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (sampler_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints one line with its result and elapsed seconds):
  0 device   the card (nvidia-smi name and power limit), torch and CUDA;
             exits nonzero when no CUDA device is present
  1 build    nvcc builds every kernel in sampler_tpu_torch/csrc into
             sampler_tpu_torch/_build/ (ptxas register/shared-memory lines)
  2 kernels  fused_color_draw and banded_gather against their plain PyTorch
             versions at the flagship shapes (1024x1024 Ising grid, 512
             random chains, both colors), on the planner's window starts
             and on starts shifted off the 256 grid and clipped to P - W;
             again at 48 chains (the 16-byte variants) and 37 (the byte
             variants), and on a 128x128 grid of degree 9 (past the draw's
             unrolled D = 1..8) at 512 and 37 chains
  3 oracle   infer_mc on an evidence-clamped 16x16 grid, fused and unfused,
             against exact enumeration (|dp| < 0.01)
  4 flagship infer_mc on the 1024x1024 grid with 512 chains, fused (the main
             path) and unfused; kernel times (beside their times before
             the 16-byte redesign), bounds, achieved TB/s, the draw's
             SASS issue bound, rates, peak memory, and where a counted
             fused sweep's time goes (the draws, the tally, the rest);
             the draw's world-write mode (the main path's) against its
             output mode and the masked block write, bit for bit (every
             color, an evidence mask, the sample-evidence mask, a block
             shorter than the tiles drawn); tally_counts' time, bound and
             plain (eager-pass) time on the flagship's world
  5 grad     the learning flagship (the 1024x1024 grid, every other
             variable labelled evidence, 256 chains a world): grad_pair_tile
             against its plain version (both colors, both coefficient
             streams, two launches bit for bit), and the whole kernel-route
             gradient against the chunked route (banded_gather), the
             records route (a row_chunk: grad_records_sum's 3 launches)
             and the
             per-factor gradient; every variant of the kernel on random
             streams (GRAD_STREAM_CASES: 256, 512, 48 and 37 chains and a
             world off the 16-byte grid, D = 1..9 and 24, 1, 2 and 64
             weights, unaligned and clipped window starts, neighbours
             around the window and past P, weight ids out of range, streams
             off the 16-byte grid), each against its plain version and
             twice bit for bit; kernel time (beside its time before the
             redesign), bound, the L2 -> SM bytes as a diagnostic, the
             flagship variant's ptxas registers and SASS issue bound
  6 learn    learn_mc on the learning flagship (10 epochs of 2 sweeps, the
             main learning path): launches, rate, peak memory and where an
             epoch's time goes (with one fused_color_draw launch at this
             width); the bytes init_values_mc allocates and the
             run's peak, each with the unchunked int32 draw it had before
             and with the chunked draw; then the grad_pair_tile and
             records gradient routes learn the same weights on a 16x16
             grid, and a labelled coin (no fused draw) reaches its
             log-odds with grad_records_sum's 3 launches an epoch and no
             row chunk of the chunked gradient
  7 dm kernels  fused_dm_draw and banded_gather_multi against their plain
             versions at the triple flagship's shapes (big_triple_grid(512,
             512): 3 colors, band_k 2, arity 3; 1024 random chains, every
             color; the gather also on shifted, clipped and past-P window
             starts), and on small graphs with band_k 1 and with arity 2;
             every variant of the draw: 1024, 512 and 48 chains (16-byte
             rows; a warp's table of sums at 512 and 1024), 37 chains and
             48 one byte off the 16-byte grid (byte rows), and on random
             streams D = 1..9 and 12, Kw 1..3, W a power of two and not;
             kernel times (beside the time before the redesign), bounds,
             the SASS issue bound; the world-write mode as in phase 4
  8 oracle dm  infer_mc on three small fusedm graphs (triple grids with
             band_k 1 and 2, a 3-colored Ising grid), fused and unfused,
             against exact enumeration (|dp| < 0.01)
  9 triple   infer_mc on the triple flagship at 1024 chains, fused (the
             default modes, the main path of this class) and unfused
             (fused off): launches, rates, peak memory and where a fused
             sweep's time goes; then one learn_mc epoch on the labelled
             triple flagship at 256 chains a world, by part, with the
             gradient on the records route (grad_records_sum: 3 launches,
             no banded_gather_multi) and on the chunked route
 10 cat kernel  fused_cat_draw against its plain version at the Potts
             flagship's shapes (big_potts_grid(512, 512, card=4): 2 colors,
             one affinek tier; 512 random chains, both colors): logits
             exactly equal, draws differing only where the top two scores
             lie within CAT_GAP; again at 48 and 37 chains and 48 one byte
             off the 16-byte grid, on a card-20 grid (K looped) and on a
             grid with mixed cardinalities (every draw below its
             variable's card), and on random streams D = 1..9 and 12, K =
             2..9 and 20; kernel time (beside the time before the
             redesign), plain time, a bound with three terms (bytes, f32
             operations, logs at the SFU rate) and the SASS issue bound;
             the world-write mode as in phase 4
 11 oracle cat  infer_mc, fused and unfused, against exact enumeration
             (|dp| < 0.01) on a 16x16 evidence-clamped card-3 Potts grid
             (fused_cat_draw), fixtures.categorical_graph and mixed_graph
             (the unbanded candidate path) and a card-200 graph (int32
             worlds, band off)
 12 potts    infer_mc on the Potts flagship at 512 chains, fused (the
             default modes, the main path of this class) and unfused:
             launches, rates, peak memory and a fused sweep by part; then
             learn_mc on the labelled flagship (bench.py's categorical
             learning configuration: 512 chains a world, 10 epochs of 2
             sweeps): launches (grad_records_sum 3 an epoch, no
             banded_gather), rate, peak memory and an epoch by part with
             the gradient on the records route and on the chunked route;
             one
             banded_gather launch at the chunked gradient's shapes, and
             its launches' share of the chunked epoch
 13 tally    tally_counts against its plain version, exactly, on the three
             flagships' worlds (phases 4, 9, 12) and on random worlds
             (TALLY_CASES: K = 2, 4, 17 and 200 at 8, 24, 37, 48, 128 and
             512 chains, and 2000; int32 worlds above 127; values below 0
             and at or past K mixed in; aligned and one element off the
             16-byte grid); its ms beside its bound at 128, 512 and 1024
             chains (TALLY_TIMED)
 14 kbc oracle  the hub tier: infer_mc on tests/test_hub.py's star graphs
             (boolean, hub_cap 6; card 3, hub_cap 5; chunks of 4) against
             exact enumeration (|dp| < 0.01 and 0.012), and the gradient
             over dense and hub tiers, on the records route and on the
             chunked route, against the per-factor one (within 1e-4) on
             random_kbc_graph(300, 900, ...)
 15 kbc      bench.py's KBC inference cell: random_kbc_graph(500000,
             1500000, skew 1.1, windows of 2000, 1e5 weights), greedy
             coloring, RCM order, compile_graph(band_wmax=32768,
             hub_cap=256), 1024 chains, the default modes ("off", "cuda":
             dm_gather_draw once a color over every deltam tier, the hub
             tier drawn in it); host seconds, colors, tiers, rate over
             bench.py's 5 x 2 counted sweeps, peak memory,
             dm_gather_draw's launches (colors x sweeps), no eager
             color_delta_multilin call and no hub_color_draw (its
             index_add_); the host ms of each counted run until it
             returns and the cyclic collector's runs and ms in the
             loop; one more run's host profile (host_profile: wall,
             enqueue, collector, torch.profiler's ops of most self CPU
             time); a sweep by part on the kernel route
             (dm_gather_draw, tally) beside the eager route's (fused
             off: gathers, the hub's index_add_, draws, masked writes,
             tally)
 15b dm gather  dm_gather_draw against its plain version at phase 15's
             shapes: every color in one launch over its deltam tiers, the
             hub's deep rows drawn too, on a random world of 1024 chains:
             the deltas exact (the delta mode's too), the draws equal but
             within DRAW_GAP of p (counted); the world-write launch of
             the main path against the output mode and the masked block
             writes, bit for bit; random streams (DM_GATHER_STREAMS: D =
             1..9, 12, 16, 256, 512 and 600, A1 1 and 2, 1024, 48 and 37
             chains, values off the 16-byte grid, indices at the world's
             last row and outside it) and random hub streams
             (DM_HUB_STREAMS: rows of 0 to 40 chunks); malformed hub
             chunk offsets raise before a launch; the ms a sweep
             (a launch a color) beside the kernel's before its redesign
             (a launch a tier and color), each tier's ms a sweep
             alone and its launches, bounds (bytes: distinct rows), the
             gathered rows' bytes, the plain version's ms, and the ptxas
             registers and spills of each variant
 16 kbc learn  bench.py's KBC learning cell: random_kbc_graph(200000,
             600000, 1e4 weights), half labelled, 256 chains a world, 10
             epochs of 2 sweeps: rate, peak memory, an epoch by part with
             the gradient on the records route and on the chunked route,
             and one fold's host profile; dm_gather_draw's launches, no
             eager color_delta_multilin; grad_records_sum 3 launches an
             epoch (all five tiers), no chunked row chunk
 16b grad records  the records route (grad_records_sum: its owner
             records' terms, every tier in one launch, then the float64
             sums by weight in a fixed order) against its plain version
             at the learning shapes of phases 16, 9 and 12 (random
             worlds, both owner masks), on random streams
             (GRAD_RECORD_STREAMS: A-1 = 0, 1, 2 and 4, D 1..9, 256 and
             512, the nine boolean types, NC not a multiple of 16, a world
             off the 16-byte grid, int32 worlds, hub chunks, 1-3 colors)
             and on GRAD_RECORD_TIERS mixed tiers in one plan (two terms
             launches): the owner terms bit for bit without RATIO, within
             RECORD_RATIO_TOL with it, each weight within one float32 ulp
             of the plain sum, two calls byte-equal; the per-tier
             grad_records kernel (the route before) against
             grad_records_plain on each of those tiers and streams, bit
             for bit without RATIO, two launches byte-equal; at most 3
             launches and no segment_reduce a gradient; each cell's ms
             beside its bound, the plain version's and the route before
             this design (grad_records a tier and segment_reduce a tier)
 17 cli kbc  the dw gibbs command (python -m sampler_tpu_torch.cli, a child
             process) on phase 15's graph, written by the port's binary
             writer, with phase 15's compile settings, 1024 chains, 2
             learning epochs of 2 sweeps, 2 burn-in and 10 counted sweeps:
             seconds to write, load, compile, learn and infer, the
             command's rate (its whole inference, and its counted sweeps
             alone) beside phase 15's, peak memory, the output
             files checked (one line a variable and category, one a
             weight); dm_gather_draw launched once a color and sweep
 18 cli oracle  the command in this process (cli.main) against exact
             enumeration: a 3x3 Ising grid (|dp| < 0.015), the labelled coin
             (within 0.2 of its log-odds), sparse-weight graphs (|dp| <
             0.01; one of them with checkpoints); a labelled sparse-weight
             graph learned through the command (grad_records_sum 3
             launches an epoch) and its gradient on the records route
             beside the chunked route (equal within GRAD_RTOL; their ms, no row
             chunk on the kernel route); 256x256 Ising, Potts and triple
             grids with learning,
             each kernel's launches on the command's path exactly counted
 19 cli resume  kill and resume: the labelled 256x256 grid killed by the
             fault hook after 5 checkpoint saves (a child process) and
             resumed writes the bytes of the uninterrupted run, and so
             does a small KBC graph with a hub tier; the two
             killed runs go side by side while this process makes the
             uninterrupted ones
 20 gs ising  chain and graph sharding (sampler_tpu_torch.parallel) on the
             1024x1024 grid (align=32, shards=4), 512 chains in all, 2 +
             10 sweeps a mesh; the ranks share this one card: mesh (1, 1)
             over NCCL, (2, 1) over Gloo, (1, 4) over Gloo in halo and
             all-gather modes (equal marginals, bit for bit, and equal
             checkpointed worlds); each mesh's mean and max |dp| against
             an unsharded infer_mc run within GS_NOISE times two
             unsharded seeds'; fused_color_draw on rank 2's local slice
             against its plain version and in world-write mode at the
             rank's rows; every rank's launches; two epochs of
             learn_sharded at (2, 1) (grad_pair_tile); the mesh's reduced
             gradient at (2, 1) and at (1, 4) under halo against the
             unsharded graph's on the same worlds; the halo plan,
             the bytes a color step exchanges, a counted sweep by part
             (draws, exchange, tally) and each rank's peak memory
 21 gs kbc   phase 15's graph compiled with shards=2 on a 1 x 2 Gloo mesh
             (all-gather; the hub tier split by chunks), 1024 chains, 2 +
             10 sweeps: the noise bound against two unsharded runs (on the
             numpy colorer's coloring; on the native one the mean bound,
             the max reported beside three unsharded seeds'), the
             rate, a sweep by part, peak memory, every rank's
             dm_gather_draw launches, and dm_gather_draw on rank 1's
             local slice against its plain version and in world-write
             mode at its rows; one learn_gs epoch on
             phase 16's graph, by part, and the mesh's reduced gradient
             there against the unsharded graph's
 22 gs cli   the gibbs command's sharded route (--n_graph_shards 2, the
             same 1 x 2 ranks): the 3x3 grid against exact enumeration
             (|dp| < 0.015), the labelled coin (within 0.2), the labelled
             256x256 Ising, Potts and triple grids (every rank launches
             fused_color_draw, fused_cat_draw, fused_dm_draw and
             tally_counts); the same grids at shards=2 through infer_gs
             within the noise bound of two unsharded runs, and the Potts
             and triple grids' fused draws on rank 1's local slice
             against their plain versions and in world-write mode at its
             rows; and a run killed by the fault hook (a child
             process with its own ranks) and resumed writes the bytes of
             the uninterrupted checkpointed run
 23 host     the native host library against its numpy plain versions:
             host seconds by part on phase 15's KBC graph (generation,
             greedy coloring by each route, RCM, compile_graph and its
             stream fill alone); the two routes' compiled graphs equal,
             every array
 24 scale ising  python -m sampler_tpu_torch.scale_gpu at its defaults:
             the 5120x5120 grid at 128 chains (worlds of 3.4e9 elements,
             past 2^31): its compile fills every tier by both routes
             (equal, timed apart: the grid's host seconds by part); rate,
             peak memory, memory_budget, launches;
             fused_color_draw against its plain version on tiles around
             and past world element 2^31 (output and world-write modes),
             tally_counts exactly equal to its plain version on the whole
             world, both kernels' ms a launch beside their bounds
 25 scale kbc  python -m sampler_tpu_torch.scale_kbc, cut for time to 2e6
             variables and 2 + 5 x 1 sweeps (its defaults: 4e6 and 2 + 5 x
             2), 1024 chains: rate, peak memory beside the bytes of the
             worlds and the graph, dm_gather_draw's launches, a sweep by
             part on the kernel and the eager route
 26 scale demo  python -m sampler_tpu_torch.scale_demo on a 2048x2048 grid
             (cut from its 3200x3200 default for time) over 4 graph ranks
             sharing the card (Gloo), 6 sweeps: the
             marginals' shape and finiteness, the halo plan engaged, every
             rank's launches, memory_budget and sharded bytes a variable
Then one JSON line with every kernel's numbers, and as the last line
{"ok": true, "device": {...}}.  Any failed check ends the run nonzero.
The script imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12      # H100 SXM int8 tensor cores, dense
# int32 outside the tensor cores: 64 a clock an SM (NVIDIA's Hopper
# architecture paper) on 132 SMs at the 1.98 GHz boost clock
INT32_OPS_PER_S = 64 * 132 * 1.98e9
GRID = 1024
CHAINS = 512
BURN, SWEEPS = 3, 20
LEARN_CHAINS = 256            # chains a world (bench.py's learning default)
LEARN_EPOCHS, LEARN_SWEEPS = 10, 2
GRAD_RTOL = 1e-5              # relative to the largest |value| compared
TRI_GRID = 512                # bench.py's arity-3 class
TRI_CHAINS = 1024
DM_ORACLE_CHAINS = 1024
DM_ORACLE_BURN, DM_ORACLE_SWEEPS = 100, 1000
DRAW_GAP = 1e-5               # a kernel draw may differ only this near p
CAT_GRID, CAT_CARD = 512, 4   # bench.py's categorical class
CAT_CHAINS = 512
CAT_GAP = 1e-5                # ... or where its top two scores are this near
CAT_ORACLE_CHAINS = 1024
SFU_PER_CLOCK_PER_SM = 16     # Hopper's special-function units (log2)
# the two kernels' times before their 16-byte redesign, when they moved
# one byte a thread (PERF.md §6, this script's phase 4 on an NVIDIA H100
# 80GB HBM3, 700 W): printed beside this run's for reference only
BYTE_A_THREAD_MS = {"fused_color_draw": 4.488, "banded_gather": 5.240}
# the kernels' times before their redesign for Hopper (records read once,
# neighbours and candidates unrolled), when they looped over the
# candidates / loaded a row after its index / took one record at a time
# (PERF.md §6, this script's phases 10, 7 and 5 on an NVIDIA H100 80GB
# HBM3, 700 W): for reference only
PRE_REDESIGN_MS = {"fused_cat_draw": 1.417, "fused_dm_draw": 0.522,
                   "grad_pair_tile": 0.6932}
# (NC, D, n_weights, TB, ntiles, world off the 16-byte grid, streams off
# it): every variant of grad_pair_tile, as tests/test_torch_grad.py's
# CARD_CASES (16-byte rows in one pass of a warp's lanes at 256 and 48
# chains, in two at 512; byte rows at 37 and off the grid; D unrolled
# 1..8, chunked at 9 and 24; 4-byte stream copies for TB not a multiple
# of 4 and for streams off the grid; a tile staged in two groups of rows)
GRAD_STREAM_CASES = ([(nc, d, (1, 2, 64)[d % 3], 8, 6, False, False)
                      for nc in (256, 512, 48, 37) for d in range(1, 10)]
                     + [(48, 5, 2, 8, 6, True, False),
                        (256, 5, 2, 6, 6, False, False),
                        (256, 5, 64, 8, 6, False, True),
                        (256, 24, 2, 64, 6, False, False)])
WIDE_GRID = 128               # the Ising grid with every pair factor twice:
WIDE_COPIES = 2               # degree 9, past the kernel's unrolled D = 1..8
# (K, NC) of the tally's random worlds: every way it counts (registers at
# K <= 16, a warp's shared histogram to 1024, global atomics above; int8
# and int32 worlds) at 16-byte rows (8, 24, 48, 128, 512: 1 to 32 lanes a
# row in registers) and byte rows (37)
TALLY_CASES = [(K, nc) for K in (2, 4, 17, 200)
               for nc in (8, 24, 37, 48, 128, 512)] + [(2000, 48)]
TALLY_ROWS = 100_003
# (K, NC) of the timed tallies on random int8 worlds of TALLY_TIME_ROWS
# rows: narrow rows beside the flagships' 512 and KBC's 1024 chains
TALLY_TIMED = [(2, 128), (4, 128), (2, 512), (2, 1024)]
TALLY_TIME_ROWS = 1 << 20
KBC_ORACLE_CHAINS = 1024
KBC_ORACLE_BURN, KBC_ORACLE_SWEEPS = 100, 1000
KBC_VARS, KBC_CHAINS = 500_000, 1024      # bench.py's bench_kbc
KBC_BURN = 2
KBC_INNER, KBC_OUTER = 5, 2               # bench.py's counted sweeps
KBC_LEARN_VARS = 200_000                  # bench.py's KBC learning cell
# (rows, D, A1, NC, values off the 16-byte grid): dm_gather_draw's
# variants on random streams: D unrolled 1..8 and chunked (9, 12, 16, and
# the KBC cell's widest dense tier and hub chunks, 256 and 512), A1 2 and
# 1, 16-byte rows (48, 64, 512, 1024 chains) and byte rows (37 chains, or
# values one byte off the 16-byte grid)
DM_GATHER_STREAMS = ([(300, d, 2, 48, False) for d in range(1, 10)]
                     + [(300, d, 1, 1024, False) for d in range(1, 10)]
                     + [(300, 12, 2, 512, False), (300, 16, 1, 48, False),
                        (88, 256, 2, 64, False), (88, 256, 1, 1024, False),
                        (42, 512, 2, 1024, False), (42, 512, 1, 37, False),
                        (40, 600, 2, 1024, False), (40, 600, 1, 48, False),
                        (30, 600, 2, 37, False), (300, 5, 2, 37, False),
                        (300, 3, 1, 37, False), (300, 5, 2, 1024, True),
                        (300, 9, 1, 48, True), (40, 600, 2, 1024, True),
                        (257, 4, 1, 1024, False)])
# hub streams: (rows, records a chunk, A1, chains, chunk counts of the rows
# in turn)
DM_HUB_STREAMS = [(20, 512, 2, 1024, (1, 2, 0, 5, 13)),
                  (15, 512, 1, 48, (3, 1, 40)), (12, 8, 2, 37, (0, 2, 7))]
# dm_gather_draw before its redesign (a launch a tier and color, a thread
# a row) on phase 15's graph: ms a sweep by tier (rows x records) and in
# all, on an H100 80GB HBM3 at 700 W (PERF.md, kernel table row 8)
DM_BEFORE_REDESIGN_MS = {"22528x5": 1.790, "20480x9": 1.555, "3344x16": 0.529,
                    "88x256": 1.046, "hub 42x512 (delta mode)": 2.081,
                    "sweep": 7.00}
CLI_KBC_ARGS = ["--order", "rcm", "--band_wmax", "32768", "--hub_cap", "256",
                "--n_chains", str(KBC_CHAINS), "-l", "2", "-s", "2", "-b", "2",
                "-i", "10", "--seed", "0"]
CLI_KBC_SWEEPS = 2 * 2 * 2 + 2 + 10        # learning (2 worlds), burn-in,
#                                           counted: CLI_KBC_ARGS' sweeps
CLI_TIMEOUT_S = 600
CLI_GRID = 256                # a labelled boolean grid that bands
CLI_GRID_EPOCHS, CLI_GRID_BURN, CLI_GRID_SWEEPS = 5, 5, 20
CLI_GRID_ARGS = ["-l", str(CLI_GRID_EPOCHS), "-a", "0.05",
                 "-b", str(CLI_GRID_BURN), "-i", str(CLI_GRID_SWEEPS),
                 "--n_chains", "64"]
RESUME_GRID = 256
RESUME_GRID_ARGS = ["-l", "4", "-a", "0.05", "-b", "20", "-i", "40",
                    "--n_chains", "64", "--checkpoint_every", "10"]
RESUME_KBC = (5000, 15000)                # variables, factors; a hub tier
RESUME_KBC_ARGS = ["--order", "rcm", "--band_wmax", "32768", "--hub_cap",
                   "256", "-l", "2", "-b", "10", "-i", "40", "--n_chains",
                   "256", "--checkpoint_every", "10"]
# phases 20-22: chain and graph sharding, the ranks sharing this one card
GS_BURN, GS_SWEEPS = 2, 10    # each mesh's burn-in and counted sweeps
SPARSE_LEARN_EPOCHS = 100       # phase 18's sparse-weight graph learned
SPARSE_LEARN_CHAINS = 512       # through the command; its gradient's chains
GS_NOISE = (1.1, 1.5)         # a sharded run's mean and max |dp| against an
#                               unsharded run, over the two unsharded
#                               seeds' mean and max |dp|, at most
GS_ARRANGEMENT = ("the ranks share one card over Gloo, staged through host "
                  "memory where Gloo has no CUDA path")
GS_CHILD = ("import sys; from sampler_tpu_torch.cli import main; "
            "from sampler_tpu_torch.parallel.comm import make_mesh; "
            "sys.exit(main(sys.argv[1:], mesh=make_mesh("
            "1, 2, ['cuda:0'] * 2, 'gloo')))")
# phases 23-26: the native host library and the large-graph entry points
SCALE_ARGS: list = []         # scale_gpu.main at its defaults: 5120^2, 128
#                               chains, 4 sweeps x (1 warm-up + 3 timed)
# scale_kbc.main at 1024 chains, cut for the script's time limit (PERF.md
# §4): its counted sweeps from 5 x 2 to 5 x 1, then its variables from
# 4e6 to 2e6 (python -m sampler_tpu_torch.scale_kbc runs the 4e6 point)
KBC_SCALE_ARGS = ["--vars", "2000000", "--outer", "1"]
# scale_demo's grid: 2048^2, cut from its 3200^2 default to keep the
# script inside its time limit (PERF.md §4)
DEMO_ARGS = ["--rows", "2048", "--cols", "2048", "--graph-axis", "4",
             "--sweeps", "6"]
DEMO_RANKS = 4                # scale_demo's graph ranks, sharing the card
EDGE_TILES = 4                # tiles checked each side of world element
#                               2^31, and at the end of the world
REPO = os.path.dirname(os.path.abspath(__file__))


def require(cond, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def report(name: str, t0: float, **fields) -> None:
    import torch

    torch.cuda.synchronize()
    fields["seconds"] = round(time.perf_counter() - t0, 3)
    print(f"[{name}] {json.dumps(fields)}", flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


class GcTimer:
    """The cyclic garbage collector's runs and milliseconds while it is
    entered (gc.callbacks)."""

    def __enter__(self):
        import gc

        self.ms, self.runs, self._t = 0.0, 0, None
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.ms += (time.perf_counter() - self._t) * 1e3
            self.runs += 1

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._cb)


def host_profile(fn, top: int = 10) -> dict:
    """Where one call of ``fn`` spends host time: its wall ms to a
    synchronize, the ms until it returns (host enqueue), the cyclic
    collector's runs and ms in it, then, in a second call under
    torch.profiler, its device ms and the ops of most self CPU time."""
    import torch

    torch.cuda.synchronize()
    with GcTimer() as gct:
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    ops = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(wall_ms=(t2 - t0) * 1e3, enqueue_ms=(t1 - t0) * 1e3,
                gc_runs=gct.runs, gc_ms=gct.ms,
                profiled_self_cpu_ms=sum(e.self_cpu_time_total
                                         for e in events) / 1e3,
                profiled_device_ms=sum(dev_us(e) for e in events) / 1e3,
                top_self_cpu=[dict(op=e.key, calls=e.count,
                                   self_cpu_ms=e.self_cpu_time_total / 1e3,
                                   device_ms=dev_us(e) / 1e3)
                              for e in ops[:top]])


def rows_read(nbr, starts, W: int) -> int:
    """Distinct in-window values rows the gather needs (this run's data)."""
    import torch

    local = nbr - starts.reshape(-1, *([1] * (nbr.dim() - 1)))
    inside = (local >= 0) & (local < W)
    return int(torch.unique(nbr[inside]).numel())


def rows_read_multi(rnbr, starts, W: int, P: int) -> int:
    """Distinct values rows a multi-window gather reads (this run's
    data)."""
    import torch

    from sampler_tpu_torch.ops.banded import _multi_rows

    row, valid = _multi_rows(rnbr, starts, W, P)
    return int(torch.unique(row[valid]).numel())


def label_half(g):
    """bench.py's learning labels (bench_learning): every other variable
    evidence, labelled ``arange % card``; returns ``g``."""
    import numpy as np

    g.var_role[::2] = 1
    g.var_init[::2] = (np.arange((g.n_vars + 1) // 2)
                       % np.asarray(g.var_card)[::2]).astype(np.int32)
    return g


def labelled_flagship(grid: int):
    """bench.py's learning graph: the grid with every other variable
    evidence, labelled ``arange % card``."""
    from sampler_tpu_torch.benchgraphs import big_ising_grid

    g, colors = big_ising_grid(grid, grid)
    return label_half(g), colors


def check_draws(out, ref, delta, seed, TB: int, NC: int) -> int:
    """Require that kernel draws ``out`` and plain draws ``ref`` differ
    only where the uniform lies within DRAW_GAP of sigmoid(delta); returns
    the number that differ."""
    import torch

    from sampler_tpu_torch.ops.fused import (hash_bits, tile_seed, u32,
                                             uniform24)

    diff = out != ref
    if bool(diff.any()):
        rows, chains = diff.nonzero(as_tuple=True)
        t = rows // TB
        u = uniform24(hash_bits((rows % TB) * NC + chains, u32(seed[0]),
                                tile_seed(seed[1], t)))
        gap = float((u - torch.sigmoid(delta[diff])).abs().max())
        require(gap < DRAW_GAP, f"a differing draw has |u - p| = {gap}")
    return int(diff.sum())


def off_grid(values):
    """A copy of ``values`` whose data lies one element (a byte of int8)
    off the 16-byte grid (the kernels then take their byte variants or
    4-byte stream copies)."""
    import torch

    flat = torch.empty(values.numel() + 1, dtype=values.dtype,
                       device=values.device)
    moved = flat[1:].view(values.shape)
    moved.copy_(values)
    require(moved.data_ptr() % 16 != 0, "off-grid copy is aligned")
    return moved


def wide_grid(rows: int, cols: int, copies: int):
    """big_ising_grid with every pair factor ``copies`` times, each copy
    with a weight of its own: (graph, colors).  Still two colors and one
    affine2 tier, of degree 4 * copies + 1."""
    import dataclasses

    import numpy as np

    from sampler_tpu_torch.benchgraphs import big_ising_grid

    g, colors = big_ising_grid(rows, cols)
    arity = np.diff(g.f_ptr)
    pair = np.nonzero(arity == 2)[0]
    pair_e = g.e_vid[g.f_ptr[pair][:, None] + np.arange(2)].reshape(-1)
    n_extra = copies - 1
    arity = np.concatenate([arity, np.full(n_extra * len(pair), 2)])
    f_ptr = np.zeros(len(arity) + 1, np.int64)
    np.cumsum(arity, out=f_ptr[1:])
    e_vid = np.concatenate([g.e_vid] + [pair_e] * n_extra).astype(np.int32)
    w = np.concatenate([g.w_init, 0.1 * np.arange(1, copies)])
    return dataclasses.replace(
        g, w_init=w, w_fixed=np.zeros(len(w), bool),
        f_type=np.concatenate([g.f_type] + [g.f_type[pair]] * n_extra),
        f_wid=np.concatenate([g.f_wid] + [np.full(len(pair), 1 + k, np.int32)
                                          for k in range(1, copies)]),
        f_feat=np.concatenate([g.f_feat] + [g.f_feat[pair]] * n_extra),
        f_ptr=f_ptr, e_vid=e_vid, e_ispos=np.ones(len(e_vid), bool),
        e_eqpred=np.ones(len(e_vid), np.int32)), colors


def ising_case(d, info, values, seed) -> dict:
    """banded_gather and fused_color_draw against their plain versions on
    every color of ``d``'s one affine2 tier, on the world ``values``, at
    the planner's window starts and at the same starts moved off the 256
    grid and clipped to P - W: the gather exactly equal, the draw's delta
    within 1e-5 and its draws differing only within DRAW_GAP of p."""
    import torch

    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_plain)
    from sampler_tpu_torch.ops.fused import (fold_affine, fused_color_draw,
                                             fused_color_draw_plain)

    ts, ti = d.tiers[0], info.tiers[0]
    C, B, D, TB, W = info.n_colors, ti.block, ti.degree, ti.band_tb, ti.band_w
    A1 = ti.arity - 1
    nt = B // TB
    P, NC = values.shape
    beta, base = fold_affine(ts, ti, C, d.w_init)
    err, g_err, n_diff, n_draws, unaligned, clipped = 0.0, 0, 0, 0, 0, 0
    for c in range(C):
        nbr = ts.cs_nbr[c * B * D * A1:(c + 1) * B * D * A1].view(
            nt, TB * D * A1)
        starts = ts.bd_start[c]
        shifted = torch.clamp(starts + 100, max=P - W)
        unaligned += int((starts % 256 != 0).sum())
        clipped += int((shifted == P - W).sum())
        for st in (starts, shifted):
            out = banded_gather(values, nbr, st, W)
            ref = banded_gather_plain(values, nbr, st, W)
            g_err = max(g_err, int((out.to(torch.int32)
                                    - ref.to(torch.int32)).abs().max()))
            require(torch.equal(out, ref),
                    f"banded_gather differs from its plain version (c={c}, "
                    f"NC={NC}, D={D})")
            del out, ref
            args = (values, ts.bd_nbr, st, beta, base, c, seed, W, TB, D)
            out, delta = fused_color_draw(*args, return_delta=True)
            ref, ref_delta = fused_color_draw_plain(*args, return_delta=True)
            err = max(err, float((delta - ref_delta).abs().max()))
            n_diff += check_draws(out, ref, delta, seed, TB, NC)
            n_draws += out.numel()
            del out, delta, ref, ref_delta
    require(err < 1e-5, f"fused delta error {err} (NC={NC}, D={D})")
    require(n_diff <= 1e-4 * n_draws,
            f"{n_diff} of {n_draws} draws differ (NC={NC}, D={D})")
    return dict(NC=NC, D=D, P=P, banded_gather="exact",
                banded_gather_max_abs_err=g_err, starts_unaligned=unaligned,
                shifted_starts_clipped_to_P_minus_W=clipped,
                fused_delta_max_abs_err=err, fused_draws_differing=n_diff,
                fused_draws=n_draws)


def world_write_check(draw, args, start: int, mask) -> int:
    """One color step of ``draw`` in world-write mode against its output
    mode followed by today's masked block write (torch.where + copy_),
    from the same world (``args[0]``, left as it was) and seed: the two
    worlds must be equal bit for bit.  Returns the rows that changed."""
    import torch

    world = args[0]
    n = mask.shape[0]
    out = draw(*args)
    ref = world.clone()
    blk = ref[start:start + n]
    blk.copy_(torch.where(mask[:, None], out[:n], blk))
    del out, blk
    got = world.clone()
    require(draw(got, *args[1:], write=(start, mask)) is got,
            f"{draw.__name__}: world-write mode returned another tensor")
    same = torch.equal(got, ref)
    changed = int((got != world).any(dim=1).sum())
    del got, ref
    require(same, f"{draw.__name__}: the world after world-write mode "
            f"differs from the output route's (block at {start}, {n} rows)")
    return changed


def world_write_cases(draw, make_args, d, info) -> dict:
    """``draw``'s world-write mode against the output route on ``d``'s
    one tier: every color under cm_resample; color 0 with every other row
    clamped as evidence (label_half's pattern) and under cm_resample_ev
    (sample_evidence); color 0 with a block 100 rows shorter than the
    tiles drawn (rows past it must stay as they were).  ``make_args(c)``
    gives the draw's arguments for color c."""
    import torch

    ts, ti = d.tiers[0], info.tiers[0]
    B = info.block_size
    res = {}
    for c in range(info.n_colors):
        res[f"c{c}"] = world_write_check(draw, make_args(c), c * B + ti.off,
                                         ts.cm_resample[c])
    m = ts.cm_resample[0]
    ev = m & (torch.arange(m.shape[0], device=m.device) % 2 == 1)
    res["c0_every_other_row_evidence"] = world_write_check(
        draw, make_args(0), ti.off, ev)
    res["c0_cm_resample_ev"] = world_write_check(
        draw, make_args(0), ti.off, ts.cm_resample_ev[0])
    res["c0_block_100_rows_short"] = world_write_check(
        draw, make_args(0), ti.off, m[:ti.block - 100])
    return dict(equal_bit_for_bit=True, rows_changed=res)


def tally_case(values, K: int) -> dict:
    """tally_counts against its plain version on ``values``, exactly, from
    counts that start at 1."""
    import torch

    from sampler_tpu_torch.ops.tally import tally_counts, tally_plain

    P, NC = values.shape
    got = torch.ones((K, P), dtype=torch.int32, device=values.device)
    ref = got.clone()
    tally_counts(got, values)
    tally_plain(ref, values)
    err = int((got - ref).abs().max())
    require(err == 0, f"tally_counts differs from its plain version by "
            f"{err} (K={K}, NC={NC}, {values.dtype})")
    return dict(K=K, NC=NC, P=P, dtype=str(values.dtype), max_abs_err=err)


def sweep_breakdown(d, world, info, folded, modes, gen, draws: dict) -> dict:
    """Where a counted sweep's time goes (CUDA events): one counted sweep
    (sweep_mc, whose fused draws write into the world, then the tally),
    the sweep alone and the tally alone; ``draws`` the draws' share from
    their kernel times, the rest of the sweep what is left."""
    import torch

    from sampler_tpu_torch.engine.multichain import sweep_mc, tally

    counts = torch.zeros((info.max_card, world.shape[0]), dtype=torch.int32,
                         device=world.device)

    def sweep():
        sweep_mc(d, world, d.w_init, gen, False, info, folded, modes)

    def counted():
        sweep()
        tally(counts, world)

    counted_ms = time_ms(counted, iters=10)
    sweep_ms = time_ms(sweep, iters=10)
    parts = dict(draws, tally=time_ms(lambda: tally(counts, world), iters=10))
    parts["rest_of_sweep"] = sweep_ms - sum(draws.values())
    return dict(counted_sweep_ms=counted_ms, sweep_ms=sweep_ms,
                parts_ms=parts)


def tally_numbers(values, K: int) -> dict:
    """tally_counts' time on ``values``, its plain version's, and its
    bound: the world read once, counts read and written once.  Up to 16
    values the plain version is the eager ``(values == k).sum`` passes the
    port ran before the kernel, one PyTorch call a value: its time is also
    the library yardstick."""
    import torch

    from sampler_tpu_torch.ops.tally import tally_counts, tally_plain

    P = values.shape[0]
    counts = torch.zeros((K, P), dtype=torch.int32, device=values.device)
    nbytes = values.numel() * values.element_size() + 2 * K * P * 4
    plain_ms = time_ms(lambda: tally_plain(counts, values), iters=5,
                       warmup=1)
    return dict(ms=time_ms(lambda: tally_counts(counts, values), iters=50),
                plain_ms=plain_ms, library_ms=plain_ms if K <= 16 else None,
                **kernel_bound(nbytes, 0))


def epoch_parts(d, w, info, modes, v_ev, v_free, cfg, gen,
                reps: int = 3, grad_modes=None) -> dict:
    """Where a learning epoch's time goes: the epoch body of
    _learn_mc_from, with CUDA events between its parts (mean of
    ``reps``); the worlds are updated in place.  ``grad_modes``, when
    given, are the gradient's modes (the chunked route's, to time it
    beside the kernel's)."""
    import torch

    from sampler_tpu_torch.engine.learn import apply_update
    from sampler_tpu_torch.engine.multichain import (mc_weight_gradient,
                                                     prepare_fold, sweep_mc)

    parts = dict(fold=0.0, sweeps=0.0, gradient=0.0, update=0.0)
    for _ in range(reps):
        ev_t = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev_t[0].record()
        folded = prepare_fold(d, w, info, modes)
        ev_t[1].record()
        for _ in range(cfg.n_sweeps_per_epoch):
            sweep_mc(d, v_ev, w, gen, False, info, folded, modes)
            sweep_mc(d, v_free, w, gen, True, info, folded, modes)
        ev_t[2].record()
        grad = mc_weight_gradient(d, v_ev, v_free, False, info,
                                  grad_modes or modes)
        ev_t[3].record()
        apply_update(w, grad, d.w_fixed, cfg.stepsize, cfg.regularization,
                     cfg.reg_param)
        ev_t[4].record()
        ev_t[4].synchronize()
        for i, name in enumerate(parts):
            parts[name] += ev_t[i].elapsed_time(ev_t[i + 1]) / reps
    return dict(parts, epoch=sum(parts.values()))


def init_values_unchunked(dg, generator, n_chains: int, info,
                          random_init: bool = True):
    """init_values_mc as it was before its draw was chunked: one int32
    [P, NC] randint and its modulo.  Kept here only to measure what the
    chunked draw saves."""
    import torch

    P = dg.var_card.shape[0]
    dt = torch.int8
    base = dg.var_init.to(dt)[:, None].expand(P, n_chains)
    if not random_init:
        return base.contiguous()
    r = torch.randint(0, 1 << 30, (P, n_chains), generator=generator,
                      device=dg.var_card.device, dtype=torch.int32)
    rand_vals = (r % dg.var_card.clamp(min=1)[:, None]).to(dt)
    return torch.where((dg.var_role == 0)[:, None], rand_vals, base)


def grad_streams(dev, NC: int, D: int, n_weights: int, seed: int,
                 TB: int = 8, ntiles: int = 6, W: int = 200, P: int = 1000,
                 C: int = 2) -> dict:
    """Random streams of an affine2 tier of C colors, as
    tests/test_torch_grad.py's: window starts anywhere in [0, P - W],
    every other one clipped to P - W; neighbours from 40 below the window
    to 40 past it, 5% at or past P and 5% negative; weight ids in [0,
    n_weights), 5% -1 and 5% in [n_weights, n_weights + 3); random
    coefficients and two random 0/1 worlds [P, NC]."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def ur(shape):
        return torch.rand(shape, generator=gen, device=dev)

    def rn(scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    shape = (C, ntiles, D * TB)
    starts = ri(0, P - W + 1, (C, ntiles))
    starts[:, ::2] = P - W
    nbr = starts[:, :, None] + ri(-40, W + 40, shape)
    u = ur(shape)
    nbr = torch.where(u < 0.05, P + ri(0, 3, shape), nbr)
    nbr = torch.where((u >= 0.05) & (u < 0.1), -1 - ri(0, 3, shape), nbr)
    wid = ri(0, n_weights, shape)
    u = ur(shape)
    wid = torch.where(u < 0.05, -1, wid)
    wid = torch.where(u > 0.95, n_weights + ri(0, 3, shape), wid)
    own0 = [8 * c * (ntiles * TB // 8 + 1) for c in range(C)]
    require(own0[-1] + ntiles * TB <= P, f"own rows past P={P}")
    return dict(v_ev=ri(0, 2, (P, NC)).to(torch.int8),
                v_free=ri(0, 2, (P, NC)).to(torch.int8),
                nbr=nbr.to(torch.int32), starts=starts.to(torch.int32),
                wid=wid.to(torch.int32), coef=rn(1.0), ao=rn(0.7),
                an=rn(0.5), ax=rn(0.3), own0=own0, W=W)


def grad_stream_case(dev, NC: int, D: int, n_weights: int, TB: int,
                     ntiles: int, world_off: bool, streams_off: bool) -> float:
    """grad_pair_tile against its plain version on grad_streams, both
    colors, and two launches bit for bit; returns the largest error
    relative to the largest |partial|."""
    import torch

    from sampler_tpu_torch.ops.grad import (grad_pair_tile,
                                            grad_pair_tile_plain)

    s = grad_streams(dev, NC, D, n_weights, 3000 + 97 * D + 13 * NC + TB,
                     TB=TB, ntiles=ntiles)
    worlds = [s["v_ev"], s["v_free"]]
    streams = [s[k] for k in ("nbr", "wid", "coef", "ao", "an", "ax")]
    if world_off:
        worlds = [off_grid(v) for v in worlds]
    if streams_off:
        streams = [off_grid(x) for x in streams]
    rel = 0.0
    for c in range(2):
        args = (*worlds, streams[0], s["starts"][c], *streams[1:], c,
                s["own0"][c], s["W"], TB, D, n_weights)
        got = grad_pair_tile(*args)
        again = grad_pair_tile(*args)
        ref = grad_pair_tile_plain(*args)
        case = (f"NC={NC} D={D} n_weights={n_weights} TB={TB} "
                f"world_off={world_off} streams_off={streams_off} c={c}")
        require(torch.equal(got, again), f"grad_pair_tile: two launches "
                f"differ ({case})")
        e, scale = float((got - ref).abs().max()), float(ref.abs().max())
        require(scale > 0, f"grad_pair_tile: all partials are 0 ({case})")
        require(e <= GRAD_RTOL * scale,
                f"grad_pair_tile: |err| {e} of {scale} ({case})")
        rel = max(rel, e / scale)
    return rel


def grad_kernel_report(dev, D: int, nt: int, TB: int) -> dict:
    """The learning flagship's variant of grad_pair_tile (16-byte rows in
    one pass, D unrolled): its ptxas registers and spills, its SASS, and
    the issue bound they imply: the own-row loop's body (the innermost
    loop with a shuffle) once a (tile, own row), issued at 4 warp
    instructions a clock an SM at the card's maximum SM clock.  The code
    outside that loop (the stream copies, unrolled, of which a warp runs
    a few trips, and the table's sums) is not counted."""
    import torch

    from sampler_tpu_torch.ops import _build

    frag = f"grad_pair_tile_kernelILi16ELi{D}ELb1E"
    name = f"grad_pair_tile_kernel<16,{D},1>"
    ptxas = [ln for ln in ptxas_summary(_build.build()[2])
             if ln.startswith(name + ":")]
    out = dict(ptxas=ptxas[0] if ptxas else None)
    code = sass_code(_build.library_path(), frag)
    if code is None:
        return dict(out, sass_instructions=None, issue_bound_ms=None)
    body = sass_loop_body(code, "SHFL")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(out, sass_instructions=len(code),
                sass_instructions_an_own_row=body,
                issue_bound_ms=nt * TB * body / (4 * n_sm * sm_clock_hz())
                * 1e3)


def grad_phase(dev) -> tuple:
    """Phase 5.  Returns (graph, device graph, info, kernel numbers)."""
    import torch

    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (
        _mc_weight_gradient_factors, _row_chunk, init_values_mc,
        mc_weight_gradient_cs)
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.grad import (GRAD_W_MAX, grad_pair_tile,
                                            grad_pair_tile_plain,
                                            grad_records_sum)

    t5 = time.perf_counter()
    chains = LEARN_CHAINS
    g, colors = labelled_flagship(GRID)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    W = dg.w_init.shape[0]
    require(len(info.tiers) == 1 and ti.affine2 and ti.band_k == 1
            and W <= GRAD_W_MAX, f"learning flagship tiers {info.tiers}")
    d = to_device(dg, dev)
    del dg
    ts = d.tiers[0]
    C, gB, D, TB, Wb = (info.n_colors, info.block_size, ti.degree,
                        ti.band_tb, ti.band_w)
    nt = ti.block // TB
    gen = torch.Generator(device=dev).manual_seed(11)
    v_ev = init_values_mc(d, gen, chains, info)
    v_free = torch.randint(0, 2, v_ev.shape, generator=gen, device=dev,
                           dtype=torch.int8)

    def args(c, coef):
        return (v_ev, v_free, ts.bd_nbr, ts.bd_start[c], ts.gd_wid, coef,
                ts.gd_ao, ts.gd_an, ts.gd_ax, c, c * gB + ti.off, Wb, TB, D,
                W)

    err, rel = 0.0, 0.0
    for c in range(C):
        for coef in (ts.gd_ctch, ts.gd_cown):
            got = grad_pair_tile(*args(c, coef))
            again = grad_pair_tile(*args(c, coef))
            ref = grad_pair_tile_plain(*args(c, coef))
            require(torch.equal(got, again),
                    f"grad_pair_tile color {c}: two launches differ")
            e, scale = float((got - ref).abs().max()), float(ref.abs().max())
            require(scale > 0, f"color {c}: all partials are 0")
            require(e <= GRAD_RTOL * scale,
                    f"grad_pair_tile color {c}: |err| {e} of {scale}")
            err, rel = max(err, e), max(rel, e / scale)
            del got, again, ref
    cases = [grad_stream_case(dev, *case) for case in GRAD_STREAM_CASES]
    row_chunk = _row_chunk(ti, ti.block, D, ti.arity, 2 * chains)
    routes = {}
    for lne in (False, True):
        banded_gather.launches = 0
        chunked = mc_weight_gradient_cs(d, v_ev, v_free, lne, info,
                                        ("cuda", "off"),
                                        row_chunk=row_chunk)
        gathers = banded_gather.launches
        require(gathers == C * (ti.block // row_chunk),
                f"chunked route: {gathers} banded_gather launches")
        # a row_chunk keeps grad_pair_tile off: the tier takes the
        # records route (grad_records_sum: its terms, pieces, weights)
        saved = grad_records_sum.launches
        records = mc_weight_gradient_cs(d, v_ev, v_free, lne, info,
                                        ("cuda", "cuda"),
                                        row_chunk=row_chunk)
        require(grad_records_sum.launches - saved == 3,
                f"records route: {grad_records_sum.launches - saved} "
                f"grad_records_sum launches")
        grad_records_sum.launches = saved   # a comparison counts none
        kernel = mc_weight_gradient_cs(d, v_ev, v_free, lne, info,
                                       ("cuda", "cuda"))
        factors = _mc_weight_gradient_factors(d, v_ev, v_free, lne, info)
        scale = float(factors.abs().max())
        diffs = {name: float((kernel - ref).abs().max())
                 for name, ref in (("chunked", chunked),
                                   ("records", records),
                                   ("factors", factors))}
        for name, e in diffs.items():
            require(e <= GRAD_RTOL * scale,
                    f"lne={lne}: kernel route vs {name}: {e} of {scale}")
        routes[f"learn_non_evidence={lne}"] = dict(
            grad=kernel.tolist(), max_abs_diff=diffs, scale=scale,
            chunked_banded_gather_launches=gathers)
        del chunked, records, kernel, factors

    k = dict(ms=time_ms(lambda: grad_pair_tile(*args(0, ts.gd_ctch)),
                        iters=20),
             ms_color1=time_ms(lambda: grad_pair_tile(*args(1, ts.gd_ctch)),
                               iters=20),
             pre_redesign_ms=PRE_REDESIGN_MS["grad_pair_tile"],
             plain_ms=time_ms(lambda: grad_pair_tile_plain(
                 *args(0, ts.gd_ctch)), iters=3, warmup=1),
             library_ms=None, max_abs_err=err)
    # bound of one launch: own rows and the in-window neighbour rows of
    # both worlds, six 4-byte record streams, starts and the partials; the
    # moments are int8 dot products (So: an add a byte of an own row; Sn
    # and Sx: an add and a multiply-add a byte of an in-window neighbour
    # row), and about 8 f32 operations a record
    nbr0 = ts.bd_nbr[0, :nt].reshape(nt, D, TB)
    local = nbr0 - ts.bd_start[0].reshape(nt, 1, 1)
    n_in = int(((local >= 0) & (local < Wb)).sum())
    nbytes = (2 * chains * (nt * TB + rows_read(nbr0, ts.bd_start[0], Wb))
              + 6 * 4 * nt * D * TB + 4 * nt + 4 * nt * W)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * chains * (nt * TB + 3 * n_in) / INT8_OPS_PER_S
             + 8 * nt * D * TB / F32_OPS_PER_S) * 1e3
    k.update(bound_ms=max(t_bytes, t_ops),
             bound_by="bytes" if t_bytes >= t_ops else "operations",
             bytes=nbytes, bound_ops_ms=t_ops,
             achieved_TB_s=nbytes / k["ms"] * 1e-9)
    # a diagnostic, not the bound: the bytes the SMs read from L2, with
    # each neighbour row read once a tile (L1 serving the repeats inside a
    # tile) and once a record
    key = (torch.arange(nt, device=dev).reshape(nt, 1, 1) * Wb + local)[
        (local >= 0) & (local < Wb)]
    own_stream = 2 * chains * nt * TB + 6 * 4 * nt * D * TB
    l2 = {"a_tile": own_stream + 2 * chains * int(torch.unique(key).numel()),
          "a_record": own_stream + 2 * chains * n_in}
    k["l2_to_sm"] = {label: dict(bytes=b, TB_s=b / k["ms"] * 1e-9)
                     for label, b in l2.items()}
    k.update(grad_kernel_report(dev, D, nt, TB))
    del v_ev, v_free
    report("5 grad", t5, compile_graph_s=round(compile_s, 3),
           P=d.var_card.shape[0], ntiles=nt, TB=TB, D=D, W_window=Wb,
           n_weights=W, NC=chains, records_in_window=n_in,
           partials_max_abs_err=err, partials_max_rel_err=rel,
           stream_cases=dict(cases=len(cases), two_launches="bit for bit",
                             max_rel_err=max(cases)),
           row_chunk=row_chunk, routes=routes, kernel=k)
    return g, d, info, k


def learn_phase(dev, g, d, info) -> dict:
    """Phase 6.  Returns the launches of the learning flagship's run."""
    import dataclasses

    import numpy as np
    import torch

    from sampler_tpu_torch import fixtures
    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.benchgraphs import big_ising_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine import multichain
    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import init_values_mc, learn_mc
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.fused import fold_affine, fused_color_draw
    from sampler_tpu_torch.ops.grad import grad_pair_tile, grad_records_sum

    t6 = time.perf_counter()
    chains = LEARN_CHAINS
    cfg = LearnConfig(n_epochs=LEARN_EPOCHS, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    modes = ("cuda", "cuda")
    C = info.n_colors
    counters = (grad_pair_tile, fused_color_draw, banded_gather)
    # one epoch first, so the counted run starts warm
    learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(1),
             dataclasses.replace(cfg, n_epochs=1), info, chains, modes,
             device=dev)
    # what init_values_mc allocates (its output included), and the run's
    # peak, with the draw as it was before it was chunked and as it is
    gen0 = torch.Generator(device=dev).manual_seed(2)
    init_bytes = {}
    for label, fn in (("unchunked", init_values_unchunked),
                      ("chunked", init_values_mc)):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        v = fn(d, gen0, chains, info)
        torch.cuda.synchronize()
        init_bytes[label] = torch.cuda.max_memory_allocated() - before
        del v
    torch.cuda.reset_peak_memory_stats()
    multichain.init_values_mc = init_values_unchunked
    try:
        learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(2),
                 cfg, info, chains, modes, device=dev)
        torch.cuda.synchronize()
    finally:
        multichain.init_values_mc = init_values_mc
    peak_unchunked = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    tr = time.perf_counter()
    w, v_ev, v_free = learn_mc(d, d.w_init,
                               torch.Generator(device=dev).manual_seed(2),
                               cfg, info, chains, modes, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - tr
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    require(launches["grad_pair_tile"] == C * cfg.n_epochs,
            f"learning: grad_pair_tile launches {launches}")
    require(launches["fused_color_draw"]
            == 2 * C * cfg.n_epochs * cfg.n_sweeps_per_epoch,
            f"learning: fused_color_draw launches {launches}")
    nw = g.n_weights
    require(bool(torch.isfinite(w).all()), f"weights {w.tolist()}")
    require(bool((w[:nw] != d.w_init[:nw]).all()),
            f"weights did not move: {w.tolist()}")
    require(bool(((v_ev == 0) | (v_ev == 1)).all()
                 and ((v_free == 0) | (v_free == 1)).all()),
            "non-boolean world")
    ev = (d.var_role == fs.ROLE_EVIDENCE) & (d.var_card > 1)
    require(bool((v_ev[ev] == d.var_init.to(torch.int8)[ev, None]).all()),
            "the evidence world lost a label")
    sweeps = cfg.n_epochs * cfg.n_sweeps_per_epoch
    tensors = [getattr(d, f) for f in d._fields if f != "tiers"]
    tensors += [x for ts in d.tiers for x in ts]
    graph_bytes = sum(t.numel() * t.element_size() for t in tensors
                      if isinstance(t, torch.Tensor))
    run = dict(wall_s=wall, learning_sweeps_per_s=sweeps / wall,
               learning_updates_per_s=g.n_vars * sweeps * 2 * chains / wall,
               peak_memory_bytes=peak,
               peak_memory_bytes_unchunked_init=peak_unchunked,
               init_values_mc_bytes=init_bytes,
               device_graph_bytes=graph_bytes, world_bytes=v_ev.numel(),
               launches=launches, weights=w.tolist(),
               w_init=d.w_init.tolist())
    require(init_bytes["chunked"] < 0.5 * init_bytes["unchunked"],
            f"init_values_mc bytes {init_bytes}")
    run["epoch_breakdown_ms"] = epoch_parts(
        d, w, info, modes, v_ev, v_free, cfg,
        torch.Generator(device=dev).manual_seed(3))
    # the sweeps' share that is draws: one launch at this width, times the
    # 2 * C * sweeps an epoch
    ts, ti = d.tiers[0], info.tiers[0]
    beta, base = fold_affine(ts, ti, C, w)
    seed = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    draw_ms = time_ms(lambda: fused_color_draw(
        v_free, ts.bd_nbr, ts.bd_start[0], beta, base, 0, seed, ti.band_w,
        ti.band_tb, ti.degree), iters=20)
    run["fused_color_draw_ms"] = dict(
        a_launch=draw_ms,
        an_epoch=draw_ms * 2 * C * cfg.n_sweeps_per_epoch)
    del v_ev, v_free

    # the grad_pair_tile route and, with the band mode off, the
    # records route learn the same weights from the same draws
    # (tests/test_grad_kernel.py's grid)
    gs, colors_s = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng = np.random.default_rng(7)
    gs.var_role[:] = rng.random(gs.n_vars) < 0.5
    gs.var_init[:] = rng.integers(0, 2, gs.n_vars)
    dgs, infos = compile_graph(gs, colors=colors_s, band_tile=8,
                               band_min_block=1)
    ds = to_device(dgs, dev)
    cfg_s = LearnConfig(n_epochs=10, n_sweeps_per_epoch=2, stepsize=0.05,
                        diminish=0.98, regularization="l2", reg_param=0.01)
    small = {}
    for label, m in (("pair", ("cuda", "cuda")),
                     ("records", ("off", "cuda"))):
        grad_pair_tile.launches = grad_records_sum.launches = 0
        ws, _, _ = learn_mc(ds, ds.w_init,
                            torch.Generator(device=dev).manual_seed(1),
                            cfg_s, infos, 4, m, device=dev)
        small[label] = (ws, (grad_pair_tile.launches,
                             grad_records_sum.launches))
    E = cfg_s.n_epochs
    require(small["pair"][1] == (infos.n_colors * E, 0)
            and small["records"][1] == (0, 3 * E),
            f"16x16 routes: (grad_pair_tile, grad_records_sum) launches "
            f"{small['pair'][1]}, {small['records'][1]}")
    dw = float((small["pair"][0] - small["records"][0]).abs().max())
    require(dw <= 1e-4, f"16x16: pair and records routes differ by {dw}")

    gc = fixtures.labeled_coin_graph(n_flips=400, p_heads=0.75, seed=2)
    p_hat = gc.var_init.mean()
    w_star = float(np.log(p_hat / (1 - p_hat)))
    dgc, infoc = compile_graph(gc)
    dc = to_device(dgc, dev)
    # a graph without a fused draw: its gradient takes the records route
    # too, 3 launches an epoch, and no row chunk of the chunked route
    coin_epochs = 300
    grad_records_sum.launches = 0
    with EagerCalls("_phi_streams") as chunks:
        wc, _, _ = learn_mc(dc, dc.w_init, torch.Generator(device=dev)
                            .manual_seed(0),
                            LearnConfig(n_epochs=coin_epochs, stepsize=0.03,
                                        diminish=0.995,
                                        regularization="none"),
                            infoc, 8, device=dev)
    coin_launches = grad_records_sum.launches
    require(coin_launches == 3 * coin_epochs
            == grad_launches_an_epoch(infoc, dev) * coin_epochs
            and chunks.calls == 0,
            f"coin: grad_records_sum launches {coin_launches}, {chunks.calls} "
            f"chunked gradient row chunks")
    coin_err = abs(float(wc[0]) - w_star)
    require(coin_err < 0.12, f"coin: learned {float(wc[0])}, want {w_star}")
    report("6 learn", t6, chains=chains, epochs=cfg.n_epochs,
           sweeps_per_epoch=cfg.n_sweeps_per_epoch, run=run,
           grid16_pair_vs_records_max_abs_dw=dw,
           grid16_weights=small["pair"][0].tolist(),
           coin_learned=float(wc[0]), coin_log_odds=w_star,
           coin_abs_err=coin_err,
           coin_grad_records_sum_launches=coin_launches,
           coin_chunked_gradient_row_chunks=chunks.calls)
    return launches


def kernel_bound(nbytes: int, ops: int, ops_per_s: float = F32_OPS_PER_S,
                 **extra) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, **extra)


def triple_flagship(dev, labelled: bool = False):
    """bench.py's arity-3 class on the card: (graph, device graph, info,
    numpy compile seconds)."""
    from sampler_tpu_torch.benchgraphs import big_triple_grid
    from sampler_tpu_torch.compile import compile_graph, to_device

    g, colors = big_triple_grid(TRI_GRID, TRI_GRID)
    if labelled:
        label_half(g)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    require(len(info.tiers) == 1 and ti.fusedm and ti.band_k == 2
            and ti.arity == 3 and not ti.affine2,
            f"triple flagship tiers {info.tiers}")
    return g, to_device(dg, dev), info, compile_s


def dm_case(dev, d, info, NC: int, seed_val: int,
            misaligned: bool = False) -> dict:
    """Both multi-window kernels against their plain versions on every
    color of ``d``'s one fusedm tier, on a random world of NC chains (one
    byte off the 16-byte grid where ``misaligned``)."""
    import torch

    from sampler_tpu_torch.ops.banded import (banded_gather_multi,
                                              banded_gather_multi_plain)
    from sampler_tpu_torch.ops.fused import (fold_deltam_tiles,
                                             fused_dm_draw,
                                             fused_dm_draw_plain)

    ts, ti = d.tiers[0], info.tiers[0]
    C, P = info.n_colors, d.var_card.shape[0]
    TB, W, K = ti.band_tb, ti.band_w, ti.band_k
    gen = torch.Generator(device=dev).manual_seed(seed_val)
    values = torch.randint(0, 2, (P, NC), generator=gen, device=dev,
                           dtype=torch.int8)
    if misaligned:
        values = off_grid(values)
    fold = fold_deltam_tiles(ts, ti, C, d.w_init)
    seed = torch.tensor([seed_val, -7 * seed_val - 1], dtype=torch.int32,
                        device=dev)
    err, g_err, n_diff, n_draws, gathers = 0.0, 0, 0, 0, 0
    for c in range(C):
        args = (values, ts.bd_dmnbr, ts.bd_start[c], *fold, c, seed, W, TB,
                ti.degree, ti.arity - 1, K)
        out, delta = fused_dm_draw(*args, return_delta=True)
        ref, ref_delta = fused_dm_draw_plain(*args, return_delta=True)
        err = max(err, float((delta - ref_delta).abs().max()))
        n_diff += check_draws(out, ref, delta, seed, TB, NC)
        n_draws += out.numel()
        del out, delta, ref, ref_delta
        if K < 2:
            continue
        starts = ts.bd_start[c]
        # the planner's starts; every start moved off the 256 grid and
        # clipped to P - W; the last window run past P (rows >= P read 0)
        past = starts.clone()
        past[:, -1] = P - W // 2
        for st in (starts, torch.clamp(starts + 100, max=P - W), past):
            got = banded_gather_multi(values, ts.bd_rnbr[c], st, W)
            ref = banded_gather_multi_plain(values, ts.bd_rnbr[c], st, W)
            g_err = max(g_err, int((got.to(torch.int32)
                                    - ref.to(torch.int32)).abs().max()))
            require(torch.equal(got, ref),
                    f"banded_gather_multi differs from its plain version "
                    f"(c={c}, NC={NC})")
            gathers += 1
            del got, ref
    require(err < 1e-5, f"fused_dm_draw delta error {err} (NC={NC})")
    require(n_diff <= 1e-4 * n_draws,
            f"{n_diff} of {n_draws} fused_dm_draw draws differ (NC={NC})")
    return dict(NC=NC, misaligned=misaligned, D=ti.degree, band_k=K,
                W=W, arity=ti.arity, delta_max_abs_err=err,
                draws_differing=n_diff, draws=n_draws,
                gathers_compared_exact=gathers, gather_max_abs_err=g_err)


def dm_streams(dev, D: int, A1: int, Kw: int, W: int, NC: int, seed: int,
               P: int = 1000, ntiles: int = 8, TB: int = 8, C: int = 2):
    """Random streams of a fusedm tier of C colors, at shapes the kernel's
    variants split on: Kw == 1, global positions around each window (some
    outside it, some at or past P); Kw >= 2, indices into the Kw windows
    laid end to end (5% at the sentinel Kw*W, a few negative) with window
    starts anywhere in [-W/2, P) (some windows past P); random
    coefficients and a random 0/1 world."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def rn(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    R = D * TB
    if Kw == 1:
        starts = ri(0, P - W, (C, ntiles)) // 256 * 256
        starts[:, ::2] = P - W
        nbr = starts[:, :, None] + ri(-32, W + 32, (C, ntiles, A1 * R))
    else:
        starts = ri(-W // 2, P, (C, ntiles, Kw))
        nbr = ri(-2, Kw * W, (C, ntiles, A1 * R))
        nbr[torch.rand(nbr.shape, generator=gen, device=dev) < 0.05] = \
            Kw * W
    return dict(values=ri(0, 2, (P, NC)).to(torch.int8),
                nbr=nbr.to(torch.int32), starts=starts.to(torch.int32),
                base=rn((C, ntiles, TB), 0.5), b1=rn((C, ntiles, R), 0.7),
                b2=rn((C, ntiles, R), 0.7) if A1 == 2 else None,
                bx=rn((C, ntiles, R), 0.7) if A1 == 2 else None)


def dm_stream_case(dev, D: int, A1: int, Kw: int, W: int, NC: int,
                   misaligned: bool = False) -> dict:
    """fused_dm_draw against its plain version on dm_streams, both colors,
    with and without the delta output."""
    import torch

    from sampler_tpu_torch.ops.fused import fused_dm_draw, fused_dm_draw_plain

    s = dm_streams(dev, D, A1, Kw, W, NC, 1000 + 97 * D + 13 * NC + Kw)
    values = off_grid(s["values"]) if misaligned else s["values"]
    seed = torch.tensor([D + 7 * Kw, -NC], dtype=torch.int32, device=dev)
    TB = s["base"].shape[2]
    err, n_diff, n_draws = 0.0, 0, 0
    for c in range(s["nbr"].shape[0]):
        args = (values, s["nbr"], s["starts"][c], s["base"], s["b1"],
                s["b2"], s["bx"], c, seed, W, TB, D, A1, Kw)
        out, delta = fused_dm_draw(*args, return_delta=True)
        ref, ref_delta = fused_dm_draw_plain(*args, return_delta=True)
        require(torch.equal(fused_dm_draw(*args), out),
                f"fused_dm_draw draws differ with and without the delta "
                f"(D={D}, A1={A1}, Kw={Kw}, NC={NC})")
        err = max(err, float((delta - ref_delta).abs().max()))
        n_diff += check_draws(out, ref, delta, seed, TB, NC)
        n_draws += out.numel()
    require(err < 1e-5, f"fused_dm_draw delta error {err} (D={D}, A1={A1}, "
            f"Kw={Kw}, W={W}, NC={NC}, misaligned={misaligned})")
    require(n_diff <= 1e-4 * n_draws,
            f"{n_diff} of {n_draws} fused_dm_draw draws differ (D={D}, "
            f"A1={A1}, Kw={Kw}, NC={NC})")
    return dict(D=D, A1=A1, Kw=Kw, W=W, NC=NC, misaligned=misaligned,
                delta_max_abs_err=err, draws_differing=n_diff,
                draws=n_draws)


def dm_kernels_phase(dev) -> tuple:
    """Phase 7.  Returns (graph, device graph, info, kernel numbers)."""
    import numpy as np
    import torch

    from sampler_tpu_torch.benchgraphs import big_ising_grid, big_triple_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.ops import _build
    from sampler_tpu_torch.ops.banded import (_multi_rows,
                                              banded_gather_multi,
                                              banded_gather_multi_plain)
    from sampler_tpu_torch.ops.fused import (fold_deltam_tiles,
                                             fused_dm_draw,
                                             fused_dm_draw_plain)

    t7 = time.perf_counter()
    g, d, info, compile_s = triple_flagship(dev)
    # every variant of the draw: 16-byte rows (1024 and 512 chains: a
    # warp's table where A1*D <= 8; 48 chains: the selects), byte rows (37
    # chains, and 48 one byte off the 16-byte grid); A1 2 and 1, Kw 2 and
    # 1 on graphs; on random streams D = 1..9 and 12 (the unrolled and
    # the chunked variants), Kw up to 3, W a power of two and not
    cases = {"triple_flagship": dm_case(dev, d, info, TRI_CHAINS, 1),
             "triple_flagship_nc48": dm_case(dev, d, info, 48, 4),
             "triple_flagship_nc37": dm_case(dev, d, info, 37, 5),
             "triple_flagship_nc48_off_grid": dm_case(dev, d, info, 48, 6,
                                                      misaligned=True)}
    # band_k 1 (global indices), and arity 2 (no b2/bx terms)
    gs, colors_s = big_triple_grid(16, 16)
    dgs, infos = compile_graph(gs, colors=colors_s, band_tile=8,
                               band_min_block=1)
    gi, _ = big_ising_grid(32, 32)
    r, c = np.divmod(np.arange(gi.n_vars), 32)
    dgi, infoi = compile_graph(gi, colors=((r + c) % 3).astype(np.int32),
                               band_tile=8, band_min_block=1, band_wmax=512)
    require(infos.tiers[0].band_k == 1 and infos.fusedm
            and infoi.tiers[0].arity == 2 and infoi.tiers[0].band_k == 2
            and infoi.fusedm, "small fusedm graphs")
    for name, dgx, infox in (("triple16_k1", dgs, infos),
                             ("ising3_a2", dgi, infoi)):
        dx = to_device(dgx, dev)
        for NC in (1024, 512, 48, 37):
            cases[f"{name}_nc{NC}"] = dm_case(dev, dx, infox, NC, 2)
        cases[f"{name}_nc48_off_grid"] = dm_case(dev, dx, infox, 48, 3,
                                                 misaligned=True)
    streams = [dm_stream_case(dev, D, A1, Kw, W, NC, off)
               for D, A1, Kw, W, NC, off in (
                   [(D, 2, 2, 256, 48, False) for D in range(1, 10)]
                   + [(12, 2, 2, 384, 48, False), (4, 2, 3, 384, 512, False),
                      (4, 1, 2, 384, 48, False), (5, 1, 1, 256, 48, False),
                      (4, 2, 1, 256, 1024, False), (9, 1, 3, 384, 48, False),
                      (1, 2, 2, 256, 512, False), (3, 2, 1, 256, 512, False),
                      (5, 2, 2, 384, 512, False), (6, 1, 1, 256, 512, False),
                      (8, 1, 2, 384, 1024, False), (9, 1, 2, 256, 512, False),
                      (4, 2, 2, 384, 37, False), (12, 1, 1, 256, 37, False),
                      (4, 2, 2, 256, 48, True), (9, 2, 1, 256, 48, True)])]

    ts, ti = d.tiers[0], info.tiers[0]
    C, P, B = info.n_colors, d.var_card.shape[0], ti.block
    D, A1, TB, W, K = (ti.degree, ti.arity - 1, ti.band_tb, ti.band_w,
                       ti.band_k)
    nt = B // TB
    R = TB * D * A1
    gen = torch.Generator(device=dev).manual_seed(3)
    values = torch.randint(0, 2, (P, TRI_CHAINS), generator=gen, device=dev,
                           dtype=torch.int8)
    fold = fold_deltam_tiles(ts, ti, C, d.w_init)
    seed = torch.tensor([12345, -67890], dtype=torch.int32, device=dev)
    fargs = (values, ts.bd_dmnbr, ts.bd_start[0], *fold, 0, seed, W, TB, D,
             A1, K)
    gargs = (values, ts.bd_rnbr[0], ts.bd_start[0], W)
    cs_nbr0 = ts.cs_nbr[:B * D * A1]
    kern = {
        "fused_dm_draw": dict(
            ms=time_ms(lambda: fused_dm_draw(*fargs), iters=50),
            plain_ms=time_ms(lambda: fused_dm_draw_plain(*fargs), iters=3,
                             warmup=1),
            library_ms=None),
        "banded_gather_multi": dict(
            ms=time_ms(lambda: banded_gather_multi(*gargs), iters=50),
            plain_ms=time_ms(lambda: banded_gather_multi_plain(*gargs),
                             iters=5, warmup=1),
            library_ms=time_ms(lambda: values.index_select(0, cs_nbr0),
                               iters=50)),
    }
    # bounds of one launch (color 0): the distinct values rows it reads,
    # its index, coefficient and start streams, its output.  The draw does
    # per (row, chain) 7 operations a record (3 multiplies and 3 adds of
    # the multilinear terms, the add into delta; 2 a record on arity 2),
    # the sigmoid (4), the hash and the uniform (about 24 integer
    # operations), counted at the f32 rate; the gather does none.
    dm = ts.bd_dmnbr[0, :nt]
    n_rows = rows_read_multi(dm, ts.bd_start[0], W, P)
    f_bytes = (n_rows * TRI_CHAINS + dm.numel() * 4
               + (1 + 2 * (A1 - 1)) * nt * D * TB * 4 + nt * TB * 4
               + ts.bd_start[0].numel() * 4 + 8 + nt * TB * TRI_CHAINS)
    per_rec = 7 if A1 == 2 else 2
    f_ops = nt * TB * TRI_CHAINS * (per_rec * D + 4 + 24)
    rn = ts.bd_rnbr[0]
    g_bytes = (rows_read_multi(rn, ts.bd_start[0], W, P) * TRI_CHAINS
               + rn.numel() * 4 + ts.bd_start[0].numel() * 4
               + rn.numel() * TRI_CHAINS)
    kern["fused_dm_draw"].update(kernel_bound(f_bytes, f_ops,
                                              rows_read=n_rows))
    kern["banded_gather_multi"].update(kernel_bound(g_bytes, 0))
    kern["fused_dm_draw"]["max_abs_err"] = max(
        case["delta_max_abs_err"]
        for case in (*cases.values(), *streams))
    kern["fused_dm_draw"].update(
        pre_redesign_ms=PRE_REDESIGN_MS["fused_dm_draw"],
        **issue_bound(dev, sass_instructions(
            _build.library_path(),
            f"fused_dm_draw_kernelILi16ELi{D}ELi{A1}ELb{int(A1 * D <= 8)}E"),
        nt * TB * TRI_CHAINS))
    kern["banded_gather_multi"]["max_abs_err"] = max(
        case["gather_max_abs_err"] for case in cases.values())
    in_window = int(_multi_rows(rn, ts.bd_start[0], W, P)[1].sum())
    world_write = world_write_cases(
        fused_dm_draw,
        lambda c: (values, ts.bd_dmnbr, ts.bd_start[c], *fold, c, seed, W,
                   TB, D, A1, K), d, info)
    del values, fargs, gargs
    report("7 dm kernels", t7, compile_graph_s=round(compile_s, 3), P=P,
           colors=C, block=B, ntiles=nt, TB=TB, D=D, A1=A1, W=W, K=K, R=R,
           gather_slots_in_window=in_window, cases=cases,
           stream_cases=streams, world_write=world_write, kernels=kern)
    return g, d, info, kern


def oracle_dm_phase(dev) -> dict:
    """Phase 8.  Returns the launches of each graph's two runs."""
    import numpy as np
    import torch

    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch import oracle
    from sampler_tpu_torch.benchgraphs import big_ising_grid, big_triple_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import infer_mc, resolve_modes
    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_multi)
    from sampler_tpu_torch.ops.fused import fused_dm_draw

    t8 = time.perf_counter()

    def evidence(g, colors, n_query, seed):
        rng = np.random.default_rng(seed)
        query = rng.choice(g.n_vars, n_query, replace=False)
        g.var_role[:] = fs.ROLE_EVIDENCE
        g.var_role[query] = fs.ROLE_QUERY
        g.var_init[:] = rng.integers(0, 2, g.n_vars)
        return g, colors, query

    gi, _ = big_ising_grid(32, 32, w_pair=0.35, w_bias=0.2)
    r, c = np.divmod(np.arange(gi.n_vars), 32)
    mw = dict(band_tile=8, band_min_block=1, band_wmax=512)
    graphs = {
        "triple16_k1": (evidence(*big_triple_grid(16, 16), 14, 1),
                        dict(band_tile=8, band_min_block=1), 1),
        "triple32_k2": (evidence(*big_triple_grid(32, 32), 12, 7), mw, 2),
        "ising3_k2": (evidence(gi, ((r + c) % 3).astype(np.int32), 12, 3),
                      mw, 2),
    }
    out = {}
    for name, ((g, colors, query), kw, band_k) in graphs.items():
        dg, info = compile_graph(g, colors=colors, **kw)
        require(info.fusedm and info.tiers[0].band_k == band_k,
                f"{name}: tiers {info.tiers}")
        require(resolve_modes(info, dev) == ("cuda", "cuda"),
                f"{name}: default modes {resolve_modes(info, dev)}")
        exact = oracle.exact_marginals(g, clamp_evidence=True)
        d = to_device(dg, dev)
        res = {}
        counters = (fused_dm_draw, banded_gather_multi, banded_gather)
        for label, modes, counter in (
                ("fused", None, fused_dm_draw),
                ("unfused", ("cuda", "off"),
                 banded_gather_multi if band_k >= 2 else banded_gather)):
            for fn in counters:
                fn.launches = 0
            marg, _ = infer_mc(d, d.w_init,
                               torch.Generator(device=dev).manual_seed(3),
                               DM_ORACLE_BURN, DM_ORACLE_SWEEPS, info,
                               DM_ORACLE_CHAINS, modes=modes, device=dev)
            dp = float(abs(marg[query, :2] - exact[query]).max())
            require(dp < 0.01, f"{name} {label}: |dp| = {dp}")
            launches = {fn.__name__: fn.launches for fn in counters}
            require(counter.launches == sum(launches.values())
                    == info.n_colors * (DM_ORACLE_BURN + DM_ORACLE_SWEEPS),
                    f"{name} {label}: launches {launches}")
            res[label] = dict(max_abs_dp=dp, launches=launches)
        out[name] = res
    report("8 oracle dm", t8, chains=DM_ORACLE_CHAINS, burn=DM_ORACLE_BURN,
           sweeps=DM_ORACLE_SWEEPS, graphs=out)
    return out


def triple_phase(dev, card: str, g, d, info, kern) -> tuple:
    """Phase 9: the triple flagship's main path, fused and unfused, then
    one learning epoch on its labelled twin (by part, the gradient on
    the records route and, beside it, on the chunked route).  Fills in the
    launches of ``kern``'s two entries; returns the tally check on its
    world and (device graph, info, chains) of the learning twin, for
    phase 16b."""
    import torch

    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import (infer_mc,
                                                     init_values_mc,
                                                     learn_mc, prepare_fold,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.banded import banded_gather_multi
    from sampler_tpu_torch.ops.fused import fused_dm_draw
    from sampler_tpu_torch.ops.grad import grad_records_sum
    from sampler_tpu_torch.ops.tally import tally_counts

    t9 = time.perf_counter()
    C = info.n_colors
    require(resolve_modes(info, dev) == ("cuda", "cuda"),
            f"default modes {resolve_modes(info, dev)}")
    runs = {}
    for label, modes in (("fused", None), ("unfused", ("cuda", "off"))):
        fused_dm_draw.launches = 0
        banded_gather_multi.launches = 0
        tally_counts.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = time.perf_counter()
        marg, vals = infer_mc(d, d.w_init,
                              torch.Generator(device=dev).manual_seed(7),
                              BURN, SWEEPS, info, TRI_CHAINS, modes=modes,
                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
        require(marg.shape == (g.n_vars, 2), f"marginals {marg.shape}")
        require(bool((marg >= 0).all() and (marg <= 1).all()),
                "marginals outside [0, 1]")
        require(float(abs(marg.sum(1) - 1).max()) < 1e-5,
                "marginal rows do not sum to 1")
        require(bool(((vals == 0) | (vals == 1)).all()), "non-boolean world")
        runs[label] = dict(
            wall_s=wall,
            variable_updates_per_s=g.n_vars * TRI_CHAINS * (BURN + SWEEPS)
            / wall,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            launches={"fused_dm_draw": fused_dm_draw.launches,
                      "banded_gather_multi": banded_gather_multi.launches,
                      "tally_counts": tally_counts.launches},
            mean_p1=float(marg[:, 1].mean()))
        if label == "fused":
            tally_check = tally_case(vals, 2)
        del vals
    require(runs["fused"]["launches"] == {
        "fused_dm_draw": C * (BURN + SWEEPS), "banded_gather_multi": 0,
        "tally_counts": SWEEPS},
        f"fused path launches {runs['fused']['launches']}")
    require(runs["unfused"]["launches"] == {
        "fused_dm_draw": 0, "banded_gather_multi": C * (BURN + SWEEPS),
        "tally_counts": SWEEPS},
        f"unfused path launches {runs['unfused']['launches']}")
    dp = abs(runs["fused"]["mean_p1"] - runs["unfused"]["mean_p1"])
    require(dp < 0.01, f"fused and unfused mean marginals differ by {dp}")
    kern["fused_dm_draw"]["launches"] = \
        runs["fused"]["launches"]["fused_dm_draw"]
    kern["banded_gather_multi"]["launches"] = \
        runs["unfused"]["launches"]["banded_gather_multi"]

    # where a counted fused sweep's time goes (CUDA events; after the
    # counted runs)
    modes = resolve_modes(info, dev)
    folded = prepare_fold(d, d.w_init, info, modes)
    gen_b = torch.Generator(device=dev).manual_seed(9)
    world = init_values_mc(d, gen_b, TRI_CHAINS, info)
    breakdown = sweep_breakdown(
        d, world, info, folded, modes, gen_b,
        {f"fused_dm_draw_x{C}": C * kern["fused_dm_draw"]["ms"]})
    del world, folded

    # one learning epoch on the labelled flagship, 256 chains a world
    gl, dl, infol, compile_l = triple_flagship(dev, labelled=True)
    cfg = LearnConfig(n_epochs=1, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    w, v_ev, v_free = learn_mc(dl, dl.w_init,
                               torch.Generator(device=dev).manual_seed(4),
                               cfg, infol, LEARN_CHAINS, device=dev)
    require(bool(torch.isfinite(w).all()), f"weights {w.tolist()}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_dm_draw.launches = 0
    banded_gather_multi.launches = 0
    grad_records_sum.launches = 0
    modes_l = resolve_modes(infol, dev)
    with EagerCalls("_phi_streams") as chunks:
        epoch = epoch_parts(dl, w, infol, modes_l, v_ev, v_free, cfg,
                            torch.Generator(device=dev).manual_seed(5),
                            reps=1)
    learn = dict(chains=LEARN_CHAINS, compile_graph_s=round(compile_l, 3),
                 epoch_breakdown_ms=epoch,
                 learning_updates_per_s=gl.n_vars * LEARN_SWEEPS * 2
                 * LEARN_CHAINS / (epoch["epoch"] / 1e3),
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 launches={"fused_dm_draw": fused_dm_draw.launches,
                           "banded_gather_multi": banded_gather_multi
                           .launches,
                           "grad_records_sum": grad_records_sum.launches},
                 chunked_gradient_row_chunks=chunks.calls,
                 weights=w.tolist())
    require(learn["launches"] == {
        "fused_dm_draw": 2 * C * LEARN_SWEEPS, "banded_gather_multi": 0,
        "grad_records_sum": grad_launches_an_epoch(infol, dev)}
        and learn["launches"]["grad_records_sum"] > 0 and chunks.calls == 0,
        f"learning epoch launches {learn['launches']}, {chunks.calls} "
        f"chunked gradient row chunks")
    torch.cuda.reset_peak_memory_stats()
    chunked = epoch_parts(dl, w, infol, modes_l, v_ev, v_free, cfg,
                          torch.Generator(device=dev).manual_seed(5), reps=1,
                          grad_modes=(modes_l[0], "off"))
    learn["chunked_gradient"] = dict(
        epoch_breakdown_ms=chunked,
        peak_memory_bytes=torch.cuda.max_memory_allocated(),
        learning_updates_per_s=gl.n_vars * LEARN_SWEEPS * 2 * LEARN_CHAINS
        / (chunked["epoch"] / 1e3))
    learn["fold_host_profile"] = host_profile(
        lambda: prepare_fold(d, w, info, modes))
    learn["gradient_share"] = {"kernel": epoch["gradient"] / epoch["epoch"],
                               "chunked": chunked["gradient"]
                               / chunked["epoch"]}
    del v_ev, v_free
    report("9 triple", t9, card=card, grid=f"{TRI_GRID}x{TRI_GRID}",
           chains=TRI_CHAINS, burn=BURN, sweeps=SWEEPS, runs=runs,
           fused_sweep_breakdown=breakdown, learning_epoch=learn)
    return tally_check, (dl, infol, LEARN_CHAINS)


def potts_flagship(dev, labelled: bool = False, grid: int | None = None,
                   card: int = CAT_CARD, mixed: bool = False):
    """bench.py's categorical class on the card (CAT_GRID unless ``grid``
    is given; ``mixed`` demotes every third variable to card 2): (graph,
    device graph, info, numpy compile seconds)."""
    from sampler_tpu_torch.benchgraphs import big_potts_grid
    from sampler_tpu_torch.compile import compile_graph, to_device

    grid = grid or CAT_GRID
    g, colors = big_potts_grid(grid, grid, card=card)
    if mixed:
        g.var_card[::3] = 2
        g.e_eqpred[:] = g.e_eqpred % g.var_card[g.e_vid]
    if labelled:
        label_half(g)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    require(len(info.tiers) == 1 and ti.affinek and not ti.affine2
            and ti.band_k == 1 and info.max_card == card,
            f"Potts {grid}x{grid} card {card} tiers {info.tiers}")
    return g, to_device(dg, dev), info, compile_s


def cat_scores(logits, rows, chains, seed, TB: int, NC: int):
    """The plain draw's Gumbel scores [n, K] at (rows, chains)."""
    import torch

    from sampler_tpu_torch.ops.fused import (KNUTH, M32, hash_bits,
                                             tile_seed, u32, uniform24)

    K = logits.shape[1]
    k = torch.arange(K, device=logits.device)[None, :]
    kseed = (tile_seed(seed[1], rows // TB)[:, None]
             ^ ((KNUTH * (k + 1)) & M32))
    u = uniform24(hash_bits(((rows % TB) * NC + chains)[:, None],
                            u32(seed[0]), kseed))
    return logits[rows, :, chains] - torch.log(-torch.log(u))


def cat_case(dev, d, info, NC: int, seed_val: int,
             misaligned: bool = False) -> dict:
    """fused_cat_draw against its plain version on every color of ``d``'s
    one affinek tier, on a random world of NC chains (one byte off the
    16-byte grid where ``misaligned``)."""
    import torch

    from sampler_tpu_torch.ops.fused import (fold_affine_cat, fused_cat_draw,
                                             fused_cat_draw_plain)

    ts, ti = d.tiers[0], info.tiers[0]
    C, P, K = info.n_colors, d.var_card.shape[0], info.max_card
    TB, gB = ti.band_tb, info.block_size
    gen = torch.Generator(device=dev).manual_seed(seed_val)
    values = (torch.randint(0, 1 << 20, (P, NC), generator=gen, device=dev)
              % d.var_card.clamp(min=1)[:, None]).to(torch.int8)
    if misaligned:
        values = off_grid(values)
    fold = fold_affine_cat(ts, ti, C, d.w_init)
    seed = torch.tensor([seed_val, -7 * seed_val - 1], dtype=torch.int32,
                        device=dev)
    res = dict(NC=NC, misaligned=misaligned, D=ti.degree, K=K,
               logits_max_abs_err=0.0, draws_differing=0, draws=0,
               max_score_gap_of_differing=0.0)
    for c in range(C):
        args = (values, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo, ts.bd_eqn,
                *fold, c, seed, ti.band_w, TB, ti.degree, K)
        out = cat_compare(args, seed, TB, NC, res)
        card = d.var_card[c * gB + ti.off:c * gB + ti.off + out.shape[0]]
        require(bool(((out >= 0) & (out < card[:, None])).all()),
                f"a draw at or above its variable's card (c={c}, NC={NC})")
        del out
    cat_verdict(res)
    return res


def cat_compare(args, seed, TB: int, NC: int, res: dict):
    """One fused_cat_draw launch against its plain version, with and
    without the logits; adds its numbers to ``res`` and returns the
    kernel's draws.  The logits must be exactly equal; a draw may differ
    only where the plain version's top two scores lie within CAT_GAP."""
    import torch

    from sampler_tpu_torch.ops.fused import (fused_cat_draw,
                                             fused_cat_draw_plain)

    out, logits = fused_cat_draw(*args, return_logits=True)
    ref, ref_logits = fused_cat_draw_plain(*args, return_logits=True)
    require(torch.equal(fused_cat_draw(*args), out),
            "fused_cat_draw draws differ with and without the logits")
    res["logits_max_abs_err"] = max(
        res["logits_max_abs_err"],
        float((logits - ref_logits).abs().max()))
    diff = out != ref
    if bool(diff.any()):
        rows, chains = diff.nonzero(as_tuple=True)
        top2 = cat_scores(ref_logits, rows, chains, seed, TB,
                          NC).topk(2, dim=1).values
        res["max_score_gap_of_differing"] = max(
            res["max_score_gap_of_differing"],
            float((top2[:, 0] - top2[:, 1]).max()))
        require(res["max_score_gap_of_differing"] < CAT_GAP,
                f"a differing categorical draw has a score gap "
                f"{res['max_score_gap_of_differing']}")
    res["draws_differing"] += int(diff.sum())
    res["draws"] += out.numel()
    return out


def cat_verdict(res: dict) -> None:
    """Require exact logits and at most 1e-4 of the draws differing."""
    require(res["logits_max_abs_err"] == 0.0,
            f"fused_cat_draw logits differ by {res['logits_max_abs_err']} "
            f"({res})")
    require(res["draws_differing"] <= 1e-4 * res["draws"],
            f"{res['draws_differing']} of {res['draws']} fused_cat_draw "
            f"draws differ ({res})")


def cat_streams(dev, D: int, K: int, NC: int, seed: int, P: int = 1000,
                ntiles: int = 8, TB: int = 8, W: int = 256, C: int = 2):
    """Random streams of an affinek tier of C colors, at shapes the
    kernel's variants split on: window starts on the 256 grid, every
    other one clipped to P - W; neighbours around the window (some
    outside it, some at or past P); eqo in [0, K) with 5% matching no
    candidate; eqn in [0, K) with 5% outside int8's range; random
    coefficients, kmask 0 or (10%) -1e30, and a world of values in
    [0, K)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev)

    def some(shape, share):
        return torch.rand(shape, generator=gen, device=dev) < share

    shape = (C, ntiles, D * TB)
    starts = ri(0, P - W, (C, ntiles)) // 256 * 256
    starts[:, ::2] = P - W
    nbr = starts[:, :, None] + ri(-32, W + 32, shape)
    eqo = ri(0, K, shape)
    eqo[some(shape, 0.05)] = K
    eqn = ri(0, K, shape)
    eqn[some(shape, 0.05)] = 300
    kmask = torch.where(some((C, ntiles, TB, K), 0.1), -1e30, 0.0)
    return dict(values=ri(0, K, (P, NC)).to(torch.int8),
                nbr=nbr.to(torch.int32), starts=starts.to(torch.int32),
                eqo=eqo.to(torch.int32), eqn=eqn.to(torch.int32),
                av=torch.randn(shape, generator=gen, device=dev),
                bv=torch.randn(shape, generator=gen, device=dev),
                kmask=kmask, W=W, TB=TB)


def cat_stream_case(dev, D: int, K: int, NC: int,
                    misaligned: bool = False) -> dict:
    """fused_cat_draw against its plain version on cat_streams, both
    colors."""
    import torch

    s = cat_streams(dev, D, K, NC, 2000 + 97 * D + 13 * NC + K)
    values = off_grid(s["values"]) if misaligned else s["values"]
    seed = torch.tensor([D + 7 * K, -NC], dtype=torch.int32, device=dev)
    res = dict(NC=NC, misaligned=misaligned, D=D, K=K,
               logits_max_abs_err=0.0, draws_differing=0, draws=0,
               max_score_gap_of_differing=0.0)
    for c in range(s["nbr"].shape[0]):
        cat_compare((values, s["nbr"], s["starts"][c], s["eqo"], s["eqn"],
                     s["av"], s["bv"], s["kmask"], c, seed, s["W"], s["TB"],
                     D, K), seed, s["TB"], NC, res)
    cat_verdict(res)
    return res


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


@functools.lru_cache(maxsize=None)
def sass_dump(tool: str, library: str) -> str:
    """cuobjdump's SASS of every kernel of ``library`` (once a library:
    its name holds the sources' hash)."""
    return subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def sass_code(library: str, fragment: str):
    """The SASS, as (address, instruction) pairs, of the one kernel of
    ``library`` whose mangled name contains ``fragment`` (from cuobjdump
    beside nvcc), or None where cuobjdump is missing."""
    import os
    import re

    from sampler_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = sass_dump(tool, library)
    found = [f for f in re.split(r"\n\s+Function : ", sass)[1:]
             if fragment in f.split("\n", 1)[0]]
    require(len(found) == 1, f"{len(found)} kernels named like {fragment}")
    return [(int(m.group(1), 16), m.group(2)) for m in (
        re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(\S.*)", line)
        for line in found[0].splitlines()) if m]


def sass_loops(code) -> list:
    """The loops of ``code`` as (first, last) addresses: one a backward
    branch."""
    import re

    return [(int(m.group(1), 16), addr) for addr, text in code
            for m in [re.search(r"\bBRA\S*\s+0x([0-9a-f]+)", text)]
            if m and int(m.group(1), 16) < addr]


def sass_loop_body(code, marker: str) -> int:
    """Instructions in the innermost loop of ``code`` that holds an
    instruction containing ``marker``."""
    loops = [(lo, hi) for lo, hi in sass_loops(code)
             if any(lo <= a <= hi and marker in t for a, t in code)]
    require(bool(loops), f"no loop holds {marker}")
    lo, hi = min(loops, key=lambda x: x[1] - x[0])
    return sum(1 for a, _ in code if lo <= a <= hi)


def sass_instructions(library: str, fragment: str, loop_trips: int = 1):
    """Instructions a thread issues in the one kernel of ``library`` whose
    mangled name contains ``fragment`` (its SASS from cuobjdump beside
    nvcc), or None where cuobjdump is missing.  With ``loop_trips`` > 1 the
    kernel has one loop the compiler kept (its one backward branch), whose
    body counts that many times.  Branches the main path skips (the delta
    or logits stores) count too."""
    code = sass_code(library, fragment)
    if code is None:
        return None
    if loop_trips == 1:
        return len(code)
    back = sass_loops(code)
    require(len(back) == 1, f"{fragment}: backward branches {back}")
    body = sum(1 for addr, _ in code if back[0][0] <= addr <= back[0][1])
    return len(code) + (loop_trips - 1) * body


def ptxas_summary(lines) -> list:
    """One line a kernel from nvcc's ptxas report: its name with its
    template arguments, registers and spill bytes."""
    import re

    out, name, spill = [], "?", ""
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            short = re.search(
                r"([a-z][a-z_]*_kernel)(I(?:L[ib]-?\d+E)+E)?", m.group(1))
            name = (short.group(1) + "<" + ",".join(
                re.findall(r"L[ib](-?\d+)E", short.group(2) or "")) + ">"
                    if short else m.group(1))
            spill = ""
        elif "spill" in line:
            spill = ", ".join(x.strip() for x in line.split(",")[1:])
        elif "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers"
                       f"{', ' + spill if spill else ''}")
    return out


def issue_bound(dev, sass, pairs: int, vec: int = 16) -> dict:
    """What a kernel's instructions alone take: ``sass`` SASS instructions
    a thread of ``vec`` chains, over ``pairs`` (row, chain) pairs, issued
    at 4 warp instructions a clock an SM at the card's maximum SM clock."""
    import torch

    if sass is None:
        return dict(sass_instructions_a_thread=None, issue_bound_ms=None)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return dict(sass_instructions_a_thread=sass,
                sass_instructions_a_pair=sass / vec,
                issue_bound_ms=pairs / vec * sass
                / (4 * 32 * n_sm * sm_clock_hz()) * 1e3)


def cat_kernel_phase(dev) -> tuple:
    """Phase 10.  Returns (graph, device graph, info, kernel numbers)."""
    import torch

    from sampler_tpu_torch.ops import _build
    from sampler_tpu_torch.ops.fused import (fold_affine_cat, fused_cat_draw,
                                             fused_cat_draw_plain)

    t10 = time.perf_counter()
    g, d, info, compile_s = potts_flagship(dev)
    # every variant of the kernel: 16-byte rows (512 and 48 chains), byte
    # rows (37 chains, and 48 one byte off the 16-byte grid); K unrolled
    # (the flagship's 4) and looped (the card-20 grid); on random streams
    # D = 1..9 and 12 (unrolled and chunked) and K = 2..9 and 20
    cases = {"potts_flagship": cat_case(dev, d, info, CAT_CHAINS, 1),
             "potts_flagship_nc48": cat_case(dev, d, info, 48, 4),
             "potts_flagship_nc37": cat_case(dev, d, info, 37, 2),
             "potts_flagship_nc48_off_grid": cat_case(dev, d, info, 48, 5,
                                                      misaligned=True)}
    for name, kw in (("card20_grid128", dict(grid=128, card=20)),
                     ("mixed_grid128", dict(grid=128, mixed=True))):
        _, dx, infox, _ = potts_flagship(dev, **kw)
        for NC in (CAT_CHAINS, 48, 37):
            cases[f"{name}_nc{NC}"] = cat_case(dev, dx, infox, NC, 3)
        cases[f"{name}_nc48_off_grid"] = cat_case(dev, dx, infox, 48, 6,
                                                  misaligned=True)
        del dx
    streams = [cat_stream_case(dev, D, K, NC, off)
               for D, K, NC, off in (
                   [(D, 4, 48, False) for D in range(1, 10)]
                   + [(5, K, 48, False) for K in (2, 3, 5, 6, 7, 8, 9, 20)]
                   + [(12, 4, 48, False), (12, 20, 48, False),
                      (5, 4, 512, False), (9, 20, 512, False),
                      (5, 4, 37, False), (9, 20, 37, False),
                      (5, 4, 48, True), (9, 3, 48, True)])]

    ts, ti = d.tiers[0], info.tiers[0]
    C, P, K = info.n_colors, d.var_card.shape[0], info.max_card
    D, TB, W = ti.degree, ti.band_tb, ti.band_w
    nt = ti.block // TB
    gen = torch.Generator(device=dev).manual_seed(3)
    values = torch.randint(0, K, (P, CAT_CHAINS), generator=gen, device=dev,
                           dtype=torch.int8)
    fold = fold_affine_cat(ts, ti, C, d.w_init)
    seed = torch.tensor([12345, -67890], dtype=torch.int32, device=dev)
    args = (values, ts.bd_nbr, ts.bd_start[0], ts.bd_eqo, ts.bd_eqn, *fold,
            0, seed, W, TB, D, K)
    k = dict(ms=time_ms(lambda: fused_cat_draw(*args), iters=50),
             plain_ms=time_ms(lambda: fused_cat_draw_plain(*args), iters=3,
                              warmup=1),
             library_ms=None,
             max_abs_err=max(c["logits_max_abs_err"]
                             for c in (*cases.values(), *streams)),
             pre_redesign_ms=PRE_REDESIGN_MS["fused_cat_draw"])
    # bound of one launch (color 0), three terms.  Bytes: the distinct
    # in-window neighbour rows it reads, five 4-byte record streams (nbr,
    # eqo, eqn, av, bv), kmask, starts and seed, its int8 output.  f32
    # operations, per (row, chain): 3 a record (compare, multiply, add),
    # and per candidate D adds, the kmask add, the hash and the uniform
    # (about 16 integer operations) and the score's subtract and compare.
    # Logs: 2 a candidate, at the special-function units' rate.
    nbr0 = ts.bd_nbr[0, :nt].reshape(nt, D, TB)
    n_rows = rows_read(nbr0, ts.bd_start[0], W)
    nbytes = (n_rows * CAT_CHAINS + 5 * nt * D * TB * 4 + nt * TB * K * 4
              + nt * 4 + 8 + nt * TB * CAT_CHAINS)
    pairs = nt * TB * CAT_CHAINS
    f_ops = pairs * (3 * D + K * (D + 19))
    logs = 2 * K * pairs
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock = sm_clock_hz()
    sfu_per_s = SFU_PER_CLOCK_PER_SM * n_sm * clock
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "f32 operations": f_ops / F32_OPS_PER_S * 1e3,
             "logs (SFU)": logs / sfu_per_s * 1e3}
    binding = max(terms, key=terms.get)
    k.update(bound_ms=terms[binding],
             bound_by="bytes" if binding == "bytes" else "operations",
             binding_term=binding, bound_terms_ms=terms, bytes=nbytes,
             f32_ops=f_ops, logs=logs, rows_read=n_rows, sm_count=n_sm,
             sm_clock_max_hz=clock, sfu_logs_per_s=sfu_per_s)
    # the flagship variant (16 chains a thread, D and K unrolled) runs its
    # chains in 4 groups of 4 in a loop
    k.update(issue_bound(dev, sass_instructions(
        _build.library_path(), f"fused_cat_draw_kernelILi16ELi{D}ELi{K}E",
        loop_trips=4), pairs))
    world_write = world_write_cases(
        fused_cat_draw,
        lambda c: (values, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo, ts.bd_eqn,
                   *fold, c, seed, W, TB, D, K), d, info)
    del values, args, fold
    report("10 cat kernel", t10, compile_graph_s=round(compile_s, 3), P=P,
           colors=C, block=ti.block, ntiles=nt, TB=TB, D=D, W=W, K=K,
           cases=cases, stream_cases=streams, world_write=world_write,
           kernel=k)
    return g, d, info, k


def oracle_cat_phase(dev) -> dict:
    """Phase 11.  Returns each graph's |dp| and launches."""
    import numpy as np
    import torch

    from sampler_tpu_torch import FactorGraph, fixtures, oracle
    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.benchgraphs import big_potts_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import infer_mc, values_dtype
    from sampler_tpu_torch.ops.banded import banded_gather
    from sampler_tpu_torch.ops.fused import fused_cat_draw

    t11 = time.perf_counter()
    gp, colors = big_potts_grid(16, 16, card=3, seed=5)
    rng = np.random.default_rng(5)
    query = rng.choice(gp.n_vars, 8, replace=False)
    gp.var_role[:] = fs.ROLE_EVIDENCE
    gp.var_role[query] = fs.ROLE_QUERY
    gp.var_init[:] = rng.integers(0, 3, gp.n_vars)
    g200 = FactorGraph.build(var_card=[200] * 3, weights=[1.2, 0.8], factors=[
        (fs.FUNC_AND_CATEGORICAL, 0, 1.0, [(0, True, 7)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(0, True, 3), (1, True, 3)]),
        (fs.FUNC_EQUAL, 1, 1.0, [(1, True, 150), (2, True, 150)])])
    g200.var_dtype[:] = fs.DTYPE_CATEGORICAL
    g200.var_role[2] = fs.ROLE_EVIDENCE
    g200.var_init[2] = 150
    graphs = {
        "potts16_card3": (gp, colors, dict(band_tile=8, band_min_block=1)),
        "categorical": (fixtures.categorical_graph(), None, {}),
        "mixed": (fixtures.mixed_graph(), None, {}),
        "card200": (g200, None, {}),
    }
    out = {}
    for name, (g, colors, kw) in graphs.items():
        dg, info = compile_graph(g, colors=colors, **kw)
        require(info.affinek == (name == "potts16_card3"),
                f"{name}: tiers {info.tiers}")
        exact = oracle.exact_marginals(g, clamp_evidence=True)
        free = g.var_role == fs.ROLE_QUERY
        d = to_device(dg, dev)
        res = dict(values_dtype=str(values_dtype(info)))
        sweeps = info.n_colors * (DM_ORACLE_BURN + DM_ORACLE_SWEEPS)
        for label, modes in (("fused", None), ("unfused", ("cuda", "off"))):
            fused_cat_draw.launches = 0
            banded_gather.launches = 0
            marg, vals = infer_mc(d, d.w_init,
                                  torch.Generator(device=dev).manual_seed(3),
                                  DM_ORACLE_BURN, DM_ORACLE_SWEEPS, info,
                                  CAT_ORACLE_CHAINS, modes=modes, device=dev)
            require(vals.dtype == values_dtype(info), f"{name}: {vals.dtype}")
            require(bool((vals < d.var_card[:, None]).all()),
                    f"{name}: a value at or above its card")
            dp = float(abs(marg[:, :exact.shape[1]] - exact)[free].max())
            require(dp < 0.01, f"{name} {label}: |dp| = {dp}")
            launches = {"fused_cat_draw": fused_cat_draw.launches,
                        "banded_gather": banded_gather.launches}
            if not info.affinek:
                want = {"fused_cat_draw": 0, "banded_gather": 0}
            elif label == "fused":
                want = {"fused_cat_draw": sweeps, "banded_gather": 0}
            else:
                want = {"fused_cat_draw": 0, "banded_gather": sweeps}
            require(launches == want, f"{name} {label}: launches {launches}")
            res[label] = dict(max_abs_dp=dp, launches=launches)
        out[name] = res
    report("11 oracle cat", t11, chains=CAT_ORACLE_CHAINS,
           burn=DM_ORACLE_BURN, sweeps=DM_ORACLE_SWEEPS, graphs=out)
    return out


def potts_phase(dev, card: str, g, d, info, kern) -> tuple:
    """Phase 12: the Potts flagship's main path, fused and unfused, then
    learn_mc on its labelled twin (the epoch by part, the gradient on
    the records route and, beside it, on the chunked route).  Fills in the
    launches of ``kern``; returns the tally check on its world and (device
    graph, info, chains) of the learning twin, for phase 16b."""
    import dataclasses

    import torch

    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import (_row_chunk, infer_mc,
                                                     init_values_mc, learn_mc,
                                                     prepare_fold,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_plain)
    from sampler_tpu_torch.ops.fused import fused_cat_draw
    from sampler_tpu_torch.ops.grad import grad_records_sum
    from sampler_tpu_torch.ops.tally import tally_counts

    t12 = time.perf_counter()
    C, K = info.n_colors, info.max_card
    ti = info.tiers[0]
    require(resolve_modes(info, dev) == ("cuda", "cuda"),
            f"default modes {resolve_modes(info, dev)}")
    # the unfused draw's row blocks a color (color_draw_categorical)
    blocks = ti.block // _row_chunk(ti, ti.block, ti.degree,
                                         K * ti.arity, CAT_CHAINS)
    runs = {}
    for label, modes in (("fused", None), ("unfused", ("cuda", "off"))):
        fused_cat_draw.launches = 0
        banded_gather.launches = 0
        tally_counts.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = time.perf_counter()
        marg, vals = infer_mc(d, d.w_init,
                              torch.Generator(device=dev).manual_seed(7),
                              BURN, SWEEPS, info, CAT_CHAINS, modes=modes,
                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
        require(marg.shape == (g.n_vars, K), f"marginals {marg.shape}")
        require(bool((marg >= 0).all() and (marg <= 1).all()),
                "marginals outside [0, 1]")
        require(float(abs(marg.sum(1) - 1).max()) < 1e-5,
                "marginal rows do not sum to 1")
        require(bool(((vals >= 0) & (vals < K)).all()), "a value outside K")
        runs[label] = dict(
            wall_s=wall,
            variable_updates_per_s=g.n_vars * CAT_CHAINS * (BURN + SWEEPS)
            / wall,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            launches={"fused_cat_draw": fused_cat_draw.launches,
                      "banded_gather": banded_gather.launches,
                      "tally_counts": tally_counts.launches},
            mean_p=marg.mean(axis=0).tolist())
        if label == "fused":
            tally_check = tally_case(vals, K)
        del vals
    sweeps = C * (BURN + SWEEPS)
    require(runs["fused"]["launches"] == {
        "fused_cat_draw": sweeps, "banded_gather": 0,
        "tally_counts": SWEEPS},
        f"fused path launches {runs['fused']['launches']}")
    require(runs["unfused"]["launches"] == {
        "fused_cat_draw": 0, "banded_gather": sweeps * blocks,
        "tally_counts": SWEEPS},
        f"unfused path launches {runs['unfused']['launches']}")
    dp = max(abs(a - b) for a, b in zip(runs["fused"]["mean_p"],
                                        runs["unfused"]["mean_p"]))
    require(dp < 0.01, f"fused and unfused mean marginals differ by {dp}")
    kern["launches"] = runs["fused"]["launches"]["fused_cat_draw"]

    # where a counted fused sweep's time goes (CUDA events; after the
    # counted runs)
    modes = resolve_modes(info, dev)
    folded = prepare_fold(d, d.w_init, info, modes)
    gen_b = torch.Generator(device=dev).manual_seed(9)
    world = init_values_mc(d, gen_b, CAT_CHAINS, info)
    breakdown = sweep_breakdown(d, world, info, folded, modes, gen_b,
                                {f"fused_cat_draw_x{C}": C * kern["ms"]})
    del world, folded

    # learning: bench.py's categorical learning configuration
    gl, dl, infol, compile_l = potts_flagship(dev, labelled=True)
    cfg = LearnConfig(n_epochs=LEARN_EPOCHS, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    til = infol.tiers[0]
    grad_blocks = til.block // _row_chunk(til, til.block, til.degree,
                                               til.arity, 2 * CAT_CHAINS)
    learn_mc(dl, dl.w_init, torch.Generator(device=dev).manual_seed(1),
             dataclasses.replace(cfg, n_epochs=1), infol, CAT_CHAINS,
             device=dev)                            # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused_cat_draw.launches = 0
    banded_gather.launches = 0
    grad_records_sum.launches = 0
    with EagerCalls("_phi_streams") as chunks:
        tr = time.perf_counter()
        w, v_ev, v_free = learn_mc(dl, dl.w_init,
                                   torch.Generator(device=dev).manual_seed(2),
                                   cfg, infol, CAT_CHAINS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
    launches = {"fused_cat_draw": fused_cat_draw.launches,
                "banded_gather": banded_gather.launches,
                "grad_records_sum": grad_records_sum.launches}
    n_sw = cfg.n_epochs * cfg.n_sweeps_per_epoch
    require(launches == {"fused_cat_draw": 2 * C * n_sw, "banded_gather": 0,
                         "grad_records_sum": 3 * cfg.n_epochs}
            and grad_launches_an_epoch(infol, dev) == 3
            and chunks.calls == 0,
            f"learning launches {launches}, {chunks.calls} chunked "
            f"gradient row chunks")
    nw = gl.n_weights
    require(bool(torch.isfinite(w).all()), f"weights {w.tolist()}")
    require(bool((w[:nw] != dl.w_init[:nw]).all()),
            f"weights did not move: {w.tolist()}")
    ev = (dl.var_role == fs.ROLE_EVIDENCE) & (dl.var_card > 1)
    require(bool((v_ev[ev] == dl.var_init.to(v_ev.dtype)[ev, None]).all()),
            "the evidence world lost a label")
    learn = dict(chains=CAT_CHAINS, epochs=cfg.n_epochs,
                 sweeps_per_epoch=cfg.n_sweeps_per_epoch,
                 compile_graph_s=round(compile_l, 3), wall_s=wall,
                 learning_sweeps_per_s=n_sw / wall,
                 learning_updates_per_s=gl.n_vars * n_sw * 2 * CAT_CHAINS
                 / wall,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 launches=launches, chunked_gradient_row_chunks=chunks.calls,
                 weights=w.tolist(), w_init=dl.w_init.tolist())
    modes_l = resolve_modes(infol, dev)
    learn["epoch_breakdown_ms"] = epoch_parts(
        dl, w, infol, modes_l, v_ev, v_free, cfg,
        torch.Generator(device=dev).manual_seed(3))
    torch.cuda.reset_peak_memory_stats()
    learn["epoch_breakdown_chunked_gradient_ms"] = epoch_parts(
        dl, w, infol, modes_l, v_ev, v_free, cfg,
        torch.Generator(device=dev).manual_seed(3),
        grad_modes=(modes_l[0], "off"))
    learn["chunked_gradient_peak_memory_bytes"] = \
        torch.cuda.max_memory_allocated()
    learn["fold_host_profile"] = host_profile(
        lambda: prepare_fold(d, w, info, modes))
    learn["gradient_share"] = {
        k: learn[k]["gradient"] / learn[k]["epoch"]
        for k in ("epoch_breakdown_ms", "epoch_breakdown_chunked_gradient_ms")}
    # the chunked route's gradient (with the fused mode off): one
    # banded_gather launch at its shapes (both worlds side by side, the
    # first row block of color 0), and the share of that route's epoch
    # that its C * grad_blocks launches take
    tsl, rc = dl.tiers[0], til.block // grad_blocks
    nbr = tsl.cs_nbr[:rc * til.degree * (til.arity - 1)].view(
        rc // til.band_tb, -1)
    st = tsl.bd_start[0, :rc // til.band_tb]
    v_both = torch.cat([v_ev, v_free], dim=-1)
    require(torch.equal(banded_gather(v_both, nbr, st, til.band_w),
                        banded_gather_plain(v_both, nbr, st, til.band_w)),
            "banded_gather differs from its plain version (Potts gradient)")
    gather_ms = time_ms(lambda: banded_gather(v_both, nbr, st, til.band_w),
                        iters=50)
    learn["chunked_gradient_gather"] = dict(
        ms=gather_ms, gathered_rows=nbr.numel(), NC=v_both.shape[1],
        launches_an_epoch=C * grad_blocks,
        ms_an_epoch=gather_ms * C * grad_blocks,
        share_of_epoch=gather_ms * C * grad_blocks
        / learn["epoch_breakdown_chunked_gradient_ms"]["epoch"])
    del v_ev, v_free, v_both
    report("12 potts", t12, card=card, grid=f"{CAT_GRID}x{CAT_GRID}",
           K=K, chains=CAT_CHAINS, burn=BURN, sweeps=SWEEPS,
           unfused_row_blocks_a_color=blocks, runs=runs,
           fused_sweep_breakdown=breakdown, learning=learn)
    return tally_check, (dl, infol, CAT_CHAINS)


def tally_phase(dev, checks: dict) -> dict:
    """Phase 13: tally_counts against its plain version, exactly, on random
    worlds (TALLY_CASES, values below 0 and at or past K mixed in), beside
    the flagship worlds' checks of phases 4, 9 and 12 (``checks``); then
    its ms beside its bound at TALLY_TIMED (phase 24 times it on the
    5120^2 grid's 128-chain world)."""
    import torch

    t13 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = dict(checks)
    for K, NC in TALLY_CASES:
        dt = torch.int8 if K <= 127 else torch.int32
        v = torch.randint(-3, min(K + 3, 127) if dt == torch.int8 else K + 3,
                          (TALLY_ROWS, NC), generator=gen, device=dev,
                          dtype=dt)
        cases[f"K{K}_nc{NC}"] = tally_case(v, K)
        # the same world one element off the 16-byte grid
        cases[f"K{K}_nc{NC}_off_grid"] = tally_case(off_grid(v), K)
        del v
    timed = {}
    for K, NC in TALLY_TIMED:
        v = torch.randint(0, K, (TALLY_TIME_ROWS, NC), generator=gen,
                          device=dev, dtype=torch.int8)
        x = timed[f"K{K}_nc{NC}"] = tally_numbers(v, K)
        x["bound_share"] = x["bound_ms"] / x["ms"]
        del v
    report("13 tally", t13, rows=TALLY_ROWS, cases=cases,
           timed_rows=TALLY_TIME_ROWS, timed=timed)
    return cases


def star_graph(n_leaves: int, card: int = 2, seed: int = 0):
    """tests/test_hub.py's star: one hub and ``n_leaves`` leaves, hub-leaf
    EQUAL couplings (0.4) and ISTRUE biases (0.3); card > 2 makes it
    categorical with random equality predicates."""
    import numpy as np

    from sampler_tpu_torch import FactorGraph
    from sampler_tpu_torch import format_spec as fs

    rng = np.random.default_rng(seed)
    V = n_leaves + 1
    factors = [(fs.FUNC_ISTRUE, 0, 1.0, [(v, True)]) for v in range(V)]
    factors += [(fs.FUNC_EQUAL, 1, 1.0, [(0, True), (v, True)])
                for v in range(1, V)]
    g = FactorGraph.build(var_card=[card] * V, weights=[0.3, 0.4],
                          factors=factors)
    if card > 2:
        g.var_dtype[:] = fs.DTYPE_CATEGORICAL
        g.e_eqpred[:] = rng.integers(0, card, g.n_edges)
    return g


def kbc_oracle_phase(dev) -> dict:
    """Phase 14: the hub tier on the card.  infer_mc on tests/test_hub.py's
    star graphs against exact enumeration (|dp| < 0.01 boolean with
    hub_cap 6 and chunks of 4; < 0.012 on the card-3 star with hub_cap 5,
    the JAX package's bound); then the gradient over dense and hub tiers,
    on the records route (the default modes) and on the chunked route (fused
    off), against the per-factor gradient (within 1e-4) on
    random_kbc_graph(300, 900, ...) with hub_cap 8 and chunks of 4."""
    import torch

    from sampler_tpu_torch import oracle
    from sampler_tpu_torch.benchgraphs import random_kbc_graph
    from sampler_tpu_torch.coloring import greedy_coloring
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (infer_mc, init_values_mc,
                                                     mc_weight_gradient,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.tally import tally_counts

    t14 = time.perf_counter()
    out = {}
    for name, g, cap, tol in (("star_bool", star_graph(14), 6, 0.01),
                              ("star_card3", star_graph(12, 3, 4), 5, 0.012)):
        dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=cap,
                                 hub_chunk=4)
        require(info.has_hub and info.tiers[-1].hub
                and info.tiers[-1].chunk_g == 4, f"{name}: {info.tiers}")
        exact = oracle.exact_marginals(g)
        d = to_device(dg, dev)
        tally_counts.launches = 0
        marg, _ = infer_mc(d, d.w_init,
                           torch.Generator(device=dev).manual_seed(1),
                           KBC_ORACLE_BURN, KBC_ORACLE_SWEEPS, info,
                           KBC_ORACLE_CHAINS, device=dev)
        dp = float(abs(marg[:, :exact.shape[1]] - exact).max())
        require(dp < tol, f"{name}: |dp| = {dp} (bound {tol})")
        require(tally_counts.launches == KBC_ORACLE_SWEEPS,
                f"{name}: tally_counts launches {tally_counts.launches}")
        out[name] = dict(max_abs_dp=dp, bound=tol, hub_cap=cap,
                         modes=resolve_modes(info, dev),
                         tally_counts_launches=tally_counts.launches)
    g = random_kbc_graph(300, 900, max_arity=3, n_weights=11, seed=3,
                         skew=1.2, evidence_frac=0.3)
    dg, info = compile_graph(g, colors=greedy_coloring(g), hub_cap=8,
                             hub_chunk=4)
    require(info.has_hub, "random_kbc_graph(300, ...) has no hub tier")
    d = to_device(dg, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    v_ev = init_values_mc(d, gen, 64, info)
    v_free = init_values_mc(d, gen, 64, info)
    grads = {}
    modes = resolve_modes(info, dev)
    for lne in (False, True):
        g_ref = mc_weight_gradient(d, v_ev, v_free, lne, info, None)
        errs = {}
        for route, m in (("records", modes), ("chunked", (modes[0], "off"))):
            g_cs = mc_weight_gradient(d, v_ev, v_free, lne, info, m)
            errs[route] = float((g_cs - g_ref).abs().max())
            require(errs[route] < 1e-4,
                    f"hub gradient ({route}, learn_non_evidence={lne}) "
                    f"differs from the per-factor one by {errs[route]}")
        grads[f"learn_non_evidence_{lne}"] = dict(
            max_abs_err=errs, max_abs_grad=float(g_ref.abs().max()))
    out["kbc300_gradient"] = grads
    report("14 kbc oracle", t14, chains=KBC_ORACLE_CHAINS,
           burn=KBC_ORACLE_BURN, sweeps=KBC_ORACLE_SWEEPS, graphs=out)
    return out


def kbc_graph(n_vars: int, n_weights: int, seed: int):
    """bench.py's KBC shape: random_kbc_graph with 3 factors a variable,
    arity up to 3, skew 1.1, document windows of 2000."""
    from sampler_tpu_torch.benchgraphs import random_kbc_graph

    return random_kbc_graph(n_vars, 3 * n_vars, max_arity=3,
                            n_weights=n_weights, seed=seed, skew=1.1,
                            window=2000)


def kbc_sweep_parts(d, world, info, modes, gen) -> dict:
    """Where a counted KBC sweep's time goes, summed over its colors and
    tiers (CUDA events, a few calls each), on ``modes`` (the kernel route
    where they are the defaults) and with the fused mode off (the eager
    route), each beside one whole counted sweep.  No KBC tier bands, so
    the tiers that draw in a fused kernel draw in dm_gather_draw, one
    launch a color (its draws and their world-writes, the hub's
    included); with the fused mode off a hub tier's parts are its chunk
    deltas (the eager arithmetic), their index_add_, and its Bernoulli
    draw; the other tiers' parts are their gathers, the rest of their
    draws (the log-odds arithmetic and the Bernoulli) and their masked
    block writes; then the tally."""
    return {"kernel_route" if m[1] != "off" else "eager_route":
            _sweep_parts(d, world, info, m, gen)
            for m in (modes, (modes[0], "off"))}


def _sweep_parts(d, world, info, modes, gen) -> dict:
    import torch

    from sampler_tpu_torch.compile import tier_geom
    from sampler_tpu_torch.engine.multichain import (_fused, _gather_nbr,
                                                     _tc,
                                                     color_delta_bool,
                                                     color_delta_multilin,
                                                     color_draw_tier,
                                                     prepare_fold, sweep_mc,
                                                     tally)

    folded = prepare_fold(d, d.w_init, info, modes)
    plan = getattr(folded, "dm", None)
    C, B = info.n_colors, info.block_size
    counts = torch.zeros((info.max_card, world.shape[0]), dtype=torch.int32,
                         device=world.device)
    parts = {}

    def add(key, ms):
        parts[key] = parts.get(key, 0.0) + ms

    reps = dict(iters=2, warmup=1)
    for c in range(C):
        if plan is not None:
            add("dm_gather_draw", time_ms(lambda: plan.draw(
                world, c, False, gen), **reps))
        for t, (ts, ti) in enumerate(zip(d.tiers, info.tiers)):
            if plan is not None and t in plan.tiers:
                continue
            start = c * B + ti.off
            mask = ts.cm_resample[c]
            if _fused(ti, folded[t], modes):
                add("dm_gather_draw", time_ms(lambda: color_draw_tier(
                    d, ts, ti, world, d.w_init, gen, c, info, folded[t],
                    modes, write=(start, mask)), **reps))
                continue
            rows, D, A = tier_geom(ts, ti, C)
            if A > 1:
                nbr = _tc(ts.cs_nbr, c, (rows, D, A - 1))
                add("gathers", time_ms(lambda: _gather_nbr(
                    ts, ti, world, nbr, c, modes), **reps))
            draw_ms = time_ms(lambda: color_draw_tier(
                d, ts, ti, world, d.w_init, gen, c, info, folded[t], modes),
                **reps)
            if ti.hub:
                dchunk = (color_delta_multilin(ts, ti, world, c, info,
                                               folded[t], modes)
                          if ti.deltam and folded[t] is not None else
                          color_delta_bool(ts, ti, world, d.w_init, c, info,
                                           modes))
                row = ts.hb_row[c].to(torch.int64)
                add_ms = time_ms(lambda: torch.zeros(
                    (ti.block + 1, world.shape[1]), device=world.device)
                    .index_add_(0, row, dchunk), **reps)
                add("hub_index_add", add_ms)
                del dchunk
                add("draws", draw_ms - add_ms)
            else:
                add("draws", draw_ms)
            drawn = color_draw_tier(d, ts, ti, world, d.w_init, gen, c, info,
                                    folded[t], modes)
            old = world[start:start + ti.block]
            add("masked_writes", time_ms(lambda: old.copy_(torch.where(
                mask[:, None], drawn, old)), **reps))
            del drawn
    if "draws" in parts and "gathers" in parts:
        parts["draws"] -= parts["gathers"]      # the draws include them
    parts["tally"] = time_ms(lambda: tally(counts, world), **reps)

    def counted():
        sweep_mc(d, world, d.w_init, gen, False, info, folded, modes)
        tally(counts, world)

    return dict(modes=list(modes),
                counted_sweep_ms=time_ms(counted, iters=3, warmup=1),
                parts_ms=parts, parts_sum_ms=sum(parts.values()))


def dm_launches_a_sweep(info) -> int:
    """dm_gather_draw's launches an unsharded sweep on the default modes:
    one a color over every deltam tier without a banded plan, the hub
    tier included (DM_MAX_TIERS tiers a launch)."""
    from sampler_tpu_torch.ops.fused import DM_MAX_TIERS

    n = sum(ti.deltam and not (ti.affine2 or ti.fusedm) for ti in info.tiers)
    return info.n_colors * -(-n // DM_MAX_TIERS)


class EagerCalls:
    """Counts the calls of an engine function while it is entered: by
    default the eager color_delta_multilin (the route a deltam tier's draw
    takes with the fused mode off); "_phi_streams" counts the row chunks
    of the chunked gradient."""

    def __init__(self, name: str = "color_delta_multilin"):
        self.name = name

    def __enter__(self):
        from sampler_tpu_torch.engine import multichain

        self.calls = 0
        self.orig = getattr(multichain, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return self.orig(*args, **kw)

        setattr(multichain, self.name, counted)
        return self

    def __exit__(self, *exc):
        from sampler_tpu_torch.engine import multichain

        setattr(multichain, self.name, self.orig)


def kbc_phase(dev, card: str) -> tuple:
    """Phase 15: bench.py's KBC inference cell (bench_kbc): KBC_VARS
    variables, greedy coloring, RCM order, compile_graph(band_wmax=32768,
    hub_cap=256), KBC_CHAINS chains, the default modes; KBC_BURN burn-in
    sweeps, then KBC_OUTER counted runs of KBC_INNER sweeps through
    run_inference_mc (bench.py's 5 x 2): dm_gather_draw launched once a
    color a sweep, no eager color_delta_multilin and no hub_color_draw
    (the hub tier draws in the kernel).
    Returns the graph and the counted sweeps' updates/s, for phase 17,
    its order, for phase 21, its device graph and info, for phase 15b,
    and dm_gather_draw's launches in the counted sweeps."""
    import torch

    from sampler_tpu_torch.coloring import greedy_coloring, rcm_order
    from sampler_tpu_torch.compile import compile_graph, iter_arrays, \
        to_device
    from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                     resolve_modes,
                                                     run_inference_mc,
                                                     run_sweeps_mc)
    from sampler_tpu_torch.ops.fused import dm_gather_draw
    from sampler_tpu_torch.ops.tally import tally_counts

    t15 = time.perf_counter()
    g = kbc_graph(KBC_VARS, 100_000, 0)
    host = {}
    tc = time.perf_counter()
    colors = greedy_coloring(g)
    host["greedy_coloring_s"] = time.perf_counter() - tc
    tc = time.perf_counter()
    order = rcm_order(g)
    host["rcm_order_s"] = time.perf_counter() - tc
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, order=order, band_wmax=32768,
                             hub_cap=256)
    host["compile_graph_s"] = time.perf_counter() - tc
    require(info.has_hub and info.tiers[-1].hub, f"KBC tiers {info.tiers}")
    d = to_device(dg, dev)
    del dg
    modes = resolve_modes(info, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    vals = init_values_mc(d, gen, KBC_CHAINS, info)
    vals = run_sweeps_mc(d, vals, d.w_init, gen, KBC_BURN, False, info,
                         modes, device=dev)
    require(modes == ("off", "cuda"), f"KBC default modes {modes}")
    tally_counts.launches = 0
    dm_gather_draw.launches = 0
    torch.cuda.synchronize()
    enqueue_ms = []
    with EagerCalls() as eager, EagerCalls("hub_color_draw") as hub, \
            GcTimer() as gct:
        tr = time.perf_counter()
        for _ in range(KBC_OUTER):
            te = time.perf_counter()
            vals, counts = run_inference_mc(d, vals, d.w_init, gen,
                                            KBC_INNER, False, info, modes,
                                            device=dev)
            enqueue_ms.append((time.perf_counter() - te) * 1e3)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
    launches = tally_counts.launches
    require(launches == KBC_OUTER * KBC_INNER,
            f"KBC: tally_counts launches {launches}")
    dm_want = dm_launches_a_sweep(info) * KBC_OUTER * KBC_INNER
    require(dm_gather_draw.launches == dm_want and dm_want > 0,
            f"KBC: dm_gather_draw launches {dm_gather_draw.launches}, "
            f"{dm_want} expected")
    require(eager.calls == 0 and hub.calls == 0,
            f"KBC: {eager.calls} eager color_delta_multilin calls, "
            f"{hub.calls} hub_color_draw calls")
    P, K = vals.shape[0], info.max_card
    per_pos = counts.reshape(K, P).sum(dim=0)
    require(bool((per_pos == KBC_INNER * KBC_CHAINS).all()),
            "KBC: a position's counts do not sum to sweeps x chains")
    require(bool(((vals == 0) | (vals == 1)).all()), "KBC: non-boolean world")
    run = dict(wall_s=wall,
               variable_updates_per_s=info.n_vars * KBC_CHAINS * KBC_INNER
               * KBC_OUTER / wall,
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               world_bytes=vals.numel() * vals.element_size(),
               graph_bytes=sum(a.numel() * a.element_size()
                               for _, a in iter_arrays(d)),
               tally_counts_launches=launches,
               dm_gather_draw_launches=dm_gather_draw.launches,
               eager_color_delta_multilin_calls=eager.calls,
               hub_color_draw_calls=hub.calls,
               host_enqueue_ms_a_run=enqueue_ms, gc_runs=gct.runs,
               gc_ms=gct.ms)
    run["host_profile_a_run"] = host_profile(lambda: run_inference_mc(
        d, vals, d.w_init, gen, KBC_INNER, False, info, modes, device=dev))
    breakdown = kbc_sweep_parts(d, vals, info, modes, gen)
    tiers = [dict(block=ti.block, degree=ti.degree, arity=ti.arity,
                  band_w=ti.band_w, band_k=ti.band_k, deltam=ti.deltam,
                  hub=ti.hub, chunks=ti.chunks, chunk_g=ti.chunk_g)
             for ti in info.tiers]
    del vals, counts
    report("15 kbc", t15, card=card, n_vars=info.n_vars,
           n_factors=info.n_factors, colors=info.n_colors, tiers=tiers,
           has_hub=info.has_hub, modes=modes, host_seconds=host,
           chains=KBC_CHAINS, burn=KBC_BURN, sweeps=f"{KBC_INNER}x{KBC_OUTER}",
           run=run, sweep_breakdown=breakdown)
    return (g, run["variable_updates_per_s"], order, d, info,
            run["dm_gather_draw_launches"])


def dm_bound(values, tiers, delta_mode: bool) -> dict:
    """The least time of one dm_gather_draw launch on these inputs (its
    tiers, DmTier): the distinct world rows its records read (this run's
    data), its index, coefficient, base and chunk-offset streams, the
    seeds and the masks read once, and its output written once (the draws
    of the rows the masks select into the world, or the float32 deltas);
    per (record, chain) an add and per (row, chain), when drawing, about
    30 operations of the hash, the exponential and the compare, at the
    f32 rate.  Beside it, the bytes of every record's rows (what the
    kernel gathers, mostly through L2)."""
    import torch

    P, NC = values.shape
    idx = torch.cat([t.nbr.reshape(-1) for t in tiers])
    valid = (idx >= 0) & (idx < P)
    distinct = int(torch.unique(idx[valid]).numel())
    nbytes, ops = distinct * NC, 0
    for t in tiers:
        M, D, A1 = t.nbr.shape
        rows = t.n_rows()
        n_coef = 1 if A1 == 1 else 3
        nbytes += (t.nbr.numel() * 4 + M * 4 + n_coef * M * D * 4
                   + (0 if t.rows is None else t.rows.numel() * 4))
        if delta_mode:
            nbytes += rows * NC * 4
        else:
            mask = t.write[1]
            nbytes += 8 + mask.numel() + int(mask.sum()) * NC
        ops += M * D * NC + (0 if delta_mode else rows * NC * 30)
    gathered = int(valid.sum()) * NC
    return dict(kernel_bound(nbytes, ops), rows_read=distinct,
                gathered_bytes=gathered,
                gathered_ms_at_hbm=gathered / HBM_BYTES_PER_S * 1e3)


def dm_compare(values, tiers, seeds) -> dict:
    """One dm_gather_draw launch over ``tiers`` (DmTier in world-write
    mode) against its plain version on ``values`` (left as they were):
    the output mode's deltas exactly equal (the delta mode's too), its
    draws equal but within DRAW_GAP of p; the world-write launch against
    the output mode's draws written under each tier's mask, bit for bit
    (the plain version's world-write too)."""
    import torch

    from sampler_tpu_torch.ops.fused import (DM_TILE_ROWS,
                                             dm_gather_draw_tiers,
                                             dm_gather_draw_tiers_plain)

    NC = values.shape[1]
    outs = [t._replace(write=None) for t in tiers]
    got = dm_gather_draw_tiers(values, outs, seeds, return_delta=True)
    ref = dm_gather_draw_tiers_plain(values, outs, seeds, return_delta=True)
    deltas = dm_gather_draw_tiers(values, outs, None)
    n_diff, n_draws, err = 0, 0, 0.0
    want = values.clone()
    for t, ((o, dl), (ro, rdl), dm) in enumerate(zip(got, ref, deltas)):
        if rdl.numel():
            err = max(err, float((dl - rdl).abs().max()),
                      float((dm - rdl).abs().max()))
        require(torch.equal(dl, rdl) and torch.equal(dm, rdl),
                f"dm_gather_draw: tier {t}'s delta differs from its plain "
                f"version's (NC={NC}, rows {tiers[t].n_rows()}, max abs err "
                f"{err})")
        n_diff += check_draws(o, ro, dl, seeds[t], DM_TILE_ROWS, NC)
        n_draws += o.numel()
        row0, mask = tiers[t].write
        blk = want[row0:row0 + mask.shape[0]]
        blk.copy_(torch.where(mask[:, None], o[:mask.shape[0]], blk))
    del got, ref, deltas
    world = values.clone()
    dm_gather_draw_tiers(world, tiers, seeds)
    plain = values.clone()
    dm_gather_draw_tiers_plain(plain, tiers, seeds)
    require(torch.equal(world, want), "dm_gather_draw: the world-write "
            "launch differs from the output mode's masked writes")
    changed = int((world != values).any(dim=1).sum())
    plain_diff = int((plain != world).sum())
    require(plain_diff <= n_diff, f"dm_gather_draw: the plain world-write "
            f"differs in {plain_diff} draws, its output mode in {n_diff}")
    return dict(delta_max_abs_err=err, draws_differing=n_diff,
                draws=n_draws, world_write_rows_changed=changed)


def dm_gather_stream_case(dev, B: int, D: int, A1: int, NC: int,
                          misaligned: bool) -> dict:
    """dm_gather_draw against its plain version on random streams: B rows
    of D records over a world of 5000 rows, neighbour positions in
    [B, P + 3) with 3% at -2 (outside the world they read 0) and 5% at
    the world's last row, random coefficients (dm_compare, the block at
    rows 0 .. B-1, which no record reads)."""
    import torch

    from sampler_tpu_torch.ops.fused import DmTier

    P = 5000
    gen = torch.Generator(device=dev).manual_seed(
        7 * B + 31 * D + 5 * A1 + NC)
    nbr = torch.randint(B, P + 3, (B, D, A1), generator=gen, device=dev,
                        dtype=torch.int32)
    nbr[torch.rand(nbr.shape, generator=gen, device=dev) < 0.03] = -2
    nbr[torch.rand(nbr.shape, generator=gen, device=dev) < 0.05] = P - 1
    values = torch.randint(0, 2, (P, NC), generator=gen, device=dev,
                           dtype=torch.int8)
    if misaligned:
        values = off_grid(values)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    b2, bx = (rn(B, D), rn(B, D)) if A1 == 2 else (None, None)
    mask = torch.rand(B, generator=gen, device=dev) < 0.7
    tier = DmTier(nbr, rn(B), rn(B, D), b2, bx, write=(0, mask))
    seeds = torch.tensor([[D * 1009 + A1, -NC - B]], dtype=torch.int32,
                         device=dev)
    res = dm_compare(values, [tier], seeds)
    require(res["draws_differing"] <= 1e-4 * res["draws"] + 1,
            f"dm_gather_draw streams: {res['draws_differing']} draws differ")
    return dict(B=B, D=D, A1=A1, NC=NC, misaligned=misaligned,
                lanes=tier.lanes(), **res)


def dm_gather_hub_stream_case(dev, rows: int, G: int, A1: int, NC: int,
                              counts: tuple) -> dict:
    """dm_gather_draw on random hub streams: ``rows`` rows whose chunk
    counts take ``counts`` in turn (0 included: a row with no chunk), G
    records a chunk, three pad chunks past the last row's, beside a dense
    tier of 5 records a row in the same launch (dm_compare)."""
    import torch

    from sampler_tpu_torch.ops.fused import DmTier

    P = 6000
    gen = torch.Generator(device=dev).manual_seed(rows * G + A1 + NC)
    n_ck = torch.tensor([counts[i % len(counts)] for i in range(rows)],
                        dtype=torch.int64)
    offs = torch.zeros(rows + 1, dtype=torch.int64)
    offs[1:] = n_ck.cumsum(0)
    M = int(offs[-1]) + 3

    def rn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def streams(B, D, lo):
        nbr = torch.randint(lo, P, (B, D, A1), generator=gen, device=dev,
                            dtype=torch.int32)
        cross = (rn(B, D), rn(B, D)) if A1 == 2 else (None, None)
        return nbr, rn(B), rn(B, D), *cross

    values = torch.randint(0, 2, (P, NC), generator=gen, device=dev,
                           dtype=torch.int8)
    dense_rows = 300
    mask_h = torch.rand(rows, generator=gen, device=dev) < 0.8
    mask_d = torch.rand(dense_rows, generator=gen, device=dev) < 0.8
    lo = rows + dense_rows             # no record reads a row drawn
    hub = DmTier(*streams(M, G, lo), rows=offs.to(torch.int32).to(dev),
                 write=(0, mask_h))
    dense = DmTier(*streams(dense_rows, 5, lo), write=(rows, mask_d))
    seeds = torch.tensor([[rows, G], [-NC, A1]], dtype=torch.int32,
                         device=dev)
    res = dm_compare(values, [dense, hub], seeds)
    require(res["draws_differing"] <= 1e-4 * res["draws"] + 1,
            f"dm_gather_draw hub streams: {res['draws_differing']} draws "
            "differ")
    return dict(rows=rows, G=G, A1=A1, NC=NC, chunk_counts=list(counts),
                **res)


def dm_bad_rows_check(dev) -> list:
    """Hub chunk offsets that decrease or leave [0, M] raise ValueError on
    the card before any launch (the kernel reads a row's chunks
    unchecked); returns the cases checked."""
    import torch

    from sampler_tpu_torch.ops.fused import dm_gather_draw

    M, G, P, NC = 5, 4, 50, 16
    gen = torch.Generator(device=dev).manual_seed(5)
    values = torch.randint(0, 2, (P, NC), generator=gen, device=dev,
                           dtype=torch.int8)
    nbr = torch.randint(0, P, (M, G, 2), generator=gen, device=dev,
                        dtype=torch.int32)
    coef = [torch.randn((M, G), generator=gen, device=dev) for _ in range(3)]
    base = torch.randn(M, generator=gen, device=dev)
    seed = torch.tensor([1, 2], dtype=torch.int32, device=dev)
    cases = {"decreasing": [0, 3, 2, 5], "negative": [-1, 2, 4, 5],
             "past_the_chunks": [0, 2, 4, 9], "empty": []}
    before = dm_gather_draw.launches
    for name, offs in cases.items():
        rows = torch.tensor(offs, dtype=torch.int32, device=dev)
        try:
            dm_gather_draw(values, nbr, base, *coef, seed, rows=rows)
        except ValueError:
            continue
        require(False, f"dm_gather_draw: {name} hub offsets {offs} did "
                "not raise")
    torch.cuda.synchronize()
    require(dm_gather_draw.launches == before,
            "dm_gather_draw launched on bad hub offsets")
    return sorted(cases)


def dm_gather_phase(dev, card: str, d, info) -> dict:
    """Phase 15b: dm_gather_draw against its plain version at phase 15's
    shapes: every color in one launch over its deltam tiers, the hub's
    deep rows drawn too, on a random world of KBC_CHAINS chains
    (dm_compare), and on random streams (DM_GATHER_STREAMS,
    DM_HUB_STREAMS); the ms a sweep of the main path's launches (world-
    write, a launch a color) beside the kernel's before its redesign
    (DM_BEFORE_REDESIGN_MS), each tier's ms a sweep alone
    (a launch a tier and color), bounds, the plain version's ms, the
    ptxas registers and spills of each variant.  Returns the kernel's
    numbers for the kernels line: a launch's mean ms, plain ms and bound
    over a sweep's launches."""
    import torch

    from sampler_tpu_torch.engine.multichain import (_dm_tier_list,
                                                     prepare_fold)
    from sampler_tpu_torch.ops import _build
    from sampler_tpu_torch.ops.fused import (DM_MAX_TIERS, dm_gather_draw,
                                             dm_gather_draw_table,
                                             dm_gather_draw_tiers_plain,
                                             dm_tier_table)

    t15b = time.perf_counter()
    P = d.var_card.shape[0]
    C = info.n_colors
    gen = torch.Generator(device=dev).manual_seed(15)
    values = torch.randint(0, 2, (P, KBC_CHAINS), generator=gen, device=dev,
                           dtype=torch.int8)
    modes = ("off", "cuda")
    folded = prepare_fold(d, d.w_init, info, modes)
    plan = folded.dm
    require(plan is not None and any(info.tiers[t].hub for t in plan.tiers)
            and len(plan.tiers) <= DM_MAX_TIERS,
            f"KBC plan: tiers {None if plan is None else plan.tiers}")
    saved = dm_gather_draw.launches
    checks, per_tier = {}, {}
    sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ops=0,
                gathered_bytes=0, gathered_ms_at_hbm=0.0, t_bytes_ms=0.0,
                t_ops_ms=0.0)
    for c in range(C):
        tiers = _dm_tier_list(d, info, plan.tiers, folded, c, False)
        table = plan.tables[c, 0]
        seeds = torch.tensor([[1515 + t, -1516 - c] for t in range(
            len(tiers))], dtype=torch.int32, device=dev)
        checks[f"c{c}"] = dm_compare(values, tiers, seeds)
        world = values.clone()
        sums["ms"] += time_ms(lambda: dm_gather_draw_table(world, table,
                                                           seeds),
                              iters=5, warmup=1)
        for i, (t, tier) in enumerate(zip(plan.tiers, tiers)):
            one = dm_tier_table([tier])
            ti = info.tiers[t]
            key = (f"hub {tier.nbr.shape[0]}x{tier.nbr.shape[1]}" if ti.hub
                   else f"{tier.nbr.shape[0]}x{tier.nbr.shape[1]}")
            x = per_tier.setdefault(key, dict(
                tier=t, hub=ti.hub, A1=tier.nbr.shape[2],
                lanes=tier.lanes(), ms_a_sweep_alone=0.0,
                launches_a_sweep_alone=0, launches_a_sweep_on_the_path=C,
                bound_ms_a_sweep=0.0))
            x["ms_a_sweep_alone"] += time_ms(
                lambda: dm_gather_draw_table(world, one, seeds[i:i + 1]),
                iters=5, warmup=1)
            x["launches_a_sweep_alone"] += 1
            x["bound_ms_a_sweep"] += dm_bound(values, [tier],
                                              False)["bound_ms"]
        plain = values.clone()
        sums["plain_ms"] += time_ms(
            lambda: dm_gather_draw_tiers_plain(plain, tiers, seeds), iters=2,
            warmup=1)
        del world, plain
        bound = dm_bound(values, tiers, False)
        for k in ("bound_ms", "bytes", "ops", "gathered_bytes",
                  "gathered_ms_at_hbm"):
            sums[k] += bound[k]
        sums["t_bytes_ms"] += bound["bytes"] / HBM_BYTES_PER_S * 1e3
        sums["t_ops_ms"] += bound["ops"] / F32_OPS_PER_S * 1e3
    n_diff = sum(x["draws_differing"] for x in checks.values())
    n_draws = sum(x["draws"] for x in checks.values())
    require(n_diff <= 1e-4 * max(n_draws, 1),
            f"dm_gather_draw: {n_diff} of {n_draws} draws differ")
    del values
    streams = [dm_gather_stream_case(dev, *case) for case in DM_GATHER_STREAMS]
    hubs = [dm_gather_hub_stream_case(dev, *case) for case in DM_HUB_STREAMS]
    bad_rows = dm_bad_rows_check(dev)
    dm_gather_draw.launches = saved     # comparisons count no launch
    ptxas = [line for line in ptxas_summary(_build.build()[2])
             if line.startswith("dm_gather_draw")]
    kern = dict(ms=sums["ms"] / C, plain_ms=sums["plain_ms"] / C,
                bound_ms=sums["bound_ms"] / C,
                bound_by="bytes" if sums["t_bytes_ms"] >= sums["t_ops_ms"]
                else "operations", library_ms=None,
                max_abs_err=max(x["delta_max_abs_err"] for x in (
                    *checks.values(), *streams, *hubs)),
                launches_a_sweep=C, sweep_ms=sums["ms"],
                sweep_ms_before_redesign=DM_BEFORE_REDESIGN_MS,
                sweep_plain_ms=sums["plain_ms"],
                sweep_bound_ms=sums["bound_ms"], sweep_bytes=sums["bytes"],
                sweep_gathered_bytes=sums["gathered_bytes"],
                sweep_gathered_ms_at_hbm=sums["gathered_ms_at_hbm"],
                share_of_bound=sums["bound_ms"] / sums["ms"]
                if sums["ms"] else None)
    report("15b dm gather", t15b, card=card, chains=KBC_CHAINS, P=P,
           colors=C, plan_tiers=plan.tiers, tiers=per_tier,
           draws_differing=n_diff, draws=n_draws, colors_checked=checks,
           stream_cases=streams, hub_stream_cases=hubs,
           bad_hub_offsets_raise=bad_rows, ptxas=ptxas,
           kernel=kern)
    return kern


def grad_launches_an_epoch(info, dev, n_graph: int = 1) -> int:
    """grad_records_sum launches of one gradient with the default modes:
    where ``gradient_route`` sends any tier to the records route, one
    launch of the terms kernel a RECORD_MAX_TIERS of those tiers, then
    the pieces' and the weights' (3 on every learning cell), else 0."""
    from sampler_tpu_torch.engine.multichain import (gradient_route,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.grad import RECORD_MAX_TIERS

    modes = resolve_modes(info, dev)
    W = info.n_weights + 1
    n = sum(1 for ti in info.tiers if gradient_route(
        ti, info, modes, W, n_graph=n_graph)[0] == "records")
    return -(-n // RECORD_MAX_TIERS) + 2 if n else 0


def record_ops(A: int, NC: int, value_bytes: int) -> float:
    """Integer operations of grad_records_sum's terms kernel per (owner
    record, chain, world) at slot count A, as its body issues them.  On
    int8 worlds of 16-byte rows and A <= 3 (swar_chains, grad_records.cu)
    a slot takes 9 operations on a word of four chains (bytes_equal's
    5, the sign's xor, the count's shift and add, the head's or): 9A / 4
    a chain; then 9 a chain (the count's and the head's extraction, 2
    each, phi, about 4, and half of the difference and the sum).
    Elsewhere (a chain at a time) 4A + 10, the per-tier kernel's count."""
    if value_bytes == 1 and NC % 16 == 0 and A <= 3:
        return 9 * A / 4 + 9
    return 4 * A + 10


def grad_record_bound(plan, v_ev) -> dict:
    """The least time of one grad_records_sum call on these inputs: the
    world rows its owner records read in both worlds (the distinct own and
    neighbour rows: this run's data), the plan read once (head, flags,
    neighbours, eq; the permutation, the pieces), the terms written and
    read once, the weights written; per (owner record, chain, world)
    record_ops operations, nearly all integer, at the int32 rate."""
    import torch

    from sampler_tpu_torch.ops.grad import FLAG_OWN

    P, NC = v_ev.shape
    rows, nbytes, ops = [], 0, 0
    for head, flags, nbr, eq in plan.packed:
        n, A = flags.shape
        rows.append(head[:, 0].to(torch.int64))
        if nbr is not None:
            rows.append(nbr[(flags[:, :A - 1] & FLAG_OWN) == 0]
                        .to(torch.int64))
        nbytes += sum(x.numel() * x.element_size()
                      for x in (head, flags, nbr, eq) if x is not None)
        ops += round(n * NC * 2 * record_ops(A, NC, v_ev.element_size()))
    idx = torch.cat(rows)
    distinct = int(torch.unique(idx[(idx >= 0) & (idx < P)]).numel())
    N = plan.terms.numel()
    nbytes += (2 * distinct * NC * v_ev.element_size() + 2 * 4 * N + 4 * N
               + 4 * plan.piece_start.numel() + 8 * 2 * plan.partial.numel()
               + 4 * plan.weight_piece.numel() + 4 * plan.W)
    return dict(kernel_bound(nbytes, ops, INT32_OPS_PER_S),
                rows_read=distinct, owner_records=N)


def owner_terms(plan, v_ev, v_free) -> list:
    """Each tier's owner terms by the per-record plain version (its
    records where the owner mask is set, in record order): what
    ``plan.terms`` holds after a kernel call."""
    from sampler_tpu_torch.ops.grad import grad_records_plain

    out = []
    for t in plan.tiers:
        rec = t.gsel.reshape(-1).nonzero().flatten()
        out.append(grad_records_plain(v_ev, v_free, *t[:14],
                                      plan.all_boolean)
                   .reshape(-1).index_select(0, rec))
    return out


def records_tier_case(args, ratio: bool, what: str) -> float:
    """The per-tier grad_records kernel (the route before grad_records_sum)
    against grad_records_plain on one tier's arguments: bit for bit without
    RATIO, within RECORD_RATIO_TOL of the largest |out| with it, and two
    launches equal byte for byte.  Returns the max |diff|."""
    import torch

    from sampler_tpu_torch.ops.grad import grad_records, grad_records_plain

    got, again = grad_records(*args), grad_records(*args)
    ref = grad_records_plain(*args)
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
            f"grad_records: two launches differ ({what})")
    if ratio:
        require(err <= RECORD_RATIO_TOL * max(1.0, float(ref.abs().max())),
                f"grad_records: RATIO differs by {err} ({what})")
    else:
        require(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                f"grad_records differs from its plain version by {err} "
                f"({what})")
    return err


def record_plan_case(plan, v_ev, v_free, ratio: bool, what: str) -> dict:
    """grad_records_sum against its plain version on ``plan``: each weight
    within one float32 ulp of the plain sum (with RATIO, plus
    RECORD_RATIO_TOL of the largest |term| for each of its records), two
    calls equal byte for byte, and the kernel's owner terms
    (``plan.terms``) equal to the per-record plain version's bit for bit
    (with RATIO within RECORD_RATIO_TOL of the largest |term|)."""
    import torch

    from sampler_tpu_torch.ops.grad import (grad_records_sum,
                                            grad_records_sum_plain)

    got = grad_records_sum(v_ev, v_free, plan)
    terms = plan.terms.clone()
    again = grad_records_sum(v_ev, v_free, plan)
    ref = grad_records_sum_plain(v_ev, v_free, plan)
    want = torch.cat(owner_terms(plan, v_ev, v_free))
    require(torch.equal(got.view(torch.int32), again.view(torch.int32)),
            f"grad_records_sum: two calls differ ({what})")
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    terr = float((terms - want).abs().max()) if want.numel() else 0.0
    if ratio:
        require(terr <= RECORD_RATIO_TOL * scale, f"grad_records_sum: "
                f"RATIO owner terms differ by {terr} ({what})")
    else:
        require(torch.equal(terms.view(torch.int32), want.view(torch.int32)),
                f"grad_records_sum: owner terms differ by {terr} ({what})")
    r = ref.abs()
    ulp = torch.nextafter(r, torch.full_like(r, float("inf"))) - r
    tol = ulp
    if ratio:
        wid = torch.cat([t.wid.reshape(-1).index_select(
            0, t.gsel.reshape(-1).nonzero().flatten()) for t in plan.tiers])
        n_w = torch.bincount(wid.to(torch.int64), minlength=plan.W)
        tol = ulp + RECORD_RATIO_TOL * scale * n_w.to(ulp.dtype)
    diff = (got - ref).abs()
    require(bool((diff <= tol).all()), f"grad_records_sum: weight sums "
            f"differ by {float(diff.max())} ({what}), past one ulp")
    return dict(max_abs_err=float(diff.max()), terms_max_abs_err=terr,
                weights_off_by_one_ulp=int((diff > 0).sum()),
                owner_records=int(want.numel()),
                max_abs_weight=float(r.max()))


def grad_records_cell(dev, d, info, NC: int, seed: int) -> dict:
    """The records route on a learning cell's graph (every tier it takes,
    one grad_records_sum call), on random worlds of NC chains, both owner
    masks (learn_non_evidence on, and off, the learning cells' setting):
    record_plan_case, and each tier on the per-tier kernel
    (records_tier_case); the default-mode gradient launches at most 3 kernels
    and no segment_reduce; then the call's ms beside its bound, the plain
    version's, the route before this design (grad_records a tier and
    segment_reduce a tier) and that route's segment_reduce alone."""
    import torch

    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.engine import multichain as tmc
    from sampler_tpu_torch.ops import grad as tgrad
    from sampler_tpu_torch.ops.grad import (grad_records, grad_records_sum,
                                            grad_records_sum_plain)
    from sampler_tpu_torch.ops.weights import segment_reduce

    modes = tmc.resolve_modes(info, dev)
    W = d.w_init.shape[0]
    tiers = [t for t, ti in enumerate(info.tiers)
             if tmc.gradient_route(ti, info, modes, W)[0] == "records"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    card = d.var_card.clamp(min=1).to(torch.int64)[:, None]
    v_ev, v_free = [(torch.randint(0, 1 << 20, (card.shape[0], NC),
                                   generator=gen, device=dev) % card)
                    .to(tmc.values_dtype(info)) for _ in range(2)]
    ratio = any(fs.FUNC_RATIO in (ti.present_funcs or info.present_funcs)
                for ti in info.tiers)
    checks, per_tier = {}, {}
    for lne in (True, False):           # timed below: False, as learning
        plan = tmc._record_plan(d, info, tiers, lne, 1, 0)
        checks[f"lne_{lne}"] = record_plan_case(plan, v_ev, v_free, ratio,
                                                f"tiers {tiers}, lne {lne}")
        for t in tiers:                 # the per-tier kernel, as before
            ts, ti = d.tiers[t], info.tiers[t]
            present = ti.present_funcs or info.present_funcs
            args = (v_ev, v_free, *tmc._record_streams(
                ts, ti, info.n_colors, info.block_size,
                ts.cs_gowner if lne else ts.cs_gtouch, 1, 0,
                info.all_boolean), present, info.all_boolean)
            per_tier[f"tier {t}, lne {lne}"] = records_tier_case(
                args, fs.FUNC_RATIO in present, f"tier {t}, lne {lne}")
            del args
    # the default modes' whole gradient: 3 launches, no index_add_ sum
    reduced = []
    saved = {m: getattr(m, "segment_reduce") for m in (tmc, tgrad)}
    for m, orig in saved.items():
        setattr(m, "segment_reduce",
                lambda *a, _o=orig: reduced.append(1) or _o(*a))
    before = grad_records_sum.launches
    try:
        whole = tmc.mc_weight_gradient_cs(d, v_ev, v_free, False, info, modes)
    finally:
        for m, orig in saved.items():
            setattr(m, "segment_reduce", orig)
    launches = grad_records_sum.launches - before
    grad_records_sum.launches = before  # a comparison counts no launch
    require(launches == grad_launches_an_epoch(info, dev) <= 3
            and not reduced and bool(torch.isfinite(whole).all()),
            f"records route: {launches} launches, {len(reduced)} "
            f"segment_reduce calls")
    # the route before: per-record terms a tier, a segment sum a tier
    old = []
    for t in tiers:
        ts, ti = d.tiers[t], info.tiers[t]
        args = (v_ev, v_free, *tmc._record_streams(
            ts, ti, info.n_colors, info.block_size, ts.cs_gtouch, 1, 0,
            info.all_boolean), ti.present_funcs or info.present_funcs,
            info.all_boolean)
        old.append((args, ts.cs_wid, grad_records(*args)))

    def old_route():
        return sum(segment_reduce(grad_records(*a), wid, W)
                   for a, wid, _ in old)

    def old_sums():
        return sum(segment_reduce(out, wid, W) for _, wid, out in old)

    old_grad = old_route()
    new_grad = grad_records_sum(v_ev, v_free, plan)
    grad_records_sum.launches = before
    require(bool(((old_grad - new_grad).abs()
                  <= 1e-6 * max(1.0, float(old_grad.abs().max()))).all()),
            "records route: the new gradient differs from the route before")
    bound = grad_record_bound(plan, v_ev)
    ms = time_ms(lambda: grad_records_sum(v_ev, v_free, plan), iters=20)
    res = dict(tiers=tiers, hub=[info.tiers[t].hub for t in tiers],
               A=[info.tiers[t].arity for t in tiers], NC=NC, W=W,
               dtype=str(v_ev.dtype), ratio=ratio, checks=checks,
               per_tier_max_abs_err=per_tier,
               launches_a_gradient=launches, segment_reduce_calls=0,
               ms=ms,
               gradient_ms=time_ms(lambda: tmc.mc_weight_gradient_cs(
                   d, v_ev, v_free, False, info, modes), iters=20),
               before_ms=time_ms(old_route, iters=10),
               before_segment_reduce_ms=time_ms(old_sums, iters=10),
               plain_ms=time_ms(lambda: grad_records_sum_plain(
                   v_ev, v_free, plan), iters=2, warmup=1),
               t_bytes_ms=bound["bytes"] / HBM_BYTES_PER_S * 1e3,
               t_ops_ms=bound["ops"] / INT32_OPS_PER_S * 1e3, **bound)
    grad_records_sum.launches = before
    res["share_of_bound"] = res["bound_ms"] / ms
    del old, v_ev, v_free
    return res


FUNCS9 = (0, 1, 2, 3, 4, 7, 8, 9, 13)     # the boolean factor types
# (B, D, A, NC, card, types, int32 worlds, hub own rows, world off grid):
# A-1 = 0, 1, 2 and 4 (the looped variant), D 1..9 and 256 / 512, the
# nine boolean types, NC not a multiple of 16, a world one byte off the
# 16-byte grid, int32 worlds (card 200) and hub chunks' own rows; case i
# has 1 + i % 3 colors
GRAD_RECORD_STREAMS = (
    [(300, d, a, nc, 2, FUNCS9, False, False, False)
     for a in (1, 2, 3, 5) for d in (1, 2, 3, 5, 9) for nc in (48, 37)]
    + [(200, d, 3, 256, 2, FUNCS9, False, False, False)
       for d in (4, 6, 7, 8)]
    + [(64, 256, 3, 256, 2, FUNCS9, False, True, False),
       (16, 512, 3, 512, 2, FUNCS9[:6], False, True, False),
       (300, 5, 2, 512, 4, (3, 12), False, False, False),
       (300, 5, 2, 48, 200, (12,), True, False, False),
       (300, 5, 3, 36, 200, (3, 12), True, False, False),
       (300, 3, 3, 48, 2, FUNCS9, False, False, True),
       (300, 3, 2, 512, 4, (3, 12), False, False, True)])
RECORD_RATIO_TOL = 1e-6         # RATIO: relative to the largest |out|
GRAD_RECORD_TIERS = 10          # tiers in one plan: two terms launches


def record_streams(dev, B, D, A, NC, seed, card, types, int32, hub,
                   off_grid, C=1, P=3000) -> tuple:
    """Random grad_records arguments for C colors in compile's invariants:
    the ismine slots a non-empty suffix (slot A-1 always own) of the
    masked slots, one head slot, a masked one; arity the masked count;
    neighbour positions in [0, P); a color's own rows B apart, the last
    color's ending at P; hub=True gives them through an index array."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    S = (C, B, D)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def ints(lo, hi, *shape, dtype=torch.int64):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=dtype)

    slots = torch.arange(A, device=dev)
    ismine = slots >= (A - ints(1, A + 1, *S))[..., None]
    mask = (rand(*S, A) < 0.8) | ismine
    # one head slot a record, a masked one (a record without a head
    # would give RATIO log1p(-1))
    masked = torch.where(mask, rand(*S, A), -1.0)
    hmask = slots == masked.argmax(dim=-1, keepdim=True)
    pos = rand(*S, A) < 0.6
    eq = None if card == 2 else ints(0, card, *S, A, dtype=torch.int16)
    tys = torch.tensor(types, dtype=torch.int8, device=dev)
    vt = torch.int32 if int32 else torch.int8
    worlds = [ints(0, card, P, NC, dtype=vt) for _ in range(2)]
    if off_grid:            # the evidence world one byte past the grid
        buf = torch.empty(P * NC * worlds[0].element_size() + 1,
                          dtype=torch.int8, device=dev)
        view = buf[1:].view(vt).view(P, NC) if vt == torch.int8 else None
        if view is not None:
            view.copy_(worlds[0])
            worlds[0] = view
    return (*worlds, ints(0, P, *S, A - 1, dtype=torch.int32), pos,
            ismine, mask, hmask, eq, tys[ints(0, len(types), *S)],
            mask.sum(-1).to(torch.int16),
            torch.tensor([0.5, 1.0, 2.0, -1.5], device=dev)[
                ints(0, 4, *S)], rand(*S) < 0.6,
            P - C * B, B,
            ints(0, B, C, B, dtype=torch.int32) if hub else None,
            tuple(sorted(set(types))), card == 2)


def grad_record_stream_case(dev, case, seed: int) -> dict:
    """grad_records_sum against its plain version (record_plan_case) on
    random streams of 1 + seed % 3 colors, one tier, weight ids drawn from
    1 + seed % 7 weights; and the per-tier kernel on the same streams
    (records_tier_case)."""
    import torch

    from sampler_tpu_torch.ops.grad import RecordTier, record_plan

    B, D, A, NC, card, types, int32, hub, off = case
    C = 1 + seed % 3
    W = 1 + seed % 7
    args = record_streams(dev, B, D, A, NC, seed, card, types, int32, hub,
                          off, C)
    wid = torch.randint(0, W, (C, B, D), device=dev, dtype=torch.int32,
                        generator=torch.Generator(device=dev)
                        .manual_seed(seed))
    plan = record_plan([RecordTier(*args[2:16], wid)], W, args[16])
    res = record_plan_case(plan, args[0], args[1], 8 in types,
                           f"streams {case}, {C} colors")
    require(res["owner_records"] > 0, f"streams {case}: no owner record")
    res["per_tier_max_abs_err"] = records_tier_case(
        args, 8 in types, f"streams {case}, {C} colors")
    return dict(B=B, D=D, A=A, NC=NC, C=C, W=W, card=card, ratio=8 in types,
                int32=int32, hub=hub, off_grid=off and not int32, **res)


def grad_record_tiers_case(dev, seed: int) -> dict:
    """GRAD_RECORD_TIERS random tiers of A = 1, 2, 3 and 5 on one pair of
    worlds in one plan: past RECORD_MAX_TIERS, so two launches of the
    terms kernel, then the pieces and the weights; and a tier with no
    owner record among them."""
    import torch

    from sampler_tpu_torch.ops.grad import (RECORD_MAX_TIERS, RecordTier,
                                            grad_records_sum, record_plan,
                                            record_launches)

    W = 11
    tiers = []
    for i in range(GRAD_RECORD_TIERS):
        args = record_streams(dev, 40 + 7 * i, 1 + i % 5, (1, 2, 3, 5)[i % 4],
                              48, seed + i, 2, FUNCS9[:6], False, i == 3,
                              False, 1 + i % 3)
        if i == 0:
            worlds = args[:2]
        gsel = args[11] if i != 5 else torch.zeros_like(args[11])
        wid = torch.randint(0, W, tuple(args[10].shape), device=dev,
                            dtype=torch.int32, generator=torch.Generator(
                                device=dev).manual_seed(seed + i))
        tiers.append(RecordTier(*args[2:11], gsel, *args[12:16], wid))
    plan = record_plan(tiers, W, True)
    require(len(tiers) > RECORD_MAX_TIERS and record_launches(plan) == 4,
            f"{len(tiers)} tiers: {record_launches(plan)} launches")
    before = grad_records_sum.launches
    res = record_plan_case(plan, *worlds, False, "mixed tiers")
    grad_records_sum.launches = before
    return dict(tiers=len(tiers), launches=record_launches(plan), **res)


def grad_records_phase(dev, card: str, graphs: dict) -> dict:
    """Phase 16b: the records route's kernels (grad_records_sum) against
    their plain version at the learning shapes of phases 16, 9 and 12
    (``graphs``: name -> (device graph, info, chains a world); every tier
    that takes the route in one call, on random worlds; grad_records_cell),
    on random streams (GRAD_RECORD_STREAMS) and on GRAD_RECORD_TIERS mixed
    tiers in one plan; each cell's numbers.  The per-tier kernel
    (grad_records, the route before) is held to grad_records_plain on
    every tier of the cells and on every stream case as well.  Returns
    the numbers of grad_records_sum for the kernels line: a gradient's
    (3 launches') mean ms, plain ms, bound and library ms (the route
    before this design's segment_reduce) over the learning cells."""
    from sampler_tpu_torch.ops.grad import grad_records, grad_records_sum

    t16b = time.perf_counter()
    saved = grad_records_sum.launches
    saved_tier = grad_records.launches
    cells = {name: grad_records_cell(dev, d, info, NC, 16)
             for name, (d, info, NC) in graphs.items()}
    streams = [grad_record_stream_case(dev, case, i)
               for i, case in enumerate(GRAD_RECORD_STREAMS)]
    mixed = grad_record_tiers_case(dev, 99)
    grad_records_sum.launches = saved   # comparisons count no launch
    grad_records.launches = saved_tier
    n = len(cells)

    def mean(k):
        return sum(x[k] for x in cells.values()) / n

    kern = dict(ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by="bytes" if mean("t_bytes_ms") >= mean("t_ops_ms")
                else "operations",
                library_ms=mean("before_segment_reduce_ms"),
                max_abs_err=max(max(c["max_abs_err"]
                                    for c in x["checks"].values())
                                for x in cells.values()),
                launches_a_gradient={k: v["launches_a_gradient"]
                                     for k, v in cells.items()},
                gradient_ms={k: v["ms"] for k, v in cells.items()},
                before_ms={k: v["before_ms"] for k, v in cells.items()},
                gradient_bound_ms={k: v["bound_ms"]
                                   for k, v in cells.items()})
    report("16b grad records", t16b, card=card, cells=cells,
           stream_cases=streams, mixed_tiers=mixed, kernel=kern)
    return kern


def kbc_learn_phase(dev, card: str) -> tuple:
    """Phase 16: bench.py's KBC learning cell (bench.py:274-288):
    KBC_LEARN_VARS variables, greedy coloring, every other variable
    labelled, band_wmax=32768, hub_cap=256, LEARN_CHAINS chains a world,
    LEARN_EPOCHS epochs of LEARN_SWEEPS sweeps: dm_gather_draw launched
    once a color a sweep of each world, grad_records_sum's 3 launches an
    epoch (all five tiers), no eager color_delta_multilin and no row
    chunk of the chunked gradient.  The epoch by part with the gradient
    on the kernels and, beside it, on the chunked route.  Returns the
    device graph, its info and grad_records_sum's launches in the counted
    run, for phase 16b and the kernels line."""
    import dataclasses

    import torch

    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.coloring import greedy_coloring
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import (learn_mc, prepare_fold,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.fused import dm_gather_draw
    from sampler_tpu_torch.ops.grad import grad_records_sum

    t16 = time.perf_counter()
    g = kbc_graph(KBC_LEARN_VARS, 10_000, 1)
    colors = greedy_coloring(g)
    label_half(g)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, band_wmax=32768, hub_cap=256)
    compile_s = time.perf_counter() - tc
    require(info.has_hub, f"KBC learning tiers {info.tiers}")
    d = to_device(dg, dev)
    del dg
    cfg = LearnConfig(n_epochs=LEARN_EPOCHS, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    learn_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(1),
             dataclasses.replace(cfg, n_epochs=1), info, LEARN_CHAINS,
             device=dev)                                # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dm_gather_draw.launches = 0
    grad_records_sum.launches = 0
    with EagerCalls() as eager, EagerCalls("_phi_streams") as chunks:
        tr = time.perf_counter()
        w, v_ev, v_free = learn_mc(d, d.w_init,
                                   torch.Generator(device=dev).manual_seed(2),
                                   cfg, info, LEARN_CHAINS, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
    n_sw = cfg.n_epochs * cfg.n_sweeps_per_epoch
    dm_want = dm_launches_a_sweep(info) * n_sw * 2
    gr_want = grad_launches_an_epoch(info, dev) * cfg.n_epochs
    require(dm_gather_draw.launches == dm_want and eager.calls == 0,
            f"KBC learning: dm_gather_draw launches "
            f"{dm_gather_draw.launches} ({dm_want} expected), "
            f"{eager.calls} eager color_delta_multilin calls")
    require(grad_records_sum.launches == gr_want == 3 * cfg.n_epochs
            and chunks.calls == 0,
            f"KBC learning: grad_records_sum launches "
            f"{grad_records_sum.launches} "
            f"({gr_want} expected), {chunks.calls} chunked gradient row "
            f"chunks")
    nw = g.n_weights
    require(bool(torch.isfinite(w).all()), "KBC learning: weights not finite")
    require(int((w[:nw] != d.w_init[:nw]).sum()) > nw // 2,
            "KBC learning: most weights did not move")
    ev = (d.var_role == fs.ROLE_EVIDENCE) & (d.var_card > 1)
    require(bool((v_ev[ev] == d.var_init.to(v_ev.dtype)[ev, None]).all()),
            "KBC learning: the evidence world lost a label")
    learn = dict(chains=LEARN_CHAINS, epochs=cfg.n_epochs,
                 sweeps_per_epoch=cfg.n_sweeps_per_epoch,
                 compile_graph_s=compile_s, wall_s=wall,
                 learning_sweeps_per_s=n_sw / wall,
                 learning_updates_per_s=info.n_vars * n_sw * 2
                 * LEARN_CHAINS / wall,
                 peak_memory_bytes=torch.cuda.max_memory_allocated(),
                 weights_moved=int((w[:nw] != d.w_init[:nw]).sum()),
                 max_abs_weight=float(w.abs().max()),
                 dm_gather_draw_launches=dm_want,
                 grad_records_sum_launches=gr_want,
                 eager_color_delta_multilin_calls=eager.calls,
                 chunked_gradient_row_chunks=chunks.calls)
    modes = resolve_modes(info, dev)
    learn["epoch_breakdown_ms"] = epoch_parts(
        d, w, info, modes, v_ev, v_free, cfg,
        torch.Generator(device=dev).manual_seed(3), reps=1)
    learn["epoch_breakdown_chunked_gradient_ms"] = epoch_parts(
        d, w, info, modes, v_ev, v_free, cfg,
        torch.Generator(device=dev).manual_seed(3), reps=1,
        grad_modes=(modes[0], "off"))
    learn["fold_host_profile"] = host_profile(
        lambda: prepare_fold(d, w, info, modes))
    learn["gradient_share"] = {
        k: learn[k]["gradient"] / learn[k]["epoch"]
        for k in ("epoch_breakdown_ms", "epoch_breakdown_chunked_gradient_ms")}
    del v_ev, v_free
    report("16 kbc learn", t16, card=card, n_vars=info.n_vars,
           colors=info.n_colors, tiers=len(info.tiers), has_hub=info.has_hub,
           learning=learn)
    return d, info, gr_want


def graph_flags(g, outdir: str) -> list:
    """Write ``g`` with the port's binary writer into ``outdir``; returns
    the gibbs command's -w -v -f -m flags."""
    from sampler_tpu_torch.io import binary

    meta = binary.write_graph(g, outdir)
    return ["-w", os.path.join(outdir, "graph.weights"),
            "-v", os.path.join(outdir, "graph.variables"),
            "-f", os.path.join(outdir, "graph.factors"), "-m", meta]


def cli_child(args, env_extra=None) -> subprocess.Popen:
    """``python -m sampler_tpu_torch.cli`` started in a child process, from
    the repository root (the fault hook ends its process); see
    cli_subprocess."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **(env_extra or {}))
    return subprocess.Popen([sys.executable, "-m", "sampler_tpu_torch.cli"]
                            + args, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def cli_subprocess(args, env_extra=None) -> subprocess.CompletedProcess:
    """cli_child run to its end (CLI_TIMEOUT_S at most)."""
    child = cli_child(args, env_extra)
    try:
        out, err = child.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise
    return subprocess.CompletedProcess(child.args, child.returncode, out, err)


def cli_log(stdout: str) -> dict:
    """The numbers of the gibbs command's log lines."""
    import re

    pats = {"load_s": r"^loaded graph: .*\[([\d.]+)s\]",
            "compile_s": r"^compiled: .*\[([\d.]+)s\]",
            "learn_s": r"^learning: \d+ sweeps in ([\d.]+)s",
            "infer_s": r"^inference: \d+ sweeps x \d+ chains in ([\d.]+)s",
            "infer_vars_per_s": r"^inference: .*\(([\d.e+]+) vars/s\)",
            "counted_s": r"^counted sweeps: \d+ in ([\d.]+)s",
            "counted_vars_per_s":
                r"^counted sweeps: .*\(([\d.e+]+) vars/s\)",
            "peak_memory_bytes": r"^peak device memory (\d+) bytes",
            "chains": r"^inference: \d+ sweeps x (\d+) chains"}
    out = {}
    for key, pat in pats.items():
        m = re.search(pat, stdout, flags=re.M)
        if m:
            out[key] = float(m.group(1))
    m = re.search(r"^kernel launches: (.*)$", stdout, flags=re.M)
    if m:
        out["launches"] = json.loads(m.group(1))
    return out


def check_cli_outputs(g, outdir: str) -> dict:
    """The gibbs command's two files: one marginal line for each
    (variable, category) (one for a boolean variable), probabilities in
    [0, 1] that sum to 1 over a categorical variable's categories, one
    finite weight line for each weight.  Returns {(vid, cat): p} and the
    weights."""
    import numpy as np

    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.io import results

    parsed = results.read_marginals(
        os.path.join(outdir, "inference_result.out.text"))
    boolean = np.asarray(g.var_dtype) == fs.DTYPE_BOOLEAN
    want = int(np.where(boolean, 1, np.asarray(g.var_card)).sum())
    require(len(parsed) == want,
            f"{len(parsed)} marginal lines, {want} expected")
    marg = {(v, 1 if c is None else c): p for v, c, p in parsed}
    p = np.array(list(marg.values()))
    require(bool(((p >= 0) & (p <= 1)).all()), "a marginal outside [0, 1]")
    sums = {}
    for (v, _), pv in marg.items():
        if not boolean[v]:
            sums[v] = sums.get(v, 0.0) + pv
    require(all(abs(x - 1) < 1e-5 * (1 + g.var_card[v])
                for v, x in sums.items()),
            "a categorical variable's marginals do not sum to 1")
    with open(os.path.join(outdir,
                           "inference_result.out.weights.text")) as fp:
        w = np.array([float(ln.split()[1]) for ln in fp])
    require(len(w) == g.n_weights and bool(np.isfinite(w).all()),
            f"{len(w)} weight lines for {g.n_weights} weights")
    return marg, w


def cli_kbc_phase(dev, card: str, g, kbc_rate: float,
                  dm_a_sweep: int, grad_an_epoch: int) -> None:
    """Phase 17: the gibbs command on phase 15's KBC graph at full size:
    written by the port's binary writer, then learning and inference in a
    child process with phase 15's compile settings (CLI_KBC_ARGS).  Its
    dm_gather_draw launches must be phase 15's a sweep (``dm_a_sweep``:
    every deltam tier and color through the kernel, none through the
    eager arithmetic) times its sweeps, CLI_KBC_SWEEPS, and its
    grad_records_sum launches ``grad_an_epoch`` times its epochs."""
    import tempfile

    import torch

    t17 = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        tw = time.perf_counter()
        flags = graph_flags(g, tmp)
        write_s = time.perf_counter() - tw
        out = os.path.join(tmp, "out")
        tr = time.perf_counter()
        r = cli_subprocess(["gibbs", *flags, "-o", out, *CLI_KBC_ARGS,
                            "--device", dev.type])
        wall = time.perf_counter() - tr
        require(r.returncode == 0, f"KBC gibbs exited {r.returncode}: "
                f"{r.stderr[-2000:]}")
        log = cli_log(r.stdout)
        check_cli_outputs(g, out)
    require(log.get("launches", {}).get("tally_counts", 0) > 0,
            f"KBC gibbs launched no tally_counts: {log}")
    require(log["launches"].get("dm_gather_draw") == dm_a_sweep
            * CLI_KBC_SWEEPS, f"KBC gibbs: dm_gather_draw launches "
            f"{log['launches'].get('dm_gather_draw')}, "
            f"{dm_a_sweep * CLI_KBC_SWEEPS} expected")
    epochs = int(CLI_KBC_ARGS[CLI_KBC_ARGS.index("-l") + 1])
    require(log["launches"].get("grad_records_sum")
            == grad_an_epoch * epochs,
            f"KBC gibbs: grad_records_sum launches "
            f"{log['launches'].get('grad_records_sum')}, "
            f"{grad_an_epoch * epochs} expected")
    ratio = log["infer_vars_per_s"] / kbc_rate
    report("17 cli kbc", t17, card=card, args=CLI_KBC_ARGS,
           write_graph_s=write_s, command_wall_s=wall, cli=log,
           in_process_updates_per_s=kbc_rate,
           cli_over_in_process=ratio,
           counted_over_in_process=log["counted_vars_per_s"] / kbc_rate,
           stdout=r.stdout.splitlines())


def cli_marginal_err(g, outdir: str) -> float:
    """Largest |dp| of the command's marginals against exact enumeration
    (query variables)."""
    import numpy as np

    from sampler_tpu_torch import oracle

    marg, _ = check_cli_outputs(g, outdir)
    exact = oracle.exact_marginals(g, clamp_evidence=True)
    return max(abs(p - exact[v, c]) for (v, c), p in marg.items()
               if g.var_role[v] == 0)


def mixed_sparse_dense():
    """tests/test_sparse_weights.py's mixed graph: a sparse unary table,
    a dense categorical pair factor and a boolean unary factor."""
    from sampler_tpu_torch import FactorGraph
    from sampler_tpu_torch import format_spec as fs

    return FactorGraph.build(
        var_card=[3, 3, 2], weights=[0.4, -0.6, 0.8, 0.3],
        factors=[
            (fs.FUNC_AND_CATEGORICAL, 3, 1.0, [(0, True, 0)],
             [((0,), 0), ((1,), 1), ((2,), 2)]),
            (fs.FUNC_AND_CATEGORICAL, 3, 1.5, [(0, True, 1), (1, True, 2)]),
            (fs.FUNC_ISTRUE, 3, 1.0, [(2, True)]),
        ])


def sparse_learn_case(dev, tmp: str) -> dict:
    """A labelled graph with sparse per-combination weights
    (fixtures.labeled_categorical_graph, 400 observations of 3
    categories) learned through the command: grad_records_sum's 3
    launches an epoch.  Then its gradient on a pair of worlds of
    SPARSE_LEARN_CHAINS chains (the labels, and random values everywhere)
    on the default route (grad_records_sum on the
    dense owner records, the table lookup on the sparse ones) and on the
    chunked route (the fused mode off), equal within GRAD_RTOL of the
    largest |value|; no row chunk on the default route; each route's ms."""
    import torch

    from sampler_tpu_torch import cli, fixtures
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                     mc_weight_gradient_cs,
                                                     resolve_modes)
    from sampler_tpu_torch.ops.grad import grad_records_sum

    tc = time.perf_counter()
    g = fixtures.labeled_categorical_graph(n_obs=400, probs=(0.5, 0.2, 0.3),
                                           seed=2)
    dg, info = compile_graph(g)
    require(info.has_sparse_cw, "sparse learn: no sparse weights")
    want = grad_launches_an_epoch(info, dev)
    require(want == 3, f"sparse learn: {want} grad_records_sum launches an "
            f"epoch ({len(info.tiers)} tiers)")
    out = os.path.join(tmp, "sparse_learn")
    grad_records_sum.launches = 0
    require(cli.main(["gibbs", *graph_flags(g, out), "-o",
                      os.path.join(out, "out"), "-l",
                      str(SPARSE_LEARN_EPOCHS), "-a", "0.03", "-d", "0.995",
                      "-i", "10", "--device", dev.type, "--quiet"]) == 0,
            "sparse learn: gibbs failed")
    launches = grad_records_sum.launches
    require(launches == want * SPARSE_LEARN_EPOCHS,
            f"sparse learn: grad_records_sum launches {launches}, "
            f"{want * SPARSE_LEARN_EPOCHS} expected")
    _, w = check_cli_outputs(g, os.path.join(out, "out"))
    d = to_device(dg, dev)
    gen = torch.Generator(device=dev).manual_seed(18)
    v_ev = init_values_mc(d, gen, SPARSE_LEARN_CHAINS, info)
    v_free = (torch.randint(0, 1 << 20, v_ev.shape, generator=gen,
                            device=dev) % d.var_card.clamp(min=1)[:, None]
              ).to(v_ev.dtype)         # every variable free, evidence too
    modes = resolve_modes(info, dev)
    chunked = (modes[0], "off")
    with EagerCalls("_phi_streams") as rows:
        g_rec = mc_weight_gradient_cs(d, v_ev, v_free, True, info, modes)
    g_chk = mc_weight_gradient_cs(d, v_ev, v_free, True, info, chunked)
    err = float((g_rec - g_chk).abs().max())
    scale = float(g_chk.abs().max())
    require(rows.calls == 0 and scale > 0 and err <= GRAD_RTOL * scale,
            f"sparse gradient: {rows.calls} row chunks, |diff| {err} of "
            f"{scale}")
    ms = {name: time_ms(lambda: mc_weight_gradient_cs(
        d, v_ev, v_free, True, info, m), iters=10, warmup=2)
        for name, m in (("records", modes), ("chunked", chunked))}
    return dict(epochs=SPARSE_LEARN_EPOCHS,
                grad_records_sum_launches=launches,
                learned_weights=[float(x) for x in w[:3]],
                chains=SPARSE_LEARN_CHAINS, gradient_max_abs_diff=err,
                gradient_max_abs=scale, gradient_ms=ms,
                seconds=time.perf_counter() - tc)


def cli_oracle_phase(dev) -> dict:
    """Phase 18: the gibbs command on the card, in this process (cli.main),
    against exact enumeration: tests/test_cli.py's 3x3 Ising grid (|dp| <
    0.015) and labelled coin (the learned weight within 0.2 of the labels'
    log-odds), the sparse-weight graphs (|dp| < 0.01; the first with
    checkpoints, so in chunks of 150 sweeps, saved after each); a labelled
    sparse-weight graph learned through the command with its gradient on
    grad_records_sum (sparse_learn_case); then the cli_kernel_paths grids,
    whose kernel launches show the command's path through every draw
    kernel of their classes, grad_pair_tile and tally_counts."""
    import tempfile

    import numpy as np

    from sampler_tpu_torch import cli, fixtures

    kernels = cli_kernels()

    t18 = time.perf_counter()
    cases = {
        "ising_3x3": (fixtures.ising_grid(3, 3, w_pair=0.4, w_bias=0.3),
                      ["-i", "1000", "-b", "100", "--n_chains", "128"], 0.015),
        "sparse_categorical": (fixtures.sparse_categorical_graph(),
                               ["-i", "600", "-b", "100", "--n_chains",
                                "512", "--checkpoint_every", "150"], 0.01),
        "mixed_sparse_dense": (mixed_sparse_dense(),
                               ["-i", "600", "-b", "100", "--n_chains",
                                "512"], 0.01),
    }
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (g, args, bound) in cases.items():
            tc = time.perf_counter()
            d = os.path.join(tmp, name)
            require(cli.main(["gibbs", *graph_flags(g, d), "-o",
                              os.path.join(d, "out"), *args, "--device",
                              dev.type, "--quiet"]) == 0,
                    f"{name}: gibbs failed")
            err = cli_marginal_err(g, os.path.join(d, "out"))
            require(err < bound, f"{name}: |dp| = {err} (bound {bound})")
            out[name] = dict(max_abs_dp=err, bound=bound, args=args,
                             seconds=time.perf_counter() - tc)
        tc = time.perf_counter()
        g = fixtures.labeled_coin_graph(n_flips=300, p_heads=0.8, seed=5)
        d = os.path.join(tmp, "coin")
        require(cli.main(["gibbs", *graph_flags(g, d), "-o",
                          os.path.join(d, "out"), "-l", "300", "-a", "0.02",
                          "-d", "0.995", "-i", "10", "--device", dev.type,
                          "--quiet"]) == 0,
                "coin: gibbs failed")
        _, w = check_cli_outputs(g, os.path.join(d, "out"))
        p_hat = float(g.var_init.mean())
        w_star = float(np.log(p_hat / (1 - p_hat)))
        require(abs(w[0] - w_star) < 0.2, f"coin: w {w[0]} vs {w_star}")
        out["labelled_coin"] = dict(weight=float(w[0]), log_odds=w_star,
                                    seconds=time.perf_counter() - tc)
        out["sparse_learn"] = sparse_learn_case(dev, tmp)
        # the command's path through the kernels, on a grid of each class
        # that bands: learning and inference, no checkpoints
        for name, (make, args, want) in cli_kernel_paths().items():
            g = make()
            d = os.path.join(tmp, name)
            for k in kernels.values():
                k.launches = 0
            require(cli.main(["gibbs", *graph_flags(g, d), "-o",
                              os.path.join(d, "out"), *args, "--device",
                              dev.type, "--quiet"]) == 0,
                    f"{name}: gibbs failed")
            got = {n: k.launches for n, k in kernels.items()}
            require(all(got[k] == n for k, n in want.items()),
                    f"{name} gibbs launches {got}, want {want}")
            check_cli_outputs(g, os.path.join(d, "out"))
            out[name] = dict(grid=f"{CLI_GRID}x{CLI_GRID}", args=args,
                             launches=got)
    report("18 cli oracle", t18, graphs=out)


def big_grid(n: int):
    from sampler_tpu_torch.benchgraphs import big_ising_grid

    return big_ising_grid(n, n)[0]


def cli_kernels() -> dict:
    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_multi)
    from sampler_tpu_torch.ops.fused import (fused_cat_draw, fused_color_draw,
                                             fused_dm_draw)
    from sampler_tpu_torch.ops.grad import grad_pair_tile, grad_records_sum
    from sampler_tpu_torch.ops.tally import tally_counts

    return {k.__name__: k for k in (
        fused_color_draw, banded_gather, grad_pair_tile, fused_dm_draw,
        banded_gather_multi, fused_cat_draw, tally_counts, grad_records_sum)}


def cli_kernel_paths() -> dict:
    """name -> (graph maker, gibbs arguments, the launches they must make;
    the chunked gradients' gathers are counted, not required):
    CLI_GRID² grids of the three classes that band, run through the
    command with CLI_GRID_ARGS (learning, burn-in, counted sweeps): the
    labelled Ising grid (2 colors; fused_color_draw in both worlds' sweeps
    and inference, grad_pair_tile a color an epoch, no grad_records_sum),
    the Potts grid (2 colors, fused_cat_draw) and the triple grid (3
    colors, fused_dm_draw), each one tier on the records route
    (grad_records_sum: 3 launches an epoch); tally_counts once a counted
    sweep."""
    from sampler_tpu_torch.benchgraphs import big_potts_grid, big_triple_grid

    E, B, S = CLI_GRID_EPOCHS, CLI_GRID_BURN, CLI_GRID_SWEEPS
    return {
        "ising_grid": (lambda: label_half(big_grid(CLI_GRID)), CLI_GRID_ARGS,
                       {"fused_color_draw": 2 * (2 * E + B + S),
                        "grad_pair_tile": 2 * E, "grad_records_sum": 0,
                        "tally_counts": S}),
        "potts_grid": (lambda: label_half(big_potts_grid(CLI_GRID, CLI_GRID,
                                                         card=4)[0]),
                       CLI_GRID_ARGS,
                       {"fused_cat_draw": 2 * (2 * E + B + S),
                        "grad_records_sum": 3 * E, "tally_counts": S}),
        "triple_grid": (lambda: label_half(big_triple_grid(CLI_GRID,
                                                           CLI_GRID)[0]),
                        CLI_GRID_ARGS,
                        {"fused_dm_draw": 3 * (2 * E + B + S),
                         "grad_records_sum": 3 * E, "tally_counts": S}),
    }


def resume_start(dev, g, args, tmp: str, name: str,
                 fault_after: int) -> dict:
    """Write ``g`` and start its gibbs run that the fault hook kills after
    ``fault_after`` checkpoint saves (a child process, running while this
    process goes on); returns what resume_finish needs."""
    d = os.path.join(tmp, name)
    base = ["gibbs", *graph_flags(g, d), *args, "--device", dev.type,
            "--quiet"]
    out_b = os.path.join(d, "b")
    return dict(name=name, g=g, base=base, out_a=os.path.join(d, "a"),
                out_b=out_b, t=time.perf_counter(),
                child=cli_child(base + ["-o", out_b],
                                {"SAMPLER_TPU_FAULT_AFTER": str(fault_after)}))


def resume_finish(case: dict) -> dict:
    """The uninterrupted checkpointed run (cli.main, this process), then,
    once the killed child has ended, its --resume (cli.main); returns the
    two runs' outputs compared."""
    from sampler_tpu_torch import cli

    name, g, base = case["name"], case["g"], case["base"]
    out_a, out_b, child = case["out_a"], case["out_b"], case["child"]
    secs = {}
    t = time.perf_counter()
    require(cli.main(base + ["-o", out_a]) == 0, f"{name}: run a failed")
    secs["uninterrupted"] = time.perf_counter() - t
    try:
        _, err = child.communicate(timeout=CLI_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise
    secs["killed_child_from_start"] = time.perf_counter() - case["t"]
    require(child.returncode == 3, f"{name}: killed run exited "
            f"{child.returncode}: {err[-2000:]}")
    require(os.path.exists(os.path.join(out_b, "checkpoint.npz"))
            and not os.path.exists(os.path.join(
                out_b, "inference_result.out.text")),
            f"{name}: the killed run left no checkpoint, or outputs")
    t = time.perf_counter()
    require(cli.main(base + ["-o", out_b, "--resume"]) == 0,
            f"{name}: the resumed run failed")
    secs["resumed"] = time.perf_counter() - t
    res = {"seconds": secs}
    for fname in ("inference_result.out.text",
                  "inference_result.out.weights.text"):
        with open(os.path.join(out_a, fname), "rb") as fa, \
                open(os.path.join(out_b, fname), "rb") as fb:
            res[fname] = fa.read() == fb.read()
    ma, wa = check_cli_outputs(g, out_a)
    mb, wb = check_cli_outputs(g, out_b)
    res["max_abs_dp"] = max(abs(ma[k] - mb[k]) for k in ma)
    res["max_abs_dw"] = float(abs(wa - wb).max())
    return res


def cli_resume_phase(dev) -> None:
    """Phase 19: kill and resume on the card.  The labelled RESUME_GRID²
    grid and a small KBC graph with a hub tier (drawn in dm_gather_draw,
    whose sums have a fixed order): each killed and resumed run writes
    exactly the bytes of the uninterrupted one.  Both killed runs start
    first, side by side, and run while this process makes the
    uninterrupted runs."""
    import tempfile

    from sampler_tpu_torch.benchgraphs import random_kbc_graph

    t19 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        started = [
            resume_start(dev, label_half(big_grid(RESUME_GRID)),
                         RESUME_GRID_ARGS, tmp, "grid", 5),
            resume_start(dev, random_kbc_graph(
                *RESUME_KBC, max_arity=3, n_weights=1000, seed=0, skew=1.1,
                window=2000), RESUME_KBC_ARGS, tmp, "kbc", 4)]
        try:
            grid, kbc = (resume_finish(case) for case in started)
        finally:
            for case in started:
                if case["child"].poll() is None:
                    case["child"].kill()
                    case["child"].communicate()
    require(grid["inference_result.out.text"]
            and grid["inference_result.out.weights.text"],
            f"grid: the resumed run's outputs differ: {grid}")
    require(kbc["inference_result.out.text"]
            and kbc["inference_result.out.weights.text"],
            f"kbc: the resumed run's outputs differ: {kbc}")
    report("19 cli resume", t19, grid=dict(grid=RESUME_GRID,
                                           args=RESUME_GRID_ARGS, **grid),
           kbc=dict(n_vars=RESUME_KBC[0], args=RESUME_KBC_ARGS, **kbc))


# ---- phases 20-22: chain and graph sharding --------------------------------

def noise_bound(m_a, m_b) -> dict:
    """Mean and max |dp| between two unsharded runs (two seeds)."""
    import numpy as np

    d = np.abs(np.asarray(m_a, np.float64) - np.asarray(m_b, np.float64))
    return dict(mean_abs_dp=float(d.mean()), max_abs_dp=float(d.max()))


def within_noise(name: str, m, m_a, ref: dict) -> dict:
    """``m``'s mean and max |dp| against the unsharded run ``m_a``, held to
    GS_NOISE times the two unsharded seeds' (``ref``)."""
    got = noise_bound(m, m_a)
    require(got["mean_abs_dp"] <= GS_NOISE[0] * ref["mean_abs_dp"]
            and got["max_abs_dp"] <= GS_NOISE[1] * ref["max_abs_dp"],
            f"{name}: |dp| {got} against the unsharded run, beyond "
            f"{GS_NOISE} x the two unsharded seeds' {ref}")
    return dict(got, mean_over_unsharded=got["mean_abs_dp"]
                / ref["mean_abs_dp"],
                max_over_unsharded=got["max_abs_dp"] / ref["max_abs_dp"])


def rank_launches(ranks, need) -> list:
    """Each rank's kernel launches in the last call through ``ranks``;
    every rank must have launched every kernel of ``need``."""
    got = [{k: n for k, n in r.items() if n} for r in ranks.launches]
    require(all(r.get(k, 0) > 0 for r in got for k in need),
            f"a rank launched none of {need}: {got}")
    return got


def sync(dev) -> None:
    """Wait for the card (a rank on the CPU has nothing to wait for)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def gs_timed(comm, fn, iters: int) -> float:
    """ms a call of ``fn`` in this rank: host clock over ``iters`` calls
    between card synchronisations, after a barrier of the ranks (their
    exchanges go through host memory, so CUDA events would miss them)."""
    import torch.distributed as dist

    dist.barrier()
    sync(comm.device)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    sync(comm.device)
    return (time.perf_counter() - t) * 1e3 / iters


def gs_parts(comm, host, info, n_chains: int, halo, iters: int) -> dict:
    """A rank body: where one counted sharded sweep's time goes in this
    rank (the draws with the exchange left out, the exchange alone, the
    own-run tallies), beside the counted sweep; the peak memory of every
    rank."""
    import torch
    import torch.distributed as dist

    from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                     prepare_fold, sweep_mc,
                                                     tally)
    from sampler_tpu_torch.parallel import graph_shard as gsm
    from sampler_tpu_torch.engine.rng import chunk_generator

    dev = comm.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    dl, modes = gsm._local(comm, host, info, None)
    n = comm.mesh.n_graph
    shard = gsm.Shard(comm, info, halo) if n > 1 else None

    class NoExchange(gsm.Shard):
        def exchange(self, values, c, t):
            pass

    quiet = NoExchange(comm, info, halo) if n > 1 else None
    gen = chunk_generator(9, "parts", 0, dev, comm.row, comm.g)
    values = init_values_mc(dl, gen, n_chains, info)
    w = dl.w_init
    folded = prepare_fold(dl, w, info, modes)
    runs = gsm.own_runs(info, n, comm.g)
    segs = [torch.zeros((info.max_card, r1 - r0), dtype=torch.int32,
                        device=dev) for r0, r1 in runs]

    def tallies():
        for (r0, r1), seg in zip(runs, segs):
            tally(seg, values[r0:r1])

    def counted():
        sweep_mc(dl, values, w, gen, False, info, folded, modes, shard)
        tallies()

    def exchange():
        for c in range(info.n_colors):
            for t in range(len(info.tiers)):
                shard.exchange(values, c, t)

    counted()                                                  # warm
    parts = dict(
        counted_sweep=gs_timed(comm, counted, iters),
        draws=gs_timed(comm, lambda: sweep_mc(
            dl, values, w, gen, False, info, folded, modes, quiet), iters),
        exchange=gs_timed(comm, exchange, iters) if n > 1 else 0.0,
        tally=gs_timed(comm, tallies, iters))
    peaks = [None] * comm.mesh.size
    dist.all_gather_object(peaks, torch.cuda.max_memory_allocated(dev)
                           if cuda else None)
    return dict(rank0_ms=parts, tally_runs=len(runs),
                peak_memory_bytes_by_rank=peaks)


def local_draw_case(host, info, n_graph: int, g: int, dev,
                    n_chains: int) -> dict:
    """The fused draw of ``host``'s first tier (fused_color_draw,
    fused_cat_draw or fused_dm_draw, by the banded tier's class, or
    dm_gather_draw on a deltam tier without a banded plan) on rank g's
    local slice (its bd_ tiles and bd_start or its cs_nbr rows, its fold)
    against its plain version, every color: the delta within 1e-5 and the
    draws differing
    only within DRAW_GAP of p (the categorical draw: its logits exact and
    the draws differing only within CAT_GAP of a tie, as cat_case holds
    it); then its world-write mode at the rank's own rows, c*B + off +
    g*Bl, under the local cm_resample, against its output mode and the
    masked block write, bit for bit (the plain version's too)."""
    import torch

    from sampler_tpu_torch.engine.multichain import _dm_streams
    from sampler_tpu_torch.ops.fused import (DM_TILE_ROWS, dm_gather_draw,
                                             dm_gather_draw_plain,
                                             fold_affine, fold_affine_cat,
                                             fold_deltam, fold_deltam_tiles,
                                             fused_cat_draw,
                                             fused_cat_draw_plain,
                                             fused_color_draw,
                                             fused_color_draw_plain,
                                             fused_dm_draw,
                                             fused_dm_draw_plain)
    from sampler_tpu_torch.parallel.graph_shard import shard_device_graph

    local = shard_device_graph(host, info, n_graph, g, dev)
    ts, ti = local.tiers[0], info.tiers[0]
    C, B, D, TB, W = (info.n_colors, info.block_size, ti.degree, ti.band_tb,
                      ti.band_w)
    K = info.max_card
    Bl = ti.block // n_graph
    P = local.var_card.shape[0]
    gen = torch.Generator(device=dev).manual_seed(21)
    if K == 2:
        values = torch.randint(0, 2, (P, n_chains), generator=gen,
                               device=dev, dtype=torch.int8)
    else:
        values = (torch.randint(0, 1 << 20, (P, n_chains), generator=gen,
                                device=dev, dtype=torch.int32)
                  % local.var_card.clamp(min=1)[:, None]).to(torch.int8)
    seed = torch.tensor([4242, -99], dtype=torch.int32, device=dev)
    if ti.affinek:
        fold = fold_affine_cat(ts, ti, C, local.w_init)
        draw, plain = fused_cat_draw, fused_cat_draw_plain

        def make(c):
            return (values, ts.bd_nbr, ts.bd_start[c], ts.bd_eqo, ts.bd_eqn,
                    *fold, c, seed, W, TB, D, K)
    elif ti.fusedm:
        fold = fold_deltam_tiles(ts, ti, C, local.w_init)
        draw, plain = fused_dm_draw, fused_dm_draw_plain

        def make(c):
            return (values, ts.bd_dmnbr, ts.bd_start[c], *fold, c, seed, W,
                    TB, D, ti.arity - 1, ti.band_k)
    elif not ti.affine2:                 # a deltam tier, no band plan
        require(ti.deltam, f"local draw: tier {ti}")
        fold = fold_deltam(ts, ti, C, local.w_init)
        draw, plain = dm_gather_draw, dm_gather_draw_plain
        TB = DM_TILE_ROWS

        def make(c):
            return (values, *_dm_streams(ts, ti, c, info, fold), seed)
    else:
        fold = fold_affine(ts, ti, C, local.w_init)
        draw, plain = fused_color_draw, fused_color_draw_plain

        def make(c):
            return (values, ts.bd_nbr, ts.bd_start[c], *fold, c, seed, W,
                    TB, D)
    cat = dict(logits_max_abs_err=0.0, draws_differing=0, draws=0,
               max_score_gap_of_differing=0.0)
    err, n_diff, n_draws, changed = 0.0, 0, 0, {}
    for c in range(C):
        args = make(c)
        if ti.affinek:
            out = cat_compare(args, seed, TB, n_chains, cat)
        else:
            out, delta = draw(*args, return_delta=True)
            ref, ref_delta = plain(*args, return_delta=True)
            err = max(err, float((delta - ref_delta).abs().max()))
            n_diff += check_draws(out, ref, delta, seed, TB, n_chains)
            n_draws += out.numel()
            del delta, ref, ref_delta
        require(out.shape[0] == Bl, f"local draw of {out.shape[0]} rows")
        del out
        start = c * B + ti.off + g * Bl
        changed[f"c{c}"] = world_write_check(draw, args, start,
                                             ts.cm_resample[c])
        world_write_check(plain, args, start, ts.cm_resample[c])
    if ti.affinek:
        cat_verdict(cat)
        numbers = cat
    else:
        require(err < 1e-5, f"local {draw.__name__} delta error {err}")
        require(n_diff <= 1e-4 * n_draws,
                f"local {draw.__name__}: {n_diff} of {n_draws} draws differ")
        numbers = dict(delta_max_abs_err=err, draws_differing=n_diff,
                       draws=n_draws)
    return dict(kernel=draw.__name__, rank=g, of=n_graph, local_rows=Bl,
                local_tiles=-(-Bl // TB), chains=n_chains, **numbers,
                world_write_rows_changed=changed)


def gs_grad_case(comm, host, info, n_chains: int, halo):
    """A rank body: this rank's worlds (the evidence world after two
    sweeps, graph-sharded where the mesh has a graph axis; the free world
    as it starts), the mesh's gradient on them as learning reduces it
    (chains.reduced_gradient), and the worlds gathered whole
    (graph_shard._canonical: under halo, the own rows summed over the
    graph group).  Rank 0 returns (the gradients without and with
    learn_non_evidence, the evidence world, the free world) on the host;
    the evidence world moved away from the start, so a gradient over
    factors that touch no evidence is far from zero."""
    from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                     prepare_fold, sweep_mc)
    from sampler_tpu_torch.engine.rng import chunk_generator
    from sampler_tpu_torch.parallel import chains
    from sampler_tpu_torch.parallel import graph_shard as gsm

    dev = comm.device
    if comm.mesh.n_graph > 1:
        d, modes = gsm._local(comm, host, info, None)
        shard = gsm.Shard(comm, info, halo)
    else:
        d, _, modes = chains._rank_setup(comm, host, host.w_init, info, None)
        shard = None
    gen = chunk_generator(13, "grad_check_init", 0, dev, comm.row)
    v_ev = init_values_mc(d, gen, n_chains, info)
    v_free = init_values_mc(d, gen, n_chains, info)
    gen = chunk_generator(13, "grad_check", 0, dev, comm.row, comm.g)
    folded = prepare_fold(d, d.w_init, info, modes)
    for _ in range(2):
        sweep_mc(d, v_ev, d.w_init, gen, False, info, folded, modes, shard)
    grads = [chains.reduced_gradient(comm, d, v_ev, v_free, lne, info, modes,
                                     shard).cpu() for lne in (False, True)]
    ev = gsm._canonical(comm, v_ev, info, halo)
    free = gsm._canonical(comm, v_free, info, halo)
    return (grads, ev.cpu(), free.cpu()) if comm.rank == 0 else None


def grad_check(name: str, ranks, host, info, n_chains: int, halo,
               dev) -> dict:
    """The mesh's reduced gradients (gs_grad_case) against
    mc_weight_gradient_cs of the unsharded graph, on this process's card,
    on the chains rows' worlds side by side, without and with
    learn_non_evidence: each within GRAD_RTOL of its largest |value|
    (exactly zero where that is, as without evidence)."""
    import torch

    from sampler_tpu_torch.engine.multichain import (mc_weight_gradient_cs,
                                                     resolve_modes)
    from sampler_tpu_torch.parallel.chains import to_device_graph

    grads, ev, free = ranks.run(gs_grad_case, host, info, n_chains, halo)
    d = to_device_graph(host, dev)
    ev, free = ev.to(dev), free.to(dev)
    modes = resolve_modes(info, dev)
    res = dict(mesh=f"{ranks.mesh.n_chains}x{ranks.mesh.n_graph}",
               halo=halo, chains=n_chains * ranks.mesh.n_chains,
               rtol=GRAD_RTOL)
    for lne, grad in zip((False, True), grads):
        want = mc_weight_gradient_cs(d, ev, free, lne, info, modes).cpu()
        scale = float(want.abs().max())
        err = float((grad - want).abs().max())
        require(err <= GRAD_RTOL * scale,
                f"{name} (learn_non_evidence {lne}): the mesh's gradient is "
                f"{err} from the unsharded one (largest |value| {scale})")
        res[f"learn_non_evidence_{lne}"] = dict(max_abs_err=err,
                                                largest_abs=scale)
    require(res["learn_non_evidence_True"]["largest_abs"] > 0,
            f"{name}: the unsharded gradient is zero")
    del d, ev, free
    torch.cuda.empty_cache()
    return res


def gs_ising_phase(dev, card: str) -> None:
    """Phase 20: the Ising flagship sharded.  big_ising_grid(GRID, GRID)
    compiled with align=32, shards=4; CHAINS chains in all, GS_BURN +
    GS_SWEEPS sweeps each mesh: (1, 1) over NCCL, (2, 1) over Gloo (chain
    parallelism) and (1, 4) over Gloo in halo and all-gather modes (equal
    marginals and checkpointed worlds, bit for bit), each within the noise
    bound of two unsharded infer_mc runs; one rank's local
    fused_color_draw against its plain version; the reduced gradient of
    the (2, 1) and the halo (1, 4) mesh against the unsharded one
    (grad_check); the halo plan, the bytes a color step exchanges, a counted
    sweep by part and each rank's peak memory."""
    import numpy as np
    import torch

    from sampler_tpu_torch.benchgraphs import big_ising_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import infer_mc
    from sampler_tpu_torch.parallel.chains import learn_sharded
    from sampler_tpu_torch.parallel.comm import make_mesh
    from sampler_tpu_torch.parallel.graph_shard import (exchange_bytes,
                                                        halo_plan, infer_gs)
    from sampler_tpu_torch.parallel.launch import Ranks

    t20 = time.perf_counter()
    g, colors = big_ising_grid(GRID, GRID)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, align=32, shards=4)
    compile_s = time.perf_counter() - tc
    host = to_device(dg, "cpu")
    del dg
    d = to_device(host, dev)
    refs = [infer_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(s),
                     GS_BURN, GS_SWEEPS, info, CHAINS, device=dev)[0]
            for s in (101, 102)]
    del d
    torch.cuda.empty_cache()
    ref = noise_bound(*refs)
    halo = halo_plan(host, info, 4)
    require(halo is not None, "the flagship has no halo plan at 4 ranks")
    local = local_draw_case(host, info, 4, 2, dev, CHAINS)
    meshes = {}
    marg = {}
    worlds = {}
    grads = {}
    one = "nccl" if dev.type == "cuda" else "gloo"   # a CPU rehearsal
    for shape, backend in (((1, 1), one), ((2, 1), "gloo"),
                           ((1, 4), "gloo")):
        name = f"{shape[0]}x{shape[1]}_{backend}"
        ts = time.perf_counter()
        with Ranks(make_mesh(*shape, [str(dev)] * (shape[0] * shape[1]),
                             backend)) as ranks:
            start_s = time.perf_counter() - ts
            modes = ("auto", None) if shape == (1, 4) else ("auto",)
            for h in modes:
                key = name if len(modes) == 1 else f"{name}_{h or 'gather'}"
                # at (1, 4): checkpoints, whose worlds the two modes must
                # give alike (halo: each rank's own rows, summed over the
                # graph group)
                kept = worlds.setdefault(key, []) if len(modes) > 1 else None
                tr = time.perf_counter()
                marg[key] = infer_gs(
                    host, host.w_init, 7, GS_BURN, GS_SWEEPS, info, ranks,
                    CHAINS // shape[0], halo=h,
                    checkpoint_every=GS_SWEEPS if kept is not None else 0,
                    on_checkpoint=None if kept is None else (
                        lambda done, v, cnt, kept=kept: kept.append(
                            (done, v))))
                wall = time.perf_counter() - tr
                meshes[key] = dict(
                    ranks_start_s=start_s, wall_s=wall,
                    launches_by_rank=rank_launches(
                        ranks, ("fused_color_draw", "tally_counts")),
                    noise=within_noise(key, marg[key], refs[0], ref))
            if shape == (2, 1):
                # chain-parallel learning: grad_pair_tile in every rank
                tr = time.perf_counter()
                w = learn_sharded(host, host.w_init, 8, LearnConfig(
                    n_epochs=2, n_sweeps_per_epoch=1, stepsize=0.01),
                    info, ranks, LEARN_CHAINS)
                require(bool(torch.isfinite(w).all()),
                        "learn_sharded: weights not finite")
                meshes[name + "_learn"] = dict(
                    epochs=2, chains_a_rank=LEARN_CHAINS,
                    wall_s=time.perf_counter() - tr,
                    launches_by_rank=rank_launches(
                        ranks, ("fused_color_draw", "grad_pair_tile")))
                grads[name] = grad_check(name, ranks, host, info,
                                         LEARN_CHAINS, None, dev)
            if shape == (1, 4):
                grads[name + "_halo"] = grad_check(
                    name + " halo", ranks, host, info, LEARN_CHAINS, halo,
                    dev)
                meshes[name + "_parts"] = dict(
                    halo=ranks.run(gs_parts, host, info, CHAINS, halo, 3),
                    gather=ranks.run(gs_parts, host, info, CHAINS, None, 3))
    require(np.array_equal(marg["1x4_gloo_auto"],
                           marg["1x4_gloo_gather"]),
            "halo and all-gather marginals differ")
    ck_halo, ck_gather = worlds["1x4_gloo_auto"], worlds["1x4_gloo_gather"]
    require([d for d, _ in ck_halo] == [GS_SWEEPS, GS_BURN + GS_SWEEPS]
            and [d for d, _ in ck_gather] == [d for d, _ in ck_halo]
            and all(np.array_equal(a, b) for (_, a), (_, b) in
                    zip(ck_halo, ck_gather)),
            "the halo run's checkpointed worlds differ from the all-gather "
            "run's")
    checkpoints = dict(sweeps_done=[d for d, _ in ck_halo],
                       world_shape=list(ck_halo[-1][1].shape),
                       halo_equals_all_gather=True)
    del worlds, ck_halo, ck_gather
    report("20 gs ising", t20, card=card, arrangement=GS_ARRANGEMENT,
           grid=f"{GRID}x{GRID}", chains=CHAINS, burn=GS_BURN,
           sweeps=GS_SWEEPS, compile_graph_s=compile_s, halo_plan=halo,
           exchange_bytes_a_color_step=dict(
               halo=exchange_bytes(info, 4, halo, CHAINS),
               all_gather=exchange_bytes(info, 4, None, CHAINS)),
           halo_equals_all_gather=True, unsharded_seeds=ref,
           checkpointed_worlds_1x4=checkpoints, reduced_gradients=grads,
           local_fused_color_draw=local, meshes=meshes)


def gs_learn_parts(comm, host, info, n_chains: int, cfg) -> dict:
    """A rank body: one learn_gs epoch in this rank, by part (fold, both
    worlds' sweeps, the local gradient, its reduce over both groups, the
    update), host clock between card synchronisations."""
    from sampler_tpu_torch.engine.learn import apply_update
    from sampler_tpu_torch.engine.multichain import (init_values_mc,
                                                     mc_weight_gradient_cs,
                                                     prepare_fold, sweep_mc)
    from sampler_tpu_torch.parallel import graph_shard as gsm
    from sampler_tpu_torch.engine.rng import chunk_generator

    dev = comm.device
    dl, modes = gsm._local(comm, host, info, None)
    n = comm.mesh.n_graph
    shard = gsm.Shard(comm, info, None) if n > 1 else None
    gen = chunk_generator(5, "parts", 0, dev, comm.row, comm.g)
    v_ev = init_values_mc(dl, gen, n_chains, info)
    v_free = init_values_mc(dl, gen, n_chains, info)
    w = dl.w_init
    out = {}

    def part(name, fn):
        sync(dev)
        t = time.perf_counter()
        res = fn()
        sync(dev)
        out[name] = (time.perf_counter() - t) * 1e3
        return res

    folded = part("fold", lambda: prepare_fold(dl, w, info, modes))

    def sweeps():
        for _ in range(cfg.n_sweeps_per_epoch):
            sweep_mc(dl, v_ev, w, gen, False, info, folded, modes, shard)
            sweep_mc(dl, v_free, w, gen, True, info, folded, modes, shard)

    part("sweeps", sweeps)
    grad = part("gradient", lambda: mc_weight_gradient_cs(
        dl, v_ev, v_free, False, info, modes, n_graph=n, g=comm.g))

    def reduce():
        if shard is not None:
            shard.psum(grad)
        comm.mean_(grad, "chains")

    part("reduce", reduce)
    part("update", lambda: apply_update(w, grad, dl.w_fixed, cfg.stepsize,
                                        cfg.regularization, cfg.reg_param))
    return dict(rank0_ms=out, epoch_ms=sum(out.values()))


def kbc_native_noise(dev, g, order, ranks) -> dict:
    """Phase 21's sharded run on the native coloring: its mean |dp|
    against an unsharded run held to GS_NOISE[0] times two unsharded
    seeds', its max |dp| reported beside three unsharded seeds' against
    the same run (the hub variables set the max)."""
    import torch

    from sampler_tpu_torch.coloring import greedy_coloring
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import infer_mc
    from sampler_tpu_torch.parallel.graph_shard import infer_gs

    dg, info = compile_graph(g, colors=greedy_coloring(g), order=order,
                             band_wmax=32768, hub_cap=256, align=16,
                             shards=2)
    host = to_device(dg, "cpu")
    del dg
    d = to_device(host, dev)
    refs = [infer_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(s),
                     GS_BURN, GS_SWEEPS, info, KBC_CHAINS, device=dev)[0]
            for s in (201, 202, 203, 204)]
    del d
    torch.cuda.empty_cache()
    marg = infer_gs(host, host.w_init, 3, GS_BURN, GS_SWEEPS, info, ranks,
                    KBC_CHAINS)
    ref, got = noise_bound(refs[0], refs[1]), noise_bound(marg, refs[0])
    require(got["mean_abs_dp"] <= GS_NOISE[0] * ref["mean_abs_dp"],
            f"kbc 1x2, native coloring: mean |dp| {got} beyond "
            f"{GS_NOISE[0]} x the unsharded seeds' {ref}")
    return dict(n_colors=info.n_colors, sharded_vs_201=got,
                unsharded_vs_201={s: noise_bound(m, refs[0]) for s, m in
                                  zip((202, 203, 204), refs[1:])},
                mean_over_unsharded=got["mean_abs_dp"] / ref["mean_abs_dp"],
                max_over_unsharded=got["max_abs_dp"] / ref["max_abs_dp"])


def gs_kbc_phase(dev, card: str, g, order, ranks) -> None:
    """Phase 21: the KBC class sharded.  Phase 15's graph (its RCM order,
    and the numpy colorer's coloring: see below), compiled with shards=2,
    KBC_CHAINS chains, GS_BURN +
    GS_SWEEPS sweeps on ``ranks`` (1 x 2 over Gloo: all-gather, since no
    tier bands; the hub tier split by chunks): the marginals within the
    noise bound of two unsharded infer_mc runs, the rate, a counted sweep
    by part and each rank's peak memory, every rank's dm_gather_draw
    launches, and dm_gather_draw on rank 1's local slice (local_draw_case)
    against its plain version and in world-write mode at its rows; then
    one learn_gs epoch on phase 16's KBC learning graph (LEARN_CHAINS
    chains a world), and its parts; the mesh's reduced gradient there
    against the unsharded graph's."""
    import dataclasses

    import torch

    from sampler_tpu_torch.coloring import greedy_coloring
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.learn import LearnConfig
    from sampler_tpu_torch.engine.multichain import infer_mc
    from sampler_tpu_torch.parallel.graph_shard import (exchange_bytes,
                                                        halo_plan, infer_gs,
                                                        learn_gs)

    t21 = time.perf_counter()
    # The noise bound's max |dp| is set by a few hub variables, which mix
    # slowly, and one pair of unsharded seeds gives its reference.  Under
    # the native coloring (phase 15's since it became the default) an
    # unsharded seed pair exceeds 1.5x another pair's maximum on this
    # graph, at a hub variable (kbc_native_noise), so the full check
    # keeps the coloring it was set on, the numpy colorer's.
    colors = greedy_coloring(g, native=False)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors, order=order, band_wmax=32768,
                             hub_cap=256, align=16, shards=2)
    compile_s = time.perf_counter() - tc
    require(info.has_hub and halo_plan(dg, info, 2) is None,
            f"sharded KBC tiers {info.tiers}")
    host = to_device(dg, "cpu")
    del dg
    d = to_device(host, dev)
    refs = [infer_mc(d, d.w_init, torch.Generator(device=dev).manual_seed(s),
                     GS_BURN, GS_SWEEPS, info, KBC_CHAINS, device=dev)[0]
            for s in (201, 202)]
    del d
    torch.cuda.empty_cache()
    ref = noise_bound(*refs)
    tr = time.perf_counter()
    marg = infer_gs(host, host.w_init, 3, GS_BURN, GS_SWEEPS, info, ranks,
                    KBC_CHAINS)
    wall = time.perf_counter() - tr
    run = dict(wall_s=wall,
               variable_updates_per_s=info.n_vars * KBC_CHAINS
               * (GS_BURN + GS_SWEEPS) / wall,
               launches_by_rank=rank_launches(ranks, ("tally_counts",
                                                      "dm_gather_draw")),
               noise=within_noise("kbc 1x2", marg, refs[0], ref),
               native_coloring=kbc_native_noise(dev, g, order, ranks),
               parts=ranks.run(gs_parts, host, info, KBC_CHAINS, None, 2),
               exchange_bytes_a_color_step=exchange_bytes(
                   info, 2, None, KBC_CHAINS))
    run["local_draw"] = local_draw_case(host, info, 2, 1, dev, KBC_CHAINS)
    del host
    # one learning epoch on the KBC learning graph
    gl = kbc_graph(KBC_LEARN_VARS, 10_000, 1)
    label_half(gl)
    dgl, infol = compile_graph(gl, colors=greedy_coloring(gl),
                               band_wmax=32768, hub_cap=256, align=16,
                               shards=2)
    hostl = to_device(dgl, "cpu")
    del dgl
    cfg = LearnConfig(n_epochs=1, n_sweeps_per_epoch=LEARN_SWEEPS,
                      stepsize=0.01, diminish=0.99, regularization="l2",
                      reg_param=0.01)
    tr = time.perf_counter()
    w = learn_gs(hostl, hostl.w_init, 4, cfg, infol, ranks, LEARN_CHAINS)
    learn_wall = time.perf_counter() - tr
    nw = gl.n_weights
    require(bool(torch.isfinite(w).all()) and int(
        (w[:nw] != hostl.w_init[:nw]).sum()) > nw // 2,
        "KBC learn_gs: weights not finite, or most did not move")
    learn = dict(chains=LEARN_CHAINS, sweeps_per_epoch=LEARN_SWEEPS,
                 wall_s=learn_wall, launches_by_rank=rank_launches(
                     ranks, ("dm_gather_draw", "grad_records_sum")),
                 parts=ranks.run(gs_learn_parts, hostl, infol, LEARN_CHAINS,
                                 dataclasses.replace(cfg)),
                 reduced_gradient=grad_check("kbc learn 1x2", ranks, hostl,
                                             infol, LEARN_CHAINS, None, dev))
    report("21 gs kbc", t21, card=card, arrangement=GS_ARRANGEMENT,
           n_vars=info.n_vars, tiers=len(info.tiers), chains=KBC_CHAINS,
           burn=GS_BURN, sweeps=GS_SWEEPS, compile_graph_s=compile_s,
           unsharded_seeds=ref, run=run, learning=learn)


def gs_grid_checks(dev, ranks) -> dict:
    """Phase 22's labelled CLI_GRID² Ising, Potts and triple grids,
    compiled with shards=2, straight through infer_gs on ``ranks`` (1 x
    2): CHAINS chains, GS_BURN + GS_SWEEPS sweeps, the marginals within
    the noise bound of two unsharded infer_mc runs and every rank
    launching the tier's fused draw and tally_counts; the Potts and
    triple grids' fused draw on rank 1's local slice against its plain
    version and in world-write mode (local_draw_case)."""
    import torch

    from sampler_tpu_torch.benchgraphs import (big_ising_grid,
                                               big_potts_grid,
                                               big_triple_grid)
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import infer_mc
    from sampler_tpu_torch.parallel.graph_shard import infer_gs

    res = {}
    for name, make, draw in (
            ("ising_grid", lambda: big_ising_grid(CLI_GRID, CLI_GRID),
             "fused_color_draw"),
            ("potts_grid", lambda: big_potts_grid(CLI_GRID, CLI_GRID, card=4),
             "fused_cat_draw"),
            ("triple_grid", lambda: big_triple_grid(CLI_GRID, CLI_GRID),
             "fused_dm_draw")):
        g, colors = make()
        label_half(g)
        dg, info = compile_graph(g, colors=colors, align=16, shards=2)
        ti = info.tiers[0]
        kind = ("fused_cat_draw" if ti.affinek else "fused_dm_draw"
                if ti.fusedm else "fused_color_draw")
        require(len(info.tiers) == 1 and ti.band_w > 0 and kind == draw,
                f"{name} at shards=2: tiers {info.tiers}")
        host = to_device(dg, "cpu")
        del dg
        d = to_device(host, dev)
        refs = [infer_mc(d, d.w_init,
                         torch.Generator(device=dev).manual_seed(s), GS_BURN,
                         GS_SWEEPS, info, CHAINS, device=dev)[0]
                for s in (301, 302)]
        del d
        ref = noise_bound(*refs)
        m = infer_gs(host, host.w_init, 9, GS_BURN, GS_SWEEPS, info, ranks,
                     CHAINS)
        res[name] = dict(
            chains=CHAINS, unsharded_seeds=ref,
            noise=within_noise(f"sharded {name}", m, refs[0], ref),
            launches_by_rank=rank_launches(ranks, (draw, "tally_counts")))
        if draw != "fused_color_draw":
            res[name]["local_draw"] = local_draw_case(host, info, 2, 1, dev,
                                                      CHAINS)
    return res


def gs_cli(dev, ranks, flags, out: str, args) -> dict:
    """The gibbs command with --n_graph_shards 2 in this process on
    ``ranks``: returns its log's kernel launches by rank."""
    import contextlib
    import io
    import re

    from sampler_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["gibbs", *flags, "-o", out, *args, "--n_graph_shards",
                       "2", "--device", dev.type], mesh=ranks)
    require(rc == 0, f"sharded gibbs exited {rc}")
    m = re.search(r"^kernel launches by rank: (.*)$", buf.getvalue(),
                  flags=re.M)
    # the command logs launches on the card (a CPU rehearsal logs none)
    require(m is not None or dev.type != "cuda",
            f"no launches in the log: {buf.getvalue()}")
    return json.loads(m.group(1)) if m else [{}, {}]


def gs_cli_phase(dev, card: str, ranks) -> None:
    """Phase 22: the gibbs command's sharded route (_run_gibbs_sharded,
    --n_graph_shards 2) on ``ranks`` (1 x 2 over Gloo, one card): the 3x3
    Ising grid against exact enumeration (|dp| < 0.015) and the labelled
    coin (within 0.2 of the labels' log-odds); the labelled CLI_GRID²
    Ising, Potts and triple grids, whose ranks must each launch
    fused_color_draw, fused_cat_draw, fused_dm_draw and tally_counts, and
    the same grids through infer_gs (gs_grid_checks: the noise bound, the
    local Potts and triple draws against their plain versions); and
    the labelled RESUME_GRID² grid killed by the fault hook (a child
    process with its own ranks, started first) and resumed writes the
    uninterrupted checkpointed run's bytes."""
    import tempfile

    import numpy as np

    from sampler_tpu_torch import fixtures
    from sampler_tpu_torch.benchgraphs import big_potts_grid, big_triple_grid

    t22 = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        dk = os.path.join(tmp, "resume")
        gk = label_half(big_grid(RESUME_GRID))
        base = [*graph_flags(gk, dk), *RESUME_GRID_ARGS]
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""),
                   SAMPLER_TPU_FAULT_AFTER="5")
        out_b = os.path.join(dk, "b")
        child = subprocess.Popen(
            [sys.executable, "-c", GS_CHILD, "gibbs", *base, "-o", out_b,
             "--n_graph_shards", "2", "--device", dev.type], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            d = os.path.join(tmp, "ising_3x3")
            g = fixtures.ising_grid(3, 3, w_pair=0.4, w_bias=0.3)
            gs_cli(dev, ranks, graph_flags(g, d), os.path.join(d, "out"),
                   ["-i", "1000", "-b", "100", "--n_chains", "128"])
            err = cli_marginal_err(g, os.path.join(d, "out"))
            require(err < 0.015, f"sharded gibbs 3x3: |dp| = {err}")
            res["ising_3x3"] = dict(max_abs_dp=err, bound=0.015)
            d = os.path.join(tmp, "coin")
            g = fixtures.labeled_coin_graph(n_flips=300, p_heads=0.8, seed=5)
            gs_cli(dev, ranks, graph_flags(g, d), os.path.join(d, "out"),
                   ["-l", "300", "-a", "0.02", "-d", "0.995", "-i", "10"])
            _, w = check_cli_outputs(g, os.path.join(d, "out"))
            p_hat = float(g.var_init.mean())
            w_star = float(np.log(p_hat / (1 - p_hat)))
            require(abs(w[0] - w_star) < 0.2,
                    f"sharded coin: w {w[0]} vs {w_star}")
            res["labelled_coin"] = dict(weight=float(w[0]), log_odds=w_star)
            grids = {
                "ising_grid": lambda: label_half(big_grid(CLI_GRID)),
                "potts_grid": lambda: label_half(big_potts_grid(
                    CLI_GRID, CLI_GRID, card=4)[0]),
                "triple_grid": lambda: label_half(big_triple_grid(
                    CLI_GRID, CLI_GRID)[0])}
            total = None
            for name, make in grids.items():
                d = os.path.join(tmp, name)
                g = make()
                got = gs_cli(dev, ranks, graph_flags(g, d),
                             os.path.join(d, "out"), CLI_GRID_ARGS)
                check_cli_outputs(g, os.path.join(d, "out"))
                print(f"  22 {name}: launches by rank {json.dumps(got)}",
                      flush=True)
                res[name] = dict(launches_by_rank=got)
                total = got if total is None else [
                    {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}
                    for a, b in zip(total, got)]
            need = ("fused_color_draw", "fused_cat_draw", "fused_dm_draw",
                    "tally_counts")
            require(all(r.get(k, 0) > 0 for r in total for k in need),
                    f"a rank launched none of {need}: {total}")
            res["grids_through_infer_gs"] = gs_grid_checks(dev, ranks)
            out_a = os.path.join(dk, "a")
            gs_cli(dev, ranks, base, out_a, [])
            try:
                _, err = child.communicate(timeout=CLI_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                child.kill()
                child.communicate()
                raise
            require(child.returncode == 3, f"killed sharded run exited "
                    f"{child.returncode}: {err[-2000:]}")
            gs_cli(dev, ranks, base, out_b, ["--resume"])
        finally:
            if child.poll() is None:
                child.kill()
                child.communicate()
        same = {}
        for fname in ("inference_result.out.text",
                      "inference_result.out.weights.text"):
            with open(os.path.join(out_a, fname), "rb") as fa, \
                    open(os.path.join(out_b, fname), "rb") as fb:
                same[fname] = fa.read() == fb.read()
        require(all(same.values()), f"sharded resume differs: {same}")
        res["resume"] = dict(grid=RESUME_GRID, args=RESUME_GRID_ARGS,
                             bytes_equal=same)
    report("22 gs cli", t22, card=card, arrangement=GS_ARRANGEMENT,
           graphs=res)


def arrays_equal(a, b, what: str) -> int:
    """Require two compiled graphs' arrays to be equal, name by name,
    dtype and shape included; returns the bytes compared."""
    import numpy as np

    from sampler_tpu_torch.compile import iter_arrays

    n = 0
    for (name, x), (other, y) in zip(iter_arrays(a), iter_arrays(b)):
        require(name == other and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y), f"{what}: {name} differs")
        n += x.nbytes
    return n


class FillWatch:
    """Wraps compile.fill_streams while open: adds up the seconds of every
    tier's stream fill by the route compile_graph asks for, and with
    ``both`` also fills each tier by the numpy plain version into arrays of
    its own, timed apart, and requires them equal to the native fill's."""

    def __init__(self, both: bool = False):
        import sampler_tpu_torch.compile as comp

        self.comp, self.fill, self.both = comp, comp.fill_streams, both
        self.seconds = {"native": 0.0, "numpy": 0.0}
        self.checking_s = 0.0        # the comparisons' own seconds
        self.bytes_equal = 0

    def __call__(self, outs, native, *args):
        import numpy as np

        t = time.perf_counter()
        self.fill(outs, native, *args)
        self.seconds["native" if native else "numpy"] += \
            time.perf_counter() - t
        if self.both and native:
            plain = {k: np.empty_like(a) for k, a in outs.items()}
            t = time.perf_counter()
            self.fill(plain, False, *args)
            self.seconds["numpy"] += time.perf_counter() - t
            t = time.perf_counter()
            for k, a in outs.items():
                require(np.array_equal(a, plain[k]),
                        f"{k}: the native fill differs from the numpy fill")
                self.bytes_equal += a.nbytes
            del plain
            self.checking_s += time.perf_counter() - t

    def __enter__(self):
        self.comp.fill_streams = self
        return self

    def __exit__(self, *exc):
        self.comp.fill_streams = self.fill


def host_route(g, colors, native: bool, **kw) -> tuple:
    """compile_graph by one route (the native host library, or its numpy
    plain versions): (graph, info, seconds of the whole compile and of its
    stream fill alone)."""
    from sampler_tpu_torch.compile import compile_graph

    with FillWatch() as watch:
        t = time.perf_counter()
        dg, info = compile_graph(g, colors=colors, native=native, **kw)
        total = time.perf_counter() - t
    return dg, info, dict(compile_graph_s=total,
                          stream_fill_s=sum(watch.seconds.values()))


def host_phase(card: str) -> None:
    """Phase 23: host seconds by part, native route and numpy route, on
    phase 15's KBC graph: generation, greedy coloring by each route, RCM
    (numpy in both), compile_graph with the native coloring passed to
    both, and its stream fill alone.  The two routes' compiled graphs must
    be equal, every array.  (The 5120^2 grid's host seconds come from
    phase 24's one compile of it, FillWatch(both=True).)"""
    import gc

    import numpy as np

    from sampler_tpu_torch import native
    from sampler_tpu_torch.coloring import greedy_coloring, rcm_order

    t23 = time.perf_counter()
    _, build_s = native.build()
    routes = ("native", "numpy")
    t = time.perf_counter()
    g = kbc_graph(KBC_VARS, 100_000, 0)
    kbc = dict(n_vars=g.n_vars, generate_s=time.perf_counter() - t,
               routes={r: {} for r in routes})
    colors = {}
    for r in routes:
        t = time.perf_counter()
        colors[r] = greedy_coloring(g, native=r == "native")
        kbc["routes"][r]["greedy_coloring_s"] = time.perf_counter() - t
        kbc["routes"][r]["n_colors"] = int(colors[r].max()) + 1
    kbc["colorings_equal"] = bool(np.array_equal(*colors.values()))
    t = time.perf_counter()
    order = rcm_order(g)
    kbc["rcm_order_s_both_routes"] = time.perf_counter() - t
    dgs = {}
    for r in routes:
        dgs[r], info, kbc["routes"][r]["compile"] = host_route(
            g, colors["native"], r == "native", order=order,
            band_wmax=32768, hub_cap=256)
    kbc["bytes_equal"] = arrays_equal(dgs["native"], dgs["numpy"], "KBC")
    kbc["tiers"] = len(info.tiers)
    del g, dgs, colors, order
    gc.collect()
    report("23 host", t23, card=card, native_build_s=build_s,
           host_cpus=os.cpu_count(), kbc=kbc)


def edge_tiles(B: int, off: int, TB: int, nt: int, NC: int) -> list:
    """Two runs of tiles of an affine2 tier: EDGE_TILES each side of the
    tile that holds world row 2^31 // NC in the second color block (where
    element 2^31 of the world lies; in the first block, the tiles whose
    neighbours lie there), and the last EDGE_TILES of the block."""
    row = (1 << 31) // NC - (B + off)
    t = min(max(row // TB, EDGE_TILES), nt - EDGE_TILES)
    return [(t - EDGE_TILES, t + EDGE_TILES), (nt - EDGE_TILES, nt)]


def past_2_31_cases(d, info, values, seed) -> list:
    """fused_color_draw against its plain version on edge_tiles of every
    color of the scale world (the world whole; the streams cut to the
    tiles): the delta within 1e-5 and draws differing only within DRAW_GAP
    of p in output mode; in world-write mode the world equal bit for bit to
    the output route's masked write (world_write_check), and the plain
    version's world-write differing from the kernel's only in the block
    written, within DRAW_GAP."""
    import torch

    from sampler_tpu_torch.ops.fused import (fold_affine, fused_color_draw,
                                             fused_color_draw_plain)

    ts, ti = d.tiers[0], info.tiers[0]
    C, B, D, TB, W = info.n_colors, info.block_size, ti.degree, ti.band_tb, \
        ti.band_w
    nt = ti.block // TB
    P, NC = values.shape
    beta, base = fold_affine(ts, ti, C, d.w_init)
    cases = []
    for c in range(C):
        for t0, t1 in edge_tiles(B, ti.off, TB, nt, NC):
            def cut(a):
                return a[c:c + 1, t0:t1].contiguous()

            nbr = cut(ts.bd_nbr)
            args = (values, nbr, ts.bd_start[c, t0:t1].contiguous(),
                    cut(beta), cut(base), 0, seed, W, TB, D)
            out, delta = fused_color_draw(*args, return_delta=True)
            ref, ref_delta = fused_color_draw_plain(*args, return_delta=True)
            err = float((delta - ref_delta).abs().max())
            n_diff = check_draws(out, ref, delta, seed, TB, NC)
            del out, ref, ref_delta
            start, n = c * B + ti.off + t0 * TB, (t1 - t0) * TB
            mask = ts.cm_resample[c, t0 * TB:t1 * TB]
            world_write_check(fused_color_draw, args, start, mask)
            got = values.clone()
            fused_color_draw(got, *args[1:], write=(start, mask))
            want = values.clone()
            fused_color_draw_plain(want, *args[1:], write=(start, mask))
            require(torch.equal(got[:start], want[:start])
                    and torch.equal(got[start + n:], want[start + n:]),
                    "world-write mode wrote outside its block")
            n_diff_w = check_draws(got[start:start + n],
                                   want[start:start + n], delta, seed, TB,
                                   NC)
            del got, want, delta
            require(err < 1e-5, f"fused delta error {err} past 2^31")
            require(n_diff + n_diff_w <= 2e-4 * n * NC,
                    f"{n_diff} + {n_diff_w} of {n * NC} draws differ")
            cases.append(dict(
                color=c, tiles=[t0, t1], delta_max_abs_err=err,
                draws=n * NC, output_draws_differing=n_diff,
                world_write_draws_differing=n_diff_w,
                max_element_read=(int(nbr.max()) + 1) * NC - 1,
                elements_written=[start * NC, (start + n) * NC - 1]))
    if P * NC > 1 << 31:
        require(any(k["max_element_read"] >= 1 << 31 for k in cases)
                and any(k["elements_written"][1] >= 1 << 31
                        for k in cases),
                "no case read or wrote past world element 2^31")
    return cases


def scale_ising_phase(dev, card: str) -> None:
    """Phase 24: scale_gpu.main at its defaults (the 5120^2 grid at 128
    chains, worlds of 3.4e9 elements): its rate, peak memory and
    memory_budget; fused_color_draw and tally_counts launched on its path;
    then, on its placed graph and last worlds, fused_color_draw against
    its plain version on tiles around and past world element 2^31
    (past_2_31_cases), tally_counts exactly equal to its plain version on
    the whole world, and both kernels' ms a launch beside their bounds
    (computed as phase 4 computes them).  Its compile of the grid is the
    grid's host measurement: every tier is filled by both routes
    (FillWatch(both=True)), timed apart and required equal; the native
    compile_graph is scale_gpu's compile_s less the numpy fills and the
    comparisons."""
    import torch

    from sampler_tpu_torch import scale_gpu
    from sampler_tpu_torch.ops.fused import fold_affine, fused_color_draw
    from sampler_tpu_torch.ops.tally import tally_counts

    t24 = time.perf_counter()
    seen = {}

    def inspect(d, info, vals, counts, modes):
        seen["launches"] = {"fused_color_draw": fused_color_draw.launches,
                            "tally_counts": tally_counts.launches}
        ts, ti = d.tiers[0], info.tiers[0]
        require(len(info.tiers) == 1 and ti.affine2 and ti.band_k == 1,
                f"scale grid tiers {info.tiers}")
        C, D, TB, W = info.n_colors, ti.degree, ti.band_tb, ti.band_w
        nt = ti.block // TB
        NC = vals.shape[1]
        seed = torch.tensor([12345, -67890], dtype=torch.int32,
                            device=vals.device)
        seen["past_2_31"] = past_2_31_cases(d, info, vals, seed)
        seen["tally_whole_world"] = tally_case(vals, info.max_card)
        beta, base = fold_affine(ts, ti, C, d.w_init)
        starts0, f_nbr = ts.bd_start[0], ts.bd_nbr[0, :nt]
        f_bytes = (rows_read(f_nbr.reshape(nt, D, TB), starts0, W) * NC
                   + 2 * f_nbr.numel() * 4 + nt * TB * 4 + nt * 4 + 8
                   + nt * TB * NC)
        f_ops = nt * TB * NC * (2 * D + 4 + 24)
        fargs = (vals, ts.bd_nbr, starts0, beta, base, 0, seed, W, TB, D)
        seen["fused_color_draw"] = dict(
            ms=time_ms(lambda: fused_color_draw(*fargs), iters=10),
            **kernel_bound(f_bytes, f_ops))
        seen["tally_counts"] = tally_numbers(vals, info.max_card)
        for k in ("fused_color_draw", "tally_counts"):
            seen[k]["bound_share"] = seen[k]["bound_ms"] / seen[k]["ms"]

    fused_color_draw.launches = 0
    tally_counts.launches = 0
    with FillWatch(both=True) as watch:
        out = scale_gpu.main(SCALE_ARGS + ["--device", str(dev)],
                             inspect=inspect)
    require(all(n > 0 for n in seen["launches"].values()),
            f"scale_gpu: launches {seen['launches']}")
    host = dict(generate_s=out["gen_s"],
                native_compile_graph_s=out["compile_s"]
                - watch.seconds["numpy"] - watch.checking_s,
                stream_fill_s=watch.seconds, checking_s=watch.checking_s,
                stream_bytes_equal=watch.bytes_equal)
    report("24 scale ising", t24, card=card, scale_gpu=out, host=host,
           world_elements_over_2_31=out["world_elements"] / (1 << 31),
           launches=seen["launches"], past_2_31=seen["past_2_31"],
           tally_whole_world=seen["tally_whole_world"],
           kernels={k: seen[k] for k in ("fused_color_draw",
                                         "tally_counts")})


def scale_kbc_phase(dev, card: str) -> None:
    """Phase 25: scale_kbc.main with KBC_SCALE_ARGS (the KBC graph at 1024
    chains, cut to 2e6 variables): its rate, peak memory beside the bytes
    of the worlds and the device graph, tally_counts launched on its path,
    dm_gather_draw once a color a sweep, and a sweep by part on the kernel
    and the eager route (kbc_sweep_parts)."""
    from sampler_tpu_torch import scale_kbc
    from sampler_tpu_torch.ops.fused import dm_gather_draw
    from sampler_tpu_torch.ops.tally import tally_counts

    t25 = time.perf_counter()
    seen = {}

    def inspect(d, info, vals, modes, gen):
        seen["tally_counts_launches"] = tally_counts.launches
        seen["dm_gather_draw_launches"] = dm_gather_draw.launches
        seen["dm_gather_draw_a_sweep"] = dm_launches_a_sweep(info)
        seen["sweep_breakdown"] = kbc_sweep_parts(d, vals, info, modes, gen)

    tally_counts.launches = 0
    dm_gather_draw.launches = 0
    out = scale_kbc.main(KBC_SCALE_ARGS + ["--device", str(dev)],
                         inspect=inspect)
    require(seen["tally_counts_launches"] > 0,
            "scale_kbc launched no tally_counts")
    want = seen["dm_gather_draw_a_sweep"] * (scale_kbc.WARM_SWEEPS
                                             + out["sweeps"])
    require(seen["dm_gather_draw_launches"] == want > 0,
            f"scale_kbc: dm_gather_draw launches "
            f"{seen['dm_gather_draw_launches']}, {want} expected")
    report("25 scale kbc", t25, card=card, scale_kbc=out, **seen)


def scale_demo_phase(dev, card: str) -> None:
    """Phase 26: scale_demo.main on DEMO_RANKS graph ranks sharing the
    card over Gloo: the marginals' shape and finiteness, the halo plan
    engaged (fewer slices shifted than an all-gather), every rank's
    launches of fused_color_draw and tally_counts, memory_budget and
    sharded_bytes_per_var."""
    import math

    from sampler_tpu_torch import scale_demo
    from sampler_tpu_torch.parallel.comm import make_mesh
    from sampler_tpu_torch.parallel.launch import Ranks

    t26 = time.perf_counter()
    with Ranks(make_mesh(1, DEMO_RANKS, [str(dev)] * DEMO_RANKS,
                         "gloo")) as ranks:
        out = scale_demo.main(DEMO_ARGS + ["--device", str(dev)],
                              mesh=ranks)
        launches = rank_launches(ranks, ("fused_color_draw",
                                         "tally_counts"))
    m = out["marginals"]
    require(m["shape"] == [out["n_vars"], 2] and math.isfinite(m["entropy"])
            and 0 < m["mean_p1"] < 1, f"scale_demo marginals {m}")
    require(out["halo"] is not None
            and sum(out["halo"]) < out["mesh"]["graph"] - 1,
            f"scale_demo: the halo plan did not engage ({out['halo']})")
    report("26 scale demo", t26, card=card, arrangement=GS_ARRANGEMENT,
           scale_demo=out, launches_by_rank=launches)


def main() -> int:
    import torch

    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda")
    report("0 device", t0, card=card, torch=torch.__version__,
           cuda=torch.version.cuda, device_name=torch.cuda.get_device_name(0),
           count=torch.cuda.device_count())

    from sampler_tpu_torch import oracle
    from sampler_tpu_torch import format_spec as fs
    from sampler_tpu_torch.benchgraphs import big_ising_grid
    from sampler_tpu_torch.compile import compile_graph, to_device
    from sampler_tpu_torch.engine.multichain import (infer_mc,
                                                     init_values_mc,
                                                     prepare_fold,
                                                     resolve_modes)
    from sampler_tpu_torch.ops import _build
    from sampler_tpu_torch.ops.banded import (banded_gather,
                                              banded_gather_plain)
    from sampler_tpu_torch.ops.fused import (fold_affine, fused_color_draw,
                                             fused_color_draw_plain)
    from sampler_tpu_torch.ops.tally import tally_counts

    # ---- 1: build ---------------------------------------------------------
    t1 = time.perf_counter()
    _, build_s, ptxas = _build.build()
    for line in ptxas_summary(ptxas):
        print(f"  {line}", flush=True)
    report("1 build", t1, nvcc_seconds=round(build_s, 3),
           library=_build.library_path(), ptxas_lines=len(ptxas))

    # ---- 2: kernels against their plain versions, flagship shapes ---------
    t2 = time.perf_counter()
    g, colors = big_ising_grid(GRID, GRID)
    tc = time.perf_counter()
    dg, info = compile_graph(g, colors=colors)
    compile_s = time.perf_counter() - tc
    ti = info.tiers[0]
    require(len(info.tiers) == 1 and ti.affine2 and ti.band_k == 1,
            f"flagship tiers {info.tiers}")
    d = to_device(dg, dev)
    ts = d.tiers[0]
    C, B, D, TB, W = info.n_colors, ti.block, ti.degree, ti.band_tb, ti.band_w
    A1 = ti.arity - 1
    nt = B // TB
    P = d.var_card.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    values = torch.randint(0, 2, (P, CHAINS), generator=gen, device=dev,
                           dtype=torch.int8)
    beta, base = fold_affine(ts, ti, C, d.w_init)

    seed = torch.tensor([12345, -67890], dtype=torch.int32, device=dev)
    # the flagship's world (the 16-byte variants), then 48 chains (16-byte
    # variants at a width not the flagship's) and 37 (the byte variants)
    cases = [ising_case(d, info, values, seed)]
    for nc in (48, 37):
        vals = torch.randint(0, 2, (P, nc), generator=gen, device=dev,
                             dtype=torch.int8)
        cases.append(ising_case(d, info, vals, seed))
        del vals
    # a tier of degree past the unrolled D = 1..8 (the generic variant)
    gw, colors_w = wide_grid(WIDE_GRID, WIDE_GRID, WIDE_COPIES)
    dgw, infow = compile_graph(gw, colors=colors_w)
    tiw = infow.tiers[0]
    require(len(infow.tiers) == 1 and tiw.affine2 and tiw.band_k == 1
            and tiw.degree > 8, f"wide grid tiers {infow.tiers}")
    dw = to_device(dgw, dev)
    for nc in (CHAINS, 37):
        vals = torch.randint(0, 2, (dw.var_card.shape[0], nc), generator=gen,
                             device=dev, dtype=torch.int8)
        cases.append(ising_case(dw, infow, vals, seed))
        del vals
    del dw, dgw
    fused_err = max(k["fused_delta_max_abs_err"] for k in cases)
    report("2 kernels", t2, compile_graph_s=round(compile_s, 3), P=P,
           ntiles=nt, TB=TB, D=D, W=W, NC=CHAINS, R=TB * D * A1,
           banded_gather="exact", fused_delta_max_abs_err=fused_err,
           cases=cases)

    # ---- 3: oracle parity on the card --------------------------------------
    t3 = time.perf_counter()
    gs, colors_s = big_ising_grid(16, 16, w_pair=0.35, w_bias=0.2)
    rng_q = torch.Generator().manual_seed(1)
    query = torch.randperm(gs.n_vars, generator=rng_q)[:12].numpy()
    gs.var_role[:] = fs.ROLE_EVIDENCE
    gs.var_role[query] = fs.ROLE_QUERY
    gs.var_init[:] = torch.randint(0, 2, (gs.n_vars,),
                                   generator=rng_q).numpy()
    dgs, infos = compile_graph(gs, colors=colors_s, band_tile=8,
                               band_min_block=1)
    require(infos.affine2, "small grid must take the fused path")
    exact = oracle.exact_marginals(gs, clamp_evidence=True)
    ds = to_device(dgs, dev)
    errs = {}
    for label, modes, counter in (("fused", ("cuda", "cuda"),
                                   fused_color_draw),
                                  ("unfused", ("cuda", "off"),
                                   banded_gather)):
        counter.launches = 0
        marg, _ = infer_mc(ds, ds.w_init,
                           torch.Generator(device=dev).manual_seed(3), 200,
                           2000, infos, CHAINS, modes=modes, device=dev)
        errs[label] = float(abs(marg[query, :2] - exact[query]).max())
        require(errs[label] < 0.01, f"{label} |dp| = {errs[label]}")
        require(counter.launches > 0, f"{label} path launched no kernel")
    report("3 oracle", t3, max_abs_dp=errs, n_query=len(query),
           chains=CHAINS, sweeps=2000)

    # ---- 4: flagship --------------------------------------------------------
    t4 = time.perf_counter()
    nbr0 = ts.cs_nbr[:B * D * A1].view(nt, TB * D * A1)
    starts0 = ts.bd_start[0]
    fargs = (values, ts.bd_nbr, ts.bd_start[0], beta, base, 0, seed, W, TB,
             D)
    kern = {
        "fused_color_draw": dict(
            ms=time_ms(lambda: fused_color_draw(*fargs), iters=50),
            plain_ms=time_ms(lambda: fused_color_draw_plain(*fargs),
                             iters=3, warmup=1),
            library_ms=None),
        "banded_gather": dict(
            ms=time_ms(lambda: banded_gather(values, nbr0, starts0, W),
                       iters=50),
            plain_ms=time_ms(lambda: banded_gather_plain(values, nbr0,
                                                         starts0, W),
                             iters=5, warmup=1),
            library_ms=time_ms(lambda: values.index_select(
                0, nbr0.reshape(-1)), iters=50)),
    }
    # bounds: each input byte read once, each output byte written once
    f_nbr = ts.bd_nbr[0, :nt]
    f_bytes = (rows_read(f_nbr.reshape(nt, D, TB), starts0, W) * CHAINS
               + 2 * f_nbr.numel() * 4 + nt * TB * 4 + nt * 4 + 8
               + nt * TB * CHAINS)
    # per (row, chain): D multiply-adds, a sigmoid (4), the hash and the
    # uniform (about 24 integer operations), counted at the f32 rate
    f_ops = nt * TB * CHAINS * (2 * D + 4 + 24)
    g_bytes = (rows_read(nbr0, starts0, W) * CHAINS + nbr0.numel() * 4
               + nt * 4 + nbr0.numel() * CHAINS)
    kern["fused_color_draw"].update(kernel_bound(f_bytes, f_ops))
    kern["banded_gather"].update(kernel_bound(g_bytes, 0))
    for name, k in kern.items():
        k.update(achieved_TB_s=k["bytes"] / k["ms"] * 1e-9,
                 byte_a_thread_ms=BYTE_A_THREAD_MS[name])
    # what the draw's instructions alone take: its flagship variant's SASS
    # (16 chains a thread, D unrolled), all issued at 4 warp instructions
    # a clock an SM at the card's maximum SM clock
    sass = sass_instructions(_build.library_path(),
                             f"fused_color_draw_kernelILi16ELi{D}E")
    if sass is not None:
        kern["fused_color_draw"].update(
            sass_instructions_a_thread=sass,
            issue_bound_ms=issue_bound(dev, sass,
                                       nt * TB * CHAINS)["issue_bound_ms"])
    # the draw's world-write mode (the main path's) against the output
    # route and the masked block write, bit for bit
    world_write = world_write_cases(
        fused_color_draw,
        lambda c: (values, ts.bd_nbr, ts.bd_start[c], beta, base, c, seed, W,
                   TB, D), d, info)
    # the tally kernel on the flagship's world: its numbers, and exactly
    # its plain version's counts
    kern["tally_counts"] = tally_numbers(values, 2)
    tally_checks = {"ising_flagship": tally_case(values, 2)}
    del values, fargs

    runs = {}
    for label, modes in (("fused", None), ("unfused", ("cuda", "off"))):
        fused_color_draw.launches = 0
        banded_gather.launches = 0
        tally_counts.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tr = time.perf_counter()
        marg, vals = infer_mc(d, d.w_init,
                              torch.Generator(device=dev).manual_seed(7),
                              BURN, SWEEPS, info, CHAINS, modes=modes,
                              device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tr
        launches = {"fused_color_draw": fused_color_draw.launches,
                    "banded_gather": banded_gather.launches,
                    "tally_counts": tally_counts.launches}
        require(marg.shape == (g.n_vars, 2), f"marginals {marg.shape}")
        require(bool((marg >= 0).all() and (marg <= 1).all()),
                "marginals outside [0, 1]")
        require(float(abs(marg.sum(1) - 1).max()) < 1e-5,
                "marginal rows do not sum to 1")
        require(bool(((vals == 0) | (vals == 1)).all()), "non-boolean world")
        runs[label] = dict(
            wall_s=wall,
            variable_updates_per_s=g.n_vars * CHAINS * (BURN + SWEEPS)
            / wall,
            peak_memory_bytes=torch.cuda.max_memory_allocated(),
            launches=launches, mean_p1=float(marg[:, 1].mean()))
        del vals
    require(runs["fused"]["launches"]["fused_color_draw"]
            == C * (BURN + SWEEPS), "fused path: fused_color_draw launches")
    require(runs["unfused"]["launches"]["banded_gather"]
            == C * (BURN + SWEEPS), "unfused path: banded_gather launches")
    require(all(r["launches"]["tally_counts"] == SWEEPS
                for r in runs.values()), "tally_counts launches")
    dp = abs(runs["fused"]["mean_p1"] - runs["unfused"]["mean_p1"])
    require(dp < 0.01, f"fused and unfused mean marginals differ by {dp}")
    # where a counted fused sweep's time goes (CUDA events; after the
    # counted runs): the draws write into the world, so the sweep is the
    # draws and what is left; then the tally
    modes = resolve_modes(info, dev)
    folded = prepare_fold(d, d.w_init, info, modes)
    gen_b = torch.Generator(device=dev).manual_seed(9)
    world = init_values_mc(d, gen_b, CHAINS, info)
    breakdown = sweep_breakdown(
        d, world, info, folded, modes, gen_b,
        {"fused_color_draw_x2": 2 * kern["fused_color_draw"]["ms"]})
    del world, d, ds, folded
    kern["fused_color_draw"].update(
        launches=runs["fused"]["launches"]["fused_color_draw"],
        max_abs_err=fused_err)
    kern["banded_gather"].update(
        launches=runs["unfused"]["launches"]["banded_gather"],
        max_abs_err=max(k["banded_gather_max_abs_err"] for k in cases))
    kern["tally_counts"].update(
        launches=runs["fused"]["launches"]["tally_counts"],
        max_abs_err=max(x["max_abs_err"] for x in tally_checks.values()))
    report("4 flagship", t4, card=card, grid=f"{GRID}x{GRID}", chains=CHAINS,
           burn=BURN, sweeps=SWEEPS, runs=runs,
           kernels={k: v for k, v in kern.items() if k != "tally_counts"},
           fused_world_write=world_write, fused_sweep_breakdown=breakdown)

    # ---- 5, 6: the learning flagship --------------------------------------
    g, d, info, kern["grad_pair_tile"] = grad_phase(dev)
    learn_launches = learn_phase(dev, g, d, info)
    kern["grad_pair_tile"]["launches"] = learn_launches["grad_pair_tile"]
    del d

    # ---- 7, 8, 9: the arity-3 / multi-window class -----------------------
    g, d, info, dm_kern = dm_kernels_phase(dev)
    kern.update(dm_kern)
    oracle_dm_phase(dev)
    learn_graphs = {}
    tally_checks["triple_flagship"], learn_graphs["triple"] = triple_phase(
        dev, card, g, d, info, kern)
    del d

    # ---- 10, 11, 12: the categorical class ------------------------------
    g, d, info, kern["fused_cat_draw"] = cat_kernel_phase(dev)
    oracle_cat_phase(dev)
    tally_checks["potts_flagship"], learn_graphs["potts"] = potts_phase(
        dev, card, g, d, info, kern["fused_cat_draw"])
    del d

    # ---- 13: the tally kernel ---------------------------------------------
    tally_phase(dev, tally_checks)

    # ---- 14, 15, 16: the KBC class (the hub tier) --------------------------
    kbc_oracle_phase(dev)
    g_kbc, kbc_rate, kbc_order, d_kbc, info_kbc, dm_launches = kbc_phase(
        dev, card)
    kern["dm_gather_draw"] = dm_gather_phase(dev, card, d_kbc, info_kbc)
    kern["dm_gather_draw"]["launches"] = dm_launches
    del d_kbc
    d_kbc, info_l, grad_records_launches = kbc_learn_phase(dev, card)
    learn_graphs = {"kbc": (d_kbc, info_l, LEARN_CHAINS), **learn_graphs}
    del d_kbc
    kern["grad_records_sum"] = grad_records_phase(dev, card, learn_graphs)
    kern["grad_records_sum"]["launches"] = grad_records_launches
    del learn_graphs

    # ---- 17, 18, 19: the gibbs command on the card -----------------------
    cli_kbc_phase(dev, card, g_kbc, kbc_rate, dm_launches_a_sweep(info_kbc),
                  grad_launches_an_epoch(info_kbc, dev))
    cli_oracle_phase(dev)
    cli_resume_phase(dev)

    # ---- 20, 21, 22: chain and graph sharding, ranks sharing the card ----
    from sampler_tpu_torch.parallel.comm import make_mesh
    from sampler_tpu_torch.parallel.launch import Ranks

    gs_ising_phase(dev, card)
    with Ranks(make_mesh(1, 2, [str(dev)] * 2, "gloo")) as pair:
        gs_kbc_phase(dev, card, g_kbc, kbc_order, pair)
        del g_kbc
        gs_cli_phase(dev, card, pair)

    # ---- 23-26: the native host library and the large-graph entry points
    host_phase(card)
    scale_ising_phase(dev, card)
    scale_kbc_phase(dev, card)
    scale_demo_phase(dev, card)

    sources = {"fused_color_draw": ("sampler_tpu_torch/csrc/"
                                    "fused_color_draw.cu",
                                    "sampler_tpu/ops/fused.py:365"),
               "banded_gather": ("sampler_tpu_torch/csrc/banded_gather.cu",
                                 "sampler_tpu/ops/banded.py:261"),
               "grad_pair_tile": ("sampler_tpu_torch/csrc/grad_pair_tile.cu",
                                  "sampler_tpu/ops/grad.py:42"),
               "fused_dm_draw": ("sampler_tpu_torch/csrc/fused_dm_draw.cu",
                                 "sampler_tpu/ops/fused.py:649"),
               "banded_gather_multi": ("sampler_tpu_torch/csrc/"
                                       "banded_gather_multi.cu",
                                       "sampler_tpu/ops/banded.py:329"),
               "fused_cat_draw": ("sampler_tpu_torch/csrc/fused_cat_draw.cu",
                                  "sampler_tpu/ops/fused.py:506"),
               # no Pallas kernel: the tallies XLA fuses into the jitted
               # sweep loop of _run_inference_mc
               "tally_counts": ("sampler_tpu_torch/csrc/tally_counts.cu",
                                "sampler_tpu/engine/multichain.py:676"),
               # no Pallas kernel: color_delta_multilin and the Bernoulli
               # draw, which XLA fuses into the jitted sweep
               "dm_gather_draw": ("sampler_tpu_torch/csrc/dm_gather_draw.cu",
                                  "sampler_tpu/engine/multichain.py:405"),
               # no Pallas kernel: the row-chunk body of
               # mc_weight_gradient_cs, which XLA fuses into the jitted
               # learning epoch; its ms a gradient's 3 launches (the
               # per-tier grad_records before it: a launch a tier)
               "grad_records_sum": ("sampler_tpu_torch/csrc/"
                                    "grad_records.cu",
                                    "sampler_tpu/engine/multichain.py:1002")}
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
         "bound_by": k["bound_by"], "library_ms": k["library_ms"]}
        for name, k in kern.items()]}
    print(json.dumps(line), flush=True)
    print(f"total {time.perf_counter() - t0:.1f}s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
