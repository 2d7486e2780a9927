"""Smoke run of the PyTorch port (lp_mp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA grid kernels from lp_mp_tpu_torch/csrc with nvcc and holds
each kernel against its plain torch version on the card: the dense phase and
round kernels, the phase kernel under the v1 contract, and the sharded phase
and round kernels on every shard at 1-4 shards (the phase kernels also at
more labels than the round kernels take), the rounding kernels (the four
label-writing phases of each mode and the cost pass: state bit-equal, labels
equal, cost within 1e-12), and every kernel replayed from a CUDA graph, the
phase kernels in every phase tuple.  Then drives the main paths,
each with the launch counters set to 0 just before and read just after: the
1000x1000, L=4 Potts grid through GridPottsModel.run_fast(kernel="cuda"),
lower_bound and round_primal; the same grid through
ShardedGridPotts.run_fast at 1 and 4 shards on the one card, held against
the dense path; and the uniform schedule through the v1 contract.  Checks
the bounds against the JAX package's, times each path and kernel against its
plain or dense counterpart and against its bound (the bytes a launch must
move at 3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever is
longer; a phase that nothing receives in reads no cost), reads each
kernel's device time inside run_fast(20) under torch.profiler, and prints
one line per phase.  The timings of lp_mp_tpu_torch/phase_bench.py follow
(which also holds the timing helpers and bounds used here): the dense, v1
and sharded phase kernels (1 shard and one window of 4) in every phase
tuple by graph replay with their bounds, the dense one also at 8 labels
and at an odd width, and the captured run_fast(20) in it/s for the
anisotropic, uniform and damped_uniform modes, dense and at 1 and 4
shards; the rounding kernels per launch and one rounding pass against the
plain ops; the captured dense run_fast(20) must end without copying its
state.

Then the generic engine path, plain PyTorch on the card in float32: a chain
of 100000 variables with 8 labels built through MrfConstructor's batch
constructors and Engine(schedule_mode="auto"), whose bound must rise
monotonically to within 1e-4 relative of the exact optimum (a min-plus
reduction on the host) in at most 200 passes; the same chain through
Solver + StandardVisitor, whose primal must be feasible and above the bound;
and the 1000x1000 grid through the engine, whose bound after 100 anisotropic
passes must lie within 1e-5 relative of GridPottsModel's kernel path.  It
times the engine's passes, their host enqueue time, the device idle share of
one pass and the engine build, and needs the native host library
(csrc/lpmp_host.cpp, built with g++) for the schedule at this size.

Then tightening, plain PyTorch on the card in float32: the 200x250
multicut grid with diagonals of bench.py (149101 edges) gets one cycle
separation round on a fresh engine, timed as pull (engine block to the
host), search (BFS) and add (triplets into the graph), which must add the
same 500 triplets the JAX package adds; after a rebuild, 100 anisotropic
passes must reach the JAX package's bound within 1e-4 relative, and GAEC
must give its upper bound.  Three Solver runs with StandardTighteningVisitor
follow: the 24x24 frustrated MRF grid (triplets absorbed by the aux pass or
rebuilt into the engine) to gap 1e-4 at the JAX package's bound, the 40x40
multicut grid to gap 1e-2, and the frustrated 4-cycle to lb 1.0.  The
JAX package's values are constants below, taken on the CPU in float32.

Then graph matching and tomography, plain PyTorch on the card in float32:
tomography_10x32 and qap_16x16 of bench.py's solver_e2e through Solver,
against the JAX package's float32 CPU bounds and gaps (constants below,
recomputed by tests/test_torch_model_constants.py); then the timed bench.py
sizes, qap_32x32_3000quadratic (engine it/s, host enqueue, idle share, and
the rounding split into min-cost flow, 2-opt polish and greedy start) and
tomography_100chains_64vars_counting (it/s, host enqueue, idle share).

Then the sharded generic engine, the tree decompositions and the tree
switch of Solver, plain PyTorch on the card in float32.  sharded_engine:
ShardedEngine at 1 and 4 shards on cuda:0 over the 1000x1000 grid of the
engine path, and at 4 shards over the multicut with its 500 triplets, each
within 1e-5 (1 + max|x|) in state and 1e-6 (multicut: 1e-5) in bound of a
fresh unsharded Engine after 20 anisotropic passes, and one rounding pass
that must give a consistent primal above the bound; it prints build
seconds, ms per pass in turns with the unsharded engine, host enqueue, the
idle share and the cut rows and bytes of one consensus.  trees: the chain
cover of bench/sharded_measurements.py's 304x304 MRF (cover seconds, T, V
and digest against the JAX package's), subgradient_ascent(50) within 1e-4
of the JAX package's float32 bound and fw_map(5, 10) reaching its bound
less 1e-4 (the port sums FW-MAP's line search in float64, the JAX package
in float32), the majority-vote labels above both bounds, the write-back into an Engine
keeping the bound, and the seconds, host enqueue and idle share of one
solve.  tree_solver: Solver(StandardVisitor(max_iter=30),
tree_decomposition_begin=10) over the cover as trees, its bound within
1e-4 of the JAX package's and the engine's bound after the write-back
keeping it.

Then the exact oracles, checkpoints and the command line, on the card in
float32 with the oracles themselves on the host.  checkpoint: the
1000x1000 engine grid (2998000 factors) saved to an npz in a temporary
directory, 5 more passes, loaded: the bound and every state tensor equal to
the saved ones bit for bit and the saved primal's cost kept; then snapshot,
one pass, restore: the bound back exactly; it prints the file's MB, save
and load seconds and snapshot and restore ms.  oracles: mrf_grid24
(untightened) after Solver(StandardVisitor(max_iter=50)): its local
polytope (9800 variables, 11386 rows), the LP value at least the bound and
within 1e-5 relative of the JAX package's (no reparametrization changes
it), ilp_round(time_limit=60) within 1e-5 of the JAX package's optimum
(the round-5 anchor), combi_lp within 1e-5 of the ILP, and
Solver(exact_rounding="ilp", exact_time_limit=30) reaching the ILP's cost
with lb <= ub, each step timed.  cli: mrf_grid24 as UAI text, qap_16x16 in
the Torresani format and the multicut_grid40 edges as "i j w" lines go
through python -m lp_mp_tpu_torch on the default device: the mrf and gm
lower bounds within 1e-4 relative of the JAX package's cli.main on the same
text, the mrf labels' cost on the host equal to the printed ub within
1e-4, and the tightened multicut run's sqlite table holding one row per
visited iteration, its last lowerBound the printed lb.

Every phase runs on the default captured path (use_jit=True: CUDA graphs,
lp_mp_tpu_torch/capture.py).  The kernel checks end with each kernel
replayed from a CUDA graph against its plain version; the launch counts of
the main paths are the schedule's graph replays plus one warm-up run per
captured graph.  Last, jit: runs every captured path (the chain, the engine
grid, the multicut with its triplets, qap_32x32, tomography_100x64, the
4-shard sharded engine on the grid and the multicut, the 304x304 tree
solve, ShardedGridPotts.run_fast(20) at 1 and 4 shards and
GridPottsModel.run_fast(20) with both kernels) with use_jit=False and True
in turns: ms per call, host enqueue, idle share, kernels, graphs, capture
seconds and pool MB, and the captured state within 1e-5 (1 + max|x|) and
its bound within 1e-6 relative (multicut 1e-5) of the eager one after 10
calls.

Then pull: the structured pull pass, Engine(pull=True) beside
Engine(pull=False) on the captured path, on bench.py's generic grid
(1000x1000, L=4, pairs horizontal then vertical: every slot strided), the
engine grid above (pairs in per-cell order: every slot gathers), the 100k
chain, qap_32x32_3000quadratic and the multicut with its 500 triplets:
slots, strided slots and fallback lanes of the plans and their build
seconds; where every slot is strided, two fresh pull engines bit-equal
after 10 passes; after 20 passes the pull bound within 1e-5 relative of
the scatter bound and the state within 1e-5 (1 + max|x|), no grid-kernel
launch; ms per pass captured (CUDA events, median of 3 in turns) and
eager, host enqueue, kernels per pass and pool MB.  The counting messages
of tomography_100chains_64vars_counting have no pull hooks: pull=True must
raise, pull="auto" runs the scatter pass.

The last lines are JSON records of the engine path, of tightening, of the
two models, of the sharded engine, the trees and the tree Solver, of the
checkpoint, the oracles, the command line, the jit and the pull phases, of
the phase kernels' timings, a JSON record of the kernels, and {"ok": true, "device": {...}}.  Any failure
raises and exits non-zero; without a CUDA device it exits non-zero at
once.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import sqlite3
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lp_mp_tpu_torch import (ChainDecomposition, Direction, DiscreteTomographyConstructor, Engine,
                             FactorGraph, GraphMatchingConstructor, GraphMatchingInput,
                             GridPottsModel, MrfConstructor, MulticutConstructor, ShardedEngine,
                             ShardedGridPotts, Solver, StandardTighteningVisitor, StandardVisitor,
                             TreeSpec, build_local_polytope, combi_lp, ilp_round, load_checkpoint,
                             native, random_grid, restore, save_checkpoint, snapshot,
                             solve_lp_relaxation)
from lp_mp_tpu_torch.capture import flatten
from lp_mp_tpu_torch.convert import host_array
from lp_mp_tpu_torch import phase_bench
from lp_mp_tpu_torch.phase_bench import (HBM_BYTES_PER_S, in_turns, launch_bound, nbytes,
                                         phase_bytes)
from lp_mp_tpu_torch.engine_pull import pull_stats
import lp_mp_tpu_torch
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, COST_RTOL, PHASE_PARAMS,
                                          ROUND_GEOMETRIES, RTOL, WIDE_LABEL_SHAPES,
                                          check_grid_kernels, check_phase_v1, check_replays,
                                          check_round_primal, check_sharded_grid_kernels)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops.grid_kernels import (launch_counts, phase_update, phase_update_ref,
                                              phase_update_sharded, phase_update_sharded_ref,
                                              phase_update_v1, reset_launch_counts,
                                              round_tile, round_update, round_update_ref,
                                              round_update_sharded, round_update_sharded_ref)
from lp_mp_tpu_torch.trees import chain_tree_messages
from lp_mp_tpu_torch.utils.mincostflow import solve_assignment

H, W, L, SEED = 1000, 1000, 4, 1
CHUNKS, CHUNK_ITERS = 15, 100
# lower bound the JAX package reaches after 15 x run_fast(100, kernel="pallas")
# on random_grid(1000, 1000, 4, seed=1): BENCH_r05.json, grid entry, target_lb
JAX_TARGET_LB = -306284.281
# the rounding against the JAX package: its GridPottsModel.round_primal("damped_uniform")
# in float32 on the CPU after run_fast(ROUND_ITERS, "damped_uniform", kernel="xla") on
# random_grid(*ROUND_GRID) (tests/test_torch_model_constants.py recomputes it): the
# labels' digest and the cost, which the JAX package sums in float32 and the port in float64
ROUND_GRID, ROUND_ITERS = (64, 80, 4, 3), 5
JAX_ROUND = {"digest": "25004eb34fc50125", "ub": -1143.324951171875}
ROUND_UB_RTOL = 1e-5
SOURCE = "lp_mp_tpu_torch/csrc/grid_potts.cu"
SHARD_RUNS = (1, 4)            # shards of the sharded main path, all on cuda:0
REPLACES = {"round_update": "lp_mp_tpu/ops/pallas_grid.py:303",
            "phase_update": "lp_mp_tpu/ops/pallas_grid.py:161",
            "round_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:536",
            "phase_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:443",
            "phase_update_v1": "lp_mp_tpu/ops/pallas_grid.py:72",
            "round_phase_update": "none (jnp ops, lp_mp_tpu/models/grid_potts.py:297-317)",
            "primal_cost": "none (jnp ops, lp_mp_tpu/models/grid_potts.py:310-317)"}
# launches of one GridPottsModel.round_primal on a float32 model on the card
ROUND_LAUNCHES = {"round_phase_update": 4, "primal_cost": 2}
# the generic engine path: bench.py's chain (bench.py:334-394) and its exact
# optimum as BASELINE_MEASURED.json records it
CHAIN_N, CHAIN_L, CHAIN_SEED = 100_000, 8, 2
CHAIN_OPT = -229782.13510709113
CHAIN_CHUNK, CHAIN_MAX_PASSES, CHAIN_GAP = 5, 200, 1e-4
ENGINE_GRID_PASSES = 100
# tightening: what the JAX package gives on the same instances and calls, on
# the CPU in float32 (lp_mp_tpu, JAX_PLATFORMS=cpu, config.set_dtype("float32"),
# Engine/Solver with schedule_mode="auto", pass_style="auto")
MC150K_PASSES = 100
JAX_MC150K = {"triplets_added": 500, "n_triplets": 567, "n_edges": 149135,
              "digest": "1457fd730514e979",       # triplet_digest of the triplets added
              "lb": -24465.54296875, "gaec_ub": -6385.433191934672}
JAX_GRID24 = {"lb": -133.89813232421875, "ub": -133.89813232421875, "builds": 4,
              "n_triplets": 328}
JAX_GRID40 = {"lb": -577.2794189453125, "ub": -571.923828125, "builds": 18,
              "n_triplets": 21077}
# graph matching and tomography: Solver(StandardVisitor(max_iter=60),
# schedule_mode="auto") on bench.py's solver_e2e instances, and the timed
# bench.py sizes; the JAX package's values on the CPU in float32 as above
# (tests/test_torch_model_constants.py recomputes them)
MODEL_ITERS = 60
JAX_TOMO10X32 = {"lb": -306.734375, "ub": -306.73443603515625, "schedule_mode": "coloring"}
JAX_QAP16 = {"lb": -26.722871780395508, "ub": -25.933637619018555,
             "rel_gap": 0.030432836803355522, "schedule_mode": "wavefront",
             "matching": [10, 11, 0, 14, 9, 1, 2, 3, 15, 6, 8, 5, 12, 4, 7, 13]}
MODEL_TIME_REPS = 3
# sharded generic engine: passes before each comparison with the unsharded engine
SHARDED_PASSES = 20
# trees: mrf_304x304 of bench/sharded_measurements.py through the chain cover,
# subgradient_ascent(n_iter=50) and fw_map(n_outer=5, n_inner=10), and through
# Solver(StandardVisitor(max_iter=30), schedule_mode="auto",
# tree_decomposition_begin=10); the JAX package's values on the CPU in float32
# (tests/test_torch_model_constants.py recomputes them)
TREE_SIDE, TREE_L = 304, 3
TREE_SOLVER_ITERS, TREE_SOLVER_BEGIN = 30, 10
JAX_TREES = {"T": 9931, "V": 362, "digest": "45939ec95042f5a1", "sg": -11783.125, "fw": -10451.244140625}
JAX_TREE_SOLVER = {"lb": -11848.4375}
# exact oracles: mrf_grid24 (untightened) after Solver(StandardVisitor(max_iter=ORACLE_ITERS)),
# then the local polytope's LP, ilp_round(time_limit=ORACLE_ILP_LIMIT) and combi_lp; and
# Solver(exact_rounding="ilp", exact_time_limit=ORACLE_SOLVER_LIMIT).  The JAX package's values
# on the CPU in float32 (tests/test_torch_model_constants.py recomputes them); the ILP's is
# the round-5 anchor's optimum
ORACLE_ITERS, ORACLE_ILP_LIMIT, ORACLE_SOLVER_LIMIT = 50, 60, 30
JAX_ORACLES = {"lp": -150.4090523654313, "ilp": -133.898193359375, "n_vars": 9800,
               "n_rows": 11386}
# checkpoint: passes run between the save and the load
CHECKPOINT_PASSES = 5
# jit: calls of each path, eager and captured from one state, before their states are compared
JIT_PASSES = 10
# pull: passes of Engine(pull=True) and Engine(pull=False) before they are compared, and of
# two fresh pull engines before their states must be bit-equal (all slots strided)
PULL_PASSES, PULL_RERUN_PASSES = 20, 10
# command line: mrf_grid24 as UAI text, qap_16x16 in the Torresani format and the
# multicut_grid40 edges, through python -m lp_mp_tpu_torch; the JAX package's cli.main on
# the same text on the CPU in float32 (tests/test_torch_model_constants.py recomputes them).
# The gm run is qap_16x16's Solver run through text, so its bound is JAX_QAP16's
CLI_MRF_ITERS, CLI_GM_ITERS, CLI_MC_ITERS = 50, MODEL_ITERS, 30
JAX_CLI = {"mrf_lb": -150.6502685546875, "gm_lb": JAX_QAP16["lb"]}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def max_state_err(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def host_ms(fn, reps: int) -> float:
    """Mean host time to enqueue ``fn`` (no synchronise inside the timed
    loop): where it nears the events' time, the host holds the card back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return t


def state_scale(state) -> float:
    return 1.0 + max(float(t.abs().max()) for t in state.values() if t.numel())


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false: this script runs only "
                 "on a machine with an NVIDIA GPU")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}")
    return name, count, card


def phase_build() -> None:
    build = _cuda_build.build(force=True)
    print(f"build: nvcc {' '.join(_cuda_build.NVCC_FLAGS)} -> {build.path.name} "
          f"in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "ptxas" in line or "spill" in line:
            print(f"build: {line.strip()}")
    _cuda_build.library()


def with_warmups(schedule: dict, records) -> dict:
    """The launches a schedule of graph replays implies, plus the one
    warm-up run of each graph whose capture ``records`` holds (a
    ``capture.Graphs``'s ``records``): a warm-up launches the kernels that
    its capture records."""
    out = dict(schedule)
    for rec in records:
        for k, v in rec.launches.items():
            out[k] += v
    return out


def labels_digest(x) -> str:
    """Short digest of a grid's labels."""
    return hashlib.sha256(np.ascontiguousarray(x, dtype=np.int32).tobytes()).hexdigest()[:16]


def jax_round_case(device) -> tuple:
    """(labels, ub) of a float32 model's round_primal on ``JAX_ROUND``'s case."""
    h, w, labels, seed = ROUND_GRID
    m = GridPottsModel(*random_grid(h, w, labels, seed=seed), device=device,
                       dtype=torch.float32)
    return m.run_fast(ROUND_ITERS, "damped_uniform", kernel="cuda").round_primal("damped_uniform")


def phase_main_path() -> dict:
    """The dense main path.  Returns its launch counts (those of the
    rounding included), its state after the 1500 iterations (before
    rounding), its bound and its rounded primal."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    m = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    prev = m.lower_bound()
    reset_launch_counts()
    for chunk in range(1, CHUNKS + 1):
        m.run_fast(CHUNK_ITERS, kernel="cuda")
        lb = m.lower_bound()
        print(f"main: cuda run_fast({CHUNK_ITERS}) chunk {chunk:2d}: lower bound {lb:.6f}")
        if lb < prev - 1e-4 * abs(prev):
            fail(f"lower bound dropped from {prev} to {lb} in chunk {chunk}")
        prev = lb
    counts = launch_counts()
    per_call = {"phase_update": 1, "round_update": CHUNK_ITERS // 2 + CHUNK_ITERS % 2}
    expect = with_warmups({k: CHUNKS * per_call.get(k, 0) for k in counts}, m.jit.records)
    print(f"main: launches {counts}, schedule implies {expect} ({CHUNKS} replays of the "
          f"captured run_fast({CHUNK_ITERS}) and its warm-up)")
    if counts != expect:
        fail(f"launch counts {counts} differ from the schedule's {expect}")
    lb_cuda = prev
    print(f"main: bound {lb_cuda:.6f}, JAX package {JAX_TARGET_LB}, "
          f"rel diff {rel(lb_cuda, JAX_TARGET_LB):.3e} (limit 1e-4)")
    if not rel(lb_cuda, JAX_TARGET_LB) <= 1e-4:
        fail(f"bound {lb_cuda} is not within 1e-4 relative of {JAX_TARGET_LB}")

    mt = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    for _ in range(CHUNKS):
        mt.run_fast(CHUNK_ITERS, kernel="torch")
    lb_torch = mt.lower_bound()
    err = max_state_err(m.state, mt.state)
    print(f"main: plain path bound {lb_torch:.6f}, rel diff {rel(lb_cuda, lb_torch):.3e} "
          f"(limit 1e-5), max state diff {err:.3e}")
    if not rel(lb_cuda, lb_torch) <= 1e-5:
        fail(f"kernel path bound {lb_cuda} and plain path bound {lb_torch} disagree")

    state = {k: v.clone() for k, v in m.state.items()}
    n_graphs = len(m.jit.records)
    reset_launch_counts()
    x, ub = m.round_primal()
    round_counts = launch_counts()
    expect = with_warmups({k: ROUND_LAUNCHES.get(k, 0) for k in round_counts},
                          m.jit.records[n_graphs:])
    print(f"main: round_primal launches {round_counts}, one replay of the captured rounding "
          f"and its warm-up imply {expect}")
    if round_counts != expect:
        fail(f"round_primal launches {round_counts} differ from the kernels' {expect}")
    _, (x_ref, ub_ref) = m._round_impl({k: v.clone() for k, v in state.items()},
                                       m._mode_params("damped_uniform"))
    same, err = bool((x == x_ref.cpu().numpy()).all()), rel(ub, float(ub_ref))
    print(f"main: round_primal ub {ub:.6f} >= lb {lb_cuda:.6f}, labels {x.shape} "
          f"in [{x.min()}, {x.max()}]; against the plain rounding of the same state: labels "
          f"equal {same}, ub rel diff {err:.1e} (limit {COST_RTOL})")
    if not (x.shape == (H, W) and 0 <= x.min() and x.max() < L and ub >= lb_cuda):
        fail(f"round_primal gave ub {ub} (lb {lb_cuda}) and labels {x.shape}")
    if not (same and err <= COST_RTOL):
        fail(f"round_primal's kernels and the plain rounding disagree (labels equal {same}, "
             f"ub {ub} against {float(ub_ref)})")
    xj, ubj = jax_round_case("cuda")
    digest, err = labels_digest(xj), rel(ubj, JAX_ROUND["ub"])
    print(f"main: round_primal at {'x'.join(map(str, ROUND_GRID[:3]))} after run_fast("
          f"{ROUND_ITERS}): labels digest {digest} (JAX package {JAX_ROUND['digest']}), ub "
          f"{ubj!r} (JAX package {JAX_ROUND['ub']!r}, rel diff {err:.1e}, limit {ROUND_UB_RTOL})")
    if not (digest == JAX_ROUND["digest"] and err <= ROUND_UB_RTOL):
        fail("round_primal disagrees with the JAX package's")

    for mode in ("uniform", "damped_uniform"):
        mk = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32).run_fast(
            10, mode, kernel="cuda")
        mp = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32).run_fast(
            10, mode, kernel="torch")
        a, b = mk.lower_bound(), mp.lower_bound()
        err = max_state_err(mk.state, mp.state)
        print(f"main: {mode} run_fast(10) cuda {a:.6f} vs torch {b:.6f}, rel diff "
              f"{rel(a, b):.3e}, max state diff {err:.3e}")
        if not (rel(a, b) <= 1e-5 and err <= 1e-4 * state_scale(mp.state)):
            fail(f"{mode}: kernel path and plain path disagree")
    counts |= {k: round_counts[k] for k in ROUND_LAUNCHES}
    return {"counts": counts, "state": state, "lb": lb_cuda, "x": x, "ub": ub}


def phase_sharded_path(dense: dict) -> dict:
    """ShardedGridPotts.run_fast on the main grid at each of SHARD_RUNS
    shards (all on cuda:0), held against the dense kernel path.  Returns the
    launch counts summed over the runs."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    total = {}
    for n in SHARD_RUNS:
        sm = ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * n, dtype=torch.float32)
        prev = sm.lower_bound()
        reset_launch_counts()
        for chunk in range(1, CHUNKS + 1):
            sm.run_fast(CHUNK_ITERS)
            lb = sm.lower_bound()
            if lb < prev - 1e-4 * abs(prev):
                fail(f"{n} shards: lower bound dropped from {prev} to {lb} in chunk {chunk}")
            prev = lb
        counts = launch_counts()
        per_call = {"phase_update_sharded": 1,
                    "round_update_sharded": CHUNK_ITERS // 2 + CHUNK_ITERS % 2}
        expect = with_warmups({k: n * CHUNKS * per_call.get(k, 0) for k in counts}, sm.jit.records)
        print(f"sharded: {n} shards (Hl={sm.layout.Hl}): bound after {CHUNKS} x "
              f"run_fast({CHUNK_ITERS}) {prev:.6f}, rel diff to JAX {rel(prev, JAX_TARGET_LB):.3e} "
              f"(limit 1e-4), to the dense kernel path {rel(prev, dense['lb']):.3e}")
        print(f"sharded: {n} shards: launches {counts}, schedule implies {expect}")
        if counts != expect:
            fail(f"{n} shards: launch counts {counts} differ from the schedule's {expect}")
        if not rel(prev, JAX_TARGET_LB) <= 1e-4:
            fail(f"{n} shards: bound {prev} is not within 1e-4 relative of {JAX_TARGET_LB}")
        ds = sm.dense_state()
        err, tol = max_state_err(ds, dense["state"]), RTOL * state_scale(dense["state"])
        print(f"sharded: {n} shards: max state diff to the dense kernel path {err:.3e} "
              f"(limit {tol:.3e})")
        if not err <= tol:
            fail(f"{n} shards: dense_state() differs from the dense kernel path by {err}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

        x, ub = sm.round_primal()
        same = bool((x == dense["x"]).all())
        print(f"sharded: {n} shards: round_primal ub {ub:.6f} (dense {dense['ub']:.6f}) >= "
              f"lb {prev:.6f}, labels equal to the dense path's: {same}")
        if not (same and ub >= prev):
            fail(f"{n} shards: round_primal labels differ from the dense path's or ub < lb")

    n = SHARD_RUNS[-1]
    for mode in ("uniform", "damped_uniform"):
        sm = ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * n,
                              dtype=torch.float32).run_fast(10, mode)
        mk = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32).run_fast(
            10, mode, kernel="cuda")
        err = max_state_err(sm.dense_state(), mk.state)
        print(f"sharded: {mode} run_fast(10) at {n} shards {sm.lower_bound():.6f} vs dense "
              f"cuda {mk.lower_bound():.6f}, max state diff {err:.3e}")
        if not err <= RTOL * state_scale(mk.state):
            fail(f"{mode}: sharded and dense kernel paths disagree")
    return total


def phase_v1_path() -> dict:
    """The uniform schedule (10 iterations) through phase_update_v1's int32
    contract, against the dense kernel path.  Returns its launch counts."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    mk = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    s = mk.state
    reset_launch_counts()
    for _ in range(10):
        for p in ((1, 1, 0), (2, 2, 0), (2, 2, 0), (1, 1, 0)):
            s = phase_update_v1(torch.tensor(p, dtype=torch.int32), s, mk.hc, mk.vc)
    counts = launch_counts()
    mk.run_fast(10, "uniform", kernel="cuda")
    err = max_state_err(s, mk.state)
    print(f"v1: uniform schedule through phase_update_v1: launches {counts}, max state diff "
          f"to the dense kernel path {err:.3e}")
    if counts["phase_update_v1"] != 40 or not err <= RTOL * state_scale(mk.state):
        fail("the v1 path disagrees with the dense kernel path or missed its launches")
    return counts


def kernel_name(name: str) -> str:
    """``grid_round_kernel<2, false>`` from a demangled CUDA kernel name."""
    m = re.search(r"(\w+_kernel)<([^>]*)>", name)
    return f"{m.group(1)}<{m.group(2)}>" if m else name[:60]


def kernel_device_us(fn) -> dict:
    """Device time of each CUDA kernel in one call of ``fn`` under
    torch.profiler: {kernel name: (total us, launches)}."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            tot, cnt = out.get(e.name, (0.0, 0))
            out[e.name] = (tot + e.time_range.elapsed_us(), cnt + 1)
    return out


def phase_time(card: str) -> dict:
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    mk = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    mp = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    n = 20
    t = in_turns({"plain": lambda: mp.run_fast(n, kernel="torch"),
                  "kernel": lambda: mk.run_fast(n, kernel="cuda")}, reps=5)
    its_plain, its_kernel = n / t["plain"] * 1e3, n / t["kernel"] * 1e3
    state_bytes = 4 * L * (H * W + 2 * H * (W - 1) + 2 * (H - 1) * W)
    cost_bytes = 4 * (H * (W - 1) + (H - 1) * W)
    launch_bytes = 2 * state_bytes + cost_bytes     # state read + written, costs read
    per_iter = launch_bytes / 2                     # a round launch covers two rounds
    gbs = per_iter * its_kernel / 1e9
    print(f"time: run_fast({n}) at {H}x{W} L={L}: cuda {its_kernel:.1f} it/s, "
          f"torch {its_plain:.1f} it/s (median of 3, CUDA events) on {card}")
    print(f"time: {per_iter / 1e6:.2f} MB/iteration moved at least -> {gbs:.1f} GB/s, "
          f"{100 * gbs * 1e9 / HBM_BYTES_PER_S:.1f}% of 3.35 TB/s on {card}")

    sharded = {k: ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * k, dtype=torch.float32)
               for k in SHARD_RUNS}
    fns = {"dense": lambda: mk.run_fast(n, kernel="cuda")}
    fns.update({f"{k} shards": (lambda m=m: m.run_fast(n)) for k, m in sharded.items()})
    t = in_turns(fns, reps=5)
    host = {k: host_ms(fn, reps=5) for k, fn in fns.items()}
    print(f"time: run_fast({n}) at {H}x{W} L={L}: " + ", ".join(
        f"{k} {n / v * 1e3:.1f} it/s ({v:.3f} ms, host enqueue {host[k]:.3f} ms)"
        for k, v in t.items()) + f" (median of 3, CUDA events) on {card}")
    for k, fn in fns.items():
        dev = kernel_device_us(fn)
        print(f"time: {k} run_fast({n}) device time by kernel under torch.profiler: " + ", ".join(
            f"{kernel_name(name)} {us:.1f} us / {cnt} = {us / cnt:.1f} us"
            for name, (us, cnt) in sorted(dev.items(), key=lambda kv: -kv[1][0])) + f" on {card}")

    s, hcc, vcc = mk.state, mk.hc, mk.vc
    one = sharded[1]
    w, c, cs = one.windows[0], one.costs[0], one.cost_slabs[0]
    sl = one.layout.slabs(one.windows)[0]
    win = (w, sl, c["hc"], c["vc"], cs, 0, H, W)
    v1 = torch.tensor([0, 1, 0], dtype=torch.int32)
    # bytes read and written by each launch timed below: a round launch reads
    # the state, the costs and (sharded) every slab row; the phases run
    # (0, 1, 0), where nothing receives, so they read the state alone
    dense, win_state = list(s.values()), list(w.values())
    win_halo = [*(x for pair in sl.values() for x in pair), c["hc"], c["vc"], *cs["hc"], *cs["vc"]]
    io = {"phase_update": phase_bytes(dense, [hcc, vcc], 0),
          "phase_update_v1": phase_bytes(dense, [hcc, vcc], 0),
          "round_update": (nbytes(dense + [hcc, vcc]), nbytes(dense)),
          "phase_update_sharded": phase_bytes(win_state, win_halo, 0),
          "round_update_sharded": (nbytes(win_state + win_halo), nbytes(win_state))}
    cells = H * W * L                   # cell-label pairs; a phase updates the cells of one colour
    updates = {"phase_update": cells // 2, "phase_update_v1": cells // 2,
               "phase_update_sharded": cells // 2, "round_update": 2 * cells,
               "round_update_sharded": 2 * cells}
    geometries = (("K1", round_tile(L, 2, H, W)),
                  ("K3, 1 shard", round_tile(L, 2, H, W, sharded=True)))
    for what, t in geometries:
        print(f"time: round kernel geometry ({what}) at {H}x{W}, L={L}, n_rounds=2: segments of "
              f"{t['rows']} rows in strips of {t['cols']} columns written per block "
              f"({t['rows_loaded']} rows streamed, {t['cols_loaded']} columns loaded), a ring of "
              f"{t['ring_rows']} rows with {t['bands_ahead']} bands of {t['band_rows']} in flight, "
              f"{t['threads']} threads, {t['smem']} B of shared memory, {t['blocks_per_sm']} "
              f"blocks per SM, {t['strips']} x {t['segments']} blocks in {t['waves']} wave(s)")
    times = {}
    for name, kern, plain in (
            ("phase_update", lambda: phase_update(s, hcc, vcc, 0, 1, 0.0),
             lambda: phase_update_ref(s, hcc, vcc, 0, 1, 0.0)),
            ("round_update", lambda: round_update(s, hcc, vcc, 2),
             lambda: round_update_ref(s, hcc, vcc, 2)),
            ("phase_update_v1", lambda: phase_update_v1(v1, s, hcc, vcc),
             lambda: phase_update_ref(s, hcc, vcc, 0, 1, 0.0)),
            ("phase_update_sharded", lambda: phase_update_sharded(*win, 0, 1, 0.0),
             lambda: phase_update_sharded_ref(*win, 0, 1, 0.0)),
            ("round_update_sharded", lambda: round_update_sharded(*win, 2),
             lambda: round_update_sharded_ref(*win, 2))):
        t = in_turns({"plain": plain, "kernel": kern}, reps=20)
        sharded = "sharded" in name
        bound_ms, bound_by = launch_bound(*io[name], updates[name])
        times[name] = {"ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None}
        print(f"time: {name} kernel {t['kernel'] * 1e3:.1f} us/launch "
              f"({launch_bytes / t['kernel'] / 1e6:.1f} GB/s, host enqueue "
              f"{host_ms(kern, reps=20) * 1e3:.1f} us), plain {t['plain'] * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by}; no single PyTorch call computes a Potts "
              f"phase) at {H}x{W} L={L}{' (1 shard)' if sharded else ''} on {card}")
    return times, phase_kernel_times(card)


def rounding_times(rec: dict) -> dict:
    """The rounding wrappers' entries of the ``kernels`` line from
    ``phase_bench.round_primal_times``'s record (``round_phase_update`` at
    the slower of its two damped_uniform phase tuples)."""
    phase = max((v for k, v in rec.items() if k.startswith("round_phase_update")),
                key=lambda v: v["us"])
    return {name: {"ms": v["us"] * 1e-3, "plain_ms": v["plain_us"] * 1e-3,
                   "bound_ms": v["bound_us"] * 1e-3, "bound_by": v["bound_by"],
                   "library_ms": None}
            for name, v in (("round_phase_update", phase), ("primal_cost", rec["primal_cost"]))}


def phase_kernel_times(card: str) -> dict:
    """The phase kernels in every phase tuple and the captured run_fast in
    every mode (``phase_bench``: graph replays of 20 launches, CUDA
    events, median of 3 in turns), and the state copies of the captured dense
    run_fast(20, "cuda")."""
    rec = {"phases": phase_bench.phase_times(lp_mp_tpu_torch, PHASE_PARAMS),
           "run_fast": phase_bench.run_fast_times(lp_mp_tpu_torch),
           "rounding": phase_bench.round_primal_times(lp_mp_tpu_torch)}
    for line in phase_bench.rounding_lines(rec["rounding"]):
        print(f"time: {line} (median of 3, CUDA events) on {card}")
    for name, per in rec["phases"].items():
        print(f"time: {name} by graph replay of {phase_bench.LAUNCHES} launches: " + ", ".join(
            f"{p} {v['us']:.1f} us ({100 * v['share']:.0f} % of {v['bound_us']:.1f})"
            for p, v in per.items()) + ("" if " L=" in name else f" at {H}x{W} L={L}")
            + f" on {card}")
    for name, per in rec["run_fast"].items():
        print(f"time: captured run_fast({phase_bench.RUN_FAST_N}) {name}: " + ", ".join(
            f"{mode} {v['its']:.1f} it/s ({v['ms']:.3f} ms)" for mode, v in per.items())
            + f" (median of 3, CUDA events) on {card}")
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    m = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    n = phase_bench.RUN_FAST_N
    dev = kernel_device_us(lambda: m.run_fast(n, kernel="cuda"))
    graph = [r for r in m.jit.records if r.name.endswith("run_fast")]
    copies = graph[-1].copies
    events = sum(cnt for _, cnt in dev.values())
    rec["dense_copies"] = {"graph_copies": copies, "profiler_events": events,
                           "profiler_kernels": {kernel_name(k): c for k, (_, c) in dev.items()}}
    print(f"time: captured dense run_fast({n}, 'cuda'): {copies} state copies at the end of its "
          f"graph (capture record); one replay under torch.profiler: {events} device events "
          f"{rec['dense_copies']['profiler_kernels']} on {card}")
    if copies:
        fail(f"the captured dense run_fast({n}) ends in {copies} state copies")
    return rec


def chain_instance(n: int, labels: int, seed: int):
    """bench.py's chain: normal unaries [n, L], normal pairwise [n-1, L, L]."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, labels)), rng.normal(size=(n - 1, labels, labels))


def chain_optimum(un, pw) -> float:
    """Exact chain optimum by a min-plus tree reduction (bench.py:339-359):
    edge matrices M_e[a, b] = pw[e][a, b] + un[e+1, b], multiplied in
    log2(n) vectorised levels."""
    M = pw + un[1:, None, :]
    while M.shape[0] > 1:
        last = None
        if M.shape[0] % 2:
            last, M = M[-1:], M[:-1]
        M = (M[0::2][:, :, :, None] + M[1::2][:, None, :, :]).min(axis=2)
        if last is not None:
            M = np.concatenate([M[:-1], (M[-1][:, :, None] + last[0][None]).min(axis=1)[None]])
    return float((un[0][:, None] + M[0]).min())


def grid_pairs(rows: int, cols: int, diagonals: bool = False, anti: bool = False) -> np.ndarray:
    """Edges of a rows x cols grid in bench.py's order: horizontal, vertical,
    then the diagonals and anti-diagonals asked for."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    parts = [(idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])]
    if diagonals:
        parts.append((idx[:-1, :-1], idx[1:, 1:]))
    if anti:
        parts.append((idx[:-1, 1:], idx[1:, :-1]))
    return np.concatenate([np.stack([a.ravel(), b.ravel()], axis=1) for a, b in parts])


def generic_grid_graph() -> FactorGraph:
    """bench.py's generic_grid (bench.py:260-331): the 1000x1000, L=4 Potts
    grid with normal unaries and weights U(0.5, 1.5) from default_rng(1),
    pairs horizontal then vertical (so every pull slot is strided)."""
    rng = np.random.default_rng(1)
    g = FactorGraph()
    mrf = MrfConstructor(g)
    mrf.add_unary_factors(rng.normal(size=(H * W, L)))
    pairs = grid_pairs(H, W)
    mrf.add_potts_factors(pairs, L, rng.uniform(0.5, 1.5, size=len(pairs)))
    return g


def multicut_150k_instance():
    """bench.py:397-433: a 200x250 grid with diagonals, 149101 edges, costs
    N(0.6, 1) from seed 3."""
    pairs = grid_pairs(200, 250, diagonals=True)
    return pairs, np.random.default_rng(3).normal(loc=0.6, scale=1.0, size=len(pairs))


def mrf_grid24_instance():
    """bench.py:616-640: a 24x24 8-connected binary grid, normal unaries,
    Potts weights U(0.2, 0.6) with a tenth of them negated (seed 7), as
    dense pairwise factors."""
    rng = np.random.default_rng(7)
    un = rng.normal(size=(24 * 24, 2)) * 1.0
    pairs = np.sort(grid_pairs(24, 24, diagonals=True, anti=True), axis=1)
    w = rng.uniform(0.2, 0.6, size=len(pairs))
    w[rng.random(len(pairs)) < 0.10] *= -1.0
    return un, pairs, w[:, None, None] * (1.0 - np.eye(2))[None]


def multicut_grid40_instance():
    """bench.py:642-658: a 40x40 grid, costs N(0.4, 1) from seed 8."""
    pairs = grid_pairs(40, 40)
    return pairs, np.random.default_rng(8).normal(loc=0.4, scale=1.0, size=len(pairs))


# the Solver settings of bench.py:616-658 (visitor keywords, Solver keywords)
MRF_GRID24_SOLVER = (dict(max_iter=150, tighten=True, tighten_iteration=20, tighten_interval=60,
                          tighten_slope=0.05, tighten_constraints_max=800),
                     dict(rounding="restricted", schedule_mode="auto"))
MULTICUT_GRID40_SOLVER = (dict(max_iter=200, tighten=True, tighten_iteration=10,
                               tighten_interval=20, tighten_slope=0.05,
                               tighten_constraints_max=600),
                          dict(schedule_mode="auto"))


def mrf_304_instance(side: "int | None" = None):
    """The ``mrf_304x304`` of bench/sharded_measurements.py:93-107: a side x
    side 4-connected grid, L=3, normal unaries and Potts weights U(0.5, 1.5)
    from default_rng(2), edges horizontal then vertical.  Returned as dense
    [E, L, L] Potts matrices: the chain write-back needs dense pairwise
    factors."""
    side = side or TREE_SIDE
    rng = np.random.default_rng(2)
    un = rng.normal(size=(side * side, TREE_L))
    pairs = grid_pairs(side, side)
    w = rng.uniform(0.5, 1.5, size=len(pairs))
    return un, pairs, w[:, None, None] * (1.0 - np.eye(TREE_L))[None]


def triplet_digest(triplets) -> str:
    """Short digest of a constructor's triplets in the order they were added."""
    return hashlib.sha256(np.asarray(list(triplets), dtype=np.int64).tobytes()).hexdigest()[:16]


def build_chain(ctor: MrfConstructor, un, pw) -> None:
    ctor.add_unary_factors(un)
    n = un.shape[0]
    ctor.add_pairwise_factors(np.stack([np.arange(n - 1), np.arange(1, n)], axis=1), pw)


def timed_engine(g: FactorGraph, **kw) -> tuple:
    """An engine on the card and its build seconds: host schedule, plans,
    upload, and the anisotropic weights of both directions."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    e = Engine(g, device="cuda", dtype=torch.float32, **kw)
    for d in Direction:
        e.weights("anisotropic", d)
    torch.cuda.synchronize()
    return e, time.perf_counter() - t


def profile_pass(fn) -> dict:
    """Wall time, device busy time and idle share of one call of ``fn`` under
    torch.profiler, plus the aten ops that take the most device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kern = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    ops = []
    for a in prof.key_averages():
        if a.self_device_time_total > 0:
            ops.append((a.self_device_time_total / 1e3, a.key, a.count))
    ops.sort(reverse=True)
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "kernels": len(kern),
            "idle_share": 1.0 - busy / (wall * 1e3), "top": ops[:6]}


def print_profile(tag: str, p: dict, card: str) -> None:
    print(f"{tag}: one pass under torch.profiler: wall {p['wall_ms']:.3f} ms, device busy "
          f"{p['busy_ms']:.3f} ms in {p['kernels']} kernels, idle share {p['idle_share']:.3f} "
          f"on {card}")
    print(f"{tag}: device time by op: " + ", ".join(
        f"{k} {ms:.3f} ms/{n}" for ms, k, n in p["top"]))


def phase_native() -> float:
    """The host schedule at a million factors needs the native library:
    its pure-Python fallbacks would outlast the run."""
    t = time.perf_counter()
    lib = native.get_lib()
    sec = time.perf_counter() - t
    if lib is None:
        fail("the native host library (csrc/lpmp_host.cpp, g++) did not build or load")
    print(f"native: liblpmp_host.so ready in {sec:.2f} s (g++ build if not cached)")
    return sec


def phase_engine_chain() -> dict:
    """The chain through Engine(schedule_mode="auto") and through Solver."""
    un, pw = chain_instance(CHAIN_N, CHAIN_L, CHAIN_SEED)
    t = time.perf_counter()
    opt = chain_optimum(un, pw)
    print(f"chain: n={CHAIN_N} L={CHAIN_L} seed={CHAIN_SEED}: exact optimum {opt!r} "
          f"(min-plus reduction, {time.perf_counter() - t:.2f} s), recorded {CHAIN_OPT!r}")
    if not rel(opt, CHAIN_OPT) <= 1e-12:
        fail(f"chain optimum {opt} differs from the recorded {CHAIN_OPT}")
    g = FactorGraph()
    t = time.perf_counter()
    build_chain(MrfConstructor(g), un, pw)
    ctor_s = time.perf_counter() - t
    e, build_s = timed_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"chain: {g.n_factors} factors, constructor {ctor_s:.2f} s, Engine build {build_s:.2f} s, "
          f"schedule_mode=auto chose {e.schedule_mode!r}, phases {nph}")
    if e.schedule_mode != "coloring":
        fail(f"auto chose {e.schedule_mode} for {g.n_factors} factors")

    scale = max(1.0, abs(opt))
    prev, passes = e.lower_bound(), 0
    while opt - prev > CHAIN_GAP * scale and passes < CHAIN_MAX_PASSES:
        for _ in range(CHAIN_CHUNK):
            e.compute_pass("anisotropic")
        passes += CHAIN_CHUNK
        lb = e.lower_bound()
        print(f"chain: {passes:3d} passes: lower bound {lb:.6f}, gap {(opt - lb) / scale:.3e}")
        if lb < prev - 1e-4 * abs(prev):
            fail(f"chain bound dropped from {prev} to {lb} after {passes} passes")
        if lb > opt + 1e-4 * scale:
            fail(f"chain bound {lb} lies above the optimum {opt}")
        prev = lb
    gap = (opt - prev) / scale
    print(f"chain: gap {gap:.3e} to the exact optimum after {passes} passes (limit {CHAIN_GAP} "
          f"within {CHAIN_MAX_PASSES})")
    if not gap <= CHAIN_GAP:
        fail(f"chain gap {gap} after {passes} passes")

    s = Solver(visitor=StandardVisitor(max_iter=200), schedule_mode="auto", device="cuda",
               dtype=torch.float32)
    build_chain(s.add_constructor(MrfConstructor), un, pw)
    t = time.perf_counter()
    lb = s.solve()
    solve_s = time.perf_counter() - t
    ub = s.primal_cost()
    ev = s.engine.evaluate_primal(s.best_primal)
    print(f"chain: Solver + StandardVisitor(max_iter=200) in {solve_s:.2f} s: lb {lb:.6f}, "
          f"ub {ub:.6f}, evaluate_primal {ev:.6f}; gap to the optimum: lb "
          f"{(opt - lb) / scale:.3e}, ub {(ub - opt) / scale:.3e}")
    if not (np.isfinite(ev) and np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)):
        fail(f"Solver: ub {ub} (evaluate_primal {ev}) is not a feasible primal above lb {lb}")
    return e, {"passes_to_gap": passes, "gap": gap, "lb": prev, "build_s": build_s,
               "solver_lb": lb, "solver_ub": ub, "solver_s": solve_s}


def phase_engine_grid() -> tuple:
    """The main grid through the generic engine (Potts pairs batch-built in
    the per-cell order of tests/test_grid.py), held against GridPottsModel's
    kernel path on the card.  The engine launches no hand-written kernel:
    the counters stay at 0 through its passes.  Returns the engine, the
    kernel-path model, the graph and the phase's record."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    g = FactorGraph()
    t = time.perf_counter()
    ctor = MrfConstructor(g)
    ctor.add_unary_factors(u.reshape(H * W, L))
    pairs, diffs = grid_potts_edges(hc, vc)
    ctor.add_potts_factors(pairs, L, diffs)
    ctor_s = time.perf_counter() - t
    e, build_s = timed_engine(g, schedule_mode="coloring")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"engine grid: {H}x{W} L={L}: {g.n_factors} factors, constructor {ctor_s:.2f} s, "
          f"Engine build {build_s:.2f} s, phases {nph}")
    reset_launch_counts()
    for _ in range(ENGINE_GRID_PASSES):
        e.compute_pass("anisotropic")
    lb_e = e.lower_bound()
    counts = launch_counts()
    print(f"engine grid: bound after {ENGINE_GRID_PASSES} anisotropic passes {lb_e:.6f}; "
          f"hand-written kernel launches in them {counts}")
    if any(counts.values()):
        fail(f"the generic engine launched grid kernels: {counts}")

    m = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    reset_launch_counts()
    m.run_fast(ENGINE_GRID_PASSES, kernel="cuda")
    lb_k = m.lower_bound()
    counts = launch_counts()
    expect = dict.fromkeys(counts, 0)
    expect.update(phase_update=1, round_update=ENGINE_GRID_PASSES // 2)
    expect = with_warmups(expect, m.jit.records)
    if counts != expect:
        fail(f"GridPottsModel kernel path launches {counts} differ from the schedule's {expect}")
    mi = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    mi.iterate("anisotropic", ENGINE_GRID_PASSES)
    lb_i = mi.lower_bound()
    print(f"engine grid: GridPottsModel after {ENGINE_GRID_PASSES} iterations: kernel path "
          f"{lb_k:.6f} (launches {counts}), iterate {lb_i:.6f}; engine rel diff "
          f"{rel(lb_e, lb_k):.3e} to the kernel path, {rel(lb_e, lb_i):.3e} to iterate "
          f"(limit 1e-5)")
    if not (rel(lb_e, lb_k) <= 1e-5 and rel(lb_e, lb_i) <= 1e-5):
        fail(f"generic engine bound {lb_e} disagrees with GridPottsModel ({lb_k}, {lb_i})")
    return e, m, g, {"lb": lb_e, "lb_kernel_path": lb_k, "build_s": build_s}


def phase_engine_time(card: str, ec: Engine, eg: Engine, m: GridPottsModel) -> tuple:
    """Engine passes per second beside the kernel path, host enqueue time of
    one pass, device idle share of one pass."""
    n = 20
    fns = {"chain pass": lambda: ec.compute_pass("anisotropic"),
           "grid pass": lambda: eg.compute_pass("anisotropic"),
           f"grid kernel path run_fast({n})": lambda: m.run_fast(n, kernel="cuda")}
    t = in_turns(fns, reps=3)
    host = {k: host_ms(fn, reps=3) for k, fn in fns.items()}
    its = {"chain": 1e3 / t["chain pass"], "grid": 1e3 / t["grid pass"],
           "grid_kernel_path": n * 1e3 / t[f"grid kernel path run_fast({n})"]}
    print("engine time: " + ", ".join(
        f"{k} {v:.3f} ms (host enqueue {host[k]:.3f} ms)" for k, v in t.items())
        + f" (median of 3 in turns, CUDA events) on {card}")
    print(f"engine time: generic engine {its['chain']:.1f} it/s on the chain, {its['grid']:.2f} "
          f"it/s on the {H}x{W} grid; GridPottsModel kernel path {its['grid_kernel_path']:.1f} "
          f"it/s on the same grid, on {card}")
    prof = {}
    for tag, e in (("chain", ec), ("grid", eg)):
        prof[tag] = profile_pass(lambda e=e: e.compute_pass("anisotropic"))
        print_profile(f"engine time: {tag}", prof[tag], card)
    return {tag: {"its": its[tag], "pass_ms": t[f"{tag} pass"],
                  "host_enqueue_ms": host[f"{tag} pass"],
                  "idle_share": prof[tag]["idle_share"], "busy_ms": prof[tag]["busy_ms"]}
            for tag in ("chain", "grid")}, its["grid_kernel_path"]


def timed_tighten(mc: MulticutConstructor, eng: Engine) -> tuple:
    """``mc.tighten`` on ``eng``, its seconds split into pull (the edge
    block to the host and into a cost per edge), add (triplets into the
    graph) and search (the rest: BFS, candidate ranking), by timing the
    constructor's own calls; and, apart, one copy of the edge block to the
    host (the transfer inside pull)."""
    spent = {"pull": 0.0, "add": 0.0}

    def timed(key, fn):
        def wrapper(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t
        return wrapper
    mc._reparametrized_edge_costs = timed("pull", mc._reparametrized_edge_costs)
    mc._reparametrized_triplet_costs = timed("pull", mc._reparametrized_triplet_costs)
    mc.add_triplet = timed("add", mc.add_triplet)
    torch.cuda.synchronize()
    t = time.perf_counter()
    try:
        n = mc.tighten(eng, max_constraints=500, max_candidates=2000)
    finally:
        for k in ("_reparametrized_edge_costs", "_reparametrized_triplet_costs", "add_triplet"):
            del mc.__dict__[k]
    total = time.perf_counter() - t
    t = time.perf_counter()
    host_array(eng.state["multicut_edge"]["c"])
    transfer = time.perf_counter() - t
    return n, {"total_s": total, "pull_s": spent["pull"], "add_s": spent["add"],
               "search_s": total - spent["pull"] - spent["add"], "transfer_s": transfer}


def phase_multicut_150k(card: str) -> tuple:
    """bench.py's multicut: one separation round on a fresh engine, a
    rebuild, 100 anisotropic passes and GAEC, against the JAX package.
    Returns the phase's record and the graph with its triplets."""
    pairs, costs = multicut_150k_instance()
    s = Solver(device="cuda", dtype=torch.float32)
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    eng, build_s = timed_engine(s.graph, schedule_mode="auto")
    n, split = timed_tighten(mc, eng)
    digest = triplet_digest(mc.triplets)
    print(f"multicut 150k: {len(pairs)} edges, Engine build {build_s:.2f} s ({eng.schedule_mode}); "
          f"tighten round {split['total_s']:.3f} s = pull {split['pull_s']:.3f} + search "
          f"{split['search_s']:.3f} + add {split['add_s']:.3f} s (edge block to the host "
          f"{split['transfer_s'] * 1e3:.3f} ms): {n} added, {len(mc.triplets)} "
          f"triplets, {len(mc.edges)} edges, digest {digest}; JAX package {JAX_MC150K}")
    got = {"triplets_added": n, "n_triplets": len(mc.triplets), "n_edges": len(mc.edges),
           "digest": digest}
    if any(got[k] != JAX_MC150K[k] for k in got):
        fail(f"the separation round differs from the JAX package's: {got}")
    eng, rebuild_s = timed_engine(s.graph, schedule_mode="auto")
    reset_launch_counts()
    prev = eng.lower_bound()
    for i in range(1, MC150K_PASSES + 1):
        eng.compute_pass("anisotropic")
        if i % 25 == 0:
            lb = eng.lower_bound()
            print(f"multicut 150k: {i:3d} passes: lower bound {lb:.6f}")
            if lb < prev - 1e-4 * abs(prev):
                fail(f"multicut bound dropped from {prev} to {lb}")
            prev = lb
    if any(launch_counts().values()):
        fail(f"the multicut engine launched grid kernels: {launch_counts()}")
    t = time.perf_counter()
    _, _, ub = mc.round_gaec()
    gaec_s = time.perf_counter() - t
    print(f"multicut 150k: after {MC150K_PASSES} passes lb {prev:.6f}, JAX package "
          f"{JAX_MC150K['lb']}, rel diff {rel(prev, JAX_MC150K['lb']):.3e} (limit 1e-4); GAEC ub "
          f"{ub!r} in {gaec_s:.2f} s, JAX package {JAX_MC150K['gaec_ub']!r}")
    if not rel(prev, JAX_MC150K["lb"]) <= 1e-4:
        fail(f"multicut bound {prev} is not within 1e-4 of the JAX package's")
    if not abs(ub - JAX_MC150K["gaec_ub"]) <= 1e-9:
        fail(f"GAEC ub {ub} differs from the JAX package's {JAX_MC150K['gaec_ub']}")
    pass_ms = in_turns({"pass": lambda: eng.compute_pass("anisotropic")}, reps=5)["pass"]
    host = host_ms(lambda: eng.compute_pass("anisotropic"), reps=5)
    prof = profile_pass(lambda: eng.compute_pass("anisotropic"))
    print(f"multicut 150k: one pass {pass_ms:.3f} ms ({1e3 / pass_ms:.1f} it/s, host enqueue "
          f"{host:.3f} ms, events median of 3) on {card}")
    print_profile("multicut 150k", prof, card)
    return {**got, **split, "lb": prev, "gaec_ub": ub, "gaec_s": gaec_s, "build_s": build_s,
            "rebuild_s": rebuild_s, "pass_ms": pass_ms, "host_enqueue_ms": host,
            "idle_share": prof["idle_share"]}, s.graph


def solver_run(tag: str, s: Solver, ctor) -> dict:
    """``s.solve()`` with the launch counters set to 0 just before and read
    just after: the generic engine and tightening launch no hand-written
    kernel."""
    torch.cuda.synchronize()
    reset_launch_counts()
    t = time.perf_counter()
    lb = s.solve()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    if any(launch_counts().values()):
        fail(f"{tag}: the Solver run launched grid kernels: {launch_counts()}")
    ub = s.primal_cost()
    gap = (ub - lb) / max(1.0, abs(ub))
    n_trip = len(getattr(ctor, "triplets", ()))
    out = {"lb": lb, "ub": ub, "rel_gap": gap, "s": sec, "n_engine_builds": s.n_engine_builds,
           "aux_n": s.aux.n, "n_triplets": n_trip, "captures": s.n_captures,
           "capture_s": s.capture_seconds}
    recs = s.engine.jit.records
    print(f"{tag}: Solver.solve() in {sec:.2f} s: lb {lb:.6f}, ub {ub:.6f}, rel gap {gap:.3e}, "
          f"{s.n_engine_builds} engine builds, aux.n {s.aux.n}, {n_trip} triplets; "
          f"{s.n_captures} CUDA graphs captured in {s.capture_seconds:.2f} s (warm-up included; "
          f"the last engine's {len(recs)}: warm-up {sum(r.warmup_s for r in recs):.2f} s, "
          f"capture {sum(r.capture_s for r in recs):.2f} s)")
    return out


def phase_tightening_solvers() -> dict:
    """The tightening Solver runs of bench.py's solver_e2e, and the
    frustrated 4-cycle of tests/test_cycle_separation.py."""
    out = {}
    vk, sk = MRF_GRID24_SOLVER
    un, pairs, pw = mrf_grid24_instance()
    s = Solver(visitor=StandardTighteningVisitor(**vk), device="cuda", dtype=torch.float32, **sk)
    mrf = s.add_constructor(MrfConstructor)
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    r = out["mrf_grid24"] = solver_run("mrf_grid24", s, mrf)
    print(f"mrf_grid24: JAX package {JAX_GRID24}; lb rel diff {rel(r['lb'], JAX_GRID24['lb']):.3e} "
          f"(limit 1e-4), rel gap limit 1e-4")
    if not (rel(r["lb"], JAX_GRID24["lb"]) <= 1e-4 and r["rel_gap"] <= 1e-4):
        fail(f"mrf_grid24: lb {r['lb']}, gap {r['rel_gap']}")

    vk, sk = MULTICUT_GRID40_SOLVER
    pairs, costs = multicut_grid40_instance()
    s = Solver(visitor=StandardTighteningVisitor(**vk), device="cuda", dtype=torch.float32, **sk)
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    r = out["multicut_grid40"] = solver_run("multicut_grid40", s, mc)
    print(f"multicut_grid40: JAX package {JAX_GRID40}; rel gap limit 1e-2, lb <= ub + 1e-4|ub|")
    if not (r["rel_gap"] <= 1e-2 and r["lb"] <= r["ub"] + 1e-4 * abs(r["ub"])):
        fail(f"multicut_grid40: lb {r['lb']}, ub {r['ub']}, gap {r['rel_gap']}")

    s = Solver(visitor=StandardTighteningVisitor(
        max_iter=150, tighten=True, tighten_iteration=5, tighten_interval=10,
        tighten_constraints_max=4, tighten_reparametrization="damped_uniform"),
        device="cuda", dtype=torch.float32)
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(4):
        mrf.add_unary_factor(np.zeros(2))
    disagree = np.eye(2)
    mrf.add_pairwise_factor(0, 1, disagree)
    for i, j in ((1, 2), (2, 3), (0, 3)):
        mrf.add_pairwise_factor(i, j, 1.0 - disagree)
    r = out["frustrated_4cycle"] = solver_run("frustrated 4-cycle", s, mrf)
    if not abs(r["lb"] - 1.0) <= 1e-5:
        fail(f"frustrated 4-cycle: lb {r['lb']}, not 1.0")
    return out


def qap_input(n: int, n_edges: int, seed: int) -> GraphMatchingInput:
    """bench.py:436-471 and :588-607: every left node a candidate of every
    right node at N(0, 1) cost, and ``n_edges`` draws of a quadratic term
    N(0, 0.3^2) between assignments of distinct left and right nodes."""
    rng = np.random.default_rng(seed)
    assignments = [(i, j, float(rng.normal())) for i in range(n) for j in range(n)]
    aid = {(i, j): k for k, (i, j, _) in enumerate(assignments)}
    edges = []
    for _ in range(n_edges):
        i1, i2 = rng.choice(n, 2, replace=False)
        j1, j2 = rng.choice(n, 2, replace=False)
        if j1 != j2:
            edges.append((aid[(i1, j1)], aid[(i2, j2)], float(rng.normal() * 0.3)))
    return GraphMatchingInput(n, n, assignments, edges)


def tomography_chains(dt: DiscreteTomographyConstructor, n_chains: int, nv: int, labels: int,
                      seed: int) -> None:
    """bench.py:474-505 and :566-585: chains of ``nv`` pixels with normal
    unaries and N(0, 0.3^2) pairwise, one projection per chain whose cost
    rises by 0.05 per unit from a random target sum."""
    rng = np.random.default_rng(seed)
    v = 0
    for _ in range(n_chains):
        first = v
        for q in range(nv):
            dt.add_unary_factor(rng.normal(size=labels))
            if q:
                dt.add_pairwise_factor(v - 1, v, rng.normal(size=(labels, labels)) * 0.3)
            v += 1
        smax = (labels - 1) * nv
        dt.add_projection(range(first, v), 0.05 * np.abs(np.arange(smax + 1)
                                                         - int(rng.integers(0, smax))))


def model_solver(ctor_cls, **kw):
    s = Solver(visitor=StandardVisitor(max_iter=MODEL_ITERS), schedule_mode="auto",
               device="cuda", dtype=torch.float32)
    return s, s.add_constructor(ctor_cls, **kw)


def phase_model_solvers() -> dict:
    """tomography_10x32 and qap_16x16 of bench.py's solver_e2e through
    Solver on the card, against the JAX package's float32 CPU values."""
    out = {}
    s, dt = model_solver(DiscreteTomographyConstructor)
    tomography_chains(dt, 10, 32, 3, seed=10)
    r = out["tomography_10x32"] = solver_run("tomography_10x32", s, dt)
    r["schedule_mode"] = s.engine.schedule_mode
    print(f"tomography_10x32: JAX package {JAX_TOMO10X32}; {s.engine.schedule_mode} schedule; "
          f"lb rel diff {rel(r['lb'], JAX_TOMO10X32['lb']):.3e} (limit 1e-4), ub - lb "
          f"{r['ub'] - r['lb']:.3e} (limit 1e-4 |lb|)")
    if not (rel(r["lb"], JAX_TOMO10X32["lb"]) <= 1e-4 and r["ub"] - r["lb"] <= 1e-4 * abs(r["lb"])):
        fail(f"tomography_10x32: lb {r['lb']}, ub {r['ub']}")

    s, gm = model_solver(GraphMatchingConstructor, construction="left")
    gm.construct(qap_input(16, 600, seed=9))
    r = out["qap_16x16"] = solver_run("qap_16x16", s, gm)
    r["schedule_mode"] = s.engine.schedule_mode
    same = bool((gm.matching(s.engine, s.best_primal) == np.asarray(JAX_QAP16["matching"])).all())
    print(f"qap_16x16: JAX package lb {JAX_QAP16['lb']}, ub {JAX_QAP16['ub']}, rel gap "
          f"{JAX_QAP16['rel_gap']:.3e}; lb rel diff {rel(r['lb'], JAX_QAP16['lb']):.3e} "
          f"(limit 1e-4), rel gap limit {JAX_QAP16['rel_gap'] + 1e-3:.3e}; matching equal to "
          f"the JAX package's: {same}")
    r["matching_equal"] = same
    if not (rel(r["lb"], JAX_QAP16["lb"]) <= 1e-4 and r["ub"] >= r["lb"]
            and r["rel_gap"] <= JAX_QAP16["rel_gap"] + 1e-3):
        fail(f"qap_16x16: lb {r['lb']}, ub {r['ub']}, rel gap {r['rel_gap']}")
    return out


def engine_time(tag: str, e: Engine, card: str) -> dict:
    """Passes per second by CUDA events (median of 3), host enqueue of one
    pass and its device idle share under torch.profiler; the engine
    launches no hand-written kernel."""
    step = lambda: e.compute_pass("anisotropic")          # noqa: E731
    reset_launch_counts()
    pass_ms = in_turns({"pass": step}, reps=MODEL_TIME_REPS)["pass"]
    host = host_ms(step, reps=MODEL_TIME_REPS)
    prof = profile_pass(step)
    if any(launch_counts().values()):
        fail(f"{tag}: the engine launched grid kernels: {launch_counts()}")
    print(f"{tag}: one pass {pass_ms:.3f} ms ({1e3 / pass_ms:.2f} it/s, host enqueue {host:.3f} ms, "
          f"events median of 3) on {card}")
    print_profile(tag, prof, card)
    return {"its": 1e3 / pass_ms, "pass_ms": pass_ms, "host_enqueue_ms": host,
            "idle_share": prof["idle_share"], "busy_ms": prof["busy_ms"]}


def phase_model_time(card: str) -> dict:
    """qap_32x32_3000quadratic and tomography_100chains_64vars_counting of
    bench.py on the card: engine passes, and for the matching the rounding
    of compute_primal split into MCF (unary block to the host and the
    assignment), the 2-opt polish of its matching, and the greedy start with
    its polish."""
    out = {}
    g = FactorGraph()
    gm = GraphMatchingConstructor(g, construction="left")
    gm.construct(qap_input(32, 3000, seed=4))
    e, build_s = timed_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"qap_32x32: {g.n_factors} factors, {len(gm.inp.edges)} quadratic terms, Engine build "
          f"{build_s:.2f} s ({e.schedule_mode}, phases {nph})")
    r = out["qap_32x32"] = {"build_s": build_s, "schedule_mode": e.schedule_mode,
                            "phases": nph, **engine_time("qap_32x32", e, card)}
    lb = e.lower_bound()
    t = [time.perf_counter()]
    match = solve_assignment(*gm._left_unary_costs(e))
    t.append(time.perf_counter())
    cands = [gm.improve_matching(match)]
    t.append(time.perf_counter())
    cands.append(gm.improve_matching(gm._greedy_matching()))
    t.append(time.perf_counter())
    best = min(cands, key=gm._matching_cost)
    prim = gm.compute_primal(e)
    ub = e.evaluate_primal(prim)
    split = dict(zip(("mcf_s", "two_opt_s", "greedy_s"), np.diff(t).tolist()))
    r.update(lb=lb, ub=ub, rel_gap=(ub - lb) / max(1.0, abs(ub)), **split)
    print(f"qap_32x32: after {1 + 4 * MODEL_TIME_REPS + 2} passes lb {lb:.6f}; rounding "
          f"{sum(split.values()):.3f} s = MCF {split['mcf_s']:.3f} + 2-opt {split['two_opt_s']:.3f} "
          f"+ greedy start {split['greedy_s']:.3f} s; ub {ub:.6f}, rel gap {r['rel_gap']:.3e}")
    if not (np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)
            and (gm.matching(e, prim) == best).all()):
        fail(f"qap_32x32: ub {ub}, lb {lb}, or compute_primal's matching is not the rounded one")

    g = FactorGraph()
    tomography_chains(DiscreteTomographyConstructor(g), 100, 64, 3, seed=5)
    e, build_s = timed_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"tomography_100x64: {g.n_factors} factors, Engine build {build_s:.2f} s "
          f"({e.schedule_mode}, phases {nph})")
    if e.schedule_mode != "coloring":
        fail(f"tomography_100x64: auto chose {e.schedule_mode}")
    r = out["tomography_100x64"] = {"build_s": build_s, "phases": nph,
                                    **engine_time("tomography_100x64", e, card)}
    torch.cuda.synchronize()
    t = time.perf_counter()
    prim = e.compute_pass_and_primal("anisotropic", Direction.forward)
    ub = e.evaluate_primal(prim)
    r.update(lb=e.lower_bound(), ub=ub, primal_pass_s=time.perf_counter() - t)
    print(f"tomography_100x64: lb {r['lb']:.6f}; one forward pass with rounding "
          f"{r['primal_pass_s']:.3f} s, ub {ub:.6f}")
    if not (np.isfinite(r["lb"]) and np.isfinite(ub) and ub >= r["lb"] - 1e-4 * abs(r["lb"])):
        fail(f"tomography_100x64: lb {r['lb']}, ub {ub}")
    return out


def state_diff(a: dict, b: dict) -> tuple:
    """(max |a - b| over the float lanes of two dual states, 1 + max |a|)."""
    err, scale = 0.0, 1.0
    for t, blk in a.items():
        for k, v in blk.items():
            if v.is_floating_point() and v.numel():
                err = max(err, float((v - b[t][k]).abs().max()))
                scale = max(scale, 1.0 + float(v.abs().max()))
    return err, scale


def timed_sharded(g: FactorGraph, n: int) -> tuple:
    """A ShardedEngine of ``n`` shards on cuda:0 and its build seconds
    (its unsharded oracle, ownership, cut rows, per-shard plans, uploads)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    sh = ShardedEngine(g, devices=["cuda:0"] * n, dtype=torch.float32)
    torch.cuda.synchronize()
    return sh, time.perf_counter() - t


def cut_summary(sh: ShardedEngine) -> dict:
    stats = sh.collective_stats()
    return {"cut_rows": sum(v["cut_rows"] for v in stats.values()),
            "bytes_per_consensus": sum(v["bytes_per_collective"] for v in stats.values()),
            "by_type": stats}


def phase_sharded_engine(card: str, g_grid: FactorGraph, g_mc: FactorGraph) -> tuple:
    """ShardedEngine on the 1000x1000 grid at 1 and 4 shards on cuda:0 and
    on the 149101-edge multicut with its 500 triplets at 4 shards, each
    held against a fresh unsharded Engine after the same passes.  Neither
    launches a hand-written kernel.  Returns the record and the 4-shard grid
    engine."""
    out = {}
    ref, ref_build = timed_engine(g_grid, schedule_mode="coloring")
    reset_launch_counts()
    for _ in range(SHARDED_PASSES):
        ref.compute_pass("anisotropic")
    lb_ref = ref.lower_bound()
    ref_state = ref.get_state()
    shards = {}
    for n in SHARD_RUNS:
        sh, build_s = timed_sharded(g_grid, n)
        for _ in range(SHARDED_PASSES):
            sh.compute_pass("anisotropic")
        lb = sh.lower_bound()
        err, scale = state_diff(ref_state, sh.state)
        cut = cut_summary(sh)
        print(f"sharded_engine: grid {H}x{W} L={L}, {n} shards on cuda:0: build {build_s:.2f} s "
              f"(unsharded Engine {ref_build:.2f} s); after {SHARDED_PASSES} anisotropic passes lb "
              f"{lb:.6f}, unsharded {lb_ref:.6f}, rel diff {rel(lb, lb_ref):.3e} (limit 1e-6), max "
              f"state diff {err:.3e} (limit {1e-5 * scale:.3e}); cut rows {cut['cut_rows']}, "
              f"{cut['bytes_per_consensus']} B per consensus")
        if not (rel(lb, lb_ref) <= 1e-6 and err <= 1e-5 * scale):
            fail(f"grid, {n} shards: ShardedEngine differs from the unsharded engine")
        shards[n] = sh
        out[f"grid_{n}"] = {"build_s": build_s, "lb": lb, "lb_unsharded": lb_ref,
                            "max_state_diff": err, **cut}
    if any(launch_counts().values()):
        fail(f"the sharded engine launched grid kernels: {launch_counts()}")
    del ref_state
    fns = {"unsharded": lambda: ref.compute_pass("anisotropic")}
    fns.update({f"{n} shards": (lambda sh=sh: sh.compute_pass("anisotropic"))
                for n, sh in shards.items()})
    t = in_turns(fns, reps=3)
    host = {k: host_ms(fn, reps=3) for k, fn in fns.items()}
    print("sharded_engine: grid one pass " + ", ".join(
        f"{k} {v:.3f} ms (host enqueue {host[k]:.3f} ms)" for k, v in t.items())
        + f" (median of 3 in turns, CUDA events) on {card}")
    for n, sh in shards.items():
        prof = profile_pass(lambda sh=sh: sh.compute_pass("anisotropic"))
        print_profile(f"sharded_engine: grid {n} shards", prof, card)
        out[f"grid_{n}"].update(pass_ms=t[f"{n} shards"], host_enqueue_ms=host[f"{n} shards"],
                                idle_share=prof["idle_share"], busy_ms=prof["busy_ms"])
    out["grid_unsharded"] = {"pass_ms": t["unsharded"], "host_enqueue_ms": host["unsharded"],
                             "build_s": ref_build}
    sh = grid_sh = shards[SHARD_RUNS[-1]]
    lb = sh.lower_bound()
    t0 = time.perf_counter()
    prim = sh.compute_pass_and_primal("damped_uniform", Direction.forward)
    ub = sh.evaluate_primal(prim)
    ok = sh.check_primal_consistency(prim)
    primal_s = time.perf_counter() - t0
    print(f"sharded_engine: grid {SHARD_RUNS[-1]} shards: compute_pass_and_primal + evaluate in "
          f"{primal_s:.2f} s: consistent {ok}, ub {ub:.6f} >= lb {lb:.6f} - 1e-4|lb|")
    if not (ok and np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)):
        fail(f"grid sharded primal: consistent {ok}, ub {ub}, lb {lb}")
    out["grid_primal"] = {"ub": ub, "lb": lb, "consistent": ok, "s": primal_s}
    del ref, shards, prim

    ref, ref_build = timed_engine(g_mc, schedule_mode="coloring")
    n = SHARD_RUNS[-1]
    sh, build_s = timed_sharded(g_mc, n)
    reset_launch_counts()
    for _ in range(SHARDED_PASSES):
        ref.compute_pass("anisotropic")
        sh.compute_pass("anisotropic")
    if any(launch_counts().values()):
        fail(f"the sharded multicut engine launched grid kernels: {launch_counts()}")
    lb, lb_ref = sh.lower_bound(), ref.lower_bound()
    cut = cut_summary(sh)
    t = in_turns({"unsharded": lambda: ref.compute_pass("anisotropic"),
                  f"{n} shards": lambda: sh.compute_pass("anisotropic")}, reps=3)
    host = host_ms(lambda: sh.compute_pass("anisotropic"), reps=3)
    prof = profile_pass(lambda: sh.compute_pass("anisotropic"))
    print(f"sharded_engine: multicut 150k + 500 triplets, {n} shards: build {build_s:.2f} s; after "
          f"{SHARDED_PASSES} passes lb {lb:.6f}, unsharded {lb_ref:.6f}, rel diff "
          f"{rel(lb, lb_ref):.3e} (limit 1e-5); cut rows {cut['cut_rows']}, "
          f"{cut['bytes_per_consensus']} B per consensus; one pass {t[f'{n} shards']:.3f} ms "
          f"(unsharded {t['unsharded']:.3f} ms, host enqueue {host:.3f} ms) on {card}")
    print_profile(f"sharded_engine: multicut {n} shards", prof, card)
    if not rel(lb, lb_ref) <= 1e-5:
        fail(f"multicut, {n} shards: bound {lb} differs from the unsharded {lb_ref}")
    out[f"multicut_{n}"] = {"build_s": build_s, "lb": lb, "lb_unsharded": lb_ref,
                            "pass_ms": t[f"{n} shards"], "unsharded_pass_ms": t["unsharded"],
                            "host_enqueue_ms": host, "idle_share": prof["idle_share"], **cut}
    return out, grid_sh


def chains_digest(chains) -> str:
    """Short digest of a chain cover, chains in order."""
    flat = [v for c in chains for v in (*c, -1)]
    return hashlib.sha256(np.asarray(flat, dtype=np.int64).tobytes()).hexdigest()[:16]


def mrf_304() -> tuple:
    un, pairs, pw = mrf_304_instance()
    g = FactorGraph()
    mrf = MrfConstructor(g, pairwise_rep="dense")
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    return g, mrf, (un, pairs, pw)


def phase_trees(card: str) -> tuple:
    """ChainDecomposition of mrf_304x304 on the card: the cover against
    the JAX package's, subgradient ascent and FW-MAP against its float32 CPU
    bounds, the majority-vote labelling, the write-back into an Engine.
    Returns the record, the decomposition and subgradient ascent's
    multipliers."""
    g, mrf, (un, pairs, pw) = mrf_304()
    t = time.perf_counter()
    dec = ChainDecomposition.from_mrf(mrf, device="cuda", dtype=torch.float32)
    cover_s = time.perf_counter() - t
    T, V, _ = dec.unary.shape
    digest = chains_digest(dec.chains)
    print(f"trees: mrf_{TREE_SIDE}x{TREE_SIDE} L={TREE_L}: chain cover in {cover_s:.2f} s: T={T}, "
          f"V={V}, digest {digest}; JAX package {JAX_TREES['T']}, {JAX_TREES['V']}, "
          f"{JAX_TREES['digest']}")
    if (T, V, digest) != (JAX_TREES["T"], JAX_TREES["V"], JAX_TREES["digest"]):
        fail("the chain cover differs from the JAX package's")
    reset_launch_counts()
    t = time.perf_counter()
    sg, lam, _ = dec.subgradient_ascent(n_iter=50)
    sg_s = time.perf_counter() - t
    t = time.perf_counter()
    fw, _, _ = dec.fw_map(n_outer=5, n_inner=10)
    fw_s = time.perf_counter() - t
    if any(launch_counts().values()):
        fail(f"the tree solves launched grid kernels: {launch_counts()}")
    # FW-MAP's line search sums 10^7 float32 terms; the JAX package rounds
    # them in float32 and the port accumulates them in float64, and after 50
    # steps the bound follows that rounding (PERF.md §6): the port's
    # bound must reach the JAX package's, less 1e-4 relative
    print(f"trees: subgradient_ascent(50) {sg:.6f} in {sg_s:.2f} s, JAX package {JAX_TREES['sg']} "
          f"(rel diff {rel(sg, JAX_TREES['sg']):.3e}, limit 1e-4); fw_map(5, 10) {fw:.6f} in "
          f"{fw_s:.2f} s, JAX package {JAX_TREES['fw']} (rel diff {(fw - JAX_TREES['fw']) / abs(JAX_TREES['fw']):+.3e}, "
          f"limit -1e-4)")
    if not (rel(sg, JAX_TREES["sg"]) <= 1e-4 and fw >= JAX_TREES["fw"] - 1e-4 * abs(JAX_TREES["fw"])):
        fail(f"tree bounds {sg}, {fw} do not reach the JAX package's")
    x = dec.primal_labels(lam)
    cost = float(un[np.arange(len(un)), x].sum() + pw[np.arange(len(pairs)), x[pairs[:, 0]],
                                                       x[pairs[:, 1]]].sum())
    tb = float(dec.dual_value(lam))
    e = Engine(g, schedule_mode="auto", device="cuda", dtype=torch.float32)
    dec.write_back_reparametrization(e, lam)
    lb_e = e.lower_bound()
    # the write-back is a reparametrization: its bound keeps the trees' (it
    # rises where one variable ends several chains: min of a sum >= sum of mins)
    print(f"trees: primal_labels cost {cost:.6f} >= bounds {tb:.6f}, {fw:.6f}; Engine bound after "
          f"write_back_reparametrization {lb_e:.6f} >= {tb:.6f} - 1e-4|lb| (diff {lb_e - tb:.3e})")
    if not (cost >= max(tb, fw) - 1e-6 * abs(tb) and lb_e >= tb - 1e-4 * abs(tb)):
        fail(f"trees: labels cost {cost}, write-back bound {lb_e}, tree bound {tb}")
    step = lambda: dec.solve(lam)                     # noqa: E731
    solve_ms = in_turns({"solve": step}, reps=3)["solve"]
    host = host_ms(step, reps=3)
    prof = profile_pass(step)
    print(f"trees: one solve {solve_ms:.3f} ms ({V - 1} Viterbi steps over {T} chains, host "
          f"enqueue {host:.3f} ms, events median of 3) on {card}")
    print_profile("trees: solve", prof, card)
    return {"cover_s": cover_s, "T": T, "V": V, "digest": digest, "sg": sg, "sg_s": sg_s,
            "fw": fw, "fw_s": fw_s, "labels_cost": cost, "write_back_lb": lb_e,
            "solve_ms": solve_ms, "host_enqueue_ms": host, "idle_share": prof["idle_share"],
            "busy_ms": prof["busy_ms"]}, dec, lam


def tree_solver(chains, device="cuda", dtype=torch.float32) -> Solver:
    """mrf_304x304 through Solver: 10 message-passing iterations, then
    subgradient ascent over the chain cover as trees until iteration 30."""
    s = Solver(visitor=StandardVisitor(max_iter=TREE_SOLVER_ITERS), schedule_mode="auto",
               tree_decomposition_begin=TREE_SOLVER_BEGIN, tree_layout="zero_sum",
               device=device, dtype=dtype)
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    un, pairs, pw = mrf_304_instance()
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    s.tree_decomposition = [TreeSpec(m) for m in chain_tree_messages(s.graph, mrf, chains)]
    return s


def phase_tree_solver(card: str, chains) -> dict:
    s = tree_solver(chains)
    reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    lb = s.solve()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    if any(launch_counts().values()):
        fail(f"the tree Solver launched grid kernels: {launch_counts()}")
    lb_e = s.engine.lower_bound()
    dec = s._tree_state["dec"]
    print(f"tree_solver: Solver(max_iter={TREE_SOLVER_ITERS}, tree_decomposition_begin="
          f"{TREE_SOLVER_BEGIN}, zero_sum) on mrf_{TREE_SIDE}x{TREE_SIDE} in {sec:.2f} s: "
          f"{dec.n_trees} trees, depth {dec.max_depth}, {s._tree_state['k']} tree steps; lb "
          f"{lb:.6f}, JAX package {JAX_TREE_SOLVER['lb']} (rel diff "
          f"{rel(lb, JAX_TREE_SOLVER['lb']):.3e}, limit 1e-4); engine bound after write-back "
          f"{lb_e:.6f}; ub {s.primal_cost():.6f} on {card}")
    if not (rel(lb, JAX_TREE_SOLVER["lb"]) <= 1e-4 and lb_e >= lb - 1e-4 * abs(lb)):
        fail(f"tree_solver: lb {lb}, engine bound {lb_e}")
    return {"lb": lb, "engine_lb": lb_e, "ub": s.primal_cost(), "s": sec, "n_trees": dec.n_trees,
            "depth": dec.max_depth, "tree_steps": s._tree_state["k"]}


def timed(fn):
    """(fn(), host seconds), the card synchronised on both sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def mrf_grid24_solver(visitor, **kw) -> tuple:
    un, pairs, pw = mrf_grid24_instance()
    s = Solver(visitor=visitor, device="cuda", dtype=torch.float32, **kw)
    mrf = s.add_constructor(MrfConstructor)
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    return s, mrf


def phase_oracles(card: str) -> dict:
    """The exact oracles on mrf_grid24 after 50 untightened Solver
    iterations on the card: the local polytope's size and LP value (which
    no reparametrization changes, so it is held to the JAX package's), the
    ILP (the round-5 optimum), combiLP against the ILP, and a Solver with
    exact_rounding="ilp".  They run on the host (HiGHS); the engine's state
    goes to the host once per oracle call."""
    s, mrf = mrf_grid24_solver(StandardVisitor(max_iter=ORACLE_ITERS))
    r = solver_run("oracles: mrf_grid24", s, mrf)
    lb = r["lb"]
    reset_launch_counts()
    (cost, rows, _, _), build_s = timed(lambda: build_local_polytope(s.engine))
    lp, lp_s = timed(lambda: solve_lp_relaxation(s.engine))
    (prim, ilp), ilp_s = timed(lambda: ilp_round(s.engine, time_limit=ORACLE_ILP_LIMIT))
    (cprim, combi), combi_s = timed(lambda: combi_lp(s.engine))
    if any(launch_counts().values()):
        fail(f"oracles: the exact oracles launched grid kernels: {launch_counts()}")
    out = {"lb": lb, "n_vars": len(cost), "n_rows": len(rows), "lp": lp, "ilp": ilp,
           "combilp": combi, "solve_s": r["s"], "build_s": build_s, "lp_s": lp_s,
           "ilp_s": ilp_s, "combilp_s": combi_s}
    print(f"oracles: local polytope {len(cost)} variables, {len(rows)} rows (JAX package "
          f"{JAX_ORACLES['n_vars']}, {JAX_ORACLES['n_rows']}), built in {build_s:.3f} s; LP "
          f"{lp:.6f} in {lp_s:.3f} s (JAX package {JAX_ORACLES['lp']}, rel diff "
          f"{rel(lp, JAX_ORACLES['lp']):.3e}, limit 1e-5; lb {lb:.6f})")
    print(f"oracles: ilp_round {ilp:.6f} in {ilp_s:.3f} s (JAX package {JAX_ORACLES['ilp']}, rel "
          f"diff {rel(ilp, JAX_ORACLES['ilp']):.3e}, limit 1e-5); combi_lp {combi:.6f} in "
          f"{combi_s:.3f} s (rel diff to the ILP {rel(combi, ilp):.3e}, limit 1e-5) on {card}")
    if not (len(cost) == JAX_ORACLES["n_vars"] and len(rows) == JAX_ORACLES["n_rows"]):
        fail(f"oracles: local polytope {len(cost)} x {len(rows)}")
    if not (lp >= lb - 1e-4 * abs(lb) and rel(lp, JAX_ORACLES["lp"]) <= 1e-5):
        fail(f"oracles: LP {lp} against lb {lb} and the JAX package's {JAX_ORACLES['lp']}")
    if not (prim is not None and rel(ilp, JAX_ORACLES["ilp"]) <= 1e-5):
        fail(f"oracles: ILP {ilp}, JAX package {JAX_ORACLES['ilp']}")
    if not (cprim is not None and rel(combi, ilp) <= 1e-5):
        fail(f"oracles: combiLP {combi} against the ILP {ilp}")

    s, mrf = mrf_grid24_solver(StandardVisitor(max_iter=ORACLE_ITERS, primal_computation_interval=25),
                               exact_rounding="ilp", exact_time_limit=ORACLE_SOLVER_LIMIT)
    r = out["solver_ilp"] = solver_run("oracles: Solver(exact_rounding='ilp')", s, mrf)
    print(f"oracles: Solver(exact_rounding='ilp') ub rel diff to the ILP {rel(r['ub'], ilp):.3e} "
          f"(limit 1e-5), lb <= ub: {r['lb'] <= r['ub']}")
    if not (rel(r["ub"], ilp) <= 1e-5 and r["lb"] <= r["ub"]):
        fail(f"oracles: Solver(exact_rounding='ilp') lb {r['lb']}, ub {r['ub']}, ILP {ilp}")
    return out


def tree_diff(a, b) -> tuple:
    """(max |a - b| over the float leaves of two trees of tensors, 1 + max |b|)."""
    la, sa = flatten(a)
    lb, sb = flatten(b)
    if sa != sb:
        fail("the captured and the eager path hold states of another structure")
    err, scale = 0.0, 1.0
    for x, y in zip(la, lb):
        if x.is_floating_point() and x.numel():
            err = max(err, float((x - y).abs().max()))
            scale = max(scale, 1.0 + float(y.abs().max()))
    return err, scale


def jit_path(tag: str, eager, graphed, step, read, bound, stats, card: str,
             bound_tol: float = 1e-6) -> dict:
    """One path of the jit phase: ``eager`` (use_jit=False) and ``graphed``
    (use_jit=True) start from the same state; after JIT_PASSES calls of
    ``step`` each, the captured state (``read``) must lie within
    1e-5 (1 + max|x|) of the eager one and its ``bound`` within
    ``bound_tol`` relative.  Then both are timed in turns (CUDA events,
    median of 3), their host enqueue measured and one call profiled."""
    for _ in range(JIT_PASSES):
        step(eager)
        step(graphed)
    err, scale = tree_diff(read(graphed), read(eager))
    b_jit, b_eager = bound(graphed), bound(eager)
    if not (err <= 1e-5 * scale and rel(b_jit, b_eager) <= bound_tol):
        fail(f"jit: {tag}: the captured path differs from the eager one after {JIT_PASSES} "
             f"calls: state {err:.3e} (limit {1e-5 * scale:.3e}), bound {b_jit} against "
             f"{b_eager} (limit {bound_tol} relative)")
    fns = {"eager": lambda: step(eager), "captured": lambda: step(graphed)}
    t = in_turns(fns, reps=3)
    host = {k: host_ms(fn, reps=3) for k, fn in fns.items()}
    prof = {k: profile_pass(fn) for k, fn in fns.items()}
    st = stats(graphed)
    print(f"jit: {tag}: ms per call eager {t['eager']:.3f} / captured {t['captured']:.3f} "
          f"({t['eager'] / t['captured']:.2f}x); host enqueue {host['eager']:.3f} / "
          f"{host['captured']:.3f} ms; idle share {prof['eager']['idle_share']:.3f} / "
          f"{prof['captured']['idle_share']:.3f}; device busy {prof['eager']['busy_ms']:.3f} / "
          f"{prof['captured']['busy_ms']:.3f} ms in {prof['eager']['kernels']} / "
          f"{prof['captured']['kernels']} kernels; {st['graphs']} graphs captured in "
          f"{st['capture_s']:.2f} s (warm-up included), pool {st['pool_mb']:.1f} MB; after "
          f"{JIT_PASSES} calls state diff {err:.3e} (limit {1e-5 * scale:.3e}), bound "
          f"{b_jit:.6f} vs {b_eager:.6f} (rel {rel(b_jit, b_eager):.3e}, limit {bound_tol}) "
          f"on {card}")
    return {"eager_ms": t["eager"], "captured_ms": t["captured"],
            "eager_host_ms": host["eager"], "captured_host_ms": host["captured"],
            "eager_idle_share": prof["eager"]["idle_share"],
            "captured_idle_share": prof["captured"]["idle_share"],
            "eager_busy_ms": prof["eager"]["busy_ms"], "captured_busy_ms": prof["captured"]["busy_ms"],
            "eager_kernels": prof["eager"]["kernels"], "captured_kernels": prof["captured"]["kernels"],
            "graphs": st["graphs"], "capture_s": st["capture_s"], "pool_mb": st["pool_mb"],
            "state_diff": err, "state_limit": 1e-5 * scale, "bound_rel_diff": rel(b_jit, b_eager)}


def phase_jit(card: str, ec: Engine, eg: Engine, g_mc: FactorGraph, sh_grid: ShardedEngine,
              dec: ChainDecomposition, lam: torch.Tensor) -> dict:
    """use_jit=False against use_jit=True on every path the port captures,
    at the sizes of the phases above; the captured objects of those phases
    are reused where a build takes seconds, their eager twins given the
    same state."""
    out = {}
    f32 = dict(device="cuda", dtype=torch.float32)

    def engine_pair(graph, graphed=None, **kw):
        eager = Engine(graph, use_jit=False, **f32, **kw)
        if graphed is None:
            graphed = Engine(graph, **f32, **kw)
        else:
            eager.set_state(graphed.get_state())
        return eager, graphed

    def engine_path(tag, pair, bound_tol=1e-6):
        out[tag] = jit_path(tag, *pair, lambda e: e.compute_pass("anisotropic"),
                            lambda e: e.state, lambda e: e.lower_bound(),
                            lambda e: e.jit.stats(), card, bound_tol)

    engine_path("chain 100k", engine_pair(ec.graph, ec, schedule_mode="auto"))
    engine_path(f"engine grid {H}x{W}", engine_pair(eg.graph, eg, schedule_mode="coloring"))
    engine_path("multicut 149k + 500 triplets", engine_pair(g_mc, schedule_mode="coloring"),
                bound_tol=1e-5)
    g = FactorGraph()
    GraphMatchingConstructor(g, construction="left").construct(qap_input(32, 3000, seed=4))
    engine_path("qap_32x32", engine_pair(g, schedule_mode="auto"))
    g = FactorGraph()
    tomography_chains(DiscreteTomographyConstructor(g), 100, 64, 3, seed=5)
    engine_path("tomography_100x64", engine_pair(g, schedule_mode="auto"))
    del g

    n = SHARD_RUNS[-1]

    def sharded_path(tag, eager, graphed, bound_tol):
        out[tag] = jit_path(tag, eager, graphed, lambda e: e.compute_pass("anisotropic"),
                            lambda e: e.state, lambda e: e.lower_bound(),
                            lambda e: e.jit.stats(), card, bound_tol)

    eager = ShardedEngine(eg.graph, devices=["cuda:0"] * n, dtype=torch.float32, use_jit=False)
    eager.set_state(sh_grid.state)
    sharded_path(f"sharded engine grid, {n} shards", eager, sh_grid, 1e-6)
    eager, graphed = (ShardedEngine(g_mc, devices=["cuda:0"] * n, dtype=torch.float32,
                                    use_jit=j) for j in (False, True))
    sharded_path(f"sharded engine multicut, {n} shards", eager, graphed, 1e-5)
    del eager, graphed

    out["chain decomposition solve"] = jit_path(
        f"chain decomposition solve {TREE_SIDE}x{TREE_SIDE}", dataclasses.replace(dec, use_jit=False),
        dec, lambda d: d.solve(lam), lambda d: d.solve(lam)[0],
        lambda d: float(torch.sum(d.solve(lam)[0], dtype=torch.float64)),
        lambda d: d.jit.stats(), card)

    u, hc, vc = random_grid(H, W, L, seed=SEED)
    n_fast = 20
    for k in SHARD_RUNS:
        eager, graphed = (ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * k,
                                           dtype=torch.float32, use_jit=j) for j in (False, True))
        out[f"sharded grid {k} shards"] = jit_path(
            f"ShardedGridPotts.run_fast({n_fast}), {k} shards", eager, graphed,
            lambda m: m.run_fast(n_fast), lambda m: m.windows, lambda m: m.lower_bound(),
            lambda m: m.jit.stats(), card)
    for kernel in ("torch", "cuda"):
        eager, graphed = (GridPottsModel(u, hc, vc, use_jit=j, **f32) for j in (False, True))
        out[f"grid model {kernel}"] = jit_path(
            f"GridPottsModel.run_fast({n_fast}, kernel={kernel!r})", eager, graphed,
            lambda m: m.run_fast(n_fast, kernel=kernel), lambda m: m.state,
            lambda m: m.lower_bound(), lambda m: m.jit.stats(), card)
    return out


def pull_totals(e: Engine) -> dict:
    """pull_stats of both directions summed: slots, strided slots, and the
    lanes of the slots that gather."""
    out = {"slots": 0, "strided": 0, "fallback_lanes": 0}
    for d in Direction:
        for v in pull_stats(e, d).values():
            out["slots"] += v["slots"]
            out["strided"] += v["strided"]
            out["fallback_lanes"] += sum(n for pat, _, n in v["patterns"] if pat is None)
    return out


def eager_turns(engines: dict, step) -> tuple:
    """ms per ``step`` of each engine with its captured graphs off (use_jit's
    eager path, CUDA events over one call, median of 3 in turns) and its
    host enqueue (one call: an eager pull pass of the multicut takes a
    second)."""
    for e in engines.values():
        e.jit.enabled = False
    try:
        fns = {k: (lambda e=e: step(e)) for k, e in engines.items()}
        return in_turns(fns, reps=1), {k: host_ms(fn, reps=1) for k, fn in fns.items()}
    finally:
        for e in engines.values():
            e.jit.enabled = True


def pull_model(tag: str, g: FactorGraph, card: str, **kw) -> dict:
    """Engine(pull=True) beside Engine(pull=False) on ``g``: plan totals and
    build seconds, bit-equal reruns of two fresh pull engines where every
    slot is strided, the bound and state after PULL_PASSES passes, and ms
    per pass captured and eager, host enqueue, kernels per pass and pool MB.
    The pull passes launch no hand-written kernel."""
    step = lambda e: e.compute_pass("anisotropic")           # noqa: E731
    sc, sc_build = timed_engine(g, **kw)
    pu, pu_build = timed_engine(g, pull=True, **kw)
    tot = pull_totals(pu)
    print(f"pull: {tag}: {g.n_factors} factors, {pu.schedule_mode}, phases "
          f"{len(pu.phases[Direction.forward])}; pull plans: {tot['slots']} slots, "
          f"{tot['strided']} strided, {tot['fallback_lanes']} fallback lanes, built in "
          f"{pu.pull_plan_s:.2f} s; Engine build pull {pu_build:.2f} s, scatter {sc_build:.2f} s")
    reset_launch_counts()
    bit_equal = None
    if tot["strided"] == tot["slots"]:
        pu2, _ = timed_engine(g, pull=True, **kw)
        for _ in range(PULL_RERUN_PASSES):
            step(pu)
            step(pu2)
        a, b = flatten(pu.state)[0], flatten(pu2.state)[0]
        bit_equal = all(torch.equal(x, y) for x, y in zip(a, b))
        print(f"pull: {tag}: two fresh pull engines after {PULL_RERUN_PASSES} passes: "
              f"bit-equal {bit_equal}")
        if not bit_equal:
            fail(f"pull: {tag}: every slot is strided, yet two pull engines differ")
        del pu2, a, b
    for _ in range(PULL_RERUN_PASSES if bit_equal is not None else 0, PULL_PASSES):
        step(pu)
    for _ in range(PULL_PASSES):
        step(sc)
    counts = launch_counts()
    if any(counts.values()):
        fail(f"pull: {tag}: the engines launched grid kernels: {counts}")
    lb_p, lb_s = pu.lower_bound(), sc.lower_bound()
    err, scale = state_diff(sc.state, pu.state)
    print(f"pull: {tag}: after {PULL_PASSES} anisotropic passes lb pull {lb_p:.6f}, scatter "
          f"{lb_s:.6f}, rel diff {rel(lb_p, lb_s):.3e} (limit 1e-5); max state diff {err:.3e} "
          f"(limit {1e-5 * scale:.3e})")
    if not (rel(lb_p, lb_s) <= 1e-5 and err <= 1e-5 * scale):
        fail(f"pull: {tag}: the pull pass differs from the scatter pass")
    engines = {"scatter": sc, "pull": pu}
    t = in_turns({k: (lambda e=e: step(e)) for k, e in engines.items()}, reps=3)
    host = {k: host_ms(lambda e=e: step(e), reps=3) for k, e in engines.items()}
    prof = {k: profile_pass(lambda e=e: step(e)) for k, e in engines.items()}
    te, he = eager_turns(engines, step)
    pool = {k: e.jit.stats()["pool_mb"] for k, e in engines.items()}
    if any(launch_counts().values()):
        fail(f"pull: {tag}: the engines launched grid kernels: {launch_counts()}")
    print(f"pull: {tag}: ms per pass captured scatter {t['scatter']:.3f} / pull {t['pull']:.3f} "
          f"(median of 3 in turns, CUDA events); eager {te['scatter']:.3f} / {te['pull']:.3f}; "
          f"host enqueue captured {host['scatter']:.3f} / {host['pull']:.3f}, eager "
          f"{he['scatter']:.3f} / {he['pull']:.3f} ms; kernels per pass {prof['scatter']['kernels']}"
          f" / {prof['pull']['kernels']}, device busy {prof['scatter']['busy_ms']:.3f} / "
          f"{prof['pull']['busy_ms']:.3f} ms; pool {pool['scatter']:.1f} / {pool['pull']:.1f} MB "
          f"on {card}")
    return {"factors": g.n_factors, "schedule_mode": pu.schedule_mode,
            "phases": len(pu.phases[Direction.forward]), **tot, "plan_s": pu.pull_plan_s,
            "build_s": pu_build, "scatter_build_s": sc_build, "bit_equal_reruns": bit_equal,
            "lb": lb_p, "lb_scatter": lb_s, "state_diff": err, "state_limit": 1e-5 * scale,
            **{f"{k}_ms": t[k] for k in t}, **{f"{k}_eager_ms": te[k] for k in te},
            **{f"{k}_host_ms": host[k] for k in host},
            **{f"{k}_eager_host_ms": he[k] for k in he},
            **{f"{k}_kernels": prof[k]["kernels"] for k in prof},
            **{f"{k}_busy_ms": prof[k]["busy_ms"] for k in prof},
            **{f"{k}_pool_mb": pool[k] for k in pool}}


def phase_pull(card: str, g_grid: FactorGraph, g_chain: FactorGraph, g_mc: FactorGraph) -> dict:
    """The structured pull pass (Engine(pull=True)) against the scatter pass
    on bench.py's generic grid (every slot strided), the engine grid (pairs
    in per-cell order: every slot gathers), the 100k chain,
    qap_32x32_3000quadratic and the multicut with its 500 triplets; then
    tomography_100x64, whose counting messages have no pull hooks: pull=True
    must raise, pull="auto" runs the scatter pass."""
    out = {"generic_grid": pull_model(f"generic grid {H}x{W}", generic_grid_graph(), card,
                                      schedule_mode="auto")}
    out["grid"] = pull_model(f"engine grid {H}x{W}", g_grid, card, schedule_mode="coloring")
    out["chain"] = pull_model(f"chain {CHAIN_N}", g_chain, card, schedule_mode="auto")
    g = FactorGraph()
    GraphMatchingConstructor(g, construction="left").construct(qap_input(32, 3000, seed=4))
    out["qap_32x32"] = pull_model("qap_32x32", g, card, schedule_mode="auto")
    out["multicut_150k"] = pull_model("multicut 149k + 500 triplets", g_mc, card,
                                      schedule_mode="coloring")
    g = FactorGraph()
    tomography_chains(DiscreteTomographyConstructor(g), 100, 64, 3, seed=5)
    try:
        Engine(g, schedule_mode="auto", device="cuda", dtype=torch.float32, pull=True)
    except ValueError as e:
        refused = str(e)
    else:
        fail("pull: tomography_100x64: pull=True built an engine without pull hooks")
    e = Engine(g, schedule_mode="auto", device="cuda", dtype=torch.float32, pull="auto")
    lb0 = e.lower_bound()
    e.compute_pass("anisotropic")
    lb1 = e.lower_bound()
    print(f"pull: tomography_100x64: pull=True refused ({refused}); pull='auto' runs the "
          f"scatter pass ({e.pull=}): lb {lb0:.6f} -> {lb1:.6f}")
    if "hooks" not in refused or e.pull or not lb1 >= lb0 - 1e-4 * abs(lb0):
        fail(f"pull: tomography_100x64: refusal {refused!r}, auto pull {e.pull}, lb {lb0} -> {lb1}")
    out["tomography_100x64"] = {"pull_true": refused, "auto_pull": e.pull, "lb": lb1}
    return out


def phase_checkpoint(card: str, e: Engine) -> dict:
    """A checkpoint of the 1000x1000, L=4 engine grid: save, 5 more passes,
    load: the bound and every state tensor as saved, bit for bit, and the
    saved primal's cost; then snapshot, one pass, restore: the bound as
    before.  The engine launches no hand-written kernel."""
    reset_launch_counts()
    prim = e.compute_pass_and_primal("damped_uniform", Direction.forward)
    cost = e.evaluate_primal(prim)
    lb0 = e.lower_bound()
    saved = snapshot(e)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "grid.npz")
        _, save_s = timed(lambda: save_checkpoint(path, e, best_primal=prim,
                                                  best_primal_cost=cost, iteration=1))
        mb = os.path.getsize(path) / 1e6
        for _ in range(CHECKPOINT_PASSES):
            e.compute_pass("anisotropic")
        lb_moved = e.lower_bound()
        (lprim, lcost, _), load_s = timed(lambda: load_checkpoint(path, e))
    lb1 = e.lower_bound()
    same = all(torch.equal(e.state[n][k], saved[n][k]) for n in saved for k in saved[n])
    lcost_eval = e.evaluate_primal(lprim)
    snap, snap_s = timed(lambda: snapshot(e))
    e.compute_pass("anisotropic")
    lb_pass = e.lower_bound()
    _, restore_s = timed(lambda: restore(e, snap))
    lb2 = e.lower_bound()
    counts = launch_counts()
    print(f"checkpoint: {e.n_factors} factors, {mb:.1f} MB npz; save {save_s:.3f} s, load "
          f"{load_s:.3f} s; bound saved {lb0!r}, after {CHECKPOINT_PASSES} passes {lb_moved!r}, "
          f"loaded {lb1!r}; state equal to the saved one: {same}; primal cost saved {cost!r}, "
          f"loaded {lcost!r}, evaluated {lcost_eval!r}")
    print(f"checkpoint: snapshot {snap_s * 1e3:.3f} ms, one pass to {lb_pass!r}, restore "
          f"{restore_s * 1e3:.3f} ms to {lb2!r}; kernel launches {counts} on {card}")
    if any(counts.values()):
        fail(f"checkpoint: the engine launched grid kernels: {counts}")
    if not (lb1 == lb0 and same and lcost == cost and lcost_eval == cost and lb2 == lb0):
        fail(f"checkpoint: bound {lb1} / {lb2} against {lb0}, state equal {same}, primal cost "
             f"{lcost} / {lcost_eval} against {cost}")
    return {"mb": mb, "save_s": save_s, "load_s": load_s, "snapshot_ms": snap_s * 1e3,
            "restore_ms": restore_s * 1e3, "lb": lb0, "lb_after_passes": lb_moved}


def uai_text(un, pairs, pw) -> str:
    """A unary and dense pairwise MRF as UAI MARKOV text (%.17g; each
    table column-major, the first scope variable fastest)."""
    n, labels = un.shape
    lines = ["MARKOV", str(n), " ".join([str(labels)] * n), str(n + len(pairs))]
    lines += [f"1 {v}" for v in range(n)] + [f"2 {i} {j}" for i, j in pairs]
    for u in un:
        lines += ["", str(labels), " ".join(f"{x:.17g}" for x in u)]
    for m in pw:
        lines += ["", str(m.size), " ".join(f"{x:.17g}" for x in m.ravel(order="F"))]
    return "\n".join(lines) + "\n"


def torresani_text(inp: GraphMatchingInput) -> str:
    lines = [f"p {inp.n_left} {inp.n_right} {len(inp.assignments)} {len(inp.edges)}"]
    lines += [f"a {k} {i} {j} {c:.17g}" for k, (i, j, c) in enumerate(inp.assignments)]
    lines += [f"e {a} {b} {c:.17g}" for a, b, c in inp.edges]
    return "\n".join(lines) + "\n"


def multicut_text(pairs, costs) -> str:
    return "".join(f"{i} {j} {c:.17g}\n" for (i, j), c in zip(pairs, costs))


def cli_inputs(d: str) -> dict:
    """The three instances of the cli phase as files in ``d``."""
    files = {"mrf": (os.path.join(d, "mrf_grid24.uai"), uai_text(*mrf_grid24_instance())),
             "gm": (os.path.join(d, "qap_16x16.txt"), torresani_text(qap_input(16, 600, seed=9))),
             "multicut": (os.path.join(d, "multicut_grid40.txt"),
                          multicut_text(*multicut_grid40_instance()))}
    for path, text in files.values():
        with open(path, "w") as f:
            f.write(text)
    return {k: path for k, (path, _) in files.items()}


def printed_bounds(out: str) -> tuple:
    """(lower, upper) bound of a cli run's output."""
    found = dict(re.findall(r"^(lower|upper) bound: (\S+)$", out, flags=re.M))
    return float(found["lower"]), float(found["upper"])


def run_cli(*args: str) -> tuple:
    """``python -m lp_mp_tpu_torch *args`` from this checkout, on the default
    device: (lower bound, upper bound, seconds)."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "lp_mp_tpu_torch", *args], capture_output=True,
                       text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    sec = time.perf_counter() - t
    if r.returncode != 0:
        fail(f"cli: {' '.join(args[:2])} exited {r.returncode}: {r.stderr[-2000:]}")
    return (*printed_bounds(r.stdout), sec)


def phase_cli(card: str) -> dict:
    """The three subcommands in subprocesses on the card: mrf_grid24 (its lb
    against the JAX cli's, its labels' cost on the host against the printed
    ub), qap_16x16 (lb against the JAX cli's) and multicut_grid40 with
    tightening and the sqlite visitor (one row per visited iteration, the
    last lowerBound the printed lb)."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        files = cli_inputs(d)
        labels_path = os.path.join(d, "labels.txt")
        lb, ub, sec = run_cli("mrf", files["mrf"], "--maxIter", str(CLI_MRF_ITERS), "-v", "0",
                              "--outputFile", labels_path)
        lab = np.loadtxt(labels_path, dtype=np.int64)
        un, pairs, pw = mrf_grid24_instance()
        host = float(un[np.arange(len(un)), lab].sum()
                     + pw[np.arange(len(pairs)), lab[pairs[:, 0]], lab[pairs[:, 1]]].sum())
        out["mrf"] = {"lb": lb, "ub": ub, "labels_cost": host, "n_labels": int(lab.size), "s": sec}
        print(f"cli: mrf {files['mrf']} --maxIter {CLI_MRF_ITERS} in {sec:.2f} s: lb {lb!r}, ub "
              f"{ub!r}; JAX cli lb {JAX_CLI['mrf_lb']!r} (rel diff {rel(lb, JAX_CLI['mrf_lb']):.3e}, "
              f"limit 1e-4); {lab.size} labels, their cost on the host {host!r} (rel diff to ub "
              f"{rel(host, ub):.3e}, limit 1e-4)")
        if not (rel(lb, JAX_CLI["mrf_lb"]) <= 1e-4 and lab.size == len(un)
                and rel(host, ub) <= 1e-4):
            fail(f"cli: mrf lb {lb}, ub {ub}, {lab.size} labels costing {host}")

        lb, ub, sec = run_cli("gm", files["gm"], "--construction", "left", "--maxIter",
                              str(CLI_GM_ITERS), "-v", "0")
        out["gm"] = {"lb": lb, "ub": ub, "s": sec}
        print(f"cli: gm qap_16x16 --construction left --maxIter {CLI_GM_ITERS} in {sec:.2f} s: lb "
              f"{lb!r}, ub {ub!r}; JAX cli lb {JAX_CLI['gm_lb']!r} (rel diff "
              f"{rel(lb, JAX_CLI['gm_lb']):.3e}, limit 1e-4)")
        if not (rel(lb, JAX_CLI["gm_lb"]) <= 1e-4 and ub >= lb):
            fail(f"cli: gm lb {lb}, ub {ub}")

        db = os.path.join(d, "bench.db")
        lb, ub, sec = run_cli("multicut", files["multicut"], "--maxIter", str(CLI_MC_ITERS),
                              "--tighten", "--tightenIteration", "10", "--tightenInterval", "10",
                              "--databaseFile", db, "--datasetName", "chip", "-v", "0")
        conn = sqlite3.connect(db)
        try:
            rows = conn.execute(
                "SELECT i.iteration, i.lowerBound FROM iterations i JOIN solvers s "
                "ON s.id = i.solver_id WHERE s.name = 'lp_mp_tpu_torch' ORDER BY i.iteration"
            ).fetchall()
        finally:
            conn.close()
        its = [it for it, _ in rows]
        db_lb = rows[-1][1] if rows else float("nan")
        out["multicut"] = {"lb": lb, "ub": ub, "db_rows": len(rows), "db_last_lb": db_lb, "s": sec}
        print(f"cli: multicut multicut_grid40 --maxIter {CLI_MC_ITERS} --tighten in {sec:.2f} s: lb "
              f"{lb!r}, ub {ub!r}; {len(rows)} iteration rows, last lowerBound {db_lb!r} (rel diff "
              f"to lb {rel(db_lb, lb):.3e}, limit 1e-6) on {card}")
        if not (rows and its == list(range(len(rows))) and len(rows) <= CLI_MC_ITERS
                and rel(db_lb, lb) <= 1e-6 and lb <= ub):
            fail(f"cli: multicut lb {lb}, ub {ub}, iteration rows {its}, last lowerBound {db_lb}")
    return out


def main() -> None:
    t0 = time.perf_counter()
    name, count, card = phase_device()
    phase_build()
    shapes = CHECK_SHAPES + WIDE_LABEL_SHAPES
    worst = check_grid_kernels("cuda", shapes=shapes, log=print)
    print(f"check: all launches within 1e-5*(1+max|x|), the round kernel bit-equal at each "
          f"geometry of {ROUND_GEOMETRIES}; max abs err {worst}")
    worst["phase_update_v1"] = check_phase_v1("cuda", shapes=shapes, log=print)
    worst.update(check_sharded_grid_kernels("cuda", shapes=shapes, log=print))
    print(f"check: all v1 and sharded launches within 1e-5*(1+max|x|), the sharded round kernel "
          f"bit-equal at each geometry; max abs err {worst}")
    worst["primal_cost"] = check_round_primal("cuda", shapes=shapes, log=print)
    worst["round_phase_update"] = 0.0       # bit-equal, or check_round_primal raised
    print(f"check: the rounding kernels in every mode: state bit-equal, labels equal, cost "
          f"within {COST_RTOL} relative; max rel err of the cost {worst['primal_cost']:.1e}")
    for k, err in check_replays("cuda", log=print).items():
        worst[k] = max(worst.get(k, 0.0), err)
    print(f"check: every kernel replayed in a CUDA graph within 1e-5*(1+max|x|) (the rounding "
          f"kernels as above); max abs err {worst}")
    dense = phase_main_path()
    counts = dict(dense["counts"])
    sharded = phase_sharded_path(dense)
    counts.update({k: sharded[k] for k in ("phase_update_sharded", "round_update_sharded")})
    counts["phase_update_v1"] = phase_v1_path()["phase_update_v1"]
    times, phase_kernels = phase_time(card)
    times.update(rounding_times(phase_kernels["rounding"]))
    kernels = [{"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
                "launches": counts[k], "max_abs_err": worst[k], **times[k]}
               for k in REPLACES]
    native_s = phase_native()
    ec, chain = phase_engine_chain()
    eg, m, g_grid, grid = phase_engine_grid()
    t, kernel_path_its = phase_engine_time(card, ec, eg, m)
    engine = {"chain": chain | t["chain"], "grid": grid | t["grid"],
              "grid_kernel_path_its": kernel_path_its, "native_build_s": native_s, "card": card}
    mc150k, g_mc = phase_multicut_150k(card)
    tightening = {"multicut_150k": mc150k, **phase_tightening_solvers(), "card": card}
    t1 = time.perf_counter()
    models = {**phase_model_solvers(), **phase_model_time(card), "card": card}
    models["phase_s"] = time.perf_counter() - t1
    print(f"models: graph matching and tomography phase {models['phase_s']:.1f} s")
    t1 = time.perf_counter()
    sharded_engine, sh_grid = phase_sharded_engine(card, g_grid, g_mc)
    sharded_engine.update(card=card, phase_s=time.perf_counter() - t1)
    t1 = time.perf_counter()
    checkpoint = {**phase_checkpoint(card, eg), "card": card}
    checkpoint["phase_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    trees, dec, lam = phase_trees(card)
    trees.update(card=card, phase_s=time.perf_counter() - t1)
    t1 = time.perf_counter()
    tree_solver_rec = {**phase_tree_solver(card, dec.chains), "card": card}
    tree_solver_rec["phase_s"] = time.perf_counter() - t1
    print(f"sharded_engine, trees, tree_solver: phases {sharded_engine['phase_s']:.1f}, "
          f"{trees['phase_s']:.1f}, {tree_solver_rec['phase_s']:.1f} s")
    t1 = time.perf_counter()
    jit = phase_jit(card, ec, eg, g_mc, sh_grid, dec, lam)
    jit.update(card=card, phase_s=time.perf_counter() - t1)
    print(f"jit: phase {jit['phase_s']:.1f} s")
    g_chain = ec.graph
    del eg, ec, sh_grid, dec
    t1 = time.perf_counter()
    pull = {**phase_pull(card, g_grid, g_chain, g_mc), "card": card}
    pull["phase_s"] = time.perf_counter() - t1
    print(f"pull: phase {pull['phase_s']:.1f} s")
    del g_grid, g_mc, g_chain
    t1 = time.perf_counter()
    oracles = {**phase_oracles(card), "card": card}
    oracles["phase_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    cli = {**phase_cli(card), "card": card}
    cli["phase_s"] = time.perf_counter() - t1
    print(f"checkpoint, oracles, cli: phases {checkpoint['phase_s']:.1f}, "
          f"{oracles['phase_s']:.1f}, {cli['phase_s']:.1f} s")
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"engine": engine}))
    print(json.dumps({"tightening": tightening}))
    print(json.dumps({"models": models}))
    print(json.dumps({"sharded_engine": sharded_engine}))
    print(json.dumps({"trees": trees}))
    print(json.dumps({"tree_solver": tree_solver_rec}))
    print(json.dumps({"checkpoint": checkpoint}))
    print(json.dumps({"oracles": oracles}))
    print(json.dumps({"cli": cli}))
    print(json.dumps({"jit": jit}))
    print(json.dumps({"pull": pull}))
    print(json.dumps({"phase_kernels": {**phase_kernels, "card": card}}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
