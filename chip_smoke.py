"""Checks of the PyTorch port (lp_mp_tpu_torch) on one NVIDIA GPU; it times nothing.

    python3 chip_smoke.py

Every check that fails raises and exits non-zero; without a CUDA device the
script exits non-zero at once.  The last two lines are {"kernels": [...]},
one entry per hand-written kernel wrapper (its source, the JAX package's
kernel it stands for, its launches on the main paths and its worst error
in the kernel checks), and {"ok": true, "device": {...}}.  The port's
rates are the benchmark's (benchmark/run.py), its kernels' times
``python3 -m lp_mp_tpu_torch.phase_bench``'s.

- Kernels: nvcc builds lp_mp_tpu_torch/csrc, and lp_mp_tpu_torch.kernel_check
  holds every CUDA kernel against its plain version: the dense, v1 and
  sharded (1-4 shards) phase kernels, also at more labels than the round
  kernels take; the round kernels, bit-equal at each geometry; the rounding
  kernels in every mode (state bit-equal, labels equal, cost within
  COST_RTOL); the bound kernel (within COST_RTOL, bit-equal across launches
  and replays, NaN in, NaN out); and each kernel replayed from a CUDA graph.
- Main paths on the 1000x1000, L=4 Potts grid, with the kernel launches
  (``tracing.counters()["launches"]``) held to the schedule's plus each
  graph's warm-up: GridPottsModel.run_fast(kernel="cuda") for 1500
  iterations against the JAX package's bound and the plain path, its
  bounds through the bound kernel (against the plain bound on its state);
  round_primal's kernels against the plain rounding and the JAX package's
  (JAX_ROUND); ShardedGridPotts at 1 and 4 shards on cuda:0 against the
  dense path; the uniform schedule through phase_update_v1.
- The generic engine in float32: the 100k-variable chain to 1e-4 of its
  exact optimum through Engine and Solver, the grid through the engine
  against the kernel path; one separation round on the 149101-edge
  multicut (the JAX package's 500 triplets, bound and GAEC bound) and the
  tightening Solver runs of mrf_grid24, multicut_grid40 and the frustrated
  4-cycle; tomography_10x32 and qap_16x16 through Solver against the JAX
  package's bounds, qap_32x32_3000quadratic's rounding and
  tomography_100chains_64vars_counting.
- ShardedEngine at 1 and 4 shards against the unsharded engine; the chain
  cover of the 304x304 MRF, its subgradient and FW-MAP bounds and the
  Solver's switch to trees against the JAX package's; a checkpoint and a
  snapshot restored bit for bit; the exact oracles (LP, ILP, combiLP) and
  ``python -m lp_mp_tpu_torch`` against the JAX package's.
- jit: every captured path with use_jit=False and True from one state, the
  states within 1e-5 (1 + max|x|) after 10 calls; the captured dense
  run_fast ends without a state copy.  pull: Engine(pull=True) against the
  scatter pass.

Only the grid model's paths launch the hand-written kernels: every other
phase checks that it launched none.  The JAX package's values are constants
below, taken on the CPU in float32 (tests/test_torch_model_constants.py
recomputes them).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
import re
import sqlite3
import subprocess
import sys
import tempfile

import numpy as np
import torch

from lp_mp_tpu_torch import (ChainDecomposition, Direction, DiscreteTomographyConstructor, Engine,
                             FactorGraph, GraphMatchingConstructor, GraphMatchingInput,
                             GridPottsModel, MrfConstructor, MulticutConstructor, ShardedEngine,
                             ShardedGridPotts, Solver, StandardTighteningVisitor, StandardVisitor,
                             TreeSpec, build_local_polytope, combi_lp, ilp_round, load_checkpoint,
                             native, random_grid, restore, save_checkpoint, snapshot,
                             solve_lp_relaxation, tracing)
from lp_mp_tpu_torch.capture import flatten
from lp_mp_tpu_torch.engine_pull import pull_stats
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, COST_RTOL, ROUND_GEOMETRIES, RTOL,
                                          WIDE_LABEL_SHAPES, check_grid_kernels, check_lower_bound,
                                          check_phase_v1, check_replays, check_round_primal,
                                          check_sharded_grid_kernels)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops.grid_kernels import phase_update_v1
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
SHARD_RUNS = (1, 4)            # shards of the sharded main path, all on cuda:0
SOURCE = "lp_mp_tpu_torch/csrc/grid_potts.cu"
# the JAX package's kernel (or plain ops) that each hand-written kernel wrapper stands for
REPLACES = {"round_update": "lp_mp_tpu/ops/pallas_grid.py:303",
            "phase_update": "lp_mp_tpu/ops/pallas_grid.py:161",
            "round_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:536",
            "phase_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:443",
            "phase_update_v1": "lp_mp_tpu/ops/pallas_grid.py:72",
            "round_phase_update": "none (jnp ops, lp_mp_tpu/models/grid_potts.py:297-317)",
            "primal_cost": "none (jnp ops, lp_mp_tpu/models/grid_potts.py:310-317)",
            "lower_bound": "none (jnp ops, lp_mp_tpu/models/grid_potts.py:291-295)"}
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
# schedule_mode="auto") on bench.py's solver_e2e instances, and the
# bench.py sizes; the JAX package's values on the CPU in float32 as above
# (tests/test_torch_model_constants.py recomputes them)
MODEL_ITERS = 60
JAX_TOMO10X32 = {"lb": -306.734375, "ub": -306.73443603515625, "schedule_mode": "coloring"}
JAX_QAP16 = {"lb": -26.722871780395508, "ub": -25.933637619018555,
             "rel_gap": 0.030432836803355522, "schedule_mode": "wavefront",
             "matching": [10, 11, 0, 14, 9, 1, 2, 3, 15, 6, 8, 5, 12, 4, 7, 13]}
# anisotropic passes of the bench.py-sized models before their rounding is checked
MODEL_PASSES = 15
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


def state_scale(state) -> float:
    return 1.0 + max(float(t.abs().max()) for t in state.values() if t.numel())


def launches() -> collections.Counter:
    """The kernel launches counted so far, by wrapper; ``launches() - before``
    holds those since ``before``."""
    return tracing.counters()["launches"]


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false: this script runs only "
                 "on a machine with an NVIDIA GPU")
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    print(f"device: {name} count={count} torch={torch.__version__} cuda={torch.version.cuda}")
    return name, count


def phase_build() -> None:
    build = _cuda_build.build(force=True)
    print(f"build: nvcc {' '.join(_cuda_build.NVCC_FLAGS)} -> {build.path.name}")
    for line in build.log.splitlines():
        if "ptxas" in line or "spill" in line:
            print(f"build: {line.strip()}")
    _cuda_build.library()


def phase_kernel_checks() -> dict:
    """Every kernel against its plain version.  Returns the worst error of
    each wrapper: absolute, relative for primal_cost and lower_bound."""
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
    worst["lower_bound"] = check_lower_bound("cuda", shapes=shapes, log=print)
    print(f"check: the bound kernel within {COST_RTOL} relative, bit-equal across launches and "
          f"replays, NaN in each state array propagating; max rel err "
          f"{worst['lower_bound']:.1e}")
    for k, err in check_replays("cuda", log=print).items():
        worst[k] = max(worst.get(k, 0.0), err)
    print(f"check: every kernel replayed in a CUDA graph within 1e-5*(1+max|x|) (the rounding "
          f"kernels as above); max abs err {worst}")
    return worst


def with_warmups(schedule: dict, records) -> collections.Counter:
    """The launches a schedule of graph replays implies, plus the one
    warm-up run of each graph whose capture ``records`` holds (a
    ``capture.Graphs``'s ``records``): a warm-up launches the kernels that
    its capture records."""
    out = collections.Counter(schedule)
    for rec in records:
        out.update(rec.launches)
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
    """The dense main path.  Returns its launches (the rounding's
    included), its state after the 1500 iterations (before rounding), its
    bound and its rounded primal."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    m = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    before = launches()
    prev = m.lower_bound()
    for chunk in range(1, CHUNKS + 1):
        m.run_fast(CHUNK_ITERS, kernel="cuda")
        lb = m.lower_bound()
        print(f"main: cuda run_fast({CHUNK_ITERS}) chunk {chunk:2d}: lower bound {lb:.6f}")
        if lb < prev - 1e-4 * abs(prev):
            fail(f"lower bound dropped from {prev} to {lb} in chunk {chunk}")
        prev = lb
    counts = launches() - before
    per_call = {"phase_update": 1, "round_update": CHUNK_ITERS // 2 + CHUNK_ITERS % 2}
    schedule = {k: CHUNKS * v for k, v in per_call.items()}
    schedule["lower_bound"] = 2 * (CHUNKS + 1)
    expect = with_warmups(schedule, m.jit.records)
    print(f"main: launches {dict(counts)}, schedule implies {dict(expect)} ({CHUNKS} replays of "
          f"the captured run_fast({CHUNK_ITERS}), {CHUNKS + 1} of the captured bound, and their "
          f"warm-ups)")
    if counts != expect:
        fail(f"launch counts {dict(counts)} differ from the schedule's {dict(expect)}")
    lb_cuda = prev
    lb_plain = float(m._lower_bound_impl(m.state))
    print(f"main: bound kernel {lb_cuda!r}, plain bound of the same state {lb_plain!r}, rel diff "
          f"{rel(lb_cuda, lb_plain):.1e} (limit {COST_RTOL})")
    if not rel(lb_cuda, lb_plain) <= COST_RTOL:
        fail(f"the bound kernel's {lb_cuda} and the plain bound's {lb_plain} disagree")
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
    before = launches()
    x, ub = m.round_primal()
    round_counts = launches() - before
    expect = with_warmups(ROUND_LAUNCHES, m.jit.records[n_graphs:])
    print(f"main: round_primal launches {dict(round_counts)}, one replay of the captured "
          f"rounding and its warm-up imply {dict(expect)}")
    if round_counts != expect:
        fail(f"round_primal launches {dict(round_counts)} differ from the kernels' "
             f"{dict(expect)}")
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
    return {"launches": counts + round_counts, "state": state, "lb": lb_cuda, "x": x, "ub": ub}


def phase_sharded_path(dense: dict) -> collections.Counter:
    """ShardedGridPotts.run_fast on the main grid at each of SHARD_RUNS
    shards (all on cuda:0), held against the dense kernel path.  Returns the
    launches of those runs."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    total = collections.Counter()
    for n in SHARD_RUNS:
        sm = ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * n, dtype=torch.float32)
        prev = sm.lower_bound()
        before = launches()
        for chunk in range(1, CHUNKS + 1):
            sm.run_fast(CHUNK_ITERS)
            lb = sm.lower_bound()
            if lb < prev - 1e-4 * abs(prev):
                fail(f"{n} shards: lower bound dropped from {prev} to {lb} in chunk {chunk}")
            prev = lb
        counts = launches() - before
        per_call = {"phase_update_sharded": 1,
                    "round_update_sharded": CHUNK_ITERS // 2 + CHUNK_ITERS % 2}
        expect = with_warmups({k: n * CHUNKS * v for k, v in per_call.items()}, sm.jit.records)
        print(f"sharded: {n} shards (Hl={sm.layout.Hl}): bound after {CHUNKS} x "
              f"run_fast({CHUNK_ITERS}) {prev:.6f}, rel diff to JAX {rel(prev, JAX_TARGET_LB):.3e} "
              f"(limit 1e-4), to the dense kernel path {rel(prev, dense['lb']):.3e}")
        print(f"sharded: {n} shards: launches {dict(counts)}, schedule implies {dict(expect)}")
        if counts != expect:
            fail(f"{n} shards: launch counts {dict(counts)} differ from the schedule's "
                 f"{dict(expect)}")
        if not rel(prev, JAX_TARGET_LB) <= 1e-4:
            fail(f"{n} shards: bound {prev} is not within 1e-4 relative of {JAX_TARGET_LB}")
        ds = sm.dense_state()
        err, tol = max_state_err(ds, dense["state"]), RTOL * state_scale(dense["state"])
        print(f"sharded: {n} shards: max state diff to the dense kernel path {err:.3e} "
              f"(limit {tol:.3e})")
        if not err <= tol:
            fail(f"{n} shards: dense_state() differs from the dense kernel path by {err}")
        total += counts

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


def phase_v1_path() -> collections.Counter:
    """The uniform schedule (10 iterations) through phase_update_v1's int32
    contract, against the dense kernel path.  Returns its launches."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    mk = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    s = mk.state
    before = launches()
    for _ in range(10):
        for p in ((1, 1, 0), (2, 2, 0), (2, 2, 0), (1, 1, 0)):
            s = phase_update_v1(torch.tensor(p, dtype=torch.int32), s, mk.hc, mk.vc)
    counts = launches() - before
    mk.run_fast(10, "uniform", kernel="cuda")
    err = max_state_err(s, mk.state)
    print(f"v1: uniform schedule through phase_update_v1: launches {dict(counts)}, max state "
          f"diff to the dense kernel path {err:.3e}")
    if counts["phase_update_v1"] != 40 or not err <= RTOL * state_scale(mk.state):
        fail("the v1 path disagrees with the dense kernel path or missed its launches")
    return counts


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


def cuda_engine(g: FactorGraph, **kw) -> Engine:
    return Engine(g, device="cuda", dtype=torch.float32, **kw)


def phase_native() -> None:
    """The host schedule at a million factors needs the native library:
    its pure-Python fallbacks would outlast the run."""
    if native.get_lib() is None:
        fail("the native host library (csrc/lpmp_host.cpp, g++) did not build or load")
    print("native: liblpmp_host.so ready")


def phase_engine_chain() -> Engine:
    """The chain through Engine(schedule_mode="auto") and through Solver."""
    un, pw = chain_instance(CHAIN_N, CHAIN_L, CHAIN_SEED)
    opt = chain_optimum(un, pw)
    print(f"chain: n={CHAIN_N} L={CHAIN_L} seed={CHAIN_SEED}: exact optimum {opt!r} "
          f"(min-plus reduction), recorded {CHAIN_OPT!r}")
    if not rel(opt, CHAIN_OPT) <= 1e-12:
        fail(f"chain optimum {opt} differs from the recorded {CHAIN_OPT}")
    g = FactorGraph()
    build_chain(MrfConstructor(g), un, pw)
    e = cuda_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"chain: {g.n_factors} factors, schedule_mode=auto chose {e.schedule_mode!r}, "
          f"phases {nph}")
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
    lb = s.solve()
    ub = s.primal_cost()
    ev = s.engine.evaluate_primal(s.best_primal)
    print(f"chain: Solver + StandardVisitor(max_iter=200): lb {lb:.6f}, ub {ub:.6f}, "
          f"evaluate_primal {ev:.6f}; gap to the optimum: lb {(opt - lb) / scale:.3e}, ub "
          f"{(ub - opt) / scale:.3e}")
    if not (np.isfinite(ev) and np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)):
        fail(f"Solver: ub {ub} (evaluate_primal {ev}) is not a feasible primal above lb {lb}")
    return e


def phase_engine_grid() -> tuple:
    """The main grid through the generic engine (Potts pairs batch-built in
    the per-cell order of tests/test_grid.py), held against GridPottsModel's
    kernel path on the card.  The engine launches no hand-written kernel.
    Returns the engine and its graph."""
    u, hc, vc = random_grid(H, W, L, seed=SEED)
    g = FactorGraph()
    ctor = MrfConstructor(g)
    ctor.add_unary_factors(u.reshape(H * W, L))
    pairs, diffs = grid_potts_edges(hc, vc)
    ctor.add_potts_factors(pairs, L, diffs)
    e = cuda_engine(g, schedule_mode="coloring")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"engine grid: {H}x{W} L={L}: {g.n_factors} factors, phases {nph}")
    before = launches()
    for _ in range(ENGINE_GRID_PASSES):
        e.compute_pass("anisotropic")
    lb_e = e.lower_bound()
    counts = launches() - before
    print(f"engine grid: bound after {ENGINE_GRID_PASSES} anisotropic passes {lb_e:.6f}; "
          f"hand-written kernel launches in them {dict(counts)}")
    if counts:
        fail(f"the generic engine launched grid kernels: {dict(counts)}")

    m = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    before = launches()
    m.run_fast(ENGINE_GRID_PASSES, kernel="cuda")
    lb_k = m.lower_bound()
    counts = launches() - before
    expect = with_warmups({"phase_update": 1, "round_update": ENGINE_GRID_PASSES // 2,
                           "lower_bound": 2}, m.jit.records)
    if counts != expect:
        fail(f"GridPottsModel kernel path launches {dict(counts)} differ from the schedule's "
             f"{dict(expect)}")
    mi = GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)
    mi.iterate("anisotropic", ENGINE_GRID_PASSES)
    lb_i = mi.lower_bound()
    print(f"engine grid: GridPottsModel after {ENGINE_GRID_PASSES} iterations: kernel path "
          f"{lb_k:.6f} (launches {dict(counts)}), iterate {lb_i:.6f}; engine rel diff "
          f"{rel(lb_e, lb_k):.3e} to the kernel path, {rel(lb_e, lb_i):.3e} to iterate "
          f"(limit 1e-5)")
    if not (rel(lb_e, lb_k) <= 1e-5 and rel(lb_e, lb_i) <= 1e-5):
        fail(f"generic engine bound {lb_e} disagrees with GridPottsModel ({lb_k}, {lb_i})")
    return e, g


def phase_multicut_150k() -> FactorGraph:
    """bench.py's multicut: one separation round on a fresh engine, a
    rebuild, 100 anisotropic passes and GAEC, against the JAX package.
    Returns the graph with its triplets."""
    pairs, costs = multicut_150k_instance()
    s = Solver(device="cuda", dtype=torch.float32)
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    eng = cuda_engine(s.graph, schedule_mode="auto")
    n = mc.tighten(eng, max_constraints=500, max_candidates=2000)
    digest = triplet_digest(mc.triplets)
    print(f"multicut 150k: {len(pairs)} edges ({eng.schedule_mode}); tighten round: {n} added, "
          f"{len(mc.triplets)} triplets, {len(mc.edges)} edges, digest {digest}; JAX package "
          f"{JAX_MC150K}")
    got = {"triplets_added": n, "n_triplets": len(mc.triplets), "n_edges": len(mc.edges),
           "digest": digest}
    if any(got[k] != JAX_MC150K[k] for k in got):
        fail(f"the separation round differs from the JAX package's: {got}")
    eng = cuda_engine(s.graph, schedule_mode="auto")
    before = launches()
    prev = eng.lower_bound()
    for i in range(1, MC150K_PASSES + 1):
        eng.compute_pass("anisotropic")
        if i % 25 == 0:
            lb = eng.lower_bound()
            print(f"multicut 150k: {i:3d} passes: lower bound {lb:.6f}")
            if lb < prev - 1e-4 * abs(prev):
                fail(f"multicut bound dropped from {prev} to {lb}")
            prev = lb
    if launches() - before:
        fail(f"the multicut engine launched grid kernels: {dict(launches() - before)}")
    _, _, ub = mc.round_gaec()
    print(f"multicut 150k: after {MC150K_PASSES} passes lb {prev:.6f}, JAX package "
          f"{JAX_MC150K['lb']}, rel diff {rel(prev, JAX_MC150K['lb']):.3e} (limit 1e-4); GAEC ub "
          f"{ub!r}, JAX package {JAX_MC150K['gaec_ub']!r}")
    if not rel(prev, JAX_MC150K["lb"]) <= 1e-4:
        fail(f"multicut bound {prev} is not within 1e-4 of the JAX package's")
    if not abs(ub - JAX_MC150K["gaec_ub"]) <= 1e-9:
        fail(f"GAEC ub {ub} differs from the JAX package's {JAX_MC150K['gaec_ub']}")
    return s.graph


def solver_run(tag: str, s: Solver, ctor) -> dict:
    """``s.solve()``, which launches no hand-written kernel: the generic
    engine and tightening use plain PyTorch."""
    before = launches()
    lb = s.solve()
    if launches() - before:
        fail(f"{tag}: the Solver run launched grid kernels: {dict(launches() - before)}")
    ub = s.primal_cost()
    gap = (ub - lb) / max(1.0, abs(ub))
    n_trip = len(getattr(ctor, "triplets", ()))
    print(f"{tag}: Solver.solve(): lb {lb:.6f}, ub {ub:.6f}, rel gap {gap:.3e}, "
          f"{s.n_engine_builds} engine builds, aux.n {s.aux.n}, {n_trip} triplets")
    return {"lb": lb, "ub": ub, "rel_gap": gap}


def phase_tightening_solvers() -> None:
    """The tightening Solver runs of bench.py's solver_e2e, and the
    frustrated 4-cycle of tests/test_cycle_separation.py."""
    vk, sk = MRF_GRID24_SOLVER
    un, pairs, pw = mrf_grid24_instance()
    s = Solver(visitor=StandardTighteningVisitor(**vk), device="cuda", dtype=torch.float32, **sk)
    mrf = s.add_constructor(MrfConstructor)
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    r = solver_run("mrf_grid24", s, mrf)
    print(f"mrf_grid24: JAX package {JAX_GRID24}; lb rel diff {rel(r['lb'], JAX_GRID24['lb']):.3e} "
          f"(limit 1e-4), rel gap limit 1e-4")
    if not (rel(r["lb"], JAX_GRID24["lb"]) <= 1e-4 and r["rel_gap"] <= 1e-4):
        fail(f"mrf_grid24: lb {r['lb']}, gap {r['rel_gap']}")

    vk, sk = MULTICUT_GRID40_SOLVER
    pairs, costs = multicut_grid40_instance()
    s = Solver(visitor=StandardTighteningVisitor(**vk), device="cuda", dtype=torch.float32, **sk)
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    r = solver_run("multicut_grid40", s, mc)
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
    r = solver_run("frustrated 4-cycle", s, mrf)
    if not abs(r["lb"] - 1.0) <= 1e-5:
        fail(f"frustrated 4-cycle: lb {r['lb']}, not 1.0")


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


def phase_model_solvers() -> None:
    """tomography_10x32 and qap_16x16 of bench.py's solver_e2e through
    Solver on the card, against the JAX package's float32 CPU values."""
    s, dt = model_solver(DiscreteTomographyConstructor)
    tomography_chains(dt, 10, 32, 3, seed=10)
    r = solver_run("tomography_10x32", s, dt)
    print(f"tomography_10x32: JAX package {JAX_TOMO10X32}; {s.engine.schedule_mode} schedule; "
          f"lb rel diff {rel(r['lb'], JAX_TOMO10X32['lb']):.3e} (limit 1e-4), ub - lb "
          f"{r['ub'] - r['lb']:.3e} (limit 1e-4 |lb|)")
    if not (rel(r["lb"], JAX_TOMO10X32["lb"]) <= 1e-4 and r["ub"] - r["lb"] <= 1e-4 * abs(r["lb"])):
        fail(f"tomography_10x32: lb {r['lb']}, ub {r['ub']}")

    s, gm = model_solver(GraphMatchingConstructor, construction="left")
    gm.construct(qap_input(16, 600, seed=9))
    r = solver_run("qap_16x16", s, gm)
    same = bool((gm.matching(s.engine, s.best_primal) == np.asarray(JAX_QAP16["matching"])).all())
    print(f"qap_16x16: JAX package lb {JAX_QAP16['lb']}, ub {JAX_QAP16['ub']}, rel gap "
          f"{JAX_QAP16['rel_gap']:.3e}; {s.engine.schedule_mode} schedule; lb rel diff "
          f"{rel(r['lb'], JAX_QAP16['lb']):.3e} (limit 1e-4), rel gap limit "
          f"{JAX_QAP16['rel_gap'] + 1e-3:.3e}; matching equal to the JAX package's: {same}")
    if not (rel(r["lb"], JAX_QAP16["lb"]) <= 1e-4 and r["ub"] >= r["lb"]
            and r["rel_gap"] <= JAX_QAP16["rel_gap"] + 1e-3):
        fail(f"qap_16x16: lb {r['lb']}, ub {r['ub']}, rel gap {r['rel_gap']}")


def engine_passes(tag: str, e: Engine) -> None:
    """MODEL_PASSES anisotropic passes of ``e``, which launch no hand-written
    kernel."""
    before = launches()
    for _ in range(MODEL_PASSES):
        e.compute_pass("anisotropic")
    if launches() - before:
        fail(f"{tag}: the engine launched grid kernels: {dict(launches() - before)}")


def phase_model_engines() -> None:
    """qap_32x32_3000quadratic and tomography_100chains_64vars_counting of
    bench.py on the card: engine passes, then for the matching the rounding
    of compute_primal (min-cost flow on the unary block, the 2-opt polish of
    its matching and of the greedy start), for the tomography one forward
    pass with rounding."""
    g = FactorGraph()
    gm = GraphMatchingConstructor(g, construction="left")
    gm.construct(qap_input(32, 3000, seed=4))
    e = cuda_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"qap_32x32: {g.n_factors} factors, {len(gm.inp.edges)} quadratic terms "
          f"({e.schedule_mode}, phases {nph})")
    engine_passes("qap_32x32", e)
    lb = e.lower_bound()
    match = solve_assignment(*gm._left_unary_costs(e))
    cands = [gm.improve_matching(match), gm.improve_matching(gm._greedy_matching())]
    best = min(cands, key=gm._matching_cost)
    prim = gm.compute_primal(e)
    ub = e.evaluate_primal(prim)
    print(f"qap_32x32: after {MODEL_PASSES} passes lb {lb:.6f}; ub {ub:.6f}, rel gap "
          f"{(ub - lb) / max(1.0, abs(ub)):.3e}")
    if not (np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)
            and (gm.matching(e, prim) == best).all()):
        fail(f"qap_32x32: ub {ub}, lb {lb}, or compute_primal's matching is not the rounded one")

    g = FactorGraph()
    tomography_chains(DiscreteTomographyConstructor(g), 100, 64, 3, seed=5)
    e = cuda_engine(g, schedule_mode="auto")
    nph = {d.value: len(p) for d, p in e.phases.items()}
    print(f"tomography_100x64: {g.n_factors} factors ({e.schedule_mode}, phases {nph})")
    if e.schedule_mode != "coloring":
        fail(f"tomography_100x64: auto chose {e.schedule_mode}")
    engine_passes("tomography_100x64", e)
    prim = e.compute_pass_and_primal("anisotropic", Direction.forward)
    ub, lb = e.evaluate_primal(prim), e.lower_bound()
    print(f"tomography_100x64: lb {lb:.6f}; one forward pass with rounding: ub {ub:.6f}")
    if not (np.isfinite(lb) and np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)):
        fail(f"tomography_100x64: lb {lb}, ub {ub}")


def state_diff(a: dict, b: dict) -> tuple:
    """(max |a - b| over the float lanes of two dual states, 1 + max |a|)."""
    err, scale = 0.0, 1.0
    for t, blk in a.items():
        for k, v in blk.items():
            if v.is_floating_point() and v.numel():
                err = max(err, float((v - b[t][k]).abs().max()))
                scale = max(scale, 1.0 + float(v.abs().max()))
    return err, scale


def sharded_engine(g: FactorGraph, n: int, **kw) -> ShardedEngine:
    return ShardedEngine(g, devices=["cuda:0"] * n, dtype=torch.float32, **kw)


def phase_sharded_engine(g_grid: FactorGraph, g_mc: FactorGraph) -> ShardedEngine:
    """ShardedEngine on the 1000x1000 grid at 1 and 4 shards on cuda:0 and
    on the 149101-edge multicut with its 500 triplets at 4 shards, each
    held against a fresh unsharded Engine after the same passes.  Neither
    launches a hand-written kernel.  Returns the 4-shard grid engine."""
    ref = cuda_engine(g_grid, schedule_mode="coloring")
    before = launches()
    for _ in range(SHARDED_PASSES):
        ref.compute_pass("anisotropic")
    lb_ref = ref.lower_bound()
    ref_state = ref.get_state()
    shards = {}
    for n in SHARD_RUNS:
        sh = sharded_engine(g_grid, n)
        for _ in range(SHARDED_PASSES):
            sh.compute_pass("anisotropic")
        lb = sh.lower_bound()
        err, scale = state_diff(ref_state, sh.state)
        print(f"sharded_engine: grid {H}x{W} L={L}, {n} shards on cuda:0: after {SHARDED_PASSES} "
              f"anisotropic passes lb {lb:.6f}, unsharded {lb_ref:.6f}, rel diff "
              f"{rel(lb, lb_ref):.3e} (limit 1e-6), max state diff {err:.3e} (limit "
              f"{1e-5 * scale:.3e})")
        if not (rel(lb, lb_ref) <= 1e-6 and err <= 1e-5 * scale):
            fail(f"grid, {n} shards: ShardedEngine differs from the unsharded engine")
        shards[n] = sh
    if launches() - before:
        fail(f"the sharded engine launched grid kernels: {dict(launches() - before)}")
    del ref, ref_state
    sh = grid_sh = shards[SHARD_RUNS[-1]]
    lb = sh.lower_bound()
    prim = sh.compute_pass_and_primal("damped_uniform", Direction.forward)
    ub = sh.evaluate_primal(prim)
    ok = sh.check_primal_consistency(prim)
    print(f"sharded_engine: grid {SHARD_RUNS[-1]} shards: compute_pass_and_primal + evaluate: "
          f"consistent {ok}, ub {ub:.6f} >= lb {lb:.6f} - 1e-4|lb|")
    if not (ok and np.isfinite(ub) and ub >= lb - 1e-4 * abs(lb)):
        fail(f"grid sharded primal: consistent {ok}, ub {ub}, lb {lb}")
    del shards, prim

    ref = cuda_engine(g_mc, schedule_mode="coloring")
    n = SHARD_RUNS[-1]
    sh = sharded_engine(g_mc, n)
    before = launches()
    for _ in range(SHARDED_PASSES):
        ref.compute_pass("anisotropic")
        sh.compute_pass("anisotropic")
    if launches() - before:
        fail(f"the sharded multicut engine launched grid kernels: {dict(launches() - before)}")
    lb, lb_ref = sh.lower_bound(), ref.lower_bound()
    print(f"sharded_engine: multicut 150k + 500 triplets, {n} shards: after {SHARDED_PASSES} "
          f"passes lb {lb:.6f}, unsharded {lb_ref:.6f}, rel diff {rel(lb, lb_ref):.3e} (limit "
          f"1e-5)")
    if not rel(lb, lb_ref) <= 1e-5:
        fail(f"multicut, {n} shards: bound {lb} differs from the unsharded {lb_ref}")
    return grid_sh


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


def phase_trees() -> tuple:
    """ChainDecomposition of mrf_304x304 on the card: the cover against
    the JAX package's, subgradient ascent and FW-MAP against its float32 CPU
    bounds, the majority-vote labelling, the write-back into an Engine.
    Returns the decomposition and subgradient ascent's multipliers."""
    g, mrf, (un, pairs, pw) = mrf_304()
    dec = ChainDecomposition.from_mrf(mrf, device="cuda", dtype=torch.float32)
    T, V, _ = dec.unary.shape
    digest = chains_digest(dec.chains)
    print(f"trees: mrf_{TREE_SIDE}x{TREE_SIDE} L={TREE_L}: chain cover T={T}, V={V}, digest "
          f"{digest}; JAX package {JAX_TREES['T']}, {JAX_TREES['V']}, {JAX_TREES['digest']}")
    if (T, V, digest) != (JAX_TREES["T"], JAX_TREES["V"], JAX_TREES["digest"]):
        fail("the chain cover differs from the JAX package's")
    before = launches()
    sg, lam, _ = dec.subgradient_ascent(n_iter=50)
    fw, _, _ = dec.fw_map(n_outer=5, n_inner=10)
    if launches() - before:
        fail(f"the tree solves launched grid kernels: {dict(launches() - before)}")
    # FW-MAP's line search sums 10^7 float32 terms; the JAX package rounds
    # them in float32 and the port accumulates them in float64, and after 50
    # steps the bound follows that rounding (PERF.md §6): the port's
    # bound must reach the JAX package's, less 1e-4 relative
    print(f"trees: subgradient_ascent(50) {sg:.6f}, JAX package {JAX_TREES['sg']} (rel diff "
          f"{rel(sg, JAX_TREES['sg']):.3e}, limit 1e-4); fw_map(5, 10) {fw:.6f}, JAX package "
          f"{JAX_TREES['fw']} (rel diff {(fw - JAX_TREES['fw']) / abs(JAX_TREES['fw']):+.3e}, "
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
    return dec, lam


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


def phase_tree_solver(chains) -> None:
    s = tree_solver(chains)
    before = launches()
    lb = s.solve()
    if launches() - before:
        fail(f"the tree Solver launched grid kernels: {dict(launches() - before)}")
    lb_e = s.engine.lower_bound()
    dec = s._tree_state["dec"]
    print(f"tree_solver: Solver(max_iter={TREE_SOLVER_ITERS}, tree_decomposition_begin="
          f"{TREE_SOLVER_BEGIN}, zero_sum) on mrf_{TREE_SIDE}x{TREE_SIDE}: {dec.n_trees} trees, "
          f"depth {dec.max_depth}, {s._tree_state['k']} tree steps; lb {lb:.6f}, JAX package "
          f"{JAX_TREE_SOLVER['lb']} (rel diff {rel(lb, JAX_TREE_SOLVER['lb']):.3e}, limit 1e-4); "
          f"engine bound after write-back {lb_e:.6f}; ub {s.primal_cost():.6f}")
    if not (rel(lb, JAX_TREE_SOLVER["lb"]) <= 1e-4 and lb_e >= lb - 1e-4 * abs(lb)):
        fail(f"tree_solver: lb {lb}, engine bound {lb_e}")


def mrf_grid24_solver(visitor, **kw) -> tuple:
    un, pairs, pw = mrf_grid24_instance()
    s = Solver(visitor=visitor, device="cuda", dtype=torch.float32, **kw)
    mrf = s.add_constructor(MrfConstructor)
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    return s, mrf


def phase_oracles() -> None:
    """The exact oracles on mrf_grid24 after 50 untightened Solver
    iterations on the card: the local polytope's size and LP value (which
    no reparametrization changes, so it is held to the JAX package's), the
    ILP (the round-5 optimum), combiLP against the ILP, and a Solver with
    exact_rounding="ilp".  They run on the host (HiGHS); the engine's state
    goes to the host once per oracle call."""
    s, mrf = mrf_grid24_solver(StandardVisitor(max_iter=ORACLE_ITERS))
    lb = solver_run("oracles: mrf_grid24", s, mrf)["lb"]
    before = launches()
    cost, rows, _, _ = build_local_polytope(s.engine)
    lp = solve_lp_relaxation(s.engine)
    prim, ilp = ilp_round(s.engine, time_limit=ORACLE_ILP_LIMIT)
    cprim, combi = combi_lp(s.engine)
    if launches() - before:
        fail(f"oracles: the exact oracles launched grid kernels: {dict(launches() - before)}")
    print(f"oracles: local polytope {len(cost)} variables, {len(rows)} rows (JAX package "
          f"{JAX_ORACLES['n_vars']}, {JAX_ORACLES['n_rows']}); LP {lp:.6f} (JAX package "
          f"{JAX_ORACLES['lp']}, rel diff {rel(lp, JAX_ORACLES['lp']):.3e}, limit 1e-5; lb "
          f"{lb:.6f})")
    print(f"oracles: ilp_round {ilp:.6f} (JAX package {JAX_ORACLES['ilp']}, rel diff "
          f"{rel(ilp, JAX_ORACLES['ilp']):.3e}, limit 1e-5); combi_lp {combi:.6f} (rel diff to "
          f"the ILP {rel(combi, ilp):.3e}, limit 1e-5)")
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
    r = solver_run("oracles: Solver(exact_rounding='ilp')", s, mrf)
    print(f"oracles: Solver(exact_rounding='ilp') ub rel diff to the ILP {rel(r['ub'], ilp):.3e} "
          f"(limit 1e-5), lb <= ub: {r['lb'] <= r['ub']}")
    if not (rel(r["ub"], ilp) <= 1e-5 and r["lb"] <= r["ub"]):
        fail(f"oracles: Solver(exact_rounding='ilp') lb {r['lb']}, ub {r['ub']}, ILP {ilp}")


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


def jit_path(tag: str, eager, graphed, step, read, bound, bound_tol: float = 1e-6) -> None:
    """One path of the jit phase: ``eager`` (use_jit=False) and ``graphed``
    (use_jit=True) start from the same state; after JIT_PASSES calls of
    ``step`` each, the captured state (``read``) must lie within
    1e-5 (1 + max|x|) of the eager one and its ``bound`` within
    ``bound_tol`` relative."""
    for _ in range(JIT_PASSES):
        step(eager)
        step(graphed)
    err, scale = tree_diff(read(graphed), read(eager))
    b_jit, b_eager = bound(graphed), bound(eager)
    print(f"jit: {tag}: {graphed.jit.stats()['graphs']} graphs; after {JIT_PASSES} calls state "
          f"diff {err:.3e} (limit {1e-5 * scale:.3e}), bound {b_jit:.6f} vs {b_eager:.6f} (rel "
          f"{rel(b_jit, b_eager):.3e}, limit {bound_tol})")
    if not (err <= 1e-5 * scale and rel(b_jit, b_eager) <= bound_tol):
        fail(f"jit: {tag}: the captured path differs from the eager one after {JIT_PASSES} "
             f"calls: state {err:.3e} (limit {1e-5 * scale:.3e}), bound {b_jit} against "
             f"{b_eager} (limit {bound_tol} relative)")


def phase_jit(ec: Engine, eg: Engine, g_mc: FactorGraph, sh_grid: ShardedEngine,
              dec: ChainDecomposition, lam: torch.Tensor) -> None:
    """use_jit=False against use_jit=True on every path the port captures,
    at the sizes of the phases above; the captured objects of those phases
    are reused where a build takes seconds, their eager twins given the
    same state."""
    f32 = dict(device="cuda", dtype=torch.float32)

    def engine_pair(graph, graphed=None, **kw):
        eager = Engine(graph, use_jit=False, **f32, **kw)
        if graphed is None:
            graphed = Engine(graph, **f32, **kw)
        else:
            eager.set_state(graphed.get_state())
        return eager, graphed

    def engine_path(tag, pair, bound_tol=1e-6):
        jit_path(tag, *pair, lambda e: e.compute_pass("anisotropic"), lambda e: e.state,
                 lambda e: e.lower_bound(), bound_tol)

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
    eager = sharded_engine(eg.graph, n, use_jit=False)
    eager.set_state(sh_grid.state)
    engine_path(f"sharded engine grid, {n} shards", (eager, sh_grid))
    engine_path(f"sharded engine multicut, {n} shards",
                tuple(sharded_engine(g_mc, n, use_jit=j) for j in (False, True)), bound_tol=1e-5)
    del eager

    jit_path(f"chain decomposition solve {TREE_SIDE}x{TREE_SIDE}",
             dataclasses.replace(dec, use_jit=False), dec, lambda d: d.solve(lam),
             lambda d: d.solve(lam)[0],
             lambda d: float(torch.sum(d.solve(lam)[0], dtype=torch.float64)))

    u, hc, vc = random_grid(H, W, L, seed=SEED)
    n_fast = 20
    for k in SHARD_RUNS:
        eager, graphed = (ShardedGridPotts(u, hc, vc, devices=["cuda:0"] * k,
                                           dtype=torch.float32, use_jit=j) for j in (False, True))
        jit_path(f"ShardedGridPotts.run_fast({n_fast}), {k} shards", eager, graphed,
                 lambda m: m.run_fast(n_fast), lambda m: m.windows, lambda m: m.lower_bound())
    for kernel in ("torch", "cuda"):
        eager, graphed = (GridPottsModel(u, hc, vc, use_jit=j, **f32) for j in (False, True))
        jit_path(f"GridPottsModel.run_fast({n_fast}, kernel={kernel!r})", eager, graphed,
                 lambda m: m.run_fast(n_fast, kernel=kernel), lambda m: m.state,
                 lambda m: m.lower_bound())
    copies = sum(r.copies for r in graphed.jit.records if r.name.endswith("run_fast"))
    print(f"jit: captured dense run_fast({n_fast}, 'cuda'): {copies} state copies at the end of "
          f"its graphs")
    if copies:
        fail(f"the captured dense run_fast({n_fast}) ends in {copies} state copies")


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


def pull_model(tag: str, g: FactorGraph, **kw) -> None:
    """Engine(pull=True) beside Engine(pull=False) on ``g``: plan totals,
    bit-equal reruns of two fresh pull engines where every slot is strided,
    the bound and state after PULL_PASSES passes.  The pull passes launch no
    hand-written kernel."""
    step = lambda e: e.compute_pass("anisotropic")           # noqa: E731
    sc = cuda_engine(g, **kw)
    pu = cuda_engine(g, pull=True, **kw)
    tot = pull_totals(pu)
    print(f"pull: {tag}: {g.n_factors} factors, {pu.schedule_mode}, phases "
          f"{len(pu.phases[Direction.forward])}; pull plans: {tot['slots']} slots, "
          f"{tot['strided']} strided, {tot['fallback_lanes']} fallback lanes")
    before = launches()
    bit_equal = None
    if tot["strided"] == tot["slots"]:
        pu2 = cuda_engine(g, pull=True, **kw)
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
    if launches() - before:
        fail(f"pull: {tag}: the engines launched grid kernels: {dict(launches() - before)}")
    lb_p, lb_s = pu.lower_bound(), sc.lower_bound()
    err, scale = state_diff(sc.state, pu.state)
    print(f"pull: {tag}: after {PULL_PASSES} anisotropic passes lb pull {lb_p:.6f}, scatter "
          f"{lb_s:.6f}, rel diff {rel(lb_p, lb_s):.3e} (limit 1e-5); max state diff {err:.3e} "
          f"(limit {1e-5 * scale:.3e})")
    if not (rel(lb_p, lb_s) <= 1e-5 and err <= 1e-5 * scale):
        fail(f"pull: {tag}: the pull pass differs from the scatter pass")


def phase_pull(g_grid: FactorGraph, g_chain: FactorGraph, g_mc: FactorGraph) -> None:
    """The structured pull pass (Engine(pull=True)) against the scatter pass
    on bench.py's generic grid (every slot strided), the engine grid (pairs
    in per-cell order: every slot gathers), the 100k chain,
    qap_32x32_3000quadratic and the multicut with its 500 triplets; then
    tomography_100x64, whose counting messages have no pull hooks: pull=True
    must raise, pull="auto" runs the scatter pass."""
    pull_model(f"generic grid {H}x{W}", generic_grid_graph(), schedule_mode="auto")
    pull_model(f"engine grid {H}x{W}", g_grid, schedule_mode="coloring")
    pull_model(f"chain {CHAIN_N}", g_chain, schedule_mode="auto")
    g = FactorGraph()
    GraphMatchingConstructor(g, construction="left").construct(qap_input(32, 3000, seed=4))
    pull_model("qap_32x32", g, schedule_mode="auto")
    pull_model("multicut 149k + 500 triplets", g_mc, schedule_mode="coloring")
    g = FactorGraph()
    tomography_chains(DiscreteTomographyConstructor(g), 100, 64, 3, seed=5)
    try:
        cuda_engine(g, schedule_mode="auto", pull=True)
    except ValueError as e:
        refused = str(e)
    else:
        fail("pull: tomography_100x64: pull=True built an engine without pull hooks")
    e = cuda_engine(g, schedule_mode="auto", pull="auto")
    lb0 = e.lower_bound()
    e.compute_pass("anisotropic")
    lb1 = e.lower_bound()
    print(f"pull: tomography_100x64: pull=True refused ({refused}); pull='auto' runs the "
          f"scatter pass ({e.pull=}): lb {lb0:.6f} -> {lb1:.6f}")
    if "hooks" not in refused or e.pull or not lb1 >= lb0 - 1e-4 * abs(lb0):
        fail(f"pull: tomography_100x64: refusal {refused!r}, auto pull {e.pull}, lb {lb0} -> {lb1}")


def phase_checkpoint(e: Engine) -> None:
    """A checkpoint of the 1000x1000, L=4 engine grid: save, 5 more passes,
    load: the bound and every state tensor as saved, bit for bit, and the
    saved primal's cost; then snapshot, one pass, restore: the bound as
    before.  The engine launches no hand-written kernel."""
    before = launches()
    prim = e.compute_pass_and_primal("damped_uniform", Direction.forward)
    cost = e.evaluate_primal(prim)
    lb0 = e.lower_bound()
    saved = snapshot(e)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "grid.npz")
        save_checkpoint(path, e, best_primal=prim, best_primal_cost=cost, iteration=1)
        for _ in range(CHECKPOINT_PASSES):
            e.compute_pass("anisotropic")
        lb_moved = e.lower_bound()
        lprim, lcost, _ = load_checkpoint(path, e)
    lb1 = e.lower_bound()
    same = all(torch.equal(e.state[n][k], saved[n][k]) for n in saved for k in saved[n])
    lcost_eval = e.evaluate_primal(lprim)
    snap = snapshot(e)
    e.compute_pass("anisotropic")
    lb_pass = e.lower_bound()
    restore(e, snap)
    lb2 = e.lower_bound()
    counts = launches() - before
    print(f"checkpoint: {e.n_factors} factors; bound saved {lb0!r}, after {CHECKPOINT_PASSES} "
          f"passes {lb_moved!r}, loaded {lb1!r}; state equal to the saved one: {same}; primal "
          f"cost saved {cost!r}, loaded {lcost!r}, evaluated {lcost_eval!r}")
    print(f"checkpoint: snapshot, one pass to {lb_pass!r}, restore to {lb2!r}; kernel launches "
          f"{dict(counts)}")
    if counts:
        fail(f"checkpoint: the engine launched grid kernels: {dict(counts)}")
    if not (lb1 == lb0 and same and lcost == cost and lcost_eval == cost and lb2 == lb0):
        fail(f"checkpoint: bound {lb1} / {lb2} against {lb0}, state equal {same}, primal cost "
             f"{lcost} / {lcost_eval} against {cost}")


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
    device: (lower bound, upper bound)."""
    r = subprocess.run([sys.executable, "-m", "lp_mp_tpu_torch", *args], capture_output=True,
                       text=True, timeout=600, cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        fail(f"cli: {' '.join(args[:2])} exited {r.returncode}: {r.stderr[-2000:]}")
    return printed_bounds(r.stdout)


def phase_cli() -> None:
    """The three subcommands in subprocesses on the card: mrf_grid24 (its lb
    against the JAX cli's, its labels' cost on the host against the printed
    ub), qap_16x16 (lb against the JAX cli's) and multicut_grid40 with
    tightening and the sqlite visitor (one row per visited iteration, the
    last lowerBound the printed lb)."""
    with tempfile.TemporaryDirectory() as d:
        files = cli_inputs(d)
        labels_path = os.path.join(d, "labels.txt")
        lb, ub = run_cli("mrf", files["mrf"], "--maxIter", str(CLI_MRF_ITERS), "-v", "0",
                         "--outputFile", labels_path)
        lab = np.loadtxt(labels_path, dtype=np.int64)
        un, pairs, pw = mrf_grid24_instance()
        host = float(un[np.arange(len(un)), lab].sum()
                     + pw[np.arange(len(pairs)), lab[pairs[:, 0]], lab[pairs[:, 1]]].sum())
        print(f"cli: mrf {files['mrf']} --maxIter {CLI_MRF_ITERS}: lb {lb!r}, ub {ub!r}; JAX cli "
              f"lb {JAX_CLI['mrf_lb']!r} (rel diff {rel(lb, JAX_CLI['mrf_lb']):.3e}, limit 1e-4); "
              f"{lab.size} labels, their cost on the host {host!r} (rel diff to ub "
              f"{rel(host, ub):.3e}, limit 1e-4)")
        if not (rel(lb, JAX_CLI["mrf_lb"]) <= 1e-4 and lab.size == len(un)
                and rel(host, ub) <= 1e-4):
            fail(f"cli: mrf lb {lb}, ub {ub}, {lab.size} labels costing {host}")

        lb, ub = run_cli("gm", files["gm"], "--construction", "left", "--maxIter",
                         str(CLI_GM_ITERS), "-v", "0")
        print(f"cli: gm qap_16x16 --construction left --maxIter {CLI_GM_ITERS}: lb {lb!r}, ub "
              f"{ub!r}; JAX cli lb {JAX_CLI['gm_lb']!r} (rel diff "
              f"{rel(lb, JAX_CLI['gm_lb']):.3e}, limit 1e-4)")
        if not (rel(lb, JAX_CLI["gm_lb"]) <= 1e-4 and ub >= lb):
            fail(f"cli: gm lb {lb}, ub {ub}")

        db = os.path.join(d, "bench.db")
        lb, ub = run_cli("multicut", files["multicut"], "--maxIter", str(CLI_MC_ITERS),
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
        print(f"cli: multicut multicut_grid40 --maxIter {CLI_MC_ITERS} --tighten: lb {lb!r}, ub "
              f"{ub!r}; {len(rows)} iteration rows, last lowerBound {db_lb!r} (rel diff to lb "
              f"{rel(db_lb, lb):.3e}, limit 1e-6)")
        if not (rows and its == list(range(len(rows))) and len(rows) <= CLI_MC_ITERS
                and rel(db_lb, lb) <= 1e-6 and lb <= ub):
            fail(f"cli: multicut lb {lb}, ub {ub}, iteration rows {its}, last lowerBound {db_lb}")


def main() -> None:
    name, count = phase_device()
    phase_build()
    worst = phase_kernel_checks()
    dense = phase_main_path()
    counts = dense["launches"] + phase_sharded_path(dense)
    del dense
    counts["phase_update_v1"] = phase_v1_path()["phase_update_v1"]
    kernels = [{"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
                "launches": counts[k], "max_abs_err": worst[k]} for k in REPLACES]
    phase_native()
    ec = phase_engine_chain()
    eg, g_grid = phase_engine_grid()
    g_mc = phase_multicut_150k()
    phase_tightening_solvers()
    phase_model_solvers()
    phase_model_engines()
    sh_grid = phase_sharded_engine(g_grid, g_mc)
    phase_checkpoint(eg)
    dec, lam = phase_trees()
    phase_tree_solver(dec.chains)
    phase_jit(ec, eg, g_mc, sh_grid, dec, lam)
    g_chain = ec.graph
    del eg, ec, sh_grid, dec
    phase_pull(g_grid, g_chain, g_mc)
    del g_grid, g_mc, g_chain
    phase_oracles()
    phase_cli()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
