"""Smoke run of the PyTorch port (lp_mp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA grid kernels from lp_mp_tpu_torch/csrc with nvcc and holds
each kernel against its plain torch version on the card: the dense phase and
round kernels, the phase kernel under the v1 contract, and the sharded phase
and round kernels on every shard at 1-4 shards.  Then drives the main paths,
each with the launch counters set to 0 just before and read just after: the
1000x1000, L=4 Potts grid through GridPottsModel.run_fast(kernel="cuda"),
lower_bound and round_primal; the same grid through
ShardedGridPotts.run_fast at 1 and 4 shards on the one card, held against
the dense path; and the uniform schedule through the v1 contract.  Checks
the bounds against the JAX package's, times each path and kernel against its
plain or dense counterpart and against its bound (the bytes a launch must
move at 3.35 TB/s, or its float32 operations at 67 TFLOP/s, whichever is
longer), reads each kernel's device time inside run_fast(20) under
torch.profiler, and prints one line per phase.

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

The last lines are JSON records of the engine path, of tightening and of
the two models, a JSON record of the kernels, and {"ok": true, "device":
{...}}.  Any
failure raises and exits non-zero; without a CUDA device it exits non-zero
at once.
"""
from __future__ import annotations

import hashlib
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lp_mp_tpu_torch import (Direction, DiscreteTomographyConstructor, Engine, FactorGraph,
                             GraphMatchingConstructor, GraphMatchingInput, GridPottsModel,
                             MrfConstructor, MulticutConstructor, ShardedGridPotts, Solver,
                             StandardTighteningVisitor, StandardVisitor, native, random_grid)
from lp_mp_tpu_torch.convert import host_array
from lp_mp_tpu_torch.kernel_check import (RTOL, check_grid_kernels, check_phase_v1,
                                          check_sharded_grid_kernels)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops.grid_kernels import (launch_counts, phase_update, phase_update_ref,
                                              phase_update_sharded, phase_update_sharded_ref,
                                              phase_update_v1, reset_launch_counts,
                                              round_tile, round_update, round_update_ref,
                                              round_update_sharded, round_update_sharded_ref)
from lp_mp_tpu_torch.utils.mincostflow import solve_assignment

H, W, L, SEED = 1000, 1000, 4, 1
CHUNKS, CHUNK_ITERS = 15, 100
# lower bound the JAX package reaches after 15 x run_fast(100, kernel="pallas")
# on random_grid(1000, 1000, 4, seed=1): BENCH_r05.json, grid entry, target_lb
JAX_TARGET_LB = -306284.281
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SOURCE = "lp_mp_tpu_torch/csrc/grid_potts.cu"
SHARD_RUNS = (1, 4)            # shards of the sharded main path, all on cuda:0
REPLACES = {"round_update": "lp_mp_tpu/ops/pallas_grid.py:303",
            "phase_update": "lp_mp_tpu/ops/pallas_grid.py:161",
            "round_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:536",
            "phase_update_sharded": "lp_mp_tpu/ops/pallas_grid.py:443",
            "phase_update_v1": "lp_mp_tpu/ops/pallas_grid.py:72"}
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


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def max_state_err(a, b) -> float:
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def events_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, reps: int) -> dict:
    """Median ms of each callable, measured three times each in turns
    (forward, reversed, forward order: plain, kernel, kernel, plain, plain,
    kernel for two), after one warm-up call of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    times = {k: [] for k in names}
    for order in (names, names[::-1], names):
        for k in order:
            times[k].append(events_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in times.items()}


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


def phase_main_path() -> dict:
    """The dense main path.  Returns its launch counts, its state after the
    1500 iterations (before rounding), its bound and its rounded primal."""
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
    expect = {k: CHUNKS * per_call.get(k, 0) for k in counts}
    print(f"main: launches {counts}, schedule implies {expect}")
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
    x, ub = m.round_primal()
    print(f"main: round_primal ub {ub:.6f} >= lb {lb_cuda:.6f}, labels {x.shape} "
          f"in [{x.min()}, {x.max()}]")
    if not (x.shape == (H, W) and 0 <= x.min() and x.max() < L and ub >= lb_cuda):
        fail(f"round_primal gave ub {ub} (lb {lb_cuda}) and labels {x.shape}")

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
        expect = {k: n * CHUNKS * per_call.get(k, 0) for k in counts}
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


# float32 operations per label of one cell update: per incident edge one min
# and one max for the min statistics, a compare, select, add and min for the
# marginal, the add into the cell and two for its slot; three for the cell
OPS_PER_LABEL_UPDATE = 4 * 8 + 3
FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def launch_bound(in_bytes: int, out_bytes: int, updates: int) -> tuple:
    """(bound_ms, bound_by): the least time for a launch that reads its
    inputs once, writes its outputs once and makes ``updates`` cell-label
    updates, at 3.35 TB/s and 67 TFLOP/s float32."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = updates * OPS_PER_LABEL_UPDATE / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    dense_in = nbytes([*s.values(), hcc, vcc])
    dense_out = nbytes(s.values())
    win_in = nbytes([*w.values(), *(x for pair in sl.values() for x in pair), c["hc"], c["vc"],
                     *cs["hc"], *cs["vc"]])
    win_out = nbytes(w.values())
    cells = H * W * L                   # cell-label pairs; a phase updates the cells of one colour
    updates = {"phase_update": cells // 2, "phase_update_v1": cells // 2,
               "phase_update_sharded": cells // 2, "round_update": 2 * cells,
               "round_update_sharded": 2 * cells}
    tile = round_tile(L, 2)
    print(f"time: round kernel tile at L={L}, n_rounds=2: {tile['rows']} x {tile['cols']} cells "
          f"written per block, {tile['rows_loaded']} x {tile['cols_loaded']} loaded, "
          f"{tile['threads']} threads, {tile['smem']} B of shared memory")
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
        bound_ms, bound_by = launch_bound(win_in if sharded else dense_in,
                                          win_out if sharded else dense_out, updates[name])
        times[name] = {"ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None}
        print(f"time: {name} kernel {t['kernel'] * 1e3:.1f} us/launch "
              f"({launch_bytes / t['kernel'] / 1e6:.1f} GB/s, host enqueue "
              f"{host_ms(kern, reps=20) * 1e3:.1f} us), plain {t['plain'] * 1e3:.1f} us, bound "
              f"{bound_ms * 1e3:.1f} us ({bound_by}; no single PyTorch call computes a Potts "
              f"phase) at {H}x{W} L={L}{' (1 shard)' if sharded else ''} on {card}")
    return times


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


def phase_engine_grid() -> dict:
    """The main grid through the generic engine (Potts pairs batch-built in
    the per-cell order of tests/test_grid.py), held against GridPottsModel's
    kernel path on the card.  The engine launches no hand-written kernel:
    the counters stay at 0 through its passes."""
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
    return e, m, {"lb": lb_e, "lb_kernel_path": lb_k, "build_s": build_s}


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


def phase_multicut_150k(card: str) -> dict:
    """bench.py's multicut: one separation round on a fresh engine, a
    rebuild, 100 anisotropic passes and GAEC, against the JAX package."""
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
            "idle_share": prof["idle_share"]}


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
           "aux_n": s.aux.n, "n_triplets": n_trip}
    print(f"{tag}: Solver.solve() in {sec:.2f} s: lb {lb:.6f}, ub {ub:.6f}, rel gap {gap:.3e}, "
          f"{s.n_engine_builds} engine builds, aux.n {s.aux.n}, {n_trip} triplets")
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


def main() -> None:
    t0 = time.perf_counter()
    name, count, card = phase_device()
    phase_build()
    worst = check_grid_kernels("cuda", log=print)
    print(f"check: all launches within 1e-5*(1+max|x|); max abs err {worst}")
    worst["phase_update_v1"] = check_phase_v1("cuda", log=print)
    worst.update(check_sharded_grid_kernels("cuda", log=print))
    print(f"check: all v1 and sharded launches within 1e-5*(1+max|x|); max abs err {worst}")
    dense = phase_main_path()
    counts = dict(dense["counts"])
    sharded = phase_sharded_path(dense)
    counts.update({k: sharded[k] for k in ("phase_update_sharded", "round_update_sharded")})
    counts["phase_update_v1"] = phase_v1_path()["phase_update_v1"]
    times = phase_time(card)
    kernels = [{"name": k, "route": "cuda", "source": SOURCE, "replaces": REPLACES[k],
                "launches": counts[k], "max_abs_err": worst[k], **times[k]}
               for k in REPLACES]
    native_s = phase_native()
    ec, chain = phase_engine_chain()
    eg, m, grid = phase_engine_grid()
    t, kernel_path_its = phase_engine_time(card, ec, eg, m)
    engine = {"chain": chain | t["chain"], "grid": grid | t["grid"],
              "grid_kernel_path_its": kernel_path_its, "native_build_s": native_s, "card": card}
    tightening = {"multicut_150k": phase_multicut_150k(card), **phase_tightening_solvers(),
                  "card": card}
    t1 = time.perf_counter()
    models = {**phase_model_solvers(), **phase_model_time(card), "card": card}
    models["phase_s"] = time.perf_counter() - t1
    print(f"models: graph matching and tomography phase {models['phase_s']:.1f} s")
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"engine": engine}))
    print(json.dumps({"tightening": tightening}))
    print(json.dumps({"models": models}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
