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
plain or dense counterpart, and prints one line per phase.

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

The last lines are a JSON record of the engine path, a JSON record of the
kernels, and {"ok": true, "device": {...}}.  Any failure raises and exits
non-zero; without a CUDA device it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from lp_mp_tpu_torch import (Direction, Engine, FactorGraph, GridPottsModel, MrfConstructor,
                             ShardedGridPotts, Solver, StandardVisitor, native, random_grid)
from lp_mp_tpu_torch.kernel_check import (RTOL, check_grid_kernels, check_phase_v1,
                                          check_sharded_grid_kernels)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops.grid_kernels import (launch_counts, phase_update, phase_update_ref,
                                              phase_update_sharded, phase_update_sharded_ref,
                                              phase_update_v1, reset_launch_counts,
                                              round_update, round_update_ref,
                                              round_update_sharded, round_update_sharded_ref)

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

    s, hcc, vcc = mk.state, mk.hc, mk.vc
    one = sharded[1]
    w, c, cs = one.windows[0], one.costs[0], one.cost_slabs[0]
    sl = one.layout.slabs(one.windows)[0]
    win = (w, sl, c["hc"], c["vc"], cs, 0, H, W)
    v1 = torch.tensor([0, 1, 0], dtype=torch.int32)
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
        times[name] = (t["kernel"], t["plain"])
        print(f"time: {name} kernel {t['kernel'] * 1e3:.1f} us/launch "
              f"({launch_bytes / t['kernel'] / 1e6:.1f} GB/s, host enqueue "
              f"{host_ms(kern, reps=20) * 1e3:.1f} us), plain {t['plain'] * 1e3:.1f} us "
              f"at {H}x{W} L={L}{' (1 shard)' if 'sharded' in name else ''} on {card}")
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
                "launches": counts[k], "max_abs_err": worst[k],
                "ms": times[k][0], "plain_ms": times[k][1]}
               for k in REPLACES]
    native_s = phase_native()
    ec, chain = phase_engine_chain()
    eg, m, grid = phase_engine_grid()
    t, kernel_path_its = phase_engine_time(card, ec, eg, m)
    engine = {"chain": chain | t["chain"], "grid": grid | t["grid"],
              "grid_kernel_path_its": kernel_path_its, "native_build_s": native_s, "card": card}
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"engine": engine}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
