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
plain or dense counterpart, and prints one line per phase.  The line before
the last is a JSON record of the kernels; the last is {"ok": true,
"device": {...}}.  Any failure raises and exits non-zero; without a CUDA
device it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from lp_mp_tpu_torch import GridPottsModel, ShardedGridPotts, random_grid
from lp_mp_tpu_torch.kernel_check import (RTOL, check_grid_kernels, check_phase_v1,
                                          check_sharded_grid_kernels)
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
    print(f"total: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
