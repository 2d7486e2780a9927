"""Times the grid phase kernels per phase tuple and the captured run_fast per mode.

    python3 -m lp_mp_tpu_torch.phase_bench [--tree DIR]

(from the root of a checkout).

On one NVIDIA GPU, at the main path's 1000x1000 grid with 4 labels:

- every phase tuple of ``kernel_check.PHASE_PARAMS`` through the dense phase
  kernel (``phase_update``), the v1 contract (``phase_update_v1``) and the
  sharded phase kernel (``phase_update_sharded``) on the window of 1 shard
  and on one window of 4 shards (the second, whose slabs are its
  neighbours' rows);
- every phase tuple through the dense phase kernel at ``OTHER_SHAPES``: more
  labels than it keeps in registers (its generic label loop) and an odd
  width (its scalar path);
- ``GridPottsModel.run_fast(20, mode, kernel="cuda")`` and
  ``ShardedGridPotts.run_fast(20, mode)`` at 1 and 4 shards on ``cuda:0``,
  captured (``use_jit``, the default), for the anisotropic, uniform and
  damped_uniform modes;
- the rounding's kernels, ``round_phase_update`` in each damped_uniform
  phase tuple and ``primal_cost``, their plain versions, and one rounding
  pass of ``GridPottsModel`` (``round_primal``'s captured call, without the
  labels' copy to the host) on the kernels and on the plain ops (where the
  package has them).

A kernel's time is one replay of a CUDA graph that holds ``LAUNCHES``
back-to-back launches, each on the state the one before wrote, over CUDA
events, divided by the launches; a ``run_fast`` time is one call, over
CUDA events.  Each time is the median of 3, taken in turns with the other
timings of its group.  Beside each kernel time: its bound (``phase_bytes``
of its phase tuple at 3.35 TB/s) and its share of the bound.  The record
also holds the build's ptxas lines and the instruction and branch counts of
each phase kernel (``cuobjdump -sass``).

``--tree DIR`` times the ``lp_mp_tpu_torch`` of another checkout (an
earlier commit unpacked with ``git archive``; this module drops the
package it came with and imports that one), so one command can time two
versions in turns; the timing uses only what the package has had since its
sharded kernels took ``out=``.  The JSON record is the last line of
standard output.  ``chip_smoke.py`` takes its timing helpers and bounds
from here and calls ``phase_times`` and ``run_fast_times`` on this
checkout's package.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

LAUNCHES = 20       # kernel launches per captured graph
RUN_FAST_N = 20     # iterations per timed run_fast call
MODES = ("anisotropic", "uniform", "damped_uniform")
H, W, L, SEED = 1000, 1000, 4, 1
# (H, W, L) of the dense phase kernel's other paths: 8 labels (more than it
# keeps in registers) and an odd width (no 8-byte pairs)
OTHER_SHAPES = ((1000, 1000, 8), (1000, 999, 4))
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
FP32_OPS_PER_S = 67e12          # H100 SXM data sheet, float32 outside the tensor cores
# float32 operations per label of one cell update: per incident edge one min
# and one max for the min statistics, a compare, select, add and min for the
# marginal, the add into the cell and two for its slot; three for the cell
OPS_PER_LABEL_UPDATE = 4 * 8 + 3


def events_ms(fn, reps: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    import torch
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def in_turns(fns: dict, reps: int = 1) -> dict:
    """Median ms of each callable, measured three times each in turns
    (forward, reversed, forward order: plain, kernel, kernel, plain, plain,
    kernel for two), after one warm-up call of each."""
    import torch
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    names = list(fns)
    times = {k: [] for k in names}
    for order in (names, names[::-1], names):
        for k in order:
            times[k].append(events_ms(fns[k], reps))
    return {k: statistics.median(v) for k, v in times.items()}


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_bytes(state, recv_only, recv_color: int) -> tuple:
    """(bytes read, bytes written) by one phase launch: ``state`` read and
    written once, and ``recv_only`` (the costs, and a window's slabs: what
    only a receiving cell reads) read once where a colour receives."""
    return nbytes(state) + (nbytes(recv_only) if recv_color else 0), nbytes(state)


def window_recv_only(slabs, costs, cost_slabs, row0: int, rows: int, H: int) -> list:
    """What only the receiving cells of a shard's window read: its costs,
    and of its slabs the one row across the window's edge (vm1 and vc
    above, vm2 below) where that row lies in the grid."""
    out = [costs["hc"], costs["vc"]]
    if row0 > 0:
        out += [slabs["vm1"][0][..., -1:, :], cost_slabs["vc"][0][..., -1:, :]]
    if row0 + rows < H:
        out.append(slabs["vm2"][1][..., :1, :])
    return out


def launch_bound(in_bytes: int, out_bytes: int, updates: int) -> tuple:
    """(bound_ms, bound_by): the least time for a launch that reads its
    inputs once, writes its outputs once and makes ``updates`` cell-label
    updates, at 3.35 TB/s and 67 TFLOP/s float32."""
    t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = updates * OPS_PER_LABEL_UPDATE / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_counts(pkg, so) -> dict:
    """{phase kernel: [instructions, branches]} of a built library by
    ``cuobjdump -sass`` (the one beside nvcc), padding NOPs left out; the
    rounding's label-writing phase kernel counts as a phase kernel."""
    tool = Path(pkg.ops._cuda_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    out, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:      # a new function: counted below only if it is a phase kernel
            name = None
        m = re.search(r"Function : \S*?\d(grid_[a-z_]+?_kernel)I(\w*?)EEvNS", ln)
        if m:
            targs = ", ".join(("false", "true")[int(v)] if t == "b" else v
                              for t, v in re.findall(r"L([bi])(\d+)E", m.group(2)))
            phase = "phase" in m.group(1) or "round_primal" in m.group(1)
            name = f"{m.group(1)}<{targs}>" if phase else None
            if name:
                out[name] = [0, 0]
            continue
        m = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)", ln)
        if name and m and m.group(1) != "NOP":
            out[name][0] += 1
            out[name][1] += m.group(1).startswith("BRA")
    return out


def captured_chain(step, state, launches: int = LAUNCHES):
    """A CUDA graph of ``launches`` calls of ``step``, each on the state the
    one before returned, starting from ``state``; returns its replay."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(state)         # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    gc.collect()    # no garbage (a graph, a model's pool) freed during the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        s = state
        for _ in range(launches):
            s = step(s)
    torch.cuda.synchronize()
    graph.keep = (state, s)     # the graph's inputs and last outputs stay alive with it
    return graph.replay


def _entry(ms: float, in_out: tuple, updates: int) -> dict:
    us = ms * 1e3 / LAUNCHES
    b, by = launch_bound(*in_out, updates)
    return {"us": us, "bound_us": b * 1e3, "share": b * 1e3 / us, "bound_by": by}


def phase_times(pkg, params_list) -> dict:
    """{kernel: {str(params): {"us", "bound_us", "share", "bound_by"}}} per launch of
    the dense, v1, 1-shard and 4-shard-window phase kernels, and of the
    dense one at each of ``OTHER_SHAPES``."""
    import torch
    gk = pkg.ops.grid_kernels
    RowShards = pkg.parallel.grid.RowShards

    models = []     # alive until the timing ends: a model freed during a capture ends it

    def warm_state(h, w, labels):
        """A model's costs and a state that has seen a few iterations, so
        every slot holds data."""
        u, hc_np, vc_np = pkg.random_grid(h, w, labels, seed=SEED)
        m = pkg.GridPottsModel(u, hc_np, vc_np, device="cuda", dtype=torch.float32)
        models.append(m)
        st = {k: v.clone() for k, v in m.run_fast(3, "uniform", kernel="cuda").state.items()}
        return st, m.hc, m.vc

    state, hc, vc = warm_state(H, W, L)
    updates = H * W * L // 2    # a phase updates the cells of one colour
    windows = {}
    for n in (1, 4):
        lay = RowShards(H, W, ["cuda:0"] * n)
        wins, costs = lay.split(state), lay.split_costs(hc, vc)
        k = 0 if n == 1 else 1
        slabs, cslabs = lay.slabs(wins)[k], lay.slabs(costs)[k]
        args = (slabs, costs[k]["hc"], costs[k]["vc"], cslabs, lay.row0[k], H, W)
        w = wins[k]
        rows = min(w["u"].shape[1], H - lay.row0[k])
        recv_only = window_recv_only(slabs, costs[k], cslabs, lay.row0[k], rows, H)
        windows[f"phase_update_sharded {n} shard{'s' if n > 1 else ''}"] = (
            w, args, list(w.values()), recv_only, updates * rows // H)
    others = {f"phase_update {h}x{w} L={labels}": warm_state(h, w, labels) + (h * w * labels // 2,)
              for h, w, labels in OTHER_SHAPES}

    out = {}
    for p in params_list:
        rc, sc, leave = p
        v1 = torch.tensor([rc, sc, round(10 * leave)], dtype=torch.int32)
        fns = {"phase_update": captured_chain(lambda s: gk.phase_update(s, hc, vc, *p), state),
               "phase_update_v1": captured_chain(lambda s: gk.phase_update_v1(v1, s, hc, vc),
                                                 state)}
        sizes = {"phase_update": (list(state.values()), [hc, vc], updates)}
        sizes["phase_update_v1"] = sizes["phase_update"]
        for name, (w, args, st, recv_only, upd) in windows.items():
            fns[name] = captured_chain(lambda s, args=args: gk.phase_update_sharded(s, *args, *p), w)
            sizes[name] = (st, recv_only, upd)
        for name, (s0, hc_o, vc_o, upd) in others.items():
            fns[name] = captured_chain(
                lambda s, hc_o=hc_o, vc_o=vc_o: gk.phase_update(s, hc_o, vc_o, *p), s0)
            sizes[name] = (list(s0.values()), [hc_o, vc_o], upd)
        for name, ms in in_turns(fns).items():
            st, recv_only, upd = sizes[name]
            out.setdefault(name, {})[str(tuple(p))] = _entry(
                ms, phase_bytes(st, recv_only, rc), upd)
        torch.cuda.synchronize()
        del fns
        torch.cuda.empty_cache()
    models.clear()
    gc.collect()    # the models' graphs go now, not during a later capture
    return out


def round_primal_times(pkg) -> dict:
    """Per launch of the rounding's kernels at the main path's grid, by graph
    replay as ``phase_times`` (``round_phase_update`` in each damped_uniform
    phase tuple, ``primal_cost`` a call, its two kernels): {name: {"us",
    "bound_us", "share", "bound_by", "plain_us"}} with the plain version's time (CUDA
    events, median of 3 in turns with the kernel); and "round_primal": {"ms",
    "plain_ms"}, one rounding pass of the model, the captured call on the
    kernels against the plain ops, without the labels' copy to the host.
    The bounds count the phase's bytes (``phase_bytes``) plus the labels of
    the colour it updates, and for the cost pass the labels, the costs and
    one value per cell of each state array."""
    import torch
    gk = pkg.ops.grid_kernels
    mode = pkg.config.ReparametrizationMode.damped_uniform
    u, hc_np, vc_np = pkg.random_grid(H, W, L, seed=SEED)
    m = pkg.GridPottsModel(u, hc_np, vc_np, device="cuda", dtype=torch.float32)
    state = {k: v.clone() for k, v in m.run_fast(3, "uniform", kernel="cuda").state.items()}
    hc, vc = m.hc, m.vc
    labels = torch.zeros((H, W), dtype=torch.int32, device="cuda")
    work = torch.empty(gk.cost_work_size(H, W), dtype=torch.float64, device="cuda")
    half_labels = nbytes([labels]) // 2
    out = {}
    for p in pkg.models.grid_potts.phase_tuples(mode)[:2]:
        t = in_turns({"kernel": captured_chain(
                          lambda s, p=p: gk.round_phase_update(s, hc, vc, *p, labels), state),
                      "plain": lambda p=p: gk.round_phase_ref(state, hc, vc, *p, labels)})
        ins, outs = phase_bytes(list(state.values()), [hc, vc], p[0])
        out[f"round_phase_update {p}"] = dict(
            _entry(t["kernel"], (ins, outs + half_labels), H * W * L // 2),
            plain_us=t["plain"] * 1e3)
    picked = nbytes([labels, hc, vc]) + sum(nbytes([v[0]]) for v in state.values())
    t = in_turns({"kernel": captured_chain(
                      lambda s: (gk.primal_cost(s, hc, vc, labels, work), s)[1], state),
                  "plain": lambda: gk.primal_cost_ref(state, hc, vc, labels)})
    out["primal_cost"] = dict(_entry(t["kernel"], (picked, 0), 0), plain_us=t["plain"] * 1e3)
    params = m._mode_params(mode)
    t = in_turns({"kernel": lambda: m._round_fn(m.state, mode=mode),
                  "plain": lambda: m._round_impl({k: v.clone() for k, v in state.items()},
                                                 params)})
    out["round_primal"] = {"ms": t["kernel"], "plain_ms": t["plain"]}
    del m
    gc.collect()
    return out


def run_fast_times(pkg) -> dict:
    """{config: {mode: it/s}} of the captured run_fast(RUN_FAST_N)."""
    import torch
    u, hc, vc = pkg.random_grid(H, W, L, seed=SEED)
    models = {"dense": pkg.GridPottsModel(u, hc, vc, device="cuda", dtype=torch.float32)}
    for n in (1, 4):
        models[f"{n} shard{'s' if n > 1 else ''}"] = pkg.ShardedGridPotts(
            u, hc, vc, devices=["cuda:0"] * n, dtype=torch.float32)
    out = {}
    for mode in MODES:
        fns = {}
        for name, mdl in models.items():
            if name == "dense":
                fns[name] = lambda mdl=mdl: mdl.run_fast(RUN_FAST_N, mode, kernel="cuda")
            else:
                fns[name] = lambda mdl=mdl: mdl.run_fast(RUN_FAST_N, mode)
        t = in_turns(fns)
        for name, ms in t.items():
            out.setdefault(name, {})[mode] = {"ms": ms, "its": RUN_FAST_N / ms * 1e3}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", help="checkout whose lp_mp_tpu_torch to import")
    args = ap.parse_args()
    if args.tree:   # the other checkout's package in place of the one this module came with
        for name in [m for m in sys.modules if m.split(".")[0] == "lp_mp_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        sys.exit("phase_bench: torch.cuda.is_available() is false: this script times the card")
    import lp_mp_tpu_torch as pkg
    import lp_mp_tpu_torch.ops.grid_kernels  # noqa: F401
    import lp_mp_tpu_torch.parallel.grid  # noqa: F401
    from lp_mp_tpu_torch.kernel_check import PHASE_PARAMS
    from lp_mp_tpu_torch.ops import _cuda_build

    t0 = time.perf_counter()
    build = _cuda_build.build(force=True)
    ptxas = [ln.strip() for ln in build.log.splitlines() if "ptxas" in ln]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    rec = {"package": pkg.__file__, "card": card, "build_s": build.seconds, "ptxas": ptxas,
           "sass": sass_counts(pkg, build.path),
           "phases": phase_times(pkg, PHASE_PARAMS), "run_fast": run_fast_times(pkg)}
    if hasattr(pkg.ops.grid_kernels, "round_phase_update"):
        rec["rounding"] = round_primal_times(pkg)
    rec["seconds"] = time.perf_counter() - t0
    tag = os.path.dirname(os.path.dirname(pkg.__file__))
    for name, (ins, bra) in rec["sass"].items():
        print(f"{tag} {name}: {ins} instructions, {bra} branches (cuobjdump -sass)")
    for name, per in rec["phases"].items():
        print(f"{tag} {name}: " + ", ".join(
            f"{p} {v['us']:.1f} us ({100 * v['share']:.0f} % of {v['bound_us']:.1f})"
            for p, v in per.items()) + f" on {card}")
    for name, per in rec["run_fast"].items():
        print(f"{tag} run_fast({RUN_FAST_N}) {name}: " + ", ".join(
            f"{mode} {v['its']:.1f} it/s ({v['ms']:.3f} ms)" for mode, v in per.items()))
    for line in rounding_lines(rec.get("rounding", {})):
        print(f"{tag} {line} on {card}")
    print(json.dumps(rec))


def rounding_lines(rec: dict) -> list:
    """``round_primal_times``'s record as lines of text."""
    lines = [f"{name}: {v['us']:.1f} us a launch ({100 * v['share']:.0f} % of "
             f"{v['bound_us']:.1f}), plain {v['plain_us']:.1f} us, at {H}x{W} L={L}"
             for name, v in rec.items() if name != "round_primal"]
    if "round_primal" in rec:
        v = rec["round_primal"]
        lines.append(f"round_primal, one captured pass: {v['ms'] * 1e3:.1f} us on the kernels, "
                     f"{v['plain_ms'] * 1e3:.1f} us on the plain ops")
    return lines


if __name__ == "__main__":
    main()
