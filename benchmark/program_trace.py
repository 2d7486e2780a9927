"""The program's own spans and counters in a traced window, and runs of a
cell with them on.

    python3 benchmark/program_trace.py --workload <name> --seed <n> --seconds <s> \\
        [--trace 0|1] [--program 0|1]

``lp_mp_tpu_torch.tracing`` puts ``lpmp.`` spans around the program's
layers, a span ``lpmp.sync.<site>`` around each wait of the host for the
device, and counts captures and syncs.  ``benchmark/run.py`` turns none of
it on: its ``harness.measure`` leaves tracing off and snapshots no counter,
and its ``trace.read`` would count the ``lpmp.`` ranges that the profiler
draws on the device's timeline as device work.  This script runs a cell
through ``harness.measure`` as ``run.py`` does, with the program's tracing
set by ``--program``, and with the two changes that the harness needs
before the pending metrics (``PENDING_PER_LAYER``) can join
``BENCHMARK.json``:

- ``tracing.enable(True)`` for the traced run, and ``rec["counters"]``:
  ``{"start", "end"}`` snapshots of ``tracing.counters()`` where the
  profiler starts and stops;
- ``trace.read`` leaving every device event named ``lpmp.`` out of the
  busy time and the kernels, and ``rec["trace"]["program"]``: what
  ``read`` below returns.

The last line of standard output is one JSON object: the run's
end-to-end metrics (``--trace 0``) or every per-layer metric of the cell,
accepted and pending, with the device's idle time put down to the
innermost ``lpmp.`` span it fell in (``--trace 1``), and ``correct``.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
GRID_CELLS = ["potts_grid_1000.uniform", "potts_grid_1000.engine"]
# the per-layer entries that wait for the harness's two changes (module
# docstring), as BENCHMARK.json would hold them
PENDING_PER_LAYER = [
    {"name": "syncs_per_solve", "unit": "syncs", "better": "lower", "source": "program_counter",
     "layer": "host-device synchronisation", "moves": "solve_s", "workloads": GRID_CELLS},
    {"name": "syncs_per_solve.kernel", "unit": "syncs", "better": "lower",
     "source": "program_counter", "layer": "host-device synchronisation",
     "moves": "solve_s.kernel", "workloads": ["potts_grid_1000.kernel"]},
    {"name": "sync_turnaround_us", "unit": "us", "better": "lower", "source": "program_span",
     "layer": "host-device synchronisation", "moves": "solve_s", "workloads": GRID_CELLS},
    {"name": "sync_turnaround_us.kernel", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "host-device synchronisation",
     "moves": "solve_s.kernel", "workloads": ["potts_grid_1000.kernel"]},
    {"name": "enqueue_us_per_replay", "unit": "us", "better": "lower", "source": "program_span",
     "layer": "captured execution", "moves": "dual_iters_per_s", "workloads": GRID_CELLS},
    {"name": "enqueue_us_per_replay.kernel", "unit": "us", "better": "lower",
     "source": "program_span", "layer": "captured execution",
     "moves": "dual_iters_per_s.kernel", "workloads": ["potts_grid_1000.kernel"]},
    {"name": "bound_device_ms_per_solve", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "dual bound", "moves": "solve_s",
     "workloads": GRID_CELLS},
    {"name": "bound_device_ms_per_solve.kernel", "unit": "ms", "better": "lower",
     "source": "program_span", "layer": "dual bound", "moves": "solve_s.kernel",
     "workloads": ["potts_grid_1000.kernel"]},
]


def read(events, base_ns: int, window: tuple) -> dict:
    """The program's part of a traced window, from the profiler's raw events
    (times in seconds from ``base_ns``, as ``trace.read`` gives them).

    Returns {"spans": {name: [(start, end)]}, the host's ``lpmp.`` spans,
    sorted; "busy": [(start, end)], the device's busy intervals merged
    (kernels, copies and sets; no ``lpmp.`` range and no benchmark span);
    "device_s": {name: seconds}, the device's busy time in the operations
    launched while a span of that name was open}, within ``window``.  An
    operation is put down to the host call that launched it (a kernel of a
    replayed graph to its ``cudaGraphLaunch``) by the correlation id they
    share: the profiler draws no device-side range for a ``record_function``
    range that only launches CUDA graphs (PyTorch 2.11)."""
    import torch

    from benchmark import trace
    cuda = torch.autograd.DeviceType.CUDA
    w0, w1 = window
    spans = collections.defaultdict(list)
    ops, launches = [], []
    for e in events:
        name = e.name()
        s = (e.start_ns() - base_ns) * 1e-9
        t = s + e.duration_ns() * 1e-9
        if s < w0 or t > w1:
            continue
        if e.device_type() == cuda:
            if not name.startswith("lpmp.") and name not in trace.SPAN_NAMES:
                ops.append((s, t, e.correlation_id()))
        elif name.startswith("lpmp."):
            spans[name].append((s, t))
        elif name.startswith("cu"):         # a CUDA runtime or driver call
            launches.append((s, e.correlation_id()))
    spans = {k: sorted(v) for k, v in spans.items()}
    device_s = {}
    for name, v in spans.items():
        starts = [s for s, _ in v]
        corr = set()
        for s, c in launches:
            i = bisect.bisect_right(starts, s)
            if i and s <= v[i - 1][1]:
                corr.add(c)
        mine = trace._union([(s, t) for s, t, c in ops if c in corr])
        device_s[name] = sum(t - s for s, t in mine)
    return {"spans": spans, "busy": [tuple(x) for x in trace._union([o[:2] for o in ops])],
            "device_s": device_s}


def idle_gaps(busy: list, window: tuple) -> list:
    """[(start, end)] of the window in which the device ran nothing."""
    gaps, prev = [], window[0]
    for s, t in list(busy) + [(window[1], window[1])]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    return gaps


def idle_by_span(program: dict, window: tuple, depth: int = 1) -> dict:
    """Seconds of the device's idle time under each innermost host ``lpmp.``
    span ("none": under no span); with ``depth`` 2, under each pair of the
    innermost span and its parent ("parent > span").  Spans of one thread
    nest, so the innermost span at an instant is the last opened of those
    still open."""
    marks = []
    for name, v in program["spans"].items():
        for i, (s, t) in enumerate(v):
            marks.append((s, 1, -t, name, i))
            marks.append((t, 0, 0.0, name, i))
    marks.sort()
    gaps = idle_gaps(program["busy"], window)
    out = collections.Counter()
    stack, prev, g = [], window[0], 0

    def charge(a, b, label):
        nonlocal g
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        k = g
        while k < len(gaps) and gaps[k][0] < b:
            ov = min(b, gaps[k][1]) - max(a, gaps[k][0])
            if ov > 0:
                out[label] += ov
            k += 1
    def label():
        return " > ".join(n for n, _ in stack[-depth:]) if stack else "none"
    for when, opening, _, name, i in marks:
        if when > prev:
            charge(prev, when, label())
            prev = when
        if opening:
            stack.append((name, i))
        elif (name, i) in stack:
            stack.remove((name, i))
    charge(prev, window[1], label())
    return dict(out.most_common())


def _filtered(prof):
    """``prof`` as ``trace.read`` reads it, without any device-side ``lpmp.``
    range (PyTorch 2.11 draws none; a profiler that does would count them
    as device work); and the minimum start over the events kept."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    kept = [e for e in prof.profiler.kineto_results.events()
            if not (e.device_type() == cuda and e.name().startswith("lpmp."))]
    view = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: kept)))
    return view, kept, min((e.start_ns() for e in kept), default=0)


class _CountingProfile:
    """A profiler that snapshots the program's counters where it starts and
    stops."""

    def __init__(self, prof, tracing):
        self.prof, self.tracing, self.counters = prof, tracing, {}

    def start(self):
        self.counters["start"] = self.tracing.counters()
        self.prof.start()

    def stop(self):
        self.prof.stop()
        self.counters["end"] = self.tracing.counters()

    @property
    def profiler(self):
        return self.prof.profiler


def measure(cs: dict, seed: int, seconds: float, traced: bool, program: bool, device,
            log=print, keep_answers: bool = False) -> dict:
    """``harness.measure`` with the program's tracing set by ``program`` and,
    traced, the harness's two changes (module docstring) in place."""
    from lp_mp_tpu_torch import tracing

    from benchmark import harness, trace
    profilers = []
    make, read_trace = trace.profiler, trace.read

    def profiler(dev):
        profilers.append(_CountingProfile(make(dev), tracing))
        return profilers[-1]

    def read_program(prof, n_counted):
        view, kept, base = _filtered(prof)
        out = read_trace(view, n_counted)
        if out:
            out["program"] = read(kept, base, out["window"])
        return out
    tracing.enable(program)
    trace.profiler, trace.read = profiler, read_program
    try:
        rec = harness.measure(cs, seed, seconds, traced, device, log=log,
                              keep_answers=keep_answers)
    finally:
        trace.profiler, trace.read = make, read_trace
        tracing.enable(False)
    if profilers:
        rec["counters"] = profilers[-1].counters
    return rec


def cell_metrics(cs: dict) -> list:
    """The cell's per-layer metrics, accepted and pending."""
    name = cs["cell"]["name"]
    return cs["per_layer"] + [m for m in PENDING_PER_LAYER if name in m["workloads"]]


def summary(cs: dict, rec: dict) -> dict:
    """What a traced run read: every per-layer metric of the cell (accepted
    and pending), the counters, the device's idle time by innermost span,
    and the program's spans counted and timed."""
    from benchmark import harness
    tr = rec["trace"]
    prog = tr["program"]
    idle = idle_by_span(prog, tr["window"])
    return {"metrics": {m["name"]: harness.reader(m["name"]).read(rec, cs)
                        for m in cell_metrics(cs)},
            "counters": rec["counters"], "window_s": tr["window_s"], "busy_s": tr["busy_s"],
            "breakdown": harness.trace.breakdown(tr),
            "idle_s": sum(idle.values()), "idle_by_span": idle,
            "idle_by_span_and_parent": idle_by_span(prog, tr["window"], depth=2),
            "span_counts": {k: len(v) for k, v in prog["spans"].items()},
            "span_mean_us": {k: 1e6 * sum(t - s for s, t in v) / len(v)
                             for k, v in prog["spans"].items()},
            "device_s": prog["device_s"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--program", type=int, choices=(0, 1), default=1)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import os

    from benchmark import run
    for key, rel in run.CACHES.items():
        os.environ[key] = str(ROOT / rel)
        os.makedirs(os.environ[key], exist_ok=True)
    import torch

    from benchmark import harness
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cs = harness.cell_spec(harness.load_spec(), args.workload)
    t = time.perf_counter()
    rec = measure(cs, args.seed, args.seconds, bool(args.trace), bool(args.program), device,
                  log=run.log)
    correct, checks = harness.verdict(rec, cs["traffic"]["limits"])
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace,
           "program": args.program, "correct": correct, "checks": checks,
           "setup_s": rec["setup_s"], "n_counted": rec["n_counted"],
           "attempted": rec["attempted"], "e2e": rec["e2e"],
           "device": torch.cuda.get_device_name(0), "power_limit_w": run.power_limit_w()}
    if rec.get("trace"):
        out.update(summary(cs, rec))
    out["seconds"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
