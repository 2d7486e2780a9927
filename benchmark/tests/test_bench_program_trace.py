"""The readers of the program's spans and counters, on hand-built records
and on a traced run of each driver on the CPU (``benchmark/program_trace.py``)."""
import sys
import types

import pytest
import torch

from benchmark import harness, program_trace, trace


def read(metric, rec):
    return harness.reader(metric).read(rec, {})


def window_rec(busy, spans=None, device_s=None, window=(0.0, 10.0), **kw):
    prog = {"spans": spans or {}, "busy": busy, "device_s": device_s or {}}
    return {"trace": {"window": window, "program": prog}, **kw}


def test_syncs_per_solve_is_the_window_s_syncs_over_the_solves_it_started():
    rec = {"counters": {"start": {"syncs": 10}, "end": {"syncs": 110}}, "attempted": 4}
    assert read("syncs_per_solve", rec) == 25.0
    assert read("syncs_per_solve.kernel", rec) == 25.0
    assert read("syncs_per_solve", {"attempted": 4}) is None


def test_sync_turnaround_is_the_idle_gap_each_sync_ends_in():
    # busy 0-1, 2-3, 5-6: a sync ending at 1.5 ends in the gap 1-2, one at
    # 2.5 while the device is busy, one at 4 in the gap 3-5, one at 8 in
    # the gap from 6 to the window's end at 10
    rec = window_rec([(0.0, 1.0), (2.0, 3.0), (5.0, 6.0)],
                     {"lpmp.sync.a": [(1.2, 1.5), (2.1, 2.5)], "lpmp.sync.b": [(3.5, 4.0)],
                      "lpmp.sync.c": [(7.0, 8.0)], "lpmp.grid.lower_bound": [(0.5, 9.5)]})
    assert read("sync_turnaround_us", rec) == pytest.approx(1e6 * (1.0 + 0.0 + 2.0 + 4.0) / 4)
    assert read("sync_turnaround_us", window_rec([], {"lpmp.sync.a": [(1, 2)]})) is None


def test_enqueue_is_the_mean_replay_span():
    rec = window_rec([(0, 1)], {"lpmp.replay": [(0.0, 1e-5), (1.0, 1.00003)],
                                "lpmp.grid.run_fast": [(0.0, 2.0)]})
    assert read("enqueue_us_per_replay", rec) == pytest.approx(20.0)
    assert read("enqueue_us_per_replay", window_rec([(0, 1)])) is None


def test_bound_device_time_is_the_device_time_the_bound_s_spans_launched():
    rec = window_rec([(0.0, 1.0)], device_s={"lpmp.grid.lower_bound": 0.003,
                                             "lpmp.engine.lower_bound": 0.001,
                                             "lpmp.grid.round_primal": 0.5}, n_counted=2)
    assert read("bound_device_ms_per_solve", rec) == pytest.approx(2.0)
    assert read("bound_device_ms_per_solve", window_rec([(0, 1)], n_counted=2)) is None


def test_capture_setup_s_reads_the_program_s_counter(monkeypatch):
    from lp_mp_tpu_torch import tracing
    assert read("capture_setup_s", {}) == tracing.counters()["capture_s"]
    # a program without the counter (the parent of the counter) gives nothing
    import lp_mp_tpu_torch
    monkeypatch.delattr(lp_mp_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "lp_mp_tpu_torch.tracing", None)
    assert read("capture_setup_s", {}) is None


def test_idle_time_goes_to_the_innermost_span():
    # gaps 1-4 and 5-9; "a" holds a sync from 1 to 3.5; "b" runs 6-8
    prog = {"busy": [(0.0, 1.0), (4.0, 5.0), (9.0, 10.0)],
            "spans": {"lpmp.a": [(0.5, 6.0)], "lpmp.sync.x": [(1.0, 3.5)],
                      "lpmp.b": [(6.0, 8.0)]}}
    got = program_trace.idle_by_span(prog, (0.0, 10.0))
    assert got == pytest.approx({"lpmp.sync.x": 2.5, "lpmp.a": 1.5, "lpmp.b": 2.0, "none": 1.0})
    assert sum(got.values()) == pytest.approx(7.0)
    pairs = program_trace.idle_by_span(prog, (0.0, 10.0), depth=2)
    assert pairs == pytest.approx({"lpmp.a > lpmp.sync.x": 2.5, "lpmp.a": 1.5, "lpmp.b": 2.0,
                                   "none": 1.0})


class Event:
    """A stand-in for one of the profiler's raw events."""

    def __init__(self, name, start_us, end_us, cuda=False, corr=0):
        self._name, self._s, self._t, self._cuda, self._corr = name, start_us, end_us, cuda, corr

    def name(self):
        return self._name

    def start_ns(self):
        return round(self._s * 1e3)

    def duration_ns(self):
        return round((self._t - self._s) * 1e3)

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def correlation_id(self):
        return self._corr


def test_device_time_goes_to_the_spans_that_launched_it():
    # the bound launches a graph (two kernels) and a copy; a chunk launched
    # before it owns the kernel at 1-2; a device-side lpmp range is no work
    events = [Event("solve", 0, 20), Event("lpmp.grid.run_fast", 0.5, 0.9),
              Event("cudaGraphLaunch", 0.6, 0.8, corr=1), Event("kernel", 1, 2, True, corr=1),
              Event("lpmp.grid.lower_bound", 3, 9), Event("cudaGraphLaunch", 3.5, 3.7, corr=2),
              Event("kernel", 4, 5, True, corr=2), Event("kernel", 4.5, 6, True, corr=2),
              Event("lpmp.sync.grid.lower_bound", 7, 8.5),
              Event("cudaMemcpyAsync", 7.1, 8, corr=3), Event("Memcpy DtoH", 7.5, 7.8, True, corr=3),
              Event("lpmp.grid.lower_bound", 3, 9, cuda=True), Event("solve", 1, 8, cuda=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    view, kept, base = program_trace._filtered(prof)
    tr = trace.read(view, 1)
    assert tr["busy_s"] == pytest.approx(3.3e-6) and "lpmp.grid.lower_bound" not in tr["kernels"]
    prog = program_trace.read(kept, base, tr["window"])
    assert [x for iv in prog["busy"] for x in iv] == pytest.approx(
        [1e-6, 2e-6, 4e-6, 6e-6, 7.5e-6, 7.8e-6])
    assert prog["device_s"] == pytest.approx({"lpmp.grid.run_fast": 1e-6,
                                              "lpmp.grid.lower_bound": 2.3e-6,
                                              "lpmp.sync.grid.lower_bound": 0.3e-6})
    assert len(kept) == len(events) - 1


SIZES = {"potts_grid_1000.kernel": None, "potts_grid_1000.uniform": None,
         "potts_grid_1000.engine": "coloring"}


@pytest.fixture(scope="module")
def cpu_runs():
    """A traced run of each cell at 8x9 on the CPU with the program's
    tracing on, its runner kept."""
    spec = harness.load_spec()
    out = {}
    for workload, mode in SIZES.items():
        cs = harness.cell_spec(spec, workload)
        cs["config"].update(H=8, W=9)
        if "pool" in cs["traffic"]:
            cs["traffic"]["pool"] = 2
        else:
            cs["traffic"]["schedule_mode"] = mode
            cs["traffic"]["visitor"]["max_iter"] = 30
        rec = program_trace.measure(cs, 2**31 + 7, 2.0, True, True, torch.device("cpu"),
                                    log=lambda m: None, keep_answers=True)
        out[workload] = cs, rec
    return out


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_every_reader_gives_a_value_or_nothing_on_a_cpu_traced_run(cpu_runs, workload):
    cs, rec = cpu_runs[workload]
    assert rec["n_counted"] > 0 and rec["trace"]["program"]["spans"]
    got = program_trace.summary(cs, rec)["metrics"]
    names = {m["name"].split(".")[0] for m in program_trace.cell_metrics(cs)}
    assert {"syncs_per_solve", "capture_setup_s", "enqueue_us_per_replay"} <= names
    suffix = ".kernel" if workload.endswith(".kernel") else ""
    assert got["syncs_per_solve" + suffix] > 0
    assert got["capture_setup_s"] == 0.0          # no graphs are captured on the CPU
    assert all(v is None or v == v for v in got.values()), got


@pytest.mark.parametrize("workload", ["potts_grid_1000.kernel", "potts_grid_1000.uniform"])
def test_the_grid_loop_s_syncs_are_its_bounds_and_twice_its_roundings(cpu_runs, workload):
    _, rec = cpu_runs[workload]
    c = rec["counters"]
    ops = [op[0] for a in rec["runner"].answers.values() for op in a["ops"]]
    assert len(rec["runner"].answers) == rec["attempted"]
    assert c["end"]["syncs"] - c["start"]["syncs"] == ops.count("lb") + 2 * ops.count("round")
    by_site = {k: v - c["start"]["syncs_by_site"].get(k, 0)
               for k, v in c["end"]["syncs_by_site"].items()}
    assert by_site["grid.lower_bound"] == ops.count("lb")
    assert by_site["grid.round_primal.labels"] == by_site["grid.round_primal.cost"] \
        == ops.count("round")
