"""The port's spans and counters (``lp_mp_tpu_torch/tracing.py``), on the CPU.

Off, tracing leaves nothing in a profiler's trace and changes no result;
on, the spans of the grid model, the solver and the engine appear under
``torch.profiler`` strictly nested, each sync inside the call that waits;
the sync counter counts exactly the waits of a known sequence of calls,
with tracing on or off.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lp_mp_tpu_torch import (GridPottsModel, MrfConstructor, Solver, StandardTighteningVisitor,
                             StandardVisitor, random_grid, tracing)
from lp_mp_tpu_torch.aux_tighten import AuxPasses
from lp_mp_tpu_torch.engine import Engine


@pytest.fixture(autouse=True)
def tracing_off_after():
    yield
    tracing.enable(False)


def grid_model():
    u, hc, vc = random_grid(8, 9, 3, seed=3)
    return GridPottsModel(u, hc, vc, device="cpu", dtype=torch.float64)


def grid_calls(m):
    """A reset, a chunk, three bounds and a rounding: what the benchmark's
    grid loop runs.  Returns the results."""
    m.load_state({k: v.clone() for k, v in m.state.items()})
    m.run_fast(4, "anisotropic")
    lbs = [m.lower_bound() for _ in range(3)]
    x, ub = m.round_primal()
    return lbs, x, ub, {k: v.clone() for k, v in m.state.items()}


def grid8(mrf, H=6, W=6, L=2, seed=11):
    """8-connected grid with dense pairwise costs (tightening absorbs its
    triplets into the aux passes)."""
    rng = np.random.default_rng(seed)
    mrf.add_unary_factors(rng.normal(size=(H * W, L)) * 0.5)
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.sort(np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()], axis=1)]), axis=1)
    mrf.add_pairwise_factors(pairs, rng.normal(size=(len(pairs), L, L)))


def solver(tighten: bool) -> Solver:
    kw = dict(max_iter=24, primal_computation_interval=4)
    if tighten:
        visitor = StandardTighteningVisitor(tighten=True, tighten_iteration=4, tighten_interval=8,
                                            tighten_constraints_max=6, **kw)
    else:
        visitor = StandardVisitor(**kw)
    s = Solver(visitor=visitor, device="cpu", dtype=torch.float64)
    grid8(s.add_constructor(MrfConstructor, pairwise_rep="dense"))
    return s


def lpmp_spans(prof) -> list:
    """[(start_ns, end_ns, name)] of the trace's ``lpmp.`` ranges, by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events() if e.name().startswith("lpmp."))


def parents(spans: list) -> list:
    """[(name, parent name or None)] of spans that nest strictly (two spans
    are disjoint or one holds the other); fails on a span that overlaps
    another's end."""
    out, stack = [], []
    for s, t, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:
            assert t <= stack[-1][1], f"{name} [{s}, {t}] crosses {stack[-1]}"
        out.append((name, stack[-1][2] if stack else None))
        stack.append((s, t, name))
    return out


def traced(fn, on: bool):
    tracing.enable(on)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = fn()
    finally:
        tracing.enable(False)
    return out, prof


def test_off_the_trace_holds_no_span_and_results_are_bit_equal():
    (lbs0, x0, ub0, st0), prof_off = traced(lambda: grid_calls(grid_model()), False)
    (lbs1, x1, ub1, st1), prof_on = traced(lambda: grid_calls(grid_model()), True)
    assert lpmp_spans(prof_off) == []
    assert lpmp_spans(prof_on)
    assert lbs0 == lbs1 and ub0 == ub1 and np.array_equal(x0, x1)
    assert all(torch.equal(st0[k], st1[k]) for k in st0)
    assert tracing.span("a") is tracing.span("b")       # one shared no-op context
    s_off, prof_off = traced(lambda: solver(True).solve(), False)
    s_on, prof_on = traced(lambda: solver(True).solve(), True)
    assert s_off == s_on and lpmp_spans(prof_off) == []


def test_grid_spans_nest_and_each_sync_lies_in_its_call():
    _, prof = traced(lambda: grid_calls(grid_model()), True)
    names = parents(lpmp_spans(prof))
    count = {}
    for name, _ in names:
        count[name] = count.get(name, 0) + 1
    assert count == {"lpmp.grid.load_state": 1, "lpmp.grid.run_fast": 1,
                     "lpmp.grid.lower_bound": 3, "lpmp.sync.grid.lower_bound": 3,
                     "lpmp.grid.round_primal": 1, "lpmp.sync.grid.round_primal.labels": 1,
                     "lpmp.sync.grid.round_primal.cost": 1}
    want = {"lpmp.sync.grid.lower_bound": "lpmp.grid.lower_bound",
            "lpmp.sync.grid.round_primal.labels": "lpmp.grid.round_primal",
            "lpmp.sync.grid.round_primal.cost": "lpmp.grid.round_primal"}
    for name, parent in names:
        assert parent == want.get(name), (name, parent)


def test_solver_spans_nest_under_solve_and_iteration():
    s = solver(True)
    s.build_engine()
    _, prof = traced(s.solve, True)
    names = parents(lpmp_spans(prof))
    parent_of = {}
    for name, parent in names:
        parent_of.setdefault(name, set()).add(parent)
    assert parent_of["lpmp.solver.solve"] == {None}
    assert parent_of["lpmp.solver.iteration"] == {"lpmp.solver.solve"}
    assert parent_of["lpmp.engine.pass"] == {"lpmp.solver.iteration"}
    assert parent_of["lpmp.engine.primal_pass"] == {"lpmp.solver.iteration"}
    assert parent_of["lpmp.solver.register_primal"] == {"lpmp.solver.iteration"}
    assert parent_of["lpmp.solver.tighten"] == {"lpmp.solver.iteration"}
    assert parent_of["lpmp.engine.evaluate_primal"] == {"lpmp.solver.register_primal"}
    # the bound of the iterations, and the final one after the loop
    assert parent_of["lpmp.engine.lower_bound"] == {"lpmp.solver.iteration", "lpmp.solver.solve"}
    assert parent_of["lpmp.sync.engine.lower_bound"] == {"lpmp.engine.lower_bound"}
    assert parent_of["lpmp.sync.engine.evaluate_primal.ok"] == {"lpmp.engine.evaluate_primal"}
    assert parent_of["lpmp.sync.engine.evaluate_primal.cost"] == {"lpmp.engine.evaluate_primal"}
    assert parent_of["lpmp.sync.aux.lower_bound"] == {"lpmp.solver.iteration", "lpmp.solver.solve"}
    assert parent_of["lpmp.sync.aux.evaluate_primal"] == {"lpmp.solver.register_primal"}
    n_iter = sum(name == "lpmp.solver.iteration" for name, _ in names)
    assert n_iter == s.visitor.cur_iter


@pytest.mark.parametrize("on", [False, True], ids=["off", "on"])
def test_syncs_count_three_bounds_and_a_rounding_as_five(on):
    m = grid_model()
    tracing.enable(on)
    before = tracing.counters()
    for _ in range(3):
        m.lower_bound()
    m.round_primal()
    after = tracing.counters()
    assert after["syncs"] - before["syncs"] == 3 + 2
    by_site = {k: v - before["syncs_by_site"].get(k, 0) for k, v in after["syncs_by_site"].items()}
    assert {k: v for k, v in by_site.items() if v} == {
        "grid.lower_bound": 3, "grid.round_primal.labels": 1, "grid.round_primal.cost": 1}


@pytest.mark.parametrize("tighten", [False, True], ids=["plain", "tightened"])
def test_syncs_of_a_solve_are_its_bounds_and_evaluations(monkeypatch, tighten):
    """Each engine bound waits once, each evaluation twice (its check and its
    cost), each aux bound and evaluation once while triplets are absorbed."""
    calls = {"lb": 0, "eval": 0, "aux": 0}

    def counting(cls, name, key):
        fn = getattr(cls, name)

        def run(self, *a, **k):
            calls[key] += 1
            return fn(self, *a, **k)
        monkeypatch.setattr(cls, name, run)
    counting(Engine, "lower_bound", "lb")
    counting(Engine, "evaluate_primal", "eval")
    aux_bound, aux_eval = AuxPasses.lower_bound, AuxPasses.evaluate_primal

    def aux_counted(fn):
        def run(self, *a, **k):
            calls["aux"] += bool(self.mrf.n) + bool(self.mc.n)
            return fn(self, *a, **k)
        return run
    monkeypatch.setattr(AuxPasses, "lower_bound", aux_counted(aux_bound))
    monkeypatch.setattr(AuxPasses, "evaluate_primal", aux_counted(aux_eval))
    s = solver(tighten)
    s.build_engine()
    before = tracing.counters()
    s.solve()
    after = tracing.counters()
    assert calls["lb"] > 1 and calls["eval"] > 1 and (calls["aux"] > 0) == tighten
    assert after["syncs"] - before["syncs"] == calls["lb"] + 2 * calls["eval"] + calls["aux"]


def test_counters_are_a_copy():
    c = tracing.counters()
    c["syncs"] += 100
    c["syncs_by_site"]["x"] = 1
    d = tracing.counters()
    assert d["syncs"] == c["syncs"] - 100 and "x" not in d["syncs_by_site"]
    assert set(d) == {"captures", "capture_s", "syncs", "syncs_by_site"}
