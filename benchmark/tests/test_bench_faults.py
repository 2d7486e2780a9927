"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a tiny size (``harness.measure`` and ``harness.verdict``
with the cell's committed limits), once sound and once for each fault the
cell can have: a step that returns its state unchanged, half of the work
left out, and an answer altered where it is produced (a bound or a cost off,
or a stale labelling reported with its true cost).  (One card: no exchange
between cards to leave out.)"""
import numpy as np
import pytest
import torch

from benchmark import harness

SIZES = {"potts_grid_1000.kernel": {"H": 24, "W": 30},
         "potts_grid_1000.uniform": {"H": 24, "W": 30},
         "potts_grid_1000.engine": {"H": 24, "W": 30}}


def run_cell(workload):
    cs = harness.cell_spec(harness.load_spec(), workload)
    cs["config"].update(SIZES[workload])
    if "pool" in cs["traffic"]:
        cs["traffic"]["pool"] = 2
    else:
        # the cell's "auto" schedule colours its 10^5-10^6 factors; at this
        # size "auto" would pick the wavefront
        cs["traffic"]["schedule_mode"] = "coloring"
        cs["traffic"]["visitor"]["max_iter"] = min(cs["traffic"]["visitor"]["max_iter"], 60)
    rec = harness.measure(cs, 2**31 + 11, 3.0, False, torch.device("cpu"), log=lambda m: None)
    return harness.verdict(rec, cs["traffic"]["limits"])


def grid_faults(monkeypatch):
    """Faults of the grid model: the step leaves the state as it was; the
    step's result kept for the top half of the rows only; the bound, or the
    rounded cost, off by a thousandth where it is produced; a stale
    labelling reported with its true cost."""
    from lp_mp_tpu_torch.models.grid_potts import GridPottsModel
    run_fast, lb, rnd = GridPottsModel.run_fast, GridPottsModel.lower_bound, \
        GridPottsModel.round_primal

    def unchanged():
        monkeypatch.setattr(GridPottsModel, "run_fast", lambda self, *a, **k: self)

    def half_left_out():
        def half(self, *a, **k):
            keep = {key: v[:, self.H // 2:].clone() for key, v in self.state.items()}
            run_fast(self, *a, **k)
            for key, v in self.state.items():
                v[:, self.H // 2:] = keep[key]
            return self
        monkeypatch.setattr(GridPottsModel, "run_fast", half)

    def bound_altered():
        monkeypatch.setattr(GridPottsModel, "lower_bound",
                            lambda self: lb(self) + 1e-3 * abs(lb(self)))

    def cost_altered():
        def r(self, *a, **k):
            x, ub = rnd(self, *a, **k)
            return x, ub - 1e-3 * abs(ub)
        monkeypatch.setattr(GridPottsModel, "round_primal", r)

    def stale_labels():
        # every rounding runs, but reports the labelling of the model's first
        # one (the set-up's, after one chunk) with that labelling's cost
        def r(self, *a, **k):
            x, ub = rnd(self, *a, **k)
            if not hasattr(self, "_stale"):
                self._stale = (np.array(x), ub)
            return self._stale
        monkeypatch.setattr(GridPottsModel, "round_primal", r)
    return {"unchanged": unchanged, "half_left_out": half_left_out,
            "bound_altered": bound_altered, "cost_altered": cost_altered,
            "stale_labels": stale_labels}


def engine_faults(monkeypatch):
    """The same faults in the generic engine: its iteration, the first half
    of each state block's rows, its bound, its primal's cost, and a stale
    primal (the first the solver was given) registered in place of each."""
    from lp_mp_tpu_torch import Solver
    from lp_mp_tpu_torch.engine import Engine
    lb, ev, step = Engine.lower_bound, Engine.evaluate_primal, Engine.compute_pass

    def unchanged():
        monkeypatch.setattr(Engine, "compute_pass", lambda self, mode: None)

    def half_left_out():
        def half(self, mode):
            before = self.get_state()
            step(self, mode)
            after = self.get_state()
            for name, block in after.items():
                for k, v in block.items():
                    v[v.shape[0] // 2:] = before[name][k][v.shape[0] // 2:]
            self.set_state(after)
        monkeypatch.setattr(Engine, "compute_pass", half)

    def bound_altered():
        monkeypatch.setattr(Engine, "lower_bound", lambda self: lb(self) + 1e-3 * abs(lb(self)))

    def cost_altered():
        monkeypatch.setattr(Engine, "evaluate_primal",
                            lambda self, p: ev(self, p) - 1e-3 * abs(ev(self, p)))

    def stale_labels():
        register = Solver.register_primal

        def r(self, prim):
            if not hasattr(self, "_stale"):
                self._stale = {k: v.clone() if torch.is_tensor(v) else v
                               for k, v in prim.items()}
            return register(self, self._stale)
        monkeypatch.setattr(Solver, "register_primal", r)
    return {"unchanged": unchanged, "half_left_out": half_left_out,
            "bound_altered": bound_altered, "cost_altered": cost_altered,
            "stale_labels": stale_labels}


FAULTS = ("unchanged", "half_left_out", "bound_altered", "cost_altered", "stale_labels")


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_sound_run_is_correct(workload):
    good, checks = run_cell(workload)
    assert good, checks


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_fault_makes_the_run_not_correct(workload, fault, monkeypatch):
    faults = (engine_faults if workload.endswith(".engine") else grid_faults)(monkeypatch)
    faults[fault]()
    good, checks = run_cell(workload)
    assert not good, checks
