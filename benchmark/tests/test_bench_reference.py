"""The plain references on tiny instances: against brute force, and against
the program in float64 where both follow the same schedule."""
import itertools

import numpy as np
import pytest
import torch

from benchmark.generators import potts_grid
from benchmark.reference import potts_grid as pref

F64 = torch.float64


def brute_potts(inst):
    u, hc, vc = inst["unary"], inst["hc"], inst["vc"]
    H, W, L = u.shape
    best = np.inf
    for lab in itertools.product(range(L), repeat=H * W):
        x = np.asarray(lab).reshape(H, W)
        best = min(best, pref.PottsGrid(u, hc, vc, dtype=F64).energy(x))
    return best


def test_potts_bounds_hold_and_the_state_stays_a_reparametrization():
    inst = potts_grid.make({"H": 2, "W": 4, "L": 3}, seed=3)
    g = pref.PottsGrid(inst["unary"], inst["hc"], inst["vc"], dtype=F64)
    opt = brute_potts(inst)
    s = g.initial()
    prev = g.lower_bound(s)
    for mode in ("anisotropic", "uniform", "damped_uniform"):
        s = g.run_fast(s, 3, mode)
        lb = g.lower_bound(s)
        assert prev - 1e-12 <= lb <= opt + 1e-12
        prev = lb
    s, x = g.rounding_pass(s)
    assert g.lower_bound(s) <= opt + 1e-12 <= g.energy(x.numpy()) + 2e-12
    # the cost of a labelling read from the state is its original cost
    assert g.state_energy(s, x) == pytest.approx(g.energy(x.numpy()), abs=1e-12)


def test_potts_replay_follows_the_program_in_float64():
    from lp_mp_tpu_torch.models.grid_potts import GridPottsModel
    inst = potts_grid.make({"H": 7, "W": 9, "L": 4}, seed=8)
    m = GridPottsModel(inst["unary"], inst["hc"], inst["vc"], device="cpu", dtype=F64)
    ops = []
    for mode in ("anisotropic", "uniform"):
        m.run_fast(5, mode)
        ops.append(("fast", 5, mode))
    x, ub = m.round_primal()
    ops += [("round",), ("lb",)]
    g = pref.PottsGrid(inst["unary"], inst["hc"], inst["vc"], dtype=F64)
    lb, best, bx = pref.replay(g, ops)
    assert lb == pytest.approx(m.lower_bound(), rel=1e-12)
    assert best == pytest.approx(ub, rel=1e-12) and (bx == x).all()


def test_potts_engine_sweeps_follow_the_coloured_engine_in_float64():
    from lp_mp_tpu_torch import MrfConstructor
    from lp_mp_tpu_torch.config import Direction
    from lp_mp_tpu_torch.engine import Engine
    from lp_mp_tpu_torch.graph import FactorGraph
    inst = potts_grid.make({"H": 6, "W": 8, "L": 3}, seed=2)
    g = FactorGraph()
    c = MrfConstructor(g)
    c.add_unary_factors(inst["unary"].reshape(48, 3))
    pairs, diffs = potts_grid.grid_edges(inst["hc"], inst["vc"])
    c.add_potts_factors(pairs, 3, diffs)
    e = Engine(g, schedule_mode="coloring", device="cpu", dtype=F64)
    for _ in range(3):
        e.compute_pass("anisotropic")
    e.compute_pass_and_primal("damped_uniform", Direction.forward)
    ops = [("pass", "anisotropic")] * 3 + [("primal", "damped_uniform", "forward"), ("lb",)]
    lb, _, _ = pref.replay(pref.PottsGrid(inst["unary"], inst["hc"], inst["vc"], dtype=F64), ops)
    assert lb == pytest.approx(e.lower_bound(), rel=1e-12)


def test_the_judge_reads_a_worse_rounding_that_reports_its_own_cost():
    """``best_ub_rel`` compares the program's best cost with the reference's
    best rounding after the same calls: the program's own answer reads
    nothing in float64, a labelling of an earlier state with its true cost
    reads the gap between the two roundings, which ``ub_rel`` cannot see."""
    from lp_mp_tpu_torch.models.grid_potts import GridPottsModel
    inst = potts_grid.make({"H": 12, "W": 14, "L": 4}, seed=5)
    m = GridPottsModel(inst["unary"], inst["hc"], inst["vc"], device="cpu", dtype=F64)
    stale, _ = m.round_primal()
    m.run_fast(30, "anisotropic")
    x, ub = m.round_primal()
    m_lb = m.lower_bound()
    ops = [("round",), ("fast", 30, "anisotropic"), ("round",), ("lb",)]
    g = pref.PottsGrid(inst["unary"], inst["hc"], inst["vc"], dtype=F64)
    e_stale = g.energy(stale)
    sound = pref.judge_grid([inst], [{"instance": 0, "ops": ops, "lb": m_lb, "ub": ub, "x": x}],
                            "cpu")
    assert max(sound.values()) < 1e-5, sound
    wrong = pref.judge_grid([inst], [{"instance": 0, "ops": ops, "lb": m_lb, "ub": e_stale,
                                      "x": stale}], "cpu")
    assert wrong["ub_rel"] < 1e-12 and wrong["lb_rel"] < 1e-5 < wrong["best_ub_rel"], wrong
