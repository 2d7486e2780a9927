"""The grid loop's stopping rule, on a scripted model and on a tiny grid."""
import math

import torch

from benchmark.drivers import grid_loop
from benchmark.trace import Spans

RULE = {"chunk": 20, "mode": "anisotropic", "round_every": 5, "gap": 1e-4,
        "stall": 1e-5, "stall_chunks": 5, "max_iter": 2000}


class Scripted:
    """A model whose bound after chunk k is ``lbs[k]`` and whose rounding
    gives ``ub``."""

    def __init__(self, lbs, ub=-1.0):
        self.lbs, self.ub, self.calls, self.k = lbs, ub, [], 0

    def run_fast(self, n, mode):
        self.calls.append(("fast", n, mode))
        self.k += 1

    def lower_bound(self):
        return self.lbs[min(self.k, len(self.lbs)) - 1]

    def round_primal(self):
        self.calls.append(("round",))
        return [[0]], self.ub


def run(model, rule=RULE):
    ops = []
    out = grid_loop.solve_loop(model, rule, Spans(False, None), ops)
    return out, ops


def test_stall_ends_the_solve_and_a_last_rounding_follows():
    # the bound gains 1.0 per chunk until chunk 7, then nothing
    lbs = [-1000.0 + min(k, 7) for k in range(1, 30)]
    (iters, lb, ub, _), ops = run(Scripted(lbs, ub=-100.0))
    # chunk 12 is the first whose bound gained < 1e-5|lb| over 5 chunks
    assert sum(op[0] == "fast" for op in ops) == 12
    # roundings after chunks 5 and 10, and a last one after chunk 12
    assert sum(op[0] == "round" for op in ops) == 3 and ops[-1] == ("round",)
    assert iters == 12 * 20 + 3 and lb == lbs[11] and ub == -100.0


def test_a_closed_gap_ends_the_solve_at_a_rounding():
    lbs = [-1000.0 + 10 * k for k in range(1, 100)]
    (iters, lb, ub, _), ops = run(Scripted(lbs, ub=lbs[4] * (1 - 5e-5)))
    assert sum(op[0] == "fast" for op in ops) == 5 and ops[-1] == ("round",)
    assert iters == 5 * 20 + 1


def test_max_iter_caps_the_solve():
    lbs = [-1e6 + 100.0 * k for k in range(1, 500)]
    (iters, *_), ops = run(Scripted(lbs, ub=1e9), dict(RULE, max_iter=400))
    assert sum(op[0] == "fast" for op in ops) == 20


def test_stop_needs_the_whole_stall_window():
    assert not grid_loop.stop([-10.0] * 5, math.inf, 100, RULE)
    assert grid_loop.stop([-10.0] * 6, math.inf, 120, RULE)


def test_the_loop_on_a_tiny_grid_ends_by_its_rule():
    from lp_mp_tpu_torch.models.grid_potts import GridPottsModel

    from benchmark.generators import potts_grid
    inst = potts_grid.make({"H": 12, "W": 14, "L": 3}, seed=5)
    m = GridPottsModel(inst["unary"], inst["hc"], inst["vc"], device="cpu",
                       dtype=torch.float32)
    (iters, lb, ub, x), ops = run(m, dict(RULE, chunk=4))
    chunks = sum(op[0] == "fast" for op in ops)
    assert iters == 4 * chunks + sum(op[0] == "round" for op in ops)
    assert lb <= ub + 1e-4 * abs(ub)
    assert x.shape == (12, 14)
    assert chunks * 4 < 2000
