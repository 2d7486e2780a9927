"""The window's arithmetic: which solves count, the rates, the tail."""
import math

import pytest

from benchmark import window
from benchmark.window import Solve


def solves(durations, t0=100.0, iters=10):
    out, t = [], t0
    for d in durations:
        out.append(Solve(t, t + d, iters, -2.0, -1.0))
        t += d
    return out


def test_a_solve_running_at_the_deadline_is_abandoned():
    ss = solves([1.0, 1.0, 1.0, 5.0])      # the fourth ends at 8 s, after a 6 s window
    assert len(window.counted(ss, 100.0, 6.0)) == 3
    m = window.end_to_end(ss, 100.0, 6.0)
    # rates divide by the window up to the end of the last counted solve (3 s), not 6 s
    assert m["dual_iters_per_s"] == pytest.approx(30 / 3.0)
    assert m["solve_s"] == pytest.approx(1.0)


def test_the_rates_cover_every_second_of_the_window_including_resets():
    # a gap of 0.5 s between solves (a reset) counts against the rate
    ss = [Solve(0.0, 1.0, 100, -2, -1), Solve(1.5, 2.5, 100, -2, -1)]
    m = window.end_to_end(ss, 0.0, 10.0)
    assert m["dual_iters_per_s"] == pytest.approx(200 / 2.5)
    assert m["solve_s"] == pytest.approx(1.25)


def test_final_rel_gap_is_the_mean_over_the_solves():
    ss = [Solve(0, 1, 1, -2.0, -1.0), Solve(1, 2, 1, -1.5, -1.0)]
    assert window.end_to_end(ss, 0, 5)["final_rel_gap"] == pytest.approx((1.0 + 0.5) / 2)


def test_an_empty_window_gives_nothing():
    assert window.end_to_end(solves([7.0]), 100.0, 6.0) == {}


@pytest.mark.parametrize("n, reported", [(199, False), (200, True), (1000, True)])
def test_the_p95_needs_200_solves(n, reported):
    ss = solves([0.01] * n)
    m = window.end_to_end(ss, 100.0, 1e9)
    assert ("solve_s.p95" in m) == reported


def test_p95_is_the_nearest_rank():
    vals = list(range(1, 201))              # 1..200
    assert window.p95(vals) == 190
    assert window.p95(vals[:-1]) is None
    assert math.isclose(window.p95([2.0] * 300), 2.0)
