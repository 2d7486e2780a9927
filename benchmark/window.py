"""The measured window: which solves count, and the end-to-end metrics.

The loop is closed: the next solve starts when the last one ends.  The
window starts before the first timed solve and ends at the end of the last
solve that completes within ``seconds``; a solve still running at that
point is abandoned and not counted.  Every rate and mean divides by the
window from its start to that end, so a slow solve cannot be hidden by
rounding a partial count.
"""
from __future__ import annotations

import dataclasses
import math

# a tail needs ten samples beyond it: the 95th percentile needs 200 solves
P95_MIN_SOLVES = 200
# what ``end_to_end`` measures; an end-to-end metric named ``<quantity>.<suffix>``
# reports ``<quantity>``, so that cells can hold one quantity to bounds of their own
QUANTITIES = ("dual_iters_per_s", "solve_s", "solve_s.p95", "final_rel_gap")


@dataclasses.dataclass
class Solve:
    """One solve as the window saw it."""
    start: float          # host clock, seconds
    end: float
    iterations: int       # dual iterations (passes) it ran
    lb: float             # final lower bound
    ub: float             # best upper bound
    ok: bool = True       # finished without error and with finite bounds


def counted(solves: list, t0: float, seconds: float) -> list:
    """The solves that ended within ``seconds`` of ``t0``."""
    return [s for s in solves if s.end - t0 <= seconds]


def p95(values: list) -> "float | None":
    """Nearest-rank 95th percentile, or None below ``P95_MIN_SOLVES`` values."""
    if len(values) < P95_MIN_SOLVES:
        return None
    v = sorted(values)
    return v[math.ceil(0.95 * len(v)) - 1]


def rel_gap(lb: float, ub: float) -> float:
    return (ub - lb) / abs(ub)


def end_to_end(solves: list, t0: float, seconds: float) -> dict:
    """{metric: value} over the counted solves of a window started at
    ``t0``; empty where no solve completed within it."""
    done = counted(solves, t0, seconds)
    if not done:
        return {}
    window = max(s.end for s in done) - t0
    out = {"dual_iters_per_s": sum(s.iterations for s in done) / window,
           "solve_s": window / len(done),
           "final_rel_gap": sum(rel_gap(s.lb, s.ub) for s in done) / len(done)}
    tail = p95([s.end - s.start for s in done])
    if tail is not None:
        out["solve_s.p95"] = tail
    return out
