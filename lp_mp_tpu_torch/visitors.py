"""Control/observability visitors (copy of ``lp_mp_tpu/visitors.py``).

Python replicas of StandardVisitor / StandardTighteningVisitor
(visitors/standard_visitor.hxx): each ``visit`` prints one iteration line,
decides termination (iteration limit, gap closed, timeout, dual stall) and
schedules primal/lower-bound computation and the reparametrization mode for
the next iteration.  Knob names and defaults match the reference CLI
(standard_visitor.hxx:32-44, 263-276).  The gap test's eps follows the
engine's dtype (``config.eps_for``), as the JAX package's follows its global
dtype.
"""
from __future__ import annotations

import dataclasses
import os
import time

from . import config
from .config import LpControl, ReparametrizationMode


def _memory_used_mb() -> float:
    """Process RSS in MB (reference mem_use.c, via /proc — Linux only;
    returns 0 where unavailable so the cap never misfires)."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024)
    except (OSError, ValueError, IndexError):
        return 0.0


@dataclasses.dataclass
class StandardVisitor:
    max_iter: int = 1000
    timeout: float = float("inf")
    max_memory_mb: float = float("inf")
    primal_computation_interval: int = 5
    primal_computation_start: int = 1
    lower_bound_computation_interval: int = 1
    min_dual_improvement: float = 0.0
    min_dual_improvement_interval: int = 10
    standard_reparametrization: ReparametrizationMode = ReparametrizationMode.anisotropic
    rounding_reparametrization: ReparametrizationMode = ReparametrizationMode.damped_uniform
    log_fn: "callable | None" = None   # called with per-iteration record dict

    def __post_init__(self):
        self.standard_reparametrization = ReparametrizationMode.convert(
            self.standard_reparametrization)
        self.rounding_reparametrization = ReparametrizationMode.convert(
            self.rounding_reparametrization)

    def begin(self, lp) -> LpControl:
        self._eps = config.eps_for(getattr(lp, "dtype", None))
        self.cur_iter = 0
        self.remaining_iter = self.max_iter
        self.lower_bounds: list[float] = []
        self.begin_time = time.monotonic()
        return LpControl(repam=self.standard_reparametrization,
                         compute_primal=False, compute_lower_bound=True)

    def visit(self, c: LpControl, lower_bound: float, primal_bound: float) -> LpControl:
        self.lower_bounds.append(lower_bound)
        elapsed = time.monotonic() - self.begin_time

        if (c.compute_primal or c.compute_lower_bound):
            rec = {"iteration": self.cur_iter, "time_ms": elapsed * 1000.0,
                   "lower_bound": lower_bound if c.compute_lower_bound else None,
                   "upper_bound": primal_bound if c.compute_primal else None}
            if self.log_fn is not None:
                self.log_fn(rec)
            if config.diagnostics():
                line = f"iteration = {self.cur_iter}"
                if c.compute_lower_bound:
                    line += f", lower bound = {lower_bound:.6f}"
                if c.compute_primal:
                    line += f", upper bound = {primal_bound:.6f}"
                print(line + f", time elapsed = {elapsed:.2f}s")

        self.cur_iter += 1
        self.remaining_iter -= 1
        ret = LpControl()

        if self.remaining_iter == 0:
            ret.end = True
            return ret
        if primal_bound <= lower_bound + self._eps:
            ret.end = True
            return ret
        if elapsed >= self.timeout:
            self.remaining_iter = min(1, self.remaining_iter)
        if self.max_memory_mb < float("inf"):
            # --maxMemory RSS enforcement (standard_visitor.hxx:156-162,
            # mem_use.c): one final rounding iteration, then terminate
            used = _memory_used_mb()
            if used > self.max_memory_mb:
                if config.diagnostics():
                    print(f"Solver uses {used:.0f} MB memory, "
                          "aborting optimization")
                self.remaining_iter = min(1, self.remaining_iter)
        if (c.compute_lower_bound and self.min_dual_improvement > 0 and
                self.cur_iter >= self.min_dual_improvement_interval and
                len(self.lower_bounds) >= self.min_dual_improvement_interval + 1):
            prev = self.lower_bounds[-1 - self.min_dual_improvement_interval]
            if lower_bound - prev < self.min_dual_improvement:
                self.remaining_iter = min(1, self.remaining_iter)

        if self.remaining_iter == 1:
            return LpControl(repam=self.rounding_reparametrization,
                             compute_primal=True, compute_lower_bound=True)

        ret.repam = self.standard_reparametrization
        if (self.cur_iter >= self.primal_computation_start and
                (self.cur_iter - self.primal_computation_start)
                % self.primal_computation_interval == 0):
            ret.compute_primal = True
            ret.repam = self.rounding_reparametrization
        if self.cur_iter % self.lower_bound_computation_interval == 0:
            ret.compute_lower_bound = True
        return ret

    def end(self, lower_bound: float, upper_bound: float) -> None:
        if config.diagnostics():
            elapsed = time.monotonic() - self.begin_time
            print(f"final lower bound = {lower_bound}, upper bound = {upper_bound}")
            print(f"Optimization took {elapsed * 1000:.0f} ms and {self.cur_iter} iterations.")


@dataclasses.dataclass
class StandardTighteningVisitor(StandardVisitor):
    """Adds tightening scheduling (standard_visitor.hxx:256-403)."""

    tighten: bool = False
    tighten_reparametrization: ReparametrizationMode = ReparametrizationMode.damped_uniform
    tighten_iteration: int = 2 ** 62
    tighten_interval: int = 2 ** 62
    tighten_constraints_max: int = 20
    tighten_min_dual_improvement: float = float("inf")
    tighten_min_dual_improvement_interval: int = 2 ** 62
    tighten_slope: "float | None" = None

    def __post_init__(self):
        super().__post_init__()
        self.tighten_reparametrization = ReparametrizationMode.convert(
            self.tighten_reparametrization)

    def begin(self, lp) -> LpControl:
        self.last_tighten_iteration = 0
        self.iteration_after_tightening = 2
        self.tighten_slope_ref = float("-inf")
        self.prev_lower_bound = float("-inf")
        return super().begin(lp)

    def _set_tighten(self, c: LpControl) -> LpControl:
        c.tighten = True
        c.tighten_constraints = self.tighten_constraints_max
        c.repam = self.tighten_reparametrization
        self.last_tighten_iteration = self.cur_iter
        self.iteration_after_tightening = 0
        self.tighten_slope_ref = float("-inf")
        return c

    def visit(self, c: LpControl, lower_bound: float, primal_bound: float) -> LpControl:
        ret = super().visit(c, lower_bound, primal_bound)
        if self.tighten and not ret.end:
            self.iteration_after_tightening += 1
            cur_slope = max(lower_bound - self.prev_lower_bound, 0.0)
            if self.iteration_after_tightening == 2:
                self.tighten_slope_ref = cur_slope
            trigger_slope = (self.tighten_slope is not None and
                             cur_slope < self.tighten_slope * self.tighten_slope_ref)
            if (self.cur_iter >= self.tighten_iteration and
                    (self.cur_iter >= self.last_tighten_iteration + self.tighten_interval
                     or trigger_slope)):
                ret = self._set_tighten(ret)
            elif (self.cur_iter < self.tighten_iteration and
                  c.compute_lower_bound and
                  self.cur_iter > self.tighten_min_dual_improvement_interval
                  + self.last_tighten_iteration and
                  self.tighten_min_dual_improvement < float("inf")):
                n = self.tighten_min_dual_improvement_interval
                if len(self.lower_bounds) >= n + 1:
                    prev = self.lower_bounds[-1 - n]
                    if lower_bound - prev < self.tighten_min_dual_improvement:
                        ret = self._set_tighten(ret)
        self.prev_lower_bound = lower_bound
        return ret
