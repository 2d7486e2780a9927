"""Solves through ``Solver.solve()``: the generic engine's path.

Set-up makes the configuration's first instance (its first
``instance_seeds``: every ``--seed`` gives the window the same work; the
seed draws the solves that are compared), poses it to a ``Solver`` (the
generator's ``pose``), builds
its engine, runs the generator's ``prepare`` (a tightening round at
set-up, where the configuration has one) and snapshots the engine's dual
state (``checkpoint.snapshot``).  Each solve restores that state
(``checkpoint.restore``), forgets the best primal and the bound, and calls
``Solver.solve()`` with a fresh ``StandardVisitor`` whose keywords are the
traffic's ``visitor``; ``min_dual_improvement_rel`` sets
``min_dual_improvement`` to that share of |lb| after
``min_dual_improvement_after`` anisotropic iterations from the initial
state, measured at set-up.

The benchmark records the calls each solve makes into the engine (its
iterations, labelling sweeps and bounds) so that the reference can replay
them, and wraps spans around them in a traced run.

Traffic keys: schedule_mode, visitor, min_dual_improvement_rel,
min_dual_improvement_after, check_solves, limits.
"""
from __future__ import annotations

import gc
import math
import time

from ..window import Solve


def _mode(m) -> str:
    return getattr(m, "value", m)


class Runner:
    def __init__(self, ctx):
        import torch
        from lp_mp_tpu_torch import Solver, native
        from lp_mp_tpu_torch.checkpoint import restore, snapshot

        self.ctx, t = ctx, ctx.traffic
        self._restore = restore
        with ctx.split("native_library"):
            native.get_lib()
        with ctx.split("instances"):
            self.instance = ctx.generator.make(ctx.config, ctx.config["instance_seeds"][0])
        with ctx.split("engine_build"):
            self.solver = Solver(visitor=self._visitor(0.0), schedule_mode=t["schedule_mode"],
                                 device=ctx.device, dtype=torch.float32, use_jit=True)
            self.problem = ctx.generator.pose(self.solver, self.instance, ctx.config)
            self.solver.build_engine()
        with ctx.split("prepare"):
            self.prepared = ctx.generator.prepare(self.solver, self.problem, ctx.config)
            ctx.sync()
        self.engine = self.solver.engine
        self.snap = snapshot(self.engine)
        self.min_dual_improvement = 0.0
        if t.get("min_dual_improvement_rel"):
            with ctx.split("capture_and_warmup"):
                for _ in range(t["min_dual_improvement_after"]):
                    self.engine.compute_pass("anisotropic")
                lb = self.engine.lower_bound()
                self.min_dual_improvement = t["min_dual_improvement_rel"] * abs(lb)
        self._ops = []
        self._wrap()
        self.answers = {}
        # every call the window makes, captured here: a solve of two
        # iterations runs a pass, the rounding sweeps and the bounds
        with ctx.split("capture_and_warmup"):
            self.solve(0, record=False, max_iter=2)
            ctx.sync()

    def _visitor(self, min_dual_improvement: float, max_iter: "int | None" = None):
        from lp_mp_tpu_torch import StandardVisitor
        kw = dict(self.ctx.traffic["visitor"])
        if min_dual_improvement:
            kw["min_dual_improvement"] = min_dual_improvement
        if max_iter is not None:
            kw["max_iter"] = max_iter
        return StandardVisitor(**kw)

    def _wrap(self) -> None:
        """Record the solve's calls into the engine, with spans around them."""
        eng, solver, spans, ops = self.engine, self.solver, self.ctx.spans, self._ops
        compute_pass, primal_pass = eng.compute_pass, eng.compute_pass_and_primal
        lower_bound, register = eng.lower_bound, solver.register_primal

        def pass_(mode):
            ops.append(("pass", _mode(mode)))
            return compute_pass(mode)

        def primal_(mode, direction, restricted=False):
            ops.append(("primal", _mode(mode), _mode(direction)))
            with spans("rounding", sync=True):
                return primal_pass(mode, direction, restricted=restricted)

        def bound_():
            ops.append(("lb",))
            with spans("lb_sync"):
                return lower_bound()

        def register_(prim):
            with spans("rounding", sync=True):
                return register(prim)
        eng.compute_pass, eng.compute_pass_and_primal = pass_, primal_
        eng.lower_bound, solver.register_primal = bound_, register_
        for c in solver.constructors:
            if hasattr(c, "compute_primal"):
                gaec = c.compute_primal

                def compute_primal_(engine, gaec=gaec):
                    with spans("rounding", sync=True):
                        return gaec(engine)
                c.compute_primal = compute_primal_

    def solve(self, k: int, record: bool = True, max_iter: "int | None" = None) -> Solve:
        s, spans = self.solver, self.ctx.spans
        t0 = time.perf_counter()
        with spans("reset"):
            self._restore(self.engine, self.snap)
            s.best_primal_cost, s.best_primal, s.lower_bound_ = math.inf, None, -math.inf
            s.visitor = self._visitor(self.min_dual_improvement, max_iter)
            visit = s.visitor.visit

            def visit_(*a, **kw):
                with spans("visitor"):
                    return visit(*a, **kw)
            s.visitor.visit = visit_
        self._ops.clear()
        lb = s.solve()
        ub = s.best_primal_cost
        end = time.perf_counter()
        iters = sum(1 for op in self._ops if op[0] == "pass") \
            + sum(1 for op in self._ops if op[0] == "primal") // 2
        ok = math.isfinite(lb) and math.isfinite(ub)
        if record:
            self.answers[k] = {"ops": list(self._ops), "lb": lb, "ub": ub,
                               "x": self.ctx.generator.labels(self.problem, self.engine,
                                                              s.best_primal)}
        return Solve(t0, end, iters, lb, ub, ok)

    def free(self) -> None:
        self.solver = self.engine = self.snap = self.problem = None
        gc.collect()

    def judge(self, sample: list, dtype=None) -> dict:
        from ..harness import load_module
        ref = load_module("reference", self.ctx.config["generator"])
        return ref.judge_solver(self.instance, self.prepared,
                                [self.answers[k] for k in sample], self.ctx.device, dtype)
