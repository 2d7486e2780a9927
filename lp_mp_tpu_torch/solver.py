"""Solver loop (counterpart of ``lp_mp_tpu/solver.py``).

Replicates ``Solver`` / ``MpRoundingSolver`` (solver.hxx:29-400):

    Begin -> { PreIterate(set repam) ; Iterate(ComputePass[AndPrimal]) ;
               PostIterate(LowerBound) } while visitor continues
          -> End -> RegisterPrimal -> best primal available.

The engine runs on the solver's ``device`` in its ``dtype``.  A rebuild
carries the current reparametrization over row-wise.  Tightening (with the
absorbing aux passes), tree decomposition and the exact rounding oracles
are later items of queue 1 in ROADMAP.md; asking for them raises
``NotImplementedError``.  Without them, ``solve`` runs exactly the JAX
``Solver``'s loop with an empty ``AuxPasses``.
"""
from __future__ import annotations

from typing import Any

import torch

from .config import Direction
from .engine import Engine
from .graph import FactorGraph
from .visitors import StandardVisitor

_TIGHTENING = "tightening (with AuxPasses) is queue 1 item 4 of ROADMAP.md, not ported yet"


class Solver:
    def __init__(self, visitor: "StandardVisitor | None" = None,
                 schedule_mode: str = "wavefront",
                 reparametrization_type: str = "shared",
                 inner_iteration: int = 5,
                 exact_rounding: "str | None" = None,
                 rounding: str = "mp",
                 tree_decomposition: "list | None" = None,
                 device="cpu", dtype: "torch.dtype | None" = None):
        if tree_decomposition is not None:
            raise NotImplementedError(
                "tree decomposition is queue 1 item 8 of ROADMAP.md, not ported yet")
        if exact_rounding is not None:
            raise NotImplementedError(
                "exact rounding (ilp, combilp) is queue 1 item 9 of ROADMAP.md, "
                "not ported yet")
        self.graph = FactorGraph()
        self.visitor = visitor if visitor is not None else StandardVisitor()
        self.schedule_mode = schedule_mode
        # --reparametrizationType / --innerIteration (LP_MP.h:588-594)
        self.reparametrization_type = reparametrization_type
        self.inner_iteration = inner_iteration
        # rounding mode: "mp" = post-receive argmin; "restricted" = argmin
        # conditioned on one-sided restricted messages from fixed neighbors
        # (factors_messages.hxx:513-566)
        assert rounding in ("mp", "restricted")
        self.rounding = rounding
        self.device = torch.device(device)
        self.dtype = dtype
        self.constructors: list[Any] = []
        self.engine: "Engine | None" = None
        self.lower_bound_: float = float("-inf")
        self.best_primal_cost: float = float("inf")
        self.best_primal: Any = None
        self.n_engine_builds = 0

    def add_constructor(self, ctor_cls, **kwargs):
        """GetProblemConstructor analogue (solver.hxx:111-118)."""
        c = ctor_cls(self.graph, **kwargs)
        self.constructors.append(c)
        return c

    # ------------------------------------------------------------------
    def build_engine(self) -> Engine:
        old = self.engine
        self.engine = Engine(self.graph, schedule_mode=self.schedule_mode,
                             update_mode=self.reparametrization_type,
                             inner_iteration=self.inner_iteration,
                             device=self.device, dtype=self.dtype)
        self.n_engine_builds += 1
        if old is not None:
            # carry reparametrized duals over: old rows are a prefix of the
            # new blocks and old padded lanes stay padded.  The new blocks
            # are fresh uploads, so writing into them leaves the old state
            # as it was.
            for name, block in old.state.items():
                new_block = self.engine.state[name]
                for k, v in block.items():
                    sl = tuple(slice(0, s) for s in v.shape)
                    new_block[k][sl] = v.to(new_block[k].dtype)
        return self.engine

    # ------------------------------------------------------------------
    def register_primal(self, prim) -> float:
        """Keep best feasible primal (solver.hxx:321-340).  Constructors may
        veto primals the engine-level message checks cannot see."""
        for c in self.constructors:
            if hasattr(c, "check_primal_consistency") and \
                    not c.check_primal_consistency(self.engine, prim):
                return float("inf")
        cost = self.engine.evaluate_primal(prim)
        if cost < self.best_primal_cost:
            self.best_primal_cost = cost
            self.best_primal = prim
        return cost

    def tighten(self, max_constraints: int) -> int:
        raise NotImplementedError(_TIGHTENING)

    # ------------------------------------------------------------------
    def solve(self) -> float:
        if self.engine is None:
            self.build_engine()
        c = self.visitor.begin(self.engine)
        while not (c.end or c.error):
            # PreIterate + Iterate (solver.hxx:267-275)
            if c.compute_primal:
                # MpRoundingSolver::Iterate (solver.hxx:387-397)
                restr = self.rounding == "restricted"
                prim = self.engine.compute_pass_and_primal(
                    c.repam, Direction.forward, restricted=restr)
                self.register_primal(prim)
                prim = self.engine.compute_pass_and_primal(
                    c.repam, Direction.backward, restricted=restr)
                self.register_primal(prim)
                # ProblemConstructorRoundingSolver hook (solver.hxx:402-481):
                # constructors with their own ComputePrimal also get a shot
                for ctor in self.constructors:
                    if hasattr(ctor, "compute_primal"):
                        self.register_primal(ctor.compute_primal(self.engine))
            else:
                self.engine.compute_pass(c.repam)
            # PostIterate (solver.hxx:277-287)
            if c.compute_lower_bound:
                self.lower_bound_ = self.engine.lower_bound()
            if c.tighten:
                raise NotImplementedError(_TIGHTENING)
            c = self.visitor.visit(c, self.lower_bound_, self.best_primal_cost)
        self.lower_bound_ = self.engine.lower_bound()
        self.visitor.end(self.lower_bound_, self.best_primal_cost)
        return self.lower_bound_

    # reference naming (solver.hxx:341-346)
    def lower_bound(self) -> float:
        return self.lower_bound_

    def primal_cost(self) -> float:
        return self.best_primal_cost
