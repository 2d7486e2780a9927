"""Solver loop (counterpart of ``lp_mp_tpu/solver.py``).

Replicates ``Solver`` / ``MpRoundingSolver`` (solver.hxx:29-400):

    Begin -> { PreIterate(set repam) ; Iterate(ComputePass[AndPrimal]) ;
               PostIterate(LowerBound, Tighten) } while visitor continues
          -> End -> RegisterPrimal -> best primal available.

The engine runs on the solver's ``device`` (the card unless the caller
passes ``device="cpu"``) in its ``dtype``, its passes captured as CUDA
graphs with ``use_jit`` (the default, as in the JAX package; every engine
the solver builds captures anew, counted in ``tracing.counters()`` beside
the solver's ``n_engine_builds``).  Tightening
grows the factor graph: additions that are triplets on existing pairwise
or edge factors go into the bucketed side passes of ``aux_tighten``
(``self.aux``, run after every engine pass); anything else rebuilds the
engine with the current reparametrization carried over row-wise and the
absorbed triplets folded back in.  With ``tree_decomposition`` and
``tree_decomposition_begin`` it switches, after that many message-passing
iterations, to subgradient ascent over a ``GeneralTreeDecomposition`` on
the same device.  With ``exact_rounding`` ("ilp" or "combilp") every primal
round also runs the exact oracle on the host (``io/ilp.ilp_round`` or
``combilp.combi_lp``, HiGHS through scipy, at most ``exact_time_limit``
seconds per MILP), after folding absorbed triplets back into a rebuilt
engine.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import tracing
from .aux_tighten import AuxPasses
from .config import Direction, entry_device
from .engine import Engine
from .graph import FactorGraph
from .trees_general import GeneralTreeDecomposition, _tmap
from .visitors import StandardVisitor


class Solver:
    def __init__(self, visitor: "StandardVisitor | None" = None,
                 schedule_mode: str = "wavefront",
                 reparametrization_type: str = "shared",
                 inner_iteration: int = 5,
                 exact_rounding: "str | None" = None,
                 exact_time_limit: "float | None" = None,
                 rounding: str = "mp",
                 tree_decomposition: "list | None" = None,
                 tree_decomposition_begin: "int | None" = None,
                 tree_layout: str = "zero_sum",
                 device="cuda", dtype: "torch.dtype | None" = None, use_jit: bool = True):
        if exact_rounding not in (None, "ilp", "combilp"):
            raise ValueError(f"exact_rounding {exact_rounding!r}: None, 'ilp' or 'combilp'")
        self.graph = FactorGraph()
        self.visitor = visitor if visitor is not None else StandardVisitor()
        self.schedule_mode = schedule_mode
        # --reparametrizationType / --innerIteration (LP_MP.h:588-594)
        self.reparametrization_type = reparametrization_type
        self.inner_iteration = inner_iteration
        # exact rounding oracle (LP_sat / combiLP analogue): None, "ilp"
        # (solver.hxx:529-546 SAT rounding) or "combilp" (combiLP.hxx:92-271)
        self.exact_rounding = exact_rounding
        # per-invocation MILP budget for the exact oracles; at the limit the
        # best feasible incumbent is used (time-boxed SAT-rounding analogue)
        self.exact_time_limit = exact_time_limit
        # rounding mode: "mp" = post-receive argmin; "restricted" = argmin
        # conditioned on one-sided restricted messages from fixed neighbors
        # (factors_messages.hxx:513-566)
        assert rounding in ("mp", "restricted")
        self.rounding = rounding
        # --treeDecompositionBegin (tree_decomposition.hxx:918-929): after
        # N message-passing iterations, switch to subgradient ascent over
        # the given tree decomposition, continuing from the reparametrized
        # duals; primal rounds write the decomposition back into the engine
        self.tree_decomposition = tree_decomposition
        self.tree_decomposition_begin = tree_decomposition_begin
        self.tree_layout = tree_layout
        self._tree_state: "dict | None" = None
        self.device = entry_device(device)
        self.dtype = dtype
        self.use_jit = use_jit
        self.constructors: list[Any] = []
        self.engine: "Engine | None" = None
        self.lower_bound_: float = float("-inf")
        self.best_primal_cost: float = float("inf")
        self.best_primal: Any = None
        # incremental tightening (aux_tighten): absorbable triplet additions
        # (MRF ternary or multicut triplets) go into bucketed side passes
        # instead of a full engine rebuild
        self.aux = AuxPasses(use_jit=use_jit)
        self.n_engine_builds = 0

    def add_constructor(self, ctor_cls, **kwargs):
        """GetProblemConstructor analogue (solver.hxx:111-118)."""
        c = ctor_cls(self.graph, **kwargs)
        self.constructors.append(c)
        return c

    # ------------------------------------------------------------------
    @tracing.traced("lpmp.solver.build_engine")
    def build_engine(self) -> Engine:
        old = self.engine
        self.engine = Engine(self.graph, schedule_mode=self.schedule_mode,
                             update_mode=self.reparametrization_type,
                             inner_iteration=self.inner_iteration,
                             device=self.device, dtype=self.dtype, use_jit=self.use_jit)
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
        # absorbed triplet duals become regular engine rows again
        self.aux.fold_into(self.engine)
        return self.engine

    # ------------------------------------------------------------------
    @tracing.traced("lpmp.solver.register_primal")
    def register_primal(self, prim) -> float:
        """Keep best feasible primal (solver.hxx:321-340).  Constructors may
        veto primals the engine-level message checks cannot see (e.g.
        multicut cycle feasibility)."""
        for c in self.constructors:
            if hasattr(c, "check_primal_consistency") and \
                    not c.check_primal_consistency(self.engine, prim):
                return float("inf")
        cost = self.engine.evaluate_primal(prim)
        if self.aux:
            cost += self.aux.evaluate_primal(self.engine, prim)
        if cost < self.best_primal_cost:
            self.best_primal_cost = cost
            self.best_primal = prim
        return cost

    @tracing.traced("lpmp.solver.tighten")
    def tighten(self, max_constraints: int) -> int:
        """Fan out to constructors implementing tighten() (solver.hxx:192-212).

        Additions that are triplets on existing dense pairwise (or multicut
        edge) factors are absorbed into the bucketed aux passes; anything
        else (new chord factors, other types) triggers a full engine
        rebuild."""
        n0, m0 = self.graph.n_factors, len(self.graph.messages)
        added = 0
        for c in self.constructors:
            if hasattr(c, "tighten"):
                added += c.tighten(self.engine, max_constraints - added)
        if added and not self.aux.absorb(self.graph, self.engine, n0, m0):
            self.build_engine()
        return added

    # ------------------------------------------------------------------
    def _tree_iterate(self, c) -> None:
        """One subgradient-ascent step over the tree decomposition
        (LP_subgradient_ascent::ComputePass semantics after the
        --treeDecompositionBegin switch)."""
        ts = self._tree_state
        if ts is None:
            dec = GeneralTreeDecomposition(self.graph, self.tree_decomposition,
                                           layout=self.tree_layout, device=self.device,
                                           dtype=self.engine.dtype, use_jit=self.use_jit)
            dec.load_duals(self.engine)
            ts = self._tree_state = {
                "dec": dec, "w": dec.zeros_like_w(), "k": 0,
                "best": float("-inf"), "best_w": None}
        dec, w = ts["dec"], ts["w"]
        val, g, gnorm = dec.grad_at(w)
        if val > ts["best"]:
            ts["best"], ts["best_w"] = val, w
        if gnorm > 1e-14:
            ub = self.best_primal_cost
            if np.isfinite(ub) and ub > val:
                alpha = (ub - val) / gnorm          # Polyak
            else:
                alpha = 1.0 / np.sqrt(ts["k"] + 1.0)
            ts["w"] = _tmap(lambda wi, gi: wi + alpha * gi, w, g)
        ts["k"] += 1
        if c.compute_primal:
            # write the best decomposition back into the engine and round
            # there (write_back keeps bound, tree_decomposition.hxx:970-988)
            dec.write_back_reparametrization(
                self.engine, dec.to_dual(ts["best_w"] if ts["best_w"] is not None else w))
            prim = self.engine.compute_pass_and_primal(
                c.repam, Direction.forward, restricted=self.rounding == "restricted")
            self.register_primal(prim)
        self.lower_bound_ = max(self.lower_bound_, ts["best"])

    def _exact_round(self, prim) -> None:
        """Run the exact oracle once and keep its primal if it is better."""
        if self.aux:
            # the exact oracles walk the full factor graph: fold the
            # absorbed triplets back into a rebuilt engine first.  The
            # rebuilt engine has blocks the old primal lacks, so combiLP
            # rounds afresh on it (the JAX package hands the old primal on
            # and fails with a KeyError on the folded-in type).
            self.build_engine()
            prim = None
        if self.exact_rounding == "ilp":
            from .io.ilp import ilp_round
            p, _ = ilp_round(self.engine, time_limit=self.exact_time_limit)
        else:
            from .combilp import combi_lp
            p, _ = combi_lp(self.engine, prim=prim, time_limit=self.exact_time_limit)
        if p is not None:
            self.register_primal(p)

    # ------------------------------------------------------------------
    @tracing.traced("lpmp.solver.solve")
    def solve(self) -> float:
        if self.engine is None:
            self.build_engine()
        c = self.visitor.begin(self.engine)
        while not (c.end or c.error):
            with tracing.span("lpmp.solver.iteration"):
                # PreIterate + Iterate (solver.hxx:267-275)
                if (self.tree_decomposition is not None
                        and self.tree_decomposition_begin is not None
                        and self.visitor.cur_iter >= self.tree_decomposition_begin):
                    self._tree_iterate(c)
                    c = self.visitor.visit(c, self.lower_bound_, self.best_primal_cost)
                    continue
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
                    if self.exact_rounding:
                        self._exact_round(prim)
                else:
                    self.engine.compute_pass(c.repam)
                if self.aux:
                    self.aux.run(self.engine)
                # PostIterate (solver.hxx:277-287)
                if c.compute_lower_bound:
                    self.lower_bound_ = self.engine.lower_bound() + self.aux.lower_bound()
                if c.tighten:
                    self.tighten(c.tighten_constraints)
                c = self.visitor.visit(c, self.lower_bound_, self.best_primal_cost)
        ts = self._tree_state
        if ts is not None and ts["best_w"] is not None:
            # final write-back of the best decomposition (End semantics)
            ts["dec"].write_back_reparametrization(self.engine, ts["dec"].to_dual(ts["best_w"]))
        self.lower_bound_ = self.engine.lower_bound() + self.aux.lower_bound()
        if ts is not None:
            self.lower_bound_ = max(self.lower_bound_, ts["best"])
        self.visitor.end(self.lower_bound_, self.best_primal_cost)
        return self.lower_bound_

    # reference naming (solver.hxx:341-346)
    def lower_bound(self) -> float:
        return self.lower_bound_

    def primal_cost(self) -> float:
        return self.best_primal_cost
