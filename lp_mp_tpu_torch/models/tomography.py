"""Discrete tomography problem constructor (counterpart of
``lp_mp_tpu/models/tomography.py``).

Reference surface: downstream ``solvers/discrete_tomography`` (documented by
test/discrete_tomography.cpp): an MRF over the pixels (usually a chain/grid
with Potts regularization) plus ``AddProjection(vars, projection_cost)``
constraints — the cost vector indexes the SUM of the label values along the
ray.  The reference decomposes each projection into a binary tree of
counting factors; here each projection is one batched counting-chain factor
(factors/counting.py) with one message per ray variable.
"""
from __future__ import annotations

import numpy as np

from ..factors.counting import COUNTING_CHAIN
from ..graph import FactorGraph, FactorRef
from ..messages.counting import UNARY_COUNTING
from .mrf import MrfConstructor, mrf_labeling


class DiscreteTomographyConstructor:
    """MRF + projection (counting) constraints."""

    def __init__(self, graph: FactorGraph, pairwise_rep: str = "auto"):
        self.graph = graph
        self.mrf = MrfConstructor(graph, pairwise_rep=pairwise_rep)
        self.projections: list[FactorRef] = []

    # MRF pass-through (reference: the DT FMC embeds the MRF constructor)
    def add_unary_factor(self, costs) -> FactorRef:
        return self.mrf.add_unary_factor(costs)

    def add_pairwise_factor(self, i: int, j: int, costs) -> FactorRef:
        return self.mrf.add_pairwise_factor(i, j, costs)

    # ------------------------------------------------------------------
    def add_projection(self, variables, projection_cost) -> FactorRef:
        """dt.AddProjection(vars, projectionCost): constrain the sum of the
        label values of ``variables``; cost vector over attainable sums."""
        variables = list(variables)
        n_labels = max(self.mrf._n_labels(v) for v in variables)
        pc = np.asarray(projection_cost, dtype=np.float64)
        f = self.graph.add_factor(COUNTING_CHAIN, (len(variables), n_labels, pc))
        for k, v in enumerate(variables):
            self.graph.add_message(UNARY_COUNTING, self.mrf.unaries[v], f, k)
        # order the counting factor between its smallest and largest ray
        # variable (keeps the relation DAG consistent with the unary chain)
        lo, hi = min(variables), max(variables)
        self.graph.add_factor_relation(self.mrf.unaries[lo], f)
        if hi != lo:
            self.graph.add_factor_relation(f, self.mrf.unaries[hi])
        self.projections.append(f)
        return f

    def labeling(self, engine, prim) -> np.ndarray:
        return mrf_labeling(self.mrf, engine, prim)
