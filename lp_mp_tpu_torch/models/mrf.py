"""MRF problem constructor (counterpart of ``lp_mp_tpu/models/mrf.py``).

Mirrors the downstream graphical-model constructor API documented by
test/graphical_model.cpp (AddUnaryFactor / AddPairwiseFactor /
AddTighteningTriplet) and the SRMP factor ordering: unaries ordered by
variable index with each pairwise factor between its endpoints
(forward relations u_i -> p -> u_j, LP_MP.h:697-702 usage).
"""
from __future__ import annotations

import numpy as np

from ..factors.potts import PAIRWISE_POTTS
from ..factors.simplex import PAIRWISE_SIMPLEX, TERNARY_SIMPLEX, UNARY_SIMPLEX
from ..graph import FactorGraph, FactorRef
from ..messages.pairwise_triplet import (PAIRWISE_TRIPLET_12,
                                         PAIRWISE_TRIPLET_13,
                                         PAIRWISE_TRIPLET_23)
from ..messages.simplex_marginalization import (UNARY_PAIRWISE_1,
                                                UNARY_PAIRWISE_2,
                                                UNARY_POTTS_1, UNARY_POTTS_2)


def is_potts(m: np.ndarray) -> "float | None":
    """If m == diff * [x1 != x2], return diff, else None."""
    m = np.asarray(m)
    n = m.shape[0]
    if m.shape[1] != n:
        return None
    r = np.ravel(m)
    if np.abs(r[:: n + 1]).max(initial=0.0) > 1e-12:  # diagonal
        return None
    if n < 2:
        return 0.0
    d = float(m[0, 1])
    off = np.abs(r - d)
    off[:: n + 1] = 0.0  # ignore diagonal lanes
    return d if off.max() <= 1e-9 * max(1.0, abs(d)) else None


class _UnaryRefs:
    """List-like view of unary FactorRefs backed by a flat fid list (1e6
    unaries must not cost 1e6 dataclass objects up front)."""

    __slots__ = ("_fids",)

    def __init__(self):
        self._fids: list[int] = []

    def append(self, ref: FactorRef) -> None:
        self._fids.append(ref.fid)

    def extend_fids(self, fids) -> None:
        self._fids.extend(np.asarray(fids).tolist())

    def fids(self) -> np.ndarray:
        return np.asarray(self._fids, dtype=np.int64)

    def __len__(self):
        return len(self._fids)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [FactorRef(UNARY_SIMPLEX, f) for f in self._fids[i]]
        return FactorRef(UNARY_SIMPLEX, self._fids[i])

    def __iter__(self):
        for f in self._fids:
            yield FactorRef(UNARY_SIMPLEX, f)


class MrfConstructor:
    """Problem constructor plugin (solver.hxx:63-67 tuple member analogue)."""

    def __init__(self, graph: FactorGraph, pairwise_rep: str = "auto"):
        assert pairwise_rep in ("auto", "dense", "potts")
        self.graph = graph
        self.pairwise_rep = pairwise_rep
        self.unaries = _UnaryRefs()
        self._pairwise: dict[tuple[int, int], FactorRef] = {}
        self._pair_batches: list = []   # lazily folded into _pairwise
        self.triplets: dict[tuple[int, int, int], FactorRef] = {}
        self._prev_unary: "FactorRef | None" = None

    @property
    def pairwise(self) -> dict:
        """(i, j) -> pairwise FactorRef; batch additions materialize here
        lazily (only tightening/tree code walks this dict)."""
        while self._pair_batches:
            pairs, fids, ft = self._pair_batches.pop(0)
            for (i, j), fid in zip(map(tuple, pairs.tolist()), fids.tolist()):
                self._pairwise[(i, j)] = FactorRef(ft, fid)
        return self._pairwise

    # -- API pinned by test/graphical_model.cpp -----------------------------
    def add_unary_factor(self, costs) -> FactorRef:
        u = self.graph.add_factor(UNARY_SIMPLEX, np.asarray(costs, dtype=np.float64))
        self.unaries.append(u)
        if self._prev_unary is not None:
            # chain relation keeps unaries in variable order (SRMP order)
            self.graph.add_factor_relation(self._prev_unary, u)
        self._prev_unary = u
        return u

    # -- batch construction (10^6-variable models in O(1) Python ops) -------
    def add_unary_factors(self, costs) -> np.ndarray:
        """Batch AddUnaryFactor: ``costs`` [N, L]; variables are appended in
        order.  Returns the global fids."""
        costs = np.asarray(costs, dtype=np.float64)
        fids = self.graph.add_factor_block(UNARY_SIMPLEX, costs, costs.shape[0])
        if self._prev_unary is not None:
            self.graph.add_factor_relation_block(
                np.asarray([self._prev_unary.fid]), fids[:1])
        if len(fids) > 1:
            self.graph.add_factor_relation_block(fids[:-1], fids[1:])
        self.unaries.extend_fids(fids)
        self._prev_unary = FactorRef(UNARY_SIMPLEX, int(fids[-1]))
        return fids

    def _add_pairwise_block(self, pairs, ftype, batch, m1, m2) -> np.ndarray:
        pairs = np.asarray(pairs, dtype=np.int64)
        assert (pairs[:, 0] < pairs[:, 1]).all(), \
            "pairwise factor endpoints must be ordered"
        E = len(pairs)
        fids = self.graph.add_factor_block(ftype, batch, E)
        ufids = self.unaries.fids()
        li, rj = ufids[pairs[:, 0]], ufids[pairs[:, 1]]
        self.graph.add_message_block(m1, li, fids)
        self.graph.add_message_block(m2, rj, fids)
        self.graph.add_factor_relation_block(li, fids)
        self.graph.add_factor_relation_block(fids, rj)
        self._pair_batches.append((pairs, fids, ftype))
        return fids

    def add_pairwise_factors(self, pairs, costs) -> np.ndarray:
        """Batch AddPairwiseFactor with dense costs [E, L1, L2]."""
        costs = np.asarray(costs, dtype=np.float64)
        return self._add_pairwise_block(pairs, PAIRWISE_SIMPLEX, costs,
                                        UNARY_PAIRWISE_1, UNARY_PAIRWISE_2)

    def add_potts_factors(self, pairs, n_labels: int, diffs) -> np.ndarray:
        """Batch AddPairwiseFactor for Potts costs: diff[e] * [x1 != x2]."""
        diffs = np.asarray(diffs, dtype=np.float64)
        return self._add_pairwise_block(pairs, PAIRWISE_POTTS,
                                        (n_labels, diffs),
                                        UNARY_POTTS_1, UNARY_POTTS_2)

    def add_pairwise_factor(self, i: int, j: int, costs) -> FactorRef:
        assert i < j, "pairwise factor endpoints must be ordered"
        assert (i, j) not in self.pairwise
        costs = np.asarray(costs, dtype=np.float64)
        ui, uj = self.unaries[i], self.unaries[j]

        if self.pairwise_rep != "dense":
            diff = is_potts(costs)
        else:
            diff = None
        if self.pairwise_rep == "potts" or diff is not None:
            assert diff is not None, "pairwise_rep='potts' requires Potts costs"
            p = self.graph.add_factor(PAIRWISE_POTTS, (costs.shape[0], diff))
            m1, m2 = UNARY_POTTS_1, UNARY_POTTS_2
        else:
            p = self.graph.add_factor(PAIRWISE_SIMPLEX, costs)
            m1, m2 = UNARY_PAIRWISE_1, UNARY_PAIRWISE_2

        self.graph.add_message(m1, ui, p)
        self.graph.add_message(m2, uj, p)
        self.graph.add_factor_relation(ui, p)
        self.graph.add_factor_relation(p, uj)
        self.pairwise[(i, j)] = p
        return p

    def get_pairwise_factor(self, i: int, j: int) -> FactorRef:
        return self.pairwise[(i, j)]

    def add_tightening_triplet(self, i: int, j: int, k: int) -> FactorRef:
        """Zero-cost ternary simplex coupled to the three pairwise factors
        (test/graphical_model.cpp:140-204).  Pairwise factors must be dense
        (use pairwise_rep='dense' when tightening); missing chord pairwise
        factors are created with zero cost (the reference
        AddTighteningTriplet does the same for triangulated cycles)."""
        assert i < j < k
        key = (i, j, k)
        if key in self.triplets:
            return self.triplets[key]
        li = self._n_labels(i)
        lj = self._n_labels(j)
        lk = self._n_labels(k)
        t = self.graph.add_factor(TERNARY_SIMPLEX, np.zeros((li, lj, lk)))
        for (a, b), mt in (((i, j), PAIRWISE_TRIPLET_12),
                           ((i, k), PAIRWISE_TRIPLET_13),
                           ((j, k), PAIRWISE_TRIPLET_23)):
            if (a, b) not in self.pairwise:
                la, lb = self._n_labels(a), self._n_labels(b)
                saved = self.pairwise_rep
                self.pairwise_rep = "dense"
                try:
                    self.add_pairwise_factor(a, b, np.zeros((la, lb)))
                finally:
                    self.pairwise_rep = saved
            p = self.pairwise[(a, b)]
            assert p.ftype is PAIRWISE_SIMPLEX, \
                "tightening requires dense pairwise factors (pairwise_rep='dense')"
            self.graph.add_message(mt, p, t)
            self.graph.add_factor_relation(p, t)
        # keep the triplet before the last unary so later factors can still
        # receive its mass in the same sweep
        self.graph.add_factor_relation(t, self.unaries[k])
        self.triplets[key] = t
        return t

    def _n_labels(self, i: int) -> int:
        ft, data = self.graph.factors[self.unaries[i].fid]
        return len(data)

    # -- tightening ---------------------------------------------------------
    def tighten(self, engine, max_constraints: int) -> int:
        """Triplet search via frustrated-triangle scoring, then odd-cycle
        separation on the k-projection graph when triangles alone find
        nothing (test/graphical_model.cpp:191-246 acceptance: both the
        3-cycle triplet search and the chordless frustrated 4-cycle must
        close to lb 1.0 through Solve() alone).

        For each triangle of pairwise factors, the guaranteed dual increase
        of adding its triplet is lb(joint triple) - sum of independent
        bounds; chordless frustrated cycles are found by the signed
        projection-graph search (models/cycle_separation.py)."""
        from .cycle_separation import cycle_search
        from .tightening import triplet_search
        added = triplet_search(self, engine, max_constraints)
        if added < max_constraints:
            added += cycle_search(self, engine, max_constraints - added)
        return added


# -- primal extraction -------------------------------------------------------

def mrf_labeling(constructor: MrfConstructor, engine, prim) -> np.ndarray:
    """Per-variable labels from a primal pytree."""
    x = prim[UNARY_SIMPLEX.name]["x"].cpu().numpy()
    return x[engine.f_local[constructor.unaries.fids()]].astype(np.int64)
