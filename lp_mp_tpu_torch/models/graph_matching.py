"""Graph matching (QAP) problem constructor (counterpart of
``lp_mp_tpu/models/graph_matching.py``).

Reference surface: downstream ``solvers/graph_matching/graph_matching.h``
(documented by test/graph_matching.cpp).  The reference offers several FMCs:

- ``FMC_GM``   — one MRF over the left nodes; uniqueness of right nodes is
  enforced by +inf entries in pairwise potentials between left nodes that
  share a candidate right node.
- ``FMC_MP``   — MRFs over BOTH sides coupled by equality messages per
  assignment (the "graph matching via message passing" construction).
- ``FMC_MCF``  — adds a min-cost-flow assignment subproblem; here the MCF
  solver is the host-side rounding oracle (utils.mincostflow), which plays
  the same role: producing feasible matchings from the reparametrized costs.

Label convention: left node i's labels enumerate its allowed assignments in
insertion order, plus a final "slack" (unmatched) label; symmetrically for
right nodes in the both-sides construction.

Rounding is host code on float64 values: it reads the unary block with one
device-to-host copy (``convert.host_array``), and its primal goes back to
the engine's device as int32 tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from ..convert import host_array
from ..factors.simplex import PAIRWISE_SIMPLEX, UNARY_SIMPLEX
from ..graph import FactorGraph, FactorRef
from ..io.torresani import GraphMatchingInput
from ..messages.equality import EQUALITY
from ..messages.simplex_marginalization import UNARY_PAIRWISE_1, UNARY_PAIRWISE_2
from ..utils.mincostflow import solve_assignment

FORBIDDEN = 1e12  # reference uses 1e13-ish entries for forbidden labels


class GraphMatchingConstructor:
    """Builds the factor graph for one matching instance.

    construction:
      - "left": FMC_GM style (single MRF + uniqueness pairwise potentials)
      - "both": FMC_MP style (two MRFs + equality messages); uniqueness is
        carried by the right-side simplices, so no inf-pairwise is needed
        between left nodes that merely share a right candidate.
    """

    def __init__(self, graph: FactorGraph, construction: str = "left"):
        assert construction in ("left", "both")
        self.graph = graph
        self.construction = construction
        self.inp: "GraphMatchingInput | None" = None
        self.left_unaries: list[FactorRef] = []
        self.right_unaries: list[FactorRef] = []
        self.left_labels: list[list[int]] = []   # right node per label
        self.right_labels: list[list[int]] = []  # left node per label
        self.pairwise: dict[tuple[int, int], FactorRef] = {}
        self._pw_cost: dict[tuple[int, int], np.ndarray] = {}
        self._inst_arrays = None

    # ------------------------------------------------------------------
    def construct(self, inp: GraphMatchingInput) -> None:
        self.inp = inp
        n0, n1 = inp.n_left, inp.n_right
        self.left_labels = [[] for _ in range(n0)]
        self.right_labels = [[] for _ in range(n1)]
        left_cost: list[list[float]] = [[] for _ in range(n0)]
        aid_pos: list[tuple[int, int]] = []  # (left label idx, right label idx)
        self._aid_pos = aid_pos
        for (i, j, c) in inp.assignments:
            aid_pos.append((len(self.left_labels[i]), len(self.right_labels[j])))
            self.left_labels[i].append(j)
            self.right_labels[j].append(i)
            left_cost[i].append(c)

        prev = None
        for i in range(n0):
            vec = np.asarray(left_cost[i] + [0.0])  # + slack label
            u = self.graph.add_factor(UNARY_SIMPLEX, vec)
            self.left_unaries.append(u)
            if prev is not None:
                self.graph.add_factor_relation(prev, u)
            prev = u
        if self.construction == "both":
            for j in range(n1):
                vec = np.zeros(len(self.right_labels[j]) + 1)
                u = self.graph.add_factor(UNARY_SIMPLEX, vec)
                self.right_unaries.append(u)
                if prev is not None:
                    self.graph.add_factor_relation(prev, u)
                prev = u
            # equality messages per assignment
            for aid, (i, j, _) in enumerate(inp.assignments):
                li, ri = aid_pos[aid]
                self.graph.add_message(EQUALITY, self.left_unaries[i],
                                       self.right_unaries[j], (li, ri))

        # pairwise: e-line costs ...
        for (a1, a2, c) in inp.edges:
            i1, j1, _ = inp.assignments[a1]
            i2, j2, _ = inp.assignments[a2]
            if i1 == i2:
                continue  # both assignments share a left node: never co-active
            if i1 > i2:
                (i1, a1, i2, a2) = (i2, a2, i1, a1)
            pw = self._get_pairwise_cost(i1, i2)
            pw[self._assignment_label(a1), self._assignment_label(a2)] += c

        # ... and uniqueness (left construction only)
        if self.construction == "left":
            by_right: dict[int, list[tuple[int, int]]] = {}
            for aid, (i, j, _) in enumerate(inp.assignments):
                by_right.setdefault(j, []).append((i, self._assignment_label(aid)))
            for j, lst in by_right.items():
                for x in range(len(lst)):
                    for y in range(x + 1, len(lst)):
                        (ia, la), (ib, lb) = lst[x], lst[y]
                        if ia == ib:
                            continue
                        if ia > ib:
                            (ia, la), (ib, lb) = (ib, lb), (ia, la)
                        pw = self._get_pairwise_cost(ia, ib)
                        pw[la, lb] = FORBIDDEN

        # materialize pairwise factors with their messages
        for (i1, i2), cost in sorted(self._pw_cost.items()):
            p = self.graph.add_factor(PAIRWISE_SIMPLEX, cost)
            self.graph.add_message(UNARY_PAIRWISE_1, self.left_unaries[i1], p)
            self.graph.add_message(UNARY_PAIRWISE_2, self.left_unaries[i2], p)
            self.graph.add_factor_relation(self.left_unaries[i1], p)
            self.graph.add_factor_relation(p, self.left_unaries[i2])
            self.pairwise[(i1, i2)] = p

    def _assignment_label(self, aid: int) -> int:
        """Position of assignment aid within its left node's label list."""
        return self._aid_pos[aid][0]

    def _get_pairwise_cost(self, i1: int, i2: int) -> np.ndarray:
        assert i1 < i2
        key = (i1, i2)
        if key not in self._pw_cost:
            self._pw_cost[key] = np.zeros((len(self.left_labels[i1]) + 1,
                                           len(self.left_labels[i2]) + 1))
        return self._pw_cost[key]

    # ------------------------------------------------------------------
    def _left_unary_costs(self, engine):
        """Reparametrized left unary costs as an [n0, n1] assignment matrix,
        +inf where not a candidate, and the [n0] slack costs; one host copy
        of the unary block."""
        c = host_array(engine.state[UNARY_SIMPLEX.name]["c"], np.float64)
        n0, n1 = self.inp.n_left, self.inp.n_right
        out = np.full((n0, n1), np.inf)
        slack = np.zeros(n0)
        for i, u in enumerate(self.left_unaries):
            row = c[engine.f_local[u.fid]]
            out[i, self.left_labels[i]] = row[:len(self.left_labels[i])]
            slack[i] = row[len(self.left_labels[i])]
        return out, slack

    # ------------------------------------------------------------------
    def _instance_arrays(self):
        """Vectorized original-objective pieces (cached): assignment cost
        matrix and edge endpoint/cost arrays."""
        if self._inst_arrays is None:
            inp = self.inp
            n0, n1 = inp.n_left, inp.n_right
            A = np.zeros((n0, n1 + 1))
            allowed = [set() for _ in range(n0)]
            for (i, j, c) in inp.assignments:
                A[i, j] = c
                allowed[i].add(j)
            ei1 = np.asarray([inp.assignments[a1][0] for a1, _, _ in inp.edges],
                             dtype=np.int64)
            ej1 = np.asarray([inp.assignments[a1][1] for a1, _, _ in inp.edges],
                             dtype=np.int64)
            ei2 = np.asarray([inp.assignments[a2][0] for _, a2, _ in inp.edges],
                             dtype=np.int64)
            ej2 = np.asarray([inp.assignments[a2][1] for _, a2, _ in inp.edges],
                             dtype=np.int64)
            ec = np.asarray([c for _, _, c in inp.edges])
            self._inst_arrays = (A, allowed, ei1, ej1, ei2, ej2, ec)
        return self._inst_arrays

    def _matching_cost(self, match) -> float:
        """Original-instance objective of a matching (slack column = 0)."""
        A, _, ei1, ej1, ei2, ej2, ec = self._instance_arrays()
        m = np.asarray(match)
        lin = float(A[np.arange(len(m)), np.where(m >= 0, m, A.shape[1] - 1)]
                    .sum())
        act = (m[ei1] == ej1) & (m[ei2] == ej2)
        return lin + float(ec[act].sum())

    def improve_matching(self, match, max_rounds: int = 30) -> np.ndarray:
        """Greedy 2-opt over the ORIGINAL objective: swap two left nodes'
        assignments or move one to a free candidate/slack.  The MCF oracle
        sees only the reparametrized unary costs, so its matching ignores
        quadratic terms entirely — on dense QAPs that left a ~30% gap; the
        polish closes most of it at O(n^2 * E) host numpy per round."""
        A, allowed, *_ = self._instance_arrays()
        n0 = self.inp.n_left
        m = np.asarray(match).copy()
        cur = self._matching_cost(m)
        for _ in range(max_rounds):
            best, best_m = cur, None
            used = {j for j in m if j >= 0}
            for i1 in range(n0):
                # moves: i1 -> unused candidate or slack
                for j in list(allowed[i1] - used) + [-1]:
                    if m[i1] == j:
                        continue
                    cand = m.copy()
                    cand[i1] = j
                    v = self._matching_cost(cand)
                    if v < best - 1e-12:
                        best, best_m = v, cand
                # swaps with i2 (feasibility: each target allowed/slack)
                for i2 in range(i1 + 1, n0):
                    j1, j2 = m[i1], m[i2]
                    if j1 == j2:
                        continue
                    if (j2 >= 0 and j2 not in allowed[i1]) or \
                            (j1 >= 0 and j1 not in allowed[i2]):
                        continue
                    cand = m.copy()
                    cand[i1], cand[i2] = j2, j1
                    v = self._matching_cost(cand)
                    if v < best - 1e-12:
                        best, best_m = v, cand
            if best_m is None:
                break
            m, cur = best_m, best
        return m

    def _greedy_matching(self) -> np.ndarray:
        """Quadratic-aware greedy construction on the ORIGINAL objective:
        place left nodes one at a time on the candidate (or slack)
        minimizing the marginal cost given earlier placements."""
        A, allowed, ei1, ej1, ei2, ej2, ec = self._instance_arrays()
        n0 = self.inp.n_left
        m = np.full(n0, -1, dtype=np.int64)
        used = set()
        for i in range(n0):
            best_j, best_v = -1, 0.0     # slack costs 0 marginally
            for j in allowed[i] - used:
                sel = (ei1 == i) & (ej1 == j) & (m[ei2] == ej2)
                sel |= (ei2 == i) & (ej2 == j) & (m[ei1] == ej1)
                v = A[i, j] + float(ec[sel].sum())
                if v < best_v:
                    best_j, best_v = j, v
            m[i] = best_j
            if best_j >= 0:
                used.add(best_j)
        return m

    def compute_primal(self, engine):
        """MCF rounding (FMC_MCF role): solve the assignment problem exactly
        on the current reparametrized unary costs, polish with the 2-opt
        local search over the original objective (a quadratic-aware greedy
        construction seeds a second start — the MCF matching alone lands in
        window-dependent local optima), then fill a full primal dict of
        int32 tensors on the engine's device (pairwise/right-side entries
        follow the matching)."""
        costs, slack = self._left_unary_costs(engine)
        match = solve_assignment(costs, slack)  # match[i] = right node or -1
        cands = [self.improve_matching(match)]
        if self.inp.n_left <= 128:
            cands.append(self.improve_matching(self._greedy_matching()))
        match = min(cands, key=self._matching_cost)

        def dev(a):
            return torch.as_tensor(a, device=engine.device)

        prim = engine.init_primal()
        ux = host_array(prim[UNARY_SIMPLEX.name]["x"])
        for i, u in enumerate(self.left_unaries):
            if match[i] >= 0:
                ux[engine.f_local[u.fid]] = self.left_labels[i].index(int(match[i]))
            else:
                ux[engine.f_local[u.fid]] = len(self.left_labels[i])
        for j, u in enumerate(self.right_unaries):
            li = [i for i in range(self.inp.n_left) if match[i] == j]
            if li:
                ux[engine.f_local[u.fid]] = self.right_labels[j].index(li[0])
            else:
                ux[engine.f_local[u.fid]] = len(self.right_labels[j])
        prim[UNARY_SIMPLEX.name] = {"x": dev(ux)}

        if PAIRWISE_SIMPLEX.name in prim:
            p1 = host_array(prim[PAIRWISE_SIMPLEX.name]["x1"])
            p2 = host_array(prim[PAIRWISE_SIMPLEX.name]["x2"])
            for (i1, i2), ref in self.pairwise.items():
                row = engine.f_local[ref.fid]
                p1[row] = ux[engine.f_local[self.left_unaries[i1].fid]]
                p2[row] = ux[engine.f_local[self.left_unaries[i2].fid]]
            prim[PAIRWISE_SIMPLEX.name] = {"x1": dev(p1), "x2": dev(p2)}
        return prim

    # ------------------------------------------------------------------
    def matching(self, engine, prim) -> np.ndarray:
        """Extract match[i] = right node or -1 from a primal dict."""
        x = host_array(prim[UNARY_SIMPLEX.name]["x"])
        out = np.full(self.inp.n_left, -1, dtype=np.int64)
        for i, u in enumerate(self.left_unaries):
            li = int(x[engine.f_local[u.fid]])
            if li < len(self.left_labels[i]):
                out[i] = self.left_labels[i][li]
        return out
