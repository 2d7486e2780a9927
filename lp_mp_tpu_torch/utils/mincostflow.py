"""Successive-shortest-path min-cost flow (host-side; copy of
``lp_mp_tpu/utils/mincostflow.py`` on the port's ``native``).

Counterpart of the vendored Kolmogorov solver ``lib/MinCost/MinCost.h:17-45``
(``MCF::SSP``: AddEdge / AddNodeExcess / Solve / GetFlow / GetReducedCost /
UpdateCost, behavior pinned by test/min_cost_flow.cpp).  In the reference it
backs the graph-matching assignment factor; here it is a host routine used
for primal rounding (assignment extraction) and never runs per-iteration,
so a clean SSP with Dijkstra + node potentials is sufficient.  A C++
implementation with the same API is provided by the port's ``native``
(csrc/lpmp_host.cpp) when built; this module transparently prefers it.
"""
from __future__ import annotations

import heapq

import numpy as np

INF = float("inf")


class MinCostFlow:
    """Min-cost flow by successive shortest paths with node potentials.

    Edges are directed with ``lower``/``upper`` capacity bounds and linear
    cost.  ``add_node_excess`` sets supplies (>0) / demands (<0); ``solve``
    routes all excess and returns the total cost (raises if infeasible).
    """

    def __init__(self, n_nodes: int, n_arcs_hint: int = 0):
        self.n = n_nodes
        self.excess = np.zeros(n_nodes, dtype=np.float64)
        # forward/backward arc pairs: arc 2e is the user edge, 2e+1 its reverse
        self.head: list[int] = []
        self.cap: list[float] = []
        self.cost: list[float] = []
        self.adj: list[list[int]] = [[] for _ in range(n_nodes)]
        self._lower_shift = 0.0
        self._n_edges = 0
        self._lower: list[float] = []

    # -- construction (MinCost.h:24-33 API) --------------------------------
    def add_edge(self, tail: int, head: int, lower: float, upper: float,
                 cost: float) -> int:
        eid = self._n_edges
        if lower != 0:
            # standard transformation: force the lower bound through
            self.excess[tail] -= lower
            self.excess[head] += lower
            self._lower_shift += lower * cost
            upper = upper - lower
        a = len(self.head)
        self.adj[tail].append(a)
        self.head.append(head)
        self.cap.append(float(upper))
        self.cost.append(float(cost))
        self.adj[head].append(a + 1)
        self.head.append(tail)
        self.cap.append(0.0)
        self.cost.append(float(-cost))
        self._n_edges += 1
        self._lower.append(float(lower))
        return eid

    def add_node_excess(self, i: int, excess: float) -> None:
        self.excess[i] += excess

    def update_cost(self, eid: int, new_cost: float) -> None:
        """Change an arc cost (MinCost.h UpdateCost).  Only valid before
        (re-)solving; flows are not repaired incrementally here."""
        a = 2 * eid
        self.cost[a] = float(new_cost)
        self.cost[a + 1] = float(-new_cost)

    # -- solve ---------------------------------------------------------------
    def solve(self) -> float:
        n = self.n
        head = self.head
        cap = self.cap
        cost = self.cost
        adj = self.adj
        pot = [0.0] * n
        excess = self.excess.copy()

        # Bellman-Ford init of potentials iff negative arc costs exist
        if any(c < 0 and cap[a] > 0 for a, c in enumerate(cost)):
            for _ in range(n):
                changed = False
                for u in range(n):
                    pu = pot[u]
                    for a in adj[u]:
                        if cap[a] > 1e-12 and pu + cost[a] < pot[head[a]] - 1e-12:
                            pot[head[a]] = pu + cost[a]
                            changed = True
                if not changed:
                    break

        total = self._lower_shift
        sources = [i for i in range(n) if excess[i] > 1e-12]
        while sources:
            s = sources[-1]
            # Dijkstra with reduced costs from s
            dist = [INF] * n
            dist[s] = 0.0
            par = [-1] * n
            pq = [(0.0, s)]
            visited = [False] * n
            while pq:
                d, u = heapq.heappop(pq)
                if visited[u]:
                    continue
                visited[u] = True
                for a in adj[u]:
                    if cap[a] <= 1e-12:
                        continue
                    v = head[a]
                    nd = d + cost[a] + pot[u] - pot[v]
                    if nd < dist[v] - 1e-12:
                        dist[v] = nd
                        par[v] = a
                        heapq.heappush(pq, (nd, v))
            # pick the closest reachable deficit node
            t, best = -1, INF
            for v in range(n):
                if excess[v] < -1e-12 and dist[v] < best:
                    best, t = dist[v], v
            if t < 0:
                raise RuntimeError("min-cost flow infeasible: unroutable excess")
            for v in range(n):
                if dist[v] < INF:
                    pot[v] += dist[v]
            # bottleneck
            push = min(excess[s], -excess[t])
            v = t
            while v != s:
                a = par[v]
                push = min(push, cap[a])
                v = head[a ^ 1]
            v = t
            while v != s:
                a = par[v]
                cap[a] -= push
                cap[a ^ 1] += push
                total += push * cost[a]
                v = head[a ^ 1]
            excess[s] -= push
            excess[t] += push
            if excess[s] <= 1e-12:
                sources.pop()
        self._pot = pot
        self.excess = excess
        return total

    # -- inspection (MinCost.h GetFlow / GetReducedCost) ---------------------
    def get_flow(self, eid: int) -> float:
        return self.cap[2 * eid + 1] + self._lower[eid]

    def reduced_cost(self, eid: int) -> float:
        a = 2 * eid
        t = self.head[a + 1]
        h = self.head[a]
        return self.cost[a] + self._pot[t] - self._pot[h]


def solve_assignment(costs: np.ndarray, slack: "np.ndarray | None" = None):
    """Rectangular assignment with optional per-left slack costs.

    ``costs[i, j]`` = cost of matching left i to right j (inf = forbidden);
    ``slack[i]`` = cost of leaving left i unmatched (None = 0 when rectangular
    requires it, else matching is forced when square and feasible).

    Returns ``match[i] = j`` or -1 (slack).  Host-side rounding oracle for
    graph matching (reference FMC_MCF purpose).
    """
    costs = np.asarray(costs, dtype=np.float64)
    n0, n1 = costs.shape
    if slack is None:
        slack = np.zeros(n0)
    # nodes: 0..n0-1 left, n0..n0+n1-1 right, n0+n1 slack sink, n0+n1+1 sink
    S = n0 + n1
    T = n0 + n1 + 1

    from .. import native
    if native.get_lib() is not None:
        tails, heads, ups, cs, keys = [], [], [], [], []
        for i in range(n0):
            for j in range(n1):
                if np.isfinite(costs[i, j]):
                    tails.append(i); heads.append(n0 + j)
                    ups.append(1.0); cs.append(costs[i, j]); keys.append((i, j))
            tails.append(i); heads.append(S)
            ups.append(1.0); cs.append(float(slack[i])); keys.append((i, -1))
        for j in range(n1):
            tails.append(n0 + j); heads.append(T)
            ups.append(1.0); cs.append(0.0); keys.append(None)
        tails.append(S); heads.append(T)
        ups.append(float(n0)); cs.append(0.0); keys.append(None)
        excess = np.zeros(n0 + n1 + 2)
        excess[:n0] = 1.0
        excess[T] = -float(n0)
        res = native.mcf_solve(n0 + n1 + 2, tails, heads,
                               np.zeros(len(tails)), ups, cs, excess)
        if res is not None:
            _, flows = res
            match = np.full(n0, -1, dtype=np.int64)
            for k, f in zip(keys, flows):
                if k is not None and k[1] >= 0 and f > 0.5:
                    match[k[0]] = k[1]
            return match

    mcf = MinCostFlow(n0 + n1 + 2)
    eids = {}
    for i in range(n0):
        for j in range(n1):
            if np.isfinite(costs[i, j]):
                eids[(i, j)] = mcf.add_edge(i, n0 + j, 0, 1, costs[i, j])
        eids[(i, -1)] = mcf.add_edge(i, S, 0, 1, float(slack[i]))
        mcf.add_node_excess(i, 1)
    for j in range(n1):
        mcf.add_edge(n0 + j, T, 0, 1, 0.0)
    mcf.add_edge(S, T, 0, n0, 0.0)
    mcf.add_node_excess(T, -n0)
    mcf.solve()
    match = np.full(n0, -1, dtype=np.int64)
    for (i, j), e in eids.items():
        if j >= 0 and mcf.get_flow(e) > 0.5:
            match[i] = j
    return match
