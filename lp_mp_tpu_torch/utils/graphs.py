"""Host-side graph algorithms for separation/tightening (copy of
``lp_mp_tpu/utils/graphs.py``; ``bfs_path`` uses the port's ``native``).

NumPy/pure-Python equivalents of the reference's graph substrate
(graph.hxx): adjacency construction, triangle enumeration by
sorted-adjacency intersection (graph.hxx:172-218), quadrangle enumeration
(graph.hxx:220-277), contraction via union-find (graph.hxx:279-334) and
thresholded BFS path search (graph.hxx:379-466, semantics pinned by
test/shortest_path.cpp).  These run once per tightening round, not per
iteration, so host execution is the right placement.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, Sequence

import numpy as np

from .union_find import UnionFind


class Graph:
    """Static undirected weighted graph with sorted adjacency."""

    def __init__(self, n: int, edges: Sequence[tuple[int, int, float]]):
        self.n = n
        self.edges = [(min(i, j), max(i, j), w) for i, j, w in edges]
        self.adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
        for i, j, w in self.edges:
            self.adj[i].append((j, w))
            self.adj[j].append((i, w))
        for a in self.adj:
            a.sort()

    def neighbors(self, i: int) -> list[int]:
        return [j for j, _ in self.adj[i]]

    # -- enumeration (graph.hxx:172-277) ------------------------------------
    def triangles(self) -> list[tuple[int, int, int]]:
        out = []
        nbr = [set(self.neighbors(i)) for i in range(self.n)]
        for i, j in sorted(set((i, j) for i, j, _ in self.edges)):
            for k in sorted(nbr[i] & nbr[j]):
                if k > j:
                    out.append((i, j, k))
        return out

    def quadrangles(self) -> list[tuple[int, int, int, int]]:
        """4-cycles (i, j, k, l) with edges ij, jk, kl, li and i minimal."""
        out = set()
        nbr = [set(self.neighbors(i)) for i in range(self.n)]
        for i in range(self.n):
            ns = sorted(n for n in nbr[i] if n > i)
            for a_idx in range(len(ns)):
                for b_idx in range(a_idx + 1, len(ns)):
                    j, l = ns[a_idx], ns[b_idx]
                    for k in (nbr[j] & nbr[l]) - {i}:
                        if k > i:
                            out.add((i, j, k, l))
        return sorted(out)

    def contract(self, contract_edges: Iterable[tuple[int, int]]) -> "Graph":
        """Contract the given node pairs; parallel edges merge by weight sum
        (graph.hxx:279-334)."""
        uf = UnionFind(self.n)
        for i, j in contract_edges:
            uf.merge(i, j)
        ids = uf.get_contiguous_ids()
        acc: dict[tuple[int, int], float] = {}
        for i, j, w in self.edges:
            a, b = ids[i], ids[j]
            if a == b:
                continue
            key = (min(a, b), max(a, b))
            acc[key] = acc.get(key, 0.0) + w
        return Graph(int(ids.max()) + 1 if len(ids) else 0,
                     [(a, b, w) for (a, b), w in acc.items()])


def bfs_path(graph: Graph, source: int, target: int,
             threshold: float = -np.inf):
    """Shortest (fewest-hop) path using only arcs with weight > threshold.

    Returns (bottleneck weight along the path, node path) or (None, []) if
    unreachable — the reference's BfsData::FindPath
    (test/shortest_path.cpp:32-45: threshold 0.5 takes the direct edge with
    bottleneck 1.0; threshold 1.5 goes around with bottleneck 2.0).
    """
    from .. import native
    if native.get_lib() is not None and graph.edges:
        us, vs, ws = zip(*graph.edges)
        path = native.bfs_path(graph.n, us, vs, ws, source, target, threshold)
        if path is not None:
            if not path:
                return None, []
            wmap = {(min(i, j), max(i, j)): w for i, j, w in graph.edges}
            bottleneck = min(wmap[(min(a, b), max(a, b))]
                             for a, b in zip(path, path[1:]))
            return bottleneck, path
    prev = {source: (None, np.inf)}
    q = deque([source])
    while q:
        u = q.popleft()
        if u == target:
            break
        for v, w in graph.adj[u]:
            if w > threshold and v not in prev:
                prev[v] = (u, w)
                q.append(v)
    if target not in prev:
        return None, []
    path = [target]
    bottleneck = np.inf
    u = target
    while prev[u][0] is not None:
        bottleneck = min(bottleneck, prev[u][1])
        u = prev[u][0]
        path.append(u)
    path.reverse()
    return bottleneck, path
