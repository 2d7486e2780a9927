"""Multicut problem constructor (counterpart of ``lp_mp_tpu/models/multicut.py``).

Reference surface: downstream ``solvers/multicut/multicut_constructor.hxx``
(documented by test/multicut.cpp, test/shortest_path.cpp): edge factors,
triangle (triplet) factors with three edge<->triplet messages, cycle
separation for tightening, and primal rounding by edge contraction.

Tightening = violated-cycle search on the current reparametrization: for
every repulsive edge (cost < -eps), BFS a path of attractive edges with
weight above a threshold between its endpoints (utils.graphs.bfs_path,
the reference BfsData::FindPath); the cycle is fan-triangulated into
triplet factors (zero-cost auxiliary edges added as needed).

Primal rounding = greedy additive edge contraction (GAEC) on the original
costs, evaluated exactly; the reference delegates to downstream KLj-style
move makers — GAEC is the standard construction heuristic.

The separation searches and GAEC are host code on float64 values; they
read the engine's edge and triplet blocks with one device-to-host copy per
block (``convert.host_array``), and the constructor's primal goes back to
the engine's device as int32 tensors.
"""
from __future__ import annotations

import heapq

import numpy as np
import torch

from ..convert import host_array
from ..factors.multicut import (MULTICUT_EDGE, MULTICUT_ODD_WHEEL,
                                MULTICUT_TRIPLET, ODD_WHEEL_PATTERNS,
                                TRIPLET_PATTERNS, _wheel_tables,
                                wheel_k_type)
from ..graph import FactorGraph, FactorRef
from ..messages.multicut import (MULTICUT_EDGE_TRIPLET_0,
                                 MULTICUT_EDGE_TRIPLET_1,
                                 MULTICUT_EDGE_TRIPLET_2,
                                 MULTICUT_EDGE_WHEEL,
                                 triplet_wheel_k_message, wheel_k_message)
from ..utils.graphs import Graph, bfs_path
from ..utils.union_find import UnionFind

_SLOT_MSG = (MULTICUT_EDGE_TRIPLET_0, MULTICUT_EDGE_TRIPLET_1,
             MULTICUT_EDGE_TRIPLET_2)


class MulticutConstructor:
    def __init__(self, graph: FactorGraph):
        self.graph = graph
        self.edges: dict[tuple[int, int], FactorRef] = {}
        self.edge_cost: dict[tuple[int, int], float] = {}
        self.triplets: dict[tuple[int, int, int], FactorRef] = {}
        self.odd_wheels: dict[tuple[int, int, int, int], FactorRef] = {}
        # general odd-k-wheels: canonical (center, rim...) -> (ref, rim)
        self.wheels_k: dict[tuple, tuple[FactorRef, tuple]] = {}
        self.n_nodes = 0
        self._prev_edge: "FactorRef | None" = None
        # zero-cost edges fabricated by triangulation/wheel construction —
        # excluded from the "original graph" view of the hub cycle search
        self._aux_edges: set[tuple[int, int]] = set()

    # ------------------------------------------------------------------
    def add_edge(self, i: int, j: int, cost: float,
                 aux: bool = False) -> FactorRef:
        assert i != j
        i, j = min(i, j), max(i, j)
        assert (i, j) not in self.edges
        if aux:
            self._aux_edges.add((i, j))
        e = self.graph.add_factor(MULTICUT_EDGE, float(cost))
        self.edges[(i, j)] = e
        self.edge_cost[(i, j)] = float(cost)
        self.n_nodes = max(self.n_nodes, j + 1)
        if self._prev_edge is not None:
            # chain relation: edges sweep in insertion order
            self.graph.add_factor_relation(self._prev_edge, e)
        self._prev_edge = e
        return e

    def add_edges(self, pairs, costs) -> np.ndarray:
        """Batch add_edge: ``pairs`` [E, 2] node ids (any order, normalized
        to i<j), ``costs`` [E].  O(E) dict fills + O(1) array appends;
        returns global fids."""
        pairs = np.asarray(pairs, dtype=np.int64)
        lo = pairs.min(axis=1)
        hi = pairs.max(axis=1)
        assert (lo != hi).all()
        costs = np.asarray(costs, dtype=np.float64)
        fids = self.graph.add_factor_block(MULTICUT_EDGE, costs, len(pairs))
        if self._prev_edge is not None:
            self.graph.add_factor_relation_block(
                np.asarray([self._prev_edge.fid]), fids[:1])
        if len(fids) > 1:
            self.graph.add_factor_relation_block(fids[:-1], fids[1:])
        for (i, j), fid, c in zip(zip(lo.tolist(), hi.tolist()),
                                  fids.tolist(), costs.tolist()):
            assert (i, j) not in self.edges
            self.edges[(i, j)] = FactorRef(MULTICUT_EDGE, fid)
            self.edge_cost[(i, j)] = c
        self.n_nodes = max(self.n_nodes, int(hi.max()) + 1)
        self._prev_edge = FactorRef(MULTICUT_EDGE, int(fids[-1]))
        return fids

    def add_triplet(self, i: int, j: int, k: int) -> FactorRef:
        assert i < j < k
        key = (i, j, k)
        if key in self.triplets:
            return self.triplets[key]
        t = self.graph.add_factor(MULTICUT_TRIPLET, None)
        for slot, (a, b) in enumerate(((i, j), (i, k), (j, k))):
            if (a, b) not in self.edges:
                self.add_edge(a, b, 0.0, aux=True)
            e = self.edges[(a, b)]
            self.graph.add_message(_SLOT_MSG[slot], e, t)
            self.graph.add_factor_relation(e, t)
        self.triplets[key] = t
        return t

    # K4 edge slot order of the odd-3-wheel factor
    _WHEEL_SLOTS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

    def add_odd_3_wheel(self, a: int, b: int, c: int, d: int) -> FactorRef:
        """Odd-3-wheel (K4) factor over 4 nodes with its 6 edge messages
        (missing edges are created with zero cost, like add_triplet)."""
        nodes = tuple(sorted((a, b, c, d)))
        assert len(set(nodes)) == 4
        if nodes in self.odd_wheels:
            return self.odd_wheels[nodes]
        w = self.graph.add_factor(MULTICUT_ODD_WHEEL, None)
        for slot, (i, j) in enumerate(self._WHEEL_SLOTS):
            key = (nodes[i], nodes[j])
            if key not in self.edges:
                self.add_edge(*key, 0.0, aux=True)
            e = self.edges[key]
            self.graph.add_message(MULTICUT_EDGE_WHEEL[slot], e, w)
            self.graph.add_factor_relation(e, w)
        self.odd_wheels[nodes] = w
        return w

    @staticmethod
    def _canon_rim(rim) -> tuple:
        """Canonical rim cycle: lexicographically smallest rotation over
        both orientations."""
        k = len(rim)
        seqs = (list(rim), list(rim)[::-1])
        return min(tuple(s[i:] + s[:i]) for s in seqs for i in range(k))

    def add_odd_wheel_k(self, center: int, rim) -> FactorRef:
        """General odd-k-wheel factor: hub ``center`` + odd cycle ``rim``
        (len(rim) odd >= 3), with 2k slot-indexed edge messages
        (slots 0..k-1 spokes, k..2k-1 rim edges) plus a pattern-space
        message from each hub-triangle triplet (created if absent) — the
        triplet coupling is what lets tightening help after the edge duals
        have been fully reparametrized into the cycle triplets.  Missing
        edges are created with zero cost like add_triplet."""
        rim = self._canon_rim(rim)
        k = len(rim)
        assert k >= 3 and k % 2 == 1 and center not in rim
        assert len(set(rim)) == k
        key = (center,) + rim
        if key in self.wheels_k:
            return self.wheels_k[key][0]
        wt = wheel_k_type(k)
        mt = wheel_k_message(k)
        tmt = triplet_wheel_k_message(k)
        # hub triangles first (they may create zero-cost edges themselves)
        tris = []
        for i in range(k):
            tri = tuple(sorted((center, rim[i], rim[(i + 1) % k])))
            tris.append(self.add_triplet(*tri))
        w = self.graph.add_factor(wt, None)
        ends = [(center, rim[i]) for i in range(k)] + \
               [(rim[i], rim[(i + 1) % k]) for i in range(k)]
        slot_of = {}
        for slot, (a, b) in enumerate(ends):
            ekey = (min(a, b), max(a, b))
            slot_of[ekey] = slot
            if ekey not in self.edges:
                self.add_edge(*ekey, 0.0, aux=True)
            e = self.edges[ekey]
            self.graph.add_message(mt, e, w, data=slot)
            self.graph.add_factor_relation(e, w)
        ek = lambda a, b: (min(a, b), max(a, b))                # noqa: E731
        for i in range(k):
            u, v = rim[i], rim[(i + 1) % k]
            tri = tuple(sorted((center, u, v)))
            # triplet edge order (n0n1, n0n2, n1n2) -> wheel slot ids
            eperm = [slot_of[ek(tri[0], tri[1])],
                     slot_of[ek(tri[0], tri[2])],
                     slot_of[ek(tri[1], tri[2])]]
            # wheel-order triangle bits are (spoke_i, spoke_j, rim_i); map
            # each wheel pattern row to the triplet row of the same cut set
            wheel_edges = [ek(center, u), ek(center, v), ek(u, v)]
            pos_in_tri = [eperm.index(slot_of[e2]) for e2 in wheel_edges]
            pw = []
            for row in TRIPLET_PATTERNS:
                bits = np.zeros(3, np.int64)
                for q in range(3):
                    bits[pos_in_tri[q]] = row[q]
                pw.append(int(np.nonzero(
                    (TRIPLET_PATTERNS == bits).all(axis=1))[0][0]))
            pt = list(np.argsort(pw))
            self.graph.add_message(tmt, tris[i], w, data={
                "slot": i, "pw": pw, "pt": pt, "eperm": eperm})
            self.graph.add_factor_relation(tris[i], w)
        self.wheels_k[key] = (w, rim)
        return w

    # ------------------------------------------------------------------
    def _reparametrized_edge_costs(self, engine) -> dict[tuple[int, int], float]:
        c = host_array(engine.state[MULTICUT_EDGE.name]["c"])
        n_known = len(engine.f_local)
        keys = list(self.edges)
        fids = np.fromiter((ref.fid for ref in self.edges.values()),
                           dtype=np.int64, count=len(keys))
        # edges created later in the same tighten round (triangulation
        # chords) are not in the engine yet; their reparametrized cost is
        # their original (zero) cost
        known = fids < n_known
        vals = np.fromiter((self.edge_cost[k] for k in keys),
                           dtype=np.float64, count=len(keys))
        vals[known] = c[engine.f_local[fids[known]]]
        return dict(zip(keys, vals.tolist()))

    def _reparametrized_triplet_costs(self, engine):
        # triplets added by cycle separation in THIS tighten round are not
        # yet part of the engine (it is rebuilt afterwards) — skip them
        if MULTICUT_TRIPLET.name not in engine.state:
            return {}
        c = host_array(engine.state[MULTICUT_TRIPLET.name]["c"])
        n_known = len(engine.f_local)
        return {key: c[engine.f_local[ref.fid]]
                for key, ref in self.triplets.items() if ref.fid < n_known}

    def tighten_odd_wheels(self, engine, max_constraints: int,
                           eps: float = 1e-8) -> int:
        """Odd-3-wheel separation: for 4-node candidates around existing
        triplets, the guaranteed dual improvement of adding the K4 factor is
        (exact min over the 15 partitions of the combined edge+triplet
        reparametrization) - (sum of the local bounds).  Candidates with
        positive gain are added best-first — the stage beyond cycle
        inequalities (downstream odd-wheel tightening surface)."""
        if max_constraints <= 0:
            return 0
        ecosts = self._reparametrized_edge_costs(engine)
        tcosts = self._reparametrized_triplet_costs(engine)
        # candidate K4s: an existing triplet plus a node connected to >=2
        # of its corners
        adj: dict[int, set[int]] = {}
        for (i, j) in ecosts:
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
        cands: set[tuple[int, int, int, int]] = set()
        for (i, j, k) in self.triplets:
            near: dict[int, int] = {}
            for v in (i, j, k):
                for u in adj.get(v, ()):
                    if u not in (i, j, k):
                        near[u] = near.get(u, 0) + 1
            for u, cnt in near.items():
                if cnt >= 2:
                    cands.add(tuple(sorted((i, j, k, u))))
        scored = []
        for nodes in cands:
            if nodes in self.odd_wheels:
                continue
            ec = np.array([ecosts.get((nodes[i], nodes[j]), 0.0)
                           for i, j in self._WHEEL_SLOTS])
            local = np.minimum(ec, 0.0).sum()
            # exact bound over the 15 partitions (14 patterns + all-uncut)
            pat = ODD_WHEEL_PATTERNS.astype(np.float64)       # [14, 6]
            vals = pat @ ec
            # add existing triplet contributions per pattern
            tri_corners = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
            slot_of = {e: s for s, e in enumerate(self._WHEEL_SLOTS)}
            for corners in tri_corners:
                key = tuple(sorted(nodes[c] for c in corners))
                tc = tcosts.get(key)
                if tc is None:
                    continue
                local += min(0.0, tc.min())
                pairs = [(corners[0], corners[1]), (corners[0], corners[2]),
                         (corners[1], corners[2])]
                bits = pat[:, [slot_of[p] for p in pairs]].astype(np.int32)
                add = np.zeros(len(pat))
                for r in range(len(pat)):
                    if bits[r].any():
                        row = np.nonzero((TRIPLET_PATTERNS == bits[r])
                                         .all(axis=1))[0][0]
                        add[r] = tc[row]
                vals = vals + add
            exact = min(0.0, vals.min())
            gain = exact - local
            if gain > eps:
                scored.append((gain, nodes))
        scored.sort(key=lambda x: -x[0])
        added = 0
        for gain, nodes in scored[:max_constraints]:
            self.add_odd_3_wheel(*nodes)
            added += 1
        return added

    def _wheel_gain(self, center: int, rim: tuple, ecosts, tcosts) -> float:
        """Guaranteed dual improvement of adding the odd-k-wheel factor:
        (exact min over all wheel partitions of the combined edge + existing
        hub-triangle triplet reparametrization) - (sum of the local bounds).
        Exact via the membership-pattern enumeration (_wheel_tables); the
        free cut choice on hub-less rim edges is priced jointly with the
        incident triplet's pattern cost."""
        k = len(rim)
        A, forced_cut, both_one, free = _wheel_tables(k)
        s = 1 - A                                              # spoke cut bits
        ekey = lambda a, b: (min(a, b), max(a, b))             # noqa: E731
        sp = np.array([ecosts.get(ekey(center, rim[i]), 0.0)
                       for i in range(k)])
        rc = np.array([ecosts.get(ekey(rim[i], rim[(i + 1) % k]), 0.0)
                       for i in range(k)])
        local = np.minimum(sp, 0.0).sum() + np.minimum(rc, 0.0).sum()
        base = s.astype(np.float64) @ sp                       # [P]
        pat_row = {tuple(p): r for r, p in enumerate(TRIPLET_PATTERNS)}
        for i in range(k):
            u, v = rim[i], rim[(i + 1) % k]
            tri = tuple(sorted((center, u, v)))
            tc = tcosts.get(tri)
            if tc is not None:
                local += min(0.0, float(tc.min()))
                # map (cut(center,u), cut(center,v), cut(u,v)) onto the
                # sorted-key edge order (n0n1, n0n2, n1n2)
                epos = {ekey(center, u): 0, ekey(center, v): 1,
                        ekey(u, v): 2}
                order = [epos[ekey(tri[0], tri[1])],
                         epos[ekey(tri[0], tri[2])],
                         epos[ekey(tri[1], tri[2])]]

                def tv(b):
                    bits = (b[order[0]], b[order[1]], b[order[2]])
                    return 0.0 if not any(bits) else float(tc[pat_row[bits]])
            else:
                def tv(b):
                    return 0.0
            si, sj = s[:, i], s[:, (i + 1) % k]
            val = np.empty(len(base))
            for p in range(len(base)):
                if forced_cut[p, i]:
                    val[p] = rc[i] + tv((si[p], sj[p], 1))
                elif both_one[p, i]:
                    val[p] = 0.0
                else:
                    val[p] = min(rc[i] + tv((1, 1, 1)), tv((1, 1, 0)))
            base = base + val
        return float(base.min()) - local

    def tighten_wheels_general(self, engine, max_constraints: int,
                               eps: float = 1e-8, max_hubs: int = 64,
                               max_k: int = 7) -> int:
        """General odd-k-wheel separation (k >= 3): around
        high-|cost| hubs, find minimum-hop odd cycles in the hub's
        neighborhood graph via BFS in its bipartite double cover, score each
        candidate wheel by its exact guaranteed gain and add best-first.
        Unlike tighten_odd_wheels this needs neither existing triplets nor
        4-cliques."""
        if max_constraints <= 0:
            return 0
        ecosts = self._reparametrized_edge_costs(engine)
        tcosts = self._reparametrized_triplet_costs(engine)
        adj: dict[int, dict[int, float]] = {}
        for (i, j), w in ecosts.items():
            adj.setdefault(i, {})[j] = w
            adj.setdefault(j, {})[i] = w
        hubs = sorted(adj, key=lambda v: -sum(abs(w) for w in adj[v].values()))
        scored = []
        seen: set[tuple] = set()
        from collections import deque
        for c in hubs[:max_hubs]:
            nbrs = [u for u in adj[c] if (min(c, u), max(c, u))
                    not in self._aux_edges]
            if len(nbrs) < 3:
                continue
            pos = {u: q for q, u in enumerate(nbrs)}
            # two views of the neighborhood graph: the original instance
            # (no fabricated zero-cost chords — finds the "real" rim even
            # after triangulation densified the graph) and the full one
            nadj_orig: list[list[int]] = [[] for _ in nbrs]
            nadj_full: list[list[int]] = [[] for _ in nbrs]
            for qi, u in enumerate(nbrs):
                for v in adj[u]:
                    if v in pos and pos[v] > qi:
                        nadj_full[qi].append(pos[v])
                        nadj_full[pos[v]].append(qi)
                        if (min(u, v), max(u, v)) not in self._aux_edges:
                            nadj_orig[qi].append(pos[v])
                            nadj_orig[pos[v]].append(qi)
            # min-hop odd closed walk through each start node: BFS in the
            # bipartite double cover (copy 0 / copy 1 by path parity)
            for nadj in (nadj_orig, nadj_full):
                for st in range(len(nbrs)):
                    prev = {(st, 0): None}
                    q = deque([(st, 0)])
                    found = None
                    while q:
                        cur, par = q.popleft()
                        if cur == st and par == 1:
                            found = (cur, par)
                            break
                        for nxt in nadj[cur]:
                            nstate = (nxt, par ^ 1)
                            if nstate not in prev:
                                prev[nstate] = (cur, par)
                                q.append(nstate)
                    if found is None:
                        continue
                    walk = []
                    stt = found
                    while stt is not None:
                        walk.append(stt[0])
                        stt = prev[stt]
                    cyc = walk[:-1]
                    k = len(cyc)
                    if k > max_k or len(set(cyc)) != k:
                        continue       # too long, or walk repeats a node
                    rim = self._canon_rim([nbrs[q2] for q2 in cyc])
                    key = (c,) + rim
                    if key in seen or key in self.wheels_k:
                        continue
                    if k == 3 and tuple(sorted((c,) + rim)) in self.odd_wheels:
                        continue       # already covered by a K4 factor
                    seen.add(key)
                    gain = self._wheel_gain(c, rim, ecosts, tcosts)
                    if gain > eps:
                        scored.append((gain, c, rim))
        scored.sort(key=lambda x: (-x[0], x[1]))
        added = 0
        for gain, c, rim in scored[:max_constraints]:
            self.add_odd_wheel_k(c, rim)
            added += 1
        return added

    def tighten(self, engine, max_constraints: int, eps: float = 1e-8,
                max_candidates: "int | None" = None) -> int:
        """Violated-cycle separation + fan triangulation; once cycles dry
        up, general odd-k-wheel separation takes over (gain-scored, with
        triplet coupling), then the legacy triplet-adjacent K4 pass with any
        remaining budget."""
        added = self.tighten_cycles(engine, max_constraints, eps,
                                    max_candidates)
        if added < max_constraints:
            added += self.tighten_wheels_general(
                engine, max_constraints - added, eps)
        if added < max_constraints:
            added += self.tighten_odd_wheels(engine, max_constraints - added,
                                             eps)
        return added

    def tighten_cycles(self, engine, max_constraints: int, eps: float = 1e-8,
                       max_candidates: "int | None" = None) -> int:
        """Violated-cycle separation + fan triangulation only.
        ``max_candidates`` caps the BFS to the most-negative edges (large
        instances: the cycle search is host-side, once per tighten round)."""
        if max_constraints <= 0:
            return 0
        costs = self._reparametrized_edge_costs(engine)
        pos = [(i, j, w) for (i, j), w in costs.items() if w > eps]
        neg = [(w, i, j) for (i, j), w in costs.items() if w < -eps]
        if max_candidates is not None and len(neg) > max_candidates:
            neg.sort()
            neg = neg[:max_candidates]
        candidates = []
        from .. import native
        batched = None
        if neg and pos:
            arr = np.asarray(pos)
            batched = native.bfs_paths(
                self.n_nodes, arr[:, 0].astype(np.int64),
                arr[:, 1].astype(np.int64), arr[:, 2],
                np.asarray([q[1] for q in neg], dtype=np.int64),
                np.asarray([q[2] for q in neg], dtype=np.int64), eps)
        if batched is not None:
            paths, bns = batched
            for (w, i, j), path, bn in zip(neg, paths, bns):
                if path:
                    candidates.append((min(-w, float(bn)), (i, j), path))
        else:
            g = Graph(self.n_nodes, pos)
            for w, i, j in neg:
                bottleneck, path = bfs_path(g, i, j, threshold=eps)
                if path:
                    candidates.append((min(-w, bottleneck), (i, j), path))
        candidates.sort(key=lambda x: -x[0])
        added = 0
        for gain, (i, j), path in candidates:
            if added >= max_constraints:
                break
            # fan triangulation from path[0]
            a = path[0]
            new = 0
            for u, v in zip(path[1:], path[2:]):
                tri = tuple(sorted((a, u, v)))
                if tri not in self.triplets:
                    self.add_triplet(*tri)
                    new += 1
            if new:
                added += 1
        return added

    # ------------------------------------------------------------------
    def round_gaec(self):
        """Greedy additive edge contraction on the original costs.
        Returns (node labels [n], cut mask per edge dict, cost)."""
        from .. import native
        if native.get_lib() is not None and self.edges:
            us = [e[0] for e in self.edge_cost]
            vs = [e[1] for e in self.edge_cost]
            ws = list(self.edge_cost.values())
            labels = native.gaec(self.n_nodes, us, vs, ws)
            if labels is not None:
                cut = {e: int(labels[e[0]] != labels[e[1]]) for e in self.edges}
                cost = sum(self.edge_cost[e] * cut[e] for e in self.edges)
                return labels, cut, cost
        # Cost is PAID when the edge is cut, so merging avoids paying
        # positive cuts: greedily contract the most positive aggregate edge.
        # Incremental lazy-deletion heap + per-component adjacency dicts
        # merged smaller-into-larger — O(E log E), no global rebuilds
        # (mirrors csrc/lpmp_host.cpp lpmp_gaec).
        parent = list(range(self.n_nodes))
        adj: list[dict[int, float]] = [dict() for _ in range(self.n_nodes)]
        for (a, b), w in self.edge_cost.items():
            adj[a][b] = adj[a].get(b, 0.0) + w
            adj[b][a] = adj[b].get(a, 0.0) + w
        heap = [(-w, a, b) for a in range(self.n_nodes)
                for b, w in adj[a].items() if a < b and w > 0]
        heapq.heapify(heap)
        while heap:
            negw, a, b = heapq.heappop(heap)
            w = -negw
            if w <= 0:
                break
            if parent[a] != a or parent[b] != b or adj[a].get(b) != w:
                continue   # stale entry
            if len(adj[a]) < len(adj[b]):
                a, b = b, a
            parent[b] = a
            adj[a].pop(b, None)
            adj[b].pop(a, None)
            for c, wc in adj[b].items():
                adj[c].pop(b, None)
                wn = adj[a].get(c, 0.0) + wc
                adj[a][c] = wn
                adj[c][a] = wn
                if wn > 0:
                    heapq.heappush(heap, (-wn, min(a, c), max(a, c)))
            adj[b] = {}

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        ids: dict[int, int] = {}
        labels = np.empty(self.n_nodes, dtype=np.int64)
        for i in range(self.n_nodes):
            r = find(i)
            labels[i] = ids.setdefault(r, len(ids))
        cut = {e: int(labels[e[0]] != labels[e[1]]) for e in self.edges}
        cost = sum(self.edge_cost[e] * cut[e] for e in self.edges)
        return labels, cut, cost

    def check_primal_consistency(self, engine, prim) -> bool:
        """Multicut feasibility: a cut edge inside one connected component
        of the uncut subgraph is inconsistent (the reference delegates this
        to the multicut constructor; engine-level message checks cannot see
        it for triplet-free models)."""
        x = host_array(prim[MULTICUT_EDGE.name]["x"])
        fids = np.fromiter((ref.fid for ref in self.edges.values()), dtype=np.int64,
                           count=len(self.edges))
        xs = x[engine.f_local[fids]].tolist()
        uf = UnionFind(self.n_nodes)
        for key, xe in zip(self.edges, xs):
            if xe == 0:
                uf.merge(*key)
        for key, xe in zip(self.edges, xs):
            if xe == 1 and uf.find(key[0]) == uf.find(key[1]):
                return False
        return True

    def compute_primal(self, engine):
        """Constructor-provided primal (ProblemConstructorRoundingSolver
        hook, solver.hxx:402-481): GAEC labeling as a primal dict of int32
        tensors on the engine's device."""
        def dev(a):
            return torch.as_tensor(a, device=engine.device)

        labels, cut, _ = self.round_gaec()
        prim = engine.init_primal()
        x = np.zeros(len(self.edges), dtype=np.int32)
        for key, ref in self.edges.items():
            x[engine.f_local[ref.fid]] = cut[key]
        prim[MULTICUT_EDGE.name] = {"x": dev(x)}
        if MULTICUT_TRIPLET.name in prim:
            T = prim[MULTICUT_TRIPLET.name]["e1"].shape[0]
            es = {1: np.zeros(T, np.int32), 2: np.zeros(T, np.int32),
                  3: np.zeros(T, np.int32)}
            n_known = len(engine.f_local)
            for (i, j, k), ref in self.triplets.items():
                if ref.fid >= n_known:
                    continue    # absorbed by the aux pass, not engine rows
                row = engine.f_local[ref.fid]
                es[1][row] = cut[(i, j)]
                es[2][row] = cut[(i, k)]
                es[3][row] = cut[(j, k)]
            prim[MULTICUT_TRIPLET.name] = {f"e{s}": dev(es[s])
                                           for s in (1, 2, 3)}
        if MULTICUT_ODD_WHEEL.name in prim:
            W = prim[MULTICUT_ODD_WHEEL.name]["e1"].shape[0]
            es = {s: np.zeros(W, np.int32) for s in range(1, 7)}
            for nodes, ref in self.odd_wheels.items():
                row = engine.f_local[ref.fid]
                for slot, (i, j) in enumerate(self._WHEEL_SLOTS):
                    es[slot + 1][row] = cut[(nodes[i], nodes[j])]
            prim[MULTICUT_ODD_WHEEL.name] = {f"e{s}": dev(es[s])
                                             for s in range(1, 7)}
        # general odd-k-wheels: cut bits per slot (spokes then rim)
        ksets: dict[str, np.ndarray] = {}
        for (center, *rim), (ref, rim_t) in self.wheels_k.items():
            name = ref.ftype.name
            if name not in prim:
                continue
            if name not in ksets:
                ksets[name] = np.zeros(
                    tuple(prim[name]["e"].shape), np.int32)
            k = len(rim_t)
            row = engine.f_local[ref.fid]
            ek = lambda a, b: (min(a, b), max(a, b))            # noqa: E731
            for i in range(k):
                ksets[name][row, i] = cut[ek(center, rim_t[i])]
                ksets[name][row, k + i] = cut[ek(rim_t[i],
                                                 rim_t[(i + 1) % k])]
        for name, e in ksets.items():
            prim[name] = {"e": dev(e)}
        return prim
