"""Cycle-inequality separation for MRF tightening (counterpart of
``lp_mp_tpu/models/cycle_separation.py``).

TPU-native re-design of the MPLP-style cycle search the reference uses via
``problem_constructors/cycle_inequalities.hxx`` (header lives in the
downstream repo; API + acceptance pinned by
test/cycle_inequalities.cpp:1-208 and
test/graphical_model.cpp:232-246: a frustrated chordless
4-cycle must go lb 0 -> 1.0 after separation + triplet triangulation).

Scheme (Sontag & Jaakkola k-projection graph):

1. For every pairwise factor (i,j), take its *current reparametrized*
   matrix th_ij (plus the unaries spread evenly across incident edges —
   a zero-unary problem is unaffected).
2. Project onto every label pair: partition labels of i into {li} vs rest
   and labels of j into {lj} vs rest, giving a 2x2 matrix m with
   m[a,b] = min over the block.  The projection-graph edge
   (i,li) -- (j,lj) gets
       parity  = 1 if min(m01,m10) < min(m00,m11)  (prefers DISagreement)
       weight  = |min(m01,m10) - min(m00,m11)|     (the margin)
3. A violated cycle inequality = a cycle with ODD parity sum whose
   minimum edge weight is positive.  Found by sorting the distinct
   weights and binary-searching the largest threshold for which the
   bipartite double cover of the thresholded projection graph connects
   some node to its own mirror (union-find); the cycle itself is then a
   shortest even/odd path in the double cover (BFS).
4. The variable cycle is triangulated into triplets
   (v0, v_t, v_{t+1}); missing chord pairwise factors are created with
   zero cost by ``MrfConstructor.add_tightening_triplet``.

Host-side NumPy on float64 copies of the engine's blocks; runs once per
tightening round, never in the hot path.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..convert import host_array
from ..utils.union_find import UnionFind


def _edge_beliefs(constructor, engine):
    """Reparametrized pairwise matrices with unary mass folded in evenly.

    ONE device->host copy per block: a per-factor read would pay one
    transfer and one synchronisation per factor."""
    from ..factors.simplex import PAIRWISE_SIMPLEX, UNARY_SIMPLEX

    deg = {}
    for (i, j) in constructor.pairwise:
        deg[i] = deg.get(i, 0) + 1
        deg[j] = deg.get(j, 0) + 1

    ublock = host_array(engine.state[UNARY_SIMPLEX.name]["c"], np.float64)
    unary = {}
    for v, u in enumerate(constructor.unaries):
        row = engine.f_local[u.fid]
        n = constructor._n_labels(v)
        unary[v] = ublock[row, :n]

    pblock = host_array(engine.state[PAIRWISE_SIMPLEX.name]["c"], np.float64)
    out = {}
    for (i, j), p in constructor.pairwise.items():
        assert p.ftype is PAIRWISE_SIMPLEX
        row = engine.f_local[p.fid]
        _, data = engine.graph.factors[p.fid]
        n1, n2 = data.shape
        th = pblock[row, :n1, :n2].copy()
        th += unary[i][:, None] / max(deg.get(i, 1), 1)
        th += unary[j][None, :] / max(deg.get(j, 1), 1)
        out[(i, j)] = th
    return out


def k_projection_graph(constructor, engine, eps: float = 1e-9):
    """Signed projection graph: list of (weight, parity, (i,li), (j,lj)).

    parity 1 = the edge prefers the indicators [x_i==li], [x_j==lj] to
    DISagree; weight = guaranteed margin of that preference.
    """
    edges = []
    for (i, j), th in _edge_beliefs(constructor, engine).items():
        li_n, lj_n = th.shape
        if li_n < 2 or lj_n < 2:
            continue
        # m11[a,b] = th[a,b]; m10[a,b] = min_{b'!=b} th[a,b'] etc.
        row_sorted = np.sort(th, axis=1)
        col_sorted = np.sort(th, axis=0)
        m11 = th
        # min over row a excluding column b
        m10 = np.where(th == row_sorted[:, :1], row_sorted[:, 1:2], row_sorted[:, :1])
        m01 = np.where(th == col_sorted[:1, :], col_sorted[1:2, :], col_sorted[:1, :])
        # m00[a,b] = min over th[a'!=a, b'!=b]
        m00 = np.empty_like(th)
        for a in range(li_n):
            sub = np.delete(th, a, axis=0)
            smin = np.sort(sub, axis=1)
            for b in range(lj_n):
                m00[a, b] = min(np.where(sub[:, b] == smin[:, 0],
                                         smin[:, 1], smin[:, 0]).min(),
                                np.delete(sub, b, axis=1).min())
        agree = np.minimum(m11, m00)
        disagree = np.minimum(m10, m01)
        margin = disagree - agree
        for a in range(li_n):
            for b in range(lj_n):
                w = abs(float(margin[a, b]))
                if w <= eps:
                    continue
                parity = 1 if margin[a, b] < 0 else 0
                edges.append((w, parity, (i, a), (j, b)))
    return edges


def _double_cover_odd_cycle(edges, threshold):
    """Among edges with weight >= threshold, find a minimum-hop odd-parity
    cycle via BFS in the bipartite double cover.  Returns the node cycle
    [(var,label), ...] or None."""
    strong = [(p, u, v) for (w, p, u, v) in edges if w >= threshold]
    if not strong:
        return None
    nodes = {}
    for _, u, v in strong:
        nodes.setdefault(u, len(nodes))
        nodes.setdefault(v, len(nodes))
    n = len(nodes)
    # double cover: node k has copies 2k (+) and 2k+1 (-)
    uf = UnionFind(2 * n)
    adj: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    for p, u, v in strong:
        a, b = nodes[u], nodes[v]
        adj[a].append((b, p))
        adj[b].append((a, p))
        uf.merge(2 * a, 2 * b + p)
        uf.merge(2 * a + 1, 2 * b + (1 - p))
    inv = {k: node for node, k in nodes.items()}
    best = None
    for k in range(n):
        if uf.find(2 * k) != uf.find(2 * k + 1):
            continue
        # BFS from (k, +) to (k, -): parity-labeled states
        prev = {(k, 0): None}
        q = deque([(k, 0)])
        while q:
            cur, par = q.popleft()
            if cur == k and par == 1:
                break
            for nxt, p in adj[cur]:
                st = (nxt, (par + p) & 1)
                if st not in prev:
                    prev[st] = (cur, par)
                    q.append(st)
        if (k, 1) not in prev:
            continue
        path = []
        st = (k, 1)
        while st is not None:
            path.append(st[0])
            st = prev[st]
        path.reverse()  # k ... k, odd cycle (may repeat intermediate nodes)
        if best is None or len(path) < len(best):
            best = path
    if best is None:
        return None
    return [inv[k] for k in best[:-1]]


def find_violated_cycles(constructor, engine, max_cycles: int = 8,
                         eps: float = 1e-9):
    """Threshold binary search (largest min-margin first) for odd cycles."""
    edges = k_projection_graph(constructor, engine, eps=eps)
    if not edges:
        return []
    weights = sorted({w for (w, _, _, _) in edges})
    lo, hi = 0, len(weights) - 1
    best_cycle, best_th = None, None
    # largest threshold that still admits an odd cycle
    while lo <= hi:
        mid = (lo + hi) // 2
        cyc = _double_cover_odd_cycle(edges, weights[mid])
        if cyc is not None:
            best_cycle, best_th = cyc, weights[mid]
            lo = mid + 1
        else:
            hi = mid - 1
    if best_cycle is None:
        return []
    cycles = [best_cycle]
    if max_cycles > 1:
        # collect more cycles at the same threshold from other components
        seen_vars = {v for (v, _) in best_cycle}
        strong = [(w, p, u, v) for (w, p, u, v) in edges
                  if w >= best_th and u[0] not in seen_vars and v[0] not in seen_vars]
        while strong and len(cycles) < max_cycles:
            cyc = _double_cover_odd_cycle(strong, best_th)
            if cyc is None:
                break
            cycles.append(cyc)
            seen_vars |= {v for (v, _) in cyc}
            strong = [e for e in strong
                      if e[2][0] not in seen_vars and e[3][0] not in seen_vars]
    return cycles


def _variable_cycle(node_cycle):
    """Projection-graph cycle -> simple variable cycle (shortcut repeats)."""
    vars_ = [v for (v, _) in node_cycle]
    # remove consecutive duplicates then shortcut any repeated variable
    out: list[int] = []
    for v in vars_:
        if out and out[-1] == v:
            continue
        if v in out:
            out = out[: out.index(v) + 1]
            continue
        out.append(v)
    return out if len(out) >= 3 else None


def triangulate_cycle(constructor, cycle_vars) -> int:
    """Fan triangulation: triplets (v0, v_t, v_{t+1}); chords get zero-cost
    pairwise factors (reference AddTighteningTriplet behavior)."""
    v0 = cycle_vars[0]
    added = 0
    for t in range(1, len(cycle_vars) - 1):
        tri = tuple(sorted((v0, cycle_vars[t], cycle_vars[t + 1])))
        if len(set(tri)) < 3 or tri in constructor.triplets:
            continue
        constructor.add_tightening_triplet(*tri)
        added += 1
    return added


def cycle_search(constructor, engine, max_constraints: int) -> int:
    """Top-level separation: find violated odd cycles, triangulate into
    triplets.  Returns the number of triplet factors added."""
    if max_constraints <= 0:
        return 0
    added = 0
    for node_cycle in find_violated_cycles(constructor, engine):
        cyc = _variable_cycle(node_cycle)
        if cyc is None:
            continue
        added += triangulate_cycle(constructor, cyc)
        if added >= max_constraints:
            break
    return added
