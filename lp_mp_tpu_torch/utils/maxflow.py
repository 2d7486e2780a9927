"""Maxflow / min-cut (host-side; copy of ``lp_mp_tpu/utils/maxflow.py`` on the
port's ``native``).

Counterpart of the vendored Boykov-Kolmogorov solver (lib/max_flow.hxx),
which downstream solvers use for cut-based rounding and odd-wheel
separation.  The native Dinic implementation (csrc/lpmp_host.cpp) carries
the load; this module adds a pure-Python Edmonds-Karp fallback with the
same (flow, source_side) interface.
"""
from __future__ import annotations

from collections import deque

import numpy as np


def maxflow(n: int, edges, s: int, t: int):
    """edges: iterable of (u, v, cap_uv, cap_vu).  Returns
    (flow_value, source_side_mask[n]) — the min-cut is the set of edges
    leaving the source side."""
    edges = list(edges)
    from .. import native
    if native.get_lib() is not None and edges:
        us, vs, cuv, cvu = zip(*edges)
        res = native.maxflow(n, us, vs, cuv, cvu, s, t)
        if res is not None:
            return res

    # Edmonds-Karp fallback
    head: list[int] = []
    cap: list[float] = []
    adj: list[list[int]] = [[] for _ in range(n)]

    def add(u, v, c):
        adj[u].append(len(head))
        head.append(v)
        cap.append(float(c))

    for (u, v, cuv, cvu) in edges:
        add(u, v, cuv)
        add(v, u, cvu)
    flow = 0.0
    while True:
        par = [-1] * n
        par[s] = -2
        q = deque([s])
        while q and par[t] == -1:
            u = q.popleft()
            for a in adj[u]:
                if cap[a] > 1e-12 and par[head[a]] == -1:
                    par[head[a]] = a
                    q.append(head[a])
        if par[t] == -1:
            break
        push = np.inf
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
            v = head[a ^ 1]
        flow += push
    side = np.zeros(n, dtype=bool)
    side[s] = True
    q = deque([s])
    while q:
        u = q.popleft()
        for a in adj[u]:
            if cap[a] > 1e-12 and not side[head[a]]:
                side[head[a]] = True
                q.append(head[a])
    return flow, side
