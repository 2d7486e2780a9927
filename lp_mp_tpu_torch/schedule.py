"""Schedule compiler: orderings, omega weights, and parallel phases.

Copy of ``lp_mp_tpu/schedule.py`` for the port (NumPy only; importing the
JAX package's module would import JAX).

Host-side (NumPy) replica of the reference's weight machinery:

- topological sort of the factor-relation DAG  (topological_sort.hxx:62-145,
  LP_MP.h:731-797) with identical DFS tie-breaking,
- SRMP anisotropic weights                      (LP_MP.h:1230-1415),
- anisotropic2 weights                          (LP_MP.h:1084-1154),
- uniform / damped-uniform weights              (LP_MP.h:1420-1449),
- mixed weights                                 (LP_MP.h:1451-1478),
- full receive masks                            (LP_MP.h:1480-1505).

On top of that, the *phase decomposition* restructures the sequential sweep
into parallel wavefront phases: updated factors are levelized so that two
factors share a phase only if their touched state (own costs + all adjacent
factors' costs) is disjoint.  Executing phases in sequence with each phase
batched is then exactly equivalent to the reference's sequential sweep in
the given total order (same block-coordinate steps, same data dependencies).
This is the TPU-native counterpart of the reference's partition passes
(LP_MP.h:1931-2051) and OpenMP conflict analysis (LP_MP.h:800-866).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .config import MessageSchedule, ReparametrizationMode


# ---------------------------------------------------------------------------
# Host-side message description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MessageDesc:
    """One message instance, host view."""

    left: int   # factor id
    right: int  # factor id
    schedule: MessageSchedule


def factor_updated_mask(n_factors: int, messages: Sequence[MessageDesc]) -> np.ndarray:
    """FactorUpdated() per factor: has any send/receive activity on its side
    (factors_messages.hxx:3125-3140)."""
    upd = np.zeros(n_factors, dtype=bool)
    bits: dict[int, tuple[bool, bool]] = {}  # hoisted per schedule object
    for m in messages:
        s = m.schedule
        b = bits.get(id(s))
        if b is None:
            b = (s.sends_to_right or s.left_receives,
                 s.sends_to_left or s.right_receives)
            bits[id(s)] = b
        if b[0]:
            upd[m.left] = True
        if b[1]:
            upd[m.right] = True
    return upd


# ---------------------------------------------------------------------------
# Topological sort (reference-identical DFS reverse postorder)
# ---------------------------------------------------------------------------

def toposort(n: int, edges) -> list[int]:
    """Iterative DFS reverse-postorder, same traversal order as
    Topological_Sort::Graph::topologicalSort (topological_sort.hxx:62-145):
    roots scanned 0..n-1, neighbors in edge-insertion order.

    ``edges`` is any iterable of (src, dst) pairs or an object with
    ``.arrays() -> (src[], dst[])`` (FactorGraph relation blocks).  The DFS
    walks a stably-sorted CSR, which preserves edge-insertion order per
    node."""
    if hasattr(edges, "arrays"):
        src, dst = edges.arrays()
    else:
        pairs = list(edges)
        if pairs:
            arr = np.asarray(pairs, dtype=np.int64)
            src, dst = arr[:, 0], arr[:, 1]
        else:
            src = dst = np.zeros(0, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))

    # cycle check via Kahn count (the reference throws "graph not a dag")
    indeg = np.bincount(dst, minlength=n)
    q = list(np.nonzero(indeg == 0)[0])
    seen = 0
    while q:
        v = q.pop()
        seen += 1
        for w in indices[indptr[v]:indptr[v + 1]]:
            indeg[w] -= 1
            if indeg[w] == 0:
                q.append(w)
    if seen != n:
        raise ValueError("graph not a dag")

    mark = np.zeros(n, dtype=np.uint8)  # 0 unmarked, 2 visited
    post: list[int] = []
    for root in range(n):
        if mark[root]:
            continue
        stack: list[tuple[int, int]] = [(root, int(indptr[root]))]
        mark[root] = 2
        while stack:
            node, it = stack[-1]
            end = indptr[node + 1]
            while it < end and mark[indices[it]]:
                it += 1
            if it < end:
                nxt = int(indices[it])
                stack[-1] = (node, it + 1)
                mark[nxt] = 2
                stack.append((nxt, int(indptr[nxt])))
            else:
                stack.pop()
                post.append(node)
    post.reverse()
    return post


# ---------------------------------------------------------------------------
# Omega weights
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Weights:
    """Per-message-instance weights/masks for one sweep direction.

    ``omega_left[m]``  : weight when the left factor sends over m (0 = skip)
    ``omega_right[m]`` : weight when the right factor sends over m
    ``recv_left[m]``   : left factor receives right's marginal during its update
    ``recv_right[m]``  : right factor receives left's marginal
    """

    omega_left: np.ndarray
    omega_right: np.ndarray
    recv_left: np.ndarray
    recv_right: np.ndarray


def _per_factor_views(n: int, messages: Sequence[MessageDesc]):
    """For each factor: list of (msg_index, is_left_side)."""
    views: list[list[tuple[int, bool]]] = [[] for _ in range(n)]
    for i, m in enumerate(messages):
        views[m.left].append((i, True))
        views[m.right].append((i, False))
    return views


def _side_flags(m: MessageDesc, is_left: bool):
    """(sends, receives, adj_sends, adj_receives) from one side's perspective
    (message_trait, LP_MP.h:123-144)."""
    s = m.schedule
    if is_left:
        return s.sends_to_right, s.left_receives, s.sends_to_left, s.right_receives
    return s.sends_to_left, s.right_receives, s.sends_to_right, s.left_receives


def compute_anisotropic_weights(order: Sequence[int], n: int,
                                messages: Sequence[MessageDesc],
                                updated: np.ndarray) -> Weights:
    """SRMP anisotropic weights (LP_MP.h:1230-1415).

    ``order`` may be a *subset* of the factors (partition / push passes,
    LP_MP.h:1931-2051): statistics then only count subset-internal
    adjacency, and out-of-set neighbors connected to >=2 subset factors act
    as relays via min-adjacent-sending / max-adjacent-receiving positions
    (LP_MP.h:1263-1304, including the map's default-0 semantics for
    out-of-set factors touching just one subset factor)."""
    M = len(messages)
    order = [int(f) for f in order]
    ns = len(order)
    pos = np.full(n, -1, dtype=np.int64)  # -1 = not in the iteration set
    pos[np.asarray(order)] = np.arange(ns)
    views = _per_factor_views(n, messages)
    MAXI = np.iinfo(np.int64).max

    # pass 1: receiving-factor statistics over subset-internal adjacency
    # (LP_MP.h:1242-1261)
    no_receiving_later = np.zeros(n, dtype=np.int64)
    last_receiving = np.zeros(n, dtype=np.int64)
    first_receiving = np.full(n, MAXI, dtype=np.int64)
    for f in order:
        for mi, is_left in views[f]:
            m = messages[mi]
            _, _, _, adj_receives = _side_flags(m, is_left)
            a = m.right if is_left else m.left
            if adj_receives and pos[a] > pos[f]:
                no_receiving_later[f] += 1
                last_receiving[f] = max(last_receiving[f], pos[a])
                first_receiving[f] = min(first_receiving[f], pos[a])

    # out-of-set relay positions (LP_MP.h:1263-1304)
    min_adj_send: dict[int, int] = {}
    max_adj_recv: dict[int, int] = {}
    if ns < n:
        adj_count: dict[int, int] = {}
        for f in order:
            for mi, is_left in views[f]:
                m = messages[mi]
                a = m.right if is_left else m.left
                if pos[a] < 0:
                    adj_count[a] = adj_count.get(a, 0) + 1
        for a, cnt in adj_count.items():
            if cnt < 2:
                continue
            mn, mx = MAXI, 0
            for mi, is_left_of_a in views[a]:
                m = messages[mi]
                other = m.right if is_left_of_a else m.left
                if pos[other] < 0:
                    continue
                # flags from a's viewpoint: does `other` send to / receive
                # from a?
                _, _, other_sends, other_receives = _side_flags(m, is_left_of_a)
                if other_sends:
                    mn = min(mn, int(pos[other]))
                if other_receives:
                    mx = max(mx, int(pos[other]))
            min_adj_send[a] = mn
            max_adj_recv[a] = mx

    omega_left = np.zeros(M)
    omega_right = np.zeros(M)
    recv_left = np.zeros(M, dtype=bool)
    recv_right = np.zeros(M, dtype=bool)

    # pass 2: per updated in-set factor, flags + SRMP weight
    # (LP_MP.h:1306-1408)
    for f in order:
        if not updated[f]:
            continue
        fi = pos[f]
        send_flags: list[tuple[int, bool, bool]] = []  # (msg, is_left, flag)
        total_send = 0
        for mi, is_left in views[f]:
            m = messages[mi]
            sends, receives, _, _ = _side_flags(m, is_left)
            a = m.right if is_left else m.left
            if sends:
                total_send += 1
                if pos[a] >= 0:
                    flag = (fi < pos[a] and updated[a]) or (last_receiving[a] > fi)
                else:
                    flag = fi < max_adj_recv.get(a, 0)
                send_flags.append((mi, is_left, flag))
            if receives:
                if pos[a] >= 0:
                    flag = (pos[a] < fi) or (first_receiving[a] < fi)
                else:
                    flag = min_adj_send.get(a, 0) < fi
                if is_left:
                    recv_left[mi] = flag
                else:
                    recv_right[mi] = flag

        aniso = sum(1 for _, _, fl in send_flags if fl)
        if aniso > 0:
            w = 1.0 / (no_receiving_later[f] + max(aniso, total_send - aniso))
            for mi, is_left, fl in send_flags:
                if fl:
                    if is_left:
                        omega_left[mi] = w
                    else:
                        omega_right[mi] = w
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_anisotropic2_weights(order: Sequence[int], n: int,
                                 messages: Sequence[MessageDesc],
                                 updated: np.ndarray) -> Weights:
    """omega = 1/#(messages sent to later factors); receive iff adjacent
    earlier (LP_MP.h:1084-1154)."""
    M = len(messages)
    pos = np.empty(n, dtype=np.int64)
    pos[np.asarray(order)] = np.arange(n)
    views = _per_factor_views(n, messages)

    no_send_later = np.zeros(n, dtype=np.int64)
    for i, m in enumerate(messages):
        if m.schedule.sends_to_right and pos[m.left] < pos[m.right]:
            no_send_later[m.left] += 1
        if m.schedule.sends_to_left and pos[m.right] < pos[m.left]:
            no_send_later[m.right] += 1

    omega_left = np.zeros(M)
    omega_right = np.zeros(M)
    recv_left = np.zeros(M, dtype=bool)
    recv_right = np.zeros(M, dtype=bool)
    for f in range(n):
        if not updated[f]:
            continue
        for mi, is_left in views[f]:
            m = messages[mi]
            sends, receives, _, _ = _side_flags(m, is_left)
            a = m.right if is_left else m.left
            if sends and pos[f] < pos[a]:
                w = 1.0 / no_send_later[f]
                if is_left:
                    omega_left[mi] = w
                else:
                    omega_right[mi] = w
            if receives and pos[a] < pos[f]:
                if is_left:
                    recv_left[mi] = True
                else:
                    recv_right[mi] = True
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_uniform_weights(order: Sequence[int], n: int,
                            messages: Sequence[MessageDesc],
                            updated: np.ndarray,
                            leave_weight: float) -> Weights:
    """omega = 1/(#send + leave_weight); full receive mask
    (LP_MP.h:1420-1449, 1480-1505)."""
    M = len(messages)
    views = _per_factor_views(n, messages)
    omega_left = np.zeros(M)
    omega_right = np.zeros(M)
    recv_left = np.zeros(M, dtype=bool)
    recv_right = np.zeros(M, dtype=bool)
    for f in range(n):
        if not updated[f]:
            continue
        n_send = 0
        for mi, is_left in views[f]:
            sends, receives, _, _ = _side_flags(messages[mi], is_left)
            if sends:
                n_send += 1
            if receives:
                if is_left:
                    recv_left[mi] = True
                else:
                    recv_right[mi] = True
        if n_send == 0:
            continue
        w = 1.0 / (n_send + leave_weight)
        for mi, is_left in views[f]:
            sends, _, _, _ = _side_flags(messages[mi], is_left)
            if sends:
                if is_left:
                    omega_left[mi] = w
                else:
                    omega_right[mi] = w
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_weights(mode: ReparametrizationMode, order: Sequence[int], n: int,
                    messages: Sequence[MessageDesc],
                    updated: np.ndarray) -> Weights:
    if mode == ReparametrizationMode.anisotropic:
        return compute_anisotropic_weights(order, n, messages, updated)
    if mode == ReparametrizationMode.anisotropic2:
        return compute_anisotropic2_weights(order, n, messages, updated)
    if mode == ReparametrizationMode.uniform:
        return compute_uniform_weights(order, n, messages, updated, 0.0)
    if mode == ReparametrizationMode.damped_uniform:
        return compute_uniform_weights(order, n, messages, updated, 1.0)
    if mode == ReparametrizationMode.mixed:
        # average of anisotropic and damped uniform omegas, full receive mask
        # (LP_MP.h:1451-1478; the reference flags this mode assert(false))
        a = compute_anisotropic_weights(order, n, messages, updated)
        d = compute_uniform_weights(order, n, messages, updated, 1.0)
        return Weights(0.5 * (a.omega_left + d.omega_left),
                       0.5 * (a.omega_right + d.omega_right),
                       d.recv_left, d.recv_right)
    raise ValueError(f"unknown reparametrization mode {mode}")


# ---------------------------------------------------------------------------
# Vectorized (array-form) weight computation — same math as the per-message
# loops above, restructured over "slots" (one per message side) so a
# 10^6-message graph computes weights in O(M) NumPy instead of O(M) Python.
# Only valid for full-set orders (every factor in ``order``); partition /
# push passes with subset relay rules keep the loop form.
# ---------------------------------------------------------------------------

def _slot_arrays(typed):
    """Flatten [(schedule, lfid[], rfid[], gids[])] into both-side slot
    arrays: (f, a, mi, is_left, sends, receives, adj_recv)."""
    fs, as_, mis, lts, sds, rcs, ars = [], [], [], [], [], [], []
    for s, l, r, g in typed:
        l = np.asarray(l, dtype=np.int64)
        r = np.asarray(r, dtype=np.int64)
        g = np.asarray(g, dtype=np.int64)
        m = len(g)
        # left side of the message: f = left factor
        fs.append(l)
        as_.append(r)
        mis.append(g)
        lts.append(np.ones(m, dtype=bool))
        sds.append(np.full(m, s.sends_to_right))
        rcs.append(np.full(m, s.left_receives))
        ars.append(np.full(m, s.right_receives))
        # right side
        fs.append(r)
        as_.append(l)
        mis.append(g)
        lts.append(np.zeros(m, dtype=bool))
        sds.append(np.full(m, s.sends_to_left))
        rcs.append(np.full(m, s.right_receives))
        ars.append(np.full(m, s.left_receives))
    if not fs:
        z = np.zeros(0, dtype=np.int64)
        b = np.zeros(0, dtype=bool)
        return z, z, z, b, b, b, b
    return (np.concatenate(fs), np.concatenate(as_), np.concatenate(mis),
            np.concatenate(lts), np.concatenate(sds), np.concatenate(rcs),
            np.concatenate(ars))


def compute_anisotropic_weights_arrays(order, n: int, typed, n_messages: int,
                                       updated: np.ndarray) -> Weights:
    """Vectorized SRMP anisotropic weights (LP_MP.h:1230-1415), full-set
    order only (loop-form parity pinned by tests/test_weights_arrays.py)."""
    order = np.asarray(order, dtype=np.int64)
    assert len(order) == n, "array-form weights require a full-set order"
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    f, a, mi, is_left, sends, receives, adj_recv = _slot_arrays(typed)
    pf, pa = pos[f], pos[a]

    # pass 1: receiving-factor statistics (LP_MP.h:1242-1261)
    MAXI = np.iinfo(np.int64).max
    sel = adj_recv & (pa > pf)
    no_receiving_later = np.bincount(f[sel], minlength=n)
    last_receiving = np.zeros(n, dtype=np.int64)
    np.maximum.at(last_receiving, f[sel], pa[sel])
    first_receiving = np.full(n, MAXI, dtype=np.int64)
    np.minimum.at(first_receiving, f[sel], pa[sel])

    omega_left = np.zeros(n_messages)
    omega_right = np.zeros(n_messages)
    recv_left = np.zeros(n_messages, dtype=bool)
    recv_right = np.zeros(n_messages, dtype=bool)

    # pass 2: send flags + SRMP weight (LP_MP.h:1306-1408)
    ss = sends & updated[f]
    flag = ((pf < pa) & updated[a]) | (last_receiving[a] > pf)
    total_send = np.bincount(f[ss], minlength=n)
    aniso = np.bincount(f[ss & flag], minlength=n)
    denom = no_receiving_later + np.maximum(aniso, total_send - aniso)
    w_f = np.where(aniso > 0, 1.0 / np.maximum(denom, 1), 0.0)
    sel_o = ss & flag
    lsel = sel_o & is_left
    omega_left[mi[lsel]] = w_f[f[lsel]]
    rsel = sel_o & ~is_left
    omega_right[mi[rsel]] = w_f[f[rsel]]

    rr = receives & updated[f]
    rflag = (pa < pf) | (first_receiving[a] < pf)
    lsel = rr & rflag & is_left
    recv_left[mi[lsel]] = True
    rsel = rr & rflag & ~is_left
    recv_right[mi[rsel]] = True
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_anisotropic2_weights_arrays(order, n: int, typed, n_messages: int,
                                        updated: np.ndarray) -> Weights:
    """Vectorized anisotropic2 (LP_MP.h:1084-1154)."""
    order = np.asarray(order, dtype=np.int64)
    assert len(order) == n
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    f, a, mi, is_left, sends, receives, _ = _slot_arrays(typed)
    pf, pa = pos[f], pos[a]

    no_send_later = np.bincount(f[sends & (pf < pa)], minlength=n)
    omega_left = np.zeros(n_messages)
    omega_right = np.zeros(n_messages)
    recv_left = np.zeros(n_messages, dtype=bool)
    recv_right = np.zeros(n_messages, dtype=bool)

    sel = sends & updated[f] & (pf < pa)
    w = 1.0 / np.maximum(no_send_later, 1)
    omega_left[mi[sel & is_left]] = w[f[sel & is_left]]
    omega_right[mi[sel & ~is_left]] = w[f[sel & ~is_left]]
    sel = receives & updated[f] & (pa < pf)
    recv_left[mi[sel & is_left]] = True
    recv_right[mi[sel & ~is_left]] = True
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_uniform_weights_arrays(n: int, typed, n_messages: int,
                                   updated: np.ndarray,
                                   leave_weight: float) -> Weights:
    """Vectorized uniform/damped weights (LP_MP.h:1420-1449, 1480-1505)."""
    f, a, mi, is_left, sends, receives, _ = _slot_arrays(typed)
    n_send = np.bincount(f[sends & updated[f]], minlength=n)
    w = 1.0 / (np.maximum(n_send, 1) + leave_weight)
    omega_left = np.zeros(n_messages)
    omega_right = np.zeros(n_messages)
    recv_left = np.zeros(n_messages, dtype=bool)
    recv_right = np.zeros(n_messages, dtype=bool)
    sel = sends & updated[f] & (n_send[f] > 0)
    omega_left[mi[sel & is_left]] = w[f[sel & is_left]]
    omega_right[mi[sel & ~is_left]] = w[f[sel & ~is_left]]
    sel = receives & updated[f]
    recv_left[mi[sel & is_left]] = True
    recv_right[mi[sel & ~is_left]] = True
    return Weights(omega_left, omega_right, recv_left, recv_right)


def compute_weights_arrays(mode: ReparametrizationMode, order, n: int,
                           typed, n_messages: int,
                           updated: np.ndarray) -> Weights:
    """Array-form compute_weights over [(schedule, lfid, rfid, gids)]."""
    mode = ReparametrizationMode.convert(mode)
    if mode == ReparametrizationMode.anisotropic:
        return compute_anisotropic_weights_arrays(order, n, typed,
                                                  n_messages, updated)
    if mode == ReparametrizationMode.anisotropic2:
        return compute_anisotropic2_weights_arrays(order, n, typed,
                                                   n_messages, updated)
    if mode == ReparametrizationMode.uniform:
        return compute_uniform_weights_arrays(n, typed, n_messages,
                                              updated, 0.0)
    if mode == ReparametrizationMode.damped_uniform:
        return compute_uniform_weights_arrays(n, typed, n_messages,
                                              updated, 1.0)
    if mode == ReparametrizationMode.mixed:
        a = compute_anisotropic_weights_arrays(order, n, typed,
                                               n_messages, updated)
        d = compute_uniform_weights_arrays(n, typed, n_messages, updated, 1.0)
        return Weights(0.5 * (a.omega_left + d.omega_left),
                       0.5 * (a.omega_right + d.omega_right),
                       d.recv_left, d.recv_right)
    raise ValueError(f"unknown reparametrization mode {mode}")


def omega_valid_arrays(weights: Weights, n: int, typed) -> bool:
    """Array-form omega_valid (LP_MP.h:1007-1014)."""
    if (weights.omega_left < 0).any() or (weights.omega_right < 0).any():
        return False
    acc = np.zeros(n)
    for s, l, r, g in typed:
        np.add.at(acc, np.asarray(l), weights.omega_left[np.asarray(g)])
        np.add.at(acc, np.asarray(r), weights.omega_right[np.asarray(g)])
    return bool((acc <= 1.0 + 1e-6).all())


def omega_valid(weights: Weights, n: int, messages: Sequence[MessageDesc]) -> bool:
    """Sum of omegas per sending factor <= 1, all >= 0 (LP_MP.h:1007-1014)."""
    if (weights.omega_left < 0).any() or (weights.omega_right < 0).any():
        return False
    acc = np.zeros(n)
    for i, m in enumerate(messages):
        acc[m.left] += weights.omega_left[i]
        acc[m.right] += weights.omega_right[i]
    return bool((acc <= 1.0 + 1e-6).all())


# ---------------------------------------------------------------------------
# Phase decomposition
# ---------------------------------------------------------------------------

def adjacency_csr(n: int, messages: Sequence[MessageDesc]):
    """Symmetric factor-adjacency CSR (indptr, indices) from messages."""
    if len(messages) == 0:
        return np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
    l = np.fromiter((m.left for m in messages), dtype=np.int64,
                    count=len(messages))
    r = np.fromiter((m.right for m in messages), dtype=np.int64,
                    count=len(messages))
    return adjacency_csr_from_arrays(n, [(l, r)])


def adjacency_csr_from_arrays(n: int, endpoint_arrays):
    """CSR from [(left_fid[], right_fid[]), ...] per message type."""
    if not endpoint_arrays:
        return np.zeros(n + 1, dtype=np.int64), np.zeros(0, dtype=np.int64)
    l = np.concatenate([np.asarray(a, dtype=np.int64)
                        for a, _ in endpoint_arrays])
    r = np.concatenate([np.asarray(b, dtype=np.int64)
                        for _, b in endpoint_arrays])
    src = np.concatenate([l, r])
    dst = np.concatenate([r, l])
    order = np.argsort(src, kind="stable")
    indices = dst[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    return indptr, indices


def updated_mask_from_arrays(n: int, typed) -> np.ndarray:
    """factor_updated_mask over [(schedule, left_fid[], right_fid[]), ...]
    (one entry per message type — vectorized form)."""
    upd = np.zeros(n, dtype=bool)
    for s, l, r in typed:
        if s.sends_to_right or s.left_receives:
            upd[np.asarray(l, dtype=np.int64)] = True
        if s.sends_to_left or s.right_receives:
            upd[np.asarray(r, dtype=np.int64)] = True
    return upd


def _group_phases(order: Sequence[int], phase_of: np.ndarray,
                  n_phases: int) -> list[list[int]]:
    """Group scheduled factors into phase lists, preserving sweep order."""
    order = np.asarray(order, dtype=np.int64)
    sched_mask = phase_of[order] >= 0
    fs = order[sched_mask]
    ps = phase_of[fs]
    sort = np.argsort(ps, kind="stable")  # stable keeps sweep order in phase
    fs = fs[sort]
    bounds = np.searchsorted(ps[sort], np.arange(1, n_phases))
    return [list(g) for g in np.split(fs, bounds)]


def levelize(order: Sequence[int], n: int, messages: Sequence[MessageDesc],
             updated: np.ndarray) -> list[list[int]]:
    """Partition the updated factors (in sweep order) into parallel phases.

    An updated factor's update *touches* its own costs and every adjacent
    factor's costs.  Factor f is placed in the earliest phase strictly after
    every earlier-ordered updated factor whose touch-set intersects f's.
    Running phases sequentially, each phase fully batched, is then exactly
    the sequential sweep (all cross-factor data dependencies respected;
    within a phase all touch-sets are disjoint).

    The sequential graph walk runs natively (csrc/lpmp_host.cpp
    lpmp_levelize) with a pure-Python fallback of identical semantics.
    """
    indptr, indices = adjacency_csr(n, messages)
    return levelize_csr(order, n, indptr, indices, updated)


def levelize_csr(order: Sequence[int], n: int, indptr, indices,
                 updated: np.ndarray) -> list[list[int]]:
    from . import native
    res = native.levelize_csr(np.asarray(order, dtype=np.int64), indptr,
                              indices, updated)
    if res is not None:
        phase_of, n_phases = res
        return _group_phases(order, phase_of, n_phases)

    taken = np.full(n, -1, dtype=np.int64)  # max phase among earlier touches
    phases: list[list[int]] = []
    for f in order:
        if not updated[f]:
            continue
        touch = list(indices[indptr[f]:indptr[f + 1]]) + [f]
        p = int(max(taken[h] for h in touch)) + 1
        if p == len(phases):
            phases.append([])
        phases[p].append(int(f))
        for h in touch:
            if taken[h] < p:
                taken[h] = p
    return phases


def coloring_order(n: int, messages: Sequence[MessageDesc],
                   updated: np.ndarray) -> list[int]:
    """Reorder factors so that levelize() yields few phases.

    Greedy-colors the conflict graph over updated factors (conflict = shared
    adjacent factor or direct adjacency), orders updated factors by color,
    and slots each passive factor directly after its earliest-ordered
    neighbor (so anisotropic weights see it "between" its endpoints, like
    the reference's interleaved factor relations).  For a grid MRF this
    reproduces a red/black schedule with 2 phases.

    The distance-2 greedy coloring runs natively (csrc/lpmp_host.cpp
    lpmp_color2) with a pure-Python fallback of identical semantics.
    """
    indptr, indices = adjacency_csr(n, messages)
    return coloring_order_csr(n, indptr, indices, updated)


def coloring_order_csr(n: int, indptr, indices,
                       updated: np.ndarray) -> list[int]:
    from . import native
    color = native.color2_csr(indptr, indices, updated)
    if color is None:
        color = np.full(n, -1, dtype=np.int64)
        for f in range(n):
            if not updated[f]:
                continue
            used = set()
            nbrs = indices[indptr[f]:indptr[f + 1]]
            for h in nbrs:
                if h != f and updated[h] and color[h] >= 0:
                    used.add(int(color[h]))
                for g in indices[indptr[h]:indptr[h + 1]]:
                    if g != f and updated[g] and color[g] >= 0:
                        used.add(int(color[g]))
            c = 0
            while c in used:
                c += 1
            color[f] = c

    updated = np.asarray(updated, dtype=bool)
    upd = np.nonzero(updated)[0]
    upd_sorted = upd[np.lexsort((upd, color[upd]))]
    pos_of = np.full(n, -1, dtype=np.int64)
    pos_of[upd_sorted] = np.arange(len(upd_sorted))

    # passive factors: anchor = earliest-ordered updated neighbor
    passive = np.nonzero(~updated)[0]
    # sort key per factor: (anchor position, passive?, factor id); updated
    # factors anchor at their own position
    key_pos = np.full(n, n + 1, dtype=np.int64)
    key_pos[upd_sorted] = np.arange(len(upd_sorted))
    if len(passive):
        deg = indptr[1:] - indptr[:-1]
        nbr_pos = np.where(pos_of[indices] >= 0, pos_of[indices], n + 1)
        mins = np.minimum.reduceat(
            np.concatenate([nbr_pos, [n + 1]]),
            np.minimum(indptr[:-1], len(indices)))
        mins = np.where(deg > 0, mins, n + 1)
        key_pos[passive] = mins[passive]
    is_passive = (~updated).astype(np.int64)
    order = np.lexsort((np.arange(n), is_passive, key_pos))
    return [int(f) for f in order]
