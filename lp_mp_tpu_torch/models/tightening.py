"""Cutting-plane tightening: triplet search (counterpart of
``lp_mp_tpu/models/tightening.py``).

MPLP-style frustrated-triangle separation (reference
``problem_constructors/cycle_inequalities.hxx``, acceptance pinned by
test/graphical_model.cpp:191-204): for each triangle of existing pairwise
factors, score the guaranteed dual increase of adding its triplet —

    score = min_{x1,x2,x3} [ th_ij + th_ik + th_jk ]
            - (min th_ij + min th_ik + min th_jk)

on the *current reparametrization*; add the top-scoring triplets.
Runs on the host once per tightening round (not in the hot path), on
float64 copies of the engine's blocks, one transfer per block.
"""
from __future__ import annotations

import numpy as np

from ..convert import host_array


def _pairwise_matrix(constructor, engine, i: int, j: int) -> np.ndarray:
    """One factor's reparametrized matrix (one row transfer; batched code
    uses ``_batched_scores``)."""
    from ..factors.simplex import PAIRWISE_SIMPLEX
    p = constructor.pairwise[(i, j)]
    assert p.ftype is PAIRWISE_SIMPLEX
    row = int(engine.f_local[p.fid])
    c = host_array(engine.state[PAIRWISE_SIMPLEX.name]["c"][row], np.float64)
    ft, data = engine.graph.factors[p.fid]
    n1, n2 = data.shape
    return c[:n1, :n2]


def triangle_candidates(constructor):
    """All triangles in the pairwise-factor graph (graph.hxx:172-218
    sorted-adjacency intersection analogue, host NumPy)."""
    nbrs: dict[int, set[int]] = {}
    for (i, j) in constructor.pairwise:
        nbrs.setdefault(i, set()).add(j)
        nbrs.setdefault(j, set()).add(i)
    out = []
    for (i, j) in sorted(constructor.pairwise):
        common = nbrs.get(i, set()) & nbrs.get(j, set())
        for k in sorted(common):
            if k > j:
                out.append((i, j, k))
    return out


def triplet_score(constructor, engine, i: int, j: int, k: int) -> float:
    tij = _pairwise_matrix(constructor, engine, i, j)
    tik = _pairwise_matrix(constructor, engine, i, k)
    tjk = _pairwise_matrix(constructor, engine, j, k)
    joint = (tij[:, :, None] + tik[:, None, :] + tjk[None, :, :]).min()
    indep = tij.min() + tik.min() + tjk.min()
    return float(joint - indep)


def _batched_scores(constructor, engine, triangles) -> np.ndarray:
    """Scores for a list of (i,j,k) triangles in one batched reduction:
    a single device->host copy of each of the pairwise block's tensors,
    then chunked [T,L,L,L] broadcast mins (PAD_COST padding cannot win a
    min, so padded label slots need no masking)."""
    from ..factors.simplex import PAIRWISE_SIMPLEX
    pw = constructor.pairwise
    blk = engine.state[PAIRWISE_SIMPLEX.name]
    c = host_array(blk["c"], np.float64)
    n1 = host_array(blk["n1"])
    n2 = host_array(blk["n2"])
    # mask invalid label slots with +inf (padding slots may hold arbitrary
    # reparametrized values), then square-pad so label axes align
    S = max(c.shape[1], c.shape[2])
    cm = np.full((c.shape[0], S, S), np.inf)
    cm[:, :c.shape[1], :c.shape[2]] = c
    valid = ((np.arange(S)[None, :, None] < n1[:, None, None])
             & (np.arange(S)[None, None, :] < n2[:, None, None]))
    cm = np.where(valid, cm, np.inf)
    rows = np.empty((len(triangles), 3), dtype=np.int64)
    for t, (i, j, k) in enumerate(triangles):
        for s, p in enumerate((pw[(i, j)], pw[(i, k)], pw[(j, k)])):
            assert p.ftype is PAIRWISE_SIMPLEX, \
                "triplet tightening needs dense pairwise factors"
            rows[t, s] = engine.f_local[p.fid]
    scores = np.empty(len(triangles))
    CH = max(1, 1 << 24 >> (3 * S.bit_length()))
    for s in range(0, len(triangles), CH):
        e = min(s + CH, len(triangles))
        tij = cm[rows[s:e, 0]]
        tik = cm[rows[s:e, 1]]
        tjk = cm[rows[s:e, 2]]
        joint = (tij[:, :, :, None] + tik[:, :, None, :]
                 + tjk[:, None, :, :]).min(axis=(1, 2, 3))
        indep = (tij.min(axis=(1, 2)) + tik.min(axis=(1, 2))
                 + tjk.min(axis=(1, 2)))
        scores[s:e] = joint - indep
    return scores


def triplet_search(constructor, engine, max_constraints: int,
                   min_score: float = 1e-8) -> int:
    if max_constraints <= 0:
        return 0
    cand = [t for t in triangle_candidates(constructor)
            if t not in constructor.triplets]
    if not cand:
        return 0
    scores = _batched_scores(constructor, engine, cand)
    order = np.argsort(-scores, kind="stable")
    added = 0
    for t in order[:max_constraints]:
        if scores[t] <= min_score:
            break
        i, j, k = cand[t]
        constructor.add_tightening_triplet(i, j, k)
        added += 1
    return added
