"""Parser for the Torresani-Kolmogorov-Rother graph matching format (copy of
``lp_mp_tpu/io/torresani.py``).

Format (documented by test/graph_matching.cpp:13-26):

    c <comment>
    p <N0> <N1> <A> <E>          # left nodes, right nodes, assignments, edges
    a <aid> <i> <j> <cost>       # assignment aid: left i -> right j
    e <a1> <a2> <cost>           # pairwise cost between two assignments
    n0 <i> <j>                   # left neighbor hints (unused here)
    n1 <i> <j>                   # right neighbor hints (unused here)
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class GraphMatchingInput:
    n_left: int
    n_right: int
    assignments: list[tuple[int, int, float]]       # (left, right, cost) per aid
    edges: list[tuple[int, int, float]]             # (aid1, aid2, cost)


def parse_torresani(text: str) -> GraphMatchingInput:
    n0 = n1 = 0
    assignments: list[tuple[int, int, float]] = []
    edges: list[tuple[int, int, float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("c"):
            continue
        tok = line.split()
        if tok[0] == "p":
            n0, n1 = int(tok[1]), int(tok[2])
        elif tok[0] == "a":
            aid, i, j, cost = int(tok[1]), int(tok[2]), int(tok[3]), float(tok[4])
            assert aid == len(assignments), "assignment ids must be consecutive"
            assignments.append((i, j, cost))
        elif tok[0] == "e":
            edges.append((int(tok[1]), int(tok[2]), float(tok[3])))
        elif tok[0] in ("n0", "n1"):
            pass  # sparsification hints, not needed for correctness
        else:
            raise ValueError(f"unrecognized line: {raw!r}")
    return GraphMatchingInput(n0, n1, assignments, edges)


def parse_file(path: str) -> GraphMatchingInput:
    with open(path) as f:
        return parse_torresani(f.read())
