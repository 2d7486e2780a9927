"""UAI MARKOV format parser (copy of ``lp_mp_tpu/io/uai.py``).

Mirrors the downstream ``UaiMrfInput`` grammar exercised by
test/graphical_model.cpp:11-57: header MARKOV, #vars, cardinalities,
#cliques, clique scopes, then one cost table per clique.  Variables without
a unary clique get zero unaries (test/graphical_model.cpp:10).
"""
from __future__ import annotations

import numpy as np


def parse_uai(text: str) -> dict:
    toks = text.split()
    if not toks or toks[0].upper() != "MARKOV":
        raise ValueError("expected MARKOV header")
    pos = 1

    def take(n=1):
        nonlocal pos
        out = toks[pos:pos + n]
        pos += n
        return out

    n_vars = int(take()[0])
    card = [int(x) for x in take(n_vars)]
    n_cliques = int(take()[0])
    scopes = []
    for _ in range(n_cliques):
        k = int(take()[0])
        scopes.append([int(x) for x in take(k)])
    tables = []
    for scope in scopes:
        n = int(take()[0])
        expect = int(np.prod([card[v] for v in scope]))
        if n != expect:
            raise ValueError(f"table size {n} != expected {expect} for scope {scope}")
        vals = np.asarray([float(x) for x in take(n)])
        # Column-major layout: the reference's UaiMrfInput reads function
        # tables with the FIRST scope variable as the fastest index — pinned
        # by test/graphical_model.cpp:60 (chain optimum 0.564, which only
        # holds under this convention).
        tables.append(vals.reshape([card[v] for v in scope], order="F"))
    return {"n_vars": n_vars, "cardinalities": card,
            "scopes": scopes, "tables": tables}


def build_mrf(mrf, parsed: dict) -> None:
    """Populate an MrfConstructor: unaries in variable order (zero where
    absent), then pairwise factors."""
    card = parsed["cardinalities"]
    unary = [np.zeros(card[v]) for v in range(parsed["n_vars"])]
    pairwise = []
    for scope, table in zip(parsed["scopes"], parsed["tables"]):
        if len(scope) == 1:
            unary[scope[0]] = unary[scope[0]] + table
        elif len(scope) == 2:
            i, j = scope
            if i > j:
                i, j = j, i
                table = table.T
            pairwise.append((i, j, table))
        else:
            raise ValueError("only unary/pairwise cliques supported in MRF input")
    for v in range(parsed["n_vars"]):
        mrf.add_unary_factor(unary[v])
    for i, j, t in pairwise:
        mrf.add_pairwise_factor(i, j, t)


def parse_and_build(text: str, mrf) -> None:
    build_mrf(mrf, parse_uai(text))
