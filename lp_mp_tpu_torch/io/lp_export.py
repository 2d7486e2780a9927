"""Export the factor-graph LP relaxation (local polytope); counterpart of
``lp_mp_tpu/io/lp_export.py``.

Counterpart of ``LP_external_solver`` / DD_ILP's ``problem_export``
(LP_external_interface.hxx:22-83, exercised by test/test_model.cpp:40-48):
every factor contributes a block of [0,1] variables with intra-factor
equality rows (simplexes, arithmetic encodings), every message contributes
coupling equalities gluing its two endpoint blocks, and the objective is
the current (reparametrized) cost, whose LP value is invariant under the
zero-sum message shifts, which makes this module a strong correctness
oracle for the whole engine.

The per-type constraint construction lives on the types themselves
(``FactorType.lp_vars/lp_fix/lp_read`` and ``MessageType.lp_coupling``),
which take host numpy rows.  The engine's state goes to the host once per
call, block by block (``convert.engine_state_to_numpy``); the rows are
numpy slices of that copy, never per-factor reads of a device tensor.

Two consumers: ``export_lp_text`` writes CPLEX .lp format;
``solve_lp_relaxation`` solves the same LP with scipy/HiGHS.  ``io/ilp``
reuses the identical constraint system for exact MILP solves.
"""
from __future__ import annotations

import numpy as np

from ..convert import engine_state_to_numpy


def _factor_tables(engine):
    """Per factor id: (ftype, meta, flat costs, intra rows, intra rhs) from
    the per-type lp_vars hooks, on the current reparametrization."""
    out = []
    state = engine_state_to_numpy(engine.state)
    for fid, (ft, data) in enumerate(engine.graph.factors):
        row = engine.f_local[fid]
        state_row = {k: v[row] for k, v in state[ft.name].items()}
        costs, rows, rhs, meta = ft.lp_vars(state_row, data)
        out.append((ft, meta, np.asarray(costs, dtype=np.float64),
                    rows, rhs))
    return out


def build_local_polytope(engine, tables=None):
    """Returns (c, A_eq rows as list of {var: coef}, b_eq, var_offsets).
    ``tables``: ``_factor_tables(engine)`` where the caller has it."""
    if tables is None:
        tables = _factor_tables(engine)
    offsets = []
    total = 0
    for (_, _, c, _, _) in tables:
        offsets.append(total)
        total += len(c)
    cost = (np.concatenate([c for (_, _, c, _, _) in tables])
            if tables else np.zeros(0))

    rows: list[dict[int, float]] = []
    b: list[float] = []
    # intra-factor constraints (simplexes etc.)
    for fid, (_, _, _, frows, frhs) in enumerate(tables):
        o = offsets[fid]
        for r, rv in zip(frows, frhs):
            rows.append({o + k: v for k, v in r.items()})
            b.append(rv)

    # coupling constraints per message
    for (mt, l, r, data) in engine.graph.messages:
        lmeta = tables[l][1]
        rmeta = tables[r][1]
        lo, ro = offsets[l], offsets[r]
        for (lc, rc, rhs) in mt.lp_coupling(lmeta, rmeta, data):
            row: dict[int, float] = {}
            for k, v in lc.items():
                row[lo + k] = row.get(lo + k, 0.0) + v
            for k, v in rc.items():
                row[ro + k] = row.get(ro + k, 0.0) + v
            rows.append(row)
            b.append(rhs)
    return cost, rows, b, offsets


def rows_to_csr(rows, nvar: int):
    """The equality rows as a scipy CSR matrix [len(rows), nvar]."""
    from scipy.sparse import csr_matrix

    data, ri, ci = [], [], []
    for i, row in enumerate(rows):
        for j, v in row.items():
            ri.append(i)
            ci.append(j)
            data.append(v)
    return csr_matrix((data, (ri, ci)), shape=(len(rows), nvar))


def solve_lp_relaxation(engine) -> float:
    """LP relaxation value via scipy/HiGHS: cross-check oracle for
    engine.lower_bound() (the DBCA bound can never exceed it)."""
    from scipy.optimize import linprog

    cost, rows, b, _ = build_local_polytope(engine)
    A = rows_to_csr(rows, len(cost))
    res = linprog(cost, A_eq=A, b_eq=np.asarray(b), bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"LP solve failed: {res.message}")
    return float(res.fun) + engine.constant


def export_lp_text(engine) -> str:
    """CPLEX .lp format (DD_ILP problem_export analogue)."""
    cost, rows, b, _ = build_local_polytope(engine)
    lines = ["Minimize", " obj:"]
    terms = []
    for j, cj in enumerate(cost):
        if cj != 0.0:
            terms.append(f" {'+' if cj >= 0 else '-'} {abs(cj):.17g} x{j}")
    lines.append("".join(terms) if terms else " 0 x0")
    lines.append("Subject To")
    for i, row in enumerate(rows):
        terms = []
        for j, v in sorted(row.items()):
            terms.append(f" {'+' if v >= 0 else '-'} {abs(v):.17g} x{j}")
        lines.append(f" c{i}:{''.join(terms)} = {b[i]:.17g}")
    lines.append("Bounds")
    for j in range(len(cost)):
        lines.append(f" 0 <= x{j}")
    lines.append("End")
    return "\n".join(lines) + "\n"


def export_lp_file(engine, path: str) -> None:
    with open(path, "w") as f:
        f.write(export_lp_text(engine))
