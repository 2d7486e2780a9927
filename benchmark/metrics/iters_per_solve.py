"""Dual iterations per solve in the traced window (solver and visitor
layer: the harness's grid loop, ``solver.py``, ``visitors.py``)."""


def read(rec: dict, cs: dict):
    solves = [s for s in rec["solves"] if s.ok]
    if not solves:
        return None
    return sum(s.iterations for s in solves) / len(solves)
