"""Host seconds per solve in primal rounding: the traced run's ``rounding``
spans (each ended by a synchronize) around ``round_primal``, the engine's
labelling sweeps with ``Solver.register_primal``, and a constructor's
``compute_primal`` (GAEC), inside the traced window."""


def read(rec: dict, cs: dict):
    tr = rec.get("trace")
    if not tr or not rec["n_counted"]:
        return None
    w0, w1 = tr["window"]
    spans = [(s, t) for s, t in tr["spans"].get("rounding", ()) if s >= w0 and t <= w1]
    if not spans:
        return None
    return sum(t - s for s, t in spans) / rec["n_counted"]
