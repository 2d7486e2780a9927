"""Waits of the host for the device per solve: the program's counter
``syncs`` (``lp_mp_tpu_torch.tracing.fetch``, every such wait on the
cells' paths) where the traced window ends less where it starts, over
the solves the window started (the counter also holds the waits of the
solve abandoned at the deadline).  Needs ``rec["counters"]``, ``{"start",
"end"}`` snapshots of ``tracing.counters()`` around the window
(``benchmark/program_trace.py``)."""


def read(rec: dict, cs: dict):
    c = rec.get("counters")
    if not c or not rec["attempted"]:
        return None
    return (c["end"]["syncs"] - c["start"]["syncs"]) / rec["attempted"]
