"""Device milliseconds per solve in the dual bound: the device's busy time
(the union of kernels and copies) in the operations launched inside the
window's ``lpmp.grid.lower_bound`` and ``lpmp.engine.lower_bound`` spans
(the bound's graph replay, the clone of its value and its copy to the
host), over the counted solves.  An operation is matched to the host call
that launched it, the replay's ``cudaGraphLaunch`` or a copy, by their
correlation id (``benchmark/program_trace.py``: the profiler draws no
device-side range for a span that only launches a CUDA graph).  Needs
``rec["trace"]["program"]``."""

NAMES = ("lpmp.grid.lower_bound", "lpmp.engine.lower_bound")


def read(rec: dict, cs: dict):
    prog = (rec.get("trace") or {}).get("program")
    if not prog or not prog["busy"] or not rec["n_counted"]:
        return None
    device = [prog["device_s"][n] for n in NAMES if n in prog["device_s"]]
    if not device:
        return None
    return 1e3 * sum(device) / rec["n_counted"]
