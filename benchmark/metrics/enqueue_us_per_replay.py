"""Host microseconds per CUDA graph replay: the mean duration of the
window's ``lpmp.replay`` spans (``capture.Graphed``: the copy-in of the
arguments, ``graph.replay()``, the launch accounting and the clones of
the results), which enqueue and do not wait.  Needs
``rec["trace"]["program"]`` (``benchmark/program_trace.py``)."""


def read(rec: dict, cs: dict):
    spans = (((rec.get("trace") or {}).get("program") or {}).get("spans") or {}).get("lpmp.replay")
    if not spans:
        return None
    return 1e6 * sum(t - s for s, t in spans) / len(spans)
