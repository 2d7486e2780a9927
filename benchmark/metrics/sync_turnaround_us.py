"""Device idle microseconds around a sync: for each ``lpmp.sync.<site>``
span of the window (a wait of the host for the device), the idle gap of
the device that the span's end falls in, from the end of the last device
operation before it to the start of the next one after it, 0 where the
device was busy then; the mean over the spans.  It is what each wait
costs the device: the host's wake-up and its enqueue of the next work.
Needs ``rec["trace"]["program"]`` (``benchmark/program_trace.py``)."""
import bisect


def read(rec: dict, cs: dict):
    tr = rec.get("trace") or {}
    prog = tr.get("program")
    if not prog or not prog["busy"]:
        return None
    ends = [t for name, v in prog["spans"].items() if name.startswith("lpmp.sync.")
            for _, t in v]
    if not ends:
        return None
    w0, w1 = tr["window"]
    busy = prog["busy"]
    starts = [s for s, _ in busy]
    idle = 0.0
    for t in ends:
        i = bisect.bisect_right(starts, t)
        if i and busy[i - 1][1] >= t:
            continue
        idle += (busy[i][0] if i < len(busy) else w1) - (busy[i - 1][1] if i else w0)
    return 1e6 * idle / len(ends)
