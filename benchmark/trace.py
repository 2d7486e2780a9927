"""Spans around the calls into the program, and the reading of the trace.

Untraced runs get spans that do nothing.  In a traced run every span is a
``torch.profiler.record_function`` range, so it lies on the trace's clock
beside the device's kernels; a span asked to ``sync`` ends with
``torch.cuda.synchronize()``, so its host time holds the device work it
enqueued.
"""
from __future__ import annotations

import bisect
import collections
import contextlib

# host spans that label the device's idle gaps
GAP_LABELS = ("lb_sync", "rounding", "visitor", "reset")


class Spans:
    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.device = device

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        import torch
        with torch.profiler.record_function(name):
            yield
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)


def profiler(device):
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


# the spans' names: on the device's timeline the profiler also draws each
# span as a user annotation, which is no work of the device
SPAN_NAMES = ("solve",) + GAP_LABELS


def read(prof, n_counted: int) -> dict:
    """The traced window's device activity, from the profiler's raw events.
    The window runs from the start of the first ``solve`` span to the end of
    the ``n_counted``-th.

    Returns {"window": (start, end), "window_s", "busy_s", "kernels": {name:
    [seconds per launch]}, "gaps": [(label, seconds)], "spans": {name:
    [(start_s, end_s)]}}, times in seconds on the trace's clock."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    base = min((e.start_ns() for e in events), default=0)
    dev, spans = [], collections.defaultdict(list)
    for e in events:
        name = e.name()
        s = (e.start_ns() - base) * 1e-9
        t = s + e.duration_ns() * 1e-9
        if e.device_type() == cuda:
            if name not in SPAN_NAMES:
                dev.append((s, t, name))
        elif name in SPAN_NAMES:
            spans[name].append((s, t))
    for v in spans.values():
        v.sort()
    solves = spans.get("solve", [])[:n_counted]
    if not solves:
        return {}
    w0, w1 = solves[0][0], solves[-1][1]
    kernels = collections.defaultdict(list)
    inside = []
    for s, t, name in dev:
        if s >= w0 and t <= w1:
            kernels[name].append(t - s)
            inside.append((s, t))
    busy = _union(inside)
    gaps = []
    prev = w0
    for s, t in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    # spans of one label do not overlap: the ones a gap meets lie between
    # the first that ends after it starts and the last that starts before it ends
    index = {n: ([s for s, _ in spans[n]], [t for _, t in spans[n]]) for n in GAP_LABELS
             if n in spans}
    labelled = []
    for g0, g1 in gaps:
        best, label = 0.0, "other"
        for name, (starts, ends) in index.items():
            for i in range(bisect.bisect_right(ends, g0), bisect.bisect_left(starts, g1)):
                ov = min(g1, ends[i]) - max(g0, starts[i])
                if ov > best:
                    best, label = ov, name
        labelled.append((label, g1 - g0))
    return {"window": (w0, w1), "window_s": w1 - w0, "busy_s": sum(t - s for s, t in busy),
            "kernels": dict(kernels), "gaps": labelled, "spans": dict(spans)}


def breakdown(summary: dict, top: int = 10) -> dict:
    ops = sorted(((k, sum(v)) for k, v in summary["kernels"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"], key=lambda g: -g[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
