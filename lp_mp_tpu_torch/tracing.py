"""Spans and counters inside the port, on the profiler's clock.

Tracing is off by default; ``enable(True)`` turns it on for the process.

- **Spans.**  ``span(name)`` is a context manager and ``traced(name)`` a
  decorator.  Off, they cost one check of the flag (``span`` returns one
  shared no-op context).  On, each is a ``torch.profiler.record_function``
  range: a running ``torch.profiler.profile`` records it on the host, on
  the clock of the device's kernels, and draws it on the device's timeline
  too, over the work the range launched.  A span never synchronises, and
  spans sit around calls, never inside a function that ``capture.Graphs``
  captures.  Every name starts with ``lpmp.``; nesting is that of the
  ``with`` blocks on the calling thread, so a span's parent is the
  innermost span around it.  The module keeps no spans: the profiler holds
  them.
- **Counters** are always on and cost an addition each: ``captures`` and
  ``capture_s`` (the warm-up and capture seconds of every CUDA graph,
  ``capture.Graphed``), ``syncs`` and ``syncs_by_site`` (every wait of the
  host for the device, ``fetch``).  ``counters()`` returns a copy.
- **Syncs.**  ``fetch(site, t, as_)`` is the port's one way to wait for the
  device on its main paths: it brings ``t`` to the host as a ``float``, a
  ``bool`` or a numpy array, counts the wait under ``site`` and, traced, is
  the span ``lpmp.sync.<site>``.  A new sync written through it is counted;
  one written otherwise is not, and the card's sync-debug test
  (``benchmark/tests/test_bench_syncs_gpu.py``) finds it.
"""
from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

_enabled = False
_OFF = contextlib.nullcontext()
_counts: dict = {"captures": 0, "capture_s": 0.0, "syncs": 0}
_syncs_by_site: dict = {}


def enable(on: bool) -> None:
    """Turn the spans on or off for the process (counters are always on)."""
    global _enabled
    _enabled = bool(on)


def span(name: str):
    """A ``record_function`` range named ``name`` while tracing is on, else
    a shared no-op context."""
    if not _enabled:
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def add(counter: str, value=1) -> None:
    """Add ``value`` to the counter ``captures`` or ``capture_s``."""
    _counts[counter] += value


def counters() -> dict:
    """A copy of the counters: {"captures", "capture_s", "syncs",
    "syncs_by_site": {site: syncs}}."""
    return {**_counts, "syncs_by_site": dict(_syncs_by_site)}


def fetch(site: str, t: torch.Tensor, as_: type = float):
    """``t`` on the host, after the device has computed it: ``float(t)``,
    ``bool(t)``, or with ``as_=np.ndarray`` its values as a numpy array.
    Counted as one sync of ``site``; traced as the span
    ``lpmp.sync.<site>``."""
    _counts["syncs"] += 1
    _syncs_by_site[site] = _syncs_by_site.get(site, 0) + 1
    if not _enabled:
        return _to_host(t, as_)
    with torch.profiler.record_function("lpmp.sync." + site):
        return _to_host(t, as_)


def _to_host(t: torch.Tensor, as_: type):
    # the only lines of the port's main paths that wait for the device
    if as_ is np.ndarray:
        return t.cpu().numpy()
    return as_(t)
