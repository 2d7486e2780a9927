"""Seconds the program spent capturing its CUDA graphs (warm-up and
capture, ``lp_mp_tpu_torch.tracing`` counter ``capture_s``, summed by
``capture.Graphed``): set-up's share that only the program can shorten.
Read from the program's counter when the run is read, after the window:
the set-up's warm-up captures every call the window makes, so a window
captures nothing.  ``None`` where the program has no such counter."""


def read(rec: dict, cs: dict):
    try:
        from lp_mp_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.counters()["capture_s"]
