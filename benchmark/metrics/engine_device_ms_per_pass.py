"""Device busy milliseconds per engine iteration (one forward and one
backward sweep, ``Engine.compute_pass`` or the two labelling sweeps of a
rounding iteration) over the traced window: the union of the device's busy
intervals over the iterations of the window's solves.  It holds the
bounds and the labelling sweeps that the solves run beside the passes."""


def read(rec: dict, cs: dict):
    tr = rec.get("trace")
    iters = sum(s.iterations for s in rec["solves"] if s.ok)
    if not tr or tr["busy_s"] <= 0 or not iters:
        return None
    return 1e3 * tr["busy_s"] / iters
