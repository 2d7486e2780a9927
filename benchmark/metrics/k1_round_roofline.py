"""K1 ``grid_round_kernel`` (dense, two anisotropic rounds a launch): the
least time for its work on the card (``benchmark/roofline.py``: the state
read and written once, the weights read once, at 3.35 TB/s) over its mean
device time per launch in the trace, in percent."""
import re

from benchmark import roofline

NAME = re.compile(r"grid_round_kernel<\s*\d+\s*,\s*false")


def read(rec: dict, cs: dict):
    tr = rec.get("trace")
    times = [t for name, v in (tr or {}).get("kernels", {}).items() if NAME.search(name)
             for t in v]
    if not times:
        return None
    c = cs["config"]
    bound = roofline.bound_s(roofline.launch_bytes(c["H"], c["W"], c["L"], 4, True),
                             roofline.launch_ops(c["H"], c["W"], c["L"], 2))
    return 100.0 * bound / (sum(times) / len(times))
