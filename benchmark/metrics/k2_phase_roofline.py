"""K2 ``grid_phase_kernel`` (dense, one colour phase a launch): the least
time for a phase's work (``benchmark/roofline.py``) over its mean device
time per launch in the trace, in percent.  In the fused anisotropic
schedule K2 runs only the send-only prologue, which reads no weights; in
the uniform schedules every phase receives and reads them."""
import re

from benchmark import roofline

NAME = re.compile(r"grid_phase_kernel<\s*false")


def read(rec: dict, cs: dict):
    tr = rec.get("trace")
    times = [t for name, v in (tr or {}).get("kernels", {}).items() if NAME.search(name)
             for t in v]
    if not times:
        return None
    c = cs["config"]
    receives = cs["traffic"]["mode"] != "anisotropic"
    bound = roofline.bound_s(roofline.launch_bytes(c["H"], c["W"], c["L"], 4, receives),
                             roofline.launch_ops(c["H"], c["W"], c["L"], 0.5))
    return 100.0 * bound / (sum(times) / len(times))
