"""K2 ``grid_phase_kernel`` in the fused anisotropic schedule, where it runs
only the send-only prologue of each chunk, which reads no weights: the
least time for that phase's work (``benchmark/roofline.py``) over its mean
device time per launch in the trace, in percent.  The reader is K2's."""
from benchmark.metrics.k2_phase_roofline import read  # noqa: F401
