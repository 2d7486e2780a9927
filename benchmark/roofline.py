"""The yardstick of the kernels: published peaks and the work of a launch.

The work is counted from the problem, never from the program's tensors:
each input byte read once and each output byte written once, as a function
of H, W, L and the size of the state's element.  A later change of the
program's layout therefore cannot move it.  The arithmetic is that of
``lp_mp_tpu_torch/phase_bench.py`` (``phase_bytes``, ``launch_bound``,
``OPS_PER_LABEL_UPDATE``), frozen here.

At 1000x1000, L=4, float32: a round launch (K1) and a phase in which a
colour receives (K2) move 167.864 MB, 50.1 us at 3.35 TB/s; a send-only
phase reads no cost, 159.872 MB, 47.7 us.  Their float32 operations take
4.2 and 2.1 us at 67 TFLOP/s, so bytes bound both.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations per label of one cell update: per incident edge one min
# and one max for the min statistics, a compare, select, add and min for
# the marginal, the add into the cell and two for its slot; three for the cell
OPS_PER_LABEL_UPDATE = 4 * 8 + 3


def state_elements(H: int, W: int, L: int) -> int:
    """Elements of the dual state: the cells' costs and four Potts slots."""
    return L * (H * W + 2 * H * (W - 1) + 2 * (H - 1) * W)


def cost_elements(H: int, W: int) -> int:
    """Elements of the Potts weights (horizontal and vertical)."""
    return H * (W - 1) + (H - 1) * W


def launch_bytes(H: int, W: int, L: int, itemsize: int, reads_costs: bool) -> int:
    """Bytes a state-to-state launch must move: the state read and written
    once, and the weights read once where some colour receives."""
    b = 2 * state_elements(H, W, L) * itemsize
    if reads_costs:
        b += cost_elements(H, W) * itemsize
    return b


def launch_ops(H: int, W: int, L: int, cell_updates_per_cell: float) -> float:
    """float32 operations of a launch that updates every cell
    ``cell_updates_per_cell`` times (K1 with two rounds: 2; a phase: 1/2)."""
    return H * W * cell_updates_per_cell * L * OPS_PER_LABEL_UPDATE


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least time for that work on the card: bytes at the memory's peak
    or operations at the float32 peak, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)
