"""Multi-device solvers of the port (counterpart of ``lp_mp_tpu/parallel``)."""
from .grid import RowShards, ShardedGridPotts, mode_phases

__all__ = ["RowShards", "ShardedGridPotts", "mode_phases"]
