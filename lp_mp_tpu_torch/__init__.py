"""lp_mp_tpu_torch: the PyTorch and CUDA port of lp_mp_tpu for NVIDIA Hopper.

It covers the flagship Potts grid: ``GridPottsModel`` with its SRMP
red/black sweeps, lower bound and primal rounding; its row-sharded
counterpart ``ShardedGridPotts`` over a list of devices; and the grid
kernels (``ops/grid_kernels``) written by hand in CUDA for sm_90a.  The
package imports torch and numpy, never JAX and never ``lp_mp_tpu``.
"""
from .config import ReparametrizationMode, eps_for, real_dtype, set_dtype
from .convert import grid_state_from_numpy, sharded_state_from_jax
from .models.grid_potts import GridPottsModel, random_grid
from .parallel.grid import ShardedGridPotts

__all__ = [
    "ReparametrizationMode", "eps_for", "real_dtype", "set_dtype",
    "grid_state_from_numpy", "sharded_state_from_jax", "GridPottsModel", "random_grid",
    "ShardedGridPotts",
]

__version__ = "0.1.0"
