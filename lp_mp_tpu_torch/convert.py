"""Carry dual state from the JAX package into the port.

``grid_state_from_numpy`` takes the JAX ``GridPottsModel``'s dense state as
numpy arrays, ``{k: np.asarray(v) for k, v in jax_model.state.items()}``,
and returns the port's; ``GridPottsModel.load_state`` installs it.  The two
packages share the dense layout, so this is a copy, not a relayout.

``sharded_state_from_jax`` takes the JAX ``ShardedGridPotts``'s mask-form
state (numpy ``[L, R, C]`` arrays) and its ``geom``, and returns the same
dense dict; ``ShardedGridPotts.load_state`` splits it over the port's shards.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.grid_kernels import STATE_KEYS


def grid_state_from_numpy(np_state, device="cpu", dtype=torch.float64):
    """Dense grid state dict of numpy arrays -> dict of torch tensors.
    Always copies: JAX hands out read-only buffers."""
    missing = [k for k in STATE_KEYS if k not in np_state]
    if missing:
        raise KeyError(f"grid state lacks {missing}")
    return {k: torch.tensor(np.asarray(np_state[k]), dtype=dtype, device=device)
            for k in STATE_KEYS}


def sharded_state_from_jax(mask_state, geom, device="cpu", dtype=torch.float64):
    """Mask-form state of the JAX ``ShardedGridPotts`` (``{k: np.asarray(v)
    for k, v in jax_model.state.items()}``, geom ``(L, R, C, H, W, P)``) ->
    the port's dense state dict, through the layout of the JAX package's
    ``to_dense`` (real cells at rows [P, P+H), cols [1, 1+W))."""
    L, R, C, H, W, P = geom
    missing = [k for k in STATE_KEYS if k not in mask_state]
    if missing:
        raise KeyError(f"sharded grid state lacks {missing}")
    for k in STATE_KEYS:
        if np.shape(mask_state[k]) != (L, R, C):
            raise ValueError(f"{k} has shape {np.shape(mask_state[k])}, geom says {(L, R, C)}")
    m = {k: np.asarray(mask_state[k]) for k in STATE_KEYS}
    dense = {"u": m["u"][:, P:P + H, 1:1 + W],
             "hm1": m["hm1"][:, P:P + H, 1:W], "hm2": m["hm2"][:, P:P + H, 1:W],
             "vm1": m["vm1"][:, P:P + H - 1, 1:1 + W], "vm2": m["vm2"][:, P:P + H - 1, 1:1 + W]}
    return grid_state_from_numpy(dense, device=device, dtype=dtype)
