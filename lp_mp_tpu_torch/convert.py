"""Carry dual state from the JAX package into the port.

``grid_state_from_numpy`` takes the JAX ``GridPottsModel``'s dense state as
numpy arrays, ``{k: np.asarray(v) for k, v in jax_model.state.items()}``,
and returns the port's; ``GridPottsModel.load_state`` installs it.  The two
packages share the dense layout, so this is a copy, not a relayout.

``sharded_state_from_jax`` takes the JAX ``ShardedGridPotts``'s mask-form
state (numpy ``[L, R, C]`` arrays) and its ``geom``, and returns the same
dense dict; ``ShardedGridPotts.load_state`` splits it over the port's shards.

``engine_state_from_numpy`` takes the JAX ``Engine``'s state as numpy
arrays, ``{type: {key: np.asarray(v)}}``, and returns the port's, for
``Engine.set_state``; ``engine_state_to_numpy`` goes the other way.  Both
engines build the same blocks in the same layout, so this too is a copy:
float lanes take ``dtype``, integer lanes (``nl``, ``n1``, ``n2``) stay
integer.
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


def block_from_numpy(block, device="cpu", dtype=torch.float64):
    """One block ``{key: numpy array}`` -> ``{key: tensor}`` on ``device``.
    Always copies, so writing into the result never reaches the numpy
    arrays (a graph's batch payloads): float lanes take ``dtype``, integer
    lanes keep their type."""
    out = {}
    for k, v in block.items():
        t = torch.from_numpy(np.array(v))
        out[k] = t.to(device=device, dtype=dtype if t.is_floating_point() else t.dtype)
    return out


def engine_state_from_numpy(np_state, device="cpu", dtype=torch.float64):
    """Engine state ``{type: {key: numpy array}}`` -> the port's ``{type:
    {key: tensor}}`` on ``device``.  Always copies."""
    return {name: block_from_numpy(block, device, dtype) for name, block in np_state.items()}


def engine_state_to_numpy(state):
    """The port's engine state (or a primal) -> ``{type: {key: numpy
    array}}`` on the host."""
    return {name: {k: v.detach().cpu().numpy() for k, v in block.items()}
            for name, block in state.items()}
