"""Carry dual state from the JAX package into the port.

``grid_state_from_numpy`` takes the JAX ``GridPottsModel``'s dense state as
numpy arrays, ``{k: np.asarray(v) for k, v in jax_model.state.items()}``,
and returns the port's; ``GridPottsModel.load_state`` installs it.  The two
packages share the dense layout, so this is a copy, not a relayout.

``sharded_state_from_jax`` takes the JAX ``ShardedGridPotts``'s mask-form
state (numpy ``[L, R, C]`` arrays) and its ``geom``, and returns the same
dense dict; ``ShardedGridPotts.load_state`` splits it over the port's shards.

``host_array`` is the one device-to-host copy the host-side separation
code makes per block: the tightening searches read ``engine.state`` through
it, never row by row.

``engine_state_from_numpy`` takes the JAX ``Engine``'s state as numpy
arrays, ``{type: {key: np.asarray(v)}}``, and returns the port's, for
``Engine.set_state``; ``engine_state_to_numpy`` goes the other way, for a
state or a primal, and ``engine_primal_from_numpy`` brings a host primal
back in the dtypes of the engine's own primal blocks.  Both
engines build the same blocks in the same layout, so this too is a copy:
float lanes take ``dtype`` (the counting chain's +inf lanes stay +inf),
integer lanes (``nl``, ``n1``, ``n2``) stay integer, and the counting
chain's ``nv`` and ``nl``, int32 in the JAX package, become the port's
int64.

``aux_state_to_numpy`` reads the absorbed tightening triplets of either
package's ``AuxPasses`` (its MRF and multicut passes: ``c``, ``lidx``,
``active``, ``w_recv`` at capacity ``cap``, plus ``n``, ``fids`` and the
MRF pass's label capacity ``dims``) into numpy, staged rows written first;
``aux_state_from_numpy`` makes the port's ``AuxPasses`` from that, on
``device`` in ``dtype``.  Both packages keep the same bucket layout, so
this too is a copy; row indices become int64 in the port.
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


# integer lanes the port builds as int64 where the JAX package builds int32
# (the counting chain's variable and label counts); every other integer lane
# keeps its type
INT64_LANES = {"counting_chain": ("nv", "nl")}


def engine_state_from_numpy(np_state, device="cpu", dtype=torch.float64):
    """Engine state ``{type: {key: numpy array}}`` -> the port's ``{type:
    {key: tensor}}`` on ``device``, with the lanes of ``INT64_LANES`` as
    int64.  Always copies."""
    out = {name: block_from_numpy(block, device, dtype) for name, block in np_state.items()}
    for name, keys in INT64_LANES.items():
        for k in keys:
            if k in out.get(name, {}):
                out[name][k] = out[name][k].long()
    return out


def host_array(t: torch.Tensor, dtype=None) -> np.ndarray:
    """A copy of a tensor as a numpy array on the host, made in one transfer
    (``dtype``: cast there, e.g. ``np.float64`` for the separation
    searches).  Always a copy, so the caller may write into it."""
    return np.array(t.detach().cpu().numpy(), dtype=dtype)


def _numpy(v) -> np.ndarray:
    """A JAX array or a torch tensor as a numpy copy."""
    return host_array(v) if isinstance(v, torch.Tensor) else np.array(v)


def aux_state_to_numpy(aux) -> dict:
    """The absorbed state of an ``AuxPasses`` (the JAX package's or the
    port's) as ``{"mrf": {...}, "mc": {...}}`` of numpy arrays and ints."""
    out = {}
    for part in ("mrf", "mc"):
        p = getattr(aux, part)
        p._sync()
        st = {"cap": int(p.cap), "n": int(p.n), "fids": [int(f) for f in p.fids],
              "dims": tuple(p._dims) if getattr(p, "_dims", None) else None}
        for k in ("c", "lidx", "active", "w_recv"):
            st[k] = None if getattr(p, k) is None else _numpy(getattr(p, k))
        out[part] = st
    return out


def aux_state_from_numpy(np_state, device="cpu", dtype=torch.float64):
    """The port's ``AuxPasses`` holding the state ``aux_state_to_numpy``
    read, on ``device`` in ``dtype``."""
    from .aux_tighten import AuxPasses
    aux = AuxPasses()
    device = torch.device(device)
    for part in ("mrf", "mc"):
        st, p = np_state[part], getattr(aux, part)
        if not st["n"]:
            continue
        p.cap, p.n, p.fids = st["cap"], st["n"], list(st["fids"])
        p._device, p._dtype = device, dtype
        if part == "mrf":
            p._dims = tuple(st["dims"])
        for k in ("c", "active", "w_recv"):
            setattr(p, k, torch.tensor(st[k], device=device, dtype=dtype))
        p.lidx = torch.tensor(st["lidx"], device=device, dtype=torch.int64)
        p._lidx_host = [tuple(r) for r in st["lidx"][:, :p.n].T.tolist()]
    return aux


def engine_state_to_numpy(state):
    """The port's engine state (or a primal) -> ``{type: {key: numpy
    array}}`` on the host, one transfer per tensor."""
    return {name: {k: v.detach().cpu().numpy() for k, v in block.items()}
            for name, block in state.items()}


def engine_primal_from_numpy(np_prim, like):
    """A primal ``{type: {key: numpy array}}`` (either package's labels,
    int32 or int64) as tensors with the dtype and device of the blocks of
    ``like``, the engine's own primal (``Engine.init_primal()``)."""
    return {name: {k: torch.as_tensor(np.asarray(v)).to(device=like[name][k].device,
                                                           dtype=like[name][k].dtype)
                   for k, v in block.items()}
            for name, block in np_prim.items()}
