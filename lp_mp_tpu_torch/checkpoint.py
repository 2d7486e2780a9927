"""Checkpoint / resume (counterpart of ``lp_mp_tpu/checkpoint.py``).

The reference keeps only in-memory snapshots (factor_archive.hxx,
serialization.hxx) and the best primal as a string (solver.hxx:145-158);
here dual state is a dict of dense blocks, so real disk checkpointing is
one ``np.savez``.  ``snapshot``/``restore`` cover the in-memory uses
(combiLP-style save/rollback, restricted-rounding state saves,
factors_messages.hxx:2343-2356).

The file is the JAX package's: one npz with keys ``state/<type>/<key>``,
``primal/<type>/<key>`` and ``meta/{constant,best_primal_cost,iteration}``,
the counting chain's ``nv`` and ``nl`` stored as int32 as the JAX package
builds them.  A checkpoint written by either package loads into the other;
loading casts the state to the engine's device and dtype and the primal to
the dtypes of the engine's own primal blocks.

A snapshot clones every tensor: the engine's passes write into its state
tensors in place, so a snapshot that shared them would move with the
engine.
"""
from __future__ import annotations

import numpy as np

from .convert import (INT64_LANES, engine_primal_from_numpy, engine_state_from_numpy,
                      engine_state_to_numpy)


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: dict) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def snapshot(engine) -> dict:
    """In-memory dual-state snapshot (factor_archive save_factor analogue):
    a clone of every state tensor, on the engine's device."""
    return engine.get_state()


def restore(engine, snap: dict) -> None:
    """Put a snapshot back; the snapshot stays usable for another restore."""
    engine.set_state({name: {k: v.clone() for k, v in block.items()}
                      for name, block in snap.items()})


def save_checkpoint(path: str, engine, best_primal=None,
                    best_primal_cost: float = float("inf"),
                    iteration: int = 0) -> None:
    state = engine_state_to_numpy(engine.state)
    for name, keys in INT64_LANES.items():
        for k in keys:
            if k in state.get(name, {}):
                state[name][k] = state[name][k].astype(np.int32)
    flat = _flatten({"state": state})
    if best_primal is not None:
        flat.update(_flatten({"primal": engine_state_to_numpy(best_primal)}))
    flat["meta/constant"] = np.asarray(engine.constant)
    flat["meta/best_primal_cost"] = np.asarray(best_primal_cost)
    flat["meta/iteration"] = np.asarray(iteration)
    np.savez(path, **flat)


def load_checkpoint(path: str, engine):
    """Restores engine.state in place; returns (best_primal or None,
    best_primal_cost, iteration)."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    engine.set_state(engine_state_from_numpy(tree["state"], engine.device, engine.dtype))
    prim = tree.get("primal")
    if prim is not None:
        prim = engine_primal_from_numpy(prim, engine.init_primal())
    meta = tree["meta"]
    return prim, float(meta["best_primal_cost"]), int(meta["iteration"])
