"""Potts grid instances, frozen copy of the measured package's generator.

``random_grid`` is ``lp_mp_tpu_torch/models/grid_potts.py:random_grid``
(itself the JAX package's ``lp_mp_tpu/models/grid_potts.py`` generator,
value for value), copied here so that no later change of the program moves
the instances: float64 normal unaries and Potts weights |N(0, 1)|.
"""
from __future__ import annotations

import numpy as np


def random_grid(H: int, W: int, L: int, seed: int = 0, potts_scale: float = 1.0):
    """(unary [H, W, L], hc [H, W-1], vc [H-1, W]), numpy float64."""
    rng = np.random.default_rng(seed)
    unary = rng.normal(size=(H, W, L))
    hc = np.abs(rng.normal(size=(H, W - 1))) * potts_scale
    vc = np.abs(rng.normal(size=(H - 1, W))) * potts_scale
    return unary, hc, vc


def make(config: dict, seed: int) -> dict:
    """One instance of a ``potts_grid`` configuration from ``seed``."""
    unary, hc, vc = random_grid(config["H"], config["W"], config["L"], seed=seed,
                                potts_scale=config.get("potts_scale", 1.0))
    return {"unary": unary, "hc": hc, "vc": vc}


def grid_edges(hc, vc):
    """The grid's Potts pairs in per-cell order (the horizontal pair of a
    cell, then its vertical one; variable r*W + c) with their weights: a
    frozen copy of ``lp_mp_tpu_torch/models/grid_potts.py:grid_potts_edges``."""
    hc, vc = np.asarray(hc), np.asarray(vc)
    H, W = hc.shape[0], vc.shape[1]
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.zeros((H, W, 2, 2), dtype=np.int64)
    diffs = np.zeros((H, W, 2))
    valid = np.zeros((H, W, 2), dtype=bool)
    pairs[:, :-1, 0] = np.stack([idx[:, :-1], idx[:, 1:]], axis=-1)
    diffs[:, :-1, 0], valid[:, :-1, 0] = hc, True
    pairs[:-1, :, 1] = np.stack([idx[:-1], idx[1:]], axis=-1)
    diffs[:-1, :, 1], valid[:-1, :, 1] = vc, True
    return pairs[valid], diffs[valid]


# ----------------------------------------------------------------------
# posing an instance to the generic engine (drivers/solver.py)
# ----------------------------------------------------------------------
def pose(solver, instance: dict, config: dict):
    """The grid as unary and Potts factors of an ``MrfConstructor``, the
    pairs in per-cell order (``grid_edges``)."""
    from lp_mp_tpu_torch import MrfConstructor
    H, W, L = config["H"], config["W"], config["L"]
    mrf = solver.add_constructor(MrfConstructor)
    mrf.add_unary_factors(instance["unary"].reshape(H * W, L))
    pairs, diffs = grid_edges(instance["hc"], instance["vc"])
    mrf.add_potts_factors(pairs, L, diffs)
    return mrf


def prepare(solver, mrf, config: dict):
    """Nothing to do before the solves."""
    return None


def labels(mrf, engine, prim) -> np.ndarray:
    """The labelling [H*W] of a primal of the engine, as uint8."""
    from lp_mp_tpu_torch.models.mrf import mrf_labeling
    return mrf_labeling(mrf, engine, prim).astype(np.uint8)
