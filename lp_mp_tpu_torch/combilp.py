"""combiLP: exact solve of the inconsistent region, grown until consistent
(counterpart of ``lp_mp_tpu/combilp.py``).

Reference scheme (combiLP.hxx:14-297): after message passing, factors whose
local bound certifies their rounded label are the LP region; the rest (the
inconsistent region) is handed to an exact solver with the border
reparametrized, and the region grows until the combined labeling is
consistent.

Here the region ILP is the integral local polytope of the masked factors
with border marginalization constraints *conditioned* on the LP-region
labeling (io/ilp.IncrementalIlp): conditioning plays the role of the
reference's border reparametrization and makes every merged labeling
consistent by construction.  The region grows when the conditioned ILP is
infeasible, or (optionally) while a duality gap to the message-passing
bound remains; when the region reaches the whole graph the solve is
globally exact.
"""
from __future__ import annotations

import numpy as np

from .config import Direction, eps_for
from .io.ilp import IncrementalIlp


def combi_lp(engine, prim=None, max_rounds: int = 10, grow_on_gap: bool = True,
             time_limit=None, log_fn=None):
    """Returns (prim, cost).  ``prim`` is a consistent primal dict; cost is
    its objective.  With grow_on_gap the loop keeps enlarging the exact
    region while cost > lower_bound + eps, reaching a globally exact solve
    in the limit (combiLP.hxx:92-271 iterate-until-consistent analogue)."""
    eps = eps_for(engine.dtype)
    if prim is None:
        prim = engine.compute_pass_and_primal("damped_uniform", Direction.forward)
    lb = engine.lower_bound()
    best_cost = engine.evaluate_primal(prim)
    best = prim

    mask = engine.get_inconsistent_mask(prim)
    n = len(mask)
    if not mask.any():
        if best_cost <= lb + eps:
            return best, best_cost
        mask = engine.per_factor_lower_bound() < engine.per_factor_primal_cost(prim) - eps
        if not mask.any():
            return best, best_cost

    # persistent MILP: region growth flips variable bounds and re-selects
    # rows instead of rebuilding the model (partial_external_solver
    # incremental-growth semantics)
    ilp = IncrementalIlp(engine)
    for round_ in range(max_rounds):
        sub_prim, cost = ilp.solve(subset=mask, fixed_prim=prim,
                                   time_limit=time_limit)
        if log_fn is not None:
            log_fn(f"combiLP round {round_}: region {int(mask.sum())}/{n}, "
                   f"cost {cost}, lb {lb}")
        if sub_prim is not None and cost < best_cost:
            best, best_cost = sub_prim, cost
        done_optimal = np.isfinite(best_cost) and best_cost <= lb + max(eps, 1e-6)
        feasible = sub_prim is not None
        if done_optimal:
            break
        if mask.all():
            break  # region == whole graph: ILP was globally exact
        if not feasible or grow_on_gap:
            mask = _fatten(engine, mask)
        else:
            break
    return best, best_cost


def _fatten(engine, mask: np.ndarray) -> np.ndarray:
    """Grow the region one message-adjacency hop (combiLP border growth)."""
    mask = mask.copy()
    for blk in engine.msgs.values():
        l, r = blk.lfid, blk.rfid
        hit = mask[l] | mask[r]
        mask[l[hit]] = True
        mask[r[hit]] = True
    return mask
