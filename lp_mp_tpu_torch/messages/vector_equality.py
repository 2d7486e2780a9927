"""Whole-vector equality message between two unary simplex factors
(counterpart of ``lp_mp_tpu/messages/vector_equality.py``).

Counterpart of the reference's ``test_message`` (test/test_model.hxx:90-137):
``RepamLeft/Right`` add a full cost vector and ``send_message_to_*`` pushes
the normalized cost ``c - min(c)``, i.e. the two factors must take the same
label, and a send shifts all relative cost onto the other side.  This is the
canonical coupling for tree decompositions over cloned factors
(tree_decomposition.hxx:277-585).  Each repam is an out-of-place
``index_add``; the pull hooks (``Engine(pull=True)``) hand the delta on as
it is.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MessageSchedule
from ..factors.simplex import UNARY_SIMPLEX
from ..registry import MessageType, add_rows, mask_pad
from .equality import condition_simplex


class VectorEqualityMessage(MessageType):
    """x_left == x_right over the full label vector (zero-sum vector shift)."""

    name = "vector_equality"
    left_type = UNARY_SIMPLEX
    right_type = UNARY_SIMPLEX
    schedule = MessageSchedule.left()

    def build(self, instances):
        return {"_": np.zeros(len(instances), dtype=np.int32)}

    def _marginal(self, costs):
        c = costs["c"]                                          # [M, L]
        return mask_pad(c - torch.amin(c, dim=1, keepdim=True))  # test_model.hxx:105-121

    def marginal_left(self, left_costs, data):
        return self._marginal(left_costs)

    def marginal_right(self, right_costs, data):
        return self._marginal(right_costs)

    # -- restricted (primal-conditioned) marginals ------------------------
    def _restricted(self, costs, primal):
        c = condition_simplex(costs["c"], costs.get("nl"), primal["x"])
        return mask_pad(c - torch.amin(c, dim=1, keepdim=True))

    def restricted_marginal_left(self, left_costs, left_primal, data):
        return self._restricted(left_costs, left_primal)

    def restricted_marginal_right(self, right_costs, right_primal, data):
        return self._restricted(right_costs, right_primal)

    def repam_left(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_left(delta, data, costs))

    def repam_right(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_right(delta, data, costs))

    def pull_left(self, delta, data, costs):
        return {"c": delta}

    def pull_right(self, delta, data, costs):
        return {"c": delta}

    # -- primal --------------------------------------------------------------
    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        return {**right_primal,
                "x": right_primal["x"].index_put((ridx,), torch.where(l >= 0, l, r))}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        return {**left_primal,
                "x": left_primal["x"].index_put((lidx,), torch.where(r >= 0, r, l))}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        return (l >= 0) & (l == r)

    # -- constraint export: the two label simplexes agree entry by entry ----
    def lp_coupling(self, lmeta, rmeta, data):
        assert lmeta[0] == rmeta[0]
        return [({lab: 1.0}, {lab: -1.0}, 0.0) for lab in range(lmeta[0])]


VECTOR_EQUALITY = VectorEqualityMessage()
