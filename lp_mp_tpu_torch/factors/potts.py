"""Compact Potts pairwise factor (counterpart of ``lp_mp_tpu/factors/potts.py``).

Reference ``pairwise_potts_factor`` (pinned by test/potts_factor.cpp):
the L x L Potts matrix ``diff * [x1 != x2]`` plus two reparametrization
slots msg1[L], msg2[L], i.e.

    cost(x1, x2) = msg1[x1] + msg2[x2] + diff * [x1 != x2]

stored in O(L) per factor instead of O(L^2).  Min computations use the
two-min trick (vector.hxx:348-449) of ``ops/reductions.py``, which keeps
the JAX package's tie rule, making message updates O(L).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.reductions import min_except, two_min
from ..registry import FactorType
from .simplex import (BUILD_DTYPE, _inf_unless, _lane, _pack_padded, _pair_fix, _pair_read,
                      _unset)


class PairwisePottsType(FactorType):
    """All Potts pairwise factors as msg1/msg2 [F, L] + diff [F]."""

    name = "pairwise_potts"

    def build(self, instances):
        """instances: iterable of (n_labels, diff_cost)."""
        msgs = [np.zeros(int(n), dtype=BUILD_DTYPE) for n, _ in instances]
        m1 = _pack_padded(msgs, BUILD_DTYPE)
        m2 = m1.copy()
        diff = np.asarray([d for _, d in instances], dtype=BUILD_DTYPE)
        nl = np.asarray([int(n) for n, _ in instances], dtype=np.int32)
        return {"msg1": m1, "msg2": m2, "diff": diff, "nl": nl}

    def build_block(self, batch):
        """batch = (n_labels, diff[N]) — uniform label count."""
        L, diffs = batch
        diff = np.asarray(diffs, dtype=BUILD_DTYPE)
        N = diff.shape[0]
        m = np.zeros((N, int(L)), dtype=BUILD_DTYPE)
        nl = np.full(N, int(L), dtype=np.int32)
        return {"msg1": m, "msg2": m.copy(), "diff": diff, "nl": nl}

    def item_data(self, block, i):
        return (int(block["nl"][i]), float(block["diff"][i]))

    @staticmethod
    def min_pair(m1, m2, diff):
        """min over (x1, x2) of m1[x1] + m2[x2] + diff*[x1 != x2], batched."""
        diag = torch.amin(m1 + m2, dim=1)
        # with a single valid label there is no off-diagonal pair
        if m1.shape[1] == 1:
            return diag
        a1, s1, i1 = two_min(m1, axis=1)
        a2, s2, i2 = two_min(m2, axis=1)
        off = torch.where(i1 != i2, a1 + a2, torch.minimum(a1 + s2, s1 + a2)) + diff
        return torch.minimum(diag, off)

    def lower_bound(self, costs):
        return self.min_pair(costs["msg1"], costs["msg2"], costs["diff"])

    @staticmethod
    def marginal(costs, side: int):
        """[F, L] min-marginal onto side 1 or 2:
        marg_1[x1] = msg1[x1] + min(msg2[x1], min_{x2 != x1} msg2[x2] + diff).
        """
        own = costs["msg1"] if side == 1 else costs["msg2"]
        other = costs["msg2"] if side == 1 else costs["msg1"]
        diff = costs["diff"][:, None]
        if other.shape[1] == 1:
            return own + other
        return own + torch.minimum(other, min_except(other, axis=1) + diff)

    def init_primal(self, costs):
        n, dev = costs["msg1"].shape[0], costs["msg1"].device
        return {"x1": _unset(n, dev), "x2": _unset(n, dev)}

    def compute_primal(self, costs, primal):
        # passive in the MRF decomposition; endpoints arrive via propagation.
        return primal

    def evaluate_primal(self, costs, primal):
        m1, m2, diff = costs["msg1"], costs["msg2"], costs["diff"]
        x1, x2 = primal["x1"], primal["x2"]
        f = torch.arange(m1.shape[0], device=m1.device)
        val = m1[f, _lane(x1)] + m2[f, _lane(x2)] + \
            torch.where(x1 != x2, diff, torch.zeros_like(diff))
        return _inf_unless((x1 >= 0) & (x2 >= 0), val)

    def dual_vector(self, costs):
        return torch.cat([costs["msg1"], costs["msg2"]], dim=1)

    # -- constraint export: densified (the O(L) factor exports its O(L^2)
    # configuration polytope, pairwise_potts == PairwiseSimplex semantics)
    def lp_vars(self, state_row, data):
        nl = int(state_row["nl"])
        m1 = np.asarray(state_row["msg1"][:nl], dtype=np.float64)
        m2 = np.asarray(state_row["msg2"][:nl], dtype=np.float64)
        diff = float(state_row["diff"])
        c = m1[:, None] + m2[None, :] + diff * (1.0 - np.eye(nl))
        return (c.ravel(), [{k: 1.0 for k in range(nl * nl)}], [1.0],
                (nl, nl))

    def lp_fix(self, prim_row, meta):
        return _pair_fix(prim_row, meta)

    def lp_read(self, values, meta):
        return _pair_read(values, meta)


PAIRWISE_POTTS = PairwisePottsType()
