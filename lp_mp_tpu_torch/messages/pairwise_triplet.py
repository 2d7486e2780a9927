"""Pairwise <-> triplet marginalization messages (tightening; counterpart of
``lp_mp_tpu/messages/pairwise_triplet.py``).

Reference ``PairwiseTripletMessage{12,13,23}`` (downstream
``messages/simplex_marginalization_message.hxx``, exercised by
test/graphical_model.cpp:140-204): the message variable space is a pair of
the triplet's three variables; the pairwise factor (left) is the active
side (schedule ``left``), pushing its full matrix and pulling the
triplet's min-marginal over the remaining variable.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import MessageSchedule
from ..factors.simplex import PAIRWISE_SIMPLEX, TERNARY_SIMPLEX
from ..registry import RESTRICT_BIG, MessageType, add_rows, mask_pad


def _axis_penalty(like, axis, x):
    """RESTRICT_BIG off lane ``x`` along ``axis`` of ``like`` [M, ...], in its
    dtype; x = -1 contributes nothing."""
    nd = like.ndim
    L = like.shape[axis]
    lanes = torch.arange(L, device=like.device).reshape(
        (1,) + tuple(L if a == axis else 1 for a in range(1, nd)))
    xb = x.reshape((-1,) + (1,) * (nd - 1))
    return torch.where((xb >= 0) & (lanes != xb), like.new_full((), RESTRICT_BIG),
                       like.new_zeros(()))


def _fit2(delta: torch.Tensor, d1: int, d2: int) -> torch.Tensor:
    """Slice/zero-pad [M, A, B] to [M, d1, d2]."""
    a, b = delta.shape[1], delta.shape[2]
    delta = delta[:, :min(a, d1), :min(b, d2)]
    pad1, pad2 = d1 - delta.shape[1], d2 - delta.shape[2]
    if pad1 or pad2:
        delta = F.pad(delta, (0, pad2, 0, pad1))
    return delta


class PairwiseTripletMessage(MessageType):
    """Left = dense pairwise over (x_a, x_b); right = ternary simplex;
    ``pair`` selects which two triplet variables the pairwise spans."""

    left_type = PAIRWISE_SIMPLEX
    right_type = TERNARY_SIMPLEX
    schedule = MessageSchedule.left()

    def __init__(self, pair: tuple[int, int]):
        assert pair in ((1, 2), (1, 3), (2, 3))
        self.pair = pair
        # axis of the triplet tensor [F, L1, L2, L3] that is marginalized out
        self.out_axis = ({1, 2, 3} - set(pair)).pop()
        self.name = f"pairwise_triplet_{pair[0]}{pair[1]}"

    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"])

    def marginal_right(self, right_costs, data):
        return mask_pad(torch.amin(right_costs["c"], dim=self.out_axis))

    # -- restricted (primal-conditioned) marginals ------------------------
    def restricted_marginal_left(self, left_costs, left_primal, data):
        c = left_costs["c"]
        pen = (_axis_penalty(c, 1, left_primal["x1"])
               + _axis_penalty(c, 2, left_primal["x2"]))
        return mask_pad(c) + pen

    def restricted_marginal_right(self, right_costs, right_primal, data):
        c = right_costs["c"]
        pen = sum(_axis_penalty(c, a, right_primal[f"x{a}"]) for a in (1, 2, 3))
        return mask_pad(torch.amin(c + pen, dim=self.out_axis))

    def repam_left(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_left(delta, data, costs))

    def repam_right(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_right(delta, data, costs))

    def pull_left(self, delta, data, costs):
        c = costs["c"]
        return {"c": _fit2(delta, c.shape[1], c.shape[2])}

    def pull_right(self, delta, data, costs):
        c = costs["c"]
        dims = [c.shape[a] for a in self.pair]
        d = _fit2(delta, dims[0], dims[1]).unsqueeze(self.out_axis)
        return {"c": d.expand((-1,) + tuple(c.shape[1:]))}

    # -- primal ------------------------------------------------------------
    def _keys(self):
        return f"x{self.pair[0]}", f"x{self.pair[1]}"

    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        k1, k2 = self._keys()
        out = dict(right_primal)
        out[k1] = out[k1].index_put((ridx,), left_primal["x1"][lidx])
        out[k2] = out[k2].index_put((ridx,), left_primal["x2"][lidx])
        return out

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        k1, k2 = self._keys()
        out = dict(left_primal)
        v1 = right_primal[k1][ridx]
        v2 = right_primal[k2][ridx]
        out["x1"] = out["x1"].index_put((lidx,), torch.where(v1 >= 0, v1, out["x1"][lidx]))
        out["x2"] = out["x2"].index_put((lidx,), torch.where(v2 >= 0, v2, out["x2"][lidx]))
        return out

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        k1, k2 = self._keys()
        l1 = left_primal["x1"][lidx]
        l2 = left_primal["x2"][lidx]
        return (l1 >= 0) & (l2 >= 0) & \
            (l1 == right_primal[k1][ridx]) & (l2 == right_primal[k2][ridx])

    # -- constraint export: pairwise config == triplet marginal ------------
    def lp_coupling(self, lmeta, rmeta, data):
        n1, n2 = lmeta
        t1, t2, t3 = rmeta
        rows = []
        for a in range(n1):
            for b in range(n2):
                if self.pair == (1, 2):
                    idxs = [(a, b, k) for k in range(t3)]
                elif self.pair == (1, 3):
                    idxs = [(a, k, b) for k in range(t2)]
                else:
                    idxs = [(k, a, b) for k in range(t1)]
                rcoefs = {(x * t2 + y) * t3 + z: -1.0 for (x, y, z) in idxs}
                rows.append(({a * n2 + b: 1.0}, rcoefs, 0.0))
        return rows


PAIRWISE_TRIPLET_12 = PairwiseTripletMessage((1, 2))
PAIRWISE_TRIPLET_13 = PairwiseTripletMessage((1, 3))
PAIRWISE_TRIPLET_23 = PairwiseTripletMessage((2, 3))
