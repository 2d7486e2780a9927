"""Equality message between single entries of two unary simplex factors
(counterpart of ``lp_mp_tpu/messages/equality.py``).

Counterpart of the graph-matching ``equality_message`` (downstream
``solvers/graph_matching``, API documented by test/graph_matching.cpp):
for assignment a = (left node i -> right node j), the indicator
``x_left == li`` must equal ``x_right == ri`` where ``li`` is j's position
in i's label list and ``ri`` is i's position in j's label list.

The message variable space is the single binary indicator, so the
min-marginal is the scalar ``c[li] - min_{k != li} c[k]`` (min_except,
vector.hxx:315-323) and reparametrization touches one entry per side.
Every candidate of a left node is its own message, so one phase repeats a
row index; the (row, entry) pairs are distinct, and the scatter is an
out-of-place ``index_put(..., accumulate=True)``.  The pull hooks of the
pull pass (``Engine(pull=True)``) put the scalar on its entry of a
one-hot row.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MessageSchedule
from ..factors.simplex import UNARY_SIMPLEX
from ..ops.reductions import min_except_index
from ..registry import RESTRICT_BIG, MessageType


def condition_simplex(c: torch.Tensor, nl, x: torch.Tensor) -> torch.Tensor:
    """[M, L] simplex costs with RESTRICT_BIG off a fixed label's lane
    (valid lanes only, so padded lanes are never perturbed); x = -1 keeps
    the costs untouched (OneSideMessageContainerView conditioning,
    factors_messages.hxx:513-566)."""
    lanes = torch.arange(c.shape[1], device=c.device)[None, :]
    off = (x[:, None] >= 0) & (lanes != x[:, None])
    if nl is not None:
        off = off & (lanes < nl[:, None])
    return c + torch.where(off, c.new_full((), RESTRICT_BIG), c.new_zeros(()))


class EqualityMessage(MessageType):
    """x_left == data['li']  <=>  x_right == data['ri'] (zero-sum scalar shift)."""

    name = "equality"
    left_type = UNARY_SIMPLEX
    right_type = UNARY_SIMPLEX
    schedule = MessageSchedule.full()

    def build(self, instances):
        li = np.asarray([d[0] for d in instances], dtype=np.int64)
        ri = np.asarray([d[1] for d in instances], dtype=np.int64)
        return {"li": li, "ri": ri}

    def marginal_left(self, left_costs, data):
        return min_except_index(left_costs["c"], data["li"])

    def marginal_right(self, right_costs, data):
        return min_except_index(right_costs["c"], data["ri"])

    # -- restricted (primal-conditioned) marginals ------------------------
    def restricted_marginal_left(self, left_costs, left_primal, data):
        c = condition_simplex(left_costs["c"], left_costs.get("nl"), left_primal["x"])
        return min_except_index(c, data["li"])

    def restricted_marginal_right(self, right_costs, right_primal, data):
        c = condition_simplex(right_costs["c"], right_costs.get("nl"), right_primal["x"])
        return min_except_index(c, data["ri"])

    def repam_left(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_put((idx, data["li"]), delta, accumulate=True)}

    def repam_right(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_put((idx, data["ri"]), delta, accumulate=True)}

    @staticmethod
    def _one_hot(delta, entry, width):
        lanes = torch.arange(width, device=delta.device)[None, :]
        return torch.where(lanes == entry[:, None], delta[:, None], delta.new_zeros(()))

    def pull_left(self, delta, data, costs):
        return {"c": self._one_hot(delta, data["li"], costs["c"].shape[1])}

    def pull_right(self, delta, data, costs):
        return {"c": self._one_hot(delta, data["ri"], costs["c"].shape[1])}

    # -- primal --------------------------------------------------------------
    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        new = torch.where((l >= 0) & (l == data["li"]), data["ri"].to(r.dtype), r)
        return {**right_primal, "x": right_primal["x"].index_put((ridx,), new)}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        new = torch.where((r >= 0) & (r == data["ri"]), data["li"].to(l.dtype), l)
        return {**left_primal, "x": left_primal["x"].index_put((lidx,), new)}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx]
        return ((l >= 0) & (r >= 0)) & ((l == data["li"]) == (r == data["ri"]))

    # -- constraint export: left indicator == right indicator ----------------
    def lp_coupling(self, lmeta, rmeta, data):
        li, ri = int(data[0]), int(data[1])
        return [({li: 1.0}, {ri: -1.0}, 0.0)]


EQUALITY = EqualityMessage()
