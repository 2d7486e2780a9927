"""Unary <-> pairwise marginalization messages (counterpart of
``lp_mp_tpu/messages/simplex_marginalization.py``).

Reference ``UnaryPairwiseMessage<Chirality::{left,right}>`` (downstream
``messages/simplex_marginalization_message.hxx``, behavior pinned by
test/simplex_marginalization.cpp:26-41):

- the message variable space is one side of the pairwise factor;
- the pairwise pushes its min-marginal over the other side
  (``send_message_to_left``), the unary pushes its full reparametrized cost
  vector (``send_message_to_right``);
- message schedule is ``left`` (all activity driven by the unary), so
  pairwise factors stay passive in the MRF sweep.

Each (chirality, pairwise-representation) pair is its own batched message
type.  The scatters are out-of-place ``index_add`` (duplicate indices
accumulate: a unary receives from several pairwise factors in one phase);
the primal writes are out-of-place ``index_put``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import MessageSchedule
from ..factors.potts import PAIRWISE_POTTS, PairwisePottsType
from ..factors.simplex import PAIRWISE_SIMPLEX, UNARY_SIMPLEX, _lane
from ..registry import RESTRICT_BIG, MessageType, mask_pad


def _valid_lanes(width: int, nl: torch.Tensor) -> torch.Tensor:
    """[M, width] bool mask of in-range label lanes given per-row counts."""
    return torch.arange(width, device=nl.device)[None, :] < nl[:, None]


def _penalty(off: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """RESTRICT_BIG where ``off``, else 0, in ``like``'s dtype."""
    return torch.where(off, like.new_full((), RESTRICT_BIG), like.new_zeros(()))


def fit_width(delta: torch.Tensor, width: int) -> torch.Tensor:
    """Slice or zero-pad axis 1 of [M, D] to D=width (padding carries no
    cost shift because invalid lanes are zeroed by mask_pad)."""
    d = delta.shape[1]
    if d == width:
        return delta
    if d > width:
        return delta[:, :width]
    return F.pad(delta, (0, width - d))


class _UnaryPairwiseBase(MessageType):
    left_type = UNARY_SIMPLEX
    schedule = MessageSchedule.left()
    side: int = 1

    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"])

    def restricted_marginal_left(self, left_costs, left_primal, data):
        """Unary marginal conditioned on its fixed label: labels other than
        the fixed one get RESTRICT_BIG (ReceiveRestrictedMessageFromLeft on a
        simplex factor)."""
        c = left_costs["c"]
        x = left_primal["x"]
        lanes = torch.arange(c.shape[1], device=c.device)[None, :]
        pen = _penalty(lanes != x[:, None], c)
        pen = torch.where(_valid_lanes(c.shape[1], left_costs["nl"]), pen, torch.zeros_like(pen))
        base = mask_pad(c)
        return torch.where((x >= 0)[:, None], base + pen, base)

    def repam_left(self, costs, idx, delta, data):
        c = costs["c"]
        return {**costs, "c": c.index_add(0, idx, fit_width(delta, c.shape[1]))}

    # -- primal ------------------------------------------------------------
    def _right_key(self):
        return "x1" if self.side == 1 else "x2"

    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        k = self._right_key()
        return {**right_primal,
                k: right_primal[k].index_put((ridx,), left_primal["x"][lidx])}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        v = right_primal[self._right_key()][ridx]
        cur = left_primal["x"][lidx]
        return {**left_primal,
                "x": left_primal["x"].index_put((lidx,), torch.where(v >= 0, v, cur))}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal[self._right_key()][ridx]
        return (l >= 0) & (l == r)

    # -- constraint export: unary marginal == pairwise row/col marginal ----
    def lp_coupling(self, lmeta, rmeta, data):
        L = lmeta[0]
        n1, n2 = rmeta
        rows = []
        for lab in range(L):
            if self.side == 1:
                rcoefs = {lab * n2 + l2: -1.0 for l2 in range(n2)}
            else:
                rcoefs = {l1 * n2 + lab: -1.0 for l1 in range(n1)}
            rows.append(({lab: 1.0}, rcoefs, 0.0))
        return rows


class UnaryPairwiseMessage(_UnaryPairwiseBase):
    """Unary <-> dense pairwise simplex, one type per side."""

    right_type = PAIRWISE_SIMPLEX

    def __init__(self, side: int):
        assert side in (1, 2)
        self.side = side
        self.name = f"unary_pairwise_{side}"

    def marginal_right(self, right_costs, data):
        other_axis = 2 if self.side == 1 else 1
        return mask_pad(torch.amin(right_costs["c"], dim=other_axis))

    def restricted_marginal_right(self, right_costs, right_primal, data):
        """Pairwise min-marginal conditioned on fixed endpoints: the minimum
        over the other axis is restricted to the fixed other-side label, and
        message-axis labels inconsistent with a fixed own-side label get
        RESTRICT_BIG."""
        c = right_costs["c"]
        x_own = right_primal["x1" if self.side == 1 else "x2"]
        x_oth = right_primal["x2" if self.side == 1 else "x1"]
        other_axis = 2 if self.side == 1 else 1
        oth_lanes = torch.arange(c.shape[other_axis], device=c.device)
        oth_lanes = oth_lanes[None, None, :] if self.side == 1 \
            else oth_lanes[None, :, None]
        x_oth_b = x_oth[:, None, None]
        pen = _penalty((x_oth_b >= 0) & (oth_lanes != x_oth_b), c)
        mm = mask_pad(torch.amin(c + pen, dim=other_axis))
        own_lanes = torch.arange(mm.shape[1], device=c.device)[None, :]
        own_pen = _penalty(own_lanes != x_own[:, None], mm)
        nl_own = right_costs["n1" if self.side == 1 else "n2"]
        own_pen = torch.where(_valid_lanes(mm.shape[1], nl_own), own_pen,
                              torch.zeros_like(own_pen))
        return torch.where((x_own >= 0)[:, None], mm + own_pen, mm)

    def repam_right(self, costs, idx, delta, data):
        c = costs["c"]
        if self.side == 1:
            d = fit_width(delta, c.shape[1])[:, :, None]
        else:
            d = fit_width(delta, c.shape[2])[:, None, :]
        d = d.expand(-1, c.shape[1], c.shape[2])
        return {**costs, "c": c.index_add(0, idx, d)}


class UnaryPottsMessage(_UnaryPairwiseBase):
    """Unary <-> compact Potts pairwise, one type per side.  O(L) updates
    via the two-min trick (test/potts_factor.cpp equivalence)."""

    right_type = PAIRWISE_POTTS

    def __init__(self, side: int):
        assert side in (1, 2)
        self.side = side
        self.name = f"unary_potts_{side}"

    def marginal_right(self, right_costs, data):
        return mask_pad(PairwisePottsType.marginal(right_costs, self.side))

    def restricted_marginal_right(self, right_costs, right_primal, data):
        """Compact-Potts conditioned marginal: with the other side fixed at
        b0, mm(a) = own(a) + other(b0) + diff*[a != b0]; a fixed own-side
        label adds RESTRICT_BIG off its lane."""
        own = right_costs["msg1" if self.side == 1 else "msg2"]
        other = right_costs["msg2" if self.side == 1 else "msg1"]
        diff = right_costs["diff"][:, None]
        x_own = right_primal["x1" if self.side == 1 else "x2"]
        x_oth = right_primal["x2" if self.side == 1 else "x1"]
        lanes = torch.arange(own.shape[1], device=own.device)[None, :]
        oth_val = torch.gather(other, 1, _lane(x_oth)[:, None])
        cond = own + oth_val + torch.where(lanes == x_oth[:, None], torch.zeros_like(diff), diff)
        base = torch.where((x_oth >= 0)[:, None], cond,
                           PairwisePottsType.marginal(right_costs, self.side))
        base = mask_pad(base)
        own_pen = _penalty(lanes != x_own[:, None], base)
        own_pen = torch.where(_valid_lanes(own.shape[1], right_costs["nl"]),
                              own_pen, torch.zeros_like(own_pen))
        return torch.where((x_own >= 0)[:, None], base + own_pen, base)

    def repam_right(self, costs, idx, delta, data):
        key = "msg1" if self.side == 1 else "msg2"
        slot = costs[key]
        return {**costs, key: slot.index_add(0, idx, fit_width(delta, slot.shape[1]))}


UNARY_PAIRWISE_1 = UnaryPairwiseMessage(1)
UNARY_PAIRWISE_2 = UnaryPairwiseMessage(2)
UNARY_POTTS_1 = UnaryPottsMessage(1)
UNARY_POTTS_2 = UnaryPottsMessage(2)
