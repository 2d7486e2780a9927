"""Multicut edge <-> triplet and edge <-> wheel messages (counterpart of
``lp_mp_tpu/messages/multicut.py``).

Reference ``multicut_edge_triplet_message`` (downstream, exercised by
test/multicut.cpp): a 1-dimensional message per (edge factor, triangle
slot).  The marginal over the message variable is the *difference*
min(cost | edge cut) - min(cost | edge uncut); Repam adds the delta to the
edge cost (left) / to the triplet entries whose pattern cuts the edge
(right).  Schedule ``left``: the edge factor drives, triplets stay passive
(same decomposition role as the pairwise factor in the MRF model).

Static per-message data (wheel slots, pattern permutations) is built as
int64, the index type of ``torch.gather`` and of advanced indexing; the
JAX package builds it as int32.  Every scatter is out of place
(``index_add`` / ``index_put``, accumulating where indices may repeat).  The
pull hooks (``pull_left``/``pull_right``) give the same updates as dense
per-message rows for the pull pass (``Engine(pull=True)``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import MessageSchedule
from ..factors.multicut import (MULTICUT_EDGE, MULTICUT_ODD_WHEEL, MULTICUT_TRIPLET,
                                ODD_WHEEL_PATTERNS, TRIPLET_PATTERNS, device_table,
                                wheel_k_type)
from ..registry import RESTRICT_BIG, MessageType, add_rows, mask_pad


def _edge_restricted(base, x):
    """Edge-side restricted delta (OneSideMessageContainerView on a binary
    cut variable, factors_messages.hxx:513-566): a fixed x=0 makes the cut
    branch RESTRICT_BIG dearer, a fixed x=1 the uncut branch — the marginal
    is cut-minus-uncut so the penalty enters with sign."""
    pen = (x == 0).to(base.dtype) - (x == 1).to(base.dtype)
    return base + (RESTRICT_BIG * pen).reshape(pen.shape + (1,) * (base.ndim - 1))


def _pattern_penalty(e, patterns, like):
    """[M, P] RESTRICT_BIG per pattern bit inconsistent with a fixed primal
    bit; ``e`` [M, S] with -1 = unset, ``patterns`` [P, S] (numpy), in
    ``like``'s dtype."""
    pats = device_table(patterns, e, torch.int32)
    viol = (e[:, None, :] >= 0) & (e[:, None, :] != pats[None])
    return RESTRICT_BIG * torch.sum(viol, dim=2).to(like.dtype)


def _zero_penalty(e, like):
    """[M] penalty of the implicit all-uncut config under fixed bits."""
    return RESTRICT_BIG * torch.sum(e == 1, dim=1).to(like.dtype)


def _wheel_conditioned(costs, e, k):
    """Wheel-k cost block conditioned on fixed edge primals ``e`` [M, 2k]:
    each fixed slot shifts its cut-vs-uncut price by RESTRICT_BIG so every
    pattern violating a fixed bit loses any min by >= BIG; per-slot the
    shift is a constant over the factor's labelings on the uncut side, so
    relative costs (hence argmin and marginal differences) are exact."""
    dt = costs["sp"].dtype
    sgn = (e == 0).to(dt) - (e == 1).to(dt)
    return {**costs,
            "sp": costs["sp"] + RESTRICT_BIG * sgn[:, :k],
            "rim": costs["rim"] + RESTRICT_BIG * sgn[:, k:]}


def _set_where_set(dst, idx, v):
    """``dst`` with ``dst[idx] = v`` where ``v >= 0`` (out of place)."""
    return dst.index_put((idx,), torch.where(v >= 0, v, dst[idx]))


class _EdgePatternMessage(MessageType):
    """Edge <-> pattern-cost factor (triplet or K4 wheel), one type per edge
    slot of the right factor's pattern table."""

    left_type = MULTICUT_EDGE
    schedule = MessageSchedule.left()
    patterns: np.ndarray

    def __init__(self, slot: int):
        self.slot = slot
        self.cut_rows = np.nonzero(self.patterns[:, slot] == 1)[0]
        self.uncut_rows = np.nonzero(self.patterns[:, slot] == 0)[0]
        self._pat_col = np.ascontiguousarray(self.patterns[:, slot])
        self._cut_idx = self.cut_rows.astype(np.int64)
        self._uncut_idx = self.uncut_rows.astype(np.int64)

    def _keys(self):
        return [f"e{s + 1}" for s in range(self.patterns.shape[1])]

    def _cut_minus_uncut(self, c, zero):
        """[M, 1] min over cutting patterns - min(uncut patterns, ``zero``)."""
        cut = torch.amin(c[:, device_table(self._cut_idx, c)], dim=1)
        uncut = torch.minimum(torch.amin(c[:, device_table(self._uncut_idx, c)], dim=1), zero)
        return mask_pad((cut - uncut)[:, None])

    # -- marginals: [M, 1] = theta(cut) - theta(uncut) -----------------------
    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"][:, None])

    def marginal_right(self, right_costs, data):
        c = right_costs["c"]
        return self._cut_minus_uncut(c, torch.zeros((), dtype=c.dtype, device=c.device))

    # -- restricted (primal-conditioned) marginals ------------------------
    def restricted_marginal_left(self, left_costs, left_primal, data):
        return _edge_restricted(mask_pad(left_costs["c"][:, None]), left_primal["x"])

    def restricted_marginal_right(self, right_costs, right_primal, data):
        c = right_costs["c"]
        e = torch.stack([right_primal[k] for k in self._keys()], dim=1)
        cz = c + _pattern_penalty(e, self.patterns, c)
        return self._cut_minus_uncut(cz, _zero_penalty(e, c))

    def repam_left(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_left(delta, data, costs))

    def repam_right(self, costs, idx, delta, data):
        return add_rows(costs, idx, self.pull_right(delta, data, costs))

    def pull_left(self, delta, data, costs):
        return {"c": delta[:, 0]}

    def pull_right(self, delta, data, costs):
        c = costs["c"]
        return {"c": delta[:, 0:1] * device_table(self._pat_col, c, c.dtype)[None, :]}

    # -- primal ------------------------------------------------------------
    def _key(self):
        return f"e{self.slot + 1}"

    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        k = self._key()
        return {**right_primal, k: right_primal[k].index_put((ridx,), left_primal["x"][lidx])}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        v = right_primal[self._key()][ridx]
        return {**left_primal, "x": _set_where_set(left_primal["x"], lidx, v)}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        return (l >= 0) & (l == right_primal[self._key()][ridx])

    # -- constraint export: edge cut indicator == sum of the right factor's
    # configs cutting this slot (config 0 = all-uncut) ----------------------
    def lp_coupling(self, lmeta, rmeta, data):
        return [({1: 1.0}, {1 + int(k): -1.0 for k in self.cut_rows}, 0.0)]


class MulticutEdgeTripletMessage(_EdgePatternMessage):
    right_type = MULTICUT_TRIPLET
    patterns = TRIPLET_PATTERNS

    def __init__(self, slot: int):
        assert slot in (0, 1, 2)  # which triangle edge (e12, e13, e23)
        self.name = f"multicut_edge_triplet_{slot}"
        super().__init__(slot)


class MulticutEdgeWheelMessage(_EdgePatternMessage):
    """Edge <-> odd-3-wheel, one type per K4 edge slot
    (01, 02, 03, 12, 13, 23) — same decomposition role as the
    edge <-> triplet message, against the 14 wheel cut patterns."""

    right_type = MULTICUT_ODD_WHEEL
    patterns = ODD_WHEEL_PATTERNS

    def __init__(self, slot: int):
        assert 0 <= slot < 6
        self.name = f"multicut_edge_wheel_{slot}"
        super().__init__(slot)


class MulticutEdgeWheelKMessage(MessageType):
    """Edge <-> odd-k-wheel message.  Unlike the K4 slot-per-type scheme,
    one type covers all 2k edge slots of the wheel: the slot index is
    per-message *data*, marginals are computed for every slot at once
    (MulticutWheelKType.slot_marginals) and gathered."""

    left_type = MULTICUT_EDGE
    schedule = MessageSchedule.left()

    def __init__(self, k: int):
        self.k = k
        self.right_type = wheel_k_type(k)
        self.name = f"multicut_edge_wheel_k{k}"

    def build(self, instances):
        return {"slot": np.asarray(list(instances), dtype=np.int64)}

    def build_block(self, batch):
        return {"slot": np.asarray(batch, dtype=np.int64)}

    def item_data(self, block, i):
        return int(block["slot"][i])

    def _select(self, allm, data):
        return mask_pad(torch.gather(allm, 1, data["slot"][:, None]))

    # -- marginals -----------------------------------------------------------
    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"][:, None])

    def marginal_right(self, right_costs, data):
        return self._select(self.right_type.slot_marginals(right_costs), data)

    # -- restricted (primal-conditioned) marginals ------------------------
    def restricted_marginal_left(self, left_costs, left_primal, data):
        return _edge_restricted(mask_pad(left_costs["c"][:, None]), left_primal["x"])

    def restricted_marginal_right(self, right_costs, right_primal, data):
        # condition the per-slot cut costs on fixed wheel-edge primals:
        # +BIG on the cut branch where e=0, -BIG (i.e. +BIG on the uncut
        # branch, a per-factor constant shift that cannot change its argmin)
        # where e=1 — then reuse the factor's exact slot-marginal DP
        cond = _wheel_conditioned(right_costs, right_primal["e"], self.k)
        return self._select(self.right_type.slot_marginals(cond), data)

    def repam_left(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_add(0, idx, delta[:, 0])}

    def repam_right(self, costs, idx, delta, data):
        k = self.k
        s = data["slot"]
        d = delta[:, 0]
        zero = torch.zeros_like(d)
        sp = costs["sp"].index_put((idx, s.clamp(0, k - 1)), torch.where(s < k, d, zero),
                                   accumulate=True)
        rim = costs["rim"].index_put((idx, (s - k).clamp(0, k - 1)),
                                     torch.where(s >= k, d, zero), accumulate=True)
        return {**costs, "sp": sp, "rim": rim}

    def pull_left(self, delta, data, costs):
        return {"c": delta[:, 0]}

    def pull_right(self, delta, data, costs):
        k = self.k
        s = data["slot"][:, None]
        d = delta[:, 0:1]
        lanes = torch.arange(k, device=d.device)[None, :]
        zero = d.new_zeros(())
        return {"sp": torch.where((s < k) & (lanes == s), d, zero),
                "rim": torch.where((s >= k) & (lanes == s - k), d, zero)}

    # -- primal ----------------------------------------------------------
    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        e = right_primal["e"].index_put((ridx, data["slot"]), left_primal["x"][lidx])
        return {**right_primal, "e": e}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        v = right_primal["e"][ridx, data["slot"]]
        return {**left_primal, "x": _set_where_set(left_primal["x"], lidx, v)}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        return (l >= 0) & (l == right_primal["e"][ridx, data["slot"]])

    # -- constraint export: edge cut == sum of wheel configs cutting slot --
    def lp_coupling(self, lmeta, rmeta, data):
        cut = np.nonzero(rmeta[:, int(data)] == 1)[0]
        return [({1: 1.0}, {int(j): -1.0 for j in cut}, 0.0)]


class MulticutTripletWheelKMessage(MessageType):
    """Hub-triangle triplet <-> odd-k-wheel message over the triplet's
    4-pattern space (reference multicut_triplet_odd_3_wheel_message
    analogue): moves dual mass between the cycle-tightening triplets and
    the wheel — without it the wheel can only drain the (often fully
    reparametrized) edge factors and odd-wheel tightening stalls.

    Per-message data: ``slot`` = rim position i of the triangle
    (hub, v_i, v_{i+1}); ``pw`` [4] maps wheel-order pattern rows
    (spoke_i, spoke_j, rim_i) to triplet-order rows (the triplet's slots
    follow its sorted node key); ``pt`` [4] is the inverse; ``eperm`` [3]
    maps the triplet's edge positions to wheel slot ids (for primal)."""

    left_type = MULTICUT_TRIPLET
    schedule = MessageSchedule.left()

    def __init__(self, k: int):
        self.k = k
        self.right_type = wheel_k_type(k)
        self.name = f"multicut_triplet_wheel_k{k}"

    def build(self, instances):
        items = list(instances)
        return {key: np.asarray([it[key] for it in items], np.int64)
                for key in ("slot", "pw", "pt", "eperm")}

    def item_data(self, block, i):
        return {"slot": int(block["slot"][i]),
                "pw": np.asarray(block["pw"][i]),
                "pt": np.asarray(block["pt"][i]),
                "eperm": np.asarray(block["eperm"][i])}

    def _select(self, allm, data):
        """[M, k, 4] -> this message's triangle, in triplet pattern order."""
        idx = data["slot"][:, None, None].expand(-1, 1, allm.shape[2])
        mw = torch.gather(allm, 1, idx)[:, 0, :]                          # wheel order
        return mask_pad(torch.gather(mw, 1, data["pt"]))                  # triplet order

    # -- marginals: [M, 4] over the triplet's pattern order ----------------
    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"])

    def marginal_right(self, right_costs, data):
        return self._select(self.right_type.tri_marginals(right_costs), data)

    # -- restricted (primal-conditioned) marginals ------------------------
    def restricted_marginal_left(self, left_costs, left_primal, data):
        c = left_costs["c"]
        e = torch.stack([left_primal[f"e{s}"] for s in (1, 2, 3)], dim=1)
        pen = _pattern_penalty(e, TRIPLET_PATTERNS, c)
        return mask_pad(c) + pen - _zero_penalty(e, c)[:, None]

    def restricted_marginal_right(self, right_costs, right_primal, data):
        cond = _wheel_conditioned(right_costs, right_primal["e"], self.k)
        return self._select(self.right_type.tri_marginals(cond), data)

    def repam_left(self, costs, idx, delta, data):
        return {**costs, "c": costs["c"].index_add(0, idx, delta)}

    def repam_right(self, costs, idx, delta, data):
        dw = torch.gather(delta, 1, data["pw"])                           # wheel order
        tri = costs["tri"].index_put((idx, data["slot"]), dw, accumulate=True)
        return {**costs, "tri": tri}

    def pull_left(self, delta, data, costs):
        return {"c": delta}

    def pull_right(self, delta, data, costs):
        dw = torch.gather(delta, 1, data["pw"])                           # wheel order
        karr = torch.arange(self.k, device=dw.device)[None, :, None]
        return {"tri": torch.where(karr == data["slot"][:, None, None], dw[:, None, :],
                                   dw.new_zeros(()))}

    # -- primal --------------------------------------------------------------
    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        vals = torch.stack([left_primal[f"e{t}"][lidx] for t in (1, 2, 3)], dim=1)
        e = right_primal["e"].index_put((ridx[:, None].expand_as(data["eperm"]), data["eperm"]),
                                        vals)
        return {**right_primal, "e": e}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        out = dict(left_primal)
        for t in (1, 2, 3):
            v = right_primal["e"][ridx, data["eperm"][:, t - 1]]
            out[f"e{t}"] = _set_where_set(out[f"e{t}"], lidx, v)
        return out

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        ok = torch.ones(lidx.shape[0], dtype=torch.bool, device=lidx.device)
        for t in (1, 2, 3):
            l = left_primal[f"e{t}"][lidx]
            r = right_primal["e"][ridx, data["eperm"][:, t - 1]]
            ok &= (l >= 0) & (l == r)
        return ok

    # -- constraint export: triplet config == sum of wheel configs whose
    # bits on the triangle's 3 wheel slots realize the same pattern ---------
    def lp_coupling(self, lmeta, rmeta, data):
        eperm = np.asarray(data["eperm"])
        rows = []
        bits_all = rmeta[:, eperm]                              # [C, 3]
        # triplet var 0 = all-uncut; vars 1..4 = TRIPLET_PATTERNS rows
        for r in range(-1, 4):
            bits = np.zeros(3, np.int64) if r < 0 else TRIPLET_PATTERNS[r]
            hit = np.nonzero((bits_all == bits).all(axis=1))[0]
            rows.append(({r + 1: 1.0}, {int(j): -1.0 for j in hit}, 0.0))
        return rows


MULTICUT_EDGE_TRIPLET_0 = MulticutEdgeTripletMessage(0)
MULTICUT_EDGE_TRIPLET_1 = MulticutEdgeTripletMessage(1)
MULTICUT_EDGE_TRIPLET_2 = MulticutEdgeTripletMessage(2)
MULTICUT_EDGE_WHEEL = tuple(MulticutEdgeWheelMessage(s) for s in range(6))

_WHEEL_K_MSG_CACHE: dict[int, MulticutEdgeWheelKMessage] = {}
_TRI_WHEEL_K_MSG_CACHE: dict[int, MulticutTripletWheelKMessage] = {}


def wheel_k_message(k: int) -> MulticutEdgeWheelKMessage:
    """Singleton edge <-> odd-k-wheel message type per rim length."""
    if k not in _WHEEL_K_MSG_CACHE:
        _WHEEL_K_MSG_CACHE[k] = MulticutEdgeWheelKMessage(k)
    return _WHEEL_K_MSG_CACHE[k]


def triplet_wheel_k_message(k: int) -> MulticutTripletWheelKMessage:
    """Singleton triplet <-> odd-k-wheel message type per rim length."""
    if k not in _TRI_WHEEL_K_MSG_CACHE:
        _TRI_WHEEL_K_MSG_CACHE[k] = MulticutTripletWheelKMessage(k)
    return _TRI_WHEEL_K_MSG_CACHE[k]
