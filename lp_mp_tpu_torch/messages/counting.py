"""Unary <-> counting-chain messages (counterpart of
``lp_mp_tpu/messages/counting.py``).

Reference: ``DiscreteTomographyMessageCounting`` (downstream, surface
documented by test/discrete_tomography.cpp) — messages between the MRF
unaries on a projection ray and the counting subproblem; every marginal is
a min-convolution DP.

The message variable space is the unary's label vector; position ``pos``
says which chain variable the unary pins.  The chain-side min-marginal at
``pos`` combines a forward DP over earlier variables, a backward DP (with
the projection cost folded in) over later ones, and the local slot:

    marg[l] = lam[pos, l] + min_s fwd[pos][s] + bwd[pos+1][s + l]

The chain keeps real +inf in ``lam`` and ``proj``; every chain-side
marginal passes ``mask_pad`` (which zeroes |delta| >= PAD_COST/2, +inf
included) before the engine weights it, so no inf * 0 or inf - inf reaches
a state.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn.functional import pad

from ..config import MessageSchedule
from ..factors.counting import COUNTING_CHAIN, _dp_start, min_corr
from ..factors.simplex import UNARY_SIMPLEX
from ..ops.minconv import INF, min_conv
from ..registry import MessageType, mask_pad
from .equality import condition_simplex
from .simplex_marginalization import fit_width


class UnaryCountingMessage(MessageType):
    name = "unary_counting"
    left_type = UNARY_SIMPLEX
    right_type = COUNTING_CHAIN
    schedule = MessageSchedule.left()
    # each message writes lam[ridx, pos] at its own pos — updates through
    # a shared chain are disjoint, so ray variables need not serialize
    # (registry.MessageType.slot_disjoint; keeps phase counts bounded; the
    # engine scales k simultaneous receives from one chain by 1/k)
    slot_disjoint = True

    def build(self, instances):
        return {"pos": np.asarray(instances, dtype=np.int64)}

    # -- marginals -------------------------------------------------------------
    def marginal_left(self, left_costs, data):
        return mask_pad(left_costs["c"])

    def restricted_marginal_left(self, left_costs, left_primal, data):
        return mask_pad(condition_simplex(left_costs["c"], left_costs.get("nl"),
                                          left_primal["x"]))

    def restricted_marginal_right(self, right_costs, right_primal, data):
        """Chain-side marginal conditioned on fixed chain-variable primals:
        RESTRICT_BIG off each fixed variable's label lane in ``lam``, then
        the identical fwd/bwd min-conv DP."""
        lam = right_costs["lam"]
        M, V, L = lam.shape
        x = right_primal["x"]                       # [M, V]
        lam = condition_simplex(lam.reshape(M * V, L), None, x.reshape(M * V)).reshape(M, V, L)
        return self._chain_marginal({**right_costs, "lam": lam}, data)

    def marginal_right(self, right_costs, data):
        return self._chain_marginal(right_costs, data)

    def marginal_right_block(self, right_block, data, ridx):
        """All chain-side marginals from ONE pair of prefix/suffix DP
        sweeps over the whole chain block (registry block-marginal hook).

        The per-message path recomputes the full V-step DP per message, a
        V-fold blowup.  Here fwd[v]/bwd[v] for every prefix/suffix come out
        of the same two sweeps the per-chain bound uses
        (``CountingChainType._forward_all`` / ``_backward_all``), the
        position marginal is one window reduction over the L label shifts,
        and each message just indexes [chain, pos]."""
        lam, proj = right_block["lam"], right_block["proj"]
        L = lam.shape[-1]
        S = proj.shape[-1]
        fwd = COUNTING_CHAIN._forward_all(lam, S)       # [V+1, C, S]
        bwd = COUNTING_CHAIN._backward_all(lam, proj)   # [V+1, C, S]
        fv, bv = fwd[:-1], bwd[1:]                      # [V, C, S]
        # corr[v, c, l] = min_s fv[v, c, s] + bv[v, c, s + l]
        win = pad(bv, (0, L - 1), value=INF).unfold(-1, S, 1)   # [V, C, L, S]
        corr = torch.amin(fv.unsqueeze(-2) + win, dim=-1)       # [V, C, L]
        marg_all = lam + corr.transpose(0, 1)                   # [C, V, L]
        return mask_pad(marg_all[ridx, data["pos"]])

    def _chain_marginal(self, right_costs, data):
        lam, proj = right_costs["lam"], right_costs["proj"]
        pos = data["pos"]
        M, V, L = lam.shape
        S = proj.shape[-1]
        fwd = _dp_start((M,), S, lam)
        for v in range(V):
            fwd = torch.where((v < pos)[:, None], min_conv(fwd, lam[:, v], S), fwd)
        bwd = proj
        for v in range(V - 1, -1, -1):
            bwd = torch.where((v > pos)[:, None], min_corr(bwd, lam[:, v], S), bwd)
        lam_p = lam[torch.arange(M, device=lam.device), pos]   # [M, L]
        # min over s of fwd[s] + bwd[s + l]  ==  min_corr over the sum axis
        return mask_pad(lam_p + min_corr(bwd, fwd, L))

    # -- reparametrization -------------------------------------------------------
    def repam_left(self, costs, idx, delta, data):
        c = costs["c"]
        return {**costs, "c": c.index_add(0, idx, fit_width(delta, c.shape[1]))}

    def repam_right(self, costs, idx, delta, data):
        lam = costs["lam"]
        d = fit_width(delta, lam.shape[2])
        return {**costs, "lam": lam.index_put((idx, data["pos"]), d, accumulate=True)}

    # -- primal -------------------------------------------------------------------
    def propagate_primal_l2r(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        x = right_primal["x"]
        cur = x[ridx, data["pos"]]
        return {**right_primal,
                "x": x.index_put((ridx, data["pos"]), torch.where(l >= 0, l, cur))}

    def propagate_primal_r2l(self, left_primal, right_primal, lidx, ridx, data):
        r = right_primal["x"][ridx, data["pos"]]
        cur = left_primal["x"][lidx]
        return {**left_primal,
                "x": left_primal["x"].index_put((lidx,), torch.where(r >= 0, r, cur))}

    def consistent(self, left_primal, right_primal, lidx, ridx, data):
        l = left_primal["x"][lidx]
        r = right_primal["x"][ridx, data["pos"]]
        return (l >= 0) & (l == r)

    # -- constraint export: unary marginal == counting slot marginal -------
    def lp_coupling(self, lmeta, rmeta, data):
        L = lmeta[0]
        nv, nl, S, _ = rmeta
        pos = int(data)
        return [({lab: 1.0}, {pos * nl + lab: -1.0}, 0.0)
                for lab in range(min(L, nl))]


UNARY_COUNTING = UnaryCountingMessage()
