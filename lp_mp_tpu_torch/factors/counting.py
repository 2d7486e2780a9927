"""Counting (discrete tomography projection) factors (counterpart of
``lp_mp_tpu/factors/counting.py``).

Reference: ``DiscreteTomographyFactorCounting`` + counting messages
(downstream ``solvers/discrete_tomography/*``, surface documented by
test/discrete_tomography.cpp): a projection constrains the SUM of the label
values of the variables along a ray, with a cost vector over the attainable
sums.  The reference decomposes each ray into a binary tree of counting
factors whose messages are min-convolutions (test/min_conv.cpp).

Batched form: one *chain* factor per projection holding per-variable
reparametrization slots ``lam [F, V, L]`` and the projection cost
``proj [F, S]``; every bound/marginal is a batched DP over partial sums
whose transition is ``ops.minconv.min_conv``.  The JAX package's
``lax.scan`` over the V variables is a Python loop here that writes each
step into its row of a preallocated ``[V+1, F, S]`` table.

Padding convention: variables beyond ``nv`` are forced to label 0 with zero
cost (lam[v>=nv] = [0, inf, ...]), labels beyond ``nl`` and sums beyond the
instance's cost-vector length carry +inf.  These are real +inf, not
``PAD_COST``: every chain-side marginal passes ``mask_pad``, which zeroes
them, before a weight multiplies it.  Not ported: the LP hooks (ROADMAP.md
queue 1 item 9).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn.functional import pad

from ..ops.minconv import INF, arg_min_conv, min_conv
from ..registry import FactorType
from .simplex import BUILD_DTYPE


def min_corr(b: torch.Tensor, lam: torch.Tensor, out_size: int) -> torch.Tensor:
    """out[s] = min_l lam[..., l] + b[..., s + l] — the backward DP step
    (cross-correlation form of min_conv; +inf where s + l leaves b), as one
    window view of ``b`` padded with +inf, like ``min_conv``."""
    L = lam.shape[-1]
    bp = pad(b, (0, max(0, out_size + L - 1 - b.shape[-1])), value=INF)
    return torch.amin(bp[..., :out_size + L - 1].unfold(-1, L, 1) + lam.unsqueeze(-2), dim=-1)


def _dp_start(lead: tuple, S: int, like: torch.Tensor) -> torch.Tensor:
    """[*lead, S] partial-sum costs before any variable: 0 at sum 0."""
    dp = torch.full(lead + (S,), INF, dtype=like.dtype, device=like.device)
    dp[..., 0] = 0.0
    return dp


class CountingChainType(FactorType):
    """All projection (counting chain) factors as one padded block."""

    name = "counting_chain"

    def build(self, instances):
        """instances: (n_vars, labels_per_var:int, proj_cost: array)."""
        V = max(inst[0] for inst in instances)
        L = max(inst[1] for inst in instances)
        S = max(len(inst[2]) for inst in instances)
        F = len(instances)
        lam = np.full((F, V, L), INF, dtype=BUILD_DTYPE)
        proj = np.full((F, S), INF, dtype=BUILD_DTYPE)
        nv = np.zeros(F, dtype=np.int64)
        nl = np.zeros(F, dtype=np.int64)
        for f, (n_vars, n_labels, pc) in enumerate(instances):
            lam[f, :n_vars, :n_labels] = 0.0
            lam[f, n_vars:, 0] = 0.0        # padded vars forced to label 0
            proj[f, :len(pc)] = np.asarray(pc, dtype=BUILD_DTYPE)
            nv[f] = n_vars
            nl[f] = n_labels
        return {"lam": lam, "proj": proj, "nv": nv, "nl": nl}

    # -- DP ------------------------------------------------------------------
    @staticmethod
    def _forward_all(lam: torch.Tensor, S: int) -> torch.Tensor:
        """fwd[v] [.., S] = min cost of vars < v by partial sum; returns the
        stacked [V+1, .., S] table."""
        V = lam.shape[-2]
        fwd = torch.empty((V + 1,) + lam.shape[:-2] + (S,), dtype=lam.dtype, device=lam.device)
        fwd[0] = _dp_start(lam.shape[:-2], S, lam)
        for v in range(V):
            min_conv(fwd[v], lam[..., v, :], S, out=fwd[v + 1])
        return fwd

    @staticmethod
    def _backward_all(lam: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
        """bwd[v] [.., S] = min cost of vars >= v plus proj, given prefix sum;
        stacked [V+1, .., S]."""
        V = lam.shape[-2]
        S = proj.shape[-1]
        bwd = torch.empty((V + 1,) + proj.shape, dtype=lam.dtype, device=lam.device)
        bwd[V] = proj
        for v in range(V - 1, -1, -1):
            bwd[v] = min_corr(bwd[v + 1], lam[..., v, :], S)
        return bwd

    def lower_bound(self, costs):
        lam, proj = costs["lam"], costs["proj"]
        fwd = self._forward_all(lam, proj.shape[-1])
        return torch.amin(fwd[-1] + proj, dim=-1)

    # -- primal ----------------------------------------------------------------
    def init_primal(self, costs):
        F, V, _ = costs["lam"].shape
        return {"x": torch.full((F, V), -1, dtype=torch.int32, device=costs["lam"].device)}

    def compute_primal(self, costs, primal):
        """Restricted argmin: honor already-fixed labels, DP + backtrack."""
        lam, proj = costs["lam"], costs["proj"]
        F, V, L = lam.shape
        S = proj.shape[-1]
        x = primal["x"]                            # [F, V]
        fixed = x >= 0
        lanes = torch.arange(L, device=lam.device)
        off = fixed[..., None] & (lanes != x.clamp(min=0).long()[..., None])
        lam_eff = torch.where(off, torch.full_like(lam, INF), lam)

        dp = _dp_start((F,), S, lam)
        ptr = torch.empty((V, F, S), dtype=torch.int64, device=lam.device)
        for v in range(V):
            dp, ptr[v] = arg_min_conv(dp, lam_eff[:, v], S)   # arg over prefix sums

        s = torch.argmin(dp + proj, dim=-1)        # [F]
        labels = torch.empty((V, F), dtype=torch.int64, device=lam.device)
        for v in range(V - 1, -1, -1):
            i = ptr[v].gather(1, s[:, None])[:, 0]
            labels[v] = s - i
            s = i
        return {"x": torch.where(fixed, x, labels.T.to(torch.int32))}

    def evaluate_primal(self, costs, primal):
        lam, proj = costs["lam"], costs["proj"]
        F, S = proj.shape
        x = primal["x"]
        ok = torch.all(x >= 0, dim=1)
        xc = x.clamp(min=0).long()
        total = torch.gather(lam, 2, xc[..., None])[..., 0].sum(dim=1)
        s = xc.sum(dim=1)
        pv = proj[torch.arange(F, device=proj.device), s.clamp(0, S - 1)]
        val = total + torch.where(s < S, pv, torch.full_like(pv, INF))
        return torch.where(ok, val, torch.full_like(val, INF))

    def dual_vector(self, costs):
        F = costs["lam"].shape[0]
        return torch.cat([costs["lam"].reshape(F, -1), costs["proj"].reshape(F, -1)], dim=1)


COUNTING_CHAIN = CountingChainType()
