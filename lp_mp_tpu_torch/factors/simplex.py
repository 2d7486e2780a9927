"""Simplex factors, type-batched (counterpart of ``lp_mp_tpu/factors/simplex.py``).

Reference API surface (downstream ``factors/simplex_factor.hxx``, pinned by
test/simplex.cpp, test/simplex_marginalization.cpp):

- ``UnarySimplexFactor(cost_vector)``: LowerBound = min cost.
- ``PairwiseSimplexFactor(n1, n2)`` with ``cost(x1, x2)``.
- ``SimpleTighteningTernarySimplexFactor`` analogue: dense ternary simplex.

All instances of one type live in one dense padded tensor (padding =
config.PAD_COST).  Blocks are built in float64 numpy; the engine casts them
once to its device and dtype.  ``torch.argmin`` returns the first minimal
index, as ``jnp.argmin`` does, so rounding breaks ties alike.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import PAD_COST
from ..registry import FactorType

BUILD_DTYPE = np.float64


def _pack_padded(vectors, dtype) -> np.ndarray:
    """Stack variable-length numpy arrays into [F, max] with PAD_COST padding."""
    shapes = [np.shape(v) for v in vectors]
    ndim = len(shapes[0])
    maxs = tuple(max(s[d] for s in shapes) for d in range(ndim))
    out = np.full((len(vectors),) + maxs, PAD_COST, dtype=dtype)
    for i, v in enumerate(vectors):
        out[(i,) + tuple(slice(0, s) for s in np.shape(v))] = v
    return out


def _unset(n: int, device) -> torch.Tensor:
    return torch.full((n,), -1, dtype=torch.int32, device=device)


def _fixed_or(x: torch.Tensor, am: torch.Tensor) -> torch.Tensor:
    """Keep already-fixed labels, fill unset (-1) ones from ``am``."""
    return torch.where(x < 0, am.to(torch.int32), x)


def _lane(x: torch.Tensor) -> torch.Tensor:
    """Label as an index: unset (-1) reads lane 0, masked by the caller."""
    return x.clamp(min=0).long()


def _inf_unless(ok: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    return torch.where(ok, val, torch.full_like(val, float("inf")))


def _feasible(x: torch.Tensor, lanes: torch.Tensor) -> torch.Tensor:
    """Lanes compatible with a (possibly unset) fixed label; ``x`` is
    broadcast against ``lanes``."""
    return (x < 0) | (lanes == x)


def _pair_fix(prim_row, meta) -> np.ndarray:
    """LP block of an (n1, n2) pairwise configuration under fixed labels."""
    v = np.zeros(meta[0] * meta[1])
    v[int(prim_row["x1"]) * meta[1] + int(prim_row["x2"])] = 1.0
    return v


def _pair_read(values, meta) -> dict:
    k = int(np.argmax(values))
    return {"x1": k // meta[1], "x2": k % meta[1]}


class UnarySimplexType(FactorType):
    """All unary simplex factors as one [F, L] tensor."""

    name = "unary_simplex"

    def build(self, instances):
        c = _pack_padded([np.asarray(v, dtype=BUILD_DTYPE) for v in instances], BUILD_DTYPE)
        nl = np.asarray([len(v) for v in instances], dtype=np.int32)
        return {"c": c, "nl": nl}

    def build_block(self, batch):
        """batch = [N, L] cost array (uniform label count)."""
        c = np.ascontiguousarray(np.asarray(batch, dtype=BUILD_DTYPE))
        assert c.ndim == 2
        nl = np.full(c.shape[0], c.shape[1], dtype=np.int32)
        return {"c": c, "nl": nl}

    def item_data(self, block, i):
        return np.asarray(block["c"][i, :int(block["nl"][i])])

    def lower_bound(self, costs):
        return torch.amin(costs["c"], dim=1)

    def init_primal(self, costs):
        c = costs["c"]
        return {"x": _unset(c.shape[0], c.device)}

    def compute_primal(self, costs, primal):
        return {"x": _fixed_or(primal["x"], torch.argmin(costs["c"], dim=1))}

    def evaluate_primal(self, costs, primal):
        x = primal["x"]
        val = torch.gather(costs["c"], 1, _lane(x)[:, None])[:, 0]
        return _inf_unless(x >= 0, val)

    def dual_vector(self, costs):
        return costs["c"].reshape(costs["c"].shape[0], -1)

    # -- constraint export (factors_messages.hxx:3441-3619 analogue) -------
    def lp_vars(self, state_row, data):
        nl = int(state_row["nl"])
        c = np.asarray(state_row["c"][:nl], dtype=np.float64)
        return c, [{k: 1.0 for k in range(nl)}], [1.0], (nl,)

    def lp_fix(self, prim_row, meta):
        v = np.zeros(meta[0])
        v[int(prim_row["x"])] = 1.0
        return v

    def lp_read(self, values, meta):
        return {"x": int(np.argmax(values))}


class PairwiseSimplexType(FactorType):
    """All dense pairwise simplex factors as one [F, L1, L2] tensor."""

    name = "pairwise_simplex"

    def build(self, instances):
        c = _pack_padded([np.asarray(v, dtype=BUILD_DTYPE) for v in instances], BUILD_DTYPE)
        n1 = np.asarray([np.shape(v)[0] for v in instances], dtype=np.int32)
        n2 = np.asarray([np.shape(v)[1] for v in instances], dtype=np.int32)
        return {"c": c, "n1": n1, "n2": n2}

    def build_block(self, batch):
        """batch = [N, L1, L2] cost array (uniform label counts)."""
        c = np.ascontiguousarray(np.asarray(batch, dtype=BUILD_DTYPE))
        assert c.ndim == 3
        n1 = np.full(c.shape[0], c.shape[1], dtype=np.int32)
        n2 = np.full(c.shape[0], c.shape[2], dtype=np.int32)
        return {"c": c, "n1": n1, "n2": n2}

    def item_data(self, block, i):
        return np.asarray(block["c"][i, :int(block["n1"][i]),
                                     :int(block["n2"][i])])

    def lower_bound(self, costs):
        return torch.amin(costs["c"], dim=(1, 2))

    def init_primal(self, costs):
        c = costs["c"]
        return {"x1": _unset(c.shape[0], c.device), "x2": _unset(c.shape[0], c.device)}

    def compute_primal(self, costs, primal):
        c = costs["c"]
        F, L1, L2 = c.shape
        x1, x2 = primal["x1"], primal["x2"]
        i1 = torch.arange(L1, device=c.device)[None, :, None]
        i2 = torch.arange(L2, device=c.device)[None, None, :]
        feas = _feasible(x1[:, None, None], i1) & _feasible(x2[:, None, None], i2)
        cm = torch.where(feas, c, torch.full_like(c, PAD_COST * 2))
        am = torch.argmin(cm.reshape(F, -1), dim=1)
        return {"x1": _fixed_or(x1, am // L2), "x2": _fixed_or(x2, am % L2)}

    def evaluate_primal(self, costs, primal):
        c = costs["c"]
        x1, x2 = primal["x1"], primal["x2"]
        f = torch.arange(c.shape[0], device=c.device)
        return _inf_unless((x1 >= 0) & (x2 >= 0), c[f, _lane(x1), _lane(x2)])

    def dual_vector(self, costs):
        return costs["c"].reshape(costs["c"].shape[0], -1)

    def lp_vars(self, state_row, data):
        n1, n2 = int(state_row["n1"]), int(state_row["n2"])
        c = np.asarray(state_row["c"][:n1, :n2], dtype=np.float64)
        return (c.ravel(), [{k: 1.0 for k in range(n1 * n2)}], [1.0],
                (n1, n2))

    def lp_fix(self, prim_row, meta):
        return _pair_fix(prim_row, meta)

    def lp_read(self, values, meta):
        return _pair_read(values, meta)


class TernarySimplexType(FactorType):
    """Dense ternary simplex [F, L1, L2, L3]: the tightening triplet factor
    (reference SimpleTighteningTernarySimplexFactor analogue,
    test/graphical_model.cpp:140-204)."""

    name = "ternary_simplex"

    def build(self, instances):
        c = _pack_padded([np.asarray(v, dtype=BUILD_DTYPE) for v in instances], BUILD_DTYPE)
        return {"c": c}

    def lower_bound(self, costs):
        return torch.amin(costs["c"], dim=(1, 2, 3))

    def init_primal(self, costs):
        c = costs["c"]
        return {k: _unset(c.shape[0], c.device) for k in ("x1", "x2", "x3")}

    def compute_primal(self, costs, primal):
        c = costs["c"]
        F, L1, L2, L3 = c.shape
        x1, x2, x3 = primal["x1"], primal["x2"], primal["x3"]
        i1 = torch.arange(L1, device=c.device)[None, :, None, None]
        i2 = torch.arange(L2, device=c.device)[None, None, :, None]
        i3 = torch.arange(L3, device=c.device)[None, None, None, :]
        feas = (_feasible(x1[:, None, None, None], i1)
                & _feasible(x2[:, None, None, None], i2)
                & _feasible(x3[:, None, None, None], i3))
        cm = torch.where(feas, c, torch.full_like(c, PAD_COST * 2))
        am = torch.argmin(cm.reshape(F, -1), dim=1)
        return {"x1": _fixed_or(x1, am // (L2 * L3)),
                "x2": _fixed_or(x2, (am // L3) % L2),
                "x3": _fixed_or(x3, am % L3)}

    def evaluate_primal(self, costs, primal):
        c = costs["c"]
        x1, x2, x3 = primal["x1"], primal["x2"], primal["x3"]
        f = torch.arange(c.shape[0], device=c.device)
        return _inf_unless((x1 >= 0) & (x2 >= 0) & (x3 >= 0),
                           c[f, _lane(x1), _lane(x2), _lane(x3)])

    def dual_vector(self, costs):
        return costs["c"].reshape(costs["c"].shape[0], -1)

    def lp_vars(self, state_row, data):
        sh = tuple(np.shape(data))
        c = np.asarray(state_row["c"][tuple(slice(0, s) for s in sh)],
                       dtype=np.float64)
        n = int(np.prod(sh))
        return c.ravel(), [{k: 1.0 for k in range(n)}], [1.0], sh

    def lp_fix(self, prim_row, meta):
        _, l2, l3 = meta
        v = np.zeros(int(np.prod(meta)))
        k = (int(prim_row["x1"]) * l2 + int(prim_row["x2"])) * l3 \
            + int(prim_row["x3"])
        v[k] = 1.0
        return v

    def lp_read(self, values, meta):
        _, l2, l3 = meta
        k = int(np.argmax(values))
        return {"x1": k // (l2 * l3), "x2": (k // l3) % l2, "x3": k % l3}


UNARY_SIMPLEX = UnarySimplexType()
PAIRWISE_SIMPLEX = PairwiseSimplexType()
TERNARY_SIMPLEX = TernarySimplexType()
