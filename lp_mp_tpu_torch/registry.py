"""Factor/message type protocols (counterpart of ``lp_mp_tpu/registry.py``).

A *factor type* batches all its instances into dense padded tensors and
provides batched reductions; a *message type* describes the min-marginal
operator between two factor types plus the scatter that applies a
reparametrization delta to each side.  Method names and signatures are the
JAX package's, so factor and message files map one to one; the arrays are
torch tensors.

Sign/semantics contract (MessageContainerView, factors_messages.hxx:
425-510): when factor A sends over a message with weight omega,

    delta = omega * min_marginal_A        (computed from A's current costs)
    A     -= delta                        (repam on A's slice)
    B     += delta                        (repam on B's slice)

"A receives from B" is B sending with omega=1.

Padding contract: invalid (padded) cost entries hold ``config.PAD_COST`` and
must stay there.  Marginal operators return **zero** on invalid message
coordinates (``mask_pad``), so padded entries are never perturbed.

Purity contract: ``repam_*`` and ``propagate_primal_*`` return new blocks
and never write into the tensors they are given (out-of-place
``index_add`` / ``index_put``).  The engine computes all deltas of a phase
from one snapshot and relies on it, as the JAX package relies on immutable
arrays.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .config import PAD_COST, MessageSchedule


def add_rows(costs: dict, idx: torch.Tensor, contrib: dict) -> dict:
    """``costs`` with ``contrib[key][m]`` added at row ``idx[m]`` of each of
    its keys (out-of-place ``index_add``: duplicate indices accumulate)."""
    return {**costs, **{k: costs[k].index_add(0, idx, v) for k, v in contrib.items()}}


def mask_pad(delta: torch.Tensor) -> torch.Tensor:
    """Zero out entries of a marginal that came from padded cost lanes."""
    return torch.where(delta.abs() >= PAD_COST / 2, torch.zeros_like(delta), delta)


# Soft-infinite penalty used by restricted (primal-conditioned) marginals:
# dominates any real cost but stays far below PAD_COST so mask_pad never
# confuses a conditioning penalty with a padded lane.
RESTRICT_BIG = 1e9


class FactorType:
    """Batched factor type. Subclasses are stateless singletons.

    Batched state of F instances is a dict of tensors with leading dim F
    ("block").  ``build`` packs per-instance data into a numpy block (float64
    for costs; the engine casts once when it moves blocks to its device and
    dtype); all other methods are pure batched tensor functions.
    """

    name: str = "factor"

    # -- construction ------------------------------------------------------
    def build(self, instances: Sequence[Any]) -> dict:
        """Pack instance data into a padded batched block (numpy)."""
        raise NotImplementedError

    def build_block(self, batch: Any) -> dict:
        """Pack a whole *batch payload* (type-specific, e.g. an [N, L] cost
        array) into a block in O(1) Python ops.  Batch counterpart of
        ``build`` used by FactorGraph.add_factor_block."""
        raise NotImplementedError(f"{self.name} has no batch constructor")

    def item_data(self, block: dict, i: int) -> Any:
        """Recover per-instance data from a built block (lazy
        graph.factors[fid] view over block chunks)."""
        raise NotImplementedError(f"{self.name} has no per-item view")

    # -- dual --------------------------------------------------------------
    def lower_bound(self, costs: dict) -> torch.Tensor:
        """[F] per-factor lower bound = min over local labelings (LP_MP.h:1507)."""
        raise NotImplementedError

    # -- primal ------------------------------------------------------------
    def init_primal(self, costs: dict) -> dict:
        """Fresh 'unset' primal block (reference init_primal, set to sentinel -1)."""
        raise NotImplementedError

    def compute_primal(self, costs: dict, primal: dict) -> dict:
        """MaximizePotentialAndComputePrimal: fill unset entries with local argmin."""
        return primal

    def evaluate_primal(self, costs: dict, primal: dict) -> torch.Tensor:
        """[F] cost of current labeling; +inf where primal invalid (LP_MP.h:1520)."""
        raise NotImplementedError

    # -- housekeeping ------------------------------------------------------
    def dual_vector(self, costs: dict) -> torch.Tensor:
        """Flatten dual state to [F, D] (serialization.hxx analogue)."""
        raise NotImplementedError

    # -- exact-oracle constraint export -------------------------------------
    # Every factor is exportable to external LP/ILP solvers, as the
    # reference's construct_constraints/load_costs/convert_primal are
    # (LP_MP.h:104-116, factors_messages.hxx:3441-3619): each type
    # contributes a block of [0,1] LP variables with linear equality rows;
    # io/lp_export and io/ilp drive these hooks.  They take and return host
    # numpy rows, never tensors.
    def lp_vars(self, state_row: dict, data: Any):
        """One factor's LP block from its reparametrized state row.

        Returns (costs [n], rows, rhs, meta): ``rows`` are intra-factor
        equality constraints as dicts {local var -> coef}, ``meta`` is an
        opaque value handed back to lp_fix/lp_read and to the incident
        messages' lp_coupling."""
        raise NotImplementedError(
            f"{self.name} has no LP constraint export")

    def lp_fix(self, prim_row: dict, meta) -> np.ndarray:
        """0/1 variable values of this block under fixed primal labels
        (convert_primal direction: primal -> external variables)."""
        raise NotImplementedError(f"{self.name} has no LP export")

    def lp_read(self, values: np.ndarray, meta) -> dict:
        """Primal labels from solved 0/1 block values (external -> primal);
        returns {primal key -> scalar or row vector}."""
        raise NotImplementedError(f"{self.name} has no LP export")


class MessageType:
    """Batched message type between ``left_type`` and ``right_type`` factors.

    One instance set = index arrays (left_idx[M], right_idx[M]) plus optional
    static per-message data.  The min-marginal operators receive *gathered*
    cost slices (leading dim M).
    """

    name: str = "message"
    left_type: FactorType
    right_type: FactorType
    schedule: MessageSchedule = MessageSchedule.left()
    # Slot-disjoint updates: every message of this type writes a DISJOINT
    # slice of its shared factor, so two active factors sharing a neighbor
    # only through this type may update in the SAME phase; the engine drops
    # this type's edges from the conflict adjacency.
    slot_disjoint: bool = False

    def build(self, instances: Sequence[Any]) -> dict:
        """Pack per-message static data (may be empty)."""
        return {}

    def build_block(self, batch: Any) -> dict:
        """Batch counterpart of ``build`` (FactorGraph.add_message_block)."""
        raise NotImplementedError(f"{self.name} has no batch constructor")

    def item_data(self, block: dict, i: int) -> Any:
        """Per-instance data view over a built data block."""
        raise NotImplementedError(f"{self.name} has no per-item view")

    # -- marginals ---------------------------------------------------------
    def marginal_left(self, left_costs: dict, data: dict) -> torch.Tensor:
        """[M, D...] min-marginal the LEFT factor pushes (send_message_to_right)."""
        raise NotImplementedError

    def marginal_right(self, right_costs: dict, data: dict) -> torch.Tensor:
        """[M, D...] min-marginal the RIGHT factor pushes (send_message_to_left)."""
        raise NotImplementedError

    # -- block marginals (optional dedup hooks) ----------------------------
    # A type whose messages share sender rows may compute the marginals of
    # ALL its messages from the full sender block in one batched op; the
    # engine gathers the [M, D...] result by its phase ids.  ``None`` means
    # "no hook"; override with a method to opt in.
    marginal_left_block = None      # (self, left_block, data, lidx) -> [M, D]
    marginal_right_block = None     # (self, right_block, data, ridx) -> [M, D]

    # -- restricted (primal-conditioned) marginals --------------------------
    # One-sided restricted messages for rounding (OneSideMessageContainerView,
    # factors_messages.hxx:513-566): the sender's min-marginal conditioned on
    # its already-fixed primal entries (RESTRICT_BIG penalties on labels
    # inconsistent with the fixed primal; unconditioned where unset).
    def restricted_marginal_left(self, left_costs: dict, left_primal: dict,
                                 data: dict) -> torch.Tensor:
        return self.marginal_left(left_costs, data)

    def restricted_marginal_right(self, right_costs: dict, right_primal: dict,
                                  data: dict) -> torch.Tensor:
        return self.marginal_right(right_costs, data)

    # -- reparametrization scatters ---------------------------------------
    def repam_left(self, costs: dict, idx: torch.Tensor, delta: torch.Tensor,
                   data: dict) -> dict:
        """New left block with costs at idx += delta (duplicate indices
        accumulate)."""
        raise NotImplementedError

    def repam_right(self, costs: dict, idx: torch.Tensor, delta: torch.Tensor,
                    data: dict) -> dict:
        raise NotImplementedError

    # -- pull-mode contributions (engine_pull) ------------------------------
    # A type that can express its reparametrization as a DENSE per-message
    # contribution in the target block's key space opts into the pull pass
    # (``Engine(pull=True)``, engine_pull): the engine adds the contributions
    # of a slot of messages lane for lane onto views of the target block.
    # Contract: repam_left(costs, idx, delta, data) must equal costs with
    # key[idx[m]] += pull_left(delta, data, costs)[key][m], i.e.
    # ``add_rows(costs, idx, pull_left(...))`` (``costs`` gives the target
    # block's shapes only).  ``None`` (the default) means no hook.
    def pull_left(self, delta: torch.Tensor, data: dict, costs: dict) -> "dict | None":
        return None

    def pull_right(self, delta: torch.Tensor, data: dict, costs: dict) -> "dict | None":
        return None

    # -- exact-oracle constraint export -------------------------------------
    def lp_coupling(self, lmeta, rmeta, data: Any) -> list:
        """Coupling equalities gluing one message's two LP blocks
        (MessageContainer::construct_constraints analogue,
        factors_messages.hxx:1605-1674).  Returns a list of
        (left_coefs {lvar->coef}, right_coefs {rvar->coef}, rhs)."""
        raise NotImplementedError(
            f"{self.name} has no LP constraint export")

    # -- primal ------------------------------------------------------------
    def propagate_primal_l2r(self, left_primal: dict, right_primal: dict,
                             lidx, ridx, data: dict) -> dict:
        """ComputeRightFromLeftPrimal on the batch; returns updated right block."""
        return right_primal

    def propagate_primal_r2l(self, left_primal: dict, right_primal: dict,
                             lidx, ridx, data: dict) -> dict:
        return left_primal

    def consistent(self, left_primal: dict, right_primal: dict,
                   lidx, ridx, data: dict) -> torch.Tensor:
        """[M] bool CheckPrimalConsistency per message."""
        return torch.ones(lidx.shape[0], dtype=torch.bool, device=lidx.device)
