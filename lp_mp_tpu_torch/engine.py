"""Batched message-passing engine (counterpart of ``lp_mp_tpu/engine.py``).

Counterpart of ``LP<FMC>`` (LP_MP.h:200-2056).  The factor graph is
compiled to

- one dense padded cost block per *factor type*,
- gather/scatter index arrays per *message type*,
- a static *phase schedule* (schedule.levelize) under which running each
  phase fully batched is exactly equivalent to the reference's sequential
  sweep (``schedule_mode="sequential"`` degenerates to one factor per phase
  and serves as the in-tree oracle for parity tests).

Per phase, receive deltas are gathered/reduced/scattered (ReceiveMessages,
factors_messages.hxx:2440-2471), then send deltas are computed from one
post-receive snapshot (SendMessages' tmp_factor semantics,
factors_messages.hxx:2787-2814) and scattered with their omega weights.

The pass is plain PyTorch on ``device``: gather, batched min-marginal,
out-of-place ``index_add`` scatter.  Every phase's index arrays and
gathered static message data are uploaded once, when the pass is built, as
int64 device tensors; running a pass moves nothing from the host.  All
updates are out of place, so a phase's deltas computed from one snapshot
never see each other's writes.

``use_jit=True`` (the default, as in the JAX package) runs every device
program through ``capture.Graphs``: on CUDA each dual pass (per direction
and weight mode), primal pass, restricted pass, partition and overlapping
sub-pass, the bound's device sum, ``evaluate_primal`` and the consistency
check is captured once per build as a CUDA graph and replayed; on the CPU
the same buffer logic runs around direct calls, with bit-equal results.
The state then lives in fixed buffers that each pass overwrites:
``get_state`` hands out clones, ``set_state`` copies into the buffers, and
a state that ``get_state`` handed out, or that ``Solver.build_engine``
carried over, stays intact.  ``use_jit=False`` runs every pass eagerly and
rebinds ``state`` to new tensors.  On CUDA, ``index_add`` sums duplicate
indices with float atomics in an order that varies from run to run, so
results on the card agree within a tolerance, not bit for bit.

``pull=True`` runs each direction's dual pass as the structured pull pass
(``engine_pull``): per message type and direction, slots of at most one
message per receiving row whose sender rows are read through strided views
and whose contributions are added in place on views of clones of the
state, with a row gather and ``index_add_`` only where a slot fits no
strided pattern.  It needs ``update_mode="shared"`` and the ``pull_left``/
``pull_right`` hooks on every scheduled message type, and raises a
``ValueError`` naming what is missing; primal, restricted, partition and
residual or adaptive passes stay on the scatter path.  ``pull="auto"`` (the
default) and ``pull=False`` run the scatter pass: the JAX package's
``auto`` picks pull only on the TPU backend.

Not ported: the ``lax.scan`` pass (it keeps XLA's compile time O(1) in the
phase count; a CUDA graph records the unrolled pass).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from . import schedule as sched
from . import tracing
from .capture import Graphs
from .config import (PAD_COST, Direction, ReparametrizationMode, entry_device, eps_for,
                     real_dtype)
from .convert import block_from_numpy
from .graph import FactorGraph
from .registry import FactorType, MessageType

# schedule_mode="auto": factor count above which coloring replaces
# wavefront.  The JAX package's non-TPU value (engine.py:159); queue 1
# item 11 of ROADMAP.md measures the cutover on the H100.
AUTO_COLORING_FACTORS = 50_000

# Rows of at most this many bytes are gathered element by element on CUDA:
# torch's row gather (``vectorized_gather_kernel``, behind both ``t[idx]``
# and ``index_select``) gives every index a thread block of its own, and took
# 605 us for 10^6 rows of 16 bytes on an H100 where the element gather took
# 79 us.  Wider rows keep the row gather: on the host-bound chain the flat
# gather's extra index ops cost more than they save (PERF.md).
FLAT_GATHER_MAX_ROW_BYTES = 16


def _flat_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along axis 0 as one element gather over flat indices."""
    k = t[0].numel()
    flat = (idx[:, None] * k + torch.arange(k, device=t.device)).reshape(-1)
    return t.reshape(-1)[flat].reshape(idx.shape + t.shape[1:])


def _take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]`` along axis 0."""
    if (t.ndim > 1 and t.device.type == "cuda"
            and t[0].numel() * t.element_size() <= FLAT_GATHER_MAX_ROW_BYTES):
        return _flat_rows(t, idx)
    return t[idx]


def _gather(block: dict, idx) -> dict:
    return {k: _take_rows(v, idx) for k, v in block.items()}


def _cumcount(a: np.ndarray) -> np.ndarray:
    """Per element: number of earlier occurrences of the same value."""
    n = len(a)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    order = np.argsort(a, kind="stable")
    sa = a[order]
    grp = np.zeros(n, dtype=np.int64)
    grp[1:] = np.cumsum(sa[1:] != sa[:-1])  # group id per sorted position
    grp_first = np.full(grp[-1] + 1, n, dtype=np.int64)
    np.minimum.at(grp_first, grp, np.arange(n))
    out = np.empty(n, dtype=np.int64)
    out[order] = np.arange(n) - grp_first[grp]
    return out


def _bmul(delta: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Multiply [M, ...] delta by per-message scalar weight [M]."""
    return delta * w.reshape((-1,) + (1,) * (delta.ndim - 1))


def _concat_blocks(blocks: list[dict]) -> dict:
    """Concatenate built blocks along axis 0, pad-harmonizing trailing dims
    (PAD_COST for float lanes, 0 for integer lanes)."""
    if len(blocks) == 1:
        return blocks[0]
    out = {}
    for k in blocks[0]:
        arrs = [np.asarray(b[k]) for b in blocks]
        trail = tuple(max(a.shape[d] for a in arrs)
                      for d in range(1, arrs[0].ndim))
        if any(a.shape[1:] != trail for a in arrs):
            padded = []
            for a in arrs:
                fill = PAD_COST if np.issubdtype(a.dtype, np.floating) else 0
                p = np.full((a.shape[0],) + trail, fill, dtype=a.dtype)
                p[(slice(None),) + tuple(slice(0, s) for s in a.shape[1:])] = a
                padded.append(p)
            arrs = padded
        out[k] = np.concatenate(arrs, axis=0)
    return out


def _segmented_cumsum(values: np.ndarray, keys: np.ndarray) -> np.ndarray:
    """Cumulative sum of ``values`` restarting whenever the (stable-sorted)
    ``keys`` group changes; result aligned to the input order."""
    m = len(values)
    if m == 0:
        return np.zeros(0)
    order = np.argsort(keys, kind="stable")
    v = values[order]
    k = keys[order]
    cs = np.cumsum(v)
    grp_change = np.zeros(m, dtype=bool)
    grp_change[1:] = k[1:] != k[:-1]
    # base per position = cumsum at end of the previous group, forward-filled
    fill = np.zeros(m)
    idx = np.nonzero(grp_change)[0]
    fill[idx] = cs[idx - 1]
    run = np.maximum.accumulate(np.where(grp_change, np.arange(m), 0))
    out = np.empty(m)
    out[order] = cs - fill[run]
    return out


@dataclasses.dataclass
class _MsgBlock:
    mtype: MessageType
    lidx: torch.Tensor     # [M] local row in left factor block (device)
    ridx: torch.Tensor     # [M] local row in right factor block (device)
    gids: np.ndarray       # [M] global message index (for weight slicing)
    data: dict             # static per-message data (device tensors)
    lfid: np.ndarray       # [M] global factor id of left endpoint
    rfid: np.ndarray       # [M] global factor id of right endpoint
    chunk_of: np.ndarray   # [M] graph message chunk (engine_pull slots)


@dataclasses.dataclass
class _PhasePlan:
    recv_left: list[tuple[str, np.ndarray]]   # (msg type name, local msg ids)
    recv_right: list[tuple[str, np.ndarray]]
    send_left: list[tuple[str, np.ndarray, np.ndarray]]   # (+ sending factor gid)
    send_right: list[tuple[str, np.ndarray, np.ndarray]]
    factor_rows: dict[str, np.ndarray]        # factor type name -> local rows
    prop_l2r: list[tuple[str, np.ndarray]]
    prop_r2l: list[tuple[str, np.ndarray]]
    # residual resend sub-rounds: rank -> [(name, local ids, from_left)]
    # (send_messages_residual's per-factor sequential resend with cumulative
    # weights, factors_messages.hxx:2959-3007; rank k of every factor runs in
    # sub-round k, so each resend sees the factor's earlier resends)
    resend: list[list[tuple[str, np.ndarray, bool]]] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class _Sel:
    """One plan entry on the device: the messages ``ids`` of type ``name``,
    their endpoint rows, their static data, and (for sends) the sending
    factors' global ids."""

    name: str
    ids: torch.Tensor
    lidx: torch.Tensor
    ridx: torch.Tensor
    data: dict
    fg: "torch.Tensor | None" = None


@dataclasses.dataclass
class _DevPlan:
    """A ``_PhasePlan`` with every index array uploaded once."""

    recv_left: list[_Sel]
    recv_right: list[_Sel]
    send_left: list[_Sel]
    send_right: list[_Sel]
    factor_rows: dict[str, torch.Tensor]
    prop_l2r: list[_Sel]
    prop_r2l: list[_Sel]
    resend: list[list[tuple[_Sel, bool]]]


class Engine:
    """Compiled model + passes over it, on ``device`` in ``dtype``
    (default: ``config.real_dtype(device)``), captured as CUDA graphs with
    ``use_jit``, with the scatter or the pull pass (module docstring)."""

    def __init__(self, graph: FactorGraph, schedule_mode: str = "wavefront",
                 update_mode: str = "shared", inner_iteration: int = 5,
                 device="cuda", dtype: "torch.dtype | None" = None, use_jit: bool = True,
                 pull: "str | bool" = "auto"):
        if pull not in (True, False, "auto"):
            raise ValueError(f"pull must be True, False or 'auto', not {pull!r}")
        self.device = entry_device(device)
        self.dtype = dtype or real_dtype(self.device)
        if schedule_mode == "auto":
            # coloring keeps the phase count graph-degree-bounded on big
            # graphs; wavefront preserves the reference sweep order on
            # small.  Slot-disjoint message types (counting chains) mean hub
            # factors whose rays would explode the wavefront phase count;
            # their conflict edges are dropped below, and coloring then
            # yields a degree-bounded 2-3 phase schedule.
            has_disjoint = any(ch.mtype.slot_disjoint
                               for ch in graph.message_chunks())
            schedule_mode = "coloring" if (graph.n_factors > AUTO_COLORING_FACTORS
                                           or has_disjoint) else "wavefront"
        assert schedule_mode in ("wavefront", "coloring", "sequential")
        # --reparametrizationType (LP_MP.h:527-530,588-594)
        assert update_mode in ("shared", "residual", "adaptive",
                               "partition", "overlapping_partition")
        self.graph = graph
        self.schedule_mode = schedule_mode
        self.update_mode = update_mode
        self.inner_iteration = inner_iteration
        self.constant = graph.constant
        # snapshot: tightening may grow the graph AFTER this engine is
        # built; every engine structure keeps using the build-time count
        self.n_factors = n = graph.n_factors

        # ---- factor blocks (chunked, O(#chunks) Python) --------------------
        self.ftypes: dict[str, FactorType] = {}
        self.f_local = np.zeros(n, dtype=np.int64)
        type_rows: dict[str, int] = {}
        # per type, in row order: built block chunks and runs of item data.
        # A type's item chunks that no block chunk separates are built in
        # one ``build`` call, so the type pads its own instances (the
        # counting chain forces a short chain's padded variables to label
        # 0); ``_concat_blocks`` pads across the rest with PAD_COST.  The
        # JAX package builds every item chunk alone: projections of two
        # lengths added between other factors get PAD_COST on every label
        # of a padded variable, and a bound of order PAD_COST (ROADMAP.md
        # queue 3).
        parts_per_type: dict[str, list] = {}
        type_fids: dict[str, list[np.ndarray]] = {}
        for ch in graph.factor_chunks():
            name = ch.ftype.name
            self.ftypes.setdefault(name, ch.ftype)
            off = type_rows.get(name, 0)
            self.f_local[ch.start:ch.start + ch.n] = np.arange(off, off + ch.n)
            type_rows[name] = off + ch.n
            type_fids.setdefault(name, []).append(
                np.arange(ch.start, ch.start + ch.n, dtype=np.int64))
            parts = parts_per_type.setdefault(name, [])
            if ch.kind == "items" and parts and isinstance(parts[-1], list):
                parts[-1].extend(ch.payload)
            else:
                parts.append(list(ch.payload) if ch.kind == "items" else ch.payload)
        self._type_fids = {k: np.concatenate(v) for k, v in type_fids.items()}
        self.state = {
            name: block_from_numpy(_concat_blocks([self.ftypes[name].build(p) if isinstance(p, list)
                                                   else p for p in parts]),
                                   self.device, self.dtype)
            for name, parts in parts_per_type.items()}

        # ---- message blocks (chunked) ---------------------------------------
        self.mtypes: dict[str, MessageType] = {}
        mb: dict[str, dict] = {}
        for ch in graph.message_chunks():
            name = ch.mtype.name
            self.mtypes.setdefault(name, ch.mtype)
            d = mb.setdefault(name, {"lf": [], "rf": [], "g": [], "built": []})
            d["lf"].append(np.asarray(ch.lfid, dtype=np.int64))
            d["rf"].append(np.asarray(ch.rfid, dtype=np.int64))
            d["g"].append(np.arange(ch.start, ch.start + ch.n, dtype=np.int64))
            built = ch.mtype.build(ch.payload) if ch.kind == "items" \
                else (ch.payload if ch.payload is not None else {})
            d["built"].append(built)
        self.msgs: dict[str, _MsgBlock] = {}
        for name, d in mb.items():
            lfid = np.concatenate(d["lf"])
            rfid = np.concatenate(d["rf"])
            self.msgs[name] = _MsgBlock(
                mtype=self.mtypes[name],
                lidx=self._index(self.f_local[lfid]), ridx=self._index(self.f_local[rfid]),
                gids=np.concatenate(d["g"]),
                data=block_from_numpy(_concat_blocks(d["built"]), self.device, self.dtype),
                lfid=lfid, rfid=rfid,
                chunk_of=np.repeat(np.arange(len(d["g"]), dtype=np.int64),
                                   [len(g) for g in d["g"]]))
        self.n_messages = graph._n_messages

        # ---- per-factor send ranks ------------------------------------------
        # Traversal order = message-type insertion order then container order,
        # mirroring the reference's MESSAGE_DISPATCHER_TYPELIST iteration in
        # send_messages_residual (factors_messages.hxx:2959-3007).  rank[m] =
        # position of m among its sending factor's outgoing messages.
        send_counts = np.zeros(n, dtype=np.int64)
        self._rank_left: dict[str, np.ndarray] = {}
        self._rank_right: dict[str, np.ndarray] = {}
        for name, blk in self.msgs.items():
            s = self.mtypes[name].schedule
            str_, stl = s.sends_to_right, s.sends_to_left
            m = len(blk.gids)
            rl = np.full(m, -1, dtype=np.int64)
            rr = np.full(m, -1, dtype=np.int64)
            # flattened sending-endpoint sequence [l0, r0, l1, r1, ...]
            # restricted to sending sides; rank = prior occurrences of the
            # factor in traversal order (vectorized cumcount)
            if str_ and stl:
                seq = np.empty(2 * m, dtype=np.int64)
                seq[0::2] = blk.lfid
                seq[1::2] = blk.rfid
            elif str_:
                seq = blk.lfid
            elif stl:
                seq = blk.rfid
            else:
                seq = np.zeros(0, dtype=np.int64)
            if len(seq):
                cc = _cumcount(seq) + send_counts[seq]
                if str_ and stl:
                    rl, rr = cc[0::2], cc[1::2]
                elif str_:
                    rl = cc
                else:
                    rr = cc
                np.add.at(send_counts, seq, 1)
            self._rank_left[name] = rl
            self._rank_right[name] = rr
        self._max_send_rank = int(send_counts.max()) if n else 0

        # ---- schedule ------------------------------------------------------
        self._descs = None
        typed = [(blk.mtype.schedule, blk.lfid, blk.rfid)
                 for blk in self.msgs.values()]
        self.updated = sched.updated_mask_from_arrays(n, typed)
        # conflict adjacency: slot-disjoint message types write disjoint
        # slices of their shared factor, so factors adjacent only through
        # them may share a phase (registry.MessageType.slot_disjoint)
        self._adj_csr = sched.adjacency_csr_from_arrays(
            n, [(blk.lfid, blk.rfid) for blk in self.msgs.values()
                if not blk.mtype.slot_disjoint])
        indptr, indices = self._adj_csr

        if schedule_mode == "coloring":
            fwd_order = sched.coloring_order_csr(n, indptr, indices, self.updated)
            bwd_order = fwd_order[::-1]
        else:
            fwd_order = sched.toposort(n, graph.forward_relations)
            bwd_order = sched.toposort(n, graph.backward_relations) \
                if graph.backward_relations else fwd_order[::-1]
        self.orders = {Direction.forward: fwd_order, Direction.backward: bwd_order}

        if schedule_mode == "sequential":
            phases = {d: [[f] for f in o if self.updated[f]]
                      for d, o in self.orders.items()}
        else:
            phases = {d: sched.levelize_csr(o, n, indptr, indices, self.updated)
                      for d, o in self.orders.items()}
        self.phases = phases
        need_resend = update_mode == "residual"
        self.plans = {d: self._build_plans(phases[d], need_resend=need_resend)
                      for d in phases}
        self._dev_plans = {d: self._device_plans(p) for d, p in self.plans.items()}

        # factors outside the update schedule (no messages — FactorUpdated()
        # skip, factors_messages.hxx:3125-3140) still need a primal in
        # rounding passes: collect their rows per type
        self._unupdated_rows = {}
        for tname, fids in self._type_fids.items():
            rows = self.f_local[fids[~self.updated[fids]]]
            if len(rows):
                self._unupdated_rows[tname] = self._index(rows)

        self._weights_cache: dict = {}
        self._weights_cache_np: dict = {}   # (mode, direction) -> host weights (pull folds)
        self._pull_folds: dict = {}         # direction -> fold callable
        self._pull_w_cache: dict = {}       # (mode, direction) -> folded lane weights
        self.pull_plan_s = 0.0              # host seconds spent on the pull plans
        if pull is True:
            # explicit opt-in: validate instead of running scatter in silence
            # (pull builds shared-semantics passes from the pull_* hooks)
            if update_mode != "shared":
                raise ValueError(f"pull=True requires update_mode='shared' (got "
                                 f"{update_mode!r}: pull passes have no residual resends "
                                 f"or adaptive reweighting)")
            missing = sorted({n for d in self.plans for n in self._pull_missing(self.plans[d])})
            if missing:
                raise ValueError(f"pull=True requires pull_left/pull_right hooks on every "
                                 f"scheduled message type; {missing} have none")
        self._pass_fns = {}
        pull_ops: dict = {}
        for d in self._dev_plans:
            if pull is True:
                from .engine_pull import make_pull_pass
                t = time.perf_counter()
                self._pass_fns[d], self._pull_folds[d] = make_pull_pass(self, d, pull_ops)
                self.pull_plan_s += time.perf_counter() - t
            else:
                self._pass_fns[d] = self._make_pass(self._dev_plans[d], primal=False,
                                                    update_mode=update_mode)
        self.pull = bool(self._pull_folds)
        self._pull_ops = pull_ops if self.pull else None
        self._primal_fns = {d: self._make_pass(self._dev_plans[d], primal=True)
                            for d in self._dev_plans}
        self._restricted_fns: dict = {}
        self._partition = None          # construct_factor_partition cache
        self._overlapping = None
        self.jit = Graphs(self.device, enabled=use_jit, name="Engine")
        self.state = self.jit.adopt(self.state)
        self._graphed: dict = {}
        self._bound_fn = self.jit.jit(self._lower_bound_impl, "lower bound")
        self._evaluate_fn = self.jit.jit(self._evaluate_impl, "evaluate_primal")
        self._consistent_fn = self.jit.jit(self._consistent_all, "primal consistency")

    # ------------------------------------------------------------------
    def _index(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

    @property
    def descs(self):
        """Host MessageDesc view (lazy: only the partition passes need
        per-message objects)."""
        if self._descs is None:
            self._descs = self.graph.message_descs()
        return self._descs

    # ------------------------------------------------------------------
    def _build_plans(self, phases: Sequence[Sequence[int]],
                     need_resend: bool = False) -> list[_PhasePlan]:
        """Vectorized plan construction: per message type, the incident
        message ids of every phase come from one lexsort over
        (phase of endpoint, position within phase, message id) — the same
        (sweep-position, container-order) sequence a per-factor walk would
        produce, at array speed."""
        n = self.n_factors
        n_phases = len(phases)
        phase_of = np.full(n, -1, dtype=np.int64)
        pos_in = np.full(n, -1, dtype=np.int64)
        for p, pset in enumerate(phases):
            arr = np.asarray(pset, dtype=np.int64)
            phase_of[arr] = p
            pos_in[arr] = np.arange(len(arr))

        def per_phase_ids(fids: np.ndarray):
            """[(phase, ids)] with ids ordered by (pos in phase, msg id)."""
            ph = phase_of[fids]
            sel = np.nonzero(ph >= 0)[0]
            if not len(sel):
                return [None] * n_phases
            order = sel[np.lexsort((sel, pos_in[fids[sel]], ph[sel]))]
            phs = ph[order]
            bounds = np.searchsorted(phs, np.arange(1, n_phases))
            groups = np.split(order, bounds)
            return [g if len(g) else None for g in groups]

        # per message type, per phase: left/right incident message ids
        by_phase: dict[str, tuple] = {}
        for name, blk in self.msgs.items():
            by_phase[name] = (per_phase_ids(blk.lfid), per_phase_ids(blk.rfid))

        # per factor type, per phase: local rows (ordered by pos in phase)
        frows_by_type: dict[str, list] = {}
        for tname, fids in self._type_fids.items():
            groups = per_phase_ids(fids)
            frows_by_type[tname] = [
                None if g is None else self.f_local[fids[g]] for g in groups]

        plans = []
        for p in range(n_phases):
            rl, rr, sl, sr, pl2r, pr2l = [], [], [], [], [], []
            frows = {t: rows[p] for t, rows in frows_by_type.items()
                     if rows[p] is not None}
            resend_by_rank: dict[int, list[tuple[str, np.ndarray, bool]]] = {}
            for name, blk in self.msgs.items():
                s = blk.mtype.schedule
                left_ids, right_ids = by_phase[name][0][p], by_phase[name][1][p]
                if left_ids is not None:
                    ids = left_ids
                    if s.left_receives:
                        rl.append((name, ids))
                    if s.sends_to_right:
                        sl.append((name, ids, blk.lfid[ids]))
                        if need_resend:
                            rk = self._rank_left[name][ids]
                            for rank in np.unique(rk):
                                resend_by_rank.setdefault(int(rank), []).append(
                                    (name, ids[rk == rank], True))
                    pl2r.append((name, ids))
                if right_ids is not None:
                    ids = right_ids
                    if s.right_receives:
                        rr.append((name, ids))
                    if s.sends_to_left:
                        sr.append((name, ids, blk.rfid[ids]))
                        if need_resend:
                            rk = self._rank_right[name][ids]
                            for rank in np.unique(rk):
                                resend_by_rank.setdefault(int(rank), []).append(
                                    (name, ids[rk == rank], False))
                    pr2l.append((name, ids))
            plans.append(_PhasePlan(
                recv_left=rl, recv_right=rr, send_left=sl, send_right=sr,
                factor_rows=frows, prop_l2r=pl2r, prop_r2l=pr2l,
                resend=[resend_by_rank[k] for k in sorted(resend_by_rank)]))
        return plans

    def _device_plans(self, plans: Sequence[_PhasePlan]) -> list[_DevPlan]:
        """Upload every plan's index arrays and gathered static data once.
        Entries that share one host id array (a phase's receive, send and
        propagation over the same messages) share one ``_Sel``."""
        memo: dict[tuple[str, int], _Sel] = {}

        def sel(name: str, ids: np.ndarray, fg=None) -> _Sel:
            key = (name, id(ids))
            s = memo.get(key)
            if s is None:
                blk = self.msgs[name]
                ids_t = self._index(ids)
                s = memo[key] = _Sel(name, ids_t, blk.lidx[ids_t], blk.ridx[ids_t],
                                     _gather(blk.data, ids_t))
            if fg is not None and s.fg is None:
                s.fg = self._index(fg)
            return s

        out = []
        for plan in plans:
            out.append(_DevPlan(
                recv_left=[sel(n, i) for n, i in plan.recv_left],
                recv_right=[sel(n, i) for n, i in plan.recv_right],
                send_left=[sel(n, i, fg) for n, i, fg in plan.send_left],
                send_right=[sel(n, i, fg) for n, i, fg in plan.send_right],
                factor_rows={t: self._index(r) for t, r in plan.factor_rows.items()},
                prop_l2r=[sel(n, i) for n, i in plan.prop_l2r],
                prop_r2l=[sel(n, i) for n, i in plan.prop_r2l],
                resend=[[(sel(n, i), fl) for n, i, fl in group]
                        for group in plan.resend]))
        return out

    # ------------------------------------------------------------------
    # pull pass (scatter-free hot path; see registry pull_* contract)
    # ------------------------------------------------------------------
    def _pull_missing(self, plans: Sequence[_PhasePlan]) -> list[str]:
        """Scheduled message types without their own pull hooks."""
        missing = set()
        for plan in plans:
            for name, *_ in (*plan.recv_left, *plan.recv_right,
                             *plan.send_left, *plan.send_right):
                mt = type(self.msgs[name].mtype)
                if (mt.pull_left is MessageType.pull_left
                        or mt.pull_right is MessageType.pull_right):
                    missing.add(name)
        return sorted(missing)

    def _pull_supported(self, plans: Sequence[_PhasePlan]) -> bool:
        return not self._pull_missing(plans)

    # ------------------------------------------------------------------
    def _recv_scales(self, plans: Sequence[_DevPlan]) -> dict:
        """Per slot-disjoint message type: [M+1] receive-weight scale.

        When k messages of a slot-disjoint type receive from the SAME
        sender factor within one phase, each strips the full min-marginal
        computed from one snapshot — k simultaneous full receives drain
        k x the sender's mass and the duals diverge exponentially.  Scaling
        each by 1/k is the parallel-diffusion cure: the phase then moves
        exactly the mass one sequential receive would, split evenly across
        the ray."""
        out = {}
        for plan in plans:
            for lst, fid_attr in ((plan.recv_left, "rfid"),
                                  (plan.recv_right, "lfid")):
                for s in lst:
                    blk = self.msgs[s.name]
                    if not blk.mtype.slot_disjoint:
                        continue
                    arr = out.setdefault(s.name, np.ones(len(blk.gids) + 1))
                    ids = s.ids.cpu().numpy()
                    f = getattr(blk, fid_attr)[ids]
                    _, inv, cnt = np.unique(f, return_inverse=True,
                                            return_counts=True)
                    arr[ids] = 1.0 / cnt[inv]
        return {k: torch.as_tensor(v, device=self.device).to(self.dtype)
                for k, v in out.items()}

    def _make_pass(self, plans: list[_DevPlan], primal: bool,
                   update_mode: str = "shared", restricted: bool = False):
        msgs = self.msgs
        ftypes = self.ftypes
        recv_scale = self._recv_scales(plans)
        n_factors = self.n_factors
        device, dtype = self.device, self.dtype
        # partition/overlapping route through plain shared updates inside each
        # block pass (LP_MP.h:981-990)
        if update_mode in ("partition", "overlapping_partition") or primal:
            update_mode = "shared"

        def apply_delta(state, s: _Sel, delta, from_left: bool):
            """Zero-sum shift: sender -= delta, other side += delta."""
            mt = msgs[s.name].mtype
            ln, rn = mt.left_type.name, mt.right_type.name
            if from_left:
                state[ln] = mt.repam_left(state[ln], s.lidx, -delta, s.data)
                state[rn] = mt.repam_right(state[rn], s.ridx, delta, s.data)
            else:
                state[rn] = mt.repam_right(state[rn], s.ridx, -delta, s.data)
                state[ln] = mt.repam_left(state[ln], s.lidx, delta, s.data)
            return state

        def send_delta(state, s: _Sel, from_left: bool):
            mt = msgs[s.name].mtype
            if from_left:
                return mt.marginal_left(_gather(state[mt.left_type.name], s.lidx), s.data)
            return mt.marginal_right(_gather(state[mt.right_type.name], s.ridx), s.data)

        def run_resends(state, w, plan: _DevPlan):
            """Residual resend (send_messages_residual, factors_messages.hxx:
            2959-3007): after the shared send, each factor re-sends its
            outgoing messages in traversal order with the *cumulative* omega,
            each resend seeing the previous ones.  Rank-k messages of all
            factors run together (they touch disjoint factors within a
            phase); zero-omega messages have zero cumulative delta."""
            for group in plan.resend:
                ops = []
                for s, from_left in group:
                    wv = w[s.name]["res_left" if from_left else "res_right"][s.ids]
                    ops.append((s, _bmul(send_delta(state, s, from_left), wv), from_left))
                for s, delta, from_left in ops:
                    state = apply_delta(state, s, delta, from_left)
            return state

        def run_sends_adaptive(state, w, plan: _DevPlan):
            """Adaptive send (send_messages_with_adaptive_weights,
            factors_messages.hxx:2859-2926): measure the dual improvement of
            each outgoing message at weight 1, then reweight per factor
            omega' = 0.5*omega + 0.5*omega_sum*impr/sum(impr) and send."""
            entries = []
            for s, from_left in [(e, True) for e in plan.send_left] + \
                    [(e, False) for e in plan.send_right]:
                mt = msgs[s.name].mtype
                lft, rft = ftypes[mt.left_type.name], ftypes[mt.right_type.name]
                lsl = _gather(state[mt.left_type.name], s.lidx)
                rsl = _gather(state[mt.right_type.name], s.ridx)
                delta = (mt.marginal_left(lsl, s.data) if from_left
                         else mt.marginal_right(rsl, s.data))
                ar = torch.arange(s.ids.shape[0], device=device)
                lb0 = lft.lower_bound(lsl) + rft.lower_bound(rsl)
                sgn = 1.0 if from_left else -1.0
                l1 = mt.repam_left(lsl, ar, -sgn * delta, s.data)
                r1 = mt.repam_right(rsl, ar, sgn * delta, s.data)
                lb1 = lft.lower_bound(l1) + rft.lower_bound(r1)
                omega = w[s.name]["omega_" + ("left" if from_left else "right")][s.ids]
                impr = torch.where(omega > 0, torch.clamp(lb1 - lb0, min=0.0),
                                   torch.zeros_like(omega))
                entries.append((s, delta, omega, impr, from_left))
            if not entries:
                return state
            all_f = torch.cat([e[0].fg for e in entries])
            w_sum = torch.zeros(n_factors, dtype=dtype, device=device).index_add_(
                0, all_f, torch.cat([e[2] for e in entries]))
            i_sum = torch.zeros(n_factors, dtype=dtype, device=device).index_add_(
                0, all_f, torch.cat([e[3] for e in entries]))
            ops = []
            for s, delta, omega, impr, from_left in entries:
                denom = i_sum[s.fg]
                pos = denom > 0
                neww = torch.where(pos, 0.5 * omega + 0.5 * w_sum[s.fg] * impr
                                   / torch.where(pos, denom, torch.ones_like(denom)),
                                   omega)
                ops.append((s, _bmul(delta, neww), from_left))
            for s, delta, from_left in ops:
                state = apply_delta(state, s, delta, from_left)
            return state

        def receive_delta(state, s: _Sel, from_right: bool):
            """Min-marginal the sender pushes into a receiving factor:
            right -> left for ``recv_left`` entries, else left -> right."""
            blk = msgs[s.name]
            mt = blk.mtype
            if from_right:
                if mt.marginal_right_block is not None:
                    # batched dedup hook: one op over the sender block
                    # instead of one per gathered message row
                    return mt.marginal_right_block(
                        state[mt.right_type.name], blk.data, blk.ridx)[s.ids]
                return mt.marginal_right(_gather(state[mt.right_type.name], s.ridx), s.data)
            if mt.marginal_left_block is not None:
                return mt.marginal_left_block(
                    state[mt.left_type.name], blk.data, blk.lidx)[s.ids]
            return mt.marginal_left(_gather(state[mt.left_type.name], s.lidx), s.data)

        def run_phase(state, prim, w, plan: _DevPlan):
            # --- receives: all deltas from phase-start state, then apply ---
            ops = []
            for lst, key, from_right in ((plan.recv_left, "recv_left", True),
                                         (plan.recv_right, "recv_right", False)):
                for s in lst:
                    delta = receive_delta(state, s, from_right)
                    wv = w[s.name][key][s.ids]
                    if s.name in recv_scale:
                        wv = wv * recv_scale[s.name][s.ids]
                    # a left receive is a send from the right factor
                    ops.append((s, _bmul(delta, wv), not from_right))
            for s, delta, from_left in ops:
                state = apply_delta(state, s, delta, from_left)

            # --- primal: argmin on the post-receive reparametrization ------
            if primal:
                src = state
                if restricted:
                    # one-sided restricted receives (OneSideMessageContainer-
                    # View, factors_messages.hxx:513-566): condition a throw-
                    # away view on already-fixed sender primals; the argmin
                    # reads the view, the duals never see it (functional
                    # equivalent of the save/restore at fm.hxx:2343-2356)
                    cond = dict(state)
                    for s in plan.recv_left:
                        mt = msgs[s.name].mtype
                        sl = _gather(state[mt.right_type.name], s.ridx)
                        pr = _gather(prim[mt.right_type.name], s.ridx)
                        delta = mt.restricted_marginal_right(sl, pr, s.data)
                        cond[mt.left_type.name] = mt.repam_left(
                            cond[mt.left_type.name], s.lidx, delta, s.data)
                    for s in plan.recv_right:
                        mt = msgs[s.name].mtype
                        sl = _gather(state[mt.left_type.name], s.lidx)
                        pr = _gather(prim[mt.left_type.name], s.lidx)
                        delta = mt.restricted_marginal_left(sl, pr, s.data)
                        cond[mt.right_type.name] = mt.repam_right(
                            cond[mt.right_type.name], s.ridx, delta, s.data)
                    src = cond
                for tname, rows in plan.factor_rows.items():
                    newp = ftypes[tname].compute_primal(_gather(src[tname], rows),
                                                        _gather(prim[tname], rows))
                    prim[tname] = {k: prim[tname][k].index_put((rows,), newp[k])
                                   for k in prim[tname]}

            # --- sends: all deltas from one post-receive snapshot ----------
            if update_mode == "adaptive":
                state = run_sends_adaptive(state, w, plan)
            else:
                ops = []
                for lst, key, from_left in ((plan.send_left, "omega_left", True),
                                            (plan.send_right, "omega_right", False)):
                    for s in lst:
                        ops.append((s, _bmul(send_delta(state, s, from_left),
                                             w[s.name][key][s.ids]), from_left))
                for s, delta, from_left in ops:
                    state = apply_delta(state, s, delta, from_left)
                if update_mode == "residual":
                    state = run_resends(state, w, plan)

            # --- primal propagation through messages -----------------------
            if primal:
                for s in plan.prop_l2r:
                    mt = msgs[s.name].mtype
                    ln, rn = mt.left_type.name, mt.right_type.name
                    prim[rn] = mt.propagate_primal_l2r(prim[ln], prim[rn], s.lidx,
                                                       s.ridx, s.data)
                for s in plan.prop_r2l:
                    mt = msgs[s.name].mtype
                    ln, rn = mt.left_type.name, mt.right_type.name
                    prim[ln] = mt.propagate_primal_r2l(prim[ln], prim[rn], s.lidx,
                                                       s.ridx, s.data)
            return state, prim

        if primal:
            unupdated = self._unupdated_rows

            def run(state, prim, w):
                state = dict(state)
                prim = dict(prim)
                for plan in plans:
                    state, prim = run_phase(state, prim, w, plan)
                # message-less factors: plain local argmin
                for tname, rows in unupdated.items():
                    newp = ftypes[tname].compute_primal(_gather(state[tname], rows),
                                                        _gather(prim[tname], rows))
                    prim[tname] = {k: prim[tname][k].index_put((rows,), newp[k])
                                   for k in prim[tname]}
                return state, prim
        else:
            def run(state, w):
                state = dict(state)
                for plan in plans:
                    state, _ = run_phase(state, None, w, plan)
                return state
        return run

    # ------------------------------------------------------------------
    # weights
    # ------------------------------------------------------------------
    def _weights_to_dict(self, w: sched.Weights) -> dict:
        """Convert host Weights to the per-message-type device dict, adding
        residual cumulative weights (the running omega sum per sending factor
        in dispatcher traversal order, factors_messages.hxx:2964-3006).
        Vectorized: slots in traversal order (type order, per message left
        then right), segmented cumsum keyed by the sending factor."""
        res_left = np.zeros_like(w.omega_left)
        res_right = np.zeros_like(w.omega_right)
        slot_f, slot_w, slot_g, slot_left = [], [], [], []
        for name, blk in self.msgs.items():
            s = blk.mtype.schedule
            m = len(blk.gids)
            g = blk.gids
            if s.sends_to_right and s.sends_to_left:
                f = np.empty(2 * m, dtype=np.int64)
                f[0::2], f[1::2] = blk.lfid, blk.rfid
                ws = np.empty(2 * m)
                ws[0::2], ws[1::2] = w.omega_left[g], w.omega_right[g]
                gs = np.repeat(g, 2)
                lt = np.tile(np.array([True, False]), m)
            elif s.sends_to_right:
                f, ws, gs = blk.lfid, w.omega_left[g], g
                lt = np.ones(m, dtype=bool)
            elif s.sends_to_left:
                f, ws, gs = blk.rfid, w.omega_right[g], g
                lt = np.zeros(m, dtype=bool)
            else:
                continue
            slot_f.append(f)
            slot_w.append(ws)
            slot_g.append(gs)
            slot_left.append(lt)
        if slot_f:
            f = np.concatenate(slot_f)
            ws = np.concatenate(slot_w)
            gs = np.concatenate(slot_g)
            lt = np.concatenate(slot_left)
            active = ws > 0
            res = _segmented_cumsum(np.where(active, ws, 0.0), f)
            sel = active & lt
            res_left[gs[sel]] = res[sel]
            sel = active & ~lt
            res_right[gs[sel]] = res[sel]

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                                   device=self.device).to(self.dtype)
        out = {}
        for name, blk in self.msgs.items():
            g = blk.gids
            out[name] = {
                "omega_left": dev(w.omega_left[g]),
                "omega_right": dev(w.omega_right[g]),
                "recv_left": dev(w.recv_left[g]),
                "recv_right": dev(w.recv_right[g]),
                "res_left": dev(res_left[g]),
                "res_right": dev(res_right[g]),
            }
        return out

    def weights(self, mode: ReparametrizationMode, direction: Direction) -> dict:
        mode = ReparametrizationMode.convert(mode)
        key = (mode, direction)
        if key not in self._weights_cache:
            typed = [(blk.mtype.schedule, blk.lfid, blk.rfid, blk.gids)
                     for blk in self.msgs.values()]
            w = sched.compute_weights_arrays(
                mode, self.orders[direction], self.n_factors,
                typed, self.n_messages, self.updated)
            assert sched.omega_valid_arrays(w, self.n_factors, typed)
            self._weights_cache[key] = self._weights_to_dict(w)
            if self._pull_folds:
                # host copy for the pull pass's weight folding
                self._weights_cache_np[key] = {
                    name: {"omega_left": w.omega_left[blk.gids],
                           "omega_right": w.omega_right[blk.gids],
                           "recv_left": w.recv_left[blk.gids],
                           "recv_right": w.recv_right[blk.gids]}
                    for name, blk in self.msgs.items()}
        return self._weights_cache[key]

    def _pass_weights(self, mode, direction: Direction):
        """Argument for the direction's dual pass: the per-name weight dict,
        or for pull directions the folded per-phase/op/run lane weights
        (engine_pull.fold_weights), uploaded once per (mode, direction)."""
        if direction not in self._pull_folds:
            return self.weights(mode, direction)
        mode = ReparametrizationMode.convert(mode)
        key = (mode, direction)
        if key not in self._pull_w_cache:
            self.weights(mode, direction)
            self._pull_w_cache[key] = self._pull_folds[direction](self._weights_cache_np[key])
        return self._pull_w_cache[key]

    # ------------------------------------------------------------------
    # public API (Solver-facing, mirrors LP<FMC>)
    # ------------------------------------------------------------------
    def _pass(self, kind: str, mode, direction: Direction):
        """The captured pass of ``kind`` ("dual", "primal" or "restricted")
        for one weight mode and direction: a function of the state that
        returns (new state, primal or None)."""
        mode = ReparametrizationMode.convert(mode)
        key = (kind, mode, direction)
        g = self._graphed.get(key)
        if g is None:
            if kind == "dual":
                w = self._pass_weights(mode, direction)
                fn = self._pass_fns[direction]

                def run(state):
                    return fn(state, w), None
            else:
                w = self.weights(mode, direction)
                if kind == "restricted" and direction not in self._restricted_fns:
                    self._restricted_fns[direction] = self._make_pass(
                        self._dev_plans[direction], primal=True, restricted=True)
                fn = (self._restricted_fns if kind == "restricted" else self._primal_fns)[direction]

                def run(state):
                    return fn(state, self._init_primal(state), w)
            g = self._graphed[key] = self.jit.jit(
                run, f"{kind} pass {direction.name} {mode.name}", donate=(0,))
        return g

    def compute_forward_pass(self, mode) -> None:
        self.state, _ = self._pass("dual", mode, Direction.forward)(self.state)

    def compute_backward_pass(self, mode) -> None:
        self.state, _ = self._pass("dual", mode, Direction.backward)(self.state)

    @tracing.traced("lpmp.engine.pass")
    def compute_pass(self, mode) -> None:
        """One iteration, routed by --reparametrizationType (LP_MP.h:869-887):
        partition -> staged block passes only; overlapping_partition ->
        overlapping pass then a normal sweep; else forward + backward."""
        if self.update_mode == "partition":
            self.compute_partition_pass(self.inner_iteration)
        elif self.update_mode == "overlapping_partition":
            self.compute_overlapping_partition_pass(self.inner_iteration)
            self.compute_forward_pass(mode)
            self.compute_backward_pass(mode)
        else:
            self.compute_forward_pass(mode)
            self.compute_backward_pass(mode)

    # ------------------------------------------------------------------
    # partition passes (LP_MP.h:1716-2051)
    # ------------------------------------------------------------------
    def _subset_pass(self, order: np.ndarray):
        """One anisotropic-weighted pass over the factor subset ``order``
        (in that order): weights from ComputeAnisotropicWeights on the
        subset with out-of-set relay rules (LP_MP.h:1263-1304), phases from
        levelize."""
        n = self.n_factors
        upd = np.zeros(n, dtype=bool)
        upd[np.asarray(order)] = True
        upd &= self.updated
        w = self._weights_to_dict(sched.compute_anisotropic_weights(order, n, self.descs, upd))
        phases = sched.levelize(order, n, self.descs, upd)
        fn = self._make_pass(self._device_plans(self._build_plans(phases)),
                             primal=False)
        return self.jit.jit(lambda state: (fn(state, w), None),
                            f"sub-pass over {len(order)} factors", donate=(0,))

    def construct_factor_partition(self) -> None:
        """Union-find blocks from put_in_same_partition pairs, ordered and
        internally sorted by the forward order (LP_MP.h:1716-1842), plus
        per-block and block->block push passes."""
        if self._partition is not None:
            return
        n = self.n_factors
        parent = list(range(n))

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for a, b in self.graph.partition_pairs:
            parent[find(a)] = find(b)
        fwd = list(self.orders[Direction.forward])
        pos = np.empty(n, dtype=np.int64)
        pos[np.asarray(fwd)] = np.arange(n)
        groups: dict[int, list[int]] = {}
        for f in range(n):
            if self.updated[f]:
                groups.setdefault(find(f), []).append(f)
        blocks = sorted((sorted(g, key=lambda f: pos[f]) for g in groups.values()),
                        key=lambda g: pos[g[0]])
        self._partition = [np.asarray(b) for b in blocks]

        def concat(*parts):
            return np.asarray([f for p in parts for f in p])

        self._block_fwd, self._block_bwd = [], []
        for b in blocks:
            self._block_fwd.append(self._subset_pass(np.asarray(b)))
            self._block_bwd.append(self._subset_pass(np.asarray(b)[::-1]))
        # push passes over concat(block_i, reversed block_{i+1}) / mirror
        # (LP_MP.h:1824-1842)
        self._push_fwd, self._push_bwd = [], []
        for i in range(len(blocks) - 1):
            self._push_fwd.append(
                self._subset_pass(concat(blocks[i], blocks[i + 1][::-1])))
        for ri in range(len(blocks) - 1):
            i = len(blocks) - ri - 1
            self._push_bwd.append(
                self._subset_pass(concat(blocks[i], blocks[i - 1][::-1])))

    def construct_overlapping_factor_partition(self) -> None:
        """Per consecutive block pair, forward/backward passes over the
        concatenated overlap (LP_MP.h:1845-1863)."""
        self.construct_factor_partition()
        if self._overlapping is not None:
            return
        blocks = self._partition
        ov_f, ov_b = [], []
        for i in range(len(blocks) - 1):
            a, b = list(blocks[i]), list(blocks[i + 1])
            ov_f.append(self._subset_pass(np.asarray(a + b[::-1])))
            ov_b.append(self._subset_pass(np.asarray(b + a[::-1])))
        self._overlapping = (ov_f, ov_b)

    def _run_subset(self, sub_pass) -> None:
        self.state, _ = sub_pass(self.state)

    def compute_partition_pass(self, no_passes: int) -> None:
        """Staged block optimization (compute_partition_pass,
        LP_MP.h:1931-1963): per block, no_passes forward+backward rounds,
        then push all messages into the next block; then mirror backward."""
        self.construct_factor_partition()
        nb = len(self._partition)
        for i in range(nb):
            for _ in range(no_passes):
                self._run_subset(self._block_fwd[i])
                self._run_subset(self._block_bwd[i])
            if i < nb - 1:
                self._run_subset(self._push_fwd[i])
        for ri in range(nb):
            i = nb - ri - 1
            for _ in range(no_passes):
                self._run_subset(self._block_fwd[i])
                self._run_subset(self._block_bwd[i])
            if i != 0:
                self._run_subset(self._push_bwd[ri])

    def compute_overlapping_partition_pass(self, no_passes: int) -> None:
        """Overlapping variant (compute_overlapping_partition_pass,
        LP_MP.h:1965-2051)."""
        self.construct_overlapping_factor_partition()
        ov_f, ov_b = self._overlapping
        for i in range(len(ov_f)):
            for _ in range(no_passes):
                self._run_subset(ov_f[i])
                self._run_subset(ov_b[i])
            self._run_subset(ov_f[i])
        for ri in range(len(ov_f)):
            i = len(ov_f) - ri - 1
            for _ in range(no_passes):
                self._run_subset(ov_b[i])
                self._run_subset(ov_f[i])
            self._run_subset(ov_b[i])

    # ------------------------------------------------------------------
    # primal
    # ------------------------------------------------------------------
    def _init_primal(self, state: dict) -> dict:
        return {name: self.ftypes[name].init_primal(block) for name, block in state.items()}

    def init_primal(self) -> dict:
        return self._init_primal(self.state)

    @tracing.traced("lpmp.engine.primal_pass")
    def compute_pass_and_primal(self, mode, direction: Direction,
                                restricted: bool = False) -> dict:
        """Rounding pass: fresh primal, interleaved with the sweep
        (LP_MP.h:913-940; the reference's timestamp lazy-init is a fresh
        init per pass).  ``restricted=True`` conditions each factor's argmin
        on one-sided restricted messages from already-fixed neighbors
        (factors_messages.hxx:513-566 rounding semantics); the dual sweep is
        unchanged either way."""
        kind = "restricted" if restricted else "primal"
        self.state, prim = self._pass(kind, mode, direction)(self.state)
        return prim

    def _lower_bound_impl(self, state: dict) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for name, block in state.items():
            total = total + torch.sum(self.ftypes[name].lower_bound(block),
                                      dtype=torch.float64)
        return total

    @tracing.traced("lpmp.engine.lower_bound")
    def lower_bound(self) -> float:
        """Sum of the per-factor bounds, accumulated in float64."""
        return tracing.fetch("engine.lower_bound", self._bound_fn(self.state)) + self.constant

    def _consistent_all(self, prim: dict) -> torch.Tensor:
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        for blk in self.msgs.values():
            mt = blk.mtype
            c = mt.consistent(prim[mt.left_type.name], prim[mt.right_type.name],
                              blk.lidx, blk.ridx, blk.data)
            ok = ok & torch.all(c)
        return ok

    def _evaluate_impl(self, state: dict, prim: dict) -> tuple:
        cost = torch.zeros((), dtype=torch.float64, device=self.device)
        for name, block in state.items():
            cost = cost + torch.sum(self.ftypes[name].evaluate_primal(block, prim[name]),
                                    dtype=torch.float64)
        return cost, self._consistent_all(prim)

    @tracing.traced("lpmp.engine.evaluate_primal")
    def evaluate_primal(self, prim: dict) -> float:
        cost, ok = self._evaluate_fn(self.state, prim)
        if not tracing.fetch("engine.evaluate_primal.ok", ok, bool):
            return float("inf")
        return tracing.fetch("engine.evaluate_primal.cost", cost) + self.constant

    def check_primal_consistency(self, prim: dict) -> bool:
        return tracing.fetch("engine.check_primal_consistency", self._consistent_fn(prim), bool)

    # ------------------------------------------------------------------
    # inconsistent-region extraction (LP_MP.h:1638-1684)
    # ------------------------------------------------------------------
    def per_factor_lower_bound(self) -> np.ndarray:
        """[n_factors] local lower bounds, global factor order."""
        out = np.zeros(self.n_factors)
        for name, block in self.state.items():
            out[self._type_fids[name]] = \
                self.ftypes[name].lower_bound(block).double().cpu().numpy()
        return out

    def per_factor_primal_cost(self, prim: dict) -> np.ndarray:
        """[n_factors] EvaluatePrimal per factor."""
        out = np.zeros(self.n_factors)
        for name, block in self.state.items():
            out[self._type_fids[name]] = \
                self.ftypes[name].evaluate_primal(block, prim[name]).double().cpu().numpy()
        return out

    def get_inconsistent_mask(self, prim: dict,
                              no_fatten_rounds: int = 1) -> np.ndarray:
        """[n_factors] bool: factors whose local bound is below their primal
        cost or that sit on a violated message, fattened ``no_fatten_rounds``
        times over message adjacency (get_inconsistent_mask,
        LP_MP.h:1638-1684)."""
        eps = eps_for(self.dtype)
        mask = self.per_factor_lower_bound() < self.per_factor_primal_cost(prim) - eps
        lf, rf = [], []
        for blk in self.msgs.values():
            mt = blk.mtype
            ok = mt.consistent(prim[mt.left_type.name], prim[mt.right_type.name],
                               blk.lidx, blk.ridx, blk.data).cpu().numpy()
            l, r = blk.lfid, blk.rfid
            mask[l[~ok]] = True
            mask[r[~ok]] = True
            lf.append(l)
            rf.append(r)
        if lf:
            lf = np.concatenate(lf)
            rf = np.concatenate(rf)
            for _ in range(no_fatten_rounds):
                hit = mask[lf] | mask[rf]
                mask[lf[hit]] = True
                mask[rf[hit]] = True
        return mask

    # snapshots (serialization.hxx analogue)
    def get_state(self) -> dict:
        """A copy of the dual state: {factor type: {key: tensor}}."""
        return {name: {k: v.clone() for k, v in block.items()}
                for name, block in self.state.items()}

    @tracing.traced("lpmp.engine.set_state")
    def set_state(self, state: dict) -> None:
        """Install ``state``: under ``use_jit`` copied into the state buffers
        where shapes and dtypes match, so the captured passes keep reading
        them; otherwise (and without ``use_jit``) taken as it is."""
        self.state = self.jit.assign(self.state, {name: dict(block)
                                                  for name, block in state.items()})
