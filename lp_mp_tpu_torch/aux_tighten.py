"""Incremental tightening: bucketed auxiliary triplet passes (counterpart of
``lp_mp_tpu/aux_tighten.py``).

The reference mutates its LP in place when tightening adds triplet factors
(Solver::Tighten, solver.hxx:192-212).  This module absorbs the common
tightening shape — ternary simplex factors coupled to *existing* dense
pairwise factors (MrfConstructor.add_tightening_triplet), or multicut
triplets on existing edges — into a side pass over the engine's pairwise
(or edge) block, run after every engine pass; anything else (new chord
factors, other factor types) falls back to a full engine rebuild, after
which the absorbed rows are folded into the rebuilt engine.

The pass itself is one MPLP-style block-coordinate step per iteration:
each triplet receives the full reparametrized matrices of its three
pairwise factors (split 1/k between the k triplets that share one) and
returns the three min-marginals with weight 1/3 — the same fixed point as
the integrated schedule (the triplet cluster update of
cycle_inequalities.hxx / Sontag et al.), run after the engine's sweep.

Eager torch never re-jits, yet the JAX package's buckets stay: capacity
doubles from 8 as triplets come, inactive rows carry weight 0, point at
pairwise row 0 and hold ``PAD_COST`` duals, and ``add`` only stages rows on
the host (``_pending``) until the next pass, bound or fold (``_sync``), so
a tighten round moves nothing to the device.  The absorbed state (``c``,
``lidx``, ``active``, ``w_recv`` at capacity ``cap``) thus has the JAX
shapes and carries across through ``convert.aux_state_{from,to}_numpy``.
Row indices are int64 (the index type of ``index_add``); every scatter
into the pairwise or edge block goes through the messages' ``repam_left``,
an out-of-place ``index_add``, because triplets share pairwise rows.

With ``use_jit`` (the default, as in the JAX package) the update, the bound
and the primal evaluation run through ``capture.Graphs`` on the engine's
device: captured once per capacity as CUDA graphs on the card, direct calls
with the same buffer logic on the CPU.  The absorbed state (``c``,
``lidx``, ``active``, ``w_recv``) then lives in the graphs' buffers, which
``_sync`` writes in place; growing the capacity or resetting the pass drops
the graphs.  The sender block arrives from the engine and goes back to it
as this pass's buffer, which the engine's next captured pass copies into its
own.
"""
from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .capture import Graphs
from .config import PAD_COST
from .factors.multicut import MULTICUT_EDGE, MULTICUT_TRIPLET
from .factors.simplex import PAIRWISE_SIMPLEX, TERNARY_SIMPLEX
from .messages.multicut import (MULTICUT_EDGE_TRIPLET_0, MULTICUT_EDGE_TRIPLET_1,
                                MULTICUT_EDGE_TRIPLET_2)
from .messages.pairwise_triplet import (PAIRWISE_TRIPLET_12, PAIRWISE_TRIPLET_13,
                                        PAIRWISE_TRIPLET_23)

_SLOTS = (PAIRWISE_TRIPLET_12, PAIRWISE_TRIPLET_13, PAIRWISE_TRIPLET_23)
_MC_SLOTS = (MULTICUT_EDGE_TRIPLET_0, MULTICUT_EDGE_TRIPLET_1, MULTICUT_EDGE_TRIPLET_2)
_MIN_CAP = 8


def _cluster_update(slots, pw_c, c, lidx, active, w_recv):
    """One triplet cluster update over the sender block ``pw_c``: receive
    its rows (split by ``w_recv``), send back 1/3 min-marginals from one
    post-receive snapshot.  Inactive rows carry weight 0 and point at row 0
    — a no-op lane.  Returns the new (pw_c, c); the inputs stay intact."""
    ridx = torch.arange(c.shape[0], device=c.device)

    def times(d, v):
        """[cap, ...] delta times a per-row weight [cap]."""
        return d * v.reshape((-1,) + (1,) * (d.ndim - 1))

    # receives: deltas from the pre-update sender state
    deltas = [times(mt.marginal_left({"c": pw_c[lidx[s]]}, {}), w_recv[s])
              for s, mt in enumerate(slots)]
    for s, mt in enumerate(slots):
        pw_c = mt.repam_left({"c": pw_c}, lidx[s], -deltas[s], {})["c"]
        c = mt.repam_right({"c": c}, ridx, deltas[s], {})["c"]
    # sends: 1/3 of each min-marginal, from one post-receive snapshot
    snap = c
    for s, mt in enumerate(slots):
        d = times(mt.marginal_right({"c": snap}, {}), active / 3.0)
        c = mt.repam_right({"c": c}, ridx, -d, {})["c"]
        pw_c = mt.repam_left({"c": pw_c}, lidx[s], d, {})["c"]
    return pw_c, c


def _recv_weights(lidx_host, cap, dtype, device):
    """[3, cap] receive weight 1/k per message, k = #triplet slots pulling
    from the same sender row: the batched receive splits the marginal
    evenly, draining the sender exactly once (monotone: min is
    superadditive)."""
    li = np.asarray(lidx_host, dtype=np.int64).reshape(-1, 3).T   # [3, n]
    cnt = np.bincount(li.reshape(-1), minlength=int(li.max(initial=0)) + 1)
    w = np.zeros((3, cap))
    w[:, :li.shape[1]] = 1.0 / cnt[li]
    return torch.as_tensor(w, device=device).to(dtype)


def _triplet_primal_cost(ftype, slots, c, lidx, active, sender_prim, check):
    """Cost of the absorbed triplets under a primal propagated from their
    senders, as a float64 device scalar; +inf if ``check`` and an active
    triplet is inconsistent."""
    tp = ftype.init_primal({"c": c})
    ridx = torch.arange(c.shape[0], device=c.device)
    for s, mt in enumerate(slots):
        tp = mt.propagate_primal_l2r(sender_prim, tp, lidx[s], ridx, {})
    act = active > 0
    val = ftype.evaluate_primal({"c": c}, tp)
    total = torch.sum(torch.where(act, val, torch.zeros_like(val)), dtype=torch.float64)
    ok = torch.isfinite(total)
    if check:
        for s, mt in enumerate(slots):
            ok = ok & torch.all(mt.consistent(sender_prim, tp, lidx[s], ridx, {}) | ~act)
    return torch.where(ok, total, torch.full_like(total, float("inf")))


def _bound(c, active):
    lb = torch.clamp(torch.amin(c, dim=tuple(range(1, c.ndim))), max=0.0)
    return torch.sum(lb * active, dtype=torch.float64)


class _AuxPass:
    """Bucket protocol shared by the MRF and multicut passes: host staging
    of added rows, capacity doubling, receive weights, bound."""

    ftype = None        # the absorbed triplets' factor type
    sender = None       # the factor type of the block they hang on
    slots = ()
    _fill = 0.0         # duals of rows not yet active

    def __init__(self, use_jit: bool = True):
        self.use_jit = use_jit
        self._jit = None            # Graphs on the engine's device, made at first use
        self.cap = 0
        self.n = 0
        self.c = None               # [cap, ...] triplet duals
        self.lidx = None            # [3, cap] sender rows (0 on inactive)
        self.active = None          # [cap] float mask
        self.w_recv = None          # [3, cap] receive weights (1/#sharers)
        self.fids: list[int] = []   # graph factor ids of absorbed triplets
        self._device = None
        self._dtype = None
        # host staging: add() touches no device tensor; _sync() writes all
        # pending rows (the last len(_pending) of _lidx_host) in one update
        self._pending: list = []
        self._lidx_host: list[tuple[int, int, int]] = []

    def __bool__(self):
        return self.n > 0

    def _stage(self, engine, fid: int, item, rows) -> None:
        if self._device is None:
            self._device, self._dtype = engine.device, engine.dtype
        self._pending.append(item)
        self._lidx_host.append(tuple(int(r) for r in rows))
        self.fids.append(fid)
        self.n += 1

    def _row_shape(self) -> tuple:
        raise NotImplementedError

    def _pending_rows(self) -> "np.ndarray | None":
        """[P, ...] cost rows of the pending triplets (None: keep the
        bucket's fill)."""
        return None

    def _primal_cost(self, c, lidx, active, sender_prim):
        raise NotImplementedError

    def _graphs(self) -> None:
        """Make the captured update, bound and evaluation on first use, on
        the device of the engine the pass absorbed from."""
        if self._jit is not None:
            return
        jit = self._jit = Graphs(self._device, enabled=self.use_jit,
                                 name=f"aux {self.ftype.name}")
        slots = self.slots

        def update(pw_c, c, lidx, active, w_recv):
            return (*_cluster_update(slots, pw_c, c, lidx, active, w_recv),
                    lidx, active, w_recv, None)
        self._update_fn = jit.jit(update, "cluster update", donate=(0, 1, 2, 3, 4))
        self._bound_fn = jit.jit(_bound, "lower bound")
        self._cost_fn = jit.jit(self._primal_cost, "evaluate_primal")

    def graph_stats(self) -> dict:
        return self._jit.stats() if self._jit is not None else {"captures": 0, "capture_s": 0.0}

    def _grow(self, new_cap: int) -> None:
        if self._jit is not None:
            self._jit.reset()   # every shape changes: the graphs of the old ones go
        kw = dict(device=self._device, dtype=self._dtype)
        c = torch.full((new_cap,) + self._row_shape(), self._fill, **kw)
        lidx = torch.zeros((3, new_cap), dtype=torch.int64, device=self._device)
        active = torch.zeros(new_cap, **kw)
        if self.cap:
            c[:self.cap] = self.c
            lidx[:, :self.cap] = self.lidx
            active[:self.cap] = self.active
        self.c, self.lidx, self.active, self.cap = c, lidx, active, new_cap

    def _sync(self) -> None:
        """Write staged rows into the device tensors (one batched update)
        and refresh the receive weights."""
        if not self._pending:
            return
        if self.n > self.cap:
            new_cap = max(_MIN_CAP, self.cap)
            while new_cap < self.n:
                new_cap *= 2
            self._grow(new_cap)
        n0 = self.n - len(self._pending)
        blocks = self._pending_rows()
        if blocks is not None:
            self.c[n0:self.n] = torch.as_tensor(blocks, device=self._device).to(self._dtype)
        rows = np.asarray(self._lidx_host[n0:], dtype=np.int64).T           # [3, P]
        self.lidx[:, n0:self.n] = torch.as_tensor(rows, device=self._device)
        self.active[n0:self.n] = 1.0
        self._pending = []
        self.w_recv = _recv_weights(self._lidx_host, self.cap, self._dtype, self._device)

    def run(self, engine) -> None:
        if not self.n:
            return
        self._sync()
        self._graphs()
        blk = engine.state[self.sender.name]
        new_c, self.c, self.lidx, self.active, self.w_recv, _ = self._update_fn(
            blk["c"], self.c, self.lidx, self.active, self.w_recv)
        engine.state[self.sender.name] = {**blk, "c": new_c}

    def lower_bound(self) -> float:
        if not self.n:
            return 0.0
        self._sync()
        self._graphs()
        return tracing.fetch("aux.lower_bound", self._bound_fn(self.c, self.active))

    def evaluate_primal(self, engine, prim) -> float:
        """The absorbed triplets' cost under a primal propagated from the
        sender labels, +inf where a check fails (``_primal_cost``)."""
        if not self.n:
            return 0.0
        self._sync()
        self._graphs()
        return tracing.fetch("aux.evaluate_primal",
                             self._cost_fn(self.c, self.lidx, self.active, prim[self.sender.name]))

    def _reset(self) -> None:
        if self._jit is not None:
            self._jit.reset()
        self.cap = self.n = 0
        self.c = self.lidx = self.active = self.w_recv = None
        self.fids = []
        self._pending = []
        self._lidx_host = []
        self._device = self._dtype = None

    def fold_into(self, engine) -> None:
        """After a full rebuild, write absorbed triplet duals into the
        engine's triplet block and reset this pass."""
        if not self.n:
            return
        self._sync()
        name = self.ftype.name
        block = dict(engine.state[name])
        rows = torch.as_tensor(engine.f_local[np.asarray(self.fids)], device=engine.device)
        tgt = block["c"]
        src = self.c[:self.n].to(tgt.dtype)
        if src.shape[1:] != tgt.shape[1:]:
            sl = (slice(None),) + tuple(slice(0, min(a, b))
                                        for a, b in zip(src.shape[1:], tgt.shape[1:]))
            sub = tgt[rows]
            sub[sl] = src[sl]
            src = sub
        block["c"] = tgt.index_put((rows,), src)
        engine.state[name] = block
        self._reset()


class AuxTripletPass(_AuxPass):
    """Side block of tightening triplets over an engine's pairwise block."""

    ftype = TERNARY_SIMPLEX
    sender = PAIRWISE_SIMPLEX
    slots = _SLOTS
    _fill = PAD_COST

    def __init__(self, use_jit: bool = True):
        super().__init__(use_jit)
        self._dims = None

    def add(self, engine, fid: int, data: np.ndarray,
            pairwise_rows: tuple[int, int, int]) -> None:
        """Absorb one ternary factor with its three pairwise endpoints
        (rows into the engine's dense pairwise block, slot order 12/13/23).
        Host-side staging only; the device tensors update on next use."""
        dims = tuple(data.shape)
        if self._dims is None:
            # label capacity = the engine's padded pairwise width (chords of
            # bigger label counts would not be absorbable anyway)
            Lp = tuple(engine.state[PAIRWISE_SIMPLEX.name]["c"].shape[1:])
            self._dims = (max(dims[0], Lp[0]), max(dims[1], Lp[1]),
                          max(dims[2], Lp[0], Lp[1]))
        assert all(d <= dc for d, dc in zip(dims, self._dims))
        block = np.full(self._dims, PAD_COST)
        block[:dims[0], :dims[1], :dims[2]] = data
        self._stage(engine, fid, block, pairwise_rows)

    def _row_shape(self):
        return self._dims

    def _pending_rows(self):
        return np.stack(self._pending)

    def _reset(self):
        super()._reset()
        self._dims = None

    def _primal_cost(self, c, lidx, active, sender_prim):
        """Triplet primal by propagation from the pairwise labels: the
        triplets' cost, +inf if any active triplet is inconsistent."""
        return _triplet_primal_cost(TERNARY_SIMPLEX, _SLOTS, c, lidx, active, sender_prim,
                                    check=True)


def absorbable(graph, engine, n0: int, m0: int) -> "list | None":
    """If every factor/message added past (n0, m0) is a ternary simplex
    coupled to EXISTING dense pairwise factors, return the absorption list
    [(fid, data, (row12, row13, row23))]; else None (full rebuild)."""
    new_f = list(range(n0, graph.n_factors))
    if not new_f:
        return None
    for fid in new_f:
        if graph.factors[fid][0] is not TERNARY_SIMPLEX:
            return None
    slots_of: dict[int, dict[int, int]] = {fid: {} for fid in new_f}
    slot_id = {m.name: s for s, m in enumerate(_SLOTS)}
    for mt, l, r, _ in graph.messages[m0:]:
        if mt.name not in slot_id or r not in slots_of or l >= len(engine.f_local):
            return None
        if graph.factors[l][0] is not PAIRWISE_SIMPLEX:
            return None
        slots_of[r][slot_id[mt.name]] = int(engine.f_local[l])
    out = []
    for fid in new_f:
        if sorted(slots_of[fid]) != [0, 1, 2]:
            return None
        _, data = graph.factors[fid]
        out.append((fid, np.asarray(data, dtype=np.float64),
                    tuple(slots_of[fid][s] for s in range(3))))
    return out


class AuxMulticutTripletPass(_AuxPass):
    """Multicut twin of AuxTripletPass: tightening triplet factors over an
    engine's multicut EDGE block, absorbed without an engine rebuild when a
    separation round adds only triplets on existing edges (on triangulated
    graphs every round after the chords exist).  Same bucket protocol and
    update semantics: receive the three edge costs (split 1/k between
    triplets sharing an edge), send back 1/3 min-marginals from one
    snapshot.  New triplets start at zero cost."""

    ftype = MULTICUT_TRIPLET
    sender = MULTICUT_EDGE
    slots = _MC_SLOTS

    def add(self, engine, fid: int, edge_rows) -> None:
        self._stage(engine, fid, None, edge_rows)

    def _row_shape(self):
        return (4,)

    def _primal_cost(self, c, lidx, active, sender_prim):
        """Propagated bits always match the edges, so consistency holds by
        construction; masked inactive rows contribute zero."""
        return _triplet_primal_cost(MULTICUT_TRIPLET, _MC_SLOTS, c, lidx, active, sender_prim,
                                    check=False)


def absorbable_multicut(graph, engine, n0: int, m0: int) -> "list | None":
    """If every factor/message added past (n0, m0) is a multicut triplet
    coupled to EXISTING edge factors, return [(fid, (row0, row1, row2))];
    else None (full rebuild).  Counterpart of ``absorbable`` for the
    multicut FMC."""
    slot_id = {m.name: s for s, m in enumerate(_MC_SLOTS)}
    new_f = list(range(n0, graph.n_factors))
    if not new_f:
        return None
    for fid in new_f:
        if graph.factors[fid][0] is not MULTICUT_TRIPLET:
            return None
    slots_of: dict[int, dict[int, int]] = {fid: {} for fid in new_f}
    for mt, l, r, _ in graph.messages[m0:]:
        if mt.name not in slot_id or r not in slots_of or l >= len(engine.f_local):
            return None
        if graph.factors[l][0] is not MULTICUT_EDGE:
            return None
        slots_of[r][slot_id[mt.name]] = int(engine.f_local[l])
    out = []
    for fid in new_f:
        if sorted(slots_of[fid]) != [0, 1, 2]:
            return None
        out.append((fid, tuple(slots_of[fid][s] for s in range(3))))
    return out


class AuxPasses:
    """Composite of the per-FMC absorb passes the Solver holds: routes a
    tightening round's additions to whichever pass can absorb them (MRF
    ternary triplets or multicut triplets), and fans the per-iteration
    run/bound/primal hooks to every active pass."""

    def __init__(self, use_jit: bool = True):
        self.mrf = AuxTripletPass(use_jit)
        self.mc = AuxMulticutTripletPass(use_jit)

    def __bool__(self):
        return bool(self.mrf) or bool(self.mc)

    @property
    def n(self) -> int:
        """Total absorbed factors across passes."""
        return self.mrf.n + self.mc.n

    def absorb(self, graph, engine, n0: int, m0: int) -> bool:
        items = absorbable(graph, engine, n0, m0)
        if items is not None:
            for fid, data, rows in items:
                self.mrf.add(engine, fid, data, rows)
            return True
        mitems = absorbable_multicut(graph, engine, n0, m0)
        if mitems is not None:
            for fid, rows in mitems:
                self.mc.add(engine, fid, rows)
            return True
        return False

    def run(self, engine) -> None:
        self.mrf.run(engine)
        self.mc.run(engine)

    def lower_bound(self) -> float:
        return self.mrf.lower_bound() + self.mc.lower_bound()

    def evaluate_primal(self, engine, prim) -> float:
        return (self.mrf.evaluate_primal(engine, prim)
                + self.mc.evaluate_primal(engine, prim))

    def fold_into(self, engine) -> None:
        self.mrf.fold_into(engine)
        self.mc.fold_into(engine)

    def graph_stats(self) -> dict:
        """Captures and capture seconds of both passes' graphs."""
        a, b = self.mrf.graph_stats(), self.mc.graph_stats()
        return {"captures": a["captures"] + b["captures"],
                "capture_s": a["capture_s"] + b["capture_s"]}
