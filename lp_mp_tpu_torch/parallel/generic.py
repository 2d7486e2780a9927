"""Sharded generic engine (counterpart of ``lp_mp_tpu/parallel/generic.py``).

The single-device phase schedule of ``Engine`` run over a list of devices,
one per shard, with the deltas that cross shard boundaries summed once per
group of updates: the reference's partition pass with push weights
(LP_MP.h:1791-1821, :1931-2051) made collective.  As in the port's
``parallel/grid.py``, one process holds the list; devices may repeat (for
example ``["cuda:0"] * 4`` or ``["cpu"] * 8``).

Design (exact, not approximate):

- every factor row gets an *owner* shard and each shard stores the rows it
  owns, in exact, unpadded blocks: no index tensor ever points past a block;
- every message op (a receive or a send of one message in one phase) runs
  on the shard that owns its *sender* row, so its min-marginal reads only
  local rows;
- the sender's ``-delta`` is always local; the receiver's ``+delta`` goes
  into the local block (receiver owned here) or into the receiver type's
  ``[C_t, ...]`` cut buffer; the shards' cut buffers are summed on the
  first shard's device and copied back, and each owner adds its own slots.
  Every repam is an additive scatter (the zero-sum contract,
  factors_messages.hxx:425-510), so the sum is exact up to float order;
- within a phase the receives come before the sends and each group's deltas
  come from one snapshot, exactly as in ``Engine``'s pass, and receives of
  slot-disjoint types carry ``Engine``'s 1/k receive scales: the sharded
  engine takes the same block-coordinate steps as ``Engine`` on every
  message type;
- primal propagation runs on the *receiver*'s owner; the cut source-primal
  rows are gathered from their owners on the first device and copied to
  every shard before each propagation group.

As in the JAX package, the shards run the default update mode: no residual
or adaptive resend sub-rounds.  On CUDA, ``index_add`` sums duplicate
indices in an unfixed order, so results on the card agree within a
tolerance; on the CPU they agree with ``Engine`` to float rounding.

With ``use_jit`` (the default, as in the JAX package) the dual pass, the
rounding pass and the bound run through ``capture.Graphs``: when every shard
sits on one CUDA device, each is one CUDA graph over all shards, the
cross-shard ``.to`` calls are no-ops and the consensus is a sum inside the
graph; on the CPU the same buffer logic runs around direct calls.  Shards on
several CUDA devices run eagerly: one graph holds the work of one device,
and capturing per device with the copies between them is not done yet.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import schedule as sched
from ..capture import Graphs
from ..config import Direction, ReparametrizationMode, entry_device, real_dtype
from ..engine import Engine, _bmul, _gather, _take_rows

# op kind -> (sender side, weight key)
_KINDS = {"rl": ("right", "recv_left"),
          "rr": ("left", "recv_right"),
          "sl": ("left", "omega_left"),
          "sr": ("right", "omega_right")}


@dataclasses.dataclass
class _Recv:
    """The receivers of one op on its shard that sit in one place: the
    local block (``idx`` = local rows) or the cut buffer (``idx`` = slots).
    ``pos`` picks them out of the op's messages (None: all of them)."""

    pos: "torch.Tensor | None"
    idx: torch.Tensor
    data: dict


@dataclasses.dataclass
class _DualOp:
    """One receive or send of one message type on one shard."""

    i: int                  # position in the direction's weight list
    kind: str               # rl, rr, sl, sr
    name: str
    shard: int
    st: str                 # sender factor type
    rt: str                 # receiver factor type
    mid: np.ndarray         # message ids (host), for the weights
    srow: torch.Tensor      # sender rows, local
    data: dict
    loc: "_Recv | None"
    cut: "_Recv | None"


@dataclasses.dataclass
class _PropOp:
    """One primal propagation of one message type on the receiver's shard."""

    name: str
    shard: int
    st: str                 # source factor type
    rt: str                 # receiving factor type
    src: torch.Tensor       # source rows: local, or F_loc + cut slot
    dst: torch.Tensor       # receiving rows, local
    data: dict
    needs_cut: bool


@dataclasses.dataclass
class _Phase:
    recv: list
    frows: list             # (shard, factor type, local rows)
    send: list
    prop: list              # (l2r, [_PropOp], source types with cut rows)


class ShardedEngine:
    """Engine-compatible facade running ``Engine``'s passes over shards."""

    def __init__(self, graph, devices: "Sequence | None" = None,
                 schedule_mode: str = "coloring", owner: "np.ndarray | None" = None,
                 dtype: "torch.dtype | None" = None, use_jit: bool = True):
        """``devices``: one per shard; by default every CUDA device, one
        shard each.  Pass ``devices=["cpu"] * n`` to run on the CPU."""
        if devices is None:
            entry_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        self.devices = [entry_device(d) for d in devices]
        self.n = n_sh = len(self.devices)
        if n_sh < 1:
            raise ValueError("ShardedEngine needs at least one device")
        self.dev0 = self.devices[0]
        self.dtype = dtype or real_dtype(self.dev0)
        # the unsharded oracle on the first device: schedule, plans, weights,
        # blocks, and the primal evaluation over the merged state
        base = self.base = Engine(graph, schedule_mode=schedule_mode, device=self.dev0,
                                  dtype=self.dtype, use_jit=use_jit)
        self.jit = Graphs(self.dev0, enabled=use_jit and len(set(self.devices)) == 1,
                          name="ShardedEngine")
        self._graphed: dict = {}
        self._local = None
        self.graph = graph
        self.constant = base.constant
        self.ftypes = base.ftypes
        self.msgs = base.msgs
        n = base.n_factors

        # ---- ownership: balanced contiguous chunks of the LOCALITY order
        # (construct_factor_partition contiguity, LP_MP.h:1716-1842), not of
        # the schedule order: the coloring order groups factors by colour,
        # so its chunks would put every red-black edge on the cut.  The
        # relation toposort follows the model's construction geometry
        # (row-major for grids), giving boundary-only cuts.
        if owner is None:
            order = np.asarray(sched.toposort(n, graph.forward_relations), dtype=np.int64)
            owner = np.zeros(n, dtype=np.int64)
            for d, ch in enumerate(np.array_split(order, n_sh)):
                owner[ch] = d
            rest = np.setdiff1d(np.arange(n), order)
            owner[rest] = rest % n_sh
        self.owner = np.asarray(owner, dtype=np.int64)
        if self.owner.shape != (n,) or (n and not 0 <= self.owner.min() <= self.owner.max() < n_sh):
            raise ValueError(f"owner must hold one shard in [0, {n_sh}) per factor")

        # per type: shard and shard-local row of each type-local row
        self.row_dev: dict[str, np.ndarray] = {}
        self.row_loc: dict[str, np.ndarray] = {}
        self._perm: dict[str, list[np.ndarray]] = {}    # shard -> type-local rows
        for t, fids in base._type_fids.items():
            dev = self.owner[fids]
            loc = np.zeros(len(fids), dtype=np.int64)
            perm = []
            for d in range(n_sh):
                rows = np.nonzero(dev == d)[0]
                loc[rows] = np.arange(len(rows))
                perm.append(rows)
            self.row_dev[t], self.row_loc[t], self._perm[t] = dev, loc, perm
        self.n_rows = [{t: len(p[d]) for t, p in self._perm.items()} for d in range(n_sh)]
        self._perm_dev0 = {t: [self._idx(p, self.dev0) for p in perm]
                           for t, perm in self._perm.items()}
        # host rows of each message's endpoints, type-local
        self._lrow = {nm: base.f_local[blk.lfid] for nm, blk in self.msgs.items()}
        self._rrow = {nm: base.f_local[blk.rfid] for nm, blk in self.msgs.items()}

        self.set_state(base.state)

        # factors outside the update schedule (FactorUpdated skip): their
        # rows per shard, for the rounding pass
        self._unupd = []
        for t, fids in base._type_fids.items():
            sub = fids[~base.updated[fids]]
            rows = base.f_local[sub]
            for d in range(n_sh):
                r = self.row_loc[t][rows[self.owner[sub] == d]]
                if len(r):
                    self._unupd.append((d, t, self._idx(r, self.devices[d])))

        self._find_cut_rows()
        self._ownD = self._owner_indices(self._cutD_rows, on_dev0=False)
        self._ownP = self._owner_indices(self._cutP_rows, on_dev0=True)
        self._plans = {}
        self._recv_scale = {}
        for direction in (Direction.forward, Direction.backward):
            self._recv_scale[direction] = base._recv_scales(base._dev_plans[direction])
            self._plans[direction] = self._compile_plans(direction)
        self._wcache: dict = {}

    # ------------------------------------------------------------------
    @staticmethod
    def _idx(a, device) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)

    def _ends(self, name: str, sender_right: bool, ids: np.ndarray):
        """(sender type, sender rows, receiver type, receiver rows) of the
        messages ``ids``; rows are type-local."""
        mt = self.msgs[name].mtype
        l, r = self._lrow[name][ids], self._rrow[name][ids]
        if sender_right:
            return mt.right_type.name, r, mt.left_type.name, l
        return mt.left_type.name, l, mt.right_type.name, r

    def _dual_ops(self, plan):
        yield from (("rl", nm, ids) for nm, ids in plan.recv_left)
        yield from (("rr", nm, ids) for nm, ids in plan.recv_right)
        yield from (("sl", nm, ids) for nm, ids, _ in plan.send_left)
        yield from (("sr", nm, ids) for nm, ids, _ in plan.send_right)

    def _prop_ops(self, plan):
        yield from ((True, nm, ids) for nm, ids in plan.prop_l2r)
        yield from ((False, nm, ids) for nm, ids in plan.prop_r2l)

    def _find_cut_rows(self) -> None:
        """Receiver rows some op updates from another shard (dual cut) and
        source rows some propagation reads from another shard (primal cut),
        per type, with the slot of each such row."""
        cutD = {t: [] for t in self.row_dev}
        cutP = {t: [] for t in self.row_dev}
        for direction in (Direction.forward, Direction.backward):
            for plan in self.base.plans[direction]:
                for kind, nm, ids in self._dual_ops(plan):
                    st, sr, rt, rr = self._ends(nm, _KINDS[kind][0] == "right", ids)
                    cutD[rt].append(rr[self.row_dev[st][sr] != self.row_dev[rt][rr]])
                for l2r, nm, ids in self._prop_ops(plan):
                    st, sr, rt, rr = self._ends(nm, not l2r, ids)
                    cutP[st].append(sr[self.row_dev[st][sr] != self.row_dev[rt][rr]])

        def slots(cut):
            rows, slot = {}, {}
            for t, parts in cut.items():
                r = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
                rows[t] = r.astype(np.int64)
                slot[t] = np.full(len(self.row_dev[t]), -1, dtype=np.int64)
                slot[t][r] = np.arange(len(r))
            return rows, slot

        self._cutD_rows, self._slotD = slots(cutD)
        self._cutP_rows, self._slotP = slots(cutP)

    def _owner_indices(self, cut_rows: dict, on_dev0: bool) -> dict:
        """Per type: [(shard, slots, local rows)] of the cut rows each shard
        owns; the slots live on the first device for the primal gather
        (``on_dev0``), on the shard's own device for the dual add."""
        out = {}
        for t, rows in cut_rows.items():
            owned = []
            for d in range(self.n):
                sel = np.nonzero(self.row_dev[t][rows] == d)[0]
                if len(sel):
                    owned.append((d, self._idx(sel, self.dev0 if on_dev0 else self.devices[d]),
                                  self._idx(self.row_loc[t][rows[sel]], self.devices[d])))
            if owned:
                out[t] = owned
        return out

    def _data(self, name: str, mids: np.ndarray, device) -> dict:
        blk = self.msgs[name]
        sub = _gather(blk.data, self._idx(mids, self.dev0))
        return {k: v.to(device) for k, v in sub.items()}

    def _compile_plans(self, direction: Direction) -> list[_Phase]:
        """Per phase, per shard: exact index tensors of every op on the
        shard's device."""
        phases = []
        n_ops = 0
        for plan in self.base.plans[direction]:
            ph = _Phase(recv=[], frows=[], send=[], prop=[])
            for kind, nm, ids in self._dual_ops(plan):
                st, sr, rt, rr = self._ends(nm, _KINDS[kind][0] == "right", ids)
                sdev, rdev = self.row_dev[st][sr], self.row_dev[rt][rr]
                for d in range(self.n):
                    sel = np.nonzero(sdev == d)[0]
                    if not len(sel):
                        continue
                    dev = self.devices[d]
                    mid = ids[sel]
                    data = self._data(nm, mid, dev)
                    local = rdev[sel] == d
                    recv = []
                    for part, idx in ((local, self.row_loc[rt]), (~local, self._slotD[rt])):
                        p = np.nonzero(part)[0]
                        if not len(p):
                            recv.append(None)
                        elif len(p) == len(sel):
                            recv.append(_Recv(None, self._idx(idx[rr[sel]], dev), data))
                        else:
                            recv.append(_Recv(self._idx(p, dev), self._idx(idx[rr[sel[p]]], dev),
                                              self._data(nm, mid[p], dev)))
                    op = _DualOp(i=n_ops, kind=kind, name=nm, shard=d, st=st, rt=rt, mid=mid,
                                 srow=self._idx(self.row_loc[st][sr[sel]], dev),
                                 data=data, loc=recv[0], cut=recv[1])
                    n_ops += 1
                    (ph.recv if kind[0] == "r" else ph.send).append(op)
            for t, rows in plan.factor_rows.items():
                dev = self.row_dev[t][rows]
                for d in range(self.n):
                    r = self.row_loc[t][rows[dev == d]]
                    if len(r):
                        ph.frows.append((d, t, self._idx(r, self.devices[d])))
            for l2r in (True, False):
                ops, cut_types = [], set()
                for _, nm, ids in (e for e in self._prop_ops(plan) if e[0] == l2r):
                    st, sr, rt, rr = self._ends(nm, not l2r, ids)
                    sdev, rdev = self.row_dev[st][sr], self.row_dev[rt][rr]
                    for d in range(self.n):
                        sel = np.nonzero(rdev == d)[0]
                        if not len(sel):
                            continue
                        dev = self.devices[d]
                        local = sdev[sel] == d
                        src = np.where(local, self.row_loc[st][sr[sel]],
                                       self.n_rows[d][st] + self._slotP[st][sr[sel]])
                        needs_cut = not local.all()
                        if needs_cut:
                            cut_types.add(st)
                        ops.append(_PropOp(name=nm, shard=d, st=st, rt=rt,
                                           src=self._idx(src, dev),
                                           dst=self._idx(self.row_loc[rt][rr[sel]], dev),
                                           data=self._data(nm, ids[sel], dev), needs_cut=needs_cut))
                if ops:
                    ph.prop.append((l2r, ops, sorted(cut_types)))
            phases.append(ph)
        return phases

    # ------------------------------------------------------------------
    # block split and merge between global [F, ...] and per-shard blocks
    # ------------------------------------------------------------------
    def set_state(self, state: dict) -> None:
        """Install a global dual state (``Engine.state`` layout); under
        ``use_jit`` copied into the shards' buffers."""
        new = [{t: {k: v.to(self.dev0)[self._perm_dev0[t][d]].to(self.devices[d])
                    for k, v in state[t].items()} for t in state}
               for d in range(self.n)]
        self._local = (self.jit.adopt(new) if self._local is None
                       else self.jit.assign(self._local, new))

    def _merge(self, per_shard: list, t: str) -> dict:
        out = {}
        n_rows = len(self.row_dev[t])
        for k, v in per_shard[0][t].items():
            g = torch.empty((n_rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=self.dev0)
            for d in range(self.n):
                g[self._perm_dev0[t][d]] = per_shard[d][t][k].to(self.dev0)
            out[k] = g
        return out

    @property
    def state(self) -> dict:
        """The dual state merged into global blocks on the first device."""
        return {t: self._merge(self._local, t) for t in self._local[0]}

    def merge_primal(self, prim: list) -> dict:
        """A per-shard primal (``compute_pass_and_primal``) in global blocks."""
        return {t: self._merge(prim, t) for t in prim[0]}

    # ------------------------------------------------------------------
    # sharded pass
    # ------------------------------------------------------------------
    def _op_weights(self, mode, direction: Direction) -> list:
        """Per op of ``direction``: its messages' weights on its shard, the
        1/k receive scales of slot-disjoint types folded in."""
        key = (mode, direction)
        if key not in self._wcache:
            w = self.base.weights(mode, direction)
            scale = self._recv_scale[direction]
            out = {}
            for ph in self._plans[direction]:
                for op in ph.recv + ph.send:
                    mid = self._idx(op.mid, self.dev0)
                    wv = w[op.name][_KINDS[op.kind][1]][mid]
                    if op.kind[0] == "r" and op.name in scale:
                        wv = wv * scale[op.name][mid]
                    out[op.i] = wv.to(self.devices[op.shard])
            self._wcache[key] = out
        return self._wcache[key]

    def _delta(self, local: list, op: _DualOp, wv: torch.Tensor) -> torch.Tensor:
        mt = self.msgs[op.name].mtype
        block = local[op.shard][op.st]
        right = _KINDS[op.kind][0] == "right"
        if op.kind[0] == "r":
            hook = mt.marginal_right_block if right else mt.marginal_left_block
            if hook is not None:
                # the type's batched hook over the shard's sender block, as
                # Engine's receive runs it over the whole block
                return _bmul(hook(block, op.data, op.srow), wv)
        marg = mt.marginal_right if right else mt.marginal_left
        return _bmul(marg(_gather(block, op.srow), op.data), wv)

    def _dual_group(self, local: list, ops: list, w: dict) -> None:
        """Deltas of every op from one snapshot, then the sender, local
        receiver and cut-buffer scatters, then the consensus of the cut
        buffers; ``local`` (the per-shard blocks) is updated in place."""
        deltas = [self._delta(local, op, w[op.i]) for op in ops]
        bufs: dict = {}                     # receiver type -> {shard: buffer}
        zero: dict = {}
        for op, delta in zip(ops, deltas):
            mt = self.msgs[op.name].mtype
            right = _KINDS[op.kind][0] == "right"
            repam_s = mt.repam_right if right else mt.repam_left
            repam_r = mt.repam_left if right else mt.repam_right
            loc = local[op.shard]
            loc[op.st] = repam_s(loc[op.st], op.srow, -delta, op.data)
            if op.loc is not None:
                d = delta if op.loc.pos is None else _take_rows(delta, op.loc.pos)
                loc[op.rt] = repam_r(loc[op.rt], op.loc.idx, d, op.loc.data)
            if op.cut is not None:
                d = delta if op.cut.pos is None else _take_rows(delta, op.cut.pos)
                per = bufs.setdefault(op.rt, {})
                if op.shard not in per:
                    C = len(self._cutD_rows[op.rt])
                    per[op.shard] = zero[(op.rt, op.shard)] = {
                        k: torch.zeros((C,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
                        for k, v in loc[op.rt].items()}
                per[op.shard] = repam_r(per[op.shard], op.cut.idx, d, op.cut.data)
        for t, per in bufs.items():
            # the keys some repam wrote: the others still hold their zeros
            keys = [k for k in next(iter(per.values()))
                    if any(b[k] is not zero[(t, d)][k] for d, b in per.items())]
            total = {}
            for k in keys:
                parts = [b[k].to(self.dev0) for b in per.values()]
                total[k] = parts[0] if len(parts) == 1 else torch.stack(parts).sum(0)
            moved = {}
            for d, slots, rows in self._ownD[t]:
                dev = self.devices[d]
                if dev not in moved:
                    moved[dev] = {k: v.to(dev) for k, v in total.items()}
                blk = dict(local[d][t])
                for k, v in moved[dev].items():
                    blk[k] = blk[k].index_add(0, rows, _take_rows(v, slots))
                local[d][t] = blk

    def _exchange_primal(self, prim: list, types: list) -> dict:
        """The cut source-primal rows of ``types``, each from its owner,
        gathered on the first device: {type: {key: [C, ...]}}."""
        out = {}
        for t in types:
            C = len(self._cutP_rows[t])
            vals = {}
            for k, v in prim[0][t].items():
                g = torch.empty((C,) + tuple(v.shape[1:]), dtype=v.dtype, device=self.dev0)
                for d, slots, rows in self._ownP[t]:
                    g[slots] = _take_rows(prim[d][t][k], rows).to(self.dev0)
                vals[k] = g
            out[t] = vals
        return out

    def _run(self, local: list, direction: Direction, w: dict, prim: "list | None") -> None:
        """One sweep over ``local`` (updated in place), with the rounding
        interleaved where ``prim`` is given."""
        for ph in self._plans[direction]:
            self._dual_group(local, ph.recv, w)
            if prim is not None:
                for d, t, rows in ph.frows:
                    p = prim[d]
                    newp = self.ftypes[t].compute_primal(_gather(local[d][t], rows),
                                                         _gather(p[t], rows))
                    p[t] = {k: p[t][k].index_put((rows,), newp[k]) for k in p[t]}
            self._dual_group(local, ph.send, w)
            if prim is None:
                continue
            for l2r, ops, cut_types in ph.prop:
                cut = self._exchange_primal(prim, cut_types)
                for op in ops:
                    mt = self.msgs[op.name].mtype
                    p = prim[op.shard]
                    ext = p[op.st]
                    if op.needs_cut:
                        dev = self.devices[op.shard]
                        ext = {k: torch.cat([v, cut[op.st][k].to(dev)]) for k, v in ext.items()}
                    if l2r:
                        p[op.rt] = mt.propagate_primal_l2r(ext, p[op.rt], op.src, op.dst, op.data)
                    else:
                        p[op.rt] = mt.propagate_primal_r2l(p[op.rt], ext, op.dst, op.src, op.data)

    # ------------------------------------------------------------------
    def collective_stats(self) -> dict:
        """Per receiver type: cut rows and the bytes of one shard's cut
        buffer (all state keys).  One consensus moves each contributing
        shard's buffer to the first device and the sum back to each owner;
        on one device those moves are no-ops and the consensus is the sum
        and the owners' scatters."""
        out = {}
        for t, rows in self._cutD_rows.items():
            if not len(rows):
                continue
            row_bytes = sum(int(np.prod(v.shape[1:], dtype=np.int64)) * v.element_size()
                            for v in self._local[0][t].values())
            out[t] = {"cut_rows": int(len(rows)), "bytes_per_collective": int(len(rows) * row_bytes)}
        return out

    # ------------------------------------------------------------------
    # Engine-compatible public API
    # ------------------------------------------------------------------
    def weights(self, mode, direction: Direction) -> dict:
        return self.base.weights(mode, direction)

    def _pass(self, mode, direction: Direction, primal: bool):
        """The captured sweep for one weight mode and direction: a function
        of the per-shard blocks that returns (new blocks, primal or None)."""
        mode = ReparametrizationMode.convert(mode)
        key = (mode, direction, primal)
        g = self._graphed.get(key)
        if g is None:
            w = self._op_weights(mode, direction)

            def run(local):
                local = [dict(loc) for loc in local]
                if not primal:
                    self._run(local, direction, w, None)
                    return local, None
                prim = self._init_primal(local)
                self._run(local, direction, w, prim)
                for d, t, rows in self._unupd:
                    p = prim[d]
                    newp = self.ftypes[t].compute_primal(_gather(local[d][t], rows),
                                                         _gather(p[t], rows))
                    p[t] = {k: p[t][k].index_put((rows,), newp[k]) for k in p[t]}
                return local, prim
            g = self._graphed[key] = self.jit.jit(
                run, f"{'primal' if primal else 'dual'} pass {direction.name} {mode.name}",
                donate=(0,))
        return g

    def compute_forward_pass(self, mode) -> None:
        self._local, _ = self._pass(mode, Direction.forward, False)(self._local)

    def compute_backward_pass(self, mode) -> None:
        self._local, _ = self._pass(mode, Direction.backward, False)(self._local)

    def compute_pass(self, mode) -> None:
        self.compute_forward_pass(mode)
        self.compute_backward_pass(mode)

    def _lower_bound_impl(self, local: list) -> torch.Tensor:
        total = torch.zeros((), dtype=torch.float64, device=self.dev0)
        for d, loc in enumerate(local):
            for t, block in loc.items():
                if self.n_rows[d][t]:
                    s = torch.sum(self.ftypes[t].lower_bound(block), dtype=torch.float64)
                    total = total + s.to(self.dev0)
        return total

    def lower_bound(self) -> float:
        """Sum of the per-factor bounds over every shard, in float64."""
        if "bound" not in self._graphed:
            self._graphed["bound"] = self.jit.jit(self._lower_bound_impl, "lower bound")
        return float(self._graphed["bound"](self._local)) + self.constant

    def _init_primal(self, local: list) -> list:
        return [{t: self.ftypes[t].init_primal(block) for t, block in loc.items()}
                for loc in local]

    def init_primal(self) -> list:
        return self._init_primal(self._local)

    def compute_pass_and_primal(self, mode, direction: Direction) -> list:
        """Rounding pass: a fresh primal per shard, interleaved with the
        sweep; then the local argmin of the factors outside the schedule."""
        self._local, prim = self._pass(mode, direction, True)(self._local)
        return prim

    def evaluate_primal(self, prim: list) -> float:
        self.base.state = self.state
        return self.base.evaluate_primal(self.merge_primal(prim))

    def check_primal_consistency(self, prim: list) -> bool:
        self.base.state = self.state
        return self.base.check_primal_consistency(self.merge_primal(prim))
