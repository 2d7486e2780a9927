"""Structured pull pass (counterpart of ``lp_mp_tpu/engine_pull.py``).

The dual sweep of ``Engine`` without gathers or scatters on models whose
message index arrays are affine-strided (grids, chains, dense assignment
blocks); ``Engine(pull=True)`` runs it in ``update_mode="shared"``.

1. **Slot-major layout**: per op (message type x direction), messages are
   laid out in *slots*: slot g holds at most one message per receiving
   factor row, lane u = the receiver's local row, so the receiver's
   contributions add lane for lane onto a contiguous row range.
2. **Strided pattern fitting**: the sender map of a slot,
   ``f[u] = sender row of the message at lane u``, is fitted to

       f[u] = b + (u // P) * T + (u % P)

   (``Strided``: constant offsets, row-major grids of unequal widths with
   T = P +- 1, broadcast rays with T = 0).  Single-chunk builds that
   interleave several orientations in one slot are split into strided
   sheets (``decompose``); same-pattern sheets with disjoint lanes merge,
   and each slot keeps the lane range it covers.  This host planning is a
   copy of the JAX package's, so both packages lay out the same slots
   (``pull_stats``).
3. **On tensors**: a fitted slot reads its sender rows as one
   ``as_strided`` view of the state ([blocks, residues], rows
   b + k*T + r) and adds its contributions in place on views of an
   accumulator: the receiver's lanes lane_lo + k*P + r, and the sender's
   rows in non-overlapping residue chunks of width at most T (a sum over
   the blocks first when T = 0).  A view covers only lanes whose rows lie
   inside both blocks: a slot is cut to the blocks and residues that hold
   its messages, and a block at its ends whose rectangle would reach
   outside a block becomes a one-block piece of its own (``_pieces``).
   Lanes without a message carry weight 0.  Unfittable slots gather with
   the engine's row gather (``engine._take_rows``: an element gather for
   narrow rows on CUDA) and add with ``index_add_`` (int64 indices).

The accumulator of a stage (the receives, or the sends, of one phase) is
cloned from the state at its first touch; every read uses the stage's
state, never the accumulator, which keeps the snapshot semantics of the
scatter pass (SendMessages' tmp_factor, factors_messages.hxx:2787-2814) and
leaves the tensors a caller holds (the captured state buffers) untouched.
A pass whose slots are all strided uses no atomics, so on CUDA it repeats
bit for bit.  The per-lane weights (message weight x lane validity x phase
membership, and for receives the engine's 1/k receive scale of
slot-disjoint types, which the JAX package's ``fold_weights`` leaves out)
are folded on the host once per (mode, direction) by ``Engine``; a run
whose weights are zero on every lane adds exact zeros and is skipped.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Direction
from .engine import _cumcount, _take_rows


# ---------------------------------------------------------------------------
# pattern fitting (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Strided:
    """f[u] = b + (u // P) * T + (u % P).  T >= P: disjoint blocks; T < P:
    overlapping blocks; T == 0: broadcast (every block reads the same P
    rows)."""
    b: int
    T: int
    P: int


def _verify(pattern: Strided, u: np.ndarray, f: np.ndarray) -> bool:
    b, T, P = pattern.b, pattern.T, pattern.P
    if P <= 0 or T < 0:
        return False
    return bool((f == b + (u // P) * T + (u % P)).all())


def fit_pattern(f: np.ndarray, valid: np.ndarray) -> "Strided | None":
    """Fit ``f`` on valid lanes to the strided form, else None.

    Candidates: constant offset (T=P covers identity too); block period
    inferred from the change points of d[u] = f[u] - u (d is constant on
    [kP, (k+1)P) and steps by T-P at block boundaries); broadcast (T=0).
    Verification is exact and vectorized, so a wrong candidate can never
    produce a wrong pass, only a fallback."""
    u = np.nonzero(valid)[0]
    if len(u) == 0:
        return None
    fv = f[u].astype(np.int64)
    d = fv - u
    # constant offset: f = u + b  ->  (b, T=1, P=1); the unit period keeps
    # lane-range restriction exact (lo rounds to itself)
    if d.min() == d.max():
        cand = Strided(int(d[0]), 1, 1)
        if _verify(cand, u, fv):
            return cand
    # general strided: d changes value exactly at block boundaries k*P
    ch = np.nonzero(d[1:] != d[:-1])[0] + 1          # indices into u
    cands: list[Strided] = []
    if len(ch):
        for P in {int(u[ch[0]]), int(u[ch[0]] - u[0])} | (
                {int(u[ch[1]] - u[ch[0]])} if len(ch) > 1 else set()):
            if P <= 0:
                continue
            # T from the per-block step of d: d = b + k*(T - P)
            k = u // P
            dk = np.unique(k)
            if len(dk) < 2:
                continue
            i0 = int(np.searchsorted(k, dk[0]))
            i1 = int(np.searchsorted(k, dk[1]))
            step, rem = divmod(int(d[i1] - d[i0]), int(dk[1] - dk[0]))
            if rem:
                continue
            T = step + P
            b = int(d[i0]) - int(dk[0]) * step
            cands.append(Strided(b, T, P))
    for cand in cands:
        if _verify(cand, u, fv):
            return cand
    return None


def _candidate_periods(f: np.ndarray, valid: np.ndarray) -> list[int]:
    """Period guesses for sheet extraction, from the gaps between lanes
    where d = f - u changes (a strided sheet of period P mixed with other
    sheets produces jump lanes whose gaps are P or split P into a few
    parts, so the most frequent gaps and sums of adjacent gaps cover it)."""
    u = np.nonzero(valid)[0]
    if len(u) < 3:
        return []
    d = f[u].astype(np.int64) - u
    jumps = u[1:][d[1:] != d[:-1]]
    if len(jumps) < 1:
        return []
    gaps = np.diff(jumps)
    cands: list[int] = [int(jumps[0]), int(jumps[0]) + 1]
    if len(gaps):
        vals, counts = np.unique(gaps, return_counts=True)
        cands += [int(v) for v in vals[np.argsort(-counts)][:3]]
        if len(gaps) > 1:
            s = gaps[:-1] + gaps[1:]
            vals, counts = np.unique(s, return_counts=True)
            cands += [int(v) for v in vals[np.argsort(-counts)][:2]]
    seen, out = set(), []
    for p in cands:
        if p > 0 and p not in seen:
            seen.add(p)
            out.append(p)
    return out[:6]


def _forced_fit(f: np.ndarray, rem: np.ndarray, P: int):
    """Best (pattern, membership) with the given period, anchored at a few
    lanes of ``rem`` (anchors on a minority sheet give low membership and
    lose; membership tests are exact, so a bad anchor can't corrupt)."""
    u = np.nonzero(rem)[0]
    if len(u) < 2:
        return None, None
    best = (0, None, None)
    lanes = np.arange(len(rem))
    for a0 in (0, len(u) // 3, (2 * len(u)) // 3):
        u0 = int(u[a0])
        # partner with the same residue in a later block
        part = u[(u % P == u0 % P) & (u // P > u0 // P)]
        if not len(part):
            continue
        u1 = int(part[0])
        T, rem_div = divmod((int(f[u1]) - int(f[u0])) * P, u1 - u0)
        if rem_div or T < 0:
            continue
        b = int(f[u0]) - (u0 // P) * T - (u0 % P)
        m = rem & (f == b + (lanes // P) * T + (lanes % P))
        cnt = int(m.sum())
        if cnt > best[0]:
            best = (cnt, Strided(b, T, P), m)
    return best[1], best[2]


def decompose(f: np.ndarray, valid: np.ndarray, row_cap: int,
              max_sheets: int = 6) -> list:
    """Split one slot's sender map into strided sheets:
    [(Strided | None, valid_mask)].  A single-chunk model build (e.g. all
    grid edges in one add_potts_factors call) interleaves orientations in
    one slot; sheet extraction recovers each orientation's strided map and
    leaves anything unexplained on a gather-fallback sheet."""
    def capped(pat: "Strided | None") -> "Strided | None":
        if pat is not None and pat.T > 0:
            R1 = -(-len(valid) // pat.P)
            if R1 * pat.T > row_cap:
                return None
        return pat

    whole = capped(fit_pattern(f, valid))
    if whole is not None:
        return [(whole, valid)]
    sheets = []
    rem = valid.copy()
    for _ in range(max_sheets):
        n_rem = int(rem.sum())
        if n_rem == 0:
            return sheets
        pat = capped(fit_pattern(f, rem))
        if pat is not None:
            sheets.append((pat, rem))
            return sheets
        best_cnt, best = 0, None
        for P in _candidate_periods(f, rem):
            pat, m = _forced_fit(f, rem, P)
            pat = capped(pat)
            if pat is not None and int(m.sum()) > best_cnt:
                best_cnt, best = int(m.sum()), (pat, m)
        if best is None or best_cnt < max(64, n_rem // 5):
            break
        sheets.append(best)
        rem = rem & ~best[1]
    if rem.any():
        sheets.append((None, rem))
    return sheets


# ---------------------------------------------------------------------------
# strided reads / in-place accumulation on tensors (views only)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Piece:
    """Lanes k*P + r (k0 <= k < k0 + nb, r0 <= r < r0 + w) of a strided
    pattern; their sender rows b + k*T + r lie inside the sender block."""
    k0: int
    nb: int
    r0: int
    w: int

    def lanes(self, P: int) -> np.ndarray:
        k = np.arange(self.k0, self.k0 + self.nb, dtype=np.int64)
        r = np.arange(self.r0, self.r0 + self.w, dtype=np.int64)
        return (k[:, None] * P + r[None, :]).reshape(-1)


def _pieces(pat: Strided, lanes: np.ndarray, n_send: int, n_span: int) -> list[_Piece]:
    """Pieces whose lanes cover ``lanes`` (lane ids whose pattern rows lie in
    [0, n_send)), every lane of a piece below ``n_span`` and every sender
    row inside [0, n_send): one rectangle of blocks x residues over the
    blocks where it stays inside both blocks (the conditions are monotone
    in the block, so these blocks are one run), and one one-block piece
    per other block that holds lanes."""
    b, T, P = pat.b, pat.T, pat.P
    k, r = lanes // P, lanes % P
    r0, r1 = int(r.min()), int(r.max()) + 1
    kk = np.arange(int(k.min()), int(k.max()) + 1, dtype=np.int64)
    inside = ((b + kk * T + r0 >= 0) & (b + kk * T + r1 - 1 < n_send)
              & (kk * P + r1 - 1 < n_span))
    core = kk[inside]
    edge = np.unique(k[~inside[k - kk[0]]])
    out = []
    for kb in edge:
        rb = r[k == kb]
        out.append(_Piece(int(kb), 1, int(rb.min()), int(rb.max()) + 1 - int(rb.min())))
    if len(core):
        out.append(_Piece(int(core[0]), len(core), r0, r1 - r0))
    return out


def _rows(t: torch.Tensor, start: int, nb: int, stride: int, w: int) -> torch.Tensor:
    """Rows start + k*stride + r (k < nb, r < w) of ``t`` as a [nb, w, ...]
    view (stride 0 repeats the same w rows)."""
    rs = t.stride(0)
    return t.as_strided((nb, w) + tuple(t.shape[1:]),
                        (stride * rs, rs) + tuple(t.stride()[1:]),
                        t.storage_offset() + start * rs)


def _read(src: torch.Tensor, start: int, nb: int, T: int, w: int) -> torch.Tensor:
    """[nb*w, ...] sender rows of a piece (a view where they are contiguous)."""
    return _rows(src, start, nb, T, w).reshape((nb * w,) + tuple(src.shape[1:]))


def _add_strided(acc: torch.Tensor, t: torch.Tensor, start: int, nb: int, T: int,
                 w: int) -> None:
    """acc[start + k*T + r] += t[k*w + r] in place, with views that never
    overlap themselves: chunks of at most T residues, a sum over the blocks
    first when T == 0."""
    t = t.reshape((nb, w) + tuple(t.shape[1:]))
    if T == 0:
        acc[start:start + w].add_(t.sum(0))
    elif T >= w:
        _rows(acc, start, nb, T, w).add_(t)
    else:
        for j in range(0, w, T):
            wj = min(T, w - j)
            _rows(acc, start + j, nb, T, wj).add_(t[:, j:j + wj])


def _lanes_in_range(pat: Strided, n_lanes: int, n_rows: int,
                    res_limit: "int | None" = None) -> np.ndarray:
    u = np.arange(n_lanes, dtype=np.int64)
    f = pat.b + (u // pat.P) * pat.T + (u % pat.P)
    ok = (f >= 0) & (f < n_rows)
    if res_limit is not None:
        ok &= u % pat.P < res_limit
    return u[ok]


def strided_read(src: torch.Tensor, pat: Strided, n_lanes: int,
                 res_limit: "int | None" = None) -> torch.Tensor:
    """out[u] = src[b + (u//P)*T + (u%P)] for u < n_lanes; zero on lanes
    whose pattern row falls outside [0, len(src)) and, when ``res_limit`` is
    given, on lanes with u%P >= res_limit."""
    out = src.new_zeros((n_lanes,) + tuple(src.shape[1:]))
    lanes = _lanes_in_range(pat, n_lanes, src.shape[0], res_limit)
    if not len(lanes):
        return out
    for p in _pieces(pat, lanes, src.shape[0], n_lanes):
        start = pat.b + p.k0 * pat.T + p.r0
        _rows(out, p.k0 * pat.P + p.r0, p.nb, pat.P, p.w).copy_(
            _rows(src, start, p.nb, pat.T, p.w))
    return out


def strided_accumulate_into(acc: torch.Tensor, contrib: torch.Tensor, pat: Strided,
                            res_limit: "int | None" = None) -> torch.Tensor:
    """acc[b + (u//P)*T + (u%P)] += contrib[u], in place; returns ``acc``.
    Lanes whose pattern row is outside [0, len(acc)), and, if ``res_limit``
    is given, lanes with u%P >= res_limit, are skipped (the caller's
    contract: they carry no contribution)."""
    lanes = _lanes_in_range(pat, contrib.shape[0], acc.shape[0], res_limit)
    if not len(lanes):
        return acc
    for p in _pieces(pat, lanes, acc.shape[0], contrib.shape[0]):
        _add_strided(acc, _read(contrib, p.k0 * pat.P + p.r0, p.nb, pat.P, p.w),
                     pat.b + p.k0 * pat.T + p.r0, p.nb, pat.T, p.w)
    return acc


def strided_accumulate(contrib: torch.Tensor, pat: Strided, n_rows: int) -> torch.Tensor:
    """Scatter contrib into a fresh zero [n_rows, ...] tensor (test wrapper
    over strided_accumulate_into)."""
    zero = contrib.new_zeros((n_rows,) + tuple(contrib.shape[1:]))
    return strided_accumulate_into(zero, contrib, pat)


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    """One slot as the JAX package lays it out (host arrays)."""
    pattern: "Strided | None"     # sender map (lane-range-adjusted)
    lane_lo: int                  # first receiver row this slot covers
    n_lanes: int                  # rows covered: [lane_lo, lane_lo+n_lanes)
    res_limit: "int | None"       # max valid residue + 1 (T < P read bound)
    sigma: np.ndarray             # [n_lanes] original message id (0 where no message)
    lane_valid: np.ndarray        # [n_lanes] bool: lane holds a message
    f: np.ndarray                 # [n_lanes] sender row (0 where no message)


@dataclasses.dataclass
class _Run:
    """One unit of a slot's work on the device: a strided piece (sender rows
    ``send0 + k*T + r``, receiver rows ``recv0 + k*P + r``) or, with
    ``sidx``, the gather over the slot's lanes from ``recv0``."""
    sigma: np.ndarray             # [n] message id per lane (0 where no message)
    valid: np.ndarray             # [n] lane holds a message
    data: dict                    # per-lane static message data (device)
    recv0: int
    send0: int = 0
    nb: int = 0
    w: int = 0
    T: int = 0
    P: int = 0
    sidx: "torch.Tensor | None" = None


@dataclasses.dataclass
class _Op:
    name: str
    kind: str                     # recv_left | recv_right | send_left | send_right
    sender: str                   # "left" | "right"
    wkey: str
    sender_type: str
    recv_type: str
    slots: list
    n_recv_rows: int
    n_send_rows: int
    runs: list = dataclasses.field(default_factory=list)


def _slot_key(kind: str):
    """(receiver rows, sender rows, sender side, weight key) per op kind."""
    return {
        "recv_left": ("lfid", "rfid", "right", "recv_left"),
        "recv_right": ("rfid", "lfid", "left", "recv_right"),
        "send_left": ("rfid", "lfid", "left", "omega_left"),
        "send_right": ("lfid", "rfid", "right", "omega_right"),
    }[kind]


def build_op(engine, name: str, kind: str) -> _Op:
    """Slot-major plan for one (message type, direction) op: group the
    type's messages by (build chunk, rank within (chunk, receiver row)),
    lay each group out on receiver-row lanes, fit/decompose the sender
    maps into strided sheets, merge same-pattern disjoint sheets, and
    restrict each sheet to the lane range it actually covers (host only)."""
    blk = engine.msgs[name]
    mt = blk.mtype
    rk, sk, sender, wkey = _slot_key(kind)
    recv_rows = engine.f_local[getattr(blk, rk)]
    send_rows = engine.f_local[getattr(blk, sk)]
    recv_t = mt.left_type.name if rk == "lfid" else mt.right_type.name
    send_t = mt.left_type.name if sk == "lfid" else mt.right_type.name
    n_recv = int(next(iter(engine.state[recv_t].values())).shape[0])
    n_send = int(next(iter(engine.state[send_t].values())).shape[0])
    M = len(blk.gids)
    chunk = blk.chunk_of
    rank = _cumcount(chunk * np.int64(n_recv) + recv_rows)
    group = chunk * (int(rank.max()) + 1 if M else 1) + rank
    row_cap = 4 * max(n_send, n_recv) + n_recv

    # 1. sheets over full lane space
    sheets = []   # [pattern | None, valid, f, sigma]
    for gval in np.unique(group):
        ids = np.nonzero(group == gval)[0]
        lanes = recv_rows[ids]
        sigma = np.zeros(n_recv, dtype=np.int64)
        lane_valid = np.zeros(n_recv, dtype=bool)
        sigma[lanes] = ids
        lane_valid[lanes] = True
        f = np.zeros(n_recv, dtype=np.int64)
        f[lanes] = send_rows[ids]
        for pat, vmask in decompose(f, lane_valid, row_cap):
            sheets.append([pat, vmask, f, sigma])

    # 2. merge same-pattern sheets with disjoint lanes (e.g. the V-edge
    # sheet split across rank slots by last-column receivers)
    merged = []
    for pat, vmask, f, sigma in sheets:
        placed = False
        if pat is not None:
            for m in merged:
                if m[0] == pat and not (m[1] & vmask).any():
                    m[1] = m[1] | vmask
                    m[2] = np.where(vmask, f, m[2])
                    m[3] = np.where(vmask, sigma, m[3])
                    placed = True
                    break
        if not placed:
            merged.append([pat, vmask.copy(), f.copy(), sigma.copy()])

    # 3. range-restrict and finalize
    slots = []
    for pat, vmask, f, sigma in merged:
        u = np.nonzero(vmask)[0]
        lo, hi = int(u[0]), int(u[-1]) + 1
        res_limit = None
        if pat is not None:
            lo = (lo // pat.P) * pat.P          # keep the block structure
            pat = Strided(pat.b + (lo // pat.P) * pat.T, pat.T, pat.P)
            if 0 < pat.T < pat.P:
                res_limit = int(((u - lo) % pat.P).max()) + 1
        vm = vmask[lo:hi]
        slots.append(_Slot(pattern=pat, lane_lo=lo, n_lanes=hi - lo, res_limit=res_limit,
                           sigma=np.where(vm, sigma[lo:hi], 0), lane_valid=vm,
                           f=np.where(vm, f[lo:hi], 0)))
    return _Op(name=name, kind=kind, sender=sender, wkey=wkey,
               sender_type=send_t, recv_type=recv_t, slots=slots,
               n_recv_rows=n_recv, n_send_rows=n_send)


def _device_runs(engine, op: _Op) -> list:
    """The runs of every slot of ``op``, with their static data on the
    engine's device (one gather of the message data per run, at build)."""
    data = engine.msgs[op.name].data

    def run(sigma, valid, **kw):
        idx = engine._index(sigma)
        return _Run(sigma=sigma, valid=valid, data={k: v[idx] for k, v in data.items()}, **kw)

    runs = []
    for s in op.slots:
        if s.pattern is None:
            runs.append(run(s.sigma, s.lane_valid, recv0=s.lane_lo,
                            sidx=engine._index(s.f)))
            continue
        b, T, P = s.pattern.b, s.pattern.T, s.pattern.P
        for p in _pieces(s.pattern, np.nonzero(s.lane_valid)[0], op.n_send_rows,
                         op.n_recv_rows - s.lane_lo):
            u = p.lanes(P)
            inside = u < s.n_lanes
            uc = np.where(inside, u, 0)
            valid = inside & s.lane_valid[uc]
            runs.append(run(np.where(valid, s.sigma[uc], 0), valid,
                            recv0=s.lane_lo + p.k0 * P + p.r0, send0=b + p.k0 * T + p.r0,
                            nb=p.nb, w=p.w, T=T, P=P))
    return runs


def build_pull_plans(engine, plans, ops: "dict | None" = None):
    """Per phase: {"recv": [(op_key, phase_ids)], "send": [...]} where
    op_key indexes a shared per-(name, kind) _Op table (slot layouts are
    phase- and direction-independent; only the folded weights differ per
    phase).  ``ops`` may carry the table of another direction."""
    ops = {} if ops is None else ops
    phases = []
    for plan in plans:
        stages = {"recv": [], "send": []}
        for stage, kind, lst in (
                ("recv", "recv_left", plan.recv_left),
                ("recv", "recv_right", plan.recv_right),
                ("send", "send_left", [(n, i) for n, i, _ in plan.send_left]),
                ("send", "send_right", [(n, i) for n, i, _ in plan.send_right])):
            for name, ids in lst:
                key = (name, kind)
                if key not in ops:
                    ops[key] = build_op(engine, name, kind)
                stages[stage].append((key, np.asarray(ids)))
        phases.append(stages)
    return ops, phases


def fold_weights(engine, ops, phases, w_np, recv_scale: dict) -> list:
    """Per phase/stage/op/run: the static per-lane weight (message weight x
    lane validity x phase membership, x the 1/k receive scale of
    slot-disjoint types for receives) as one [n] device tensor, or None
    where it is zero on every lane: that run would add exact zeros, and the
    pass skips it (a wavefront phase touches few of an op's slots).  Built
    once per (mode, direction) on the host and cached by Engine."""
    out = []
    for stages in phases:
        ph = {"recv": [], "send": []}
        for stage in ("recv", "send"):
            for key, ids in stages[stage]:
                op = ops[key]
                M = len(engine.msgs[op.name].gids)
                in_phase = np.zeros(M, dtype=bool)
                in_phase[ids] = True
                wvec = np.asarray(w_np[op.name][op.wkey], dtype=np.float64)
                if stage == "recv" and op.name in recv_scale:
                    wvec = wvec * recv_scale[op.name][:M]
                folded = [wvec[r.sigma] * (r.valid & in_phase[r.sigma]) for r in op.runs]
                ph[stage].append([torch.as_tensor(w, device=engine.device).to(engine.dtype)
                                  if w.any() else None for w in folded])
        out.append(ph)
    return out


# ---------------------------------------------------------------------------
# pass runner
# ---------------------------------------------------------------------------

def make_pull_pass(engine, direction, ops: "dict | None" = None):
    """Returns (run, fold): ``run(state, pw)`` is the dual sweep of
    ``direction``, ``fold(w_np)`` builds its per-(mode, direction) weights.
    ``ops`` shares the slot table (and its device runs) between the
    directions."""
    ops, phases = build_pull_plans(engine, engine.plans[direction], ops)
    for op in ops.values():
        if not op.runs:
            op.runs = _device_runs(engine, op)
    msgs = engine.msgs
    recv_scale = {k: v.double().cpu().numpy()
                  for k, v in engine._recv_scales(engine._dev_plans[direction]).items()}

    def run_stage(state, entries, stage_w):
        # accumulate on clones of the state (snapshot semantics: every
        # read below uses `state`, never `acc`)
        acc: dict = {}

        def get(tname, key):
            a = acc.get((tname, key))
            if a is None:
                a = acc[(tname, key)] = state[tname][key].clone(
                    memory_format=torch.contiguous_format)
            return a

        for (key, _ids), op_w in zip(entries, stage_w):
            op = ops[key]
            mt = msgs[op.name].mtype
            if op.sender == "left":
                marginal, recv_pull, send_pull = mt.marginal_left, mt.pull_right, mt.pull_left
            else:
                marginal, recv_pull, send_pull = mt.marginal_right, mt.pull_left, mt.pull_right
            sblock, rblock = state[op.sender_type], state[op.recv_type]
            for r, w in zip(op.runs, op_w):
                if w is None:
                    continue
                if r.sidx is None:
                    srows = {k: _read(v, r.send0, r.nb, r.T, r.w) for k, v in sblock.items()}
                else:
                    srows = {k: _take_rows(v, r.sidx) for k, v in sblock.items()}
                marg = marginal(srows, r.data)
                delta = marg * w.reshape((-1,) + (1,) * (marg.ndim - 1))
                rc = recv_pull(delta, r.data, rblock)
                sc = send_pull(-delta, r.data, sblock)
                for k, t in rc.items():
                    a = get(op.recv_type, k)
                    if r.sidx is None:
                        _rows(a, r.recv0, r.nb, r.P, r.w).add_(
                            t.reshape((r.nb, r.w) + tuple(t.shape[1:])))
                    else:
                        a[r.recv0:r.recv0 + t.shape[0]].add_(t)
                for k, t in sc.items():
                    a = get(op.sender_type, k)
                    if r.sidx is None:
                        _add_strided(a, t, r.send0, r.nb, r.T, r.w)
                    else:
                        a.index_add_(0, r.sidx, t)
        new_state = dict(state)
        for (tname, k), a in acc.items():
            new_state[tname] = {**new_state[tname], k: a}
        return new_state

    def run(state, pw):
        state = dict(state)
        for stages, ph_w in zip(phases, pw):
            state = run_stage(state, stages["recv"], ph_w["recv"])
            state = run_stage(state, stages["send"], ph_w["send"])
        return state

    def fold(w_np):
        return fold_weights(engine, ops, phases, w_np, recv_scale)

    return run, fold


def pull_stats(engine, direction=None) -> dict:
    """Diagnostics: slots per op and how many fitted a strided pattern
    (the JAX package's dict)."""
    d = direction if direction is not None else Direction.forward
    # a pull engine's own slot table; any other engine plans afresh
    ops, phases = build_pull_plans(engine, engine.plans[d], getattr(engine, "_pull_ops", None))
    out = {}
    for name, kind in dict.fromkeys(k for st in phases for s in ("recv", "send")
                                    for k, _ in st[s]):
        op = ops[(name, kind)]
        fitted = sum(1 for s in op.slots if s.pattern is not None)
        out[f"{name}|{kind}"] = {
            "slots": len(op.slots), "strided": fitted,
            "patterns": [(dataclasses.astuple(s.pattern)
                          if s.pattern else None,
                          s.lane_lo, s.n_lanes) for s in op.slots]}
    return out
