"""Factor graph builder.

Copy of ``lp_mp_tpu/graph.py`` for the port (NumPy only; it holds the
port's own type singletons, which it uses only as annotations).  Python
counterpart of ``LP<FMC>``'s model-construction API
(LP_MP.h:238-285, add_factor / add_message / AddFactorRelation):
downstream problem constructors call these, then ``Engine`` compiles the
graph into type-batched arrays + a phase schedule.

Storage is *chunked*: consecutive per-item ``add_factor`` calls of one type
coalesce into an items-chunk, and the batch APIs (``add_factor_block`` /
``add_message_block``) append one pre-built array chunk for N instances in
O(1) Python operations.  This is what lets a 10^6-factor model (the
reference routinely runs such sizes in one process, LP_MP.h:869-1005) build
in seconds: the legacy per-item views ``graph.factors[fid]`` /
``graph.messages[mid]`` remain available as lazy sequences.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from .registry import FactorType, MessageType
from .schedule import MessageDesc


@dataclasses.dataclass(frozen=True)
class FactorRef:
    ftype: FactorType
    fid: int  # global factor id (insertion order, like LP::f_)


@dataclasses.dataclass(frozen=True)
class MessageRef:
    mtype: MessageType
    mid: int


@dataclasses.dataclass
class FactorChunk:
    ftype: FactorType
    kind: str          # "items" | "block"
    payload: Any       # list of per-instance data | built block dict
    start: int         # global fid of first factor in chunk
    n: int


@dataclasses.dataclass
class MessageChunk:
    mtype: MessageType
    kind: str          # "items" | "block"
    lfid: Any          # list[int] | np.ndarray
    rfid: Any
    payload: Any       # list of per-instance data | built data dict (or None)
    start: int         # global mid of first message in chunk
    n: int


class _FactorSeq:
    """Lazy list-like view of (ftype, data) tuples over factor chunks."""

    def __init__(self, graph: "FactorGraph"):
        self._g = graph

    def __len__(self):
        return self._g._n_factors

    def _locate(self, i: int) -> tuple[FactorChunk, int]:
        chunks = self._g._fchunks
        lo, hi = 0, len(chunks)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if chunks[mid].start <= i:
                lo = mid
            else:
                hi = mid
        return chunks[lo], i - chunks[lo].start

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        ch, off = self._locate(i)
        if ch.kind == "items":
            return (ch.ftype, ch.payload[off])
        return (ch.ftype, ch.ftype.item_data(ch.payload, off))

    def __iter__(self):
        for ch in self._g._fchunks:
            if ch.kind == "items":
                for d in ch.payload:
                    yield (ch.ftype, d)
            else:
                for off in range(ch.n):
                    yield (ch.ftype, ch.ftype.item_data(ch.payload, off))


class _MessageSeq:
    """Lazy list-like view of (mtype, left_fid, right_fid, data) tuples."""

    def __init__(self, graph: "FactorGraph"):
        self._g = graph

    def __len__(self):
        return self._g._n_messages

    def _locate(self, i: int) -> tuple[MessageChunk, int]:
        chunks = self._g._mchunks
        lo, hi = 0, len(chunks)
        while lo + 1 < hi:
            mid = (lo + hi) // 2
            if chunks[mid].start <= i:
                lo = mid
            else:
                hi = mid
        return chunks[lo], i - chunks[lo].start

    def _item(self, ch: MessageChunk, off: int):
        l, r = int(ch.lfid[off]), int(ch.rfid[off])
        if ch.kind == "items":
            return (ch.mtype, l, r, ch.payload[off])
        data = None if ch.payload is None else \
            ch.mtype.item_data(ch.payload, off)
        return (ch.mtype, l, r, data)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        ch, off = self._locate(i)
        return self._item(ch, off)

    def __iter__(self):
        for ch in self._g._mchunks:
            for off in range(ch.n):
                yield self._item(ch, off)


class _RelationSeq:
    """Lazy flat [(int, int)] view over relation blocks."""

    def __init__(self, blocks: list):
        self._blocks = blocks

    def __len__(self):
        return sum(len(a) for a, _ in self._blocks)

    def __bool__(self):
        return any(len(a) for a, _ in self._blocks)

    def __iter__(self):
        for a, b in self._blocks:
            for x, y in zip(a, b):
                yield (int(x), int(y))

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        if not self._blocks:
            z = np.zeros(0, dtype=np.int64)
            return z, z
        return (np.concatenate([np.asarray(a, dtype=np.int64)
                                for a, _ in self._blocks]),
                np.concatenate([np.asarray(b, dtype=np.int64)
                                for _, b in self._blocks]))


class FactorGraph:
    def __init__(self):
        self._fchunks: list[FactorChunk] = []
        self._mchunks: list[MessageChunk] = []
        self._n_factors = 0
        self._n_messages = 0
        self._fwd_rel: list = []   # [(l_arr/list, r_arr/list)] blocks
        self._bwd_rel: list = []
        self.partition_pairs: list[tuple[int, int]] = []
        self.constant: float = 0.0

    # -- construction (LP_MP.h:238-285) ------------------------------------
    def add_factor(self, ftype: FactorType, data: Any) -> FactorRef:
        ch = self._fchunks[-1] if self._fchunks else None
        if ch is not None and ch.kind == "items" and ch.ftype is ftype:
            ch.payload.append(data)
            ch.n += 1
        else:
            self._fchunks.append(FactorChunk(ftype, "items", [data],
                                             self._n_factors, 1))
        self._n_factors += 1
        return FactorRef(ftype, self._n_factors - 1)

    def add_factor_block(self, ftype: FactorType, batch: Any,
                         n: int) -> np.ndarray:
        """Append ``n`` factors of one type at once.  ``batch`` is the
        type's batch payload (see FactorType.build_block); returns the
        global fids [n]."""
        block = ftype.build_block(batch)
        start = self._n_factors
        self._fchunks.append(FactorChunk(ftype, "block", block, start, n))
        self._n_factors += n
        return np.arange(start, start + n, dtype=np.int64)

    def add_message(self, mtype: MessageType, left: FactorRef, right: FactorRef,
                    data: Any = None) -> MessageRef:
        assert left.ftype is mtype.left_type, \
            f"left factor type {left.ftype.name} != {mtype.left_type.name}"
        assert right.ftype is mtype.right_type, \
            f"right factor type {right.ftype.name} != {mtype.right_type.name}"
        ch = self._mchunks[-1] if self._mchunks else None
        if ch is not None and ch.kind == "items" and ch.mtype is mtype:
            ch.lfid.append(left.fid)
            ch.rfid.append(right.fid)
            ch.payload.append(data)
            ch.n += 1
        else:
            self._mchunks.append(MessageChunk(
                mtype, "items", [left.fid], [right.fid], [data],
                self._n_messages, 1))
        self._n_messages += 1
        return MessageRef(mtype, self._n_messages - 1)

    def add_message_block(self, mtype: MessageType, lfid: np.ndarray,
                          rfid: np.ndarray, batch: Any = None) -> np.ndarray:
        """Append len(lfid) messages of one type at once.  ``batch`` is the
        type's batch data payload (None when the type carries no data);
        returns the global mids."""
        lfid = np.asarray(lfid, dtype=np.int64)
        rfid = np.asarray(rfid, dtype=np.int64)
        assert lfid.shape == rfid.shape
        block = None if batch is None else mtype.build_block(batch)
        start = self._n_messages
        self._mchunks.append(MessageChunk(mtype, "block", lfid, rfid, block,
                                          start, len(lfid)))
        self._n_messages += len(lfid)
        return np.arange(start, start + len(lfid), dtype=np.int64)

    def add_factor_relation(self, f1: FactorRef, f2: FactorRef) -> None:
        """AddFactorRelation: f1 before f2 forward, f2 before f1 backward
        (LP_MP.h:697-702)."""
        self.forward_relation(f1, f2)
        self.backward_relation(f2, f1)

    def forward_relation(self, f1: FactorRef, f2: FactorRef) -> None:
        assert f1.fid != f2.fid
        self._fwd_rel.append(([f1.fid], [f2.fid]))

    def backward_relation(self, f1: FactorRef, f2: FactorRef) -> None:
        assert f1.fid != f2.fid
        self._bwd_rel.append(([f1.fid], [f2.fid]))

    def add_factor_relation_block(self, f1: np.ndarray, f2: np.ndarray) -> None:
        f1 = np.asarray(f1, dtype=np.int64)
        f2 = np.asarray(f2, dtype=np.int64)
        self._fwd_rel.append((f1, f2))
        self._bwd_rel.append((f2, f1))

    def put_in_same_partition(self, f1: FactorRef, f2: FactorRef) -> None:
        """Group factors into one block for staged partition passes
        (LP_MP.h:465-475 ``partition_graph``)."""
        self.partition_pairs.append((f1.fid, f2.fid))

    def add_to_constant(self, x: float) -> None:
        self.constant += x

    # -- host views ---------------------------------------------------------
    @property
    def n_factors(self) -> int:
        return self._n_factors

    @property
    def factors(self) -> _FactorSeq:
        return _FactorSeq(self)

    @property
    def messages(self) -> _MessageSeq:
        return _MessageSeq(self)

    @property
    def forward_relations(self) -> _RelationSeq:
        return _RelationSeq(self._fwd_rel)

    @property
    def backward_relations(self) -> _RelationSeq:
        return _RelationSeq(self._bwd_rel)

    def factor_chunks(self) -> list[FactorChunk]:
        return self._fchunks

    def message_chunks(self) -> list[MessageChunk]:
        return self._mchunks

    def message_descs(self) -> list[MessageDesc]:
        return [MessageDesc(l, r, mt.schedule) for mt, l, r, _ in self.messages]
