"""Captured execution: the port's counterpart of ``jax.jit``.

The JAX package compiles each device program of its engines and models
once per build with ``jax.jit`` (``use_jit=True``, its default).  Here the
counterpart is a CUDA graph: a function of tensors is captured once per
build as a ``torch.cuda.CUDAGraph`` and then replayed as one launch, so a
pass that runs hundreds or thousands of small kernels costs one graph
launch and a few copies on the host.  Every build fixes its shapes (the
index tensors are uploaded once), so the graphs stay valid for the life of
their owner.

``Graphs`` is the owner: one per engine or model.  It holds one memory
pool that all its graphs share, the graphs, and the static buffers it made.
``Graphs.jit(fn, name, donate)`` wraps ``fn``, a function whose positional
arguments are trees (dicts, lists, tuples) of tensors and whose keyword
arguments are static (hashable; part of the key, like
``static_argnums``).  Values that ``fn`` closes over (index tensors,
weights) are used at their addresses: their owner keeps them alive and
unchanged, or calls ``reset`` when it rebinds them.

- **Capture.**  On the first call for a key (the tree structure, shapes,
  dtypes and devices of the arguments, and the static arguments), every
  tensor argument gets a static buffer: a tensor the owner made itself is
  used as it is, any other is cloned into a new one.  ``fn`` then runs once
  on the owner's side stream (the warm-up the CUDA-graph notes of PyTorch
  ask for: lazy uploads and caches happen here, outside the graph), on
  clones of its donated arguments, and is captured on that stream into the
  owner's pool.
- **Ownership: the pass ends by copying into the state buffers.**  For
  each argument named in ``donate``, ``fn`` returns its new value; the
  graph's last operations copy it into that argument's static buffers, and
  the call returns those buffers (in new containers).  Every other output
  is cloned right after the replay.  So after a replay nothing that a
  caller holds lives in the pool: the graphs of one owner share its pool
  and replay in any order.  The design costs one copy of the state per
  call, inside the graph, unless ``fn`` returns the donated buffers
  themselves, having written its results into them (the kernel schedule of
  ``GridPottsModel.run_fast`` does, through scratch buffers of its model):
  a value that is its own buffer is not copied.
- **Later calls** copy an argument into its static buffer only where the
  caller passed another tensor than the buffer, then replay.  A caller that
  keeps the returned buffers (``engine.state``) pays no copy.
- **On the CPU** the same buffer logic runs around a direct call of
  ``fn``, so the CPU tests exercise the ownership rules; the results are
  the direct call's, bit for bit.
- **Errors.**  A capture that fails raises ``RuntimeError`` naming the
  function; nothing falls back to eager execution.
- **Tracing** (``tracing``): each capture is the span ``lpmp.capture`` and
  adds to the counters ``captures`` and ``capture_s`` (its warm-up and
  capture seconds); each replay (copy-in, launch, launch accounting, result
  clones) is the span ``lpmp.replay``.  The kernel wrappers count a launch
  when their Python code runs, which under capture launches nothing: the
  capture records those counts (``tracing.recording``) and each replay
  adds them to the counter ``launches``.
- **Records.**  Per graph: warm-up and capture seconds, replays, the bytes
  the capture added to the pool (the change of
  ``torch.cuda.memory_reserved``), the kernel launches it holds and the
  state tensors it copies at its end (0 for a function that writes its
  results into the donated buffers themselves).
- **Invalidation.**  ``reset()`` drops every graph and static buffer, for
  an owner whose static data changed (for example the aux passes' growth).

An owner made with ``enabled=False`` (``use_jit=False``, or shards on
several devices, which one graph cannot hold) calls ``fn`` directly.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import time
import warnings

import torch

from . import tracing

_LEAF = object()     # structure marker of a tensor leaf


def _flatten(tree, leaves: list):
    """Append the tensors of ``tree`` to ``leaves``; return its structure
    (hashable; non-tensor leaves are kept by value)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if isinstance(tree, dict):
        return (dict, tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    return ("value", tree)


def _unflatten(struct, it):
    if struct is _LEAF:
        return next(it)
    kind, body = struct
    if kind is dict:
        return {k: _unflatten(s, it) for k, s in body}
    if kind in (list, tuple):
        return kind(_unflatten(s, it) for s in body)
    return body


def flatten(tree) -> tuple:
    """(tensor leaves, structure) of a tree of tensors."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def unflatten(struct, leaves):
    return _unflatten(struct, iter(leaves))


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.device


@dataclasses.dataclass
class GraphRecord:
    """What one capture cost and how often it ran."""

    name: str
    warmup_s: float = 0.0
    capture_s: float = 0.0
    replays: int = 0
    pool_bytes: int = 0
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    copies: int = 0     # tensors copied into the donated buffers at the end of a call


@dataclasses.dataclass
class _Entry:
    in_struct: tuple
    static_in: list             # one static buffer per tensor leaf of the arguments
    donated: list               # per donated argument: (struct, leaf positions)
    record: GraphRecord
    graph: "torch.cuda.CUDAGraph | None" = None
    extra_struct: object = None
    extra_leaves: list = dataclasses.field(default_factory=list)   # pool tensors (CUDA)


class Graphed:
    """``fn`` captured per key; see the module docstring."""

    def __init__(self, owner: "Graphs", fn, name: str, donate: tuple = ()):
        self.owner, self.fn, self.name = owner, fn, name
        self.donate = tuple(donate)
        self._entries: dict = {}

    def reset(self) -> None:
        self._entries.clear()

    def __call__(self, *args, **static):
        if not self.owner.enabled:
            return self.fn(*args, **static)
        leaves, struct = flatten(args)
        key = (struct, tuple(_meta(t) for t in leaves), tuple(sorted(static.items())))
        entry = self._entries.get(key)
        if entry is None:
            entry = self._new_entry(args, leaves, struct)
            if self.owner.device.type == "cuda":
                with tracing.span("lpmp.capture"):
                    self._capture(entry, static)
                tracing.add("captures")
                tracing.add("capture_s", entry.record.warmup_s + entry.record.capture_s)
            self.owner.records.append(entry.record)
            self._entries[key] = entry
        if entry.graph is not None:
            with tracing.span("lpmp.replay"):
                return self._replay(entry, leaves)
        return self._direct(entry, leaves, static)

    # ------------------------------------------------------------------
    def _new_entry(self, args, leaves, struct) -> _Entry:
        owner = self.owner
        for t in leaves:
            if t.device != owner.device:
                raise ValueError(f"{self.name}: argument on {t.device}, but its graphs live on "
                                 f"{owner.device}")
        static_in = [owner.buffer(t) for t in leaves]
        donated, pos = [], 0
        for i, a in enumerate(args):
            n = len(flatten(a)[0])
            if i in self.donate:
                donated.append((flatten(a)[1], list(range(pos, pos + n))))
            pos += n
        return _Entry(struct, static_in, donated, GraphRecord(self.name))

    def _place(self, entry: _Entry, out) -> list:
        """Copy the new values of the donated arguments into their static
        buffers; return the leaves of the other outputs."""
        if self.donate:
            if not (isinstance(out, tuple) and len(out) == len(self.donate) + 1):
                raise ValueError(f"{self.name}: a function with donated arguments returns "
                                 f"(one new value per donated argument..., other outputs)")
            news, extra = out[:-1], out[-1]
        else:
            news, extra = (), out
        static = entry.static_in
        pos_of = {id(t): i for i, t in enumerate(static)}
        writes = []
        for (struct, positions), new in zip(entry.donated, news):
            leaves, s = flatten(new)
            if s != struct or len(leaves) != len(positions):
                raise ValueError(f"{self.name}: a donated argument came back with another "
                                 "structure")
            for p, t in zip(positions, leaves):
                if _meta(t) != _meta(static[p]):
                    raise ValueError(f"{self.name}: donated leaf {p} came back as "
                                     f"{_meta(t)}, its buffer is {_meta(static[p])}")
                if t is not static[p]:
                    writes.append((p, t))
        # a new value that is another argument's buffer is read before any
        # buffer is written
        writes = [(p, t.clone() if id(t) in pos_of else t) for p, t in writes]
        entry.record.copies = len(writes)
        for p, t in writes:
            static[p].copy_(t)
        leaves, entry.extra_struct = flatten(extra)
        return leaves

    def _results(self, entry: _Entry, extra_leaves: list):
        extra = unflatten(entry.extra_struct, [t.clone() for t in extra_leaves])
        if not self.donate:
            return extra
        static = entry.static_in
        return tuple(unflatten(struct, [static[p] for p in positions])
                     for struct, positions in entry.donated) + (extra,)

    @staticmethod
    def _copy_in(entry: _Entry, leaves: list) -> None:
        for t, s in zip(leaves, entry.static_in):
            if t is not s:
                s.copy_(t)

    def _direct(self, entry: _Entry, leaves: list, static: dict):
        self._copy_in(entry, leaves)
        out = self.fn(*unflatten(entry.in_struct, entry.static_in), **static)
        entry.record.replays += 1
        return self._results(entry, self._place(entry, out))

    @staticmethod
    def warmup_args(entry: _Entry) -> tuple:
        """The arguments of a capture's warm-up run: the static buffers, each
        donated one cloned, so a function that writes its donated arguments
        in place leaves the state as it was (the replay after the capture is
        the call's one run)."""
        donated = {p for _, positions in entry.donated for p in positions}
        return unflatten(entry.in_struct, [t.clone() if i in donated else t
                                           for i, t in enumerate(entry.static_in)])

    def _capture(self, entry: _Entry, static: dict) -> None:
        owner, rec = self.owner, entry.record
        dev = owner.device
        args = unflatten(entry.in_struct, entry.static_in)
        stream = owner.stream()
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            t0 = time.perf_counter()
            stream.wait_stream(cur)
            with torch.cuda.stream(stream):
                self.fn(*self.warmup_args(entry), **static)
            cur.wait_stream(stream)
            torch.cuda.synchronize(dev)
            rec.warmup_s = time.perf_counter() - t0
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            # no cyclic garbage collection inside the capture: collecting an
            # unreachable owner (an engine is a reference cycle) destroys its
            # graphs, a call the capture forbids, and the capture fails
            collecting = gc.isenabled()
            gc.disable()
            reserved = torch.cuda.memory_reserved(dev)
            try:
                # capture_begin/capture_end, not torch.cuda.graph: that one
                # also empties the allocator's cache, and every eager call
                # after it allocates its memory anew
                with warnings.catch_warnings(record=True) as caught, torch.cuda.stream(stream), \
                        tracing.recording(rec.launches):
                    warnings.simplefilter("always")
                    graph.capture_begin(pool=owner.pool())
                    try:
                        extra = self._place(entry, self.fn(*args, **static))
                    finally:
                        graph.capture_end()
                for w in caught:    # PyTorch's warnings of the capture, with the function's name
                    # but not "empty": a function that ran nothing on the card
                    # (a pass over an engine without messages) replays as a no-op
                    if "Graph is empty" not in str(w.message):
                        warnings.warn(f"capturing {self.name}: {w.message}", w.category,
                                      stacklevel=3)
            except Exception as e:
                owner.abandon_pool()
                raise RuntimeError(f"capturing {self.name} as a CUDA graph failed: "
                                   f"{type(e).__name__}: {e}") from e
            finally:
                if collecting:
                    gc.enable()
            rec.capture_s = time.perf_counter() - t0
            rec.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        entry.graph, entry.extra_leaves = graph, extra

    def _replay(self, entry: _Entry, leaves: list):
        with torch.cuda.device(self.owner.device):
            self._copy_in(entry, leaves)
            entry.graph.replay()
            tracing.launch(entry.record.launches)
            entry.record.replays += 1
            return self._results(entry, entry.extra_leaves)


class Graphs:
    """The captured functions of one engine or model, their shared memory
    pool and the static buffers they read and write."""

    def __init__(self, device, enabled: bool = True, name: str = ""):
        device = torch.device(device)
        if enabled and device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.enabled = enabled
        self.name = name
        self.records: list[GraphRecord] = []
        self._fns: list[Graphed] = []
        self._owned: dict[int, torch.Tensor] = {}
        self._pool = None
        self._stream = None

    def jit(self, fn, name: str, donate: tuple = ()) -> Graphed:
        g = Graphed(self, fn, f"{self.name}: {name}" if self.name else name, donate)
        self._fns.append(g)
        return g

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def abandon_pool(self) -> None:
        """After a failed capture: a capture that ends in an error leaves
        PyTorch's allocator recording into the pool, so end that and let the
        next capture start a new pool (the graphs captured so far keep
        theirs)."""
        if self._pool is None:
            return
        try:
            torch._C._cuda_endAllocateToPool(self.device.index, self._pool)
        except RuntimeError:
            pass        # the capture had ended the recording itself
        self._pool = None

    def stream(self) -> "torch.cuda.Stream":
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    # ---- buffers ----------------------------------------------------------
    def owns(self, t) -> bool:
        return isinstance(t, torch.Tensor) and self._owned.get(id(t)) is t

    def buffer(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` if this owner made it, else a clone that it now owns."""
        if self.owns(t):
            return t
        b = t.clone()
        self._owned[id(b)] = b
        return b

    def adopt(self, tree):
        """Take the tensors of ``tree`` (which its caller made and hands
        over) as this owner's buffers; returns ``tree``."""
        if self.enabled:
            for t in flatten(tree)[0]:
                self._owned[id(t)] = t
        return tree

    def assign(self, current, new):
        """``new`` in place of ``current``: each leaf of ``new`` that meets a
        buffer of this owner of the same shape, dtype and device at the same
        place in ``current`` is copied into it, so the graphs keep reading
        the same buffers; other leaves are taken as they are."""
        if not self.enabled:
            return new
        if isinstance(new, dict) and isinstance(current, dict):
            return {k: self.assign(current.get(k), v) for k, v in new.items()}
        if isinstance(new, (list, tuple)) and isinstance(current, (list, tuple)) \
                and len(new) == len(current):
            return type(new)(self.assign(c, v) for c, v in zip(current, new))
        if isinstance(new, torch.Tensor) and self.owns(current) and _meta(current) == _meta(new):
            if current is not new:
                current.copy_(new)
            return current
        return new

    def reset(self) -> None:
        """Drop every graph and static buffer (the owner's static data changed).
        The next capture starts a new pool: PyTorch's allocator refuses to
        record into a pool whose graphs are all gone."""
        for g in self._fns:
            g.reset()
        self._owned.clear()
        self._pool = None

    # ---- records ------------------------------------------------------------
    def stats(self) -> dict:
        """Captures, their warm-up and capture seconds, replays (direct
        calls on the CPU) and the pool's MB."""
        r = self.records
        return {"graphs": sum(len(g._entries) for g in self._fns), "captures": len(r),
                "capture_s": sum(x.warmup_s + x.capture_s for x in r),
                "replays": sum(x.replays for x in r),
                "pool_mb": sum(x.pool_bytes for x in r) / 2**20}
