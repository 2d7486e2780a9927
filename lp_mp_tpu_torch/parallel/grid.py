"""Row-sharded grid Potts solver (counterpart of ``lp_mp_tpu/parallel/grid.py``).

One process holds a list of devices, one per shard; devices may repeat (for
example ``["cuda:0"] * 4`` or ``["cpu"] * 8``).  The grid's rows are cut into
``n`` windows of ``Hl`` rows, at least ``SLAB`` each, so the last shards may
hold inert rows or be wholly inert.  Each shard stores the slots its own
cells own (the sharded layout of ``ops/grid_kernels.py``), so a shard's
update writes only its own storage and the halo is symmetric: before every
launch, each shard gets the ``SLAB`` rows just above and below its window
from its neighbours' pre-launch state (the counterpart of the TPU package's
``ppermute`` of 8-row slabs).  The updates are out of place, so
shards that share a device may launch one after another.

``run_fast`` runs the fused schedule through the sharded kernels
(``round_update_sharded``, ``phase_update_sharded``); ``iterate``,
``lower_bound`` and ``round_primal`` are plain torch per shard.  Because the
slabs deliver the same neighbour rows the dense schedule reads, every
coordinate update equals ``GridPottsModel``'s, and ``dense_state()`` equals
the dense model's state exactly.  Shards on one device read their slabs as
views of the neighbours' windows; with distinct devices the slabs are
device-to-device copies.

The windows live in two fixed sets, and every sweep reads one set and
writes the other in place (the kernels take their output windows), so no
sweep allocates or copies its state.  With ``use_jit`` (the default, as in
the JAX package) each sweep in each direction between the sets, the bound
and the rounding pass run through ``capture.Graphs``: when every shard sits
on one CUDA device, a sweep is one CUDA graph over all shards (the slab
views and each shard's kernel launch; the counterpart of the JAX package's
jitted ``shard_map`` per sweep), which ``run_fast`` replays; two graphs per
sweep swap the sets.  On the CPU the same calls run directly.  Shards on
several CUDA devices run eagerly (one graph holds one device's work).
"""
from __future__ import annotations

import numpy as np
import torch

from ..capture import Graphs
from ..config import ReparametrizationMode, entry_device, real_dtype
from ..models.grid_potts import _NUMPY_DTYPES, _potts_min_pair
from ..ops.grid_kernels import (SLAB, STATE_KEYS, _write_into, phase_update_sharded,
                                phase_update_sharded_ref, round_update_sharded, sharded_phase)

_ANISOTROPIC = (ReparametrizationMode.anisotropic, ReparametrizationMode.anisotropic2)


def mode_phases(mode):
    """(recv_color, send_color, leave) per phase; colours 0=none 1=black
    2=red.  Mirrors GridPottsModel._mode_params' closed-form SRMP weights."""
    mode = ReparametrizationMode.convert(mode)
    if mode in _ANISOTROPIC:
        return ((0, 1, 0.0), (2, 0, 0.0), (0, 2, 0.0), (1, 0, 0.0))
    if mode == ReparametrizationMode.uniform:
        lv = 0.0
    elif mode == ReparametrizationMode.damped_uniform:
        lv = 1.0
    else:
        raise NotImplementedError(f"{mode} not supported on grid model")
    return ((1, 1, lv), (2, 2, lv), (2, 2, lv), (1, 1, lv))


class RowShards:
    """How an H x W grid's rows are cut over ``devices``: window ``i`` holds
    global rows ``[row0[i], row0[i] + Hl)``.  Moves dense arrays into the
    sharded layout and back, and cuts the halo slabs."""

    def __init__(self, H: int, W: int, devices):
        self.H, self.W = H, W
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)
        if self.n < 1:
            raise ValueError("ShardedGridPotts needs at least one device")
        self.Hl = max(-(-H // self.n), SLAB)
        self.row0 = [i * self.Hl for i in range(self.n)]
        self._zeros = {}

    def _cut(self, full):
        """Padded [.., n*Hl, w] array -> per-shard windows on their devices."""
        return [full[..., r:r + self.Hl, :].to(dev).contiguous()
                for r, dev in zip(self.row0, self.devices)]

    def split(self, dense):
        """Dense state dict -> list of window dicts."""
        H, R = self.H, self.n * self.Hl
        u = dense["u"]
        L = u.shape[0]
        full = {}
        for k, w in (("u", self.W), ("hm1", self.W - 1), ("hm2", self.W - 1),
                     ("vm1", self.W), ("vm2", self.W)):
            full[k] = torch.zeros((L, R, w), dtype=u.dtype, device=u.device)
        full["u"][:, :H] = u
        full["hm1"][:, :H] = dense["hm1"]
        full["hm2"][:, :H] = dense["hm2"]
        full["vm1"][:, :H - 1] = dense["vm1"]   # edge below row r, owned by r
        full["vm2"][:, 1:H] = dense["vm2"]      # edge above row r, owned by r
        cut = {k: self._cut(v) for k, v in full.items()}
        return [{k: cut[k][i] for k in STATE_KEYS} for i in range(self.n)]

    def split_costs(self, hc, vc):
        """Dense hc [H, W-1], vc [H-1, W] -> list of {"hc": .., "vc": ..} windows."""
        R = self.n * self.Hl
        hcf = torch.zeros((R, self.W - 1), dtype=hc.dtype, device=hc.device)
        vcf = torch.zeros((R, self.W), dtype=vc.dtype, device=vc.device)
        hcf[:self.H] = hc
        vcf[:self.H - 1] = vc
        return [{"hc": h, "vc": v} for h, v in zip(self._cut(hcf), self._cut(vcf))]

    def join(self, windows):
        """List of window dicts -> dense state dict on the first device."""
        H, dev = self.H, self.devices[0]
        full = {k: torch.cat([w[k].to(dev) for w in windows], dim=1) for k in STATE_KEYS}
        return {"u": full["u"][:, :H], "hm1": full["hm1"][:, :H], "hm2": full["hm2"][:, :H],
                "vm1": full["vm1"][:, :H - 1], "vm2": full["vm2"][:, 1:H]}

    def _zero_like(self, t):
        key = (t.device, t.dtype, tuple(t.shape[:-2]) + (SLAB, t.shape[-1]))
        if key not in self._zeros:
            self._zeros[key] = torch.zeros(key[2], dtype=t.dtype, device=t.device)
        return self._zeros[key]

    def slabs(self, windows):
        """Per shard, per array: (rows just above the window, rows just
        below) from the neighbours, zeros past the first and last shard.  A
        neighbour on the same device lends a view of its window (the kernels
        take a slab's label stride), one on another device a copy.  The
        slabs are cut from the state as it is now, before any shard launches;
        the updates are out of place, so no launch changes them."""
        out = []
        for i, (w, dev) in enumerate(zip(windows, self.devices)):
            s = {}
            for k, t in w.items():
                top = (windows[i - 1][k][..., -SLAB:, :].to(dev) if i > 0
                       else self._zero_like(t))
                bot = (windows[i + 1][k][..., :SLAB, :].to(dev) if i + 1 < self.n
                       else self._zero_like(t))
                s[k] = (top, bot)
            out.append(s)
        return out

    def rows_below(self, tensors):
        """Per shard, ``[..., Hl, w]`` -> the rows one below each window row:
        the window's rows 1.. and then the next shard's first row (zeros
        after the last shard)."""
        out = []
        for i, (t, dev) in enumerate(zip(tensors, self.devices)):
            nxt = (tensors[i + 1][..., :1, :].to(dev) if i + 1 < self.n
                   else torch.zeros_like(t[..., :1, :]))
            out.append(torch.cat([t[..., 1:, :], nxt], dim=-2))
        return out


class ShardedGridPotts:
    """Row-sharded grid Potts SRMP over a list of devices, one per shard.

    ``iterate`` runs exact forward+backward passes, ``run_fast`` the fused
    schedule through the sharded CUDA kernels; ``lower_bound``,
    ``round_primal`` and ``dense_state`` mirror the JAX ``ShardedGridPotts``.
    """

    def __init__(self, unary, hcost, vcost, devices=None, dtype=None, use_jit: bool = True):
        """``devices``: one per shard; by default every CUDA device, one
        shard each.  Pass ``devices=["cpu"] * n`` to run on the CPU."""
        if devices is None:
            entry_device("cuda")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = [entry_device(d) for d in devices]
        unary = np.asarray(unary)
        H, W, L = unary.shape
        self.H, self.W, self.L = H, W, L
        self.layout = RowShards(H, W, devices)
        self.devices, self.n = self.layout.devices, self.layout.n
        self.jit = Graphs(self.devices[0], enabled=use_jit and len(set(self.devices)) == 1,
                          name="ShardedGridPotts")
        self._graphed: dict = {}
        self._sets = None       # two window lists; sweeps read self._cur, write the other
        self._cur = 0
        self.dtype = dtype or real_dtype(self.devices[0])
        if self.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"ShardedGridPotts takes float32 or float64, not {self.dtype}")
        np_dtype = _NUMPY_DTYPES[self.dtype]
        hcost = np.asarray(hcost, dtype=np_dtype)
        vcost = np.asarray(vcost, dtype=np_dtype)
        if hcost.shape != (H, W - 1) or vcost.shape != (H - 1, W):
            raise ValueError(f"cost shapes {hcost.shape}, {vcost.shape} do not fit an "
                             f"{H}x{W} grid: expected {(H, W - 1)}, {(H - 1, W)}")
        u = torch.from_numpy(np.ascontiguousarray(np.moveaxis(unary.astype(np_dtype), -1, 0)))
        self.load_state({"u": u,
                         "hm1": torch.zeros((L, H, W - 1), dtype=self.dtype),
                         "hm2": torch.zeros((L, H, W - 1), dtype=self.dtype),
                         "vm1": torch.zeros((L, H - 1, W), dtype=self.dtype),
                         "vm2": torch.zeros((L, H - 1, W), dtype=self.dtype)})
        # static, like the TPU package's cost slabs: cut once
        self.costs = self.layout.split_costs(torch.from_numpy(hcost), torch.from_numpy(vcost))
        self.cost_slabs = self.layout.slabs(self.costs)

    def load_state(self, state) -> "ShardedGridPotts":
        """Install a dense state dict (as ``GridPottsModel.state``, or from
        ``convert.sharded_state_from_jax``) split over the shards."""
        L, H, W = self.L, self.H, self.W
        want = {"u": (L, H, W), "hm1": (L, H, W - 1), "hm2": (L, H, W - 1),
                "vm1": (L, H - 1, W), "vm2": (L, H - 1, W)}
        dense = {}
        for k in STATE_KEYS:
            t = state[k]
            if tuple(t.shape) != want[k]:
                raise ValueError(f"state[{k!r}] has shape {tuple(t.shape)}, expected {want[k]}")
            dense[k] = t.to(dtype=self.dtype)
        new = self.layout.split(dense)
        if self._sets is None:
            self._sets = [new, [{k: v.clone() for k, v in w.items()} for w in new]]
        else:       # in place: the captured graphs keep reading the same buffers
            for w, nw in zip(self.windows, new):
                for k in STATE_KEYS:
                    w[k].copy_(nw[k])
        return self

    @property
    def windows(self) -> list:
        """The current state: one window dict per shard (sharded layout of
        ``ops/grid_kernels.py``)."""
        return self._sets[self._cur]

    # ------------------------------------------------------------------
    def _graph(self, key, make, name: str):
        """The captured function of ``key``, made by ``make()`` on first use."""
        g = self._graphed.get(key)
        if g is None:
            g = self._graphed[key] = self.jit.jit(make(), name)
        return g

    def _sweep(self, phase_fn, *params):
        """One launch per shard, all from slabs cut before the first, from the
        current set of windows into the other; one captured graph per phase
        function, parameters and direction."""
        src, dst = self._cur, 1 - self._cur

        def make():
            a, b = self._sets[src], self._sets[dst]

            def sweep():
                slabs = self.layout.slabs(a)
                for w, s, c, cs, row0, o in zip(a, slabs, self.costs, self.cost_slabs,
                                                self.layout.row0, b):
                    phase_fn(w, s, c["hc"], c["vc"], cs, row0, self.H, self.W, *params, out=o)
            return sweep
        self._graph((phase_fn.__name__, params, src), make,
                    f"sweep {phase_fn.__name__}{params} into set {dst}")()
        self._cur = dst

    def iterate(self, mode="anisotropic", n: int = 1):
        """n exact forward+backward iterations, plain torch per shard."""
        phases = mode_phases(mode)
        for _ in range(n):
            for ph in phases:
                self._sweep(phase_update_sharded_ref, *ph)
        return self

    def run_fast(self, n: int, mode="anisotropic"):
        """n iterations of the fused schedule of ``GridPottsModel.run_fast``
        (send-only prologue, then two full colour updates per round) through
        the sharded kernels: their CUDA kernels for shards on the card, their
        plain versions for shards on the CPU."""
        mode = ReparametrizationMode.convert(mode)
        if mode in _ANISOTROPIC:
            self._sweep(phase_update_sharded, 0, 1, 0.0)
            r = n
            while r >= 2:
                self._sweep(round_update_sharded, 2)
                r -= 2
            if r:
                self._sweep(round_update_sharded, 1)
        else:   # uniform and damped_uniform: the exact 4-phase cycle
            phases = mode_phases(mode)
            for _ in range(n):
                for p in phases:
                    self._sweep(phase_update_sharded, *p)
        return self

    # ------------------------------------------------------------------
    def _lower_bound_impl(self, windows):
        f64 = torch.float64
        # per window row: the slot the cell below owns on the edge below
        vm2_below = self.layout.rows_below([w["vm2"] for w in windows])
        lb = torch.zeros((), dtype=f64, device=self.devices[0])
        for w, c, below in zip(windows, self.costs, vm2_below):
            s = torch.sum(torch.amin(w["u"], dim=0), dtype=f64)
            s += torch.sum(_potts_min_pair(w["hm1"], w["hm2"], c["hc"]), dtype=f64)
            s += torch.sum(_potts_min_pair(w["vm1"], below, c["vc"]), dtype=f64)
            lb = lb + s.to(lb.device)
        return lb

    def lower_bound(self) -> float:
        a = self.windows
        g = self._graph(("bound", self._cur), lambda: lambda: self._lower_bound_impl(a),
                        f"lower bound of set {self._cur}")
        return float(g())

    def round_primal(self, mode="damped_uniform"):
        """One rounding pass (MpRoundingSolver semantics): run the phases,
        labelling each updated cell by the argmin of its post-receive cost;
        the primal cost is summed over the shards.  Returns (labels int32
        [H, W], ub)."""
        src, dst = self._cur, 1 - self._cur
        a, b = self._sets[src], self._sets[dst]

        def make():
            def round_pass(mode):
                new, extra = self._round_impl(a, mode)
                for o, nw in zip(b, new):
                    _write_into(o, nw)
                return extra
            return round_pass
        xs, ub = self._graph(("round", src), make, f"round_primal into set {dst}")(
            mode=ReparametrizationMode.convert(mode))
        self._cur = dst
        labels = torch.cat([x.cpu() for x in xs], dim=0)[:self.H]
        return labels.to(torch.int32).numpy(), float(ub)

    def _round_impl(self, windows, mode):
        """The device part of ``round_primal``: (new windows, (per-shard
        labels, ub as a float64 scalar))."""
        H = self.H
        xs = [torch.zeros((self.layout.Hl, self.W), dtype=torch.int64, device=dev)
              for dev in self.devices]
        for ph in mode_phases(mode):
            slabs = self.layout.slabs(windows)
            new = []
            for i, (w, s, c, cs, row0) in enumerate(zip(windows, slabs, self.costs,
                                                        self.cost_slabs, self.layout.row0)):
                nw, uu = sharded_phase(w, s, c["hc"], c["vc"], cs, row0, H, *ph)
                g = torch.arange(row0, row0 + self.layout.Hl, device=uu.device)[:, None]
                col = torch.arange(self.W, device=uu.device)[None, :]
                black = (g + col) % 2 == 0
                colours = set(ph[:2])
                active = (g < H) & ((black & (1 in colours)) | (~black & (2 in colours)))
                xs[i] = torch.where(active, torch.argmin(uu, dim=0), xs[i])
                new.append(nw)
            windows = new

        def pick(t, labels):
            return torch.gather(t, 0, labels[None])[0]

        f64 = torch.float64
        x_below = self.layout.rows_below(xs)
        vm2_below = self.layout.rows_below([w["vm2"] for w in windows])
        ub = torch.zeros((), dtype=f64, device=self.devices[0])
        for w, c, x, xb, below in zip(windows, self.costs, xs, x_below, vm2_below):
            xl, xr = x[:, :-1], x[:, 1:]
            s = torch.sum(pick(w["u"], x), dtype=f64)
            s += torch.sum(pick(w["hm1"], xl), dtype=f64)
            s += torch.sum(pick(w["hm2"], xr), dtype=f64)
            s += torch.sum(torch.where(xl != xr, c["hc"], torch.zeros_like(c["hc"])), dtype=f64)
            s += torch.sum(pick(w["vm1"], x), dtype=f64)
            s += torch.sum(pick(below, xb), dtype=f64)
            s += torch.sum(torch.where(x != xb, c["vc"], torch.zeros_like(c["vc"])), dtype=f64)
            ub = ub + s.to(ub.device)
        return windows, (xs, ub)

    def dense_state(self):
        """The state in the dense layout of ``GridPottsModel.state``, on the
        first device."""
        return self.layout.join(self.windows)
